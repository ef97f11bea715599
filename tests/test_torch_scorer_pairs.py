"""Kernel 1's pair form (swimm_tpu_torch.ops.scorer: _tiles_pairs, its
plain version score_tiles_pairs_ref, and score_tiles' 16-bit guard) on the
CPU, against the int32 plain walk, the JAX package's XLA scorer and search,
and the C oracle: exact below the pair form's limit, exact everywhere
through the guard (lanes past 32,767 scored again in int32, and only the
blocks that hold them), the int32 form wherever the pair form does not fit
or a ceiling is asked, and the same result from scalars the caller gives
as from scalars read from the profile. Tolerance: bit-exact int32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swimm_tpu.db import build_db as j_build_db
from swimm_tpu.fasta import FastaRecord as JRecord
from swimm_tpu.models import engine as jengine
from swimm_tpu.ops import xla_scorer
from swimm_tpu_torch.alphabet import ALPHABET, PAD_CODE
from swimm_tpu_torch.benchmarks import launch_counts
from swimm_tpu_torch.db import build_db
from swimm_tpu_torch.matrices import get_matrix
from swimm_tpu_torch.models import engine
from swimm_tpu_torch.models import stream as tstream
from swimm_tpu_torch.models.engine import SearchConfig
from swimm_tpu_torch.models.profile import build_query_profile
from swimm_tpu_torch.ops import cref, scorer
from swimm_tpu_torch.ops import longquery as tlong
from swimm_tpu_torch.utils.synth import random_codes, synth_db, synth_queries
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

W = ALPHABET.index("W")


def _stream(blocks):
    """(tiles, outrow) of (L, V) int8 blocks, each L a multiple of 32."""
    tiles = np.concatenate([b.reshape(-1, 32, b.shape[1]) for b in blocks])
    outrow = np.repeat(np.arange(len(blocks), dtype=np.int32),
                       [b.shape[0] // 32 for b in blocks])
    return torch.from_numpy(tiles), torch.from_numpy(outrow)


def _random_blocks(rng, lengths, V):
    """Blocks of random codes 0-23 (B, Z, X and * included), PAD runs at
    the ends of every third lane, two tied lanes."""
    blocks = []
    for L in lengths:
        b = rng.integers(0, 24, size=(L, V), dtype=np.int8)
        for v in range(0, V, 3):
            b[rng.integers(1, L + 1):, v] = PAD_CODE
        b[:, 1] = b[:, 0]
        blocks.append(b)
    return blocks


def _planted_blocks(rng, planted, n_blocks, L, V=64):
    """n_blocks (L, V) blocks of short random lanes of codes 2-19, PAD
    behind them; planted {(block, lane): codes} laid over them."""
    blocks = []
    for _ in range(n_blocks):
        b = np.full((L, V), PAD_CODE, np.int8)
        for v in range(V):
            n = int(rng.integers(1, min(60, L)))
            b[:n, v] = rng.integers(2, 20, n)
        blocks.append(b)
    for (bi, v), codes in planted.items():
        blocks[bi][:, v] = PAD_CODE
        blocks[bi][:len(codes), v] = codes
    return blocks


def _lane_seqs(blocks):
    out = []
    for b in blocks:
        for v in range(b.shape[1]):
            lane = b[:, v]
            n = (int(np.argmax(lane == PAD_CODE)) if (lane == PAD_CODE).any()
                 else len(lane))
            out.append(lane[:n].astype(np.uint8))
    return out


def _big_entry_case(rng):
    """A matrix whose A/A entry is 1,000 (T = 31,767), R/R 100 and N/N 1:
    lanes that score 33,000 (33 A: past 32,767), 31,766 (T - 1) and 31,767
    (T), each in a block of its own, and a block of ordinary lanes only."""
    mat = get_matrix("BLOSUM62").copy()
    mat[0, 0], mat[1, 1], mat[2, 2] = 1000, 100, 1
    q = np.concatenate([[0] * 33, [1] * 7, [2] * 67,
                        rng.integers(3, 20, 30)]).astype(np.uint8)
    planted = {(0, 3): [0] * 33, (1, 40): [0] * 31 + [1] * 7 + [2] * 66,
               (2, 63): [0] * 31 + [1] * 7 + [2] * 67}
    return q, mat, _planted_blocks(rng, planted, 4, 128), {
        (0, 3): 33000, (1, 40): 31766, (2, 63): 31767}


def _pam250_w_run_case(rng):
    """PAM250, whose W/W (17) is its largest entry (T = 32,750): a query
    with a run of 1,928 W, the longest run of the matrix's best residue a
    2,048-row profile holds, past 32,767; lanes of the run (32,776), of
    1,927 W (32,759: at or above T, exact) and of 1,926 W (32,742: below
    T), and a short block of ordinary lanes."""
    q = np.concatenate([rng.integers(2, 20, 20), [W] * 1928,
                        rng.integers(2, 20, 20)]).astype(np.uint8)
    blocks = _planted_blocks(rng, {(0, 5): [W] * 1928, (0, 9): [W] * 1927,
                                   (1, 2): [W] * 1926}, 2, 1952)
    blocks += _planted_blocks(rng, {}, 1, 32)
    return q, get_matrix("PAM250"), blocks, {(0, 5): 32776, (0, 9): 32759,
                                             (1, 2): 32742}


@pytest.mark.parametrize("gaps", [(10, 2), (0, 0), (11, 1)])
@pytest.mark.parametrize("m", [8, 32, 40, 448, 2048])
@pytest.mark.parametrize("V", [64, 128])
def test_pair_form_plain_equals_int32_below_the_limit(V, m, gaps):
    # BLOSUM62 profiles of up to 2,048 rows: no H reaches the limit, so the
    # pair form's plain version and score_tiles (the pair form and its
    # guard) are the int32 plain walk, lane for lane
    rng = np.random.default_rng([V, m, *gaps])
    q = random_codes(rng, m - int(rng.integers(0, 8)))
    qp = torch.from_numpy(build_query_profile(q, "BLOSUM62", 8))
    tiles, outrow = _stream(_random_blocks(rng, [32, 64, 32], V))
    lo, hi, top = scorer.profile_bounds(qp)
    assert scorer.pair_form_fits(V, *gaps, lo, hi)
    assert top < scorer.pair_limit(hi)
    exp = scorer.score_tiles_ref(tiles, outrow, 3, qp, *gaps)
    assert torch.equal(scorer.score_tiles_pairs_ref(tiles, outrow, 3, qp,
                                                    *gaps), exp)
    assert torch.equal(scorer._tiles_pairs(tiles, outrow, 3, qp, *gaps,
                                           None), exp)
    assert torch.equal(scorer.score_tiles(tiles, outrow, 3, qp, *gaps), exp)


@pytest.mark.parametrize("V,m,gaps", [(64, 40, (10, 2)), (128, 448, (0, 0)),
                                      (128, 136, (11, 1))])
def test_score_tiles_in_the_pair_form_equals_jax(V, m, gaps):
    rng = np.random.default_rng([7, V, m])
    q = random_codes(rng, m)
    qp = build_query_profile(q, "BLOSUM62", 8)
    tiles, outrow = _stream(_random_blocks(rng, [64, 32, 96], V))
    got = scorer.score_tiles(tiles, outrow, 3, torch.from_numpy(qp), *gaps)
    ref = np.asarray(xla_scorer.score_tiles(
        jnp.asarray(tiles.numpy()), jnp.asarray(outrow.numpy()), 3,
        jnp.asarray(qp), *gaps))
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("make", [_big_entry_case, _pam250_w_run_case],
                         ids=["big_entry", "pam250_w_run"])
def test_pair_form_rescores_every_block_that_could_wrap(make):
    # the planted lanes pass 32,767, or sit at or just below the limit T;
    # score_tiles equals the C oracle in every lane, and the blocks scored
    # again in int32 are exactly those with a lane at or above T; without
    # the second pass the lanes above T read T (the kernel: T or more)
    q, mat, blocks, planted = make(np.random.default_rng(61))
    qp = torch.from_numpy(build_query_profile(q, mat, 8))
    tiles, outrow = _stream(blocks)
    n_rows, V = len(blocks), blocks[0].shape[1]
    lo, hi, top = scorer.profile_bounds(qp)
    limit = scorer.pair_limit(hi)
    assert qp.shape[1] <= scorer.max_query_pad()
    assert scorer.pair_form_fits(V, 10, 2, lo, hi) and top >= limit
    exp = cref.sw_score_many(q, _lane_seqs(blocks), mat, 10, 2).reshape(
        n_rows, V)
    for (b, v), score in planted.items():
        assert exp[b, v] == score
    assert max(planted.values()) > scorer.PAIR_MAX
    assert min(planted.values()) < limit <= sorted(planted.values())[1]
    flagged = int((exp >= limit).any(axis=1).sum())
    assert 0 < flagged < n_rows

    seen = []
    real = scorer._tiles_int32

    def spy(tiles, outrow, n_rows, *a):
        seen.append(n_rows)
        return real(tiles, outrow, n_rows, *a)

    before = scorer.score_tiles.rescored_blocks
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scorer, "_tiles_int32", spy)
        got = scorer.score_tiles(tiles, outrow, n_rows, qp, 10, 2).numpy()
    assert np.array_equal(got, exp)
    assert scorer.score_tiles.rescored_blocks - before == flagged
    assert seen == [flagged]           # one int32 pass, the flagged blocks
    if make is _pam250_w_run_case:     # one plain pass of the run: ~5 s
        return
    raw = scorer._tiles_pairs(tiles, outrow, n_rows, qp, 10, 2,
                              None).numpy()
    low = exp < limit
    assert np.array_equal(raw[low], exp[low])
    assert (raw[~low] == limit).all() and (raw != exp).any()


@pytest.mark.parametrize("V,gaps,entry,ceiling", [
    (32, (10, 2), None, None), (96, (10, 2), None, None),  # no whole warps
    (64, (16000, 385), None, None),                   # 2 goe past 32,768
    (64, (10, 2), 32767 - 12 + 1, None),              # S + goe past 32,767
    (128, (10, 2), -40000, None),                     # an entry below -32,768
    (64, (10, 2), None, 40), (128, (10, 2), None, 32767)])   # a ceiling
def test_inputs_outside_the_pair_form_take_the_int32_form(V, gaps, entry,
                                                          ceiling,
                                                          monkeypatch):
    rng = np.random.default_rng(67)
    mat = get_matrix("BLOSUM62").copy()
    if entry is not None:
        mat[0, 0] = entry
    q = rng.integers(0, 20, 70).astype(np.uint8)
    qp = torch.from_numpy(build_query_profile(q, mat, 8))
    blocks = _planted_blocks(rng, {(1, 2): q[:50]}, 2, 64, V)
    tiles, outrow = _stream(blocks)
    lo, hi, _ = scorer.profile_bounds(qp)
    assert ceiling is not None or not scorer.pair_form_fits(V, *gaps, lo, hi)

    def refuse(*a, **k):
        raise AssertionError("the pair form was taken")

    monkeypatch.setattr(scorer, "_tiles_pairs", refuse)
    got = scorer.score_tiles(tiles, outrow, 2, qp, *gaps, ceiling=ceiling)
    assert torch.equal(got, scorer.score_tiles_ref(tiles, outrow, 2, qp,
                                                   *gaps, ceiling=ceiling))
    exp = cref.sw_score_many(q, _lane_seqs(blocks), mat, *gaps)
    if ceiling is not None:
        exp = np.minimum(exp, ceiling)
    assert np.array_equal(got.numpy().reshape(-1), exp)


@pytest.mark.parametrize("make", ["blosum62", _big_entry_case],
                         ids=["blosum62", "big_entry"])
def test_scalars_from_the_caller_equal_scalars_from_the_profile(
        make, monkeypatch):
    # score_tiles with profile_bounds given gives what it gives when it
    # reads them from the profile, guard included, and reads nothing then
    rng = np.random.default_rng(71)
    if make == "blosum62":
        q, mat = random_codes(rng, 90), get_matrix("BLOSUM62")
        blocks = _random_blocks(rng, [32, 96], 64)
    else:
        q, mat, blocks, _ = make(rng)
    qp = torch.from_numpy(build_query_profile(q, mat, 8))
    tiles, outrow = _stream(blocks)
    n_rows = len(blocks)
    bounds = scorer.profile_bounds(qp)
    before = scorer.score_tiles.rescored_blocks
    read = scorer.score_tiles(tiles, outrow, n_rows, qp, 10, 2)
    n_read = scorer.score_tiles.rescored_blocks - before

    def refuse(qp):
        raise AssertionError("the bounds were read from the profile")

    monkeypatch.setattr(scorer, "profile_bounds", refuse)
    given = scorer.score_tiles(tiles, outrow, n_rows, qp, 10, 2,
                               bounds=bounds)
    assert torch.equal(given, read)
    assert scorer.score_tiles.rescored_blocks - before == 2 * n_read


def test_score_tiles_long_takes_the_callers_scalars(monkeypatch):
    # kernel 2's scorer takes the same scalars (engine.score_lanes gives
    # them to both lane scorers): equal scores, guard included, and no read
    q, mat, blocks, _ = _big_entry_case(np.random.default_rng(79))
    qp = torch.from_numpy(build_query_profile(q, mat, 8))
    tiles, outrow = _stream(blocks)
    read = tlong.score_tiles_long(tiles, outrow, 4, qp, 10, 2, tile_m=24)
    bounds = scorer.profile_bounds(qp)

    def refuse(qp):
        raise AssertionError("the bounds were read from the profile")

    monkeypatch.setattr(tlong, "profile_bounds", refuse)
    assert torch.equal(tlong.score_tiles_long(tiles, outrow, 4, qp, 10, 2,
                                              tile_m=24, bounds=bounds),
                       read)


def test_profile_bounds_and_the_pair_scratch():
    qp = torch.tensor([[3, -2, 0], [-5, 4, -1]], dtype=torch.int32)
    assert scorer.profile_bounds(qp) == (-5, 4, 3 + 4 + 0)
    assert scorer.strip_carry(32, (10, 32, 128), "cpu", pairs=True) is None
    assert scorer.strip_carry(40, (10, 32, 128), "cpu",
                              pairs=True).shape == (2, 10, 32, 64)
    assert scorer.strip_carry(40, (10, 32, 128), "cpu").shape == (10, 32,
                                                                  128, 2)


def test_launch_counts_sum_kernel_1_in_both_forms(monkeypatch):
    monkeypatch.setattr(scorer.score_tiles, "launches", 3)
    monkeypatch.setattr(scorer.score_tiles, "pair_launches", 4)
    assert launch_counts()["sw_ragged_kernel"] == 7
    assert scorer.score_tiles.kernel == "sw_ragged_kernel"


def test_a_ceiling_takes_the_int32_form_and_none_the_pair_form(monkeypatch):
    # a saturating tier (the ladder's) takes the int32 form, an uncapped
    # call the pair form; both exact to their contract
    rng = np.random.default_rng(73)
    q = random_codes(rng, 60)
    qp = torch.from_numpy(build_query_profile(q, "BLOSUM62", 16))
    blocks = _random_blocks(rng, [32, 64, 32, 32], 64)
    tiles, outrow = _stream(blocks)
    forms = []
    pairs, int32 = scorer._tiles_pairs, scorer._tiles_int32
    monkeypatch.setattr(scorer, "_tiles_pairs", lambda *a: (
        forms.append("pairs"), pairs(*a))[1])
    monkeypatch.setattr(scorer, "_tiles_int32", lambda *a: (
        forms.append(("int32", a[6])), int32(*a))[1])
    got = scorer.score_tiles(tiles, outrow, 4, qp, 10, 2, ceiling=12)
    got_exact = scorer.score_tiles(tiles, outrow, 4, qp, 10, 2)
    assert forms == [("int32", 12), "pairs"]
    exp = scorer.score_tiles_ref(tiles, outrow, 4, qp, 10, 2)
    assert torch.equal(got_exact, exp)
    assert torch.equal(got, exp.clamp_max(12))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """200 sequences of up to 180 aa at V = 64 (the pair form's width),
    three queries with planted homologs, packed by both packages."""
    d = tmp_path_factory.mktemp("pairs")
    queries = synth_queries(3, [30, 70, 120], seed=81)
    recs = synth_db(200, seed=82, median_len=60, sigma=0.5, max_len=180,
                    queries=[q.codes for q in queries], homolog_frac=0.05)
    packed = build_db(recs, d / "t", V=64)
    pj = j_build_db(recs, d / "j", V=64, use_native=False)
    return packed, pj, queries


@pytest.mark.parametrize("stream", [False, True], ids=["resident",
                                                       "streamed"])
def test_search_passes_host_bounds_and_equals_jax(world, stream,
                                                  monkeypatch):
    # every kernel-1 launch of a search gets the profile's bounds from the
    # host, where the profile was built; the hits equal swimm_tpu's
    packed, pj, queries = world
    seen = []
    real = scorer.score_tiles

    def spy(tiles, outrow, n_rows, qp, go, ge, **kw):
        seen.append(kw.get("bounds") == scorer.profile_bounds(qp))
        return real(tiles, outrow, n_rows, qp, go, ge, **kw)

    spy.kernel = real.kernel
    monkeypatch.setattr(scorer, "score_tiles", spy)
    cfg = dict(top_k=5, db_stream=stream, window_tiles=8)
    got, _ = engine.search(packed, queries, SearchConfig(**cfg),
                           device="cpu")
    assert seen and all(seen)
    assert len(seen) == (len(queries) * (1 if not stream else len(
        tstream.plan_windows(tstream.stream_layout(packed), 8)[0])))
    ref, _ = jengine.search(pj, [JRecord(q.title, q.codes) for q in queries],
                            jengine.SearchConfig(backend="xla", **cfg))
    assert ([[(h.score, h.sorted_idx) for h in r.hits] for r in got]
            == [[(h.score, h.sorted_idx) for h in r.hits] for r in ref])


@pytest.mark.parametrize("mesh_shape,stream", [
    ((4, 1), False), ((4, 2), False), ((4, 1), True)],
    ids=["sharded_4x1", "sharded_4x2", "sharded_stream_4x1"])
def test_sharded_search_passes_host_bounds(world, mesh_shape, stream,
                                           monkeypatch):
    # the sharded steps take each profile's bounds once a query, on the
    # host (_cell_profiles): every kernel-1 launch over every shard gets
    # them, none reads them back from the device, and the hits equal the
    # unsharded search's
    from swimm_tpu_torch.parallel import sharded_search as sharded
    from swimm_tpu_torch.parallel import sharded_stream
    from swimm_tpu_torch.parallel.mesh import make_mesh
    packed, _, queries = world
    cfg = SearchConfig(top_k=5, db_stream=stream, window_tiles=8)
    want, _ = engine.search(packed, queries, SearchConfig(top_k=5),
                            device="cpu")
    seen = []
    real, bounds_of = scorer.score_tiles, scorer.profile_bounds

    def spy(tiles, outrow, n_rows, qp, go, ge, **kw):
        seen.append(kw.get("bounds") == bounds_of(qp))
        return real(tiles, outrow, n_rows, qp, go, ge, **kw)

    spy.kernel = real.kernel
    mesh = make_mesh(mesh_shape[0] * mesh_shape[1], query_axis=mesh_shape[1],
                     devices=["cpu"] * (mesh_shape[0] * mesh_shape[1]))
    host = []
    monkeypatch.setattr(scorer, "score_tiles", spy)
    monkeypatch.setattr(scorer, "profile_bounds", lambda qp: (
        host.append(qp.device.type), bounds_of(qp))[1])
    run = (sharded_stream.search_streaming_sharded if stream
           else sharded.sharded_search)
    got, _ = run(packed, queries, cfg, mesh=mesh)
    assert seen and all(seen)
    assert host == ["cpu"] * len(queries)      # once a query, on the host
    assert ([[(h.score, h.sorted_idx) for h in r.hits] for r in got]
            == [[(h.score, h.sorted_idx) for h in r.hits] for r in want])
