"""swimm_tpu_torch.ops.scorer (plain PyTorch path of score_tiles) against
the JAX package's Pallas kernel (interpret mode), its XLA scorer and the
numpy Gotoh oracle. Tolerance: bit-exact int32 scores — every path computes
exact integers."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swimm_tpu.matrices import get_matrix
from swimm_tpu.models.profile import build_query_profile
from swimm_tpu.ops import pallas_scorer, reference, xla_scorer
from swimm_tpu.utils.synth import random_codes
from swimm_tpu_torch.ops import scorer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def ragged_case(rng, lengths, V=8, jt=32):
    blocks = [rng.integers(0, 20, size=(L, V), dtype=np.int8)
              for L in lengths]
    tiles = np.concatenate([b.reshape(-1, jt, V) for b in blocks])
    outrow = np.concatenate(
        [[i] * (b.shape[0] // jt) for i, b in enumerate(blocks)]
    ).astype(np.int32)
    return blocks, tiles, outrow


def port_scores(tiles, outrow, n_rows, qp, go, ge, **kw):
    return scorer.score_tiles(torch.from_numpy(tiles),
                              torch.from_numpy(outrow), n_rows,
                              torch.from_numpy(qp), go, ge, **kw).numpy()


def jax_scores(tiles, outrow, n_rows, qp, go, ge, **kw):
    return np.asarray(pallas_scorer.score_tiles(
        jnp.asarray(tiles), outrow, n_rows, jnp.asarray(qp), go, ge,
        interpret=True, **kw))


def test_score_tiles_mixed_lengths_vs_pallas_xla_oracle():
    rng = np.random.default_rng(11)
    q = random_codes(rng, 21)
    qp = build_query_profile(q, "BLOSUM62", m_multiple=8)
    blocks, tiles, outrow = ragged_case(rng, [32, 96, 32, 64])
    got = port_scores(tiles, outrow, len(blocks), qp, 10, 2)
    assert got.dtype == np.int32
    assert np.array_equal(got, jax_scores(tiles, outrow, len(blocks), qp,
                                          10, 2))
    assert np.array_equal(got, np.asarray(xla_scorer.score_tiles(
        jnp.asarray(tiles), jnp.asarray(outrow), len(blocks),
        jnp.asarray(qp), 10, 2)))
    db_seqs = [b[:, v] for b in blocks for v in range(b.shape[1])]
    exp = reference.sw_score_many(q, db_seqs, get_matrix("BLOSUM62"), 10, 2)
    assert np.array_equal(got.reshape(-1), exp)


def test_score_tiles_ceiling_vs_pallas():
    ceiling = 12
    rng = np.random.default_rng(12)
    q = random_codes(rng, 8)
    qp = build_query_profile(q, "BLOSUM62", m_multiple=8)
    blocks, tiles, outrow = ragged_case(rng, [32, 32])
    exact = port_scores(tiles, outrow, 2, qp, 10, 2)
    capped = port_scores(tiles, outrow, 2, qp, 10, 2, ceiling=ceiling)
    assert np.array_equal(capped, jax_scores(tiles, outrow, 2, qp, 10, 2,
                                             ceiling=ceiling))
    # sub-ceiling lanes exact, the others report exactly the ceiling
    assert np.array_equal(capped, np.minimum(exact, ceiling))
    assert (exact >= ceiling).any()


def test_score_tiles_flat_gap_extend_and_multi_strip():
    # ge == 0 (flat gap cost) and m = 72 > one 32-row strip, with a
    # remainder strip of 8 rows
    rng = np.random.default_rng(13)
    q = random_codes(rng, 70)
    qp = build_query_profile(q, "BLOSUM62", m_multiple=8)
    blocks, tiles, outrow = ragged_case(rng, [32, 64])
    got = port_scores(tiles, outrow, 2, qp, 5, 0)
    assert np.array_equal(got, np.asarray(xla_scorer.score_tiles(
        jnp.asarray(tiles), jnp.asarray(outrow), 2, jnp.asarray(qp), 5, 0)))
    db_seqs = [b[:, v] for b in blocks for v in range(b.shape[1])]
    exp = reference.sw_score_many(q, db_seqs, get_matrix("BLOSUM62"), 5, 0)
    assert np.array_equal(got.reshape(-1), exp)


# the shapes that strain the CUDA kernel's cooperating workers (the card
# check holds the kernel against the plain version on the same list): blocks
# of one 32-position tile, fewer strips than workers (m = 8, 32, 40), strip
# counts no worker count divides and 8-row tail strips (m = 72, 120, 136),
# 14 strips, the longest profile, 64 lanes, a ceiling, flat and free gaps
@pytest.mark.parametrize("lengths,V,m,go,ge,ceiling", [
    ([32, 32, 32], 8, 8, 10, 2, None),
    ([32, 64], 8, 32, 10, 2, None),
    ([32, 96, 32], 8, 40, 10, 2, 12),
    ([32, 128, 64], 8, 72, 10, 2, None),
    ([64, 32, 96], 8, 120, 10, 2, 24),
    ([32, 96], 8, 136, 10, 2, None),
    ([32, 224, 64], 8, 448, 10, 2, None),
    ([32, 64], 64, 448, 10, 2, 20),
    ([32, 64], 8, 2048, 10, 2, None),
    ([64, 96], 8, 72, 5, 0, None),
    ([64, 96], 8, 72, 0, 3, 14),
    ([64, 96], 8, 72, 0, 0, None),
])
def test_score_tiles_worker_edge_shapes_vs_xla_and_oracle(lengths, V, m, go,
                                                          ge, ceiling):
    rng = np.random.default_rng(100 + m + V + go)
    q = random_codes(rng, m - int(rng.integers(0, 8)))
    qp = build_query_profile(q, "BLOSUM62", m_multiple=8)
    assert qp.shape == (32, m)
    blocks, tiles, outrow = ragged_case(rng, lengths, V=V)
    got = port_scores(tiles, outrow, len(blocks), qp, go, ge,
                      ceiling=ceiling)
    assert np.array_equal(got, np.asarray(xla_scorer.score_tiles(
        jnp.asarray(tiles), jnp.asarray(outrow), len(blocks),
        jnp.asarray(qp), go, ge, ceiling=ceiling)))
    if m <= 136:
        db_seqs = [b[:, v] for b in blocks for v in range(V)]
        exp = reference.sw_score_many(q, db_seqs, get_matrix("BLOSUM62"),
                                      go, ge)
        if ceiling is not None:
            assert (exp >= ceiling).any()
            exp = np.minimum(exp, ceiling)
        assert np.array_equal(got.reshape(-1), exp)


@pytest.mark.parametrize("go,ge", [(-1, 2), (10, -1)])
def test_score_tiles_rejects_negative_gaps(go, ge):
    rng = np.random.default_rng(14)
    qp = build_query_profile(random_codes(rng, 8), "BLOSUM62", m_multiple=8)
    _, tiles, outrow = ragged_case(rng, [32])
    with pytest.raises(ValueError, match="must be >= 0"):
        port_scores(tiles, outrow, 1, qp, go, ge)


def test_score_tiles_rejects_bad_inputs():
    rng = np.random.default_rng(15)
    qp = build_query_profile(random_codes(rng, 8), "BLOSUM62", m_multiple=8)
    _, tiles, outrow = ragged_case(rng, [32])
    with pytest.raises(ValueError, match="int8"):
        port_scores(tiles.astype(np.int32), outrow, 1, qp, 10, 2)
    with pytest.raises(ValueError, match="multiple of 8"):
        port_scores(tiles, outrow, 1, np.ascontiguousarray(qp[:, :4]), 10, 2)
    big = np.zeros((32, 2056), np.int32)
    with pytest.raises(ValueError, match="max_query_pad"):
        port_scores(tiles, outrow, 1, big, 10, 2)


@pytest.mark.parametrize("V,ok", [(512, True), (513, False),
                                  (1024, False)])
def test_lane_width_limit_is_the_kernels_thread_limit(V, ok):
    # every CUDA kernel of the package is built for at most 512 threads a
    # block (a thread per lane per worker): wider lanes are refused before
    # any launch, on every device
    rng = np.random.default_rng(16)
    q = random_codes(rng, 8)
    qp = build_query_profile(q, "BLOSUM62", m_multiple=8)
    blocks, tiles, outrow = ragged_case(rng, [32], V=V)
    codes = torch.from_numpy(tiles.reshape(1, 32, V))
    if ok:
        got = port_scores(tiles, outrow, 1, qp, 10, 2)
        assert np.array_equal(
            got, scorer.score_chunk(codes, torch.from_numpy(qp), 10,
                                    2).numpy())
        exp = reference.sw_score_many(q, [blocks[0][:, v] for v in (0, V - 1)],
                                      get_matrix("BLOSUM62"), 10, 2)
        assert np.array_equal(got[0, [0, V - 1]], exp)
        return
    with pytest.raises(ValueError, match="lane width"):
        port_scores(tiles, outrow, 1, qp, 10, 2)
    with pytest.raises(ValueError, match="lane width"):
        scorer.score_chunk(codes, torch.from_numpy(qp), 10, 2)
    with pytest.raises(ValueError, match="lane width"):
        scorer.score_tiles_packed(
            torch.from_numpy(tiles), torch.from_numpy(outrow), 1,
            torch.from_numpy(qp), torch.zeros(1, dtype=torch.int32), 10, 2)


def test_row_starts():
    outrow = torch.tensor([0, 0, 1, 3, 3, 3], dtype=torch.int32)
    assert scorer.row_starts(outrow, 4).tolist() == [0, 2, 3, 3, 6]


# ---- the int32 gap bound (scorer.MAX_GAP) --------------------------------
# The input of the fault it repairs: synth_db(12, seed=2, median_len=60,
# max_len=120), V=8, BLOSUM62, the query the second draw of
# default_rng(3) (100 aa; 2,100 aa for the long paths). At gaps 0 / 2^26
# the plain scorers used to wrap int32 (and swimm_tpu still returns wrong
# scores there); now every path equals the oracle up to MAX_GAP and raises
# past it, on every device.

@pytest.fixture(scope="module")
def gap_world(tmp_path_factory):
    from swimm_tpu_torch import build_db
    from swimm_tpu_torch.fasta import FastaRecord
    from swimm_tpu_torch.utils.synth import synth_db
    packed = build_db(synth_db(12, seed=2, median_len=60, max_len=120),
                      tmp_path_factory.mktemp("gaps") / "db", V=8)
    rng = np.random.default_rng(3)
    rng.integers(0, 20, 20)
    queries = {"short": FastaRecord("q100", rng.integers(0, 20, 100)),
               "long": FastaRecord("q2100", rng.integers(0, 20, 2100))}
    return packed, queries, {}


def _oracle(world, which, go, ge):
    packed, queries, cache = world
    if (which, go, ge) not in cache:
        cache[which, go, ge] = reference.sw_score_many(
            queries[which].codes,
            [packed.seq_codes(i) for i in range(packed.n_seqs)],
            get_matrix("BLOSUM62"), go, ge)
    return cache[which, go, ge]


def _gap_path(path, packed, queries, go, ge):
    """Sorted-db score vector of one path of the port at gaps go/ge."""
    from swimm_tpu_torch.models import engine, qpack
    from swimm_tpu_torch.ops import longquery
    which = "long" if path.endswith("long") else "short"
    q = queries[which]
    cfg = engine.SearchConfig(gap_open=go, gap_extend=ge,
                              top_k=packed.n_seqs)
    tiles, outrow, n_rows, rs = engine.device_tiles(packed, "cpu")[:4]
    qp = torch.from_numpy(build_query_profile(q.codes, "BLOSUM62", 16))
    if path == "score_tiles":
        lanes = scorer.score_tiles(tiles, outrow, n_rows, qp, go, ge,
                                   row_start=rs)
    elif path == "score_tiles_long":
        lanes = longquery.score_tiles_long(tiles, outrow, n_rows, qp, go, ge,
                                           row_start=rs)
    elif path == "score_tiles_packed":
        pack, = qpack.build_query_packs([q], "BLOSUM62")
        lanes = scorer.score_tiles_packed(
            tiles, outrow, n_rows, torch.from_numpy(pack.qp),
            torch.from_numpy(pack.seg_of_group), go, ge,
            row_start=rs)[:, pack.entries[0].seg // 2]
    elif path.startswith("score_db"):
        return engine.score_db(packed, q, cfg, device="cpu")
    elif path == "ladder":
        return engine.score_db(packed, q, engine.SearchConfig(
            gap_open=go, gap_extend=ge, precision="ladder"), device="cpu")
    else:                                  # search, search_long, packed
        res, _ = engine.search(packed, [q], engine.SearchConfig(
            gap_open=go, gap_extend=ge, top_k=packed.n_seqs,
            query_pack=path == "search_packed"), device="cpu")
        out = np.full(packed.n_seqs, -1, np.int64)
        for h in res[0].hits:
            out[h.sorted_idx] = h.score
        return out
    return engine.scatter_lane_scores(packed, lanes.reshape(-1).numpy())


GAP = scorer.MAX_GAP


@pytest.mark.parametrize("go,ge,inside", [
    (GAP, GAP, True), (0, GAP, True), (GAP + 1, 0, False),
    (0, GAP + 1, False)])
@pytest.mark.parametrize("path", [
    "score_tiles", "score_tiles_packed", "score_tiles_long", "score_db",
    "score_db_long", "search", "search_packed", "search_long", "ladder"])
def test_gap_bound_every_path(gap_world, path, go, ge, inside):
    packed, queries, _ = gap_world
    if not inside:
        with pytest.raises(ValueError, match="at most"):
            _gap_path(path, packed, queries, go, ge)
        return
    which = "long" if path.endswith("long") else "short"
    got = _gap_path(path, packed, queries, go, ge)
    assert np.array_equal(got, _oracle(gap_world, which, go, ge))


def test_plain_walk_refuses_a_ramp_past_int32():
    # MAX_GAP keeps a one-pass plain walk in range up to 3,584 rows; a
    # longer profile at that gap_extend is refused, not wrapped
    tiles = torch.zeros((1, 32, 8), dtype=torch.int8)
    outrow = torch.zeros(1, dtype=torch.int32)
    ok = torch.zeros((32, 3584), dtype=torch.int32)
    assert not scorer.score_tiles_ref(tiles, outrow, 1, ok, 0, GAP).any()
    with pytest.raises(ValueError, match="ramp"):
        scorer.score_tiles_ref(tiles, outrow, 1,
                               torch.zeros((32, 3592), dtype=torch.int32),
                               0, GAP)
