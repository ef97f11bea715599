"""swimm_tpu_torch.ops.longquery (plain PyTorch path of the query-tiled
scorer) against the JAX package's score_tiles_long (Pallas interpret mode)
and the numpy oracle, with a planted homolog. Tolerance: bit-exact int32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swimm_tpu.matrices import get_matrix
from swimm_tpu.models.profile import build_query_profile
from swimm_tpu.ops import longquery, reference
from swimm_tpu.utils.synth import mutate, random_codes
from swimm_tpu_torch.alphabet import ALPHABET, PAD_CODE
from swimm_tpu_torch.matrices import get_matrix as t_matrix
from swimm_tpu_torch.models.profile import build_query_profile as t_profile
from swimm_tpu_torch.ops import cref
from swimm_tpu_torch.ops import longquery as tlong
from swimm_tpu_torch.ops import scorer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _case(seed, qlen, lengths, V=8):
    rng = np.random.default_rng(seed)
    q = random_codes(rng, qlen)
    qp = build_query_profile(q, "BLOSUM62", m_multiple=8)
    blocks = [rng.integers(0, 20, size=(L, V), dtype=np.int8)
              for L in lengths]
    hom = mutate(rng, q, sub_rate=0.05, indel_rate=0.01)[:lengths[1]]
    blocks[1][:len(hom), 2] = hom
    tiles = np.concatenate([b.reshape(-1, 32, V) for b in blocks])
    outrow = np.concatenate(
        [[i] * (b.shape[0] // 32) for i, b in enumerate(blocks)]
    ).astype(np.int32)
    return q, qp, blocks, tiles, outrow


def test_score_tiles_long_vs_pallas_and_oracle():
    q, qp, blocks, tiles, outrow = _case(13, 90, [32, 96, 32])
    got = tlong.score_tiles_long(
        torch.from_numpy(tiles), torch.from_numpy(outrow), len(blocks),
        torch.from_numpy(qp), 10, 2, tile_m=32).numpy()
    ref = np.asarray(longquery.score_tiles_long(
        jnp.asarray(tiles), outrow, len(blocks), jnp.asarray(qp), 10, 2,
        tile_m=32, interpret=True))
    assert np.array_equal(got, ref)
    db_seqs = [b[:, v] for b in blocks for v in range(b.shape[1])]
    exp = reference.sw_score_many(q, db_seqs, get_matrix("BLOSUM62"),
                                  10, 2).reshape(len(blocks), -1)
    assert np.array_equal(got, exp)
    assert got[1, 2] > 100              # planted homolog


def test_score_tiles_long_equals_one_pass_any_tile_m():
    # splitting the query into tiles (incl. a tile_m that is not a
    # multiple of the 32-row strip) never changes a score
    _, qp, blocks, tiles, outrow = _case(17, 100, [32, 96, 64])
    args = (torch.from_numpy(tiles), torch.from_numpy(outrow), len(blocks))
    one = scorer.score_tiles(*args, torch.from_numpy(qp), 10, 1).numpy()
    for tile_m in (8, 40, 104):
        got = tlong.score_tiles_long(*args, torch.from_numpy(qp), 10, 1,
                                     tile_m=tile_m).numpy()
        assert np.array_equal(got, one), tile_m


def test_qtile_carries_chain_like_one_tile():
    # two 16-row tiles chained through the carries give the same scores
    # and the same outgoing carries as one 32-row tile
    _, qp, blocks, tiles, outrow = _case(19, 32, [64, 32, 32])
    t, o = torch.from_numpy(tiles), torch.from_numpy(outrow)
    h0 = torch.zeros(t.shape, dtype=torch.int32)
    f0 = torch.full(t.shape, scorer.NEG, dtype=torch.int32)
    qpt = torch.from_numpy(qp)
    s_one, h_one, f_one = tlong.score_qtile(t, o, 3, qpt, 10, 2, h0, f0)
    s_a, h_a, f_a = tlong.score_qtile(t, o, 3, qpt[:, :16].contiguous(),
                                      10, 2, h0, f0)
    s_b, h_b, f_b = tlong.score_qtile(t, o, 3, qpt[:, 16:].contiguous(),
                                      10, 2, h_a, f_a)
    assert torch.equal(torch.maximum(s_a, s_b), s_one)
    assert torch.equal(h_b, h_one) and torch.equal(f_b, f_one)


def _carries(rng, tiles, outrow, big):
    """Random incoming carries (H 0..5, F -40..9), and at each block's last
    position an F of big[lane] + 10 * block in the lanes of `big`: above
    every H the tile could make there, since no position follows it."""
    h = torch.from_numpy(rng.integers(0, 6, tiles.shape, dtype=np.int32))
    f = torch.from_numpy(rng.integers(-40, 10, tiles.shape, dtype=np.int32))
    last = np.flatnonzero(np.diff(np.append(outrow, outrow[-1] + 1)))
    for b, t in enumerate(last):
        for lane, val in big.items():
            f[t, -1, lane] = val + 10 * b
    return h, f, last


@pytest.mark.parametrize("gap_open,gap_extend",
                         [(10, 2), (5, 0), (0, 3), (0, 0)])
def test_qtile_score_from_incoming_f(gap_open, gap_extend):
    # an incoming F above every t0 of the tile is the tile's score in its
    # lane (F enters row 0: H = F there), and it decays by gap_extend per
    # row to the outgoing carries: H = F - (R - 1) * ge on the bottom row,
    # F = H - ge entering the row below (goe >= ge)
    _, qp, blocks, tiles, outrow = _case(23, 8, [32, 64])
    R = qp.shape[1]
    big = {2: 500, 5: 700}
    h, f, last = _carries(np.random.default_rng(29), tiles, outrow, big)
    t, o = torch.from_numpy(tiles), torch.from_numpy(outrow)
    s, ho, fo = tlong.score_qtile(t, o, len(blocks),
                                  torch.from_numpy(qp).contiguous(),
                                  gap_open, gap_extend, h, f)
    for b, tl in enumerate(last):
        for lane, val in big.items():
            fin = val + 10 * b
            assert int(s[b, lane]) == fin
            assert int(ho[tl, -1, lane]) == fin - (R - 1) * gap_extend
            assert int(fo[tl, -1, lane]) == fin - R * gap_extend
    # the other lanes score as a tile whose row above held no F at all
    f_none = f.clone()
    for tl in last:
        f_none[tl, -1, list(big)] = scorer.NEG
    s_none = tlong.score_qtile(t, o, len(blocks), torch.from_numpy(qp),
                               gap_open, gap_extend, h, f_none)[0]
    rest = [v for v in range(tiles.shape[2]) if v not in big]
    assert torch.equal(s[:, rest], s_none[:, rest])


@pytest.mark.parametrize("tile_m", [8, 32, 40, 72, 104])
def test_qtile_chain_scores_and_carries_equal_one_pass(tile_m):
    # random carries into the first tile (with lanes whose score comes
    # from the incoming F): the tiles chained give the one-pass scores AND
    # the one-pass outgoing carries
    _, qp, blocks, tiles, outrow = _case(31, 200, [32, 96, 64])
    qpp, n_qt = tlong.pad_to_tiles(torch.from_numpy(qp), tile_m)
    h, f, _ = _carries(np.random.default_rng(37), tiles, outrow, {1: 3000})
    t, o = torch.from_numpy(tiles), torch.from_numpy(outrow)
    s_one, h_one, f_one = tlong.score_qtile(t, o, len(blocks), qpp, 10, 2,
                                            h, f)
    best, hc, fc = None, h, f
    for qt in range(n_qt):
        out, hc, fc = tlong.score_qtile(
            t, o, len(blocks),
            qpp[:, qt * tile_m:(qt + 1) * tile_m].contiguous(), 10, 2, hc,
            fc)
        best = out if best is None else torch.maximum(best, out)
    assert torch.equal(best, s_one)
    assert torch.equal(hc, h_one) and torch.equal(fc, f_one)
    assert int(s_one[:, 1].min()) >= 3000


# ---- the pair form of kernel 2 and its 16-bit guard ----

W, C, H = (ALPHABET.index(a) for a in "WCH")


def _stream(blocks):
    """(tiles, outrow) of (L, V) int8 blocks, each L a multiple of 32."""
    tiles = np.concatenate([b.reshape(-1, 32, b.shape[1]) for b in blocks])
    outrow = np.concatenate(
        [[i] * (b.shape[0] // 32) for i, b in enumerate(blocks)]
    ).astype(np.int32)
    return torch.from_numpy(tiles), torch.from_numpy(outrow)


def _blocks(rng, planted, n_blocks, L, V=64):
    """n_blocks (L, V) blocks of short random lanes of codes 2-19, PAD
    behind them; planted {(block, lane): codes} laid over them."""
    blocks = []
    for _ in range(n_blocks):
        b = np.full((L, V), PAD_CODE, np.int8)
        for v in range(V):
            n = int(rng.integers(1, 60))
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
            n = int(np.argmax(lane == PAD_CODE)) if (lane == PAD_CODE).any() \
                else len(lane)
            out.append(lane[:n].astype(np.uint8))
    return out


def _w_run_case(rng):
    """BLOSUM62 (largest entry 11, so T = 32,756): a query with a run of
    2,980 W (W/W = 11) between C and H, and one block with lanes that score
    32,780 (the run: past 32,767), 32,797 (C, the run, H), 32,755 (2,977 W
    and H: T - 1) and 32,756 (C and 2,977 W: T)."""
    q = np.concatenate([rng.integers(2, 20, 40), [C], [W] * 2980, [H],
                        rng.integers(2, 20, 40)]).astype(np.uint8)
    planted = {(0, 1): [W] * 2980, (0, 7): [C] + [W] * 2980 + [H],
               (0, 20): [W] * 2977 + [H], (0, 33): [C] + [W] * 2977}
    blocks = _blocks(rng, planted, 1, 3008)
    scores = {(0, 1): 32780, (0, 7): 32797, (0, 20): 32755, (0, 33): 32756}
    return q, t_matrix("BLOSUM62"), blocks, 1024, scores


def _big_entry_case(rng):
    """A matrix whose A/A entry is 1,000 (T = 31,767), R/R 100 and N/N 1,
    over four blocks and 18 query tiles of 8 rows: lanes that score 33,000
    (33 A: past 32,767), 31,766 (31 A, 7 R and 66 N: T - 1) and 31,767
    (T), each in a block of its own, and a block of ordinary lanes only."""
    mat = t_matrix("BLOSUM62").copy()
    mat[0, 0], mat[1, 1], mat[2, 2] = 1000, 100, 1
    q = np.concatenate([[0] * 33, [1] * 7, [2] * 67,
                        rng.integers(3, 20, 30)]).astype(np.uint8)
    planted = {(0, 3): [0] * 33, (1, 40): [0] * 31 + [1] * 7 + [2] * 66,
               (2, 63): [0] * 31 + [1] * 7 + [2] * 67}
    blocks = _blocks(rng, planted, 4, 128)
    return q, mat, blocks, 8, {(0, 3): 33000, (1, 40): 31766,
                               (2, 63): 31767}


def _pair_form_alone(tiles, outrow, n_rows, qp, tile_m, go=10, ge=2):
    """Every query tile in the pair form, chained through its carries, and
    no second pass: the maximum over tiles."""
    qp, n_qt = tlong.pad_to_tiles(qp, tile_m)
    half = (*tiles.shape[:2], tiles.shape[2] // 2)
    h = torch.zeros(half, dtype=torch.int32)
    f = torch.full(half, tlong.pair_word(-(go + ge)), dtype=torch.int32)
    best = None
    for qt in range(n_qt):
        out, h, f = tlong.score_qtile_pairs(
            tiles, outrow, n_rows,
            qp[:, qt * tile_m:(qt + 1) * tile_m].contiguous(), go, ge, h, f)
        best = out if best is None else torch.maximum(best, out)
    return best


@pytest.mark.parametrize("make", [_w_run_case, _big_entry_case],
                         ids=["blosum62_w_run", "big_entry"])
def test_pair_form_rescores_every_lane_that_could_wrap(make):
    # the pair form scores in 16-bit lanes; every block with a lane at or
    # above T is scored again in int32, and the result equals the one-pass
    # plain walk and the C oracle bit for bit; without the second pass a
    # lane past 32,767 reads a wrong score (the test can fail: shown on the
    # small case, since each plain pass of the W run takes ~10 s)
    q, mat, blocks, tile_m, planted = make(np.random.default_rng(41))
    qp = torch.from_numpy(t_profile(q, mat, m_multiple=8))
    tiles, outrow = _stream(blocks)
    n_rows, V = len(blocks), blocks[0].shape[1]
    limit = tlong.pair_limit(int(qp.max()))
    assert tlong.pair_form_fits(V, 10, 2, int(qp.min()), int(qp.max()))
    exp = cref.sw_score_many(q, _lane_seqs(blocks), mat, 10, 2).reshape(
        n_rows, V)
    for (b, v), score in planted.items():
        assert exp[b, v] == score
    assert {s - limit for s in planted.values()} >= {-1, 0}

    before = tlong.score_tiles_long.rescored_blocks
    got = tlong.score_tiles_long(tiles, outrow, n_rows, qp, 10, 2,
                                 tile_m=tile_m).numpy()
    assert np.array_equal(got, exp)
    flagged = int((exp >= limit).any(axis=1).sum())
    assert flagged == len({b for (b, _), s in planted.items()
                           if s >= limit})
    assert tlong.score_tiles_long.rescored_blocks - before == flagged
    one = scorer.score_tiles_ref(tiles, outrow, n_rows, qp, 10, 2).numpy()
    assert np.array_equal(one, exp)
    if make is _w_run_case:
        return

    raw = _pair_form_alone(tiles, outrow, n_rows, qp, tile_m).numpy()
    low = exp < limit
    assert np.array_equal(raw[low], exp[low])     # exact below T
    assert (raw[~low] >= limit).all()             # at least T above it
    assert (raw != exp).any()                     # wrong without the pass


@pytest.mark.parametrize("V,gaps,entry", [
    (32, (10, 2), None), (96, (10, 2), None),     # no whole warps of pairs
    (64, (16000, 385), None),                     # 2 goe past 32,768
    (64, (10, 2), 32767 - 12 + 1)])               # S + goe past 32,767
def test_inputs_outside_the_pair_form_take_the_int32_form(V, gaps, entry,
                                                          monkeypatch):
    rng = np.random.default_rng(43)
    mat = t_matrix("BLOSUM62").copy()
    if entry is not None:
        mat[0, 0] = entry
    q = rng.integers(0, 20, 70).astype(np.uint8)
    qp = torch.from_numpy(t_profile(q, mat, m_multiple=8))
    blocks = _blocks(rng, {(1, 2): q[:50]}, 2, 64, V)
    tiles, outrow = _stream(blocks)
    assert not tlong.pair_form_fits(V, *gaps, int(qp.min()), int(qp.max()))

    def refuse(*a, **k):
        raise AssertionError("the pair form was taken")

    monkeypatch.setattr(tlong, "score_qtile_pairs", refuse)
    got = tlong.score_tiles_long(tiles, outrow, 2, qp, *gaps, tile_m=24)
    assert torch.equal(got, scorer.score_tiles_ref(tiles, outrow, 2, qp,
                                                   *gaps))
    exp = cref.sw_score_many(q, _lane_seqs(blocks), mat, *gaps)
    assert np.array_equal(got.numpy().reshape(-1), exp)


@pytest.mark.parametrize("tile_m,gaps", [(8, (10, 2)), (40, (0, 3)),
                                         (104, (5, 0)), (64, (0, 0))])
def test_pair_form_tile_equals_int32_tile(tile_m, gaps):
    # one pair-form launch (its plain version) with random carries in,
    # planted F lanes included: the int32 tile's scores and carries, in
    # lane pairs
    _, qp, blocks, tiles, outrow = _case(47, tile_m, [32, 96, 64], V=64)
    h, f, _ = _carries(np.random.default_rng(53), tiles, outrow, {6: 900})
    t, o = torch.from_numpy(tiles), torch.from_numpy(outrow)
    qpt = torch.from_numpy(qp)
    s, hc, fc = tlong.score_qtile(t, o, 3, qpt, *gaps, h, f)
    s2, hc2, fc2 = tlong.score_qtile_pairs(t, o, 3, qpt, *gaps,
                                           tlong.to_pairs(h),
                                           tlong.to_pairs(f))
    assert torch.equal(s2, s)
    assert torch.equal(tlong.from_pairs(hc2), hc)
    assert torch.equal(tlong.from_pairs(fc2), fc)
    assert int(s[:, 6].min()) >= 900


def test_lane_pairs_round_trip_and_the_bounds():
    x = torch.tensor([[0, -1, 32767, -32768, 5, -12]], dtype=torch.int32)
    p = tlong.to_pairs(x)
    assert p.shape == (1, 3)
    assert torch.equal(tlong.from_pairs(p), x)
    assert tlong.pair_word(-12) == int(tlong.to_pairs(torch.tensor(
        [-12, -12], dtype=torch.int32)))
    assert tlong.pair_limit(11) == 32756
    assert tlong.pair_form_fits(128, 10, 2, -64, 11)
    assert tlong.pair_form_fits(64, 16384, 0, -32768, 32767 - 16384)
    for args in ((64, 16384, 1, -4, 11), (64, 10, 2, -32769, 11),
                 (64, 10, 2, -4, 32756), (160, 10, 2, -4, 11)):
        assert not tlong.pair_form_fits(*args)
