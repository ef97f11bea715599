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
