"""swimm_tpu_torch's per-chunk scorers (plain PyTorch path of score_chunk,
score_chunk_qtile and score_chunk_long) against the JAX package's Pallas
chunk kernels (interpret mode), its XLA chunk scorer and the numpy Gotoh
oracle. Tolerance: bit-exact int32 — every path computes exact integers."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swimm_tpu.matrices import get_matrix
from swimm_tpu.models.profile import build_query_profile
from swimm_tpu.ops import longquery, pallas_scorer, reference, xla_scorer
from swimm_tpu.utils.synth import mutate, random_codes
from swimm_tpu_torch.ops import longquery as tlong
from swimm_tpu_torch.ops import scorer


def chunk_case(seed, qlen, B=3, L=64, V=8):
    rng = np.random.default_rng(seed)
    q = random_codes(rng, qlen)
    qp = build_query_profile(q, "BLOSUM62", m_multiple=8)
    codes = rng.integers(0, 20, size=(B, L, V), dtype=np.int8)
    hom = mutate(rng, q, sub_rate=0.05, indel_rate=0.01)[:L]
    codes[1, :len(hom), 2] = hom
    codes[:, L - 9:, 5] = 24                   # a PAD run at a lane's end
    return q, qp, codes


def oracle(q, codes, go, ge):
    B, L, V = codes.shape
    seqs = [codes[b, :, v][codes[b, :, v] != 24]
            for b in range(B) for v in range(V)]
    return reference.sw_score_many(q, seqs, get_matrix("BLOSUM62"), go,
                                   ge).reshape(B, V)


def port_chunk(codes, qp, go, ge, **kw):
    return scorer.score_chunk(torch.from_numpy(codes), torch.from_numpy(qp),
                              go, ge, **kw).numpy()


@pytest.mark.parametrize("ceiling", [None, 14])
def test_score_chunk_vs_pallas_xla_oracle(ceiling):
    q, qp, codes = chunk_case(51, 21)
    got = port_chunk(codes, qp, 10, 2, ceiling=ceiling)
    assert got.dtype == np.int32 and got.shape == codes.shape[::2]
    ref = np.asarray(pallas_scorer.score_chunk(
        jnp.asarray(codes), jnp.asarray(qp), 10, 2, interpret=True,
        ceiling=ceiling))
    assert np.array_equal(got, ref)
    exact = np.asarray(xla_scorer.score_chunk(jnp.asarray(codes),
                                              jnp.asarray(qp), 10, 2))
    assert np.array_equal(exact, oracle(q, codes, 10, 2))
    if ceiling is None:
        assert np.array_equal(got, exact)
        assert got[1, 2] > 60                  # the planted homolog
    else:
        # sub-ceiling lanes exact, the others report exactly the ceiling
        assert np.array_equal(got, np.minimum(exact, ceiling))
        assert (exact >= ceiling).any() and (exact < ceiling).any()


@pytest.mark.parametrize("qlen,gaps", [(8, (10, 2)), (70, (5, 0)),
                                       (40, (0, 3))])
def test_score_chunk_strips_and_gap_variants_vs_xla_oracle(qlen, gaps):
    # one 8-row strip; 32 + 32 + 8 rows with flat gap extension; free gap
    # opening
    q, qp, codes = chunk_case(52 + qlen, qlen, B=2, L=96)
    got = port_chunk(codes, qp, *gaps)
    assert np.array_equal(got, np.asarray(xla_scorer.score_chunk(
        jnp.asarray(codes), jnp.asarray(qp), *gaps)))
    assert np.array_equal(got, oracle(q, codes, *gaps))


def test_score_chunk_tiling_arguments_do_not_change_scores():
    _, qp, codes = chunk_case(53, 30, B=4)
    base = port_chunk(codes, qp, 10, 2)
    for kw in ({"jt_steps": 32}, {"jt_steps": 16, "precision": "int32"},
               {"lanes_per_block": 4}, {"lanes_per_block": 16}):
        assert np.array_equal(port_chunk(codes, qp, 10, 2, **kw), base), kw
    with pytest.raises(ValueError, match="jt_steps"):
        port_chunk(codes, qp, 10, 2, jt_steps=48)
    with pytest.raises(ValueError, match="lanes_per_block"):
        port_chunk(codes, qp, 10, 2, lanes_per_block=0)


def test_score_chunk_rejects_bad_inputs():
    _, qp, codes = chunk_case(54, 8)
    with pytest.raises(ValueError, match="int8"):
        port_chunk(codes.astype(np.int32), qp, 10, 2)
    with pytest.raises(ValueError, match="multiple of 32"):
        port_chunk(np.ascontiguousarray(codes[:, :40]), qp, 10, 2)
    with pytest.raises(ValueError, match="contiguous"):
        scorer.score_chunk(torch.from_numpy(codes)[:, :, ::2],
                           torch.from_numpy(qp), 10, 2)
    with pytest.raises(ValueError, match="max_query_pad"):
        port_chunk(codes, np.zeros((32, 2056), np.int32), 10, 2)
    with pytest.raises(ValueError, match="must be >= 0"):
        port_chunk(codes, qp, -1, 2)
    with pytest.raises(ValueError, match="precision"):
        port_chunk(codes, qp, 10, 2, precision="bf16")


def test_score_chunk_long_vs_pallas_and_oracle():
    q, qp, codes = chunk_case(55, 90, B=2, L=96)
    got = tlong.score_chunk_long(torch.from_numpy(codes),
                                 torch.from_numpy(qp), 10, 2,
                                 tile_m=32).numpy()
    ref = np.asarray(longquery.score_chunk_long(
        jnp.asarray(codes), jnp.asarray(qp), 10, 2, tile_m=32))
    assert got.dtype == np.int32 and np.array_equal(got, ref)
    assert np.array_equal(got, oracle(q, codes, 10, 2))
    assert got[1, 2] > 100                     # the planted homolog


@pytest.mark.parametrize("tile_m", [8, 40, 104, None])
def test_score_chunk_long_equals_one_pass_any_tile_m(tile_m):
    # splitting the query into tiles (incl. a tile_m that is not a multiple
    # of the 32-row strip, and the default 1024) never changes a score
    _, qp, codes = chunk_case(56, 100, B=2, L=64)
    one = port_chunk(codes, qp, 10, 1)
    got = tlong.score_chunk_long(torch.from_numpy(codes),
                                 torch.from_numpy(qp), 10, 1,
                                 tile_m=tile_m).numpy()
    assert np.array_equal(got, one)


def test_chunk_qtile_carries_chain_like_one_tile_and_like_the_stream():
    # two 16-row tiles chained through the carries give the scores and the
    # outgoing carries of one 32-row tile, and the chunk step equals the
    # stream step on the same codes seen as a tile stream
    _, qp, codes = chunk_case(57, 32, B=3, L=64)
    c, qpt = torch.from_numpy(codes), torch.from_numpy(qp)
    h0 = torch.zeros(c.shape, dtype=torch.int32)
    f0 = torch.full(c.shape, scorer.NEG, dtype=torch.int32)
    s_one, h_one, f_one = tlong.score_chunk_qtile(c, qpt, 10, 2, h0, f0)
    s_a, h_a, f_a = tlong.score_chunk_qtile(c, qpt[:, :16].contiguous(),
                                            10, 2, h0, f0)
    s_b, h_b, f_b = tlong.score_chunk_qtile(c, qpt[:, 16:].contiguous(),
                                            10, 2, h_a, f_a)
    assert torch.equal(torch.maximum(s_a, s_b), s_one)
    assert torch.equal(h_b, h_one) and torch.equal(f_b, f_one)
    tiles, row_start = scorer.chunk_as_stream(c)
    outrow = torch.repeat_interleave(torch.arange(3, dtype=torch.int32), 2)
    s_t, h_t, f_t = tlong.score_qtile(
        tiles, outrow, 3, qpt[:, 16:].contiguous(), 10, 2,
        h_a.reshape(tiles.shape), f_a.reshape(tiles.shape), row_start)
    assert torch.equal(s_t, s_b)
    assert torch.equal(h_t.reshape(c.shape), h_b)
    assert torch.equal(f_t.reshape(c.shape), f_b)
    with pytest.raises(ValueError, match="carries"):
        tlong.score_chunk_qtile(c, qpt, 10, 2, h0[:2].contiguous(), f0)
