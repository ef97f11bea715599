"""swimm_tpu_torch.models.qpack and ops.scorer.score_tiles_packed (plain
PyTorch path) against the JAX package: the packs array for array, the
packed scores against the Pallas packed kernel (interpret mode) and the
numpy Gotoh oracle per query. Tolerance: bit-exact int32 — every path
computes exact integers."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swimm_tpu.matrices import get_matrix
from swimm_tpu.models import qpack as jqpack
from swimm_tpu.ops import pallas_scorer, reference
from swimm_tpu.utils.synth import mutate, random_codes
from swimm_tpu_torch.models import qpack
from swimm_tpu_torch.ops import scorer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def ragged_db(rng, lengths, V=8, jt=32):
    blocks = [rng.integers(0, 20, size=(L, V), dtype=np.int8)
              for L in lengths]
    outrow = np.concatenate(
        [[i] * (b.shape[0] // jt) for i, b in enumerate(blocks)]
    ).astype(np.int32)
    return blocks, outrow


def as_tiles(blocks, jt=32):
    return np.concatenate([b.reshape(-1, jt, b.shape[1]) for b in blocks])


def port_planes(tiles, outrow, n_rows, pack, go, ge):
    return scorer.score_tiles_packed(
        torch.from_numpy(tiles), torch.from_numpy(outrow), n_rows,
        torch.from_numpy(pack.qp), torch.from_numpy(pack.seg_of_group),
        go, ge).numpy()


def jax_planes(tiles, outrow, n_rows, pack, go, ge):
    return np.asarray(pallas_scorer.score_tiles_packed(
        jnp.asarray(tiles), outrow, n_rows, jnp.asarray(pack.qp),
        pack.seg_of_group, go, ge, interpret=True))


def check_against_oracle(planes, pack, queries, blocks, go, ge):
    db_seqs = [b[:, v] for b in blocks for v in range(b.shape[1])]
    sub = get_matrix("BLOSUM62")
    for e in pack.entries:
        exp = reference.sw_score_many(queries[e.query_pos], db_seqs, sub,
                                      go, ge).reshape(len(blocks), -1)
        assert np.array_equal(planes[:, e.seg // 2, :], exp), e.query_pos
    used = {e.seg // 2 for e in pack.entries}
    for s in range(qpack.N_SEG_CAP // 2):
        if s not in used:
            assert (planes[:, s, :] == 0).all()


def test_module_constants_match_jax():
    for name in ("SUB", "N_SEG_CAP", "SEP_SCORE", "PACK_BUCKETS"):
        assert getattr(qpack, name) == getattr(jqpack, name), name
    for n in (0, 1, 8, 9, 1015, 1016, 1017):
        assert qpack._rows_needed(n) == jqpack._rows_needed(n)


@pytest.mark.parametrize("matrix,buckets", [("BLOSUM62", None),
                                            ("PAM250", (512, 1024))])
def test_packs_equal_jax_on_a_60_query_mix(matrix, buckets):
    rng = np.random.default_rng(40)
    lens = np.concatenate([rng.integers(1, 40, 20), rng.integers(40, 500, 35),
                           rng.integers(900, 1017, 5)])
    queries = [random_codes(rng, int(n)) for n in rng.permutation(lens)]
    kw = {} if buckets is None else {"buckets": buckets}
    got = qpack.build_query_packs(queries, matrix, **kw)
    ref = jqpack.build_query_packs(queries, matrix, **kw)
    assert [p.M for p in got] == [p.M for p in ref]
    assert sorted(e.query_pos for p in got for e in p.entries) == list(
        range(60))
    for g, r in zip(got, ref):
        assert g.qp.dtype == np.int32 and np.array_equal(g.qp, r.qp)
        assert g.seg_of_group.dtype == np.int32
        assert np.array_equal(g.seg_of_group, r.seg_of_group)
        assert g.n_seg == r.n_seg
        assert [vars(e) for e in g.entries] == [vars(e) for e in r.entries]


def test_pack_rejects_overlong_query_and_empty_batch():
    rng = np.random.default_rng(41)
    with pytest.raises(ValueError, match="long-query path"):
        qpack.build_query_packs(
            [random_codes(rng, qpack.PACK_BUCKETS[-1] + 1)])
    assert qpack._rows_needed(qpack.PACK_BUCKETS[-1] - 8) == \
        qpack.PACK_BUCKETS[-1]
    assert qpack.build_query_packs([]) == []


def test_packed_scores_leak_case_vs_pallas_and_oracle():
    # q0 has a strong homolog planted: big scores in the rows right above
    # q1's — the adversarial case for F or diagonal leaking across segments
    rng = np.random.default_rng(1)
    queries = [random_codes(rng, L) for L in (40, 16, 61, 24)]
    blocks, outrow = ragged_db(rng, [64, 96])
    hom = mutate(rng, queries[0], sub_rate=0.02, indel_rate=0.0)
    blocks[0][:len(hom), 3] = hom
    tiles = as_tiles(blocks)
    packs = qpack.build_query_packs(queries, buckets=(256,))
    assert len(packs) == 1
    got = port_planes(tiles, outrow, len(blocks), packs[0], 10, 2)
    assert got.dtype == np.int32
    assert got.shape == (len(blocks), qpack.N_SEG_CAP // 2, 8)
    assert np.array_equal(got, jax_planes(tiles, outrow, len(blocks),
                                          packs[0], 10, 2))
    check_against_oracle(got, packs[0], queries, blocks, 10, 2)
    assert got[0, :, 3].max() > 150          # the planted homolog


@pytest.mark.parametrize("gaps", [(12, 1), (0, 4), (5, 0)])
def test_packed_gap_variants_vs_pallas_and_oracle(gaps):
    rng = np.random.default_rng(2)
    queries = [random_codes(rng, L) for L in (33, 50)]
    blocks, outrow = ragged_db(rng, [32, 64])
    tiles = as_tiles(blocks)
    p = qpack.build_query_packs(queries, buckets=(128,))[0]
    got = port_planes(tiles, outrow, len(blocks), p, *gaps)
    assert np.array_equal(got, jax_planes(tiles, outrow, len(blocks), p,
                                          *gaps))
    check_against_oracle(got, p, queries, blocks, *gaps)


@pytest.mark.parametrize("lens,bucket", [((8,), 64), ((3, 8, 1, 5), 64),
                                         ((100, 7), 1024)])
def test_packed_layouts_vs_oracle(lens, bucket):
    # a one-group query, a pack filled to its bucket exactly (the last
    # separator is the pack's last group), a pack with a large unused tail
    rng = np.random.default_rng(sum(lens))
    queries = [random_codes(rng, L) for L in lens]
    blocks, outrow = ragged_db(rng, [64, 32])
    tiles = as_tiles(blocks)
    p = qpack.build_query_packs(queries, buckets=(bucket,))[0]
    assert p.M == bucket
    if lens == (3, 8, 1, 5):
        assert sum(qpack._rows_needed(n) for n in lens) == bucket
    got = port_planes(tiles, outrow, len(blocks), p, 10, 2)
    check_against_oracle(got, p, queries, blocks, 10, 2)


def cut_pack(pack, M):
    """The pack's first M rows (any M % 8 == 0 is a legal profile), with
    the entries that lie wholly inside them."""
    entries = [e for e in pack.entries if e.row_start + e.n_rows <= M]
    return qpack.QueryPack(np.ascontiguousarray(pack.qp[:, :M]),
                           np.ascontiguousarray(pack.seg_of_group[:M // 8]),
                           entries, pack.n_seg)


# the strip shapes of the CUDA kernel's walk (32 rows, then 8; two workers
# take alternate strips and fold their maxima into shared planes): one
# 8-row strip without a separator; 32 + 8 rows with the second query in
# rows 24-39; 32 + 32 + 8 rows with the second query in rows 56-71; five
# strips under one query. A homolog of the rows just ABOVE a strip boundary
# that the query straddles is planted, where a lost or leaked maximum would
# show. The card check holds the kernel against the plain version on the
# same layouts.
@pytest.mark.parametrize("lens,M,who,rows", [
    ((8,), 8, 0, (0, 8)),
    ((12, 12), 40, 1, (0, 8)),
    ((45, 12), 72, 1, (0, 8)),
    ((130, 12), 160, 0, (24, 64)),
])
def test_packed_cut_to_odd_strip_counts_vs_pallas_and_oracle(lens, M, who,
                                                             rows):
    rng = np.random.default_rng(300 + M)
    queries = [random_codes(rng, L) for L in lens]
    blocks, outrow = ragged_db(rng, [64, 32, 96])
    hom = mutate(rng, queries[who][rows[0]:rows[1]], sub_rate=0.02,
                 indel_rate=0.0)
    blocks[0][:len(hom), 3] = hom
    tiles = as_tiles(blocks)
    full = qpack.build_query_packs(queries, buckets=(256,))[0]
    p = cut_pack(full, M)
    assert p.M == M and [e.query_pos for e in p.entries] == list(
        range(len(lens)))
    e = next(e for e in p.entries if e.query_pos == who)
    if M > 32:      # the query with the homolog straddles a strip boundary
        assert e.row_start < 32 * (1 + e.row_start // 32) < (e.row_start
                                                             + e.n_rows)
    got = port_planes(tiles, outrow, len(blocks), p, 10, 2)
    assert np.array_equal(got, jax_planes(tiles, outrow, len(blocks), p,
                                          10, 2))
    check_against_oracle(got, p, queries, blocks, 10, 2)
    assert got[0, e.seg // 2, 3] >= 3 * (rows[1] - rows[0])


def test_score_tiles_packed_rejects_bad_inputs():
    rng = np.random.default_rng(42)
    blocks, outrow = ragged_db(rng, [32])
    tiles = as_tiles(blocks)
    p = qpack.build_query_packs([random_codes(rng, 20)], buckets=(64,))[0]
    args = (torch.from_numpy(tiles), torch.from_numpy(outrow), 1,
            torch.from_numpy(p.qp))
    seg = torch.from_numpy(p.seg_of_group)
    with pytest.raises(ValueError, match="seg_of_group"):
        scorer.score_tiles_packed(*args, seg[:-1].contiguous(), 10, 2)
    with pytest.raises(ValueError, match="seg_of_group"):
        scorer.score_tiles_packed(*args, seg.long(), 10, 2)
    with pytest.raises(ValueError, match="n_seg_cap"):
        scorer.score_tiles_packed(*args, seg, 10, 2, n_seg_cap=7)
    with pytest.raises(ValueError, match="nondecreasing"):
        scorer.score_tiles_packed(*args, seg.flip(0).contiguous(), 10, 2)
    with pytest.raises(ValueError, match="must be >= 0"):
        scorer.score_tiles_packed(*args, seg, -1, 2)
    with pytest.raises(ValueError, match="precision"):
        scorer.score_tiles_packed(*args, seg, 10, 2, precision="bf16")
