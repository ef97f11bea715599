"""swimm_tpu_torch's per-chunk scorers (plain PyTorch path of score_chunk,
score_chunks, score_chunk_qtile and score_chunk_long) against the JAX package's Pallas
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
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


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


def chunk_list(seed, qlen, shapes, V=8):
    """Separately allocated chunks of different B and L, a homolog of the
    query planted in each, a PAD run at a lane's end."""
    rng = np.random.default_rng(seed)
    q = random_codes(rng, qlen)
    qp = build_query_profile(q, "BLOSUM62", m_multiple=8)
    chunks = []
    for B, L in shapes:
        codes = rng.integers(0, 20, size=(B, L, V), dtype=np.int8)
        hom = mutate(rng, q, sub_rate=0.05, indel_rate=0.01)[:L]
        codes[B - 1, :len(hom), 2] = hom
        codes[:, L - 9:, 5] = 24
        chunks.append(codes)
    return q, qp, chunks


THREE = ((2, 96), (1, 32), (3, 64))


@pytest.mark.parametrize("n_full,last", [
    pytest.param(n_full, last, id=f"{n_full}x64+{last}")
    for n_full in (1, 2) for last in (8, 16, 32, 56)])
def test_chunks_long_short_last_tile_equals_one_pass(n_full, last,
                                                     monkeypatch):
    # one or two full 64-row tiles, then a last tile of 8, 16, 32 or
    # tile_m - 8 rows: chained through random carries, the one-pass scores
    # and outgoing carries; score_chunks_long over two chunks launches
    # exactly those tiles and gives the one-pass scores
    tile_m = 64
    rng = np.random.default_rng(81)
    _, qp, chunks = chunk_list(81, n_full * tile_m + last, THREE[:2])
    qpt = torch.from_numpy(qp)
    assert qpt.shape[1] == n_full * tile_m + last
    for codes in chunks:
        c = torch.from_numpy(codes)
        h = torch.from_numpy(rng.integers(0, 6, c.shape, dtype=np.int32))
        f = torch.from_numpy(rng.integers(-40, 10, c.shape, dtype=np.int32))
        s_one, h_one, f_one = tlong.score_chunk_qtile_ref(c, qpt, 10, 2, h,
                                                          f)
        best, hc, fc = None, h, f
        for qp_tile in tlong.tile_profiles(qpt, tile_m):
            out, hc, fc = tlong.score_chunk_qtile(c, qp_tile, 10, 2, hc, fc)
            best = out if best is None else torch.maximum(best, out)
        assert torch.equal(best, s_one)
        assert torch.equal(hc, h_one) and torch.equal(fc, f_one)
    seen, inner = [], tlong.score_chunks_qtile

    def spy(chunks, qp_tile, *a, **k):
        seen.append(qp_tile.shape[1])
        return inner(chunks, qp_tile, *a, **k)

    monkeypatch.setattr(tlong, "score_chunks_qtile", spy)
    tc = [torch.from_numpy(c) for c in chunks]
    got = tlong.score_chunks_long(tc, qpt, 10, 2, tile_m=tile_m)
    assert seen == [tile_m] * n_full + [last]
    for g, c in zip(got, chunks):
        assert np.array_equal(g.numpy(), port_chunk(c, qp, 10, 2))


@pytest.mark.parametrize("seed,qlen,gaps,V,tile_m,shapes,vs_jax", [
    pytest.param(61, 90, (10, 2), 8, 32, THREE, True, id="61-90-gaps0"),
    pytest.param(62, 95, (10, 2), 8, 32, THREE, True, id="62-95-gaps1"),
    pytest.param(63, 70, (5, 0), 8, 32, THREE, False, id="63-70-gaps2"),
    # the shapes the card holds sw_chunk_qtile_kernel's carry form to: one
    # 8-row strip a tile, flat and free gaps (0/0), 256 and 512 lanes,
    # 1024-row tiles, chunks of one 32-position block (chunks of one shape
    # share one Pallas compile)
    pytest.param(71, 20, (0, 0), 8, 8, ((1, 32), (2, 64)), True,
                 id="tile_m8-gaps0-0"),
    pytest.param(72, 90, (10, 2), 256, 32, ((2, 32), (2, 32)), True,
                 id="V256"),
    pytest.param(73, 60, (0, 0), 512, 1024, ((1, 32), (1, 32)), True,
                 id="V512-tile_m1024-gaps0-0"),
])
def test_score_chunks_long_list_vs_one_chunk_pallas_and_one_pass(
        seed, qlen, gaps, V, tile_m, shapes, vs_jax):
    # B = 1 in a chunk of one 32-position tile: the list form gives, chunk
    # for chunk, the one-chunk form's scores, the one-pass plain scorer's,
    # the oracle's and (vs_jax; each chunk shape compiles a Pallas kernel)
    # the JAX package's
    q, qp, chunks = chunk_list(seed, qlen, shapes, V=V)
    tc = [torch.from_numpy(c) for c in chunks]
    tqp = torch.from_numpy(qp)
    got = tlong.score_chunks_long(tc, tqp, *gaps, tile_m=tile_m)
    assert len(got) == len(chunks)
    for codes, c, g in zip(chunks, tc, got):
        assert g.dtype == torch.int32 and g.shape == codes.shape[::2]
        assert torch.equal(g, tlong.score_chunk_long(c, tqp, *gaps,
                                                     tile_m=tile_m))
        assert np.array_equal(g.numpy(), port_chunk(codes, qp, *gaps))
        assert np.array_equal(g.numpy(), oracle(q, codes, *gaps))
        if vs_jax:
            assert np.array_equal(g.numpy(), np.asarray(
                longquery.score_chunk_long(jnp.asarray(codes),
                                           jnp.asarray(qp), *gaps,
                                           tile_m=tile_m)))


@pytest.mark.parametrize("ceiling,with_table", [(None, False), (None, True),
                                                (14, False), (14, True)])
def test_score_chunks_list_vs_one_chunk_pallas_and_oracle(ceiling,
                                                          with_table):
    # separately allocated chunks of different B and L, the longest neither
    # first nor last: the list form gives, chunk for chunk, score_chunk's
    # scores, the JAX package's and the oracle's
    q, qp, chunks = chunk_list(67, 21, [(2, 64), (1, 32), (3, 96), (1, 64)])
    tc = [torch.from_numpy(c) for c in chunks]
    tqp = torch.from_numpy(qp)
    table = scorer.ChunkTable(tc) if with_table else None
    got = scorer.score_chunks(tc, tqp, 10, 2, ceiling=ceiling, table=table)
    assert len(got) == len(chunks)
    hit_ceiling = False
    for codes, c, g in zip(chunks, tc, got):
        assert g.dtype == torch.int32 and g.shape == codes.shape[::2]
        assert torch.equal(g, scorer.score_chunk(c, tqp, 10, 2,
                                                 ceiling=ceiling))
        assert np.array_equal(g.numpy(), np.asarray(
            pallas_scorer.score_chunk(jnp.asarray(codes), jnp.asarray(qp),
                                      10, 2, interpret=True,
                                      ceiling=ceiling)))
        exact = oracle(q, codes, 10, 2)
        if ceiling is not None:
            hit_ceiling |= bool((exact >= ceiling).any())
            exact = np.minimum(exact, ceiling)
        assert np.array_equal(g.numpy(), exact)
        assert ceiling is not None or g[-1, 2] > 60    # the planted homolog
    assert hit_ceiling == (ceiling is not None)


def test_score_chunks_rejects_bad_inputs():
    _, qp, chunks = chunk_list(68, 20, [(2, 64), (1, 32), (3, 96)])
    tc = [torch.from_numpy(c) for c in chunks]
    tqp = torch.from_numpy(qp)
    with pytest.raises(ValueError, match="other chunks"):
        scorer.score_chunks(tc[:2], tqp, 10, 2,
                            table=scorer.ChunkTable(tc))
    with pytest.raises(ValueError, match="other chunks"):
        scorer.score_chunks([c.clone() for c in tc], tqp, 10, 2,
                            table=scorer.ChunkTable(tc))
    with pytest.raises(ValueError, match="at least one chunk"):
        scorer.score_chunks([], tqp, 10, 2)
    with pytest.raises(ValueError, match="max_query_pad"):
        scorer.score_chunks(tc, torch.zeros((32, 2056), dtype=torch.int32),
                            10, 2)
    with pytest.raises(ValueError, match="multiple of 32"):
        scorer.score_chunks(tc + [tc[0][:, :40].contiguous()], tqp, 10, 2)
    with pytest.raises(ValueError, match="share V"):
        scorer.score_chunks([tc[0], tc[1][:, :, :4].contiguous()], tqp, 10, 2)
    with pytest.raises(ValueError, match="precision"):
        scorer.score_chunks(tc, tqp, 10, 2, precision="bf16")


def test_chunk_table_maps_blocks_longest_first():
    _, qp, chunks = chunk_list(64, 20, [(2, 64), (1, 32), (3, 96), (1, 64)])
    tc = [torch.from_numpy(c) for c in chunks]
    table = scorer.ChunkTable(tc)
    assert (table.n_blocks, table.V) == (7, 8)
    assert table.numel == sum(c.size for c in chunks)
    # (chunk, block within it), longest L first, list order among equals
    assert table.block_map.tolist() == [[2, 0], [2, 1], [2, 2], [0, 0],
                                        [0, 1], [3, 0], [1, 0]]
    flat = torch.arange(table.numel, dtype=torch.int32)
    views = table.carry_views(flat)
    assert [v.shape for v in views] == [c.shape for c in tc]
    assert views[2].data_ptr() == flat[(2 * 64 + 32) * 8:].data_ptr()
    outs = table.out_views(torch.zeros((7, 8), dtype=torch.int32))
    assert [o.shape[0] for o in outs] == [2, 1, 3, 1]
    desc = table.bind(views, views, outs)
    assert desc.shape == (4, 6) and desc.dtype == torch.int64
    assert desc[:, 0].tolist() == [c.data_ptr() for c in tc]
    assert desc[:, 3].tolist() == [o.data_ptr() for o in outs]
    assert desc[:, 4:].tolist() == [[2, 64], [1, 32], [3, 96], [1, 64]]
    assert table.matches(tc) and not table.matches(tc[:3])
    with pytest.raises(ValueError, match="other chunks"):
        tlong.score_chunks_qtile(tc[:3], torch.from_numpy(qp), 10, 2,
                                 views[:3], views[:3], table)
    with pytest.raises(ValueError, match="share V"):
        scorer.ChunkTable([tc[0], tc[1][:, :, :4].contiguous()])
    with pytest.raises(ValueError, match="one length"):
        tlong.score_chunks_qtile(tc, torch.from_numpy(qp), 10, 2, views,
                                 views[:3])


def small_db(tmp_path, recs, V=8):
    from swimm_tpu.db import build_db as j_build_db
    from swimm_tpu_torch.db import build_db
    return (build_db(recs, tmp_path / "t", V=V),
            j_build_db(recs, tmp_path / "j", V=V, use_native=False))


def test_chunk_table_is_built_once_per_db_and_device(tmp_path, monkeypatch):
    from swimm_tpu_torch.fasta import FastaRecord
    from swimm_tpu_torch.models import engine
    from swimm_tpu_torch.utils.synth import synth_db
    built = []
    init = scorer.ChunkTable.__init__
    monkeypatch.setattr(scorer.ChunkTable, "__init__",
                        lambda self, chunks: (built.append(len(chunks)),
                                              init(self, chunks))[1])
    monkeypatch.setattr(scorer, "max_query_pad", lambda: 32)
    monkeypatch.setattr(tlong, "LONG_TILE_M", 32)
    pt, _ = small_db(tmp_path, synth_db(40, seed=7, median_len=40,
                                        max_len=100))
    rng = np.random.default_rng(65)
    for n in (70, 100, 20):          # two long queries (3 and 4 tiles), one
        engine.score_db(pt, FastaRecord("q", random_codes(rng, n)),   # short
                        engine.SearchConfig(), device="cpu")
    assert built == [len(pt.chunks)]
    chunks, table = engine.device_chunk_table(pt, "cpu")
    assert engine.device_chunk_table(pt, "cpu")[1] is table
    assert table.matches(engine.device_chunks(pt, "cpu"))
    assert table.n_blocks == sum(ch.n_blocks for ch in pt.chunks)


def test_score_db_long_query_through_the_list_form_matches_jax(tmp_path,
                                                               monkeypatch):
    # with the one-pass limit lowered to 32 rows a 100-aa query takes the
    # port's query-tiled path (4 tiles of 32 rows over all chunks at once)
    from swimm_tpu.fasta import FastaRecord as JRecord
    from swimm_tpu.models import engine as jengine
    from swimm_tpu_torch.fasta import FastaRecord
    from swimm_tpu_torch.models import engine
    from swimm_tpu_torch.utils.synth import synth_db
    monkeypatch.setattr(scorer, "max_query_pad", lambda: 32)
    monkeypatch.setattr(tlong, "LONG_TILE_M", 32)
    rng = np.random.default_rng(66)
    q = FastaRecord("q", random_codes(rng, 100))
    recs = synth_db(60, seed=11, median_len=50, max_len=150)
    recs[17] = FastaRecord("hom planted_homolog",
                           mutate(rng, q.codes[:80], 0.1, 0.0))
    pt, pj = small_db(tmp_path, recs)
    assert len(pt.chunks) > 2
    calls = []
    inner = tlong.score_chunks_qtile
    monkeypatch.setattr(tlong, "score_chunks_qtile",
                        lambda *a, **k: (calls.append(len(a[0])),
                                         inner(*a, **k))[1])
    got = engine.score_db(pt, q, engine.SearchConfig(), device="cpu")
    assert calls == [len(pt.chunks)] * 4   # one call per query tile
    ref = jengine.score_db(pj, JRecord(q.title, q.codes),
                           jengine.SearchConfig(backend="xla"))
    assert got.dtype == np.int32 and np.array_equal(got, ref)
    assert engine.top_k_hits(pt, got, 1)[0].title == "hom planted_homolog"


def test_score_db_short_query_through_the_list_form_matches_jax(tmp_path,
                                                                monkeypatch):
    # a query of at most max_query_pad() rows takes the one-pass chunk
    # scorer's list form: one call over all the chunks with the cached table
    from swimm_tpu.fasta import FastaRecord as JRecord
    from swimm_tpu.models import engine as jengine
    from swimm_tpu_torch.fasta import FastaRecord
    from swimm_tpu_torch.models import engine
    from swimm_tpu_torch.utils.synth import synth_db
    rng = np.random.default_rng(69)
    q = FastaRecord("q", random_codes(rng, 70))
    recs = synth_db(60, seed=12, median_len=50, max_len=150)
    recs[23] = FastaRecord("hom planted_homolog",
                           mutate(rng, q.codes[:60], 0.1, 0.0))
    pt, pj = small_db(tmp_path, recs)
    assert len(pt.chunks) > 2
    calls = []
    inner = scorer.score_chunks
    monkeypatch.setattr(scorer, "score_chunks",
                        lambda chunks, *a, **k: (
                            calls.append((len(chunks), k.get("table"))),
                            inner(chunks, *a, **k))[1])
    got = engine.score_db(pt, q, engine.SearchConfig(), device="cpu")
    assert calls == [(len(pt.chunks), engine.device_chunk_table(pt, "cpu")[1])]
    ref = jengine.score_db(pj, JRecord(q.title, q.codes),
                           jengine.SearchConfig(backend="xla"))
    assert got.dtype == np.int32 and np.array_equal(got, ref)
    assert engine.top_k_hits(pt, got, 1)[0].title == "hom planted_homolog"
