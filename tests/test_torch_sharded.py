"""swimm_tpu_torch.parallel's sharded resident search (mesh.py,
sharded_search.py) against swimm_tpu.parallel's on the CPU: the port's
meshes of ['cpu'] * n devices (device='cpu': the plain PyTorch scorers)
against swimm_tpu's meshes of the 8 virtual XLA devices that
tests/conftest.py provides (backend 'xla'). Hit lists (rank, score, sorted
and original index, title), E-values and bit scores, shard cuts and
ValueErrors are compared bit for bit: tolerance 0 throughout, every path
computes exact integers and the fits read the same integer tables."""

import numpy as np
import pytest
import torch

from swimm_tpu.db import build_db as j_build_db
from swimm_tpu.fasta import FastaRecord as JRecord
from swimm_tpu.models import engine as jengine
from swimm_tpu.parallel import mesh as jmesh
from swimm_tpu.parallel import sharded_search as jsharded
from swimm_tpu_torch import SearchConfig, build_db, search
from swimm_tpu_torch.alphabet import PAD_CODE
from swimm_tpu_torch.fasta import FastaRecord
from swimm_tpu_torch.models import engine
from swimm_tpu_torch.parallel import sharded_search as sharded
from swimm_tpu_torch.parallel.mesh import balanced_2d, make_mesh
from swimm_tpu_torch.utils.synth import random_codes, synth_db, synth_queries
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _jq(queries):
    return [JRecord(q.title, q.codes) for q in queries]


def _hits(results):
    return [[(h.rank, h.score, h.sorted_idx, h.orig_idx, h.title, h.evalue,
              h.bits) for h in r.hits] for r in results]


def _cpu_mesh(n, query_axis=1):
    return make_mesh(n, query_axis=query_axis, devices=["cpu"] * n)


def _pair(recs, d, V):
    return build_db(recs, d / "t", V=V), j_build_db(recs, d / "j", V=V,
                                                     use_native=False)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """200 sequences of up to 200 aa (V=16: 13 blocks), four queries in
    three padded-length groups with planted homologs: the reference
    suite's world."""
    queries = synth_queries(4, [40, 64, 100, 30], seed=5)
    recs = synth_db(200, seed=11, median_len=60, sigma=0.4, max_len=200,
                    queries=[q.codes for q in queries], homolog_frac=0.05)
    pt, pj = _pair(recs, tmp_path_factory.mktemp("sharded"), 16)
    ref = _hits(jengine.search(pj, _jq(queries), jengine.SearchConfig(
        backend="xla", top_k=8))[0])
    return pt, pj, queries, ref


def _jsharded(pj, queries, query_axis, n=8, **cfg):
    return _hits(jsharded.sharded_search(
        pj, _jq(queries), jengine.SearchConfig(backend="xla", **cfg),
        mesh=jmesh.make_mesh(n, query_axis=query_axis))[0])


def test_balanced_2d():
    for n in (1, 2, 7, 8, 12, 16, 36):
        assert balanced_2d(n) == jmesh.balanced_2d(n)
    assert balanced_2d(8) == (4, 2) and balanced_2d(7) == (7, 1)


@pytest.mark.parametrize("query_axis", [1, 2, 4])
def test_sharded_equals_reference(world, query_axis):
    pt, pj, queries, ref = world
    got, met = sharded.sharded_search(pt, queries, SearchConfig(top_k=8),
                                      mesh=_cpu_mesh(8, query_axis))
    assert _hits(got) == ref
    assert _hits(got) == _jsharded(pj, queries, query_axis, top_k=8)
    assert met.n_queries == len(queries) and met.gcups > 0
    assert set(met.timers) == {"h2d", "profiles", "score+merge",
                               "final_topk"}


def test_single_device_mesh(world):
    pt, _, queries, ref = world
    got, _ = sharded.sharded_search(pt, queries, SearchConfig(top_k=8),
                                    mesh=_cpu_mesh(1))
    assert _hits(got) == ref


@pytest.mark.parametrize("n_data", [3, 5, 13, 16])
def test_uneven_and_empty_shards(world, n_data):
    """Block counts that do not divide the data axis, one block a shard,
    and more shards than blocks (empty shards, never launched)."""
    pt, _, queries, ref = world
    before = sharded.build_tile_shards(pt, _cpu_mesh(n_data))
    sizes = [s.n_rows for (_, _), s in sorted(before["shards"].items())]
    assert sum(sizes) == sum(ch.n_blocks for ch in pt.chunks)
    got, _ = sharded.sharded_search(pt, queries, SearchConfig(top_k=8),
                                    mesh=_cpu_mesh(n_data))
    assert _hits(got) == ref


def test_split_score_merge_equals_fused(world):
    pt, pj, queries, ref = world
    got, met = sharded.sharded_search(pt, queries, SearchConfig(top_k=8),
                                      mesh=_cpu_mesh(8, 2),
                                      measure_merge=True)
    assert _hits(got) == ref
    for name in ("score", "merge", "d2h", "final_topk"):
        assert met.timers[name] > 0
    groups = len(engine.group_by_m_pad(queries, 16))
    assert met.timers["merge_collectives"]["count"] == groups
    # the split steps return what the fused step does
    mesh = _cpu_mesh(4, 2)
    shards = sharded.build_tile_shards(pt, mesh)
    prof = sharded._cell_profiles(queries[:3], SearchConfig(), mesh)
    assert [p is None for p in prof["cpu"]] == [False, False, False, True]
    assert {p.kernel for p in prof["cpu"][:3]} == {"sw_ragged_kernel"}
    kw = dict(mesh=mesh, config=SearchConfig(), k=8)
    fused = sharded.sharded_tiles_topk(shards, prof, **kw)
    split = sharded.merge_candidates(sharded.sharded_tiles_local_topk(
        shards, prof, **kw), mesh=mesh)
    for q in fused:
        for a, b in zip(fused[q], split[q]):
            assert torch.equal(a, b)
    assert fused[0][0].shape == (2, 2 * min(8, shards["R_loc"] * 16))
    assert (fused[1][0][1] == -1).all()      # the pad query: not launched


def test_sharded_empty_query_batch(world):
    pt, _, _, _ = world
    results, metrics = sharded.sharded_search(pt, [], SearchConfig(top_k=8),
                                              mesh=_cpu_mesh(4))
    assert results == [] and metrics.n_queries == 0


def test_sharded_randomized_worlds(tmp_path):
    """Random DB sizes (down to fewer blocks than shards), V widths, batch
    mixes and mesh shapes: the port's sharded hits equal swimm_tpu's
    sharded and resident hits in every draw."""
    rng = np.random.default_rng(99)
    for trial in range(4):
        n_seqs = int(rng.integers(10, 400))
        V = int(rng.choice([8, 16, 32]))
        nq = int(rng.integers(1, 6))
        qlens = [int(rng.integers(5, 200)) for _ in range(nq)]
        queries = synth_queries(nq, qlens, seed=200 + trial)
        recs = synth_db(n_seqs, seed=300 + trial, median_len=60, sigma=0.6,
                        max_len=300, queries=[q.codes for q in queries],
                        homolog_frac=0.05)
        pt, pj = _pair(recs, tmp_path / str(trial), V)
        qa = int(rng.choice([1, 2, 4]))
        got = _hits(sharded.sharded_search(pt, queries,
                                           SearchConfig(top_k=8),
                                           mesh=_cpu_mesh(8, qa))[0])
        ref = _hits(jengine.search(pj, _jq(queries), jengine.SearchConfig(
            backend="xla", top_k=8))[0])
        assert got == ref, (trial, n_seqs, V, qlens, qa)
        assert got == _jsharded(pj, queries, qa, top_k=8), trial


def test_long_query_over_2048_rows(tmp_path):
    """A 2,050-aa query (2,064 padded rows: kernel 2's mode, three query
    tiles per shard) beside a short one, over 4 shards."""
    rng = np.random.default_rng(22)
    long_q = FastaRecord("long", random_codes(rng, 2050))
    queries = [long_q, FastaRecord("short", random_codes(rng, 20))]
    recs = synth_db(40, seed=3, median_len=40, max_len=100)
    recs[5] = FastaRecord("hom planted_homolog", long_q.codes[100:160])
    pt, pj = _pair(recs, tmp_path, 8)
    ref = _hits(jengine.search(pj, _jq(queries), jengine.SearchConfig(
        backend="xla", top_k=5))[0])
    for qa in (1, 2):
        got, met = sharded.sharded_search(pt, queries, SearchConfig(top_k=5),
                                          mesh=_cpu_mesh(4, qa))
        assert _hits(got) == ref
        assert got[0].hits[0].title == "hom planted_homolog"


@pytest.mark.parametrize("query_axis", [1, 2])
def test_evalues_equal_reference(world, query_axis):
    pt, pj, queries, _ = world
    cfg = SearchConfig(top_k=8, evalue=True)
    got, _ = sharded.sharded_search(pt, queries, cfg,
                                    mesh=_cpu_mesh(8, query_axis))
    assert _hits(got) == _jsharded(pj, queries, query_axis, top_k=8,
                                   evalue=True)
    assert _hits(got) == _hits(search(pt, queries, cfg, device="cpu")[0])
    assert all(h.evalue is not None for r in got for h in r.hits)


@pytest.mark.parametrize("n_data", [1, 2, 3, 4, 8, 16])
def test_plan_tile_shards_equal_reference(world, n_data):
    """The same cuts, rows and lanes; the port's shard is the reference's
    without its PAD tiles and trash row."""
    pt, pj, _, _ = world
    shapes, build = sharded.plan_tile_shards(pt, n_data)
    jshapes, jbuild = jsharded.plan_tile_shards(pj, n_data)
    for key in ("T_max", "R_loc", "V", "n_data", "jt"):
        assert shapes[key] == jshapes[key], key
    for d in range(n_data):
        tiles, outrow, valid, l2s = build(d)
        jt, jo, jv, jl = jbuild(d)
        n = tiles.shape[0]
        assert np.array_equal(tiles, jt[:n]) and (jt[n:] == PAD_CODE).all()
        assert np.array_equal(outrow, jo[:n])
        assert (jo[n:] == shapes["R_loc"] - 1).all()
        assert np.array_equal(valid, jv[:valid.size]) and not jv[
            valid.size:].any()
        assert np.array_equal(l2s[valid], jl[:valid.size][valid])
        rows = shapes["bounds"][d + 1] - shapes["bounds"][d]
        assert valid.size == rows * shapes["V"]


def test_value_errors_equal_reference(world):
    pt, pj, queries, _ = world
    cases = [(dict(top_k=8), dict(topk_per_shard=4)),
             (dict(top_k=8, evalue=True), dict(measure_merge=True))]
    for cfg, kw in cases:
        with pytest.raises(ValueError) as port:
            sharded.sharded_search(pt, queries, SearchConfig(**cfg),
                                   mesh=_cpu_mesh(2), **kw)
        with pytest.raises(ValueError) as ref:
            jsharded.sharded_search(pj, _jq(queries), jengine.SearchConfig(
                backend="xla", **cfg), mesh=jmesh.make_mesh(2), **kw)
        assert str(port.value) == str(ref.value)


def test_tie_straddles_shard_cut(tmp_path):
    """30 copies of one homolog (one length, so adjacent in sorted order,
    over four 8-lane blocks): a shard cut falls inside the run and top_k
    = 10 cuts inside the tie; the kept hits are the 10 lowest sorted
    indices, as in the resident search and swimm_tpu's."""
    rng = np.random.default_rng(7)
    q = FastaRecord("q", random_codes(rng, 60))
    recs = synth_db(150, seed=8, median_len=60, sigma=0.3, max_len=120)
    for j in range(30):
        recs[5 * j] = FastaRecord(f"dup{j}", q.codes[5:55].copy())
    pt, pj = _pair(recs, tmp_path, 8)
    ref = _hits(jengine.search(pj, _jq([q]), jengine.SearchConfig(
        backend="xla", top_k=10))[0])
    mask, l2s = pt.lane_maps()
    dup_rows = [lane // 8 for lane in np.nonzero(mask)[0]
                if pt.title_of_sorted(int(l2s[lane])).startswith("dup")]
    straddled = 0
    for n_data in (2, 3, 4, 5, 6):
        bounds = sharded.plan_tile_shards(pt, n_data)[0]["bounds"]
        straddled += any(min(dup_rows) < b <= max(dup_rows)
                         for b in bounds[1:-1])
        got = _hits(sharded.sharded_search(pt, [q], SearchConfig(top_k=10),
                                           mesh=_cpu_mesh(n_data))[0])
        assert got == ref, n_data
    assert straddled, "no shard cut fell inside the tied run"
    assert len({h[1] for h in ref[0]}) == 1          # all 10 tied
    assert _jsharded(pj, [q], 1, n=4, top_k=10) == ref


def test_padded_cells_count_the_fill(world):
    """Divergence kept on purpose (ROADMAP Queue 3): shards are launched at
    their fill, so padded_cells counts the stream's tiles once (the
    resident search's count); swimm_tpu's counts every shard padded to
    T_max, and the query axis's pad profiles."""
    pt, pj, queries, _ = world
    cfg = SearchConfig(top_k=8)
    _, met = sharded.sharded_search(pt, queries, cfg, mesh=_cpu_mesh(8, 4))
    _, res = search(pt, queries, cfg, device="cpu")
    _, jmet = jsharded.sharded_search(pj, _jq(queries), jengine.SearchConfig(
        backend="xla", top_k=8), mesh=jmesh.make_mesh(8, query_axis=4))
    assert met.padded_cells == res.padded_cells
    assert met.cells == res.cells == jmet.cells
    assert jmet.padded_cells > met.padded_cells


def test_shards_are_views_and_cached(world):
    """A device that holds every shard keeps them as views of its resident
    stream; the shards are built once per (PackedDb, mesh)."""
    pt, _, _, _ = world
    mesh = _cpu_mesh(4)
    got = sharded.build_tile_shards(pt, mesh)
    assert sharded.build_tile_shards(pt, _cpu_mesh(4)) is got
    stream = engine.device_tiles(pt, "cpu")[0]
    base = stream.data_ptr()
    end = base + stream.numel()
    for shard in got["shards"].values():
        assert base <= shard.tiles.data_ptr() < end or shard.n_rows == 0
        assert int(shard.row_start[0]) == 0
        assert int(shard.row_start[-1]) == shard.tiles.shape[0]


def test_shard_too_large_raises_by_memory(world, monkeypatch):
    """Divergence kept on purpose (ROADMAP Queue 3): no RESIDENT_TILE_CAP;
    a shard that does not fit its card's free memory raises before any
    upload, pointing at --sharded --stream."""
    pt, _, _, _ = world
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (1, 1))
    plan, _ = sharded.plan_tile_shards(pt, 2)
    for rows in ((0, plan["bounds"][1]), (0, plan["bounds"][-1])):
        with pytest.raises(RuntimeError, match="--sharded --stream"):
            sharded._device_stream(pt, plan, torch.device("cuda", 0),
                                   int(rows[0]), int(rows[1]))


def test_make_mesh_errors_equal_reference(monkeypatch):
    for kw in (dict(n_devices=9), dict(query_axis=0), dict(query_axis=3)):
        with pytest.raises(ValueError) as port:
            make_mesh(devices=["cpu"] * 8, **kw)
        with pytest.raises(ValueError) as ref:
            jmesh.make_mesh(**kw)
        assert str(port.value) == str(ref.value)
    mesh = make_mesh(devices=["cpu"] * 8, query_axis=2)
    assert mesh.shape == {"data": 4, "query": 2} and not mesh.distributed
    assert mesh == _cpu_mesh(8, 2) and mesh != _cpu_mesh(8, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
        make_mesh()
    with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
        sharded.sharded_search(None, [])
