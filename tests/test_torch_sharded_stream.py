"""swimm_tpu_torch.parallel.sharded_stream (the streaming posture across
the 'data' axis) against swimm_tpu.parallel.sharded_stream on the CPU: the
port's meshes of ['cpu'] * n devices against swimm_tpu's meshes of the 8
virtual XLA devices (backend 'xla'). Hit lists, E-values and bit scores
bit for bit, on every mesh shape and window size; the refused postures
with the reference's ValueErrors. Tolerance 0 throughout."""

import pytest

from swimm_tpu.db import build_db as j_build_db
from swimm_tpu.fasta import FastaRecord as JRecord
from swimm_tpu.models import engine as jengine
from swimm_tpu.parallel import mesh as jmesh
from swimm_tpu.parallel import sharded_stream as jsstream
from swimm_tpu_torch import SearchConfig, build_db, load_db, search
from swimm_tpu_torch.models import stream
from swimm_tpu_torch.parallel import sharded_stream as sstream
from swimm_tpu_torch.parallel.mesh import make_mesh
from swimm_tpu_torch.utils.synth import synth_db, synth_queries
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference suite's world: 300 sequences of up to 220 aa (V=8),
    five queries with planted homologs; the port's DB memmapped."""
    d = tmp_path_factory.mktemp("sstream")
    queries = synth_queries(5, [24, 40, 40, 64, 100], seed=81)
    recs = synth_db(300, seed=82, median_len=60, sigma=0.5, max_len=220,
                    queries=[q.codes for q in queries], homolog_frac=0.06)
    build_db(recs, d / "t", V=8)
    pj = j_build_db(recs, d / "j", V=8, use_native=False)
    ref = _hits(jengine.search(pj, _jq(queries), jengine.SearchConfig(
        backend="xla", top_k=10))[0])
    return load_db(d / "t"), pj, queries, ref


def _jq(queries):
    return [JRecord(q.title, q.codes) for q in queries]


def _hits(results):
    return [[(h.rank, h.score, h.sorted_idx, h.orig_idx, h.title, h.evalue,
              h.bits) for h in r.hits] for r in results]


def _scfg(**kw):
    return SearchConfig(top_k=10, db_stream=True, **kw)


@pytest.mark.parametrize("n_dev,query_axis", [(1, 1), (4, 1), (8, 1),
                                              (8, 2)])
def test_sharded_stream_equals_reference(world, n_dev, query_axis):
    pt, pj, queries, ref = world
    mesh = make_mesh(n_dev, query_axis=query_axis, devices=["cpu"] * n_dev)
    got, met = sstream.search_streaming_sharded(
        pt, queries, _scfg(window_tiles=64, max_in_flight=3), mesh=mesh)
    assert _hits(got) == ref
    assert met.timers.get("stream", 0) > 0
    jgot, _ = jsstream.search_streaming_sharded(
        pj, _jq(queries), jengine.SearchConfig(
            backend="xla", top_k=10, db_stream=True, window_tiles=64,
            max_in_flight=3), mesh=jmesh.make_mesh(n_dev, query_axis))
    assert _hits(got) == _hits(jgot)


@pytest.mark.parametrize("wt", [32, 128, 4096])
def test_sharded_stream_window_sweep(world, wt):
    """The window size changes the span plan, never the hits; 32 and 128
    give span counts that 4 rows do not divide (a short last
    super-window), 4096 one span (three rows idle)."""
    pt, _, queries, ref = world
    spans, _ = stream.plan_windows(stream.stream_layout(pt), wt)
    got, _ = sstream.search_streaming_sharded(
        pt, queries, _scfg(window_tiles=wt), mesh=make_mesh(
            devices=["cpu"] * 4))
    assert _hits(got) == ref, (wt, len(spans))


@pytest.mark.parametrize("query_axis", [1, 2])
def test_sharded_stream_evalues(world, query_axis):
    pt, pj, queries, _ = world
    got, _ = sstream.search_streaming_sharded(
        pt, queries, _scfg(window_tiles=64, evalue=True),
        mesh=make_mesh(devices=["cpu"] * 4, query_axis=query_axis))
    res, _ = search(pt, queries, SearchConfig(top_k=10, evalue=True),
                    device="cpu")
    assert _hits(got) == _hits(res)
    jgot, _ = jsstream.search_streaming_sharded(
        pj, _jq(queries), jengine.SearchConfig(
            backend="xla", top_k=10, db_stream=True, window_tiles=64,
            evalue=True), mesh=jmesh.make_mesh(4, query_axis))
    assert _hits(got) == _hits(jgot)


@pytest.mark.parametrize("cfg", [dict(precision="ladder"),
                                 dict(query_pack=True)])
def test_sharded_stream_refusals_equal_reference(world, cfg):
    pt, pj, queries, _ = world
    with pytest.raises(ValueError) as port:
        sstream.search_streaming_sharded(
            pt, queries, _scfg(window_tiles=64, **cfg),
            mesh=make_mesh(devices=["cpu"] * 2))
    with pytest.raises(ValueError) as ref:
        jsstream.search_streaming_sharded(
            pj, _jq(queries), jengine.SearchConfig(
                backend="xla", top_k=10, db_stream=True, window_tiles=64,
                **cfg), mesh=jmesh.make_mesh(2))
    assert str(port.value) == str(ref.value)


def test_sharded_stream_padded_cells_count_the_fill(world):
    """Divergence kept on purpose (ROADMAP Queue 3): spans are launched at
    their fill, so padded_cells counts the stream's tiles once, as the
    resident search does; swimm_tpu's counts every span at the window
    width, with the all-PAD tail spans."""
    pt, pj, queries, _ = world
    _, met = sstream.search_streaming_sharded(
        pt, queries, _scfg(window_tiles=32), mesh=make_mesh(
            devices=["cpu"] * 4))
    _, res = search(pt, queries, SearchConfig(top_k=10), device="cpu")
    _, jmet = jsstream.search_streaming_sharded(
        pj, _jq(queries), jengine.SearchConfig(
            backend="xla", top_k=10, db_stream=True, window_tiles=32),
        mesh=jmesh.make_mesh(4))
    assert met.padded_cells == res.padded_cells < jmet.padded_cells
    assert met.cells == jmet.cells


def test_sharded_stream_empty_batch_and_spans(world):
    pt, _, _, _ = world
    got, met = sstream.search_streaming_sharded(
        pt, [], _scfg(window_tiles=64), mesh=make_mesh(devices=["cpu"] * 2))
    assert got == [] and met.n_queries == 0
    assert list(sstream._iter_super_windows([(0, 2), (2, 3), (3, 7)], 2)) \
        == [[(0, (0, 2)), (1, (2, 3))], [(0, (3, 7))]]
