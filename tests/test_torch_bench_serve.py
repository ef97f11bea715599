"""swimm_tpu_torch.benchmarks.bench_serve and bench_scaling on the CPU
(device='cpu': the plain scorers) at small sizes, against the JAX package.

bench_serve starts one `python -m swimm_tpu_torch serve --listen
127.0.0.1:0 --device cpu` subprocess on a DB of a few hundred sequences in
tmp_path: serial requests, concurrent ones (coalesced: no more dispatches
than requests) and a soak with the server's RSS read from /proc; every
reply's hits equal swimm_tpu's search (backend 'xla') of the same query on
the same pack; the JSON line's keys are the reference's. bench_scaling's
per-shard tile counts equal swimm_tpu.parallel.sharded_search's
build_tile_shards on the 8 XLA devices of tests/conftest.py, and every
mesh's hits equal swimm_tpu's search. Both raise without a card unless
given the CPU.

Tolerance 0 throughout."""

import contextlib
import io
import json

import numpy as np
import pytest

from swimm_tpu.db import build_db as j_build_db
from swimm_tpu.db import load_db as j_load_db
from swimm_tpu.fasta import FastaRecord as JRecord
from swimm_tpu.models import engine as jengine
from swimm_tpu.parallel import mesh as jmesh
from swimm_tpu.parallel import sharded_search as jsharded
from swimm_tpu.utils import synth as jsynth
from swimm_tpu_torch import benchmarks as tb
from swimm_tpu_torch.benchmarks import bench_scaling, bench_serve
from swimm_tpu_torch.db import build_db
from swimm_tpu_torch.utils.synth import synth_db
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# keys of the reference's JSON line (benchmarks/bench_serve.py)
SERVE_KEYS = ["metric", "startup_s", "serial_request_s", "median_request_s",
              "request_gcups", "concurrent_n", "concurrent_wall_s",
              "concurrent_dispatches", "concurrent_gcups"]
SOAK_KEYS = ["soak_n", "soak_errors", "soak_p50_s", "soak_p95_s",
             "soak_rss_first_mb", "soak_rss_last_mb", "soak_rss_growth_mb"]


def _hits(results):
    return [[(h.rank, h.score, h.title) for h in r.hits] for r in results]


def _reply_hits(resp):
    return [[(h["rank"], h["score"], h["title"]) for h in r["hits"]]
            for r in resp["results"]]


@pytest.fixture(autouse=True)
def one_thread_server(monkeypatch):
    """The `serve` subprocess's torch on one intra-op thread, as this
    process's (torch_threads): with a thread per core beside the suite's
    other workers, one soak took 270 s in place of ~10 s."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def served_db(tmp_path_factory):
    """A pack of 300 short sequences (60-120 aa: a plain search takes well
    under a second) where bench_serve looks for the cache of 300 under a
    root, and swimm_tpu's view of the same files."""
    root = tmp_path_factory.mktemp("serve")
    d = tb.bench_db_dir(300, root) / "db"
    build_db(synth_db(300, seed=2, median_len=60, max_len=120), d, V=128)
    return root, d, j_load_db(d)


def _jsearch(jdb, queries, top_k=16):
    return jengine.search(jdb, [JRecord(q.title, q.codes) for q in queries],
                          jengine.SearchConfig(top_k=top_k, backend="xla"))


def test_serve_queries_are_the_reference_draws():
    rng = np.random.default_rng(3)
    qlens = [int(x) for x in rng.integers(100, 501, size=7)]
    ref = jsynth.synth_queries(7, qlens, seed=5)
    got = bench_serve.serve_queries(7)
    assert [(q.title, q.codes.tobytes()) for q in got] == [
        (q.title, q.codes.tobytes()) for q in ref]


def test_bench_serve_soak_on_the_cpu(served_db):
    root, _, jdb = served_db
    out, world = bench_serve.run("cpu", n_requests=2, concurrent=3, soak=5,
                                 top_k=8, n_seqs=300, root=root)
    assert sorted(out) == sorted(SERVE_KEYS + SOAK_KEYS)
    assert "cpu (no card)" in out["metric"] and "300-seq DB" in out["metric"]
    assert out["soak_errors"] == 0 and out["soak_n"] == 5
    assert out["soak_rss_first_mb"] > 0 and out["soak_rss_last_mb"] > 0
    assert 1 <= out["concurrent_dispatches"] <= 3
    assert len(out["serial_request_s"]) == 2 and out["concurrent_n"] == 3
    queries = world["queries"]
    ref, jmet = _jsearch(jdb, queries, top_k=8)
    replies = world["serial"] + world["concurrent"] + world["soak"]
    ids = [r["id"] for r in replies]
    assert ids == [0, 1, 2, 3, 4, 0, 1, 2, 3, 4]
    for r in replies:
        assert _reply_hits(r) == _hits(ref[r["id"]:r["id"] + 1])
    assert world["serial"][0]["metrics"]["cells"] == (
        queries[0].length * jdb.total_residues)


def test_bench_serve_stream_posture(served_db):
    _, d, jdb = served_db
    out, world = bench_serve.run("cpu", n_requests=1, concurrent=2, db_dir=d,
                                 stream=True)
    assert sorted(out) == sorted(SERVE_KEYS + ["posture"])
    assert out["posture"] == "stream" and "(streaming posture)" in \
        out["metric"]
    ref, _ = _jsearch(jdb, world["queries"])
    for r in world["serial"] + world["concurrent"]:
        assert _reply_hits(r) == _hits(ref[r["id"]:r["id"] + 1])


def test_bench_serve_without_the_db_prints_the_error_line(tmp_path,
                                                           monkeypatch,
                                                           capsys):
    monkeypatch.setattr(tb, "REPO", tmp_path)
    assert bench_serve.main(["--device", "cpu", "--n-seqs", "40"]) == 1
    dbdir = tmp_path / ".bench_sp_torch_40" / "db"
    assert json.loads(capsys.readouterr().out) == {
        "error": f"bench DB missing at {dbdir}; run python -m "
                 "swimm_tpu_torch.bench (or bench_swissprot) once first"}


@pytest.fixture(scope="module")
def scaling(tmp_path_factory):
    """bench_scaling.run on the reference's workload cut to 96 sequences
    (its printed table), and swimm_tpu's pack of the same records."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rows = bench_scaling.run("cpu", n_seqs=96)
    queries = jsynth.synth_queries(4, [80, 144, 200, 300], seed=1)
    recs = jsynth.synth_db(96, seed=2, queries=[q.codes for q in queries],
                           homolog_frac=0.01)
    jdb = j_build_db(recs, tmp_path_factory.mktemp("scaling"), V=8,
                     use_native=False)
    return rows, queries, jdb, printed.getvalue().splitlines()


@pytest.mark.parametrize("nd", [1, 2, 4, 8])
def test_bench_scaling_tile_counts_equal_jax(scaling, nd):
    rows, _, jdb, _ = scaling
    row = rows[[1, 2, 4, 8].index(nd)]
    assert row["mesh"] == nd and row["devices"] == ["cpu"] * nd
    tiles_all, *rest, R_loc = jsharded.build_tile_shards(
        jdb, jmesh.make_mesh(nd))
    counts = [int((np.asarray(rest[0][d]) != R_loc - 1).sum())
              for d in range(nd)]
    assert row["tiles"] == counts
    assert row["merge_bytes"] == nd * jsharded.TOPK_PER_SHARD * 8 * 4


def test_bench_scaling_hits_equal_jax(scaling):
    rows, queries, jdb, printed = scaling
    assert printed[0] == "on cpu (no card): 96 seqs, 4 queries"
    assert printed[1].split() == ["mesh", "tiles/dev", "(max/min)", "merge",
                                  "bytes", "steady", "ms", "exact"]
    assert [x.split()[0] for x in printed[2:6]] == ["1", "2", "4", "8"]
    assert [x.split()[-1] for x in printed[2:6]] == ["yes"] * 4
    assert printed[6].startswith("shards sharing a device run one after "
                                 "another") and "not a speed-up" in printed[6]
    ref, _ = jengine.search(jdb, queries, jengine.SearchConfig(
        top_k=16, precision="f32", backend="xla"))
    for row in rows:
        assert row["exact"] is True
        assert _hits(row["results"]) == _hits(ref)


@pytest.mark.parametrize("main", [bench_serve.main, bench_scaling.main],
                         ids=["bench_serve", "bench_scaling"])
def test_entry_point_without_a_card_raises(main, tmp_path, monkeypatch):
    monkeypatch.setattr(tb, "REPO", tmp_path)
    with pytest.raises(RuntimeError, match="CUDA device"):
        main([])
