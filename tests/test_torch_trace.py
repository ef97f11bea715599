"""The port's span recorder (swimm_tpu_torch/utils/metrics.py) and the spans
the server and the engine record with it: off unless a torch profiler
session is open (no record, no record_function), on for every thread while
one is (threads started before it too, which open no record_function),
nested spans, the bound on the buffer, cross-thread intervals, one seq per
request through the Batcher and the TCP front end, engine.launch counts
that sum to the search's SearchMetrics, and PhaseTimer's totals."""

import contextlib
import json
import socket
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from swimm_tpu_torch import cli
from swimm_tpu_torch import db as tdb
from swimm_tpu_torch.alphabet import decode
from swimm_tpu_torch.fasta import FastaRecord, write_fasta
from swimm_tpu_torch.models import engine
from swimm_tpu_torch.models.engine import SearchConfig
from swimm_tpu_torch.ops import lanes, longquery, scorer
from swimm_tpu_torch.server import Batcher, SearchServer, make_socket_server
from swimm_tpu_torch.utils import metrics
from swimm_tpu_torch.utils.metrics import PhaseTimer, record, span, spans
from swimm_tpu_torch.utils.synth import random_codes, synth_db, synth_queries
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _profiler():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture
def counted_record_function(monkeypatch):
    """torch.profiler.record_function, counting the ranges it opens."""
    opened = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return opened


@pytest.fixture(scope="module")
def db_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tracedb")
    write_fasta(tmp / "db.fasta", synth_db(120, seed=5, median_len=60,
                                           max_len=160))
    tdb.build_db(str(tmp / "db.fasta"), tmp / "t", V=8)
    return tmp / "t"


@pytest.fixture(scope="module")
def packed(db_dir):
    return tdb.load_db(db_dir)


# -- the recorder ------------------------------------------------------------

@pytest.mark.parametrize("how", ["span", "record", "nested", "phase"])
def test_off_records_nothing(counted_record_function, how):
    assert not metrics.tracing()
    lo = time.perf_counter()
    if how == "span":
        with span("t.off", n=1):
            pass
    elif how == "record":
        record("t.off", lo, lo + 1.0, seq=3)
    elif how == "nested":
        with span("t.outer"):
            with span("t.inner"):
                pass
    else:
        timer = PhaseTimer()
        with timer.phase("score"):
            pass
        assert timer.phases["score"] >= 0
    assert spans(lo) == []
    assert counted_record_function == []
    assert span("a") is span("b")        # one shared no-op context


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_on_nested_spans(counted_record_function, depth):
    lo = time.perf_counter()
    with _profiler():
        assert metrics.tracing()
        with span("t.level0", k=0):
            if depth > 1:
                with span("t.level1", k=1):
                    if depth > 2:
                        with span("t.level2", k=2):
                            pass
    got = {r.name: r for r in spans(lo)}
    assert sorted(got) == [f"t.level{i}" for i in range(depth)]
    assert [r.name for r in spans(lo)] == [f"t.level{i}"
                                           for i in reversed(range(depth))]
    for i in range(1, depth):
        inner, outer = got[f"t.level{i}"], got[f"t.level{i - 1}"]
        assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1
        assert inner.attrs["k"] == i
    assert counted_record_function == [f"t.level{i}" for i in range(depth)]
    assert not metrics.tracing()


def test_on_spans_show_in_the_profilers_trace():
    with _profiler() as prof:
        with span("t.in_the_trace"):
            torch.ones(4).sum()
    assert "t.in_the_trace" in {e.name for e in prof.events()}


def test_buffer_keeps_the_newest():
    lo = time.perf_counter()
    n = metrics.MAX_SPANS + 7
    with _profiler():
        for i in range(n):
            record("t.bound", lo, lo, i=i)
    kept = [r for r in spans(lo) if r.name == "t.bound"]
    assert len(kept) == metrics.MAX_SPANS
    assert kept[0].attrs["i"] == 7 and kept[-1].attrs["i"] == n - 1


def test_thread_started_before_the_profiler_records(counted_record_function):
    """The gate is torch's process-global flag: a thread that was running
    before the profiler opened (the Batcher's dispatcher) sees it, though
    torch's own per-thread profiler state there reads off; so it records
    its spans and opens no record_function, whose range would be lost."""
    go, done = threading.Event(), threading.Event()
    seen = {}

    def worker():
        go.wait(30)
        seen["torch_thread_state"] = torch._C._autograd._profiler_enabled()
        seen["tracing"] = metrics.tracing()
        with span("t.worker", where="thread"):
            with span("t.worker_inner"):
                pass
        done.set()

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    lo = time.perf_counter()
    with _profiler():
        go.set()
        assert done.wait(30)
    t.join(timeout=30)
    assert not t.is_alive()
    assert seen["tracing"] is True
    assert seen["torch_thread_state"] is False
    got = {r.name: r for r in spans(lo)}
    assert got["t.worker"].attrs == {"where": "thread"}
    assert got["t.worker"].t0 <= got["t.worker_inner"].t0 \
        <= got["t.worker_inner"].t1 <= got["t.worker"].t1
    assert counted_record_function == []


def test_cross_thread_record():
    box = {}

    def start():
        box["t0"] = time.perf_counter()

    t = threading.Thread(target=start)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    lo = time.perf_counter()
    with _profiler():
        with span("t.enclosing"):
            t1 = time.perf_counter()
            record("t.crossed", box["t0"], t1, seq=11)
    got = {r.name: r for r in spans(box["t0"])}
    rec = got["t.crossed"]
    assert (rec.t0, rec.t1) == (box["t0"], t1) and rec.t0 < lo
    assert rec.attrs == {"seq": 11}
    assert got["t.enclosing"].t0 > rec.t0


@pytest.mark.parametrize("window,names", [
    ((0.5, 1.5), ["a", "b"]), ((2.5, 3.5), ["b", "c"]),
    ((4.5, 5.0), []), ((1.0, 1.0), ["a"])])
def test_spans_read_the_overlapping_window(window, names):
    base = -1e6            # before every real span (perf_counter > 0)
    case = object()
    with _profiler():
        record("a", base + 0.0, base + 1.0, case=case)
        record("b", base + 1.2, base + 2.8, case=case)
        record("c", base + 3.0, base + 4.0, case=case)
    lo, hi = window
    assert [r.name for r in spans(base + lo, base + hi)
            if r.attrs["case"] is case] == names


@pytest.mark.parametrize("traced", [False, True])
def test_phase_timer_totals_unchanged(traced):
    timer = PhaseTimer()
    lo = time.perf_counter()
    with _profiler() if traced else contextlib.nullcontext():
        for _ in range(3):
            with timer.phase("merge"):
                time.sleep(0.002)
        with pytest.raises(RuntimeError):
            with timer.phase("score"):
                raise RuntimeError("a phase that raises is still timed")
    assert set(timer.report()) == {"merge", "score"}
    assert timer.event_stats("merge")["count"] == 3
    assert timer.phases["merge"] == pytest.approx(
        sum(timer.events["merge"]))
    assert timer.phases["merge"] >= 0.006
    assert timer.event_stats("score")["count"] == 1
    assert timer.event_stats("h2d") is None
    recs = [r for r in spans(lo) if r.name.startswith("phase.")]
    if traced:
        merge = [r.t1 - r.t0 for r in recs if r.name == "phase.merge"]
        assert len(merge) == 3
        assert all(0.002 <= a <= b for a, b in zip(merge,
                                                   timer.events["merge"]))
        assert [r.name for r in recs].count("phase.score") == 1
    else:
        assert recs == []


# -- the engine --------------------------------------------------------------

@pytest.mark.parametrize("lengths", [(30,), (30, 45, 17), (2050, 20)])
def test_engine_launch_counts_sum_to_search_metrics(tmp_path, lengths):
    rng = np.random.default_rng(31)
    queries = [FastaRecord(f"q{i}", random_codes(rng, n))
               for i, n in enumerate(lengths)]
    if max(lengths) > 2048:      # one long query, kernel 2: a small DB
        recs = synth_db(16, seed=3, median_len=40, max_len=64)
    else:
        recs = synth_db(60, seed=9, median_len=60, max_len=200)
    pk = tdb.build_db(recs, tmp_path / "t", V=8)
    lo = time.perf_counter()
    with _profiler():
        results, met = engine.search(pk, queries, SearchConfig(top_k=4),
                                     device="cpu")
    recs = spans(lo)
    launches = [r for r in recs if r.name == "engine.launch"]
    assert len(launches) == len(queries)
    assert sum(r.attrs["cells"] for r in launches) == met.cells
    kernels = sorted(r.attrs["kernel"] for r in launches)
    assert kernels == sorted(
        "sw_ragged_qtile_kernel" if n > 2048 else "sw_ragged_kernel"
        for n in lengths)
    (top,) = [r for r in recs if r.name == "engine.search"]
    (score,) = [r for r in recs if r.name == "phase.score"]
    assert top.attrs == {} and top.t0 <= score.t0 <= score.t1 <= top.t1
    for name in ("engine.profile", "engine.launch", "engine.top_k",
                 "engine.collect"):
        inner = [r for r in recs if r.name == name]
        assert len(inner) == (1 if name == "engine.collect"
                              else len(queries))
        assert all(score.t0 <= r.t0 <= r.t1 <= score.t1 for r in inner)
    assert set(met.timers) == {"h2d", "score"}


@pytest.mark.parametrize("mode,kernel", [
    ("tiles", "sw_ragged_kernel"), ("tiles_long", "sw_ragged_qtile_kernel")])
def test_engine_launch_names_the_wrappers_kernel(mode, kernel):
    """engine.launch's kernel attr, a lanes.Profile's kernel, is the name the
    scorer wrapper gives the CUDA kernel it launches (the device trace's
    name, by which the kernel rooflines split cells)."""
    length = 20 if mode == "tiles" else 2050
    prof = lanes.Profile.build(FastaRecord("q", random_codes(
        np.random.default_rng(5), length)), SearchConfig())
    assert prof.mode == mode and prof.kernel == kernel
    fn = scorer.score_tiles if mode == "tiles" else longquery.score_tiles_long
    assert fn.kernel == kernel


def test_engine_untraced_records_nothing(packed):
    lo = time.perf_counter()
    _, met = engine.search(packed, synth_queries(2, [20, 33], seed=2),
                           SearchConfig(top_k=3), device="cpu")
    assert met.cells > 0 and spans(lo) == []


# -- the server --------------------------------------------------------------

def _line(qs, rid):
    return json.dumps({"id": rid, "queries": [
        {"title": q.title, "seq": decode(q.codes)} for q in qs]}) + "\n"


@pytest.mark.parametrize("n_clients", [1, 4])
def test_batcher_request_spans_share_one_seq(packed, n_clients):
    """Concurrent TCP clients: each search request has its queue and
    postprocess spans under one seq of its own, the queue's end and the
    postprocess inside exactly one batcher.dispatch, and each dispatch
    holds one engine.search."""
    Server, Handler, srv, batcher = make_socket_server(
        packed, SearchConfig(top_k=3), device="cpu")
    tcp = Server(("127.0.0.1", 0), Handler)
    th = threading.Thread(target=tcp.serve_forever,
                          kwargs={"poll_interval": 0.05}, daemon=True)
    th.start()
    lo = time.perf_counter()
    got = [None] * n_clients
    try:
        with _profiler():
            def client(i):
                qs = synth_queries(1 + i % 2, [25 + 7 * i, 40], seed=i)
                with socket.create_connection(tcp.server_address,
                                              timeout=60) as s:
                    s.sendall(_line(qs, i).encode())
                    got[i] = json.loads(s.makefile().readline())

            clients = [threading.Thread(target=client, args=(i,))
                       for i in range(n_clients)]
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=120)
            assert not any(c.is_alive() for c in clients)
    finally:
        tcp.shutdown()
        tcp.server_close()
        batcher.stop()
    th.join(timeout=30)
    assert all("results" in r for r in got)
    recs = spans(lo)
    by = {}
    for r in recs:
        if "seq" in r.attrs:
            by.setdefault(r.attrs["seq"], {}).setdefault(r.name, []).append(r)
    assert len(by) == n_clients
    dispatches = [r for r in recs if r.name == "batcher.dispatch"]
    assert batcher.n_dispatches == len(dispatches)
    for seq, named in by.items():
        assert {n: len(v) for n, v in named.items()} == {
            "batcher.queue": 1, "server.postprocess": 1}
        q, post = named["batcher.queue"][0], named["server.postprocess"][0]
        (d,) = [d for d in dispatches if d.t0 <= q.t1 <= d.t1]
        assert q.t0 <= q.t1 <= post.t0 <= post.t1 <= d.t1
    searches = [r for r in recs if r.name == "engine.search"]
    assert len(searches) == len(dispatches)
    for d in dispatches:
        assert sum(d.t0 <= r.t0 <= r.t1 <= d.t1 for r in searches) == 1


def test_search_server_handle_spans(packed):
    """The stdio path (no Batcher) records the engine's spans alone: the
    server's spans are the Batcher's, joined on its seq."""
    srv = SearchServer(packed, SearchConfig(top_k=3), device="cpu")
    lo = time.perf_counter()
    req = json.loads(_line(synth_queries(1, [33], seed=1), 5))
    with _profiler():
        resp = srv.handle(req)
        bad = srv.handle({"id": 6, "queries": "MKV"})
    assert "results" in resp and bad["error_kind"] == "bad_request"
    names = [r.name for r in spans(lo)]
    assert names.count("engine.search") == 1
    assert not [n for n in names if n.split(".")[0] in ("server", "batcher")]


def test_batcher_dispatch_without_profiler_records_nothing(packed):
    srv = SearchServer(packed, SearchConfig(top_k=3), device="cpu")
    b = Batcher(srv)
    lo = time.perf_counter()
    try:
        resp = b.submit(json.loads(_line(synth_queries(1, [28], seed=3), 1)))
    finally:
        b.stop()
    assert "results" in resp and spans(lo) == []


def test_cli_profile_dir_trace_carries_the_spans(db_dir, tmp_path, capsys):
    qs = synth_queries(2, [30, 45], seed=4)
    write_fasta(tmp_path / "q.fasta", qs)
    assert cli.main(["search", "-d", str(db_dir), "-q",
                     str(tmp_path / "q.fasta"), "-r", "2", "--device", "cpu",
                     "--profile-dir", str(tmp_path / "prof")]) == 0
    assert capsys.readouterr().out.count("Query: ") == 2
    (trace,) = (tmp_path / "prof").glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert {"engine.search", "engine.launch", "engine.collect",
            "phase.score"} <= names
