"""The per-layer metrics read from the program's own spans
(swbench/program_spans.py and its six readers): each on hand-made spans and
a Timeline, None where there is nothing to read (no spans, a program
without the recorder, no device timeline), and one CPU ``--trace 1`` run of
each cell, where the span-only metrics come out as numbers."""

import math
import time
from types import SimpleNamespace

import pytest

from swbench import program_spans, sol
from swbench.spec import Spec
from swbench.tests.conftest import run_cell
from swbench.trace import Timeline
from swimm_tpu_torch.utils import metrics

K1 = "void (anonymous namespace)::sw_ragged_kernel<false>(signed char const*)"
K2 = "sw_ragged_qtile_kernel(signed char const*, int*)"


def _span(name, t0, t1, **attrs):
    return SimpleNamespace(name=name, t0=t0, t1=t1, attrs=attrs)


#: a served window [0, 4]: three requests, two dispatches
SERVED = [
    _span("batcher.queue", 0.0, 0.1, seq=1),
    _span("batcher.queue", 0.05, 0.1, seq=2),
    _span("batcher.queue", 1.0, 1.3, seq=3),
    _span("batcher.dispatch", 0.1, 0.6, seqs=[1, 2]),
    _span("batcher.dispatch", 1.3, 2.0, seqs=[3]),
    _span("server.postprocess", 0.45, 0.5, seq=1),
    _span("server.postprocess", 0.5, 0.6, seq=2),
    _span("server.postprocess", 1.9, 2.0, seq=3),
]
#: device activity in the served window: idle within the dispatches
#: 0.1-0.2, 0.4-0.6 and 1.8-2.0 (0.5 s of 4)
SERVED_DEVICE = [(K1, "kernel", 0.2, 0.4), (K1, "kernel", 1.3, 1.8),
                 ("Memcpy DtoH", "gpu_memcpy", 3.0, 3.1)]

#: a batch window [0, 2]: two searches, a launch of each kernel in each
CELLS1, CELLS2 = 2 * 10 ** 12, 9 * 10 ** 12
BATCH = [
    _span("engine.search", 0.0, 0.95, n_queries=2),
    _span("engine.search", 1.0, 2.0, n_queries=2),
    _span("engine.launch", 0.05, 0.06, kernel="sw_ragged_kernel",
          cells=CELLS1, padded_cells=CELLS1 + 7),
    _span("engine.launch", 0.06, 0.07, kernel="sw_ragged_qtile_kernel",
          cells=CELLS2, padded_cells=CELLS2),
    _span("engine.launch", 1.05, 1.06, kernel="sw_ragged_kernel",
          cells=CELLS1, padded_cells=CELLS1),
    _span("engine.launch", 1.06, 1.07, kernel="sw_ragged_qtile_kernel",
          cells=CELLS2, padded_cells=CELLS2),
]
BATCH_DEVICE = [(K1, "kernel", 0.05, 0.25), (K2, "kernel", 0.25, 0.9),
                (K1, "kernel", 1.05, 1.25), (K2, "kernel", 1.25, 1.9)]


@pytest.fixture
def program(monkeypatch):
    """Let the program's recorder hold the given hand-made spans."""
    def hold(items):
        monkeypatch.setattr(
            metrics, "spans", lambda lo=-math.inf, hi=math.inf: [
                r for r in items if r.t1 >= lo and r.t0 <= hi])
    return hold


def _rec(t0, t1, device):
    return SimpleNamespace(window=SimpleNamespace(t0=t0, t1=t1),
                           timeline=None if device is None
                           else Timeline(device, t0, t1))


def _read(name, rec):
    return Spec().reader(name)(rec)


def test_served_readers(program):
    program(SERVED)
    rec = _rec(0.0, 4.0, SERVED_DEVICE)
    # waits 100, 50, 300 ms: the nearest-rank p95 of three is the largest
    assert math.isclose(_read("queue_wait_p95_ms.serve", rec), 300.0)
    # rides 0.5 - 0.1, 0.6 - 0.1, 2.0 - 1.3
    assert math.isclose(_read("in_dispatch_p95_ms.serve", rec), 700.0)
    assert math.isclose(_read("host_idle_pct.serve", rec), 100 * 0.5 / 4)
    device_idle = _read("device_idle_pct.serve", rec)
    assert _read("host_idle_pct.serve", rec) <= device_idle


def test_batch_readers(program):
    program(BATCH)
    rec = _rec(0.0, 2.0, BATCH_DEVICE)
    k1 = _read("kernel1_roofline.batch", rec)
    k2 = _read("kernel2_roofline.batch", rec)
    assert math.isclose(k1, 100 * sol.seconds(2 * CELLS1) / 0.4)
    assert math.isclose(k2, 100 * sol.seconds(2 * CELLS2) / 1.3)
    # the search spans leave 0.05 + 0.05 + 0.05 + 0.1 s idle inside them
    assert math.isclose(_read("host_idle_pct.batch", rec), 100 * 0.25 / 2)
    rec.counters = {"cells": 2 * (CELLS1 + CELLS2), "db_bytes": 0}
    every = _read("kernels_roofline.batch", rec)
    assert min(k1, k2) <= every <= max(k1, k2)


SILENT = {
    "no spans": ([], BATCH_DEVICE),
    "no device timeline": (SERVED + BATCH, None),
    "no device activity": (SERVED + BATCH, []),
}
READERS = ["queue_wait_p95_ms.serve", "in_dispatch_p95_ms.serve",
           "host_idle_pct.serve", "host_idle_pct.batch",
           "kernel1_roofline.batch", "kernel2_roofline.batch"]
SPAN_ONLY = READERS[:2]


@pytest.mark.parametrize("case", sorted(SILENT))
@pytest.mark.parametrize("name", READERS)
def test_readers_none_with_nothing_to_read(program, case, name):
    items, device = SILENT[case]
    program(items)
    got = _read(name, _rec(0.0, 4.0, device))
    if case == "no spans" or name not in SPAN_ONLY:
        assert got is None
    else:
        assert got is not None            # needs no device timeline


@pytest.mark.parametrize("name", READERS)
def test_readers_none_on_a_program_without_the_recorder(monkeypatch, name):
    monkeypatch.delattr(metrics, "spans")
    assert _read(name, _rec(0.0, 4.0, SERVED_DEVICE + BATCH_DEVICE)) is None


def test_readers_none_outside_the_window(program):
    program(SERVED + BATCH)
    rec = _rec(10.0, 12.0, [(K1, "kernel", 10.0, 11.0)])
    assert all(_read(name, rec) is None for name in READERS)


@pytest.mark.parametrize("oldest_end,full", [
    (-0.5, True), (0.0, True), (0.05, True), (0.05, False)])
def test_readers_none_when_the_buffer_may_have_dropped_window_spans(
        program, monkeypatch, oldest_end, full):
    """A full buffer whose oldest kept record ended inside the window may
    have dropped some of the window's records: every reader then leaves
    its metric out rather than read part of the window."""
    oldest = _span("t.oldest", oldest_end - 0.01, oldest_end)
    kept = [oldest] + SERVED + BATCH
    program(kept)
    monkeypatch.setattr(metrics, "MAX_SPANS",
                        len(kept) if full else len(kept) + 1)
    rec = _rec(0.0, 4.0, SERVED_DEVICE + BATCH_DEVICE)
    got = {name: _read(name, rec) for name in READERS}
    if full and oldest_end >= 0.0:
        assert all(v is None for v in got.values())
    else:
        assert all(v is not None for v in got.values())


def test_kernel_roofline_none_for_a_kernel_without_launches(program):
    program([s for s in BATCH if s.attrs.get("kernel") != "sw_ragged_kernel"])
    rec = _rec(0.0, 2.0, BATCH_DEVICE)
    assert _read("kernel1_roofline.batch", rec) is None
    assert _read("kernel2_roofline.batch", rec) is not None


@pytest.mark.parametrize("op,name", [
    (K1, "sw_ragged_kernel"), (K2, "sw_ragged_qtile_kernel"),
    ("void swimm::sw_chunk_kernel<true>(int)", "sw_chunk_kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD")])
def test_kernel_name(op, name):
    assert program_spans.kernel_name(op) == name


@pytest.mark.parametrize("xs,ys,shared", [
    ([(0, 1)], [(0.5, 2)], 0.5),
    ([(0, 1), (2, 3)], [(0.5, 2.5)], 1.0),
    ([(0, 1)], [(1, 2)], 0.0),
    ([], [(0, 1)], 0.0)])
def test_overlap(xs, ys, shared):
    assert math.isclose(program_spans.overlap(xs, ys), shared)


def test_merged_clips_and_joins():
    got = program_spans.merged([(3, 5), (-1, 1), (0.5, 2), (6, 6)], 0, 4)
    assert got == [(0, 2), (3, 4)]


@pytest.mark.parametrize("cell", ["sp_canonical20", "sp_serve_poisson"])
def test_cpu_traced_run_reads_the_programs_spans(capsys, cell):
    """On the CPU the profiler sees no device, so the metrics that need
    the device timeline are left out; the span-only ones are numbers, and
    the window's engine.launch cells equal its SearchMetrics cells."""
    lo = time.perf_counter()
    rc, out = run_cell(capsys, cell, trace=1)
    assert rc == 0 and out["correct"] is True
    got = out["metrics"]
    for name in READERS:
        if name.endswith(".serve" if cell == "sp_serve_poisson"
                         else ".batch") and name in SPAN_ONLY:
            assert got[name]["value"] > 0, name
        else:
            assert name not in got, name
    launched = sum(r.attrs["cells"] for r in metrics.spans(lo)
                   if r.name == "engine.launch")
    assert launched == out["counters"]["program_cells"] > 0
