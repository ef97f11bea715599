"""The streamed cell, spstream_q20: its configuration and mix found by name,
the readers it adds and the batch readers it shares on hand-made device
timelines and spans (a window copy under a kernel is hidden, one alone is
exposed, a pageable upload is not a window copy; a wait over a gap is host
idle, a wait over a kernel is not), None where there is nothing to read (a
program without the stream's spans, as before they existed), and tiny CPU
runs of the cell through the stream driver, over the memmapped pack."""

import math
from types import SimpleNamespace

import numpy as np
import pytest

from swbench import sol
from swbench.spec import Spec
from swbench.tests.conftest import run_cell
from swbench.trace import Timeline
from swimm_tpu_torch.utils import metrics

CELL = "spstream_q20"
READERS = ["pad_waste_pct.batch", "kernels_roofline.batch",
           "device_idle_pct.batch", "host_idle_pct.batch",
           "kernel1_roofline.batch", "h2d_exposed_pct.stream",
           "host_idle_pct.stream"]
K1 = "void (anonymous namespace)::sw_ragged_kernel<false>(signed char const*)"
H2D = "Memcpy HtoD (Pinned -> Device)"
PROFILE = "Memcpy HtoD (Pageable -> Device)"

#: a window [0, 10]: two windows' copies (the first alone on the card, the
#: second under a kernel), kernels 1-4 and 5-8.5, an idle gap 8.5-10
DEVICE = [(H2D, "gpu_memcpy", 0.5, 1.0), (K1, "kernel", 1.0, 4.0),
          (H2D, "gpu_memcpy", 2.0, 2.5), (K1, "kernel", 5.0, 8.5),
          ("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 8.5, 8.6),
          (PROFILE, "gpu_memcpy", 9.0, 9.5)]
CELLS = 10 ** 12
SPANS = [
    SimpleNamespace(name="engine.launch", t0=1.0, t1=1.1,
                    attrs={"kernel": "sw_ragged_kernel", "cells": CELLS}),
    SimpleNamespace(name="engine.launch", t0=5.0, t1=5.1,
                    attrs={"kernel": "sw_ragged_kernel", "cells": CELLS}),
    # over the gap 4-5 (1 s idle) and over the kernel 5-6 (not idle)
    SimpleNamespace(name="stream.wait", t0=4.0, t1=6.0, attrs={}),
    # over the kernel only
    SimpleNamespace(name="stream.wait", t0=2.0, t1=3.0, attrs={}),
    # over 8.6-9.0 idle, after the DtoH copy
    SimpleNamespace(name="stream.merge", t0=8.5, t1=9.0,
                    attrs={"merge": "candidates"}),
    SimpleNamespace(name="stream.read", t0=0.0, t1=0.5, attrs={"bytes": 1}),
]


@pytest.fixture
def program(monkeypatch):
    """Let the program's recorder hold the given hand-made spans."""
    def hold(items):
        monkeypatch.setattr(
            metrics, "spans", lambda lo=-math.inf, hi=math.inf: [
                r for r in items if r.t1 >= lo and r.t0 <= hi])
    return hold


def _rec(device, lo=0.0, hi=10.0):
    return SimpleNamespace(window=SimpleNamespace(t0=lo, t1=hi),
                           timeline=None if device is None
                           else Timeline(device, lo, hi))


def _read(name, rec):
    return Spec().reader(name)(rec)


def test_the_cell_is_found_by_name():
    sp = Spec()
    cell = sp.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "swissprot_stream", "q20_uniform100_500", 1)
    cfg = sp.config("swissprot_stream")
    batch = sp.config("swissprot_batch")
    assert cfg["driver"] == "stream" and cfg["db"] == batch["db"]
    assert cfg["search"] == {**batch["search"], "db_stream": True,
                             "window_tiles": 8192, "max_in_flight": 2,
                             "stream_scores": "candidates"}
    assert [r["key"] for r in cfg["reduced"]] == [
        "db.n_seqs", "search.stream_scores"]
    entry = next(c for c in sp.bench["configs"]
                 if c["name"] == "swissprot_stream")
    assert entry["reduced"] == [r["key"] for r in cfg["reduced"]]
    lens = sp.traffic("q20_uniform100_500")["queries"]["lengths"]
    assert lens == [100 + 20 * i + 10 for i in range(20)]
    assert sum(lens) == 6000
    assert {m["name"] for m in sp.metrics_of(CELL, traced=False)} == {
        "gcups", "device_peak_mib", "setup_s"}
    assert [m["name"] for m in sp.metrics_of(CELL, traced=True)] == READERS


def test_h2d_exposed_counts_a_copy_alone_not_one_under_a_kernel():
    # 0.5-1.0 alone; 2.0-2.5 under the kernel 1-4; the DtoH copy and the
    # pageable profile upload 9.0-9.5, alone, not at all
    assert _read("h2d_exposed_pct.stream", _rec(DEVICE)) == pytest.approx(5.0)
    hidden = [d for d in DEVICE if d[2] != 0.5]
    assert _read("h2d_exposed_pct.stream", _rec(hidden)) == pytest.approx(0)
    no_h2d = [d for d in DEVICE if d[0] != H2D]
    assert _read("h2d_exposed_pct.stream", _rec(no_h2d)) is None
    assert _read("h2d_exposed_pct.stream", _rec(None)) is None


def test_host_idle_counts_a_wait_over_a_gap_not_one_over_a_kernel(program):
    program(SPANS)
    # gaps 0-0.5, 4-5, 8.6-9, 9.5-10: the waits cover 4-5, the merge 8.6-9
    assert _read("host_idle_pct.stream", _rec(DEVICE)) == pytest.approx(14.0)
    program([s for s in SPANS if s.t0 != 4.0])
    assert _read("host_idle_pct.stream", _rec(DEVICE)) == pytest.approx(4.0)
    program([s for s in SPANS if s.name == "stream.read"])
    assert _read("host_idle_pct.stream", _rec(DEVICE)) is None
    program(SPANS)
    assert _read("host_idle_pct.stream", _rec(None)) is None


def test_kernel1_roofline_reads_the_streamed_launches(program):
    program(SPANS)
    busy = 3.0 + 3.5
    assert _read("kernel1_roofline.batch", _rec(DEVICE)) == pytest.approx(
        100.0 * sol.seconds(2 * CELLS) / busy)
    # a program without the streamed engine.launch spans: nothing to read
    program([s for s in SPANS if s.name != "engine.launch"])
    assert _read("kernel1_roofline.batch", _rec(DEVICE)) is None


def test_device_idle_is_the_window_less_device_activity():
    # busy 0.5-4, 5-8.6, 9-9.5 = 7.6 s of 10
    assert _read("device_idle_pct.batch", _rec(DEVICE)) == pytest.approx(24.0)
    assert _read("device_idle_pct.batch", _rec(None)) is None


#: a CPU run's size: the shortest lengths of the mix, a 240-sequence
#: database at V = 8 cut into several windows
TINY = {"config": {"db": {"n_seqs": 240, "homolog_frac": 0.05, "V": 8},
                   "search": {"window_tiles": 64}},
        "traffic": {"queries": {"lengths": [110, 130, 150]}}}


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_run_of_the_cell(capsys, trace):
    from swimm_tpu_torch.models import stream
    before = stream.stream_windows.windows
    rc, out = run_cell(capsys, CELL, trace=trace, overrides=TINY)
    assert rc == 0 and out["correct"] is True
    assert out["attempted"] % 3 == 0
    assert all(c["value"] == 0 for c in out["check"].values())
    # the warm-up and the window's batches, each over several windows
    assert stream.stream_windows.windows - before >= 2 * 4
    assert out["counters"]["stream_windows"] >= out["counters"]["batches"] * 4
    assert out["counters"]["stream_h2d_bytes"] == 0     # no copy on the CPU
    if trace:
        # no device timeline on the CPU: each reader finds nothing to read
        # but the padding, which the program's counts give
        assert set(out["metrics"]) == {"pad_waste_pct.batch"}
    else:
        assert set(out["metrics"]) == {"gcups", "device_peak_mib",
                                       "setup_s"}


def test_the_cell_streams_from_the_memmapped_pack(capsys, monkeypatch):
    """Every search of the run reads the pack as ``search --stream`` opens
    it: load_db, chunk files memmapped, so each window is read from the
    files; the result line counts the windows of the window's batches."""
    from swbench.drivers import batch
    from swimm_tpu_torch.models import stream
    searched = []
    real = batch.Session._search

    def watched(self):
        searched.append(self.packed)
        return real(self)

    monkeypatch.setattr(batch.Session, "_search", watched)
    rc, out = run_cell(capsys, CELL, overrides=TINY)
    assert rc == 0 and out["correct"] is True
    assert len(searched) == 1 + out["counters"]["batches"]
    assert all(isinstance(ch.codes, np.memmap)
               for packed in searched for ch in packed.chunks)
    plan, _ = stream.plan_windows(stream.stream_layout(searched[0]), 64)
    assert len(plan) >= 4
    assert out["counters"]["stream_windows"] == (
        out["counters"]["batches"] * len(plan))


@pytest.mark.card
def test_the_byte_counter_counts_each_windows_three_copies(card, tmp_path):
    """On a card each window's tiles, local rows and row starts are copied
    to the ring: the counter adds exactly their bytes."""
    from swimm_tpu_torch import SearchConfig, build_db, load_db, search
    from swimm_tpu_torch.models import stream
    from swimm_tpu_torch.utils.synth import random_codes, synth_db
    from swimm_tpu_torch.fasta import FastaRecord
    rng = np.random.default_rng(5)
    build_db(synth_db(300, seed=6, median_len=60, max_len=300),
             tmp_path / "db", V=8)
    packed = load_db(tmp_path / "db")
    queries = [FastaRecord(f"q{i}", random_codes(rng, n))
               for i, n in enumerate((40, 90))]
    layout = stream.stream_layout(packed)
    plan, _ = stream.plan_windows(layout, 16)
    cum = layout["cum"]
    copied = sum(int(cum[g1] - cum[g0]) * (32 * 8 + 4) + (g1 - g0 + 1) * 8
                 for g0, g1 in plan)   # int8 tiles, int32 rows, int64 starts
    before = stream.stream_windows.windows, stream.stream_windows.h2d_bytes
    search(packed, queries, SearchConfig(
        top_k=5, db_stream=True, stream_scores="candidates",
        window_tiles=16, max_in_flight=2), device="cuda")
    assert stream.stream_windows.windows - before[0] == len(plan) >= 4
    assert stream.stream_windows.h2d_bytes - before[1] == copied
