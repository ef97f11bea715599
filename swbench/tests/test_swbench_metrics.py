"""The end-to-end arithmetic: the batch rate runs to the last batch's end,
and the served percentiles run over every request from its due time, a
failed or missing one counting as missing."""

import json
import math
import time
from types import SimpleNamespace

import numpy as np

from swbench import sol, stats
from swbench.drivers import batch, server
from swbench.trace import Spans, Timeline


class FakeDb:
    total_residues = 1000


def test_batch_rate_counts_every_batch_to_the_last_ones_end(monkeypatch):
    traffic = SimpleNamespace(queries=[np.frombuffer(b"ACD", np.uint8),
                                       np.frombuffer(b"WWWWW", np.uint8)],
                              lengths=np.array([3, 5]))
    cfg = {"search": {"matrix": "BLOSUM62", "gap_open": 10,
                      "gap_extend": 2, "top_k": 2}}
    s = batch.Session(cfg, traffic, FakeDb(), None, "cpu", 1, 0.25, Spans(),
                      None)
    hit = SimpleNamespace(score=5, title="S0000001")
    met = SimpleNamespace(cells=8000, padded_cells=16000)

    def slow_search():
        time.sleep(0.1)
        return [SimpleNamespace(hits=[hit])] * 2, met
    monkeypatch.setattr(s, "_search", slow_search)
    w = s.window()
    n = w.counters["batches"]
    assert n == 3                      # the one running at 0.25 s counts
    assert w.t1 - w.t0 >= 0.3          # ... to its end
    assert w.counters["cells"] == n * (3 + 5) * 1000
    assert math.isclose(w.e2e["gcups"],
                        n * 8000 / (w.t1 - w.t0) / 1e9)
    assert len(w.answers) == 2 * n


def rec(i, due, sent, recv, resp):
    return {"id": i, "due": due, "sent": sent, "recv": recv,
            "resp": None if resp is None else json.dumps(resp)}


def ok(i, seconds=0.01):
    return {"id": i, "results": [{"query": f"Q{i}", "hits": [
        {"rank": 1, "score": 9, "title": "S0000003"}]}],
            "metrics": {"seconds": seconds}}


def test_latency_runs_from_due_and_failures_are_missing():
    recs = [rec(0, 10.0, 10.5, 11.0, ok(0)),        # late send: 1.0 s
            rec(1, 11.0, 11.0, 11.2, ok(1)),        # 0.2 s
            rec(2, 12.0, 12.0, 12.1, {"id": 2, "error": "x",
                                      "error_kind": "internal"}),
            rec(3, 13.0, 13.0, None, None),         # never came back
            rec(4, 14.0, 14.0, 14.3, ok(5))]        # another request's
    answers, requests, e2e = server.read_responses(recs)
    assert [h is None for _, h in answers] == [False, False, True, True,
                                               True]
    lat = [r["latency_s"] for r in requests]
    assert math.isclose(lat[0], 1.0) and math.isclose(lat[1], 0.2)
    assert all(math.isinf(x) for x in lat[2:])
    # 5 requests: the p50 is the 3rd smallest, a missing one
    assert math.isinf(e2e["latency_p50_ms"])
    assert math.isinf(e2e["latency_p95_ms"])
    answers, requests, e2e = server.read_responses(recs[:2])
    assert math.isclose(e2e["latency_p50_ms"], 200.0)
    assert math.isclose(e2e["latency_p95_ms"], 1000.0)
    assert answers[0][1] == [(9, "S0000003")]


def test_timeline_union_gaps_and_breakdown():
    from swbench.trace import breakdown
    tl = Timeline([("k1", "kernel", 1.0, 2.0), ("k1", "kernel", 1.5, 2.5),
                   ("copy", "gpu_memcpy", 3.0, 3.25),
                   ("cpu", "cpu_op", 0.0, 9.0)], lo=0.5, hi=4.0)
    assert math.isclose(tl.busy(), 1.75)
    assert math.isclose(tl.busy(cats=("kernel",)), 1.5)
    assert [tuple(round(x, 6) for x in g) for g in tl.gaps()] == [
        (0.5, 1.0), (2.5, 3.0), (3.25, 4.0)]
    b = breakdown(tl, lambda t: "between" if t > 3 else "search")
    assert b["device_ops"] == [["k1", 2.0], ["copy", 0.25]]
    assert b["idle_gaps"][0] == ["between", 0.75]


def test_layer_readers_read_what_they_find():
    from swbench.spec import Spec
    sp = Spec()
    tl = Timeline([("k", "kernel", 0.0, 2.0)], lo=0.0, hi=4.0)
    rec_ = SimpleNamespace(
        timeline=tl, requests=[{"latency_s": 0.05, "search_s": 0.03}],
        counters={"cells": sol.CELLS_PER_S, "db_bytes": 0,
                  "program_cells": 9, "program_padded_cells": 10,
                  "dispatches": 4, "queries": 10})
    assert math.isclose(sp.reader("kernels_roofline.batch")(rec_), 50.0)
    assert math.isclose(sp.reader("device_idle_pct.batch")(rec_), 50.0)
    assert math.isclose(sp.reader("pad_waste_pct.batch")(rec_), 10.0)
    assert math.isclose(sp.reader("queries_per_dispatch.serve")(rec_), 2.5)
    assert math.isclose(sp.reader("server_wait_p95_ms.serve")(rec_), 20.0)
    silent = SimpleNamespace(timeline=None, requests=[], counters={})
    for name in ("kernels_roofline.serve", "device_idle_pct.serve",
                 "pad_waste_pct.batch", "queries_per_dispatch.serve",
                 "server_wait_p95_ms.serve"):
        assert sp.reader(name)(silent) is None


def test_speed_of_light_is_frozen():
    from swbench import sol
    assert math.isclose(sol.ISSUE_PER_S, 33.45e12, rel_tol=1e-3)
    assert math.isclose(sol.CELLS_PER_S / 1e9, 16_727, rel_tol=1e-4)
    assert sol.seconds(sol.CELLS_PER_S, 0) == 1.0
    assert stats.gcups(2 * 10 ** 9, 2.0) == 1.0
    assert stats.cells([3, 5], 10) == 80
