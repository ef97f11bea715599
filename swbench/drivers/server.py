"""The persistent server (``python -m swimm_tpu_torch serve --listen
HOST:PORT --warm ...``), in the run's process: the port's TCP front end
(``server.make_socket_server``: one ``SearchServer`` over the resident
database, one ``Batcher`` at the configuration's ``max_batch_queries``),
bound to a free loopback port, warmed as ``--warm`` does, serving on a
thread. The load comes from ``swbench.loadgen`` in a child process: an
open loop, each request timed on the client's clock from when it was due
to when its response came back.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

from swbench import stats
from swbench.drivers.batch import Window

#: idle connections the client opens before the window
POOL = 64
#: seconds past the window's close that a response may still come back in
GRACE_S = 60.0
#: seconds between the client's "ready" and the first request's due time
LEAD_S = 0.25


def read_responses(recs: list):
    """(answers, requests, end-to-end metrics) from the client's records.
    A request is answered when its response is a search result for its
    own id; any other (an error, none by the deadline) is missing: its
    latency is infinite, so it counts against every percentile. Latency
    runs from when the request was due, not when it went out."""
    answers, requests, lat = [], [], []
    for r in recs:
        resp = json.loads(r["resp"]) if r["resp"] else {}
        ok = "results" in resp and resp.get("id") == r["id"]
        answers.append((r["id"], [(h["score"], h["title"])
                                  for h in resp["results"][0]["hits"]]
                        if ok else None))
        latency = r["recv"] - r["due"] if ok else math.inf
        lat.append(latency)
        requests.append({"id": r["id"], "due": r["due"], "sent": r["sent"],
                         "recv": r["recv"], "latency_s": latency,
                         "search_s": resp["metrics"]["seconds"] if ok
                         else None})
    e2e = {"latency_p50_ms": 1e3 * stats.percentile(lat, 50),
           "latency_p95_ms": 1e3 * stats.percentile(lat, 95)}
    return answers, requests, e2e


class Session:
    def __init__(self, cfg, traffic, db, packed, device, seed, seconds,
                 spans, workdir):
        from swimm_tpu_torch.models.engine import SearchConfig
        self.cfg, self.traffic, self.db = cfg, traffic, db
        self.packed, self.device, self.seconds = packed, device, seconds
        self.spans, self.workdir = spans, Path(workdir)
        self.config = SearchConfig(**cfg["search"])
        self.tcp = self.thread = self.batcher = self.srv = None
        self.client = None
        self.requests = []

    def setup(self):
        from swimm_tpu_torch.server import make_socket_server
        Server, Handler, srv, batcher = make_socket_server(
            self.packed, self.config, device=self.device,
            **self.cfg.get("server", {}))
        self.srv, self.batcher = srv, batcher
        self.tcp = Server(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(
            target=self.tcp.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True)
        self.thread.start()
        lens = sorted(int(n) for n in self.traffic.lengths)
        warm = sorted({lens[0], lens[len(lens) // 2], lens[-1]})
        with self.spans.span("warmup.server"):
            srv._warm(warm)
        # the benchmark's span around each call into the engine layer
        srv._search = self.spans.wrap("engine.search", srv._search)

    def _start_client(self):
        """Write the schedule and start the load generator; returns once
        its pool of connections is open."""
        reqs = [{"id": i, "due": float(d), "line": json.dumps({
            "id": i, "queries": [{"title": f"Q{i:04d}",
                                  "seq": q.tobytes().decode()}],
            **self.traffic.request})}
            for i, (d, q) in enumerate(zip(self.traffic.due,
                                           self.traffic.queries))]
        sched = self.workdir / "schedule.json"
        with open(sched, "w") as fh:
            json.dump({"pool": POOL, "deadline_s": self.seconds + GRACE_S,
                       "requests": reqs}, fh)
        self.out = self.workdir / "responses.jsonl"
        host, port = self.tcp.server_address[:2]
        self.client = subprocess.Popen(
            [sys.executable, "-m", "swbench.loadgen", str(sched),
             str(self.out), host, str(port)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            cwd=str(Path(__file__).resolve().parents[2]))
        if self.client.stdout.readline().strip() != "ready":
            raise RuntimeError("the load generator did not start")

    def window(self) -> Window:
        self._start_client()
        n0 = (self.batcher.n_dispatches, self.srv.total_cells,
              self.srv.n_queries)
        self.t0 = time.perf_counter() + LEAD_S
        self.client.communicate(f"{self.t0!r}\n",
                                timeout=self.seconds + GRACE_S + 30)
        if self.client.returncode != 0:
            raise RuntimeError(f"the load generator exited "
                               f"{self.client.returncode}")
        with open(self.out) as fh:
            recs = [json.loads(line) for line in fh]
        answers, requests, e2e = read_responses(recs)
        t1 = max([self.t0 + self.seconds]
                 + [r["recv"] for r in recs if r["recv"] is not None])
        qlens = self.traffic.lengths
        answered = [i for i, h in answers if h is not None]
        late = [r["sent"] - r["due"] for r in requests if r["sent"]]
        counters = {
            "dispatches": self.batcher.n_dispatches - n0[0],
            "program_cells": self.srv.total_cells - n0[1],
            "queries": self.srv.n_queries - n0[2],
            "answered": len(answered),
            "cells": stats.cells(qlens[answered], self.db.total_residues),
            "db_bytes": len(answered) * self.db.total_residues,
            "client_late_max_s": max(late) if late else None,
        }
        self.requests = requests
        return Window(self.t0, t1, answers, e2e, counters, requests)

    def label(self, t: float) -> str:
        open_ = self.spans.open_at(t)
        if open_:
            return open_[-1]
        waiting = any(r["sent"] is not None and r["sent"] <= t
                      and (r["recv"] is None or t < r["recv"])
                      for r in self.requests)
        return ("server, a request in flight" if waiting
                else "no request in flight")

    def close(self):
        if self.client is not None and self.client.poll() is None:
            self.client.kill()
            self.client.wait()
        if self.tcp is not None:
            self.tcp.shutdown()
            self.tcp.server_close()
            self.thread.join(timeout=30)
        if self.batcher is not None:
            self.batcher.stop()
        self.srv = self.batcher = self.tcp = None
