"""Request latency and batched concurrency through one persistent server
process (server.py, ``python -m swimm_tpu_torch serve --listen``), the
counterpart of the JAX package's benchmarks/bench_serve.py.

Starts ONE ``python -m swimm_tpu_torch serve -d DB -r K --listen
127.0.0.1:0 --warm L,...`` subprocess on the cached Swiss-Prot-scale DB
(benchmarks.bench_db_dir; ``--stream``: the windowed streaming posture),
reads the bound port from its ``bound HOST:PORT`` log line and waits for
``ready: ... serving``. The requests carry one query each, lengths from
default_rng(3).integers(100, 501), synth_queries(seed=5):

  serial      ``n_requests`` requests back to back, timed on the client
              (JSON in, JSON out: protocol and marshalling included);
  concurrent  ``concurrent`` requests from as many connections at once;
              the server's Batcher coalesces what queues behind the
              running search, so the dispatches (distinct ``metrics`` of
              the replies: a batch's members share one) stay fewer than
              the requests;
  --soak N    N further serial requests cycling the query set, with the
              server's resident set size read from /proc after the first
              and the last.

Prints one JSON line with the reference's keys. A server error prints
{"error": ...} and exits 1. The server is stopped on every exit.

Run: python -m swimm_tpu_torch.benchmarks.bench_serve [--n-requests 5]
[--concurrent 8] [--n-seqs 570000] [--top-k 16] [--soak 0] [--stream]
[--device cpu]. Without --device cpu the server runs on the card, and this
raises when there is none.
"""

from __future__ import annotations

import argparse
import json
import re
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from swimm_tpu_torch.alphabet import decode
from swimm_tpu_torch.benchmarks import REPO, MissingDb, bench_db_dir, where
from swimm_tpu_torch.models.engine import resolve_device
from swimm_tpu_torch.utils.synth import synth_queries


class ServeError(RuntimeError):
    """The server exited early or answered a request with an error."""


def _request(port, req, timeout=600):
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        f = s.makefile("rw", encoding="utf-8")
        f.write(json.dumps(req) + "\n")
        f.flush()
        return json.loads(f.readline())


def _rss_mb(pid) -> float:
    """Resident set size of a process in MB (Linux /proc)."""
    with open(f"/proc/{pid}/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return float("nan")


def serve_queries(n: int) -> list:
    """The requests' queries: lengths from default_rng(3).integers(100,
    501), synth_queries(seed=5)."""
    qlens = [int(x) for x in np.random.default_rng(3).integers(100, 501,
                                                               size=n)]
    return synth_queries(n, qlens, seed=5)


def run(device=None, n_requests: int = 5, concurrent: int = 8,
        n_seqs: int = 570_000, top_k: int = 16, soak: int = 0,
        stream: bool = False, root=None, db_dir=None):
    """The serving measurement against the server's DB: db_dir, else the
    cached pack of bench_db_dir(n_seqs, root) (MissingDb when absent).
    Returns (the JSON line's dict, {"serial", "concurrent", "soak": the
    replies, "queries"})."""
    dev = resolve_device(device)
    dbdir = Path(db_dir) if db_dir is not None else (
        bench_db_dir(n_seqs, root) / "db")
    if not (dbdir / "manifest.json").exists():
        raise MissingDb(dbdir)
    n_q = n_requests + concurrent
    queries = serve_queries(n_q)
    qlens = [q.length for q in queries]
    n_db = json.loads((dbdir / "manifest.json").read_text())["n_seqs"]

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "swimm_tpu_torch", "serve",
         "-d", str(dbdir), "-r", str(top_k), "--listen", "127.0.0.1:0",
         "--warm", ",".join(str(n) for n in qlens), "--device", str(dev)]
        + (["--stream"] if stream else []),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        bufsize=1, cwd=str(REPO))
    world = {"queries": queries, "serial": [], "soak": []}
    try:
        port = None
        for line in proc.stderr:
            m = re.search(r"bound 127\.0\.0\.1:(\d+)", line)
            if m:
                port = int(m.group(1))
            if "serving" in line:
                break
        if port is None:
            raise ServeError("server exited before binding")
        # drain stderr so the server never blocks on it
        threading.Thread(target=lambda: [None for _ in proc.stderr],
                         daemon=True).start()
        if not _request(port, {"cmd": "ping"}).get("ok"):
            raise ServeError("server did not answer ping")
        startup_s = time.perf_counter() - t0

        def req_for(i):
            q = queries[i]
            return {"id": i, "queries": [
                {"title": q.title, "seq": decode(q.codes)}]}

        lat, cells = [], []
        for i in range(n_requests):
            t1 = time.perf_counter()
            resp = _request(port, req_for(i))
            lat.append(time.perf_counter() - t1)
            if "error" in resp:
                raise ServeError(f"request {i}: {resp['error']}")
            world["serial"].append(resp)
            cells.append(resp["metrics"]["cells"])

        # all at once: the first request in dispatches alone, the rest
        # coalesce behind it
        conc = [None] * concurrent
        ts = [threading.Thread(target=lambda j=j: conc.__setitem__(
            j, _request(port, req_for(n_requests + j))))
            for j in range(concurrent)]
        t2 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        conc_wall = time.perf_counter() - t2
        for j, resp in enumerate(conc):
            if resp is None or "error" in resp:
                raise ServeError(f"concurrent request {j}: "
                                 f"{(resp or {}).get('error', 'no reply')}")
        world["concurrent"] = conc
        # a batch's members share one metrics dict verbatim; distinct
        # dispatches differ (in their timings at least)
        uniq = {json.dumps(r["metrics"], sort_keys=True) for r in conc}
        conc_cells = sum(json.loads(u)["cells"] for u in uniq)

        soaked = {}
        if soak > 0:
            slat, errors, rss_first = [], 0, None
            for i in range(soak):
                t3 = time.perf_counter()
                resp = _request(port, req_for(i % n_q))
                slat.append(time.perf_counter() - t3)
                world["soak"].append(resp)
                errors += "error" in resp
                if i == 0:
                    rss_first = _rss_mb(proc.pid)
            rss_last = _rss_mb(proc.pid)
            s = sorted(slat)
            soaked = {
                "soak_n": soak,
                "soak_errors": errors,
                "soak_p50_s": round(s[len(s) // 2], 4),
                "soak_p95_s": round(s[int(len(s) * 0.95)], 4),
                "soak_rss_first_mb": round(rss_first, 1),
                "soak_rss_last_mb": round(rss_last, 1),
                "soak_rss_growth_mb": round(rss_last - rss_first, 1),
            }
        _request(port, {"cmd": "shutdown"}, timeout=60)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)

    med = sorted(lat)[len(lat) // 2]
    med_cells = sorted(cells)[len(cells) // 2]
    return {
        "metric": ("request latency through a resident `python -m "
                   f"swimm_tpu_torch serve --listen` process on {where(dev)}"
                   f", 1 query/request vs {n_db}-seq DB"
                   + (" (streaming posture)" if stream else "")),
        **({"posture": "stream"} if stream else {}),
        "startup_s": round(startup_s, 1),
        "serial_request_s": [round(x, 4) for x in lat],
        "median_request_s": round(med, 4),
        "request_gcups": round(med_cells / med / 1e9, 1),
        "concurrent_n": concurrent,
        "concurrent_wall_s": round(conc_wall, 4),
        "concurrent_dispatches": len(uniq),
        "concurrent_gcups": round(conc_cells / conc_wall / 1e9, 1),
        **soaked,
    }, world


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m swimm_tpu_torch.benchmarks.bench_serve",
        description="Request latency, coalescing and a memory soak through "
                    "one `serve --listen` process (one JSON line).")
    ap.add_argument("--n-requests", type=int, default=5)
    ap.add_argument("--concurrent", type=int, default=8)
    ap.add_argument("--n-seqs", type=int, default=570_000)
    ap.add_argument("--top-k", type=int, default=16)
    ap.add_argument("--soak", type=int, default=0,
                    help="extra serial requests cycling the query set, "
                         "with server RSS sampled (memory-flatness soak)")
    ap.add_argument("--stream", action="store_true",
                    help="serve through the windowed streaming posture")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain scorers)")
    args = ap.parse_args(argv)
    try:
        out, _ = run(args.device, args.n_requests, args.concurrent,
                     args.n_seqs, args.top_k, args.soak, args.stream)
    except MissingDb as e:
        print(json.dumps({"error": f"bench DB missing at {e}; run python -m "
                          "swimm_tpu_torch.bench (or bench_swissprot) once "
                          "first"}))
        return 1
    except ServeError as e:
        print(json.dumps({"error": str(e)}))
        return 1
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
