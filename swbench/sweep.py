"""The knee of a served cell, found once by a sweep on the card:

    python -m swbench.sweep --workload sp_serve_poisson --seed N \\
        --seconds 20 --rates 20,24,28,32,36

It brings the cell's deployment up once, as a run does, then offers each
rate in turn (the cell's mix with that Poisson rate, an open loop over the
same server) and prints one JSON line per rate: the requests due, the
share answered by the window's close (+1 s), p50 and p95 from the due
time, and the mean latency of the window's first and last thirds (a
growing backlog shows as a last third far above the first). The knee is
the highest rate whose completions keep up with no backlog growing.

``--seeds A,B,...`` offers each rate once per schedule seed (the order of
lengths and arrival gaps), the residues staying those of ``--seed``.

    python -m swbench.sweep --workload sp_serve_poisson --pick-schedule

needs no card: it prints the schedule seed the mix replays, chosen from
the traffic alone (typical_schedule).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from swbench import stats, workload
from swbench.run import _merge, prepare
from swbench.spec import Spec
from swbench.trace import Spans


#: the offered load's bins for typical_schedule (about a long dispatch)
BIN_S = 0.5


def typical_schedule(mix: dict, seconds: float, seeds=range(1, 65)) -> dict:
    """The schedule seed whose offered work -- the query residues due in
    each BIN_S bin of the window -- has its median and 95th percentile
    nearest (by the larger relative distance) to those statistics' medians
    over ``seeds``. It reads the traffic alone, no model of the program."""
    rows = []
    for s in seeds:
        t = workload.make({**mix, "schedule_seed": s}, 0, seconds)
        work = np.bincount((t.due // BIN_S).astype(np.int64),
                           weights=t.lengths,
                           minlength=int(np.ceil(seconds / BIN_S)))
        rows.append((s, float(np.median(work)),
                     float(np.quantile(work, 0.95))))
    med = np.median([r[1] for r in rows]), np.median([r[2] for r in rows])
    dist = {s: max(abs(a / med[0] - 1), abs(b / med[1] - 1))
            for s, a, b in rows}
    best = min(dist, key=lambda s: (dist[s], s))
    return {"schedule_seed": best, "distance": dist[best],
            "median_work": med[0], "p95_work": med[1],
            "chosen": next(r[1:] for r in rows if r[0] == best)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m swbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--rates", default=None)
    ap.add_argument("--seeds", default=None,
                    help="schedule seeds to offer each rate with (default: "
                         "the mix's own)")
    ap.add_argument("--pick-schedule", action="store_true")
    args = ap.parse_args(argv)
    spec = Spec()
    cell = spec.cell(args.workload)
    cfg, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    seconds = args.seconds or spec.bench["run_seconds"]
    if args.pick_schedule:
        print(json.dumps(typical_schedule(mix, seconds)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("swbench.sweep: no CUDA card", file=sys.stderr)
        return 3
    rates = [float(r) for r in args.rates.split(",")]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="swbench-sweep-") as work:
        top = _merge(mix, {"arrivals": {"poisson_rate": max(rates)}})
        traffic, db, packed = prepare(cfg, top, args.seed, seconds,
                                      Path(work), {}, t0)
        session = spec.driver(cfg["driver"]).Session(
            cfg, traffic, db, packed, "cuda", args.seed, seconds,
            Spans(), Path(work))
        try:
            session.setup()
            seeds = ([int(x) for x in args.seeds.split(",")] if args.seeds
                     else [mix.get("schedule_seed", args.seed)])
            for rate, sched_seed in ((r, s) for r in rates for s in seeds):
                m = _merge(mix, {"arrivals": {"poisson_rate": rate},
                                 "schedule_seed": sched_seed})
                session.traffic = workload.make(m, args.seed, seconds)
                win = session.window()
                lat = [r["latency_s"] for r in win.requests]
                close = win.t0 + seconds + 1.0
                third = max(1, len(lat) // 3)
                print(json.dumps({
                    "rate": rate, "seed": sched_seed, "due": len(lat),
                    "answered_by_close": sum(
                        r["recv"] is not None and r["recv"] <= close
                        and r["search_s"] is not None
                        for r in win.requests) / len(lat),
                    "p50_ms": 1e3 * stats.percentile(lat, 50),
                    "p95_ms": 1e3 * stats.percentile(lat, 95),
                    "first_third_mean_ms": 1e3 * sum(lat[:third]) / third,
                    "last_third_mean_ms": 1e3 * sum(lat[-third:]) / third,
                    "queries_per_dispatch": win.counters["queries"]
                    / max(1, win.counters["dispatches"]),
                    "card": torch.cuda.get_device_name(0)}), flush=True)
        finally:
            session.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
