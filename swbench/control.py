"""The controls of a cell's comparison, at the cell's own size:

    python -m swbench.control --workload CELL --seeds 1,2,3

For each seed it makes the cell's queries, database and candidate sets
as a run does (the whole database for the shortest checked query), puts
the reference in the program's place -- exact, with H saturating at 16
bits (32,767) and at 8 bits (127), and with the tie order reversed --
and judges each control's answers with check.judge, as a run judges the
program's. It prints one JSON line per (seed, control) with the counts
and the seconds the reference took. The exact control must read 0
everywhere; a control must fail at least one number to be a control. It
needs no program and does not start one.
"""

from __future__ import annotations

import argparse
import json
import time

from swbench import check, dbgen, workload
from swbench.run import _check_queries, _full_queries
from swbench.spec import Spec

CONTROLS = {"exact": {}, "int16": {"ceiling": 32767},
            "int8": {"ceiling": 127}, "reverse_ties": {"reverse_ties": True}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m swbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    spec = Spec()
    cell = spec.cell(args.workload)
    cfg, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    seconds = spec.bench["run_seconds"]
    s = cfg["search"]
    k = mix.get("request", {}).get("top_k", s["top_k"])
    for seed in (int(x) for x in args.seeds.split(",")):
        traffic = workload.make(mix, seed, seconds)
        db = dbgen.make_db(cfg["db"], traffic.queries, seed)
        qs = _check_queries(mix, traffic, seed)
        full = _full_queries(traffic, qs)
        for name, kw in CONTROLS.items():
            t = time.perf_counter()
            ans = check.control_answers(
                traffic.queries, db, k, s["gap_open"], s["gap_extend"], seed,
                qs, full=full, device="cuda", **kw)
            t_ctl = time.perf_counter() - t
            t = time.perf_counter()
            counts = check.judge(ans, traffic.queries, db, k, s["gap_open"],
                                 s["gap_extend"], seed, full=full,
                                 device="cuda")
            print(json.dumps({
                "workload": args.workload, "seed": seed, "control": name,
                "correct": all(counts[n] <= lim
                               for n, lim in check.LIMITS.items()),
                "counts": counts, "answers": len(ans),
                "top_score": max(sc for _, h in ans for sc, _ in h),
                "control_s": t_ctl, "judge_s": time.perf_counter() - t}),
                flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
