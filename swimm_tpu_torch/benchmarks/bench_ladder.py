"""Batched precision-ladder serving throughput against the exact adaptive
path, the counterpart of the JAX package's benchmarks/bench_ladder.py (its
bar: the ladder at >= 0.85x the exact path at Swiss-Prot scale, with equal
hit lists).

Runs the 20-query batch (benchmarks.bench_queries) against the cached
Swiss-Prot-scale DB (benchmarks.cached_bench_db) with
precision='adaptive' and precision='ladder' (ops/ladder.py: tier 1 on
sw_ragged_kernel<CEIL> over the resident stream, later tiers on the
flagged blocks): a warm-up, then the best of 3 each. Prints one JSON line
a precision and a summary line with the reference's keys (hits_equal,
ladder_vs_adaptive, meets_085x_bar), the card on stderr; exit 1 when the
hit lists differ. A missing cache says so on stderr and exits 1.

Run: python -m swimm_tpu_torch.benchmarks.bench_ladder [--n-queries 20]
[--device cpu]. On the CPU the DB is the reference's CPU one (1,500
sequences). Without --device cpu it runs on the card and raises when there
is none.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from swimm_tpu_torch.benchmarks import (MissingDb, bench_queries, best_of,
                                        cached_bench_db, where)
from swimm_tpu_torch.models.engine import SearchConfig, resolve_device, search


def run(device=None, n_seqs: int | None = None, n_queries: int = 20,
        reps: int = 3, root=None, packed=None, queries=None):
    """The ladder against the exact path; n_seqs defaults to the
    reference's for the device (570,000 on a card, 1,500 on the CPU);
    ``packed`` and ``queries`` replace the cached DB and the query set.
    Raises MissingDb when the cache is absent. Prints each line as JSON.
    Returns (the summary line, {"packed", "queries", "adaptive",
    "ladder": (results, metrics)})."""
    dev = resolve_device(device)
    if packed is None:
        packed = cached_bench_db(
            n_seqs or (570_000 if dev.type == "cuda" else 1_500), root)
    if queries is None:
        queries = bench_queries(n_queries)
    print(f"bench_ladder on {where(dev)}", file=sys.stderr, flush=True)
    out, world = {}, {"packed": packed, "queries": queries}
    for name in ("adaptive", "ladder"):
        cfg = SearchConfig(top_k=16, precision=name)
        t0 = time.perf_counter()
        search(packed, queries, cfg, device=dev)     # warm (build, upload)
        warm = time.perf_counter() - t0
        results, best, _ = best_of(
            lambda: search(packed, queries, cfg, device=dev), reps)
        world[name] = (results, best)
        out[name] = {"gcups": round(best.gcups, 1),
                     "seconds": round(best.seconds, 3),
                     "warm_s": round(warm, 1)}
        print(json.dumps({name: out[name]}), flush=True)
    hits = {name: [[(h.score, h.sorted_idx) for h in r.hits]
                   for r in world[name][0]] for name in ("adaptive", "ladder")}
    out["hits_equal"] = hits["adaptive"] == hits["ladder"]
    out["ladder_vs_adaptive"] = round(
        world["ladder"][1].gcups / world["adaptive"][1].gcups, 3)
    out["meets_085x_bar"] = out["ladder_vs_adaptive"] >= 0.85
    print(json.dumps(out), flush=True)
    return out, world


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m swimm_tpu_torch.benchmarks.bench_ladder",
        description="The precision ladder against the exact path on the "
                    "cached Swiss-Prot-scale DB (exit 1: hits differ).")
    ap.add_argument("--n-queries", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain scorers)")
    args = ap.parse_args(argv)
    try:
        out, _ = run(args.device, n_queries=args.n_queries)
    except MissingDb:
        print("run python -m swimm_tpu_torch.benchmarks.bench_swissprot "
              "first (builds the DB)", file=sys.stderr)
        return 1
    return 0 if out["hits_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
