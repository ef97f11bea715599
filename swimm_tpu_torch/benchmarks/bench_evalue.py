"""E-value statistics overhead at Swiss-Prot scale, the counterpart of the
JAX package's benchmarks/bench_evalue.py.

The statistics posture reuses the resident search and adds one device
score histogram per query (engine.score_hist) and the fit on the host.
This measures the resident 20-query batch with and without evalue=True on
the cached Swiss-Prot-scale DB (benchmarks.cached_bench_db, built by
bench_swissprot or the headline bench) and reports the overhead fraction:
a warm-up, then the best of 3 each. Prints one JSON line a posture and a
summary line, with the reference's keys, and the card on stderr. A missing
cache prints the reference's error line and exits 1.

Run: python -m swimm_tpu_torch.benchmarks.bench_evalue [--device cpu]. On
the CPU the sizes are the reference's CPU ones (1,500 sequences, 4
queries). Without --device cpu it runs on the card and raises when there
is none.
"""

from __future__ import annotations

import argparse
import json
import sys

from swimm_tpu_torch.benchmarks import (MissingDb, bench_queries, best_of,
                                        cached_bench_db, where)
from swimm_tpu_torch.models.engine import SearchConfig, resolve_device, search


def run(device=None, n_seqs: int | None = None, n_queries: int | None = None,
        reps: int = 3, root=None, packed=None, queries=None):
    """Plain against evalue=True; sizes default to the reference's for the
    device (570,000 sequences and 20 queries on a card; 1,500 and 4 on the
    CPU); ``packed`` and ``queries`` replace the cached DB and the query
    set. Raises MissingDb when the cache is absent. Prints each line as
    JSON. Returns (the summary line, {"packed", "queries", "plain",
    "evalue": (results, metrics)})."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if packed is None:
        packed = cached_bench_db(n_seqs or (570_000 if on_card else 1_500),
                                 root)
    if queries is None:
        queries = bench_queries(n_queries or (20 if on_card else 4))
    print(f"bench_evalue on {where(dev)}", file=sys.stderr, flush=True)
    out, world = {}, {"packed": packed, "queries": queries}
    for name, cfg in (("plain", SearchConfig(top_k=16)),
                      ("evalue", SearchConfig(top_k=16, evalue=True))):
        search(packed, queries, cfg, device=dev)        # warm
        results, best, _ = best_of(
            lambda: search(packed, queries, cfg, device=dev), reps)
        world[name] = (results, best)
        out[name] = {"gcups": round(best.gcups, 1),
                     "seconds": round(best.seconds, 3)}
        print(json.dumps({"phase": name, **out[name]}), flush=True)
        if name == "evalue":
            out["top_hit_evalue"] = results[0].hits[0].evalue
    out["evalue_overhead_frac"] = round(
        out["evalue"]["seconds"] / out["plain"]["seconds"] - 1.0, 3)
    summary = {"summary": out}
    print(json.dumps(summary), flush=True)
    return summary, world


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m swimm_tpu_torch.benchmarks.bench_evalue",
        description="The resident batch with and without E-values on the "
                    "cached Swiss-Prot-scale DB.")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain scorers)")
    args = ap.parse_args(argv)
    try:
        run(args.device)
    except MissingDb as e:
        print(json.dumps({"error": f"no cached DB at {e}; run python -m "
                          "swimm_tpu_torch.benchmarks.bench_swissprot "
                          "first"}))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
