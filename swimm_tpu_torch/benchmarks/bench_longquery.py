"""Long-query benchmark (BASELINE config 3), the counterpart of the JAX
package's benchmarks/bench_longquery.py.

A 5,478-aa titin-like query (synth_queries(1, [5478], seed=3)) against a
synthetic DB of ``n_seqs`` (30,000) sequences (synth_db seed 4,
homolog_frac 0.0005, packed at V=128 in a temporary directory) through
engine.search: past 2,048 padded rows the query is cut into 1,024-row
tiles, the last cut to the rows left, one launch of kernel 2
(sw_ragged_qtile_kernel) each (6 for 5,478 aa, the last of 368 rows), the
H and F columns carried from tile to tile. A warm-up, then the
best of 3 runs. Prints real-cell and padded GCUPS and the card.

Run: python -m swimm_tpu_torch.benchmarks.bench_longquery [n_seqs]
[--device cpu]. Without --device cpu it runs on the card and raises when
there is none.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

from swimm_tpu_torch.benchmarks import best_of, where
from swimm_tpu_torch.db import build_db
from swimm_tpu_torch.models.engine import SearchConfig, resolve_device, search
from swimm_tpu_torch.utils.synth import synth_db, synth_queries


def run(device=None, n_seqs: int = 30_000, qlen: int = 5478, reps: int = 3,
        packed=None, queries=None):
    """The long-query measurement; ``packed`` and ``queries`` replace the
    synthetic DB and the query. Prints the reference's lines. Returns
    {"packed", "queries", "results", "metrics", "warm_s"}."""
    dev = resolve_device(device)
    if queries is None:
        queries = synth_queries(1, [qlen], seed=3)
    with tempfile.TemporaryDirectory() as td:
        if packed is None:
            recs = synth_db(n_seqs, seed=4, queries=[queries[0].codes],
                            homolog_frac=0.0005)
            packed = build_db(recs, td, V=128)
        cfg = SearchConfig(top_k=16)
        t0 = time.perf_counter()
        search(packed, queries, cfg, device=dev)
        warm_s = time.perf_counter() - t0
        print(f"warmup {warm_s:.1f}s on {where(dev)}", flush=True)
        results, met, _ = best_of(
            lambda: search(packed, queries, cfg, device=dev), reps)
    print(f"steady: {met.seconds * 1e3:.0f} ms for 1x{queries[0].length}aa "
          f"query x {packed.n_seqs} seqs")
    print(f"  real GCUPS: {met.gcups:.1f}   padded GCUPS: "
          f"{met.padded_gcups:.1f}")
    print(f"  top hit: {results[0].hits[0].score} "
          f"{results[0].hits[0].title[:40]}", flush=True)
    return {"packed": packed, "queries": queries, "results": results,
            "metrics": met, "warm_s": warm_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m swimm_tpu_torch.benchmarks.bench_longquery",
        description="GCUPS of a 5,478-aa query through the query-tiled "
                    "path (BASELINE config 3).")
    ap.add_argument("n_seqs", nargs="?", type=int, default=30_000)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain scorers)")
    args = ap.parse_args(argv)
    run(args.device, args.n_seqs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
