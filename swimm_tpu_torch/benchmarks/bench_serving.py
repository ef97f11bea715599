"""End-to-end serving benchmark in the packed posture (BASELINE config 2's
shape), the counterpart of the JAX package's benchmarks/bench_serving.py.

A synthetic DB of ``n_seqs`` (100,000) sequences (synth_db seed 2,
homolog_frac 0.001, packed at V=128 in a temporary directory) resident on
the card, 20 queries of 100-500 aa (benchmarks.bench_queries), searched
with query_pack=True: one launch of kernel 3 (sw_ragged_packed_kernel) per
pack. A warm-up (the kernels' build and the DB's upload), then the best of
3 runs. Prints real-cell GCUPS (SearchMetrics.gcups), padded GCUPS and DB
seq-scores/s, as the reference does, and the card they were measured on.

Run: python -m swimm_tpu_torch.benchmarks.bench_serving [n_seqs]
[n_queries] [--device cpu]. Without --device cpu it runs on the card and
raises when there is none.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

from swimm_tpu_torch.benchmarks import bench_queries, best_of, where
from swimm_tpu_torch.db import build_db
from swimm_tpu_torch.models.engine import SearchConfig, resolve_device, search
from swimm_tpu_torch.utils.synth import synth_db


def run(device=None, n_seqs: int = 100_000, n_queries: int = 20,
        reps: int = 3, packed=None, queries=None):
    """The packed-posture measurement; ``packed`` and ``queries`` replace
    the synthetic DB and the query set. Prints the reference's lines.
    Returns {"packed", "queries", "results", "metrics", "warm_s"}."""
    dev = resolve_device(device)
    if queries is None:
        queries = bench_queries(n_queries)
    with tempfile.TemporaryDirectory() as td:
        if packed is None:
            print(f"building {n_seqs}-seq synthetic DB...", flush=True)
            recs = synth_db(n_seqs, seed=2, queries=[q.codes for q in queries],
                            homolog_frac=0.001)
            packed = build_db(recs, td, V=128)
        cfg = SearchConfig(top_k=16, query_pack=True)
        print(f"warmup (kernel build + DB upload) on {where(dev)}...",
              flush=True)
        t0 = time.perf_counter()
        search(packed, queries, cfg, device=dev)
        warm_s = time.perf_counter() - t0
        print(f"warmup {warm_s:.1f}s", flush=True)
        results, met, _ = best_of(
            lambda: search(packed, queries, cfg, device=dev), reps)
    n_q = len(queries)
    print(f"steady: {met.seconds * 1e3:.0f} ms for {n_q} queries x "
          f"{packed.n_seqs} seqs", flush=True)
    print(f"  real GCUPS: {met.gcups:.1f}   padded GCUPS: "
          f"{met.padded_gcups:.1f}")
    print(f"  seq-scores/s: {met.n_db_seqs * n_q / met.seconds:,.0f}")
    print(f"  top hit q0: {results[0].hits[0].score} "
          f"{results[0].hits[0].title[:40]}", flush=True)
    return {"packed": packed, "queries": queries, "results": results,
            "metrics": met, "warm_s": warm_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m swimm_tpu_torch.benchmarks.bench_serving",
        description="Packed-posture serving GCUPS (BASELINE config 2).")
    ap.add_argument("n_seqs", nargs="?", type=int, default=100_000)
    ap.add_argument("n_queries", nargs="?", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain scorers)")
    args = ap.parse_args(argv)
    run(args.device, args.n_seqs, args.n_queries)
    return 0


if __name__ == "__main__":
    sys.exit(main())
