"""Kernel microbenchmark: GCUPS of kernel 4 (sw_chunk_kernel, through
ops/scorer.score_chunk) on one chunk, the counterpart of the JAX package's
benchmarks/bench_kernel.py.

A 144-aa query (random_codes(default_rng(0), 144): the classic P02232
length) against one (32, 512, 128) chunk of random codes from the same
generator, BLOSUM62 10/2. One chain is ``n_inner`` (8) calls, each on the
codes XORed with the previous call's score sum mod 2, so every call
depends on the one before it on the device: no host synchronisation in the
chain, and no call can be skipped or overlapped with the next. A warm-up
chain, then ``reps`` (4) chains timed together with CUDA events
(benchmarks.device_seconds). GCUPS = B x L x V x 144 x n_inner x reps
cells over that time (m = 144 has no pad rows). Prints ONE JSON line:
  {"metric": ..., "value": GCUPS, "unit": "GCUPS", "vs_baseline": ...}
vs_baseline divides by 150 (BASELINE.md's SWIMM dual-Xeon midpoint). The
time includes each call's launch, as the reference's includes its
dispatch.

Run: python -m swimm_tpu_torch.benchmarks.bench_kernel [--device cpu].
On the CPU: the plain scorer at (2, 64, 16), 2 calls a chain, 1 chain.
Without --device cpu it runs on the card and raises when there is none.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from swimm_tpu_torch.benchmarks import device_seconds, where
from swimm_tpu_torch.models.engine import resolve_device
from swimm_tpu_torch.models.profile import build_query_profile
from swimm_tpu_torch.ops import scorer
from swimm_tpu_torch.utils.synth import random_codes

BASELINE_GCUPS = 150.0


def chain_inputs(shape: tuple, device: torch.device):
    """(query codes, its (32, 144) profile, (B, L, V) int8 codes) on
    device, as the reference draws them: one default_rng(0) for the query,
    then the codes."""
    rng = np.random.default_rng(0)
    query = random_codes(rng, 144)
    qp = torch.from_numpy(build_query_profile(query, "BLOSUM62",
                                              m_multiple=16)).to(device)
    codes = torch.from_numpy(rng.integers(0, 20, size=shape,
                                          dtype=np.int8)).to(device)
    return query, qp, codes


def chained(codes, qp, n_inner: int, score=scorer.score_chunk):
    """n_inner calls of score(codes ^ (previous sum % 2), qp, 10, 2), all
    on the device; returns the last call's score sum as an int32 tensor."""
    tot = torch.zeros((), dtype=torch.int32, device=codes.device)
    for _ in range(n_inner):
        c2 = codes ^ (tot % 2).to(torch.int8)
        tot = score(c2, qp, 10, 2).sum().to(torch.int32)
    return tot


def run(device=None, shape: tuple | None = None, n_inner: int | None = None,
        reps: int | None = None):
    """The chained kernel-4 measurement; sizes default to the reference's
    for the device ((32, 512, 128), 8 calls, 4 chains on a card; (2, 64,
    16), 2, 1 on the CPU). Returns (the JSON line's dict, the last chain's
    total: the int32 sum of its last call's scores)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    B, L, V = shape or ((32, 512, 128) if on_card else (2, 64, 16))
    n_inner = n_inner or (8 if on_card else 2)
    reps = reps or (4 if on_card else 1)
    query, qp, codes = chain_inputs((B, L, V), dev)
    last = []
    device_seconds(lambda: last.append(chained(codes, qp, n_inner)),
                   dev)                                    # warm-up
    dt = device_seconds(lambda: last.extend(
        chained(codes, qp, n_inner) for _ in range(reps)), dev)
    cells = B * L * V * len(query) * n_inner * reps
    gcups = cells / dt / 1e9
    return {
        "metric": (f"GCUPS/card on {where(dev)} (exact affine SW fill, "
                   "144aa query, BLOSUM62 10/2)"),
        "value": round(gcups, 1),
        "unit": "GCUPS",
        "vs_baseline": round(gcups / BASELINE_GCUPS, 2),
    }, int(last[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m swimm_tpu_torch.benchmarks.bench_kernel",
        description="GCUPS of kernel 4 on one chunk, a chain of dependent "
                    "calls (one JSON line).")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain scorer, small)")
    args = ap.parse_args(argv)
    out, _ = run(args.device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
