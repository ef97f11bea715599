"""Headline benchmark: end-to-end real GCUPS of one card at Swiss-Prot
scale, the counterpart of the JAX package's bench.py.

A 570,000-sequence synthetic Swiss-Prot-scale database
(benchmarks.bench_db: synth_fasta_fast seed 2, homolog_frac 0.0005, the
native packer, cached in .bench_sp_torch_570000/) resident on the card is
searched by 20 queries of 100-500 aa (benchmarks.bench_queries), BLOSUM62
10/2, top 16, one kernel-1 launch per query (query_pack=False): a warm-up,
then the best of at most ``reps`` runs. Prints ONE JSON line on stdout:
  {"metric": ..., "value": GCUPS, "unit": "GCUPS", "vs_baseline": ...}
with the reference's keys; progress goes to stderr.

GCUPS counts real cells (query length x DB residues over the search's
wall time, SearchMetrics.gcups). vs_baseline divides by 150, the midpoint
of the SWIMM dual-Xeon figure (BASELINE.md): the card against that whole
node. The metric string names the card and its power limit.

Before the search it probes the card's link (h2d_mbps: a 16 MiB host
array to the card; pull_rtt_ms: a tiny device op pulled back with .cpu(),
median of 3). Then, under a wall budget (SWTPU_BENCH_BUDGET_S, default
450 s, re-anchored after the probe and after the warm-up), the extras on
the same DB and batch: the precision ladder (ladder_gcups), the MFU of
kernel 1 (benchmarks.roofline: padded GCUPS at m=1,024 against the card's
nominal instruction rate) and the windowed streaming posture
(stream_gcups, with stream_link_floor_s and stream_stall_limited). An
extra past its share of the budget is skipped with "*_skipped": "wall
budget". SWTPU_BENCH_NO_EXTRAS=1 drops the ladder and the stream,
SWTPU_BENCH_NO_MFU=1 the MFU.

One divergence from the reference, on purpose: an extra that raises is not
caught into a "*_error" key. The exception propagates and the command
exits non-zero with no JSON line, so a fault of the card or a kernel is
never hidden behind a printed number.

Run: python -m swimm_tpu_torch.bench [--device cpu]. On the CPU it runs
the plain scorers at the reference's CPU sizes (2,000 sequences, 4
queries) without the link probe and the extras; without --device cpu it
runs on the card and raises when there is none.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from swimm_tpu_torch.benchmarks import (bench_db, bench_queries, best_of,
                                        launch_counts, where)
from swimm_tpu_torch.models.engine import SearchConfig, resolve_device, search

N_SEQS = 570_000
N_QUERIES = 20
CPU_N_SEQS = 2_000
CPU_N_QUERIES = 4
BASELINE_GCUPS = 150.0      # SWIMM dual-Xeon midpoint, BASELINE.md


def probe_link(device: torch.device):
    """(h2d_mbps, pull_rtt_ms) of the card: a 16 MiB int8 host array sent
    to it and synchronised, and the round trip of a tiny device op pulled
    back with .cpu() (median of 3, after one warm call)."""
    x = torch.zeros(16 * 1024 * 1024, dtype=torch.int8)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    x.to(device)
    torch.cuda.synchronize(device)
    h2d_mbps = 16.0 / max(time.perf_counter() - t0, 1e-9)
    y = torch.zeros((8, 128), dtype=torch.float32, device=device)
    (y + 1.0).cpu()
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        (y + 1.0).cpu()
        ts.append(time.perf_counter() - t0)
    return round(h2d_mbps, 1), round(sorted(ts)[1] * 1000, 3)


def run(device=None, n_seqs: int | None = None, n_queries: int | None = None,
        reps: int = 3, extras: bool | None = None, mfu: bool | None = None,
        root=None, packed=None, queries=None):
    """The headline measurement. Sizes default to the reference's for the
    device (570,000 sequences and 20 queries on a card; 2,000 and 4 on the
    CPU); ``packed`` and ``queries`` replace the cached DB and the query
    set. ``reps`` caps the measured runs of every posture (the resident
    batch up to 3, the ladder up to 2, the stream up to 3 in the
    reference). extras / mfu default to on for a card unless
    SWTPU_BENCH_NO_EXTRAS / SWTPU_BENCH_NO_MFU is set; the wall budget is
    SWTPU_BENCH_BUDGET_S (450 s). Progress goes to stderr.

    Returns (the JSON line's dict, {"packed", "queries", "results",
    "metrics", "launches": each kernel's launches in this run (also on
    stderr), and "ladder" / "stream": (results, metrics) of the extras
    that ran})."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    launched = launch_counts()
    budget = float(os.environ.get("SWTPU_BENCH_BUDGET_S", "450"))
    if extras is None:
        extras = on_card and not os.environ.get("SWTPU_BENCH_NO_EXTRAS")
    if mfu is None:
        mfu = on_card and not os.environ.get("SWTPU_BENCH_NO_MFU")
    anchor = [t0]

    def note(msg: str) -> None:
        print(f"[bench +{time.perf_counter() - t0:.0f}s] {msg}",
              file=sys.stderr, flush=True)

    def run_elapsed() -> float:
        return time.perf_counter() - anchor[0]

    if queries is None:
        queries = bench_queries(n_queries or (N_QUERIES if on_card
                                              else CPU_N_QUERIES))
    if packed is None:
        packed, _ = bench_db(n_seqs or (N_SEQS if on_card else CPU_N_SEQS),
                             queries, root)
    note(f"db ready on {where(dev)}")
    link = {}
    if on_card:
        h2d, rtt = probe_link(dev)
        link = {"h2d_mbps": h2d, "pull_rtt_ms": rtt}
    anchor[0] = time.perf_counter()
    note(f"link probe done: {link}")

    cfg = SearchConfig(top_k=16, query_pack=False)
    search(packed, queries, cfg, device=dev)        # warm-up: DB upload
    note("resident warmup done")
    anchor[0] = time.perf_counter()
    results, best, n_reps = best_of(
        lambda: search(packed, queries, cfg, device=dev), reps,
        lambda: run_elapsed() < 0.55 * budget)
    note(f"resident best of {n_reps}: {best.seconds:.3f}s")
    gcups = best.gcups
    world = {"packed": packed, "queries": queries, "results": results,
             "metrics": best}
    out = {
        "metric": (f"GCUPS/card on {where(dev)}, end-to-end exact SW search "
                   f"({len(queries)} queries 100-500aa vs {packed.n_seqs}-seq "
                   f"{packed.total_residues}-residue DB, BLOSUM62 10/2, "
                   "device-resident serving path, real cells)"),
        "value": round(gcups, 1),
        "unit": "GCUPS",
        "vs_baseline": round(gcups / BASELINE_GCUPS, 2),
        "seq_scores_per_sec_M": round(best.seqs_per_sec / 1e6, 2),
        "resident_reps": n_reps,
        **link,
    }
    if extras:
        if run_elapsed() < 0.55 * budget:
            lcfg = SearchConfig(top_k=16, precision="ladder")
            search(packed, queries, lcfg, device=dev)       # warm
            res, m, _ = best_of(
                lambda: search(packed, queries, lcfg, device=dev),
                min(reps, 2), lambda: run_elapsed() <= 0.65 * budget)
            note(f"ladder best: {m.seconds:.3f}s")
            world["ladder"] = (res, m)
            out["ladder_gcups"] = round(m.gcups, 1)
            out["ladder_frac_of_resident"] = round(m.gcups / gcups, 2)
        else:
            out["ladder_skipped"] = "wall budget"
    if mfu:
        if run_elapsed() < 0.75 * budget:
            from swimm_tpu_torch.benchmarks import roofline
            note("mfu section start")
            padded = roofline.measure_kernel_padded_gcups(1024, device=dev)
            peak = roofline.peak_instruction_rate()
            out["kernel_padded_gcups"] = round(padded["median"], 1)
            out["kernel_padded_gcups_band"] = [round(padded["min"], 1),
                                               round(padded["max"], 1)]
            out["mfu_pct"] = round(roofline.mfu_pct(padded["median"], 1024,
                                                    peak), 1)
            out["mfu_pct_band"] = [
                round(roofline.mfu_pct(padded[k], 1024, peak), 1)
                for k in ("min", "max")]
        else:
            out["mfu_skipped"] = "wall budget"
    if extras:
        # the stream last: it crosses the link once per run
        db_mb = sum(ch.n_blocks * ch.L * ch.V for ch in packed.chunks) / 1e6
        if run_elapsed() < 0.85 * budget:
            scfg = SearchConfig(top_k=16, db_stream=True)
            res, m, _ = best_of(
                lambda: search(packed, queries, scfg, device=dev),
                min(reps, 3), lambda: run_elapsed() <= 0.95 * budget)
            note(f"stream best: {m.seconds:.3f}s")
            world["stream"] = (res, m)
            out["stream_gcups"] = round(m.gcups, 1)
            out["stream_frac_of_resident"] = round(m.gcups / gcups, 2)
            out["stream_seconds"] = round(m.seconds, 3)
            if link.get("h2d_mbps"):
                floor = db_mb / link["h2d_mbps"]
                out["stream_link_floor_s"] = round(floor, 3)
                out["stream_stall_limited"] = bool(
                    m.seconds > 2.0 * (best.seconds + floor))
        else:
            out["stream_skipped"] = "wall budget"
    out["bench_wall_s"] = round(time.perf_counter() - t0, 1)
    world["launches"] = {k: n - launched[k]
                         for k, n in launch_counts().items()}
    note(f"kernel launches: {world['launches']}")
    return out, world


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m swimm_tpu_torch.bench",
        description="End-to-end real GCUPS of the card at Swiss-Prot scale "
                    "(one JSON line).")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain scorers at the "
                         "reference's CPU sizes, no extras)")
    args = ap.parse_args(argv)
    out, _ = run(args.device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
