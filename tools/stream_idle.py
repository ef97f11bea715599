"""Time the streamed batch cell's batches (spstream_q20: the 20 queries of
q20_uniform100_500 over the Swiss-Prot-sized pack, memmapped, in 8,192-tile
windows) for trees of this repository in turns, on one NVIDIA GPU, and say
where the device's idle time a batch goes.

    python3 tools/stream_idle.py --tree parent=build/parent --tree change=. \\
        --order parent,change,change,parent --seed 2210021014 \\
        [--batches 20] [--out chiprun_out/stream_idle]

The database and its pack are built once, from the seed, by swbench's own
generator and the port's native packer (as a run of the cell builds them),
under --work. Each turn is a child process with its tree first on sys.path:
it loads the pack with load_db, warms up with two batches, then runs three
passes of --batches batches each and prints one JSON line:

  wall_ms         engine.search's wall time a batch, untraced, nothing
                  wrapped (the cell's gcups is its cells over these)
  launch_host_ms  host time a batch inside engine.score_lanes (second pass,
                  wrapped): the launch path's host work, which the card
                  waits for only where the host is not ahead of it
  head_ms         from engine.search's start to its first score_lanes call
                  (second pass): profile builds and the first window's read
  syncs           synchronizing CUDA calls inside score_lanes over the
                  second pass (torch.cuda.set_sync_debug_mode("warn"))
  busy_ms         the device's busy time a batch (third pass, under
                  torch.profiler through swbench.trace.Tracer: the union
                  of kernels, copies and memsets in the batch's interval)
  idle_ms         wall_ms's median less busy_ms's median: idle a batch,
                  untraced
  traced_*_ms     the traced pass's idle a batch, cut into the gap before
                  the batch's first device operation (head), the gaps
                  between its operations (mid) and the gap after its last
                  (tail)

Medians over the pass's batches, with each batch's values listed.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELL = "spstream_q20"


def _cell():
    from swbench.spec import Spec
    spec = Spec()
    cell = spec.cell(CELL)
    return spec.config(cell["config"]), spec.traffic(cell["traffic"])


def build(work: Path, seed: int, n_seqs: int | None) -> None:
    from swbench import run
    cfg, mix = _cell()
    if n_seqs:
        cfg["db"]["n_seqs"] = n_seqs
    run.prepare(cfg, mix, seed, 51.0, work, {}, time.perf_counter())


def _median(xs):
    return statistics.median(xs) if xs else None


def child(work: Path, seed: int, batches: int, device: str) -> dict:
    import warnings

    import torch

    from swbench import dbgen, workload
    from swbench.trace import Tracer
    from swimm_tpu_torch.db import load_db
    from swimm_tpu_torch.fasta import parse_fasta_str
    from swimm_tpu_torch.models import engine
    from swimm_tpu_torch.models.engine import SearchConfig

    cfg, mix = _cell()
    traffic = workload.make(mix, seed, 51.0)
    records = parse_fasta_str(dbgen.query_fasta(traffic.queries))
    config = SearchConfig(**cfg["search"])
    packed = load_db(work / "pack")

    on_card = device == "cuda"

    def batch():
        return engine.search(packed, records, config, device=device)

    def sync_mode(mode):
        if on_card:
            torch.cuda.set_sync_debug_mode(mode)

    for _ in range(2):
        batch()
    if on_card:
        torch.cuda.synchronize()
    out = {"tree": str(Path(engine.__file__).resolve().parents[2]),
           "card": torch.cuda.get_device_name(0) if on_card else "cpu"}

    wall = []
    for _ in range(batches):
        t0 = time.perf_counter()
        batch()
        wall.append((time.perf_counter() - t0) * 1e3)

    real = engine.score_lanes
    state = {"host": 0.0, "first": None, "syncs": 0}

    def timed(*a, **kw):
        t0 = time.perf_counter()
        if state["first"] is None:
            state["first"] = t0
        sync_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                return real(*a, **kw)
        finally:
            sync_mode("default")
            state["syncs"] += sum("synchroniz" in str(w.message)
                                  for w in caught)
            state["host"] += time.perf_counter() - t0

    engine.score_lanes = timed
    host, head = [], []
    try:
        for _ in range(batches):
            state.update(host=0.0, first=None)
            t0 = time.perf_counter()
            batch()
            host.append(state["host"] * 1e3)
            head.append((state["first"] - t0) * 1e3)
    finally:
        engine.score_lanes = real

    spans = []
    tracer = Tracer(work / f"trace_{os.getpid()}")
    (work / f"trace_{os.getpid()}").mkdir(exist_ok=True)
    with tracer:
        t_lo = time.perf_counter()
        for _ in range(batches):
            t0 = time.perf_counter()
            batch()
            spans.append((t0, time.perf_counter()))
        t_hi = time.perf_counter()
    tl = tracer.timeline(t_lo, t_hi)
    busy, heads, mids, tails = [], [], [], []
    for a, b in spans:
        tl.lo, tl.hi = a, b
        ivs = tl.clipped()
        busy.append(tl.busy() * 1e3)
        gaps = tl.gaps()
        first = ivs[0][0] if ivs else b
        last = max(e for _, e in ivs) if ivs else a
        heads.append((first - a) * 1e3)
        tails.append((b - last) * 1e3)
        mids.append(sum(min(y, last) - max(x, first) for x, y in gaps
                        if y > first and x < last) * 1e3)
    out.update(
        wall_ms=_median(wall), launch_host_ms=_median(host),
        head_ms=_median(head), syncs=state["syncs"],
        busy_ms=_median(busy), idle_ms=_median(wall) - _median(busy),
        traced_head_ms=_median(heads), traced_mid_ms=_median(mids),
        traced_tail_ms=_median(tails),
        batches={"wall_ms": wall, "launch_host_ms": host, "head_ms": head,
                 "busy_ms": busy, "traced_head_ms": heads,
                 "traced_mid_ms": mids, "traced_tail_ms": tails})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/stream_idle.py")
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR, a checkout of this repository")
    ap.add_argument("--order", default=None,
                    help="comma-separated tree names, the turns in order")
    ap.add_argument("--seed", type=int, default=2210021014)
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--work", default=str(ROOT / "build" / "stream_idle"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cpu: a rehearsal of the control flow only")
    ap.add_argument("--n-seqs", type=int, default=None,
                    help="a smaller database, for a rehearsal")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.append(str(ROOT))      # behind a child's tree
    work = Path(args.work)
    if args.child:
        print(json.dumps(child(work, args.seed, args.batches, args.device)),
              flush=True)
        return 0
    trees = dict(t.split("=", 1) for t in args.tree) or {"shipped": "."}
    order = args.order.split(",") if args.order else list(trees)
    work.mkdir(parents=True, exist_ok=True)
    if not (work / "pack").exists():
        build(work, args.seed, args.n_seqs)
    results = []
    for name in order:
        tree = Path(trees[name]).resolve()
        env = dict(os.environ, PYTHONPATH=f"{tree}{os.pathsep}{ROOT}")
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child",
             "--seed", str(args.seed), "--batches", str(args.batches),
             "--work", str(work), "--device", args.device], env=env,
            cwd=tree,
            capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stdout + proc.stderr)
            return proc.returncode
        res = dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                   name=name)
        results.append(res)
        print(json.dumps({k: v for k, v in res.items() if k != "batches"}),
              flush=True)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        with open(Path(args.out) / f"stream_idle_{args.seed}.json",
                  "w") as fh:
            json.dump(results, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
