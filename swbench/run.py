"""One run of one cell:

    python -m swbench --workload CELL --seed N --seconds S --trace 0|1

1. makes the cell's queries and database from the seed (workload, dbgen);
2. writes the database as FASTA and packs it with the port's own
   preprocess, ``swimm_tpu_torch.db.build_db`` (its native route), into a
   directory under TMPDIR that the run removes;
3. brings the configuration's deployment up on the card and warms this
   cell's shapes (drivers/<driver>.py);
4. measures for ``seconds`` (with ``--trace 1`` under the profiler);
5. frees the program's state, then compares the answers with the plain
   reference (check.py), which scores the shortest checked query against
   the whole database;
6. prints the compared numbers beside their limits as the last lines of
   stderr, and one JSON result as the last line of stdout.

With no card, or fewer than the cell asks for, it exits 3 and prints no
result; it never falls back to the CPU. It exits 4, with no result, if a
module whose top-level name is jax, jaxlib, flax or swimm_tpu (the JAX
package) is loaded when the window has closed.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

from swbench import check, dbgen, sol, workload
from swbench.spec import Spec
from swbench.trace import Spans, Tracer, breakdown

#: top-level module names a run may not load (compared whole: the port's
#: own name, swimm_tpu_torch, begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "swimm_tpu")

CHECKOUT = Path(__file__).resolve().parents[1]


def forbidden_modules(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m swbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = (_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's nvcc and cc libraries already live in build/)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CHECKOUT / "build" / "swbench" / sub)


def _check_queries(mix: dict, traffic, seed: int):
    """The queries whose answers are held to the reference: all, or a
    sample of ``check_sample`` drawn from the seed with the longest."""
    n = len(traffic.queries)
    want = mix.get("check_sample")
    if want is None or want >= n:
        return list(range(n))
    rng = dbgen.rng_for(seed, "check_queries")
    pick = set(rng.choice(n, size=want - 1, replace=False).tolist())
    pick.add(int(traffic.lengths.argmax()))
    return sorted(pick)


def _full_queries(traffic, check_queries) -> list:
    """The checked query that the reference scores against the whole
    database: the shortest (the first of those of its length)."""
    lens = traffic.lengths
    return [min(check_queries, key=lambda q: (lens[q], q))]


def prepare(cfg: dict, mix: dict, seed: int, seconds: float, work: Path,
            phases: dict, t_start: float):
    """The cell's traffic and database from the seed, the database packed
    by the port's own preprocess (build_db's native route, fed a FASTA
    path) under ``work``. Returns (traffic, db, packed)."""
    traffic = workload.make(mix, seed, seconds)
    db = dbgen.make_db(cfg["db"], traffic.queries, seed)
    phases["data_s"] = time.perf_counter() - t_start
    fasta = work / "db.fasta"
    dbgen.write_fasta(db, fasta)
    phases["fasta_s"] = time.perf_counter() - t_start
    from swimm_tpu_torch import native
    from swimm_tpu_torch.db import build_db
    if not native.available():
        raise RuntimeError("the port's native packer does not build")
    packed = build_db(str(fasta), work / "pack", V=cfg["db"]["V"])
    fasta.unlink()
    phases["pack_s"] = time.perf_counter() - t_start
    return traffic, db, packed


def _say(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def main(argv=None, t_start: float | None = None, device: str | None = None,
         spec: Spec | None = None, overrides: dict | None = None) -> int:
    """Run one cell. ``device``, ``spec`` and ``overrides`` exist for the
    harness's own tests (a CPU run at a small size); a benchmark run
    passes none of them."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    spec = spec or Spec()
    cell = spec.cell(args.workload)
    over = overrides or {}
    cfg = _merge(spec.config(cell["config"]), over.get("config", {}))
    mix = _merge(spec.traffic(cell["traffic"]), over.get("traffic", {}))
    _cache_dirs()
    import torch
    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell["chips"]:
            _say(f"swbench: {args.workload} needs {cell['chips']} CUDA "
                 f"card(s); this machine has {have}")
            return 3
        device = "cuda"
        sol.check_card(torch.cuda.get_device_properties(0)
                       .multi_processor_count)
    on_card = device == "cuda"
    search = cfg["search"]
    k = mix.get("request", {}).get("top_k", search["top_k"])
    with tempfile.TemporaryDirectory(prefix="swbench-") as work:
        work = Path(work)
        phases = {"start_s": time.perf_counter() - t_start}
        traffic, db, packed = prepare(cfg, mix, args.seed, args.seconds,
                                      work, phases, t_start)
        spans = Spans()
        session = spec.driver(cfg["driver"]).Session(
            cfg, traffic, db, packed, device, args.seed, args.seconds, spans,
            work)
        tracer = Tracer(work, enabled=bool(args.trace))
        try:
            session.setup()
            phases["warm_s"] = time.perf_counter() - t_start
            with tracer:
                win = session.window()
            peak = torch.cuda.max_memory_allocated() if on_card else 0
            timeline = tracer.timeline(win.t0, win.t1)
            label = session.label
        finally:
            session.close()
        del session, packed
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        bad = forbidden_modules()
        if bad:
            _say(f"swbench: modules loaded that a run may not load: {bad}")
            return 4
        checked = _check_queries(mix, traffic, args.seed)
        counts = check.judge(
            win.answers, traffic.queries, db, k, search["gap_open"],
            search["gap_extend"], args.seed, check_queries=checked,
            full=_full_queries(traffic, checked), device=device)
        phases["check_s"] = time.perf_counter() - t_start
    correct = all(counts[n] <= lim for n, lim in check.LIMITS.items())
    rec = SimpleNamespace(cell=cell, window=win, counters=win.counters,
                          requests=win.requests, spans=spans,
                          timeline=timeline)
    metrics = {}
    for m in spec.metrics_of(args.workload, bool(args.trace)):
        if args.trace:
            value = spec.reader(m["name"])(rec)
        elif m["name"] == "setup_s":
            value = win.t0 - t_start
        elif m["name"] == "device_peak_mib":
            value = peak / 2 ** 20
        else:
            value = win.e2e[m["name"]]
        if value is not None and not math.isfinite(value):
            _say(f"swbench: {m['name']} is not finite: a request failed")
        elif value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": len(win.answers),
           "failed": counts["missing_answers"], "metrics": metrics,
           "device": dev}
    if timeline is not None:
        dev["busy_s"] = timeline.busy()
        dev["window_s"] = timeline.hi - timeline.lo
        out["breakdown"] = breakdown(timeline, label)
    out["counters"] = win.counters
    out["phases"] = phases
    out["check"] = {n: {"value": counts[n], "limit": lim}
                    for n, lim in check.LIMITS.items()}
    for n, lim in check.LIMITS.items():
        _say(f"check {n} {counts[n]} limit {lim}")
    print(json.dumps(out), flush=True)
    return 0
