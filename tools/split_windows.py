"""Time kernel 1's pair form on each window of the streamed search's
8,192-tile plan, unsplit and on the split walk under the plans that
scorer.split_parts makes at several slot counts, in turns, on one NVIDIA
GPU, at chip_smoke.py's workload (570,000 synthetic sequences, V = 128).

    python3 tools/split_windows.py [--m 112,256,448,496] [--slots 132,264]
                                   [--rounds 3] [--out DIR]

For each profile length m (a random query of m residues, BLOSUM62, gaps
10/2) and each window it checks every variant bit-exact against the
unsplit launch, then times each variant (CUDA events, 3 launches a
reading) in turns, alternating the order from round to round. Prints the
card's name and power limit, the card's own slots
(scorer.split_slots), each plan's split blocks and extra CUDA blocks, and
per variant the window times and their sum; writes them as JSON to
--out (default build/split_windows). Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", default="112,256,448,496")
    ap.add_argument("--slots", default="132,264")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", type=Path, default=ROOT / "build" /
                    "split_windows")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("split_windows: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from swimm_tpu_torch.db import build_db
    from swimm_tpu_torch.models import engine, stream
    from swimm_tpu_torch.ops import scorer
    from swimm_tpu_torch.utils.synth import synth_fasta_fast, synth_queries
    args.out.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    rng = np.random.default_rng(0)
    queries = synth_queries(cs.N_QUERIES,
                            list(rng.integers(100, 501, size=cs.N_QUERIES)),
                            seed=1)
    with tempfile.TemporaryDirectory() as td:
        fasta = Path(td) / "sp.fasta"
        synth_fasta_fast(fasta, cs.N_SEQS, seed=2,
                         queries=[q.codes for q in queries],
                         homolog_frac=0.0005)
        packed = build_db(str(fasta), Path(td) / "db", V=128)
    tiles, outrow = engine.device_tiles(packed)[:2]
    _, jt, V = tiles.shape
    layout = stream.stream_layout(packed)
    cum = layout["cum"]
    spans, _ = stream.plan_windows(layout, 8192)
    own = scorer.split_slots("cuda", V)
    print(f"{len(spans)} windows; the card's slots at V={V}: {own}",
          flush=True)
    slot_counts = [int(x) for x in args.slots.split(",")]
    result = {"card": card, "card_slots": own, "m": {}}
    for m in (int(x) for x in args.m.split(",")):
        qp = cs.profile(np.random.default_rng(m), m)
        bounds = scorer.profile_bounds(qp)
        wins = []
        for g0, g1 in spans:
            t0, t1 = int(cum[g0]), int(cum[g1])
            lens = np.diff(cum[g0:g1 + 1]) * jt
            plans = {"unsplit": None}
            for n in slot_counts:
                plan = scorer.split_plan(lens, qp.shape[1], V, n)
                plans[f"slots{n}"] = scorer.upload_split(plan, "cuda")
            wins.append(((tiles[t0:t1], (outrow[t0:t1] - g0).contiguous(),
                          g1 - g0, torch.from_numpy(cum[g0:g1 + 1] - t0)
                          .cuda()), plans))

        def run(win, split):
            t, o, n, rs = win
            return scorer.score_tiles(t, o, n, qp, 10, 2, row_start=rs,
                                      bounds=bounds, split=split)

        names = list(wins[0][1])
        for w, (win, plans) in enumerate(wins):
            want = run(win, None)
            for name, split in plans.items():
                if not torch.equal(run(win, split), want):
                    raise SystemExit(f"m={m} window {w} {name}: scores "
                                     "differ from the unsplit launch")
        ms = {name: [[] for _ in wins] for name in names}
        for r in range(args.rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                for w, (win, plans) in enumerate(wins):
                    ms[name][w].append(cs.cuda_ms(
                        lambda: run(win, plans[name]), 3))
        out = {}
        for name in names:
            per = [float(np.median(x)) for x in ms[name]]
            split = [wins[w][1][name] for w in range(len(wins))]
            out[name] = {"window_ms": per, "sum_ms": sum(per),
                         "split_rows": [s.rows if s else 0 for s in split],
                         "extra_blocks": [s.parts if s else 0
                                          for s in split]}
            print(f"m={qp.shape[1]} {name}: windows "
                  f"{[round(x, 3) for x in per]} ms, sum {sum(per):.3f} "
                  f"ms; split blocks {out[name]['split_rows']}, extra "
                  f"CUDA blocks {out[name]['extra_blocks']}", flush=True)
        result["m"][str(qp.shape[1])] = out
    (args.out / "split_windows.json").write_text(json.dumps(result,
                                                            indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
