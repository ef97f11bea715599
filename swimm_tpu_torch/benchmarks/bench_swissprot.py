"""Swiss-Prot-scale benchmark (BASELINE metric 2, DB sequences a second at
Swiss-Prot scale), the counterpart of the JAX package's
benchmarks/bench_swissprot.py.

Synthesizes a 570,000-sequence, ~2e8-residue database and packs it through
the native parser and packer, both timed and cached
(benchmarks.bench_db, .bench_sp_torch_{n}/, shared with the headline
bench), then measures the 20-query batch (benchmarks.bench_queries) in
both postures:

  - resident on the card (the serving path, one upload): a warm-up, the
    best of 3;
  - streamed in windows (db_stream=True, the DB-larger-than-the-card
    path), sweeping window_tiles x max_in_flight over (8192, 2), (8192,
    4), (16384, 3) (--quick: (8192, 2)): a warm-up, the best of 2 each;
  - the per-query restream: engine.score_db_streaming of query 0 (every
    sequence's score, the DB crossing the link for one query).

After each posture the top 4 hits of the first 3 queries are rescored by
the C oracle on the sequences read back from the pack
(benchmarks.check_hits_vs_oracle); a difference raises. Prints one JSON
line a measurement and a summary line, with the reference's keys; the
summary's metric names the card.

Run: python -m swimm_tpu_torch.benchmarks.bench_swissprot [--n-seqs N]
[--quick] [--fresh] [--device cpu]. On the CPU the sizes are the
reference's CPU ones (1,500 sequences, 4 queries, windows of 256 tiles).
Without --device cpu it runs on the card and raises when there is none.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from swimm_tpu_torch.benchmarks import (bench_db, bench_queries, best_of,
                                        check_hits_vs_oracle, where)
from swimm_tpu_torch.models.engine import (SearchConfig, resolve_device,
                                           score_db_streaming, search,
                                           top_k_hits)

SWEEP = ((8192, 2), (8192, 4), (16384, 3))


def run(device=None, n_seqs: int | None = None, quick: bool = False,
        fresh: bool = False, n_queries: int | None = None, reps: int = 3,
        root=None, packed=None, queries=None):
    """Every posture of the module docstring; sizes default to the
    reference's for the device (570,000 sequences and 20 queries on a
    card; 1,500 and 4 on the CPU); ``packed`` and ``queries`` replace the
    cached DB and the query set (no pack timed then). ``reps`` caps the
    measured runs of each posture (3 resident, 2 a stream setting in the
    reference). Prints each line as JSON. Returns (the lines, {"packed",
    "queries", "resident": (results, metrics), "stream": [(results,
    metrics) a setting], "restream": query 0's scores})."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    lines = []

    def line(d):
        lines.append(d)
        print(json.dumps(d), flush=True)

    if queries is None:
        queries = bench_queries(n_queries or (20 if on_card else 4))
    out = {"n_seqs": n_seqs or (570_000 if on_card else 1_500)}
    if packed is None:
        packed, made = bench_db(out["n_seqs"], queries, root, fresh)
        out.update((k, round(v, 1) if k.endswith("_s") else v)
                   for k, v in made.items())
    out["n_seqs"] = packed.n_seqs
    out["total_residues"] = int(packed.total_residues)
    tiles, _, _ = packed.flat_tiles()
    out["tile_stream_mb"] = round(tiles.nbytes / 1e6, 1)
    del tiles
    line({"phase": "db", **out})
    world = {"packed": packed, "queries": queries, "stream": []}

    # ---- the resident posture (per-length shapes) ----
    cfg = SearchConfig(top_k=16, query_pack=False)
    search(packed, queries, cfg, device=dev)        # warm: build + upload
    results, best, _ = best_of(
        lambda: search(packed, queries, cfg, device=dev), reps)
    check_hits_vs_oracle(packed, queries, results)
    world["resident"] = (results, best)
    resident = {
        "phase": "resident",
        "gcups_real": round(best.gcups, 1),
        "seq_scores_per_sec_M": round(best.seqs_per_sec / 1e6, 2),
        "seconds": round(best.seconds, 3),
        "exact": True,
    }
    line(resident)

    # ---- window-major batch streaming (the DB-larger-than-the-card path)
    if not on_card:
        sweeps = [(256, 2)]     # a window small next to the CPU's DB
    elif quick:
        sweeps = [SWEEP[0]]
    else:
        sweeps = list(SWEEP)
    stream_rows = []
    for wt, mif in sweeps:
        scfg = SearchConfig(top_k=16, db_stream=True, window_tiles=wt,
                            max_in_flight=mif)
        search(packed, queries, scfg, device=dev)    # warm
        sres, smet, _ = best_of(
            lambda: search(packed, queries, scfg, device=dev), min(reps, 2))
        check_hits_vs_oracle(packed, queries, sres)
        world["stream"].append((sres, smet))
        stream_rows.append({
            "phase": "stream_batch", "window_tiles": wt,
            "max_in_flight": mif,
            "gcups_real": round(smet.gcups, 1),
            "seq_scores_per_sec_M": round(smet.seqs_per_sec / 1e6, 2),
            "seconds": round(smet.seconds, 3),
            "exact": True,
        })
        line(stream_rows[-1])

    # the per-query restream: every sequence's score for one query
    scfg1 = SearchConfig(top_k=16, db_stream=True,
                         window_tiles=8192 if on_card else 256)
    q0 = queries[0]
    score_db_streaming(packed, q0, scfg1, device=dev)   # warm
    t0 = time.perf_counter()
    scores = score_db_streaming(packed, q0, scfg1, device=dev)
    dt = time.perf_counter() - t0
    if not top_k_hits(packed, scores, 1)[0].score > 0:
        raise AssertionError("the restreamed scores of query 0 are all 0")
    world["restream"] = scores
    line({
        "phase": "stream_per_query_restream", "queries": 1,
        "gcups_real": round(q0.length * packed.total_residues / dt / 1e9,
                            1),
        "seconds": round(dt, 3),
    })

    i_best = max(range(len(stream_rows)),
                 key=lambda i: world["stream"][i][1].gcups)
    best_stream = stream_rows[i_best]
    line({
        "metric": (f"Swiss-Prot-scale search on {where(dev)} "
                   f"({len(queries)} queries 100-500aa, {packed.n_seqs} "
                   f"seqs, {packed.total_residues} residues)"),
        "resident_gcups": resident["gcups_real"],
        "resident_Mseqscores_per_s": resident["seq_scores_per_sec_M"],
        "stream_best_gcups": best_stream["gcups_real"],
        "stream_best_cfg": [best_stream["window_tiles"],
                            best_stream["max_in_flight"]],
        "stream_vs_resident_pct": round(
            100 * world["stream"][i_best][1].gcups / best.gcups, 1),
    })
    return lines, world


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m swimm_tpu_torch.benchmarks.bench_swissprot",
        description="Swiss-Prot-scale search, resident and streamed (one "
                    "JSON line a measurement).")
    ap.add_argument("--n-seqs", type=int, default=None,
                    help="default 570000 (1500 with --device cpu)")
    ap.add_argument("--quick", action="store_true",
                    help="skip the streaming sweep (single setting)")
    ap.add_argument("--fresh", action="store_true",
                    help="rebuild the FASTA + packed DB from scratch")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain scorers)")
    args = ap.parse_args(argv)
    run(args.device, args.n_seqs, args.quick, args.fresh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
