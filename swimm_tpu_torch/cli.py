"""Command line of the PyTorch/CUDA port (counterpart of swimm_tpu/cli.py's
synth, preprocess and search subcommands).

    python -m swimm_tpu_torch synth -o db.fasta -n 10000
    python -m swimm_tpu_torch preprocess -i db.fasta -o db_packed
    python -m swimm_tpu_torch search -d db_packed -q q.fasta \\
        -s BLOSUM62 -g 10 -e 2 -r 16 [--precision ladder] [--query-pack] \\
        [--evalue [--max-evalue E]] [--device cpu] [--json] \\
        [--stream [--window-tiles N] [--max-in-flight N] \\
                  [--stream-scores {auto,buffer,candidates}]]

search runs on the CUDA device unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m swimm_tpu_torch",
        description="Exact Smith-Waterman protein database search "
                    "(PyTorch/CUDA)")
    sub = ap.add_subparsers(dest="command", required=True)

    pp = sub.add_parser("preprocess", help="pack a FASTA database")
    pp.add_argument("-i", "--input", required=True, help="input FASTA")
    pp.add_argument("-o", "--output", required=True,
                    help="output DB directory")
    pp.add_argument("--lanes", type=int, default=128,
                    help="db sequences per vector block (V)")
    pp.add_argument("--resume", action="store_true",
                    help="reuse a completed pack of this input at --output")

    se = sub.add_parser("search", help="search queries against a packed DB")
    se.add_argument("-d", "--db", required=True, help="packed DB directory")
    se.add_argument("-q", "--query", required=True, help="query FASTA")
    se.add_argument("-s", "--matrix", default="BLOSUM62",
                    help="substitution matrix (BLOSUM45/50/62/80/90, "
                         "PAM30/70/250)")
    se.add_argument("-g", "--gap-open", type=int, default=10)
    se.add_argument("-e", "--gap-extend", type=int, default=2)
    se.add_argument("-r", "--top-k", type=int, default=16)
    se.add_argument("--precision",
                    choices=["adaptive", "ladder", "f32", "int32"],
                    default="adaptive",
                    help="adaptive = fastest exact path for the hardware; "
                         "ladder = reference-style narrow-first + overflow "
                         "recheck (the same scores)")
    se.add_argument("--query-pack", dest="query_pack", action="store_true",
                    default=False,
                    help="pack the query batch along the profile axis: one "
                         "kernel launch per fixed-size pack of up to 24 "
                         "queries instead of one per query")
    se.add_argument("--no-query-pack", dest="query_pack",
                    action="store_false",
                    help="one kernel launch per query (default)")
    se.add_argument("--stream", action="store_true",
                    help="stream the DB through the device in windows "
                         "(for databases larger than device memory)")
    se.add_argument("--window-tiles", type=int, default=None,
                    help="most (32,V) tiles in a streaming window "
                         "(--stream only; default: SearchConfig's)")
    se.add_argument("--max-in-flight", type=int, default=None,
                    help="streaming windows alive on the device (--stream "
                         "only; default: SearchConfig's 2)")
    se.add_argument("--stream-scores",
                    choices=["auto", "buffer", "candidates"], default=None,
                    help="streaming merge (--stream only): 'buffer' keeps "
                         "every score on the device (4 bytes a sequence "
                         "and query), 'candidates' merges per-window top-k "
                         "on the host; 'auto' (default) picks by buffer "
                         "size")
    se.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch scorers)")
    se.add_argument("--evalue", action="store_true",
                    help="attach empirical E-values to hits, fitted from "
                         "this search's own score distribution "
                         "(utils/stats.py; the score histogram is taken on "
                         "the device)")
    se.add_argument("--max-evalue", type=float, default=None,
                    help="report only hits with E-value <= this bound "
                         "(requires --evalue; ranks renumbered after the "
                         "filter)")
    se.add_argument("--json", action="store_true", help="JSON output")

    sy = sub.add_parser("synth", help="generate a synthetic protein FASTA")
    sy.add_argument("-o", "--output", required=True)
    sy.add_argument("-n", "--n-seqs", type=int, default=10000)
    sy.add_argument("--seed", type=int, default=0)
    sy.add_argument("--queries", default=None,
                    help="optional query FASTA to plant homologs of")
    return ap


def main(argv=None) -> int:
    try:
        return _run(build_parser().parse_args(argv))
    except FileNotFoundError as e:
        print(f"swimm_tpu_torch: error: file not found: {e.filename or e}",
              file=sys.stderr)
        return 2
    except (ValueError, OSError, RuntimeError) as e:
        print(f"swimm_tpu_torch: error: {e}", file=sys.stderr)
        return 2


def _run(args) -> int:
    if args.command == "preprocess":
        from swimm_tpu_torch.db import build_db
        packed = build_db(args.input, args.output, V=args.lanes,
                          resume=args.resume)
        print(f"packed {packed.n_seqs} sequences "
              f"({packed.total_residues} residues) into "
              f"{len(packed.chunks)} chunks at {args.output}")
        return 0

    if args.command == "synth":
        from swimm_tpu_torch.fasta import read_fasta, write_fasta
        from swimm_tpu_torch.utils.synth import synth_db
        queries = None
        if args.queries:
            queries = [r.codes for r in read_fasta(args.queries)]
        recs = synth_db(args.n_seqs, seed=args.seed, queries=queries)
        write_fasta(args.output, recs)
        print(f"wrote {len(recs)} synthetic sequences to {args.output}")
        return 0

    from dataclasses import replace

    from swimm_tpu_torch.db import load_db
    from swimm_tpu_torch.fasta import read_fasta
    from swimm_tpu_torch.models.engine import SearchConfig, search

    if args.stream and args.query_pack:
        raise ValueError(
            "--stream does not support --query-pack: the streaming path "
            "batches queries per padded length against each window — drop "
            "one of the two flags")
    if not args.stream:
        for flag, on in (("--window-tiles", args.window_tiles is not None),
                         ("--max-in-flight", args.max_in_flight is not None),
                         ("--stream-scores", args.stream_scores is not None)):
            if on:
                raise ValueError(
                    f"{flag} only applies to the streaming posture and "
                    f"would be ignored here — add --stream or drop {flag}")
    if args.evalue and args.query_pack:
        raise ValueError(
            "--evalue runs per-query statistics; it does not combine with "
            "--query-pack — drop one of the two flags")
    if args.max_evalue is not None:
        if not args.evalue:
            raise ValueError(
                "--max-evalue filters on E-values, which are only computed "
                "under --evalue — add --evalue or drop --max-evalue")
        if args.max_evalue <= 0:
            raise ValueError("--max-evalue must be positive")
    stream_kw = {k: v for k, v in (("window_tiles", args.window_tiles),
                                   ("max_in_flight", args.max_in_flight),
                                   ("stream_scores", args.stream_scores))
                 if v is not None}        # None -> SearchConfig's defaults
    config = SearchConfig(matrix=args.matrix, gap_open=args.gap_open,
                          gap_extend=args.gap_extend, top_k=args.top_k,
                          precision=args.precision,
                          query_pack=args.query_pack, evalue=args.evalue,
                          db_stream=args.stream, **stream_kw)
    results, metrics = search(load_db(args.db), read_fasta(args.query),
                              config, device=args.device)
    if args.max_evalue is not None:
        # a cutoff on the reported list only (scores and the fitted model
        # are untouched); ranks renumbered so the table stays 1..n
        for r in results:
            r.hits = [replace(h, rank=i + 1) for i, h in enumerate(
                h2 for h2 in r.hits if h2.evalue <= args.max_evalue)]
    if args.json:
        print(json.dumps({
            "results": [{"query": r.query_title,
                         "hits": [{"rank": h.rank, "score": h.score,
                                   "title": h.title,
                                   **({"evalue": h.evalue}
                                      if h.evalue is not None else {})}
                                  for h in r.hits]}
                        for r in results],
            "metrics": json.loads(metrics.to_json()),
        }, indent=1))
    else:
        for r in results:
            print(r.as_table())
            print()
        print(f"time: {metrics.seconds:.3f}s  GCUPS: {metrics.gcups:.2f} "
              f"(padded {metrics.padded_gcups:.2f})  "
              f"seqs/s: {metrics.seqs_per_sec:.0f}")
    return 0
