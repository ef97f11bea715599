"""Command line of the PyTorch/CUDA port (counterpart of swimm_tpu/cli.py).

    python -m swimm_tpu_torch synth -o db.fasta -n 10000
    python -m swimm_tpu_torch preprocess -i db.fasta -o db_packed
    python -m swimm_tpu_torch info -d db_packed
    python -m swimm_tpu_torch search -d db_packed -q q.fasta \\
        -s BLOSUM62 -g 10 -e 2 -r 16 [--precision ladder] [--query-pack] \\
        [--evalue [--max-evalue E]] [--device cpu] \\
        [--json | --format {table,json,m8}] [--align] [--selfcheck] \\
        [--profile-dir DIR] \\
        [--stream [--window-tiles N] [--max-in-flight N] \\
                  [--stream-scores {auto,buffer,candidates}]] \\
        [--sharded [--topk-per-shard K] [--query-axis N]]
    python -m swimm_tpu_torch serve -d db_packed [--device cpu] \\
        [--warm 144,448] [--listen HOST:PORT [--http]] ...
    python -m swimm_tpu_torch query -q q.fasta --server HOST:PORT

search and serve run on the CUDA device unless --device cpu is given; with
no card they exit 2. search --sharded splits the DB over every visible card
(with --device, over that one device). query is a client only: it imports
no torch.
"""

from __future__ import annotations

import argparse
import json
import sys


def _add_scoring_flags(p):
    p.add_argument("-s", "--matrix", default="BLOSUM62",
                   help="substitution matrix (BLOSUM45/50/62/80/90, "
                        "PAM30/70/250)")
    p.add_argument("-g", "--gap-open", type=int, default=10)
    p.add_argument("-e", "--gap-extend", type=int, default=2)


def _add_device_flag(p):
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch scorers)")


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
    _add_scoring_flags(se)
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
    se.add_argument("--sharded", action="store_true",
                    help="data-parallel search over all visible cards "
                         "(parallel/: the DB split into contiguous block "
                         "ranges, per-shard top-k merged across devices)")
    se.add_argument("--topk-per-shard", type=int, default=None,
                    help="candidates gathered per data shard before the "
                         "merge (--sharded only; default 256)")
    se.add_argument("--query-axis", type=int, default=None,
                    help="mesh 'query' axis size: devices split into a "
                         "(data, query) grid (--sharded only; default 1)")
    _add_device_flag(se)
    se.add_argument("--evalue", action="store_true",
                    help="attach empirical E-values to hits, fitted from "
                         "this search's own score distribution "
                         "(utils/stats.py; the score histogram is taken on "
                         "the device, summed over the shards when sharded)")
    se.add_argument("--max-evalue", type=float, default=None,
                    help="report only hits with E-value <= this bound "
                         "(requires --evalue; ranks renumbered after the "
                         "filter)")
    se.add_argument("--selfcheck", action="store_true",
                    help="rescore every reported hit with the C reference "
                         "scorer (csrc/swref.c) and fail on any mismatch")
    se.add_argument("--align", action="store_true",
                    help="traceback (ops/align.py: on the card, or on the "
                         "host with --device cpu): print a BLAST-style "
                         "alignment for every reported hit")
    se.add_argument("--json", action="store_true", help="JSON output")
    se.add_argument("--format", choices=["table", "json", "m8"],
                    default=None,
                    help="output format: 'table' (default), 'json' (same "
                         "as --json), 'm8' (BLAST tabular, 12 "
                         "tab-separated columns per hit; runs the "
                         "traceback of every hit like --align and implies "
                         "--evalue)")
    se.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of the search "
                         "(Chrome trace JSON; CPU and, on a card, CUDA "
                         "activity) into this directory; it carries the "
                         "program's spans beside the kernels: "
                         "engine.search, phase.h2d, phase.score, "
                         "engine.profile, engine.launch, engine.top_k and "
                         "engine.collect")

    sv = sub.add_parser(
        "serve",
        help="persistent search server: load the DB once, answer "
             "newline-JSON requests on stdin, TCP or HTTP (server.py)")
    sv.add_argument("-d", "--db", required=True, help="packed DB directory")
    _add_scoring_flags(sv)
    sv.add_argument("-r", "--top-k", type=int, default=16,
                    help="default hits per query (requests may override)")
    sv.add_argument("--precision",
                    choices=["adaptive", "ladder", "f32", "int32"],
                    default="adaptive")
    sv.add_argument("--stream", action="store_true",
                    help="serve through the windowed streaming posture "
                         "(databases larger than device memory)")
    sv.add_argument("--evalue", action="store_true",
                    help="attach E-values + bit scores to every hit")
    _add_device_flag(sv)
    sv.add_argument("--warm", default=None,
                    help="comma-separated query lengths to warm at "
                         "start-up (e.g. 144,500,1000): builds the "
                         "kernels, uploads the DB and runs a throwaway "
                         "search of each, so the first request runs at "
                         "steady-state latency")
    sv.add_argument("--listen", default=None, metavar="HOST:PORT",
                    help="serve the same newline-JSON protocol over TCP "
                         "instead of stdin/stdout (PORT 0 picks a free "
                         "port; the bound address is logged to stderr)")
    sv.add_argument("--http", action="store_true",
                    help="with --listen: serve HTTP instead of the line "
                         "protocol (POST /search with the same request "
                         "JSON; GET /health, /info; stop with SIGTERM)")
    sv.add_argument("--max-batch-queries", type=int, default=64,
                    help="TCP mode: cap on queries coalesced into one "
                         "search (queued requests past the cap wait for "
                         "the next one)")
    sv.add_argument("--max-top-k", type=int, default=None,
                    help="ceiling on per-request top_k (default 1024); "
                         "a top_k above the default is searched at the "
                         "next power of two and truncated")
    sv.add_argument("--max-query-len", type=int, default=None,
                    metavar="AA",
                    help="reject queries longer than this (default: "
                         "unlimited)")
    sv.add_argument("--request-timeout", type=float, default=None,
                    metavar="SECONDS",
                    help="TCP/HTTP mode: bound how long a request may "
                         "wait; expired requests get an error_kind "
                         "'timeout' reply (HTTP 504). Default: wait "
                         "forever")
    sv.add_argument("--allow-remote-shutdown", action="store_true",
                    help="TCP line mode: accept {\"cmd\": \"shutdown\"} "
                         "from non-loopback peers (default: loopback "
                         "only)")

    qy = sub.add_parser(
        "query",
        help="send a query FASTA to a running `serve --listen` server and "
             "print the results (a client only: no torch, no card)")
    qy.add_argument("-q", "--query", default=None,
                    help="query FASTA (gzip transparently supported); "
                         "required unless --cmd is given")
    qy.add_argument("--cmd", choices=["ping", "info"], default=None,
                    help="send a server command instead of a search")
    qy.add_argument("--server", required=True, metavar="HOST:PORT")
    qy.add_argument("-r", "--top-k", type=int, default=None,
                    help="per-request top-k (server default otherwise)")
    qy.add_argument("--align", action="store_true",
                    help="request traceback alignment blocks per hit")
    qy.add_argument("--format", choices=["table", "json", "m8"],
                    default="table")
    qy.add_argument("--timeout", type=float, default=600.0,
                    help="socket timeout in seconds")

    info = sub.add_parser("info", help="describe a packed DB")
    info.add_argument("-d", "--db", required=True)

    sy = sub.add_parser("synth", help="generate a synthetic protein FASTA")
    sy.add_argument("-o", "--output", required=True)
    sy.add_argument("-n", "--n-seqs", type=int, default=10000)
    sy.add_argument("--seed", type=int, default=0)
    sy.add_argument("--queries", default=None,
                    help="optional query FASTA to plant homologs of")
    return ap


def main(argv=None) -> int:
    # ValueError is the user-input error (bad matrix, malformed FASTA,
    # conflicting flags), RuntimeError a device that is missing or failed
    # and OSError a file: each is one line and exit 2. SWTPU_DEBUG=1
    # re-raises them with the traceback.
    import os
    debug = os.environ.get("SWTPU_DEBUG", "") not in ("", "0", "false",
                                                      "False", "no")
    try:
        return _run(build_parser().parse_args(argv))
    except BrokenPipeError:
        # a pager or head closed stdout: the POSIX exit for SIGPIPE
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 141
    except FileNotFoundError as e:
        if debug:
            raise
        print(f"swimm_tpu_torch: error: file not found: {e.filename or e}",
              file=sys.stderr)
        return 2
    except (ValueError, OSError, RuntimeError) as e:
        if debug:
            raise
        print(f"swimm_tpu_torch: error: {e}", file=sys.stderr)
        return 2


def _run(args) -> int:
    if args.command == "query":
        # a client only: keep this branch above anything that imports torch
        from swimm_tpu_torch.client import run_query
        return run_query(args)

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

    if args.command == "info":
        return _info(args)
    if args.command == "serve":
        return _serve(args)
    return _search(args)


def _info(args) -> int:
    """Describe a packed DB from its chunk metadata (no torch, no tile
    stream built)."""
    import numpy as np

    from swimm_tpu_torch.db import load_db
    packed = load_db(args.db)
    lens = packed.lengths
    jt, V = 32, packed.manifest["V"]
    n_tiles = sum(ch.n_blocks * ch.L // jt for ch in packed.chunks)
    n_rows = sum(ch.n_blocks for ch in packed.chunks)
    nbytes = n_tiles * jt * V
    pad_pct = 100 * (nbytes / max(int(packed.total_residues), 1) - 1)
    print(f"packed DB       {args.db}")
    print(f"sequences       {packed.n_seqs:,}")
    print(f"residues        {packed.total_residues:,}")
    print(f"lengths         min {int(lens.min())} / median "
          f"{int(np.median(lens))} / max {int(lens.max())}")
    print(f"chunks          {len(packed.chunks)}  "
          f"blocks {n_rows}  lanes/block {V}")
    print(f"tile stream     {n_tiles:,} x {jt} x {V} int8 = "
          f"{nbytes / 1e6:.1f} MB device ({pad_pct:.1f}% padding)")
    print(f"format version  {packed.manifest['format_version']}")
    return 0


def _serve(args) -> int:
    from swimm_tpu_torch.db import load_db
    from swimm_tpu_torch.models.engine import SearchConfig
    from swimm_tpu_torch.server import serve_socket, serve_stdio
    warm = ()
    if args.warm:
        try:
            warm = tuple(int(x) for x in args.warm.split(",") if x)
        except ValueError:
            raise ValueError(
                f"--warm must be comma-separated integer lengths "
                f"(got {args.warm!r})") from None
        if any(w <= 0 for w in warm):
            raise ValueError("--warm lengths must be positive")
    if args.max_query_len is not None and args.max_query_len <= 0:
        raise ValueError("--max-query-len must be positive")
    config = SearchConfig(matrix=args.matrix, gap_open=args.gap_open,
                          gap_extend=args.gap_extend, top_k=args.top_k,
                          precision=args.precision, db_stream=args.stream,
                          evalue=args.evalue)
    if args.listen is not None:
        host, sep, port = args.listen.rpartition(":")
        if not sep or not port.isdigit():
            raise ValueError(
                f"--listen must be HOST:PORT (got {args.listen!r})")
        if args.max_batch_queries <= 0:
            raise ValueError("--max-batch-queries must be positive")
        if args.request_timeout is not None and args.request_timeout <= 0:
            raise ValueError("--request-timeout must be positive")
        return serve_socket(load_db(args.db), config, host or "127.0.0.1",
                            int(port), warm_lengths=warm,
                            max_batch_queries=args.max_batch_queries,
                            http=args.http, max_top_k=args.max_top_k,
                            allow_remote_shutdown=args.allow_remote_shutdown,
                            request_timeout=args.request_timeout,
                            max_query_len=args.max_query_len,
                            device=args.device)
    if args.http:
        raise ValueError("--http requires --listen HOST:PORT")
    if args.allow_remote_shutdown:
        raise ValueError("--allow-remote-shutdown requires --listen "
                         "(stdio has no remote peers)")
    if args.request_timeout is not None:
        raise ValueError("--request-timeout requires --listen "
                         "(stdio serves one request at a time)")
    return serve_stdio(load_db(args.db), config, warm_lengths=warm,
                       max_top_k=args.max_top_k,
                       max_query_len=args.max_query_len, device=args.device)


def _search(args) -> int:
    import contextlib
    from dataclasses import replace

    from swimm_tpu_torch.db import load_db
    from swimm_tpu_torch.fasta import read_fasta
    from swimm_tpu_torch.models.engine import (SearchConfig, resolve_device,
                                               search)

    # swimm_tpu's posture-combination errors, word for word and in its
    # order: a flag that would be ignored is refused, naming the conflict
    if args.sharded and args.query_pack:
        raise ValueError(
            "--sharded does not support --query-pack: the sharded path "
            "groups queries by padded length itself — drop --query-pack or "
            "run without --sharded")
    if args.stream and args.query_pack:
        raise ValueError(
            "--stream does not support --query-pack: the streaming path "
            "batches queries per padded length against each window — drop "
            "one of the two flags")
    if args.sharded and args.stream_scores is not None:
        raise ValueError(
            "--stream-scores does not apply to the sharded posture: sharded "
            "streaming always merges per-span candidates via the collective "
            "top-k — drop --stream-scores")
    if not args.stream:
        for flag, on in (("--window-tiles", args.window_tiles is not None),
                         ("--max-in-flight", args.max_in_flight is not None),
                         ("--stream-scores", args.stream_scores is not None)):
            if on:
                raise ValueError(
                    f"{flag} only applies to the streaming posture and "
                    f"would be ignored here — add --stream or drop {flag}")
    if not args.sharded:
        for flag, on in (("--topk-per-shard", args.topk_per_shard is not None),
                         ("--query-axis", args.query_axis is not None)):
            if on:
                raise ValueError(
                    f"{flag} only applies to the sharded posture and would "
                    f"be ignored here — add --sharded or drop {flag}")
    if args.sharded and args.stream and args.topk_per_shard is not None:
        raise ValueError(
            "--sharded --stream does not support --topk-per-shard: the "
            "streamed super-window path takes top_k candidates per span — "
            "drop --topk-per-shard")
    if args.evalue and args.query_pack:
        raise ValueError(
            "--evalue runs per-query statistics; it does not combine with "
            "--query-pack — drop one of the two flags")
    fmt = args.format
    if fmt is None:
        fmt = "json" if args.json else "table"
    elif args.json and fmt != "json":
        raise ValueError(f"--json conflicts with --format {fmt} — pick one")
    if fmt == "m8":
        if args.align:
            raise ValueError(
                "--format m8 is a fixed 12-column tabular format; "
                "--align's alignment blocks do not apply — drop --align "
                "(m8 already includes alignment geometry)")
        if args.query_pack:
            raise ValueError(
                "--format m8 computes E-values (implied --evalue), which "
                "do not combine with --query-pack — drop --query-pack")
        args.evalue = True   # the evalue/bitscore columns
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
    packed = load_db(args.db)
    queries = read_fasta(args.query)
    prof = contextlib.nullcontext()
    if args.profile_dir:
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        acts = [ProfilerActivity.CPU]
        if resolve_device(args.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts, on_trace_ready=(
            tensorboard_trace_handler(args.profile_dir)))
    with prof:
        if args.sharded:
            from swimm_tpu_torch.parallel.mesh import make_mesh
            mesh = make_mesh(
                query_axis=(args.query_axis if args.query_axis is not None
                            else 1),
                devices=None if args.device in (None, "cuda")
                else [args.device])
        if args.sharded and args.stream:
            from swimm_tpu_torch.parallel.sharded_stream import \
                search_streaming_sharded
            results, metrics = search_streaming_sharded(packed, queries,
                                                        config, mesh=mesh)
        elif args.sharded:
            from swimm_tpu_torch.parallel.sharded_search import sharded_search
            kw = ({"topk_per_shard": args.topk_per_shard}
                  if args.topk_per_shard is not None else {})
            results, metrics = sharded_search(packed, queries, config,
                                              mesh=mesh, **kw)
        else:
            results, metrics = search(packed, queries, config,
                                      device=args.device)
    if args.max_evalue is not None:
        # a cutoff on the reported list only (scores and the fitted model
        # are untouched); ranks renumbered so the table stays 1..n
        for r in results:
            r.hits = [replace(h, rank=i + 1) for i, h in enumerate(
                h2 for h2 in r.hits if h2.evalue <= args.max_evalue)]
    if args.selfcheck:
        from swimm_tpu_torch.matrices import get_matrix
        from swimm_tpu_torch.ops import cref
        sub = get_matrix(args.matrix)
        n_checked = 0
        for q, r in zip(queries, results):
            seqs = [packed.seq_codes(h.sorted_idx) for h in r.hits]
            exp = cref.sw_score_many(q.codes, seqs, sub, args.gap_open,
                                     args.gap_extend)
            got = [h.score for h in r.hits]
            if list(exp) != got:
                raise AssertionError(
                    f"selfcheck FAILED for {r.query_title!r}: device {got} "
                    f"vs C oracle {list(exp)}")
            n_checked += len(got)
        print(f"selfcheck: PASS ({n_checked} hit scores verified against "
              "the C reference scorer)", file=sys.stderr)
    aligns = None
    if args.align or fmt == "m8":
        from swimm_tpu_torch.ops.align import align_hits
        aligns = align_hits(results, queries, packed, config,
                            device=resolve_device(args.device))
    if fmt == "m8":
        # pure TSV on stdout; the run summary to stderr
        from swimm_tpu_torch.formats import m8_rows
        for qi, r in enumerate(results):
            for line in m8_rows(r, aligns[qi]):
                print(line)
        print(f"time: {metrics.seconds:.3f}s  GCUPS: {metrics.gcups:.2f}  "
              f"seqs/s: {metrics.seqs_per_sec:.0f}", file=sys.stderr)
    elif fmt == "json":
        out = {
            "results": [{"query": r.query_title,
                         "hits": [{"rank": h.rank, "score": h.score,
                                   "title": h.title,
                                   **({"evalue": h.evalue}
                                      if h.evalue is not None else {})}
                                  for h in r.hits]}
                        for r in results],
            "metrics": json.loads(metrics.to_json()),
        }
        if aligns is not None:
            for robj, arow in zip(out["results"], aligns):
                for hobj, a in zip(robj["hits"], arow):
                    hobj["alignment"] = {
                        "q_range": [a.q_start + 1, a.q_end],
                        "d_range": [a.d_start + 1, a.d_end],
                        "identity": a.n_identity, "length": a.length,
                        "gaps": a.n_gaps, "q_aln": a.q_aln, "d_aln": a.d_aln,
                    }
        print(json.dumps(out, indent=1))
    else:
        for qi, r in enumerate(results):
            print(r.as_table())
            if aligns is not None:
                for h, a in zip(r.hits, aligns[qi]):
                    print(f"\n> {h.title}")
                    print(a.pretty())
            print()
        print(f"time: {metrics.seconds:.3f}s  GCUPS: {metrics.gcups:.2f} "
              f"(padded {metrics.padded_gcups:.2f})  "
              f"seqs/s: {metrics.seqs_per_sec:.0f}")
    return 0
