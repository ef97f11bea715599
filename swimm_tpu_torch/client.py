"""Client of a running ``python -m swimm_tpu_torch serve --listen`` server
(counterpart of swimm_tpu/client.py, copied).

``python -m swimm_tpu_torch query -q queries.fasta --server HOST:PORT``
sends the FASTA text over the newline-JSON TCP protocol (server.py) and
renders the response in the output styles of a local search (table, json,
m8, optional alignment blocks).

Imports neither torch nor numpy nor any engine code: the client runs on any
machine that can open a socket, while the server owns the card. Rendering
works from the response dicts alone (plus query lengths read from the local
FASTA text).
"""

from __future__ import annotations

import json
import socket
import sys


def request(host: str, port: int, req: dict, timeout: float = 600.0) -> dict:
    """One request -> one response over a fresh connection."""
    with socket.create_connection((host, port), timeout=timeout) as s:
        f = s.makefile("rw", encoding="utf-8")
        f.write(json.dumps(req) + "\n")
        f.flush()
        line = f.readline()
    if not line:
        raise ConnectionError("server closed the connection without replying")
    return json.loads(line)


def _read_text(path: str) -> str:
    """FASTA text, transparently gunzipping (magic-sniffed, like
    fasta.is_gzip)."""
    with open(path, "rb") as fh:
        head = fh.read(2)
    if head == b"\x1f\x8b":
        import gzip
        with gzip.open(path, "rt", newline="\n") as fh:
            return fh.read()
    with open(path, "r", newline="\n") as fh:
        return fh.read()


def _query_lengths(fasta_text: str) -> dict:
    """title -> residue count, parsed purely textually (no codec —
    lengths are cosmetic here; the server does the real parse)."""
    lengths, title, n = {}, None, 0
    for line in fasta_text.splitlines():
        if line.startswith(">"):
            if title is not None:
                lengths[title] = n
            title, n = line[1:].strip(), 0
        elif title is not None:
            n += sum(c.isalpha() or c == "*" for c in line)
    if title is not None:
        lengths[title] = n
    return lengths


def _fmt_evalue(e: float) -> str:
    # mirrors engine._fmt_evalue
    return f"{e:.2g}" if e < 0.1 else f"{e:.2f}"


def _render_alignment(a: dict, width: int = 60) -> str:
    """Client-side alignment block from the response dict (the server
    computed the traceback; identity/midline details that aren't in the
    dict are recomputed from the aligned strings)."""
    qa, da = a["q_aln"], a["d_aln"]
    out = [f"Identities = {a['identity']}/{a['length']} "
           f"({100 * a['identity'] // max(a['length'], 1)}%), "
           f"Gaps = {a['gaps']}/{a['length']}"]
    qp, dp = a["q_range"][0] - 1, a["d_range"][0] - 1
    for off in range(0, len(qa), width):
        qs, ds = qa[off:off + width], da[off:off + width]
        ms = "".join("|" if x == y and x != "-" else " "
                     for x, y in zip(qs, ds))
        q2 = qp + len(qs) - qs.count("-")
        d2 = dp + len(ds) - ds.count("-")
        out.append(f"Query  {qp + 1:>5} {qs} {q2}")
        out.append(f"             {ms}")
        out.append(f"Sbjct  {dp + 1:>5} {ds} {d2}")
        qp, dp = q2, d2
    return "\n".join(out)


def render_table(resp: dict, lengths: dict | None = None) -> str:
    """Human table matching engine.QueryResult.as_table, from dicts."""
    lengths = lengths or {}
    blocks = []
    for r in resp["results"]:
        with_e = any("evalue" in h for h in r["hits"])
        qlen = lengths.get(r["query"])
        head = f"{'rank':>4} {'score':>7}"
        head += f" {'E-value':>9}  title" if with_e else "  title"
        lines = [f"Query: {r['query']}"
                 + (f" ({qlen} aa)" if qlen else ""), head]
        for h in r["hits"]:
            row = f"{h['rank']:>4} {h['score']:>7}"
            if with_e:
                row += f" {_fmt_evalue(h['evalue']):>9}"
            lines.append(f"{row}  {h['title']}")
        for h in r["hits"]:
            if "alignment" in h:
                lines.append(f"\n> {h['title']}")
                lines.append(_render_alignment(h["alignment"]))
        blocks.append("\n".join(lines))
    return "\n\n".join(blocks)


def run_query(args) -> int:
    """The CLI's query entry point (argparse namespace from cli.py)."""
    host, sep, port = args.server.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"--server must be HOST:PORT (got {args.server!r})")
    if getattr(args, "cmd", None):
        try:
            resp = request(host or "127.0.0.1", int(port),
                           {"cmd": args.cmd}, timeout=args.timeout)
        except (OSError, TimeoutError) as e:
            raise ValueError(
                f"cannot reach server {args.server}: {e}") from e
        print(json.dumps(resp, indent=1))
        return 0 if "error" not in resp else 1
    if not args.query:
        raise ValueError("either -q/--query FASTA or --cmd is required")
    text = _read_text(args.query)
    req = {"query_fasta": text}
    if args.top_k is not None:
        req["top_k"] = args.top_k
    if args.align:
        req["align"] = True
    if args.format == "m8":
        req["format"] = "m8"
    try:
        resp = request(host or "127.0.0.1", int(port), req,
                       timeout=args.timeout)
    except (OSError, TimeoutError) as e:
        # gaierror / refused / reset / timeout -> the CLI's one-line
        # user-error path (ValueError -> exit 2)
        raise ValueError(f"cannot reach server {args.server}: {e}") from e
    if "error" in resp:
        kind = resp.get("error_kind")
        raise ValueError(
            f"server error{f' ({kind})' if kind else ''}: {resp['error']}")
    met = resp.get("metrics", {})
    if args.format == "m8":
        for row in resp["m8"]:
            print(row)
    elif args.format == "json":
        print(json.dumps(resp, indent=1))
    else:
        print(render_table(resp, _query_lengths(text)))
    if args.format != "json" and met:
        print(f"time: {met.get('seconds', 0):.3f}s  "
              f"GCUPS: {met.get('gcups', 0):.2f}  "
              f"seqs/s: {met.get('seqs_per_sec', 0):.0f}",
              file=sys.stderr)
    return 0
