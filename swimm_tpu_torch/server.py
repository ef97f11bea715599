"""Persistent search server (counterpart of swimm_tpu/server.py).

A one-shot search pays the DB load, its upload and the kernels' build
before its first score. ``python -m swimm_tpu_torch serve`` keeps a
process alive that

- loads the packed DB once, and uploads its tile stream to the card once
  (at the first search, or at start-up with ``--warm``),
- with ``--warm``, builds and loads the kernels, uploads the resident DB
  and runs throwaway searches of the given query lengths, so the first
  request runs at steady-state latency,
- then answers newline-delimited JSON requests with one JSON response
  line each: on stdin/stdout by default, over TCP with ``--listen
  HOST:PORT`` (the same protocol per connection, any number of clients;
  ``python -m swimm_tpu_torch query`` is the bundled torch-free client),
  or over HTTP with ``--listen ... --http`` (POST /search with the same
  request schema; GET /health, /info). stderr carries logs in every mode.

Request lines:
  {"id": 1, "queries": [{"title": "q1", "seq": "MKV..."}, ...],
   "top_k": 16, "align": true,
   "format": "m8"}               -- search; top_k optional (server
                                    default); align adds a traceback
                                    alignment block per hit; format
                                    "m8" adds BLAST-tabular rows
                                    (response key "m8", one row per hit)
  {"id": 2, "query_fasta": ">q1\\nMKV...\\n"}   -- FASTA text alternative
  {"cmd": "ping"}                               -- liveness probe
  {"cmd": "info"}                               -- DB + config description
  {"cmd": "shutdown"}                           -- clean exit (also EOF)

Response lines (matching "id" when given):
  {"id": 1, "results": [{"query": ..., "hits": [{"rank", "score",
   "title", "evalue"?, "bits"?}, ...]}, ...], "metrics": {...}}
  {"id": 1, "error": "...", "error_kind": "bad_request"|"internal"|
   "unavailable"|"forbidden"|"timeout"}  -- request-level failure; the
   server stays up. The HTTP front end maps error_kind to 400, 500, 503,
   403 and 504.

The scoring posture (matrix, gaps, precision, streaming, statistics) is
fixed at start-up; per request only top_k, align and format change, none
of which reaches a kernel. top_k above a ceiling (max_top_k, CLI
--max-top-k) is refused, and a top_k other than the default is searched
at the next power of two (the default itself when it is smaller) and
truncated: the ranked list under the (score desc, sorted index asc) order
is prefix-stable in k, so truncation equals a direct k-run, and a client
sweeping k meets at most log2(max_top_k) distinct searches.

Threads: searches run on the thread that calls SearchServer.handle (stdio)
or on the Batcher's one dispatcher thread (TCP, HTTP); handler threads
only parse, queue and reply, and make no torch call. Every launch goes to
the calling thread's current CUDA stream, which is the device's default
stream on every thread here, and the resident tile stream is cached per
(PackedDb, device) for the process (engine.device_tiles), so the
dispatcher and the thread that warmed share one stream and one upload.
After a CUDA fault every later CUDA call in the process fails: each
request answers error_kind "internal" and the server keeps answering; no
request is retried on the CPU or through a plain version.

A run under a torch profiler (the CLI's ``search --profile-dir``, or any
``torch.profiler.profile`` around a server in the process) records the
program's spans (utils/metrics.py): ``batcher.queue``, ``batcher.dispatch``
and ``server.postprocess`` here, the Batcher's ``seq`` on a request's
queue and postprocess spans across threads, and ``engine.search``,
``engine.profile``, ``engine.launch``, ``engine.top_k`` and
``engine.collect`` in models/engine.py.
"""

from __future__ import annotations

import functools
import ipaddress
import itertools
import json
import socketserver
import sys
import threading
import time
import traceback
from dataclasses import replace

from swimm_tpu_torch.utils.metrics import record, span

LOG_PREFIX = "swimm_tpu_torch serve:"

#: what _parse may raise for a malformed request: ValueError for every
#: field it checks, the rest as a net, so that no request shape can end a
#: connection or the stdio loop
_BAD_REQUEST = (ValueError, TypeError, KeyError, AttributeError)


def _encode_queries(req):
    """Build FastaRecord queries from a request dict (either form).

    Every type is checked, so a typed-but-malformed request ({"queries":
    "MKV"}, {"queries": [{"seq": 5}]}, {"query_fasta": 5}) raises
    ValueError and gets an {"error": ...} reply."""
    from swimm_tpu_torch.alphabet import encode
    from swimm_tpu_torch.fasta import FastaRecord, parse_fasta_str
    if "query_fasta" in req:
        fa = req["query_fasta"]
        if not isinstance(fa, str):
            raise ValueError(
                f"query_fasta must be a string (got {type(fa).__name__})")
        recs = parse_fasta_str(fa)
        if not recs:
            raise ValueError("query_fasta contained no sequences")
        return recs
    queries = req.get("queries")
    if queries is not None and not isinstance(queries, (list, tuple)):
        raise ValueError("'queries' must be a list of {title, seq} "
                         f"objects (got {type(queries).__name__})")
    if not queries:
        raise ValueError(
            "request needs 'queries' (list of {title, seq}) or "
            "'query_fasta' (FASTA text)")
    recs = []
    for i, q in enumerate(queries):
        if not isinstance(q, dict):
            raise ValueError(f"queries[{i}] must be an object with a "
                             f"'seq' field (got {type(q).__name__})")
        seq = q.get("seq", "")
        if not isinstance(seq, str):
            raise ValueError(f"queries[{i}].seq must be a string "
                             f"(got {type(seq).__name__})")
        if not seq:
            raise ValueError(f"queries[{i}] has an empty 'seq'")
        recs.append(FastaRecord(str(q.get("title", f"query{i}")),
                                encode(seq)))
    return recs


def _bucket_k(k: int, default_k: int, max_k: int) -> int:
    """The k a request of top_k = k is searched at: the server default for
    any k up to it (the default is >= k, so truncation is exact), else the
    next power of two capped at max_k (k <= max_k is checked by the
    caller). swimm_tpu buckets a k below the default to its own power of
    two; the truncated responses are the same."""
    if k <= default_k:
        return default_k
    b = 1
    while b < k:
        b <<= 1
    return min(b, max_k)


def _alignments(result, packed, query, scoring):
    """Host traceback per reported hit (as the CLI's --align); the
    recovered path's score must equal the device hit score."""
    from swimm_tpu_torch.ops.traceback import sw_align
    aligns = []
    for h in result.hits:
        a = sw_align(query.codes, packed.seq_codes(h.sorted_idx),
                     matrix=scoring["matrix"],
                     gap_open=scoring["gap_open"],
                     gap_extend=scoring["gap_extend"])
        if a.score != h.score:
            raise AssertionError(
                f"traceback score {a.score} != device hit score "
                f"{h.score} for {h.title!r}")
        aligns.append(a)
    return aligns


def _hits_json(result, aligns=None):
    out = []
    for i, h in enumerate(result.hits):
        d = {"rank": h.rank, "score": h.score, "title": h.title}
        if h.evalue is not None:
            d["evalue"] = h.evalue
            d["bits"] = h.bits
        if aligns is not None:
            a = aligns[i]
            d["alignment"] = {
                "q_range": [a.q_start + 1, a.q_end],
                "d_range": [a.d_start + 1, a.d_end],
                "identity": a.n_identity, "length": a.length,
                "gaps": a.n_gaps, "q_aln": a.q_aln, "d_aln": a.d_aln,
            }
        out.append(d)
    return {"query": result.query_title, "hits": out}


class SearchServer:
    """One resident database + config on one device; .handle(dict) ->
    dict per request. device=None means 'cuda'; with no card the
    constructor raises (no server on the CPU unless device='cpu')."""

    #: default ceiling on per-request top_k (CLI --max-top-k overrides)
    DEFAULT_MAX_TOP_K = 1024

    def __init__(self, packed, config, warm_lengths=(), max_top_k=None,
                 max_query_len=None, device=None):
        from swimm_tpu_torch.models import engine
        self._packed = packed
        self._config = config
        self._device = engine.resolve_device(device)
        # a callable of (packed, queries, config), replaceable by tests
        self._search = functools.partial(engine.search, device=self._device)
        self.max_top_k = int(max_top_k) if max_top_k is not None \
            else self.DEFAULT_MAX_TOP_K
        if self.max_top_k < config.top_k:
            raise ValueError(
                f"max_top_k {self.max_top_k} is below the server default "
                f"top_k {config.top_k}")
        # optional ceiling on query length (None = unlimited): a client's
        # 100k-aa "query" would hold the dispatcher for its whole walk
        self.max_query_len = (int(max_query_len)
                              if max_query_len is not None else None)
        if self.max_query_len is not None and self.max_query_len <= 0:
            raise ValueError(f"max_query_len must be positive (got "
                             f"{self.max_query_len})")
        self.n_requests = 0
        self.n_queries = 0
        self.total_cells = 0         # true DP cells served (excl. warm)
        self.search_seconds = 0.0    # search wall time (excl. warm)
        self._t0 = time.perf_counter()
        if warm_lengths:
            self._warm(warm_lengths)

    @property
    def device(self):
        return self._device

    def _warm(self, lengths) -> float:
        """Build and load the kernels (on a card), upload the resident DB
        (unless the config streams or the DB does not fit the card, where
        search streams it with its warning), then run throwaway searches
        of these query lengths: one single-query search per distinct
        length (the common request shape), then one of all of them
        together (the batched shape)."""
        from swimm_tpu_torch.models import engine
        from swimm_tpu_torch.ops import scorer
        from swimm_tpu_torch.utils.synth import synth_queries
        t0 = time.perf_counter()
        if self._device.type == "cuda":
            scorer.build_kernels()
        if not self._config.db_stream and engine.resident_fits(
                self._packed, self._device):
            engine.device_tiles(self._packed, self._device)
        uniq = sorted(set(int(n) for n in lengths))
        for n in uniq:
            self._search(self._packed, synth_queries(1, [n], seed=7),
                         self._config)
        if len(uniq) > 1:
            self._search(self._packed, synth_queries(len(uniq), uniq, seed=7),
                         self._config)
        return time.perf_counter() - t0

    @staticmethod
    def _rss_mb():
        """This process's resident set size in MB (Linux; None elsewhere).
        Under streaming it includes the pinned host slots."""
        try:
            with open("/proc/self/status") as fh:
                for line in fh:
                    if line.startswith("VmRSS:"):
                        return round(int(line.split()[1]) / 1024.0, 1)
        except OSError:
            pass
        return None

    def info(self) -> dict:
        p = self._packed
        c = self._config
        return {
            "n_seqs": int(p.n_seqs),
            "total_residues": int(p.total_residues),
            "matrix": c.matrix, "gap_open": c.gap_open,
            "gap_extend": c.gap_extend, "precision": c.precision,
            "db_stream": c.db_stream, "evalue": c.evalue,
            "default_top_k": c.top_k,
            "device": str(self._device),
            "n_requests": self.n_requests,
            "n_queries": self.n_queries,
            "total_cells": self.total_cells,
            "search_seconds": round(self.search_seconds, 3),
            "uptime_s": round(time.perf_counter() - self._t0, 1),
            "rss_mb": self._rss_mb(),
        }

    def _account(self, n_requests, n_queries, metrics):
        self.n_requests += n_requests
        self.n_queries += n_queries
        self.total_cells += metrics.cells
        self.search_seconds += metrics.seconds

    def _parse(self, req: dict):
        """Validate a search request -> (queries, opts). Raises ValueError
        on any malformed field, types included.

        opts["top_k"] is the k the client gets (the truncation bound);
        opts["search_k"] the k the search runs at (_bucket_k)."""
        queries = _encode_queries(req)
        if self.max_query_len is not None:
            for q in queries:
                if q.length > self.max_query_len:
                    raise ValueError(
                        f"query {q.title!r} is {q.length} aa, over the "
                        f"server maximum {self.max_query_len}")
        top_k = self._config.top_k
        if "top_k" in req:
            raw = req["top_k"]
            if isinstance(raw, bool) or not isinstance(raw, int):
                raise ValueError(
                    f"top_k must be an integer (got {type(raw).__name__})")
            top_k = raw
            if top_k <= 0:
                raise ValueError("top_k must be positive")
            if top_k > self.max_top_k:
                raise ValueError(f"top_k {top_k} exceeds the server "
                                 f"maximum {self.max_top_k}")
        fmt = req.get("format", "json")
        if fmt not in ("json", "m8"):
            raise ValueError(f"format must be 'json' or 'm8' (got {fmt!r})")
        return queries, {"top_k": top_k,
                         "search_k": _bucket_k(top_k, self._config.top_k,
                                               self.max_top_k),
                         "align": bool(req.get("align", False)),
                         "format": fmt}

    def _postprocess(self, queries, results, metrics, opts, rid) -> dict:
        """The response dict for one request's slice of a search, whose
        results may come from a LARGER top_k (a coalesced batch runs at
        its largest search_k): truncated to the request's top_k."""
        results = [replace(r, hits=r.hits[:opts["top_k"]]) for r in results]
        scoring = {"matrix": self._config.matrix,
                   "gap_open": self._config.gap_open,
                   "gap_extend": self._config.gap_extend}
        need_align = opts["align"] or opts["format"] == "m8"
        aligns = [_alignments(r, self._packed, q, scoring)
                  if need_align else None
                  for q, r in zip(queries, results)]
        resp = {**rid,
                "results": [
                    _hits_json(r, aligns=a if opts["align"] else None)
                    for r, a in zip(results, aligns)],
                "metrics": json.loads(metrics.to_json())}
        if opts["format"] == "m8":
            from swimm_tpu_torch.formats import m8_rows
            resp["m8"] = [row for r, a in zip(results, aligns)
                          for row in m8_rows(r, a)]
        return resp

    def handle(self, req: dict) -> dict:
        cmd = req.get("cmd")
        rid = {"id": req["id"]} if "id" in req else {}
        if cmd == "ping":
            return {"ok": True, **rid}
        if cmd == "info":
            return {"info": self.info(), **rid}
        if cmd == "shutdown":
            # the transports that support it (stdio, TCP line protocol)
            # intercept it; reaching here means this one has none
            return {**rid, "error": "shutdown is not supported on this "
                                    "transport; send SIGTERM to the "
                                    "server process",
                    "error_kind": "bad_request"}
        if cmd is not None:
            return {**rid, "error": f"unknown cmd {cmd!r} (ping, info)",
                    "error_kind": "bad_request"}
        try:
            queries, opts = self._parse(req)
        except _BAD_REQUEST as e:
            return {**rid, "error": str(e) or repr(e),
                    "error_kind": "bad_request"}
        try:
            config = self._config
            if opts["search_k"] != config.top_k:
                config = replace(config, top_k=opts["search_k"])
            results, metrics = self._search(self._packed, queries, config)
            self._account(1, len(queries), metrics)
            return self._postprocess(queries, results, metrics, opts, rid)
        except Exception as e:  # noqa: BLE001 — one faulting search
            # answers its request; the server stays up for the next
            return {**rid, "error": f"search failed: {e!r}",
                    "error_kind": "internal"}


class Batcher:
    """Adaptive micro-batching front end over one SearchServer.

    Requests that arrive while a search runs coalesce into ONE multi-query
    search when it ends; no delay is added (an idle server dispatches at
    once). Mixed top_k coalesces by searching at the batch's largest
    search_k and truncating per request; align and format stay per
    request. Every search runs on this object's one dispatcher thread.

    request_timeout (seconds, None = wait forever) bounds how long a
    client blocks: a request still queued at expiry is withdrawn; one
    already dispatched cannot be cancelled on the card, so the client gets
    the timeout error and the result is dropped when it lands. Either way
    the reply carries error_kind "timeout" (HTTP 504).
    """

    def __init__(self, srv: SearchServer, max_batch_queries: int = 64,
                 autostart: bool = True, stderr=None,
                 request_timeout: float = None):
        self._srv = srv
        self._max = int(max_batch_queries)
        self._timeout = float(request_timeout) if request_timeout else None
        self._cv = threading.Condition()
        # [(queries, opts, rid, box, event, seq, perf_counter at enqueue)]
        self._pending = []
        self._seq = itertools.count()   # the spans' request id (seq)
        self._stopping = False
        self._stderr = stderr if stderr is not None else sys.stderr
        self.n_dispatches = 0       # searches actually issued
        self._thread = None
        if autostart:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def submit(self, req: dict) -> dict:
        """Protocol entry: blocks until this request's response is ready."""
        if "cmd" in req:
            return self._srv.handle(req)     # ping/info: no search, no queue
        rid = {"id": req["id"]} if "id" in req else {}
        try:
            queries, opts = self._srv._parse(req)
        except _BAD_REQUEST as e:
            return {**rid, "error": str(e) or repr(e),
                    "error_kind": "bad_request"}
        box, ev = {}, threading.Event()
        with self._cv:
            if self._stopping:
                return {**rid, "error": "server is shutting down",
                        "error_kind": "unavailable"}
            item = (queries, opts, rid, box, ev, next(self._seq),
                    time.perf_counter())
            self._pending.append(item)
            self._cv.notify()
        if ev.wait(self._timeout):
            return box["resp"]
        with self._cv:
            # identity, not ==: a tuple compare would compare the
            # FastaRecords' numpy code arrays
            queued = any(p is item for p in self._pending)
            if queued:
                self._pending = [p for p in self._pending if p is not item]
        if not queued and ev.wait(0.05):     # lost the race: it finished
            return box["resp"]
        state = "cancelled while queued" if queued else \
            "still completing on device; its result will be discarded"
        return {**rid, "error": f"request timed out after "
                                f"{self._timeout:g}s ({state})",
                "error_kind": "timeout"}

    def stop(self):
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=60)

    def _loop(self):
        while True:
            with self._cv:
                while not self._pending and not self._stopping:
                    self._cv.wait()
                if not self._pending and self._stopping:
                    return
            self._drain_once()

    def _drain_once(self):
        """Dispatch ONE coalesced search over the queued requests (up to
        max_batch_queries queries; the rest stay queued)."""
        with span("batcher.dispatch"):
            self._dispatch()

    def _dispatch(self):
        with self._cv:
            batch, n = [], 0
            while self._pending and n + len(self._pending[0][0]) <= self._max:
                item = self._pending.pop(0)
                batch.append(item)
                n += len(item[0])
            if not batch and self._pending:
                # a single oversized request: served alone, not starved
                batch = [self._pending.pop(0)]
        t_pop = time.perf_counter()
        for item in batch:
            record("batcher.queue", item[6], t_pop, seq=item[5])
        if not batch:
            return
        all_q = [q for item in batch for q in item[0]]
        k_max = max(item[1]["search_k"] for item in batch)
        config = self._srv._config
        if k_max != config.top_k:
            config = replace(config, top_k=k_max)
        try:
            results, metrics = self._srv._search(self._srv._packed,
                                                 all_q, config)
            self._srv._account(len(batch), len(all_q), metrics)
            self.n_dispatches += 1
            met = json.loads(metrics.to_json())
            met["batched_requests"] = len(batch)
            met["batched_queries"] = len(all_q)
            off = 0
            for queries, opts, rid, box, ev, seq, _ in batch:
                rs = results[off:off + len(queries)]
                off += len(queries)
                with span("server.postprocess", seq=seq):
                    resp = self._srv._postprocess(queries, rs, metrics,
                                                  opts, rid)
                resp["metrics"] = met
                box["resp"] = resp
                ev.set()
        except Exception as e:   # noqa: BLE001 — a dead dispatcher hangs
            # every queued client; answer the batch and keep going
            print(f"{LOG_PREFIX} batch dispatch failed: {e!r}\n"
                  f"{traceback.format_exc()}", file=self._stderr, flush=True)
            for queries, opts, rid, box, ev, *_ in batch:
                if "resp" not in box:
                    box["resp"] = {**rid,
                                   "error": f"batch dispatch failed: {e}",
                                   "error_kind": "internal"}
                    ev.set()


def shutdown_allowed(peer_host: str, allow_remote: bool) -> bool:
    """Whether a TCP-line client at peer_host may stop the server:
    loopback peers only (IPv4 127/8, ::1, and an IPv4-mapped IPv6 address
    read as its IPv4 one), unless the operator opts in
    (--allow-remote-shutdown). swimm_tpu lists the loopback forms by hand
    and refuses a mapped one other than ::ffff:127.0.0.1."""
    if allow_remote:
        return True
    try:
        ip = ipaddress.ip_address(peer_host)
    except ValueError:
        return False
    if ip.version == 6 and ip.ipv4_mapped is not None:
        ip = ip.ipv4_mapped
    return ip.is_loopback


def make_socket_server(packed, config, max_batch_queries=64,
                       max_top_k=None, allow_remote_shutdown=False,
                       request_timeout=None, max_query_len=None,
                       device=None):
    """Build (but do not start) a TCP front end over one SearchServer.

    The newline-JSON protocol of serve_stdio, one response line per
    request line, any number of concurrent connections; searches go
    through one Batcher, so concurrent requests coalesce. {"cmd":
    "shutdown"} stops the whole server, from loopback peers only unless
    allow_remote_shutdown (shutdown_allowed).

    Returns (ServerClass, HandlerClass, search_server, batcher); callers
    bind and serve (serve_socket, or threads in tests) and call
    batcher.stop() when done."""
    srv = SearchServer(packed, config, max_top_k=max_top_k,
                       max_query_len=max_query_len, device=device)
    batcher = Batcher(srv, max_batch_queries=max_batch_queries,
                      request_timeout=request_timeout)

    class Handler(socketserver.StreamRequestHandler):
        def _send(self, obj):
            self.wfile.write((json.dumps(obj) + "\n").encode())
            self.wfile.flush()

        def handle(self):
            for raw in self.rfile:
                line = raw.strip()
                if not line:
                    continue
                try:
                    req = json.loads(line)
                    if not isinstance(req, dict):
                        raise ValueError("request must be a JSON object")
                except ValueError as e:
                    self._send({"error": f"bad request line: {e}",
                                "error_kind": "bad_request"})
                    continue
                if req.get("cmd") == "shutdown":
                    rid = {"id": req["id"]} if "id" in req else {}
                    if not shutdown_allowed(self.client_address[0],
                                            allow_remote_shutdown):
                        self._send({**rid, "error":
                                    "shutdown refused from non-loopback "
                                    f"peer {self.client_address[0]}; start "
                                    "the server with "
                                    "--allow-remote-shutdown to permit it",
                                    "error_kind": "forbidden"})
                        continue
                    self._send({"ok": True, "served": srv.n_requests,
                                **rid})
                    # handler threads are not the serve_forever thread, so
                    # shutdown() here cannot deadlock
                    self.server.shutdown()
                    return
                self._send(batcher.submit(req))

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    return Server, Handler, srv, batcher


#: error_kind -> HTTP status; absent or unknown kinds read as 400
_HTTP_STATUS = {"bad_request": 400, "forbidden": 403,
                "internal": 500, "unavailable": 503, "timeout": 504}


def make_http_server(packed, config, max_batch_queries=64, max_top_k=None,
                     request_timeout=None, max_query_len=None, device=None):
    """HTTP front end over one SearchServer + Batcher (stdlib http.server):

      POST /search   body = one search request (the line protocol's
                     schema) -> response JSON
      GET  /health   -> {"ok": true}
      GET  /info     -> {"info": {...}}

    Concurrent POSTs coalesce through the Batcher like TCP-line clients;
    error responses map error_kind to a status (_HTTP_STATUS). Returns
    (ServerClass, HandlerClass, search_server, batcher)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    srv = SearchServer(packed, config, max_top_k=max_top_k,
                       max_query_len=max_query_len, device=device)
    batcher = Batcher(srv, max_batch_queries=max_batch_queries,
                      request_timeout=request_timeout)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *a):     # access logs to stderr
            print(f"{LOG_PREFIX} http {fmt % a}", file=sys.stderr,
                  flush=True)

        def _reply(self, code, obj):
            body = (json.dumps(obj) + "\n").encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                return self._reply(200, {"ok": True})
            if self.path == "/info":
                return self._reply(200, {"info": srv.info()})
            return self._reply(404, {"error": f"no route {self.path!r}; "
                                     "GET /health, /info or POST /search"})

        def do_POST(self):
            if self.path not in ("/search", "/"):
                return self._reply(404, {"error": f"no route {self.path!r};"
                                         " POST /search"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                if not isinstance(req, dict):
                    raise ValueError("request must be a JSON object")
            except ValueError as e:
                return self._reply(400, {"error": f"bad request body: {e}",
                                         "error_kind": "bad_request"})
            resp = batcher.submit(req)
            code = (_HTTP_STATUS.get(resp.get("error_kind"), 400)
                    if "error" in resp else 200)
            return self._reply(code, resp)

    return ThreadingHTTPServer, Handler, srv, batcher


def serve_socket(packed, config, host, port, warm_lengths=(),
                 max_batch_queries=64, stderr=None, http=False,
                 max_top_k=None, allow_remote_shutdown=False,
                 request_timeout=None, max_query_len=None,
                 device=None) -> int:
    """CLI entry: bind host:port, warm, then serve until shutdown.

    http=False serves the line protocol; http=True the same request
    schema over HTTP (stop with SIGTERM: there is no shutdown route). The
    device is resolved first (no card: raises before binding), then the
    socket is bound BEFORE the warm pass, so supervisors see the port up
    at once; early connections wait until serving starts."""
    stderr = stderr if stderr is not None else sys.stderr

    def log(msg):
        print(f"{LOG_PREFIX} {msg}", file=stderr, flush=True)

    make = make_http_server if http else functools.partial(
        make_socket_server, allow_remote_shutdown=allow_remote_shutdown)
    Server, Handler, srv, batcher = make(
        packed, config, max_batch_queries=max_batch_queries,
        max_top_k=max_top_k, request_timeout=request_timeout,
        max_query_len=max_query_len, device=device)
    with Server((host, port), Handler) as tcp:
        if threading.current_thread() is threading.main_thread():
            import signal

            def _graceful(signum, frame):
                log(f"signal {signum}: draining and shutting down")
                # shutdown() blocks until serve_forever (this thread, now
                # in the signal handler) leaves its loop: call it from a
                # helper thread
                threading.Thread(target=tcp.shutdown, daemon=True).start()

            signal.signal(signal.SIGTERM, _graceful)
            signal.signal(signal.SIGINT, _graceful)
        bound = tcp.server_address
        log(f"bound {bound[0]}:{bound[1]}")
        if warm_lengths:
            dt = srv._warm(warm_lengths)
            log(f"warmed {len(warm_lengths)} query lengths in {dt:.1f}s")
        log(f"ready: {packed.n_seqs} sequences on {srv.device}; serving "
            f"{'http' if http else 'line protocol'} on "
            f"{bound[0]}:{bound[1]}")
        tcp.serve_forever(poll_interval=0.2)
        batcher.stop()
        log(f"shutdown after {srv.n_requests} requests "
            f"({batcher.n_dispatches} search dispatches)")
    return 0


def serve_stdio(packed, config, warm_lengths=(), stdin=None, stdout=None,
                stderr=None, max_top_k=None, max_query_len=None,
                device=None) -> int:
    """Run the newline-JSON loop until EOF or a shutdown command. A fault
    that escapes SearchServer.handle answers error_kind "internal" and the
    loop goes on."""
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    stderr = stderr if stderr is not None else sys.stderr

    def log(msg):
        print(f"{LOG_PREFIX} {msg}", file=stderr, flush=True)

    t0 = time.perf_counter()
    srv = SearchServer(packed, config, max_top_k=max_top_k,
                       max_query_len=max_query_len, device=device)
    if warm_lengths:
        dt = srv._warm(warm_lengths)
        log(f"warmed {len(warm_lengths)} query lengths in {dt:.1f}s")
    log(f"ready: {packed.n_seqs} sequences on {srv.device} "
        f"({time.perf_counter() - t0:.1f}s startup); awaiting JSON "
        "lines on stdin")
    for line in stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError("request must be a JSON object")
        except ValueError as e:
            print(json.dumps({"error": f"bad request line: {e}",
                              "error_kind": "bad_request"}),
                  file=stdout, flush=True)
            continue
        rid = {"id": req["id"]} if "id" in req else {}
        if req.get("cmd") == "shutdown":
            print(json.dumps({"ok": True, "served": srv.n_requests, **rid}),
                  file=stdout, flush=True)
            log(f"shutdown after {srv.n_requests} requests")
            return 0
        t1 = time.perf_counter()
        try:
            resp = srv.handle(req)
        except Exception as e:  # noqa: BLE001 — the loop must keep serving
            log(f"request failed: {e!r}\n{traceback.format_exc()}")
            resp = {**rid, "error": f"request failed: {e!r}",
                    "error_kind": "internal"}
        if "results" in resp:
            log(f"request served in {time.perf_counter() - t1:.2f}s "
                f"({len(resp['results'])} queries)")
        print(json.dumps(resp), file=stdout, flush=True)
    log(f"stdin EOF after {srv.n_requests} requests")
    return 0
