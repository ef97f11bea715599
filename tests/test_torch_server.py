"""swimm_tpu_torch.server (device='cpu': the plain PyTorch scorers) against
swimm_tpu.server (xla backend) on one DB: for the same requests the same
responses, metrics aside — results, hits and their tie order, E-values and
bit scores, alignment blocks, m8 rows and error replies — through
SearchServer.handle, the Batcher, the TCP line protocol, HTTP and
serve_stdio, resident and streaming. Tolerance 0: equal integers, equal
strings, equal floats. Also the four places where the port departs from
swimm_tpu on purpose (ROADMAP Queue 3), each on the input where the two
differ."""

import io
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import swimm_tpu.db as jdb
import swimm_tpu.server as jserver
from swimm_tpu.models.engine import SearchConfig as JConfig
from swimm_tpu_torch import db as tdb
from swimm_tpu_torch import server
from swimm_tpu_torch.alphabet import decode
from swimm_tpu_torch.fasta import write_fasta
from swimm_tpu_torch.models.engine import SearchConfig
from swimm_tpu_torch.server import Batcher, SearchServer
from swimm_tpu_torch.utils.synth import synth_db, synth_queries
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    """(port pack, swimm_tpu pack) of one FASTA: synth_db(150, seed=21),
    V=16."""
    tmp = tmp_path_factory.mktemp("srvdb")
    write_fasta(tmp / "db.fasta", synth_db(150, seed=21))
    return (tdb.build_db(str(tmp / "db.fasta"), tmp / "t", V=16),
            jdb.build_db(str(tmp / "db.fasta"), tmp / "j", V=16))


def _servers(packs, **cfg):
    pt, pj = packs
    kw = {k: cfg.pop(k) for k in ("max_top_k", "max_query_len") if k in cfg}
    return (SearchServer(pt, SearchConfig(top_k=4, **cfg), device="cpu",
                         **kw),
            jserver.SearchServer(pj, JConfig(backend="xla", top_k=4, **cfg),
                                 **kw))


@pytest.fixture(scope="module")
def pair(packs):
    return _servers(packs)


@pytest.fixture(scope="module")
def pair_evalue(packs):
    return _servers(packs, evalue=True)


def _strip(resp):
    return {k: v for k, v in resp.items() if k != "metrics"}


def _req(lengths=(35, 70), seed=9, **extra):
    qs = synth_queries(len(lengths), list(lengths), seed=seed)
    return {"id": 1, "queries": [{"title": q.title, "seq": decode(q.codes)}
                                 for q in qs], **extra}


def _self_req(packed, **extra):
    # a db sequence as the query: its rank-1 hit is the exact self-hit
    return {"queries": [{"title": "self q",
                         "seq": decode(packed.seq_codes(0))}], **extra}


REQUESTS = {
    "two_queries": _req(),
    "fasta_form_top_k_2": {"query_fasta": ">fq one\nMKVLAAGIVGLLLAWWHHKQ"
                                          "\nPRSTVYACDEFGHIKLMNPQRS\n",
                           "top_k": 2},
    "align": _req(align=True),
    "m8": _req(format="m8"),
    "top_k_5_bucketed": _req(top_k=5),
    "top_k_1_below_default": _req(top_k=1),
}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_handle_equals_reference(pair, name):
    port, ref = pair
    got = port.handle(REQUESTS[name])
    assert "error" not in got, got
    assert _strip(got) == _strip(ref.handle(REQUESTS[name]))


@pytest.mark.parametrize("extra", [{}, {"align": True, "top_k": 2},
                                   {"format": "m8"}])
def test_handle_evalue_posture_equals_reference(pair_evalue, packs, extra):
    port, ref = pair_evalue
    for req in (_req(**extra), _self_req(packs[0], **extra)):
        got = port.handle(req)
        assert "bits" in got["results"][0]["hits"][0]
        assert _strip(got) == _strip(ref.handle(req))


def test_commands_equal_reference(pair):
    port, ref = pair
    for req in ({"cmd": "ping", "id": 3}, {"cmd": "ping"},
                {"cmd": "shutdown", "id": 6}, {"cmd": "restart", "id": 4}):
        assert port.handle(req) == ref.handle(req), req
    info, rinfo = port.handle({"cmd": "info"})["info"], ref.info()
    assert set(info) == set(rinfo) | {"device"} and info["device"] == "cpu"
    for k in ("n_seqs", "total_residues", "matrix", "gap_open", "gap_extend",
              "precision", "db_stream", "evalue", "default_top_k"):
        assert info[k] == rinfo[k], k
    assert info["rss_mb"] is None or info["rss_mb"] > 0


MALFORMED = [
    {"queries": [{"seq": 5}]},          # non-string seq
    {"queries": "MKV"},                 # queries not a list
    {"queries": [5]},                   # element not an object
    {"query_fasta": 5},                 # fasta not a string
    {"queries": [{"seq": "ACD"}], "top_k": [4]},    # top_k not an int
    {"queries": [{"seq": "ACD"}], "top_k": True},   # bool is not a k
    {"queries": [{"seq": "ACD"}], "top_k": 0},
    {"queries": [{"seq": "ACD"}], "top_k": 9},      # over max_top_k 8
    {"queries": [{"seq": "ACD"}], "format": "xml"},
    {"queries": [{"seq": ""}]},
    {"query_fasta": ""},
    {"no": "queries"},
]


@pytest.mark.parametrize("i", range(len(MALFORMED)))
def test_malformed_request_errors_equal_reference(packs, i):
    port, ref = _servers(packs, max_top_k=8)
    req = dict(MALFORMED[i], id=7)
    got = port.handle(req)
    assert got["error_kind"] == "bad_request" and got["id"] == 7
    assert got == ref.handle(req)
    b = Batcher(port, autostart=False)
    assert b.submit(req) == got          # answered at once, never queued
    assert not b._pending
    assert port.n_requests == 0


def test_fuzz_handler_never_raises_and_stays_up(packs):
    """Seeded random requests: every reply is a dict ('results', 'error',
    'ok' or 'info'), never an exception; the server still serves after."""
    rng = np.random.default_rng(99)

    def rand_value(depth=0):
        kind = rng.integers(0, 9 if depth < 2 else 6)
        if kind == 0:
            return int(rng.integers(-(10**9), 10**9))
        if kind == 1:
            return float(rng.normal())
        if kind == 2:
            return bool(rng.integers(0, 2))
        if kind == 3:
            return None
        if kind == 4:
            alpha = "ACDEFGHIKLMNPQRSTVWY>*\n\x00é🧬 {}[]"
            return "".join(alpha[i] for i in rng.integers(
                0, len(alpha), size=int(rng.integers(0, 12))))
        if kind == 5:
            return ""
        if kind == 6:
            return [rand_value(depth + 1)
                    for _ in range(int(rng.integers(0, 4)))]
        if kind == 7:
            return {str(rand_value(2)): rand_value(depth + 1)
                    for _ in range(int(rng.integers(0, 4)))}
        return {"seq": rand_value(depth + 1), "title": rand_value(depth + 1)}

    srv = SearchServer(packs[0], SearchConfig(top_k=4), device="cpu",
                       max_top_k=8, max_query_len=64)
    keys = ["queries", "query_fasta", "top_k", "align", "format", "cmd",
            "id", "bogus"]
    for _ in range(300):
        req = {k: rand_value() for k in
               rng.choice(keys, size=rng.integers(1, 5), replace=False)}
        resp = srv.handle(req)
        assert isinstance(resp, dict)
        assert {"error", "results", "ok", "info"} & set(resp), req
    assert "error" not in srv.handle(_req((35, 50)))


def test_top_k_ceiling_and_prefix(pair, packs):
    port, _ = _servers(packs, max_top_k=8)
    assert "maximum 8" in port.handle(_req(top_k=9))["error"]
    r5 = port.handle(_req(top_k=5))
    r8 = port.handle(_req(top_k=8))
    for a, b in zip(r5["results"], r8["results"]):
        assert len(a["hits"]) == 5 and a["hits"] == b["hits"][:5]
    with pytest.raises(ValueError, match="below the server default"):
        SearchServer(packs[0], SearchConfig(top_k=4), device="cpu",
                     max_top_k=2)


def _serve_thread(tcp):
    t = threading.Thread(target=tcp.serve_forever,
                         kwargs={"poll_interval": 0.05}, daemon=True)
    t.start()
    return t


def _lines(port, lines, timeout=60):
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        f = s.makefile("rw", encoding="utf-8")
        out = []
        for line in lines:
            f.write(line + "\n")
            f.flush()
            out.append(json.loads(f.readline()))
        return out


def test_tcp_line_protocol_equals_reference(pair, packs):
    Server, Handler, srv, batcher = server.make_socket_server(
        packs[0], SearchConfig(top_k=4), device="cpu")
    tcp = Server(("127.0.0.1", 0), Handler)
    t = _serve_thread(tcp)
    try:
        port = tcp.server_address[1]
        reqs = [REQUESTS["two_queries"], REQUESTS["m8"], REQUESTS["align"]]
        r = _lines(port, [json.dumps({"cmd": "ping"}), "{nope", "[1]"]
                   + [json.dumps(q) for q in reqs])
        assert r[0] == {"ok": True}
        assert "bad request line" in r[1]["error"]
        assert r[2]["error_kind"] == "bad_request"
        for got, req in zip(r[3:], reqs):
            assert got["metrics"]["batched_requests"] == 1
            assert _strip(got) == _strip(pair[1].handle(req))
        assert _lines(port, [json.dumps({"cmd": "info"})])[0][
            "info"]["n_requests"] == 3
        r3 = _lines(port, [json.dumps({"cmd": "shutdown", "id": 9})])
        assert r3[0] == {"ok": True, "served": 3, "id": 9}
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        tcp.shutdown()
        tcp.server_close()
        batcher.stop()


def test_serve_socket_warms_serves_and_shuts_down(pair, packs):
    """serve_socket (the CLI's --listen entry) in a thread: binds, warms,
    serves the line protocol, stops on a loopback shutdown and returns 0,
    its log naming the bound port, the warm and the dispatch count."""
    err, box = io.StringIO(), {}
    t = threading.Thread(target=lambda: box.setdefault(
        "rc", server.serve_socket(packs[0], SearchConfig(top_k=4),
                                  "127.0.0.1", 0, warm_lengths=(32, 48),
                                  stderr=err, device="cpu")))
    t.start()
    deadline = time.monotonic() + 300
    while "ready:" not in err.getvalue():
        assert t.is_alive() and time.monotonic() < deadline, err.getvalue()
        time.sleep(0.05)
    port = int(err.getvalue().split("bound 127.0.0.1:")[1].split()[0])
    r = _lines(port, [json.dumps(REQUESTS["m8"]),
                      json.dumps({"cmd": "shutdown", "id": 1})])
    assert _strip(r[0]) == _strip(pair[1].handle(REQUESTS["m8"]))
    assert r[1] == {"ok": True, "served": 1, "id": 1}
    t.join(timeout=60)
    assert not t.is_alive() and box["rc"] == 0
    log = err.getvalue()
    assert "warmed 2 query lengths" in log and "on cpu" in log
    assert "shutdown after 1 requests (1 search dispatches)" in log


def test_tcp_concurrent_clients_equal_lone_requests(pair, packs):
    """Six connections at once, each one request: every response equals
    the same request served alone by swimm_tpu."""
    Server, Handler, srv, batcher = server.make_socket_server(
        packs[0], SearchConfig(top_k=4), device="cpu")
    tcp = Server(("127.0.0.1", 0), Handler)
    _serve_thread(tcp)
    reqs = [_req((30 + 7 * i,), seed=40 + i, id=i) for i in range(6)]
    out = [None] * 6
    try:
        ts = [threading.Thread(target=lambda i=i: out.__setitem__(
            i, _lines(tcp.server_address[1], [json.dumps(reqs[i])])[0]))
            for i in range(6)]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in ts)
        for i, got in enumerate(out):
            assert _strip(got) == _strip(pair[1].handle(reqs[i])), i
        assert srv.n_requests == 6 and 1 <= batcher.n_dispatches <= 6
    finally:
        tcp.shutdown()
        tcp.server_close()
        batcher.stop()


def test_batcher_coalesces_and_truncates(pair):
    """Three requests queued together (mixed top_k) -> ONE search; each
    response equals the lone request's, here and in swimm_tpu."""
    port, ref = pair
    b = Batcher(port, autostart=False)
    qs = synth_queries(3, [30, 44, 44], seed=17)
    q = [{"title": x.title, "seq": decode(x.codes)} for x in qs]
    reqs = [{"id": 0, "queries": [q[0]], "top_k": 2},
            {"id": 1, "queries": [q[1]]},
            {"id": 2, "queries": [q[2], dict(q[0], title="x2")],
             "top_k": 3}]
    before = port.n_requests
    out = [None] * 3
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(
        i, b.submit(reqs[i]))) for i in range(3)]
    for t in threads:
        t.start()
    for _ in range(1000):
        with b._cv:
            if len(b._pending) == 3:
                break
        time.sleep(0.01)
    b._drain_once()
    for t in threads:
        t.join(timeout=30)
    assert b.n_dispatches == 1 < len(reqs)
    assert port.n_requests - before == 3
    for i, req in enumerate(reqs):
        assert out[i]["metrics"]["batched_requests"] == 3
        assert out[i]["metrics"]["batched_queries"] == 4
        assert _strip(out[i]) == _strip(port.handle(req)) \
            == _strip(ref.handle(req))


def test_batcher_thread_search_equals_main_thread(pair):
    """A search run on the dispatcher thread equals one on this thread."""
    port, _ = pair
    b = Batcher(port)
    try:
        got = b.submit(REQUESTS["align"])
        assert b._thread.is_alive() and b.n_dispatches == 1
        assert _strip(got) == _strip(port.handle(REQUESTS["align"]))
    finally:
        b.stop()
    assert not b._thread.is_alive()
    assert b.submit(_req())["error_kind"] == "unavailable"


def test_batcher_oversized_request_served_alone(pair):
    b = Batcher(pair[0], max_batch_queries=1, autostart=False)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "r", b.submit(_req())))
    t.start()
    for _ in range(1000):
        with b._cv:
            if b._pending:
                break
        time.sleep(0.01)
    b._drain_once()
    t.join(timeout=30)
    assert len(out["r"]["results"]) == 2 and b.n_dispatches == 1


def test_request_timeout_cancels_queued(pair):
    b = Batcher(pair[0], autostart=False, request_timeout=0.25)
    t0 = time.perf_counter()
    resp = b.submit(_req())
    assert time.perf_counter() - t0 < 5
    assert resp["id"] == 1 and resp["error_kind"] == "timeout"
    assert "cancelled while queued" in resp["error"]
    assert not b._pending


def test_request_timeout_in_flight_discards(packs):
    """A request already dispatched when its timeout fires is answered at
    once; the search's result is dropped when it lands and the server
    serves the next request. The search is a stub (the first call slow),
    so the timing does not depend on the machine's load."""
    srv = SearchServer(packs[0], SearchConfig(top_k=4), device="cpu")
    req = _req(id=2)
    want = _strip(srv.handle(req))
    found = srv._search(packs[0], server._encode_queries(req), srv._config)
    calls = []

    def stub(*a, **kw):
        calls.append(a)
        if len(calls) == 1:
            time.sleep(1.2)
        return found

    srv._search = stub
    b = Batcher(srv, request_timeout=0.3)
    try:
        t0 = time.perf_counter()
        resp = b.submit(req)
        assert resp["error_kind"] == "timeout", resp
        assert "discarded" in resp["error"]
        assert time.perf_counter() - t0 < 1.0
        for _ in range(200):                   # the slow search lands
            time.sleep(0.05)
            if b.n_dispatches >= 1:
                break
        assert b.n_dispatches == 1
        ok = b.submit(req)
        assert _strip(ok) == want and len(calls) == 2
    finally:
        b.stop()


def test_internal_fault_answers_and_stays_up(packs):
    """A fault inside the search answers error_kind 'internal', through
    handle and the Batcher, with nothing retried elsewhere; the next
    request is served."""
    srv = SearchServer(packs[0], SearchConfig(top_k=4), device="cpu")
    real = srv._search
    calls = []

    def boom(*a, **kw):
        calls.append(a)
        raise RuntimeError("synthetic device fault")

    srv._search = boom
    resp = srv.handle(_req(id=5))
    assert resp["id"] == 5 and resp["error_kind"] == "internal"
    assert "synthetic device fault" in resp["error"]
    err = io.StringIO()
    b = Batcher(srv, autostart=False, stderr=err)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "r", b.submit(_req(id=6))))
    t.start()
    for _ in range(1000):
        with b._cv:
            if b._pending:
                break
        time.sleep(0.01)
    b._drain_once()
    t.join(timeout=30)
    assert out["r"]["error_kind"] == "internal" and len(calls) == 2
    assert "batch dispatch failed" in err.getvalue()
    srv._search = real
    assert "error" not in srv.handle(_req())


def _http(base, path, obj=None):
    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_server_equals_reference(pair, packs):
    """Routes, the error_kind -> status map, responses equal to
    swimm_tpu's, malformed bodies answered 400 with the server up, an
    internal fault 500, two concurrent POSTs."""
    assert server._HTTP_STATUS == jserver._HTTP_STATUS
    Server, Handler, srv, batcher = server.make_http_server(
        packs[0], SearchConfig(top_k=4), device="cpu")
    httpd = Server(("127.0.0.1", 0), Handler)
    _serve_thread(httpd)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        assert _http(base, "/health") == (200, {"ok": True})
        code, info = _http(base, "/info")
        assert code == 200 and info["info"]["n_seqs"] == packs[0].n_seqs
        assert _http(base, "/nope")[0] == 404
        assert _http(base, "/elsewhere", _req())[0] == 404
        for name in ("two_queries", "m8"):
            code, resp = _http(base, "/search", REQUESTS[name])
            assert code == 200
            assert _strip(resp) == _strip(pair[1].handle(REQUESTS[name]))
        for m in MALFORMED[:6]:
            code, resp = _http(base, "/search", m)
            assert code == 400 and resp["error_kind"] == "bad_request", m
        code, resp = _http(base, "/search", {"cmd": "shutdown"})
        assert code == 400 and "SIGTERM" in resp["error"]
        real = srv._search

        def boom(*a, **kw):
            raise RuntimeError("synthetic dispatch fault")

        srv._search = boom
        assert _http(base, "/search", _req())[0] == 500
        srv._search = real
        out = [None, None]
        ts = [threading.Thread(target=lambda i=i: out.__setitem__(
            i, _http(base, "/search", REQUESTS["two_queries"])))
            for i in range(2)]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=120)
        assert [o[0] for o in out] == [200, 200]
        assert _strip(out[0][1]) == _strip(out[1][1])
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.stop()


def test_serve_stdio_equals_reference(packs):
    """The same stdin lines through both stdio loops: equal replies."""
    lines = [json.dumps({"cmd": "ping"}), "", "{nope", "[2]",
             json.dumps(REQUESTS["two_queries"]),
             json.dumps(dict(MALFORMED[0], id=8)),
             json.dumps(REQUESTS["m8"]), json.dumps({"cmd": "info"}),
             json.dumps({"cmd": "shutdown", "id": 3}),
             json.dumps({"cmd": "ping", "id": "never read"})]
    outs = []
    for serve, pk, cfg, kw in (
            (server.serve_stdio, packs[0], SearchConfig(top_k=4),
             {"device": "cpu"}),
            (jserver.serve_stdio, packs[1], JConfig(backend="xla", top_k=4),
             {})):
        out, err = io.StringIO(), io.StringIO()
        assert serve(pk, cfg, stdin=io.StringIO("\n".join(lines)),
                     stdout=out, stderr=err, **kw) == 0
        outs.append([json.loads(x) for x in out.getvalue().splitlines()])
    got, want = outs
    assert len(got) == len(want) == 8
    assert got[6]["info"]["n_requests"] == 2
    for g, w in zip(got, want):
        if "info" in g:
            continue
        assert _strip(g) == _strip(w)


def test_streaming_server_equals_resident(pair, packs):
    """A server started with db_stream=True answers as the resident one,
    and as swimm_tpu's streaming server."""
    pt, pj = packs
    req = _req((26, 41), seed=20, align=True)
    stream = SearchServer(pt, SearchConfig(top_k=4, db_stream=True,
                                           window_tiles=64), device="cpu")
    jstream = jserver.SearchServer(pj, JConfig(backend="xla", top_k=4,
                                               db_stream=True,
                                               window_tiles=64))
    got = _strip(stream.handle(req))
    assert got == _strip(pair[0].handle(req))
    assert got == _strip(jstream.handle(req))


def test_warm_and_no_card(packs, monkeypatch):
    """warm_lengths runs throwaway searches (uncounted); with no card and
    no device='cpu' the server does not come up."""
    import torch
    srv = SearchServer(packs[0], SearchConfig(top_k=4), device="cpu",
                       warm_lengths=(32, 64))
    assert srv.n_requests == 0 and srv.total_cells == 0
    assert "error" not in srv.handle(_req())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SearchServer(packs[0], SearchConfig(top_k=4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        server.make_socket_server(packs[0], SearchConfig(top_k=4))


# ---- the four deliberate departures from swimm_tpu (ROADMAP Queue 3) ----

def test_parse_fault_answers_bad_request_and_stdio_stays_up(pair, packs,
                                                             monkeypatch):
    """1. A non-ValueError out of _parse: swimm_tpu's handle lets it
    escape (and its stdio loop dies); the port answers bad_request, and
    its stdio loop answers 'internal' for anything that escapes handle."""
    def broken(req):
        raise TypeError("unanticipated parse fault")

    port, ref = pair
    monkeypatch.setattr(server, "_encode_queries", broken)
    monkeypatch.setattr(jserver, "_encode_queries", broken)
    resp = port.handle(_req(id=4))
    assert resp == {"id": 4, "error": "unanticipated parse fault",
                    "error_kind": "bad_request"}
    with pytest.raises(TypeError):
        ref.handle(_req(id=4))
    monkeypatch.undo()

    real = SearchServer.handle

    def flaky(self, req):
        if req.get("id") == "boom":
            raise RuntimeError("escaped handle")
        return real(self, req)

    monkeypatch.setattr(SearchServer, "handle", flaky)
    lines = "\n".join([json.dumps({"id": "boom", "queries": []}),
                       json.dumps(REQUESTS["two_queries"])])
    out = io.StringIO()
    assert server.serve_stdio(packs[0], SearchConfig(top_k=4),
                              stdin=io.StringIO(lines), stdout=out,
                              stderr=io.StringIO(), device="cpu") == 0
    r = [json.loads(x) for x in out.getvalue().splitlines()]
    assert r[0]["id"] == "boom" and r[0]["error_kind"] == "internal"
    assert "escaped handle" in r[0]["error"]
    assert _strip(r[1]) == _strip(ref.handle(REQUESTS["two_queries"]))


def test_bucket_k_below_default_searches_at_default(pair):
    """2. A top_k below the server default is searched at the default
    (swimm_tpu: at its own power of two); the truncated responses are
    equal, and every bucket is >= k, <= max, O(log max) of them."""
    import math
    assert server._bucket_k(1, 4, 1024) == 4 != jserver._bucket_k(1, 4, 1024)
    assert server._bucket_k(3, 4, 1024) == 4
    assert server._bucket_k(5, 4, 1024) == jserver._bucket_k(5, 4, 1024) == 8
    assert server._bucket_k(1000, 4, 1024) == 1024
    for default in (1, 4, 16, 100):
        for max_k in (default, 64, 1000):
            if max_k < default:
                continue
            seen = set()
            for k in range(1, max_k + 1):
                b = server._bucket_k(k, default, max_k)
                assert max(k, default) <= b <= max_k
                seen.add(b)
            assert len(seen) <= math.ceil(math.log2(max_k)) + 2
    port, ref = pair
    for k in (1, 2, 3, 4):
        req = _req(top_k=k)
        assert _strip(port.handle(req)) == _strip(ref.handle(req)), k


def test_max_query_len_zero_is_refused(pair, packs):
    """3. max_query_len=0: swimm_tpu reads it as unlimited (a falsy
    check); the port refuses it. A positive ceiling answers alike."""
    with pytest.raises(ValueError, match="positive"):
        SearchServer(packs[0], SearchConfig(top_k=4), device="cpu",
                     max_query_len=0)
    ref0 = jserver.SearchServer(packs[1], JConfig(backend="xla", top_k=4),
                                max_query_len=0)
    assert ref0.max_query_len is None
    port, ref = _servers(packs, max_query_len=50)
    long_req = _req((80,), seed=38)
    assert port.handle(long_req) == ref.handle(long_req)
    assert "80 aa" in port.handle(long_req)["error"]
    assert _strip(port.handle(_req((40,), seed=38))) == _strip(
        ref.handle(_req((40,), seed=38)))


@pytest.mark.parametrize("peer,allowed", [
    ("127.0.0.1", True), ("127.0.0.53", True), ("::1", True),
    ("::ffff:127.0.0.1", True), ("::ffff:127.0.0.53", True),
    ("10.0.0.5", False), ("192.168.1.9", False), ("::ffff:10.0.0.5", False),
    ("fe80::1", False), ("localhost", False)])
def test_shutdown_allowed_reads_mapped_loopback(peer, allowed):
    """4. The loopback gate through ipaddress: an IPv4-mapped IPv6 peer is
    read as its IPv4 address. swimm_tpu refuses ::ffff:127.0.0.53 (its
    list names one mapped form); on every other peer the two agree."""
    assert server.shutdown_allowed(peer, False) is allowed
    assert server.shutdown_allowed(peer, True)
    differs = peer == "::ffff:127.0.0.53"
    assert jserver.shutdown_allowed(peer, False) is (allowed and not differs)
