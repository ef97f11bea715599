"""The port's CLI (python -m swimm_tpu_torch) against swimm_tpu's CLI on
one packed DB: info, search --align / --format m8 / --selfcheck with
--device cpu (the same text), --profile-dir, every flag conflict and serve
validation error (one line, exit 2, as swimm_tpu's), and one serve stdio
subprocess run to its shutdown."""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest

from swimm_tpu import cli as jcli
from swimm_tpu_torch import cli
from swimm_tpu_torch.alphabet import decode
from swimm_tpu_torch.db import load_db
from swimm_tpu_torch.fasta import write_fasta
from swimm_tpu_torch.models.engine import SearchConfig
from swimm_tpu_torch.server import SearchServer
from swimm_tpu_torch.utils.synth import synth_db, synth_queries
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(packed DB dir, query FASTA): the port packs, both CLIs read it."""
    tmp = tmp_path_factory.mktemp("clidb")
    qs = synth_queries(2, [30, 45], seed=4)
    write_fasta(tmp / "db.fasta", synth_db(80, seed=3, queries=[
        q.codes for q in qs], median_len=80, max_len=200,
        homolog_frac=0.05))
    write_fasta(tmp / "q.fasta", qs)
    assert cli.main(["preprocess", "-i", str(tmp / "db.fasta"), "-o",
                     str(tmp / "pdb"), "--lanes", "8"]) == 0
    return str(tmp / "pdb"), str(tmp / "q.fasta")


def _both(capsys, args, jargs=()):
    """(port stdout, port stderr, swimm_tpu stdout, swimm_tpu stderr) with
    each run's 'time:' summary line dropped."""
    out = []
    for main, extra in ((cli.main, ["--device", "cpu"]),
                        (jcli.main, ["--backend", "xla", *jargs])):
        capsys.readouterr()
        assert main([*args, *extra]) == 0
        o = capsys.readouterr()
        out += ["\n".join(x for x in s.splitlines()
                          if not x.startswith("time: "))
                for s in (o.out, o.err)]
    return out


def test_info_equals_reference(files, capsys):
    db, _ = files
    assert cli.main(["info", "-d", db]) == 0
    port = capsys.readouterr().out
    assert jcli.main(["info", "-d", db]) == 0
    ref = capsys.readouterr().out
    assert port == ref.replace(" MB HBM (", " MB device (")
    assert "sequences       80" in port


@pytest.mark.parametrize("flags", [
    ["--align"], ["--format", "m8"], ["--align", "--format", "json"],
    ["--selfcheck", "--evalue"], ["--format", "m8", "--selfcheck"]])
def test_search_outputs_equal_reference(files, capsys, flags):
    db, q = files
    out, err, jout, jerr = _both(capsys, ["search", "-d", db, "-q", q, "-r",
                                          "3", *flags])
    if "json" in flags:
        assert json.loads(out)["results"] == json.loads(jout)["results"]
        assert "alignment" in json.loads(out)["results"][0]["hits"][0]
    else:
        assert out == jout and out
    if "m8" in flags:
        assert all(len(r.split("\t")) == 12 for r in out.splitlines())
    if "--selfcheck" in flags:
        assert "selfcheck: PASS (6 hit scores verified" in err
        assert err == jerr


def test_search_profile_dir(files, tmp_path, capsys):
    db, q = files
    prof = tmp_path / "prof"
    assert cli.main(["search", "-d", db, "-q", q, "-r", "2", "--device",
                     "cpu", "--profile-dir", str(prof)]) == 0
    assert capsys.readouterr().out.count("Query: ") == 2
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert json.loads(traces[0].read_text())["traceEvents"]


SEARCH_CONFLICTS = [
    ["--format", "m8", "--align"],
    ["--format", "m8", "--query-pack"],
    ["--json", "--format", "table"],
    ["--max-evalue", "1"],
    ["--evalue", "--max-evalue", "0"],
    ["--stream", "--query-pack"],
    ["--window-tiles", "64"],
    ["--evalue", "--query-pack"],
    ["-s", "BLOSUM999"],
]


@pytest.mark.parametrize("flags", SEARCH_CONFLICTS)
def test_search_conflicts_exit_2(files, capsys, flags):
    db, q = files
    base = ["search", "-d", db, "-q", q]
    assert cli.main([*base, "--device", "cpu", *flags]) == 2
    err = capsys.readouterr().err
    assert err.startswith("swimm_tpu_torch: error: ")
    assert len(err.strip().splitlines()) == 1
    assert jcli.main([*base, "--backend", "xla", *flags]) == 2


@pytest.mark.parametrize("flags", [
    ["--sharded"], ["--sharded", "--topk-per-shard", "64"],
    ["--sharded", "--evalue"], ["--sharded", "--format", "json"],
    ["--sharded", "--stream"],
    ["--sharded", "--stream", "--window-tiles", "32", "--evalue"]])
def test_sharded_search_equals_reference(files, capsys, flags):
    """--sharded on the CPU (one CPU device) prints what swimm_tpu's
    --sharded prints over its 8 virtual devices."""
    db, q = files
    out, err, jout, jerr = _both(capsys, ["search", "-d", db, "-q", q, "-r",
                                          "3", *flags])
    if "json" in flags:
        assert json.loads(out)["results"] == json.loads(jout)["results"]
    else:
        assert out == jout and out.count("Query: ") == 2


SHARDED_CONFLICTS = [
    ["--sharded", "--query-pack"],
    ["--sharded", "--stream-scores", "buffer"],
    ["--sharded", "--stream", "--stream-scores", "buffer"],
    ["--topk-per-shard", "64"],
    ["--query-axis", "2"],
    ["--sharded", "--stream", "--topk-per-shard", "64"],
    ["--sharded", "--window-tiles", "64"],
    ["--stream", "--query-axis", "1"],
]


@pytest.mark.parametrize("flags", SHARDED_CONFLICTS)
def test_sharded_conflicts_equal_reference(files, capsys, flags):
    """Each conflict of the sharded flags exits 2 with swimm_tpu's message,
    word for word."""
    db, q = files
    base = ["search", "-d", db, "-q", q]
    assert cli.main([*base, "--device", "cpu", *flags]) == 2
    err = capsys.readouterr().err
    assert jcli.main([*base, "--backend", "xla", *flags]) == 2
    jerr = capsys.readouterr().err
    assert err.startswith("swimm_tpu_torch: error: ")
    assert err.removeprefix("swimm_tpu_torch: error: ") == \
        jerr.removeprefix("swtpu: error: ")


SERVE_ERRORS = [
    ["--warm", "a,b"], ["--warm", "0"], ["--listen", "8080x"],
    ["--listen", "localhost"], ["--listen", "host:port"],
    ["--listen", "127.0.0.1:0", "--max-batch-queries", "0"],
    ["--listen", "127.0.0.1:0", "--request-timeout", "-1"],
    ["--http"], ["--allow-remote-shutdown"], ["--request-timeout", "5"],
]


@pytest.mark.parametrize("flags", SERVE_ERRORS)
def test_serve_validation_exit_2(files, capsys, flags):
    db, _ = files
    assert cli.main(["serve", "-d", db, "--device", "cpu", *flags]) == 2
    err = capsys.readouterr().err
    assert err.startswith("swimm_tpu_torch: error: ")
    assert jcli.main(["serve", "-d", db, "--backend", "xla", *flags]) == 2


@pytest.mark.parametrize("n", ["0", "-5"])
def test_serve_refuses_max_query_len_not_positive(files, capsys, n):
    """swimm_tpu reads --max-query-len 0 as unlimited and -5 as a ceiling
    that refuses every query; the port refuses both (ROADMAP Queue 3)."""
    db, _ = files
    assert cli.main(["serve", "-d", db, "--device", "cpu",
                     "--max-query-len", n]) == 2
    assert "--max-query-len must be positive" in capsys.readouterr().err


def test_no_card_exits_2(files, capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db, q = files
    for args in (["serve", "-d", db], ["serve", "-d", db, "--listen",
                                       "127.0.0.1:0"],
                 ["search", "-d", db, "-q", q]):
        assert cli.main(args) == 2, args
        assert "device='cpu'" in capsys.readouterr().err


def test_broken_pipe_and_debug(files, tmp_path, monkeypatch):
    def broken(args):
        raise BrokenPipeError

    with open(tmp_path / "out", "w") as fh:
        monkeypatch.setattr(sys, "stdout", fh)
        monkeypatch.setattr(cli, "_run", broken)
        assert cli.main(["info", "-d", files[0]]) == 141
    monkeypatch.undo()
    monkeypatch.setenv("SWTPU_DEBUG", "1")
    with pytest.raises(ValueError, match="BLOSUM999"):
        cli.main(["search", "-d", files[0], "-q", files[1], "-s",
                  "BLOSUM999", "--device", "cpu"])


def test_serve_stdio_subprocess(files):
    """python -m swimm_tpu_torch serve on stdin/stdout, warmed, to its
    shutdown: a ping, a search equal to the in-process server's, a
    malformed line answered, exit 0."""
    db, _ = files
    q = synth_queries(1, [30], seed=15)[0]
    req = {"id": 5, "queries": [{"title": "sq", "seq": decode(q.codes)}],
           "align": True}
    lines = "\n".join([json.dumps({"cmd": "ping"}), json.dumps(req),
                       "{nope", json.dumps({"cmd": "shutdown"})]) + "\n"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    p = subprocess.run(
        [sys.executable, "-m", "swimm_tpu_torch", "serve", "-d", db,
         "--device", "cpu", "-r", "3", "--warm", "30"],
        input=lines, capture_output=True, text=True, timeout=600, env=env,
        cwd=REPO)
    assert p.returncode == 0, p.stderr
    resp = [json.loads(x) for x in p.stdout.splitlines()]
    assert resp[0] == {"ok": True}
    want = SearchServer(load_db(db), SearchConfig(top_k=3),
                        device="cpu").handle(req)
    assert {k: v for k, v in resp[1].items() if k != "metrics"} == {
        k: v for k, v in want.items() if k != "metrics"}
    assert resp[2]["error_kind"] == "bad_request"
    assert resp[3] == {"ok": True, "served": 1}
    assert "swimm_tpu_torch serve: ready" in p.stderr
    assert "warmed 1 query lengths" in p.stderr


def test_serve_http_subprocess_sigterm(files):
    """python -m swimm_tpu_torch serve --listen 127.0.0.1:0 --http: the
    bound port logged, GET /health and POST /search answered (the search
    equal to the in-process server's), SIGTERM drains and exits 0."""
    db, _ = files
    env = dict(os.environ, PYTHONPATH=str(REPO))
    p = subprocess.Popen(
        [sys.executable, "-m", "swimm_tpu_torch", "serve", "-d", db,
         "--device", "cpu", "-r", "3", "--listen", "127.0.0.1:0", "--http"],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        env=env, cwd=REPO)
    log = []
    reader = threading.Thread(target=lambda: log.extend(p.stderr),
                              daemon=True)
    reader.start()
    try:
        deadline = time.monotonic() + 600
        while not any("ready:" in x for x in log):
            assert p.poll() is None and time.monotonic() < deadline, log
            time.sleep(0.1)
        port = int(re.search(r"bound 127\.0\.0\.1:(\d+)", "".join(log))[1])
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            assert json.loads(r.read()) == {"ok": True}
        q = synth_queries(1, [40], seed=16)[0]
        req = {"queries": [{"title": "hq", "seq": decode(q.codes)}]}
        rq = urllib.request.Request(base + "/search",
                                    data=json.dumps(req).encode())
        with urllib.request.urlopen(rq, timeout=300) as r:
            got = json.loads(r.read())
        want = SearchServer(load_db(db), SearchConfig(top_k=3),
                            device="cpu").handle(req)
        assert got["results"] == want["results"]
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=120) == 0
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)
    reader.join(timeout=30)
    text = "".join(log)
    assert "draining and shutting down" in text
    assert "shutdown after 1 requests (1 search dispatches)" in text
