"""swimm_tpu_torch.client and the CLI's query subcommand against an
in-process port server (device='cpu'): the client loads neither torch nor
jax, render_table gives swimm_tpu.client's text for the same response, and
query prints what the server answered in each format."""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from swimm_tpu.client import render_table as j_render_table
from swimm_tpu_torch import client
from swimm_tpu_torch import db as tdb
from swimm_tpu_torch.alphabet import decode
from swimm_tpu_torch.cli import main
from swimm_tpu_torch.fasta import FastaRecord, write_fasta
from swimm_tpu_torch.models.engine import SearchConfig
from swimm_tpu_torch.server import make_socket_server
from swimm_tpu_torch.utils.synth import synth_db, synth_queries
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A live port TCP server (E-values on) over a small DB; yields
    (packed, port)."""
    tmp = tmp_path_factory.mktemp("clidb")
    write_fasta(tmp / "db.fasta", synth_db(120, seed=31))
    packed = tdb.build_db(str(tmp / "db.fasta"), tmp / "packed", V=16)
    Server, Handler, srv, batcher = make_socket_server(
        packed, SearchConfig(top_k=4, evalue=True), device="cpu")
    tcp = Server(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=tcp.serve_forever,
                         kwargs={"poll_interval": 0.05}, daemon=True)
    t.start()
    yield packed, tcp.server_address[1]
    tcp.shutdown()
    tcp.server_close()
    batcher.stop()


@pytest.fixture()
def qfasta(tmp_path):
    path = tmp_path / "q.fasta"
    write_fasta(path, synth_queries(2, [34, 52], seed=32))
    return path


def test_client_and_query_branch_load_neither_torch_nor_jax():
    # the delta of sys.modules: an interpreter may preload modules at
    # start-up; the client, the CLI module and its query branch (run to
    # its connection error) must add neither torch nor jax
    code = ("import sys; base = set(sys.modules)\n"
            "import swimm_tpu_torch.client, swimm_tpu_torch.cli\n"
            "rc = swimm_tpu_torch.cli.main(['query', '--cmd', 'ping', "
            "'--server', '127.0.0.1:1', '--timeout', '2'])\n"
            "bad = sorted(m for m in set(sys.modules) - base "
            "if m.split('.')[0] in ('torch', 'jax', 'numpy'))\n"
            "print(rc, bad); sys.exit(0 if rc == 2 and not bad else 1)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_render_table_equals_reference(served):
    packed, port = served
    resp = client.request("127.0.0.1", port, {
        "queries": [{"title": "self q", "seq": decode(packed.seq_codes(0))},
            {"title": "q2", "seq": "MKVLAAGIVGLLLAWWHHKQPRST"}],
        "align": True})
    assert "error" not in resp
    for lengths in (None, {"self q": 9, "q2": 24}):
        text = client.render_table(resp, lengths)
        assert text == j_render_table(resp, lengths)
        assert "E-value" in text and "Identities = " in text
    no_e = {"results": [{"query": "x", "hits": [
        {"rank": 1, "score": 40, "title": "t"}]}]}
    assert client.render_table(no_e) == j_render_table(no_e)


def test_query_table_output(served, qfasta, capsys):
    _, port = served
    assert main(["query", "-q", str(qfasta),
                 "--server", f"127.0.0.1:{port}"]) == 0
    out = capsys.readouterr()
    assert out.out.count("Query: ") == 2
    assert "E-value" in out.out and "(34 aa)" in out.out
    assert "GCUPS" in out.err


def test_query_m8_json_and_top_k(served, qfasta, capsys):
    _, port = served
    assert main(["query", "-q", str(qfasta), "-r", "2", "--format", "m8",
                 "--server", f"127.0.0.1:{port}"]) == 0
    rows = [x for x in capsys.readouterr().out.splitlines() if x]
    assert len(rows) == 4 and all(len(r.split("\t")) == 12 for r in rows)
    assert main(["query", "-q", str(qfasta), "--format", "json",
                 "--server", f"127.0.0.1:{port}"]) == 0
    resp = json.loads(capsys.readouterr().out)
    assert len(resp["results"]) == 2 and resp["metrics"]["n_queries"] == 2
    assert [r["query"] for r in resp["results"]] == [
        q.title for q in synth_queries(2, [34, 52], seed=32)]


def test_query_align_blocks(served, tmp_path, capsys):
    packed, port = served
    codes = packed.seq_codes(0)
    path = tmp_path / "self.fasta"
    write_fasta(path, [FastaRecord("selfq", codes)])
    assert main(["query", "-q", str(path), "-r", "1", "--align",
                 "--server", f"127.0.0.1:{port}"]) == 0
    out = capsys.readouterr().out
    assert f"Identities = {len(codes)}/{len(codes)} (100%)" in out
    assert "Query      1 " in out and "Sbjct      1 " in out


def test_query_cmds_and_errors(served, qfasta, capsys):
    packed, port = served
    assert main(["query", "--cmd", "ping",
                 "--server", f"127.0.0.1:{port}"]) == 0
    assert json.loads(capsys.readouterr().out)["ok"] is True
    assert main(["query", "--cmd", "info",
                 "--server", f"127.0.0.1:{port}"]) == 0
    info = json.loads(capsys.readouterr().out)["info"]
    assert info["n_seqs"] == packed.n_seqs and info["device"] == "cpu"
    assert main(["query", "--server", f"127.0.0.1:{port}"]) == 2
    assert "required" in capsys.readouterr().err
    assert main(["query", "-q", str(qfasta), "--server", "nonsense"]) == 2
    assert "HOST:PORT" in capsys.readouterr().err
    assert main(["query", "-q", str(qfasta), "-r", "0",
                 "--server", f"127.0.0.1:{port}"]) == 2
    assert "(bad_request)" in capsys.readouterr().err
