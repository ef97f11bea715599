"""swimm_tpu_torch.search (device='cpu': the plain PyTorch scorers) against
swimm_tpu.search (xla backend): identical hit lists — scores, sorted
indices, titles and tie order — for queries up to and over 2048 padded
rows, plus the package's import hygiene and device rule."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from swimm_tpu.db import build_db as j_build_db
from swimm_tpu.fasta import FastaRecord as JRecord
from swimm_tpu.models import engine as jengine
from swimm_tpu.models.stream import dispatched_rows as j_rows
from swimm_tpu.models.stream import select_mode as j_mode
from swimm_tpu.utils.synth import mutate
from swimm_tpu_torch import SearchConfig, build_db, search
from swimm_tpu_torch.fasta import FastaRecord
from swimm_tpu_torch.models import engine
from swimm_tpu_torch.utils.synth import random_codes, synth_db

REPO = Path(__file__).resolve().parent.parent


def _hits(results):
    return [[(h.rank, h.score, h.sorted_idx, h.orig_idx, h.title)
             for h in r.hits] for r in results]


def _compare(packed_t, packed_j, queries, top_k=8, **cfg):
    got, gm = search(packed_t, queries, SearchConfig(top_k=top_k, **cfg),
                     device="cpu")
    jq = [JRecord(q.title, q.codes) for q in queries]
    ref, jm = jengine.search(packed_j, jq, jengine.SearchConfig(
        top_k=top_k, backend="xla", **cfg))
    assert _hits(got) == _hits(ref)
    assert [r.as_table() for r in got] == [r.as_table() for r in ref]
    assert gm.cells == jm.cells
    return got, gm


def _db(tmp_path, recs, V=8):
    return (build_db(recs, tmp_path / "t", V=V),
            j_build_db(recs, tmp_path / "j", V=V, use_native=False))


def test_search_matches_jax_short_queries(tmp_path):
    rng = np.random.default_rng(21)
    queries = [FastaRecord(f"q{i}", random_codes(rng, n))
               for i, n in enumerate((30, 45, 17))]
    recs = synth_db(240, seed=9, queries=[q.codes for q in queries],
                    median_len=60, max_len=200, homolog_frac=0.05)
    pt, pj = _db(tmp_path, recs)
    got, metrics = _compare(pt, pj, queries, gap_open=10, gap_extend=2)
    assert all(r.hits[0].title.endswith("planted_homolog") for r in got)
    lanes = sum(ch.n_blocks * ch.L * ch.V for ch in pt.chunks)
    assert metrics.padded_cells == lanes * sum(
        j_rows(j_mode("pallas", m), m) for m in (32, 48, 32))


def test_search_matches_jax_long_query(tmp_path):
    # a 2050-aa query pads to 2064 rows > 2048: mode tiles_long, 3 query
    # tiles of 1024 rows; padded cells count what that mode dispatches
    rng = np.random.default_rng(22)
    long_q = FastaRecord("long", random_codes(rng, 2050))
    short_q = FastaRecord("short", random_codes(rng, 20))
    recs = synth_db(16, seed=3, median_len=40, max_len=64)
    recs[5] = FastaRecord("hom planted_homolog",
                          mutate(rng, long_q.codes[:60], 0.1, 0.0))
    pt, pj = _db(tmp_path, recs)
    assert engine.select_mode(2064) == j_mode("pallas", 2064) == "tiles_long"
    got, metrics = _compare(pt, pj, [long_q, short_q], top_k=4)
    assert got[0].hits[0].title == "hom planted_homolog"
    lanes = sum(ch.n_blocks * ch.L * ch.V for ch in pt.chunks)
    rows = j_rows("tiles_long", 2064) + j_rows("tiles", 32)
    assert rows == 3072 + 32
    assert metrics.padded_cells == lanes * rows


def test_search_ties_straddle_top_k(tmp_path):
    # duplicated sequences give equal scores across the k boundary; the
    # hit order must be (score desc, sorted index asc) exactly as the
    # JAX package's lax.top_k
    rng = np.random.default_rng(23)
    q = FastaRecord("q", random_codes(rng, 24))
    base = synth_db(6, seed=11, median_len=30, max_len=48)
    recs = [FastaRecord(f"dup{i}", base[i % 3].codes) for i in range(30)]
    recs += [FastaRecord("self", q.codes)]
    pt, pj = _db(tmp_path, recs)
    for k in (2, 5, 8, 40):
        got, _ = _compare(pt, pj, [q], top_k=k, gap_open=4, gap_extend=1)
        scores = [h.score for h in got[0].hits]
        assert len(scores) == min(k, len(recs))
        assert len(set(scores)) < len(scores) or k <= 2


def test_search_precisions_and_unported_postures(tmp_path):
    rng = np.random.default_rng(24)
    q = FastaRecord("q", random_codes(rng, 20))
    pt, pj = _db(tmp_path, synth_db(40, seed=12, median_len=40, max_len=80))
    for prec in ("f32", "int32"):
        _compare(pt, pj, [q], precision=prec)
    for kw in ({"precision": "ladder"}, {"query_pack": True},
               {"db_stream": True}, {"evalue": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            search(pt, [q], SearchConfig(**kw), device="cpu")


@pytest.mark.parametrize("kw", [{"gap_open": -1}, {"gap_extend": -2},
                                {"m_multiple": 12}, {"window_tiles": 0},
                                {"stream_scores": "x"},
                                {"evalue": True, "query_pack": True}])
def test_search_config_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        jengine.SearchConfig(**kw)
    with pytest.raises(ValueError):
        SearchConfig(**kw)


def test_device_top_k_breaks_ties_by_lowest_index():
    import torch
    scores = torch.tensor([5, 7, 7, 3, 7, 5, 9, 1], dtype=torch.int32)
    mask = torch.tensor([True] * 7 + [False])
    l2s = torch.arange(8, dtype=torch.int64) + 100
    v, si = engine.device_top_k(scores, mask, l2s, 6)
    assert v.tolist() == [9, 7, 7, 7, 5, 5]
    assert si.tolist() == [106, 101, 102, 104, 100, 105]
    v, si = engine.device_top_k(scores, mask, l2s, 8)
    assert v.tolist()[-1] == -1 and si.tolist()[-1] == 107


def test_package_imports_neither_jax_nor_swimm_tpu():
    code = ("import sys, swimm_tpu_torch, swimm_tpu_torch.cli, "
            "swimm_tpu_torch.models.engine, swimm_tpu_torch.ops.longquery, "
            "swimm_tpu_torch.ops._build\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'swimm_tpu' "
            "or m.startswith('swimm_tpu.'))\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_search_without_device_raises_when_cuda_absent(tmp_path,
                                                       monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(25)
    pt = build_db(synth_db(20, seed=1), tmp_path / "d", V=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        search(pt, [FastaRecord("q", random_codes(rng, 10))])


def test_cli_search_cpu(tmp_path, capsys):
    from swimm_tpu_torch.cli import main

    def run(*args):
        assert main([*args]) == 0
        return capsys.readouterr().out

    db, q, pdb = (str(tmp_path / n) for n in ("db.fasta", "q.fasta", "pdb"))
    run("synth", "-o", db, "-n", "60", "--seed", "3")
    run("synth", "-o", q, "-n", "2", "--seed", "4")
    run("preprocess", "-i", db, "-o", pdb, "--lanes", "8")
    out = run("search", "-d", pdb, "-q", q, "-r", "3", "--device", "cpu")
    assert out.count("Query: ") == 2 and "GCUPS" in out
    assert main(["search", "-d", pdb, "-q", q, "-s", "BLOSUM999",
                 "--device", "cpu"]) == 2
    # the module entry point, as a user runs it
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-m", "swimm_tpu_torch", "search",
                          "-d", pdb, "-q", q, "-r", "3", "--device", "cpu",
                          "--json"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    import json
    js = json.loads(res.stdout)
    assert [len(r["hits"]) for r in js["results"]] == [3, 3]


@pytest.mark.parametrize("k", [1, 4, 9, 200])
def test_host_top_k_and_lane_scatter_match_jax(tmp_path, k):
    recs = synth_db(70, seed=6, median_len=40, max_len=90)
    pt, pj = _db(tmp_path, recs)
    rng = np.random.default_rng(k)
    mask, _ = pt.lane_maps()
    flat = rng.integers(0, 6, size=mask.shape[0]).astype(np.int32)
    sc_t = engine.scatter_lane_scores(pt, flat)
    assert np.array_equal(sc_t, jengine.scatter_lane_scores(pj, flat))
    got = engine.top_k_hits(pt, sc_t, k)
    ref = jengine.top_k_hits(pj, sc_t, k)
    assert [(h.rank, h.score, h.sorted_idx, h.orig_idx, h.title)
            for h in got] == [(h.rank, h.score, h.sorted_idx, h.orig_idx,
                               h.title) for h in ref]
