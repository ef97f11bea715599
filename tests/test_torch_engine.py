"""swimm_tpu_torch.search (device='cpu': the plain PyTorch scorers) against
swimm_tpu.search (xla backend): identical hit lists — scores, sorted
indices, titles and tie order — for queries up to and over 2048 padded
rows, per query and packed (query_pack=True); score_db against
swimm_tpu.score_db; plus the package's import hygiene and device rule.
Tolerance 0 throughout: every path computes exact integers."""

import os
import runpy
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
from swimm_tpu_torch import SearchConfig, build_db, score_db, search
from swimm_tpu_torch.fasta import FastaRecord
from swimm_tpu_torch.models import engine, qpack
from swimm_tpu_torch.ops.lanes import select_mode
from swimm_tpu_torch.utils.synth import random_codes, synth_db
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

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
    # a 2050-aa query pads to 2064 rows > 2048: mode tiles_long, 2 query
    # tiles of 1024 rows and a last one of 16; padded cells count what that
    # mode dispatches: the port's 2,064 rows, where the JAX package walks
    # and counts 3,072
    rng = np.random.default_rng(22)
    long_q = FastaRecord("long", random_codes(rng, 2050))
    short_q = FastaRecord("short", random_codes(rng, 20))
    recs = synth_db(16, seed=3, median_len=40, max_len=64)
    recs[5] = FastaRecord("hom planted_homolog",
                          mutate(rng, long_q.codes[:60], 0.1, 0.0))
    pt, pj = _db(tmp_path, recs)
    assert select_mode(2064) == j_mode("pallas", 2064) == "tiles_long"
    got, metrics = _compare(pt, pj, [long_q, short_q], top_k=4)
    assert got[0].hits[0].title == "hom planted_homolog"
    lanes = sum(ch.n_blocks * ch.L * ch.V for ch in pt.chunks)
    assert j_rows("tiles_long", 2064) == 3072
    assert metrics.padded_cells == lanes * (2064 + 32)


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
    for prec in ("f32", "int32", "ladder"):
        _compare(pt, pj, [q], precision=prec)
    _compare(pt, pj, [q], evalue=True)
    for kw in ({"precision": "ladder"}, {"evalue": True},
               {"db_stream": True}, {"db_stream": True, "evalue": True}):
        engine.check_supported(SearchConfig(**kw))
    # every posture is ported; streaming refuses what swimm_tpu's does
    with pytest.raises(ValueError, match="query_pack"):
        search(pt, [q], SearchConfig(db_stream=True, query_pack=True),
               device="cpu")
    with pytest.raises(ValueError, match="ladder"):
        score_db(pt, q, SearchConfig(db_stream=True, precision="ladder"),
                 device="cpu")
    with pytest.raises(ValueError, match="unknown precision"):
        search(pt, [q], SearchConfig(precision="f16"), device="cpu")


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
    # one child interpreter: the only way to see what the package alone
    # imports. Its limit is generous because a fresh torch import on a
    # machine busy with other test workers can take minutes.
    code = ("import sys, swimm_tpu_torch, swimm_tpu_torch.cli, "
            "swimm_tpu_torch.models.engine, swimm_tpu_torch.models.qpack, "
            "swimm_tpu_torch.models.stream, "
            "swimm_tpu_torch.ops.scorer, swimm_tpu_torch.ops.longquery, "
            "swimm_tpu_torch.ops.ladder, swimm_tpu_torch.utils.stats, "
            "swimm_tpu_torch.ops._build, swimm_tpu_torch.server, "
            "swimm_tpu_torch.client, swimm_tpu_torch.formats, "
            "swimm_tpu_torch.native, swimm_tpu_torch._cc, "
            "swimm_tpu_torch.ops.cref, swimm_tpu_torch.ops.traceback, "
            "swimm_tpu_torch.ops.align, "
            "swimm_tpu_torch.parallel, swimm_tpu_torch.parallel.mesh, "
            "swimm_tpu_torch.parallel.sharded_search, "
            "swimm_tpu_torch.parallel.sharded_stream, "
            "swimm_tpu_torch.parallel.distributed, "
            "swimm_tpu_torch.benchmarks.roofline, "
            "swimm_tpu_torch.benchmarks.probe_narrow_int, "
            "swimm_tpu_torch.benchmarks.fuzz, "
            "swimm_tpu_torch.benchmarks.acceptance, "
            "swimm_tpu_torch.bench, "
            "swimm_tpu_torch.benchmarks.bench_kernel, "
            "swimm_tpu_torch.benchmarks.bench_serving, "
            "swimm_tpu_torch.benchmarks.bench_longquery, "
            "swimm_tpu_torch.benchmarks.bench_swissprot, "
            "swimm_tpu_torch.benchmarks.bench_evalue, "
            "swimm_tpu_torch.benchmarks.bench_ladder, "
            "swimm_tpu_torch.benchmarks.bench_serve, "
            "swimm_tpu_torch.benchmarks.bench_scaling\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'swimm_tpu' "
            "or m.startswith('swimm_tpu.') or m == 'benchmarks' "
            "or m.startswith('benchmarks.'))\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr


def test_search_without_device_raises_when_cuda_absent(tmp_path,
                                                       monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(25)
    pt = build_db(synth_db(20, seed=1), tmp_path / "d", V=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        search(pt, [FastaRecord("q", random_codes(rng, 10))])


def test_cli_search_cpu(tmp_path, capsys, monkeypatch):
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
    # the module entry point (python -m swimm_tpu_torch), driven in this
    # process: a child interpreter's start-up under a loaded test run has
    # no useful time limit
    import json
    packed_hits = None
    for flag in ("--no-query-pack", "--query-pack"):
        monkeypatch.setattr(sys, "argv", [
            "swimm_tpu_torch", "search", "-d", pdb, "-q", q, "-r", "3",
            "--device", "cpu", "--json", flag])
        with pytest.raises(SystemExit) as done:
            runpy.run_module("swimm_tpu_torch", run_name="__main__")
        assert done.value.code == 0
        js = json.loads(capsys.readouterr().out)
        assert [len(r["hits"]) for r in js["results"]] == [3, 3]
        assert packed_hits in (None, js["results"])
        packed_hits = js["results"]


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


def _mixed_db(tmp_path, queries, n=200, seed=31):
    recs = synth_db(n, seed=seed, queries=[q.codes for q in queries],
                    median_len=50, max_len=160, homolog_frac=0.05)
    return _db(tmp_path, recs)


def test_packed_search_matches_jax(tmp_path):
    # query_pack=True: one packed-scorer call per pack; hit lists equal the
    # JAX package's, and the padded cells count the packs' rows
    rng = np.random.default_rng(31)
    queries = [FastaRecord(f"q{i}", random_codes(rng, n))
               for i, n in enumerate((40, 16, 61, 24, 9, 33))]
    pt, pj = _mixed_db(tmp_path, queries)
    got, metrics = _compare(pt, pj, queries, query_pack=True)
    assert any(r.hits[0].title.endswith("planted_homolog") for r in got)
    packs = qpack.build_query_packs(queries)
    lanes = sum(ch.n_blocks * ch.L * ch.V for ch in pt.chunks)
    assert metrics.padded_cells == lanes * sum(p.M for p in packs)
    plain, _ = search(pt, queries, SearchConfig(top_k=8), device="cpu")
    assert _hits(plain) == _hits(got)


@pytest.mark.parametrize("k", [2, 5, 8, 40])
def test_packed_search_ties_straddle_top_k(tmp_path, k):
    rng = np.random.default_rng(32)
    qs = [FastaRecord("qa", random_codes(rng, 24)),
          FastaRecord("qb", random_codes(rng, 13))]
    base = synth_db(6, seed=11, median_len=30, max_len=48)
    recs = [FastaRecord(f"dup{i}", base[i % 3].codes) for i in range(30)]
    recs += [FastaRecord("self", qs[0].codes)]
    pt, pj = _db(tmp_path, recs)
    got, _ = _compare(pt, pj, qs, top_k=k, gap_open=4, gap_extend=1,
                      query_pack=True)
    for r in got:
        scores = [h.score for h in r.hits]
        assert len(scores) == min(k, len(recs))
        assert len(set(scores)) < len(scores) or k <= 2


def test_packed_search_overlong_query_takes_per_length_path(tmp_path):
    # one query that fits no pack sends the whole batch down the
    # per-length path, as in the JAX package: padded cells say which ran
    rng = np.random.default_rng(33)
    long_len = qpack.PACK_BUCKETS[-1]
    assert qpack._rows_needed(long_len) > qpack.PACK_BUCKETS[-1]
    queries = [FastaRecord("short", random_codes(rng, 20)),
               FastaRecord("overlong", random_codes(rng, long_len))]
    recs = synth_db(24, seed=5, median_len=40, max_len=64)
    pt, pj = _db(tmp_path, recs)
    _, metrics = _compare(pt, pj, queries, top_k=4, query_pack=True)
    lanes = sum(ch.n_blocks * ch.L * ch.V for ch in pt.chunks)
    assert metrics.padded_cells == lanes * (32 + long_len)


@pytest.mark.parametrize("qlen", [37, 2050])
def test_score_db_matches_jax(tmp_path, qlen):
    # the per-chunk API: one-pass chunk scorer for the short query, the
    # query-tiled one (3 tiles of 1024 rows) for the 2,050-aa query
    rng = np.random.default_rng(qlen)
    q = FastaRecord("q", random_codes(rng, qlen))
    recs = synth_db(40, seed=7, median_len=40, max_len=100)
    recs[9] = FastaRecord("hom planted_homolog",
                          mutate(rng, q.codes[:50], 0.1, 0.0))
    pt, pj = _db(tmp_path, recs)
    assert len(pt.chunks) > 1
    got = score_db(pt, q, SearchConfig(), device="cpu")
    ref = jengine.score_db(pj, JRecord(q.title, q.codes),
                           jengine.SearchConfig(backend="xla"))
    assert got.dtype == np.int32 and got.shape == (len(recs),)
    assert np.array_equal(got, ref)
    top = engine.top_k_hits(pt, got, 1)[0]
    assert top.title == "hom planted_homolog"


def test_device_chunks_are_views_of_the_stream(tmp_path):
    pt, _ = _db(tmp_path, synth_db(50, seed=8, median_len=40, max_len=120))
    tiles = engine.device_tiles(pt, "cpu")[0]
    chunks = engine.device_chunks(pt, "cpu")
    assert len(chunks) == len(pt.chunks)
    for dev, ch in zip(chunks, pt.chunks):
        assert dev.shape == (ch.n_blocks, ch.L, ch.V)
        assert np.array_equal(dev.numpy(), np.asarray(ch.codes))
    assert chunks[0].data_ptr() == tiles.data_ptr()
