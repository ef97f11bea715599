"""The measurement entry points of swimm_tpu_torch on the CPU
(device='cpu': the plain scorers) at small sizes, against the JAX package:
swimm_tpu_torch.bench (the headline bench.py) and
swimm_tpu_torch.benchmarks.bench_kernel, bench_serving, bench_longquery,
bench_swissprot, bench_evalue and bench_ladder (benchmarks/bench_*.py).

Each module builds the same inputs as the reference script at the same
seeds (FASTA, packed DB and query set byte for byte); its hits, scores,
E-values and cells equal swimm_tpu's (backend 'xla') on the same DB;
bench_kernel's chained total equals the reference's JAX chain on
xla_scorer.score_chunk. Each JSON line's keys equal the reference's for
the same flags, written below as literal lists from the reference's
source. The headline's extras run on the CPU when asked: a zero wall
budget skips them with the reference's keys, and an extra that raises
propagates out of main with no JSON line (ROADMAP Queue 3, divergences
kept on purpose). Every entry point raises without a card unless given
the CPU.

Tolerance 0 throughout: the same bytes, int32 scores, hit lists and
E-values."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from swimm_tpu.db import build_db as j_build_db
from swimm_tpu.db import load_db as j_load_db
from swimm_tpu.fasta import FastaRecord as JRecord
from swimm_tpu.models import engine as jengine
from swimm_tpu.models.profile import build_query_profile as j_profile
from swimm_tpu.ops import xla_scorer
from swimm_tpu.utils import synth as jsynth
from swimm_tpu_torch import bench
from swimm_tpu_torch import benchmarks as tb
from swimm_tpu_torch.benchmarks import (bench_evalue, bench_kernel,
                                        bench_ladder, bench_longquery,
                                        bench_serving, bench_swissprot)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_SEQS = 26        # the cached DB's sequences: one block, at most 807 aa
N_QUERIES = 1

# keys of the reference's JSON lines (bench.py and benchmarks/bench_*.py)
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline",
              "seq_scores_per_sec_M", "resident_reps", "bench_wall_s"]
BENCH_LADDER_KEYS = ["ladder_gcups", "ladder_frac_of_resident"]
BENCH_STREAM_KEYS = ["stream_gcups", "stream_frac_of_resident",
                     "stream_seconds"]
BENCH_SKIPPED_KEYS = ["ladder_skipped", "mfu_skipped", "stream_skipped"]
KERNEL_KEYS = ["metric", "value", "unit", "vs_baseline"]
SP_DB_KEYS = ["phase", "n_seqs", "synth_s", "total_residues", "db_build_s",
              "tile_stream_mb"]
SP_RESIDENT_KEYS = ["phase", "gcups_real", "seq_scores_per_sec_M",
                    "seconds", "exact"]
SP_STREAM_KEYS = ["phase", "window_tiles", "max_in_flight", "gcups_real",
                  "seq_scores_per_sec_M", "seconds", "exact"]
SP_RESTREAM_KEYS = ["phase", "queries", "gcups_real", "seconds"]
SP_SUMMARY_KEYS = ["metric", "resident_gcups", "resident_Mseqscores_per_s",
                   "stream_best_gcups", "stream_best_cfg",
                   "stream_vs_resident_pct"]
EVALUE_SUMMARY_KEYS = ["plain", "evalue", "top_hit_evalue",
                       "evalue_overhead_frac"]
LADDER_KEYS = ["adaptive", "ladder", "hits_equal", "ladder_vs_adaptive",
               "meets_085x_bar"]


def _hits(results):
    return [[(h.rank, h.score, h.sorted_idx, h.orig_idx, h.title, h.evalue,
              h.bits) for h in r.hits] for r in results]


def _jq(queries):
    return [JRecord(q.title, q.codes) for q in queries]


def _jsearch(jdb, queries, **cfg):
    return jengine.search(jdb, _jq(queries),
                          jengine.SearchConfig(top_k=16, backend="xla", **cfg))


def _same_dir(a, b):
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    """bench_swissprot.run at N_SEQS and N_QUERIES: builds the cached DB
    that the headline, bench_evalue and bench_ladder then load; the JAX
    package's view of the same pack and its search of the same queries."""
    root = tmp_path_factory.mktemp("bench_root")
    lines, world = bench_swissprot.run("cpu", n_seqs=N_SEQS,
                                       n_queries=N_QUERIES, reps=1,
                                       root=root)
    jdb = j_load_db(tb.bench_db_dir(N_SEQS, root) / "db")
    ref, jmet = _jsearch(jdb, world["queries"])
    return {"root": root, "lines": lines, "world": world, "jdb": jdb,
            "ref": ref, "jmet": jmet}


def test_bench_inputs_are_the_reference_bytes(tmp_path):
    """bench_queries and bench_db against bench.py's own steps in
    swimm_tpu (2,000 sequences: one planted homolog)."""
    queries = tb.bench_queries(4)
    rng = np.random.default_rng(0)
    jqueries = jsynth.synth_queries(4, list(rng.integers(100, 501, size=4)),
                                    seed=1)
    assert [(q.title, q.codes.tobytes()) for q in queries] == [
        (q.title, q.codes.tobytes()) for q in jqueries]
    packed, made = tb.bench_db(2000, queries, tmp_path / "port")
    assert set(made) == {"synth_s", "total_residues", "db_build_s"}
    jdir = tmp_path / "jax"
    jdir.mkdir()
    total = jsynth.synth_fasta_fast(jdir / "sp.fasta", 2000, seed=2,
                                    queries=[q.codes for q in jqueries],
                                    homolog_frac=0.0005)
    j_build_db(str(jdir / "sp.fasta"), jdir / "db", V=128)
    port = tb.bench_db_dir(2000, tmp_path / "port")
    assert made["total_residues"] == total == packed.total_residues
    assert (port / "sp.fasta").read_bytes() == (jdir / "sp.fasta").read_bytes()
    _same_dir(port / "db", jdir / "db")
    assert sum("planted_homolog" in t for t in packed.titles) == 1
    again, made = tb.bench_db(2000, queries, tmp_path / "port")
    assert made == {} and again.titles == packed.titles


def test_bench_swissprot_equals_jax(sp):
    lines, world = sp["lines"], sp["world"]
    assert [sorted(x) for x in lines] == [
        sorted(SP_DB_KEYS), sorted(SP_RESIDENT_KEYS), sorted(SP_STREAM_KEYS),
        sorted(SP_RESTREAM_KEYS), sorted(SP_SUMMARY_KEYS)]
    assert lines[0]["n_seqs"] == N_SEQS
    assert lines[2]["window_tiles"] == 256 and lines[4]["stream_best_cfg"] \
        == [256, 2]
    assert "cpu (no card)" in lines[4]["metric"]
    for results, met in (world["resident"], *world["stream"]):
        assert _hits(results) == _hits(sp["ref"])
        assert met.cells == sp["jmet"].cells
    q0 = world["queries"][0]
    exp = jengine.score_db(sp["jdb"], JRecord(q0.title, q0.codes),
                           jengine.SearchConfig(backend="xla"))
    assert np.array_equal(world["restream"], exp)


def test_bench_headline_equals_jax(sp):
    out, world = bench.run("cpu", n_seqs=N_SEQS, n_queries=N_QUERIES,
                           reps=1, root=sp["root"])
    assert sorted(out) == sorted(BENCH_KEYS)
    assert out["resident_reps"] == 1 and out["unit"] == "GCUPS"
    assert "cpu (no card)" in out["metric"]
    assert _hits(world["results"]) == _hits(sp["ref"])
    assert world["metrics"].cells == sp["jmet"].cells
    # CPU tensors take the plain versions: no kernel is launched
    assert set(world["launches"].values()) == {0}
    assert set(world["launches"]) == {
        "sw_ragged_kernel", "sw_ragged_qtile_kernel",
        "sw_ragged_packed_kernel", "sw_chunk_kernel",
        "sw_chunk_qtile_kernel"}


def test_bench_extras_on_the_cpu_equal_the_resident_hits(sp):
    out, world = bench.run("cpu", n_seqs=N_SEQS, n_queries=N_QUERIES,
                           reps=1, extras=True, root=sp["root"])
    assert sorted(out) == sorted(BENCH_KEYS + BENCH_LADDER_KEYS
                                 + BENCH_STREAM_KEYS)
    for name in ("ladder", "stream"):
        results, met = world[name]
        assert _hits(results) == _hits(sp["ref"])
        assert met.cells == sp["jmet"].cells


def test_bench_zero_budget_skips_every_extra(sp, monkeypatch):
    monkeypatch.setenv("SWTPU_BENCH_BUDGET_S", "0")
    out, world = bench.run("cpu", n_seqs=N_SEQS, n_queries=N_QUERIES,
                           extras=True, mfu=True, root=sp["root"])
    assert sorted(out) == sorted(BENCH_KEYS + BENCH_SKIPPED_KEYS)
    assert {out[k] for k in BENCH_SKIPPED_KEYS} == {"wall budget"}
    assert out["resident_reps"] == 1          # no second run past budget
    assert _hits(world["results"]) == _hits(sp["ref"])


def test_bench_failing_extra_exits_nonzero_without_a_line(sp, monkeypatch,
                                                          capsys):
    """The divergence kept on purpose: the reference writes ladder_error
    and exits 0; here the extra's exception leaves main."""
    real = bench.search

    def faulty(packed, queries, config, device=None):
        if config.precision == "ladder":
            raise RuntimeError("ladder tier launch failed")
        return real(packed, queries, config, device=device)

    monkeypatch.setattr(bench, "search", faulty)
    monkeypatch.setattr(bench, "CPU_N_SEQS", N_SEQS)
    monkeypatch.setattr(bench, "CPU_N_QUERIES", N_QUERIES)
    monkeypatch.setattr(tb, "REPO", sp["root"])
    monkeypatch.setattr(bench, "run", functools.partial(
        bench.run, reps=1, extras=True))
    with pytest.raises(RuntimeError, match="ladder tier launch failed"):
        bench.main(["--device", "cpu"])
    assert capsys.readouterr().out == ""


def test_bench_main_prints_one_line(sp, monkeypatch, capsys):
    monkeypatch.setattr(bench, "CPU_N_SEQS", N_SEQS)
    monkeypatch.setattr(bench, "CPU_N_QUERIES", N_QUERIES)
    monkeypatch.setattr(tb, "REPO", sp["root"])
    assert bench.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and sorted(json.loads(out[0])) == sorted(BENCH_KEYS)
    assert json.loads(out[0])["resident_reps"] == 3


def test_bench_kernel_chain_equals_the_jax_chain():
    out, total = bench_kernel.run("cpu")
    assert sorted(out) == sorted(KERNEL_KEYS)
    # the reference's chain, on swimm_tpu's XLA scorer
    rng = np.random.default_rng(0)
    query = jsynth.random_codes(rng, 144)
    qp = jnp.asarray(j_profile(query, "BLOSUM62", m_multiple=16))
    codes = jnp.asarray(rng.integers(0, 20, size=(2, 64, 16),
                                     dtype=np.int8))

    def body(carry, _):
        c2 = codes ^ (carry % 2).astype(jnp.int8)
        return xla_scorer.score_chunk(c2, qp, 10, 2).sum().astype(
            jnp.int32), None

    ref, _ = jax.lax.scan(body, jnp.zeros((), jnp.int32), None, length=2)
    assert total == int(ref)
    q, qp_t, codes_t = bench_kernel.chain_inputs((2, 64, 16), "cpu")
    assert np.array_equal(q, query)
    assert np.array_equal(codes_t.numpy(), np.asarray(codes))
    assert np.array_equal(qp_t.numpy(), np.asarray(qp))


def test_bench_serving_equals_jax(tmp_path, capsys):
    world = bench_serving.run("cpu", n_seqs=N_SEQS, n_queries=N_QUERIES,
                              reps=1)
    printed = capsys.readouterr().out
    for head in ("steady:", "  real GCUPS:", "  seq-scores/s:",
                 "  top hit q0:"):
        assert any(x.startswith(head) for x in printed.splitlines()), head
    queries = world["queries"]
    recs = jsynth.synth_db(N_SEQS, seed=2, queries=[q.codes for q in queries],
                           homolog_frac=0.001)
    jdb = j_build_db(recs, tmp_path / "j", V=128, use_native=False)
    assert world["packed"].titles == jdb.titles
    for a, b in zip(world["packed"].chunks, jdb.chunks):
        assert np.array_equal(a.codes, b.codes)
    ref, jmet = _jsearch(jdb, queries, query_pack=True)
    assert _hits(world["results"]) == _hits(ref)
    assert world["metrics"].cells == jmet.cells


def test_bench_longquery_equals_jax(tmp_path, capsys):
    world = bench_longquery.run("cpu", n_seqs=2, qlen=2064, reps=1)
    assert "steady:" in capsys.readouterr().out
    q, = world["queries"]
    jq, = jsynth.synth_queries(1, [2064], seed=3)
    assert q.title == jq.title and np.array_equal(q.codes, jq.codes)
    recs = jsynth.synth_db(2, seed=4, queries=[jq.codes],
                           homolog_frac=0.0005)
    jdb = j_build_db(recs, tmp_path / "j", V=128, use_native=False)
    assert world["packed"].titles == jdb.titles
    ref, jmet = _jsearch(jdb, [q])
    assert _hits(world["results"]) == _hits(ref)
    assert world["metrics"].cells == jmet.cells


def test_bench_evalue_equals_jax(sp, capsys):
    summary, world = bench_evalue.run("cpu", n_seqs=N_SEQS,
                                      n_queries=N_QUERIES, reps=1,
                                      root=sp["root"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [sorted(x) for x in lines[:2]] == [["gcups", "phase", "seconds"]
                                              ] * 2
    assert lines[2] == summary and sorted(summary["summary"]) == sorted(
        EVALUE_SUMMARY_KEYS)
    assert _hits(world["plain"][0]) == _hits(sp["ref"])
    eref, jmet = _jsearch(sp["jdb"], world["queries"], evalue=True)
    assert _hits(world["evalue"][0]) == _hits(eref)
    assert summary["summary"]["top_hit_evalue"] == eref[0].hits[0].evalue
    assert world["evalue"][1].cells == jmet.cells


def test_bench_ladder_equals_jax(sp, capsys):
    out, world = bench_ladder.run("cpu", n_seqs=N_SEQS, n_queries=N_QUERIES,
                                  reps=1, root=sp["root"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [list(x) for x in lines[:2]] == [["adaptive"], ["ladder"]]
    assert sorted(lines[0]["adaptive"]) == ["gcups", "seconds", "warm_s"]
    assert lines[2] == out and sorted(out) == sorted(LADDER_KEYS)
    assert out["hits_equal"] is True
    for name in ("adaptive", "ladder"):
        assert _hits(world[name][0]) == _hits(sp["ref"])


@pytest.mark.parametrize("module,line", [
    (bench_evalue, {"error": "no cached DB at {}; run python -m "
                    "swimm_tpu_torch.benchmarks.bench_swissprot first"}),
    (bench_ladder, None)])
def test_missing_cache_exits_1(module, line, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tb, "REPO", tmp_path)
    assert module.main(["--device", "cpu"]) == 1
    out, err = capsys.readouterr()
    if line is None:
        assert out == "" and "bench_swissprot first" in err
    else:
        dbdir = tmp_path / ".bench_sp_torch_1500" / "db"
        assert json.loads(out) == {"error": line["error"].format(dbdir)}


@pytest.mark.parametrize("main", [
    bench.main, bench_kernel.main, bench_serving.main, bench_longquery.main,
    bench_swissprot.main, bench_evalue.main, bench_ladder.main],
    ids=["bench", "bench_kernel", "bench_serving", "bench_longquery",
         "bench_swissprot", "bench_evalue", "bench_ladder"])
def test_entry_point_without_a_card_raises(main, tmp_path, monkeypatch):
    monkeypatch.setattr(tb, "REPO", tmp_path)
    with pytest.raises(RuntimeError, match="CUDA device"):
        main([])
    assert list(tmp_path.iterdir()) == []
