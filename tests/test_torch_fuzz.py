"""swimm_tpu_torch.benchmarks.fuzz against the JAX package's
benchmarks/fuzz_tpu.py and scorers, on the CPU (device='cpu': the plain
versions).

- draw_round reproduces fuzz_tpu.main's draws for seeds 0-2 at 12 rounds:
  fuzz_tpu.main runs with its two scorers replaced by recorders that return
  swimm_tpu.ops.cref's answer (so no Pallas kernel runs; nothing under
  benchmarks/ or swimm_tpu/ changes), and every round's matrix, gaps,
  ceiling, query, codes and profile equal the port's draw.
- run_round on hand-built draws (each matrix, flat and free gaps, a
  one-residue query, a long query on one 32-position block, each
  adversarial lane kind alone, both ceilings): every route equal to
  swimm_tpu.ops.xla_scorer.score_chunk (the ceiling applied with
  np.minimum, as the script does) and to swimm_tpu.ops.cref.
- a scorer that is off by one makes main print FAIL and return 1.
- fuzz_packed at small sizes passes, its hits equal to swimm_tpu's search.

Tolerance 0 throughout: the same int32 scores."""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import swimm_tpu.models.profile as jprofile
from swimm_tpu.db import build_db as j_build_db
from swimm_tpu.fasta import FastaRecord as JRecord
from swimm_tpu.matrices import get_matrix as j_get_matrix
from swimm_tpu.models import engine as jengine
from swimm_tpu.ops import cref as jcref
from swimm_tpu.ops import longquery as jlongquery
from swimm_tpu.ops import pallas_scorer as jpallas
from swimm_tpu.ops import xla_scorer
from swimm_tpu_torch.alphabet import PAD_CODE
from swimm_tpu_torch.benchmarks import fuzz
from swimm_tpu_torch.models.profile import build_query_profile
from swimm_tpu_torch.ops import longquery, scorer
from swimm_tpu_torch.utils.synth import random_codes
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]


def _lanes(codes):
    """The sequences of a (B, L, V) code block, lane by lane: each lane's
    codes before its first PAD."""
    B, L, V = codes.shape
    out = []
    for b in range(B):
        for v in range(V):
            lane = codes[b, :, v]
            n = int(np.argmax(lane == PAD_CODE)) if (lane == PAD_CODE).any() \
                else L
            out.append(lane[:n].astype(np.uint8))
    return out


def _reference_rounds(seed, monkeypatch, capsys):
    """fuzz_tpu.main --rounds 12 --seed seed with recording scorers: one
    dict a round (matrix, query, codes, qp, gaps, ceiling)."""
    spec = importlib.util.spec_from_file_location(
        "jax_fuzz_tpu", REPO / "benchmarks/fuzz_tpu.py")
    jfuzz = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jfuzz)
    profiles, calls = [], []
    real_profile = jprofile.build_query_profile

    def profile(query, matrix, m_multiple=16):
        profiles.append((np.asarray(query), matrix))
        return real_profile(query, matrix, m_multiple=m_multiple)

    def record(codes, qp, go, ge, ceiling=None):
        codes = np.asarray(codes)
        query, matrix = profiles[-1]
        calls.append({"codes": codes, "qp": np.asarray(qp), "go": go,
                      "ge": ge, "ceiling": ceiling, "query": query,
                      "matrix": matrix})
        exp = jcref.sw_score_many(query, _lanes(codes), j_get_matrix(matrix),
                                  go, ge).reshape(codes.shape[0],
                                                  codes.shape[2])
        return exp if ceiling is None else np.minimum(exp, ceiling)

    monkeypatch.setattr(jprofile, "build_query_profile", profile)
    monkeypatch.setattr(jpallas, "score_chunk", record)
    monkeypatch.setattr(jlongquery, "score_chunk_long",
                        lambda codes, qp, go, ge: record(codes, qp, go, ge))
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["fuzz_tpu.py", "--rounds", "12",
                                      "--seed", str(seed)])
    assert jfuzz.main() == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"fuzz": "PASS", "rounds": 12, "failures": 0}
    return calls


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_draw_round_reproduces_fuzz_tpu_draws(seed, monkeypatch, capsys):
    calls = _reference_rounds(seed, monkeypatch, capsys)
    assert len(calls) == 12
    rng = np.random.default_rng(seed)
    for ref in calls:
        d = fuzz.draw_round(rng)
        assert d.matrix == ref["matrix"]
        assert (d.gap_open, d.gap_extend) == (ref["go"], ref["ge"])
        assert d.ceiling == ref["ceiling"]
        np.testing.assert_array_equal(d.query, ref["query"])
        assert d.codes.dtype == ref["codes"].dtype
        np.testing.assert_array_equal(d.codes, ref["codes"])
        np.testing.assert_array_equal(
            build_query_profile(d.query, d.matrix, m_multiple=8), ref["qp"])
        assert [len(s) for s in d.seqs] == [len(s) for s in
                                            _lanes(ref["codes"])]


KINDS = ("one", "full", "ambiguity", "homolog", "random")


def _draw(matrix="BLOSUM62", go=10, ge=2, qlen=40, L=64, n_blocks=1,
          ceiling=None, kinds=KINDS, seed=0):
    """A hand-built round: lane k of kind kinds[k % len(kinds)]."""
    rng = np.random.default_rng(seed)
    query = random_codes(rng, qlen)
    seqs = []
    for k in range(n_blocks * fuzz.V):
        kind = kinds[k % len(kinds)]
        if kind == "one":
            s = random_codes(rng, 1)
        elif kind == "full":
            s = random_codes(rng, L)
        elif kind == "ambiguity":
            s = rng.integers(20, 24, size=int(rng.integers(5, L + 1))
                             ).astype(np.uint8)
        elif kind == "homolog":
            s = query[:min(qlen, L)].copy()
        else:
            s = random_codes(rng, int(rng.integers(1, L + 1)))
        seqs.append(s)
    return fuzz.Draw(matrix, go, ge, query, seqs,
                     fuzz.lay_out(seqs, n_blocks, L), ceiling)


CASES = ([{"matrix": m} for m in fuzz.MATRICES]
         + [{"go": 0, "ge": 0}, {"go": 0, "ge": 8}, {"go": 20, "ge": 0}]
         + [{"qlen": 1}, {"qlen": 2049 + 7, "L": 32, "matrix": "PAM30"}]
         + [{"kinds": (k,)} for k in KINDS]
         + [{"ceiling": 127, "matrix": "PAM30", "n_blocks": 2},
            {"ceiling": 32767}])


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}={v if k != 'kinds' else v[0]}" for k, v in c.items()))
def test_run_round_routes_equal_jax(case):
    d = _draw(**case)
    res = fuzz.run_round(d, "cpu", np.random.default_rng([0, 1]))
    assert res["mismatch"] is None
    routes = res["routes"]
    assert list(routes) == (["k5", "k2", "k3"] if d.long
                            else ["k4", "k1", "k3", "ladder"])
    mat = j_get_matrix(d.matrix)
    B = d.codes.shape[0]
    exact = jcref.sw_score_many(d.query, d.seqs, mat, d.gap_open,
                                d.gap_extend).reshape(B, fuzz.V)
    qp = jprofile.build_query_profile(d.query, d.matrix, m_multiple=8)
    xla = np.asarray(xla_scorer.score_chunk(
        jnp.asarray(d.codes), jnp.asarray(qp), d.gap_open, d.gap_extend))
    np.testing.assert_array_equal(xla, exact)
    capped = xla if d.ceiling is None else np.minimum(xla, d.ceiling)
    for name in ("k4", "k1", "k5", "k2"):
        if name in routes:
            want = capped if name in ("k4", "k1") else xla
            np.testing.assert_array_equal(routes[name], want)
    if "ladder" in routes:
        np.testing.assert_array_equal(routes["ladder"], xla)
    assert 2 <= len(res["pack"]) <= 6
    for q, plane in zip(res["pack"], routes["k3"]):
        np.testing.assert_array_equal(plane, jcref.sw_score_many(
            q, d.seqs, mat, d.gap_open, d.gap_extend).reshape(B, fuzz.V))


def test_ragged_stream_cuts_each_block_to_its_longest_lane():
    seqs = [random_codes(np.random.default_rng(k), n) for k, n in
            enumerate([1] * 128 + [33] + [2] * 127 + [96] * 128)]
    d = fuzz.Draw("BLOSUM62", 10, 2, seqs[0], seqs,
                  fuzz.lay_out(seqs, 3, 128), None)
    tiles, outrow, n_rows = fuzz.ragged_stream(d)
    assert n_rows == 3 and tiles.shape == (1 + 2 + 3, 32, fuzz.V)
    assert outrow.tolist() == [0, 1, 1, 2, 2, 2]
    np.testing.assert_array_equal(tiles[1:3].reshape(64, fuzz.V),
                                  d.codes[1, :64])


@pytest.mark.parametrize("module, name, oks, route", [
    (scorer, "score_chunk", [True, False], "round 1 route k4 block 0"),
    (scorer, "score_tiles_packed", [False, False],
     "round 0 route k3 query 0 block 0"),
    (longquery, "score_chunk_long", [False, True],
     "round 0 route k5 block 0")])
def test_a_wrong_scorer_fails_the_fuzz(module, name, oks, route, monkeypatch,
                                       capsys):
    """An off-by-one scorer (seed 0: round 0 is long, round 1 short)."""
    real = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: real(*a, **k) + 1)
    assert fuzz.main(["--device", "cpu", "--rounds", "2", "--seed", "0"]) == 1
    out, err = capsys.readouterr()
    lines = [json.loads(x) for x in out.strip().splitlines()]
    assert [x["ok"] for x in lines[:2]] == oks
    assert lines[-1] == {"fuzz": "FAIL", "rounds": 2,
                         "failures": oks.count(False)}
    assert f"MISMATCH seed 0 {route} lane 0" in err


def test_main_without_a_card_raises(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fuzz.main(["--rounds", "1"])


def test_fuzz_packed_small_equals_jax_search(tmp_path, capsys):
    rounds = fuzz.fuzz_packed(2, 0, "cpu", n_seqs=300, max_queries=4,
                              max_qlen=60)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"fuzz_packed": "PASS", "rounds": 2,
                                "failures": 0}
    pj = j_build_db(fuzz.packed_world(0, 300), tmp_path / "j", V=fuzz.V,
                    use_native=False)
    for r in rounds:
        assert r["ok"]
        jq = [JRecord(q.title, q.codes) for q in r["queries"]]
        ref, _ = jengine.search(pj, jq, jengine.SearchConfig(
            top_k=8, backend="xla"))
        want = [[(h.score, h.sorted_idx, h.title) for h in x.hits]
                for x in ref]
        for got in (r["per_query"], r["packed"]):
            assert [[(h.score, h.sorted_idx, h.title) for h in x.hits]
                    for x in got] == want
