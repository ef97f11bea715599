"""swimm_tpu_torch.benchmarks.acceptance on the CPU (device='cpu': the
plain versions) at small sizes, against the JAX package (backend 'xla').

The five configs run through acceptance.run, every row exact; their
results equal swimm_tpu's on the same sequences and queries: search
(configs 1-3), score_db (config 1's whole vector), sharded_search over
swimm_tpu's 8-device mesh (config 4) and the serial f32 search the ladder
is held to (config 5). spot_oracle_check returns False on a planted wrong
hit score and on a hit list that a sampled sequence out-scores.

Tolerance 0 throughout: the same int32 scores and hit lists."""

import dataclasses

import numpy as np
import pytest

from swimm_tpu.db import build_db as j_build_db
from swimm_tpu.fasta import FastaRecord as JRecord
from swimm_tpu.models import engine as jengine
from swimm_tpu.parallel import mesh as jmesh
from swimm_tpu.parallel import sharded_search as jsharded
from swimm_tpu_torch.benchmarks import acceptance
from swimm_tpu_torch.matrices import get_matrix
from swimm_tpu_torch.ops import cref
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SIZES = {"c1": {"n_seqs": 300}, "c2": {"n_seqs": 200, "n_queries": 2},
         "c3": {"n_seqs": 20, "qlen": 2100, "homolog_frac": 0.05}}


def _hits(results):
    return [[(h.rank, h.score, h.sorted_idx, h.orig_idx, h.title)
             for h in r.hits] for r in results]


def _jq(queries):
    return [JRecord(q.title, q.codes) for q in queries]


@pytest.fixture(scope="module")
def accepted(tmp_path_factory):
    """acceptance.run at SIZES, and swimm_tpu's packed DBs of each
    config's sequences."""
    rows, out, where = acceptance.run("cpu", **SIZES)
    d = tmp_path_factory.mktemp("jacc")
    jdbs = {n: j_build_db(out[n]["recs"], d / str(n), V=128,
                          use_native=False) for n in (1, 2, 3)}
    return rows, out, where, jdbs


def test_every_row_is_exact(accepted):
    rows, _, where, _ = accepted
    assert where == "cpu (no card)"
    assert [r.config for r in rows] == [
        "1: 144aa vs 300-seq", "2: 2 queries vs 200-seq",
        "3: 2100aa long query", "4: sharded + collective top-k",
        "5: precision ladder == exact"]
    assert [r.exact for r in rows] == [True] * 5
    assert rows[3].scale == "1-cpu mesh"


@pytest.mark.parametrize("n", [1, 2, 3])
def test_search_equals_jax(accepted, n):
    _, out, _, jdbs = accepted
    assert out[n]["packed"].n_seqs == jdbs[n].n_seqs
    ref, _ = jengine.search(jdbs[n], _jq(out[n]["queries"]),
                            jengine.SearchConfig(top_k=16, backend="xla"))
    assert _hits(out[n]["results"]) == _hits(ref)


def test_config3_top_hit_is_the_planted_homolog(accepted):
    _, out, _, _ = accepted
    top = out[3]["results"][0].hits[0]
    assert top.score > 127 and "planted_homolog" in top.title


def test_score_db_equals_jax_and_the_oracle(accepted):
    _, out, _, jdbs = accepted
    q = out[1]["queries"][0]
    ref = jengine.score_db(jdbs[1], JRecord(q.title, q.codes),
                           jengine.SearchConfig(precision="f32",
                                                backend="xla"))
    np.testing.assert_array_equal(out[1]["scores"], np.asarray(ref))
    recs, packed = out[1]["recs"], out[1]["packed"]
    np.testing.assert_array_equal(out[1]["scores"], cref.sw_score_many(
        q.codes, [recs[i].codes for i in packed.orig_index],
        get_matrix("BLOSUM62"), 10, 2))


def test_sharded_and_ladder_equal_jax(accepted):
    _, out, _, jdbs = accepted
    jq = _jq(out[1]["queries"])
    cfg = jengine.SearchConfig(top_k=16, precision="f32", backend="xla")
    serial, _ = jengine.search(jdbs[1], jq, cfg)
    shard, _ = jsharded.sharded_search(jdbs[1], jq, cfg,
                                       mesh=jmesh.make_mesh())
    assert _hits(shard) == _hits(serial)
    for name in ("serial", "sharded", "ladder"):
        assert _hits(out[4][name]) == _hits(serial)


def test_spot_oracle_check_catches_a_wrong_hit(accepted):
    _, out, _, _ = accepted
    c2 = out[2]
    args = (c2["packed"], c2["recs"], c2["queries"])
    assert acceptance.spot_oracle_check(*args, c2["results"])
    res = c2["results"][0]
    wrong = dataclasses.replace(res, hits=[dataclasses.replace(
        res.hits[3], score=res.hits[3].score + 1) if i == 3 else h
        for i, h in enumerate(res.hits)])
    assert not acceptance.spot_oracle_check(*args, [wrong]
                                            + c2["results"][1:])


def test_spot_oracle_check_catches_a_better_sampled_sequence(accepted):
    """The 16 lowest-scoring sequences reported as the hits, each with its
    exact score: the sample holds sequences that out-score the k-th."""
    _, out, _, _ = accepted
    c2 = out[2]
    packed, recs, q = c2["packed"], c2["recs"], c2["queries"][0]
    exact = cref.sw_score_many(
        q.codes, [recs[i].codes for i in packed.orig_index],
        get_matrix("BLOSUM62"), 10, 2)
    worst = np.argsort(exact, kind="stable")[:16][::-1]
    res = c2["results"][0]
    low = dataclasses.replace(res, hits=[dataclasses.replace(
        res.hits[0], score=int(exact[i]), sorted_idx=int(i))
        for i in worst])
    assert not acceptance.spot_oracle_check(packed, recs, [q], [low])


def test_main_without_a_card_raises(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        acceptance.main([])
