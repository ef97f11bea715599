"""swimm_tpu_torch.ops.ladder (the adaptive-precision ladder on the plain
scorers' ceiling path) against swimm_tpu.ops.ladder (xla backend, or the
Pallas kernel in interpret mode where the JAX function has no other), in
scores, candidate hits and stats; search and score_db with
precision='ladder' against the exact search, with and without E-values and
with a query over 2,048 padded rows. Tolerance 0 throughout."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swimm_tpu.db import build_db as j_build_db
from swimm_tpu.fasta import FastaRecord as JRecord
from swimm_tpu.models import engine as jengine
from swimm_tpu.ops import ladder as jladder
from swimm_tpu_torch import SearchConfig, build_db, score_db, search
from swimm_tpu_torch.alphabet import PAD_CODE
from swimm_tpu_torch.fasta import FastaRecord
from swimm_tpu_torch.models import engine
from swimm_tpu_torch.models.profile import build_query_profile
from swimm_tpu_torch.ops import ladder, scorer
from swimm_tpu_torch.utils.synth import (mutate, random_codes, synth_db,
                                         synth_queries)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TIERS = [ladder.DEFAULT_TIERS, (30, 100, None), (20, 60, 200)]


def test_constants_and_bound_match_jax():
    assert (ladder.INT8_CEIL, ladder.INT16_CEIL, ladder.DEFAULT_TIERS) == (
        jladder.INT8_CEIL, jladder.INT16_CEIL, jladder.DEFAULT_TIERS)
    for q, s, mat in ((10, 100, "BLOSUM62"), (100, 10, "PAM250"),
                      (7, 7, "BLOSUM45")):
        assert ladder.max_possible_score(q, s, mat) == \
            jladder.max_possible_score(q, s, mat)


def _chunk_world(seed, with_homolog=True):
    rng = np.random.default_rng(seed)
    q = random_codes(rng, 120)
    B, L, V = 3, 160, 8
    codes = np.full((B, L, V), PAD_CODE, dtype=np.int8)
    for k in range(B * V):
        b, v = divmod(k, V)
        s = (mutate(rng, q, sub_rate=0.02, indel_rate=0.0)
             if with_homolog and k in (2, 9) else
             random_codes(rng, int(rng.integers(20, L))))
        codes[b, :min(len(s), L), v] = s[:L]
    return q, build_query_profile(q), codes


@pytest.mark.parametrize("homolog,tiers,upper", [
    (True, ladder.DEFAULT_TIERS, None), (False, ladder.DEFAULT_TIERS, None),
    (True, ladder.DEFAULT_TIERS, 100), (True, ladder.DEFAULT_TIERS, "valid"),
    (True, (30, 100, None), None), (True, (20, 60, 200), None)])
def test_score_chunk_adaptive_matches_jax(homolog, tiers, upper):
    q, qp, codes = _chunk_world(41, homolog)
    if upper == "valid":
        upper = ladder.max_possible_score(qp.shape[1], codes.shape[1])
    got, st = ladder.score_chunk_adaptive(
        torch.from_numpy(codes), torch.from_numpy(qp), 10, 2, tiers=tiers,
        upper_bound=upper)
    ref, jst = jladder.score_chunk_adaptive(codes, jnp.asarray(qp), 10, 2,
                                            tiers=tiers, backend="xla",
                                            upper_bound=upper)
    assert np.array_equal(got, ref) and st == jst
    if upper != 100:     # a bound below the scores may clamp, as in JAX
        assert np.array_equal(got, scorer.score_chunk(
            torch.from_numpy(codes), torch.from_numpy(qp), 10, 2).numpy())


@pytest.fixture(scope="module")
def ladder_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ladder")
    queries = synth_queries(4, [48, 48, 40, 100], seed=21)
    recs = synth_db(160, seed=22, median_len=50, sigma=0.5, max_len=160,
                    queries=[queries[0].codes, queries[3].codes],
                    homolog_frac=0.1)
    return (build_db(recs, tmp / "t", V=8),
            j_build_db(recs, tmp / "j", V=8, use_native=False), queries)


def _qps(queries, m_multiple=16):
    return np.stack([build_query_profile(q.codes, m_multiple=m_multiple)
                     for q in queries])


def _exact_lanes(pt, qp):
    tiles, outrow, n_rows, rs = engine.device_tiles(pt, "cpu")[:4]
    return scorer.score_tiles(tiles, outrow, n_rows, torch.from_numpy(qp),
                              10, 2, row_start=rs).numpy()


@pytest.mark.parametrize("qi,tiers", [(0, (30, 100, None)), (2, (30, 60))])
def test_score_db_adaptive_matches_jax_pallas(ladder_world, qi, tiers):
    pt, pj, queries = ladder_world
    q = queries[qi]
    qp = build_query_profile(q.codes, m_multiple=8)
    got, st = ladder.score_db_adaptive(pt, qp, q.length, 10, 2, tiers=tiers,
                                       device="cpu")
    ref, jst = jladder.score_db_adaptive(pj, jnp.asarray(qp), q.length, 10,
                                         2, tiers=tiers, interpret=True)
    assert np.array_equal(got, ref) and st == jst
    assert np.array_equal(got, _exact_lanes(pt, qp))
    if qi == 0:
        assert got.max() > tiers[0] and st["tier_blocks"][1] >= 1


@pytest.mark.parametrize("tiers", TIERS)
def test_score_db_adaptive_batch_matches_jax(ladder_world, tiers):
    pt, pj, queries = ladder_world
    qps = _qps(queries[:3])
    lens = [q.length for q in queries[:3]]
    got, st = ladder.score_db_adaptive_batch(pt, qps, lens, 10, 2,
                                             tiers=tiers, device="cpu")
    ref, jst = jladder.score_db_adaptive_batch(pj, qps, lens, 10, 2,
                                               tiers=tiers, backend="xla")
    assert np.array_equal(got, ref) and st == jst
    for i in range(3):
        assert np.array_equal(got[i], _exact_lanes(pt, qps[i]))
    assert st["tier_blocks"][1] >= 1


@pytest.mark.parametrize("k,tiers", [(5, ladder.DEFAULT_TIERS),
                                     (40, (30, 100, None)),
                                     (7, (20, 60, 200)), (5000, (30,))])
def test_topk_db_adaptive_batch_matches_jax(ladder_world, k, tiers):
    pt, pj, queries = ladder_world
    qps = _qps(queries[:3])
    lens = [q.length for q in queries[:3]]
    got, st = ladder.topk_db_adaptive_batch(pt, qps, lens, k, 10, 2,
                                            tiers=tiers, device="cpu")
    ref, jst = jladder.topk_db_adaptive_batch(pj, qps, lens, k, 10, 2,
                                              tiers=tiers, backend="xla")
    assert st == jst
    for (v, i), (jv, ji), qp in zip(got, ref, qps):
        assert np.array_equal(v, jv) and np.array_equal(i, ji)
        exact = [(h.score, h.sorted_idx) for h in engine.top_k_hits(
            pt, engine.scatter_lane_scores(pt, _exact_lanes(pt, qp)
                                           .reshape(-1)), k)]
        assert list(zip(v.tolist(), i.tolist())) == exact


def test_topk_db_adaptive_serving_groups_match_jax(ladder_world):
    # two padded-length groups in one call: the tiers truncate on the
    # whole batch's bound, so the stats depend on both groups together
    pt, pj, queries = ladder_world
    groups = [(_qps(queries[:3]), [q.length for q in queries[:3]]),
              (_qps(queries[3:]), [queries[3].length])]
    got, st = ladder.topk_db_adaptive_serving(pt, groups, 6, 10, 2,
                                              device="cpu")
    ref, jst = jladder.topk_db_adaptive_serving(pj, groups, 6, 10, 2,
                                                backend="xla")
    assert st == jst and len(st["tier_blocks"]) == 2
    for g, jg in zip(got, ref):
        for (v, i), (jv, ji) in zip(g, jg):
            assert np.array_equal(v, jv) and np.array_equal(i, ji)


def _hits(results):
    return [[(h.rank, h.score, h.sorted_idx, h.orig_idx, h.title, h.evalue,
              h.bits) for h in r.hits] for r in results]


@pytest.fixture(scope="module")
def long_world(tmp_path_factory):
    # a batch with one query over 2,048 padded rows (the ladder hands it
    # to the exact score_db) beside short ones with planted homologs
    tmp = tmp_path_factory.mktemp("ladder_long")
    rng = np.random.default_rng(51)
    queries = synth_queries(3, [40, 64, 100], seed=52)
    queries.insert(1, FastaRecord("long", random_codes(rng, 2050)))
    recs = synth_db(60, seed=53, median_len=50, sigma=0.4, max_len=120,
                    queries=[q.codes for q in queries[2:]],
                    homolog_frac=0.1)
    recs[7] = FastaRecord("hom planted_homolog",
                          mutate(rng, queries[1].codes[:90], 0.05, 0.0))
    return (build_db(recs, tmp / "t", V=8),
            j_build_db(recs, tmp / "j", V=8, use_native=False), queries)


@pytest.mark.parametrize("evalue", [False, True])
def test_search_ladder_matches_exact_and_jax(long_world, evalue):
    pt, pj, queries = long_world
    cfg = dict(top_k=6, evalue=evalue)
    got, gm = search(pt, queries, SearchConfig(precision="ladder", **cfg),
                     device="cpu")
    ref, jm = jengine.search(pj, [JRecord(q.title, q.codes) for q in queries],
                             jengine.SearchConfig(backend="xla",
                                                  precision="ladder", **cfg))
    assert _hits(got) == _hits(ref) and gm.cells == jm.cells
    assert got[1].hits[0].title == "hom planted_homolog"
    exact, _ = search(pt, queries, SearchConfig(top_k=6), device="cpu")
    assert [[(h.score, h.sorted_idx) for h in r.hits] for r in got] == \
           [[(h.score, h.sorted_idx) for h in r.hits] for r in exact]
    if evalue:   # the full-vector fit of the exact score_db vector
        from swimm_tpu_torch.utils import stats
        for q, r in zip(queries, got):
            model = stats.fit_evalue_model(
                score_db(pt, q, SearchConfig(), device="cpu"), pt.lengths)
            assert [h.evalue for h in r.hits] == [
                float(model.evalue(h.score, pt.lengths[h.sorted_idx]))
                for h in r.hits]
    else:        # padded rows: the groups' m_pad, the long query's too
        lanes = sum(ch.n_blocks * ch.L * ch.V for ch in pt.chunks)
        assert gm.padded_cells == lanes * (48 + 2064 + 64 + 112)


def test_search_fused_batch_ladder_only_long_queries(long_world):
    # a batch with no query for the ladder's tiers
    pt, _, queries = long_world
    got, rows = engine.search_fused_batch(
        pt, queries[1:2], SearchConfig(precision="ladder", top_k=4), "cpu")
    exact, _ = engine.search_fused_batch(pt, queries[1:2],
                                         SearchConfig(top_k=4), "cpu")
    assert [(h.score, h.sorted_idx) for h in got[0]] == \
           [(h.score, h.sorted_idx) for h in exact[0]] and rows == 2064
    # no group at all: no candidates (swimm_tpu raises IndexError here)
    assert ladder.topk_db_adaptive_serving(pt, [], 4, 10, 2,
                                           device="cpu")[0] == []


@pytest.mark.parametrize("qi", [0, 1, 3])
def test_score_db_ladder_matches_exact_and_jax(long_world, qi):
    pt, pj, queries = long_world
    q = queries[qi]
    got = score_db(pt, q, SearchConfig(precision="ladder"), device="cpu")
    assert np.array_equal(got, score_db(pt, q, SearchConfig(),
                                        device="cpu"))
    assert np.array_equal(got, jengine.score_db(
        pj, JRecord(q.title, q.codes),
        jengine.SearchConfig(backend="xla", precision="ladder")))


def test_ladder_launches_ceiling_tiers_then_the_exact_one(ladder_world,
                                                         monkeypatch):
    # the first tier runs with its ceiling over the whole stream, the next
    # over just the flagged blocks; no tier runs the full stream twice
    pt, _, queries = ladder_world
    seen = []
    real = scorer.score_tiles

    def spy(tiles, outrow, n_rows, qp, go, ge, **kw):
        seen.append((n_rows, kw.get("ceiling")))
        return real(tiles, outrow, n_rows, qp, go, ge, **kw)

    monkeypatch.setattr(scorer, "score_tiles", spy)
    q = queries[0]
    qp = build_query_profile(q.codes, m_multiple=16)
    got, st = ladder.score_db_adaptive(pt, qp, q.length, 10, 2,
                                       device="cpu")
    n_rows = engine.device_tiles(pt, "cpu")[2]
    assert seen == [(n_rows, 127), (st["tier_blocks"][1], None)]
    assert st["tier_ceilings"] == [127, None]
    assert np.array_equal(got, _exact_lanes(pt, qp))
    assert 0 < st["tier_blocks"][1] < n_rows


def test_cli_precision_ladder_matches_jax(tmp_path, capsys):
    import json

    from swimm_tpu.cli import main as jmain
    from swimm_tpu_torch.cli import main
    from swimm_tpu_torch.fasta import write_fasta
    queries = synth_queries(2, [50, 70], seed=61)
    write_fasta(tmp_path / "db.fa", synth_db(
        90, seed=62, median_len=60, sigma=0.4, max_len=150,
        queries=[q.codes for q in queries], homolog_frac=0.1))
    write_fasta(tmp_path / "q.fa", queries)
    for fn, out in ((main, "t"), (jmain, "j")):
        assert fn(["preprocess", "-i", str(tmp_path / "db.fa"), "-o",
                   str(tmp_path / out), "--lanes", "8"]) == 0
    capsys.readouterr()

    def results(fn, db, *extra):
        args = ["search", "-d", str(tmp_path / db), "-q",
                str(tmp_path / "q.fa"), "-r", "6", "--json", *extra]
        args += ["--device", "cpu"] if fn is main else ["--backend", "xla"]
        assert fn(args) == 0
        return json.loads(capsys.readouterr().out)["results"]

    ladder_r = results(main, "t", "--precision", "ladder")
    assert ladder_r == results(main, "t")
    assert ladder_r == results(jmain, "j", "--precision", "ladder")
    assert results(main, "t", "--precision", "ladder", "--evalue") == \
        results(jmain, "j", "--precision", "ladder", "--evalue")
    with pytest.raises(SystemExit):
        main(["search", "-d", str(tmp_path / "t"), "-q",
              str(tmp_path / "q.fa"), "--precision", "f16"])
