"""swimm_tpu_torch E-value statistics against swimm_tpu's: the copied fit
(utils/stats.py) field for field on the same arrays, the device histogram
(engine.score_hist, one torch.bincount) against hist_from_scores (one-hot
matmuls) on the same lane scores, search(evalue=True) hits, E-values and
bit scores against swimm_tpu.search(backend='xla', evalue=True), and the
CLI flags. Tolerance 0 throughout: both packages run the same float64
numpy fit on the same integer table, so every float is bit-identical."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swimm_tpu.db import build_db as j_build_db
from swimm_tpu.fasta import FastaRecord as JRecord
from swimm_tpu.models import engine as jengine
from swimm_tpu.utils import stats as jstats
from swimm_tpu_torch import SearchConfig, build_db, search
from swimm_tpu_torch.fasta import FastaRecord, write_fasta
from swimm_tpu_torch.models import engine
from swimm_tpu_torch.ops.lanes import select_mode
from swimm_tpu_torch.utils import stats
from swimm_tpu_torch.utils.synth import random_codes, synth_db, synth_queries
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _gumbel(rng, n, a=5.0, b=8.0, beta=4.0):
    lengths = rng.integers(40, 2000, size=n)
    return (np.round(a + b * np.log(lengths) + rng.gumbel(0.0, beta, n)),
            lengths)


def _fields(model):
    return (model.a, model.b, model.mu, model.beta, model.n_db,
            model.n_censored, model.n_iters)


def _table(ids, scores):
    hist = np.zeros((stats.N_LEN_BINS, stats.SCORE_CAP + 1))
    np.add.at(hist, (ids, np.clip(scores, 0, stats.SCORE_CAP).astype(int)),
              1.0)
    return hist


def test_constants_match_jax():
    assert (stats.N_LEN_BINS, stats.SCORE_CAP) == (jstats.N_LEN_BINS,
                                                   jstats.SCORE_CAP)


@pytest.mark.parametrize("n,planted,max_iters", [(6000, 0, 10),
                                                 (4000, 80, 10),
                                                 (300, 12, 3), (8, 0, 10)])
def test_fit_evalue_model_matches_jax(n, planted, max_iters):
    rng = np.random.default_rng(n + planted)
    scores, lengths = _gumbel(rng, n)
    scores[:planted] += 400.0
    got = stats.fit_evalue_model(scores, lengths, max_iters)
    ref = jstats.fit_evalue_model(scores, lengths, max_iters)
    assert _fields(got) == _fields(ref)
    probe_s, probe_l = np.arange(0, 600, 7.0), np.linspace(1, 5000, 86)
    for fn in ("surprise", "pvalue", "evalue"):
        assert np.array_equal(getattr(got, fn)(probe_s, probe_l),
                              getattr(ref, fn)(probe_s, probe_l))


@pytest.mark.parametrize("seed", [13, 14])
def test_length_bins_and_hist_fit_match_jax(seed):
    rng = np.random.default_rng(seed)
    scores, lengths = _gumbel(rng, 5000)
    ids, centers = stats.length_bins(lengths)
    j_ids, j_centers = jstats.length_bins(lengths)
    assert np.array_equal(ids, j_ids) and np.array_equal(centers, j_centers)
    hist = _table(ids, scores)
    assert _fields(stats.fit_evalue_model_hist(hist, centers)) == _fields(
        jstats.fit_evalue_model_hist(hist, j_centers))
    mask = rng.random(7000) < 0.9
    l2s = rng.integers(0, 5000, 7000).astype(np.int32)
    assert np.array_equal(stats.lane_bin_map(mask, l2s, lengths),
                          jstats.lane_bin_map(mask, l2s, lengths))


def test_hist_fit_saturation_and_input_errors_match_jax():
    rng = np.random.default_rng(17)
    lengths = rng.integers(40, 2000, size=4000)
    scores = np.round(600 + 80 * np.log(lengths) + rng.gumbel(0, 40, 4000))
    ids, centers = stats.length_bins(lengths)
    for mod in (stats, jstats):
        with pytest.raises(ValueError, match="saturated"):
            mod.fit_evalue_model_hist(_table(ids, scores), centers)
        with pytest.raises(ValueError, match=">= 8"):
            mod.fit_evalue_model(np.arange(4), np.arange(4) + 30)
        with pytest.raises(ValueError, match="scores"):
            mod.fit_evalue_model(np.arange(20), np.arange(10) + 30)
        with pytest.raises(ValueError, match=">= 8"):
            mod.fit_evalue_model_hist(np.zeros((32, 512)), centers)


def test_attach_evalues_matches_jax():
    rng = np.random.default_rng(19)
    scores, lengths = _gumbel(rng, 2000)
    model = stats.fit_evalue_model(scores, lengths)
    jmodel = jstats.fit_evalue_model(scores, lengths)
    idx = rng.integers(0, 2000, 12)
    hits = [engine.Hit(r + 1, int(scores[i]), int(i), int(i), "t")
            for r, i in enumerate(idx)]
    jhits = [jengine.Hit(r + 1, int(scores[i]), int(i), int(i), "t")
             for r, i in enumerate(idx)]
    stats.attach_evalues(hits, model, lengths)
    jstats.attach_evalues(jhits, jmodel, lengths)
    assert [(h.evalue, h.bits) for h in hits] == [(h.evalue, h.bits)
                                                  for h in jhits]


@pytest.mark.parametrize("n,V,top,seed", [(3000, 8, 700, 21),
                                          (20000, 128, 511, 22),
                                          (16384, 16, 2000, 23)])
def test_score_hist_matches_hist_from_scores(n, V, top, seed):
    # the same lane scores (some past the table edge), bin ids and pad
    # lanes through both: the port's bincount against the reference's
    # one-hot matmuls, table for table, then model for model
    rng = np.random.default_rng(seed)
    lengths = rng.integers(20, 3000, n)
    lanes = -(-n // V) * V + V
    mask = np.zeros(lanes, bool)
    mask[:n] = True
    rng.shuffle(mask)
    l2s = np.where(mask, np.cumsum(mask) - 1, 0).astype(np.int32)
    scores = rng.integers(0, top, lanes).astype(np.int32)
    bins = stats.lane_bin_map(mask, l2s, lengths)
    got = engine.score_hist(torch.from_numpy(scores), torch.from_numpy(mask),
                            torch.from_numpy(bins)).numpy()
    ref = np.asarray(jengine.hist_from_scores(
        jnp.asarray(scores), jnp.asarray(bins),
        jnp.asarray(mask.astype(np.float32)), stats.N_LEN_BINS,
        stats.SCORE_CAP + 1))
    assert got.shape == ref.shape == (stats.N_LEN_BINS, stats.SCORE_CAP + 1)
    assert np.array_equal(got, ref)
    assert got.sum() == n
    _, centers = stats.length_bins(lengths)
    fits = []
    for table, mod in ((got, stats), (ref, jstats)):
        try:
            fits.append(_fields(mod.fit_evalue_model_hist(table, centers)))
        except ValueError as exc:          # saturated: both must say so
            fits.append(str(exc))
    assert fits[0] == fits[1]


@pytest.fixture(scope="module")
def evalue_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("evalue")
    queries = synth_queries(3, [64, 120, 300], seed=91)
    recs = synth_db(400, seed=92, median_len=120, sigma=0.6, max_len=700,
                    queries=[queries[0].codes], homolog_frac=0.01)
    return (build_db(recs, tmp / "t", V=16),
            j_build_db(recs, tmp / "j", V=16, use_native=False), queries)


def _hits(results):
    return [[(h.rank, h.score, h.sorted_idx, h.orig_idx, h.title, h.evalue,
              h.bits) for h in r.hits] for r in results]


def _jsearch(packed_j, queries, **cfg):
    return jengine.search(packed_j, [JRecord(q.title, q.codes)
                                     for q in queries],
                          jengine.SearchConfig(backend="xla", **cfg))[0]


@pytest.mark.parametrize("top_k", [8, 400])
def test_search_evalue_matches_jax(evalue_world, top_k):
    pt, pj, queries = evalue_world
    got, _ = search(pt, queries, SearchConfig(top_k=top_k, evalue=True),
                    device="cpu")
    ref = _jsearch(pj, queries, top_k=top_k, evalue=True)
    assert _hits(got) == _hits(ref)
    assert all(h.evalue is not None and h.bits is not None
               for r in got for h in r.hits)
    assert [r.as_table() for r in got] == [r.as_table() for r in ref]
    assert "E-value" in got[0].as_table()
    plain, _ = search(pt, queries, SearchConfig(top_k=top_k), device="cpu")
    assert [[(h.score, h.sorted_idx) for h in r.hits] for r in plain] == \
           [[(h.score, h.sorted_idx) for h in r.hits] for r in got]
    assert all(h.evalue is None for r in plain for h in r.hits)
    assert "E-value" not in plain[0].as_table()


def test_search_evalue_long_query_matches_jax(tmp_path):
    # a query over 2,048 padded rows takes the query-tiled path
    # ('tiles_long'); its histogram is taken there too
    rng = np.random.default_rng(31)
    long_q = FastaRecord("long", random_codes(rng, 2050))
    recs = synth_db(40, seed=32, median_len=50, max_len=90)
    pt = build_db(recs, tmp_path / "t", V=8)
    pj = j_build_db(recs, tmp_path / "j", V=8, use_native=False)
    assert select_mode(2064) == "tiles_long"
    got, _ = search(pt, [long_q], SearchConfig(top_k=6, evalue=True),
                    device="cpu")
    assert _hits(got) == _hits(_jsearch(pj, [long_q], top_k=6, evalue=True))


def test_device_lane_bins_cached_and_counted(evalue_world):
    pt, _, _ = evalue_world
    bins = engine.device_lane_bins(pt, "cpu")
    assert bins is engine.device_lane_bins(pt, "cpu")
    assert bins.dtype == torch.int32
    mask, l2s = pt.lane_maps()
    assert np.array_equal(bins.numpy(),
                          stats.lane_bin_map(mask, l2s, pt.lengths))
    assert (engine.device_bytes_needed(pt, evalue=True)
            - engine.device_bytes_needed(pt)) == 4 * mask.size


def _cli_world(tmp_path):
    queries = synth_queries(1, [50], seed=95)
    recs = synth_db(80, seed=96, median_len=60, sigma=0.4, max_len=150,
                    queries=[queries[0].codes], homolog_frac=0.1)
    write_fasta(tmp_path / "db.fa", recs)
    write_fasta(tmp_path / "q.fa", queries)
    return tmp_path


def test_cli_evalue_and_max_evalue_match_jax(tmp_path, capsys):
    from swimm_tpu.cli import main as jmain
    from swimm_tpu_torch.cli import main
    d = _cli_world(tmp_path)
    for fn, out in ((main, "t"), (jmain, "j")):
        assert fn(["preprocess", "-i", str(d / "db.fa"), "-o",
                   str(d / out), "--lanes", "8"]) == 0
    capsys.readouterr()

    def hits(fn, db, *extra):
        args = ["search", "-d", str(d / db), "-q", str(d / "q.fa"), "-r",
                "10", "--evalue", "--json", *extra]
        args += ["--device", "cpu"] if fn is main else ["--backend", "xla"]
        assert fn(args) == 0
        return json.loads(capsys.readouterr().out)["results"][0]["hits"]

    every = hits(main, "t")
    assert every == hits(jmain, "j")
    assert all("evalue" in h for h in every)
    cut = sorted(h["evalue"] for h in every)[len(every) // 2]
    kept = hits(main, "t", "--max-evalue", str(cut))
    assert kept == hits(jmain, "j", "--max-evalue", str(cut))
    assert [h["rank"] for h in kept] == list(range(1, len(kept) + 1))
    assert 0 < len(kept) < len(every)
    assert main(["search", "-d", str(d / "t"), "-q", str(d / "q.fa"),
                 "--evalue", "--device", "cpu"]) == 0
    table = capsys.readouterr().out
    assert "E-value" in table
    assert main(["search", "-d", str(d / "t"), "-q", str(d / "q.fa"),
                 "--device", "cpu", "--json"]) == 0
    plain = json.loads(capsys.readouterr().out)["results"][0]["hits"]
    assert all("evalue" not in h for h in plain)


@pytest.mark.parametrize("extra,msg", [
    (["--max-evalue", "1"], "add --evalue"),
    (["--evalue", "--max-evalue", "0"], "must be positive"),
    (["--evalue", "--query-pack"], "does not combine with --query-pack")])
def test_cli_evalue_errors(tmp_path, capsys, extra, msg):
    from swimm_tpu_torch.cli import main
    d = _cli_world(tmp_path)
    assert main(["preprocess", "-i", str(d / "db.fa"), "-o", str(d / "t"),
                 "--lanes", "8"]) == 0
    capsys.readouterr()
    assert main(["search", "-d", str(d / "t"), "-q", str(d / "q.fa"),
                 "--device", "cpu", *extra]) == 2
    assert msg in capsys.readouterr().err
