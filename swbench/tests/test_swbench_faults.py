"""The comparison fails what it should: a whole run (the look for a card
skipped, the rest as on the card, at a CPU size) with the timed path broken
underneath reads ``correct`` false, once for each fault a cell can have;
a sound run reads true; and the controls (the reference in the program's
place at a lower precision, or with the tie order broken) fail too."""

import json
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

from swbench import check, dbgen, workload
from swbench.tests.conftest import TINY, run_cell

ROOT = Path(__file__).resolve().parents[2]


def _altered(real):
    """An answer altered where it is produced: one hit's score + 1."""
    def search(packed, queries, config=None, device=None):
        results, met = real(packed, queries, config, device=device)
        results[-1].hits[0].score += 1
        return results, met
    return search


def _half(real):
    """Half of the batch left out: the second half of each search's
    queries (the one query of a search of one) answered from the first
    half, or with no hits where the first half is empty."""
    def search(packed, queries, config=None, device=None):
        results, met = real(packed, queries, config, device=device)
        keep = len(results) // 2
        return [r if i < keep else
                (results[i % keep] if keep else replace(r, hits=[]))
                for i, r in enumerate(results)], met
    return search


def _stale(real):
    """A step that returns its state unchanged: each search answers with
    the previous search's results."""
    prev = []

    def search(packed, queries, config=None, device=None):
        results, met = real(packed, queries, config, device=device)
        out = prev[-1] if prev and len(prev[-1]) == len(results) else None
        prev.append(results)
        return (out if out is not None else
                [results[(i + 1) % len(results)]
                 for i in range(len(results))]), met
    return search


FAULTS = {"altered": _altered, "half": _half, "stale": _stale}
CASES = [("sp_canonical20", "altered"), ("sp_canonical20", "half"),
         ("sp_serve_poisson", "altered"), ("sp_serve_poisson", "half"),
         ("sp_serve_poisson", "stale")]


@pytest.mark.parametrize("cell", ["sp_canonical20", "sp_serve_poisson"])
def test_a_sound_run_is_correct(cell, capsys):
    rc, out = run_cell(capsys, cell, seed=2 ** 31 + 5)
    assert rc == 0 and out["correct"] is True, out
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "check"
    assert all(v["value"] == 0 for v in out["check"].values())


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_is_not_correct(cell, fault, capsys,
                                            monkeypatch):
    from swimm_tpu_torch.models import engine
    monkeypatch.setattr(engine, "search", FAULTS[fault](engine.search))
    rc, out = run_cell(capsys, cell, seed=11)
    assert rc == 0 and out["correct"] is False, out["check"]


def test_a_search_that_skips_part_of_the_database_is_not_correct(
        capsys, monkeypatch):
    """A search that leaves out every other sequence that is not a planted
    homolog keeps every homolog and every score it reports right. Only the
    query scored against the whole database shows it (the sample is cut
    to no sequence here, so nothing else can), in each cell."""
    from swimm_tpu_torch.models import engine
    made = []
    make_db = dbgen.make_db

    def recording(*a, **kw):
        made.append(make_db(*a, **kw))
        return made[-1]

    def skipping(real):
        def search(packed, queries, config=None, device=None):
            whole = replace(config, top_k=packed.n_seqs)
            results, met = real(packed, queries, whole, device=device)
            hom = set(made[-1].homologs.tolist())
            kept = [replace(r, hits=[h for h in r.hits if
                                     dbgen.orig_index(h.title) in hom
                                     or dbgen.orig_index(h.title) % 2 == 0]
                            [:config.top_k]) for r in results]
            return kept, met
        return search

    monkeypatch.setattr(dbgen, "make_db", recording)
    monkeypatch.setattr(check, "SAMPLE", 0)
    monkeypatch.setattr(engine, "search", skipping(engine.search))
    for cell in ("sp_canonical20", "sp_serve_poisson"):
        rc, out = run_cell(capsys, cell, seed=13)
        assert rc == 0 and out["correct"] is False, out["check"]
        assert out["check"]["missed_hits"]["value"] > 0
        assert out["check"]["score_mismatches"]["value"] == 0


def _cell_data(cell, seed):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = next(x for x in bench["workloads"] if x["name"] == cell)
    from swbench.run import _merge
    cfg = _merge(json.loads((ROOT / "swbench" / "configs" /
                             f"{w['config']}.json").read_text()),
                 TINY[cell]["config"])
    mix = _merge(json.loads((ROOT / "swbench" / "traffic" /
                             f"{w['traffic']}.json").read_text()),
                 TINY[cell]["traffic"])
    traffic = workload.make(mix, seed, 2.0)
    return cfg, traffic, dbgen.make_db(cfg["db"], traffic.queries, seed)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("control", ["int8", "reverse_ties"])
def test_controls_are_not_correct(control, seed):
    cfg, traffic, db = _cell_data("sp_canonical20", seed)
    s = cfg["search"]
    qs = range(len(traffic.queries))
    kw = ({"ceiling": 127} if control == "int8" else {"reverse_ties": True})
    ans = check.control_answers(traffic.queries, db, s["top_k"],
                                s["gap_open"], s["gap_extend"], seed,
                                qs, **kw)
    counts = check.judge(ans, traffic.queries, db, s["top_k"], s["gap_open"],
                         s["gap_extend"], seed)
    assert any(counts[n] > lim for n, lim in check.LIMITS.items()), counts
    exact = check.control_answers(traffic.queries, db, s["top_k"],
                                  s["gap_open"], s["gap_extend"], seed,
                                  qs)
    counts = check.judge(exact, traffic.queries, db, s["top_k"],
                         s["gap_open"], s["gap_extend"], seed)
    assert all(v == 0 for v in counts.values()), counts


def test_the_int16_control_is_exact_below_its_ceiling():
    """No score of these data reaches 32,767, so saturating 16-bit lanes
    give the exact answer: that control cannot fail, and the cell's
    precision control is the 8-bit one (PERF.md)."""
    cfg, traffic, db = _cell_data("sp_canonical20", 4)
    s = cfg["search"]
    ans = check.control_answers(traffic.queries, db, s["top_k"],
                                s["gap_open"], s["gap_extend"], 4,
                                range(len(traffic.queries)), ceiling=32767)
    counts = check.judge(ans, traffic.queries, db, s["top_k"], s["gap_open"],
                         s["gap_extend"], 4)
    assert all(v == 0 for v in counts.values())
    assert max(sc for _, hits in ans for sc, _ in hits) < 32767
