"""The generators: deterministic per seed, the same work for every seed,
the canonical lengths exact, and a FASTA the port's parser reads back."""

import json
from pathlib import Path

import numpy as np
import pytest

from swbench import dbgen, workload

BENCH = Path(__file__).resolve().parents[1]
DB = {"n_seqs": 3000, "median_len": 300, "sigma": 0.55, "min_len": 20,
      "max_len": 6000, "homolog_frac": 0.01, "homolog_sub_rate": [0.05, 0.4],
      "homolog_indel_rate": 0.02, "V": 128}


def mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def test_canonical_lengths_are_exact():
    t = workload.make(mix("canonical20"), seed=123, seconds=20)
    lens = [len(q) for q in t.queries]
    assert lens == [144, 189, 222, 375, 464, 567, 657, 729, 850, 1000, 1500,
                    2005, 2504, 3005, 3564, 4061, 4548, 4743, 5147, 5478]
    assert sum(lens) == 41752
    long = sum(n for n in lens if n > 2048)
    assert round(long / sum(lens), 3) == 0.792
    assert t.due is None


@pytest.mark.parametrize("name", ["canonical20", "serve_poisson"])
def test_traffic_is_deterministic_per_seed(name):
    a = workload.make(mix(name), seed=2 ** 31 + 11, seconds=20)
    b = workload.make(mix(name), seed=2 ** 31 + 11, seconds=20)
    c = workload.make(mix(name), seed=5, seconds=20)
    assert all(np.array_equal(x, y) for x, y in zip(a.queries, b.queries))
    assert not all(np.array_equal(x, y) for x, y in zip(a.queries, c.queries))
    assert sorted(a.lengths) == sorted(c.lengths)
    if a.due is not None:
        assert np.array_equal(a.due, b.due)


def test_open_loop_schedule():
    m = mix("serve_poisson")
    rate = m["arrivals"]["poisson_rate"]
    a = workload.make(m, seed=1, seconds=20)
    c = workload.make(m, seed=2, seconds=20)
    assert len(a.due) == round(rate * 20)
    assert a.due[0] == 0 and a.due[-1] < 20 and np.all(np.diff(a.due) > 0)
    # the same gaps, in another order (but for the one after the last)
    ga, gc = np.sort(np.diff(a.due)), np.sort(np.diff(c.due))
    assert np.isin(np.round(ga, 9), np.round(gc, 9)).sum() >= len(ga) - 1
    assert np.isclose(np.diff(a.due).sum(), np.diff(c.due).sum(), rtol=0.05)
    assert 250 <= np.median(a.lengths) <= 350
    assert a.request == {"top_k": 16, "format": "json", "align": False}


def test_the_replayed_schedule_is_the_typical_one():
    """The served mix replays the schedule that the traffic alone picks
    (sweep.typical_schedule at the benchmark's run_seconds), not one
    chosen with the program's latencies."""
    from swbench.sweep import typical_schedule
    seconds = json.loads((BENCH.parent / "BENCHMARK.json").read_text())[
        "run_seconds"]
    m = mix("serve_poisson")
    got = typical_schedule(m, seconds)
    assert got["schedule_seed"] == m["schedule_seed"]
    assert got["distance"] < 0.02


def test_db_is_deterministic_and_seed_changes_only_order_and_residues():
    qs = [dbgen.random_letters(np.random.default_rng(0), n) for n in (50, 90)]
    a = dbgen.make_db(DB, qs, seed=9)
    b = dbgen.make_db(DB, qs, seed=9)
    c = dbgen.make_db(DB, qs, seed=10)
    assert np.array_equal(a.letters, b.letters)
    assert np.array_equal(a.starts, b.starts)
    assert not np.array_equal(a.letters[:1000], c.letters[:1000])
    assert a.n_seqs == c.n_seqs == 3000
    assert len(a.homologs) == 30
    random_a = np.delete(a.lengths, a.homologs)
    random_c = np.delete(c.lengths, c.homologs)
    base = dbgen.lognormal_lengths(3000, 300, 0.55, 20, 6000)
    assert set(random_a) <= set(base) and set(random_c) <= set(base)
    assert 280 <= np.median(base) <= 320
    assert set(np.unique(a.letters)) <= set(dbgen.LETTERS)


def test_residue_frequencies_follow_the_table():
    got = dbgen.random_letters(np.random.default_rng(1), 400_000)
    freq = np.array([(got == c).mean() for c in dbgen.LETTERS])
    assert np.allclose(freq, dbgen.AA_FREQ, atol=0.002)


def test_fasta_reads_back_through_the_port(tmp_path):
    from swimm_tpu_torch.alphabet import encode
    from swimm_tpu_torch.fasta import read_fasta
    qs = [dbgen.random_letters(np.random.default_rng(0), 60)]
    db = dbgen.make_db({**DB, "n_seqs": 200, "homolog_frac": 0.05}, qs, 3)
    dbgen.write_fasta(db, tmp_path / "db.fasta")
    recs = read_fasta(str(tmp_path / "db.fasta"))
    assert len(recs) == 200
    for i in (0, 7, int(db.homologs[0]), 199):
        assert recs[i].title == dbgen.title(i)
        assert dbgen.orig_index(recs[i].title) == i
        assert np.array_equal(recs[i].codes, encode(db.seq(i).tobytes()))
    with pytest.raises(ValueError):
        dbgen.orig_index("Q0001")
