"""The m8 check of sp_serve_m8 (drivers/server_m8.py) fails what it should:
a whole run at a CPU size reads ``correct`` true with no row mismatch, and
false where the program's rows are altered (a start shifted by one, a gap
run miscounted); at the judge, rows of a path whose ties were broken the
other way (E before the diagonal) differ, missing rows count, and the
reference's own rows in the program's place read 0."""

import json

import numpy as np
import pytest

from swbench import align_reference, dbgen
from swbench.drivers import server_m8
from swbench.tests.conftest import run_cell

CELL = "sp_serve_m8"
TINY_M8 = {"config": {"db": {"n_seqs": 200, "homolog_frac": 0.05,
                             "median_len": 60, "max_len": 300}},
           "traffic": {"arrivals": {"poisson_rate": 4.0},
                       "queries": {"median_len": 25, "max_len": 50},
                       "check_sample": 6}}
#: pairs whose path meets a tie of the diagonal and E at 10/2
CO_OPTIMAL = [(b"AHESADKWSTGNSRLNCNVT", b"SMLDIHSADKSFTFGNSEEMCKNVTESS"),
              (b"ISNFEEQCRVQTTAGPVYEVIRDGVLN",
               b"NGWIFNFEMEMQCRVQKSGHFVYSFKDIVLFNRYY")]


def _shift_qstart(row):
    c = row.split("\t")
    c[6] = str(int(c[6]) + 1)
    return "\t".join(c)


def _extra_gap_open(row):
    c = row.split("\t")
    c[5] = str(int(c[5]) + 1)
    return "\t".join(c)


def test_a_sound_m8_run_is_correct(capsys):
    rc, out = run_cell(capsys, CELL, seed=2 ** 31 + 24, overrides=TINY_M8)
    assert rc == 0 and out["correct"] is True, out["check"]
    assert out["counters"]["m8_row_mismatches"] == 0
    assert out["counters"]["align_pairs"] > 0
    assert all(v["value"] == 0 for v in out["check"].values())


@pytest.mark.parametrize("fault", [_shift_qstart, _extra_gap_open])
def test_altered_m8_rows_are_not_correct(fault, capsys, monkeypatch):
    from swimm_tpu_torch import formats
    real = formats.m8_rows
    monkeypatch.setattr(formats, "m8_rows", lambda r, a: [
        fault(x) for x in real(r, a)])
    rc, out = run_cell(capsys, CELL, seed=24, overrides=TINY_M8)
    assert rc == 0 and out["correct"] is False
    assert out["counters"]["m8_row_mismatches"] > 0
    assert out["check"]["malformed_answers"]["value"] > 0


def _recs_and_db(rows_of):
    """One response per CO_OPTIMAL pair: the subject is database sequence
    k, the only hit; rows_of(k, counts) gives the response's rows."""
    queries = [np.frombuffer(q, np.uint8) for q, _ in CO_OPTIMAL]
    subs = [np.frombuffer(d, np.uint8) for _, d in CO_OPTIMAL]
    db = dbgen.Database(np.concatenate(subs), np.concatenate(
        [[0], np.cumsum([len(s) for s in subs])]).astype(np.int64),
        np.zeros(0, np.int64), np.zeros(0, np.int64))
    recs = []
    for k in range(len(queries)):
        c = align_reference.align([queries[k]], [[subs[k]]], 10, 2,
                                  e_first=False)[0][0]
        resp = {"id": k, "results": [{"query": f"Q{k:04d}", "hits": [
            {"rank": 1, "score": int(c[0]), "title": dbgen.title(k)}]}],
            "m8": rows_of(k, queries[k], subs[k])}
        recs.append({"id": k, "resp": json.dumps(resp)})
    return recs, queries, db


def _rows(e_first):
    def rows_of(k, q, s):
        c = align_reference.align([q], [[s]], 10, 2, e_first=e_first)[0][0]
        return [align_reference.m8_row(f"Q{k:04d}", dbgen.title(k), c)]
    return rows_of


def test_the_judge_reads_rows():
    recs, queries, db = _recs_and_db(_rows(False))
    assert server_m8.m8_mismatches(recs, [0, 1], queries, db, 10, 2) == {}
    recs, queries, db = _recs_and_db(_rows(True))
    assert server_m8.m8_mismatches(recs, [0, 1], queries, db, 10, 2) == {
        0: 1, 1: 1}
    recs, queries, db = _recs_and_db(lambda k, q, s: [])
    assert server_m8.m8_mismatches(recs, [0, 1], queries, db, 10, 2) == {
        0: 1, 1: 1}
    recs, queries, db = _recs_and_db(lambda k, q, s: None)
    assert server_m8.m8_mismatches(recs, [1], queries, db, 10, 2) == {1: 1}
