"""The served BLAST-tabular deployment (``swimm_tpu_torch serve --listen``,
every request ``"format": "m8"``): the server driver's TCP front end,
Batcher, warm-up and open-loop client, and two steps of its own.

- Set-up: after the server driver's warm-up, one m8 request goes through
  the server (its Batcher), which brings up the program's alignment path
  as a deployment that serves m8 does before its first user. On a card
  that request must launch the program's alignment kernel (its
  ``align.launches`` counter grows): a program that aligns on the host
  (about 5 us a cell, seconds a request, where the cell offers 24
  requests a second) or keeps no such counter cannot serve this traffic,
  and the run stops there with an error, before the window.
- After the window has closed (``t1``): the m8 rows of a sample of the
  responses (those the score check holds: the seed's draw of 128, with the
  longest query) are held to the plain reference (align_reference.py),
  every column. A response whose rows differ, or that has none, is passed
  on as an empty hit list, so check.judge counts it under
  ``malformed_answers`` and ``correct`` is false.

The result line's counters add ``m8_row_mismatches`` (the sampled rows
that differ from the reference's, a missing row counted as one) and the
growth over the window of the program's always-on alignment counters
(``align_launches``, ``align_pairs``, ``align_cells``), where the program
keeps them.
"""

from __future__ import annotations

import json

from swbench import align_reference, dbgen
from swbench.drivers import server

#: responses whose rows are held to the reference
SAMPLE = 128
#: the program's counters (utils/metrics.py) -> the result line's names
COUNTERS = {"align.launches": "align_launches", "align.pairs": "align_pairs",
            "align.cells": "align_cells"}


def _program_counts() -> dict:
    """The program's alignment counters as they stand; {} for a program
    without them."""
    from swimm_tpu_torch.utils import metrics
    read = getattr(metrics, "counter", None)
    return {} if read is None else {k: read(k) for k in COUNTERS}


def m8_mismatches(recs: list, picks, queries: list, db: dbgen.Database,
                  gap_open: int, gap_extend: int, device="cpu",
                  e_first: bool = False) -> dict:
    """{request id: rows that differ} over the picked requests that got a
    search result: each response's m8 rows against the reference's rows
    for its query and its reported hits, in order (a missing, extra or
    unreadable row counts as one). ``e_first`` breaks the reference's
    ties the other way: a control."""
    todo, hits, got = [], [], []
    by_id = {r["id"]: r for r in recs}
    for i in picks:
        resp = json.loads(by_id[i]["resp"]) if by_id[i]["resp"] else {}
        if "results" not in resp or resp.get("id") != i:
            continue
        titles = [h["title"] for h in resp["results"][0]["hits"]]
        try:
            idx = [dbgen.orig_index(t) for t in titles]
        except ValueError:
            idx = None
        todo.append(i)
        hits.append((titles, idx))
        got.append(resp.get("m8"))
    subjects = [[db.seq(k) for k in idx] if idx is not None else []
                for _, idx in hits]
    counts = align_reference.align([queries[i] for i in todo], subjects,
                                   gap_open, gap_extend, device=device,
                                   e_first=e_first)
    bad = {}
    for i, (titles, idx), rows, c in zip(todo, hits, got, counts):
        if idx is None or not isinstance(rows, list):
            bad[i] = max(len(titles), 1)
            continue
        want = [align_reference.m8_row(f"Q{i:04d}", t, x)
                for t, x in zip(titles, c)]
        n = sum(a != b for a, b in zip(rows, want)) + abs(len(rows)
                                                          - len(want))
        if n:
            bad[i] = n
    return bad


class Session(server.Session):
    def __init__(self, cfg, traffic, db, packed, device, seed, seconds,
                 spans, workdir):
        super().__init__(cfg, traffic, db, packed, device, seed, seconds,
                         spans, workdir)
        self.seed = seed

    def setup(self):
        super().setup()
        lens = self.traffic.lengths
        q = self.traffic.queries[int(lens.argsort()[len(lens) // 2])]
        before = _program_counts()
        with self.spans.span("warmup.m8"):
            resp = self.batcher.submit({
                "id": -1, "queries": [{"title": "warm",
                                       "seq": q.tobytes().decode()}],
                **self.traffic.request})
        if "m8" not in resp:
            raise RuntimeError(f"the server answered the m8 warm-up "
                               f"without rows: {str(resp)[:200]}")
        after = _program_counts()
        if self.device != "cpu" and after.get("align.launches", 0) <= \
                before.get("align.launches", 0):
            raise RuntimeError("the m8 warm-up launched no alignment kernel: "
                               "this program aligns its hits on the host, "
                               "which cannot serve this cell's traffic")

    def window(self) -> server.Window:
        from swbench.run import _check_queries
        before = _program_counts()
        win = super().window()
        after = _program_counts()
        with open(self.out) as fh:
            recs = [json.loads(line) for line in fh]
        picks = _check_queries({"check_sample": SAMPLE}, self.traffic,
                               self.seed)
        search = self.cfg["search"]
        bad = m8_mismatches(recs, picks, self.traffic.queries, self.db,
                            search["gap_open"], search["gap_extend"],
                            self.device)
        win.answers[:] = [(i, [] if i in bad else hits)
                          for i, hits in win.answers]
        win.counters["m8_row_mismatches"] = sum(bad.values())
        win.counters.update({COUNTERS[k]: after[k] - before[k]
                             for k in before})
        return win
