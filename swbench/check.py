"""The comparison that decides ``correct``.

An answer is one query's hit list as the system under test returned it:
(score, title) pairs, or None for an answer that never came or came as an
error. The reference cannot score all of a Swiss-Prot-scale database for
every query in the time a run allows, so for each query it scores a
candidate set:

- for the queries in ``full`` (a run names one: its shortest checked
  query), the whole database;
- for the others: every sequence any answer to that query reports, the
  planted homologs of that query (its true top hits), and ``SAMPLE``
  sequences drawn from the seed.

Each answer is then held to the configuration's guarantees, against the
reference's scores and its own derivation of the sorted index:

- ``missing_answers``: answers that never came;
- ``malformed_answers``: not min(k, n) hits, a title the database does not
  have, or a sequence twice;
- ``score_mismatches``: hits whose score is not the reference's;
- ``order_violations``: neighbouring hits not in (score descending, sorted
  index ascending) order by the reference's scores;
- ``missed_hits``: candidates left out that rank before the last hit (for
  a query scored against the whole database: any sequence at all, so a
  search that skips part of the database fails here).

Each is an exact comparison, so each has the limit 0.
"""

from __future__ import annotations

import numpy as np

from swbench import dbgen, reference

#: random database sequences each query's candidate set holds
SAMPLE = 2048

LIMITS = {"missing_answers": 0, "malformed_answers": 0,
          "score_mismatches": 0, "order_violations": 0, "missed_hits": 0}


def candidates(db: dbgen.Database, query: int, reported,
               sample: np.ndarray) -> np.ndarray:
    """Sorted unique original indices: the reported ones, the query's
    homologs, the sample."""
    return np.unique(np.concatenate([
        np.asarray(sorted(reported), dtype=np.int64),
        db.homologs[db.homolog_source == query], sample]).astype(np.int64))


def _candidate_sets(db: dbgen.Database, todo, shown: dict, seed: int,
                    full) -> dict:
    """Each query's candidate set: the whole database for those in
    ``full``, candidates() for the others."""
    rng = dbgen.rng_for(seed, "check")
    pick = rng.choice(db.n_seqs, size=min(SAMPLE, db.n_seqs), replace=False)
    return {qi: (np.arange(db.n_seqs, dtype=np.int64) if qi in full
                 else candidates(db, qi, shown.get(qi, ()), pick))
            for qi in todo}


def _reference(queries: list, db: dbgen.Database, cand: dict, gap_open: int,
               gap_extend: int, device, ceiling=None) -> dict:
    """The reference's scores of each query in ``cand`` against its set."""
    todo = list(cand)
    got = reference.score([queries[qi] for qi in todo],
                          [[db.seq(i) for i in cand[qi]] for qi in todo],
                          gap_open, gap_extend, device=device,
                          ceiling=ceiling)
    return dict(zip(todo, got))


def parse_hits(hits, k: int, n_seqs: int):
    """[(score, original index)] of an answer, or None if malformed."""
    try:
        out = [(int(s), dbgen.orig_index(t)) for s, t in hits]
    except (ValueError, TypeError):
        return None
    idx = [i for _, i in out]
    if (len(out) != min(k, n_seqs) or len(set(idx)) != len(idx)
            or any(not 0 <= i < n_seqs for i in idx)):
        return None
    return out


def judge(answers, queries: list, db: dbgen.Database, k: int,
          gap_open: int, gap_extend: int, seed: int, check_queries=None,
          full=(), device="cpu") -> dict:
    """Counts of each fault over ``answers`` ([(query index, hits or
    None)]). Every answer is checked for presence and form; those to the
    queries in ``check_queries`` (default: all) against the reference,
    those in ``full`` against the whole database."""
    counts = dict.fromkeys(LIMITS, 0)
    parsed = []
    for qi, hits in answers:
        if hits is None:
            counts["missing_answers"] += 1
            continue
        p = parse_hits(hits, k, db.n_seqs)
        if p is None:
            counts["malformed_answers"] += 1
            continue
        parsed.append((qi, np.array(p, dtype=np.int64).reshape(-1, 2)))
    want = (set(check_queries) if check_queries is not None
            else {qi for qi, _ in parsed})
    shown: dict = {}
    for qi, p in parsed:
        shown.setdefault(qi, set()).update(p[:, 1].tolist())
    todo = sorted(set(shown) & want)
    cand = _candidate_sets(db, todo, shown, seed, set(full))
    scores = _reference(queries, db, cand, gap_open, gap_extend, device)
    rank = reference.sorted_rank(db.lengths)
    for qi, p in parsed:
        if qi not in cand:
            continue
        c, t = cand[qi], scores[qi]
        got, idx = p[:, 0], p[:, 1]
        ref = t[np.searchsorted(c, idx)]
        counts["score_mismatches"] += int((got != ref).sum())
        s_, r_ = -ref, rank[idx]
        ahead = (s_[:-1] < s_[1:]) | ((s_[:-1] == s_[1:]) & (r_[:-1] < r_[1:]))
        counts["order_violations"] += int((~ahead).sum())
        # candidates that rank before the last hit, less the hits among them
        last_s, last_r = -s_[-1], r_[-1]
        before = (t > last_s) | ((t == last_s) & (rank[c] < last_r))
        listed = np.isin(c, idx)
        counts["missed_hits"] += int((before & ~listed).sum())
    return counts


def control_answers(queries: list, db: dbgen.Database, k: int, gap_open: int,
                    gap_extend: int, seed: int, check_queries, full=(),
                    device="cpu", ceiling=None, reverse_ties=False) -> list:
    """The reference put in the program's place, as a control: each query's
    top k over its candidate set (homologs and the seed's sample, or the
    whole database for those in ``full``), scored with H saturating at
    ``ceiling`` and/or ties broken the other way."""
    cand = _candidate_sets(db, list(check_queries), {}, seed, set(full))
    got = _reference(queries, db, cand, gap_open, gap_extend, device,
                     ceiling)
    rank = reference.sorted_rank(db.lengths)
    return [(q, [(s, dbgen.title(i)) for s, i in reference.top_k(
        c, got[q], rank, k, reverse_ties)]) for q, c in cand.items()]
