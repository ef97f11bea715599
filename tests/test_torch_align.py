"""swimm_tpu_torch.ops.align, the one owner of alignment, on the CPU:
align_pairs (ops.traceback.sw_align there) against the harness's plain
reference (swbench/align_reference.py, no JAX) row for row in m8's columns
and count for count, on seeded random and homologous pairs and on pairs
full of ties (identical sequences, low-complexity repeats, optima reached
through gaps, one-residue sequences), at gaps 10/2 and 0/3; the host half
of the card path (the records built from a kernel's counts and paths)
against sw_align; the workspace groups; the hit-score probe and the
counters; and the Batcher: one alignment call per dispatch for the
requests that ask for alignments, none for JSON ones. Tolerance 0."""

import dataclasses
import threading
import time

import numpy as np
import pytest

from swbench import align_reference
from swimm_tpu_torch import db as tdb
from swimm_tpu_torch.alphabet import decode, encode
from swimm_tpu_torch.fasta import write_fasta
from swimm_tpu_torch.formats import m8_rows
from swimm_tpu_torch.matrices import get_matrix
from swimm_tpu_torch.models.engine import Hit, QueryResult, SearchConfig
from swimm_tpu_torch.ops import align
from swimm_tpu_torch.ops.traceback import sw_align
from swimm_tpu_torch.server import Batcher, SearchServer
from swimm_tpu_torch.utils import metrics
from swimm_tpu_torch.utils.synth import (mutate, random_codes, synth_db,
                                         synth_queries)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TIES = [("W", "W"), ("A", "C"), ("A" * 12, "A" * 17),
        ("ACACACACACAC", "CACACACA"), ("KKKKRKKKKRKK", "KRKRK"),
        ("WWWWWGGGGGWWWWW", "WWWWWWWWWW"), ("WWWWWWWWWW", "WWWWWGGGGGWWWWW"),
        ("WWWWGWWWWGWWWW", "WWWWWWWWWWW"), ("LLLLLLLLLLLL", "LLLLAAAALLLL"),
        ("HHHHCCCCHHHHCCCC", "HHHHHHHHCCCCCCCC"), ("MKVLAAG", "MKVLAAG")]
#: homologous pairs whose path meets a tie of the diagonal and E at 10/2
CO_OPTIMAL = [("AHESADKWSTGNSRLNCNVT", "SMLDIHSADKSFTFGNSEEMCKNVTESS"),
              ("ISNFEEQCRVQTTAGPVYEVIRDGVLN",
               "NGWIFNFEMEMQCRVQKSGHFVYSFKDIVLFNRYY")]


def _pairs(seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(5):
        q = random_codes(rng, int(rng.integers(1, 45)))
        out.append((q, random_codes(rng, int(rng.integers(1, 45)))))
        h = mutate(rng, q, sub_rate=0.2, indel_rate=0.1)
        out.append((q, np.concatenate([random_codes(rng, 4), h,
                                       random_codes(rng, 3)])))
    return out + [(encode(a), encode(b)) for a, b in TIES + CO_OPTIMAL]


def _rows(pairs, aligns) -> list:
    """Each pair's m8 row as the program formats it (formats.m8_rows)."""
    return [m8_rows(QueryResult("q", len(q), [Hit(1, a.score, k, k,
                                                  f"S{k:07d}")]), [a])[0]
            for k, ((q, _), a) in enumerate(zip(pairs, aligns))]


def _letters(codes) -> np.ndarray:
    return np.frombuffer(decode(codes).encode(), np.uint8)


@pytest.mark.parametrize("gaps", [(10, 2), (0, 3)])
@pytest.mark.parametrize("seed", [1, 2])
def test_align_pairs_equals_plain_reference(gaps, seed):
    go, ge = gaps
    pairs = _pairs(seed)
    got = align.align_pairs(pairs, gap_open=go, gap_extend=ge)
    ref = align_reference.align([_letters(q) for q, _ in pairs],
                                [[_letters(d)] for _, d in pairs], go, ge)
    want = [align_reference.m8_row("q", f"S{k:07d}", c[0])
            for k, c in enumerate(ref)]
    assert _rows(pairs, got) == want
    for a, c in zip(got, ref):
        c = dict(zip(align_reference.FIELDS, c[0].tolist()))
        assert (a.score, a.q_start, a.q_end, a.d_start, a.d_end, a.length,
                a.n_identity, a.n_positive, a.n_gaps) == (
            c["score"], c["q_start"], c["q_end"], c["d_start"], c["d_end"],
            c["length"], c["identities"], c["positives"], c["gaps"])
    assert sum(a.n_gaps > 0 for a in got) > 0


def test_plain_reference_tie_control_differs():
    """E before the diagonal (the reference's control) gives another path,
    and another m8 row, where the diagonal and E tie on the path; the
    program's rows are the exact rule's."""
    pairs = [(encode(a), encode(b)) for a, b in CO_OPTIMAL]
    args = ([_letters(q) for q, _ in pairs],
            [[_letters(d)] for _, d in pairs], 10, 2)
    rows = {e: [align_reference.m8_row("q", f"S{k:07d}", c[0])
                for k, c in enumerate(align_reference.align(
                    *args, e_first=e))] for e in (False, True)}
    got = _rows(pairs, align.align_pairs(pairs))
    assert got == rows[False]
    assert all(a != b for a, b in zip(got, rows[True]))


def _kernel_outputs(pairs, aligns):
    """What sw_align_kernel returns for these alignments: the counts and
    each path's columns last first, m + n bytes a pair."""
    res = np.zeros((len(pairs), align.OUT), np.int32)
    paths = []
    for k, ((q, d), a) in enumerate(zip(pairs, aligns)):
        cols = [1 if x == "-" else 2 if y == "-" else 0
                for x, y in zip(a.q_aln, a.d_aln)][::-1]
        buf = np.zeros(len(q) + len(d), np.uint8)
        buf[:len(cols)] = cols
        paths.append(buf)
        res[k, [align.SCORE, align.QSTART, align.QEND, align.DSTART,
                align.DEND, align.LENGTH, align.IDENT, align.POS,
                align.GAPS, align.CHECK]] = [
            a.score, a.q_start, a.q_end, a.d_start, a.d_end, a.length,
            a.n_identity, a.n_positive, a.n_gaps, a.score]
    return res, np.concatenate(paths)


@pytest.mark.parametrize("seed", [3, 4])
def test_records_from_kernel_outputs_equal_sw_align(seed):
    """The card path's host half: the Alignments built from a launch's
    counts and paths are sw_align's, strings and midline included."""
    pairs = _pairs(seed) + [(random_codes(np.random.default_rng(seed), 9),
                             np.zeros(0, np.uint8))]
    want = [sw_align(q, d) for q, d in pairs]
    res, paths = _kernel_outputs(pairs, want)
    got = align._records(pairs, res, paths,
                         get_matrix("BLOSUM62").astype(np.int64))
    assert [dataclasses.asdict(a) for a in got] == \
        [dataclasses.asdict(a) for a in want]


def test_groups_hold_the_workspace_cap():
    # the worst dispatch: 64 queries of 6,000 aa, 16 hits of 6,000 aa each
    size = align.workspace_bytes(6000, 6000)
    assert size == 4 * 750 * 6000
    cut = align.groups([size] * 1024)
    per = align.WORKSPACE_BYTES // size
    assert len(cut) == -(-1024 // per) == 18
    assert [b - a for a, b in cut] == [per] * 17 + [1024 - 17 * per]
    assert all(size * (b - a) <= align.WORKSPACE_BYTES for a, b in cut)
    assert align.groups([5, 2 * align.WORKSPACE_BYTES, 5]) == [
        (0, 1), (1, 2), (2, 3)]
    assert align.groups([]) == []
    assert align.groups([3, 3, 3], cap=6) == [(0, 2), (2, 3)]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("aligndb")
    write_fasta(tmp / "db.fasta", synth_db(120, seed=23))
    packed = tdb.build_db(str(tmp / "db.fasta"), tmp / "t", V=16)
    return SearchServer(packed, SearchConfig(top_k=3), device="cpu")


def test_align_hits_probes_the_hit_scores(served):
    qs = synth_queries(2, [30, 41], seed=5)
    results, _ = served._search(served._packed, qs, served._config)
    before = (metrics.counter("align.pairs"), metrics.counter("align.cells"))
    got = align.align_hits(results, qs, served._packed, served._config)
    assert [len(g) for g in got] == [len(r.hits) for r in results]
    assert [a.score for g in got for a in g] == \
        [h.score for r in results for h in r.hits]
    n = sum(len(r.hits) for r in results)
    cells = sum(q.length * int(served._packed.lengths[h.sorted_idx])
                for q, r in zip(qs, results) for h in r.hits)
    assert (metrics.counter("align.pairs"), metrics.counter(
        "align.cells")) == (before[0] + n, before[1] + cells)
    results[1].hits[0].score += 1
    with pytest.raises(AssertionError, match="device hit score"):
        align.align_hits(results, qs, served._packed, served._config)


def test_batcher_aligns_once_per_dispatch(served, monkeypatch):
    """JSON, align and m8 requests queued together: one search and one
    alignment call, for the align and m8 requests only; each response
    equals the lone request's."""
    calls = []
    real = served._align

    def counted(queries, results):
        calls.append([q.title for q in queries])
        return real(queries, results)
    monkeypatch.setattr(served, "_align", counted)
    qs = synth_queries(4, [28, 36, 36, 45], seed=31)
    q = [{"title": x.title, "seq": decode(x.codes)} for x in qs]
    reqs = [{"id": 0, "queries": [q[0]]},
            {"id": 1, "queries": [q[1]], "align": True, "top_k": 2},
            {"id": 2, "queries": [q[2], q[3]], "format": "m8"},
            {"id": 3, "queries": [q[3]], "top_k": 2}]
    b = Batcher(served, autostart=False)
    out = [None] * len(reqs)
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(
        i, b.submit(reqs[i]))) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for _ in range(1000):
        with b._cv:
            if len(b._pending) == len(reqs):
                break
        time.sleep(0.01)
    b._drain_once()
    for t in threads:
        t.join(timeout=60)
    assert b.n_dispatches == 1
    assert calls == [[qs[1].title, qs[2].title, qs[3].title]]
    assert "m8" not in out[0] and "m8" not in out[3]
    assert len(out[2]["m8"]) == 6
    assert all("alignment" in h for h in out[1]["results"][0]["hits"])
    calls.clear()
    for i, req in enumerate(reqs):
        lone = served.handle(req)
        assert {k: v for k, v in out[i].items() if k != "metrics"} == \
            {k: v for k, v in lone.items() if k != "metrics"}
    assert calls == [[qs[1].title], [qs[2].title, qs[3].title]]
