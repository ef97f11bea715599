"""The streamed posture (SearchConfig(db_stream=True), models/stream.py)
against the benchmark's plain reference (swbench/reference.py: Gotoh in
plain PyTorch, importing nothing of the program and no JAX) and against the
resident path, on the CPU: the same scores, titles and order under both
merges and two window sizes, with ties planted across window boundaries;
and the spans and counters the streamed path records (utils/metrics.span):
launch cells that sum to SearchMetrics.cells, one ``stream.window`` and
one ``stream.read`` per planned window, reads on the reader thread, the
windows counter (and no bytes counted where nothing is copied), and
nothing recorded with the recorder off.
Tolerance 0 throughout: every path computes exact integers."""

import threading
import time

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from swbench import reference
from swimm_tpu_torch import SearchConfig, build_db, load_db, search
from swimm_tpu_torch.alphabet import ALPHABET, decode
from swimm_tpu_torch.fasta import FastaRecord
from swimm_tpu_torch.models import stream
from swimm_tpu_torch.ops import scorer
from swimm_tpu_torch.utils import metrics
from swimm_tpu_torch.utils.synth import random_codes, synth_db
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

K = 5
V = 8
#: window caps: 10 and 4 windows over the fixture's 70 tiles (largest
#: block 7 tiles)
WINDOWS = [8, 20]
#: residues the tie query holds none of: W scores below 0 against every
#: other residue of BLOSUM62 but F and Y, so a W tail adds nothing to a
#: local alignment with it
NOT_IN_TIE_QUERY = [ALPHABET.index(c) for c in "WFY"]
TIE_TAILS = [0, 11, 29, 47, 73, 101, 131]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """200 synthetic sequences of up to 200 aa with planted homologs of
    three queries, and seven tied hits of the first query: one 32-aa piece
    of it with W tails of TIE_TAILS lengths, so the seven score alike and
    sort into blocks of seven lengths, across windows; K = 5 cuts the tie.
    Packed at V = 8 and memmapped through load_db."""
    rng = np.random.default_rng(2020)
    allowed = np.setdiff1d(np.arange(20), NOT_IN_TIE_QUERY)
    tie_query = rng.choice(allowed, size=48).astype(np.uint8)
    queries = [FastaRecord("tieq", tie_query),
               FastaRecord("q1", random_codes(rng, 70)),
               FastaRecord("q2", random_codes(rng, 110))]
    recs = synth_db(200, seed=2021, median_len=60, sigma=0.5, max_len=200,
                    queries=[q.codes for q in queries[1:]],
                    homolog_frac=0.05)
    piece = tie_query[8:40]
    w = ALPHABET.index("W")
    for j, n in enumerate(TIE_TAILS):
        recs.insert(17 * j + 3, FastaRecord(
            f"TIE{j} tied", np.concatenate(
                [piece, np.full(n, w, np.uint8)]).astype(np.uint8)))
    d = tmp_path_factory.mktemp("stream_ref")
    build_db(recs, d / "t", V=V)
    return load_db(d / "t"), recs, queries


@pytest.fixture(scope="module")
def expected(world):
    """The reference's top K of each query over the whole database, as
    (score, title), and the resident path's hits."""
    packed, recs, queries = world

    def letters(codes):
        return np.frombuffer(decode(codes).encode(), dtype=np.uint8)

    db = [letters(r.codes) for r in recs]
    got = reference.score([letters(q.codes) for q in queries],
                          [db] * len(queries), 10, 2)
    rank = reference.sorted_rank(np.array([len(x) for x in db]))
    every = np.arange(len(db))
    ref = [[(s, recs[i].title) for s, i in
            reference.top_k(every, sc, rank, K)] for sc in got]
    resident, _ = search(packed, queries, SearchConfig(top_k=K),
                         device="cpu")
    return ref, _hits(resident)


def _hits(results):
    return [[(h.rank, h.score, h.sorted_idx, h.orig_idx, h.title)
             for h in r.hits] for r in results]


def _config(merge, wt):
    return SearchConfig(top_k=K, db_stream=True, stream_scores=merge,
                        window_tiles=wt, max_in_flight=2)


def _plan(packed, wt):
    return stream.plan_windows(stream.stream_layout(packed), wt)[0]


def _window_of_row(plan, row):
    return next(w for w, (g0, g1) in enumerate(plan) if g0 <= row < g1)


@pytest.mark.parametrize("wt", WINDOWS)
def test_the_planted_tie_crosses_windows_and_the_cut(world, expected, wt):
    packed, recs, _ = world
    plan = _plan(packed, wt)
    assert len(plan) >= 4
    mask, lane2sorted = packed.lane_maps()
    row_of = {int(s): lane // V for lane, s in enumerate(lane2sorted)
              if mask[lane]}
    tied = [s for s in range(packed.n_seqs)
            if packed.title_of_sorted(s).startswith("TIE")]
    assert len(tied) == len(TIE_TAILS) > K
    assert len({_window_of_row(plan, row_of[s]) for s in tied}) >= 3
    ref, _ = expected
    top = ref[0]
    assert all(t.startswith("TIE") for _, t in top)
    assert len({s for s, _ in top}) == 1      # one score: the cut is a tie
    assert [t for _, t in top] == [f"TIE{j} tied" for j in range(K)]


@pytest.mark.parametrize("wt", WINDOWS)
@pytest.mark.parametrize("merge", ["buffer", "candidates"])
def test_streamed_hits_are_the_reference_and_the_resident(world, expected,
                                                          merge, wt):
    packed, _, queries = world
    ref, resident = expected
    got, met = search(packed, queries, _config(merge, wt), device="cpu")
    assert [[(h.score, h.title) for h in r.hits] for r in got] == ref
    assert _hits(got) == resident
    assert met.cells == packed.total_residues * sum(
        q.length for q in queries)


def _traced_search(packed, queries, config):
    lo = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]):
        _, met = search(packed, queries, config, device="cpu")
    return met, [r for r in metrics.spans(lo)]


def _named(records, name):
    return [r for r in records if r.name == name]


@pytest.mark.parametrize("wt", WINDOWS)
@pytest.mark.parametrize("merge", ["buffer", "candidates"])
def test_streamed_spans(world, merge, wt):
    packed, _, queries = world
    plan = _plan(packed, wt)
    met, rec = _traced_search(packed, queries, _config(merge, wt))
    launches = _named(rec, "engine.launch")
    assert len(launches) == len(plan) * len(queries)
    assert {r.attrs["kernel"] for r in launches} == {scorer.score_tiles.kernel}
    assert sum(r.attrs["cells"] for r in launches) == met.cells
    windows = _named(rec, "stream.window")
    cum = stream.stream_layout(packed)["cum"]
    assert [(r.attrs["tiles"], r.attrs["rows"]) for r in windows] == [
        (int(cum[g1] - cum[g0]), g1 - g0) for g0, g1 in plan]
    for w in windows:          # the window's launches are inside its span
        inside = [r for r in launches if w.t0 <= r.t0 and r.t1 <= w.t1]
        assert len(inside) == len(queries)
    reads = _named(rec, "stream.read")
    assert [r.attrs["bytes"] for r in reads] == [
        int(cum[g1] - cum[g0]) * 32 * V for g0, g1 in plan]
    # a wait for each window and one for the end of the stream
    assert len(_named(rec, "stream.wait")) == len(plan) + 1
    merges = _named(rec, "stream.merge")
    assert [r.attrs["merge"] for r in merges] == [merge]
    assert merges[0].t0 >= windows[-1].t1


def test_reads_run_on_the_reader_thread(world, monkeypatch):
    """Each window's chunk reads happen inside its ``stream.read`` span, on
    a thread other than the caller's."""
    packed, _, queries = world
    fills = []
    real = stream._fill_window

    def watched(*a, **kw):
        fills.append((threading.get_ident(), time.perf_counter()))
        return real(*a, **kw)

    monkeypatch.setattr(stream, "_fill_window", watched)
    _, rec = _traced_search(packed, queries, _config("candidates", 8))
    reads = _named(rec, "stream.read")
    assert len(fills) == len(reads) == len(_plan(packed, 8))
    assert all(ident != threading.get_ident() for ident, _ in fills)
    assert all(r.t0 <= t <= r.t1 for (_, t), r in zip(fills, reads))


@pytest.mark.parametrize("wt", WINDOWS)
def test_window_and_byte_counters(world, wt):
    """A window counted per planned window of each batch; no byte counted
    on the CPU, where the windows are scored in place and nothing is
    copied (the bytes on a card: swbench/tests/test_swbench_stream.py)."""
    packed, _, queries = world
    plan = _plan(packed, wt)
    for batch in range(2):
        before = stream.stream_windows.windows, stream.stream_windows.h2d_bytes
        search(packed, queries, _config("candidates", wt), device="cpu")
        assert stream.stream_windows.windows - before[0] == len(plan)
        assert stream.stream_windows.h2d_bytes == before[1]


def test_recorder_off_records_nothing(world):
    packed, _, queries = world
    assert not metrics.tracing()
    lo = time.perf_counter()
    search(packed, queries, _config("candidates", 8), device="cpu")
    assert metrics.spans(lo) == []


def test_block_residues_are_each_rows_real_residues(world):
    packed, _, _ = world
    per_row = packed.block_residues()
    mask, lane2sorted = packed.lane_maps()
    n_rows = stream.stream_layout(packed)["n_rows"]
    assert len(per_row) == n_rows and per_row.sum() == packed.total_residues
    for row in range(n_rows):
        lanes = range(row * V, (row + 1) * V)
        assert per_row[row] == sum(
            int(packed.lengths[lane2sorted[j]]) for j in lanes if mask[j])
    assert packed.block_residues() is per_row      # cached
