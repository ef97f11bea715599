"""swimm_tpu_torch's streaming posture (SearchConfig(db_stream=True),
score_db_streaming, models/stream.py) against swimm_tpu's (xla backend),
on the CPU (device='cpu': the plain PyTorch scorers): the same windows,
window contents, merges, hit lists, E-values and score vectors, bit for
bit; plus what the port promises beyond the reference: the DB never
materialised on the host nor uploaded whole, windows at their fill, a
short read refused, the prefetch thread stopped, the auto-route keyed on
the port's fit decision, the CLI's posture errors. Tolerance 0
throughout: every path computes exact integers (E-values: the same floats
from the same integer tables)."""

import json
import os
import threading
import time

import numpy as np
import pytest

from swimm_tpu.db import build_db as j_build_db
from swimm_tpu.fasta import FastaRecord as JRecord
from swimm_tpu.models import engine as jengine
from swimm_tpu.models import stream as jstream
from swimm_tpu_torch import (SearchConfig, build_db, load_db, score_db,
                             score_db_streaming, search)
from swimm_tpu_torch.db import PackedDb
from swimm_tpu_torch.fasta import FastaRecord, write_fasta
from swimm_tpu_torch.models import engine, stream
from swimm_tpu_torch.ops.lanes import select_mode
from swimm_tpu_torch.utils.synth import random_codes, synth_db, synth_queries
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """160 sequences of up to 220 aa (V=8: 20 blocks of 1-7 tiles, 56
    tiles; 10 windows at window_tiles=7, 4 at 16, 2 at 32), five queries
    in three padded-length groups (32, 48, 112 rows) with planted
    homologs; the port's DB memmapped through load_db."""
    d = tmp_path_factory.mktemp("stream")
    queries = synth_queries(5, [24, 40, 40, 100, 30], seed=51)
    recs = synth_db(160, seed=52, median_len=60, sigma=0.5, max_len=220,
                    queries=[q.codes for q in queries], homolog_frac=0.06)
    build_db(recs, d / "t", V=8)
    pj = j_build_db(recs, d / "j", V=8, use_native=False)
    return load_db(d / "t"), pj, queries


@pytest.fixture(scope="module")
def long_world(tmp_path_factory):
    """A 2,050-aa query (2,064 padded rows: kernel 2's mode, two 1,024-row
    tiles and one of 16) beside a short one, against 40 short sequences."""
    d = tmp_path_factory.mktemp("stream_long")
    rng = np.random.default_rng(22)
    long_q = FastaRecord("long", random_codes(rng, 2050))
    short_q = FastaRecord("short", random_codes(rng, 20))
    recs = synth_db(40, seed=3, median_len=40, max_len=100)
    recs[5] = FastaRecord("hom planted_homolog", long_q.codes[100:160])
    build_db(recs, d / "t", V=8)
    pj = j_build_db(recs, d / "j", V=8, use_native=False)
    return load_db(d / "t"), pj, [long_q, short_q]


def _hits(results):
    return [[(h.rank, h.score, h.sorted_idx, h.orig_idx, h.title, h.evalue,
              h.bits) for h in r.hits] for r in results]


def _jq(queries):
    return [JRecord(q.title, q.codes) for q in queries]


def _jsearch(pj, queries, **cfg):
    return jengine.search(pj, _jq(queries), jengine.SearchConfig(
        backend="xla", **cfg))[0]


@pytest.mark.parametrize("wt", [7, 16, 32, 64, 1 << 16])
def test_layout_plan_and_width_match_jax(world, wt):
    pt, pj, _ = world
    lay, jlay = stream.stream_layout(pt), jstream.stream_layout(pj)
    for key in ("n_rows", "T", "chunk_tile0", "chunk_row0", "jt", "V"):
        assert lay[key] == jlay[key]
    assert np.array_equal(lay["cum"], jlay["cum"])
    spans, r_cap = stream.plan_windows(lay, wt)
    assert (spans, r_cap) == jstream.plan_windows(jlay, wt)
    assert (stream.effective_window_tiles(lay, spans)
            == jstream.effective_window_tiles(jlay, spans))


def test_plan_refuses_a_window_below_the_largest_block(world):
    pt, pj, _ = world
    with pytest.raises(ValueError, match="raise --window-tiles"):
        stream.plan_windows(stream.stream_layout(pt), 6)
    with pytest.raises(ValueError, match="raise --window-tiles"):
        jstream.plan_windows(jstream.stream_layout(pj), 6)


@pytest.mark.parametrize("wt", [7, 32, 1 << 16])
def test_windows_at_their_fill_match_jax(world, wt):
    # each window: the reference's codes and local rows on its fill (the
    # reference pads the rest and sends it to a trash row; the port does
    # not), and row starts from the layout; two slots reused in turn
    pt, pj, _ = world
    lay = stream.stream_layout(pt)
    spans, r_cap = stream.plan_windows(lay, wt)
    width = stream.effective_window_tiles(lay, spans)
    slots = stream.WindowSlots(2, width, 32, lay["V"], r_cap, pin=False)
    ref = list(jstream.iter_windows(pj, wt))
    got = []
    for s, win, orow, rs, g0, n_w in stream.iter_windows(pt, wt, slots):
        got.append((s, win.copy(), orow.copy(), rs.copy(), g0, n_w))
        slots.release(s)
    assert len(got) == len(ref) == len(spans)
    for i, ((s, win, orow, rs, g0, n_w), (jw, jo, jg0, jn, jr)) in enumerate(
            zip(got, ref)):
        n_t = win.shape[0]
        assert s == i % 2 and (g0, n_w, jr) == (jg0, jn, r_cap)
        assert n_t == int(lay["cum"][g0 + n_w] - lay["cum"][g0])
        assert np.array_equal(win, jw[:n_t])
        assert np.array_equal(orow, jo[:n_t])
        assert (jo[n_t:] == r_cap).all()
        assert np.array_equal(rs, lay["cum"][g0:g0 + n_w + 1]
                              - lay["cum"][g0])


@pytest.mark.parametrize("merge", ["buffer", "candidates"])
@pytest.mark.parametrize("evalue", [False, True])
def test_stream_search_matches_jax(world, merge, evalue):
    # three padded-length groups share each window; hits, E-values and
    # bit scores equal the reference's streaming and the port's resident
    # search, at two window sizes and in-flight depths
    pt, pj, queries = world
    resident, rm = search(pt, queries, SearchConfig(top_k=10,
                                                    evalue=evalue),
                          device="cpu")
    ref = _jsearch(pj, queries, top_k=10, evalue=evalue, db_stream=True,
                   window_tiles=32, stream_scores=merge)
    assert _hits(ref) == _hits(resident)
    for wt, depth in ((32, 1), (16, 3)):
        got, m = search(pt, queries, SearchConfig(
            top_k=10, evalue=evalue, db_stream=True, window_tiles=wt,
            max_in_flight=depth, stream_scores=merge), device="cpu")
        assert _hits(got) == _hits(ref), (wt, depth)
        assert [r.as_table() for r in got] == [r.as_table() for r in ref]
        assert (m.cells, m.padded_cells) == (rm.cells, rm.padded_cells)
    assert any(r.hits[0].title.endswith("planted_homolog") for r in got)
    assert all((h.evalue is not None) == evalue for r in got for h in r.hits)


@pytest.mark.parametrize("merge", ["buffer", "candidates"])
def test_stream_long_query_matches_jax(long_world, merge):
    # a query past 2,048 padded rows streams through kernel 2's mode (one
    # call per query tile per window) beside a short one in kernel 1's
    pt, pj, queries = long_world
    assert [select_mode(m) for m in (2064, 32)] == ["tiles_long",
                                                         "tiles"]
    cfg = dict(top_k=6, db_stream=True, window_tiles=8, stream_scores=merge)
    got, m = search(pt, queries, SearchConfig(**cfg), device="cpu")
    assert _hits(got) == _hits(_jsearch(pj, queries, **cfg))
    assert got[0].hits[0].title == "hom planted_homolog"
    lanes = sum(ch.n_blocks * ch.L * ch.V for ch in pt.chunks)
    assert m.padded_cells == lanes * (2064 + 32)


def test_stream_padded_cells_count_the_fill(world):
    # the reference dispatches every window at one width (pad tiles into a
    # trash row) and counts len(spans) x width; the port launches each
    # window at its fill, so it counts the stream's tiles once, like the
    # resident path. Hits are the same (test_stream_search_matches_jax)
    pt, pj, queries = world
    cfg = dict(top_k=5, db_stream=True, window_tiles=32)
    _, m = search(pt, queries[:1], SearchConfig(**cfg), device="cpu")
    _, jm = jengine.search(pj, _jq(queries[:1]), jengine.SearchConfig(
        backend="xla", **cfg))
    lay = stream.stream_layout(pt)
    spans, _ = stream.plan_windows(lay, 32)
    width = stream.effective_window_tiles(lay, spans)
    assert m.padded_cells == lay["T"] * 32 * 8 * 32
    assert jm.padded_cells == len(spans) * width * 32 * 8 * 32
    assert jm.padded_cells > m.padded_cells


def test_auto_resolution_matches_jax(world, monkeypatch):
    pt, pj, queries = world
    assert stream.STREAM_BUFFER_CAP == jstream.STREAM_BUFFER_CAP
    lay = stream.stream_layout(pt)
    _, r_cap = stream.plan_windows(lay, 32)
    huge = stream.STREAM_BUFFER_CAP // (4 * lay["V"]) + 1
    for q, rows, rc, V in ((5, lay["n_rows"], r_cap, lay["V"]),
                           (5, huge, r_cap, lay["V"]), (1, 1, 1, 128),
                           (2, huge // 2 - 1, 1, lay["V"]),
                           (2, huge // 2 - 1, 3, lay["V"])):
        for merge in ("auto", "buffer", "candidates"):
            got = stream.resolve_stream_scores(
                SearchConfig(stream_scores=merge), q, rows, rc, V)
            assert got == jstream.resolve_stream_scores(
                jengine.SearchConfig(stream_scores=merge), q, rows, rc, V)
    # 'auto' with the cap shrunk below this batch's buffers takes the
    # candidates merge, and its hits stay the reference's
    seen = []
    real = stream.resolve_stream_scores

    def spy(*a):
        seen.append(real(*a))
        return seen[-1]
    monkeypatch.setattr(stream, "resolve_stream_scores", spy)
    monkeypatch.setattr(stream, "STREAM_BUFFER_CAP", 1024)
    got, _ = search(pt, queries, SearchConfig(top_k=8, db_stream=True,
                                              window_tiles=32), device="cpu")
    assert seen == ["candidates"]
    assert _hits(got) == _hits(_jsearch(pj, queries, top_k=8,
                                        db_stream=True, window_tiles=32))


@pytest.mark.parametrize("which", [0, 3])
def test_score_db_streaming_matches_jax(world, which):
    pt, pj, queries = world
    q = queries[which]
    cfg = SearchConfig()
    want = jengine.score_db_streaming(pj, _jq([q])[0], jengine.SearchConfig(
        backend="xla"), window_tiles=16, max_in_flight=2)
    for wt, depth in ((16, 2), (7, 1), (1 << 16, 3)):
        got = score_db_streaming(pt, q, cfg, window_tiles=wt,
                                 max_in_flight=depth, device="cpu")
        assert got.dtype == np.int32 and np.array_equal(got, want)
    assert np.array_equal(score_db(pt, q, cfg, device="cpu"), want)
    with pytest.raises(ValueError, match="window_tiles"):
        score_db_streaming(pt, q, cfg, window_tiles=0, device="cpu")
    with pytest.raises(ValueError, match="max_in_flight"):
        score_db_streaming(pt, q, cfg, max_in_flight=0, device="cpu")


def test_score_db_streaming_long_query_matches_jax(long_world):
    pt, pj, queries = long_world
    want = jengine.score_db_streaming(pj, _jq(queries)[0],
                                      jengine.SearchConfig(backend="xla"),
                                      window_tiles=8)
    got = score_db_streaming(pt, queries[0], window_tiles=8, device="cpu")
    assert np.array_equal(got, want)


def test_streaming_never_materialises_nor_uploads_the_db(world,
                                                         monkeypatch):
    # out of core: the windows come from the chunk files alone, so the DB
    # is never built whole on the host (flat_tiles) nor uploaded whole
    # (device_tiles), and the auto-route's fit decision reads metadata
    pt, _, queries = world
    fresh = load_db(os.path.dirname(pt.chunks[0].codes.filename))

    def refuse(*a, **k):
        raise AssertionError("the streaming posture touched the whole DB")
    monkeypatch.setattr(PackedDb, "flat_tiles", refuse)
    monkeypatch.setattr(engine, "device_tiles", refuse)
    assert isinstance(fresh.chunks[0].codes, np.memmap)
    for merge in ("buffer", "candidates"):
        res, _ = search(fresh, queries, SearchConfig(
            top_k=4, db_stream=True, window_tiles=16, stream_scores=merge,
            evalue=True), device="cpu")
        assert all(len(r.hits) == 4 for r in res)
    score_db_streaming(fresh, queries[0], device="cpu")
    assert engine.device_bytes_needed(fresh, query_pack=True, evalue=True)
    assert fresh not in engine._DEVICE_TILE_CACHE
    assert getattr(fresh, "_flat_tiles_cache", None) is None


@pytest.mark.parametrize("query_pack,evalue", [(False, False), (True, False),
                                               (False, True), (True, True)])
def test_device_bytes_needed_from_metadata(world, query_pack, evalue):
    # the old formula over flat_tiles(), which built the DB on the host
    from swimm_tpu_torch.models import qpack
    pt, _, _ = world
    tiles, outrow, n_rows = pt.flat_tiles()
    lanes = n_rows * int(pt.manifest["V"])
    old = tiles.nbytes * 9 + outrow.nbytes + lanes * 5 + 8 * (n_rows + 1)
    old += lanes * (qpack.N_SEG_CAP // 2) * 12 if query_pack else 0
    old += lanes * 4 if evalue else 0
    assert engine.device_bytes_needed(pt, query_pack, evalue) == old


def test_truncated_chunk_file_raises(tmp_path):
    # a chunk file cut short after the DB was opened: the window that
    # reads past its end fails with the short read, never scores garbage
    recs = synth_db(120, seed=85, median_len=60, sigma=0.4, max_len=150)
    build_db(recs, tmp_path / "db", V=8)
    packed = load_db(tmp_path / "db")
    big = max(packed.chunks, key=lambda c: c.codes.nbytes).codes.filename
    os.truncate(big, os.path.getsize(big) - 4096)
    q = synth_queries(1, [40], seed=86)
    with pytest.raises(OSError, match="short read"):
        search(packed, q, SearchConfig(db_stream=True, window_tiles=16),
               device="cpu")
    with pytest.raises(OSError, match="short read"):
        score_db_streaming(packed, q[0], window_tiles=16, device="cpu")


def _wait_for_no_new_threads(before):
    deadline = time.time() + 10.0
    extra = True
    while time.time() < deadline:
        extra = [t for t in threading.enumerate() if t not in before]
        if not extra:
            return []
        time.sleep(0.05)
    return extra


def test_prefetch_abandon_stops_producer():
    produced = []

    def src():
        for i in range(100_000):
            produced.append(i)
            yield i

    before = set(threading.enumerate())
    it = stream._prefetch_iter(src(), depth=2)
    assert next(it) == 0
    it.close()
    assert not _wait_for_no_new_threads(before)
    assert len(produced) < 100_000


def test_prefetch_forwards_producer_exception():
    def src():
        yield 1
        raise RuntimeError("boom in producer")

    it = stream._prefetch_iter(src(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom in producer"):
        for _ in it:
            pass


def test_abandoned_window_stream_stops_its_thread(world):
    # a consumer that leaves after the first window while the producer
    # waits for a slot: closing the slots lets the thread end
    import torch
    pt, _, _ = world
    before = set(threading.enumerate())
    windows = stream.stream_windows(pt, 7, 1, torch.device("cpu"))
    tiles, outrow, row_start, g0, n_w = next(windows)
    assert g0 == 0 and row_start.shape == (n_w + 1,)
    time.sleep(0.3)                       # the producer fills the rest
    windows.close()
    assert not _wait_for_no_new_threads(before)


def test_slot_refilled_only_after_its_copy_completed():
    # the reader thread waits on the event a slot was released with (on a
    # card: the event behind its host-to-device copy) before it refills it
    class Copy:
        done = False

        def synchronize(self):
            time.sleep(0.05)
            self.done = True

    slots = stream.WindowSlots(2, 4, 32, 8, 2, pin=False)
    first, second = slots.acquire(), slots.acquire()
    copies = [Copy(), Copy()]
    slots.release(first, copies[0])
    slots.release(second, copies[1])
    assert slots.acquire() == first and copies[0].done
    assert not copies[1].done
    assert slots.acquire() == second and copies[1].done
    slots.close()
    assert slots.acquire() is None


def test_window_stream_under_thread_switch_stress(world):
    # the reader thread refills slots while the consumer holds a window:
    # with one slot in flight and the interpreter switching threads every
    # microsecond, every window the consumer sees must still hold its own
    # codes when it asks for the next (a slot refilled early would not)
    import sys
    import torch
    pt, _, _ = world
    tiles, _, _ = pt.flat_tiles()
    cum = stream.stream_layout(pt)["cum"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            seen = 0
            for win, orow, rs, g0, n_w in stream.stream_windows(
                    pt, 7, 1, torch.device("cpu")):
                want = tiles[cum[g0]:cum[g0 + n_w]]
                time.sleep(0.002)            # the reader runs meanwhile
                assert np.array_equal(win.numpy(), want)
                seen += n_w
            assert seen == len(cum) - 1
    finally:
        sys.setswitchinterval(old)


def test_auto_route_warns_and_gives_the_resident_hits(world, monkeypatch):
    # the port's fit decision (device memory, resident_fits) stands in for
    # the reference's RESIDENT_TILE_CAP guard; with no card here it is
    # monkeypatched to say the DB does not fit
    pt, _, queries = world
    resident, rm = search(pt, queries, SearchConfig(top_k=8), device="cpu")
    monkeypatch.setattr(engine, "resident_fits", lambda *a, **k: False)
    with pytest.warns(UserWarning, match="streaming path"):
        routed, m = search(pt, queries, SearchConfig(top_k=8,
                                                     window_tiles=32),
                           device="cpu")
    assert _hits(routed) == _hits(resident)
    assert m.padded_cells == rm.padded_cells
    with pytest.raises(ValueError, match="query_pack"):
        search(pt, queries, SearchConfig(query_pack=True), device="cpu")
    with pytest.raises(ValueError, match="ladder"):
        search(pt, queries, SearchConfig(precision="ladder"), device="cpu")
    fresh = load_db(os.path.dirname(pt.chunks[0].codes.filename))
    with pytest.raises(RuntimeError, match="score_db_streaming"):
        score_db(fresh, queries[0], device="cpu")


def test_stream_refuses_query_pack_and_ladder_like_jax(world):
    pt, pj, queries = world
    for kw, msg in (({"query_pack": True}, "query_pack"),
                    ({"precision": "ladder"}, "ladder")):
        with pytest.raises(ValueError, match=msg):
            search(pt, queries[:1], SearchConfig(db_stream=True, **kw),
                   device="cpu")
        with pytest.raises(ValueError, match=msg):
            jstream.search_streaming_batch(pj, _jq(queries[:1]),
                                           jengine.SearchConfig(
                                               backend="xla", db_stream=True,
                                               **kw))


def _cli_db(tmp_path):
    queries = synth_queries(2, [40, 70], seed=61)
    recs = synth_db(60, seed=60, median_len=40, sigma=0.3, max_len=90,
                    queries=[q.codes for q in queries], homolog_frac=0.1)
    write_fasta(tmp_path / "db.fa", recs)
    write_fasta(tmp_path / "q.fa", queries)
    return tmp_path


def test_cli_stream_matches_resident_and_jax(tmp_path, capsys):
    from swimm_tpu.cli import main as jmain
    from swimm_tpu_torch.cli import main
    d = _cli_db(tmp_path)
    for fn, out in ((main, "t"), (jmain, "j")):
        assert fn(["preprocess", "-i", str(d / "db.fa"), "-o",
                   str(d / out), "--lanes", "8"]) == 0
    capsys.readouterr()

    def hits(fn, db, *extra):
        args = ["search", "-d", str(d / db), "-q", str(d / "q.fa"), "-r",
                "6", "--json", *extra]
        args += ["--device", "cpu"] if fn is main else ["--backend", "xla"]
        assert fn(args) == 0
        return json.loads(capsys.readouterr().out)["results"]

    resident = hits(main, "t")
    for extra in (["--stream"],
                  ["--stream", "--window-tiles", "8", "--max-in-flight",
                   "1", "--stream-scores", "candidates"],
                  ["--stream", "--stream-scores", "buffer", "--evalue"]):
        got = hits(main, "t", *extra)
        assert got == hits(jmain, "j", *extra)
        if "--evalue" not in extra:
            assert got == resident


@pytest.mark.parametrize("extra,msg", [
    (["--stream", "--query-pack"], "--stream does not support --query-pack"),
    (["--window-tiles", "8"], "add --stream"),
    (["--max-in-flight", "3"], "add --stream"),
    (["--stream-scores", "buffer"], "add --stream"),
    (["--stream", "--precision", "ladder"], "precision='ladder'"),
    (["--stream", "--window-tiles", "0"], "window_tiles must be positive")])
def test_cli_stream_posture_errors(tmp_path, capsys, extra, msg):
    from swimm_tpu.cli import main as jmain
    from swimm_tpu_torch.cli import main
    d = _cli_db(tmp_path)
    assert main(["preprocess", "-i", str(d / "db.fa"), "-o", str(d / "t"),
                 "--lanes", "8"]) == 0
    assert jmain(["preprocess", "-i", str(d / "db.fa"), "-o", str(d / "j"),
                  "--lanes", "8"]) == 0
    capsys.readouterr()
    assert main(["search", "-d", str(d / "t"), "-q", str(d / "q.fa"),
                 "--device", "cpu", *extra]) == 2
    err = capsys.readouterr().err
    assert msg in err and len(err.strip().splitlines()) == 1
    assert jmain(["search", "-d", str(d / "j"), "-q", str(d / "q.fa"),
                  "--backend", "xla", *extra]) == 2
