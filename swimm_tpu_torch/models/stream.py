"""Window-major, out-of-core DB streaming (counterpart of
swimm_tpu/models/stream.py).

For a database larger than device memory (SearchConfig(db_stream=True)):

- The tile stream is cut into windows at block boundaries once per query
  batch (stream_layout, plan_windows: copies of the JAX module's, so both
  packages cut the same windows).
- Each window is read straight from the memmapped chunk files
  (_read_chunk_tiles_into: readinto, never a memmap slice, never
  PackedDb.flat_tiles) by a background thread into one of max_in_flight +
  1 host slots, pinned on a card, and copied to one of max_in_flight
  device slots on a copy stream of its own (stream_windows). The compute
  stream waits on each copy's event, the copy stream on the event recorded
  after the last launch that read the device slot it overwrites, and a
  host slot is refilled only once its copy has completed: at most
  max_in_flight windows live on the device, with no host wait per window.
- Each window is scored against EVERY query of the batch (ops/lanes.score:
  one launch per query of kernel 1, or of kernel 2 per query tile past
  max_query_pad() rows) before the next window, so the DB crosses the link
  once per batch.
- Windows are launched at their fill (t1 - t0 tiles, n_w rows, row starts
  from the layout). Kernel 1's split plans of each window (lanes.Splits:
  which of its longest blocks several CUDA blocks walk) are made on the
  host from the window's block lengths, at the window's first launch of
  each padded length. The JAX module pads every window to one compiled
  width and sends the pad tiles to a trash row; the kernels here take a
  row-start array and walk the longest rows first, so a trash row would
  be one long block walked first and in series.
- Two merges (SearchConfig.stream_scores, resolve_stream_scores): 'buffer'
  writes each window's (n_w, V) scores into a (Q, n_rows, V) int32 buffer
  (a plane per query), finished like the resident path (device top-k,
  score histograms) with one copy to the host; 'candidates' takes a
  per-(window, query) device top-k (and under evalue sums per-window
  histograms on the device), and the host merges the candidates in (score
  desc, sorted index asc) order. Every global top-k hit is in its own
  window's top-k, so both give the resident hit lists exactly.

While a profiler is open (utils/metrics.span) the path records its spans:
``stream.read`` (reader thread: one window's chunk files into its host
slot; ``bytes``), ``stream.wait`` (consumer: blocked on the prefetch queue
for the next window), ``stream.window`` (consumer: a window handed over →
its last launch queued; ``tiles``, ``rows``), ``engine.launch`` per (window,
query) with the resident path's attrs (``kernel``; ``cells``, the query's
length × the window's real residues, so a batch's launches sum to its
SearchMetrics.cells) and ``stream.merge`` (the finalize, or the candidates'
copies and host merge). Counters, always on: ``stream_windows.windows``
(windows streamed) and ``stream_windows.h2d_bytes`` (the bytes of each
window's three host → device copies: tiles, local rows, row starts; none
on the CPU, where the windows are scored in place).
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from swimm_tpu_torch.ops import lanes
from swimm_tpu_torch.utils.metrics import span


def stream_layout(packed, jt: int = 32):
    """Analytic tile-stream layout, computed from chunk METADATA only (no
    code arrays touched — memmaps stay cold). Matches flat_tiles() order:
    blocks in chunk order, each block's L/jt tiles consecutive.

    Returns dict(n_rows, T, cum (n_rows+1,) int64 cumulative tiles per
    block, chunk_tile0 / chunk_row0 per chunk, jt, V).
    """
    tb_parts, chunk_tile0, chunk_row0 = [], [], []
    row = 0
    t = 0
    for ch in packed.chunks:
        assert ch.L % jt == 0, (ch.L, jt)
        chunk_tile0.append(t)
        chunk_row0.append(row)
        tb_parts.append(np.full(ch.n_blocks, ch.L // jt, np.int64))
        row += ch.n_blocks
        t += ch.n_blocks * (ch.L // jt)
    tb = np.concatenate(tb_parts) if tb_parts else np.zeros(0, np.int64)
    cum = np.concatenate([[0], np.cumsum(tb)])
    return {"n_rows": row, "T": t, "cum": cum,
            "chunk_tile0": chunk_tile0, "chunk_row0": chunk_row0,
            "jt": jt, "V": int(packed.manifest["V"])}


def plan_windows(layout, window_tiles: int):
    """Cut the stream into windows at block boundaries (the JAX module's
    cuts, so both packages stream the same windows).

    Returns (spans [(g0, g1) block ranges], r_cap = max blocks per window).
    Each window is launched at its fill (its own tiles and rows, no pad
    tiles); window_tiles caps a window's tiles, and with r_cap sizes the
    host and device slots.

    Spans are BALANCED, not greedy-filled: with n_win = ceil(T /
    window_tiles) windows either way, boundaries sit at the block edges
    nearest w*T/n_win. Greedy filling would leave one nearly-empty tail
    window; balancing evens the windows' fills at the same window count
    and memory bound (the JAX module, which pads every window to one
    compiled width, balances to bound that padding).
    """
    cum, n_rows = layout["cum"], layout["n_rows"]
    if n_rows == 0:
        return [], 0
    biggest = int((cum[1:] - cum[:-1]).max())
    if biggest > window_tiles:
        raise ValueError(
            f"window_tiles={window_tiles} is smaller than the largest DB "
            f"block ({biggest} tiles, ~{biggest * layout['jt']} residues); "
            "blocks cannot span windows — raise --window-tiles")
    T = int(cum[-1])
    n_win = -(-T // window_tiles)
    # block index whose tile range contains each even tile boundary
    bounds = [0]
    for w in range(1, n_win):
        g = int(np.searchsorted(cum, round(w * T / n_win), side="left"))
        bounds.append(min(max(g, bounds[-1] + 1), n_rows))
    bounds.append(n_rows)
    spans = []
    r_cap = 0
    fill_max = 0
    for g0, g1 in zip(bounds[:-1], bounds[1:]):
        if g1 <= g0:
            continue
        spans.append((g0, g1))
        r_cap = max(r_cap, g1 - g0)
        fill_max = max(fill_max, int(cum[g1] - cum[g0]))
    if fill_max > window_tiles:      # a huge block straddled a boundary:
        # fall back to greedy fill (still <= window_tiles per window)
        spans = []
        g0 = 0
        r_cap = 0
        while g0 < n_rows:
            g1 = int(np.searchsorted(cum, cum[g0] + window_tiles,
                                     side="right")) - 1
            g1 = max(g1, g0 + 1)
            spans.append((g0, g1))
            r_cap = max(r_cap, g1 - g0)
            g0 = g1
    return spans, r_cap


def effective_window_tiles(layout, spans, quantum: int = 64) -> int:
    """Width actually needed for this plan: the largest span fill,
    rounded up to `quantum` tiles. The JAX package dispatches every window
    at this width; here it sizes the host and device window slots, and
    each window is launched at its own fill."""
    cum = layout["cum"]
    if not spans:
        return 0
    fill = max(int(cum[g1] - cum[g0]) for g0, g1 in spans)
    return -(-fill // quantum) * quantum


STREAM_BUFFER_CAP = 2 * 1024 * 1024 * 1024
"""Device-byte budget for buffer-mode score accumulators (stream_scores=
'auto'): Q x (n_rows + r_cap) x V x 4 bytes must fit or the batch falls
back to candidate mode. The JAX module's constant and formula (r_cap
included, though the buffers here hold n_rows rows), so 'auto' picks the
same merge in both packages."""


def resolve_stream_scores(config, n_queries: int, n_rows: int, r_cap: int,
                          V: int) -> str:
    """Pick the streaming merge strategy for this batch: 'buffer' whenever
    the score buffers fit STREAM_BUFFER_CAP (no per-window work beyond a
    device copy, one resident-style finalize), else 'candidates' (O(k)
    device memory per query, whatever the DB size)."""
    if config.stream_scores != "auto":
        return config.stream_scores
    need = n_queries * (n_rows + r_cap) * V * 4
    return "buffer" if need <= STREAM_BUFFER_CAP else "candidates"


def _read_chunk_tiles_into(ch, lo: int, hi: int, jt: int, V: int,
                           out: np.ndarray) -> None:
    """Read tiles [lo, hi) of one chunk's (nb*L/jt, jt, V) tile view
    directly INTO out (a contiguous (hi-lo, jt, V) int8 view).

    For a memmap-backed chunk the bytes come from readinto() on the
    backing file, not from slicing the memmap: touched memmap pages stay
    counted in the process RSS until memory pressure evicts them, so
    streaming a whole DB through memmap slices would look (and under
    pressure behave) like O(DB) resident memory. readinto() lands the
    page-cache read straight in the window buffer (one copy, the GIL
    released for the read, on the prefetch thread). A short read raises."""
    codes = ch.codes
    n = (hi - lo) * jt * V
    if isinstance(codes, np.memmap):
        with open(codes.filename, "rb") as fh:
            fh.seek(codes.offset + lo * jt * V * codes.itemsize)
            got = fh.readinto(out.reshape(-1).view(np.uint8).data)
        if got != n:
            raise IOError(f"short read: {got} of {n} bytes from "
                          f"{codes.filename}")
    else:
        out[...] = np.asarray(codes).reshape(-1, jt, V)[lo:hi]


def _fill_window(packed, layout, t0: int, t1: int, win: np.ndarray):
    """Copy global tile range [t0, t1) into win[:t1-t0] straight from the
    per-chunk code files (O(window) host memory, see
    _read_chunk_tiles_into). Returns the tiles written."""
    jt, V = layout["jt"], layout["V"]
    dst = 0
    for ch, ct0 in zip(packed.chunks, layout["chunk_tile0"]):
        n_t = ch.n_blocks * (ch.L // jt)
        lo = max(t0, ct0) - ct0
        hi = min(t1, ct0 + n_t) - ct0
        if hi <= lo:
            continue
        _read_chunk_tiles_into(ch, lo, hi, jt, V, win[dst:dst + hi - lo])
        dst += hi - lo
    return dst


class WindowSlots:
    """n host buffers for windows of up to wt tiles and r_cap rows (codes,
    local rows, row starts), pinned for a copy to a card, handed out in
    turn. acquire() blocks until a slot is free and, when its last copy's
    event was given to release(), until that copy has completed; close()
    makes a waiting acquire() return None."""

    def __init__(self, n: int, wt: int, jt: int, V: int, r_cap: int,
                 pin: bool):
        def buf(shape, dtype):
            return torch.empty(shape, dtype=dtype, pin_memory=pin)
        self.tiles = [buf((wt, jt, V), torch.int8) for _ in range(n)]
        self.orow = [buf((wt,), torch.int32) for _ in range(n)]
        self.row_start = [buf((r_cap + 1,), torch.int64) for _ in range(n)]
        self._free: "queue.Queue" = queue.Queue()
        for s in range(n):
            self._free.put((s, None))
        self._closed = threading.Event()

    def acquire(self):
        while not self._closed.is_set():
            try:
                s, copied = self._free.get(timeout=0.2)
            except queue.Empty:
                continue
            if copied is not None:
                copied.synchronize()
            return s
        return None

    def release(self, s: int, copied=None) -> None:
        self._free.put((s, copied))

    def close(self) -> None:
        self._closed.set()


def iter_windows(packed, window_tiles: int, slots, jt: int = 32,
                 spans=None):
    """Yield (slot, win (t1-t0, jt, V) int8, orow (t1-t0,) int32 local
    rows, row_start (n_w+1,) int64 first local tile of each row, g0 global
    first row, n_w rows in window) — windows assembled out of core (host
    memory O(window)), each at its fill: no pad tiles, no trash row. The
    arrays are views of the WindowSlots slot acquired for the window,
    which the consumer releases. Ends early if the slots are closed.
    spans: the (g0, g1) windows to read, by default all of plan_windows'
    (the sharded stream gives each shard device its own)."""
    layout = stream_layout(packed, jt)
    if spans is None:
        spans, _ = plan_windows(layout, window_tiles)
    cum = layout["cum"]
    for g0, g1 in spans:
        t0, t1 = int(cum[g0]), int(cum[g1])
        n_t, n_w = t1 - t0, g1 - g0
        s = slots.acquire()
        if s is None:
            return
        win = slots.tiles[s].numpy()[:n_t]
        orow = slots.orow[s].numpy()[:n_t]
        rs = slots.row_start[s].numpy()[:n_w + 1]
        with span("stream.read", bytes=win.nbytes):
            filled = _fill_window(packed, layout, t0, t1, win)
        if filled != n_t:
            raise IOError(f"window [{t0}, {t1}) filled {filled} tiles")
        rs[:] = cum[g0:g1 + 1] - t0
        orow[:] = np.repeat(np.arange(n_w, dtype=np.int32), np.diff(rs))
        yield s, win, orow, rs, g0, n_w


def _prefetch_iter(it, depth: int = 2):
    """Run an iterator in a background thread with a bounded queue: at
    most `depth` produced items are alive beyond the one the consumer
    holds. Exceptions in the producer re-raise at the consumer.

    If the consumer abandons the generator mid-stream (its own exception,
    or GC of a half-consumed generator), the finally block signals the
    producer to stop and unblocks any pending put, so neither the thread
    nor its window buffers outlive the search."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    return
            put(end)
        except BaseException as e:                 # forward to consumer
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            with span("stream.wait"):
                item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while not q.empty():           # unblock a producer stuck on put
            try:
                q.get_nowait()
            except queue.Empty:
                break


def stream_windows(packed, window_tiles: int, max_in_flight: int, dev,
                   jt: int = 32, spans=None):
    """Yield (tiles, outrow, row_start, g0, n_w) on dev for each window of
    plan_windows (or of its subset `spans`), in order, as the kernels take
    them (n_w rows, row_start local). The consumer must have launched all
    its work on a window before it asks for the next.

    On a card: host slots pinned, max_in_flight + 1 of them; a ring of
    max_in_flight device slots allocated once; each upload on a copy stream
    of its own after the event recorded behind the last launches that read
    its device slot; the current (compute) stream waits on the upload's
    event, the host never waits on the device here. On the CPU: the
    windows are the host slots themselves."""
    layout = stream_layout(packed, jt)
    plan, r_cap = plan_windows(layout, window_tiles)
    wt = effective_window_tiles(layout, plan)
    slots = WindowSlots(max_in_flight + 1, wt, jt, layout["V"], r_cap,
                        pin=dev.type == "cuda")
    feed = _prefetch_iter(iter_windows(packed, window_tiles, slots, jt,
                                       spans), depth=max_in_flight + 1)
    try:
        if dev.type != "cuda":
            for s, win, orow, rs, g0, n_w in feed:
                _count_window()
                yield (torch.from_numpy(win), torch.from_numpy(orow),
                       torch.from_numpy(rs), g0, n_w)
                slots.release(s)
            return
        compute = torch.cuda.current_stream(dev)
        copier = torch.cuda.Stream(dev)
        ring = [(torch.empty((wt, jt, layout["V"]), dtype=torch.int8,
                             device=dev),
                 torch.empty(wt, dtype=torch.int32, device=dev),
                 torch.empty(r_cap + 1, dtype=torch.int64, device=dev))
                for _ in range(max_in_flight)]
        # the ring comes from the allocator's compute-stream pool, which may
        # hand out a block that launches queued on the compute stream still
        # use; the copier writes it, so it starts behind them
        copier.wait_stream(compute)
        read = [None] * max_in_flight   # after the last launches on a slot
        for i, (s, win, _, _, g0, n_w) in enumerate(feed):
            j = i % max_in_flight
            n_t = win.shape[0]
            dst = (ring[j][0][:n_t], ring[j][1][:n_t], ring[j][2][:n_w + 1])
            src = (slots.tiles[s][:n_t], slots.orow[s][:n_t],
                   slots.row_start[s][:n_w + 1])
            with torch.cuda.device(dev), torch.cuda.stream(copier):
                if read[j] is not None:
                    copier.wait_event(read[j])
                for d, h in zip(dst, src):
                    d.copy_(h, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(copier)
            slots.release(s, copied)
            compute.wait_event(copied)
            _count_window(*src)
            yield (*dst, g0, n_w)
            # under the guard, but not across the yield: the consumer's
            # current device stays its own
            with torch.cuda.device(dev):
                read[j] = torch.cuda.Event()
                read[j].record(compute)
    finally:
        slots.close()
        feed.close()


stream_windows.windows = 0     # windows streamed
stream_windows.h2d_bytes = 0   # bytes of their host -> device copies


def _count_window(*copied) -> None:
    stream_windows.windows += 1
    stream_windows.h2d_bytes += sum(a.nbytes for a in copied)


def check_streamable(config) -> None:
    """The postures the streaming path refuses, with swimm_tpu's
    ValueErrors."""
    if config.query_pack:
        raise ValueError(
            "db_stream=True does not support query_pack=True: the "
            "streaming path batches queries per padded length against "
            "each window — set query_pack=False")
    if config.precision == "ladder":
        raise ValueError(
            "db_stream=True does not support precision='ladder': the "
            "ladder's block-escalation control flow needs the whole-DB "
            "saturation map before recompute, which conflicts with "
            "window-at-a-time residency. Use precision='adaptive' — it "
            "serves the identical (bit-exact) scores via the single "
            "exact pass (ops/ladder.py docstring)")


def search_streaming_batch(packed, queries, config, device=None):
    """Batch search under the streaming posture: ONE pass of the DB over
    the host->device link serves the whole batch (module docstring).

    Returns (hit lists in input order, padded query rows dispatched, db
    lane positions dispatched per query row) — the latter two feed the
    padded-cell accounting in engine.search()."""
    from swimm_tpu_torch.models import engine
    from swimm_tpu_torch.utils import stats

    check_streamable(config)
    engine.check_supported(config)
    dev = engine.resolve_device(device)
    layout = stream_layout(packed)
    spans, r_cap = plan_windows(layout, config.window_tiles)
    n_rows, V = layout["n_rows"], layout["V"]
    lane_positions = layout["T"] * layout["jt"] * V
    order, profiles = [], []
    for _, positions in sorted(engine.group_by_m_pad(
            queries, config.m_multiple).items()):
        order += positions
        profiles += [lanes.Profile.build(queries[p], config, dev)
                     for p in positions]
    padded_rows = sum(prof.rows for prof in profiles)
    if not spans or not queries:
        return [[] for _ in queries], padded_rows, lane_positions
    merge = resolve_stream_scores(config, len(queries), n_rows, r_cap, V)
    mask, lane2sorted = engine.device_lane_maps(packed, dev)
    bins = engine.device_lane_bins(packed, dev) if config.evalue else None
    residues = packed.block_residues()
    lens = np.diff(layout["cum"]) * layout["jt"]   # each DB block's positions
    k = config.top_k
    if merge == "buffer":            # one buffer per query: rows of a group
        buf = torch.zeros((len(order), n_rows, V), dtype=torch.int32,
                          device=dev)
    else:
        cands = []                   # per window: (Q, kk) scores, indices
        tables = (torch.zeros((len(order), stats.N_LEN_BINS,
                               stats.SCORE_CAP + 1), dtype=torch.int64,
                              device=dev) if config.evalue else None)
    for tiles, outrow, row_start, g0, n_w in stream_windows(
            packed, config.window_tiles, config.max_in_flight, dev):
        window = slice(g0 * V, (g0 + n_w) * V)
        real = int(residues[g0:g0 + n_w].sum())
        splits = lanes.Splits(lens[g0:g0 + n_w], V, dev)
        vs, sis = [], []
        with span("stream.window", tiles=int(tiles.shape[0]), rows=n_w):
            for row, prof in enumerate(profiles):
                with span("engine.launch", kernel=prof.kernel,
                          cells=prof.length * real):
                    scores = lanes.score((tiles, outrow, n_w, row_start),
                                         prof, config.gap_open,
                                         config.gap_extend, splits)
                if merge == "buffer":
                    buf[row, g0:g0 + n_w] = scores.view(n_w, V)
                    continue
                v, si = engine.device_top_k(scores, mask[window],
                                            lane2sorted[window],
                                            min(k, n_w * V))
                vs.append(v)
                sis.append(si)
                if tables is not None:
                    tables[row] += engine.score_hist(scores, mask[window],
                                                     bins[window])
            if merge == "candidates":
                cands.append((torch.stack(vs), torch.stack(sis)))
    out = [None] * len(queries)
    with span("stream.merge", merge=merge):
        if merge == "buffer":        # the resident path's finalize
            kk = min(k, mask.numel())
            finals = [engine.device_top_k(buf[row].view(-1), mask,
                                          lane2sorted, kk)
                      for row in range(len(order))]
            hists = ([engine.score_hist(buf[row].view(-1), mask, bins)
                      for row in range(len(order))] if config.evalue
                     else None)
            engine._collect_hits(packed, config, order,
                                 [f[0] for f in finals],
                                 [f[1] for f in finals], hists, out)
            return out, padded_rows, lane_positions
        # host merge: global (score desc, sorted index asc) over the union
        # of per-window candidates, which holds the global top-k
        v_all = torch.cat([c[0] for c in cands], dim=1).cpu().numpy()
        i_all = torch.cat([c[1] for c in cands], dim=1).cpu().numpy()
        if config.evalue:
            tabs = tables.cpu().numpy()
            _, bin_logl = stats.length_bins(packed.lengths)
        for row, p in enumerate(order):
            v, i = v_all[row], i_all[row]
            by = np.lexsort((i, -v))
            out[p] = engine._hits_from(packed, v[by], i[by], k)
            if config.evalue:
                stats.attach_evalues(out[p], stats.fit_evalue_model_hist(
                    tabs[row], bin_logl), packed.lengths)
    return out, padded_rows, lane_positions
