"""Scorers of one (or one packed) query profile against the packed DB
(counterpart of swimm_tpu/ops/pallas_scorer.py's ``score_tiles``,
``score_tiles_packed`` and ``score_chunk``, and of
swimm_tpu/ops/xla_scorer.py's ``score_tiles``).

Each wrapper launches its hand-written CUDA kernel on a CUDA tensor and
runs its plain PyTorch version (``*_ref``) on a CPU tensor:

  score_tiles         sw_ragged_kernel         (csrc/sw_ragged.cu)
  score_tiles_packed  sw_ragged_packed_kernel  (csrc/sw_ragged.cu)
  score_chunk         sw_chunk_kernel          (csrc/sw_chunk.cu)

There is no fallback from one to the other: a CUDA tensor either reaches
the kernel or raises.

The plain versions share ``walk_ref``, the column-vectorised two-pass
recurrence of xla_scorer.score_tiles in int32: per db position,
Ht = max(Hdiag + S, E, 0) over the whole query column, then F recovered
exactly as an exclusive cumulative max of Ht (valid because gap_open >= 0:
a gap never profitably re-opens inside a gap), H = max(Ht, F). All blocks
step together, shortest first: a block leaves the working set when its
tiles run out, so there is one torch op per (db position of the longest
block, step of the recurrence) and no work on finished blocks.
"""

from __future__ import annotations

import bisect
import ctypes

import torch

NEG = -(1 << 28)   # same floor as the CUDA kernels (csrc/sw_ragged.cu)
JT = 32            # db positions per tile (PackedDb.flat_tiles)


def check_gaps(gap_open: int, gap_extend: int) -> None:
    """gap_open >= 0 and gap_extend >= 0 are load-bearing for exactness:
    the plain version's F recovery needs goe >= ge; ge == 0 (flat gap cost)
    is legal."""
    if gap_open < 0:
        raise ValueError(f"gap_open must be >= 0 (got {gap_open})")
    if gap_extend < 0:
        raise ValueError(f"gap_extend must be >= 0 (got {gap_extend})")


def max_query_pad() -> int:
    """Largest padded query length scored in one pass; longer queries go
    through the query-tiled path (ops/longquery.py)."""
    return 2048


def row_starts(outrow: torch.Tensor, n_rows: int) -> torch.Tensor:
    """(n_rows + 1,) int64 first tile of each output row (+ the end), from
    the nondecreasing (T,) tile -> row map."""
    counts = torch.bincount(outrow.long(), minlength=n_rows)[:n_rows]
    out = torch.zeros(n_rows + 1, dtype=torch.int64, device=outrow.device)
    torch.cumsum(counts, 0, out=out[1:])
    return out


def check_precision(precision: str) -> None:
    """'f32' | 'int32' are the JAX package's kernel dtypes, accepted for
    its contract; every scorer here computes exact int32."""
    if precision not in ("f32", "int32"):
        raise ValueError(f"precision must be 'f32' or 'int32' "
                         f"(got {precision!r})")


def check_profile(qp) -> None:
    if qp.dim() != 2 or qp.shape[0] != 32 or qp.dtype != torch.int32:
        raise ValueError(f"qp must be (32, m) int32 (got "
                         f"{tuple(qp.shape)} {qp.dtype})")
    if qp.shape[1] % 8 or qp.shape[1] == 0:
        raise ValueError(f"profile length {qp.shape[1]} must be a positive "
                         "multiple of 8")


def check_stream(tiles, outrow, qp, row_start=None) -> None:
    """Shape/type/device/contiguity checks shared by the stream kernels."""
    if tiles.dim() != 3 or tiles.dtype != torch.int8:
        raise ValueError(f"tiles must be (T, jt, V) int8 (got "
                         f"{tuple(tiles.shape)} {tiles.dtype})")
    T, jt, V = tiles.shape
    if not 0 < V <= 1024:
        raise ValueError(f"lane width V={V} must be in 1..1024")
    if outrow.shape != (T,) or outrow.dtype != torch.int32:
        raise ValueError(f"outrow must be ({T},) int32")
    check_profile(qp)
    tensors = [tiles, outrow, qp]
    if row_start is not None:
        if row_start.dtype != torch.int64:
            raise ValueError("row_start must be int64")
        tensors.append(row_start)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("tiles, outrow, qp and row_start must share a device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("tiles, outrow, qp and row_start must be contiguous")


def walk_ref(tiles, row_start, n_rows: int, qp, gap_open: int,
             gap_extend: int, ceiling: int | None = None,
             hcar=None, fcar=None):
    """Plain PyTorch walk of the ragged stream for one (32, m) profile.

    hcar/fcar (T, jt, V) int32, optional: the row above the profile's first
    row at every db position (its H, and the F entering the first row).
    Without them the boundary is H = 0, F = NEG. Returns (scores (n_rows, V)
    int32, hcar_out, fcar_out), where the carries (None without input
    carries) hold the profile's last row: its H and the F entering the row
    below it — the same carries the CUDA kernels emit.

    Blocks are taken in order of tile count; at tile step t the working set
    is the blocks that still have a t-th tile (a suffix of that order), so
    the state tensors shrink as short blocks finish.
    """
    T, jt, V = tiles.shape
    m = qp.shape[1]
    dev = tiles.device
    goe, ge = gap_open + gap_extend, gap_extend
    i32 = torch.int32
    qpt = qp.t().contiguous()                              # (m, 32)
    ramp = ((torch.arange(m, device=dev, dtype=i32) + 1) * ge)[:, None]
    carry = hcar is not None
    hout = torch.empty_like(hcar) if carry else None
    fout = torch.empty_like(fcar) if carry else None
    counts = row_start[1:] - row_start[:-1]
    order = torch.argsort(counts, stable=True)             # short first
    done_at = counts[order].tolist()       # block i (in order) has no tile t
    first = 0                              # for t >= done_at[i]
    n_all = n_rows * V
    smax = torch.zeros(n_all, dtype=i32, device=dev)       # in `order`
    H = torch.zeros((m, n_all), dtype=i32, device=dev)
    E = torch.full((m, n_all), NEG, dtype=i32, device=dev)
    htop = torch.zeros((1, n_all), dtype=i32, device=dev)  # H(row -1, j-1)
    for t in range(done_at[-1] if done_at else 0):
        live = bisect.bisect_right(done_at, t)
        if live > first:                   # drop the blocks that finished
            cut = (live - first) * V
            H, E, htop = H[:, cut:], E[:, cut:], htop[:, cut:]
            first = live
        nb = n_rows - first
        N = nb * V
        tidx = row_start[order[first:]] + t                # (nb,) tile ids

        def lanes(x):   # (nb, jt, V) -> (jt, nb*V): db position major
            return x[tidx].permute(1, 0, 2).reshape(jt, N)

        def back(x):    # (jt, nb*V) -> (nb, jt, V) in tidx order
            return x.reshape(jt, nb, V).permute(1, 0, 2)

        codes = lanes(tiles).long() & 31
        if carry:
            hc, fc = lanes(hcar), lanes(fcar)
            ho = torch.empty((jt, N), dtype=i32, device=dev)
            fo = torch.empty((jt, N), dtype=i32, device=dev)
        neg_row = torch.full((1, N), NEG, dtype=i32, device=dev)
        best = smax[first * V:]
        for j in range(jt):
            s = qpt[:, codes[j]]                           # (m, N)
            hd = torch.cat([htop, H[:-1]])
            E = torch.maximum(H - goe, E - ge)
            Ht = torch.maximum(hd + s, E).clamp_min_(0)
            G = torch.cummax(Ht - goe + ramp, dim=0).values
            F = torch.cat([neg_row, G[:-1] - ramp[:-1]])
            if carry:
                F = torch.maximum(F, fc[j][None] - (ramp - ge))
                htop = hc[j][None]
            H = torch.maximum(Ht, F)
            if ceiling is not None:
                H = H.clamp_max_(ceiling)
            torch.maximum(best, H.amax(dim=0), out=best)
            if carry:
                ho[j] = H[-1]
                fo[j] = torch.maximum(H[-1] - goe, F[-1] - ge)
        if carry:
            hout[tidx] = back(ho)
            fout[tidx] = back(fo)
    out = torch.empty((n_rows, V), dtype=i32, device=dev)
    out[order] = smax.reshape(n_rows, V)
    return out, hout, fout


def score_tiles_ref(tiles, outrow, n_rows: int, qp, gap_open: int,
                    gap_extend: int, ceiling: int | None = None,
                    row_start=None) -> torch.Tensor:
    """Plain PyTorch version of score_tiles (any device)."""
    check_gaps(gap_open, gap_extend)
    if row_start is None:
        row_start = row_starts(outrow, n_rows)
    return walk_ref(tiles, row_start, n_rows, qp, gap_open, gap_extend,
                    ceiling)[0]


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
RAGGED_SIGNATURES = {
    "sw_ragged_launch": [_PTR, _PTR, _INT, _INT, _INT, _PTR, _INT, _INT,
                         _INT, _INT, _INT, _PTR, _PTR, _PTR, _PTR],
    "sw_ragged_qtile_launch": [_PTR, _PTR, _INT, _INT, _INT, _PTR, _INT,
                               _INT, _INT, _PTR, _PTR, _PTR, _PTR],
    "sw_ragged_packed_launch": [_PTR, _PTR, _INT, _INT, _INT, _PTR, _INT,
                                _PTR, _INT, _INT, _INT, _PTR, _PTR, _PTR,
                                _PTR],
}
CHUNK_SIGNATURES = {
    "sw_chunk_launch": [_PTR, _INT, _INT, _INT, _PTR, _INT, _INT, _INT,
                        _INT, _INT, _PTR, _PTR, _PTR, _PTR],
    "sw_chunk_qtile_launch": [_PTR, _INT, _INT, _INT, _PTR, _INT, _INT,
                              _INT, _PTR, _PTR, _PTR, _PTR],
}


def kernels():
    """The built sw_ragged library: the three kernels over the whole-DB
    tile stream (compiled on first call)."""
    from swimm_tpu_torch.ops import _build
    return _build.load("sw_ragged", RAGGED_SIGNATURES)


def chunk_kernels():
    """The built sw_chunk library: the two kernels over one rectangular
    chunk (compiled on first call)."""
    from swimm_tpu_torch.ops import _build
    return _build.load("sw_chunk", CHUNK_SIGNATURES)


def build_kernels() -> None:
    """Build and load every CUDA source of the package now, side by side
    (one nvcc per source), instead of at each kernel's first launch."""
    from swimm_tpu_torch.ops import _build
    _build.build("sw_ragged", "sw_chunk")
    kernels()
    chunk_kernels()


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def strip_scratch(m: int, like: torch.Tensor):
    """Carry scratch between the strips of an m-row profile (32 rows, then
    8): two int32 tensors shaped like the codes, or (None, None) when the
    profile fits one strip. Returned so they outlive the launch call."""
    if m // 32 + (m % 32) // 8 <= 1:
        return None, None
    ch = torch.empty(like.shape, dtype=torch.int32, device=like.device)
    return ch, torch.empty_like(ch)


def _ptr(t):
    return None if t is None else t.data_ptr()


def score_tiles(tiles, outrow, n_rows: int, qp, gap_open: int,
                gap_extend: int, precision: str = "f32",
                ceiling: int | None = None,
                row_start=None) -> torch.Tensor:
    """Score an entire ragged tile stream (all blocks, any lengths) in ONE
    kernel launch.

    Args:
      tiles: (T, jt, V) int8 packed db codes, block-major.
      outrow: (T,) int32 tile -> output row, nondecreasing (0..n_rows-1).
      n_rows: number of output rows (total blocks).
      qp: (32, m) int32 query profile; m % 8 == 0, m <= max_query_pad().
      precision: 'f32' | 'int32' — accepted for the JAX package's contract;
        both compute exact int32.
      ceiling: saturating tier — lanes whose exact score reaches it report
        exactly `ceiling`, the others their exact score.
      row_start: optional cached row_starts(outrow, n_rows).

    Returns: (n_rows, V) int32 exact local-alignment scores.
    """
    check_gaps(gap_open, gap_extend)
    check_precision(precision)
    check_stream(tiles, outrow, qp, row_start)
    if qp.shape[1] > max_query_pad():
        raise ValueError(f"profile length {qp.shape[1]} exceeds "
                         f"max_query_pad()={max_query_pad()}; use "
                         "longquery.score_tiles_long")
    if tiles.device.type == "cpu":
        return score_tiles_ref(tiles, outrow, n_rows, qp, gap_open,
                               gap_extend, ceiling, row_start)
    if tiles.device.type != "cuda":
        raise ValueError(f"unsupported device {tiles.device}")
    if row_start is None:
        row_start = row_starts(outrow, n_rows)
    T, jt, V = tiles.shape
    m = qp.shape[1]
    out = torch.empty((n_rows, V), dtype=torch.int32, device=tiles.device)
    ch, cf = strip_scratch(m, tiles)
    err = kernels().sw_ragged_launch(
        tiles.data_ptr(), row_start.data_ptr(), n_rows, V, jt,
        qp.data_ptr(), m, gap_open + gap_extend, gap_extend,
        int(ceiling is not None), int(ceiling or 0), _ptr(ch), _ptr(cf),
        out.data_ptr(), torch.cuda.current_stream(tiles.device).cuda_stream)
    raise_on(err, "sw_ragged_kernel")
    score_tiles.launches += 1
    return out


score_tiles.launches = 0   # sw_ragged_kernel launches (never the plain path)


def check_segments(seg_of_group, qp, n_seg_cap: int) -> None:
    """Shape, type and order of a pack's segment ids, the same on every
    device. The order is read from the data (one scalar comes back from the
    device): ids out of order would give wrong planes without any error."""
    if n_seg_cap < 2 or n_seg_cap % 2:
        raise ValueError(f"n_seg_cap={n_seg_cap} must be a positive even "
                         "number (one score plane per even segment id)")
    if (seg_of_group.shape != (qp.shape[1] // 8,)
            or seg_of_group.dtype != torch.int32
            or seg_of_group.device != qp.device
            or not seg_of_group.is_contiguous()):
        raise ValueError(f"seg_of_group must be a contiguous "
                         f"({qp.shape[1] // 8},) int32 tensor on the "
                         "profile's device")
    if bool((seg_of_group[1:] < seg_of_group[:-1]).any()):
        raise ValueError("seg_of_group must be nondecreasing")


def score_tiles_packed_ref(tiles, outrow, n_rows: int, qp, seg_of_group,
                           gap_open: int, gap_extend: int,
                           n_seg_cap: int = 48,
                           row_start=None) -> torch.Tensor:
    """Plain PyTorch version of score_tiles_packed (any device): every
    query of the pack (the columns of one even segment id) walked alone,
    as if it had never been packed. seg_of_group as check_segments
    accepts it."""
    check_gaps(gap_open, gap_extend)
    if row_start is None:
        row_start = row_starts(outrow, n_rows)
    seg = seg_of_group.tolist()
    n_planes = n_seg_cap // 2
    out = torch.zeros((n_rows, n_planes, tiles.shape[2]), dtype=torch.int32,
                      device=tiles.device)
    for sid in sorted(set(seg)):
        if sid < 0 or sid % 2 or sid // 2 >= n_planes:
            continue       # separators, the tail, ids past the planes
        g0 = seg.index(sid)
        rows = slice(g0 * 8, (g0 + seg.count(sid)) * 8)
        out[:, sid // 2] = walk_ref(tiles, row_start, n_rows,
                                    qp[:, rows].contiguous(), gap_open,
                                    gap_extend)[0]
    return out


def score_tiles_packed(tiles, outrow, n_rows: int, qp, seg_of_group,
                       gap_open: int, gap_extend: int, n_seg_cap: int = 48,
                       precision: str = "f32",
                       row_start=None) -> torch.Tensor:
    """Score a ragged tile stream against a PACKED multi-query profile
    (models/qpack.build_query_packs) in ONE kernel launch.

    Args:
      tiles/outrow/n_rows/row_start/precision: as score_tiles.
      qp: (32, M) int32 packed profile, M % 8 == 0 (packs are multiples of
        64), read as it is (separator columns hold qpack.SEP_SCORE).
      seg_of_group: (M/8,) int32 nondecreasing segment id of every 8-row
        group: 2s for query s, odd ids for separators and the tail.
      n_seg_cap: segment-id count (models/qpack.N_SEG_CAP).

    Returns: (n_rows, n_seg_cap // 2, V) int32 — exact per-(block, query
    plane, lane) scores; plane p holds segment id 2p, so entry.seg // 2
    indexes its plane. Unused planes, and rows with no tiles, hold zeros;
    ids outside 0..n_seg_cap-1 are ignored.
    """
    check_gaps(gap_open, gap_extend)
    check_precision(precision)
    check_stream(tiles, outrow, qp, row_start)
    check_segments(seg_of_group, qp, n_seg_cap)
    if tiles.device.type == "cpu":
        return score_tiles_packed_ref(tiles, outrow, n_rows, qp,
                                      seg_of_group, gap_open, gap_extend,
                                      n_seg_cap, row_start)
    if tiles.device.type != "cuda":
        raise ValueError(f"unsupported device {tiles.device}")
    if row_start is None:
        row_start = row_starts(outrow, n_rows)
    T, jt, V = tiles.shape
    m = qp.shape[1]
    n_planes = n_seg_cap // 2
    out = torch.zeros((n_rows, n_planes, V), dtype=torch.int32,
                      device=tiles.device)
    ch, cf = strip_scratch(m, tiles)
    err = kernels().sw_ragged_packed_launch(
        tiles.data_ptr(), row_start.data_ptr(), n_rows, V, jt,
        qp.data_ptr(), m, seg_of_group.data_ptr(), n_planes,
        gap_open + gap_extend, gap_extend, _ptr(ch), _ptr(cf),
        out.data_ptr(), torch.cuda.current_stream(tiles.device).cuda_stream)
    raise_on(err, "sw_ragged_packed_kernel")
    score_tiles_packed.launches += 1
    return out


score_tiles_packed.launches = 0   # sw_ragged_packed_kernel launches


def check_chunk(codes, qp) -> None:
    """Shape/type/device/contiguity checks shared by the chunk kernels."""
    if codes.dim() != 3 or codes.dtype != torch.int8:
        raise ValueError(f"codes must be (B, L, V) int8 (got "
                         f"{tuple(codes.shape)} {codes.dtype})")
    B, L, V = codes.shape
    if L == 0 or L % JT:
        raise ValueError(f"chunk length L={L} must be a positive multiple "
                         f"of {JT}")
    if not 0 < V <= 1024:
        raise ValueError(f"lane width V={V} must be in 1..1024")
    check_profile(qp)
    if codes.device != qp.device:
        raise ValueError("codes and qp must share a device")
    if not (codes.is_contiguous() and qp.is_contiguous()):
        raise ValueError("codes and qp must be contiguous")


def chunk_as_stream(codes):
    """A (B, L, V) chunk seen as a block-major tile stream (a reshape: a
    chunk's codes are block-major). Returns (tiles (B*L/32, 32, V),
    row_start (B + 1,) int64)."""
    B, L, V = codes.shape
    row_start = torch.arange(B + 1, dtype=torch.int64,
                             device=codes.device) * (L // JT)
    return codes.reshape(B * (L // JT), JT, V), row_start


def score_chunk_ref(codes, qp, gap_open: int, gap_extend: int,
                    ceiling: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of score_chunk (any device)."""
    check_gaps(gap_open, gap_extend)
    tiles, row_start = chunk_as_stream(codes)
    return walk_ref(tiles, row_start, codes.shape[0], qp, gap_open,
                    gap_extend, ceiling)[0]


def score_chunk(codes, qp, gap_open: int, gap_extend: int,
                precision: str = "f32", jt_steps: int | None = None,
                ceiling: int | None = None,
                lanes_per_block: int | None = None) -> torch.Tensor:
    """Score every lane of one packed chunk against one query in ONE
    kernel launch.

    Args:
      codes: (B, L, V) int8 packed db codes; L % 32 == 0 (guaranteed by
        db.py's length quantization).
      qp: (32, m) int32 query profile; m % 8 == 0, m <= max_query_pad().
      precision: 'f32' | 'int32' — both compute exact int32.
      jt_steps, lanes_per_block: the JAX package's tiling choices for its
        kernel grid, accepted and validated for its contract (jt_steps must
        divide L, lanes_per_block must be positive); results do not depend
        on them and the CUDA kernel has no use for them.
      ceiling: as score_tiles.

    Returns: (B, V) int32 exact local-alignment scores.
    """
    check_gaps(gap_open, gap_extend)
    check_precision(precision)
    check_chunk(codes, qp)
    B, L, V = codes.shape
    m = qp.shape[1]
    if m > max_query_pad():
        raise ValueError(f"profile length {m} exceeds max_query_pad()="
                         f"{max_query_pad()}; use "
                         "longquery.score_chunk_long")
    if jt_steps is not None and (jt_steps <= 0 or L % jt_steps):
        raise ValueError(f"L={L} not a multiple of jt_steps={jt_steps}")
    if lanes_per_block is not None and lanes_per_block <= 0:
        raise ValueError(f"lanes_per_block={lanes_per_block} must be "
                         "positive")
    if codes.device.type == "cpu":
        return score_chunk_ref(codes, qp, gap_open, gap_extend, ceiling)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    out = torch.empty((B, V), dtype=torch.int32, device=codes.device)
    ch, cf = strip_scratch(m, codes)
    err = chunk_kernels().sw_chunk_launch(
        codes.data_ptr(), B, L, V, qp.data_ptr(), m, gap_open + gap_extend,
        gap_extend, int(ceiling is not None), int(ceiling or 0), _ptr(ch),
        _ptr(cf), out.data_ptr(),
        torch.cuda.current_stream(codes.device).cuda_stream)
    raise_on(err, "sw_chunk_kernel")
    score_chunk.launches += 1
    return out


score_chunk.launches = 0   # sw_chunk_kernel launches
