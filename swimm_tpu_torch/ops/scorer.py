"""Scorers of one (or one packed) query profile against the packed DB
(counterpart of swimm_tpu/ops/pallas_scorer.py's ``score_tiles``,
``score_tiles_packed`` and ``score_chunk``, and of
swimm_tpu/ops/xla_scorer.py's ``score_tiles``).

Each wrapper launches its hand-written CUDA kernel on a CUDA tensor and
runs its plain PyTorch version (``*_ref``) on a CPU tensor:

  score_tiles         sw_ragged_kernel         (csrc/sw_ragged.cu)
  score_tiles_packed  sw_ragged_packed_kernel  (csrc/sw_ragged.cu)
  score_chunks        sw_chunk_kernel          (csrc/sw_chunk.cu)

``score_tiles`` runs kernel 1 in its pair form (``_tiles_pairs``,
``sw_ragged_kernel<false, true>``: two lanes a thread in 16-bit halves)
where the input allows it (``pair_form_fits``, no ceiling), and in its int32
form (``score_tiles_int32``, ``sw_ragged_kernel<CEIL>``) otherwise. A lane
of the pair form whose H stays below ``pair_limit`` (32,767 minus the
largest profile entry) is exact; one that reaches it may have wrapped, and
its maximum says so, since the H that first passes the limit is exact and
goes into it. So every DB block with a lane at or above the limit is scored
again in int32 on a sub-stream of those blocks (``rescore_flagged``;
``score_tiles.rescored_blocks`` counts them), unless the sum of the
profile's row maxima, a bound on every H, stays below the limit.
``_pair_guard`` is that guard, for kernel 1 here and kernel 2 in
ops/longquery.py.

A CUDA block walks a DB block no faster than one SM, so a block much longer
than its launch's share of positions a slot runs on alone after the rest.
Given a ``Split``, the pair form's launch walks such blocks with two or
four CUDA blocks each (the split walk, ``sw_ragged_kernel<false, true,
true>``). ``split_plan`` chooses them on the host from the blocks' lengths,
the profile's strips and the card's slots (``split_parts``, ``split_map``,
``split_slots``); ops/lanes.py keeps one plan per stream and length.

(``score_chunk`` is the one-chunk case of ``score_chunks``.) There is no
fallback from one to the other: a CUDA tensor either reaches the kernel or
raises. Each launch, and every allocation it needs, runs under
``torch.cuda.device`` of its tensors, so a tensor on ``cuda:1`` is scored
by cuda:1 whatever device the calling thread has current. ``ChunkTable`` is what the chunk kernels need to take a list of
chunks in one launch (sw_chunk_kernel here, sw_chunk_qtile_kernel through
ops/longquery.py).

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
from dataclasses import dataclass

import numpy as np
import torch

from swimm_tpu_torch.utils import metrics

NEG = -(1 << 28)   # same floor as the CUDA kernels (csrc/sw_ragged.cu)
JT = 32            # db positions per tile (PackedDb.flat_tiles)
MAX_LANES = 512    # lane width V at most: a CUDA block has a thread per lane
# (per worker). All five kernels are compiled for at most 512 threads
# (csrc/sw_walk_hg.cuh HG_MAX_THREADS), so on an H100 all five launch at
# V = 512 and none at V = 544. The same limit on every device, so the CPU
# tests see the card's


MAX_GAP = 1 << 19  # gap_open and gap_extend at most (real penalties are tens)
# Every scorer computes in int32. Where each would first wrap, with goe =
# gap_open + gap_extend and H <= 34,816 (2,048 rows in one pass times 17,
# the largest entry of the package's matrices):
#   the kernels (csrc/sw_walk_hg.cuh) keep hg = H - goe and an F >= -goe
#     (or NEG), and form F - goe and NEG - goe:       goe <= 2^30
#   the plain walk (walk_ref) adds the ramp (m - 1) * ge to H, and
#     subtracts it from an incoming F that may be NEG = -2^28:
#     one pass of m = 2,048 rows                      ge <= 1,049,071
#     a query tile or a pack of m <= 1,024 rows       ge <= 1,836,801
# so the largest safe gaps are gap_extend <= 1,049,071 and goe <= 2^30.
# MAX_GAP is the simpler bound inside that: a one-pass plain walk of up to
# (2^31 - 2^28) / 2^19 = 3,584 rows stays in range (walk_ref refuses more).
# swimm_tpu has no such check and returns wrong scores past the bound.
RAMP_LIMIT = (1 << 31) + NEG   # the plain walk's largest (m - 1) * ge

PAIR_MAX = 32767   # the largest value of a 16-bit lane


def pair_form_fits(V: int, gap_open: int, gap_extend: int, lo: int,
                   hi: int) -> bool:
    """Whether the pair form of kernels 1 and 2 may score V lanes at these
    gaps with profile entries in lo..hi: workers of V / 2 threads fill
    whole warps, every staged entry S + goe fits 16 bits, and F - goe >=
    -2 goe does not wrap (csrc/sw_walk_hg.cuh's note gives the proof)."""
    goe = gap_open + gap_extend
    return (V % 64 == 0 and 2 * goe <= PAIR_MAX + 1 and lo >= -PAIR_MAX - 1
            and hi + goe <= PAIR_MAX)


def pair_limit(hi: int) -> int:
    """T: below it a lane of the pair form is exact for a profile whose
    largest entry is hi (no H + S can pass 32,767 while H < T)."""
    return PAIR_MAX - hi


def pair_word(x: int) -> int:
    """The int32 lane pair that holds the 16-bit value x in both lanes."""
    w = (x & 0xFFFF) * 0x10001
    return w - (1 << 32) if w >= 1 << 31 else w


def to_pairs(x: torch.Tensor) -> torch.Tensor:
    """(..., V) int32 values in the int16 range (any others keep their low 16
    bits) -> (..., V / 2) int32 lane pairs: lane 2u in the low half, 2u + 1
    in the high half."""
    w = (x[..., 0::2].long() & 0xFFFF) | ((x[..., 1::2].long() & 0xFFFF)
                                          << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).int()


def from_pairs(p: torch.Tensor) -> torch.Tensor:
    """(..., V / 2) int32 lane pairs -> (..., V) int32, each half
    sign-extended."""
    w = p.long()
    lo = ((w & 0xFFFF) ^ 0x8000) - 0x8000
    hi = (((w >> 16) & 0xFFFF) ^ 0x8000) - 0x8000
    return torch.stack([lo, hi], dim=-1).flatten(-2).int()


def profile_bounds(qp) -> tuple:
    """(lo, hi, top) of a (32, m) profile: its least and largest entries,
    and the sum of its rows' largest entries (at least 0 each), which no H
    can pass. One copy to the host: callers on the search paths take them
    from the profile on the host, where it is built, so that a launch on
    the card does not wait for the device."""
    return tuple(torch.stack([qp.min(), qp.max(),
                              qp.amax(dim=0).clamp_min(0).sum()]).tolist())


def check_gaps(gap_open: int, gap_extend: int) -> None:
    """gap_open >= 0 and gap_extend >= 0 are load-bearing for exactness:
    the plain version's F recovery needs goe >= ge; ge == 0 (flat gap cost)
    is legal. Both at most MAX_GAP, on every device, or int32 wraps."""
    if gap_open < 0:
        raise ValueError(f"gap_open must be >= 0 (got {gap_open})")
    if gap_extend < 0:
        raise ValueError(f"gap_extend must be >= 0 (got {gap_extend})")
    if gap_open > MAX_GAP or gap_extend > MAX_GAP:
        raise ValueError(f"gap_open and gap_extend must be at most "
                         f"{MAX_GAP} (got {gap_open}/{gap_extend}): larger "
                         "penalties overflow the int32 scores")


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


def substream(tiles: torch.Tensor, cum: np.ndarray, rows: np.ndarray):
    """The blocks `rows` (ascending) of a tile stream as a stream of their
    own, gathered on the device; cum is the stream's row_starts on the
    host. Returns (tiles, outrow, row_start)."""
    counts = cum[rows + 1] - cum[rows]
    first = np.cumsum(counts) - counts
    tidx = (np.repeat(cum[rows] - first, counts)
            + np.arange(int(counts.sum()), dtype=np.int64))
    dev = tiles.device
    sub = tiles.index_select(0, torch.from_numpy(tidx).to(dev))
    outrow = torch.from_numpy(np.repeat(
        np.arange(len(rows), dtype=np.int32), counts)).to(dev)
    return sub, outrow, row_starts(outrow, len(rows))


def rescore_flagged(best, limit: int, tiles, row_start, rescore) -> int:
    """The pair form's second pass: every block (row of best, (n_rows, V))
    with a lane at or above limit is scored again by rescore(tiles, outrow,
    n_rows, row_start) on a sub-stream of those blocks, in place. The
    flagged rows come back to the host. Returns their count."""
    rows = torch.nonzero((best >= limit).any(dim=1)).flatten().cpu().numpy()
    if len(rows):
        sub, o, rs = substream(tiles, row_start.cpu().numpy(), rows)
        best[torch.from_numpy(rows).to(best.device)] = rescore(
            sub, o, len(rows), rs)
    return len(rows)


def _pair_guard(wrapper, tiles, outrow, n_rows: int, row_start, qp,
                gap_open: int, gap_extend: int, bounds, pairs, int32):
    """The 16-bit guard of kernels 1 and 2 (wrapper: score_tiles or
    longquery.score_tiles_long, whose rescored_blocks it counts). Where
    pair_form_fits allows it, pairs over the whole stream, then, unless the
    profile's top stays below pair_limit(hi), int32 over the blocks with a
    lane at or above it (rescore_flagged); else int32 over the whole
    stream. pairs and int32 take (tiles, outrow, n_rows, row_start).
    bounds: profile_bounds(qp), or None to read them from qp (on a card a
    wait for the device before the launch)."""
    lo, hi, top = profile_bounds(qp) if bounds is None else bounds
    if not pair_form_fits(tiles.shape[2], gap_open, gap_extend, lo, hi):
        return int32(tiles, outrow, n_rows, row_start)
    best = pairs(tiles, outrow, n_rows, row_start)
    if top >= pair_limit(hi):          # a lane may have reached the limit
        wrapper.rescored_blocks += rescore_flagged(best, pair_limit(hi),
                                                   tiles, row_start, int32)
    return best


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


def check_lanes(V: int) -> None:
    if not 0 < V <= MAX_LANES:
        raise ValueError(f"lane width V={V} must be in 1..{MAX_LANES}")


def check_stream(tiles, outrow, qp, row_start=None) -> None:
    """Shape/type/device/contiguity checks shared by the stream kernels."""
    if tiles.dim() != 3 or tiles.dtype != torch.int8:
        raise ValueError(f"tiles must be (T, jt, V) int8 (got "
                         f"{tuple(tiles.shape)} {tiles.dtype})")
    T, jt, V = tiles.shape
    check_lanes(V)
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
    if (m - 1) * gap_extend > RAMP_LIMIT:
        raise ValueError(f"a {m}-row profile at gap_extend={gap_extend} "
                         "overflows the plain walk's int32 ramp")
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
                         _INT, _INT, _INT, _PTR, _PTR, _PTR],
    "sw_ragged_pairs_launch": [_PTR, _PTR, _INT, _INT, _INT, _PTR, _INT,
                               _INT, _INT, _PTR, _PTR, _PTR],
    "sw_ragged_split_launch": [_PTR, _PTR, _INT, _INT, _INT, _INT, _PTR,
                               _INT, _INT, _INT, _PTR, _PTR, _PTR, _PTR,
                               _PTR],
    "sw_ragged_split_slots": [_INT, _INT, _PTR],
    "sw_ragged_qtile_launch": [_PTR, _PTR, _INT, _INT, _INT, _PTR, _INT,
                               _INT, _INT, _PTR, _PTR, _PTR, _PTR],
    "sw_ragged_qtile_pairs_launch": [_PTR, _PTR, _INT, _INT, _INT, _PTR,
                                     _INT, _INT, _INT, _PTR, _PTR, _PTR,
                                     _PTR],
    "sw_ragged_packed_launch": [_PTR, _PTR, _INT, _INT, _INT, _PTR, _INT,
                                _PTR, _INT, _INT, _INT, _PTR, _PTR, _PTR],
}
CHUNK_SIGNATURES = {
    "sw_chunk_launch": [_PTR, _PTR, _PTR, _INT, _INT, _PTR, _INT, _INT,
                        _INT, _INT, _INT, _PTR],
    "sw_chunk_qtile_launch": [_PTR, _PTR, _PTR, _INT, _INT, _PTR, _INT,
                              _INT, _INT, _PTR],
}


def kernels():
    """The built sw_ragged library: the three kernels over the whole-DB
    tile stream (compiled on first call)."""
    from swimm_tpu_torch.ops import _build
    return _build.load("sw_ragged", RAGGED_SIGNATURES)


def chunk_kernels():
    """The built sw_chunk library: the two kernels over a list of
    rectangular chunks (compiled on first call)."""
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


def strip_carry(m: int, shape, device, pairs: bool = False):
    """Carry scratch between the strips of an m-row profile (32 rows, then
    8) for the kernels on the walk of csrc/sw_walk_hg.cuh: one (H - goe, F)
    int32 pair per code byte, shaped (*shape, 2); for kernel 1's pair form
    (pairs, shape the codes' (T, jt, V)), two int32 streams of lane pairs,
    H then F, shaped (2, T, jt, V / 2): half the bytes. None when the
    profile fits one strip. Returned so it outlives the launch call."""
    if m // 32 + (m % 32) // 8 <= 1:
        return None
    if pairs:
        return torch.empty((2, *shape[:-1], shape[-1] // 2),
                           dtype=torch.int32, device=device)
    return torch.empty((*shape, 2), dtype=torch.int32, device=device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def check_tiles(tiles, outrow, qp, gap_open: int, gap_extend: int,
                row_start=None) -> None:
    """What kernel 1 takes in either form: the stream checks, the gaps, a
    profile of at most max_query_pad() rows, a CPU or CUDA device."""
    check_gaps(gap_open, gap_extend)
    check_stream(tiles, outrow, qp, row_start)
    if qp.shape[1] > max_query_pad():
        raise ValueError(f"profile length {qp.shape[1]} exceeds "
                         f"max_query_pad()={max_query_pad()}; use "
                         "longquery.score_tiles_long")
    if tiles.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {tiles.device}")


def _tiles_int32(tiles, outrow, n_rows, qp, gap_open, gap_extend, ceiling,
                 row_start):
    if tiles.device.type == "cpu":
        return score_tiles_ref(tiles, outrow, n_rows, qp, gap_open,
                               gap_extend, ceiling, row_start)
    if row_start is None:
        row_start = row_starts(outrow, n_rows)
    T, jt, V = tiles.shape
    m = qp.shape[1]
    with torch.cuda.device(tiles.device):
        out = torch.empty((n_rows, V), dtype=torch.int32, device=tiles.device)
        carry = strip_carry(m, tiles.shape, tiles.device)
        err = kernels().sw_ragged_launch(
            tiles.data_ptr(), row_start.data_ptr(), n_rows, V, jt,
            qp.data_ptr(), m, gap_open + gap_extend, gap_extend,
            int(ceiling is not None), int(ceiling or 0), _ptr(carry),
            out.data_ptr(),
            torch.cuda.current_stream(tiles.device).cuda_stream)
    raise_on(err, "sw_ragged_kernel")
    score_tiles.launches += 1
    return out


def n_strips(m: int) -> int:
    """Strips of an m-row profile: 32 rows each, then 8 (csrc/sw_walk.cuh)."""
    return m // 32 + (m % 32) // 8


def pair_workers(V: int, m: int) -> int:
    """Workers of V / 2 threads per CUDA block of kernel 1's pair form, as
    csrc/sw_walk_hg.cuh hg_launch_shape gives them: four, as far as the
    thread limit and the strip count allow."""
    return max(1, min(4, MAX_LANES // (V // 2), n_strips(m)))


SPLIT_PARTS = (1, 2, 4)   # CUDA blocks that may walk one DB block


def split_parts(lens, m: int, V: int, slots: int,
                force: int | None = None) -> np.ndarray:
    """k_r, the CUDA blocks ("parts") that walk each DB block of one launch
    of kernel 1's pair form, from the blocks' positions (lens, on the host),
    the profile's rows m, the lanes V and the card's slots (CUDA blocks of
    the launch shape it holds at once: split_slots).

    A DB block takes about its positions times its rounds of strips (S
    workers a part take S * k strips a round), and no CUDA block is faster
    than one SM. k_r is the least of SPLIT_PARTS that brings a part's work
    within the launch's mean work a slot: lens_r * ceil(strips / (S k)) <=
    sum(lens) / slots * ceil(strips / S); the largest allowed where none
    does. No part without a strip: k <= ceil(strips / S). The parts of the
    split blocks, longest first, fill at most the slots (beyond them a part
    would not start in the launch's first wave); the rest take one. No
    block splits where the slots are fewer than two. force: every block
    takes that k (or the largest allowed below it), for tests of the walk."""
    lens = np.asarray(lens, dtype=np.int64)
    k = np.ones(len(lens), dtype=np.int64)
    S = pair_workers(V, m)
    rounds = -(-n_strips(m) // S)
    allowed = [p for p in SPLIT_PARTS if p <= min(rounds, slots)]
    if len(allowed) < 2 or not len(lens):
        return k
    if force is not None:
        k[:] = max(p for p in allowed if p <= force)
        return k
    budget = lens.sum() / slots * rounds
    if lens.max() * rounds <= budget:     # no block past its share
        return k
    k[:] = allowed[-1]
    for p in reversed(allowed):
        k[lens * -(-n_strips(m) // (S * p)) <= budget] = p
    order = longest_first(lens)
    over = np.cumsum(np.where(k[order] > 1, k[order], 0)) > slots
    k[order[over]] = 1
    return k


def longest_first(lens) -> np.ndarray:
    """The DB blocks in the order kernel 1 takes them: longest first, and
    among equals the last first (csrc/sw_ragged.cu block_row)."""
    lens = np.asarray(lens)
    return np.lexsort((-np.arange(len(lens)), -lens))


def split_map(lens, k) -> np.ndarray | None:
    """The split launch's block map for parts k (split_parts): one int32
    entry per CUDA block, row << 4 | part << 2 | (parts - 1), longest
    block first, a block's parts adjacent and part 0 first; None where
    every k is 1 (the unsplit launch)."""
    k = np.asarray(k, dtype=np.int64)
    if not (k > 1).any():
        return None
    order = longest_first(lens)
    ko = k[order]
    part = np.arange(int(ko.sum())) - np.repeat(np.cumsum(ko) - ko, ko)
    return (np.repeat(order, ko) << 4 | part << 2
            | np.repeat(ko - 1, ko)).astype(np.int32)


@dataclass(frozen=True)
class Split:
    """One launch of kernel 1's split walk: its block map (split_map) on
    the launch's device, and what the counters count of it."""
    block_map: torch.Tensor   # (CUDA blocks,) int32
    rows: int                 # DB blocks walked by more than one part
    parts: int                # CUDA blocks beyond one per DB block


def split_plan(lens, m: int, V: int, slots: int | None,
               force: int | None = None):
    """(block map on the host or None, split rows, extra parts) of one
    launch over DB blocks of lens positions (split_parts, split_map); no
    map without slots (a CPU device)."""
    if slots is None or V % 64:
        return None, 0, 0
    k = split_parts(lens, m, V, slots, force)
    return split_map(lens, k), int((k > 1).sum()), int((k - 1).sum())


def upload_split(plan, device) -> Split | None:
    """split_plan's plan as a Split on device, copied from pinned memory
    without a wait for the device; None for no map."""
    bmap, rows, parts = plan
    if bmap is None:
        return None
    host = torch.from_numpy(bmap)
    if torch.device(device).type == "cuda":
        host = host.pin_memory()
    return Split(host.to(device, non_blocking=True), rows, parts)


_SLOTS: dict = {}


def split_slots(device, V: int) -> int | None:
    """The split walk's slots on a card (sw_ragged_split_slots: SMs times
    its resident CUDA blocks per SM, at four workers of V / 2 threads);
    None on the CPU, which walks nothing split. Once per (card, V)."""
    device = torch.device(device)
    if device.type != "cuda" or V % 64:
        return None
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), V)
    if key not in _SLOTS:
        got = ctypes.c_int(0)
        with torch.cuda.device(key[0]):
            raise_on(kernels().sw_ragged_split_slots(
                V, max_query_pad(), ctypes.byref(got)), "sw_ragged_kernel")
        _SLOTS[key] = got.value
    return _SLOTS[key]


def _tiles_pairs(tiles, outrow, n_rows, qp, gap_open, gap_extend,
                 row_start, split=None):
    """Kernel 1 in its pair form, with no second pass, on checked inputs
    that pair_form_fits accepts: one launch of sw_ragged_kernel<false,
    true>, or with a Split of sw_ragged_kernel<false, true, true> (the
    split walk), on a CUDA tensor; score_tiles_pairs_ref on a CPU tensor,
    whatever the split."""
    if tiles.device.type == "cpu":
        return score_tiles_pairs_ref(tiles, outrow, n_rows, qp, gap_open,
                                     gap_extend, row_start)
    if row_start is None:
        row_start = row_starts(outrow, n_rows)
    T, jt, V = tiles.shape
    m = qp.shape[1]
    stream = torch.cuda.current_stream(tiles.device).cuda_stream
    with torch.cuda.device(tiles.device):
        carry = strip_carry(m, tiles.shape, tiles.device, pairs=True)
        if split is None:
            out = torch.empty((n_rows, V), dtype=torch.int32,
                              device=tiles.device)
            err = kernels().sw_ragged_pairs_launch(
                tiles.data_ptr(), row_start.data_ptr(), n_rows, V, jt,
                qp.data_ptr(), m, gap_open + gap_extend, gap_extend,
                _ptr(carry), out.data_ptr(), stream)
        else:   # out, then the progress and gate words, all zero
            n_blocks = split.block_map.numel()
            buf = torch.zeros(n_rows * V + 2 * n_blocks, dtype=torch.int32,
                              device=tiles.device)
            out = buf[:n_rows * V].view(n_rows, V)
            err = kernels().sw_ragged_split_launch(
                tiles.data_ptr(), row_start.data_ptr(), n_rows, n_blocks, V,
                jt, qp.data_ptr(), m, gap_open + gap_extend, gap_extend,
                split.block_map.data_ptr(), buf[n_rows * V:].data_ptr(),
                _ptr(carry), out.data_ptr(), stream)
    raise_on(err, "sw_ragged_kernel")
    score_tiles.pair_launches += 1
    if split is not None:
        metrics.count("score_tiles.split_launches")
        metrics.count("score_tiles.split_rows", split.rows)
        metrics.count("score_tiles.split_parts", split.parts)
    return out


def score_tiles_int32(tiles, outrow, n_rows: int, qp, gap_open: int,
                      gap_extend: int, ceiling: int | None = None,
                      row_start=None) -> torch.Tensor:
    """Kernel 1 in its int32 form whatever the input: one launch of
    sw_ragged_kernel<CEIL> on a CUDA tensor, score_tiles_ref on a CPU
    tensor. The ladder's saturating tiers, the inputs outside the pair
    form and the pair form's second pass; arguments as score_tiles."""
    check_tiles(tiles, outrow, qp, gap_open, gap_extend, row_start)
    return _tiles_int32(tiles, outrow, n_rows, qp, gap_open, gap_extend,
                        ceiling, row_start)


def score_tiles_pairs_ref(tiles, outrow, n_rows: int, qp, gap_open: int,
                          gap_extend: int, row_start=None) -> torch.Tensor:
    """Plain PyTorch version of one pair-form launch of kernel 1, to the
    kernel's contract: a lane whose H stays below T = pair_limit(max(qp))
    scores exactly; any other scores T (the kernel: T or more)."""
    return score_tiles_ref(tiles, outrow, n_rows, qp, gap_open, gap_extend,
                           row_start=row_start).clamp_max(
                               pair_limit(int(qp.max())))


def score_tiles(tiles, outrow, n_rows: int, qp, gap_open: int,
                gap_extend: int, precision: str = "f32",
                ceiling: int | None = None,
                row_start=None, bounds=None, split=None) -> torch.Tensor:
    """Score an entire ragged tile stream (all blocks, any lengths) in ONE
    kernel launch: with no ceiling behind _pair_guard (the pair form where
    it fits, then the int32 form over the blocks that may have wrapped),
    else in the int32 form.

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
      bounds: optional profile_bounds(qp); the search paths and the ladder
        pass it (ops/lanes.py's Profile holds it). Without it the bounds are
        read from qp, on a card a wait for the device before the launch:
        for direct callers only.
      split: optional Split of this stream for qp's rows (split_plan): the
        pair form's launch on the split walk. None, and on the CPU, the
        unsplit launch; the int32 form ignores it.

    Returns: (n_rows, V) int32 exact local-alignment scores.
    """
    check_precision(precision)
    check_tiles(tiles, outrow, qp, gap_open, gap_extend, row_start)
    if row_start is None:
        row_start = row_starts(outrow, n_rows)
    if ceiling is not None:
        return _tiles_int32(tiles, outrow, n_rows, qp, gap_open, gap_extend,
                            ceiling, row_start)
    return _pair_guard(
        score_tiles, tiles, outrow, n_rows, row_start, qp, gap_open,
        gap_extend, bounds,
        lambda t, o, n, rs: _tiles_pairs(t, o, n, qp, gap_open, gap_extend,
                                         rs, split),
        lambda t, o, n, rs: _tiles_int32(t, o, n, qp, gap_open, gap_extend,
                                         None, rs))


score_tiles.launches = 0   # sw_ragged_kernel<CEIL> launches (the int32
# form; never the plain path)
score_tiles.pair_launches = 0   # sw_ragged_kernel<false, true> launches,
# split or not (metrics counters score_tiles.split_launches, split_rows and
# split_parts count those on the split walk)
score_tiles.rescored_blocks = 0   # DB blocks scored again in int32
score_tiles.kernel = "sw_ragged_kernel"   # its CUDA kernel's name, both forms


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
    with torch.cuda.device(tiles.device):
        out = torch.zeros((n_rows, n_planes, V), dtype=torch.int32,
                          device=tiles.device)
        carry = strip_carry(m, tiles.shape, tiles.device)
        err = kernels().sw_ragged_packed_launch(
            tiles.data_ptr(), row_start.data_ptr(), n_rows, V, jt,
            qp.data_ptr(), m, seg_of_group.data_ptr(), n_planes,
            gap_open + gap_extend, gap_extend, _ptr(carry), out.data_ptr(),
            torch.cuda.current_stream(tiles.device).cuda_stream)
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
    check_lanes(V)
    check_profile(qp)
    if codes.device != qp.device:
        raise ValueError("codes and qp must share a device")
    if not (codes.is_contiguous() and qp.is_contiguous()):
        raise ValueError("codes and qp must be contiguous")


class ChunkTable:
    """What a chunk kernel that takes a LIST of chunks in one launch needs
    beside the chunks: built once for a list of (B, L, V) int8 chunk
    tensors (any allocations, one device, one V) and reused for every
    launch over them.

      block_map  (n_blocks, 2) int32 on the device: CUDA block -> (chunk,
                 block within the chunk), longest L first (stable: equal
                 lengths stay in list order), so the long blocks start at
                 once and the short ones fill in behind them;
      codes0     the lowest codes address of the list (the kernel addresses
                 every chunk's codes from it);
      out_views, carry_views  per-chunk views of a flat (n_blocks, V)
                 output and of a flat carry buffer of ``numel`` entries,
                 for callers that allocate those once for the whole list;
      bind()     the device table of descriptors for one call.
    """

    def __init__(self, chunks):
        if not chunks:
            raise ValueError("a chunk table needs at least one chunk")
        first = chunks[0]
        for c in chunks:
            if c.dim() != 3 or c.dtype != torch.int8 or not c.is_contiguous():
                raise ValueError("every chunk must be a contiguous (B, L, V) "
                                 "int8 tensor")
            if c.shape[2] != first.shape[2] or c.device != first.device:
                raise ValueError("all chunks of a list must share V and the "
                                 "device")
        self.chunks = list(chunks)       # keeps the addresses alive
        self.device = first.device
        self.V = int(first.shape[2])
        B = np.array([c.shape[0] for c in chunks], dtype=np.int64)
        L = np.array([c.shape[1] for c in chunks], dtype=np.int64)
        self.first_block = np.concatenate([[0], np.cumsum(B)])
        self.first_pos = np.concatenate([[0], np.cumsum(B * L * self.V)])
        self.n_blocks = int(self.first_block[-1])
        self.numel = int(self.first_pos[-1])
        chunk_of = np.repeat(np.arange(len(chunks)), B)
        within = np.arange(self.n_blocks) - self.first_block[chunk_of]
        order = np.argsort(-L[chunk_of], kind="stable")
        self.block_map = torch.from_numpy(np.stack(
            [chunk_of[order], within[order]], axis=1).astype(np.int32)).to(
                self.device)
        # rows of csrc/sw_chunk.cu's ChunkDesc: codes, ch, cf, out, B, L
        self._desc = np.zeros((len(chunks), 6), dtype=np.int64)
        self._desc[:, 0] = [c.data_ptr() for c in chunks]
        self.codes0 = int(self._desc[:, 0].min())   # lowest codes address
        self._desc[:, 4] = B
        self._desc[:, 5] = L

    def matches(self, chunks) -> bool:
        """True if this table was built for exactly these tensors."""
        return (len(chunks) == len(self.chunks) and all(
            a.data_ptr() == b.data_ptr() and a.shape == b.shape
            for a, b in zip(chunks, self.chunks)))

    def bind(self, hcars, fcars, outs) -> torch.Tensor:
        """The (n, 6) int64 descriptor table on the device for one call:
        the cached rows with this call's carry and output addresses, chunk
        for chunk. hcars / fcars may be None for a kernel that does not
        take them (a null address)."""
        desc = self._desc.copy()
        for col, tensors in ((1, hcars), (2, fcars), (3, outs)):
            if tensors is not None:
                desc[:, col] = [t.data_ptr() for t in tensors]
        return torch.from_numpy(desc).to(self.device)

    def out_views(self, out: torch.Tensor) -> list:
        """Per-chunk (B, V) views of a flat (n_blocks, V) output."""
        fb = self.first_block
        return [out[a:b] for a, b in zip(fb[:-1], fb[1:])]

    def carry_views(self, flat: torch.Tensor) -> list:
        """Per-chunk (B, L, V, ...) views of a flat (numel, ...) carry
        buffer."""
        fp = self.first_pos
        return [flat[a:b].view(*c.shape, *flat.shape[1:])
                for a, b, c in zip(fp[:-1], fp[1:], self.chunks)]


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


def score_chunks(chunks, qp, gap_open: int, gap_extend: int,
                 precision: str = "f32", ceiling: int | None = None,
                 table: ChunkTable | None = None) -> list:
    """Score every lane of a LIST of packed chunks against one query. On
    CUDA tensors: ONE launch of sw_chunk_kernel over every block of every
    chunk; on CPU tensors: score_chunk_ref chunk by chunk.

    Args:
      chunks: list of (B, L, V) int8 packed db codes (any B and L, one V,
        one device; separate allocations or views of one); L % 32 == 0
        (guaranteed by db.py's length quantization).
      qp: (32, m) int32 query profile; m % 8 == 0, m <= max_query_pad().
      precision: 'f32' | 'int32' — both compute exact int32.
      ceiling: as score_tiles.
      table: optional cached ChunkTable(chunks).

    Returns: list of (B_i, V) int32 exact local-alignment scores (views of
    one flat output on a CUDA device). The strip carries of all chunks are
    one buffer allocated per call (8 bytes per code byte; none for a
    one-strip profile).
    """
    check_gaps(gap_open, gap_extend)
    check_precision(precision)
    for codes in chunks:
        check_chunk(codes, qp)
    m = qp.shape[1]
    if m > max_query_pad():
        raise ValueError(f"profile length {m} exceeds max_query_pad()="
                         f"{max_query_pad()}; use "
                         "longquery.score_chunks_long")
    if table is None:
        table = ChunkTable(chunks)
    elif not table.matches(chunks):
        raise ValueError("table was built for other chunks")
    if table.device.type == "cpu":
        return [score_chunk_ref(codes, qp, gap_open, gap_extend, ceiling)
                for codes in chunks]
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    with torch.cuda.device(table.device):
        out = torch.empty((table.n_blocks, table.V), dtype=torch.int32,
                          device=table.device)
        outs = table.out_views(out)
        carry = strip_carry(m, (table.numel,), table.device)
        desc = table.bind(None if carry is None
                          else table.carry_views(carry), None, outs)
        err = chunk_kernels().sw_chunk_launch(
            table.codes0, desc.data_ptr(), table.block_map.data_ptr(),
            table.n_blocks, table.V, qp.data_ptr(), m, gap_open + gap_extend,
            gap_extend, int(ceiling is not None), int(ceiling or 0),
            torch.cuda.current_stream(table.device).cuda_stream)
    raise_on(err, "sw_chunk_kernel")
    score_chunks.launches += 1
    return outs


score_chunks.launches = 0   # sw_chunk_kernel launches


def score_chunk(codes, qp, gap_open: int, gap_extend: int,
                precision: str = "f32", jt_steps: int | None = None,
                ceiling: int | None = None,
                lanes_per_block: int | None = None) -> torch.Tensor:
    """Score every lane of one packed chunk against one query in ONE
    kernel launch: the one-chunk case of score_chunks.

    Args:
      codes: (B, L, V) int8 packed db codes; L % 32 == 0.
      qp, precision, ceiling: as score_chunks.
      jt_steps, lanes_per_block: the JAX package's tiling choices for its
        kernel grid, accepted and validated for its contract (jt_steps must
        divide L, lanes_per_block must be positive); results do not depend
        on them and the CUDA kernel has no use for them.

    Returns: (B, V) int32 exact local-alignment scores.
    """
    check_chunk(codes, qp)
    L = codes.shape[1]
    if jt_steps is not None and (jt_steps <= 0 or L % jt_steps):
        raise ValueError(f"L={L} not a multiple of jt_steps={jt_steps}")
    if lanes_per_block is not None and lanes_per_block <= 0:
        raise ValueError(f"lanes_per_block={lanes_per_block} must be "
                         "positive")
    return score_chunks([codes], qp, gap_open, gap_extend, precision,
                        ceiling)[0]
