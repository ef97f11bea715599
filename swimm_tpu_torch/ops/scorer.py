"""Ragged whole-DB scorer (counterpart of swimm_tpu/ops/pallas_scorer.py's
``score_tiles`` and swimm_tpu/ops/xla_scorer.py's ``score_tiles``).

``score_tiles`` launches the hand-written CUDA kernel ``sw_ragged_kernel``
(csrc/sw_ragged.cu) on a CUDA tensor and runs ``score_tiles_ref``, its
plain PyTorch version, on a CPU tensor. There is no fallback from one to
the other: a CUDA tensor either reaches the kernel or raises.

The plain version is the column-vectorised two-pass recurrence of
xla_scorer.score_tiles in int32: per db position, Ht = max(Hdiag + S, E, 0)
over the whole query column, then F recovered exactly as an exclusive
cumulative max of Ht (valid because gap_open >= 0: a gap never profitably
re-opens inside a gap), H = max(Ht, F). Blocks with the same tile count are
stepped together, one torch op per (db position, step of the recurrence).
"""

from __future__ import annotations

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


def check_stream(tiles, outrow, qp, row_start=None) -> None:
    """Shape/type/device/contiguity checks shared by both kernels."""
    if tiles.dim() != 3 or tiles.dtype != torch.int8:
        raise ValueError(f"tiles must be (T, jt, V) int8 (got "
                         f"{tuple(tiles.shape)} {tiles.dtype})")
    T, jt, V = tiles.shape
    if not 0 < V <= 1024:
        raise ValueError(f"lane width V={V} must be in 1..1024")
    if outrow.shape != (T,) or outrow.dtype != torch.int32:
        raise ValueError(f"outrow must be ({T},) int32")
    if qp.dim() != 2 or qp.shape[0] != 32 or qp.dtype != torch.int32:
        raise ValueError(f"qp must be (32, m) int32 (got "
                         f"{tuple(qp.shape)} {qp.dtype})")
    if qp.shape[1] % 8 or qp.shape[1] == 0:
        raise ValueError(f"profile length {qp.shape[1]} must be a positive "
                         "multiple of 8")
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
    """
    T, jt, V = tiles.shape
    m = qp.shape[1]
    dev = tiles.device
    goe, ge = gap_open + gap_extend, gap_extend
    i32 = torch.int32
    qpt = qp.t().contiguous()                              # (m, 32)
    ramp = ((torch.arange(m, device=dev, dtype=i32) + 1) * ge)[:, None]
    carry = hcar is not None
    out = torch.zeros((n_rows, V), dtype=i32, device=dev)
    hout = torch.empty_like(hcar) if carry else None
    fout = torch.empty_like(fcar) if carry else None
    counts = row_start[1:] - row_start[:-1]
    for c in torch.unique(counts).tolist():
        if c == 0:
            continue
        rows = torch.nonzero(counts == c).flatten()
        nb, N, L = rows.numel(), rows.numel() * V, c * jt
        tidx = row_start[rows][:, None] + torch.arange(c, device=dev)

        def lanes(x):   # (nb, c, jt, V) -> (L, nb*V): db position major
            return x.reshape(nb, L, V).permute(1, 0, 2).reshape(L, N)

        codes = lanes(tiles[tidx]).long() & 31
        if carry:
            hc, fc = lanes(hcar[tidx]), lanes(fcar[tidx])
            ho = torch.empty((L, N), dtype=i32, device=dev)
            fo = torch.empty((L, N), dtype=i32, device=dev)
        H = torch.zeros((m, N), dtype=i32, device=dev)
        E = torch.full((m, N), NEG, dtype=i32, device=dev)
        smax = torch.zeros(N, dtype=i32, device=dev)
        htop = torch.zeros((1, N), dtype=i32, device=dev)  # H(row -1, j-1)
        neg_row = torch.full((1, N), NEG, dtype=i32, device=dev)
        for j in range(L):
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
            smax = torch.maximum(smax, H.max(dim=0).values)
            if carry:
                ho[j] = H[-1]
                fo[j] = torch.maximum(H[-1] - goe, F[-1] - ge)
        out[rows] = smax.reshape(nb, V)
        if carry:
            def back(x):   # (L, nb*V) -> (nb*c, jt, V) in tidx order
                return x.reshape(L, nb, V).permute(1, 0, 2).reshape(
                    nb * c, jt, V)
            flat = tidx.reshape(-1)
            hout[flat] = back(ho)
            fout[flat] = back(fo)
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
SIGNATURES = {
    "sw_ragged_launch": [_PTR, _PTR, _INT, _INT, _INT, _PTR, _INT, _INT,
                         _INT, _INT, _INT, _PTR, _PTR, _PTR, _PTR],
    "sw_ragged_qtile_launch": [_PTR, _PTR, _INT, _INT, _INT, _PTR, _INT,
                               _INT, _INT, _PTR, _PTR, _PTR, _PTR],
}


def kernels():
    """The built sw_ragged library (compiled on first call)."""
    from swimm_tpu_torch.ops import _build
    return _build.load("sw_ragged", SIGNATURES)


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


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
    if precision not in ("f32", "int32"):
        raise ValueError(f"precision must be 'f32' or 'int32' "
                         f"(got {precision!r})")
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
    if m // 32 + (m % 32) // 8 > 1:   # several strips (32 rows, then 8):
        # the carries between strips need scratch
        ch = torch.empty((T, jt, V), dtype=torch.int32, device=tiles.device)
        cf = torch.empty_like(ch)
        chp, cfp = ch.data_ptr(), cf.data_ptr()
    else:
        chp = cfp = None
    err = kernels().sw_ragged_launch(
        tiles.data_ptr(), row_start.data_ptr(), n_rows, V, jt,
        qp.data_ptr(), m, gap_open + gap_extend, gap_extend,
        int(ceiling is not None), int(ceiling or 0), chp, cfp,
        out.data_ptr(), torch.cuda.current_stream(tiles.device).cuda_stream)
    raise_on(err, "sw_ragged_kernel")
    score_tiles.launches += 1
    return out


score_tiles.launches = 0   # sw_ragged_kernel launches (never the plain path)
