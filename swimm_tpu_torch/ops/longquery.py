"""Query-tiled scorers for long queries (counterpart of
swimm_tpu/ops/longquery.py's ``score_tiles_long`` and ``score_chunk_long``).

A query longer than max_query_pad() is padded to a multiple of tile_m rows
with PAD_SCORE (pad rows never raise a score) and walked one query tile at a
time: each tile is one launch of ``sw_ragged_qtile_kernel`` over the whole
DB tile stream (``score_tiles_long``), or of ``sw_chunk_qtile_kernel`` over
one rectangular chunk (``score_chunk_long``). The row above each tile
travels between launches in two int32 carry streams aligned with the db
codes — the real H of the previous tile's bottom row and the real F
entering this tile's first row (the JAX kernels carry a global-ramp cummax
instead; the carries are internal, the contract is the output). The kernels
update the carries in place, so the streams cost 8 bytes per (db position,
lane) in all. The result is the max of the per-tile scores.
"""

from __future__ import annotations

import torch

from swimm_tpu_torch.alphabet import PAD_SCORE
from swimm_tpu_torch.ops.scorer import (NEG, check_chunk, check_gaps,
                                        check_precision, check_stream,
                                        chunk_as_stream, chunk_kernels,
                                        kernels, raise_on, row_starts,
                                        walk_ref)

LONG_TILE_M = 1024   # query rows per tile (one kernel launch each)


def check_carries(codes, hcar, fcar) -> None:
    for c in (hcar, fcar):
        if (c.shape != codes.shape or c.dtype != torch.int32
                or c.device != codes.device or not c.is_contiguous()):
            raise ValueError("carries must be contiguous int32 tensors "
                             "shaped like the codes, on the same device")


def pad_to_tiles(qp, tile_m: int):
    """(profile padded with PAD_SCORE columns to a multiple of tile_m rows,
    number of query tiles)."""
    if tile_m <= 0 or tile_m % 8:
        raise ValueError(f"tile_m={tile_m} must be a positive multiple of 8")
    m = qp.shape[1]
    n_qt = -(-m // tile_m)
    if n_qt * tile_m != m:
        qp = torch.cat([qp, torch.full((qp.shape[0], n_qt * tile_m - m),
                                       PAD_SCORE, dtype=torch.int32,
                                       device=qp.device)], dim=1)
    return qp, n_qt


def score_qtile_ref(tiles, outrow, n_rows: int, qp_tile, gap_open: int,
                    gap_extend: int, hcar, fcar, row_start=None):
    """Plain PyTorch version of one query-tile launch: returns (scores
    (n_rows, V) int32 over this tile's rows, new hcar, new fcar)."""
    check_gaps(gap_open, gap_extend)
    if row_start is None:
        row_start = row_starts(outrow, n_rows)
    return walk_ref(tiles, row_start, n_rows, qp_tile, gap_open, gap_extend,
                    None, hcar, fcar)


def score_qtile(tiles, outrow, n_rows: int, qp_tile, gap_open: int,
                gap_extend: int, hcar, fcar, row_start=None):
    """One query tile over the whole stream. On a CUDA tensor: one launch
    of sw_ragged_qtile_kernel, which updates hcar/fcar IN PLACE and returns
    them; on a CPU tensor: score_qtile_ref (new carry tensors)."""
    check_stream(tiles, outrow, qp_tile, row_start)
    check_carries(tiles, hcar, fcar)
    if tiles.device.type == "cpu":
        return score_qtile_ref(tiles, outrow, n_rows, qp_tile, gap_open,
                               gap_extend, hcar, fcar, row_start)
    if tiles.device.type != "cuda":
        raise ValueError(f"unsupported device {tiles.device}")
    check_gaps(gap_open, gap_extend)
    if row_start is None:
        row_start = row_starts(outrow, n_rows)
    T, jt, V = tiles.shape
    out = torch.empty((n_rows, V), dtype=torch.int32, device=tiles.device)
    err = kernels().sw_ragged_qtile_launch(
        tiles.data_ptr(), row_start.data_ptr(), n_rows, V, jt,
        qp_tile.data_ptr(), qp_tile.shape[1], gap_open + gap_extend,
        gap_extend, hcar.data_ptr(), fcar.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(tiles.device).cuda_stream)
    raise_on(err, "sw_ragged_qtile_kernel")
    score_qtile.launches += 1
    return out, hcar, fcar


score_qtile.launches = 0   # sw_ragged_qtile_kernel launches


def score_tiles_long(tiles, outrow, n_rows: int, qp, gap_open: int,
                     gap_extend: int, precision: str = "f32",
                     tile_m: int | None = None,
                     row_start=None) -> torch.Tensor:
    """Score a whole-DB ragged tile stream against a query of ANY length
    (qp (32, m), m % 8 == 0), one launch per tile_m-row query tile.

    Returns (n_rows, V) int32 exact scores.
    """
    check_gaps(gap_open, gap_extend)
    check_precision(precision)
    tile_m = tile_m or LONG_TILE_M
    qp, n_qt = pad_to_tiles(qp, tile_m)
    if row_start is None:
        row_start = row_starts(outrow, n_rows)
    hcar = torch.zeros(tiles.shape, dtype=torch.int32, device=tiles.device)
    fcar = torch.full(tiles.shape, NEG, dtype=torch.int32,
                      device=tiles.device)
    best = None
    for qt in range(n_qt):
        qp_tile = qp[:, qt * tile_m:(qt + 1) * tile_m].contiguous()
        out, hcar, fcar = score_qtile(tiles, outrow, n_rows, qp_tile,
                                      gap_open, gap_extend, hcar, fcar,
                                      row_start)
        best = out if best is None else torch.maximum(best, out)
    return best


def score_chunk_qtile_ref(codes, qp_tile, gap_open: int, gap_extend: int,
                          hcar, fcar):
    """Plain PyTorch version of one query-tile launch over a chunk: returns
    (scores (B, V) int32 over this tile's rows, new hcar, new fcar)."""
    check_gaps(gap_open, gap_extend)
    tiles, row_start = chunk_as_stream(codes)
    out, hc, fc = walk_ref(tiles, row_start, codes.shape[0], qp_tile,
                           gap_open, gap_extend, None,
                           hcar.reshape(tiles.shape),
                           fcar.reshape(tiles.shape))
    return out, hc.reshape(codes.shape), fc.reshape(codes.shape)


def score_chunk_qtile(codes, qp_tile, gap_open: int, gap_extend: int,
                      hcar, fcar):
    """One query tile over one (B, L, V) chunk; hcar/fcar (B, L, V) int32
    hold the row above the tile. On a CUDA tensor: one launch of
    sw_chunk_qtile_kernel, which updates hcar/fcar IN PLACE and returns
    them; on a CPU tensor: score_chunk_qtile_ref (new carry tensors)."""
    check_gaps(gap_open, gap_extend)
    check_chunk(codes, qp_tile)
    check_carries(codes, hcar, fcar)
    if codes.device.type == "cpu":
        return score_chunk_qtile_ref(codes, qp_tile, gap_open, gap_extend,
                                     hcar, fcar)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    B, L, V = codes.shape
    out = torch.empty((B, V), dtype=torch.int32, device=codes.device)
    err = chunk_kernels().sw_chunk_qtile_launch(
        codes.data_ptr(), B, L, V, qp_tile.data_ptr(), qp_tile.shape[1],
        gap_open + gap_extend, gap_extend, hcar.data_ptr(), fcar.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(codes.device).cuda_stream)
    raise_on(err, "sw_chunk_qtile_kernel")
    score_chunk_qtile.launches += 1
    return out, hcar, fcar


score_chunk_qtile.launches = 0   # sw_chunk_qtile_kernel launches


def score_chunk_long(codes, qp, gap_open: int, gap_extend: int,
                     precision: str = "f32",
                     tile_m: int | None = None) -> torch.Tensor:
    """Score a (B, L, V) chunk against a query of ANY length (qp (32, m),
    m % 8 == 0), one launch per tile_m-row query tile.

    Returns (B, V) int32 exact scores.
    """
    check_gaps(gap_open, gap_extend)
    check_precision(precision)
    qp, n_qt = pad_to_tiles(qp, tile_m or LONG_TILE_M)
    tile_m = qp.shape[1] // n_qt
    hcar = torch.zeros(codes.shape, dtype=torch.int32, device=codes.device)
    fcar = torch.full(codes.shape, NEG, dtype=torch.int32,
                      device=codes.device)
    best = None
    for qt in range(n_qt):
        qp_tile = qp[:, qt * tile_m:(qt + 1) * tile_m].contiguous()
        out, hcar, fcar = score_chunk_qtile(codes, qp_tile, gap_open,
                                            gap_extend, hcar, fcar)
        best = out if best is None else torch.maximum(best, out)
    return best
