"""Query-tiled scorer for long queries (counterpart of
swimm_tpu/ops/longquery.py's ``score_tiles_long``).

A query longer than max_query_pad() is padded to a multiple of tile_m rows
with PAD_SCORE (pad rows never raise a score) and walked one query tile at a
time: each tile is one launch of ``sw_ragged_qtile_kernel`` over the whole
DB tile stream. The row above each tile travels between launches in two
(T, jt, V) int32 carry streams aligned with the db tiles — the real H of the
previous tile's bottom row and the real F entering this tile's first row
(the JAX kernel carries a global-ramp cummax instead; the carries are
internal, the contract is the output). The kernel updates the carries in
place, so the streams cost 8 bytes per (db position, lane) in all. The
result is the max of the per-tile scores.
"""

from __future__ import annotations

import torch

from swimm_tpu_torch.alphabet import PAD_SCORE
from swimm_tpu_torch.ops.scorer import (NEG, check_gaps, check_stream,
                                        kernels, raise_on, row_starts,
                                        walk_ref)

LONG_TILE_M = 1024   # query rows per tile (one kernel launch each)


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
    for c in (hcar, fcar):
        if (c.shape != tiles.shape or c.dtype != torch.int32
                or c.device != tiles.device or not c.is_contiguous()):
            raise ValueError("carries must be contiguous int32 tensors "
                             "shaped like tiles, on the same device")
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
    if precision not in ("f32", "int32"):
        raise ValueError(f"precision must be 'f32' or 'int32' "
                         f"(got {precision!r})")
    tile_m = tile_m or LONG_TILE_M
    if tile_m % 8:
        raise ValueError(f"tile_m={tile_m} must be a multiple of 8")
    m = qp.shape[1]
    n_qt = -(-m // tile_m)
    if n_qt * tile_m != m:
        qp = torch.cat([qp, torch.full((qp.shape[0], n_qt * tile_m - m),
                                       PAD_SCORE, dtype=torch.int32,
                                       device=qp.device)], dim=1)
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
