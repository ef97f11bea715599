"""Query-tiled scorers for long queries (counterpart of
swimm_tpu/ops/longquery.py's ``score_tiles_long`` and ``score_chunk_long``).

A query longer than max_query_pad() is padded to a multiple of tile_m rows
with PAD_SCORE (pad rows never raise a score) and walked one query tile at a
time: each tile is one launch of ``sw_ragged_qtile_kernel`` over the whole
DB tile stream (``score_tiles_long``), or of ``sw_chunk_qtile_kernel`` over
a list of rectangular chunks (``score_chunks_long``; ``score_chunk_long``
is its one-chunk case). The row above each tile
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
from swimm_tpu_torch.ops.scorer import (NEG, ChunkTable, check_chunk,
                                        check_gaps, check_precision,
                                        check_stream, chunk_as_stream,
                                        chunk_kernels, kernels, raise_on,
                                        row_starts, walk_ref)

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
    with torch.cuda.device(tiles.device):
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


def score_chunks_qtile(chunks, qp_tile, gap_open: int, gap_extend: int,
                       hcars, fcars, table: ChunkTable | None = None):
    """One query tile over a LIST of (B, L, V) chunks (any B and L, one V,
    one device; separate allocations or views of one); hcars/fcars hold,
    chunk for chunk, the row above the tile in int32 tensors shaped like
    the codes. On CUDA tensors: ONE launch of sw_chunk_qtile_kernel over
    every block of every chunk, which updates the carries IN PLACE and
    returns them; on CPU tensors: score_chunk_qtile_ref chunk by chunk (new
    carry tensors).

    table: optional cached ChunkTable(chunks).

    Returns (scores, hcars, fcars): lists, scores[i] (B_i, V) int32.
    """
    check_gaps(gap_open, gap_extend)
    if not (len(chunks) == len(hcars) == len(fcars)):
        raise ValueError("chunks, hcars and fcars must be lists of one "
                         "length")
    for codes, hcar, fcar in zip(chunks, hcars, fcars):
        check_chunk(codes, qp_tile)
        check_carries(codes, hcar, fcar)
    if table is None:
        table = ChunkTable(chunks)
    elif not table.matches(chunks):
        raise ValueError("table was built for other chunks")
    if table.device.type == "cpu":
        res = [score_chunk_qtile_ref(codes, qp_tile, gap_open, gap_extend,
                                     hcar, fcar)
               for codes, hcar, fcar in zip(chunks, hcars, fcars)]
        return tuple(list(x) for x in zip(*res))
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    with torch.cuda.device(table.device):
        out = torch.empty((table.n_blocks, table.V), dtype=torch.int32,
                          device=table.device)
        outs = table.out_views(out)
        desc = table.bind(hcars, fcars, outs)
        err = chunk_kernels().sw_chunk_qtile_launch(
            table.codes0, desc.data_ptr(), table.block_map.data_ptr(),
            table.n_blocks, table.V,
            qp_tile.data_ptr(), qp_tile.shape[1], gap_open + gap_extend,
            gap_extend, torch.cuda.current_stream(table.device).cuda_stream)
    raise_on(err, "sw_chunk_qtile_kernel")
    score_chunks_qtile.launches += 1
    return outs, list(hcars), list(fcars)


score_chunks_qtile.launches = 0   # sw_chunk_qtile_kernel launches


def score_chunk_qtile(codes, qp_tile, gap_open: int, gap_extend: int,
                      hcar, fcar):
    """One query tile over one (B, L, V) chunk: the one-chunk case of
    score_chunks_qtile. Returns (scores (B, V) int32, hcar, fcar)."""
    out, hc, fc = score_chunks_qtile([codes], qp_tile, gap_open, gap_extend,
                                     [hcar], [fcar])
    return out[0], hc[0], fc[0]


def score_chunks_long(chunks, qp, gap_open: int, gap_extend: int,
                      precision: str = "f32", tile_m: int | None = None,
                      table: ChunkTable | None = None) -> list:
    """Score a list of (B, L, V) chunks against a query of ANY length (qp
    (32, m), m % 8 == 0): one launch per tile_m-row query tile over all the
    chunks. The carries of all chunks are two flat int32 buffers allocated
    once per call (8 bytes per code byte).

    Returns the list of (B_i, V) int32 exact scores.
    """
    check_gaps(gap_open, gap_extend)
    check_precision(precision)
    qp, n_qt = pad_to_tiles(qp, tile_m or LONG_TILE_M)
    tile_m = qp.shape[1] // n_qt
    if table is None:
        table = ChunkTable(chunks)
    hcars = table.carry_views(torch.zeros(
        table.numel, dtype=torch.int32, device=table.device))
    fcars = table.carry_views(torch.full(
        (table.numel,), NEG, dtype=torch.int32, device=table.device))
    best = None
    for qt in range(n_qt):
        qp_tile = qp[:, qt * tile_m:(qt + 1) * tile_m].contiguous()
        outs, hcars, fcars = score_chunks_qtile(
            chunks, qp_tile, gap_open, gap_extend, hcars, fcars, table)
        best = outs if best is None else [torch.maximum(b, o)
                                          for b, o in zip(best, outs)]
    return best


def score_chunk_long(codes, qp, gap_open: int, gap_extend: int,
                     precision: str = "f32",
                     tile_m: int | None = None) -> torch.Tensor:
    """Score one (B, L, V) chunk against a query of ANY length: the
    one-chunk case of score_chunks_long. Returns (B, V) int32 exact
    scores."""
    return score_chunks_long([codes], qp, gap_open, gap_extend, precision,
                             tile_m)[0]
