"""Data-parallel sharded search with the collective top-k merge
(counterpart of swimm_tpu/parallel/sharded_search.py; BASELINE config 4:
"DB split over 2+ hosts, per-shard top-256 hits merged via collectives").

- The DB's tile stream is cut into n_data contiguous block ranges balanced
  by tile count (plan_tile_shards: the reference's cuts). Shard d lives on
  every device of mesh row d (build_tile_shards), at its fill: no PAD
  tiles, no trash row, its row starts rebased to its first tile. A device
  that holds every shard keeps them as views of its resident stream
  (engine.device_tiles); any other uploads the block range its shards
  cover, once.
- Each cell (d, q) scores its shard against the queries of column q (the
  batch padded to the 'query' axis; pad queries are not launched): kernel
  1 per query, or kernel 2 per 1,024-row query tile past max_query_pad()
  padded rows. Pad lanes are masked to -1 and the shard's top-kk taken on
  its device in (score desc, sorted index asc) order (engine.device_top_k),
  as global sorted indices; a shard with fewer than kk lanes pads its
  candidates with -1, so every cell's array is (Ql, kk).
- The merge gathers the columns' candidates over 'data' into (Q, n_data *
  kk), the reference's shape. In one process that is a copy of each
  shard's candidates to the column's output device (the cells are driven
  from this thread in turn; launches are asynchronous, so shards on
  different cards run together and shards on one card one after another);
  across processes it is all_gather_into_tensor over the column's ranks
  (parallel/distributed.py), and the E-value histograms' sum an
  all_reduce. The host's lexsort((i, -v)) then gives the resident hit list.

Exactness: every global top-k member lives in one shard and is in that
shard's top-kk (kk >= top_k, ties to the lowest sorted index, and a
shard's lanes are in sorted order); the union's lexsort reproduces the
resident order bit for bit. Shards partition the valid lanes, so the
summed integer histograms are the whole DB's.
"""

from __future__ import annotations

import time
import weakref
from dataclasses import dataclass, replace

import numpy as np
import torch

from swimm_tpu_torch.db import PackedDb
from swimm_tpu_torch.models.profile import build_query_profile
from swimm_tpu_torch.utils.metrics import PhaseTimer, SearchMetrics

TOPK_PER_SHARD = 256  # BASELINE config 4


@dataclass
class Shard:
    """One data shard on one device, at its fill: blocks [g0, g0 + n_rows)
    of the DB as a ragged tile stream the kernels take as it is."""
    tiles: torch.Tensor        # (n_tiles, jt, V) int8
    outrow: torch.Tensor       # (n_tiles,) int32 rows local to the shard
    row_start: torch.Tensor    # (n_rows + 1,) int64 tiles local to the shard
    n_rows: int
    mask: torch.Tensor         # (n_rows * V,) bool, valid lanes
    lane2sorted: torch.Tensor  # (n_rows * V,) int64 global sorted index
    lane_bins: torch.Tensor | None = None   # (n_rows * V,) int32, E-values


def _local_score_topk(shard: Shard, qps: list, mode: str, config, kk: int,
                      with_hist: bool = False):
    """The per-shard body shared by every step: score each local query over
    the shard (qps: ((32, m) int32 profile on its device, its
    scorer.profile_bounds) per query, None for a pad query of the query
    axis, which is not launched), mask pad lanes to -1,
    take the top-kk in (score desc, sorted index asc) order as global
    sorted indices, and with with_hist each query's (N_LEN_BINS,
    SCORE_CAP + 1) int64 score histogram over the shard's valid lanes.

    Returns (vals (Ql, kk) int32, idx (Ql, kk) int64[, hists]) on the
    shard's device; rows and columns past what the shard holds read -1."""
    from swimm_tpu_torch.models import engine
    from swimm_tpu_torch.utils import stats
    dev = shard.tiles.device
    vals = torch.full((len(qps), kk), -1, dtype=torch.int32, device=dev)
    idx = torch.zeros((len(qps), kk), dtype=torch.int64, device=dev)
    hists = (torch.zeros((len(qps), stats.N_LEN_BINS, stats.SCORE_CAP + 1),
                         dtype=torch.int64, device=dev) if with_hist else None)
    n = min(kk, shard.mask.numel())
    for row, cell in enumerate(qps):
        if cell is None or n == 0:
            continue
        qp, bounds = cell
        scores = engine.score_lanes(
            (shard.tiles, shard.outrow, shard.n_rows, shard.row_start), qp,
            mode, config, bounds)
        vals[row, :n], idx[row, :n] = engine.device_top_k(
            scores, shard.mask, shard.lane2sorted, n)
        if with_hist:
            hists[row] = engine.score_hist(scores, shard.mask,
                                           shard.lane_bins)
    return (vals, idx, hists) if with_hist else (vals, idx)


def _column_rows(mesh, q: int, n_pad: int) -> range:
    """The padded batch's rows that query column q serves."""
    ql = n_pad // mesh.shape["query"]
    return range(q * ql, (q + 1) * ql)


def sharded_tiles_local_topk(tile_shards, profiles, *, mesh, config, mode,
                             k=TOPK_PER_SHARD, with_hist=False):
    """Stage 1 of the SPLIT sharded step: every local cell scores its shard
    and takes its top-kk, with no communication. profiles: {device:
    [((32, m) tensor, its bounds) or None per padded query]}
    (_cell_profiles). Returns {(d, q):
    (vals, idx[, hists])}, each on its cell's device. Pair with
    merge_candidates (stage 2) to time the merge apart."""
    shards, kk = tile_shards["shards"], min(k, tile_shards["R_loc"]
                                            * tile_shards["V"])
    out = {}
    for (d, q), shard in shards.items():
        qps = profiles[str(shard.tiles.device)]
        rows = _column_rows(mesh, q, len(qps))
        out[d, q] = _local_score_topk(shard, [qps[r] for r in rows], mode,
                                      config, kk, with_hist)
    return out


def merge_candidates(cells: dict, *, mesh) -> dict:
    """Stage 2 of the split sharded step, the top-k merge: gather each
    query column's candidates over 'data' into (Ql, n_data * kk), and sum
    the histograms when the cells carry them. In one process, a copy of
    every shard's candidates to the column's output device (its data row 0
    cell's); across processes, all_gather_into_tensor over the column's
    ranks and all_reduce(SUM) of the int64 histograms. Returns {q: (vals,
    idx[, hists])} for this process's columns."""
    n_data = mesh.shape["data"]
    if mesh.distributed:
        import torch.distributed as dist
        ((d, q), parts), = cells.items()
        out = []
        for t in parts[:2]:
            buf = torch.empty((n_data * t.shape[0],) + t.shape[1:],
                              dtype=t.dtype, device=t.device)
            dist.all_gather_into_tensor(buf, t.contiguous(),
                                        group=mesh.data_group)
            out.append(buf.view(n_data, *t.shape).transpose(0, 1).reshape(
                t.shape[0], -1))
        if len(parts) == 3:
            dist.all_reduce(parts[2], op=dist.ReduceOp.SUM,
                            group=mesh.data_group)
            out.append(parts[2])
        return {q: tuple(out)}
    merged = {}
    for q in range(mesh.shape["query"]):
        dev = mesh.devices[0, q]
        parts = [cells[d, q] for d in range(n_data)]
        cols = [torch.cat([p[i].to(dev) for p in parts], dim=1)
                for i in range(2)]
        if len(parts[0]) == 3:
            cols.append(sum(p[2].to(dev) for p in parts))
        merged[q] = tuple(cols)
    return merged


def sharded_tiles_topk(tile_shards, profiles, *, mesh, config, mode,
                       k=TOPK_PER_SHARD):
    """Whole-DB sharded search step: each cell scores its shard, takes its
    top-kk, and the candidates gather over 'data'. Returns {q: (vals (Ql,
    n_data * kk) int32, idx int64)} (merge_candidates)."""
    return merge_candidates(sharded_tiles_local_topk(
        tile_shards, profiles, mesh=mesh, config=config, mode=mode, k=k),
        mesh=mesh)


def sharded_tiles_topk_hist(tile_shards, profiles, *, mesh, config, mode,
                            k=TOPK_PER_SHARD):
    """sharded_tiles_topk plus E-value statistics: each shard also takes
    every local query's score histogram over its valid lanes, summed over
    'data'. Returns {q: (vals, idx, hists (Ql, N_LEN_BINS, SCORE_CAP + 1)
    int64)}."""
    return merge_candidates(sharded_tiles_local_topk(
        tile_shards, profiles, mesh=mesh, config=config, mode=mode, k=k,
        with_hist=True), mesh=mesh)


_TILE_SHARD_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def plan_tile_shards(packed: PackedDb, n_data: int):
    """Host-side shard plan for the whole-DB ragged tile stream: blocks
    split into n_data contiguous groups balanced by TILE count, the
    reference's cuts, from the chunks' metadata alone.

    Returns (shapes, build): shapes = dict(T_max (the largest shard's
    tiles), R_loc (the largest shard's rows + 1: the reference's trash row,
    kept so kk and the gathered shapes equal the reference's), V, n_data,
    jt, bounds (n_data + 1,) block cuts, cum (n_rows + 1,) tiles before
    each block); build(d) -> (tiles_d, outrow_d, valid_d, l2s_d) numpy
    arrays of shard d at its fill, its tiles read from the chunk files
    alone — so a rank materialises only its own shard."""
    from swimm_tpu_torch.models.stream import _fill_window, stream_layout
    layout = stream_layout(packed)
    cum, n_rows, V, jt = (layout["cum"], layout["n_rows"], layout["V"],
                          layout["jt"])
    T = int(cum[-1])
    targets = (np.arange(1, n_data) * T) // n_data
    cuts = np.searchsorted(cum, targets, side="left")
    bounds = np.concatenate([[0], cuts, [n_rows]]).astype(np.int64)
    R_loc = int(max(bounds[d + 1] - bounds[d] for d in range(n_data))) + 1
    T_max = max(int(max(cum[bounds[d + 1]] - cum[bounds[d]]
                        for d in range(n_data))), 1)

    def build(d: int):
        g0, g1 = int(bounds[d]), int(bounds[d + 1])
        t0, t1 = int(cum[g0]), int(cum[g1])
        tiles_d = np.empty((t1 - t0, jt, V), np.int8)
        _fill_window(packed, layout, t0, t1, tiles_d)
        mask, lane2sorted = packed.lane_maps()
        return (tiles_d, _local_outrow(cum, g0, g1),
                mask[g0 * V:g1 * V].copy(), lane2sorted[g0 * V:g1 * V].copy())

    return {"T_max": T_max, "R_loc": R_loc, "V": V, "n_data": n_data,
            "jt": jt, "bounds": bounds, "cum": cum}, build


def _local_outrow(cum, g0: int, g1: int) -> np.ndarray:
    return np.repeat(np.arange(g1 - g0, dtype=np.int32),
                     np.diff(cum[g0:g1 + 1]))


def _range_bytes(cum, V: int, jt: int, g0: int, g1: int) -> int:
    """Device bytes of blocks [g0, g1) as engine.device_bytes_needed counts
    the whole DB's: the codes, their carry scratch (8 bytes a code byte),
    the row map, the lane maps and row starts."""
    n_t = int(cum[g1] - cum[g0])
    return (n_t * jt * V * 9 + n_t * 4 + (g1 - g0) * V * 5
            + 8 * (g1 - g0 + 1))


def _device_stream(packed: PackedDb, plan, dev, g_lo: int, g_hi: int):
    """The codes of blocks [g_lo, g_hi) on dev: the resident stream when
    the range is the whole DB (engine.device_tiles: no second upload when
    'cuda' already put it on this card), else the range read from the
    chunk files and uploaded. Raises RuntimeError when it does not fit the
    device's free memory."""
    from swimm_tpu_torch.models import engine
    from swimm_tpu_torch.models.stream import _fill_window, stream_layout
    cum, V, jt = plan["cum"], plan["V"], plan["jt"]
    whole = (g_lo, g_hi) == (0, len(cum) - 1)
    if whole:     # the resident stream on dev, whichever name uploaded it
        for cached in engine._DEVICE_TILE_CACHE.get(packed, {}).values():
            if torch.is_tensor(cached[0]) and cached[0].device == dev:
                return cached[0]
    if dev.type == "cuda":
        need = _range_bytes(cum, V, jt, g_lo, g_hi)
        free = torch.cuda.mem_get_info(dev)[0]
        if need > free:
            raise RuntimeError(
                f"the data shards of blocks [{g_lo}, {g_hi}) need "
                f"{need / 1e9:.2f} GB of device memory (tile stream + "
                f"scratch), more than {dev} has free; use more data shards "
                "or the streamed posture (--sharded --stream)")
    if whole:
        return engine.device_tiles(packed, dev)[0]
    t_lo, t_hi = int(cum[g_lo]), int(cum[g_hi])
    host = np.empty((t_hi - t_lo, jt, V), np.int8)
    _fill_window(packed, stream_layout(packed), t_lo, t_hi, host)
    return torch.from_numpy(host).to(dev)


def build_tile_shards(packed: PackedDb, mesh):
    """This process's data shards, each on its cell's device: {"shards":
    {(d, q): Shard}, "R_loc", "V", "bounds"} (plan_tile_shards'). A device's shards
    are views of one stream of the blocks they cover (_device_stream); the
    whole is cached per (PackedDb, mesh). Only the mesh's local cells are
    built, so a rank of a distributed mesh materialises only its own
    shard (distributed.global_tile_shards)."""
    from swimm_tpu_torch.models import engine
    per_db = _TILE_SHARD_CACHE.setdefault(packed, {})
    hit = per_db.get(mesh)
    if hit is not None:
        return hit
    plan, _ = plan_tile_shards(packed, int(mesh.shape["data"]))
    bounds, cum, V = plan["bounds"], plan["cum"], plan["V"]
    by_dev: dict = {}
    for d, q in mesh.local_cells():
        by_dev.setdefault(mesh.devices[d, q], []).append((d, q))
    shards = {}
    for dev, cells in by_dev.items():
        rows = sorted({d for d, _ in cells})
        g_lo, g_hi = int(bounds[rows[0]]), int(bounds[rows[-1] + 1])
        base = _device_stream(packed, plan, dev, g_lo, g_hi)
        mask, lane2sorted = engine.device_lane_maps(packed, dev)
        for d in rows:
            g0, g1 = int(bounds[d]), int(bounds[d + 1])
            t0 = int(cum[g0] - cum[g_lo])
            lanes = slice(g0 * V, g1 * V)
            shard = Shard(
                base[t0:t0 + int(cum[g1] - cum[g0])],
                torch.from_numpy(_local_outrow(cum, g0, g1)).to(dev),
                torch.from_numpy(cum[g0:g1 + 1] - cum[g0]).to(dev),
                g1 - g0, mask[lanes], lane2sorted[lanes])
            for c in cells:
                if c[0] == d:
                    shards[c] = shard
    out = {"shards": shards, "R_loc": plan["R_loc"], "V": V,
           "bounds": bounds}
    per_db[mesh] = out
    return out


def _with_lane_bins(packed: PackedDb, tile_shards) -> None:
    """Give every shard its lane bin ids (engine.device_lane_bins, sliced)
    for the E-value histograms."""
    from swimm_tpu_torch.models import engine
    V, bounds = tile_shards["V"], tile_shards["bounds"]
    for (d, _), shard in tile_shards["shards"].items():
        if shard.lane_bins is None:
            shard.lane_bins = engine.device_lane_bins(
                packed, shard.tiles.device)[int(bounds[d]) * V:
                                            int(bounds[d + 1]) * V]


def pad_queries(qps: np.ndarray, mesh) -> np.ndarray:
    """Pad the query axis to the 'query' mesh axis size (with all-PAD
    profiles that score 0 everywhere)."""
    from swimm_tpu_torch.alphabet import PAD_SCORE
    nq = mesh.shape["query"]
    Q = qps.shape[0]
    Qp = ((Q + nq - 1) // nq) * nq
    if Qp != Q:
        pad = np.full((Qp - Q,) + qps.shape[1:], PAD_SCORE, dtype=qps.dtype)
        qps = np.concatenate([qps, pad], axis=0)
    return qps


def _cell_profiles(qps: np.ndarray, n_real: int, mesh) -> dict:
    """{device: [((32, m) int32 tensor, its scorer.profile_bounds) per real
    query, None per pad]} for every device of this process's cells: one
    upload per device; the bounds are taken once a query, on the host."""
    from swimm_tpu_torch.ops import scorer
    host = [torch.from_numpy(qps[r]) for r in range(n_real)]
    bounds = [scorer.profile_bounds(qp) for qp in host]
    return {str(dev): [(qp.to(dev), b) for qp, b in zip(host, bounds)]
            + [None] * (len(qps) - n_real)
            for dev in {mesh.devices[c] for c in mesh.local_cells()}}


def _sync(mesh) -> None:
    """Wait for every card of this process's cells."""
    for dev in {mesh.devices[c] for c in mesh.local_cells()}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _device_to_host(cols: dict, mesh) -> list:
    """Fetch {q: (tensors...)} (merge_candidates) to the host as numpy
    (Q_pad, ...) arrays, one per tensor. Across processes the columns are
    first gathered over 'query', so every rank has every result."""
    if mesh.distributed and mesh.shape["query"] > 1:
        import torch.distributed as dist
        (q, parts), = cols.items()
        out = []
        for t in parts:
            buf = torch.empty((mesh.shape["query"] * t.shape[0],)
                              + t.shape[1:], dtype=t.dtype, device=t.device)
            dist.all_gather_into_tensor(buf, t.contiguous(),
                                        group=mesh.query_group)
            out.append(buf.cpu().numpy())
        return out
    order = sorted(cols)
    return [np.concatenate([cols[q][i].cpu().numpy() for q in order])
            for i in range(len(cols[order[0]]))]


def sharded_search(packed: PackedDb, queries, config=None, mesh=None,
                   topk_per_shard: int = TOPK_PER_SHARD, tile_shards=None,
                   measure_merge: bool = False):
    """Batched, sharded search over a whole PackedDb.

    Queries are grouped by padded profile length, one sharded step per
    group. Exactness: the final per-query hit list is exact as long as
    config.top_k <= topk_per_shard.

    tile_shards: pre-built shards (build_tile_shards /
    distributed.global_tile_shards); default builds this process's shards
    of the mesh.

    measure_merge: run the split form (local score + top-k, then the merge
    on its own) so the merge latency lands in timers['merge'] and, per
    group, timers['merge_collectives']. Default is the fused form
    (timers['score+merge']).

    precision='ladder' (and 'adaptive') serve through the exact pass, as in
    the reference: the ladder's host-driven escalation is not sharded, and
    the exact pass gives the same hit lists.

    Returns (list[QueryResult], SearchMetrics).
    """
    from swimm_tpu_torch.models import engine
    from swimm_tpu_torch.models.stream import dispatched_rows, select_mode
    from swimm_tpu_torch.utils import stats

    config = config or engine.SearchConfig()
    if mesh is None:
        from swimm_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh()
    if config.top_k > topk_per_shard:
        raise ValueError("top_k must be <= topk_per_shard for exact merge")
    if config.evalue and measure_merge:
        raise ValueError(
            "evalue=True and measure_merge=True do not combine: the "
            "merge-latency measurement mode times the bare collective "
            "(no histogram reduction) — drop one of the two")
    engine.check_supported(replace(config, db_stream=False))
    timer = PhaseTimer()
    t0 = time.perf_counter()
    groups = engine.group_by_m_pad(queries, config.m_multiple)
    Q = len(queries)
    with timer.phase("h2d"):
        if tile_shards is None:
            tile_shards = build_tile_shards(packed, mesh)
        if config.evalue:
            _with_lane_bins(packed, tile_shards)
            _, bin_logl = stats.length_bins(packed.lengths)
    step = sharded_tiles_topk_hist if config.evalue else sharded_tiles_topk
    kwargs = dict(mesh=mesh, config=config, k=topk_per_shard)

    all_v, all_i, all_h = [None] * Q, [None] * Q, [None] * Q
    padded_rows = 0
    # every profile is uploaded before the first launch: a copy from
    # pageable memory waits for the launches queued before it
    staged = []
    with timer.phase("profiles"):
        for m_pad, positions in sorted(groups.items()):
            mode = select_mode(m_pad)
            qps = pad_queries(np.stack([_fixed_profile(queries[p], config,
                                                       m_pad)
                                        for p in positions]), mesh)
            staged.append((positions, mode,
                           _cell_profiles(qps, len(positions), mesh)))
            padded_rows += dispatched_rows(mode, m_pad) * len(positions)
    pending = []
    for positions, mode, profiles in staged:
        if measure_merge:
            with timer.phase("score"):
                cells = sharded_tiles_local_topk(tile_shards, profiles,
                                                 mode=mode, **kwargs)
                _sync(mesh)
            with timer.phase("merge"):
                cols = merge_candidates(cells, mesh=mesh)
                _sync(mesh)
        else:
            with timer.phase("score+merge"):
                cols = step(tile_shards, profiles, mode=mode, **kwargs)
        pending.append((positions, cols))
    with timer.phase("d2h" if measure_merge else "score+merge"):
        for positions, cols in pending:
            got = _device_to_host(cols, mesh)      # synchronises
            for row, p in enumerate(positions):
                all_v[p], all_i[p] = got[0][row], got[1][row]
                if config.evalue:
                    all_h[p] = got[2][row]

    results = []
    with timer.phase("final_topk"):
        for qi, q in enumerate(queries):
            v, i = all_v[qi], all_i[qi]
            order = np.lexsort((i, -v))        # pads (-1) sort last, dropped
            hits = engine._hits_from(packed, v[order], i[order], config.top_k)
            if config.evalue:
                stats.attach_evalues(hits, stats.fit_evalue_model_hist(
                    all_h[qi], bin_logl), packed.lengths)
            results.append(engine.QueryResult(q.title, q.length, hits))

    seconds = time.perf_counter() - t0
    # every shard is launched at its fill: the stream's tiles count once,
    # times the query rows launched (pad queries of the query axis are not)
    lane_positions = sum(ch.n_blocks * ch.L * ch.V for ch in packed.chunks)
    timers = timer.report()
    merge_stats = timer.event_stats("merge")
    if merge_stats is not None:
        # one merge per m_pad group; the latency is the per-merge number
        timers["merge_collectives"] = merge_stats
    metrics = SearchMetrics(
        cells=int(packed.total_residues) * sum(q.length for q in queries),
        padded_cells=lane_positions * padded_rows,
        n_db_seqs=packed.n_seqs, n_queries=Q, seconds=seconds,
        timers=timers)
    return results, metrics


def _fixed_profile(q, config, m_pad):
    from swimm_tpu_torch.alphabet import PAD_CODE
    codes = np.full(m_pad, PAD_CODE, dtype=np.uint8)
    codes[:q.length] = q.codes
    # build_query_profile pads to a multiple; feeding the pre-padded codes
    # with m_multiple=1 keeps every query at the common m_pad length
    return build_query_profile(codes, config.matrix, m_multiple=1)
