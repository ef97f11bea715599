"""Adaptive-precision ladder: narrow-first scoring + overflow recheck
(counterpart of swimm_tpu/ops/ladder.py).

Score everything at a saturating ceiling, flag the blocks with a lane that
reached it, and score only those blocks again at the next wider tier. The
contract: final scores and hit lists are IDENTICAL to one exact pass, and
the returned stats (tier_ceilings, tier_blocks) are the JAX module's.

Every tier is one kernel launch with a ceiling: ``scorer.score_tiles(...,
ceiling=tier)`` (sw_ragged_kernel<CEIL>) over the resident tile stream, or
``scorer.score_chunk(..., ceiling=tier)`` (sw_chunk_kernel<CEIL>) over one
chunk. Each score_tiles launch takes its profile's scorer.profile_bounds,
taken on the host before the profile's upload, so the exact tier's 16-bit
guard does not wait for the device. An escalation gathers the flagged
blocks from the resident stream ON THE DEVICE (index_select of their
tiles, with a row map and scorer.row_starts for the sub-stream), each
query its own blocks; the JAX module's host gather, re-upload and
power-of-two padding only bounded its compiled shapes. Saturation flags
are computed on the device; only flags and top-k candidates come to the
host, one copy per tier.

Tier ceilings are the reference's: 127 (int8-class), 32767 (int16-class),
None (exact). Every tier computes in int32 here, as on the TPU: the tiers
keep the reference's control flow, not a narrower arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from swimm_tpu_torch.matrices import get_matrix
from swimm_tpu_torch.models import engine
from swimm_tpu_torch.ops import scorer

INT8_CEIL = 127
INT16_CEIL = 32767
DEFAULT_TIERS = (INT8_CEIL, INT16_CEIL, None)


def max_possible_score(query_len: int, seq_len: int,
                       matrix="BLOSUM62") -> int:
    """Conservative upper bound on any local-alignment score for this
    (query length, db sequence length) pair: the shorter sequence fully
    matched at the matrix's best diagonal score."""
    return int(min(query_len, seq_len) * _max_diag(matrix))


def _max_diag(matrix) -> int:
    mat = get_matrix(matrix) if isinstance(matrix, str) else matrix
    return int(np.diag(np.asarray(mat)).max())


def _tiers(tiers, bound: int) -> tuple:
    """The tiers with the exact one last, cut after the first whose
    ceiling covers the score bound (that tier runs exact instead)."""
    if tiers[-1] is not None:
        tiers = tuple(tiers) + (None,)
    kept = []
    for t in tiers:
        kept.append(t)
        if t is not None and t >= bound:
            kept[-1] = None
            break
    return tuple(kept)


def _flags(scores: torch.Tensor, ceiling) -> torch.Tensor:
    """Per block row, on the device: does any lane reach the ceiling?"""
    if ceiling is None:
        return torch.zeros(scores.shape[:-1], dtype=torch.bool,
                           device=scores.device)
    return (scores >= ceiling).any(dim=-1)


def _tile_rows(packed) -> np.ndarray:
    """(n_rows + 1,) first tile of every block row of the flat stream."""
    _, outrow, n_rows = packed.flat_tiles()
    return np.concatenate([[0], np.cumsum(
        np.bincount(outrow, minlength=n_rows))]).astype(np.int64)


def _bounds(qps) -> list:
    """scorer.profile_bounds of each profile of a (Q, 32, m) stack, taken
    where the stack is (the host, for the search paths' numpy stacks)."""
    qps = torch.as_tensor(qps)
    return [scorer.profile_bounds(qps[q]) for q in range(qps.shape[0])]


def _resident(packed, dev_db, device):
    return dev_db if dev_db is not None else engine.device_tiles(packed,
                                                                 device)


def topk_db_adaptive_serving(packed, groups, k: int, gap_open: int,
                             gap_extend: int, tiers=DEFAULT_TIERS,
                             matrix="BLOSUM62", dev_db=None, device=None):
    """The batched ladder across padded-length groups, with top-k
    candidates taken on the device: tier 1 is one launch per query over
    the whole resident stream; each later tier is one launch per query
    that still has flagged blocks, over just those blocks. Every tier's
    launches are queued before its one copy to the host.

    Args:
      groups: list of (qps (Qg, 32, m_pad) int32, lens (Qg,)), one entry
        per padded-length group (engine.group_by_m_pad).
      dev_db: engine.device_tiles(packed, device), uploaded if None.

    Returns (per-group list of per-query (vals, sorted_idx) candidate
    arrays in global hit order, stats). Exactness of the candidate merge:
    for a query q, a block "finalizes" at the tier where it was scored and
    not flagged for q (its clamped scores are exact). If lane x is in q's
    true top-k it is in the top-k of the launch where its block finalized,
    since every lane ranked above it there outranks it exactly too. So
    candidates count only where their block finalized for that query;
    duplicates are removed.
    """
    tiles, outrow, n_rows, row_start, mask, _ = _resident(packed, dev_db,
                                                          device)
    dev = tiles.device
    V = tiles.shape[2]
    _, l2s = packed.lane_maps()
    cum = _tile_rows(packed)
    maxdiag = _max_diag(matrix)
    blockmax = packed.block_max_lengths()
    tiers = _tiers(tiers, int(min(
        max((l for _, lens in groups for l in lens), default=0),
        int(blockmax.max()) if n_rows else 0) * maxdiag))
    kk = min(k, n_rows * V) if n_rows else 0
    stats = {"tier_ceilings": list(tiers), "tier_blocks": [n_rows]}
    if kk == 0 or not groups:
        return [[(np.zeros(0, np.int32), np.zeros(0, np.int64))
                 for _ in range(int(qps.shape[0]))]
                for qps, _ in groups], stats
    lanes = torch.arange(n_rows * V, device=dev)
    mask2d = mask.view(n_rows, V)

    def launch(t, o, nr, rs, qp, bounds, ceiling, lane_mask, kk_t):
        """One tier launch, reduced on the device to (flags, top-kk_t
        clamped scores, their lanes) in one int64 vector."""
        s = scorer.score_tiles(t, o, nr, qp, gap_open, gap_extend,
                               ceiling=ceiling, row_start=rs, bounds=bounds)
        v, li = engine.device_top_k(s.reshape(-1), lane_mask,
                                    lanes[:nr * V], kk_t)
        return torch.cat([_flags(s, ceiling).long(), v.long(), li])

    def drain(parts, sizes):          # one device-to-host copy per tier
        flat = torch.cat(parts).cpu().numpy()
        out, a = [], 0
        for nr, kk_t in sizes:
            b = a + nr
            out.append((flat[a:b].astype(bool),
                        flat[b:b + kk_t].astype(np.int32),
                        flat[b + kk_t:b + 2 * kk_t]))
            a = b + 2 * kk_t
        return out

    # ---- tier 1: one launch per query over the whole stream ----
    qbounds = [_bounds(qps) for qps, _ in groups]
    qps_dev = [torch.as_tensor(qps).to(dev) for qps, _ in groups]
    parts, sizes = [], []
    for qps, bs in zip(qps_dev, qbounds):
        for q in range(qps.shape[0]):
            parts.append(launch(tiles, outrow, n_rows, row_start, qps[q],
                                bs[q], tiers[0], mask, kk))
            sizes.append((n_rows, kk))
    first = iter(drain(parts, sizes))
    rounds, pend_all = [], []   # [group][query]: candidate rounds; pending
    for qps, lens in groups:
        bounds = (np.minimum(np.asarray(lens, np.int64)[:, None],
                             blockmax[None, :]) * maxdiag)
        g_rounds, g_pend = [], []
        for q in range(int(qps.shape[0])):
            flags, v, idx = next(first)
            p = (np.nonzero(flags & (bounds[q] > tiers[0]))[0]
                 if tiers[0] is not None else np.zeros(0, np.int64))
            g_rounds.append([(v, idx, np.arange(n_rows, dtype=np.int64), p)])
            g_pend.append(p)
        rounds.append(g_rounds)
        pend_all.append(g_pend)

    # ---- tiers 2..: each query's own flagged blocks, gathered on device ----
    if tiers[0] is not None:
        for tier in tiers[1:]:
            entries = [(gi, q) for gi, g_pend in enumerate(pend_all)
                       for q, p in enumerate(g_pend) if len(p)]
            stats["tier_blocks"].append(
                int(sum(len(pend_all[gi][q]) for gi, q in entries)))
            if not entries:
                break
            parts, sizes = [], []
            for gi, q in entries:
                pend = pend_all[gi][q]
                sub, o, rs = scorer.substream(tiles, cum, pend)
                kk_t = min(k, len(pend) * V)
                lane_mask = mask2d[torch.from_numpy(pend).to(dev)].reshape(-1)
                parts.append(launch(sub, o, len(pend), rs, qps_dev[gi][q],
                                    qbounds[gi][q], tier, lane_mask, kk_t))
                sizes.append((len(pend), kk_t))
            for (gi, q), (sflags, sv, sidx) in zip(entries,
                                                   drain(parts, sizes)):
                pend = pend_all[gi][q]
                bound_q = (np.minimum(int(groups[gi][1][q]), blockmax[pend])
                           * maxdiag)
                new_p = (pend[sflags & (bound_q > tier)]
                         if tier is not None else np.zeros(0, np.int64))
                rounds[gi][q].append((sv, sidx, pend, new_p))
                pend_all[gi][q] = new_p
            if tier is None:
                break

    # ---- host merge per query (finalization rule + dedupe) ----
    out = []
    for g_rounds in rounds:
        g_out = []
        for q_rounds in g_rounds:
            allv, alli = [], []
            for rv, ridx, rowmap, rpend in q_rounds:
                keep = rv >= 0
                if not keep.any():
                    continue
                li = ridx[keep]
                vq = rv[keep]
                grow = rowmap[li // V]
                fin = ~np.isin(grow, rpend)
                gflat = grow * V + (li % V)
                allv.append(vq[fin])
                alli.append(l2s[gflat[fin]].astype(np.int64))
            if not allv:
                g_out.append((np.zeros(0, np.int32), np.zeros(0, np.int64)))
                continue
            v_all = np.concatenate(allv)
            i_all = np.concatenate(alli)
            _, first_at = np.unique(i_all, return_index=True)
            v_all, i_all = v_all[first_at], i_all[first_at]
            order = np.lexsort((i_all, -v_all))[:k]
            g_out.append((v_all[order], i_all[order]))
        out.append(g_out)
    return out, stats


def topk_db_adaptive_batch(packed, qps, query_lens, k: int, gap_open: int,
                           gap_extend: int, tiers=DEFAULT_TIERS,
                           matrix="BLOSUM62", dev_db=None, device=None):
    """The batched ladder with top-k candidates for ONE group of profiles
    (qps (Q, 32, m) int32, query_lens (Q,)): topk_db_adaptive_serving
    with a single group. Returns (per-query list of (vals, sorted_idx) in
    global hit order, stats)."""
    out, stats = topk_db_adaptive_serving(
        packed, [(qps, list(query_lens))], k, gap_open, gap_extend,
        tiers=tiers, matrix=matrix, dev_db=dev_db, device=device)
    return out[0], stats


def score_db_adaptive_batch(packed, qps, query_lens, gap_open: int,
                            gap_extend: int, tiers=DEFAULT_TIERS,
                            matrix="BLOSUM62", dev_db=None, device=None):
    """Whole-database ladder for a BATCH of queries with full score
    tensors: tier 1 over every (query, block); each later tier scores the
    UNION of the queries' flagged blocks, gathered once on the device, for
    every query. Patching a (query, block) pair the query did not flag is
    exact: its narrower score was below the ceiling, so the wider tier
    gives the same value.

    Args:
      qps: (Q, 32, m) int32 stacked query profiles (common m_pad).
      query_lens: (Q,) true query lengths (per-query score bounds).

    Returns (scores (Q, n_rows, V) int32 numpy, identical to exact passes,
    and a stats dict with per-tier union block counts).
    """
    tiles, outrow, n_rows, row_start = _resident(packed, dev_db, device)[:4]
    dev = tiles.device
    qbounds = _bounds(qps)
    qps = torch.as_tensor(qps).to(dev)
    Q = qps.shape[0]
    maxdiag = _max_diag(matrix)
    bounds = (np.minimum(np.asarray(query_lens, np.int64)[:, None],
                         packed.block_max_lengths()[None, :]) * maxdiag)
    tiers = _tiers(tiers, int(bounds.max()))
    scores = torch.stack([scorer.score_tiles(
        tiles, outrow, n_rows, qps[q], gap_open, gap_extend,
        ceiling=tiers[0], row_start=row_start, bounds=qbounds[q])
        for q in range(Q)])
    stats = {"tier_ceilings": list(tiers), "tier_blocks": [n_rows]}
    if tiers[0] is None or len(tiers) == 1:
        return scores.cpu().numpy(), stats
    flags = _flags(scores, tiers[0]).cpu().numpy()
    pend = [np.nonzero(flags[q] & (bounds[q] > tiers[0]))[0]
            for q in range(Q)]
    cum = _tile_rows(packed)
    for tier in tiers[1:]:
        union = (np.unique(np.concatenate(pend)) if pend
                 else np.zeros(0, np.int64))
        stats["tier_blocks"].append(int(len(union)))
        if len(union) == 0:
            break
        sub, o, rs = scorer.substream(tiles, cum, union)
        wider = torch.stack([scorer.score_tiles(
            sub, o, len(union), qps[q], gap_open, gap_extend, ceiling=tier,
            row_start=rs, bounds=qbounds[q]) for q in range(Q)])  # (Q, U, V)
        scores[:, torch.from_numpy(union).to(dev)] = wider
        if tier is None:
            break
        flags = _flags(wider, tier).cpu().numpy()
        pend = [union[flags[q] & (bounds[q][union] > tier)]
                for q in range(Q)]
    return scores.cpu().numpy(), stats


def score_db_adaptive(packed, qp, query_len: int, gap_open: int,
                      gap_extend: int, tiers=DEFAULT_TIERS,
                      matrix="BLOSUM62", dev_db=None, device=None):
    """Whole-database ladder for one (32, m) profile over the resident tile
    stream: a saturating first tier over every block, then each wider tier
    over only the blocks that (a) reached the ceiling and (b) are not
    PROVABLY under it — the per-block bound min(query_len, block_max_len)
    * max_diag (length-sorted packing makes short blocks provably narrow).
    The one-query case of score_db_adaptive_batch.

    Returns (scores (n_rows, V) int32 numpy, identical to an exact pass,
    and a stats dict with per-tier block counts).
    """
    scores, stats = score_db_adaptive_batch(
        packed, torch.as_tensor(qp)[None], [query_len], gap_open, gap_extend,
        tiers=tiers, matrix=matrix, dev_db=dev_db, device=device)
    return scores[0], stats


def score_chunk_adaptive(codes, qp, gap_open: int, gap_extend: int,
                         tiers=DEFAULT_TIERS, upper_bound: int | None = None):
    """Score one packed chunk (codes (B, L, V) int8, qp (32, m) int32, one
    device) through the ladder: every block at the first tier, then the
    blocks with a lane at the ceiling at the next wider tier, and so on.
    With upper_bound (a provable score bound), the tiers stop at the first
    whose ceiling covers it (that tier keeps its ceiling, as in the JAX
    module).

    Returns ((B, V) int32 numpy scores, identical to an exact pass when the
    bound is valid, and a stats dict).
    """
    if tiers[-1] is not None:
        tiers = tuple(tiers) + (None,)   # guarantee the exact final tier
    if upper_bound is not None:
        kept = []
        for t in tiers:
            kept.append(t)
            if t is not None and t >= upper_bound:
                break
        tiers = tuple(kept)
    scores = scorer.score_chunk(codes, qp, gap_open, gap_extend,
                                ceiling=tiers[0])
    stats = {"tier_ceilings": list(tiers),
             "tier_blocks": [int(codes.shape[0])]}
    if tiers[0] is None or len(tiers) == 1:
        return scores.cpu().numpy(), stats
    pending = np.nonzero(_flags(scores, tiers[0]).cpu().numpy())[0]
    for tier in tiers[1:]:
        stats["tier_blocks"].append(int(len(pending)))
        if len(pending) == 0:
            break
        idx = torch.from_numpy(pending).to(codes.device)
        wider = scorer.score_chunk(codes.index_select(0, idx), qp, gap_open,
                                   gap_extend, ceiling=tier)
        scores[idx] = wider
        if tier is None:
            break
        pending = pending[_flags(wider, tier).cpu().numpy()]
    return scores.cpu().numpy(), stats
