"""Sharded, window-major DB streaming (counterpart of
swimm_tpu/parallel/sharded_stream.py): the streaming posture across the
'data' axis of a mesh.

The tile stream is cut into spans of at most window_tiles tiles
(models/stream.plan_windows, the reference's plan); n_data consecutive
spans form one super-window, and span d of each goes to mesh row d
(_iter_super_windows). Each row's device reads its own spans out of core
through the streaming machinery of models/stream.py (stream_windows with
its spans: pinned WindowSlots filled by a prefetch thread, a copy stream
and events on that device), one stream per (row, device) however many
query columns share the device. Every span is launched at its fill and
scored against the queries of each column on that device (kernel 1, or
kernel 2 per query tile); its top-kk candidates, kk = min(top_k, (r_cap +
1) * V) as in the reference, and under evalue its histograms are taken on
the device, per span. At the end the candidates of every cell (a short
row's missing tail span reads -1) and its summed histograms are gathered
over 'data' by sharded_search.merge_candidates, once, and merged on the
host in (score desc, sorted index asc) order.

Exactness is the streaming merge's argument with "window" read as
"span": every global top-k member is in its own span's top-kk, and the
spans partition the valid lanes, so the summed histograms are the whole
DB's.
"""

from __future__ import annotations

import time
from dataclasses import replace

import numpy as np
import torch

from swimm_tpu_torch.db import PackedDb
from swimm_tpu_torch.utils.metrics import PhaseTimer, SearchMetrics


def _iter_super_windows(spans, n_data: int):
    """Yield, per super-window, its spans as [(d, (g0, g1))]: n_data
    consecutive spans of the plan, span d for mesh row d; the last
    super-window may hold fewer."""
    for s0 in range(0, len(spans), n_data):
        yield list(enumerate(spans[s0:s0 + n_data]))


def search_streaming_sharded(packed: PackedDb, queries, config=None,
                             mesh=None):
    """Batched sharded search under the streaming posture: the DB crosses
    each row's host-to-device link once per batch, span by span, and the
    candidates merge through the same gather as the resident sharded path.

    config.window_tiles is the PER-DEVICE span size; one super-window moves
    n_data * window_tiles tiles at most.

    Returns (list[QueryResult], SearchMetrics).
    """
    from swimm_tpu_torch.models import engine
    from swimm_tpu_torch.models.stream import (plan_windows, stream_layout,
                                               stream_windows)
    from swimm_tpu_torch.parallel.sharded_search import (
        Shard, _column_rows, _device_to_host, _group_profiles,
        _local_score_topk, merge_candidates)
    from swimm_tpu_torch.utils import stats

    config = config or engine.SearchConfig()
    if mesh is None:
        from swimm_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh()
    if config.query_pack:
        raise ValueError(
            "sharded streaming does not support query_pack=True: queries "
            "batch per padded length against each span — set "
            "query_pack=False")
    if config.precision == "ladder":
        raise ValueError(
            "db_stream=True does not support precision='ladder' (see "
            "models/stream.py) — use precision='adaptive': identical "
            "scores via the exact pass")
    engine.check_supported(replace(config, db_stream=False))
    n_data = int(mesh.shape["data"])
    timer = PhaseTimer()
    t0 = time.perf_counter()

    layout = stream_layout(packed)
    spans, r_cap = plan_windows(layout, config.window_tiles)
    V = layout["V"]
    kk = min(config.top_k, (r_cap + 1) * V)
    n_super = -(-len(spans) // n_data)
    cells = mesh.local_cells()
    devices = {mesh.devices[c] for c in cells}

    with timer.phase("h2d"):            # lane maps only: the DB streams
        maps = {str(dev): engine.device_lane_maps(packed, dev)
                for dev in devices}
        if config.evalue:
            bins = {str(dev): engine.device_lane_bins(packed, dev)
                    for dev in devices}
            _, bin_logl = stats.length_bins(packed.lengths)

    with timer.phase("profiles"):
        groups, padded_rows = _group_profiles(queries, config, mesh)

    # per cell and group: each span's (vals, idx), and the summed hists
    cands = {c: [[] for _ in groups] for c in cells}
    hists = {c: [None] * len(groups) for c in cells}
    feeds = {}                          # (row, device) -> its stream, cells
    for d, q in cells:
        dev = mesh.devices[d, q]
        feeds.setdefault((d, str(dev)), [dev, []])[1].append((d, q))
    with timer.phase("stream"):
        streams = {key: stream_windows(packed, config.window_tiles,
                                       config.max_in_flight, dev,
                                       spans=spans[key[0]::n_data])
                   for key, (dev, _) in feeds.items()}
        try:
            for sw in _iter_super_windows(spans if groups else [], n_data):
                for (d, dk), (dev, row_cells) in feeds.items():
                    if d >= len(sw):
                        continue                # a short last super-window
                    tiles, outrow, row_start, g0, n_w = next(streams[d, dk])
                    lanes = slice(g0 * V, (g0 + n_w) * V)
                    shard = Shard(tiles, outrow, row_start, n_w,
                                  maps[dk][0][lanes], maps[dk][1][lanes],
                                  bins[dk][lanes] if config.evalue else None)
                    for c in row_cells:
                        for gi, (_, profiles) in enumerate(groups):
                            qps = profiles[dk]
                            out = _local_score_topk(
                                shard, [qps[r] for r in _column_rows(
                                    mesh, c[1], len(qps))],
                                config, kk, config.evalue)
                            cands[c][gi].append(out[:2])
                            if config.evalue:
                                hists[c][gi] = (out[2] if hists[c][gi] is None
                                                else hists[c][gi] + out[2])
        finally:
            for gen in streams.values():
                gen.close()

        results = [None] * len(queries)
        for gi, (positions, profiles) in enumerate(groups):
            n_pad = len(next(iter(profiles.values())))
            per_cell = {}
            for c in cells:
                ql = len(_column_rows(mesh, c[1], n_pad))
                dev = mesh.devices[c]
                got = cands[c][gi]
                missing = n_super - len(got)    # this row's absent spans
                v = torch.cat([g[0] for g in got] + [torch.full(
                    (ql, kk * missing), -1, dtype=torch.int32, device=dev)],
                    dim=1)
                i = torch.cat([g[1] for g in got] + [torch.zeros(
                    (ql, kk * missing), dtype=torch.int64, device=dev)],
                    dim=1)
                per_cell[c] = (v, i)
                if config.evalue:
                    h = hists[c][gi]
                    per_cell[c] += (h if h is not None else torch.zeros(
                        (ql, stats.N_LEN_BINS, stats.SCORE_CAP + 1),
                        dtype=torch.int64, device=dev),)
            got = _device_to_host(merge_candidates(per_cell, mesh=mesh),
                                  mesh)
            for row, p in enumerate(positions):
                results[p] = got[0][row], got[1][row], (
                    got[2][row] if config.evalue else None)

    out = []
    with timer.phase("final_topk"):
        for q, (v, i, h) in zip(queries, results):
            order = np.lexsort((i, -v))
            hits = engine._hits_from(packed, v[order], i[order],
                                     config.top_k)
            if config.evalue and hits:
                stats.attach_evalues(hits, stats.fit_evalue_model_hist(
                    h, bin_logl), packed.lengths)
            out.append(engine.QueryResult(q.title, q.length, hits))

    seconds = time.perf_counter() - t0
    # spans are launched at their fill: the stream's tiles count once
    lane_positions = layout["T"] * layout["jt"] * V
    metrics = SearchMetrics(
        cells=int(packed.total_residues) * sum(q.length for q in queries),
        padded_cells=lane_positions * padded_rows,
        n_db_seqs=packed.n_seqs, n_queries=len(queries), seconds=seconds,
        timers=timer.report())
    return out, metrics
