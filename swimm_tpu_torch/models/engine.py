"""Search entry points + top-k results (counterpart of swimm_tpu/models/engine.py).

The main serving path of the JAX package, on PyTorch: the whole DB lives on
the device as one block-major ragged tile stream (uploaded once per
PackedDb), queries are grouped by padded profile length, each query is one
scorer call over the whole stream ('tiles': one CUDA launch; 'tiles_long':
one launch per 1024-row query tile), pad lanes are masked to -1 and the
top-k is taken ON THE DEVICE in (score desc, sorted index asc) order; only
k (score, index) pairs per query come back to the host.

With SearchConfig(query_pack=True) the batch is packed along the query
axis instead (models/qpack.py): one launch of the packed kernel per pack
scores up to 24 queries at once into per-query planes, and one top-k runs
over all planes. score_db is the per-chunk API: every lane's score for one
query, one launch over all chunks (for a long query: one launch per query
tile over all chunks).

SearchConfig(evalue=True) also takes each query's (32 length bins x 512
scores) histogram on the device (score_hist) and fits the E-value model
from it on the host (utils/stats.py). SearchConfig(precision='ladder')
runs the adaptive-precision ladder (ops/ladder.py); with evalue it scores
each query's full vector through score_db and fits that instead.

SearchConfig(db_stream=True) streams the DB through the device in windows
instead (models/stream.py: window-major, pinned host slots, a copy stream),
for a DB larger than device memory; search() takes that path by itself,
with a warning, when the resident DB does not fit (resident_fits).
score_db_streaming is every lane's score for one query on that path.

Entry points run on 'cuda' unless the caller passes device='cpu' (the plain
PyTorch scorers). With no card and no device='cpu' they raise; they never
fall back to the CPU on their own.
"""

from __future__ import annotations

import time
import warnings
import weakref
from dataclasses import dataclass, replace

import numpy as np
import torch

from swimm_tpu_torch.db import PackedDb
from swimm_tpu_torch.fasta import FastaRecord
from swimm_tpu_torch.models import qpack
from swimm_tpu_torch.models.profile import build_query_profile
from swimm_tpu_torch.models.stream import (check_streamable,
                                           search_streaming_batch,
                                           stream_layout, stream_windows)
from swimm_tpu_torch.ops import lanes, longquery, scorer
from swimm_tpu_torch.utils import stats
from swimm_tpu_torch.utils.metrics import PhaseTimer, SearchMetrics, span


@dataclass
class SearchConfig:
    """Same fields and validation as swimm_tpu.models.engine.SearchConfig.

    Supported here: precision 'adaptive' | 'f32' | 'int32' (all compute
    exact int32) and 'ladder' (narrow tiers first, the same scores),
    query_pack, evalue, and db_stream with its window_tiles (the cap on a
    window's tiles), max_in_flight (windows alive on the device) and
    stream_scores ('buffer' | 'candidates' | 'auto', models/stream.py);
    db_stream refuses query_pack and the ladder, as in swimm_tpu. backend
    is carried for parity and unused.
    """
    matrix: str = "BLOSUM62"
    gap_open: int = 10
    gap_extend: int = 2
    top_k: int = 16
    backend: str = "auto"
    precision: str = "adaptive"
    m_multiple: int = 16         # query-length padding granularity
    query_pack: bool = False
    db_stream: bool = False
    window_tiles: int = 8192
    max_in_flight: int = 2
    stream_scores: str = "auto"
    evalue: bool = False

    def __post_init__(self):
        if self.gap_open < 0:
            raise ValueError(f"gap_open must be >= 0 (got {self.gap_open})")
        if self.gap_extend < 0:
            raise ValueError(
                f"gap_extend must be >= 0 (got {self.gap_extend})")
        if self.m_multiple <= 0 or self.m_multiple % 8:
            raise ValueError(
                f"m_multiple must be a positive multiple of 8 "
                f"(got {self.m_multiple})")
        if self.window_tiles <= 0:
            raise ValueError("window_tiles must be positive")
        if self.max_in_flight <= 0:
            raise ValueError("max_in_flight must be positive")
        if self.stream_scores not in ("auto", "buffer", "candidates"):
            raise ValueError(
                f"stream_scores must be 'auto', 'buffer', or 'candidates' "
                f"(got {self.stream_scores!r})")
        if self.evalue and self.query_pack:
            raise ValueError(
                "evalue statistics run the per-query full-vector path; "
                "query_pack does not apply — drop query_pack or evalue")


def check_supported(config: SearchConfig) -> None:
    """Raise ValueError for a posture no path serves (db_stream with
    query_pack or the ladder, as swimm_tpu does), an unknown precision or
    gaps past scorer.MAX_GAP."""
    if config.db_stream:
        check_streamable(config)
    if config.precision not in ("adaptive", "ladder", "f32", "int32"):
        raise ValueError(f"unknown precision {config.precision!r}")
    scorer.check_gaps(config.gap_open, config.gap_extend)


def resolve_device(device=None) -> torch.device:
    """'cuda' unless the caller asks otherwise; never a silent CPU."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "swimm_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (CLI: --device cpu) to run the "
            "plain PyTorch scorers on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclass
class Hit:
    rank: int
    score: int
    sorted_idx: int
    orig_idx: int
    title: str
    evalue: float | None = None   # set only under SearchConfig.evalue
    bits: float | None = None     # empirical bit score, set with evalue


def _fmt_evalue(e: float) -> str:
    return f"{e:.2g}" if e < 0.1 else f"{e:.2f}"


@dataclass
class QueryResult:
    query_title: str
    query_length: int
    hits: list

    def as_table(self) -> str:
        with_e = any(h.evalue is not None for h in self.hits)
        head = f"{'rank':>4} {'score':>7}"
        head += f" {'E-value':>9}  title" if with_e else "  title"
        lines = [f"Query: {self.query_title} ({self.query_length} aa)",
                 head]
        for h in self.hits:
            row = f"{h.rank:>4} {h.score:>7}"
            if with_e:
                row += f" {_fmt_evalue(h.evalue):>9}"
            lines.append(f"{row}  {h.title}")
        return "\n".join(lines)


def device_bytes_needed(packed: PackedDb, query_pack: bool = False,
                        evalue: bool = False) -> int:
    """Device memory the resident path needs: the int8 tile stream, its
    (T,) row map, the lane maps, and the int32 carry scratch (8 bytes per
    tile byte) that multi-strip and long queries use. With query_pack, also
    one pack's score planes and their int64 top-k keys (4 + 8 bytes per
    plane lane); with evalue, the int32 lane bin map (device_lane_bins).
    From the chunks' metadata alone: no code byte is read."""
    layout = stream_layout(packed)
    n_rows, V = layout["n_rows"], layout["V"]
    lanes = n_rows * V
    need = (layout["T"] * layout["jt"] * V * 9 + layout["T"] * 4 + lanes * 5
            + 8 * (n_rows + 1))
    if query_pack:
        need += lanes * (qpack.N_SEG_CAP // 2) * 12
    if evalue:
        need += lanes * 4
    return need


_DEVICE_TILE_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_LANE_MAP_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def resident_fits(packed: PackedDb, device=None) -> bool:
    """Whether the resident path can serve this DB on the device: always
    on the CPU; on a card when its tile stream is uploaded already or
    device_bytes_needed fits the free memory. search() streams the DB
    when it does not (swimm_tpu keys the same decision on the Pallas
    kernel's RESIDENT_TILE_CAP; the limit here is device memory)."""
    dev = resolve_device(device)
    if dev.type != "cuda" or str(dev) in _DEVICE_TILE_CACHE.get(packed, {}):
        return True
    return device_bytes_needed(packed) <= torch.cuda.mem_get_info(dev)[0]


def device_tiles(packed: PackedDb, device=None):
    """Device-resident ragged tile stream of the whole DB, uploaded once
    per (PackedDb, device) and reused across queries. Returns (tiles,
    outrow, n_rows, row_start, mask, lane2sorted), all on the device.
    Raises if it would not fit in the device's free memory."""
    dev = resolve_device(device)
    per_db = _DEVICE_TILE_CACHE.setdefault(packed, {})
    cached = per_db.get(str(dev))
    if cached is not None:
        return cached
    if not resident_fits(packed, dev):
        raise RuntimeError(
            f"the resident DB needs {device_bytes_needed(packed) / 1e9:.2f} "
            f"GB of device memory (tile stream + scratch), more than {dev} "
            "has free; search with SearchConfig(db_stream=True), or score "
            "one query with engine.score_db_streaming")
    tiles, outrow, n_rows = packed.flat_tiles()
    t = torch.from_numpy(np.ascontiguousarray(tiles)).to(dev)
    o = torch.from_numpy(outrow).to(dev)
    cached = (t, o, n_rows, scorer.row_starts(o, n_rows),
              *device_lane_maps(packed, dev))
    per_db[str(dev)] = cached
    return cached


def device_lane_maps(packed: PackedDb, device=None):
    """(mask bool, lane2sorted int64), each (n_rows * V,), on the device:
    uploaded once per (PackedDb, device), apart from the tile stream, so
    the streaming posture has them without uploading the DB."""
    dev = resolve_device(device)
    per_db = _LANE_MAP_CACHE.setdefault(packed, {})
    if str(dev) not in per_db:
        mask, lane2sorted = packed.lane_maps()
        per_db[str(dev)] = (
            torch.from_numpy(mask).to(dev),
            torch.from_numpy(lane2sorted.astype(np.int64)).to(dev))
    return per_db[str(dev)]


def device_chunks(packed: PackedDb, device=None) -> list:
    """The DB's chunks on the device, one (n_blocks, L, V) int8 tensor
    each. The resident tile stream is the chunks' codes block-major, so
    the chunks are VIEWS of device_tiles' stream — no second upload, and
    the same per-(PackedDb, device) cache."""
    tiles = device_tiles(packed, device)[0]
    out, t0 = [], 0
    for ch in packed.chunks:
        t1 = t0 + ch.n_blocks * (ch.L // scorer.JT)
        out.append(tiles[t0:t1].view(ch.n_blocks, ch.L, ch.V))
        t0 = t1
    return out


def device_chunk_table(packed: PackedDb, device=None):
    """(device_chunks, their scorer.ChunkTable) — the block map and chunk
    descriptors that let one launch take every chunk — built once per
    (PackedDb, device) and cached beside device_tiles' entry. (None, None)
    for a DB without chunks."""
    dev = resolve_device(device)
    device_tiles(packed, dev)              # uploads, or raises if too large
    per_db = _DEVICE_TILE_CACHE[packed]
    key = f"{dev}/chunk_table"
    if key not in per_db:
        chunks = device_chunks(packed, dev)
        per_db[key] = ((chunks, scorer.ChunkTable(chunks)) if chunks
                       else (None, None))
    return per_db[key]


def device_lane_bins(packed: PackedDb, device=None) -> torch.Tensor:
    """(n_rows * V,) int32 ln-length bin id of every lane
    (stats.lane_bin_map; pad lanes read 0), uploaded once per (PackedDb,
    device) and cached beside device_lane_maps' entry."""
    dev = resolve_device(device)
    per_db = _LANE_MAP_CACHE.setdefault(packed, {})
    key = f"{dev}/lane_bins"
    if key not in per_db:
        mask, lane2sorted = packed.lane_maps()
        per_db[key] = torch.from_numpy(stats.lane_bin_map(
            mask, lane2sorted, packed.lengths)).to(dev)
    return per_db[key]


def score_hist(scores: torch.Tensor, mask: torch.Tensor,
               lane_bins: torch.Tensor) -> torch.Tensor:
    """(N_LEN_BINS, SCORE_CAP + 1) int64 count table of one query's lane
    scores, on their device (counterpart of swimm_tpu's hist_from_scores):
    one torch.bincount over bin * 512 + clamp(score, 0, 511). Pad lanes go
    to one extra trash bin, dropped, rather than through boolean indexing,
    which would synchronise the device on every query. The TPU's one-hot
    matmuls exist only because scatter-add serialises there."""
    width = stats.SCORE_CAP + 1
    trash = stats.N_LEN_BINS * width
    idx = torch.where(mask, lane_bins * width
                      + scores.clamp(0, stats.SCORE_CAP), trash)
    return torch.bincount(idx, minlength=trash + 1)[:trash].view(
        stats.N_LEN_BINS, width)


def _m_pad(length: int, m_multiple: int) -> int:
    return -(-max(length, 1) // m_multiple) * m_multiple


def group_by_m_pad(queries, m_multiple: int) -> dict:
    """{padded profile length: [positions]} — one dispatch group each."""
    groups: dict = {}
    for pos, q in enumerate(queries):
        groups.setdefault(_m_pad(q.length, m_multiple), []).append(pos)
    return groups


def scatter_lane_scores(packed: PackedDb, flat: np.ndarray) -> np.ndarray:
    """Map flat lane-order scores (n_rows*V,) to sorted-db order
    (n_seqs,), dropping pad lanes."""
    mask, lane2sorted = packed.lane_maps()
    out = np.zeros(packed.n_seqs, dtype=np.int32)
    out[lane2sorted[mask]] = flat[mask]
    return out


def device_top_k(scores: torch.Tensor, mask: torch.Tensor,
                 lane2sorted: torch.Tensor, k: int):
    """Top-k of lane scores on the device, pad lanes masked to -1, in
    (score desc, lane asc) order — lane order is sorted-db order for valid
    lanes. scores is (lanes,) for one query, or (planes, ...) whose
    trailing axes flatten to the lanes, of any strides (a pack's planes,
    transposed). torch.topk does not promise the lowest index on ties, so
    each int64 key packs the score above the inverted lane index: all keys
    differ and the order is total. The keys are the only copy made (8 bytes
    per score). Returns (scores int32, sorted idx), (k,) or (planes, k)."""
    low = (1 << 32) - 1
    lanes = mask.numel()
    lead = tuple(scores.shape[:1]) if scores.dim() > 1 else ()
    key = torch.empty(scores.shape, dtype=torch.int64, device=scores.device)
    key.copy_(scores)         # widens; lays strided planes out lane-major
    key = key.view(-1, lanes)
    key.masked_fill_(~mask, -1)
    key <<= 32
    key += low - torch.arange(lanes, device=scores.device,
                              dtype=torch.int64)
    top = torch.topk(key, k).values.view(*lead, k)
    return (top >> 32).int(), lane2sorted[low - (top & low)]


def _hits_from(packed: PackedDb, v: np.ndarray, si: np.ndarray, k: int):
    keep = np.nonzero(v >= 0)[0][:k]
    return [Hit(r + 1, int(v[j]), int(si[j]), int(packed.orig_index[si[j]]),
                packed.title_of_sorted(int(si[j])))
            for r, j in enumerate(keep)]


def _search_packed(packed: PackedDb, queries, config: SearchConfig, dev_db):
    """Packed-profile path: one launch of the packed kernel per pack, the
    planes (n_rows, 24, V) ranked as (24, n_rows * V) lanes by one device
    top-k over all planes; every pack is launched before the first
    copy of results to the host (one per output per pack; before that only
    the scorer's one-scalar check of the segment order comes back); each
    query's hits come from plane entry.seg // 2. Raises if one pack's
    planes and their top-k keys would not fit in the device memory that is
    free or held unused by PyTorch's allocator."""
    tiles, outrow, n_rows, row_start, mask, lane2sorted = dev_db
    dev = tiles.device
    if dev.type == "cuda":
        free = (torch.cuda.mem_get_info(dev)[0]
                + torch.cuda.memory_reserved(dev)
                - torch.cuda.memory_allocated(dev))
        need = (device_bytes_needed(packed, query_pack=True)
                - device_bytes_needed(packed))
        if need > free:
            raise RuntimeError(
                f"a pack's score planes and top-k keys need {need / 1e9:.2f} "
                f"GB of device memory but {free / 1e9:.2f} GB is free; "
                "search without query_pack")
    k = min(config.top_k, mask.numel())
    packs = qpack.build_query_packs(queries, config.matrix)
    pending = []
    for p in packs:
        planes = scorer.score_tiles_packed(
            tiles, outrow, n_rows, torch.from_numpy(p.qp).to(dev),
            torch.from_numpy(p.seg_of_group).to(dev), config.gap_open,
            config.gap_extend, n_seg_cap=qpack.N_SEG_CAP,
            row_start=row_start)
        pending.append((p, device_top_k(planes.transpose(0, 1), mask,
                                        lane2sorted, k)))
    out = [None] * len(queries)
    for p, (vs, sis) in pending:
        vs, sis = vs.cpu().numpy(), sis.cpu().numpy()   # synchronises
        for e in p.entries:
            out[e.query_pos] = _hits_from(packed, vs[e.seg // 2],
                                          sis[e.seg // 2], config.top_k)
    return out, sum(p.M for p in packs)


def search_fused_batch(packed: PackedDb, queries, config: SearchConfig,
                       device=None):
    """Whole-DB search for a query batch.

    With config.query_pack, and when every query fits a pack, queries are
    PACKED along the profile axis (models/qpack.py): one kernel launch per
    fixed-size pack. Otherwise one scorer call per query over the resident
    stream, queries grouped by padded profile length. Either way the top-k
    is taken on the device and each output crosses to the host once per
    batch (once per pack on the packed path). With config.evalue each
    query's score histogram is taken on the device too (score_hist), and
    the tables come to the host once per batch beside the hits.
    precision='ladder' runs _search_ladder_batch instead.

    Returns (hit lists in input order, padded query rows dispatched)."""
    check_supported(config)
    dev_db = device_tiles(packed, device)
    if config.precision == "ladder":
        return _search_ladder_batch(packed, queries, config, dev_db)
    if config.query_pack and all(
            qpack._rows_needed(q.length) <= qpack.PACK_BUCKETS[-1]
            for q in queries):
        return _search_packed(packed, queries, config, dev_db)
    dev = dev_db[0].device
    mask, lane2sorted = dev_db[4], dev_db[5]
    lane_bins = device_lane_bins(packed, dev) if config.evalue else None
    k = min(config.top_k, mask.numel())
    out = [None] * len(queries)
    order, vs, sis, hists = [], [], [], []
    padded_rows = 0
    for positions in group_by_m_pad(queries, config.m_multiple).values():
        for p in positions:
            with span("engine.profile"):
                prof = lanes.Profile.build(queries[p], config, dev)
            padded_rows += prof.rows
            with span("engine.launch", kernel=prof.kernel,
                      cells=prof.length * int(packed.total_residues)):
                scores = lanes.score(dev_db[:4], prof, config.gap_open,
                                     config.gap_extend)
            with span("engine.top_k"):
                v, si = device_top_k(scores, mask, lane2sorted, k)
            order.append(p)
            vs.append(v)
            sis.append(si)
            if config.evalue:
                hists.append(score_hist(scores, mask, lane_bins))
    with span("engine.collect"):
        _collect_hits(packed, config, order, vs, sis,
                      hists if config.evalue else None, out)
    return out, padded_rows


def _collect_hits(packed: PackedDb, config: SearchConfig, order, vs, sis,
                  hists, out: list) -> None:
    """Set out[p] for each position p in order from its device top-k (vs,
    sis: (k,) tensors, one per position) and, when hists is given, its
    score table: each crosses to the host in one copy for all of them."""
    if not order:
        return
    vs_all = torch.stack(vs).cpu().numpy()      # synchronises the device
    sis_all = torch.stack(sis).cpu().numpy()
    if hists is not None:
        hists_all = torch.stack(hists).cpu().numpy()
        _, bin_logl = stats.length_bins(packed.lengths)
    for row, p in enumerate(order):
        out[p] = _hits_from(packed, vs_all[row], sis_all[row], config.top_k)
        if hists is not None:
            model = stats.fit_evalue_model_hist(hists_all[row], bin_logl)
            stats.attach_evalues(out[p], model, packed.lengths)


def _search_ladder_batch(packed: PackedDb, queries, config: SearchConfig,
                         dev_db):
    """precision='ladder' for a query batch: the tiers of every
    padded-length group through ladder.topk_db_adaptive_serving (top-k
    candidates on the device, each tier's flagged blocks gathered from the
    resident stream). Queries over max_query_pad() padded rows leave the
    ladder for the exact score_db (as swimm_tpu does on its kernels: the
    long-query kernels are exact). With evalue, every query takes the
    full-vector path instead: score_db (the ladder or exact), the unbinned
    fit, its top-k.

    Returns (hit lists in input order, padded query rows dispatched)."""
    from swimm_tpu_torch.ops import ladder
    dev = dev_db[0].device
    mm = config.m_multiple
    out = [None] * len(queries)
    padded_rows = 0
    full_vector = list(range(len(queries))) if config.evalue else []
    groups = {} if config.evalue else group_by_m_pad(queries, mm)
    for m_pad in [m for m in groups if m > scorer.max_query_pad()]:
        full_vector += groups.pop(m_pad)
    if groups:
        group_list = [(np.stack([
            build_query_profile(queries[p].codes, config.matrix, mm)
            for p in positions]), [queries[p].length for p in positions])
            for positions in groups.values()]
        cand_groups, _ = ladder.topk_db_adaptive_serving(
            packed, group_list, config.top_k, config.gap_open,
            config.gap_extend, matrix=config.matrix, dev_db=dev_db)
        for (m_pad, positions), cand in zip(groups.items(), cand_groups):
            padded_rows += m_pad * len(positions)
            for row, p in enumerate(positions):
                out[p] = _hits_from(packed, *cand[row], config.top_k)
    for p in full_vector:
        prof = lanes.Profile.build(queries[p], config)
        svec = _score_db(packed, prof, config, dev)
        out[p] = top_k_hits(packed, svec, config.top_k)
        if config.evalue:
            stats.attach_evalues(out[p], stats.fit_evalue_model(
                svec, packed.lengths), packed.lengths)
        padded_rows += prof.rows
    return out, padded_rows


def search_fused(packed: PackedDb, query: FastaRecord, config: SearchConfig,
                 device=None):
    """Whole-DB search for one query; returns its hit list."""
    return search_fused_batch(packed, [query], config, device)[0][0]


def score_db_streaming(packed: PackedDb, query: FastaRecord,
                       config: SearchConfig | None = None,
                       window_tiles: int | None = None,
                       max_in_flight: int | None = None,
                       device=None) -> np.ndarray:
    """score_db for a DB too large to live on the device: the windows of
    models/stream.stream_windows (read out of core, at most max_in_flight
    on the device), each scored by lanes.score. Each window's scores are
    copied into one host (n_rows, V) array without a wait; the device is
    synchronised once. window_tiles / max_in_flight default to the
    config's.

    Returns (n_seqs,) int32 scores in sorted-db order."""
    config = config or SearchConfig()
    window_tiles = (window_tiles if window_tiles is not None
                    else config.window_tiles)
    max_in_flight = (max_in_flight if max_in_flight is not None
                     else config.max_in_flight)
    if window_tiles <= 0:
        raise ValueError("window_tiles must be positive")
    if max_in_flight <= 0:
        raise ValueError("max_in_flight must be positive")
    check_supported(config)
    dev = resolve_device(device)
    prof = lanes.Profile.build(query, config, dev)
    layout = stream_layout(packed)
    host = torch.zeros((layout["n_rows"], layout["V"]), dtype=torch.int32,
                       pin_memory=dev.type == "cuda")
    for tiles, outrow, row_start, g0, n_w in stream_windows(
            packed, window_tiles, max_in_flight, dev):
        scores = lanes.score((tiles, outrow, n_w, row_start), prof,
                             config.gap_open, config.gap_extend)
        host[g0:g0 + n_w].copy_(scores.view(n_w, -1), non_blocking=True)
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    return scatter_lane_scores(packed, host.numpy().reshape(-1))


def score_db(packed: PackedDb, query: FastaRecord,
             config: SearchConfig | None = None, device=None) -> np.ndarray:
    """All-lane scores for one query, in sorted-db order (n_seqs,) int32:
    one kernel launch over all chunks (a long query: one per query tile),
    all launched before the one synchronising device-to-host copy. With
    precision='ladder' and at most max_query_pad() padded rows:
    ladder.score_db_adaptive over the resident stream instead (the same
    scores). For a DB that does not fit the device: score_db_streaming."""
    config = config or SearchConfig()
    check_supported(config)
    return _score_db(packed, lanes.Profile.build(query, config), config,
                     device)


def _score_db(packed: PackedDb, prof, config: SearchConfig,
              device) -> np.ndarray:
    """score_db of a lanes.Profile on the host: the ladder for kernel 1's
    lengths under precision='ladder'; else one launch over all chunks of
    the one-pass chunk kernel, or of the query-tiled one per query tile.
    The latter raises if the carries of all chunks (8 bytes per code byte,
    allocated once per call) would not fit in the device memory that is
    free or held unused by PyTorch's allocator."""
    if config.precision == "ladder" and prof.mode == "tiles":
        from swimm_tpu_torch.ops import ladder
        dev_db = device_tiles(packed, device)
        scores2d, _ = ladder.score_db_adaptive(
            packed, prof.qp, prof.length, config.gap_open,
            config.gap_extend, matrix=config.matrix, dev_db=dev_db)
        return scatter_lane_scores(packed, scores2d.reshape(-1))
    chunks, table = device_chunk_table(packed, device)
    out = np.zeros(packed.n_seqs, dtype=np.int32)
    if not chunks:
        return out
    dev = table.device
    if dev.type == "cuda":
        free = (torch.cuda.mem_get_info(dev)[0]
                + torch.cuda.memory_reserved(dev)
                - torch.cuda.memory_allocated(dev))
        need = 8 * table.numel
        if need > free:
            raise RuntimeError(
                f"the query's carries need {need / 1e9:.2f} GB of "
                f"device memory but {free / 1e9:.2f} GB is free")
    score = (scorer.score_chunks if prof.mode == "tiles"
             else longquery.score_chunks_long)
    flat = torch.cat([s.reshape(-1) for s in score(
        chunks, prof.qp.to(dev), config.gap_open, config.gap_extend,
        table=table)]).cpu().numpy()
    lane0 = 0
    for ch in packed.chunks:
        out[ch.base:ch.base + ch.n_seqs] = flat[lane0:lane0 + ch.n_seqs]
        lane0 += ch.n_blocks * ch.V
    return out


def top_k_hits(packed: PackedDb, scores: np.ndarray, k: int) -> list:
    """Rank host-side scores descending, resolve titles; ties broken by
    sorted index ascending."""
    k = min(k, len(scores))
    if k < len(scores):
        kth = np.partition(scores, len(scores) - k)[len(scores) - k]
        cand = np.nonzero(scores >= kth)[0]
    else:
        cand = np.arange(len(scores))
    idx = cand[np.lexsort((cand, -scores[cand]))][:k]
    return [Hit(r + 1, int(scores[i]), int(i), int(packed.orig_index[i]),
                packed.title_of_sorted(int(i)))
            for r, i in enumerate(idx)]


def search(packed: PackedDb, queries, config: SearchConfig | None = None,
           device=None):
    """Search a query batch against the DB: resident on the device, or
    streamed through it in windows under config.db_stream — which this
    sets itself, with a warning, when the resident DB does not fit the
    device (resident_fits).

    Returns (list[QueryResult], SearchMetrics)."""
    config = config or SearchConfig()
    check_supported(config)
    if not config.db_stream and not resident_fits(packed, device):
        if config.query_pack:
            raise ValueError(
                "this database's resident tile stream does not fit the "
                "device's free memory, so it must serve through the "
                "streaming path, which does not support query_pack=True "
                "— set query_pack=False")
        if config.precision == "ladder":
            raise ValueError(
                "this database's resident tile stream does not fit the "
                "device's free memory that the ladder's whole-DB tier "
                "launches need — use precision='adaptive' (identical "
                "scores via the exact pass)")
        warnings.warn(
            "the resident DB does not fit the device's free memory "
            f"(engine.device_bytes_needed: {device_bytes_needed(packed)} "
            "bytes); serving via the windowed streaming path (the same "
            "hits)", stacklevel=2)
        config = replace(config, db_stream=True)
    with span("engine.search"):
        timer = PhaseTimer()
        t0 = time.perf_counter()
        with timer.phase("h2d"):             # one-time upload, then cached
            if not config.db_stream:         # (windows upload while scoring)
                device_tiles(packed, device)
        with timer.phase("score"):
            if config.db_stream:
                hit_lists, padded_rows, lane_positions = \
                    search_streaming_batch(packed, queries, config, device)
            else:
                hit_lists, padded_rows = search_fused_batch(packed, queries,
                                                            config, device)
                lane_positions = sum(ch.n_blocks * ch.L * ch.V
                                     for ch in packed.chunks)
        results = [QueryResult(q.title, q.length, h)
                   for q, h in zip(queries, hit_lists)]
        seconds = time.perf_counter() - t0
        metrics = SearchMetrics(
            cells=int(packed.total_residues) * sum(q.length for q in queries),
            padded_cells=lane_positions * padded_rows,
            n_db_seqs=packed.n_seqs,
            n_queries=len(queries),
            seconds=seconds,
            timers=timer.report(),
        )
    return results, metrics
