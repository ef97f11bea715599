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
query, one launch per chunk (for a long query: one launch per query tile
over all chunks).

Entry points run on 'cuda' unless the caller passes device='cpu' (the plain
PyTorch scorers). With no card and no device='cpu' they raise; they never
fall back to the CPU on their own.
"""

from __future__ import annotations

import time
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from swimm_tpu_torch.db import PackedDb
from swimm_tpu_torch.fasta import FastaRecord
from swimm_tpu_torch.models import qpack
from swimm_tpu_torch.models.profile import build_query_profile
from swimm_tpu_torch.models.stream import dispatched_rows, select_mode
from swimm_tpu_torch.ops import longquery, scorer
from swimm_tpu_torch.utils.metrics import PhaseTimer, SearchMetrics


@dataclass
class SearchConfig:
    """Same fields and validation as swimm_tpu.models.engine.SearchConfig.

    Supported here: precision 'adaptive' | 'f32' | 'int32' (all compute
    exact int32) and query_pack. precision='ladder', db_stream and evalue
    are accepted by the dataclass (same fields) but search() and score_db()
    raise NotImplementedError for them until their ROADMAP items land;
    backend, window_tiles, max_in_flight and stream_scores are carried for
    parity and unused.
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
    """Raise NotImplementedError for the postures not ported yet, naming
    the ROADMAP.md Queue 1 item that will bring each."""
    todo = [("precision='ladder'", config.precision == "ladder",
             "Queue 1 item 'Adaptive-precision ladder'"),
            ("db_stream=True", config.db_stream,
             "Queue 1 item 'Streaming posture'"),
            ("evalue=True", config.evalue,
             "Queue 1 item 'E-value statistics'")]
    for what, on, item in todo:
        if on:
            raise NotImplementedError(
                f"{what} is not ported to swimm_tpu_torch yet ({item} in "
                "ROADMAP.md)")
    if config.precision not in ("adaptive", "f32", "int32"):
        raise ValueError(f"unknown precision {config.precision!r}")


def kernel_precision(config: SearchConfig) -> str:
    """The scorers' precision argument for this config ('adaptive' runs
    the exact pass, as in the JAX package)."""
    return "f32" if config.precision == "adaptive" else config.precision


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


@dataclass
class QueryResult:
    query_title: str
    query_length: int
    hits: list

    def as_table(self) -> str:
        lines = [f"Query: {self.query_title} ({self.query_length} aa)",
                 f"{'rank':>4} {'score':>7}  title"]
        for h in self.hits:
            lines.append(f"{h.rank:>4} {h.score:>7}  {h.title}")
        return "\n".join(lines)


def device_bytes_needed(packed: PackedDb, query_pack: bool = False) -> int:
    """Device memory the resident path needs: the int8 tile stream, its
    (T,) row map, the lane maps, and the int32 carry scratch (8 bytes per
    tile byte) that multi-strip and long queries use. With query_pack, also
    one pack's score planes and their int64 top-k keys (4 + 8 bytes per
    plane lane)."""
    tiles, outrow, n_rows = packed.flat_tiles()
    lanes = n_rows * int(packed.manifest["V"])
    need = tiles.nbytes * 9 + outrow.nbytes + lanes * 5 + 8 * (n_rows + 1)
    if query_pack:
        need += lanes * (qpack.N_SEG_CAP // 2) * 12
    return need


_DEVICE_TILE_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def device_tiles(packed: PackedDb, device=None):
    """Device-resident ragged tile stream of the whole DB, uploaded once
    per (PackedDb, device) and reused across queries. Returns (tiles,
    outrow, n_rows, row_start, mask, lane2sorted), all on the device.
    Raises if it would not fit in the device's free memory (no streaming
    in this package yet)."""
    dev = resolve_device(device)
    per_db = _DEVICE_TILE_CACHE.setdefault(packed, {})
    cached = per_db.get(str(dev))
    if cached is not None:
        return cached
    if dev.type == "cuda":
        free, _total = torch.cuda.mem_get_info(dev)
        need = device_bytes_needed(packed)
        if need > free:
            raise RuntimeError(
                f"the resident DB needs {need / 1e9:.2f} GB of device memory "
                f"(tile stream + scratch) but {free / 1e9:.2f} GB is "
                "free; DB streaming is not ported yet (ROADMAP.md Queue 1 "
                "item 'Streaming posture')")
    tiles, outrow, n_rows = packed.flat_tiles()
    mask, lane2sorted = packed.lane_maps()
    t = torch.from_numpy(np.ascontiguousarray(tiles)).to(dev)
    o = torch.from_numpy(outrow).to(dev)
    cached = (t, o, n_rows, scorer.row_starts(o, n_rows),
              torch.from_numpy(mask).to(dev),
              torch.from_numpy(lane2sorted.astype(np.int64)).to(dev))
    per_db[str(dev)] = cached
    return cached


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


def group_by_m_pad(queries, m_multiple: int) -> dict:
    """{padded profile length: [positions]} — one dispatch group each."""
    groups: dict = {}
    for pos, q in enumerate(queries):
        m_pad = -(-max(q.length, 1) // m_multiple) * m_multiple
        groups.setdefault(m_pad, []).append(pos)
    return groups


def scatter_lane_scores(packed: PackedDb, flat: np.ndarray) -> np.ndarray:
    """Map flat lane-order scores (n_rows*V,) to sorted-db order
    (n_seqs,), dropping pad lanes."""
    mask, lane2sorted = packed.lane_maps()
    out = np.zeros(packed.n_seqs, dtype=np.int32)
    out[lane2sorted[mask]] = flat[mask]
    return out


def score_lanes(dev_db, qp: torch.Tensor, mode: str,
                config: SearchConfig) -> torch.Tensor:
    """(n_rows * V,) int32 scores of every lane for one (32, m) profile."""
    tiles, outrow, n_rows, row_start = dev_db[:4]
    prec = kernel_precision(config)
    fn = (scorer.score_tiles if mode == "tiles"
          else longquery.score_tiles_long)
    return fn(tiles, outrow, n_rows, qp, config.gap_open, config.gap_extend,
              precision=prec, row_start=row_start).reshape(-1)


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
    prec = kernel_precision(config)
    packs = qpack.build_query_packs(queries, config.matrix)
    pending = []
    for p in packs:
        planes = scorer.score_tiles_packed(
            tiles, outrow, n_rows, torch.from_numpy(p.qp).to(dev),
            torch.from_numpy(p.seg_of_group).to(dev), config.gap_open,
            config.gap_extend, n_seg_cap=qpack.N_SEG_CAP, precision=prec,
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
    batch (once per pack on the packed path).

    Returns (hit lists in input order, padded query rows dispatched)."""
    check_supported(config)
    dev_db = device_tiles(packed, device)
    if config.query_pack and all(
            qpack._rows_needed(q.length) <= qpack.PACK_BUCKETS[-1]
            for q in queries):
        return _search_packed(packed, queries, config, dev_db)
    dev = dev_db[0].device
    mask, lane2sorted = dev_db[4], dev_db[5]
    k = min(config.top_k, mask.numel())
    out = [None] * len(queries)
    order, vs, sis = [], [], []
    padded_rows = 0
    for m_pad, positions in group_by_m_pad(
            queries, config.m_multiple).items():
        mode = select_mode(m_pad)
        padded_rows += dispatched_rows(mode, m_pad) * len(positions)
        for p in positions:
            qp = torch.from_numpy(build_query_profile(
                queries[p].codes, config.matrix, config.m_multiple)).to(dev)
            v, si = device_top_k(score_lanes(dev_db, qp, mode, config),
                                 mask, lane2sorted, k)
            order.append(p)
            vs.append(v)
            sis.append(si)
    if not order:
        return out, padded_rows
    vs_all = torch.stack(vs).cpu().numpy()      # synchronises the device
    sis_all = torch.stack(sis).cpu().numpy()
    for row, p in enumerate(order):
        out[p] = _hits_from(packed, vs_all[row], sis_all[row], config.top_k)
    return out, padded_rows


def search_fused(packed: PackedDb, query: FastaRecord, config: SearchConfig,
                 device=None):
    """Whole-DB search for one query; returns its hit list."""
    return search_fused_batch(packed, [query], config, device)[0][0]


def _chunk_scorer(config: SearchConfig):
    """chunks, their ChunkTable, qp (32, m) -> list of (B, V) scores, every
    launch over all the chunks at once: the one-pass chunk kernel, one
    launch, up to max_query_pad() rows; else the query-tiled one, one launch
    per query tile. Either raises if the carries of all chunks (8 bytes per
    code byte, allocated once per call) would not fit in the device memory
    that is free or held unused by PyTorch's allocator."""
    prec = kernel_precision(config)

    def dispatch(chunks, table, qp):
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
        if qp.shape[1] <= scorer.max_query_pad():
            return scorer.score_chunks(chunks, qp, config.gap_open,
                                       config.gap_extend, precision=prec,
                                       table=table)
        return longquery.score_chunks_long(
            chunks, qp, config.gap_open, config.gap_extend, precision=prec,
            table=table)

    return dispatch


def score_db(packed: PackedDb, query: FastaRecord,
             config: SearchConfig | None = None, device=None) -> np.ndarray:
    """All-lane scores for one query, in sorted-db order (n_seqs,) int32:
    one kernel launch over all chunks (a long query: one per query tile),
    all launched before the one synchronising device-to-host copy."""
    config = config or SearchConfig()
    check_supported(config)
    chunks, table = device_chunk_table(packed, device)
    out = np.zeros(packed.n_seqs, dtype=np.int32)
    if not chunks:
        return out
    qp = torch.from_numpy(build_query_profile(
        query.codes, config.matrix, config.m_multiple)).to(table.device)
    flat = torch.cat([s.reshape(-1) for s in _chunk_scorer(config)(
        chunks, table, qp)]).cpu().numpy()
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
    """Search a query batch against the resident DB.

    Returns (list[QueryResult], SearchMetrics)."""
    config = config or SearchConfig()
    check_supported(config)
    timer = PhaseTimer()
    t0 = time.perf_counter()
    with timer.phase("h2d"):             # one-time upload, then cached
        device_tiles(packed, device)
    with timer.phase("score"):
        hit_lists, padded_rows = search_fused_batch(packed, queries, config,
                                                    device)
    results = [QueryResult(q.title, q.length, h)
               for q, h in zip(queries, hit_lists)]
    seconds = time.perf_counter() - t0
    lane_positions = sum(ch.n_blocks * ch.L * ch.V for ch in packed.chunks)
    metrics = SearchMetrics(
        cells=int(packed.total_residues) * sum(q.length for q in queries),
        padded_cells=lane_positions * padded_rows,
        n_db_seqs=packed.n_seqs,
        n_queries=len(queries),
        seconds=seconds,
        timers=timer.report(),
    )
    return results, metrics
