"""Alignments (score and path) of many (query, subject) pairs in one call:
the one owner of alignment for the server's ``"align"`` and ``"format":
"m8"`` and the CLI's ``--align`` and ``--format m8``.

``align_pairs`` gives the ``ops.traceback.Alignment`` records of a list of
pairs, ``align_hits`` those of every reported hit of a search (one call
for all the queries of a batch or of a coalesced dispatch):

- on a CUDA device, ``sw_align_kernel`` (csrc/sw_align.cu, built the first
  time an alignment is asked for, never by ``scorer.build_kernels``): one
  warp per pair runs a Gotoh pass that keeps a 4-bit backpointer per cell,
  finds the end cell and walks back to the path, counting identities,
  positives, gap columns, gap runs and the path's own score on the card.
  The pairs' codes go up in one copy, the counts and the paths come back
  in one. Pairs are launched in groups whose backpointer workspace stays
  under ``WORKSPACE_BYTES`` (a pair larger than that runs alone), so a
  64-query dispatch of 6,000-aa queries with 16 hits of 6,000 aa each
  (18 MB a pair) takes 18 launches;
- on the CPU, ``ops.traceback.sw_align`` for each pair, as it is.

Both give the same records, bit for bit: the kernel follows sw_align's
recurrence and tie rules (its header says how). The aligned strings and
the midline are built on the host from the path the kernel returns. Every
path's score is held to the DP's (the kernel's own count) and, where the
caller gives them, to the scores the search reported, once per group.

Always-on counters (utils/metrics.py ``count``): ``align.launches``
(kernel launches), ``align.pairs`` and ``align.cells`` (sum of query
length x subject length) of every pair aligned, on either device. A
launch under a torch profiler is an ``align.launch`` span with attrs
``kernel`` and ``cells``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from swimm_tpu_torch.alphabet import ALPHABET
from swimm_tpu_torch.matrices import get_matrix
from swimm_tpu_torch.ops.traceback import Alignment, sw_align
from swimm_tpu_torch.utils.metrics import count, span

#: the largest backpointer workspace of one launch (4 bits a cell)
WORKSPACE_BYTES = 1 << 30
#: the CUDA kernel's name, as the profiler shows it
KERNEL = "sw_align_kernel"

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"sw_align_launch": [_PTR, _PTR, _INT, _PTR, _INT, _INT, _INT,
                                  _PTR, _PTR, _PTR, _PTR, _PTR]}
DESC = 8   # int64 words of one pair's descriptor (csrc/sw_align.cu)
OUT = 12   # int32 results of one pair
#: the results' columns, in csrc/sw_align.cu's order
(SCORE, QSTART, QEND, DSTART, DEND, LENGTH, IDENT, POS, GAPS, QOPENS,
 DOPENS, CHECK) = range(OUT)

#: letter of each code, then of a gap (code 24)
_LETTERS = np.frombuffer((ALPHABET + "-").encode(), dtype=np.uint8)
_GAP = len(ALPHABET)
_MID = np.frombuffer(b" +|", dtype=np.uint8)
_TABLES: dict = {}


def kernels():
    """The built sw_align library (compiled on first call)."""
    from swimm_tpu_torch.ops import _build
    return _build.load("sw_align", SIGNATURES)


def workspace_bytes(m: int, n: int) -> int:
    """Backpointer bytes of one m x n pair: a 32-bit word holds the cells
    of eight query rows at one subject column."""
    return 4 * ((m + 7) // 8) * n


def groups(sizes, cap: int | None = None) -> list:
    """(start, stop) of consecutive runs of pairs whose workspace sizes sum
    to at most ``cap`` (WORKSPACE_BYTES by default; a pair over it
    alone)."""
    cap = WORKSPACE_BYTES if cap is None else cap
    out, start, total = [], 0, 0
    for k, size in enumerate(sizes):
        if k > start and total + size > cap:
            out.append((start, k))
            start, total = k, 0
        total += size
    if len(sizes) > start:
        out.append((start, len(sizes)))
    return out


def _table(matrix: str, device) -> torch.Tensor:
    """The (24, 24) int32 matrix on the device, uploaded once."""
    key = (matrix, str(device))
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(
            get_matrix(matrix).astype(np.int32)).to(device)
    return _TABLES[key]


def _codes(pairs: list) -> tuple:
    """Every pair's query and subject codes end to end (and one byte
    more), and each pair's query and subject offsets in it."""
    seqs = [x for pair in pairs for x in pair]
    ends = np.cumsum([len(x) for x in seqs], dtype=np.int64)
    blob = np.concatenate(seqs + [np.zeros(1, np.uint8)])
    starts = ends - [len(x) for x in seqs]
    return blob, starts[0::2], starts[1::2]


def _records(pairs: list, res: np.ndarray, paths: np.ndarray,
             sub: np.ndarray) -> list:
    """The Alignments of one launch from the kernel's counts (``res``) and
    its paths (``paths``: each pair's columns last first, m + n bytes a
    pair; 0 a residue pair, 1 a gap in the query, 2 a gap in the
    subject), the strings of all of them built at once."""
    blob, qoff, doff = _codes(pairs)
    L = res[:, LENGTH].astype(np.int64)
    span_ = np.array([len(q) + len(d) for q, d in pairs], dtype=np.int64)
    first = np.cumsum(L) - L                  # each path in the flat order
    pid = np.repeat(np.arange(len(pairs)), L)
    k = np.arange(int(L.sum())) - first[pid]
    ops = paths[(np.cumsum(span_) - span_)[pid] + L[pid] - 1 - k]
    takes_q, takes_d = ops != 1, ops != 2
    before_q = np.cumsum(takes_q) - takes_q   # columns before that take
    before_d = np.cumsum(takes_d) - takes_d   # a residue, over all paths
    qi = res[pid, QSTART] + before_q - before_q[first[pid]]
    dj = res[pid, DSTART] + before_d - before_d[first[pid]]
    qc = np.where(takes_q, blob[qoff[pid] + qi], _GAP)
    dc = np.where(takes_d, blob[doff[pid] + dj], _GAP)
    pair = ops == 0
    score = np.where(pair, sub[np.minimum(qc, _GAP - 1),
                               np.minimum(dc, _GAP - 1)], 0)
    mid = np.where(pair & (qc == dc), 2, np.where(pair & (score > 0), 1, 0))
    q_all = _LETTERS[qc].tobytes().decode()
    d_all = _LETTERS[dc].tobytes().decode()
    m_all = _MID[mid].tobytes().decode()
    return [Alignment(int(r[SCORE]), int(r[QSTART]), int(r[QEND]),
                      int(r[DSTART]), int(r[DEND]), q_all[a:a + n],
                      d_all[a:a + n], m_all[a:a + n], int(r[IDENT]),
                      int(r[POS]), int(r[GAPS]))
            for r, a, n in zip(res, first.tolist(), L.tolist())]


def _launch(pairs: list, table: torch.Tensor, gap_open: int,
            gap_extend: int, device) -> tuple:
    """One launch of sw_align_kernel over ``pairs``: (results (P, 12)
    int32, the paths: m + n bytes a pair, each last column first)."""
    from swimm_tpu_torch.ops.scorer import raise_on
    P = len(pairs)
    m = np.array([len(q) for q, _ in pairs], dtype=np.int64)
    n = np.array([len(d) for _, d in pairs], dtype=np.int64)
    blob, qoff, doff = _codes(pairs)
    desc = np.zeros((P, DESC), dtype=np.int64)
    desc[:, 0], desc[:, 1], desc[:, 2], desc[:, 3] = qoff, m, doff, n
    words = (m + 7) // 8 * n
    desc[:, 4] = np.cumsum(words) - words
    rows = 2 * (n + 1)
    desc[:, 5] = np.cumsum(rows) - rows
    desc[:, 6] = P * OUT * 4 + np.cumsum(m + n) - (m + n)
    cells = int((m * n).sum())
    lib = kernels()
    with torch.cuda.device(device):
        codes_t = torch.from_numpy(blob).to(device)
        desc_t = torch.from_numpy(desc).to(device)
        bp = torch.empty(max(int(words.sum()), 1), dtype=torch.int32,
                         device=device)
        row = torch.empty(max(int(rows.sum()), 1), dtype=torch.int32,
                          device=device)
        # the results, then the paths: one buffer, one copy back
        back = torch.empty(P * OUT * 4 + int((m + n).sum()),
                           dtype=torch.uint8, device=device)
        with span("align.launch", kernel=KERNEL, cells=cells):
            err = lib.sw_align_launch(
                codes_t.data_ptr(), desc_t.data_ptr(), P, table.data_ptr(),
                table.shape[0], gap_open + gap_extend, gap_extend,
                bp.data_ptr(), row.data_ptr(), back.data_ptr(),
                back.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream)
        raise_on(err, KERNEL)
        host = back.cpu().numpy()
    count("align.launches")
    return host[:P * OUT * 4].view(np.int32).reshape(P, OUT), \
        host[P * OUT * 4:]


def align_pairs(pairs, matrix: str = "BLOSUM62", gap_open: int = 10,
                gap_extend: int = 2, device="cpu") -> list:
    """The Alignment of each (query codes, subject codes) pair, in order,
    as ops.traceback.sw_align gives it, under the named matrix."""
    pairs = [(np.asarray(q, dtype=np.uint8), np.asarray(d, dtype=np.uint8))
             for q, d in pairs]
    device = torch.device(device)
    count("align.pairs", len(pairs))
    count("align.cells", sum(len(q) * len(d) for q, d in pairs))
    if device.type == "cpu":
        return [sw_align(q, d, matrix=matrix, gap_open=gap_open,
                         gap_extend=gap_extend) for q, d in pairs]
    sub = get_matrix(matrix).astype(np.int64)
    table = _table(matrix, device)
    out = []
    for a, b in groups([workspace_bytes(len(q), len(d)) for q, d in pairs]):
        res, paths = _launch(pairs[a:b], table, gap_open, gap_extend,
                             device)
        bad = np.flatnonzero(res[:, CHECK] != res[:, SCORE])
        if len(bad):
            k = int(bad[0])
            raise AssertionError(
                f"traceback self-check failed: path scores "
                f"{res[k, CHECK]}, DP says {res[k, SCORE]}")
        out += _records(pairs[a:b], res, paths, sub)
    return out


def align_hits(results, queries, packed, config, device="cpu") -> list:
    """Each reported hit's Alignment, one list per query (parallel to
    ``results[i].hits``), in one align_pairs call for all of them; each
    path's score must equal the hit's score."""
    hits = [h for r in results for h in r.hits]
    flat = align_pairs([(q.codes, packed.seq_codes(h.sorted_idx))
                        for q, r in zip(queries, results) for h in r.hits],
                       matrix=config.matrix, gap_open=config.gap_open,
                       gap_extend=config.gap_extend, device=device)
    bad = np.flatnonzero(np.array([a.score for a in flat], dtype=np.int64)
                         != np.array([h.score for h in hits], dtype=np.int64))
    if len(bad):   # a probe from the search kernels to the traceback
        a, h = flat[bad[0]], hits[bad[0]]
        raise AssertionError(f"traceback score {a.score} != device hit "
                             f"score {h.score} for {h.title!r}")
    out, off = [], 0
    for r in results:
        out.append(flat[off:off + len(r.hits)])
        off += len(r.hits)
    return out
