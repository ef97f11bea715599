"""The plain reference: Smith-Waterman with Gotoh's affine gaps in plain
PyTorch, and the top-k order the configurations guarantee.

It imports nothing of the program. It reads the residues the harness made
(ASCII letters) and scores them with its own BLOSUM62 copy; a gap of
length g costs gap_open + g * gap_extend, as in the field's protocol.

The recurrence, for query row i and database column j:

    E[i,j] = max(H[i-1,j] - (go + ge), E[i-1,j] - ge)
    F[i,j] = max(H[i,j-1] - (go + ge), F[i,j-1] - ge)
    H[i,j] = max(0, H[i-1,j-1] + s(q_i, d_j), E[i,j], F[i,j])

and a sequence's score is its largest H. One step takes a whole query row
over many database sequences laid end to end, several queries at a time.
F runs along the row, so it is taken in closed form: with H0 = max(0,
diagonal, E), F[j] = max over k < j of H0[k] - (go + ge) - ge * (j - 1 - k)
(an F that wins at k adds nothing at k + 1, since go >= 0), which is one
cumulative maximum of H0[k] + ge * k. A sequence boundary resets the
diagonal, and an offset per sequence keeps the maximum from crossing it.

``ceiling`` saturates every H at that value: the control of a lower
precision (16-bit or 8-bit lanes with saturating arithmetic).
"""

from __future__ import annotations

import numpy as np
import torch

from swbench import blosum62

NEG = -(1 << 28)
WIDTH = 8192              # letters in one packed row (>= any sequence)
SEG_STRIDE = 1 << 17      # > any H + gap_extend * length in one sequence
DUMMY = WIDTH             # the segment number of padding (after any real)

_CODE = np.full(256, blosum62.ORDER.index("X"), dtype=np.uint8)
for _i, _c in enumerate(blosum62.ORDER):
    _CODE[ord(_c)] = _i
    _CODE[ord(_c.lower())] = _i


def codes(letters: np.ndarray) -> np.ndarray:
    """uint8 codes (blosum62.ORDER) of ASCII residue letters."""
    return _CODE[np.asarray(letters, dtype=np.uint8)]


def _next_fit(lens: list, width: int):
    """(row, offset) of each length laid end to end in rows of ``width``,
    a new row where the next one would not fit."""
    row_of = np.zeros(len(lens), np.int64)
    off_of = np.zeros(len(lens), np.int64)
    row = off = 0
    for k, L in enumerate(lens):
        if off + L > width:
            row, off = row + 1, 0
        row_of[k], off_of[k] = row, off
        off += L
    return row_of, off_of


def _pack(seqs: list, width: int, device):
    """One query's candidate letters packed into rows of ``width``, on
    ``device``: the sequences end to end in the order given, a new row
    where the next one would not fit. Returns (codes, candidate, segment,
    position), each (rows, width) int64: the residue code; the candidate's
    index (len(seqs) in padding); its number within the row, which
    increases along the row (padding: DUMMY); the position within its
    sequence (padding: the column)."""
    n = len(seqs)
    lens = np.array([len(x) for x in seqs], dtype=np.int64)
    row_of, off_of = _next_fit(lens.tolist(), width)
    rows = int(row_of[-1]) + 1 if n else 1
    kw = {"dtype": torch.int64, "device": device}
    codes_ = torch.zeros(rows * width, **kw)
    cand = torch.full((rows * width,), n, **kw)
    seg = torch.full((rows * width,), DUMMY, **kw)
    pos = torch.arange(width, **kw).repeat(rows)
    if n:
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)
        L = dev(lens)
        first = torch.cumsum(L, 0) - L
        within = (torch.arange(int(lens.sum()), **kw)
                  - torch.repeat_interleave(first, L))
        flat = torch.repeat_interleave(dev(row_of * width + off_of),
                                       L) + within
        row_start = np.searchsorted(row_of, row_of, side="left")
        codes_[flat] = dev(codes(np.concatenate(seqs))).long()
        cand[flat] = torch.repeat_interleave(torch.arange(n, **kw), L)
        seg[flat] = torch.repeat_interleave(dev(np.arange(n) - row_start),
                                            L)
        pos[flat] = within
    return tuple(t.view(rows, width) for t in (codes_, cand, seg, pos))


def _score_group(queries: list, cands: list, gap_open: int, gap_extend: int,
                 device, ceiling: int | None, width: int) -> list:
    """Scores of each query against its own candidates: one row step for
    all the group's queries and all their packed rows at once."""
    Q = len(queries)
    goe, ge = gap_open + gap_extend, gap_extend
    packs = [_pack(c, width, device) for c in cands]
    B = max(p[0].shape[0] for p in packs)
    nmax = max(len(c) for c in cands)

    def stack(j, fill):
        out = torch.full((Q, B, width), fill, dtype=torch.int64,
                         device=device)
        for r, p in enumerate(packs):
            out[r, :p[j].shape[0]] = p[j]
        return out
    db = stack(0, 0)
    cand = stack(1, nmax)
    for r, c in enumerate(cands):
        cand[r][cand[r] == len(c)] = nmax
    seg = stack(2, DUMMY)
    pos = stack(3, 0)
    pos[:] = torch.where(seg == DUMMY, torch.arange(width, device=device),
                         pos)
    first = pos == 0
    offs = seg * SEG_STRIDE
    add_t = (offs + ge * pos).int()                # t = H0 + add_t
    sub_f = (offs + goe + ge * (pos - 1)).int()    # F = cummax(t)[j-1] - sub_f
    del offs, seg, pos
    sub = torch.tensor(blosum62.rows(), dtype=torch.int8, device=device)
    prof = sub[:, db].permute(1, 0, 2, 3).contiguous()   # (Q, 24, B, W)
    del db
    qc = np.zeros((Q, max(len(q) for q in queries)), np.int64)
    for r, q in enumerate(queries):
        qc[r, :len(q)] = codes(q)
    qc_t = torch.from_numpy(qc).to(device)
    qlen = torch.tensor([len(q) for q in queries], device=device)
    rows_q = torch.arange(Q, device=device)
    H = torch.zeros((Q, B, width), dtype=torch.int32, device=device)
    E = torch.full_like(H, NEG)
    best = torch.zeros_like(H)
    zero = torch.zeros((Q, B, 1), dtype=torch.int32, device=device)
    for i in range(qc.shape[1]):
        s = prof[rows_q, qc_t[:, i]]                    # (Q, B, W) int8
        diag = torch.cat([zero, H[..., :-1]], 2).masked_fill_(first, 0)
        E = torch.maximum(H - goe, E.sub_(ge))
        H0 = torch.maximum(diag.add_(s), E).clamp_min_(0)
        if ceiling is not None:
            H0.clamp_max_(ceiling)
        cm = torch.cummax(H0 + add_t, 2).values
        F = torch.cat([zero, cm[..., :-1]], 2).sub_(sub_f)
        H = torch.maximum(H0, F)
        if ceiling is not None:
            H.clamp_max_(ceiling)
        live = (i < qlen).view(Q, 1, 1)
        best = torch.where(live, torch.maximum(best, H), best)
    out = torch.zeros((Q, nmax + 1), dtype=torch.int64, device=device)
    out.scatter_reduce_(1, cand.view(Q, -1), best.view(Q, -1).long(),
                        reduce="amax")
    out = out.cpu().numpy()
    return [out[r, :len(cands[r])] for r in range(Q)]


def plan_groups(lengths: list, widths: list, budget: int,
                step_s: float = 2e-4, elem_s: float = 6e-11) -> list:
    """Queries (indices, sorted by length) cut into groups that score
    together, by the least modelled time: a group of longest query M whose
    queries hold sum(w) packed letters costs M * (step_s + elem_s *
    len(group) * max(w)), and no group's letters pass ``budget``."""
    order = sorted(range(len(lengths)), key=lambda r: lengths[r])
    n = len(order)
    best = [0.0] + [float("inf")] * n
    cut = [0] * (n + 1)
    for j in range(1, n + 1):
        w = 0
        for i in range(j - 1, -1, -1):
            w = max(w, widths[order[i]])
            if (j - i) * w > budget and i < j - 1:
                break
            c = best[i] + lengths[order[j - 1]] * (
                step_s + elem_s * (j - i) * w)
            if c < best[j]:
                best[j], cut[j] = c, i
    groups, j = [], n
    while j > 0:
        groups.append(order[cut[j]:j])
        j = cut[j]
    return groups[::-1]


def _blocks(cand: list, budget: int) -> list:
    """(start, stop) of consecutive runs of ``cand`` of about ``budget``
    letters each (a sequence goes with the run it starts in)."""
    if not cand:
        return [(0, 0)]
    ends = np.cumsum([len(x) for x in cand])
    block = (ends - 1) // budget
    cuts = np.flatnonzero(np.diff(block)) + 1
    edges = [0, *cuts.tolist(), len(cand)]
    return list(zip(edges[:-1], edges[1:]))


def score(queries: list, cands: list, gap_open: int, gap_extend: int,
          device="cpu", ceiling: int | None = None,
          budget: int = 1 << 26) -> list:
    """Each query's scores against its own list of candidate sequences
    (ASCII letter arrays): a list of int64 arrays, one per query. A list
    of more than ``budget`` letters (a whole database) is scored in blocks
    of about that many; the blocks are scored in groups (plan_groups),
    each group's (queries x packed letters) under ``budget`` elements."""
    width = max([WIDTH] + [len(x) for c in cands for x in c])
    parts = [(r, a, b) for r, c in enumerate(cands)
             for a, b in _blocks(c, budget)]
    widths = [width * (int(_next_fit([len(x) for x in cands[r][a:b]],
                                     width)[0][-1]) + 1 if b > a else 1)
              for r, a, b in parts]
    got = [None] * len(parts)
    for g in plan_groups([len(queries[r]) for r, _, _ in parts], widths,
                         budget):
        res = _score_group([queries[parts[j][0]] for j in g],
                           [cands[parts[j][0]][parts[j][1]:parts[j][2]]
                            for j in g],
                           gap_open, gap_extend, device, ceiling, width)
        for j, v in zip(g, res):
            got[j] = v
    out = [[] for _ in queries]
    for (r, _, _), v in zip(parts, got):
        out[r].append(v)
    return [np.concatenate(v) for v in out]


def sorted_rank(lengths: np.ndarray) -> np.ndarray:
    """Each original index's position in the stable length-ascending order
    (docs/DB_FORMAT.md): the second key of the guaranteed hit order."""
    order = np.argsort(lengths, kind="stable")
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order))
    return rank


def top_k(cand: np.ndarray, scores: np.ndarray, rank: np.ndarray, k: int,
          reverse_ties: bool = False) -> list:
    """The k best candidates in the guaranteed order (score descending,
    sorted index ascending), as (score, original index) pairs.
    reverse_ties breaks ties the other way: a control."""
    tie = -rank[cand] if reverse_ties else rank[cand]
    idx = np.lexsort((tie, -scores))[:k]
    return [(int(scores[i]), int(cand[i])) for i in idx]
