"""The plain reference of an alignment: Smith-Waterman with Gotoh's affine
gaps in plain PyTorch, with the path, for BLAST tabular (m8) rows.

It imports nothing of the program. It reads the residues the harness made
(ASCII letters), scores them with its own BLOSUM62 copy (blosum62.py) and
counts a gap of length g as gap_open + g * gap_extend. For query row i and
subject column j (1-based; row 0 and column 0 hold H = 0, E = F = -inf):

    E[i,j] = max(H[i,j-1] - (go + ge), E[i,j-1] - ge)    a gap in the query
    F[i,j] = max(H[i-1,j] - (go + ge), F[i-1,j] - ge)    a gap in the subject
    H[i,j] = max(0, H[i-1,j-1] + s(q_i, d_j), E[i,j], F[i,j])

The path, by the tie rules the configuration guarantees:

- it ends at the first maximum of H in row-major order ((0, 0), an empty
  path, when every H is 0);
- from a cell in H it stops where H = 0, else takes the diagonal where H
  equals it, else E where H equals E, else F (``e_first`` puts E before
  the diagonal: a control, not the rule);
- in E or F it extends the gap only where extending wins strictly, else
  returns to H at the cell it opened from;
- it stops at row or column 0.

How it is worked. One step takes a whole query row over many subjects
laid end to end in rows of ``WIDTH`` letters, for a group of queries at
once (each against its own subjects). F runs down the columns and is
elementwise; E runs along the row and is taken in closed form from H0 =
max(0, diagonal, F): E[j] = max over k < j of H0[k] - (go + ge) - ge * (j
- 1 - k), one cumulative maximum of H0[k] + ge * k, with an offset per
subject so that the maximum never crosses into the next (a subject's
first column takes E = -(go + ge), its value from column 0). Each cell's
4-bit backpointer (H's source, E extends, F extends) is kept on the
device, one byte a cell; each column keeps its largest H and the first
row it was reached at, which gives each pair's end cell. The walk then
steps every pair of the group back at once. Groups are cut so that the
backpointers stay under a budget of bytes.

m8 rows hold columns 1-10 of BLAST+ -outfmt 6: qseqid, sseqid, pident
(identities / alignment columns, two decimals), length (columns),
mismatch (residue pairs that differ), gapopen (gap runs in the aligned
query plus those in the aligned subject), qstart, qend, sstart, send
(1-based, inclusive); evalue and bitscore print ``*``.
"""

from __future__ import annotations

import numpy as np
import torch

from swbench import blosum62
from swbench.reference import codes

WIDTH = 8192             # letters in one packed row (>= any subject)
BP_BUDGET = 1 << 31      # backpointer bytes of one group
ELEM_BUDGET = 1 << 24    # cells of one row step of one group
STOP, DIAG, FROM_E, FROM_F = 0, 1, 2, 3
# one pair's counts, in this order
FIELDS = ("score", "q_start", "q_end", "d_start", "d_end", "length",
          "identities", "positives", "gaps", "q_opens", "d_opens", "check")


def _next_fit(lens, width: int):
    row_of = np.zeros(len(lens), np.int64)
    off_of = np.zeros(len(lens), np.int64)
    row = off = 0
    for k, L in enumerate(lens):
        if off + L > width:
            row, off = row + 1, 0
        row_of[k], off_of[k] = row, off
        off += L
    return row_of, off_of


def _rows_of(subjects: list, width: int) -> int:
    return int(_next_fit([len(s) for s in subjects], width)[0][-1]) + 1 \
        if subjects else 1


def _group(queries: list, subjects: list, gap_open: int, gap_extend: int,
           device, width: int, e_first: bool) -> list:
    """Each pair's counts (FIELDS) for a group of queries, each against
    its own list of subjects: a list per query of (n_subjects, 12) int64
    arrays."""
    Q = len(queries)
    goe, ge = gap_open + gap_extend, gap_extend
    kw = {"dtype": torch.int64, "device": device}
    B = max(_rows_of(s, width) for s in subjects)
    npair = max(len(s) for s in subjects) + 1          # the last: padding
    dcode = np.zeros((Q, B, width), np.int64)
    pair = np.full((Q, B, width), npair - 1, np.int64)
    pos = np.tile(np.arange(width, dtype=np.int64), (Q, B, 1))
    seg = np.full((Q, B, width), width, np.int64)      # padding: after all
    base = np.zeros((Q, npair), np.int64)              # a pair's first cell
    for r, subs in enumerate(subjects):
        row_of, off_of = _next_fit([len(s) for s in subs], width)
        for k, s in enumerate(subs):
            b, o = int(row_of[k]), int(off_of[k])
            dcode[r, b, o:o + len(s)] = codes(s)
            pair[r, b, o:o + len(s)] = k
            pos[r, b, o:o + len(s)] = np.arange(len(s))
            seg[r, b, o:o + len(s)] = k
            base[r, k] = b * width + o
    M = max(len(q) for q in queries)
    qc = np.zeros((Q, max(M, 1)), np.int64)
    for r, q in enumerate(queries):
        qc[r, :len(q)] = codes(q)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    d_t, pos_t, seg_t = dev(dcode), dev(pos), dev(seg)
    first = pos_t == 0
    real = dev(pair) != npair - 1
    # E's closed form: t = H0 + ge * pos + off; E = excl-cummax(t) - sub_e
    off = seg_t << 34
    add_t = off + ge * pos_t
    sub_e = off + goe + ge * (pos_t - 1)
    sub = torch.tensor(blosum62.rows(), **kw)          # (24, 24)
    qc_t = dev(qc)
    qlen = torch.tensor([len(q) for q in queries], **kw).view(Q, 1, 1)
    shape = (Q, B, width)
    bp = torch.zeros((max(M, 1),) + shape, dtype=torch.uint8, device=device)
    H = torch.zeros(shape, **kw)
    F = torch.full(shape, -(1 << 40), **kw)
    best = torch.zeros(shape, **kw)
    best_row = torch.zeros(shape, **kw)
    zero = torch.zeros((Q, B, 1), **kw)
    flat_d = d_t.view(Q, -1)
    for i in range(1, M + 1):
        s = torch.gather(sub[qc_t[:, i - 1]], 1, flat_d).view(shape)
        diag = torch.cat([zero, H[..., :-1]], 2).masked_fill_(first, 0)
        f_open, f_ext = H - goe, F - ge
        F = torch.maximum(f_open, f_ext)
        dg = diag + s
        H0 = torch.maximum(torch.maximum(dg, F), torch.zeros_like(dg))
        cm = torch.cummax(H0 + add_t, 2).values
        E = torch.cat([zero - (1 << 40), cm[..., :-1]], 2) - sub_e
        E = torch.where(first, torch.full_like(E, -goe), E)
        Hn = torch.maximum(H0, E)
        # E at column j extends where E[j-1] - ge beats H[j-1] - goe
        e_ext = torch.cat([zero, (E[..., :-1] - ge > Hn[..., :-1] - goe)
                           .long()], 2).masked_fill_(first, 0)
        if e_first:
            src = torch.where(Hn == 0, STOP, torch.where(
                Hn == E, FROM_E, torch.where(Hn == dg, DIAG, FROM_F)))
        else:
            src = torch.where(Hn == 0, STOP, torch.where(
                Hn == dg, DIAG, torch.where(Hn == E, FROM_E, FROM_F)))
        bp[i - 1] = (src | (e_ext << 2) | ((f_ext > f_open).long() << 3)
                     ).to(torch.uint8)
        live = i <= qlen
        up = live & real & (Hn > best)
        best = torch.where(up, Hn, best)
        best_row = torch.where(up, torch.full_like(best_row, i), best_row)
        H = Hn
    # each pair's end cell: its largest H, at the smallest (row, column)
    P = Q * npair
    gid = (pair + np.arange(Q).reshape(Q, 1, 1) * npair).reshape(-1)
    gid_t = dev(gid)
    top = torch.zeros(P, **kw).scatter_reduce_(
        0, gid_t, best.reshape(-1), reduce="amax")
    at_top = best.reshape(-1) == top[gid_t]
    key = best_row.reshape(-1) * (width + 1) + pos_t.reshape(-1)
    big = torch.full((P,), 1 << 62, **kw)
    first_key = big.scatter_reduce(
        0, gid_t, torch.where(at_top, key, big[gid_t]), reduce="amin")
    score = top
    end_i = torch.where(score > 0, first_key // (width + 1), 0)
    end_j = torch.where(score > 0, first_key % (width + 1) + 1, 0)
    # the walk: every pair of the group one step at a time
    pair_base = dev((base + np.arange(Q).reshape(Q, 1) * (B * width))
                    .reshape(-1))
    q_of = torch.arange(P, **kw) // npair
    plane = Q * B * width
    bp_flat = bp.view(-1)
    d_flat = d_t.reshape(-1)
    i, j = end_i.clone(), end_j.clone()
    state = torch.full((P,), DIAG, **kw)
    prev = torch.full((P,), DIAG, **kw)
    cnt = {f: torch.zeros(P, **kw) for f in FIELDS[5:]}
    while True:
        act = (i > 0) & (j > 0)
        if not bool(act.any()):
            break
        cell = ((i - 1).clamp_min(0) * plane + pair_base
                + (j - 1).clamp_min(0))
        code = bp_flat[torch.where(act, cell, 0)].long()
        in_h = act & (state == DIAG)
        src = code & 3
        stop = in_h & (src == STOP)
        take = in_h & (src == DIAG)
        to_gap = in_h & ((src == FROM_E) | (src == FROM_F))
        in_e = act & (state == FROM_E)
        in_f = act & (state == FROM_F)
        a = qc_t[q_of, (i - 1).clamp_min(0)]
        b = d_flat[torch.where(act, cell - (i - 1).clamp_min(0) * plane, 0)]
        sc = sub[a, b]
        gap = in_e | in_f
        kind = torch.where(in_e, FROM_E, FROM_F)
        new_run = gap & (prev != kind)
        cnt["length"] += (take | gap).long()
        cnt["identities"] += (take & (a == b)).long()
        cnt["positives"] += (take & ((a == b) | (sc > 0))).long()
        cnt["gaps"] += gap.long()
        cnt["q_opens"] += (new_run & in_e).long()
        cnt["d_opens"] += (new_run & in_f).long()
        cnt["check"] += torch.where(take, sc, 0) - torch.where(
            gap, torch.where(new_run, goe, ge), 0)
        prev = torch.where(take, DIAG, torch.where(gap, kind, prev))
        ext = torch.where(in_e, (code >> 2) & 1, (code >> 3) & 1) == 1
        state = torch.where(to_gap, src, torch.where(
            gap & ~ext, DIAG, state))
        i = i - (take | in_f).long()
        j = j - (take | in_e).long()
        # a stop ends the walk where it is
        i = torch.where(stop, -i - 1, i)
    i = torch.where(i < 0, -i - 1, i)
    out = torch.stack([score, i, end_i, j, end_j] + [cnt[f] for f in
                                                      FIELDS[5:]], 1)
    out = out.cpu().numpy().reshape(Q, npair, len(FIELDS))
    return [out[r, :len(subjects[r])] for r in range(Q)]


def plan(qlens: list, rows: list, width: int, bp_budget: int,
         elem_budget: int) -> list:
    """Queries (indices, by length) cut into groups whose backpointers
    (longest query x rows x width bytes) and row step (rows x width cells)
    stay under their budgets; a query over them alone."""
    order = sorted(range(len(qlens)), key=lambda r: qlens[r])
    groups, cur, n_rows = [], [], 0
    for r in order:
        grow = n_rows + rows[r]
        if cur and (max(qlens[r], 1) * grow * width > bp_budget
                    or grow * width > elem_budget):
            groups.append(cur)
            cur, grow = [], rows[r]
        cur.append(r)
        n_rows = grow
    if cur:
        groups.append(cur)
    return groups


def align(queries: list, subjects: list, gap_open: int, gap_extend: int,
          device="cpu", e_first: bool = False,
          bp_budget: int = BP_BUDGET,
          elem_budget: int = ELEM_BUDGET) -> list:
    """Each (query, subject) pair's counts: for each query (ASCII letter
    array) and its list of subjects, an (n_subjects, 12) int64 array of
    FIELDS. Raises if a path's own score is not the DP's."""
    width = max([WIDTH] + [len(s) for subs in subjects for s in subs])
    todo = [r for r in range(len(queries)) if subjects[r]]
    out = [np.zeros((len(s), len(FIELDS)), np.int64) for s in subjects]
    rows = [_rows_of(subjects[r], width) for r in todo]
    for g in plan([len(queries[r]) for r in todo], rows, width, bp_budget,
                  elem_budget):
        got = _group([queries[todo[k]] for k in g],
                     [subjects[todo[k]] for k in g], gap_open, gap_extend,
                     device, width, e_first)
        for k, v in zip(g, got):
            out[todo[k]] = v
    for v in out:
        if (v[:, 0] != v[:, -1]).any():
            raise AssertionError("the reference's path does not score its "
                                 "DP's maximum")
    return out


def m8_row(qid: str, sid: str, c) -> str:
    """One m8 row of a pair's counts (FIELDS order); evalue and bitscore
    ``*``."""
    length, ident, gaps = int(c[5]), int(c[6]), int(c[8])
    return "\t".join([
        qid, sid, f"{100.0 * ident / max(length, 1):.2f}", str(length),
        str(length - ident - gaps), str(int(c[9]) + int(c[10])),
        str(int(c[1]) + 1), str(int(c[2])), str(int(c[3]) + 1),
        str(int(c[4])), "*", "*"])
