"""Pure-NumPy Gotoh affine-gap Smith-Waterman oracle.

This is test-oracle #1 (SURVEY.md section 5, implication 1): a direct O(mn)
transcription of the Gotoh recurrence that every faster path in the framework
must match bit-exactly. It is deliberately simple and is cross-checked against
the independently written C scorer (csrc/swref.c).

Recurrence / gap convention (the bit-exactness contract, SURVEY.md section 4.2):
a gap of length k costs ``gap_open + k * gap_extend`` — i.e. the first gap
residue is charged open+extend:

    H(i,j) = max(0, H(i-1,j-1) + S(q_i, d_j), E(i,j), F(i,j))
    E(i,j) = max(H(i,j-1) - (Go+Ge), E(i,j-1) - Ge)
    F(i,j) = max(H(i-1,j) - (Go+Ge), F(i-1,j) - Ge)
    score  = max over i,j of H(i,j)

Scores only — no traceback — matching the reference engine (SURVEY.md
section 1: "scores only, like SWIPE's default mode").
"""

from __future__ import annotations

import numpy as np


def sw_score(query: np.ndarray, db: np.ndarray, submat: np.ndarray,
             gap_open: int, gap_extend: int) -> int:
    """Exact local-alignment score of one query vs one db sequence.

    Args:
      query, db: uint8 residue codes.
      submat: (A, A) int substitution matrix (A >= max code + 1).
      gap_open, gap_extend: positive penalties; gap length k costs
        gap_open + k * gap_extend.
    """
    q = np.asarray(query, dtype=np.int64)
    d = np.asarray(db, dtype=np.int64)
    m, n = len(q), len(d)
    goe = gap_open + gap_extend
    ge = gap_extend
    sub = np.asarray(submat, dtype=np.int64)

    NEG = np.int64(-(1 << 40))
    h_prev = np.zeros(m + 1, dtype=np.int64)   # column j-1 of H
    e_prev = np.full(m + 1, NEG, dtype=np.int64)  # column j-1 of E
    best = np.int64(0)
    for j in range(n):
        h_col = np.zeros(m + 1, dtype=np.int64)
        e_col = np.full(m + 1, NEG, dtype=np.int64)
        f = NEG
        dj = d[j]
        for i in range(1, m + 1):
            e = max(h_prev[i] - goe, e_prev[i] - ge)
            f = max(h_col[i - 1] - goe, f - ge)
            h = max(0, h_prev[i - 1] + sub[q[i - 1], dj], e, f)
            h_col[i] = h
            e_col[i] = e
            if h > best:
                best = h
        h_prev, e_prev = h_col, e_col
    return int(best)

