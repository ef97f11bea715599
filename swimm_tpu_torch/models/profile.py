"""Query profile construction (counterpart of swimm_tpu/models/profile.py).

The reference pre-gathers substitution scores so the DP inner loop does no
scalar table lookups (SWIPE query-profile technique). The profile is a
``(32, m_pad)`` int table ``QP[a, i] = submat[a, q[i]]``; the CUDA kernels
stage a strip of its rows in shared memory and read ``QP[code, i]`` per
(db residue, query row).

Rows >= 24 (incl. PAD_CODE) and columns past the true query length score
PAD_SCORE, which (a) zero-clamps H on any pad cell and (b) makes pad-row DP
values strictly dominated by real rows, so no end-masking is needed anywhere.
"""

from __future__ import annotations

import numpy as np

from swimm_tpu_torch.alphabet import PAD_CODE, TABLE_CODES
from swimm_tpu_torch.matrices import kernel_table


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_query_profile(query_codes: np.ndarray, matrix="BLOSUM62",
                        m_multiple: int = 16) -> np.ndarray:
    """Return QP (TABLE_CODES, m_pad) int32 for one query."""
    table = kernel_table(matrix)  # (32, 32) int32, PAD-padded
    q = np.asarray(query_codes, dtype=np.int64)
    m_pad = round_up(max(len(q), 1), m_multiple)
    q_padded = np.full(m_pad, PAD_CODE, dtype=np.int64)
    q_padded[:len(q)] = q
    qp = table[:, q_padded]  # (32, m_pad)
    assert qp.shape == (TABLE_CODES, m_pad)
    return np.ascontiguousarray(qp, dtype=np.int32)
