"""Host alignment of the reported hits (counterpart of
swimm_tpu/ops/traceback.py, copied).

A numpy Gotoh pass with backpointers, run on the host for the <= top_k
sequences of a hit list only: O(k * mn) host work beside a
database-sized device search. It is not a kernel of the JAX package either.
ops/align.py runs it for the CLI's --align and --format m8 and the
server's "align" and "format": "m8" on the CPU; on a card they take
sw_align_kernel, which is held to it bit for bit.

Same recurrence and gap convention as ops/reference.py (a gap of length k
costs gap_open + k * gap_extend). Ties are broken as in swimm_tpu: the
diagonal first, then E, then F; a gap extends only when extending wins
strictly. The recovered path's score is re-derived from the aligned pairs
and must equal the DP score (a self-check); callers also hold it against
the device hit score (a probe from kernel to traceback).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from swimm_tpu_torch.alphabet import ALPHABET
from swimm_tpu_torch.matrices import get_matrix

# backpointer codes for the H state
_STOP, _DIAG, _FROM_E, _FROM_F = 0, 1, 2, 3


@dataclass
class Alignment:
    score: int
    q_start: int          # 0-based inclusive, query residue offset
    q_end: int            # 0-based exclusive
    d_start: int
    d_end: int
    q_aln: str            # aligned query with '-' gaps
    d_aln: str
    midline: str          # '|' identity, '+' positive score, ' ' otherwise
    n_identity: int
    n_positive: int
    n_gaps: int

    @property
    def length(self) -> int:
        return len(self.q_aln)

    def pretty(self, width: int = 60) -> str:
        """BLAST-style alignment block."""
        out = [f"Score = {self.score}, Identities = {self.n_identity}/"
               f"{self.length} ({100 * self.n_identity // max(self.length, 1)}%), "
               f"Positives = {self.n_positive}/{self.length}, "
               f"Gaps = {self.n_gaps}/{self.length}"]
        qp, dp = self.q_start, self.d_start
        for off in range(0, self.length, width):
            qs = self.q_aln[off:off + width]
            ms = self.midline[off:off + width]
            ds = self.d_aln[off:off + width]
            q2 = qp + len(qs) - qs.count("-")
            d2 = dp + len(ds) - ds.count("-")
            out.append(f"Query  {qp + 1:>5} {qs} {q2}")
            out.append(f"             {ms}")
            out.append(f"Sbjct  {dp + 1:>5} {ds} {d2}")
            qp, dp = q2, d2
        return "\n".join(out)


def sw_align(query: np.ndarray, db: np.ndarray, matrix="BLOSUM62",
             gap_open: int = 10, gap_extend: int = 2) -> Alignment:
    """Optimal local alignment (scores AND path) of query vs one sequence.

    O(mn) time and memory — intended for the <= top_k hits only.
    """
    sub = (get_matrix(matrix) if isinstance(matrix, str)
           else np.asarray(matrix)).astype(np.int64)
    q = np.asarray(query, dtype=np.int64)
    d = np.asarray(db, dtype=np.int64)
    m, n = len(q), len(d)
    goe = gap_open + gap_extend
    ge = gap_extend
    NEG = -(1 << 40)

    H = np.zeros((m + 1, n + 1), dtype=np.int64)
    E = np.full((m + 1, n + 1), NEG, dtype=np.int64)   # gap in query dir (j)
    F = np.full((m + 1, n + 1), NEG, dtype=np.int64)   # gap in db dir (i)
    bp_h = np.zeros((m + 1, n + 1), dtype=np.int8)
    # E/F backpointers: True = extend (came from E/F), False = open (from H)
    bp_e = np.zeros((m + 1, n + 1), dtype=bool)
    bp_f = np.zeros((m + 1, n + 1), dtype=bool)

    # vectorized over j for each i (substitution row gathered once)
    for i in range(1, m + 1):
        srow = sub[q[i - 1], d]                        # (n,)
        # E along j must be sequential? E(i,j) depends on H(i,j-1) which
        # depends on E(i,j) of the same row -> row-sequential. Keep the
        # scalar inner loop (k hits only; clarity beats speed here).
        for j in range(1, n + 1):
            e_open = H[i, j - 1] - goe
            e_ext = E[i, j - 1] - ge
            E[i, j] = max(e_open, e_ext)
            bp_e[i, j] = e_ext > e_open                # extend wins strictly
            f_open = H[i - 1, j] - goe
            f_ext = F[i - 1, j] - ge
            F[i, j] = max(f_open, f_ext)
            bp_f[i, j] = f_ext > f_open
            diag = H[i - 1, j - 1] + srow[j - 1]
            h = max(0, diag, E[i, j], F[i, j])
            H[i, j] = h
            if h == 0:
                bp_h[i, j] = _STOP
            elif h == diag:
                bp_h[i, j] = _DIAG                     # prefer match on ties
            elif h == E[i, j]:
                bp_h[i, j] = _FROM_E
            else:
                bp_h[i, j] = _FROM_F

    i, j = np.unravel_index(int(np.argmax(H)), H.shape)
    score = int(H[i, j])
    q_end, d_end = int(i), int(j)

    qa, da = [], []
    state = "H"
    while i > 0 and j > 0:
        if state == "H":
            b = bp_h[i, j]
            if b == _STOP:
                break
            if b == _DIAG:
                qa.append(int(q[i - 1]))
                da.append(int(d[j - 1]))
                i -= 1
                j -= 1
            elif b == _FROM_E:
                state = "E"
            else:
                state = "F"
        elif state == "E":                             # gap in query: consume d
            qa.append(-1)
            da.append(int(d[j - 1]))
            ext = bp_e[i, j]
            j -= 1
            state = "E" if ext else "H"
        else:                                          # gap in db: consume q
            qa.append(int(q[i - 1]))
            da.append(-1)
            ext = bp_f[i, j]
            i -= 1
            state = "F" if ext else "H"

    qa.reverse()
    da.reverse()
    q_start, d_start = int(i), int(j)

    q_str = "".join("-" if c < 0 else ALPHABET[c] for c in qa)
    d_str = "".join("-" if c < 0 else ALPHABET[c] for c in da)
    mid = []
    n_id = n_pos = n_gap = 0
    check = 0
    prev_gap = None          # 'E' / 'F': adjacent opposite-direction gaps
    # are two separate gaps and each pays its own open charge
    for cq, cd in zip(qa, da):
        if cq < 0 or cd < 0:
            g = "E" if cq < 0 else "F"
            mid.append(" ")
            n_gap += 1
            check -= ge if prev_gap == g else goe
            prev_gap = g
        else:
            prev_gap = None
            s = int(sub[cq, cd])
            check += s
            if cq == cd:
                mid.append("|")
                n_id += 1
                n_pos += 1
            elif s > 0:
                mid.append("+")
                n_pos += 1
            else:
                mid.append(" ")
    if check != score:
        raise AssertionError(f"traceback self-check failed: path scores "
                             f"{check}, DP says {score}")

    return Alignment(score, q_start, q_end, d_start, d_end,
                     q_str, d_str, "".join(mid), n_id, n_pos, n_gap)
