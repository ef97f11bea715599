"""Query packing: many queries per kernel launch along the query axis
(counterpart of swimm_tpu/models/qpack.py; the packs are equal to that
module's array for array).

Packing concatenates a batch of query profiles into ONE (32, M) profile
with fixed bucket sizes M, so a batch rides one launch of
``sw_ragged_packed_kernel`` per pack (ops/scorer.score_tiles_packed)
instead of one launch per query.

Segment isolation is exact (tests/test_torch_qpack.py):

- every query is padded to a multiple of 8 rows (one segment group) and
  followed by one full 8-row SEPARATOR group whose profile column is
  SEP_SCORE for every residue code — far below any attainable DP value, so
  H on separator rows is identically 0 and the next query's row 0 sees the
  correct zero diagonal/vertical boundary;
- the F (query-direction gap) recurrence is segmented inside the kernel:
  F restarts at the first row of every group whose segment id differs from
  the group above. Segment ids are NONDECREASING along the pack, and
  separator groups must not share their neighbors' segments, so query s
  takes id 2s and its separator group 2s+1; the unused tail takes
  N_SEG_CAP - 1;
- per-query scores are the maxima over the groups of each even id.

SEP rows score 0 and pad rows are dominated, so a packed run returns the
same scores as one run per query.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from swimm_tpu_torch.alphabet import PAD_CODE, TABLE_CODES
from swimm_tpu_torch.matrices import kernel_table

SUB = 8                      # rows per segment group
N_SEG_CAP = 48               # segment ids per pack: at most 24 queries
                             # (even ids) and as many score planes
SEP_SCORE = -(1 << 17)       # separator profile value. Only the MAGNITUDE
# matters: it must dominate any |DP value| (< ~1.2e5), and diag + SEP_SCORE
# cannot wrap in int32. The kernels read the profile as it is.
PACK_BUCKETS = tuple(range(64, 1025, 64))    # fixed pack lengths, the
# JAX package's (multiples of 64 up to 1024), so packs and padded-cell
# counts are equal in both packages


@dataclass
class PackEntry:
    query_pos: int           # index into the caller's query list
    seg: int                 # segment id inside the pack
    row_start: int           # first profile row of this query
    n_rows: int              # 8-aligned true rows (excl. separator group)
    length: int              # true query length


@dataclass
class QueryPack:
    qp: np.ndarray           # (32, M) int32 packed profile
    seg_of_group: np.ndarray  # (M/8,) int32 segment id per sublane group
    entries: list = field(default_factory=list)
    n_seg: int = 0           # real segments (queries) in this pack

    @property
    def M(self) -> int:
        return self.qp.shape[1]


def _rows_needed(length: int) -> int:
    """8-aligned query rows + one full separator group."""
    return -(-max(length, 1) // SUB) * SUB + SUB


def build_query_packs(queries, matrix="BLOSUM62",
                      buckets=PACK_BUCKETS) -> list:
    """Pack query code arrays (list of (codes, caller_pos) or FastaRecord
    order) into QueryPacks: balanced LPT assignment (longest-first into
    the least-filled of ceil(total/cap) bins) rounded up to fixed bucket
    sizes.

    Queries longer than buckets[-1] - SUB must go through the long-query
    path instead; passing one raises ValueError.
    """
    if not len(queries):
        return []        # no empty all-separator pack
    table = kernel_table(matrix)                     # (32, 32) int32
    cap = buckets[-1]
    items = []
    for pos, q in enumerate(queries):
        codes = np.asarray(q.codes if hasattr(q, "codes") else q)
        need = _rows_needed(len(codes))
        if need > cap:
            raise ValueError(
                f"query {pos} needs {need} rows > pack cap {cap}; "
                "use the long-query path")
        items.append((pos, codes, need))

    # Balanced packing: fix the bin count at the
    # minimum k = ceil(total/cap) and assign longest-first to the
    # least-filled bin (LPT). Equalized fills mean each bin's bucket
    # roundup is small, vs first-fit-decreasing whose LAST bin is nearly
    # empty and still pays a whole bucket. Falls back to k+1 bins when the
    # query-count cap or an unlucky LPT split overflows a bin.
    items.sort(key=lambda t: -t[2])
    max_q = N_SEG_CAP // 2      # ids 2s, 2s+1 must stay < N_SEG_CAP
    total = sum(t[2] for t in items)
    k = max(1, -(-total // cap), -(-len(items) // max_q))
    while True:
        bins = [[] for _ in range(k)]
        fill = [0] * k
        ok = True
        for pos, codes, need in items:
            cands = [i for i in range(k)
                     if fill[i] + need <= cap and len(bins[i]) < max_q]
            if not cands:
                ok = False
                break
            i = min(cands, key=lambda i: fill[i])
            bins[i].append((pos, codes, need))
            fill[i] += need
        if ok:
            break
        k += 1

    packs = []
    for group, used in zip(bins, fill):
        M = next(b for b in buckets if b >= used)
        qp = np.full((TABLE_CODES, M), SEP_SCORE, dtype=np.int32)
        # tail groups: one id above every used id (keeps ids nondecreasing)
        seg = np.full(M // SUB, N_SEG_CAP - 1, dtype=np.int32)
        pack = QueryPack(qp, seg)
        row = 0
        for s, (pos, codes, need) in enumerate(group):
            n_rows = need - SUB
            q_padded = np.full(n_rows, PAD_CODE, dtype=np.int64)
            q_padded[:len(codes)] = codes
            qp[:, row:row + n_rows] = table[:, q_padded]
            seg[row // SUB:(row + n_rows) // SUB] = 2 * s
            seg[(row + n_rows) // SUB] = 2 * s + 1       # separator group
            pack.entries.append(PackEntry(pos, 2 * s, row, n_rows,
                                          len(codes)))
            row += need
        pack.n_seg = 2 * len(group)
        packs.append(pack)
    return packs
