"""The yardstick's arithmetic, frozen: GCUPS and percentiles."""

from __future__ import annotations

import math


def cells(query_lengths, db_residues: int) -> int:
    """Real DP cells of a search: each query residue against each database
    residue, padding not counted."""
    return int(sum(int(n) for n in query_lengths)) * int(db_residues)


def gcups(n_cells: int, seconds: float) -> float:
    """Billions of real cells a second."""
    return n_cells / seconds / 1e9


def percentile(values, p: float) -> float:
    """The nearest-rank p-th percentile (0 < p <= 100): the smallest value
    with at least p% of the values at or below it. A missing value (a
    failed or refused request) is given as math.inf and counts against
    every limit."""
    vals = sorted(values)
    if not vals:
        raise ValueError("percentile of no values")
    return vals[max(0, math.ceil(p / 100 * len(vals)) - 1)]
