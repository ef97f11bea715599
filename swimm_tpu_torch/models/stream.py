"""Kernel-mode selection shared by the search paths (counterpart of
``select_mode`` and ``dispatched_rows`` in swimm_tpu/models/stream.py).

The streaming paths of the JAX module are not ported yet; only the mode
decision and the padded-row accounting live here, so padded-cell metrics
match the JAX package's.
"""

from __future__ import annotations

from swimm_tpu_torch.ops.longquery import LONG_TILE_M
from swimm_tpu_torch.ops.scorer import max_query_pad


def select_mode(m_pad: int) -> str:
    """Kernel mode for one padded-length group: 'tiles' (one pass over the
    query) up to max_query_pad() rows, else 'tiles_long' (query tiles)."""
    return "tiles" if m_pad <= max_query_pad() else "tiles_long"


def dispatched_rows(mode: str, m_pad: int) -> int:
    """Query rows the kernel actually dispatches for this mode — the
    long-query path rounds m up to a LONG_TILE_M multiple; honest
    padded-cell accounting counts what ran, not what was asked."""
    if mode == "tiles_long":
        return -(-m_pad // LONG_TILE_M) * LONG_TILE_M
    return m_pad
