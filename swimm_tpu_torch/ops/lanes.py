"""How one query profile is scored against a tile stream, for every search
path: resident (models/engine.py), streamed (models/stream.py), sharded and
sharded streamed (parallel/).

A ``Profile`` is built once per query: the (32, m_pad) int32 profile on the
host, its ``scorer.profile_bounds`` taken there, then one upload. ``score``
scores it against a stream (tiles, outrow, n_rows, row_start): kernel 1
(``scorer.score_tiles``, one launch) up to max_query_pad() padded rows,
else kernel 2 (``longquery.score_tiles_long``, one launch per LONG_TILE_M
query rows, the last cut to the rows left), each with the profile's
bounds, so that its 16-bit guard (``scorer._pair_guard``) never waits for
the device. The profile names the CUDA kernel (``kernel``, the
``engine.launch`` span's attr) and the query rows it dispatches (``rows``,
what SearchMetrics.padded_cells counts).

``Splits`` holds kernel 1's split plans of one stream (``scorer.split_plan``:
which DB blocks several CUDA blocks walk), one per padded length, built on
the host from the blocks' lengths; ``score`` takes the one for its profile.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import torch

from swimm_tpu_torch.models.profile import build_query_profile
from swimm_tpu_torch.ops import longquery, scorer


def select_mode(m_pad: int) -> str:
    """Kernel mode for one padded length: 'tiles' (kernel 1, one pass over
    the query) up to max_query_pad() rows, else 'tiles_long' (kernel 2,
    query tiles). The JAX package's names for the two."""
    return "tiles" if m_pad <= scorer.max_query_pad() else "tiles_long"


def _wrapper(mode: str):
    return scorer.score_tiles if mode == "tiles" else longquery.score_tiles_long


@dataclass(frozen=True)
class Profile:
    """One query's profile, as every search path scores it."""
    qp: torch.Tensor   # (32, m_pad) int32, on the device that scores it
    bounds: tuple      # scorer.profile_bounds(qp), taken on the host
    length: int        # the query's residues (engine.launch's cells)

    @classmethod
    def build(cls, query, config, device=None) -> "Profile":
        """A query's profile under config (matrix, m_multiple): built on the
        host, its bounds taken there, then one upload to device (none if
        None)."""
        qp = torch.from_numpy(build_query_profile(
            query.codes, config.matrix, config.m_multiple))
        bounds = scorer.profile_bounds(qp)
        return cls(qp if device is None else qp.to(device), bounds,
                   query.length)

    @cached_property
    def mode(self) -> str:
        return select_mode(self.qp.shape[1])

    @cached_property
    def kernel(self) -> str:
        """The CUDA kernel it launches: sw_ragged_kernel or
        sw_ragged_qtile_kernel."""
        return _wrapper(self.mode).kernel

    @property
    def rows(self) -> int:
        """The query rows its kernel dispatches: m_pad in both modes, since
        kernel 2 cuts its last query tile to the rows left
        (longquery.query_tiles; the JAX package's dispatched_rows counts
        whole LONG_TILE_M tiles, which it walks)."""
        return self.qp.shape[1]


class Splits(dict):
    """Kernel 1's split plans of one tile stream, by padded profile length:
    a scorer.Split, or None where the launch splits nothing (every length
    on the CPU). Each length is planned and uploaded the first time it is
    asked for, without a wait for the device. lens: the stream's DB blocks'
    positions on the host (a resident stream's are kept with it; a streamed
    window's are made for each window)."""

    def __init__(self, lens, V: int, device):
        super().__init__()
        self.lens, self.V, self.device = lens, V, torch.device(device)

    def __missing__(self, m: int):
        self[m] = split = scorer.upload_split(scorer.split_plan(
            self.lens, m, self.V, scorer.split_slots(self.device, self.V)),
            self.device)
        return split


def score(stream, prof: Profile, gap_open: int, gap_extend: int,
          splits: Splits | None = None) -> torch.Tensor:
    """(n_rows * V,) int32 scores of every lane of stream = (tiles, outrow,
    n_rows, row_start), on its device, for one profile on that device;
    kernel 1 on the split walk where splits (the stream's) splits a block
    at the profile's length."""
    tiles, outrow, n_rows, row_start = stream
    kw = ({"split": splits[prof.rows]}
          if splits is not None and prof.mode == "tiles" else {})
    return _wrapper(prof.mode)(tiles, outrow, n_rows, prof.qp, gap_open,
                               gap_extend, row_start=row_start,
                               bounds=prof.bounds, **kw).reshape(-1)
