"""Device mesh (counterpart of swimm_tpu/parallel/mesh.py).

The search has one big parallel axis, the database ('data': contiguous
block ranges, one per grid row), and an optional query axis ('query':
the batch split over the grid's columns). A Mesh is a (data, query) grid
of torch devices. In one process every cell is driven by that process;
distributed.global_mesh lays the ranks of a torch.distributed job over
the grid instead, one device per rank, and carries the process groups of
the rank's column and row.
"""

from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """Devices laid out as a (data, query) grid.

      devices      (n_data, n_query) object array of torch.device
      shape        {"data": n_data, "query": n_query}, as JAX's Mesh
      ranks        (n_data, n_query) int array: the process that drives
                   each cell (all 0 for one process's devices)
      rank         this process's rank (0 for one process)
      data_group   torch.distributed group of this rank's column (the ranks
                   holding the other shards for its queries), None in one
                   process; query_group likewise for its row
    """

    def __init__(self, devices, ranks=None, rank: int = 0,
                 data_group=None, query_group=None):
        grid = np.empty(np.shape(devices)[:2], dtype=object)
        for (d, q), dev in np.ndenumerate(np.asarray(devices, dtype=object)):
            grid[d, q] = torch.device(dev)
        self.devices = grid
        self.shape = {"data": grid.shape[0], "query": grid.shape[1]}
        self.ranks = (np.zeros(grid.shape, dtype=np.int64) if ranks is None
                      else np.asarray(ranks, dtype=np.int64))
        self.rank = rank
        self.data_group = data_group
        self.query_group = query_group

    @property
    def distributed(self) -> bool:
        """Whether the cells are the ranks of a process group."""
        return self.data_group is not None

    def local_cells(self) -> list:
        """(d, q) of every cell this process drives, row by row."""
        return [(int(d), int(q)) for d, q in np.argwhere(
            self.ranks == self.rank)]

    def _key(self):
        return (tuple(str(d) for d in self.devices.flat), self.devices.shape,
                tuple(self.local_cells()))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())


def make_mesh(n_devices: int | None = None, query_axis: int = 1,
              devices=None) -> Mesh:
    """Build a (data, query) mesh over the visible CUDA devices (or the
    first n_devices of them), or over an explicit `devices` list, which may
    repeat one device (['cpu'] * 8; four shards on one card). Raises when
    no card is visible and no list is given: never a silent CPU mesh.

    query_axis=1 gives a pure data-parallel mesh; query_axis > 1 carves
    the devices into an (n / query_axis, query_axis) grid.
    """
    from swimm_tpu_torch.models.engine import resolve_device
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh takes the visible CUDA devices and none is "
                "available; pass devices=['cpu'] (CLI: --device cpu) to "
                "shard over the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [resolve_device(d) for d in devices]
        devices = [torch.device("cuda", torch.cuda.current_device())
                   if d.type == "cuda" and d.index is None else d
                   for d in devices]
        if not devices:
            raise ValueError("devices must name at least one device")
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} "
                "available")
        devices = devices[:n_devices]
    n = len(devices)
    if query_axis < 1:
        raise ValueError(f"query_axis must be >= 1 (got {query_axis})")
    if n % query_axis:
        raise ValueError(f"{n} devices not divisible by query_axis={query_axis}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(n // query_axis, query_axis))


def balanced_2d(n: int) -> tuple[int, int]:
    """Factor n into (data, query) axes, data >= query, as square as possible."""
    q = int(np.floor(np.sqrt(n)))
    while n % q:
        q -= 1
    return n // q, q
