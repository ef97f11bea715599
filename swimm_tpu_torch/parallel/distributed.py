"""Multi-process execution over torch.distributed (counterpart of
swimm_tpu/parallel/distributed.py).

Every process (rank) joins one process group: NCCL when it drives a card,
gloo on the CPU, never one in place of the other. global_mesh lays the
ranks over a (data, query) grid, one device per rank, with the process
groups of each rank's column (the 'data' group: the ranks holding the
other shards for its queries) and row (the 'query' group). The search
itself is unchanged — sharded_search and search_streaming_sharded take
this mesh as they take a mesh of one process's devices; the mesh says
whether the gather is a copy or a collective:

- the candidates: all_gather_into_tensor over the data group;
- the E-value histograms: all_reduce(SUM) of the int64 counts over the
  data group;
- the results: all_gather_into_tensor over the query group, so every rank
  returns every query's hits.

Each rank builds only its own shard (global_tile_shards) from the
memmapped chunk files. NCCL refuses two ranks on one card, so a job has a
card per rank.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from swimm_tpu_torch.parallel.mesh import Mesh


def init(coordinator_address: str | None = None,
         num_processes: int | None = None,
         process_id: int | None = None, device=None) -> None:
    """Join the job (a no-op if this process has joined already).

    coordinator_address: 'host:port' (or 'tcp://host:port') of rank 0's
    rendezvous; None reads MASTER_ADDR / MASTER_PORT, WORLD_SIZE and RANK
    from the environment, as do num_processes / process_id when None.
    device: 'cuda' (default) or 'cpu': the backend follows it, NCCL for a
    card, gloo for the CPU. On a card the rank's device is made current
    first: cuda:LOCAL_RANK (or the rank) modulo the visible cards, or the
    index the device names."""
    import torch.distributed as dist

    from swimm_tpu_torch.models.engine import resolve_device
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    kw = {}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    if dev.type == "cuda":
        rank = process_id if process_id is not None else int(
            os.environ.get("RANK", 0))
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(dev.index if dev.index is not None
                              else local % torch.cuda.device_count())
    method = "env://"
    if coordinator_address is not None:
        method = (coordinator_address if "://" in coordinator_address
                  else f"tcp://{coordinator_address}")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=method, **kw)


def _rank_device() -> torch.device:
    import torch.distributed as dist
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_mesh(query_axis: int = 1) -> Mesh:
    """(data, query) mesh over the job's ranks, one device each: rank r at
    cell divmod(r, query_axis). Every rank must call it, in the same order
    as its other collectives (it creates the process groups)."""
    import torch.distributed as dist
    n, rank = dist.get_world_size(), dist.get_rank()
    if query_axis < 1 or n % query_axis:
        raise ValueError(f"{n} global devices not divisible by {query_axis}")
    names = [None] * n
    dist.all_gather_object(names, str(_rank_device()))
    ranks = np.arange(n).reshape(n // query_axis, query_axis)
    d, q = divmod(rank, query_axis)
    data_group = query_group = None
    for col in range(query_axis):      # every rank creates every group
        g = dist.new_group([int(r) for r in ranks[:, col]])
        data_group = g if col == q else data_group
    for row in range(ranks.shape[0]):
        g = dist.new_group([int(r) for r in ranks[row]])
        query_group = g if row == d else query_group
    return Mesh(np.array(names, dtype=object).reshape(ranks.shape),
                ranks=ranks, rank=rank, data_group=data_group,
                query_group=query_group)


def process_data_rows(mesh: Mesh, process_index: int | None = None) -> list:
    """Sorted 'data'-axis rows that hold >= 1 cell of this process (or of
    process_index): the shards whose DB slice it must materialise."""
    if process_index is None:
        process_index = mesh.rank
    return sorted({int(d) for d, _ in np.argwhere(
        mesh.ranks == process_index)})


def block_range_for_rows(n_blocks: int, n_data: int,
                         rows: list) -> tuple[int, int]:
    """Pure index math behind host_block_range: [start, stop) padded-block
    range covered by the given contiguous 'data'-axis rows, for a chunk
    whose block axis (padded to a multiple of n_data) is sharded evenly.

    Raises if the rows are non-contiguous — a strided host-to-row layout
    would silently drop blocks under a contiguous-range contract, so fail
    loudly instead (assemble per-row in that case)."""
    bp = -(-n_blocks // n_data) * n_data     # padded block count
    per_dev = bp // n_data
    if not rows:
        return 0, 0
    if list(rows) != list(range(rows[0], rows[-1] + 1)):
        raise ValueError(
            f"process rows {rows} are not contiguous on the 'data' axis; "
            "host_block_range requires a contiguous block range")
    return rows[0] * per_dev, (rows[-1] + 1) * per_dev


def host_block_range(n_blocks: int, mesh: Mesh) -> tuple[int, int]:
    """[start, stop) padded-block range this process's cells own for a
    chunk whose block axis is sharded over 'data'."""
    return block_range_for_rows(n_blocks, int(mesh.shape["data"]),
                                process_data_rows(mesh))


def global_tile_shards(packed, mesh: Mesh):
    """Each rank's own data shard of the whole-DB tile stream, on its
    device: sharded_search.build_tile_shards builds only a mesh's local
    cells, so a rank reads only its block range from the memmapped chunk
    files (no data crosses between ranks). Pass to sharded_search as
    tile_shards."""
    from swimm_tpu_torch.parallel.sharded_search import build_tile_shards
    return build_tile_shards(packed, mesh)


def make_global_chunk(local_blocks: np.ndarray, n_blocks_global: int,
                      mesh: Mesh) -> torch.Tensor:
    """This process's part of a (Bp, L, V) chunk whose block axis, padded
    to a multiple of n_data, is sharded evenly over 'data': its padded
    block range [lo, hi) (host_block_range), as a tensor on its first
    cell's device.

    local_blocks covers [lo, hi) — at least the real blocks in that
    range; the padded tail (ragged final shard) is PAD-filled here."""
    from swimm_tpu_torch.alphabet import PAD_CODE
    lo, hi = host_block_range(n_blocks_global, mesh)
    n_local_real = max(min(hi, n_blocks_global) - lo, 0)
    if local_blocks.shape[0] < n_local_real:
        raise ValueError(
            f"local_blocks has {local_blocks.shape[0]} blocks; this host's "
            f"range [{lo}, {hi}) needs at least {n_local_real} real blocks")
    out = np.full((hi - lo,) + local_blocks.shape[1:], PAD_CODE,
                  local_blocks.dtype)
    out[:n_local_real] = local_blocks[:n_local_real]
    return torch.from_numpy(out).to(mesh.devices[mesh.local_cells()[0]])
