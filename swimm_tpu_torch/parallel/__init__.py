"""swimm_tpu_torch.parallel — device mesh, sharded search, collective top-k
(counterpart of swimm_tpu/parallel).

The database is split into contiguous block ranges over the 'data' axis of
a (data, query) device grid, query profiles are replicated (or split over
'query'), each shard takes its own top-k, and only those candidates cross
between devices: copies between the devices of one process, or
torch.distributed collectives (NCCL on cards, gloo on the CPU) between
processes (parallel/distributed.py).
"""
