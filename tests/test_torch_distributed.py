"""swimm_tpu_torch.parallel.distributed against swimm_tpu.parallel.
distributed on the CPU: the block-range index math over mesh shapes and
uneven block counts (the reference suite's parametrisations, as cases of
the same tests), process_data_rows, make_global_chunk's round trip with
its PAD tail, and a one-rank gloo job in this process (global_mesh, the
collectives of sharded_search and search_streaming_sharded). The
two-process job is tests/test_torch_multiproc.py. Tolerance 0: all
integers."""

import socket

import numpy as np
import pytest
import torch

from swimm_tpu.parallel import distributed as jdist
from swimm_tpu_torch import SearchConfig, build_db, search
from swimm_tpu_torch.alphabet import PAD_CODE
from swimm_tpu_torch.parallel import distributed
from swimm_tpu_torch.parallel.mesh import make_mesh
from swimm_tpu_torch.parallel.sharded_search import sharded_search
from swimm_tpu_torch.parallel.sharded_stream import search_streaming_sharded
from swimm_tpu_torch.utils.synth import synth_db, synth_queries
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("n_data", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("n_blocks", [1, 2, 5, 7, 8, 16, 17, 33])
def test_block_range_partition(n_data, n_blocks):
    bp = -(-n_blocks // n_data) * n_data
    per_dev = bp // n_data
    covered = []
    for r in range(n_data):
        lo, hi = distributed.block_range_for_rows(n_blocks, n_data, [r])
        assert (lo, hi) == jdist.block_range_for_rows(n_blocks, n_data, [r])
        assert hi - lo == per_dev
        covered.extend(range(lo, hi))
    assert covered == list(range(bp))
    assert set(range(n_blocks)) <= set(covered)


@pytest.mark.parametrize("n_data,rows", [
    (4, [0, 1]), (4, [2, 3]), (8, [0, 1, 2, 3]), (8, [4, 5, 6, 7]),
    (8, [3]), (3, [0, 1, 2]),
])
@pytest.mark.parametrize("n_blocks", [5, 8, 17])
def test_block_range_multirow(n_data, rows, n_blocks):
    lo, hi = distributed.block_range_for_rows(n_blocks, n_data, rows)
    assert (lo, hi) == jdist.block_range_for_rows(n_blocks, n_data, rows)
    per_dev = (-(-n_blocks // n_data) * n_data) // n_data
    assert lo == rows[0] * per_dev
    assert hi == (rows[-1] + 1) * per_dev
    others = [r for r in range(n_data) if r not in rows]
    if others and others == list(range(others[0], others[-1] + 1)):
        lo2, hi2 = distributed.block_range_for_rows(n_blocks, n_data, others)
        assert sorted(set(range(lo, hi)) | set(range(lo2, hi2))) == \
            list(range(-(-n_blocks // n_data) * n_data))


def test_block_range_empty_and_noncontiguous():
    assert distributed.block_range_for_rows(10, 4, []) == (0, 0)
    with pytest.raises(ValueError) as port:
        distributed.block_range_for_rows(10, 4, [0, 2])
    with pytest.raises(ValueError) as ref:
        jdist.block_range_for_rows(10, 4, [0, 2])
    assert str(port.value) == str(ref.value)


def test_process_data_rows_single_process():
    mesh = make_mesh(8, query_axis=2, devices=["cpu"] * 8)
    assert distributed.process_data_rows(mesh) == [0, 1, 2, 3]
    assert distributed.process_data_rows(mesh, process_index=0) == \
        [0, 1, 2, 3]
    assert distributed.process_data_rows(mesh, process_index=99) == []
    assert distributed.host_block_range(10, mesh) == (0, 12)


@pytest.mark.parametrize("query_axis", [1, 2])
@pytest.mark.parametrize("n_blocks", [3, 8, 11])
def test_make_global_chunk_roundtrip(query_axis, n_blocks):
    mesh = make_mesh(8, query_axis=query_axis, devices=["cpu"] * 8)
    n_data = int(mesh.shape["data"])
    L, V = 12, 4
    rng = np.random.default_rng(0)
    blocks = rng.integers(0, 24, size=(n_blocks, L, V)).astype(np.int8)
    arr = distributed.make_global_chunk(blocks, n_blocks, mesh)
    bp = -(-n_blocks // n_data) * n_data
    expect = np.full((bp, L, V), PAD_CODE, np.int8)
    expect[:n_blocks] = blocks
    assert arr.device.type == "cpu"
    np.testing.assert_array_equal(arr.numpy(), expect)


def test_make_global_chunk_rejects_short_local():
    mesh = make_mesh(4, query_axis=1, devices=["cpu"] * 4)
    blocks = np.zeros((2, 8, 4), np.int8)
    with pytest.raises(ValueError, match="needs at least 5 real blocks"):
        distributed.make_global_chunk(blocks, 5, mesh)


def test_init_without_card_raises(monkeypatch):
    """The backend follows the device; no card and no device='cpu' raises
    before any process group is made (no gloo in NCCL's place)."""
    import torch.distributed as dist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed.init("127.0.0.1:1", 1, 0)
    assert not dist.is_initialized()


def test_one_rank_gloo_job(tmp_path):
    """One rank: global_mesh, its own shard, and the sharded searches
    through their real collectives (all_gather_into_tensor, all_reduce)
    equal the resident search; the group is destroyed after."""
    import torch.distributed as dist
    queries = synth_queries(3, [30, 50, 70], seed=9)
    recs = synth_db(90, seed=10, median_len=60, max_len=150,
                    queries=[q.codes for q in queries], homolog_frac=0.05)
    packed = build_db(recs, tmp_path / "db", V=8)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    distributed.init(f"127.0.0.1:{port}", 1, 0, device="cpu")
    try:
        mesh = distributed.global_mesh()
        assert mesh.distributed and mesh.shape == {"data": 1, "query": 1}
        assert distributed.process_data_rows(mesh) == [0]
        shards = distributed.global_tile_shards(packed, mesh)
        assert list(shards["shards"]) == [(0, 0)]
        for cfg, kw in ((SearchConfig(top_k=5), dict(measure_merge=True)),
                        (SearchConfig(top_k=5, evalue=True), {})):
            ref = search(packed, queries, cfg, device="cpu")[0]
            got, met = sharded_search(packed, queries, cfg, mesh=mesh,
                                      tile_shards=shards, **kw)
            assert [r.hits for r in got] == [r.hits for r in ref]
            got, _ = search_streaming_sharded(
                packed, queries, SearchConfig(top_k=5, db_stream=True,
                                              window_tiles=16,
                                              evalue=cfg.evalue), mesh=mesh)
            assert [r.hits for r in got] == [r.hits for r in ref]
        with pytest.raises(ValueError, match="not divisible by 2"):
            distributed.global_mesh(2)
    finally:
        dist.destroy_process_group()
