"""A real two-process torch.distributed job on the CPU (gloo): the port's
counterpart of tests/test_multiproc.py.

The test builds one packed DB, takes swimm_tpu's serial search of it
(backend 'xla') in this process as the reference, and runs this file as
the rank script in two processes. Each rank joins the gloo group, builds
global_mesh and only its own shard (global_tile_shards), then runs the
resident leg (sharded_search, split form: the merge timed on its own),
the streamed leg (search_streaming_sharded) and the E-value leg, through
the real collectives. Every rank's hit lists, E-values and bit scores
must equal the reference's, bit for bit. The rank script imports neither
JAX nor swimm_tpu.

    python tests/test_torch_multiproc.py --rank R --world 2 --port P \\
        --db DB --queries Q.fasta --query-axis 1 --out OUT.json
"""

import argparse
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]


def _hits(results):
    return [[[h.rank, h.score, h.sorted_idx, h.orig_idx, h.title, h.evalue,
              h.bits] for h in r.hits] for r in results]


def rank_main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    for flag in ("--rank", "--world", "--port", "--query-axis"):
        ap.add_argument(flag, type=int, required=True)
    for flag in ("--db", "--queries", "--out"):
        ap.add_argument(flag, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist

    from swimm_tpu_torch import SearchConfig, load_db, read_fasta
    from swimm_tpu_torch.parallel import distributed
    from swimm_tpu_torch.parallel.sharded_search import sharded_search
    from swimm_tpu_torch.parallel.sharded_stream import \
        search_streaming_sharded

    distributed.init(f"127.0.0.1:{args.port}", args.world, args.rank,
                     device="cpu")
    try:
        mesh = distributed.global_mesh(query_axis=args.query_axis)
        packed = load_db(args.db)
        queries = read_fasta(args.queries)
        shards = distributed.global_tile_shards(packed, mesh)
        rows = distributed.process_data_rows(mesh)
        built = sorted(shards["shards"])
        resident, met = sharded_search(packed, queries, SearchConfig(top_k=8),
                                       mesh=mesh, tile_shards=shards,
                                       measure_merge=True)
        streamed, _ = search_streaming_sharded(
            packed, queries, SearchConfig(top_k=8, db_stream=True,
                                          window_tiles=16, max_in_flight=2),
            mesh=mesh)
        evalued, _ = sharded_search(packed, queries,
                                    SearchConfig(top_k=8, evalue=True),
                                    mesh=mesh, tile_shards=shards)
    finally:
        dist.destroy_process_group()
    Path(args.out).write_text(json.dumps({
        "rank": args.rank, "mesh": mesh.shape, "rows": rows,
        "cells": built, "merge": met.timers["merge_collectives"],
        "resident": _hits(resident), "streamed": _hits(streamed),
        "evalue": _hits(evalued),
        "foreign": sorted(m for m in sys.modules
                          if m.split(".")[0] in ("jax", "swimm_tpu"))}))
    return 0


@pytest.mark.parametrize("query_axis", [1, 2])
def test_two_process_gloo_job(tmp_path, query_axis):
    from swimm_tpu.db import build_db as j_build_db
    from swimm_tpu.fasta import FastaRecord as JRecord
    from swimm_tpu.models import engine as jengine
    from swimm_tpu_torch import build_db
    from swimm_tpu_torch.fasta import write_fasta
    from swimm_tpu_torch.utils.synth import synth_db, synth_queries

    queries = synth_queries(4, [40, 72, 100, 56], seed=7)
    recs = synth_db(200, seed=13, median_len=70, sigma=0.4, max_len=260,
                    queries=[q.codes for q in queries], homolog_frac=0.05)
    write_fasta(tmp_path / "q.fasta", queries)
    build_db(recs, tmp_path / "db", V=16)
    pj = j_build_db(recs, tmp_path / "j", V=16, use_native=False)
    jq = [JRecord(q.title, q.codes) for q in queries]
    expect = _hits(jengine.search(pj, jq, jengine.SearchConfig(
        backend="xla", top_k=8))[0])
    expect_e = _hits(jengine.search(pj, jq, jengine.SearchConfig(
        backend="xla", top_k=8, evalue=True))[0])

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), "--world", "2",
         "--port", str(port), "--query-axis", str(query_axis), "--db",
         str(tmp_path / "db"), "--queries", str(tmp_path / "q.fasta"),
         "--out", str(tmp_path / f"rank{r}.json")],
        env=env, cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    for r in range(2):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        n_data = 2 // query_axis
        assert got["mesh"] == {"data": n_data, "query": query_axis}
        assert got["cells"] == [list(divmod(r, query_axis))]
        assert got["rows"] == [r // query_axis]
        assert got["merge"]["count"] == 4          # one per m_pad group
        assert got["resident"] == expect, r
        assert got["streamed"] == expect, r
        assert got["evalue"] == expect_e, r
        assert got["foreign"] == []


if __name__ == "__main__":
    sys.exit(rank_main())
