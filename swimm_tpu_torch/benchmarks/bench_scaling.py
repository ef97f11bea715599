"""Sharded whole-DB search against mesh size, the counterpart of the JAX
package's benchmarks/bench_scaling.py.

Sweeps meshes of 1, 2, 4 and 8 data shards (up to ``max_devices``)
through parallel.mesh.make_mesh with an explicit device list: the CPU
repeated on the CPU, the card repeated on one card (virtual shards,
scored one after another), and distinct cards where there are several
(device i % cards). On the reference's workload (4 queries of 80, 144,
200 and 300 aa, synth_queries seed 1; synth_db(4000, seed 2,
homolog_frac 0.01) packed at V=8; f32, top 16) each mesh runs
parallel.sharded_search (per-shard top-k, then the merge) once to warm
and once timed, and prints: real tiles per device (max/min, from
plan_tile_shards' cuts, as the reference counts them), the merge's bytes
(shards x TOPK_PER_SHARD x 8 x queries), the steady ms on the host clock,
and whether the hits equal the one-shard hits (which it asserts).

What the rows measure is the division of work and the merge's cost. The
shards of one card run one after another, so the time is not a speed-up,
and the last line says so; a speed-up needs several cards.

Run: python -m swimm_tpu_torch.benchmarks.bench_scaling [max_devices]
[--device cpu]. Without --device cpu it runs on the card(s) and raises
when there is none.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

import torch

from swimm_tpu_torch.benchmarks import where
from swimm_tpu_torch.db import build_db
from swimm_tpu_torch.models.engine import SearchConfig, resolve_device
from swimm_tpu_torch.parallel.mesh import make_mesh
from swimm_tpu_torch.parallel.sharded_search import (TOPK_PER_SHARD,
                                                     plan_tile_shards,
                                                     sharded_search)
from swimm_tpu_torch.utils.synth import synth_db, synth_queries

MESHES = (1, 2, 4, 8)


def mesh_devices(device: torch.device, n: int) -> list:
    """n devices for a mesh: the CPU n times, or the cards in turn (one
    card n times on a machine with one)."""
    if device.type != "cuda":
        return [device] * n
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n)]


def shard_tile_counts(packed, n_data: int) -> list:
    """Real tiles of each of n_data shards, by plan_tile_shards' cuts."""
    plan, _ = plan_tile_shards(packed, n_data)
    cum, bounds = plan["cum"], plan["bounds"]
    return [int(cum[bounds[d + 1]] - cum[bounds[d]]) for d in range(n_data)]


def run(device=None, max_devices: int = 8, n_seqs: int = 4000,
        qlens=(80, 144, 200, 300), V: int = 8, packed=None, queries=None):
    """The mesh-size sweep; ``packed`` and ``queries`` replace the
    synthetic DB and queries. Prints the reference's table. Returns a row
    a mesh: {"mesh", "devices", "tiles", "merge_bytes", "steady_ms",
    "exact", "results"}."""
    dev = resolve_device(device)
    if queries is None:
        queries = synth_queries(len(qlens), list(qlens), seed=1)
    cfg = SearchConfig(precision="f32", top_k=16)
    rows, base = [], None
    with tempfile.TemporaryDirectory() as td:
        if packed is None:
            recs = synth_db(n_seqs, seed=2, queries=[q.codes for q in queries],
                            homolog_frac=0.01)
            packed = build_db(recs, td, V=V)
        print(f"on {where(dev)}: {packed.n_seqs} seqs, {len(queries)} queries")
        print(f"{'mesh':>6} {'tiles/dev (max/min)':>20} {'merge bytes':>12} "
              f"{'steady ms':>10} {'exact':>6}")
        for nd in [d for d in MESHES if d <= max_devices]:
            devices = mesh_devices(dev, nd)
            mesh = make_mesh(nd, devices=devices)
            counts = shard_tile_counts(packed, nd)
            merge_bytes = nd * TOPK_PER_SHARD * 8 * len(queries)
            sharded_search(packed, queries, cfg, mesh=mesh)     # warm
            t0 = time.perf_counter()
            results, _ = sharded_search(packed, queries, cfg, mesh=mesh)
            ms = (time.perf_counter() - t0) * 1e3
            hits = [[(h.score, h.sorted_idx) for h in r.hits]
                    for r in results]
            if base is None:
                base = hits
            print(f"{nd:>6} {max(counts):>10}/{min(counts):<9} "
                  f"{merge_bytes:>12} {ms:>10.0f} "
                  f"{'yes' if hits == base else 'NO':>6}", flush=True)
            if hits != base:
                raise AssertionError(f"sharded hits over {nd} shards differ "
                                     "from the one-shard hits")
            rows.append({"mesh": nd, "devices": [str(d) for d in devices],
                         "tiles": counts, "merge_bytes": merge_bytes,
                         "steady_ms": ms, "exact": True,
                         "results": results})
    shared = len(set(rows[-1]["devices"])) < rows[-1]["mesh"]
    print(("shards sharing a device run one after another: these rows "
           "measure the division of work and the merge, not a speed-up"
           if shared else "one shard a device")
          + "; per-card throughput: python -m swimm_tpu_torch.bench, "
          "python -m swimm_tpu_torch.benchmarks.bench_serving", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m swimm_tpu_torch.benchmarks.bench_scaling",
        description="Sharded search over meshes of 1-8 shards: work "
                    "division, merge bytes, steady ms, exactness.")
    ap.add_argument("max_devices", nargs="?", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain scorers)")
    args = ap.parse_args(argv)
    run(args.device, args.max_devices)
    return 0


if __name__ == "__main__":
    sys.exit(main())
