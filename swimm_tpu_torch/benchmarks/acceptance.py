"""The five BASELINE acceptance configs end to end, each held exactly
against the C oracle (ops/cref.py): the counterpart of the JAX package's
benchmarks/acceptance.py, at its sizes and seeds.

  1  a 144-aa query against 10,000 sequences: search, then every lane of
     score_db(precision='f32') equal to the oracle over the whole DB;
  2  20 queries of 100-500 aa against 100,000 sequences (per query, no
     packing): spot_oracle_check on the first 4;
  3  a 5,478-aa query (the query-tiled path) against 30,000 sequences:
     spot check, and its top score above 127;
  4  parallel.sharded_search on parallel.mesh.make_mesh() (the visible
     cards) over config 1's sequences, equal to the serial f32 search;
  5  the precision ladder over the same, equal to the serial search.

Every size is a keyword argument of its config whose default is the
reference's. The DBs are built in a temporary directory.

Run: python -m swimm_tpu_torch.benchmarks.acceptance [--device cpu]
prints a line a config (its GCUPS beside the card's name and power
limit), the reference's table and one JSON line; exit 1 if any row fails.
It takes ~20 s on an H100, most of it the synthesis and packing of the
DBs and the oracle; at these sizes the CPU's plain scorers would take
hours. Without --device cpu it runs on the card and raises when there is
none.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from dataclasses import asdict, dataclass
from pathlib import Path

import numpy as np

from swimm_tpu_torch.benchmarks import card, same_hits
from swimm_tpu_torch.db import build_db
from swimm_tpu_torch.matrices import get_matrix
from swimm_tpu_torch.models.engine import (SearchConfig, resolve_device,
                                           score_db, search)
from swimm_tpu_torch.ops import cref
from swimm_tpu_torch.parallel.mesh import make_mesh
from swimm_tpu_torch.parallel.sharded_search import sharded_search
from swimm_tpu_torch.utils.synth import synth_db, synth_queries


@dataclass
class Row:
    config: str
    scale: str
    metric: str
    exact: bool
    gcups: float


def _k(n: int) -> str:
    """10000 -> '10k', as the reference's table writes its sizes."""
    return f"{n // 1000}k" if n % 1000 == 0 else str(n)


def spot_oracle_check(packed, recs, queries, results, n_spot=512, seed=0):
    """Exactness where a full-DB oracle pass is too slow: every reported
    hit's score must equal the C oracle on its sequence, and no sequence of
    a random sample may out-score the reported k-th hit (BLOSUM62 10/2)."""
    rng = np.random.default_rng(seed)
    sub = get_matrix("BLOSUM62")
    for q, res in zip(queries, results):
        hit_idx = [h.sorted_idx for h in res.hits]
        seqs = [recs[int(packed.orig_index[i])].codes for i in hit_idx]
        exp = cref.sw_score_many(q.codes, seqs, sub, 10, 2)
        if list(exp) != [h.score for h in res.hits]:
            return False
        sample = rng.integers(0, packed.n_seqs, n_spot)
        sample = np.setdiff1d(sample, np.asarray(hit_idx))
        sseqs = [recs[int(packed.orig_index[i])].codes for i in sample]
        sexp = cref.sw_score_many(q.codes, sseqs, sub, 10, 2)
        kth = res.hits[-1].score
        if len(sexp) and sexp.max() > kth:
            return False
    return True


def _measured(device, fn):
    """fn()'s measured run. On a card fn runs once before it, so that the
    kernels' build and the DB's upload stay out of the measured run; the
    CPU's plain scorers have nothing to warm."""
    if resolve_device(device).type == "cuda":
        fn()
    return fn()


def _search(packed, queries, config, device):
    return _measured(device, lambda: search(packed, queries, config,
                                            device=device))


def config1(work: Path, device, n_seqs: int = 10_000, qlen: int = 144):
    """144 aa against n_seqs sequences; score_db equal to the oracle lane
    for lane. Returns (row, {queries, recs, packed, results, scores})."""
    queries = synth_queries(1, [qlen], seed=21)
    q = queries[0]
    recs = synth_db(n_seqs, seed=22, queries=[q.codes], homolog_frac=0.002)
    packed = build_db(recs, work / "c1", V=128)
    results, met = _search(packed, queries, SearchConfig(top_k=16), device)
    got = score_db(packed, q, SearchConfig(precision="f32"), device=device)
    exp = cref.sw_score_many(
        q.codes, [recs[i].codes for i in packed.orig_index],
        get_matrix("BLOSUM62"), 10, 2)
    row = Row(f"1: {qlen}aa vs {_k(n_seqs)}-seq", f"{_k(n_seqs)} seqs",
              f"{met.gcups:.1f} GCUPS", bool(np.array_equal(got, exp)),
              met.gcups)
    return row, {"queries": queries, "recs": recs, "packed": packed,
                 "results": results, "scores": got}


def config2(work: Path, device, n_seqs: int = 100_000, n_queries: int = 20):
    """n_queries of 100-500 aa against n_seqs sequences, per query; the
    first 4 spot-checked."""
    qlens = list(np.random.default_rng(0).integers(100, 501, size=20))
    queries = synth_queries(n_queries, qlens, seed=1)
    recs = synth_db(n_seqs, seed=2, queries=[x.codes for x in queries],
                    homolog_frac=0.001)
    packed = build_db(recs, work / "c2", V=128)
    results, met = _search(packed, queries, SearchConfig(
        top_k=16, query_pack=False), device)
    ok = spot_oracle_check(packed, recs, queries[:4], results[:4])
    row = Row(f"2: {n_queries} queries vs {_k(n_seqs)}-seq",
              f"{_k(n_seqs)} seqs",
              f"{met.gcups:.1f} GCUPS, "
              f"{met.n_db_seqs * n_queries / met.seconds / 1e6:.2f}M "
              "seq-scores/s", ok, met.gcups)
    return row, {"queries": queries, "recs": recs, "packed": packed,
                 "results": results}


def config3(work: Path, device, n_seqs: int = 30_000, qlen: int = 5478,
            homolog_frac: float = 0.0005):
    """One qlen-aa query (query-tiled past 2,048 rows) against n_seqs
    sequences with planted homologs: spot check, top score above 127."""
    queries = synth_queries(1, [qlen], seed=3)
    recs = synth_db(n_seqs, seed=4, queries=[queries[0].codes],
                    homolog_frac=homolog_frac)
    packed = build_db(recs, work / "c3", V=128)
    results, met = _search(packed, queries, SearchConfig(top_k=16), device)
    ok = spot_oracle_check(packed, recs, queries, results, n_spot=16)
    top = results[0].hits[0]
    row = Row(f"3: {qlen}aa long query", f"{_k(n_seqs)} seqs",
              f"{met.gcups:.1f} GCUPS, top={top.score}",
              ok and top.score > 127, met.gcups)
    return row, {"queries": queries, "recs": recs, "packed": packed,
                 "results": results}


def config4_5(work: Path, device, world: dict):
    """Config 1's sequences and query: sharded_search on make_mesh() (on
    the CPU a one-device mesh) and the ladder, each equal to the serial
    f32 search."""
    dev = resolve_device(device)
    packed = build_db(world["recs"], work / "c4", V=128)
    queries = world["queries"]
    f32 = SearchConfig(top_k=16, precision="f32")
    serial, _ = search(packed, queries, f32, device=dev)
    mesh = make_mesh() if dev.type == "cuda" else make_mesh(devices=[dev])
    shard, met4 = _measured(dev, lambda: sharded_search(
        packed, queries, f32, mesh=mesh))
    row4 = Row("4: sharded + collective top-k",
               f"{mesh.devices.size}-"
               f"{'card' if dev.type == 'cuda' else 'cpu'} mesh",
               f"{met4.gcups:.1f} GCUPS", same_hits(serial, shard),
               met4.gcups)
    ladder, met5 = _search(packed, queries, SearchConfig(
        top_k=16, precision="ladder"), dev)
    row5 = Row("5: precision ladder == exact",
               f"{_k(packed.n_seqs)} seqs",
               f"{met5.gcups:.1f} GCUPS (ladder path)",
               same_hits(serial, ladder), met5.gcups)
    return row4, row5, {"packed": packed, "serial": serial,
                        "sharded": shard, "ladder": ladder}


def run(device=None, c1: dict | None = None, c2: dict | None = None,
        c3: dict | None = None):
    """All five configs on `device` (cuda unless 'cpu'), their DBs in a
    temporary directory; c1-c3 are keyword sizes of config1-config3.
    Prints a line a config with its GCUPS beside the card's name and power
    limit. Returns (rows, {config number: its results; 4 holds 4 and
    5's}, the card's name and power limit or "cpu (no card)")."""
    dev = resolve_device(device)
    where = card() if dev.type == "cuda" else "cpu (no card)"
    rows, out = [], {}
    with tempfile.TemporaryDirectory() as td:
        work = Path(td)
        for n, fn, kw in ((1, config1, c1), (2, config2, c2),
                          (3, config3, c3)):
            row, out[n] = fn(work, dev, **(kw or {}))
            rows.append(row)
        *rows45, out[4] = config4_5(work, dev, out[1])
        rows += rows45
    for row in rows:
        print(f"  -> {row.config}: {row.metric}  exact={row.exact}  "
              f"[{where}]", flush=True)
    return rows, out, where


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m swimm_tpu_torch.benchmarks.acceptance",
        description="The five BASELINE configs end to end against the C "
                    "oracle (exit 0: every row exact).")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    rows, _, where = run(args.device)
    print("\nconfig                              scale            metric"
          "                                   exact")
    for r in rows:
        print(f"{r.config:<35} {r.scale:<16} {r.metric:<40} "
              f"{'PASS' if r.exact else 'FAIL'}")
    ok = all(r.exact for r in rows)
    print(json.dumps({"acceptance": "PASS" if ok else "FAIL",
                      "card": where, "rows": [asdict(r) for r in rows]}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
