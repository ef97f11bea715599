"""Randomized differential fuzz of the five search kernels against the C
oracle: the counterpart of the JAX package's benchmarks/fuzz_tpu.py.

Each round draws a substitution matrix (one of 8), gap penalties (open
0-20, extend 0-8), a query (1-1,199 aa, or 2,049-3,999 with probability
0.25) and 1-3 blocks of V=128 lanes of length L = 32-256 with adversarial
lanes (1 residue, full length, codes 20-23 only, a homolog: the query's
prefix, or random), and on the short path a ceiling (127 or 32,767) with
probability 0.3. ``draw_round`` consumes the generator exactly as
fuzz_tpu.main does, so one seed draws the same rounds in both packages.

``run_round`` scores the round through every route that can take it and
holds each against ops/cref.sw_score_many (the ceiling applied with
np.minimum), with exact equality:

  k4      scorer.score_chunk (sw_chunk_kernel<CEIL>)      qlen <= 2048
  k5      longquery.score_chunk_long (sw_chunk_qtile)     qlen > 2048
  k1      scorer.score_tiles (sw_ragged_kernel)           qlen <= 2048
  k1_split  score_tiles on the split walk, forced          qlen <= 2048
  k2      longquery.score_tiles_long (sw_ragged_qtile)    qlen > 2048
  k2_planted  score_tiles_long on the planted stream      qlen > 2048
  k2_int32    longquery.score_tiles_long_int32 on it      qlen > 2048
  k1_planted  score_tiles on it, the query's first 2,048  qlen > 2048
  k3      scorer.score_tiles_packed (sw_ragged_packed)    every round
  ladder  ladder.score_chunk_adaptive (default tiers)     qlen <= 2048

k4 and k5 are the reference's routes. k1 and k2 take the same blocks cut
as a ragged tile stream, each block trimmed to its longest lane rounded up
to 32 rows, so the blocks of one stream differ in length. No lane of a
draw can score 32,767 (its blocks hold at most 256 residues), so a long
round also scores a planted stream (``planted``, drawn from nothing: the
round's matrix and gaps): a run of the matrix's best-scoring residue as
the query, one block of 64 lanes that hold runs scoring past 32,767, at the
pair form's limit and just below it; k2_planted takes it through
score_tiles_long (kernel 2's pair form, then its int32 pass over the
flagged block), k2_int32 through the int32 form alone, k1_planted through
score_tiles (kernel 1's pair form and its int32 pass) with the query cut
to the 2,048 residues kernel 1 takes, whose lanes pass 32,767 only where a
match scores 17 (PAM250: 2,048 x 15 stays below the limit). k1 takes the
pair form where the round has no ceiling and its int32 form where it has
one. k1_split takes the round's stream through score_tiles with every
block walked by several CUDA blocks (scorer.split_plan forced to 4 parts
for an odd query length, else 2, as far as the query's rounds of strips
allow; on the card's own slots) where the round has no ceiling: the split
walk of kernel 1's pair form (on the CPU, where nothing splits, the plain
walk). k3 takes a pack
of 2-6 new queries of 1-300 aa, drawn from a second generator
default_rng([seed, round]) so that the shared draws stay seed for seed
equal, packed under the round's matrix and scored over that stream under
the round's gaps. The ladder must give the exact scores.

``fuzz_packed`` is the counterpart of ``--packed``: searches of random
query batches against a 3,000-sequence DB per query and packed, hit for
hit, and the C oracle on one top hit a round.

Run: python -m swimm_tpu_torch.benchmarks.fuzz [--rounds 12] [--seed 0]
[--packed] [--device cpu]. One JSON line a round, one of kernels 1 and 2's
launches by lane form and their re-scored blocks, then
{"fuzz": "PASS"|"FAIL", ...}; exit 1 on any mismatch, whose first
differing (route, block, lane, got, exp) goes to stderr. Without --device
cpu it runs on the card, and raises when there is none.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from dataclasses import dataclass

import numpy as np
import torch

from swimm_tpu_torch.alphabet import PAD_CODE
from swimm_tpu_torch.benchmarks import same_hits
from swimm_tpu_torch.db import build_db
from swimm_tpu_torch.matrices import get_matrix
from swimm_tpu_torch.models import qpack
from swimm_tpu_torch.models.engine import SearchConfig, resolve_device, search
from swimm_tpu_torch.models.profile import build_query_profile, round_up
from swimm_tpu_torch.ops import cref, ladder, longquery, scorer
from swimm_tpu_torch.utils.synth import random_codes, synth_db, synth_queries

MATRICES = ["BLOSUM45", "BLOSUM50", "BLOSUM62", "BLOSUM80", "BLOSUM90",
            "PAM30", "PAM70", "PAM250"]
V = 128            # lanes per block, as fuzz_tpu.py
SHORT_MAX = 2048   # longest query on the one-pass routes (max_query_pad)
ROUTES = ("k4", "k5", "k1", "k1_split", "k2", "k2_planted", "k2_int32",
          "k1_planted", "k3", "ladder")
PAIR_MAX = 32767   # the largest value of a 16-bit lane


@dataclass
class Draw:
    """One round's inputs. codes[b, :, lane] holds seqs[b * V + lane]
    followed by PAD_CODE."""
    matrix: str
    gap_open: int
    gap_extend: int
    query: np.ndarray      # uint8 codes
    seqs: list             # n_blocks * V uint8 code arrays, each <= L
    codes: np.ndarray      # (n_blocks, L, V) int8
    ceiling: int | None

    @property
    def qlen(self) -> int:
        return len(self.query)

    @property
    def long(self) -> bool:
        return self.qlen > SHORT_MAX


def lay_out(seqs, n_blocks: int, L: int) -> np.ndarray:
    """(n_blocks, L, V) int8 codes of n_blocks * V sequences of at most L
    residues, lane-major within a block, PAD-filled."""
    codes = np.full((n_blocks, L, V), PAD_CODE, np.int8)
    for k, s in enumerate(seqs):
        b, lane = divmod(k, V)
        codes[b, :len(s), lane] = s
    return codes


def draw_round(rng: np.random.Generator) -> Draw:
    """One round, drawn from rng in fuzz_tpu.main's order."""
    matrix = MATRICES[int(rng.integers(len(MATRICES)))]
    go = int(rng.integers(0, 21))
    ge = int(rng.integers(0, 9))   # ge == 0 (flat gap cost) is legal
    if rng.random() < 0.25:
        qlen = int(rng.integers(2049, 4000))
    else:
        qlen = int(rng.integers(1, 1200))
    query = random_codes(rng, qlen)
    n_blocks = int(rng.integers(1, 4))
    L = int(rng.integers(1, 9)) * 32
    seqs = []
    for _ in range(n_blocks * V):
        draw = rng.random()
        if draw < 0.02:
            s = random_codes(rng, 1)                          # 1 residue
        elif draw < 0.04:
            s = random_codes(rng, L)                          # full length
        elif draw < 0.06:
            s = rng.integers(20, 24, size=int(rng.integers(5, L + 1))
                             ).astype(np.uint8)               # B/Z/X/* only
        elif draw < 0.10:
            s = query[:min(qlen, L)].copy()                   # homolog
        else:
            s = random_codes(rng, int(rng.integers(1, L + 1)))
        seqs.append(s[:L])
    ceiling = None
    if qlen <= SHORT_MAX and rng.random() < 0.3:
        ceiling = int(rng.choice([127, 32767]))
    return Draw(matrix, go, ge, query, seqs, lay_out(seqs, n_blocks, L),
                ceiling)


def pack_queries(rng2: np.random.Generator) -> list:
    """2-6 queries of 1-300 aa for the packed route."""
    n = int(rng2.integers(2, 7))
    return [random_codes(rng2, int(rng2.integers(1, 301))) for _ in range(n)]


def ragged_stream(draw: Draw):
    """The round's blocks as a ragged tile stream, each block cut to its
    longest lane rounded up to 32 rows: (tiles (T, 32, V) int8, outrow
    (T,) int32, n_rows)."""
    n_blocks, _, _ = draw.codes.shape
    lens = np.array([len(s) for s in draw.seqs]).reshape(n_blocks, V)
    cut = [round_up(max(int(n), 1), 32) for n in lens.max(axis=1)]
    tiles = np.concatenate([draw.codes[b, :cut[b]].reshape(-1, 32, V)
                            for b in range(n_blocks)])
    outrow = np.repeat(np.arange(n_blocks, dtype=np.int32),
                       [c // 32 for c in cut])
    return tiles, outrow, n_blocks


def planted(draw: Draw):
    """A long round's planted stream: (query, lane sequences, (tiles (T, 32,
    64) int8, outrow, 1)). The query is a run of the residue whose match
    scores most under the round's matrix (d), long enough that the run alone
    scores past 32,767; lane 0 holds that run, lane 1 the shortest run that
    reaches the pair form's limit 32,767 - d (flagged, and exact), lane 2 one
    residue less (not flagged); the other lanes are empty."""
    mat = get_matrix(draw.matrix)
    best = int(np.argmax(np.diag(mat)[:20]))
    d = int(mat[best, best])
    n = PAIR_MAX // d + 1                 # n * d > 32,767
    k = -(-(PAIR_MAX - d) // d)           # k * d >= the limit
    query = np.full(n, best, np.uint8)
    seqs = [query, query[:k], query[:k - 1]] + [query[:0]] * 61
    L = round_up(n, 32)
    codes = np.full((L, 64), PAD_CODE, np.int8)
    for lane, x in enumerate(seqs):
        codes[:len(x), lane] = x
    return query, seqs, (codes.reshape(-1, 32, 64),
                         np.zeros(L // 32, np.int32), 1)


def first_mismatch(route: str, got: np.ndarray, exp: np.ndarray):
    """(route, block, lane, got, exp) of the first differing lane, or
    None; for k3's (queries, n_blocks, V) planes the route names the
    query of the pack."""
    bad = np.argwhere(got != exp)
    if not len(bad):
        return None
    at = tuple(bad[0])
    if len(at) == 3:
        route = f"{route} query {at[0]}"
    return (route, int(at[-2]), int(at[-1]), int(got[at]), int(exp[at]))


def run_round(draw: Draw, device, rng2: np.random.Generator) -> dict:
    """Score one round through every route that can take it on `device`
    and compare each with the C oracle. Returns {"routes": {route: scores},
    "expected": {route: oracle}, "pack": the packed route's query codes,
    "mismatch": the first (route, block, lane, got, exp) or None}; k3's
    arrays are (queries, n_blocks, V), the others (n_blocks, V)."""
    dev = resolve_device(device)
    mat = get_matrix(draw.matrix)
    go, ge, ceiling = draw.gap_open, draw.gap_extend, draw.ceiling
    n_blocks = draw.codes.shape[0]
    exact = cref.sw_score_many(draw.query, draw.seqs, mat, go, ge).reshape(
        n_blocks, V)
    capped = exact if ceiling is None else np.minimum(exact, ceiling)
    codes = torch.from_numpy(draw.codes).to(dev)
    qp = torch.from_numpy(build_query_profile(draw.query, draw.matrix,
                                              m_multiple=8)).to(dev)
    tiles, outrow, n_rows = ragged_stream(draw)
    tiles, outrow = torch.from_numpy(tiles).to(dev), torch.from_numpy(
        outrow).to(dev)
    row_start = scorer.row_starts(outrow, n_rows)
    scorer.check_stream(tiles, outrow, qp, row_start)
    routes, expected = {}, {}
    if draw.long:
        routes["k5"] = longquery.score_chunk_long(codes, qp, go, ge)
        routes["k2"] = longquery.score_tiles_long(tiles, outrow, n_rows, qp,
                                                  go, ge, row_start=row_start)
        expected.update(k5=exact, k2=exact)
        pq, pseqs, (pt, po, pn) = planted(draw)
        pt, po = torch.from_numpy(pt).to(dev), torch.from_numpy(po).to(dev)
        pqp = torch.from_numpy(build_query_profile(pq, draw.matrix,
                                                   m_multiple=8)).to(dev)
        routes["k2_planted"] = longquery.score_tiles_long(pt, po, pn, pqp,
                                                          go, ge)
        routes["k2_int32"] = longquery.score_tiles_long_int32(pt, po, pn,
                                                              pqp, go, ge)
        pexp = cref.sw_score_many(pq, pseqs, mat, go, ge).reshape(pn, 64)
        expected.update(k2_planted=pexp, k2_int32=pexp)
        k1q = pq[:SHORT_MAX]
        routes["k1_planted"] = scorer.score_tiles(
            pt, po, pn, torch.from_numpy(build_query_profile(
                k1q, draw.matrix, m_multiple=8)).to(dev), go, ge)
        expected["k1_planted"] = cref.sw_score_many(
            k1q, pseqs, mat, go, ge).reshape(pn, 64)
    else:
        routes["k4"] = scorer.score_chunk(codes, qp, go, ge, ceiling=ceiling)
        routes["k1"] = scorer.score_tiles(tiles, outrow, n_rows, qp, go, ge,
                                          ceiling=ceiling, row_start=row_start)
        expected.update(k4=capped, k1=capped)
        if ceiling is None:
            split = scorer.upload_split(scorer.split_plan(
                np.diff(row_start.cpu().numpy()) * tiles.shape[1],
                qp.shape[1], V, scorer.split_slots(dev, V),
                force=4 if draw.qlen % 2 else 2), dev)
            routes["k1_split"] = scorer.score_tiles(
                tiles, outrow, n_rows, qp, go, ge, row_start=row_start,
                split=split)
            expected["k1_split"] = exact
    pack = pack_queries(rng2)
    planes = np.zeros((len(pack), n_blocks, V), np.int64)
    for p in qpack.build_query_packs(pack, matrix=draw.matrix):
        out = scorer.score_tiles_packed(
            tiles, outrow, n_rows, torch.from_numpy(p.qp).to(dev),
            torch.from_numpy(p.seg_of_group).to(dev), go, ge,
            n_seg_cap=qpack.N_SEG_CAP, row_start=row_start).cpu().numpy()
        for e in p.entries:
            planes[e.query_pos] = out[:, e.seg // 2]
    routes["k3"] = planes
    expected["k3"] = np.stack([cref.sw_score_many(
        q, draw.seqs, mat, go, ge).reshape(n_blocks, V) for q in pack])
    if not draw.long:
        routes["ladder"] = ladder.score_chunk_adaptive(codes, qp, go, ge)[0]
        expected["ladder"] = exact
    routes = {k: v.cpu().numpy() if torch.is_tensor(v) else v
              for k, v in routes.items()}
    mismatch = next((m for k in routes if (m := first_mismatch(
        k, routes[k], expected[k])) is not None), None)
    return {"routes": routes, "expected": expected, "pack": pack,
            "mismatch": mismatch}


def fuzz(rounds: int, seed: int, device=None) -> int:
    """fuzz_tpu.main's loop on `device`; returns the failed rounds. Before
    the summary line, one line of kernels 1 and 2's launches in each lane
    form (on a card) and the blocks each scored again in int32 (kernel 2:
    one a long round, the planted stream's; kernel 1: one a long PAM250
    round)."""
    rng = np.random.default_rng(seed)
    failures = 0
    before = (longquery.score_qtile_pairs.launches,
              longquery.score_qtile.launches,
              longquery.score_tiles_long.rescored_blocks,
              scorer.score_tiles.pair_launches, scorer.score_tiles.launches,
              scorer.score_tiles.rescored_blocks)
    for r in range(rounds):
        draw = draw_round(rng)
        res = run_round(draw, device, np.random.default_rng([seed, r]))
        print(json.dumps({     # fuzz_tpu.py's keys, and the routes
            "round": r, "matrix": draw.matrix,
            "gap": [draw.gap_open, draw.gap_extend], "qlen": draw.qlen,
            "blocks": draw.codes.shape[0], "L": draw.codes.shape[1],
            "ceiling": draw.ceiling, "ok": res["mismatch"] is None,
            "routes": list(res["routes"]),
            "pack_qlens": [len(q) for q in res["pack"]]}), flush=True)
        if res["mismatch"] is not None:
            route, b, lane, got, exp = res["mismatch"]
            print(f"  MISMATCH seed {seed} round {r} route {route} block {b} "
                  f"lane {lane}: got {got}, exp {exp}", file=sys.stderr)
            failures += 1
    print(json.dumps({"kernel2": {
        "pairs": longquery.score_qtile_pairs.launches - before[0],
        "int32": longquery.score_qtile.launches - before[1],
        "rescored_blocks": (longquery.score_tiles_long.rescored_blocks
                            - before[2])}, "kernel1": {
        "pairs": scorer.score_tiles.pair_launches - before[3],
        "int32": scorer.score_tiles.launches - before[4],
        "rescored_blocks": (scorer.score_tiles.rescored_blocks
                            - before[5])}}), flush=True)
    print(json.dumps({"fuzz": "PASS" if not failures else "FAIL",
                      "rounds": rounds, "failures": failures}), flush=True)
    return failures


def packed_world(seed: int, n_seqs: int = 3_000):
    """fuzz_tpu.fuzz_packed's DB records: n_seqs synthetic sequences with
    1% homologs of 8 queries of 30-1,000 aa."""
    base = synth_queries(8, [30, 80, 150, 300, 500, 700, 900, 1000],
                         seed=seed + 1)
    return synth_db(n_seqs, seed=seed + 2, queries=[q.codes for q in base],
                    homolog_frac=0.01)


def fuzz_packed(rounds: int, seed: int, device=None, n_seqs: int = 3_000,
                max_queries: int = 15, max_qlen: int = 1_008) -> list:
    """Random batches of 1..max_queries queries of 1..max_qlen aa against
    an n_seqs-sequence DB, searched per query and packed (query_pack):
    the hit lists must be equal, and one random query's top hit equal to
    the C oracle. Returns one dict a round: its queries, both searches'
    results and ok."""
    rng = np.random.default_rng(seed)
    recs = packed_world(seed, n_seqs)
    out = []
    with tempfile.TemporaryDirectory() as td:
        packed = build_db(recs, td, V=V)
        for r in range(rounds):
            nq = int(rng.integers(1, max_queries + 1))
            qlens = [int(rng.integers(1, max_qlen + 1)) for _ in range(nq)]
            queries = synth_queries(nq, qlens, seed=seed + 100 + r)
            a, _ = search(packed, queries, SearchConfig(
                top_k=8, query_pack=False), device=device)
            b, _ = search(packed, queries, SearchConfig(
                top_k=8, query_pack=True), device=device)
            ok = same_hits(a, b)
            qi = int(rng.integers(nq))      # the oracle on one top hit
            if a[qi].hits:
                h0 = a[qi].hits[0]
                exp = int(cref.sw_score_many(
                    queries[qi].codes, [packed.seq_codes(h0.sorted_idx)],
                    get_matrix("BLOSUM62"), 10, 2)[0])
                ok = ok and exp == h0.score
            print(json.dumps({"round": r, "nq": nq, "qlens": qlens[:6],
                              "ok": bool(ok)}), flush=True)
            out.append({"queries": queries, "per_query": a, "packed": b,
                        "ok": bool(ok)})
    failures = sum(not r["ok"] for r in out)
    print(json.dumps({"fuzz_packed": "PASS" if not failures else "FAIL",
                      "rounds": rounds, "failures": failures}), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m swimm_tpu_torch.benchmarks.fuzz",
        description="Randomized differential fuzz of the five search "
                    "kernels against the C oracle (exit 0: every draw "
                    "agreed exactly).")
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--packed", action="store_true",
                    help="fuzz the packed serving posture vs per-query")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    if args.packed:
        rounds = fuzz_packed(args.rounds, args.seed, args.device)
        return 0 if all(r["ok"] for r in rounds) else 1
    return 1 if fuzz(args.rounds, args.seed, args.device) else 0


if __name__ == "__main__":
    sys.exit(main())
