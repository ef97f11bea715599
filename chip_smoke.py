"""On-card smoke test of swimm_tpu_torch (PyTorch + CUDA, one NVIDIA GPU).

    python3 chip_smoke.py [--kernels-only]

Phases (any failure raises and exits nonzero; nothing is caught):
  1. the card's name and power limit (nvidia-smi);
  2. build csrc/sw_ragged.cu and csrc/sw_chunk.cu side by side and hold all
     five kernels against their plain PyTorch versions on the card,
     bit-exact, on small cases: the stream kernels on ragged cases (mixed
     block lengths, tied lanes, PAD runs, a ceiling, gap_extend=0, m = 8,
     16, 24, 40, 2048, 2064, a multi-tile long query with a small tile_m,
     and the DB's longest block, and for sw_ragged_kernel the shapes that
     strain its cooperating workers, each with and without a ceiling:
     one-tile blocks, m = 8, 32, 40, 72, 120, 136, 448, 2048, 64, 256 and
     512 lanes, flat and free gaps; more than 512 lanes are refused before
     any launch; for sw_ragged_qtile_kernel, on the carry form of its walk,
     tile_m = 8 to 1024 (1 to 32 strips, tail strips, three and four
     workers), one-tile blocks, 64 to 512 lanes, gaps 10/2, 5/0, 0/3, 0/0,
     random carries in with lanes whose score is their incoming F alone,
     scores and both carries out, and three chained tiles against one pass);
     the packed kernel on packs with a planted homolog in the
     query just above another, a one-group query, a pack filled to its
     bucket, a pack with a large unused tail, gap_extend=0 and gap_open=0,
     and on packs cut to M = 8, 40, 72 and 160 rows (one strip, an 8-row
     tail strip, odd strip counts) with a query that straddles a strip
     boundary and a homolog planted in its rows just above the boundary;
     the chunk kernels at V = 128, 64 and 512, m = 8, 40, 2048, a ceiling,
     m = 2064 in 1024-row tiles, a small tile_m, one query-tile launch with
     random carries, and the list forms of both chunk kernels on separately
     allocated chunks of different B and L in one launch (--kernels-only
     stops here);
  3. the main path at Swiss-Prot scale: a 570,000-sequence synthetic DB
     (seed 2, homolog_frac 0.0005), 20 queries of 100-500 aa (lengths from
     rng seed 0, synth_queries seed 1), BLOSUM62 10/2, top_k 16 — packed,
     uploaded once, searched once as warm-up, then timed with the kernels'
     launch counters set to 0 just before and read just after;
  4. one 5,000-aa query (a query-0 segment inside random sequence) through
     the query-tiled path (5 tiles of 1024 rows), counted the same way;
  5. the packed path: the same 20 queries with query_pack=True (one launch
     per pack), hit lists equal to the per-query search's hit for hit; then
     100 short queries (30-120 aa), per query against packed, equal hits;
  6. the chunk path: score_db for query 0 and for the 5,000-aa query, every
     lane's score equal to the stream kernels' over the resident stream,
     their top 16 equal to the search's hits, one launch over all chunks
     (for the long query: one per query tile);
  7. exactness at scale: every reported hit rescored (numpy Gotoh oracle
     for three queries, the plain scorer on the gathered lanes for all),
     each query's top hit a planted homolog;
  8. all five kernels against their plain versions at the main path's full
     size, bit-exact (the whole tile stream at query 0's m; the first two
     1024-row tiles of the long query, scores and both outgoing carries;
     the widest pack over the whole stream; every chunk at query 0's m in
     one launch, also equal to kernel 1's lanes;
     the long query's third tile over every chunk with the second tile's
     carries in), their times beside their bounds (instruction rate
     peak from the card's SM count and max clock), kernel 1's time without
     the 100 longest blocks and on those alone, GCUPS, latencies, profiled
     20-query searches (kernel device time and the device's idle share); a
     `kernels` JSON line, then the device JSON as the last line.

Imports nothing of JAX or of the swimm_tpu package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

T_START = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
INSTR_PER_CLK_SM = 128      # thread-instructions an SM can start per clock:
# 4 warp schedulers x 32 lanes, one instruction per scheduler per clock
# (Hopper architecture white paper); times SM count and max SM clock, both
# read from the card, gives the card's peak instruction rate. The 64
# int32 add/min/max results per clock per SM in NVIDIA's arithmetic
# throughput table for sm_90 is NOT the ceiling of these kernels: sm_90 fuses
# an addition into a maximum, and a kernel of this repo has already run
# below the time that table gives for 11 additions and maxima per cell
OPS_PER_CELL = 6.5          # instructions per DP cell, counted from the
# recurrence (not from any build of it) in the shortest sm_90 sequence:
#   hg = H - goe                       1  VIADD, shared: this row's next
#                                         column (E) and this column's next
#                                         row (F) both want it
#   E  = max(hg_left, E - ge)          1  VIADDMNMX
#   F  = max(hg_above, F - ge)         1  VIADDMNMX
#   H  = max(diag + S, E, F, 0)        2  VIADDMNMX + VIMNMX3
#   running max over two rows          0.5  VIMNMX3 (two H per instruction)
#   S  = profile[row][code]            1  shared-memory load
N_SEQS = 570_000
N_QUERIES = 20
LONG_LEN = 5000
N_SHORT = 100               # short queries, per query against packed


def note(msg: str) -> None:
    print(f"[+{time.perf_counter() - T_START:7.1f}s] {msg}", flush=True)


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean device milliseconds of fn() over reps launches (warm)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ragged_case(rng, tile_counts, V=128, jt=32):
    """Block-major tile stream with mixed block lengths, PAD runs at lane
    ends (as in a packed DB), and duplicated lanes (ties)."""
    from swimm_tpu_torch.alphabet import PAD_CODE
    blocks = []
    for c in tile_counts:
        b = rng.integers(0, 24, size=(c * jt, V), dtype=np.int8)
        for v in range(0, V, 3):
            b[rng.integers(1, c * jt + 1):, v] = PAD_CODE
        b[:, 1] = b[:, 0]
        b[:, V - 1] = b[:, 5]
        blocks.append(b)
    tiles = np.concatenate([b.reshape(-1, jt, V) for b in blocks])
    outrow = np.repeat(np.arange(len(tile_counts), dtype=np.int32),
                       tile_counts)
    return (torch.from_numpy(tiles).cuda(), torch.from_numpy(outrow).cuda(),
            len(tile_counts))


def profile(rng, m, matrix="BLOSUM62"):
    from swimm_tpu_torch.models.profile import build_query_profile
    from swimm_tpu_torch.utils.synth import random_codes
    q = random_codes(rng, max(m - int(rng.integers(0, 8)), 1))
    return torch.from_numpy(build_query_profile(q, matrix, 8)).cuda()


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def random_carries(rng, tiles, row_start, big_lanes=range(2, 512, 5),
                   big=20_000):
    """Random incoming carries for a query tile (H 0..59, F -80..39), and
    at each block's last position an F of big + block + lane in the lanes
    big_lanes: above every H a tile of up to 1024 rows could make there
    (BLOSUM62 scores at most 11 a row), so that those lanes' per-tile score
    is that F alone. Returns (hcar, fcar, mask of the planted lanes per
    (block, lane), their expected scores)."""
    n_rows = row_start.shape[0] - 1
    V = tiles.shape[2]
    hc = torch.from_numpy(rng.integers(0, 60, tiles.shape, dtype=np.int32))
    fc = torch.from_numpy(rng.integers(-80, 40, tiles.shape, dtype=np.int32))
    lanes = torch.tensor([v for v in big_lanes if v < V])
    last = row_start[1:].cpu() - 1
    want = (big + torch.arange(n_rows)[:, None] + lanes[None, :]).int()
    fc[last[:, None], -1, lanes[None, :]] = want
    mask = torch.zeros((n_rows, V), dtype=torch.bool)
    mask[:, lanes] = True
    dev = tiles.device
    return (hc.to(dev), fc.to(dev), mask.to(dev),
            want.to(dev).reshape(-1))


def compare_qtile_carry_form(rng, errs: dict) -> None:
    """sw_ragged_qtile_kernel (the carry form of the hg walk) against
    score_qtile_ref, scores and both outgoing carries: tile_m = 8, 32, 40,
    64, 72, 104 and 1024 (1, 1, 2, 2, 3, 4 and 32 strips: one worker, 8-row
    tail strips, odd strip counts, every worker slot filled), blocks of one
    tile beside long ones, 64 to 512 lanes, gaps 10/2, 5/0, 0/3 and 0/0,
    random carries in with lanes whose score is their incoming F alone;
    then three chained tiles against one pass over their rows."""
    from swimm_tpu_torch.ops import longquery, scorer
    k2 = "sw_ragged_qtile_kernel"
    for counts, V, tile_m, go, ge in (
            ([1, 5, 1, 3], 128, 8, 10, 2), ([1, 4, 2], 128, 32, 5, 0),
            ([2, 1, 6], 128, 40, 0, 3), ([1, 3, 1], 64, 64, 0, 0),
            ([3, 1, 7], 128, 72, 10, 2), ([1, 2, 5], 256, 104, 5, 0),
            ([1, 6, 2], 128, 1024, 10, 2), ([2, 1, 3], 512, 72, 0, 3),
            ([1, 3], 64, 1024, 5, 0), ([1, 2], 256, 1024, 0, 0),
            ([1, 1, 1], 128, 104, 0, 3), ([4, 1], 128, 1024, 0, 3)):
        tiles, outrow, n_rows = ragged_case(rng, counts, V)
        rs = scorer.row_starts(outrow, n_rows)
        hc, fc, mask, want = random_carries(rng, tiles, rs)
        qp = profile(rng, tile_m)
        ref = longquery.score_qtile_ref(tiles, outrow, n_rows, qp, go, ge,
                                        hc, fc)
        got = longquery.score_qtile(tiles, outrow, n_rows, qp, go, ge,
                                    hc.clone(), fc.clone())
        torch.cuda.synchronize()
        if not torch.equal(ref[0][mask], want):
            raise AssertionError(f"{k2} tile_m={tile_m}: the planted F does "
                                 "not give its lanes' scores")
        e = max(max_err(g, r) for g, r in zip(got, ref))
        errs[k2] = max(errs[k2], e)
        note(f"{k2} carry form V={V} tile_m={tile_m} gaps={go}/{ge} blocks "
             f"{counts}, random carries in (planted F in {int(mask.sum())} "
             f"lanes), scores + carries out: max_abs_err={e}")
    for counts, V, tile_m, go, ge in (([1, 4, 2], 128, 40, 10, 2),
                                      ([2, 5, 1], 128, 104, 0, 3),
                                      ([1, 3], 256, 72, 5, 0),
                                      ([1, 2], 128, 512, 0, 0)):
        tiles, outrow, n_rows = ragged_case(rng, counts, V)
        rs = scorer.row_starts(outrow, n_rows)
        hc, fc, _, _ = random_carries(rng, tiles, rs)
        qp = profile(rng, 3 * tile_m)
        ref = longquery.score_qtile_ref(tiles, outrow, n_rows, qp, go, ge,
                                        hc, fc)
        best, h, f = None, hc.clone(), fc.clone()
        for qt in range(3):
            out, h, f = longquery.score_qtile(
                tiles, outrow, n_rows,
                qp[:, qt * tile_m:(qt + 1) * tile_m].contiguous(), go, ge, h,
                f)
            best = out if best is None else torch.maximum(best, out)
        torch.cuda.synchronize()
        e = max(max_err(g, r) for g, r in zip((best, h, f), ref))
        errs[k2] = max(errs[k2], e)
        note(f"{k2} three chained tiles of {tile_m} rows V={V} gaps={go}/{ge}"
             f" vs one pass of {3 * tile_m}: max_abs_err={e}")


def compare_kernels(errs: dict) -> None:
    """Phase 2: both kernels vs their plain versions, on the card."""
    from swimm_tpu_torch.ops import longquery, scorer
    rng = np.random.default_rng(5)
    k1 = "sw_ragged_kernel"
    k2 = "sw_ragged_qtile_kernel"
    cases = [  # (tile counts, V, m, gap_open, gap_extend, ceiling)
        ([1, 3, 1, 5, 2], 128, 8, 10, 2, None),
        ([2, 1, 4], 128, 16, 10, 2, None),
        ([3, 1, 2], 128, 24, 10, 1, None),
        ([1, 2, 6], 128, 40, 11, 1, None),
        ([2, 5, 1, 3], 128, 64, 10, 2, 40),
        ([4, 2, 3], 128, 96, 5, 0, None),
        ([1, 3, 2], 128, 2048, 10, 2, None),
    ]
    # shapes that strain the workers of sw_ragged_kernel, each with and
    # without a ceiling: blocks of one tile (shorter than a lock step),
    # fewer strips than workers (m = 8, 32, 40), odd strip counts and 8-row
    # tail strips (m = 72, 120, 136), 14 strips, the longest profile, 64
    # lanes, flat and free gaps
    for counts, V, m, go, ge, ceil in (
            ([1, 1, 1], 128, 8, 10, 2, 12), ([1, 2], 128, 32, 10, 2, 25),
            ([1, 3, 1], 128, 40, 10, 2, 25), ([1, 4, 2], 128, 72, 10, 2, 30),
            ([2, 1, 3], 128, 120, 10, 2, 30), ([1, 3], 128, 136, 10, 2, 25),
            ([1, 7, 2], 128, 448, 10, 2, 50), ([1, 7, 2], 64, 448, 10, 2, 50),
            ([1, 3], 256, 136, 10, 2, 25), ([2, 1], 512, 72, 10, 2, 30),
            ([1, 2], 64, 2048, 10, 2, 60), ([2, 3], 128, 72, 5, 0, 20),
            ([2, 3], 128, 72, 0, 3, 20), ([2, 3], 128, 72, 0, 0, 20)):
        cases += [(counts, V, m, go, ge, None), (counts, V, m, go, ge, ceil)]
    for counts, V, m, go, ge, ceil in cases:
        tiles, outrow, n_rows = ragged_case(rng, counts, V)
        qp = profile(rng, m)
        got = scorer.score_tiles(tiles, outrow, n_rows, qp, go, ge,
                                 ceiling=ceil)
        ref = scorer.score_tiles_ref(tiles, outrow, n_rows, qp, go, ge,
                                     ceiling=ceil)
        torch.cuda.synchronize()
        errs[k1] = max(errs[k1], max_err(got, ref))
        note(f"{k1} V={V} m={m} gaps={go}/{ge} ceiling={ceil}: "
             f"max_abs_err={max_err(got, ref)}")
    # the lane limit is checked before any launch: every kernel is built
    # for at most 512 threads a block
    tiles, outrow, n_rows = ragged_case(rng, [1], 1024)
    try:
        scorer.score_tiles(tiles, outrow, n_rows, profile(rng, 8), 10, 2)
    except ValueError as exc:
        note(f"{k1} V=1024 refused: {exc}")
    else:
        raise AssertionError("V=1024 must be refused")
    # long queries: m=2064 in 1024-row tiles (3 launches), m=200 in 64-row
    # tiles (4 launches) and 512 lanes, against the one-pass plain scorer
    for counts, V, m, tile_m in (([2, 1, 3], 128, 2064, None),
                                 ([3, 2], 128, 200, 64),
                                 ([2, 1], 512, 72, 32)):
        tiles, outrow, n_rows = ragged_case(rng, counts, V)
        qp = profile(rng, m)
        got = longquery.score_tiles_long(tiles, outrow, n_rows, qp, 10, 2,
                                         tile_m=tile_m)
        ref = scorer.score_tiles_ref(tiles, outrow, n_rows, qp, 10, 2)
        torch.cuda.synchronize()
        errs[k2] = max(errs[k2], max_err(got, ref))
        note(f"{k2} score_tiles_long V={V} m={m} tile_m={tile_m}: "
             f"max_abs_err={max_err(got, ref)}")
    # one launch with carries in and out vs the plain one-tile step
    tiles, outrow, n_rows = ragged_case(rng, [2, 4, 1])
    hc = torch.randint(0, 60, tiles.shape, dtype=torch.int32, device="cuda")
    fc = torch.randint(-80, 40, tiles.shape, dtype=torch.int32,
                       device="cuda")
    qp = profile(rng, 72)
    ref = longquery.score_qtile_ref(tiles, outrow, n_rows, qp, 10, 2, hc, fc)
    got = longquery.score_qtile(tiles, outrow, n_rows, qp, 10, 2,
                                hc.clone(), fc.clone())
    torch.cuda.synchronize()
    e = max(max_err(g, r) for g, r in zip(got, ref))
    errs[k2] = max(errs[k2], e)
    note(f"{k2} one tile, random carries in, scores + carries out: "
         f"max_abs_err={e}")
    compare_qtile_carry_form(rng, errs)


def chunk_case(rng, B, L, V):
    """One (B, L, V) chunk with PAD runs at lane ends and tied lanes."""
    from swimm_tpu_torch.alphabet import PAD_CODE
    codes = rng.integers(0, 24, size=(B, L, V), dtype=np.int8)
    for b in range(B):
        for v in range(0, V, 3):
            codes[b, rng.integers(1, L + 1):, v] = PAD_CODE
    codes[:, :, 1] = codes[:, :, 0]
    return torch.from_numpy(codes).cuda()


def pack_on_card(pack):
    return (torch.from_numpy(pack.qp).cuda(),
            torch.from_numpy(pack.seg_of_group).cuda())


def compare_new_kernels(errs: dict) -> None:
    """Phase 2, second half: the packed and the two chunk kernels vs their
    plain versions, on the card."""
    from swimm_tpu_torch.models import qpack
    from swimm_tpu_torch.ops import longquery, scorer
    from swimm_tpu_torch.utils.synth import mutate, random_codes
    rng = np.random.default_rng(6)
    k3, k4, k5 = ("sw_ragged_packed_kernel", "sw_chunk_kernel",
                  "sw_chunk_qtile_kernel")
    packs = [  # (what, query lengths, bucket, rows kept, gap_open,
        #         gap_extend, V, query a homolog is planted of, its rows)
        ("homolog above the next query", (40, 16, 61, 24), 256, 256, 10, 2,
         128, 0, (0, 32)),
        ("one-group query", (8,), 64, 64, 10, 2, 128, 0, (0, 8)),
        ("filled to its bucket", (3, 8, 1, 5), 64, 64, 10, 2, 128, 0, (0, 3)),
        ("large unused tail", (100, 7), 1024, 1024, 10, 2, 128, 0, (0, 32)),
        ("gap_extend=0", (33, 50), 128, 128, 5, 0, 128, 0, (0, 32)),
        ("gap_open=0", (33, 50), 128, 128, 0, 4, 128, 0, (0, 32)),
        ("gap_open=0, gap_extend=0", (33, 50), 128, 128, 0, 0, 128, 0,
         (0, 32)),
        ("24 queries, 6 strips", (1,) * 24, 384, 384, 10, 2, 128, 0, (0, 1)),
        # packs cut to M rows (any M % 8 == 0 is legal; a pack lays its
        # queries out longest first): one 8-row strip and no separator; 32
        # + 8 rows, the second query in rows 24-39; 32 + 32 + 8 rows, the
        # second query in rows 56-71; five strips (the carry stream in
        # use) under one query. Each has a query that straddles a strip
        # boundary, and a homolog of its rows just above the boundary is
        # planted: the rows whose maxima two workers fold into one plane
        ("one strip of 8 rows", (8,), 64, 8, 10, 2, 128, 0, (0, 8)),
        ("1 + tail strip, straddling row 32", (12, 12), 64, 40, 10, 2, 128,
         1, (0, 8)),
        ("3 strips, straddling rows 32 and 64", (45, 12), 128, 72, 10, 2,
         128, 1, (0, 8)),
        ("5 strips, straddling rows 32-128", (130, 12), 192, 160, 10, 2, 128,
         0, (24, 64)),
        ("64 lanes", (40, 16, 61, 24), 256, 256, 10, 2, 64, 0, (0, 32)),
        ("256 lanes, 5 + tail strips", (130, 12), 192, 168, 10, 2, 256, 0,
         (24, 64)),
        ("512 lanes, one worker", (45, 12), 128, 72, 10, 2, 512, 1, (0, 8)),
    ]
    for what, lens, bucket, keep, go, ge, V, who, (h0, h1) in packs:
        queries = [random_codes(rng, n) for n in lens]
        tiles, outrow, n_rows = ragged_case(rng, [2, 1, 3], V)
        # strong homologs: big H and F in the rows right above the next
        # query's (or the next strip's), the case a leak would show in
        hom = mutate(rng, queries[who][h0:h1], 0.02, 0.0).astype(np.int8)
        tiles[0, :, 7] = torch.from_numpy(
            np.resize(hom, tiles.shape[1])).cuda()
        pack, = qpack.build_query_packs(queries, buckets=(bucket,))
        qp, seg = pack_on_card(pack)
        qp, seg = qp[:, :keep].contiguous(), seg[:keep // 8].contiguous()
        got = scorer.score_tiles_packed(tiles, outrow, n_rows, qp, seg, go,
                                        ge)
        ref = scorer.score_tiles_packed_ref(tiles, outrow, n_rows, qp, seg,
                                            go, ge)
        torch.cuda.synchronize()
        errs[k3] = max(errs[k3], max_err(got, ref))
        used = sorted(e.seg // 2 for e in pack.entries)
        unused = [p for p in range(got.shape[1]) if p not in used]
        if unused and int(got[:, unused].abs().max().item()) != 0:
            raise AssertionError(f"{k3} {what}: an unused plane is not zero")
        plane = next(e.seg // 2 for e in pack.entries if e.query_pos == who)
        if h1 - h0 >= 8 and int(got[0, plane, 7].item()) < 2 * (h1 - h0):
            raise AssertionError(f"{k3} {what}: the planted homolog does "
                                 "not show in its query's plane")
        note(f"{k3} {what} lens={lens} M={keep} V={V} gaps={go}/{ge}: "
             f"max_abs_err={max_err(got, ref)}")
    chunks = [  # (B, L, V, m, gap_open, gap_extend, ceiling)
        (3, 96, 128, 8, 10, 2, None),
        (2, 64, 128, 40, 11, 1, None),
        (5, 32, 64, 72, 5, 0, None),
        (4, 160, 128, 64, 10, 2, 40),
        (2, 64, 64, 2048, 10, 2, None),
        (2, 96, 512, 72, 10, 2, 30),
    ]
    for B, L, V, m, go, ge, ceil in chunks:
        codes = chunk_case(rng, B, L, V)
        qp = profile(rng, m)
        got = scorer.score_chunk(codes, qp, go, ge, ceiling=ceil)
        ref = scorer.score_chunk_ref(codes, qp, go, ge, ceiling=ceil)
        torch.cuda.synchronize()
        errs[k4] = max(errs[k4], max_err(got, ref))
        note(f"{k4} B={B} L={L} V={V} m={m} gaps={go}/{ge} ceiling={ceil}: "
             f"max_abs_err={max_err(got, ref)}")
    # long queries over a chunk: m=2064 in 1024-row tiles (3 launches) and
    # m=200 in 64-row tiles (4 launches), against the one-pass plain scorer
    for B, L, V, m, tile_m in ((2, 64, 128, 2064, None), (3, 96, 64, 200, 64),
                               (2, 64, 512, 72, 32)):
        codes = chunk_case(rng, B, L, V)
        qp = profile(rng, m)
        got = longquery.score_chunk_long(codes, qp, 10, 2, tile_m=tile_m)
        ref = scorer.score_chunk_ref(codes, qp, 10, 2)
        torch.cuda.synchronize()
        errs[k5] = max(errs[k5], max_err(got, ref))
        note(f"{k5} score_chunk_long V={V} m={m} tile_m={tile_m}: "
             f"max_abs_err={max_err(got, ref)}")
    # the list forms on separately allocated chunks of different B and L
    # (B = 1, one 32-position tile, the longest neither first nor last).
    # Kernel 4: one launch, with and without a ceiling, one strip (no
    # carry), strips for both workers, and more strips than workers
    shapes = ((2, 64), (1, 32), (3, 160), (1, 4480), (4, 96))
    for V, m, ceil in ((128, 8, None), (128, 40, None), (128, 72, 30),
                       (64, 448, None), (64, 448, 60), (256, 136, None)):
        clist = [chunk_case(rng, B, L, V) for B, L in shapes]
        qp = profile(rng, m)
        before = scorer.score_chunks.launches
        got = scorer.score_chunks(clist, qp, 10, 2, ceiling=ceil)
        if scorer.score_chunks.launches != before + 1:
            raise AssertionError(f"{k4}: the list form must be one launch")
        e = max(max_err(g, scorer.score_chunk_ref(c, qp, 10, 2, ceiling=ceil))
                for g, c in zip(got, clist))
        torch.cuda.synchronize()
        errs[k4] = max(errs[k4], e)
        note(f"{k4} list of {len(clist)} separate chunks V={V} m={m} "
             f"ceiling={ceil}, one launch: max_abs_err={e}")
    # Kernel 5: one launch per query tile, scores and both outgoing carries
    # of every chunk against the plain one-tile step chunk by chunk
    for V, m in ((128, 72), (64, 1024)):
        clist = [chunk_case(rng, B, L, V) for B, L in shapes]
        hcs = [torch.randint(0, 60, c.shape, dtype=torch.int32,
                             device="cuda") for c in clist]
        fcs = [torch.randint(-80, 40, c.shape, dtype=torch.int32,
                             device="cuda") for c in clist]
        qp = profile(rng, m)
        before = longquery.score_chunks_qtile.launches
        got = longquery.score_chunks_qtile(
            clist, qp, 10, 2, [h.clone() for h in hcs],
            [f.clone() for f in fcs])
        if longquery.score_chunks_qtile.launches != before + 1:
            raise AssertionError(f"{k5}: the list form must be one launch")
        e = 0
        for i, c in enumerate(clist):
            ref = longquery.score_chunk_qtile_ref(c, qp, 10, 2, hcs[i],
                                                  fcs[i])
            e = max([e] + [max_err(g[i], r) for g, r in zip(got, ref)])
        torch.cuda.synchronize()
        errs[k5] = max(errs[k5], e)
        note(f"{k5} list of {len(clist)} separate chunks V={V} m={m}, "
             f"random carries in, scores + carries out: max_abs_err={e}")
    # one launch with carries in and out vs the plain one-tile step
    codes = chunk_case(rng, 3, 128, 128)
    hc = torch.randint(0, 60, codes.shape, dtype=torch.int32, device="cuda")
    fc = torch.randint(-80, 40, codes.shape, dtype=torch.int32,
                       device="cuda")
    qp = profile(rng, 72)
    ref = longquery.score_chunk_qtile_ref(codes, qp, 10, 2, hc, fc)
    got = longquery.score_chunk_qtile(codes, qp, 10, 2, hc.clone(),
                                      fc.clone())
    torch.cuda.synchronize()
    e = max(max_err(g, r) for g, r in zip(got, ref))
    errs[k5] = max(errs[k5], e)
    note(f"{k5} one tile, random carries in, scores + carries out: "
         f"max_abs_err={e}")


def longest_block_check(dev_db, qp_short, errs: dict) -> None:
    """Both kernels vs plain on the DB's longest block."""
    from swimm_tpu_torch.ops import longquery, scorer
    tiles, _, _, row_start = dev_db[:4]
    counts = row_start[1:] - row_start[:-1]
    r = int(torch.argmax(counts).item())
    t0, t1 = int(row_start[r].item()), int(row_start[r + 1].item())
    blk = tiles[t0:t1].contiguous()
    orow = torch.zeros(t1 - t0, dtype=torch.int32, device="cuda")
    got = scorer.score_tiles(blk, orow, 1, qp_short, 10, 2)
    ref = scorer.score_tiles_ref(blk, orow, 1, qp_short, 10, 2)
    errs["sw_ragged_kernel"] = max(errs["sw_ragged_kernel"],
                                   max_err(got, ref))
    qp_long = profile(np.random.default_rng(8), 1024)
    h0 = torch.zeros(blk.shape, dtype=torch.int32, device="cuda")
    f0 = torch.full(blk.shape, scorer.NEG, dtype=torch.int32, device="cuda")
    g2 = longquery.score_qtile(blk, orow, 1, qp_long, 10, 2, h0.clone(),
                               f0.clone())
    r2 = longquery.score_qtile_ref(blk, orow, 1, qp_long, 10, 2, h0, f0)
    e2 = max(max_err(g, x) for g, x in zip(g2, r2))
    errs["sw_ragged_qtile_kernel"] = max(errs["sw_ragged_qtile_kernel"], e2)
    torch.cuda.synchronize()
    note(f"longest block (row {r}, {(t1 - t0) * 32} positions): "
         f"sw_ragged_kernel err={max_err(got, ref)}, "
         f"sw_ragged_qtile_kernel err={e2}")


def rescore_plain(packed, query, hits, config):
    """Scores of the hit sequences from the plain scorer on one gathered
    block of lanes (on the card)."""
    from swimm_tpu_torch.alphabet import PAD_CODE
    from swimm_tpu_torch.db import quantize_len
    from swimm_tpu_torch.models.profile import build_query_profile
    from swimm_tpu_torch.ops import scorer
    seqs = [packed.seq_codes(h.sorted_idx) for h in hits]
    L = quantize_len(max(len(s) for s in seqs))
    blk = np.full((L, 128), PAD_CODE, np.int8)
    for v, s in enumerate(seqs):
        blk[:len(s), v] = s
    tiles = torch.from_numpy(blk.reshape(-1, 32, 128)).cuda()
    orow = torch.zeros(tiles.shape[0], dtype=torch.int32, device="cuda")
    qp = torch.from_numpy(build_query_profile(
        query.codes, config.matrix, config.m_multiple)).cuda()
    out = scorer.score_tiles_ref(tiles, orow, 1, qp, config.gap_open,
                                 config.gap_extend)
    return out[0, :len(seqs)].cpu().tolist()


def check_hits(packed, queries, results, config, n_oracle: int) -> int:
    """Phase 5: rescore every hit; top hit must be a planted homolog."""
    from swimm_tpu_torch.matrices import get_matrix
    from swimm_tpu_torch.ops.reference import sw_score
    sub = get_matrix(config.matrix)
    n = 0
    for qi, (q, r) in enumerate(zip(queries, results)):
        if len(r.hits) != config.top_k:
            raise AssertionError(f"{q.title}: {len(r.hits)} hits")
        scores = [h.score for h in r.hits]
        if scores != sorted(scores, reverse=True):
            raise AssertionError(f"{q.title}: hits not in score order")
        plain = rescore_plain(packed, q, r.hits, config)
        if plain != scores:
            raise AssertionError(f"{q.title}: reported {scores}, plain "
                                 f"scorer {plain}")
        if qi < n_oracle:
            for h in r.hits:
                exp = sw_score(q.codes, packed.seq_codes(h.sorted_idx), sub,
                               config.gap_open, config.gap_extend)
                if exp != h.score:
                    raise AssertionError(f"{q.title} hit {h.rank}: reported "
                                         f"{h.score}, oracle {exp}")
        if not r.hits[0].title.endswith("planted_homolog"):
            raise AssertionError(f"{q.title}: top hit {r.hits[0].title!r} "
                                 "is not a planted homolog")
        n += len(r.hits)
    return n


def device_breakdown(fn) -> dict:
    """Wall time of fn() under torch.profiler, the device time of its CUDA
    kernels (ours vs the rest), and the device's idle share of the wall.
    Device numbers read "not measured" when the trace holds no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t) * 1e3
    ours = other = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = ev.self_device_time_total
        if "sw_ragged" in ev.key or "sw_chunk" in ev.key:
            ours += us / 1e3
        else:
            other += us / 1e3
    if ours + other == 0:
        return {"wall_ms": wall_ms, "kernel_ms": "not measured",
                "other_device_ms": "not measured", "idle_share":
                "not measured"}
    return {"wall_ms": wall_ms, "kernel_ms": ours, "other_device_ms": other,
            "idle_share": 1 - (ours + other) / wall_ms}


def instruction_rate() -> float:
    """The card's peak thread-instruction rate: SMs x 128 per clock x max
    SM clock."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INSTR_PER_CLK_SM * mhz * 1e6


def bound(bytes_moved: float, ops: float, int_rate: float):
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_o = ops / int_rate * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def timed(fn, reps: int = 1):
    """(mean device ms over reps, result of the last call)."""
    box = []
    ms = cuda_ms(lambda: box.append(fn()), reps)
    return ms, box[-1]


def same_hits(a, b) -> bool:
    key = lambda r: [(h.rank, h.score, h.sorted_idx) for h in r.hits]
    return [key(r) for r in a] == [key(r) for r in b]


def check_score_vector(packed, name, vec, lane_scores, result, top_k):
    """A score_db vector must equal the stream kernel's lane scores put in
    sorted-db order, and its top hits must be the search's."""
    from swimm_tpu_torch.models import engine
    exp = engine.scatter_lane_scores(packed, lane_scores.cpu().numpy())
    if not np.array_equal(vec, exp):
        raise AssertionError(f"score_db({name}) differs from the stream "
                             f"kernel on {int((vec != exp).sum())} sequences")
    top = engine.top_k_hits(packed, vec, top_k)
    if ([(h.score, h.sorted_idx) for h in top]
            != [(h.score, h.sorted_idx) for h in result.hits]):
        raise AssertionError(f"score_db({name}): top {top_k} differ from "
                             "the search's hits")


def main(argv=None) -> int:
    kernels_only = "--kernels-only" in (sys.argv[1:] if argv is None
                                        else argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script measures the port on a GPU only",
              file=sys.stderr)
        return 1
    from swimm_tpu_torch.db import build_db
    from swimm_tpu_torch.fasta import FastaRecord
    from swimm_tpu_torch.models import engine, qpack
    from swimm_tpu_torch.models.engine import SearchConfig, score_db, search
    from swimm_tpu_torch.models.profile import build_query_profile
    from swimm_tpu_torch.ops import _build, longquery, scorer
    from swimm_tpu_torch.utils.synth import (random_codes, synth_fasta_fast,
                                             synth_queries)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    note(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"python {sys.version.split()[0]}")
    phases = {}
    counters = {"sw_ragged_kernel": scorer.score_tiles,
                "sw_ragged_qtile_kernel": longquery.score_qtile,
                "sw_ragged_packed_kernel": scorer.score_tiles_packed,
                "sw_chunk_kernel": scorer.score_chunks,
                "sw_chunk_qtile_kernel": longquery.score_chunks_qtile}
    launches = dict.fromkeys(counters, 0)

    def counted(fn):
        """fn() with every launch counter set to 0 just before and read
        just after; adds the counts to `launches` and returns (result,
        this run's counts)."""
        for w in counters.values():
            w.launches = 0
        res = fn()
        seen = {name: w.launches for name, w in counters.items()}
        for name, n in seen.items():
            launches[name] += n
        return res, seen

    # ---- phase 2: build + kernels vs plain ----
    t = time.perf_counter()
    scorer.build_kernels()
    phases["build_s"] = time.perf_counter() - t
    for src, log in sorted(_build.BUILD_LOGS.items()):
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "error")):
                note(f"ptxas {src}: {line.strip()}")
    errs = dict.fromkeys(counters, 0)
    t = time.perf_counter()
    compare_kernels(errs)
    compare_new_kernels(errs)
    phases["compare_s"] = time.perf_counter() - t
    if kernels_only:
        note(f"kernels only: max_abs_err per kernel {errs}")
        return 0 if not any(errs.values()) else 1

    # ---- phase 3: Swiss-Prot-scale DB + 20-query batch ----
    rng = np.random.default_rng(0)
    qlens = list(rng.integers(100, 501, size=N_QUERIES))
    queries = synth_queries(N_QUERIES, qlens, seed=1)
    config = SearchConfig(top_k=16)
    with tempfile.TemporaryDirectory() as td:
        t = time.perf_counter()
        fasta = Path(td) / "sp.fasta"
        n_res = synth_fasta_fast(fasta, N_SEQS, seed=2,
                                 queries=[q.codes for q in queries],
                                 homolog_frac=0.0005)
        phases["synth_s"] = time.perf_counter() - t
        note(f"synthetic DB: {N_SEQS} seqs, {n_res} residues")
        t = time.perf_counter()
        packed = build_db(str(fasta), Path(td) / "db", V=128)
        phases["parse_pack_s"] = time.perf_counter() - t
    tiles_np, _, n_rows = packed.flat_tiles()
    note(f"packed: {n_rows} blocks in {len(packed.chunks)} chunks, tile "
         f"stream {tiles_np.shape} ({tiles_np.nbytes / 1e6:.1f} MB)")
    t = time.perf_counter()
    dev_db = engine.device_tiles(packed)
    torch.cuda.synchronize()
    phases["upload_s"] = time.perf_counter() - t
    longest_block_check(dev_db, torch.from_numpy(build_query_profile(
        queries[0].codes, "BLOSUM62", 16)).cuda(), errs)

    t = time.perf_counter()
    search(packed, queries, config)                      # warm-up
    phases["warmup_search_s"] = time.perf_counter() - t
    (results, met), seen = counted(lambda: search(packed, queries, config))
    note(f"20-query search: {met.seconds:.3f} s, {met.gcups:.1f} GCUPS "
         f"(padded {met.padded_gcups:.1f}), launches {seen}")
    if seen["sw_ragged_kernel"] != N_QUERIES:
        raise AssertionError(f"expected {N_QUERIES} launches, got {seen}")

    # ---- phase 4: one 5,000-aa query through the query-tiled path ----
    lrng = np.random.default_rng(3)
    seg = queries[0].codes
    pre = (LONG_LEN - len(seg)) // 2
    long_codes = np.concatenate([random_codes(lrng, pre), seg,
                                 random_codes(lrng, LONG_LEN - pre
                                              - len(seg))])
    long_q = FastaRecord(f"LONG len={LONG_LEN} (contains "
                         f"{queries[0].title.split()[0]})", long_codes)
    m_long = -(-LONG_LEN // config.m_multiple) * config.m_multiple
    n_qt = -(-m_long // longquery.LONG_TILE_M)
    assert engine.select_mode(m_long) == "tiles_long"
    search(packed, [long_q], config)                     # warm-up
    (long_res, long_met), seen = counted(
        lambda: search(packed, [long_q], config))
    note(f"{LONG_LEN}-aa query: {long_met.seconds:.3f} s, "
         f"{long_met.gcups:.1f} GCUPS, launches {seen}")
    if seen["sw_ragged_qtile_kernel"] != n_qt:
        raise AssertionError(f"expected {n_qt} query-tile launches, got "
                             f"{seen}")

    # single-query latency (first query alone)
    _, one_met = search(packed, queries[:1], config)
    breakdown = device_breakdown(lambda: search(packed, queries, config))
    note(f"20-query search under torch.profiler: {breakdown}")

    # ---- phase 5: the packed path (query_pack=True) ----
    pconfig = SearchConfig(top_k=16, query_pack=True)
    packs = qpack.build_query_packs(queries, pconfig.matrix)
    pack_rows = sum(p.M for p in packs)
    fill = sum(e.n_rows for p in packs for e in p.entries) / pack_rows
    note(f"{len(packs)} packs, M = {[p.M for p in packs]}, "
         f"{[len(p.entries) for p in packs]} queries each; query rows / "
         f"pack rows = {fill:.3f}")
    t = time.perf_counter()
    search(packed, queries, pconfig)                     # warm-up
    phases["warmup_packed_s"] = time.perf_counter() - t
    (p_results, p_met), seen = counted(
        lambda: search(packed, queries, pconfig))
    note(f"20-query packed search: {p_met.seconds:.3f} s, {p_met.gcups:.1f} "
         f"GCUPS (padded {p_met.padded_gcups:.1f}), launches {seen}")
    if seen["sw_ragged_packed_kernel"] != len(packs) or any(
            n for name, n in seen.items()
            if name != "sw_ragged_packed_kernel"):
        raise AssertionError(f"expected {len(packs)} packed launches and no "
                             f"other, got {seen}")
    if not same_hits(p_results, results):
        raise AssertionError("packed search's hits differ from the "
                             "per-query search's")
    p_breakdown = device_breakdown(lambda: search(packed, queries, pconfig))
    note(f"20-query packed search under torch.profiler: {p_breakdown}")
    # many short queries, where a launch per query has few rows to work on:
    # per query against packed, each after one warm-up run
    srng = np.random.default_rng(4)
    shorts = synth_queries(N_SHORT, list(srng.integers(30, 121, N_SHORT)),
                           seed=5)
    short = {}
    for name, cfg in (("per_query", config), ("packed", pconfig)):
        search(packed, shorts, cfg)
        res, m = search(packed, shorts, cfg)
        short[name] = {"seconds": m.seconds, "gcups": m.gcups,
                       "padded_gcups": m.padded_gcups, "results": res}
    if not same_hits(short["packed"].pop("results"),
                     short["per_query"].pop("results")):
        raise AssertionError("short queries: packed hits differ from the "
                             "per-query hits")
    short["packs"] = len(qpack.build_query_packs(shorts, pconfig.matrix))
    note(f"{N_SHORT} queries of 30-120 aa: {short}")

    # ---- phase 6: the chunk path (score_db) ----
    tiles, outrow, n_rows, row_start = dev_db[:4]
    T, jt, V = tiles.shape
    lanes_pos = T * jt * V
    n_chunks = len(packed.chunks)
    qp1 = torch.from_numpy(build_query_profile(
        queries[0].codes, "BLOSUM62", config.m_multiple)).cuda()
    qp_l = torch.from_numpy(build_query_profile(
        long_codes, "BLOSUM62", config.m_multiple)).cuda()
    m1 = qp1.shape[1]
    score_db(packed, queries[0], config)                 # warm-up
    t = time.perf_counter()
    vec, seen = counted(lambda: score_db(packed, queries[0], config))
    db_short_s = time.perf_counter() - t
    if seen["sw_chunk_kernel"] != 1 or sum(seen.values()) != 1:
        raise AssertionError(f"expected one launch over all {n_chunks} "
                             f"chunks, got {seen}")
    check_score_vector(packed, "query 0", vec, scorer.score_tiles(
        tiles, outrow, n_rows, qp1, 10, 2, row_start=row_start).reshape(-1),
        results[0], config.top_k)
    t = time.perf_counter()
    vec_l, seen = counted(lambda: score_db(packed, long_q, config))
    db_long_s = time.perf_counter() - t
    if seen["sw_chunk_qtile_kernel"] != n_qt:
        raise AssertionError(f"expected {n_qt} chunk query-tile launches "
                             f"(one per tile over all {n_chunks} chunks), "
                             f"got {seen}")
    check_score_vector(packed, "long query", vec_l,
                       longquery.score_tiles_long(
                           tiles, outrow, n_rows, qp_l, 10, 2,
                           row_start=row_start).reshape(-1),
                       long_res[0], config.top_k)
    note(f"score_db over {n_chunks} chunks: query 0 {db_short_s:.3f} s, "
         f"{LONG_LEN}-aa query {db_long_s:.3f} s; both vectors equal the "
         "stream kernels' and their top 16 equal the search's hits")

    # ---- phase 7: exactness at scale ----
    t = time.perf_counter()
    n_checked = check_hits(packed, queries, results, config, n_oracle=3)
    n_checked += check_hits(packed, [long_q], long_res, config, n_oracle=0)
    phases["rescore_s"] = time.perf_counter() - t
    note(f"rescored {n_checked} hits exactly (numpy oracle on 3 queries, "
         "plain scorer on all); every top hit is a planted homolog")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")

    # ---- phase 8: kernels vs plain at main-path shapes, timed ----
    int_rate = instruction_rate()
    note(f"instruction rate peak from the card: {int_rate / 1e12:.2f} "
         "T thread-instructions/s")
    stream_bytes = tiles.numel() + 8 * (n_rows + 1)

    def walk_bound(m, extra_bytes):
        return bound(stream_bytes + 4 * 32 * m + extra_bytes,
                     OPS_PER_CELL * lanes_pos * m, int_rate)

    t = time.perf_counter()
    k1 = lambda: scorer.score_tiles(tiles, outrow, n_rows, qp1, 10, 2,
                                    row_start=row_start)
    k1_ms, got1 = timed(k1, reps=3)
    p1_ms, ref1 = timed(lambda: scorer.score_tiles_ref(
        tiles, outrow, n_rows, qp1, 10, 2, row_start=row_start))
    e1 = max_err(got1, ref1)
    errs["sw_ragged_kernel"] = max(errs["sw_ragged_kernel"], e1)
    note(f"sw_ragged_kernel vs plain, whole stream at m={m1}: "
         f"max_abs_err={e1}")
    del ref1
    b1, b1_by = walk_bound(m1, 4 * n_rows * V)
    # how much of kernel 1's time is the tail of long blocks: the stream
    # without its 100 longest blocks (the last rows), and those alone
    cut = n_rows - 100
    tc = int(row_start[cut].item())
    rs_head = row_start[:cut + 1].contiguous()
    or_tail = (outrow[tc:] - cut).contiguous()
    rs_tail = (row_start[cut:] - tc).contiguous()
    k1_tail = {
        "tiles_without_100_longest": tc, "tiles": T,
        "ms_without_100_longest": cuda_ms(lambda: scorer.score_tiles(
            tiles[:tc], outrow[:tc], cut, qp1, 10, 2, row_start=rs_head)),
        "ms_100_longest_alone": cuda_ms(lambda: scorer.score_tiles(
            tiles[tc:], or_tail, 100, qp1, 10, 2, row_start=rs_tail))}
    note(f"sw_ragged_kernel without the 100 longest blocks ({tc} of {T} "
         f"tiles): {k1_tail['ms_without_100_longest']:.3f} ms; those 100 "
         f"alone: {k1_tail['ms_100_longest_alone']:.3f} ms")
    # kernel 2 on the long query's first two 1024-row tiles: fresh carries
    # in, then the first tile's carries in; the kernel updates its carries
    # in place, so it gets clones and the plain version the originals
    tm = longquery.LONG_TILE_M
    hc = torch.zeros(tiles.shape, dtype=torch.int32, device="cuda")
    fc = torch.full(tiles.shape, scorer.NEG, dtype=torch.int32,
                    device="cuda")
    e2 = 0
    p2_ms = None
    for qt in range(2):
        qp2 = qp_l[:, qt * tm:(qt + 1) * tm].contiguous()
        got2 = longquery.score_qtile(tiles, outrow, n_rows, qp2, 10, 2,
                                     hc.clone(), fc.clone(), row_start)
        ms, ref2 = timed(lambda: longquery.score_qtile_ref(
            tiles, outrow, n_rows, qp2, 10, 2, hc, fc, row_start))
        p2_ms = p2_ms if p2_ms is not None else ms
        e = max(max_err(g, r) for g, r in zip(got2, ref2))
        note(f"sw_ragged_qtile_kernel vs plain, whole stream, query tile "
             f"{qt}: scores + both carries max_abs_err={e}")
        e2 = max(e2, e)
        _, hc, fc = ref2
        del got2, ref2
    errs["sw_ragged_qtile_kernel"] = max(errs["sw_ragged_qtile_kernel"], e2)
    m2 = qp2.shape[1]
    hk, fk = hc.clone(), fc.clone()   # timed in place; hc/fc (the second
    # tile's outgoing carries) are kept for kernel 5 below
    k2_ms = cuda_ms(lambda: longquery.score_qtile(
        tiles, outrow, n_rows, qp2, 10, 2, hk, fk, row_start))
    del hk, fk
    b2, b2_by = walk_bound(m2, 4 * n_rows * V + 16 * lanes_pos)
    phases["full_size_k1_k2_s"] = time.perf_counter() - t

    # kernel 3 on the widest pack over the whole stream
    t = time.perf_counter()
    wide = max(packs, key=lambda p: p.M)
    qp3, seg3 = pack_on_card(wide)
    k3 = lambda: scorer.score_tiles_packed(tiles, outrow, n_rows, qp3, seg3,
                                           10, 2, row_start=row_start)
    k3_ms, got3 = timed(k3, reps=3)
    p3_ms, ref3 = timed(lambda: scorer.score_tiles_packed_ref(
        tiles, outrow, n_rows, qp3, seg3, 10, 2, row_start=row_start))
    e3 = max_err(got3, ref3)
    errs["sw_ragged_packed_kernel"] = max(errs["sw_ragged_packed_kernel"],
                                          e3)
    note(f"sw_ragged_packed_kernel vs plain, whole stream, pack M={wide.M} "
         f"of {len(wide.entries)} queries: max_abs_err={e3}")
    planes_bytes = got3.numel() * 4
    del got3, ref3
    b3, b3_by = walk_bound(wide.M, 4 * (wide.M // 8) + planes_bytes)
    phases["full_size_k3_s"] = time.perf_counter() - t

    # kernel 4 over every chunk at query 0's m, in one launch; the chunks
    # are views of the stream, so its scores are also kernel 1's lanes
    t = time.perf_counter()
    chunks, table = engine.device_chunk_table(packed)
    k4 = lambda: scorer.score_chunks(chunks, qp1, 10, 2, table=table)
    before = scorer.score_chunks.launches
    k4_ms, got4 = timed(k4, reps=3)
    if scorer.score_chunks.launches != before + 3:
        raise AssertionError(f"expected one launch per call over all "
                             f"{n_chunks} chunks")
    p4_ms, ref4 = timed(
        lambda: [scorer.score_chunk_ref(c, qp1, 10, 2) for c in chunks])
    e4 = max(max_err(g, r) for g, r in zip(got4, ref4))
    errs["sw_chunk_kernel"] = max(errs["sw_chunk_kernel"], e4)
    if not torch.equal(torch.cat(got4), got1):
        raise AssertionError("sw_chunk_kernel over all chunks differs from "
                             "sw_ragged_kernel's lanes")
    note(f"sw_chunk_kernel vs plain, all {n_chunks} chunks at m={m1} in one "
         f"launch: max_abs_err={e4}; equal to sw_ragged_kernel's lanes")
    del got1, got4, ref4
    b4, b4_by = bound(tiles.numel() + n_chunks * 4 * 32 * m1
                      + 4 * n_rows * V, OPS_PER_CELL * lanes_pos * m1,
                      int_rate)
    phases["full_size_k4_s"] = time.perf_counter() - t

    # kernel 5: the long query's third tile over every chunk, the second
    # tile's outgoing carries in (hc/fc above: the stream's carries are the
    # chunks' carries end to end, so they are sliced like the codes)
    t = time.perf_counter()
    qp5 = qp_l[:, 2 * tm:3 * tm].contiguous()
    spans = np.cumsum([0] + [c.shape[0] * c.shape[1] // jt for c in chunks])
    car = [(hc[a:b].view(c.shape), fc[a:b].view(c.shape))
           for c, a, b in zip(chunks, spans[:-1], spans[1:])]
    got5 = longquery.score_chunks_qtile(
        chunks, qp5, 10, 2, [h.clone() for h, _ in car],
        [f.clone() for _, f in car], table)
    p5_ms, ref5 = timed(
        lambda: [longquery.score_chunk_qtile_ref(c, qp5, 10, 2, h, f)
                 for c, (h, f) in zip(chunks, car)])
    e5 = max(max_err(g[i], r) for i, rs in enumerate(ref5)
             for g, r in zip(got5, rs))
    errs["sw_chunk_qtile_kernel"] = max(errs["sw_chunk_qtile_kernel"], e5)
    note(f"sw_chunk_qtile_kernel vs plain, all {n_chunks} chunks in one "
         f"launch, query tile 2: scores + both carries max_abs_err={e5}")
    del ref5
    k5_ms = cuda_ms(lambda: longquery.score_chunks_qtile(  # in place on
        chunks, qp5, 10, 2, got5[1], got5[2], table),      # those carries
        reps=3)
    del got5
    b5, b5_by = bound(tiles.numel() + 4 * 32 * tm + 48 * n_chunks
                      + 8 * n_rows + 4 * n_rows * V + 16 * lanes_pos,
                      OPS_PER_CELL * lanes_pos * tm, int_rate)
    phases["full_size_k5_s"] = time.perf_counter() - t

    for name, e in errs.items():
        if e != 0:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"(max_abs_err={e})")
    rows = [  # name, source, replaces, ms, plain ms, bound, by, shape
        ("sw_ragged_kernel", "sw_ragged.cu",
         "swimm_tpu/ops/pallas_scorer.py:317", k1_ms, p1_ms, b1, b1_by,
         f"T={T} V={V} m={m1}"),
        ("sw_ragged_qtile_kernel", "sw_ragged.cu",
         "swimm_tpu/ops/longquery.py:208", k2_ms, p2_ms, b2, b2_by,
         f"T={T} V={V} tile_m={m2}"),
        ("sw_ragged_packed_kernel", "sw_ragged.cu",
         "swimm_tpu/ops/pallas_scorer.py:434", k3_ms, p3_ms, b3, b3_by,
         f"T={T} V={V} M={wide.M} queries={len(wide.entries)}"),
        ("sw_chunk_kernel", "sw_chunk.cu",
         "swimm_tpu/ops/pallas_scorer.py:245", k4_ms, p4_ms, b4, b4_by,
         f"{n_chunks} chunks, {n_rows} blocks, V={V} m={m1}; one launch "
         "over all chunks"),
        ("sw_chunk_qtile_kernel", "sw_chunk.cu",
         "swimm_tpu/ops/longquery.py:126", k5_ms, p5_ms, b5, b5_by,
         f"{n_chunks} chunks, {n_rows} blocks, V={V} tile_m={tm}; one "
         "launch over all chunks"),
    ]
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"swimm_tpu_torch/csrc/{src}", "replaces": replaces,
         "launches": launches[name], "max_abs_err": errs[name],
         "exact": True, "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
         "bound_by": by, "library_ms": None, "shape": shape}
        for name, src, replaces, ms, plain_ms, b, by, shape in rows]
    for k in kernels:
        note(f"{k['name']}: {k['ms']:.3f} ms (plain {k['plain_ms']:.1f} ms, "
             f"bound {k['bound_ms']:.3f} ms by {k['bound_by']}), "
             f"{k['launches']} launches on the main path; {k['shape']}")

    def batch(m):
        return {"seconds": m.seconds, "gcups": m.gcups,
                "padded_gcups": m.padded_gcups,
                "per_query_s": m.seconds / N_QUERIES, "timers": m.timers}

    summary = {
        "card": card,
        "db": {"n_seqs": packed.n_seqs, "residues": packed.total_residues,
               "blocks": n_rows, "tiles": T, "chunks": n_chunks},
        "batch20": batch(met),
        "batch20_packed": dict(batch(p_met), packs=len(packs),
                               pack_rows=pack_rows, fill=fill),
        "single_query": {"seconds": one_met.seconds, "gcups": one_met.gcups},
        "batch20_profiled": breakdown,
        "batch20_packed_profiled": p_breakdown,
        "short100": short,
        "long5000": {"seconds": long_met.seconds, "gcups": long_met.gcups,
                     "padded_gcups": long_met.padded_gcups},
        "score_db": {"query0_s": db_short_s, "long5000_s": db_long_s,
                     "chunks": n_chunks},
        "kernel1_tail": k1_tail,
        "phases_s": phases,
        "hits_rescored": n_checked,
        "wall_s": time.perf_counter() - T_START,
    }
    print(json.dumps(summary), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
