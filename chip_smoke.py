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
     512 lanes, flat and free gaps, every case without a ceiling in both
     lane forms (the int32 form and the pair form, 16-bit lane pairs, whose
     plain version is the int32 walk clamped at its limit); then kernel 1's
     16-bit guard through score_tiles: lanes past 32,767 (a matrix with A/A
     1,000; a 1,928-aa W run under PAM250), at or just below T, equal to
     the C oracle with the flagged blocks re-scored in int32 and counted
     exactly, a wrong score from the pair form alone, and the int32 form
     for gaps past the 16-bit bound and for V = 96; more than 512 lanes
     are refused before any launch; for sw_ragged_qtile_kernel, on the
     carry form of its walk, tile_m = 8 to 1024 (1 to 32 strips, tail
     strips, three and four workers), one-tile blocks, 64 to 512 lanes, gaps 10/2, 5/0, 0/3, 0/0,
     random carries in with lanes whose score is their incoming F alone,
     scores and both carries out, and three chained tiles against one pass;
     the same cases in its pair form (16-bit lane pairs, carries packed)
     against its plain version, three chained pair-form tiles against one
     int32 pass, and the 16-bit guard through score_tiles_long: lanes past
     32,767 (a 2,980-aa W run under BLOSUM62; a matrix with A/A 1,000), at
     T - 1 and at T, over several blocks and query tiles, equal to the C
     oracle with the flagged blocks re-scored and counted exactly, a wrong
     score without that pass, and the int32 form for gaps past the 16-bit
     bound and for V = 96); the packed kernel on packs with a planted
     homolog in the query just above another, a one-group query, a pack
     filled to its bucket, a pack with a large unused tail, gap_extend=0
     and gap_open=0,
     and on packs cut to M = 8, 40, 72 and 160 rows (one strip, an 8-row
     tail strip, odd strip counts) with a query that straddles a strip
     boundary and a homolog planted in its rows just above the boundary;
     the chunk kernels at V = 128, 64 and 512, m = 8, 40, 2048, a ceiling,
     m = 2064 in 1024-row tiles, a small tile_m, one query-tile launch with
     random carries, and the list forms of both chunk kernels on separately
     allocated chunks of different B and L in one launch; for
     sw_chunk_qtile_kernel, on the carry form of its walk, the case set of
     sw_ragged_qtile_kernel over lists of chunks (chunks of one to three
     32-position blocks beside a block of 4,480, one launch a tile); then
     all five at the largest gaps accepted (scorer.MAX_GAP: 2^19/2^19,
     0/2^19, 2^19/0) at each path's longest profile, and one past the bound
     refused before any launch; and the two measurement kernels of
     csrc/probe.cu (built with the others, three nvcc at once):
     chain_kernel's three forms (f32, viaddmnmx, vimnmx3) at the TPU's
     (512, 128) tile at loops 0-8 on the JAX function's linspace and on
     integers below 2^24 (the int32 forms also equal to the f32 form), at
     the card-filling 33 tiles and at a size that ends inside a block;
     narrow_kernel in int32, int16x2 and int8x4 at steps 0, 1, 8 and 33 on
     the JAX probe's input, random values of the whole type and values at
     its edges that wrap; last sw_align_kernel (csrc/sw_align.cu, built on
     its first use as a server builds it) against ops.traceback.sw_align
     field by field and the C oracle's score on seeded, homologous and
     tie-heavy pairs (identical, repeats, optima through gaps, one residue,
     empty, score 0) under BLOSUM62, PAM30 and BLOSUM45 at gaps 10/2, 0/3,
     0/0 and 5/0, one launch each, and again under a 2 KB workspace cap
     (several launches, the same alignments) (--kernels-only stops here);
  3. the main path at Swiss-Prot scale: a 570,000-sequence synthetic DB
     (seed 2, homolog_frac 0.0005), 20 queries of 100-500 aa (lengths from
     rng seed 0, synth_queries seed 1), BLOSUM62 10/2, top_k 16 — packed,
     uploaded once, searched once as warm-up, then timed with the kernels'
     launch counters set to 0 just before and read just after, all 20
     launches of kernel 1 in its pair form and none re-scored;
  4. one 5,000-aa query (a query-0 segment inside random sequence) through
     the query-tiled path (5 tiles of 1024 rows), counted the same way, all
     5 in kernel 2's pair form, and none re-scored;
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
     1024-row tiles of the long query, scores and both outgoing carries, in
     kernel 2's int32 form and in its pair form, whose time is kernel 2's
     and the int32 form's beside it; the canonical 5,147- and 5,478-aa
     queries in kernel 2's pair form tile by tile, their last tiles of 32
     and 368 rows against the plain walk from the same carries in, scores
     and both carries out, the whole query equal to score_tiles_long and
     to the int32 form; the canonical batch's 8 queries past 2,048 rows
     through score_tiles_long timed, 36 launches and 8 short last tiles
     (score_tiles_long.short_tiles), beside the same profiles padded with
     PAD_SCORE to whole 1,024-row tiles;
     the widest pack over the whole stream; every chunk at query 0's m in
     one launch, also equal to kernel 1's lanes;
     the long query's third tile over every chunk with the second tile's
     carries in), their times beside their bounds (bound_ms: the nominal
     instruction rate, roofline.peak_instruction_rate, from the card's SM
     count and max clock, at half the instructions a cell for a pair form;
     pipe_bound_ms: the rates phase 19 measures),
     kernel 1's time without
     the 100 longest blocks and on those alone, GCUPS, latencies, profiled
     20-query searches (kernel device time and the device's idle share);
 19. the rates, after phase 8, with every launch counter set to 0 before
     and read after (chain_kernel and narrow_kernel must have launched):
     benchmarks/roofline.report (each chain form's instructions per step
     read from its SASS, its rates at the TPU's tile and filling the card,
     the band of speed-of-light GCUPS, the walk's SASS per cell, kernel 1's
     padded GCUPS at 1,024 and 50,865 tiles and MFU) and
     benchmarks/probe_narrow_int.report (int32 against int16x2 and int8x4);
     every kernel gets a pipe_bound_ms: its own SASS load a cell or step
     (roofline.walk_load) over the measured half-rate pipe and total issue
     (roofline.walk_bound_s), or its bytes; chain_kernel and narrow_kernel
     must not have launched on the main paths of 3-6; both timed at the
     TPU functions' shapes (narrow_kernel at 4,096 steps, where the kernel
     and not its launch takes the time) against their plain versions, and
     bit-exact. Then the roofline and probe JSON
     lines, the summary, a `kernels` JSON line of seven kernels, and the
     device JSON as the last line.
Between 7 and 8, the later paths, each after a warm-up with its own launch
counts (the kernels line keeps counting the main paths of 3-6):
  9. the 20 queries with evalue=True: hits equal the plain batch's; each
     query's device histogram equals np.bincount of its kernel-1 lane
     scores on the host, and every E-value and bit score equals the fit of
     that host table (==);
 10. the 20 queries and the 5,000-aa query with precision='ladder': hits
     equal the exact ones; the tiers' ceilings, blocks per tier and
     launches per kernel printed;
 11. score_db(precision='ladder') for query 0 equal to the exact vector;
     score_chunk_adaptive on the DB's largest chunk equal to its exact
     scores;
 12. 4 queries with the ladder and evalue=True: E-values equal the fit of
     the exact score_db vectors.
Then the streaming posture (db_stream=True) on the phase-3 DB loaded again
with load_db (memmapped chunk files), each run after a warm-up with its
launch counts added to the kernels line (kernels 1 and 2):
 13. the 20 queries at the default window_tiles=8192 (7 windows) under the
     'buffer' and 'candidates' merges, each with and without evalue: hits,
     E-values and bit scores equal the resident search's; one run under
     torch.profiler (device idle share, host-to-device copy ms beside the
     bytes the windows hold); kernel 1's ms on each window for query 0;
 14. the 20 queries at window_tiles=1024 (about 50 windows), both merges,
     equal hits, with the peak device memory the run allocates held under
     a bound from its slots, carries and buffers;
 15. the 5,000-aa query streamed (kernel 2 per query tile per window);
 16. score_db_streaming for query 0 and the 5,000-aa query, equal to
     score_db's vectors; no streaming phase uploads the resident DB.
Then serving (server.py), before phase 8, each step's launches counted
exactly and apart from the kernels line:
 17. a TCP line-protocol server over the phase-3 DB, warmed, with no second
     upload of the resident DB: the 20 queries as 20 one-query requests
     from four client threads (coalesced by the Batcher; hits equal phase
     3's; search dispatches printed; the same traffic again under
     torch.profiler, and three times over with the SM clock and power
     sampled beside three back-to-back searches of the 20), 10 sequential
     one-query requests
     (p50 and max latency), top_k 4 and 100 equal to the prefix of a
     direct search, align and format "m8" for 2 queries at top 2 (aligned
     on the card, equal to sw_align); an HTTP
     server: the 5,000-aa query (kernel 2) equal to phase 4, GET /health
     (timed before and after it) and /info; a streaming server (db_stream=True) on the memmapped DB of
     phases 13-16 equal to the resident hits; the C oracle (ops/cref.py,
     --selfcheck's) over every hit of the 20; one `python -m
     swimm_tpu_torch serve --warm 448` stdio subprocess (two requests equal
     to phase 3, a shutdown, exit 0) and one `info` subprocess.
Then alignments on the card (ops/align.py), before phase 8:
 22. one 16-hit request (phase 3's median query) through align_hits,
     equal to sw_align hit by hit; the 5,478-aa query against 16 subjects
     of 6,000 aa, its m8 rows equal to swbench/align_reference.py's and its
     scores to the C oracle; 64 queries of 6,000 aa with 16 hits of 6,000
     aa each (18 MB of backpointers a pair), one launch per group under
     the workspace cap, every path scoring its DP's maximum, 16 scores
     against the oracle and 4 rows against the plain reference; the
     card's time of each (CUDA events).
Then distribution (parallel/), before phase 8, on the same DBs, each run
after a warm-up with its launches counted exactly:
 18. (a) sharded_search on make_mesh() (one shard per visible card; no
     second upload of the resident stream), the 20 queries and the
     5,000-aa query, hits, ranks, scores and titles equal to phases 3 and
     4, 20 launches of kernel 1 and 5 of kernel 2 per shard, wall time and
     real GCUPS beside the resident batch's; (b) 4 virtual shards on the
     one card (devices=['cuda:0'] * 4) at (4, 1) and (2, 2), split form
     (merge latency apart), equal hits, launches n_data times the one-shard
     count, and kernel 1's ms per shard for query 0 beside the whole
     stream's; (c) kernel 1 on the last shard (the longest blocks, a stream
     that starts mid-chunk) at m=448 against its plain version; (d)
     E-values under (a) and (b) equal to phase 9's; (e)
     search_streaming_sharded on the memmapped DB, 8,192 tiles a span, 4
     virtual shards, equal hits, peak device memory; (f) a one-rank NCCL
     group in this process (global_mesh, global_tile_shards, sharded_search
     with and without E-values through real all_gather_into_tensor and
     all_reduce calls, counted), destroyed after; (g) one `python -m
     swimm_tpu_torch search --sharded --topk-per-shard 64` subprocess,
     exit 0, hits equal phase 3's.
Then the card fuzz (benchmarks/fuzz.py, benchmarks/acceptance.py), before
phase 8, its launches counted apart from the kernels line:
 20. (a) fuzz rounds from seed 0 (a random matrix of 8, gaps 0-20/0-8, a
     query of 1-1,199 or 2,049-3,999 aa, 1-3 blocks of 32-256 positions
     with adversarial lanes, a ceiling of 127 or 32,767), every route a
     round can take (kernels 4 and 1 with its ceiling, or 5 and 2, on the
     blocks as chunks and as a ragged stream, and kernel 2 on a planted
     stream with lanes past 32,767 in both lane forms, and kernel 1 on
     that stream with the query cut to 2,048 residues; kernel 3 on a pack
     of 2-6 new
     queries; the ladder) equal to the C oracle, until all 8 matrices and
     the routes of kernels 1-5 have run (at most 64 rounds); (b)
     acceptance config 1: every lane of score_db over 10,000 sequences
     equal to the C oracle; (c) one fuzz_packed round (3,000 sequences,
     per query against packed, the oracle on a top hit); kernels 1-5 must
     each have launched in the phase, kernels 1 and 2's launches by lane
     form and their re-scored blocks printed (kernel 2: one planted block
     a long round; kernel 1: one a long PAM250 round).
Then the measurement entry points (swimm_tpu_torch.bench and
benchmarks/bench_*.py), before phase 8, on the phase-3 DB and queries,
their launches counted apart from the kernels line:
 21. each module's run() once: bench_serve (a `serve --listen`
     subprocess on the phase-3 DB directory: 3 serial, 4 concurrent, a
     soak of 10; no error, no more dispatches than concurrent requests,
     every reply equal to a direct search) on a thread while the next
     run: bench_kernel at full size (its chained total equal to the plain
     version's chain); bench_serving, bench_longquery (the 5,000-aa
     query), bench_swissprot --quick, bench_evalue and bench_ladder at one
     rep; bench_scaling over 1, 2 and 4 virtual shards; then, the server
     stopped, bench with one rep and the ladder and stream extras (link
     probe keys present, no *_error or *_skipped key) and its three
     headline reps under torch.profiler with kernel 1's device ms on every
     launch (min / median / max for each rep, and a query's spread across
     the reps); every result equal to phases 3-6 and 9; kernels 1-4 must
     each have launched in the phase.
Phase 3 packs the DB through build_db's native route (csrc/swpack.c).

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
N_SEQS = 570_000
N_QUERIES = 20
LONG_LEN = 5000
# the canonical batch's queries past 2,048 padded rows (aa)
CANONICAL_LONG = (2504, 3005, 3564, 4061, 4548, 4743, 5147, 5478)
N_SHORT = 100               # short queries, per query against packed
FUZZ_CAP = 64               # phase 20's most fuzz rounds


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


def kernel1_launches() -> int:
    """sw_ragged_kernel's launches so far, in both lane forms."""
    from swimm_tpu_torch.ops import scorer
    return scorer.score_tiles.launches + scorer.score_tiles.pair_launches


def planted_case(rng, mat, q, planted, n_blocks, L, V=128):
    """n_blocks (L, V) blocks of random lanes of codes 2-19 (1-299 long),
    PAD behind them, planted {(block, lane): codes} laid over them: (tiles
    and outrow on the card, the C oracle's (n_blocks, V) scores of the
    query q under mat at gaps 10/2)."""
    from swimm_tpu_torch.alphabet import PAD_CODE
    from swimm_tpu_torch.ops import cref
    codes = np.full((n_blocks, L, V), PAD_CODE, np.int8)
    for b in range(n_blocks):
        for v in range(V):
            n = int(rng.integers(1, min(300, L)))
            codes[b, :n, v] = rng.integers(2, 20, n)
    for (b, v), x in planted.items():
        codes[b, :, v] = PAD_CODE
        codes[b, :len(x), v] = x
    seqs = [codes[b, :, v][:int(np.argmax(np.append(
        codes[b, :, v], PAD_CODE) == PAD_CODE))].astype(np.uint8)
        for b in range(n_blocks) for v in range(V)]
    exp = cref.sw_score_many(np.asarray(q, np.uint8), seqs, mat, 10,
                             2).reshape(n_blocks, V)
    tiles = torch.from_numpy(codes.reshape(-1, 32, V)).cuda()
    outrow = torch.from_numpy(np.repeat(
        np.arange(n_blocks, dtype=np.int32), L // 32)).cuda()
    return tiles, outrow, exp


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


def compare_qtile_pairs(rng, errs: dict) -> None:
    """sw_ragged_qtile_kernel's pair form against score_qtile_pairs_ref,
    scores and both outgoing carries (lane pairs): tile_m = 8 to 1024,
    blocks of one tile beside long ones, 64 to 512 lanes, gaps 10/2, 5/0,
    0/3 and 0/0, random carries in with lanes whose score is their incoming
    F alone; three chained tiles against one pass; then the 16-bit guard
    through score_tiles_long: lanes past 32,767 (a 2,980-aa W run under
    BLOSUM62), at T - 1 and at T, over several blocks and query tiles,
    equal to the C oracle, the flagged blocks counted exactly, a wrong score
    without the int32 pass, and the int32 form where the pair form does
    not fit."""
    from swimm_tpu_torch.alphabet import ALPHABET
    from swimm_tpu_torch.matrices import get_matrix
    from swimm_tpu_torch.models.profile import build_query_profile
    from swimm_tpu_torch.ops import longquery, scorer
    k2 = "sw_ragged_qtile_kernel"
    lq = longquery
    for counts, V, tile_m, go, ge in (
            ([1, 5, 1, 3], 128, 8, 10, 2), ([1, 4, 2], 128, 32, 5, 0),
            ([2, 1, 6], 128, 40, 0, 3), ([1, 3, 1], 64, 64, 0, 0),
            ([3, 1, 7], 128, 72, 10, 2), ([1, 2, 5], 256, 104, 5, 0),
            ([1, 6, 2], 128, 1024, 10, 2), ([2, 1, 3], 512, 72, 0, 3),
            ([1, 3], 64, 1024, 5, 0), ([1, 2], 256, 1024, 0, 0),
            ([1, 1, 1], 128, 104, 0, 3), ([4, 1], 128, 1024, 0, 3),
            ([2, 3], 512, 1024, 10, 2)):
        tiles, outrow, n_rows = ragged_case(rng, counts, V)
        rs = scorer.row_starts(outrow, n_rows)
        hc, fc, mask, want = random_carries(rng, tiles, rs)
        hc, fc = lq.to_pairs(hc), lq.to_pairs(fc)
        qp = profile(rng, tile_m)
        ref = lq.score_qtile_pairs_ref(tiles, outrow, n_rows, qp, go, ge,
                                       hc, fc)
        got = lq.score_qtile_pairs(tiles, outrow, n_rows, qp, go, ge,
                                   hc.clone(), fc.clone())
        torch.cuda.synchronize()
        if not torch.equal(ref[0][mask], want):
            raise AssertionError(f"{k2} pairs tile_m={tile_m}: the planted F "
                                 "does not give its lanes' scores")
        e = max(max_err(g, r) for g, r in zip(got, ref))
        errs[k2] = max(errs[k2], e)
        note(f"{k2} pair form V={V} tile_m={tile_m} gaps={go}/{ge} blocks "
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
        ref = lq.score_qtile_ref(tiles, outrow, n_rows, qp, go, ge, hc, fc)
        best, h, f = None, lq.to_pairs(hc), lq.to_pairs(fc)
        for qt in range(3):
            out, h, f = lq.score_qtile_pairs(
                tiles, outrow, n_rows,
                qp[:, qt * tile_m:(qt + 1) * tile_m].contiguous(), go, ge, h,
                f)
            best = out if best is None else torch.maximum(best, out)
        torch.cuda.synchronize()
        e = max(max_err(g, r) for g, r in zip(
            (best, lq.from_pairs(h), lq.from_pairs(f)), ref))
        errs[k2] = max(errs[k2], e)
        note(f"{k2} pair form, three chained tiles of {tile_m} rows V={V} "
             f"gaps={go}/{ge} vs one int32 pass of {3 * tile_m}: "
             f"max_abs_err={e}")

    # the 16-bit guard: lanes past 32,767, at T - 1 and at T
    W, C, H = (ALPHABET.index(a) for a in "WCH")
    blosum = get_matrix("BLOSUM62")
    big = blosum.copy()
    big[0, 0], big[1, 1], big[2, 2] = 1000, 100, 1
    cases = [  # (what, matrix, query, {(block, lane): codes}, blocks, L,
        #         tile_m, {(block, lane): score})
        ("BLOSUM62 W run", blosum,
         np.concatenate([rng.integers(2, 20, 40), [C], [W] * 2980, [H],
                         rng.integers(2, 20, 40)]),
         {(0, 1): [W] * 2980, (1, 7): [C] + [W] * 2980 + [H],
          (1, 20): [W] * 2977 + [H], (2, 33): [C] + [W] * 2977},
         3, 3008, 1024, {(0, 1): 32780, (1, 7): 32797, (1, 20): 32755,
                         (2, 33): 32756}),
        ("A/A 1,000", big,
         np.concatenate([[0] * 33, [1] * 7, [2] * 67,
                         rng.integers(3, 20, 30)]),
         {(0, 3): [0] * 33, (1, 40): [0] * 31 + [1] * 7 + [2] * 66,
          (2, 63): [0] * 31 + [1] * 7 + [2] * 67},
         4, 128, 8, {(0, 3): 33000, (1, 40): 31766, (2, 63): 31767})]
    for what, mat, q, planted, n_blocks, L, tile_m, scores in cases:
        V = 128
        tiles, outrow, exp = planted_case(rng, mat, q, planted, n_blocks, L)
        if any(exp[b, v] != sc for (b, v), sc in scores.items()):
            raise AssertionError(f"{what}: planted scores {scores} differ "
                                 "from the oracle")
        q = np.asarray(q, np.uint8)
        qp = torch.from_numpy(build_query_profile(q, mat, 8)).cuda()
        n_rows = n_blocks
        limit = lq.pair_limit(int(qp.max()))
        flagged = int((exp >= limit).any(axis=1).sum())
        before = (lq.score_tiles_long.rescored_blocks,
                  lq.score_qtile_pairs.launches, lq.score_qtile.launches)
        got = lq.score_tiles_long(tiles, outrow, n_rows, qp, 10, 2,
                                  tile_m=tile_m).cpu().numpy()
        counted = (lq.score_tiles_long.rescored_blocks - before[0],
                   lq.score_qtile_pairs.launches - before[1],
                   lq.score_qtile.launches - before[2])
        h = torch.zeros((*tiles.shape[:2], V // 2), dtype=torch.int32,
                        device=tiles.device)
        f = torch.full_like(h, lq.pair_word(-12))
        raw = None
        for qp_tile in lq.tile_profiles(qp, tile_m):   # the pair form alone
            out, h, f = lq.score_qtile_pairs(tiles, outrow, n_rows, qp_tile,
                                             10, 2, h, f)
            raw = out if raw is None else torch.maximum(raw, out)
        raw = raw.cpu().numpy()
        one = scorer.score_tiles_ref(tiles, outrow, n_rows, qp, 10,
                                     2).cpu().numpy()
        n_qt = -(-qp.shape[1] // tile_m)
        low = exp < limit
        e = int(np.abs(got.astype(np.int64) - exp).max())
        errs[k2] = max(errs[k2], e, int(np.abs(one.astype(np.int64)
                                              - exp).max()))
        if counted != (flagged, n_qt, n_qt) or not flagged:
            raise AssertionError(f"{what}: rescored blocks, pair and int32 "
                                 f"launches {counted}, expected "
                                 f"{(flagged, n_qt, n_qt)}")
        if not (np.array_equal(raw[low], exp[low])
                and (raw[~low] >= limit).all() and (raw != exp).any()):
            raise AssertionError(f"{what}: the pair form alone is not exact "
                                 "below T, at least T above it and wrong "
                                 "past 32,767")
        note(f"{k2} 16-bit guard, {what} (T={limit}, lanes "
             f"{sorted(scores.values())}), {n_blocks} blocks x {n_qt} query "
             f"tiles: max_abs_err={e} vs the C oracle; rescored blocks "
             f"{counted[0]} of {flagged} flagged, launches pairs {counted[1]}"
             f" int32 {counted[2]}; without the int32 pass "
             f"{int((raw != exp).sum())} lanes wrong")
    # where the pair form does not fit: gaps past the 16-bit bound, and
    # lanes that fill no whole warp of pairs
    for V, go, ge in ((128, 16000, 385), (96, 10, 2)):
        tiles, outrow, n_rows = ragged_case(rng, [2, 1, 3], V)
        qp = profile(rng, 2064)
        before = lq.score_qtile_pairs.launches
        got = lq.score_tiles_long(tiles, outrow, n_rows, qp, go, ge)
        ref = scorer.score_tiles_ref(tiles, outrow, n_rows, qp, go, ge)
        torch.cuda.synchronize()
        if lq.score_qtile_pairs.launches != before:
            raise AssertionError(f"V={V} gaps {go}/{ge} took the pair form")
        errs[k2] = max(errs[k2], max_err(got, ref))
        note(f"{k2} V={V} gaps {go}/{ge} (the int32 form): max_abs_err="
             f"{max_err(got, ref)}")


def compare_tiles_pairs(rng, errs: dict) -> None:
    """Kernel 1's 16-bit guard through score_tiles (its pair form against
    its plain version: compare_kernels): lanes past 32,767 (a matrix with
    A/A 1,000; a 1,928-aa W run under PAM250, whose W/W of 17 is the only
    match score that passes 32,767 in 2,048 rows), at or above T and just
    below it, over several blocks, equal to the C oracle, the flagged
    blocks re-scored in int32 and counted exactly, the pair form alone
    exact below T, at least T above it and wrong past 32,767; then the
    int32 form where the pair form does not fit."""
    from swimm_tpu_torch.alphabet import ALPHABET
    from swimm_tpu_torch.matrices import get_matrix
    from swimm_tpu_torch.models.profile import build_query_profile
    from swimm_tpu_torch.ops import scorer
    k1 = "sw_ragged_kernel"
    st = scorer.score_tiles
    W = ALPHABET.index("W")
    big = get_matrix("BLOSUM62").copy()
    big[0, 0], big[1, 1], big[2, 2] = 1000, 100, 1
    cases = [  # (what, matrix, query, {(block, lane): codes}, blocks, L,
        #         {(block, lane): score})
        ("A/A 1,000", big,
         np.concatenate([[0] * 33, [1] * 7, [2] * 67,
                         rng.integers(3, 20, 30)]),
         {(0, 3): [0] * 33, (1, 40): [0] * 31 + [1] * 7 + [2] * 66,
          (2, 63): [0] * 31 + [1] * 7 + [2] * 67},
         4, 128, {(0, 3): 33000, (1, 40): 31766, (2, 63): 31767}),
        ("PAM250 W run", get_matrix("PAM250"),
         np.concatenate([rng.integers(2, 20, 20), [W] * 1928,
                         rng.integers(2, 20, 20)]),
         {(0, 1): [W] * 1928, (0, 9): [W] * 1927, (1, 7): [W] * 1926},
         3, 1952, {(0, 1): 32776, (0, 9): 32759, (1, 7): 32742})]
    for what, mat, q, planted, n_blocks, L, scores in cases:
        tiles, outrow, exp = planted_case(rng, mat, q, planted, n_blocks, L)
        if any(exp[b, v] != sc for (b, v), sc in scores.items()):
            raise AssertionError(f"{what}: planted scores {scores} differ "
                                 "from the oracle")
        qp = torch.from_numpy(build_query_profile(np.asarray(q, np.uint8),
                                                  mat, 8)).cuda()
        limit = scorer.pair_limit(int(qp.max()))
        flagged = int((exp >= limit).any(axis=1).sum())
        before = (st.rescored_blocks, st.pair_launches, st.launches)
        got = st(tiles, outrow, n_blocks, qp, 10, 2).cpu().numpy()
        counted = (st.rescored_blocks - before[0],
                   st.pair_launches - before[1], st.launches - before[2])
        raw = scorer._tiles_pairs(tiles, outrow, n_blocks, qp, 10, 2,
                                  None).cpu().numpy()
        low = exp < limit
        e = int(np.abs(got.astype(np.int64) - exp).max())
        errs[k1] = max(errs[k1], e)
        if counted != (flagged, 1, 1) or not 0 < flagged < n_blocks:
            raise AssertionError(f"{what}: rescored blocks, pair and int32 "
                                 f"launches {counted}, expected "
                                 f"{(flagged, 1, 1)}")
        if not (np.array_equal(raw[low], exp[low])
                and (raw[~low] >= limit).all() and (raw != exp).any()):
            raise AssertionError(f"{what}: kernel 1's pair form alone is not "
                                 "exact below T, at least T above it and "
                                 "wrong past 32,767")
        note(f"{k1} 16-bit guard, {what} (T={limit}, lanes "
             f"{sorted(scores.values())}), {n_blocks} blocks: max_abs_err="
             f"{e} vs the C oracle; rescored blocks {counted[0]} of "
             f"{flagged} flagged, launches pairs {counted[1]} int32 "
             f"{counted[2]}; without the int32 pass "
             f"{int((raw != exp).sum())} lanes wrong")
    for V, go, ge in ((128, 16000, 385), (96, 10, 2)):
        tiles, outrow, n_rows = ragged_case(rng, [2, 1, 3], V)
        qp = profile(rng, 448)
        before = st.pair_launches
        got = st(tiles, outrow, n_rows, qp, go, ge)
        ref = scorer.score_tiles_ref(tiles, outrow, n_rows, qp, go, ge)
        torch.cuda.synchronize()
        if st.pair_launches != before:
            raise AssertionError(f"{k1} V={V} gaps {go}/{ge} took the pair "
                                 "form")
        errs[k1] = max(errs[k1], max_err(got, ref))
        note(f"{k1} V={V} gaps {go}/{ge} (the int32 form): max_abs_err="
             f"{max_err(got, ref)}")


def canonical_long_queries(tiles, outrow, n_rows, row_start, m_multiple,
                           errs: dict) -> dict:
    """Kernel 2 on the canonical batch's queries past 2,048 rows (random
    residues, CANONICAL_LONG's lengths) over the whole stream, each cut
    into full 1,024-row tiles and a last tile of the rows left. The two
    longest (last tiles of 32 and 368 rows) in the pair form tile by tile:
    the last tile against the plain walk from the same carries in, scores
    and both carries out; the whole query equal to score_tiles_long and to
    the int32 form. Then all 8 through score_tiles_long, counted (36
    pair-form launches, 8 short tiles, no block scored again) and timed,
    beside the same profiles padded with PAD_SCORE to whole tiles (the
    walk before the cut). Returns the times and counts."""
    from swimm_tpu_torch.alphabet import PAD_SCORE
    from swimm_tpu_torch.models.profile import build_query_profile
    from swimm_tpu_torch.ops import longquery as lq
    from swimm_tpu_torch.ops import scorer
    from swimm_tpu_torch.utils.synth import random_codes
    k2 = "sw_ragged_qtile_kernel"
    tm = lq.LONG_TILE_M
    rng = np.random.default_rng(6)
    host = [torch.from_numpy(build_query_profile(
        random_codes(rng, n), "BLOSUM62", m_multiple))
        for n in CANONICAL_LONG]
    bounds = [scorer.profile_bounds(qp) for qp in host]
    cut = [qp.cuda() for qp in host]
    half = (*tiles.shape[:2], tiles.shape[2] // 2)
    for n, qp, b in list(zip(CANONICAL_LONG, cut, bounds))[-2:]:
        parts = lq.tile_profiles(qp, tm)
        h = torch.zeros(half, dtype=torch.int32, device=tiles.device)
        f = torch.full_like(h, lq.pair_word(-12))
        best = None
        for qp_tile in parts[:-1]:
            out, h, f = lq.score_qtile_pairs(tiles, outrow, n_rows, qp_tile,
                                             10, 2, h, f, row_start)
            best = out if best is None else torch.maximum(best, out)
        h_in, f_in = lq.from_pairs(h), lq.from_pairs(f)
        got = lq.score_qtile_pairs(tiles, outrow, n_rows, parts[-1], 10, 2,
                                   h, f, row_start)
        ref = lq.score_qtile_ref(tiles, outrow, n_rows, parts[-1], 10, 2,
                                 h_in, f_in, row_start)
        del h_in, f_in
        e_last = max(max_err(got[0], ref[0]),
                     max_err(lq.from_pairs(got[1]), ref[1]),
                     max_err(lq.from_pairs(got[2]), ref[2]))
        del ref
        best = torch.maximum(best, got[0])
        whole = lq.score_tiles_long(tiles, outrow, n_rows, qp, 10, 2,
                                    row_start=row_start, bounds=b)
        whole32 = lq.score_tiles_long_int32(tiles, outrow, n_rows, qp, 10, 2,
                                            row_start=row_start)
        e = max(e_last, max_err(whole, best), max_err(whole32, best))
        errs[k2] = max(errs[k2], e)
        top, limit = int(best.max()), lq.pair_limit(int(qp.max()))
        if top >= limit:
            raise AssertionError(f"{n}-aa query: a lane reached {top}, at or "
                                 f"past the pair form's limit {limit}")
        note(f"{k2} pair form, the {n}-aa query ({qp.shape[1]} rows: tiles "
             f"{[p.shape[1] for p in parts]}), whole stream: the last tile "
             f"vs plain from the same carries in, scores + both carries "
             f"max_abs_err={e_last}; the whole query vs score_tiles_long "
             f"and the int32 form max_abs_err={e} (top score {top})")
        del got, best, whole, whole32

    def run(qps):
        for qp, b in zip(qps, bounds):
            lq.score_tiles_long(tiles, outrow, n_rows, qp, 10, 2,
                                row_start=row_start, bounds=b)

    whole_tiles = [torch.cat([qp, torch.full(
        (32, -(-qp.shape[1] // tm) * tm - qp.shape[1]), PAD_SCORE,
        dtype=torch.int32)], dim=1).cuda() for qp in host]
    counts = {}
    for name, qps in (("cut", cut), ("whole_tiles", whole_tiles)):
        before = (lq.score_qtile_pairs.launches, lq.score_qtile.launches,
                  lq.score_tiles_long.short_tiles,
                  lq.score_tiles_long.rescored_blocks)
        run(qps)                                         # warm-up
        torch.cuda.synchronize()
        counts[name] = dict(zip(
            ("pairs", "int32", "short_tiles", "rescored_blocks"),
            (lq.score_qtile_pairs.launches - before[0],
             lq.score_qtile.launches - before[1],
             lq.score_tiles_long.short_tiles - before[2],
             lq.score_tiles_long.rescored_blocks - before[3])))
    want = {"cut": {"pairs": 36, "int32": 0, "short_tiles": 8,
                    "rescored_blocks": 0},
            "whole_tiles": {"pairs": 36, "int32": 0, "short_tiles": 0,
                            "rescored_blocks": 0}}
    if counts != want:
        raise AssertionError(f"kernel 2 on the 8 canonical long queries: "
                             f"{counts}, expected {want}")
    ms = {"cut": [], "whole_tiles": []}
    for _ in range(2):                                   # in turns
        for name, qps in (("cut", cut), ("whole_tiles", whole_tiles)):
            ms[name].append(cuda_ms(lambda: run(qps), reps=1))
    rows = {"cut": sum(qp.shape[1] for qp in cut),
            "whole_tiles": sum(qp.shape[1] for qp in whole_tiles)}
    note(f"{k2} on the canonical batch's 8 queries past 2,048 rows "
         f"({rows['cut']} rows; {rows['whole_tiles']} in whole tiles): "
         f"{ms['cut']} ms cut, {ms['whole_tiles']} ms in whole tiles; "
         f"counts {counts['cut']} (whole tiles {counts['whole_tiles']})")
    return {"ms": ms, "rows": rows, "counts": counts}


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
        # score_tiles takes the pair form where there is no ceiling (every
        # V here is a multiple of 64); the int32 form is checked apart
        got = {"score_tiles": scorer.score_tiles(tiles, outrow, n_rows, qp,
                                                 go, ge, ceiling=ceil)}
        if ceil is None:
            got["int32"] = scorer.score_tiles_int32(tiles, outrow, n_rows,
                                                    qp, go, ge)
        ref = scorer.score_tiles_ref(tiles, outrow, n_rows, qp, go, ge,
                                     ceiling=ceil)
        torch.cuda.synchronize()
        e = {form: max_err(g, ref) for form, g in got.items()}
        errs[k1] = max(errs[k1], *e.values())
        note(f"{k1} V={V} m={m} gaps={go}/{ge} ceiling={ceil}: "
             f"max_abs_err {e}")
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
    compare_qtile_pairs(rng, errs)
    compare_tiles_pairs(rng, errs)


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
    compare_chunk_qtile_carry_form(rng, errs)


def chunk_carries(rng, chunk):
    """random_carries for a (B, L, V) chunk: carries shaped like the chunk,
    the planted F at each block's last position; (hcar, fcar, mask (B, V),
    expected scores)."""
    from swimm_tpu_torch.ops import scorer
    tiles, rs = scorer.chunk_as_stream(chunk)
    hc, fc, mask, want = random_carries(rng, tiles, rs)
    return hc.view(chunk.shape), fc.view(chunk.shape), mask, want


def compare_chunk_qtile_carry_form(rng, errs: dict) -> None:
    """sw_chunk_qtile_kernel (the carry form of the hg walk, over a list of
    chunks in one launch) against score_chunk_qtile_ref chunk by chunk,
    scores and both outgoing carries: tile_m = 8, 32, 40, 64, 72, 104 and
    1024 (1 to 32 strips: one worker, 8-row tail strips, odd strip counts,
    every worker slot filled), chunks of one to three blocks of 32
    positions (shorter than a round of four workers) beside a block of
    4,480, 64 to 512 lanes, gaps 10/2, 5/0, 0/3 and 0/0, random carries in
    with lanes whose score is their incoming F alone; then three chained
    tiles against one pass over their rows. One launch per tile."""
    from swimm_tpu_torch.ops import longquery
    k5 = "sw_chunk_qtile_kernel"
    tail = ((1, 32), (3, 32), (2, 96), (1, 32))
    mixed = ((2, 64), (1, 32), (3, 160), (1, 4480), (4, 96), (2, 32))

    def launch(clist, qp, go, ge, hcs, fcs):
        before = longquery.score_chunks_qtile.launches
        got = longquery.score_chunks_qtile(clist, qp, go, ge, hcs, fcs)
        if longquery.score_chunks_qtile.launches != before + 1:
            raise AssertionError(f"{k5}: a query tile must be one launch")
        return got

    for shapes, V, tile_m, go, ge in (
            (mixed, 128, 8, 10, 2), (tail, 128, 32, 5, 0),
            (tail, 128, 40, 0, 3), (tail, 64, 64, 0, 0),
            (mixed, 128, 72, 10, 2), (tail, 256, 104, 5, 0),
            (mixed, 128, 1024, 10, 2), (tail, 512, 72, 0, 3),
            (tail, 64, 1024, 5, 0), (tail, 256, 1024, 0, 0),
            (((1, 32),) * 3, 128, 104, 0, 3), (mixed, 512, 1024, 0, 0)):
        clist = [chunk_case(rng, B, L, V) for B, L in shapes]
        cars = [chunk_carries(rng, c) for c in clist]
        qp = profile(rng, tile_m)
        got = launch(clist, qp, go, ge, [h.clone() for h, *_ in cars],
                     [f.clone() for _, f, *_ in cars])
        e, planted = 0, 0
        for i, (c, (hc, fc, mask, want)) in enumerate(zip(clist, cars)):
            ref = longquery.score_chunk_qtile_ref(c, qp, go, ge, hc, fc)
            if not torch.equal(ref[0][mask], want):
                raise AssertionError(f"{k5} tile_m={tile_m}: the planted F "
                                     "does not give its lanes' scores")
            e = max([e] + [max_err(g[i], r) for g, r in zip(got, ref)])
            planted += int(mask.sum())
        torch.cuda.synchronize()
        errs[k5] = max(errs[k5], e)
        note(f"{k5} carry form V={V} tile_m={tile_m} gaps={go}/{ge} chunks "
             f"{shapes}, one launch, random carries in (planted F in "
             f"{planted} lanes), scores + carries out: max_abs_err={e}")
    for shapes, V, tile_m, go, ge in ((tail, 128, 40, 10, 2),
                                      (mixed, 128, 104, 0, 3),
                                      (tail, 256, 72, 5, 0),
                                      (tail, 128, 512, 0, 0)):
        clist = [chunk_case(rng, B, L, V) for B, L in shapes]
        cars = [chunk_carries(rng, c)[:2] for c in clist]
        qp = profile(rng, 3 * tile_m)
        best = None
        hcs, fcs = [h.clone() for h, _ in cars], [f.clone() for _, f in cars]
        for qt in range(3):
            outs, hcs, fcs = launch(
                clist, qp[:, qt * tile_m:(qt + 1) * tile_m].contiguous(), go,
                ge, hcs, fcs)
            best = outs if best is None else [torch.maximum(b, o)
                                              for b, o in zip(best, outs)]
        e = 0
        for i, (c, (hc, fc)) in enumerate(zip(clist, cars)):
            ref = longquery.score_chunk_qtile_ref(c, qp, go, ge, hc, fc)
            e = max([e] + [max_err(g, r) for g, r in
                           zip((best[i], hcs[i], fcs[i]), ref)])
        torch.cuda.synchronize()
        errs[k5] = max(errs[k5], e)
        note(f"{k5} three chained tiles of {tile_m} rows V={V} gaps={go}/{ge}"
             f" chunks {shapes} vs one pass of {3 * tile_m}: "
             f"max_abs_err={e}")


def compare_at_gap_bound(errs: dict) -> None:
    """Phase 2, last: all five kernels against their plain versions at the
    largest gaps the package accepts (scorer.MAX_GAP), at each path's
    longest profile (2,048 rows in one pass, 1,024-row query tiles, a
    1,024-row pack), and gaps one past the bound refused before a launch."""
    from swimm_tpu_torch.models import qpack
    from swimm_tpu_torch.ops import longquery, scorer
    from swimm_tpu_torch.utils.synth import random_codes
    rng = np.random.default_rng(9)
    big = scorer.MAX_GAP
    for go, ge in ((big, big), (0, big), (big, 0)):
        tiles, outrow, n_rows = ragged_case(rng, [1, 3, 2])
        qp = profile(rng, 2048)
        e = {"sw_ragged_kernel": max_err(
            scorer.score_tiles(tiles, outrow, n_rows, qp, go, ge),
            scorer.score_tiles_ref(tiles, outrow, n_rows, qp, go, ge))}
        qp_l = profile(rng, 2064)
        e["sw_ragged_qtile_kernel"] = max_err(
            longquery.score_tiles_long(tiles, outrow, n_rows, qp_l, go, ge),
            scorer.score_tiles_ref(tiles, outrow, n_rows, qp_l, go, ge))
        pack, = qpack.build_query_packs(
            [random_codes(rng, n) for n in (500, 300, 150)], buckets=(1024,))
        qp3, seg3 = pack_on_card(pack)
        e["sw_ragged_packed_kernel"] = max_err(
            scorer.score_tiles_packed(tiles, outrow, n_rows, qp3, seg3, go,
                                      ge),
            scorer.score_tiles_packed_ref(tiles, outrow, n_rows, qp3, seg3,
                                          go, ge))
        codes = chunk_case(rng, 3, 96, 128)
        e["sw_chunk_kernel"] = max_err(
            scorer.score_chunk(codes, qp, go, ge),
            scorer.score_chunk_ref(codes, qp, go, ge))
        e["sw_chunk_qtile_kernel"] = max_err(
            longquery.score_chunk_long(codes, qp_l, go, ge),
            scorer.score_chunk_ref(codes, qp_l, go, ge))
        torch.cuda.synchronize()
        for name, err in e.items():
            errs[name] = max(errs[name], err)
        note(f"gaps {go}/{ge} (scorer.MAX_GAP = {big}): max_abs_err {e}")
    tiles, outrow, n_rows = ragged_case(rng, [1])
    for go, ge in ((big + 1, 0), (0, big + 1)):
        before = kernel1_launches()
        try:
            scorer.score_tiles(tiles, outrow, n_rows, profile(rng, 8), go, ge)
        except ValueError as exc:
            note(f"gaps {go}/{ge} refused before a launch: {exc}")
        else:
            raise AssertionError(f"gaps {go}/{ge} must be refused")
        if kernel1_launches() != before:
            raise AssertionError("a refused gap must not launch")


def probe_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest difference of two equal-shaped results, in float64 for the
    f32 chains (max_err truncates to integers) and as integers else."""
    if a.dtype.is_floating_point:
        return float((a.double() - b.double()).abs().max().item())
    return max_err(a, b)


def compare_probe_kernels(errs: dict) -> None:
    """Phase 2: chain_kernel's three forms and narrow_kernel's three lane
    types against their plain versions on the card, bit-exact. P1 at the
    TPU's (512, 128) tile at small loop counts: its own linspace input in
    f32, integers in f32 and int32 (kept below 2^24, where f32 is exact,
    so the three forms must agree with each other too), at loops 0 to 8,
    the card-filling 33 tiles, and a size
    that ends inside a block. P2 at steps 0, 1, 8 and 33: the JAX probe's
    input, every value of int8 and random int16 and int32, values at the
    edges that wrap in int16 and int8 (a + a and a + 120 past the top),
    and sizes of one 32-bit word."""
    from swimm_tpu_torch.benchmarks import probe_narrow_int as pn
    from swimm_tpu_torch.benchmarks import roofline as rl
    rng = np.random.default_rng(13)
    tile = (rl.ROWS, rl.VK)
    ints = [torch.from_numpy(rng.integers(-3000, 3000, tile, dtype=np.int32)),
            torch.from_numpy(rng.integers((1 << 24) - 20_000,
                                          (1 << 24) - 9_000, tile,
                                          dtype=np.int32))]
    cases = [("f32", rl.chain_input("f32", 1, "cuda"), loops)
             for loops in (1, 3, 8)]
    for x in ints:
        for loops in (0, 1, 3, 8):
            cases += [("f32", x.float().cuda(), loops),
                      ("viaddmnmx", x.cuda(), loops),
                      ("vimnmx3", x.cuda(), loops)]
    fill = rl.card_filling_tiles(torch.device("cuda"))
    for form in rl.FORMS:
        cases += [(form, rl.chain_input(form, fill, "cuda"), 1),
                  (form, rl.chain_input(form, 1, "cuda").view(-1)[:1000]
                   .contiguous(), 2)]
    err = 0.0
    for form, x, loops in cases:
        got = rl.chains(x, loops, form)
        err = max(err, probe_err(got, rl.chains_ref(x, loops, form)))
        if x.shape == tile and x.dtype == torch.int32:
            same = rl.chains(x.float(), loops, "f32")
            err = max(err, probe_err(got.float(), same))
    torch.cuda.synchronize()
    errs["chain_kernel"] = max(errs["chain_kernel"], err)
    note(f"chain_kernel, 3 forms, {len(cases)} cases vs plain (and the "
         f"int32 forms vs f32): max_abs_err={err}")

    edges = {torch.int32: [(1 << 31) - 1, -(1 << 31), (1 << 30), -(1 << 30),
                           (1 << 30) - 1, 1_073_741_000, 1000, -1000, 0, 7],
             torch.int16: [32_767, -32_768, 32_766, -32_767, 16_384, 16_383,
                           -16_385, 20_000, 32_647, 32_648, 120, -120],
             torch.int8: [127, -128, 126, -127, 120, 8, 7, 64, 63, -64, 0,
                          -120]}
    full = {torch.int32: (-(1 << 31), 1 << 31, 1),   # (lo, hi, lanes a word)
            torch.int16: (-32_768, 32_768, 2), torch.int8: (-128, 128, 4)}
    err, n = 0, 0
    for dt, (lo, hi, lanes) in full.items():
        xs = [pn.probe_input(dt, pn.SHAPE, "cuda"),
              torch.from_numpy(rng.integers(lo, hi, pn.SHAPE)).to(dt).cuda(),
              torch.tensor(edges[dt] * 4, dtype=dt).cuda(),
              torch.tensor(edges[dt][:lanes], dtype=dt).cuda()]
        if dt == torch.int8:
            xs.append(torch.arange(-128, 128, dtype=dt).cuda())
        for x in xs:
            for steps in (0, 1, 8, 33):
                err = max(err, probe_err(pn.narrow(x, steps),
                                         pn.narrow_ref(x, steps)))
                n += 1
    torch.cuda.synchronize()
    errs["narrow_kernel"] = max(errs["narrow_kernel"], err)
    note(f"narrow_kernel, int32 / int16x2 / int8x4, {n} cases vs plain "
         f"(wrapping at the edges): max_abs_err={err}")


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


def device_breakdown(fn, launches_of: str | None = None) -> dict:
    """Wall time of fn() under torch.profiler, the device time of its CUDA
    kernels (ours vs the rest, host-to-device copies among the rest and
    also apart), and the device's idle share of the wall. Device numbers
    read "not measured" when the trace holds no device time. With
    launches_of, also "launch_ms": the device ms of every launch of the
    kernels whose name holds it, in the order they started."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t) * 1e3
    ours = other = h2d = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = ev.self_device_time_total
        if "sw_ragged" in ev.key or "sw_chunk" in ev.key:
            ours += us / 1e3
        else:
            other += us / 1e3
        if "HtoD" in ev.key:
            h2d += us / 1e3
    if ours + other == 0:
        return {"wall_ms": wall_ms, "kernel_ms": "not measured",
                "other_device_ms": "not measured", "h2d_ms": "not measured",
                "idle_share": "not measured"}
    out = {"wall_ms": wall_ms, "kernel_ms": ours, "other_device_ms": other,
           "h2d_ms": h2d, "idle_share": 1 - (ours + other) / wall_ms}
    if launches_of is not None:
        out["launch_ms"] = [e.time_range.elapsed_us() / 1e3 for e in sorted(
            (e for e in prof.events() if e.device_type == DeviceType.CUDA
             and launches_of in e.name), key=lambda e: e.time_range.start)]
    return out


def sampled(fn):
    """(fn(), the card's SM clock and power draw while it ran): nvidia-smi
    polled on a thread, one reading after another, until fn returns."""
    import threading
    readings, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            row = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, check=True).stdout.split(",")
            readings.append((float(row[0]), float(row[1])))

    th = threading.Thread(target=poll, daemon=True)
    th.start()
    try:
        res = fn()
    finally:
        stop.set()
        th.join(timeout=30)
    if not readings:
        return res, {"sm_mhz": "not measured", "power_w": "not measured",
                     "readings": 0}
    return res, {"sm_mhz": float(np.mean([r[0] for r in readings])),
                 "sm_mhz_min": min(r[0] for r in readings),
                 "power_w": float(np.mean([r[1] for r in readings])),
                 "power_w_max": max(r[1] for r in readings),
                 "readings": len(readings)}


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


def later_paths(packed, dev_db, queries, results, long_q, long_res, met,
                long_met, vec0, config, counted) -> dict:
    """Phases 9-12, E-values and the precision ladder: each path driven
    once after a warm-up, its launch counters set to 0 just before and read
    just after (kept apart from the kernels line, which counts the main
    paths of phases 3-6), its time beside the exact path's, and its results
    held exactly against the exact path's. Returns the numbers and phase
    times."""
    from dataclasses import replace

    from swimm_tpu_torch.models import engine
    from swimm_tpu_torch.models.engine import SearchConfig, score_db, search
    from swimm_tpu_torch.models.profile import build_query_profile
    from swimm_tpu_torch.ops import ladder, longquery, scorer
    from swimm_tpu_torch.ops.lanes import Profile
    from swimm_tpu_torch.ops.lanes import score as score_lanes
    from swimm_tpu_torch.utils import stats
    out, phases = {}, {}

    def qprof(q):
        return torch.from_numpy(build_query_profile(
            q.codes, config.matrix, config.m_multiple)).cuda()

    def same_evalues(hits, model):
        exp = [replace(h) for h in hits]
        stats.attach_evalues(exp, model, packed.lengths)
        return ([(h.evalue, h.bits) for h in hits]
                == [(h.evalue, h.bits) for h in exp])

    # ---- phase 9: the 20-query batch with E-values ----
    t = time.perf_counter()
    econfig = SearchConfig(top_k=16, evalue=True)
    search(packed, queries, econfig)                     # warm-up
    (e_res, e_met), seen = counted(
        lambda: search(packed, queries, econfig), main=False)
    if seen["sw_ragged_kernel"] != N_QUERIES or sum(seen.values()) != \
            N_QUERIES:
        raise AssertionError(f"E-value batch: expected {N_QUERIES} launches "
                             f"of sw_ragged_kernel and no other, got {seen}")
    if not same_hits(e_res, results):
        raise AssertionError("E-value batch: hits differ from the plain "
                             "batch's")
    mask, lane_bins = dev_db[4], engine.device_lane_bins(packed)
    valid = mask.cpu().numpy()
    bins = lane_bins.cpu().numpy()[valid].astype(np.int64)
    width = stats.SCORE_CAP + 1
    _, bin_logl = stats.length_bins(packed.lengths)
    for q, r in zip(queries, e_res):
        lanes = score_lanes(dev_db[:4], Profile.build(q, config, "cuda"),
                            config.gap_open, config.gap_extend)
        table = engine.score_hist(lanes, mask, lane_bins).cpu().numpy()
        host = np.bincount(
            bins * width + np.clip(lanes.cpu().numpy()[valid], 0,
                                   stats.SCORE_CAP),
            minlength=stats.N_LEN_BINS * width).reshape(-1, width)
        if not np.array_equal(table, host):
            raise AssertionError(f"{q.title}: the device histogram differs "
                                 "from np.bincount of the lane scores")
        if not same_evalues(r.hits, stats.fit_evalue_model_hist(host,
                                                                bin_logl)):
            raise AssertionError(f"{q.title}: E-values differ from the fit "
                                 "of the host table")
    out["e_res"] = e_res                 # phase 18's E-value reference
    out["evalue20"] = {"seconds": e_met.seconds,
                       "plain_seconds": met.seconds,
                       "overhead": e_met.seconds / met.seconds - 1,
                       "launches": seen, "profiled": device_breakdown(
                           lambda: search(packed, queries, econfig))}
    note(f"20-query search with E-values: {e_met.seconds:.3f} s (plain "
         f"batch {met.seconds:.3f} s, {out['evalue20']['overhead']:+.1%}), "
         f"launches {seen}; hits equal the plain batch's, every device "
         "table equals np.bincount of its lane scores, every E-value and "
         "bit score equals the fit of that table; under torch.profiler: "
         f"{out['evalue20']['profiled']}")
    phases["evalue20_s"] = time.perf_counter() - t

    # ---- phase 10: the ladder batch (20 queries + the 5,000-aa query) ----
    t = time.perf_counter()
    lconfig = SearchConfig(top_k=16, precision="ladder")
    batch = queries + [long_q]
    search(packed, batch, lconfig)                       # warm-up
    (l_res, l_met), seen = counted(
        lambda: search(packed, batch, lconfig), main=False)
    n_qt = -(-engine._m_pad(long_q.length, config.m_multiple)
             // longquery.LONG_TILE_M)
    if (seen["sw_ragged_kernel"] < N_QUERIES
            or seen["sw_chunk_qtile_kernel"] != n_qt):
        raise AssertionError(f"ladder batch: expected >= {N_QUERIES} tier "
                             f"launches and {n_qt} long-query launches, got "
                             f"{seen}")
    if not same_hits(l_res, results + long_res):
        raise AssertionError("ladder batch: hits differ from the exact "
                             "search's")
    # the tiers' block counts: the serving call the batch made, again
    group_list = [(np.stack([build_query_profile(
        queries[p].codes, config.matrix, config.m_multiple)
        for p in positions]), [queries[p].length for p in positions])
        for positions in engine.group_by_m_pad(
            queries, config.m_multiple).values()]
    t1 = time.perf_counter()
    (_, tier_stats), tier_seen = counted(
        lambda: ladder.topk_db_adaptive_serving(
            packed, group_list, 16, config.gap_open, config.gap_extend,
            dev_db=dev_db), main=False)
    tiers_s = time.perf_counter() - t1
    out["ladder21"] = {"seconds": l_met.seconds,
                       "exact_seconds": met.seconds + long_met.seconds,
                       "launches": seen, "tiers_20_seconds": tiers_s,
                       "tiers_20_launches": tier_seen, **tier_stats,
                       "tiers_20_profiled": device_breakdown(
                           lambda: ladder.topk_db_adaptive_serving(
                               packed, group_list, 16, config.gap_open,
                               config.gap_extend, dev_db=dev_db))}
    note(f"ladder batch (20 queries + the {LONG_LEN}-aa query): "
         f"{l_met.seconds:.3f} s (exact: {met.seconds:.3f} + "
         f"{long_met.seconds:.3f} s), launches {seen}; hits equal the exact "
         f"ones. Tiers of the 20: ceilings {tier_stats['tier_ceilings']}, "
         f"blocks per tier {tier_stats['tier_blocks']}, {tiers_s:.3f} s, "
         f"launches {tier_seen}; under torch.profiler: "
         f"{out['ladder21']['tiers_20_profiled']}")
    phases["ladder21_s"] = time.perf_counter() - t

    # ---- phase 11: score_db with the ladder, and score_chunk_adaptive ----
    t = time.perf_counter()
    score_db(packed, queries[0], lconfig)                # warm-up
    t1 = time.perf_counter()
    lvec, seen = counted(lambda: score_db(packed, queries[0], lconfig),
                         main=False)
    db_s = time.perf_counter() - t1
    if not np.array_equal(lvec, vec0) or seen["sw_ragged_kernel"] < 1:
        raise AssertionError(f"score_db(precision='ladder') for query 0 "
                             f"differs from the exact vector (launches "
                             f"{seen})")
    chunks, _ = engine.device_chunk_table(packed)
    big = max(chunks, key=lambda c: c.numel())
    qp0 = qprof(queries[0])
    (csc, cst), c_seen = counted(lambda: ladder.score_chunk_adaptive(
        big, qp0, config.gap_open, config.gap_extend, upper_bound=(
            ladder.max_possible_score(queries[0].length, big.shape[1]))),
        main=False)
    if not np.array_equal(csc, scorer.score_chunk(
            big, qp0, config.gap_open, config.gap_extend).cpu().numpy()) \
            or c_seen["sw_chunk_kernel"] < 1:
        raise AssertionError("score_chunk_adaptive differs from the exact "
                             f"chunk scores (launches {c_seen})")
    out["score_db_ladder"] = {"query0_s": db_s, "launches": seen,
                              "chunk_adaptive": {**cst, "shape": list(
                                  big.shape), "launches": c_seen}}
    note(f"score_db(precision='ladder') for query 0: {db_s:.3f} s, "
         f"launches {seen}, equal to the exact vector; "
         f"score_chunk_adaptive on the largest chunk {tuple(big.shape)}: "
         f"{cst}, launches {c_seen}, equal to the exact chunk scores")
    phases["score_db_ladder_s"] = time.perf_counter() - t

    # ---- phase 12: the ladder with E-values (full-vector fits) ----
    t = time.perf_counter()
    leconfig = SearchConfig(top_k=16, precision="ladder", evalue=True)
    four = queries[:4]
    search(packed, four, leconfig)                       # warm-up
    (le_res, le_met), seen = counted(
        lambda: search(packed, four, leconfig), main=False)
    if not same_hits(le_res, results[:4]) or seen["sw_ragged_kernel"] < 4:
        raise AssertionError(f"ladder with E-values: hits differ from the "
                             f"exact search's (launches {seen})")
    fit_s = []
    for q, r in zip(four, le_res):
        svec = score_db(packed, q, config)
        t1 = time.perf_counter()
        model = stats.fit_evalue_model(svec, packed.lengths)
        fit_s.append(time.perf_counter() - t1)
        if not same_evalues(r.hits, model):
            raise AssertionError(f"{q.title}: ladder E-values differ from "
                                 "the fit of the exact score_db vector")
    out["ladder_evalue4"] = {"seconds": le_met.seconds, "launches": seen,
                             "plain_seconds_4": met.seconds * 4 / N_QUERIES,
                             "host_fit_seconds": fit_s}
    note(f"4 queries, ladder with E-values: {le_met.seconds:.3f} s "
         f"(plain batch: {met.seconds * 4 / N_QUERIES:.3f} s for 4), "
         f"launches {seen}; E-values equal the fit of the exact score_db "
         f"vectors; that fit alone takes {sum(fit_s) / len(fit_s):.3f} s a "
         "query on the host")
    phases["ladder_evalue4_s"] = time.perf_counter() - t
    out["phases_s"] = phases
    return out


def same_evalues_of(a, b) -> bool:
    return ([[(h.evalue, h.bits) for h in r.hits] for r in a]
            == [[(h.evalue, h.bits) for h in r.hits] for r in b])


def window_kernel_ms(dev_db, spans, cum, qp) -> list:
    """Kernel 1's device ms on each window of a plan, at its fill, over the
    resident stream's tiles (the same codes the streamed window holds)."""
    from swimm_tpu_torch.ops import scorer
    tiles, outrow = dev_db[:2]
    bounds = scorer.profile_bounds(qp)
    out = []
    for g0, g1 in spans:
        t0, t1 = int(cum[g0]), int(cum[g1])
        rs = torch.from_numpy(cum[g0:g1 + 1] - t0).cuda()
        orow = (outrow[t0:t1] - g0).contiguous()
        out.append(cuda_ms(lambda: scorer.score_tiles(
            tiles[t0:t1], orow, g1 - g0, qp, 10, 2, row_start=rs,
            bounds=bounds)))
    return out


def stream_paths(db_dir, packed, dev_db, queries, results, long_q, long_res,
                 met, long_met, vec, vec_l, config, counted) -> dict:
    """Phases 13-16, the streaming posture (db_stream=True) on the phase-3
    DB loaded again with load_db (memmapped chunk files; windows read with
    readinto into pinned slots). Every search is driven once after a
    warm-up with the launch counters set to 0 just before and read just
    after; its launches count on the kernels line (kernels 1 and 2). Every
    result is held exactly against the resident one: hits, E-values and
    bit scores; score_db_streaming against score_db's vectors. Returns the
    numbers and phase times."""
    from swimm_tpu_torch.db import load_db
    from swimm_tpu_torch.models import engine, stream
    from swimm_tpu_torch.models.engine import (SearchConfig,
                                               score_db_streaming, search)
    from swimm_tpu_torch.ops import longquery
    from swimm_tpu_torch.ops.lanes import Profile
    from swimm_tpu_torch.ops.lanes import score as score_lanes
    out, phases = {}, {}
    spacked = load_db(db_dir)
    if not isinstance(spacked.chunks[0].codes, np.memmap):
        raise AssertionError("load_db did not memmap the chunk files")
    layout = stream.stream_layout(spacked)
    cum, V, jt = layout["cum"], layout["V"], layout["jt"]
    prof0 = Profile.build(queries[0], config, "cuda")
    qp0 = prof0.qp

    def plan(wt):
        spans, r_cap = stream.plan_windows(layout, wt)
        return spans, r_cap, stream.effective_window_tiles(layout, spans)

    def h2d_bytes(spans):   # codes, local rows, row starts of each window
        return sum(int(cum[g1] - cum[g0]) * (jt * V + 4) + 8 * (g1 - g0 + 1)
                   for g0, g1 in spans)

    def expect(seen, k1, k2=0):
        want = dict.fromkeys(seen, 0)
        want.update(sw_ragged_kernel=k1, sw_ragged_qtile_kernel=k2)
        if seen != want:
            raise AssertionError(f"expected launches {want}, got {seen}")

    # ---- phase 13: the 20 queries at 8,192 tiles, both merges, E-values --
    t = time.perf_counter()
    spans, r_cap, wt = plan(8192)
    n_win = len(spans)
    e_res, e_met = search(packed, queries, SearchConfig(top_k=16,
                                                        evalue=True))
    search(spacked, queries, SearchConfig(top_k=16, db_stream=True))
    runs = {}
    for merge in ("buffer", "candidates"):
        for ev in (False, True):
            cfg = SearchConfig(top_k=16, db_stream=True, stream_scores=merge,
                               evalue=ev)
            (res, m), seen = counted(lambda: search(spacked, queries, cfg))
            expect(seen, n_win * N_QUERIES)
            if not same_hits(res, e_res if ev else results) or (
                    ev and not same_evalues_of(res, e_res)):
                raise AssertionError(f"streamed {N_QUERIES} queries ({merge}, "
                                     f"evalue={ev}) differ from resident")
            resident_s = e_met.seconds if ev else met.seconds
            runs[f"{merge}{'_evalue' if ev else ''}"] = {
                "seconds": m.seconds, "resident_seconds": resident_s,
                "ratio": m.seconds / resident_s, "gcups": m.gcups,
                "padded_gcups": m.padded_gcups, "launches": seen}
            note(f"streamed {N_QUERIES} queries, {n_win} windows of <= 8192 "
                 f"tiles, {merge}, evalue={ev}: {m.seconds:.3f} s (resident "
                 f"{resident_s:.3f} s, x{m.seconds / resident_s:.3f}), "
                 f"{m.gcups:.1f} real GCUPS, launches {seen}; hits"
                 f"{', E-values and bit scores' if ev else ''} equal the "
                 "resident search's")
    sconfig = SearchConfig(top_k=16, db_stream=True)
    prof = device_breakdown(lambda: search(spacked, queries, sconfig))
    win_ms = window_kernel_ms(dev_db, spans, cum, qp0)
    whole_ms = cuda_ms(lambda: score_lanes(dev_db[:4], prof0,
                                           config.gap_open,
                                           config.gap_extend))
    out["batch20_8192"] = {
        "windows": n_win, "width_tiles": wt, "r_cap": r_cap,
        "runs": runs, "profiled": prof, "h2d_bytes": h2d_bytes(spans),
        "query0_kernel_ms_per_window": win_ms,
        "query0_kernel_ms_windows_sum": sum(win_ms),
        "query0_kernel_ms_whole_stream": whole_ms}
    note(f"streamed {N_QUERIES}-query batch under torch.profiler: {prof}; "
         f"host-to-device {h2d_bytes(spans)} bytes")
    note(f"kernel 1, query 0 (m={qp0.shape[1]}), per window of <= 8192 "
         f"tiles: {[round(x, 3) for x in win_ms]} ms, sum {sum(win_ms):.3f}"
         f" ms against {whole_ms:.3f} ms over the whole stream")
    phases["stream20_8192_s"] = time.perf_counter() - t

    # ---- phase 14: 1,024-tile windows, peak device memory ----
    t = time.perf_counter()
    spans1, r_cap1, wt1 = plan(1024)
    depth = sconfig.max_in_flight
    lanes = layout["n_rows"] * V
    m_max = max(engine._m_pad(q.length, config.m_multiple) for q in queries)
    bound = (depth * (wt1 * jt * V + 4 * wt1 + 8 * (r_cap1 + 1))  # ring
             + 4 * 32 * m_max * N_QUERIES                   # profiles
             + 13 * lanes                                   # lane maps
             + 4 * N_QUERIES * lanes                        # score buffer
             + 8 * wt1 * jt * V                             # strip carry
             + 40 * r_cap1 * V                              # out + keys
             + 40 * lanes)                                  # finalize
    resident_need = engine.device_bytes_needed(packed)
    one = {}
    for merge in ("buffer", "candidates"):
        cfg = SearchConfig(top_k=16, db_stream=True, window_tiles=1024,
                           stream_scores=merge)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (res, m), seen = counted(lambda: search(spacked, queries, cfg))
        peak = torch.cuda.max_memory_allocated() - base
        expect(seen, len(spans1) * N_QUERIES)
        if not same_hits(res, results):
            raise AssertionError(f"streamed {N_QUERIES} queries at 1,024 "
                                 f"tiles ({merge}) differ from resident")
        if peak > bound:
            raise AssertionError(f"1,024-tile stream ({merge}): peak device "
                                 f"memory {peak} bytes over its bound "
                                 f"{bound}")
        one[merge] = {"seconds": m.seconds, "gcups": m.gcups,
                      "launches": seen, "peak_bytes": peak}
        note(f"streamed {N_QUERIES} queries, {len(spans1)} windows of <= 1024 "
             f"tiles, {merge}: {m.seconds:.3f} s, {m.gcups:.1f} real GCUPS, "
             f"launches {seen}, hits equal; peak device memory {peak} bytes "
             f"(bound {bound}; resident footprint {resident_need})")
    win1_ms = window_kernel_ms(dev_db, spans1, cum, qp0)
    out["batch20_1024"] = {"windows": len(spans1), "width_tiles": wt1,
                           "runs": one, "peak_bound_bytes": bound,
                           "resident_bytes_needed": resident_need,
                           "query0_kernel_ms_windows_sum": sum(win1_ms),
                           "query0_kernel_ms_max_window": max(win1_ms)}
    note(f"kernel 1, query 0, {len(spans1)} windows of <= 1024 tiles: sum "
         f"{sum(win1_ms):.3f} ms, longest window {max(win1_ms):.3f} ms")
    phases["stream20_1024_s"] = time.perf_counter() - t

    # ---- phase 15: the 5,000-aa query streamed (kernel 2) ----
    t = time.perf_counter()
    n_qt = -(-engine._m_pad(long_q.length, config.m_multiple)
             // longquery.LONG_TILE_M)
    search(spacked, [long_q], sconfig)                   # warm-up
    (l_res, l_met), seen = counted(lambda: search(spacked, [long_q],
                                                  sconfig))
    expect(seen, 0, n_win * n_qt)
    if not same_hits(l_res, long_res):
        raise AssertionError("streamed 5,000-aa query differs from resident")
    out["long5000"] = {"seconds": l_met.seconds,
                       "resident_seconds": long_met.seconds,
                       "gcups": l_met.gcups, "launches": seen}
    note(f"streamed {LONG_LEN}-aa query: {l_met.seconds:.3f} s (resident "
         f"{long_met.seconds:.3f} s), {l_met.gcups:.1f} real GCUPS, launches"
         f" {seen}; hits equal")
    phases["stream_long_s"] = time.perf_counter() - t

    # ---- phase 16: score_db_streaming for query 0 and the long query ----
    t = time.perf_counter()
    db_s = {}
    for name, q, want, k1, k2 in (("query0", queries[0], vec, n_win, 0),
                                  ("long5000", long_q, vec_l, 0,
                                   n_win * n_qt)):
        score_db_streaming(spacked, q, config)           # warm-up
        t1 = time.perf_counter()
        got, seen = counted(lambda: score_db_streaming(spacked, q, config))
        db_s[name] = {"seconds": time.perf_counter() - t1, "launches": seen}
        expect(seen, k1, k2)
        if not np.array_equal(got, want):
            raise AssertionError(f"score_db_streaming({name}) differs from "
                                 "score_db")
    # the host side alone: every window read from the chunk files into
    # pinned slots, no copy, no launch
    slots = stream.WindowSlots(2, wt, jt, V, r_cap, pin=True)
    t1 = time.perf_counter()
    for s, *_ in stream.iter_windows(spacked, 8192, slots):
        slots.release(s)
    db_s["host_reads_s"] = time.perf_counter() - t1
    out["score_db_streaming"] = db_s
    note(f"score_db_streaming: {db_s}; both vectors equal score_db's; "
         f"reading the {n_win} windows into pinned slots alone took "
         f"{db_s['host_reads_s']:.3f} s ({h2d_bytes(spans) / 1e9:.3f} GB)")
    phases["stream_score_db_s"] = time.perf_counter() - t
    if spacked in engine._DEVICE_TILE_CACHE:
        raise AssertionError("a streaming phase uploaded the resident DB")
    out["phases_s"] = phases
    out["spacked"] = spacked          # phase 17's streaming server
    return out


def serving_paths(db_dir, packed, spacked, queries, results, long_q,
                  long_res, n_win, config, counted) -> dict:
    """Phase 17, serving (server.py) on the phase-3 DB, which is resident
    already: the server must not upload it again. TCP line protocol (20
    one-query requests from four client threads, coalesced by the
    Batcher; 10 sequential requests for latency; top_k 4 and 100; align
    and m8), HTTP (the 5,000-aa query, /health, /info), a streaming
    server on the memmapped DB of phases 13-16, the C oracle over every
    hit of the 20 (--selfcheck's), and one `serve` stdio subprocess and
    one `info` subprocess. Each step's launches are counted apart from
    the main paths and checked exactly. Returns the numbers and the
    phase time."""
    import socket
    import threading
    import urllib.request
    from dataclasses import replace

    from swimm_tpu_torch.alphabet import decode
    from swimm_tpu_torch.matrices import get_matrix
    from swimm_tpu_torch.models import engine
    from swimm_tpu_torch.models.engine import search
    from swimm_tpu_torch.ops import cref, longquery
    from swimm_tpu_torch.server import (SearchServer, make_http_server,
                                        make_socket_server)
    t_phase = time.perf_counter()
    out = {"launches": {}}
    repo = Path(__file__).resolve().parent
    resident = engine._DEVICE_TILE_CACHE[packed]["cuda"]
    mem0 = torch.cuda.memory_allocated()

    def qreq(q, **extra):
        return {"queries": [{"title": q.title, "seq": decode(q.codes)}],
                **extra}

    def hits_of(r):
        return [(h["rank"], h["score"], h["title"]) for h in r["hits"]]

    def want(r):
        return [(h.rank, h.score, h.title) for h in r.hits]

    def step(name, fn, k1, k2=0):
        res, seen = counted(fn, main=False)
        exp = dict.fromkeys(seen, 0)
        exp.update(sw_ragged_kernel=k1, sw_ragged_qtile_kernel=k2)
        if seen != exp:
            raise AssertionError(f"serving {name}: expected launches {exp}, "
                                 f"got {seen}")
        out["launches"][name] = seen
        return res

    def lines(port, reqs, lat=None):
        with socket.create_connection(("127.0.0.1", port), timeout=300) as c:
            f = c.makefile("rw", encoding="utf-8")
            got = []
            for r in reqs:
                t = time.perf_counter()
                f.write(json.dumps(r) + "\n")
                f.flush()
                got.append(json.loads(f.readline()))
                if lat is not None:
                    lat.append(time.perf_counter() - t)
                if "error" in got[-1]:
                    raise AssertionError(f"server error: {got[-1]}")
            return got

    # ---- TCP line protocol over the resident DB ----
    Server, Handler, srv, batcher = make_socket_server(packed, config)
    warm_s = srv._warm([448])
    tcp = Server(("127.0.0.1", 0), Handler)
    port = tcp.server_address[1]
    th = threading.Thread(target=tcp.serve_forever,
                          kwargs={"poll_interval": 0.05}, daemon=True)
    th.start()
    try:
        # 20 one-query requests from four client threads, five each
        got = [None] * N_QUERIES
        errors = []

        def client(c):
            try:
                idx = list(range(c, N_QUERIES, 4))
                for i, r in zip(idx, lines(port, [qreq(queries[i])
                                                  for i in idx])):
                    got[i] = r
            except Exception as e:   # re-raised below, on this thread
                errors.append(e)

        def twenty():
            ts = [threading.Thread(target=client, args=(c,))
                  for c in range(4)]
            t = time.perf_counter()
            for x in ts:
                x.start()
            for x in ts:
                x.join(timeout=300)
            if errors or any(x.is_alive() for x in ts):
                raise AssertionError(f"a client failed: {errors}")
            return time.perf_counter() - t

        d0 = batcher.n_dispatches
        wall20 = step("tcp_20_requests_4_clients", twenty, N_QUERIES)
        n_disp = batcher.n_dispatches - d0
        for i, r in enumerate(got):
            if hits_of(r["results"][0]) != want(results[i]):
                raise AssertionError(f"served query {i} differs from the "
                                     "phase-3 search")
        out["tcp_20"] = {"wall_s": wall20, "dispatches": n_disp,
                         "requests_per_s": N_QUERIES / wall20}
        note(f"serving: {N_QUERIES} one-query requests from 4 clients in "
             f"{wall20:.3f} s, {n_disp} search dispatches; every response "
             "equals the phase-3 hits")
        # the same traffic again under torch.profiler: the device's
        # kernel time and idle share while serving (launches not counted)
        got = [None] * N_QUERIES
        out["tcp_20_profiled"] = device_breakdown(twenty)
        if [hits_of(r["results"][0]) for r in got] != [want(r)
                                                       for r in results]:
            raise AssertionError("profiled serving run differs")
        note(f"serving, the 20 requests under torch.profiler: "
             f"{out['tcp_20_profiled']}")
        # the SM clock and power draw while serving (idle gaps between
        # dispatches) against the same 20 searched back to back, each
        # three times over
        _, back = sampled(lambda: [search(packed, queries, config)
                                   for _ in range(3)])
        got = [None] * N_QUERIES
        _, served = sampled(lambda: [twenty() for _ in range(3)])
        if [hits_of(r["results"][0]) for r in got] != [want(r)
                                                       for r in results]:
            raise AssertionError("sampled serving run differs")
        out["clocks"] = {"back_to_back": back, "serving": served}
        note(f"serving: SM clock and power, back to back {back}, while "
             f"serving {served}")

        # 10 sequential one-query requests: latency
        lat = []
        seq = step("tcp_10_sequential", lambda: lines(
            port, [qreq(queries[i % N_QUERIES]) for i in range(10)], lat), 10)
        for i, r in enumerate(seq):
            if hits_of(r["results"][0]) != want(results[i % N_QUERIES]):
                raise AssertionError(f"sequential request {i} differs")
        out["latency_s"] = {"p50": float(np.median(lat)), "max": max(lat),
                            "all": lat}
        note(f"serving: 10 sequential one-query requests, latency p50 "
             f"{np.median(lat) * 1e3:.1f} ms, max {max(lat) * 1e3:.1f} ms")

        # top_k 4 and 100 against a direct search at 100
        direct, _ = search(packed, queries[:1], replace(config, top_k=100))
        tk = step("tcp_top_k_4_100", lambda: lines(port, [
            qreq(queries[0], top_k=4), qreq(queries[0], top_k=100)]), 2)
        for r, k in zip(tk, (4, 100)):
            if hits_of(r["results"][0]) != want(direct[0])[:k]:
                raise AssertionError(f"top_k {k} is not the prefix of a "
                                     "direct search at 100")

        # align and m8 for the two shortest queries at top 2
        two = sorted(range(N_QUERIES), key=lambda i: queries[i].length)[:2]
        pair = {"queries": [qreq(queries[i])["queries"][0] for i in two],
                "top_k": 2}
        al, m8 = step("tcp_align_m8", lambda: lines(port, [
            dict(pair, align=True), dict(pair, format="m8")]), 4)
        for r, i in zip(al["results"], two):
            if hits_of(r) != want(results[i])[:2] or not all(
                    "alignment" in h for h in r["hits"]):
                raise AssertionError("align response differs")
        if len(m8["m8"]) != 4 or any(len(x.split("\t")) != 12
                                     for x in m8["m8"]):
            raise AssertionError(f"m8 rows: {m8['m8']}")
        from swimm_tpu_torch.ops.traceback import sw_align
        for r, i in zip(al["results"], two):     # aligned on the card
            for hj, h in zip(r["hits"], results[i].hits):
                a = sw_align(queries[i].codes, packed.seq_codes(h.sorted_idx))
                if (hj["alignment"]["q_aln"], hj["alignment"]["d_aln"]) != (
                        a.q_aln, a.d_aln):
                    raise AssertionError("the card's alignment differs from "
                                         "sw_align's")
        out["align_m8_ok"] = True
    finally:
        tcp.shutdown()
        tcp.server_close()
        batcher.stop()
    th.join(timeout=10)

    # ---- HTTP: the 5,000-aa query (kernel 2), /health, /info ----
    Server, Handler, hsrv, hbatcher = make_http_server(packed, config)
    httpd = Server(("127.0.0.1", 0), Handler)
    hth = threading.Thread(target=httpd.serve_forever,
                           kwargs={"poll_interval": 0.05}, daemon=True)
    hth.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        def post():
            rq = urllib.request.Request(
                base + "/search", data=json.dumps(qreq(long_q)).encode(),
                headers={"Content-Type": "application/json"})
            t = time.perf_counter()
            with urllib.request.urlopen(rq, timeout=300) as r:
                return r.status, json.loads(r.read()), time.perf_counter() - t

        def health():
            t = time.perf_counter()
            with urllib.request.urlopen(base + "/health", timeout=30) as r:
                if json.loads(r.read()) != {"ok": True}:
                    raise AssertionError("/health")
            return time.perf_counter() - t

        n_qt = -(-engine._m_pad(long_q.length, config.m_multiple)
                 // longquery.LONG_TILE_M)
        health_s = [health()]             # the server's first response
        code, resp, long_s = step("http_long_5000", post, 0, n_qt)
        if code != 200 or hits_of(resp["results"][0]) != want(long_res[0]):
            raise AssertionError("HTTP 5,000-aa query differs from phase 4")
        health_s += [health(), health()]
        out["http_health_s"] = health_s
        with urllib.request.urlopen(base + "/info", timeout=30) as r:
            info = json.loads(r.read())["info"]
        if info["n_seqs"] != packed.n_seqs or info["device"] != "cuda":
            raise AssertionError(f"/info: {info}")
        out["http_long5000_s"] = long_s
    finally:
        httpd.shutdown()
        httpd.server_close()
        hbatcher.stop()
    hth.join(timeout=10)
    if engine._DEVICE_TILE_CACHE[packed]["cuda"] is not resident:
        raise AssertionError("the servers uploaded the resident DB again")
    grown = torch.cuda.memory_allocated() - mem0
    if grown >= resident[0].numel():
        raise AssertionError(f"device memory grew by {grown} bytes while "
                             "serving: a second upload")

    # ---- a streaming server on the memmapped DB of phases 13-16 ----
    ssrv = SearchServer(spacked, replace(config, db_stream=True))
    every = {"queries": [qreq(q)["queries"][0] for q in queries]}
    t = time.perf_counter()
    sresp = step("stream_server_20", lambda: ssrv.handle(every),
                 n_win * N_QUERIES)
    out["stream_server_20_s"] = time.perf_counter() - t
    if "error" in sresp or [hits_of(r) for r in sresp["results"]] != [
            want(r) for r in results]:
        raise AssertionError("the streaming server differs from resident")
    if spacked in engine._DEVICE_TILE_CACHE:
        raise AssertionError("the streaming server uploaded the DB")

    # ---- --selfcheck's C oracle over every hit of the 20 ----
    sub = get_matrix(config.matrix)
    t = time.perf_counter()
    n_c = 0
    for q, r in zip(queries, results):
        exp = cref.sw_score_many(q.codes, [packed.seq_codes(h.sorted_idx)
                                           for h in r.hits], sub,
                                 config.gap_open, config.gap_extend)
        if list(exp) != [h.score for h in r.hits]:
            raise AssertionError(f"C oracle differs for {q.title}")
        n_c += len(exp)
    out["cref_hits"] = n_c
    out["cref_s"] = time.perf_counter() - t

    # ---- the CLI: a serve stdio subprocess and info ----
    two_req = [qreq(queries[0], id=0), qreq(queries[1], id=1)]
    stdin = "\n".join([json.dumps(r) for r in two_req]
                      + [json.dumps({"cmd": "shutdown"})]) + "\n"
    t = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "swimm_tpu_torch", "serve", "-d",
         str(db_dir), "--warm", "448"], input=stdin, capture_output=True,
        text=True, timeout=300, cwd=repo)
    out["serve_subprocess_s"] = time.perf_counter() - t
    if p.returncode != 0:
        raise AssertionError(f"serve subprocess exit {p.returncode}: "
                             f"{p.stderr[-2000:]}")
    sub_resp = [json.loads(x) for x in p.stdout.splitlines()]
    if [hits_of(r["results"][0]) for r in sub_resp[:2]] != [
            want(results[0]), want(results[1])] or sub_resp[2] != {
            "ok": True, "served": 2}:
        raise AssertionError(f"serve subprocess answered {p.stdout[:2000]}")
    note("serving: `python -m swimm_tpu_torch serve --warm 448` stdio "
         f"subprocess in {out['serve_subprocess_s']:.1f} s: "
         + " | ".join(x for x in p.stderr.splitlines()
                      if "serve:" in x)[:600])
    p = subprocess.run([sys.executable, "-m", "swimm_tpu_torch", "info",
                        "-d", str(db_dir)], capture_output=True, text=True,
                       timeout=120, cwd=repo)
    if p.returncode != 0 or f"sequences       {packed.n_seqs:,}" \
            not in p.stdout:
        raise AssertionError(f"info: {p.returncode} {p.stdout} {p.stderr}")
    note("info -d: " + " | ".join(p.stdout.splitlines()))
    out.update(warm_s=warm_s, phase_s=time.perf_counter() - t_phase)
    note(f"serving: {json.dumps(out)}")
    return out


def sharded_paths(db_dir, packed, spacked, dev_db, queries, results, long_q,
                  long_res, e_res, met, stream_runs, config, counted,
                  errs) -> dict:
    """Phase 18, distribution (parallel/) on the phase-3 DB and queries:
    (a) sharded_search on make_mesh() (every visible card; one here), the
    20 queries and the 5,000-aa query; (b) a virtual mesh of 4 shards on
    the one card at (4, 1) and (2, 2), split form (merge timed apart);
    (c) kernel 1 on the shard with the longest blocks against its plain
    version; (d) E-values under (a) and (b); (e) search_streaming_sharded
    on the memmapped DB at 8,192 tiles a span over 4 virtual shards, peak
    device memory; (f) a one-rank NCCL group in this process, its real
    all_gather_into_tensor and all_reduce; (g) one `search --sharded
    --topk-per-shard 64` CLI subprocess. Every result is held exactly
    against phases 3, 4 and 9 (hits, ranks, scores, titles, E-values, bit
    scores); every run after a warm-up with its launches counted exactly
    ((a), (b), (e), (f) on the kernels line; (d) apart). Nothing is
    caught. Returns the numbers and phase times."""
    import socket

    import torch.distributed as dist

    from swimm_tpu_torch.fasta import write_fasta
    from swimm_tpu_torch.models import stream
    from swimm_tpu_torch.models.engine import SearchConfig
    from swimm_tpu_torch.models.profile import build_query_profile
    from swimm_tpu_torch.ops import longquery, scorer
    from swimm_tpu_torch.parallel import distributed
    from swimm_tpu_torch.parallel.mesh import make_mesh
    from swimm_tpu_torch.parallel.sharded_search import (build_tile_shards,
                                                         sharded_search)
    from swimm_tpu_torch.parallel.sharded_stream import \
        search_streaming_sharded
    out, phases = {}, {}
    m_long = -(-long_q.length // config.m_multiple) * config.m_multiple
    n_qt = -(-m_long // longquery.LONG_TILE_M)
    econfig = SearchConfig(top_k=16, evalue=True)
    qp0 = torch.from_numpy(build_query_profile(
        queries[0].codes, config.matrix, config.m_multiple)).cuda()

    def key(rs):
        return [[(h.rank, h.score, h.sorted_idx, h.title, h.evalue, h.bits)
                 for h in r.hits] for r in rs]

    def run(name, fn, want, k1, k2=0, main=True):
        """fn() once more after a warm-up, its launches counted exactly and
        its results equal to want's."""
        fn()
        (res, m), seen = counted(fn, main=main)
        exp = dict.fromkeys(seen, 0)
        exp.update(sw_ragged_kernel=k1, sw_ragged_qtile_kernel=k2)
        if seen != exp:
            raise AssertionError(f"phase 18 {name}: expected launches {exp}, "
                                 f"got {seen}")
        if key(res) != key(want):
            raise AssertionError(f"phase 18 {name}: results differ from the "
                                 "resident search's")
        return m, seen

    # ---- (a) + (d): one shard per visible card ----
    t = time.perf_counter()
    mem0 = torch.cuda.memory_allocated()
    mesh1 = make_mesh()
    nd = mesh1.shape["data"]
    a_met, seen = run("(a) 20 queries", lambda: sharded_search(
        packed, queries, config, mesh=mesh1), results, N_QUERIES * nd)
    al_met, _ = run("(a) 5,000 aa", lambda: sharded_search(
        packed, [long_q], config, mesh=mesh1), long_res, 0, n_qt * nd)
    ae_met, _ = run("(d) E-values on (a)", lambda: sharded_search(
        packed, queries, econfig, mesh=mesh1), e_res, N_QUERIES * nd,
        main=False)
    grew = torch.cuda.memory_allocated() - mem0
    if nd == 1 and grew > dev_db[0].numel() // 10:
        raise AssertionError(f"the one-shard mesh allocated {grew} bytes: "
                             "the resident stream was uploaded again")
    out["a"] = {"mesh": mesh1.shape, "seconds": a_met.seconds,
                "gcups": a_met.gcups, "resident_seconds": met.seconds,
                "ratio": a_met.seconds / met.seconds, "launches": seen,
                "long_seconds": al_met.seconds,
                "evalue_seconds": ae_met.seconds, "bytes_allocated": grew,
                "timers": a_met.timers}
    note(f"phase 18 (a) sharded_search on make_mesh() {mesh1.shape}: "
         f"{a_met.seconds:.3f} s, {a_met.gcups:.1f} real GCUPS (resident "
         f"{met.seconds:.3f} s, x{a_met.seconds / met.seconds:.3f}), "
         f"launches {seen}; 5,000 aa {al_met.seconds:.3f} s; (d) E-values "
         f"{ae_met.seconds:.3f} s; {grew} bytes allocated beside the "
         "resident stream; hits, ranks, scores, titles and E-values equal "
         "phases 3, 4 and 9")
    phases["sharded_a_s"] = time.perf_counter() - t

    # ---- (b) + (d): 4 virtual shards on the one card ----
    t = time.perf_counter()
    out["b"] = {}
    for qa in (1, 2):
        mesh = make_mesh(devices=["cuda:0"] * 4, query_axis=qa)
        nd = mesh.shape["data"]
        b_met, seen = run(f"(b) {mesh.shape}", lambda: sharded_search(
            packed, queries, config, mesh=mesh, measure_merge=True),
            results, N_QUERIES * nd)
        bl_met, _ = run(f"(b) {mesh.shape} 5,000 aa", lambda: sharded_search(
            packed, [long_q], config, mesh=mesh), long_res, 0, n_qt * nd)
        be_met, _ = run(f"(d) E-values on {mesh.shape}", lambda:
                        sharded_search(packed, queries, econfig, mesh=mesh),
                        e_res, N_QUERIES * nd, main=False)
        out["b"][f"{nd}x{qa}"] = {
            "seconds": b_met.seconds, "gcups": b_met.gcups,
            "resident_seconds": met.seconds, "launches": seen,
            "merge_s": b_met.timers["merge"], "score_s": b_met.timers["score"],
            "merge_collectives": b_met.timers["merge_collectives"],
            "long_seconds": bl_met.seconds, "evalue_seconds": be_met.seconds}
        note(f"phase 18 (b) 4 virtual shards at {mesh.shape}, split form: "
             f"{b_met.seconds:.3f} s (score {b_met.timers['score']:.3f} s, "
             f"merge {b_met.timers['merge'] * 1e3:.3f} ms over "
             f"{b_met.timers['merge_collectives']}), launches {seen}; "
             f"5,000 aa {bl_met.seconds:.3f} s; (d) E-values "
             f"{be_met.seconds:.3f} s; all equal phases 3, 4 and 9")
    # the shards run one after another on one card: each launch ends on its
    # own longest block
    shards = build_tile_shards(packed, make_mesh(devices=["cuda:0"] * 4))
    bounds0 = scorer.profile_bounds(qp0)
    shard_ms = [cuda_ms(lambda: scorer.score_tiles(
        s.tiles, s.outrow, s.n_rows, qp0, 10, 2, row_start=s.row_start,
        bounds=bounds0)) for _, s in sorted(shards["shards"].items())]
    whole_ms = cuda_ms(lambda: scorer.score_tiles(
        dev_db[0], dev_db[1], dev_db[2], qp0, 10, 2, row_start=dev_db[3],
        bounds=bounds0))
    out["b"]["query0_kernel_ms_per_shard"] = shard_ms
    out["b"]["query0_kernel_ms_whole_stream"] = whole_ms
    out["b"]["shard_tiles"] = [int(s.tiles.shape[0]) for _, s in
                               sorted(shards["shards"].items())]
    note(f"kernel 1, query 0 (m={qp0.shape[1]}), per shard of the (4, 1) "
         f"plan ({out['b']['shard_tiles']} tiles): "
         f"{[round(x, 3) for x in shard_ms]} ms, sum {sum(shard_ms):.3f} ms "
         f"against {whole_ms:.3f} ms over the whole stream")
    phases["sharded_b_s"] = time.perf_counter() - t

    # ---- (c): kernel 1 on the last shard (the longest blocks) vs plain ----
    t = time.perf_counter()
    last = shards["shards"][max(shards["shards"])]
    got = scorer.score_tiles(last.tiles, last.outrow, last.n_rows, qp0, 10,
                             2, row_start=last.row_start)
    ref = scorer.score_tiles_ref(last.tiles, last.outrow, last.n_rows, qp0,
                                 10, 2, row_start=last.row_start)
    e = max_err(got, ref)
    errs["sw_ragged_kernel"] = max(errs["sw_ragged_kernel"], e)
    if e:
        raise AssertionError(f"sw_ragged_kernel on the last shard differs "
                             f"from its plain version (max_abs_err={e})")
    out["c"] = {"tiles": int(last.tiles.shape[0]), "rows": last.n_rows,
                "m": int(qp0.shape[1]), "max_abs_err": e}
    note(f"phase 18 (c) sw_ragged_kernel vs plain on the last shard "
         f"({last.n_rows} blocks, {last.tiles.shape[0]} tiles, a stream "
         f"that starts mid-chunk, row starts rebased) at m={qp0.shape[1]}: "
         f"max_abs_err={e}")
    phases["sharded_c_s"] = time.perf_counter() - t

    # ---- (e): the streamed posture over 4 virtual shards ----
    t = time.perf_counter()
    layout = stream.stream_layout(spacked)
    spans, _ = stream.plan_windows(layout, 8192)
    mesh4 = make_mesh(devices=["cuda:0"] * 4)
    scfg = SearchConfig(top_k=16, db_stream=True, window_tiles=8192)
    search_streaming_sharded(spacked, queries, scfg, mesh=mesh4)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (s_res, s_met), seen = counted(lambda: search_streaming_sharded(
        spacked, queries, scfg, mesh=mesh4))
    peak = torch.cuda.max_memory_allocated() - base
    if seen["sw_ragged_kernel"] != len(spans) * N_QUERIES or sum(
            seen.values()) != len(spans) * N_QUERIES:
        raise AssertionError(f"phase 18 (e): expected {len(spans)} x "
                             f"{N_QUERIES} launches, got {seen}")
    if key(s_res) != key(results):
        raise AssertionError("phase 18 (e): streamed sharded hits differ "
                             "from the resident search's")
    out["e"] = {"spans": len(spans), "seconds": s_met.seconds,
                "gcups": s_met.gcups, "peak_bytes": peak,
                "stream_seconds": {k: v["seconds"]
                                   for k, v in stream_runs.items()},
                "launches": seen, "timers": s_met.timers}
    note(f"phase 18 (e) search_streaming_sharded, 4 virtual shards, "
         f"{len(spans)} spans of <= 8192 tiles: {s_met.seconds:.3f} s "
         f"(unsharded stream: buffer {stream_runs['buffer']['seconds']:.3f}"
         f" s, candidates {stream_runs['candidates']['seconds']:.3f} s), "
         f"peak {peak / 1e6:.1f} MB allocated, launches {seen}; hits equal")
    phases["sharded_e_s"] = time.perf_counter() - t

    # ---- (f): a one-rank NCCL group in this process ----
    t = time.perf_counter()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    calls = {"all_gather_into_tensor": 0, "all_reduce": 0}
    real = {n: getattr(dist, n) for n in calls}

    def counting(n):
        def call(*args, **kw):
            calls[n] += 1
            return real[n](*args, **kw)
        return call

    distributed.init(f"127.0.0.1:{port}", 1, 0)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}, not nccl")
        gmesh = distributed.global_mesh()
        gshards = distributed.global_tile_shards(packed, gmesh)
        for n in calls:
            setattr(dist, n, counting(n))
        f_met, seen = run("(f) NCCL", lambda: sharded_search(
            packed, queries, config, mesh=gmesh, tile_shards=gshards,
            measure_merge=True), results, N_QUERIES)
        fe_met, _ = run("(f) NCCL E-values", lambda: sharded_search(
            packed, queries, econfig, mesh=gmesh, tile_shards=gshards),
            e_res, N_QUERIES, main=False)
    finally:
        for n, fn in real.items():
            setattr(dist, n, fn)
        dist.destroy_process_group()
    groups = len({-(-q.length // 16) for q in queries})
    if calls["all_gather_into_tensor"] != 8 * groups or \
            calls["all_reduce"] != 2 * groups:
        raise AssertionError(f"phase 18 (f): collectives {calls}, expected "
                             f"{8 * groups} gathers and {2 * groups} "
                             "reductions")
    out["f"] = {"seconds": f_met.seconds, "merge_s": f_met.timers["merge"],
                "merge_collectives": f_met.timers["merge_collectives"],
                "evalue_seconds": fe_met.seconds, "launches": seen,
                "collective_calls": calls}
    note(f"phase 18 (f) one-rank NCCL group: {f_met.seconds:.3f} s, "
         f"all_gather merges {f_met.timers['merge_collectives']}, E-values "
         f"{fe_met.seconds:.3f} s, collectives {calls}; hits and E-values "
         "equal; process group destroyed")
    phases["sharded_f_s"] = time.perf_counter() - t

    # ---- (g): one `search --sharded` CLI subprocess ----
    t = time.perf_counter()
    qf = Path(db_dir).parent / "q18.fasta"
    write_fasta(qf, queries)
    p = subprocess.run(
        [sys.executable, "-m", "swimm_tpu_torch", "search", "-d",
         str(db_dir), "-q", str(qf), "--sharded", "--topk-per-shard", "64",
         "-r", "16", "--format", "json"], capture_output=True, text=True,
        timeout=300, cwd=Path(__file__).resolve().parent)
    if p.returncode != 0:
        raise AssertionError(f"search --sharded exit {p.returncode}: "
                             f"{p.stderr[-2000:]}")
    cli = json.loads(p.stdout)
    if [[(h["rank"], h["score"], h["title"]) for h in r["hits"]]
            for r in cli["results"]] != [[(h.rank, h.score, h.title)
                                         for h in r.hits] for r in results]:
        raise AssertionError("search --sharded printed other hits")
    out["g"] = {"subprocess_s": time.perf_counter() - t,
                "search_seconds": cli["metrics"]["seconds"]}
    note(f"phase 18 (g) `search --sharded --topk-per-shard 64` subprocess: "
         f"exit 0 in {out['g']['subprocess_s']:.1f} s (search "
         f"{out['g']['search_seconds']:.3f} s), hits equal phase 3's")
    phases["sharded_g_s"] = time.perf_counter() - t
    out["phases_s"] = phases
    return out


def align_cases(rng) -> list:
    """Phase 2's alignment pairs (codes): seeded random and homologous
    pairs, and pairs full of ties: identical sequences, low-complexity
    repeats, optima reached through gaps, one-residue and empty
    sequences, and a pair that scores 0 (an empty path)."""
    from swimm_tpu_torch.alphabet import encode
    from swimm_tpu_torch.utils.synth import mutate, random_codes
    cases = []
    for _ in range(8):
        q = random_codes(rng, int(rng.integers(1, 120)))
        cases.append((q, random_codes(rng, int(rng.integers(1, 120)))))
        h = mutate(rng, q, sub_rate=0.2, indel_rate=0.08)
        cases.append((q, np.concatenate([random_codes(rng, 7), h,
                                         random_codes(rng, 5)])))
    q = random_codes(rng, 90)
    for a, b in [(q, q), (q[:1], q), (q, q[40:41]), (q[:0], q), (q, q[:0]),
                 ("A", "C"), ("W", "W"), ("A" * 40, "A" * 55),
                 ("ACACACACACACAC", "CACACACA"), ("KKKKRKKKKRKKKK", "KRKRK"),
                 ("WWWWWGGGGGWWWWW", "WWWWWWWWWW"),
                 ("WWWWWWWWWW", "WWWWWGGGGGWWWWW"),
                 ("WWWWGWWWWGWWWW", "WWWWWWWWWWW"),
                 ("LLLLLLLLLLLLLLLL", "LLLLAAAALLLL"),
                 ("HHHHCCCCHHHHCCCCHHHH", "HHHHHHHHCCCCCCCC"),
                 # the diagonal and E tie on the path at 10/2
                 ("AHESADKWSTGNSRLNCNVT", "SMLDIHSADKSFTFGNSEEMCKNVTESS"),
                 ("ISNFEEQCRVQTTAGPVYEVIRDGVLN",
                  "NGWIFNFEMEMQCRVQKSGHFVYSFKDIVLFNRYY")]:
        cases.append((encode(a) if isinstance(a, str) else a,
                      encode(b) if isinstance(b, str) else b))
    return cases


def compare_align() -> None:
    """Phase 2's alignment part: sw_align_kernel (csrc/sw_align.cu, built
    here on its first use, as a server builds it) against
    ops.traceback.sw_align field by field and against the C oracle's
    score, on align_cases under three matrices and the gaps 10/2, 0/3, 0/0
    and 5/0, in one launch a (matrix, gaps); then the same pairs with the
    workspace cap cut so that they take several launches."""
    import dataclasses
    from swimm_tpu_torch.matrices import get_matrix
    from swimm_tpu_torch.ops import _build, align, cref
    from swimm_tpu_torch.ops.traceback import sw_align
    from swimm_tpu_torch.utils import metrics
    t = time.perf_counter()
    align.kernels()
    for line in _build.BUILD_LOGS.get("sw_align", "").splitlines():
        if any(w in line for w in ("registers", "spill", "error")):
            note(f"ptxas sw_align: {line.strip()}")
    note(f"sw_align built in {time.perf_counter() - t:.1f} s")
    cases = align_cases(np.random.default_rng(24))
    n, n_gapped = 0, 0
    for matrix in ("BLOSUM62", "PAM30", "BLOSUM45"):
        for go, ge in ((10, 2), (0, 3), (0, 0), (5, 0)):
            before = metrics.counter("align.launches")
            got = align.align_pairs(cases, matrix, go, ge, device="cuda")
            if metrics.counter("align.launches") - before != 1:
                raise AssertionError("expected one sw_align launch")
            sub = get_matrix(matrix)
            for (q, d), a in zip(cases, got):
                want = sw_align(q, d, matrix=matrix, gap_open=go,
                                gap_extend=ge)
                if dataclasses.asdict(a) != dataclasses.asdict(want):
                    raise AssertionError(
                        f"sw_align_kernel {matrix} {go}/{ge} m={len(q)} "
                        f"n={len(d)}: {a} != {want}")
                if a.score != cref.sw_score(q, d, sub, go, ge):
                    raise AssertionError("sw_align_kernel score != C oracle")
                n += 1
                n_gapped += a.n_gaps > 0
    if n_gapped == 0:
        raise AssertionError("no case took a gap")
    cap = align.WORKSPACE_BYTES
    align.WORKSPACE_BYTES = 2048
    try:
        before = metrics.counter("align.launches")
        split = align.align_pairs(cases, device="cuda")
        n_launch = metrics.counter("align.launches") - before
    finally:
        align.WORKSPACE_BYTES = cap
    whole = align.align_pairs(cases, device="cuda")
    if split != whole or n_launch < 4:
        raise AssertionError(f"a cut workspace changed the alignments "
                             f"({n_launch} launches)")
    note(f"sw_align_kernel: {n} pairs equal sw_align and the C oracle "
         f"({n_gapped} gapped); under a 2 KB cap {n_launch} launches, "
         f"equal")


def align_paths(packed, queries, results, config) -> dict:
    """Phase 22, alignments at full size: one 16-hit request's alignments
    (phase 3's median query) through ops.align.align_hits, equal to
    sw_align on the host; the 5,478-aa query against 16 subjects of 6,000
    aa (half of them its homologs), equal to the plain reference
    (swbench/align_reference.py) in every m8 column and to the C oracle;
    then the worst dispatch the server can meet, 64 queries of 6,000 aa
    with 16 hits of 6,000 aa each, over the workspace cap (one launch per
    group), every path's score equal to the one its strings give, 16
    against the C oracle and 4 against the plain reference. Each timed
    on the card (CUDA events around the call)."""
    import dataclasses
    from swbench import align_reference
    from swimm_tpu_torch.alphabet import ALPHABET, decode
    from swimm_tpu_torch.formats import m8_rows
    from swimm_tpu_torch.matrices import get_matrix
    from swimm_tpu_torch.models.engine import Hit, QueryResult
    from swimm_tpu_torch.ops import align, cref
    from swimm_tpu_torch.ops.traceback import sw_align
    from swimm_tpu_torch.utils import metrics
    from swimm_tpu_torch.utils.synth import mutate, random_codes
    t0 = time.perf_counter()
    out = {}
    sub = get_matrix("BLOSUM62")

    def timed_call(fn):
        fn()                                          # warm
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        before = metrics.counter("align.launches")
        a.record()
        res = fn()
        b.record()
        torch.cuda.synchronize()
        return res, a.elapsed_time(b), metrics.counter(
            "align.launches") - before

    def ref_rows(qs, subjects):
        letters = [[np.frombuffer(decode(s).encode(), np.uint8)
                    for s in subs] for subs in subjects]
        got = align_reference.align(
            [np.frombuffer(decode(q).encode(), np.uint8) for q in qs],
            letters, 10, 2, device="cuda")
        return [[align_reference.m8_row("q", f"S{k:07d}", c)
                 for k, c in enumerate(g)] for g in got]

    def rows(q, subs, al):
        r = QueryResult("q", len(q), [Hit(k + 1, a.score, k, k, f"S{k:07d}")
                                      for k, a in enumerate(al)])
        return m8_rows(r, al)

    idx = {c: k for k, c in enumerate(ALPHABET)}

    def own_score(a) -> int:
        """The path's score from its strings (gaps: open + extend)."""
        s, prev = 0, None
        for x, y in zip(a.q_aln, a.d_aln):
            if x == "-" or y == "-":
                g = "q" if x == "-" else "d"
                s -= 12 if prev != g else 2
                prev = g
            else:
                s += int(sub[idx[x], idx[y]])
                prev = None
        return s

    # one 16-hit request: the median query of phase 3
    mid = sorted(range(len(queries)), key=lambda i: queries[i].length)[
        len(queries) // 2]
    one = [queries[mid]]
    got, ms, n_l = timed_call(lambda: align.align_hits(
        [results[mid]], one, packed, config, device="cuda"))
    for h, a in zip(results[mid].hits, got[0]):
        want = sw_align(one[0].codes, packed.seq_codes(h.sorted_idx))
        if dataclasses.asdict(a) != dataclasses.asdict(want):
            raise AssertionError(f"hit {h.title}: {a} != {want}")
    cells = sum(one[0].length * int(packed.lengths[h.sorted_idx])
                for h in results[mid].hits)
    out["request16"] = {"ms": ms, "launches": n_l, "cells": cells,
                        "query_aa": one[0].length}
    note(f"one 16-hit request ({one[0].length} aa, {cells} cells): "
         f"{ms:.3f} ms, {n_l} launch, equal to sw_align")

    # the 5,478-aa query against 6,000-aa subjects
    rng = np.random.default_rng(5478)
    q = random_codes(rng, 5478)
    subs = []
    for k in range(16):
        if k % 2 == 0:
            h = mutate(rng, q, sub_rate=0.1 + 0.02 * k, indel_rate=0.02)[:6000]
            s = np.concatenate([random_codes(rng, (6000 - len(h)) // 2), h])
            subs.append(np.concatenate([s, random_codes(rng, 6000 - len(s))]))
        else:
            subs.append(random_codes(rng, 6000))
    pairs = [(q, s) for s in subs]
    got, ms, n_l = timed_call(lambda: align.align_pairs(pairs,
                                                        device="cuda"))
    if rows(q, subs, got) != ref_rows([q], [subs])[0]:
        raise AssertionError("5,478 x 6,000: m8 rows differ from the plain "
                             "reference")
    want = cref.sw_score_many(q, subs, sub, 10, 2)
    if [a.score for a in got] != list(want):
        raise AssertionError("5,478 x 6,000: scores differ from the oracle")
    out["q5478"] = {"ms": ms, "launches": n_l, "cells": 5478 * 6000 * 16}
    note(f"5,478 aa x 16 subjects of 6,000: {ms:.1f} ms, {n_l} launch; m8 "
         f"rows equal the plain reference, scores the C oracle")

    # 64 queries of 6,000 aa, 16 hits of 6,000 each: over the cap
    qs = [random_codes(rng, 6000) for _ in range(64)]
    pairs = []
    for k, qq in enumerate(qs):
        for j in range(16):
            pairs.append((qq, mutate(rng, qq, 0.3, 0.02)[:6000] if j == 0
                          else random_codes(rng, 6000)))
    n_groups = len(align.groups([align.workspace_bytes(len(a), len(b))
                                 for a, b in pairs]))
    got, ms, n_l = timed_call(lambda: align.align_pairs(pairs,
                                                        device="cuda"))
    if n_l != n_groups or n_groups < 2:
        raise AssertionError(f"expected {n_groups} launches, got {n_l}")
    bad = [k for k, a in enumerate(got) if own_score(a) != a.score]
    if bad:
        raise AssertionError(f"{len(bad)} paths do not score their DP's "
                             f"maximum")
    pick = list(range(0, 1024, 64))
    want = [cref.sw_score(pairs[k][0], pairs[k][1], sub, 10, 2)
            for k in pick]
    if [got[k].score for k in pick] != want:
        raise AssertionError("64 x 16 x 6,000: scores differ from the "
                             "oracle")
    four = pick[:4]
    if ([rows(pairs[k][0], [pairs[k][1]], [got[k]])[0] for k in four]
            != [r[0] for r in ref_rows([pairs[k][0] for k in four],
                                       [[pairs[k][1]] for k in four])]):
        raise AssertionError("64 x 16 x 6,000: m8 rows differ from the "
                             "plain reference")
    out["dispatch64"] = {"ms": ms, "launches": n_l,
                         "cells": 1024 * 6000 * 6000,
                         "workspace_bytes": align.WORKSPACE_BYTES}
    note(f"64 queries x 16 hits, all 6,000 aa: {ms:.1f} ms, {n_l} launches "
         f"(cap {align.WORKSPACE_BYTES >> 20} MiB), every path scores its "
         f"DP; 16 scores equal the C oracle, 4 rows the plain reference")
    out["phase_s"] = time.perf_counter() - t0
    return out


def card_fuzz(search_kernels, counted) -> dict:
    """Phase 20, the card fuzz (benchmarks/fuzz.py, benchmarks/acceptance.py),
    its launches counted apart from the kernels line: (a) fuzz rounds from
    seed 0, every route each round can take held exactly against the C
    oracle, until all 8 matrices and the routes of kernels 1-5 have run
    (at most FUZZ_CAP rounds); (b) acceptance config 1, every lane of
    score_db over 10,000 sequences equal to the oracle; (c) one fuzz_packed
    round at the reference's sizes. Each of kernels 1-5 must have launched.
    Nothing is caught. Returns the numbers and the phase's seconds."""
    from swimm_tpu_torch.benchmarks import acceptance, fuzz
    from swimm_tpu_torch.ops import longquery, scorer
    t_phase = time.perf_counter()
    out = {"seed": 0, "matrices": [], "routes": [], "ceilings": [],
           "long_rounds": 0, "long_pam250_rounds": 0}

    def run():
        rng = np.random.default_rng(0)
        for r in range(FUZZ_CAP):
            draw = fuzz.draw_round(rng)
            res = fuzz.run_round(draw, "cuda", np.random.default_rng([0, r]))
            if res["mismatch"] is not None:
                raise AssertionError(
                    f"phase 20 fuzz seed 0 round {r} ({draw.matrix} "
                    f"{draw.gap_open}/{draw.gap_extend}, qlen {draw.qlen}, "
                    f"codes {draw.codes.shape}, ceiling {draw.ceiling}): "
                    f"first mismatch (route, block, lane, got, exp) "
                    f"{res['mismatch']}")
            for key, new in (("matrices", [draw.matrix]),
                             ("routes", res["routes"]),
                             ("ceilings", [draw.ceiling])):
                out[key] += [x for x in new if x not in out[key]]
            out["long_rounds"] += draw.long
            out["long_pam250_rounds"] += draw.long and draw.matrix == "PAM250"
            if (set(out["matrices"]) == set(fuzz.MATRICES)
                    and set(out["routes"]) == set(fuzz.ROUTES)):
                break
        else:
            raise AssertionError(f"phase 20: {FUZZ_CAP} rounds ran {out} "
                                 "and not every matrix and route")
        out["rounds"] = r + 1
        out["fuzz_s"] = time.perf_counter() - t_phase
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as td:
            row, c1 = acceptance.config1(Path(td), "cuda")
        if not row.exact:
            raise AssertionError(f"phase 20 acceptance config 1: {row}")
        out["config1"] = {"lanes": len(c1["scores"]), "gcups": row.gcups,
                          "s": time.perf_counter() - t}
        t = time.perf_counter()
        packed_round, = fuzz.fuzz_packed(1, 0, "cuda")
        if not packed_round["ok"]:
            raise AssertionError("phase 20 fuzz_packed round 0 of seed 0: "
                                 "packed hits differ from the per-query "
                                 "hits or the oracle")
        out["fuzz_packed"] = {"queries": len(packed_round["queries"]),
                              "s": time.perf_counter() - t}

    longquery.score_tiles_long.rescored_blocks = 0
    scorer.score_tiles.rescored_blocks = 0
    _, seen = counted(run, main=False)
    out["launches"] = {name: seen[name] for name in search_kernels}
    for name in search_kernels:
        if seen[name] <= 0:
            raise AssertionError(f"phase 20: {name} was not launched")
    # kernel 2 by lane form, and the planted blocks scored again in int32
    # (one a long round: its lanes past 32,767 and at the limit)
    out["kernel2"] = {"pairs": longquery.score_qtile_pairs.launches,
                      "int32": longquery.score_qtile.launches,
                      "rescored_blocks":
                          longquery.score_tiles_long.rescored_blocks}
    if out["kernel2"]["rescored_blocks"] != out["long_rounds"]:
        raise AssertionError(f"phase 20: {out['kernel2']} after "
                             f"{out['long_rounds']} long rounds")
    # kernel 1 by lane form; its planted block passes the limit only in a
    # long PAM250 round (k1_planted)
    out["kernel1"] = {"pairs": scorer.score_tiles.pair_launches,
                      "int32": scorer.score_tiles.launches,
                      "rescored_blocks": scorer.score_tiles.rescored_blocks}
    if out["kernel1"]["rescored_blocks"] != out["long_pam250_rounds"]:
        raise AssertionError(f"phase 20: {out['kernel1']} after "
                             f"{out['long_pam250_rounds']} long PAM250 "
                             "rounds")
    out["phase_s"] = time.perf_counter() - t_phase
    note(f"phase 20 (card fuzz) {out['phase_s']:.1f} s: {out['rounds']} "
         f"rounds from seed 0 ({out['long_rounds']} long) in "
         f"{out['fuzz_s']:.1f} s, matrices {out['matrices']}, routes "
         f"{out['routes']}, ceilings {out['ceilings']}; acceptance config 1 "
         f"exact over {out['config1']['lanes']:,} lanes "
         f"({out['config1']['s']:.1f} s); "
         f"fuzz_packed round of {out['fuzz_packed']['queries']} queries "
         f"equal ({out['fuzz_packed']['s']:.1f} s); launches "
         f"{out['launches']}; kernel 2 {out['kernel2']}; kernel 1 "
         f"{out['kernel1']}")
    return out


def bench_entry_points(db_dir, packed, queries, results, long_q, long_res,
                       e_res, vec, counted) -> dict:
    """Phase 21, the measurement entry points (swimm_tpu_torch.bench and
    benchmarks/bench_*.py), each run() once on the card on the phase-3 DB
    and queries (no second DB built, the resident stream not uploaded
    again), stdout captured and noted, launches counted apart from the
    kernels line. bench_serve first (a `serve --listen` subprocess on the
    phase-3 DB directory: 3 serial requests, 4 concurrent, a soak of 10),
    on a thread, so that the server starts while bench_kernel at full size
    (its chained total equal to the plain version's chain), bench_serving
    and bench_longquery (the 5,000-aa query), bench_swissprot (--quick),
    bench_evalue, bench_ladder (one rep each) and bench_scaling (1, 2 and
    4 virtual shards) run; then, with the server stopped, bench (reps=1,
    the link probe, the ladder and stream extras; the MFU is phase 19's)
    and its headline reps (3) once more under torch.profiler with kernel
    1's device ms per launch for each rep. Every result equals phases 3-6
    and 9 (hits, scores, E-values, score vectors) or a direct search of
    the same queries. Nothing is caught. Returns the numbers and the
    phase's seconds."""
    import contextlib
    import io
    from concurrent.futures import ThreadPoolExecutor

    from swimm_tpu_torch import bench
    from swimm_tpu_torch.benchmarks import (bench_evalue, bench_kernel,
                                            bench_ladder, bench_longquery,
                                            bench_scaling, bench_serve,
                                            bench_serving, bench_swissprot)
    from swimm_tpu_torch.models.engine import SearchConfig, search
    from swimm_tpu_torch.ops import scorer
    t_phase = time.perf_counter()
    out = {"launches": {}, "s": {}}

    def step(name, fn):
        """fn() with its stdout noted line by line, its launches counted."""
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res, seen = counted(fn, main=False)
        out["s"][name] = time.perf_counter() - t
        out["launches"][name] = {k: n for k, n in seen.items() if n}
        for line in buf.getvalue().splitlines():
            note(f"phase 21 {name}: {line}")
        return res

    def check(name, ok):
        if not ok:
            raise AssertionError(f"phase 21 {name}: results differ from "
                                 "the earlier phases'")

    # the serve subprocess starts (~10 s) while the steps below run; the
    # headline and its profiled reps come after it has stopped
    pool = ThreadPoolExecutor(1)
    t_serve = time.perf_counter()
    served = pool.submit(lambda: (bench_serve.run(
        "cuda", n_requests=3, concurrent=4, soak=10, db_dir=db_dir),
        time.perf_counter() - t_serve))

    line, total = step("bench_kernel", lambda: bench_kernel.run("cuda"))
    _, qp, codes = bench_kernel.chain_inputs((32, 512, 128), "cuda")
    check("bench_kernel", total == int(bench_kernel.chained(
        codes, qp, 8, scorer.score_chunk_ref)))
    out["bench_kernel"] = line

    w = step("bench_serving", lambda: bench_serving.run(
        "cuda", reps=1, packed=packed, queries=queries))
    check("bench_serving", same_hits(w["results"], results))
    out["bench_serving"] = {"seconds": w["metrics"].seconds,
                            "gcups": w["metrics"].gcups}
    w = step("bench_longquery", lambda: bench_longquery.run(
        "cuda", reps=1, packed=packed, queries=[long_q]))
    check("bench_longquery", same_hits(w["results"], long_res))
    out["bench_longquery"] = {"seconds": w["metrics"].seconds,
                              "gcups": w["metrics"].gcups}

    lines, w = step("bench_swissprot", lambda: bench_swissprot.run(
        "cuda", quick=True, reps=1, packed=packed, queries=queries))
    check("bench_swissprot", same_hits(w["resident"][0], results)
          and all(same_hits(r, results) for r, _ in w["stream"])
          and np.array_equal(w["restream"], vec))
    out["bench_swissprot"] = lines[-1]
    summary, w = step("bench_evalue", lambda: bench_evalue.run(
        "cuda", reps=1, packed=packed, queries=queries))
    check("bench_evalue", same_hits(w["plain"][0], results)
          and same_hits(w["evalue"][0], e_res)
          and same_evalues_of(w["evalue"][0], e_res))
    out["bench_evalue"] = summary
    line, w = step("bench_ladder", lambda: bench_ladder.run(
        "cuda", reps=1, packed=packed, queries=queries))
    check("bench_ladder", line["hits_equal"]
          and same_hits(w["adaptive"][0], results))
    out["bench_ladder"] = line

    rows = step("bench_scaling", lambda: bench_scaling.run(
        "cuda", max_devices=4, packed=packed, queries=queries))
    check("bench_scaling", [r["mesh"] for r in rows] == [1, 2, 4] and all(
        r["exact"] and same_hits(r["results"], results) for r in rows))
    out["bench_scaling"] = [{k: v for k, v in r.items() if k != "results"}
                            for r in rows]

    (line, w), out["s"]["bench_serve"] = served.result()
    pool.shutdown()
    out["launches"]["bench_serve"] = {}     # its launches are the server's
    direct, _ = search(packed, w["queries"], SearchConfig(top_k=16))
    replies = w["serial"] + w["concurrent"] + w["soak"]
    check("bench_serve", line["soak_errors"] == 0
          and line["concurrent_dispatches"] <= 4 and all(
              [[(h["rank"], h["score"], h["title"]) for h in r["hits"]]
               for r in x["results"]]
              == [[(h.rank, h.score, h.title) for h in direct[x["id"]].hits]]
              for x in replies))
    note(f"phase 21 bench_serve: {json.dumps(line)}")
    out["bench_serve"] = line

    line, w = step("bench", lambda: bench.run(
        "cuda", reps=1, extras=True, mfu=False, packed=packed,
        queries=queries))
    check("bench", same_hits(w["results"], results)
          and same_hits(w["ladder"][0], results)
          and same_hits(w["stream"][0], results))
    want = {"h2d_mbps", "pull_rtt_ms", "ladder_gcups", "stream_gcups",
            "stream_link_floor_s", "stream_stall_limited"}
    if not want <= set(line) or any(k.endswith(("_error", "_skipped"))
                                    for k in line):
        raise AssertionError(f"phase 21 bench line: {line}")
    out["bench"] = line

    # the headline's reps under the profiler: kernel 1's device ms on each
    # launch, 20 a search (the warm-up, then each rep)
    box = []
    prof = device_breakdown(lambda: box.append(step(
        "bench_profiled", lambda: bench.run(
            "cuda", extras=False, mfu=False, packed=packed,
            queries=queries))), launches_of="sw_ragged_kernel")
    line, w = box[0]
    check("bench_profiled", same_hits(w["results"], results))
    ms = prof.pop("launch_ms")
    n_runs = 1 + line["resident_reps"]
    if len(ms) != N_QUERIES * n_runs:
        raise AssertionError(f"phase 21: {len(ms)} kernel-1 launches traced "
                             f"for {n_runs} searches of {N_QUERIES}")
    reps = [ms[i * N_QUERIES:(i + 1) * N_QUERIES] for i in range(n_runs)]
    per_query = np.array(reps[1:])             # (reps, queries)
    out["bench_profiled"] = dict(
        prof, line=line, kernel1_ms_per_run=[
            {"run": "warm-up" if i == 0 else f"rep {i}", "sum": sum(r),
             "min": min(r), "median": float(np.median(r)), "max": max(r)}
            for i, r in enumerate(reps)],
        kernel1_query_spread_pct=float(100 * (
            per_query.max(0) / per_query.min(0) - 1).max()))
    note(f"phase 21 headline reps under torch.profiler: kernel 1 ms per "
         f"launch (min / median / max, sum) "
         + "; ".join(f"{r['run']} {r['min']:.2f} / {r['median']:.2f} / "
                     f"{r['max']:.2f}, {r['sum']:.1f}"
                     for r in out["bench_profiled"]["kernel1_ms_per_run"])
         + f"; a query's launch spread across reps "
         f"{out['bench_profiled']['kernel1_query_spread_pct']:.2f}%; idle "
         f"{prof['idle_share']}")

    seen = {}
    for counts in out["launches"].values():
        for k, n in counts.items():
            seen[k] = seen.get(k, 0) + n
    for name in ("sw_ragged_kernel", "sw_ragged_qtile_kernel",
                 "sw_ragged_packed_kernel", "sw_chunk_kernel"):
        if not seen.get(name):
            raise AssertionError(f"phase 21: {name} was not launched")
    out["phase_s"] = time.perf_counter() - t_phase
    note(f"phase 21 (bench entry points) {out['phase_s']:.1f} s, by step "
         f"{ {k: round(v, 1) for k, v in out['s'].items()} }; launches "
         f"{out['launches']}")
    return out


def main(argv=None) -> int:
    kernels_only = "--kernels-only" in (sys.argv[1:] if argv is None
                                        else argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script measures the port on a GPU only",
              file=sys.stderr)
        return 1
    from swimm_tpu_torch import _cc
    from swimm_tpu_torch.benchmarks import probe_kernels
    from swimm_tpu_torch.benchmarks import probe_narrow_int as pn
    from swimm_tpu_torch.benchmarks import roofline as rl
    from swimm_tpu_torch.db import build_db
    from swimm_tpu_torch.fasta import FastaRecord
    from swimm_tpu_torch.models import engine, qpack
    from swimm_tpu_torch.models.engine import SearchConfig, score_db, search
    from swimm_tpu_torch.models.profile import build_query_profile
    from swimm_tpu_torch.ops import _build, longquery, scorer
    from swimm_tpu_torch.ops.lanes import select_mode
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

    class Kernel2:
        """sw_ragged_qtile_kernel's launches in both lane forms, read and
        set to 0 like one wrapper's counter (the pair form's own:
        longquery.score_qtile_pairs.launches)."""

        @property
        def launches(self):
            return (longquery.score_qtile.launches
                    + longquery.score_qtile_pairs.launches)

        @launches.setter
        def launches(self, n):
            longquery.score_qtile.launches = n
            longquery.score_qtile_pairs.launches = 0

    class Kernel1:
        """sw_ragged_kernel's launches in both lane forms, read and set to
        0 like one wrapper's counter (the pair form's own:
        scorer.score_tiles.pair_launches)."""

        @property
        def launches(self):
            return kernel1_launches()

        @launches.setter
        def launches(self, n):
            scorer.score_tiles.launches = n
            scorer.score_tiles.pair_launches = 0

    counters = {"sw_ragged_kernel": Kernel1(),
                "sw_ragged_qtile_kernel": Kernel2(),
                "sw_ragged_packed_kernel": scorer.score_tiles_packed,
                "sw_chunk_kernel": scorer.score_chunks,
                "sw_chunk_qtile_kernel": longquery.score_chunks_qtile,
                "chain_kernel": rl.chains, "narrow_kernel": pn.narrow}
    search_kernels = list(counters)[:5]
    launches = dict.fromkeys(counters, 0)

    def counted(fn, main=True):
        """fn() with every launch counter set to 0 just before and read
        just after; returns (result, this run's counts) and, for the main
        paths of phases 3-6 (main=True), adds the counts to `launches`,
        which the kernels line reports."""
        for w in counters.values():
            w.launches = 0
        res = fn()
        seen = {name: w.launches for name, w in counters.items()}
        if main:
            for name, n in seen.items():
                launches[name] += n
        return res, seen

    # ---- phase 2: build + kernels vs plain ----
    t = time.perf_counter()
    _build.build("sw_ragged", "sw_chunk", "probe")   # three nvcc at once
    scorer.build_kernels()
    probe_kernels()
    phases["build_s"] = time.perf_counter() - t
    for src, log in sorted(_build.BUILD_LOGS.items()):
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "error")):
                note(f"ptxas {src}: {line.strip()}")
    errs = dict.fromkeys(counters, 0)
    t = time.perf_counter()
    compare_kernels(errs)
    compare_new_kernels(errs)
    compare_probe_kernels(errs)
    compare_at_gap_bound(errs)
    compare_align()
    phases["compare_s"] = time.perf_counter() - t
    if kernels_only:
        note(f"kernels only: max_abs_err per kernel {errs}")
        return 0 if not any(errs.values()) else 1

    # ---- phase 3: Swiss-Prot-scale DB + 20-query batch ----
    rng = np.random.default_rng(0)
    qlens = list(rng.integers(100, 501, size=N_QUERIES))
    queries = synth_queries(N_QUERIES, qlens, seed=1)
    config = SearchConfig(top_k=16)
    tmp = tempfile.TemporaryDirectory()   # the packed DB stays on disk for
    td = Path(tmp.name)                   # the streaming phases
    t = time.perf_counter()
    fasta = td / "sp.fasta"
    n_res = synth_fasta_fast(fasta, N_SEQS, seed=2,
                             queries=[q.codes for q in queries],
                             homolog_frac=0.0005)
    phases["synth_s"] = time.perf_counter() - t
    note(f"synthetic DB: {N_SEQS} seqs, {n_res} residues")
    t = time.perf_counter()
    packed = build_db(str(fasta), td / "db", V=128)   # the native route
    phases["parse_pack_s"] = time.perf_counter() - t
    if "swpack" not in _cc._LIBS:
        raise AssertionError("build_db did not take the native packer")
    note(f"parse + pack (native, csrc/swpack.c): "
         f"{phases['parse_pack_s']:.2f} s")
    fasta.unlink()
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
    scorer.score_tiles.rescored_blocks = 0
    (results, met), seen = counted(lambda: search(packed, queries, config))
    forms1 = {"pairs": scorer.score_tiles.pair_launches,
              "int32": scorer.score_tiles.launches,
              "rescored_blocks": scorer.score_tiles.rescored_blocks}
    note(f"20-query search: {met.seconds:.3f} s, {met.gcups:.1f} GCUPS "
         f"(padded {met.padded_gcups:.1f}), launches {seen}; kernel 1 by "
         f"lane form and the blocks scored again {forms1}")
    if (seen["sw_ragged_kernel"] != N_QUERIES
            or forms1 != {"pairs": N_QUERIES, "int32": 0,
                          "rescored_blocks": 0}):
        raise AssertionError(f"expected {N_QUERIES} launches in the pair "
                             f"form, got {seen}, {forms1}")

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
    assert select_mode(m_long) == "tiles_long"
    search(packed, [long_q], config)                     # warm-up
    longquery.score_tiles_long.rescored_blocks = 0
    (long_res, long_met), seen = counted(
        lambda: search(packed, [long_q], config))
    forms = {"pairs": longquery.score_qtile_pairs.launches,
             "int32": longquery.score_qtile.launches,
             "rescored_blocks": longquery.score_tiles_long.rescored_blocks}
    note(f"{LONG_LEN}-aa query: {long_met.seconds:.3f} s, "
         f"{long_met.gcups:.1f} GCUPS, launches {seen}; kernel 2 by lane "
         f"form and the blocks scored again {forms}")
    if seen["sw_ragged_qtile_kernel"] != n_qt or forms["pairs"] != n_qt:
        raise AssertionError(f"expected {n_qt} query-tile launches in the "
                             f"pair form, got {seen}, {forms}")

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
    for name in search_kernels:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")

    # ---- phases 9-12: E-values and the precision ladder ----
    later = later_paths(packed, dev_db, queries, results, long_q, long_res,
                        met, long_met, vec, config, counted)
    phases.update(later.pop("phases_s"))
    e_res = later.pop("e_res")

    # ---- phases 13-16: the streaming posture, on the DB loaded again ----
    streamed = stream_paths(td / "db", packed, dev_db, queries, results,
                            long_q, long_res, met, long_met, vec, vec_l,
                            config, counted)
    phases.update(streamed.pop("phases_s"))

    # ---- phase 17: serving, on the resident DB and the memmapped one ----
    spacked = streamed.pop("spacked")
    serving = serving_paths(td / "db", packed, spacked,
                            queries, results, long_q, long_res,
                            streamed["batch20_8192"]["windows"], config,
                            counted)
    phases["serving_s"] = serving["phase_s"]

    # ---- phase 22: alignments on the card at full size ----
    aligned = align_paths(packed, queries, results, config)
    phases["align_s"] = aligned.pop("phase_s")

    # ---- phase 18: distribution, on the resident DB and the memmapped one
    sharded = sharded_paths(td / "db", packed, spacked, dev_db, queries,
                            results, long_q, long_res, e_res, met,
                            streamed["batch20_8192"]["runs"], config,
                            counted, errs)
    phases.update(sharded.pop("phases_s"))

    # ---- phase 20: the card fuzz, against the C oracle ----
    fuzzed = card_fuzz(search_kernels, counted)
    phases["card_fuzz_s"] = fuzzed["phase_s"]

    # ---- phase 21: the measurement entry points, on the phase-3 DB ----
    benched = bench_entry_points(td / "db", packed, queries, results, long_q,
                                 long_res, e_res, vec, counted)
    phases["bench_entry_points_s"] = benched["phase_s"]
    tmp.cleanup()

    # ---- phase 8: kernels vs plain at main-path shapes, timed ----
    int_rate = rl.peak_instruction_rate()
    note(f"instruction rate peak from the card: {int_rate / 1e12:.2f} "
         "T thread-instructions/s")
    stream_bytes = tiles.numel() + 8 * (n_rows + 1)

    def walk_work(m, extra_bytes):   # (bytes moved, DP cells)
        return stream_bytes + 4 * 32 * m + extra_bytes, lanes_pos * m

    t = time.perf_counter()
    bounds1 = scorer.profile_bounds(qp1)
    k1 = lambda: scorer.score_tiles(tiles, outrow, n_rows, qp1, 10, 2,
                                    row_start=row_start, bounds=bounds1)
    k1_ms, got1 = timed(k1, reps=3)
    k1_int32_ms, got1_int32 = timed(lambda: scorer.score_tiles_int32(
        tiles, outrow, n_rows, qp1, 10, 2, row_start=row_start), reps=3)
    p1_ms, ref1 = timed(lambda: scorer.score_tiles_ref(
        tiles, outrow, n_rows, qp1, 10, 2, row_start=row_start))
    e1 = max(max_err(got1, ref1), max_err(got1_int32, ref1))
    errs["sw_ragged_kernel"] = max(errs["sw_ragged_kernel"], e1)
    k1_int32_load = rl.walk_load(rl.walk_sass_per_cell(
        "sw_ragged", "sw_ragged_kernelILb0ELb0E"))
    note(f"sw_ragged_kernel vs plain, whole stream at m={m1}: pair form "
         f"{k1_ms:.3f} ms, int32 form {k1_int32_ms:.3f} ms (SASS a cell "
         f"{k1_int32_load}), both max_abs_err={e1}")
    del ref1, got1_int32
    w1 = walk_work(m1, 4 * n_rows * V)
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
            tiles[:tc], outrow[:tc], cut, qp1, 10, 2, row_start=rs_head,
            bounds=bounds1)),
        "ms_100_longest_alone": cuda_ms(lambda: scorer.score_tiles(
            tiles[tc:], or_tail, 100, qp1, 10, 2, row_start=rs_tail,
            bounds=bounds1))}
    note(f"sw_ragged_kernel without the 100 longest blocks ({tc} of {T} "
         f"tiles): {k1_tail['ms_without_100_longest']:.3f} ms; those 100 "
         f"alone: {k1_tail['ms_100_longest_alone']:.3f} ms")
    # kernel 2 on the long query's first two 1024-row tiles: fresh carries
    # in, then the first tile's carries in; the kernel updates its carries
    # in place, so it gets clones and the plain version the originals. The
    # pair form (the main path's) on the same tiles, its carries in lane
    # pairs: no lane here comes near its limit, so its plain version is
    # the int32 plain walk's scores and carries, packed
    tm = longquery.LONG_TILE_M
    hc = torch.zeros(tiles.shape, dtype=torch.int32, device="cuda")
    fc = torch.full(tiles.shape, scorer.NEG, dtype=torch.int32,
                    device="cuda")
    half = (*tiles.shape[:2], V // 2)
    hp = torch.zeros(half, dtype=torch.int32, device="cuda")
    fp = torch.full(half, longquery.pair_word(-12), dtype=torch.int32,
                    device="cuda")
    limit = longquery.pair_limit(int(qp_l.max()))
    e2 = 0
    p2_ms = None
    for qt in range(2):
        qp2 = qp_l[:, qt * tm:(qt + 1) * tm].contiguous()
        got2 = longquery.score_qtile(tiles, outrow, n_rows, qp2, 10, 2,
                                     hc.clone(), fc.clone(), row_start)
        gotp = longquery.score_qtile_pairs(tiles, outrow, n_rows, qp2, 10, 2,
                                           hp, fp, row_start)
        ms, ref2 = timed(lambda: longquery.score_qtile_ref(
            tiles, outrow, n_rows, qp2, 10, 2, hc, fc, row_start))
        p2_ms = p2_ms if p2_ms is not None else ms
        e = max(max_err(g, r) for g, r in zip(got2, ref2))
        ep = max(max_err(gotp[0], ref2[0]),
                 max_err(longquery.from_pairs(gotp[1]), ref2[1]),
                 max_err(longquery.from_pairs(gotp[2]), ref2[2]))
        top = int(ref2[0].max())
        if top >= limit:
            raise AssertionError(f"query tile {qt}: a lane reached {top}, at "
                                 f"or past the pair form's limit {limit}")
        note(f"sw_ragged_qtile_kernel vs plain, whole stream, query tile "
             f"{qt}: scores + both carries max_abs_err={e}; the pair form "
             f"max_abs_err={ep} (top score {top}, limit {limit})")
        e2 = max(e2, e, ep)
        _, hc, fc = ref2
        del got2, gotp, ref2
    errs["sw_ragged_qtile_kernel"] = max(errs["sw_ragged_qtile_kernel"], e2)
    m2 = qp2.shape[1]
    hk, fk = hc.clone(), fc.clone()   # timed in place; hc/fc (the second
    # tile's outgoing carries) are kept for kernel 5 below
    k2_int32_ms = cuda_ms(lambda: longquery.score_qtile(
        tiles, outrow, n_rows, qp2, 10, 2, hk, fk, row_start))
    del hk, fk
    k2_ms = cuda_ms(lambda: longquery.score_qtile_pairs(
        tiles, outrow, n_rows, qp2, 10, 2, hp, fp, row_start))
    del hp, fp
    w2 = walk_work(m2, 4 * n_rows * V + 8 * lanes_pos)
    k2_int32_load = rl.walk_load(rl.walk_sass_per_cell(
        "sw_ragged", "sw_ragged_qtile_kernelILb0E"))
    note(f"sw_ragged_qtile_kernel one 1024-row tile over the whole stream: "
         f"pair form {k2_ms:.3f} ms, int32 form {k2_int32_ms:.3f} ms "
         f"(SASS a cell {k2_int32_load})")
    k2_canonical = canonical_long_queries(tiles, outrow, n_rows, row_start,
                                          config.m_multiple, errs)
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
    w3 = walk_work(wide.M, 4 * (wide.M // 8) + planes_bytes)
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
    w4 = (tiles.numel() + n_chunks * 4 * 32 * m1 + 4 * n_rows * V,
          lanes_pos * m1)
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
    w5 = (tiles.numel() + 4 * 32 * tm + 48 * n_chunks + 8 * n_rows
          + 4 * n_rows * V + 16 * lanes_pos, lanes_pos * tm)
    phases["full_size_k5_s"] = time.perf_counter() - t

    # ---- phase 19: the rates: P1 and P2 driven through their entry
    # points, counted; the five kernels' bounds on the measured rates ----
    t = time.perf_counter()

    def rates():
        roof = rl.report("cuda", n_reps=3)
        phases["rates_roofline_s"] = time.perf_counter() - t
        return roof, pn.report("cuda", n_reps=3)

    (roof, probe), seen = counted(rates, main=False)
    search_launches = {}   # P1 and P2 on the main paths of 3-6: none
    for name in ("chain_kernel", "narrow_kernel"):
        search_launches[name] = launches[name]
        if search_launches[name] != 0:
            raise AssertionError(f"{name} was launched "
                                 f"{search_launches[name]} times on the "
                                 "search paths")
        if seen[name] <= 0:
            raise AssertionError(f"{name} was not launched by the rates "
                                 "phase")
        launches[name] = seen[name]
    failed = [k for k, v in probe.items() if "compiles" in k and not v]
    if failed:
        raise AssertionError(f"narrow_kernel failed: {failed} {probe}")
    walk = roof["walk_rates"]
    note(f"measured rates (filled card): the half-rate pipe "
         f"{walk['half_rate_per_s'] / 1e12:.3f} T/s, best total issue "
         f"{walk['issue_per_s'] / 1e12:.3f} T/s; SASS per step "
         f"{roof['sass_per_step']}; sol band at m={roof['m']} "
         f"{roof['sol_gcups_band']} GCUPS ({roof['sol']['low_by']}); "
         f"kernel 1 padded {roof['measured_padded_gcups']:.1f} GCUPS at "
         "1,024 tiles "
         f"(spread {roof['measured_padded_gcups_spread_pct']:.2f}%), "
         f"{roof['filled_padded_gcups']['median']:.1f} at 50,865")
    note(f"narrow probe: int16 x{probe['int16_speedup_vs_int32']:.3f}, "
         f"int8 x{probe['int8_speedup_vs_int32']:.3f} vs int32 at "
         f"{pn.SHAPE}; filled x{probe['int16_speedup_vs_int32_filled']:.3f}"
         f", x{probe['int8_speedup_vs_int32_filled']:.3f}; SASS per step "
         f"{probe['sass_per_step']}")
    # P1 and P2 at the TPU functions' shapes, against plain: the f32
    # chains at the long loop count; the int32 step chained at the probe's
    # long step count (8 steps, the TPU's scan, take ~1 us: a time of the
    # launch, not of the kernel)
    x1 = rl.chain_input("f32", 1, "cuda")
    k6_ms, got = timed(lambda: rl.chains(x1, rl.LOOPS[1], "f32"), reps=3)
    p6_ms, ref = timed(lambda: rl.chains_ref(x1, rl.LOOPS[1], "f32"))
    errs["chain_kernel"] = max(errs["chain_kernel"], probe_err(got, ref))
    steps6 = rl.LOOPS[1] * rl.UNROLL * rl.CHAINS * x1.numel()
    b6, b6_by = bound(8 * x1.numel(), 3 * steps6 + 7 * x1.numel(), int_rate)
    x2 = pn.probe_input(torch.int32, pn.SHAPE, "cuda")
    steps7 = pn.STEPS[1]
    k7_ms, got = timed(lambda: pn.narrow(x2, steps7), reps=3)
    p7_ms, ref = timed(lambda: pn.narrow_ref(x2, steps7))
    errs["narrow_kernel"] = max(errs["narrow_kernel"], probe_err(got, ref))
    # instructions as the walk's bound counts them, the shortest sm_90
    # sequence: 4 a step (VIADD, 2 VIADDMNMX, VIMNMX3), not its 7 integer
    # operations, which the fused ones beat
    b7, b7_by = bound(8 * x2.numel(), 4 * steps7 * x2.numel(), int_rate)
    phases["rates_s"] = time.perf_counter() - t
    note(f"phase 19 (rates) {phases['rates_s']:.1f} s, of it "
         f"roofline.report {phases['rates_roofline_s']:.1f} s")

    for name, e in errs.items():
        if e != 0:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"(max_abs_err={e})")
    opc = rl.ops_per_cell(8)["total"]
    rows = [  # name, source, replaces, ms, plain ms, (bytes, cells),
        # shape, its SASS name in the library
        ("sw_ragged_kernel", "sw_ragged.cu",
         "swimm_tpu/ops/pallas_scorer.py:317", k1_ms, p1_ms, w1,
         f"T={T} V={V} m={m1}, pair form (int32 form {k1_int32_ms:.3f} ms)",
         "sw_ragged_kernelILb0ELb1E"),
        ("sw_ragged_qtile_kernel", "sw_ragged.cu",
         "swimm_tpu/ops/longquery.py:208", k2_ms, p2_ms, w2,
         f"T={T} V={V} tile_m={m2}, pair form (int32 form "
         f"{k2_int32_ms:.3f} ms)", "sw_ragged_qtile_kernelILb1E"),
        ("sw_ragged_packed_kernel", "sw_ragged.cu",
         "swimm_tpu/ops/pallas_scorer.py:434", k3_ms, p3_ms, w3,
         f"T={T} V={V} M={wide.M} queries={len(wide.entries)}",
         "sw_ragged_packed_kernel"),
        ("sw_chunk_kernel", "sw_chunk.cu",
         "swimm_tpu/ops/pallas_scorer.py:245", k4_ms, p4_ms, w4,
         f"{n_chunks} chunks, {n_rows} blocks, V={V} m={m1}; one launch "
         "over all chunks", "sw_chunk_kernelILb0E"),
        ("sw_chunk_qtile_kernel", "sw_chunk.cu",
         "swimm_tpu/ops/longquery.py:126", k5_ms, p5_ms, w5,
         f"{n_chunks} chunks, {n_rows} blocks, V={V} tile_m={tm}; one "
         "launch over all chunks", "sw_chunk_qtile_kernel"),
    ]

    def measured_bound(nbytes, work, load):
        """(ms, by) on this card's measured rates: ``work`` cells or steps
        of ``load`` (roofline.walk_load of the kernel's own SASS) over the
        half-rate pipe and total issue (roofline.walk_bound_s), or the
        bytes over the memory rate, whichever is longer."""
        t_m = rl.walk_bound_s(work, load, walk)
        t_m["bytes"] = nbytes / HBM_BYTES_PER_S
        by_m = max(t_m, key=t_m.get)
        return t_m[by_m] * 1e3, by_m

    kernels = []
    for (name, src, replaces, ms, plain_ms, (nbytes, cells), shape,
         sass_name) in rows:
        # a pair form (its name's last template argument true) does two
        # cells in each .S16x2 instruction: half the instructions a cell
        lanes = 2 if sass_name.endswith("Lb1E") else 1
        b, by = bound(nbytes, opc * cells / lanes, int_rate)
        load = rl.walk_load(rl.walk_sass_per_cell(src[:-3], sass_name,
                                                  lanes))
        pb, pby = measured_bound(nbytes, cells, load)
        kernels.append(
            {"name": name, "route": "cuda",
             "source": f"swimm_tpu_torch/csrc/{src}", "replaces": replaces,
             "launches": launches[name], "max_abs_err": errs[name],
             "exact": True, "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
             "bound_by": by, "pipe_bound_ms": pb, "pipe_bound_by": pby,
             "sass_load": load, "library_ms": None, "shape": shape})
    for name, replaces, ms, plain_ms, b, by, work, load, shape in (
            ("chain_kernel", "benchmarks/roofline.py:110", k6_ms, p6_ms, b6,
             b6_by, (8 * x1.numel(), steps6),
             rl.walk_load(roof["sass_per_step"]["f32"]),
             f"f32 form, {tuple(x1.shape)} x {rl.CHAINS} chains, "
             f"{rl.LOOPS[1]} loops of {rl.UNROLL} steps"),
            ("narrow_kernel", "benchmarks/probe_narrow_int.py:37", k7_ms,
             p7_ms, b7, b7_by, (8 * x2.numel(), steps7 * x2.numel()),
             rl.walk_load(probe["sass_per_step"]["int32"]),
             f"int32, {tuple(x2.shape)}, {steps7} steps")):
        pb, pby = measured_bound(*work, load)
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "swimm_tpu_torch/csrc/probe.cu", "replaces": replaces,
             "launches": launches[name],
             "main_search_launches": search_launches[name],
             "max_abs_err": errs[name], "exact": True, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
             "pipe_bound_ms": pb, "pipe_bound_by": pby, "sass_load": load,
             "library_ms": None, "shape": shape})
    for k in kernels:
        note(f"{k['name']}: {k['ms']:.3f} ms (plain {k['plain_ms']:.1f} ms, "
             f"bound {k['bound_ms']:.3f} ms by {k['bound_by']}, measured "
             f"bound {k['pipe_bound_ms']:.3f} ms by {k['pipe_bound_by']} "
             f"at {k['sass_load']}), {k['launches']} launches; "
             f"{k['shape']}")

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
        "kernel2_canonical_long": k2_canonical,
        "evalue_and_ladder": later,
        "stream": streamed,
        "serving": serving,
        "sharded": sharded,
        "card_fuzz": fuzzed,
        "bench_entry_points": benched,
        "phases_s": phases,
        "hits_rescored": n_checked,
        "wall_s": time.perf_counter() - T_START,
    }
    print(json.dumps({"roofline": roof}), flush=True)
    print(json.dumps({"probe_narrow_int": probe}), flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
