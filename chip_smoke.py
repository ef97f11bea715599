"""On-card smoke test of swimm_tpu_torch (PyTorch + CUDA, one NVIDIA GPU).

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; nothing is caught):
  1. the card's name and power limit (nvidia-smi);
  2. build csrc/sw_ragged.cu and hold both kernels against their plain
     PyTorch versions on the card, bit-exact, on ragged cases (mixed block
     lengths, tied lanes, PAD runs, a ceiling, gap_extend=0, m = 8, 16, 24,
     40, 2048, 2064, a multi-tile long query with a small tile_m, and the
     DB's longest block);
  3. the main path at Swiss-Prot scale: a 570,000-sequence synthetic DB
     (seed 2, homolog_frac 0.0005), 20 queries of 100-500 aa (lengths from
     rng seed 0, synth_queries seed 1), BLOSUM62 10/2, top_k 16 — packed,
     uploaded once, searched once as warm-up, then timed with the kernels'
     launch counters set to 0 just before and read just after;
  4. one 5,000-aa query (a query-0 segment inside random sequence) through
     the query-tiled path (5 tiles of 1024 rows), counted the same way;
  5. exactness at scale: every reported hit rescored (numpy Gotoh oracle
     for three queries, the plain scorer on the gathered lanes for all),
     each query's top hit a planted homolog;
  6. both kernels against their plain versions at the main path's full
     size, bit-exact (the whole tile stream at query 0's m; the first two
     1024-row tiles of the long query, scores and both outgoing carries),
     their times beside their bounds (int32 peak from the card's SM count
     and max clock), GCUPS, latencies, one profiled 20-query search (kernel
     device time and the device's idle share); a `kernels` JSON line, then
     the device JSON as the last line.

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
INT32_OPS_PER_CLK_SM = 64   # 32-bit integer add/sub/min/max results per
# clock per SM at compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput table); times SM count and max SM
# clock, both read from the card, gives its int32 peak
OPS_PER_CELL = 11           # int32 ops per DP cell in the walk (E: 3,
# H: 4, F: 3, running max: 1 — see csrc/sw_ragged.cu)
N_SEQS = 570_000
N_QUERIES = 20
LONG_LEN = 5000


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


def compare_kernels(errs: dict) -> None:
    """Phase 2: both kernels vs their plain versions, on the card."""
    from swimm_tpu_torch.ops import longquery, scorer
    rng = np.random.default_rng(5)
    k1 = "sw_ragged_kernel"
    k2 = "sw_ragged_qtile_kernel"
    cases = [  # (tile counts, m, gap_open, gap_extend, ceiling)
        ([1, 3, 1, 5, 2], 8, 10, 2, None),
        ([2, 1, 4], 16, 10, 2, None),
        ([3, 1, 2], 24, 10, 1, None),
        ([1, 2, 6], 40, 11, 1, None),
        ([2, 5, 1, 3], 64, 10, 2, 40),
        ([4, 2, 3], 96, 5, 0, None),
        ([1, 3, 2], 2048, 10, 2, None),
    ]
    for counts, m, go, ge, ceil in cases:
        tiles, outrow, n_rows = ragged_case(rng, counts)
        qp = profile(rng, m)
        got = scorer.score_tiles(tiles, outrow, n_rows, qp, go, ge,
                                 ceiling=ceil)
        ref = scorer.score_tiles_ref(tiles, outrow, n_rows, qp, go, ge,
                                     ceiling=ceil)
        torch.cuda.synchronize()
        errs[k1] = max(errs[k1], max_err(got, ref))
        note(f"{k1} m={m} gaps={go}/{ge} ceiling={ceil}: "
             f"max_abs_err={max_err(got, ref)}")
    # long queries: m=2064 in 1024-row tiles (3 launches), and m=200 in
    # 64-row tiles (4 launches), against the one-pass plain scorer
    for counts, m, tile_m in (([2, 1, 3], 2064, None), ([3, 2], 200, 64)):
        tiles, outrow, n_rows = ragged_case(rng, counts)
        qp = profile(rng, m)
        got = longquery.score_tiles_long(tiles, outrow, n_rows, qp, 10, 2,
                                         tile_m=tile_m)
        ref = scorer.score_tiles_ref(tiles, outrow, n_rows, qp, 10, 2)
        torch.cuda.synchronize()
        errs[k2] = max(errs[k2], max_err(got, ref))
        note(f"{k2} score_tiles_long m={m} tile_m={tile_m}: "
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
        if "sw_ragged" in ev.key:
            ours += us / 1e3
        else:
            other += us / 1e3
    if ours + other == 0:
        return {"wall_ms": wall_ms, "kernel_ms": "not measured",
                "other_device_ms": "not measured", "idle_share":
                "not measured"}
    return {"wall_ms": wall_ms, "kernel_ms": ours, "other_device_ms": other,
            "idle_share": 1 - (ours + other) / wall_ms}


def int32_ops_per_s() -> float:
    """The card's int32 ALU peak: SMs x 64 ops/clk x max SM clock."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_OPS_PER_CLK_SM * mhz * 1e6


def bound(bytes_moved: float, ops: float, int_rate: float):
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_o = ops / int_rate * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def timed(fn, reps: int = 1):
    """(mean device ms over reps, result of the last call)."""
    box = []
    ms = cuda_ms(lambda: box.append(fn()), reps)
    return ms, box[-1]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script measures the port on a GPU only",
              file=sys.stderr)
        return 1
    from swimm_tpu_torch.db import build_db
    from swimm_tpu_torch.fasta import FastaRecord
    from swimm_tpu_torch.models import engine
    from swimm_tpu_torch.models.engine import SearchConfig, search
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

    # ---- phase 2: build + kernels vs plain ----
    t = time.perf_counter()
    scorer.kernels()
    phases["build_s"] = time.perf_counter() - t
    for line in _build.BUILD_LOGS.get("sw_ragged", "").splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            note(f"ptxas: {line.strip()}")
    errs = {"sw_ragged_kernel": 0, "sw_ragged_qtile_kernel": 0}
    t = time.perf_counter()
    compare_kernels(errs)
    phases["compare_s"] = time.perf_counter() - t

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
    note(f"packed: {n_rows} blocks, tile stream {tiles_np.shape} "
         f"({tiles_np.nbytes / 1e6:.1f} MB)")
    t = time.perf_counter()
    dev_db = engine.device_tiles(packed)
    torch.cuda.synchronize()
    phases["upload_s"] = time.perf_counter() - t
    longest_block_check(dev_db, torch.from_numpy(build_query_profile(
        queries[0].codes, "BLOSUM62", 16)).cuda(), errs)

    t = time.perf_counter()
    search(packed, queries, config)                      # warm-up
    phases["warmup_search_s"] = time.perf_counter() - t
    scorer.score_tiles.launches = 0
    longquery.score_qtile.launches = 0
    results, met = search(packed, queries, config)
    launches = {"sw_ragged_kernel": scorer.score_tiles.launches,
                "sw_ragged_qtile_kernel": longquery.score_qtile.launches}
    note(f"20-query search: {met.seconds:.3f} s, {met.gcups:.1f} GCUPS "
         f"(padded {met.padded_gcups:.1f}), launches {launches}")

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
    assert engine.select_mode(m_long) == "tiles_long"
    search(packed, [long_q], config)                     # warm-up
    scorer.score_tiles.launches = 0
    longquery.score_qtile.launches = 0
    long_res, long_met = search(packed, [long_q], config)
    long_launches = longquery.score_qtile.launches
    launches["sw_ragged_qtile_kernel"] += long_launches
    launches["sw_ragged_kernel"] += scorer.score_tiles.launches
    note(f"{LONG_LEN}-aa query: {long_met.seconds:.3f} s, "
         f"{long_met.gcups:.1f} GCUPS, {long_launches} tile launches")
    if long_launches != -(-m_long // longquery.LONG_TILE_M):
        raise AssertionError(f"expected 5 query-tile launches, got "
                             f"{long_launches}")

    # single-query latency (first query alone)
    _, one_met = search(packed, queries[:1], config)
    breakdown = device_breakdown(lambda: search(packed, queries, config))
    note(f"20-query search under torch.profiler: {breakdown}")

    # ---- phase 5: exactness at scale ----
    t = time.perf_counter()
    n_checked = check_hits(packed, queries, results, config, n_oracle=3)
    n_checked += check_hits(packed, [long_q], long_res, config, n_oracle=0)
    phases["rescore_s"] = time.perf_counter() - t
    note(f"rescored {n_checked} hits exactly (numpy oracle on 3 queries, "
         "plain scorer on all); every top hit is a planted homolog")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")

    # ---- phase 6: kernels vs plain at main-path shapes, timed ----
    tiles, outrow, n_rows, row_start = dev_db[:4]
    T, jt, V = tiles.shape
    lanes_pos = T * jt * V
    qp1 = torch.from_numpy(build_query_profile(
        queries[0].codes, "BLOSUM62", config.m_multiple)).cuda()
    m1 = qp1.shape[1]
    int_rate = int32_ops_per_s()
    note(f"int32 peak from the card: {int_rate / 1e12:.2f} Tops/s")
    k1 = lambda: scorer.score_tiles(tiles, outrow, n_rows, qp1, 10, 2,
                                    row_start=row_start)
    k1_ms, got1 = timed(k1, reps=3)
    p1_ms, ref1 = timed(lambda: scorer.score_tiles_ref(
        tiles, outrow, n_rows, qp1, 10, 2, row_start=row_start))
    e1 = max_err(got1, ref1)
    errs["sw_ragged_kernel"] = max(errs["sw_ragged_kernel"], e1)
    note(f"sw_ragged_kernel vs plain, whole stream at m={m1}: "
         f"max_abs_err={e1}")
    del got1, ref1
    b1, b1_by = bound(tiles.numel() + 4 * T + 4 * 32 * m1 + 4 * n_rows * V,
                      OPS_PER_CELL * lanes_pos * m1, int_rate)
    # kernel 2 on the long query's first two 1024-row tiles: fresh carries
    # in, then the first tile's carries in; the kernel updates its carries
    # in place, so it gets clones and the plain version the originals
    qp_l = torch.from_numpy(build_query_profile(
        long_codes, "BLOSUM62", config.m_multiple)).cuda()
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
    k2_ms = cuda_ms(lambda: longquery.score_qtile(
        tiles, outrow, n_rows, qp2, 10, 2, hc, fc, row_start))
    b2, b2_by = bound(tiles.numel() + 4 * T + 4 * 32 * m2 + 4 * n_rows * V
                      + 16 * lanes_pos, OPS_PER_CELL * lanes_pos * m2,
                      int_rate)
    note(f"kernel times: sw_ragged_kernel {k1_ms:.3f} ms at m={m1} "
         f"(plain {p1_ms:.1f} ms, bound {b1:.3f} ms); "
         f"sw_ragged_qtile_kernel {k2_ms:.3f} ms at tile_m={m2} "
         f"(plain {p2_ms:.1f} ms, bound {b2:.3f} ms)")
    for name, e in errs.items():
        if e != 0:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"(max_abs_err={e})")
    kernels = [
        {"name": "sw_ragged_kernel", "route": "cuda",
         "source": "swimm_tpu_torch/csrc/sw_ragged.cu",
         "replaces": "swimm_tpu/ops/pallas_scorer.py:317",
         "launches": launches["sw_ragged_kernel"],
         "max_abs_err": errs["sw_ragged_kernel"], "exact": True,
         "ms": k1_ms, "plain_ms": p1_ms, "bound_ms": b1, "bound_by": b1_by,
         "library_ms": None, "shape": f"T={T} V={V} m={m1}"},
        {"name": "sw_ragged_qtile_kernel", "route": "cuda",
         "source": "swimm_tpu_torch/csrc/sw_ragged.cu",
         "replaces": "swimm_tpu/ops/longquery.py:208",
         "launches": launches["sw_ragged_qtile_kernel"],
         "max_abs_err": errs["sw_ragged_qtile_kernel"], "exact": True,
         "ms": k2_ms, "plain_ms": p2_ms, "bound_ms": b2, "bound_by": b2_by,
         "library_ms": None, "shape": f"T={T} V={V} tile_m={m2}"},
    ]
    summary = {
        "card": card,
        "db": {"n_seqs": packed.n_seqs, "residues": packed.total_residues,
               "blocks": n_rows, "tiles": T},
        "batch20": {"seconds": met.seconds, "gcups": met.gcups,
                    "padded_gcups": met.padded_gcups,
                    "per_query_s": met.seconds / N_QUERIES,
                    "timers": met.timers},
        "single_query": {"seconds": one_met.seconds, "gcups": one_met.gcups},
        "batch20_profiled": breakdown,
        "long5000": {"seconds": long_met.seconds, "gcups": long_met.gcups,
                     "padded_gcups": long_met.padded_gcups},
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
