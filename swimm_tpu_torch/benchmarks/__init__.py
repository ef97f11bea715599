"""Measurements of the card: counterparts of the JAX package's
benchmarks/roofline.py (``roofline``: the attainable instruction rates, the
walk's instructions per cell, speed-of-light GCUPS and MFU) and
benchmarks/probe_narrow_int.py (``probe_narrow_int``: the DP step's op mix
in int32, 16x2 and 8x4 lanes), whose two kernels are in csrc/probe.cu; the
exactness guards, counterparts of benchmarks/fuzz_tpu.py (``fuzz``) and
benchmarks/acceptance.py (``acceptance``); and the measurement entry
points, counterparts of benchmarks/bench_*.py (``bench_kernel``,
``bench_serving``, ``bench_longquery``, ``bench_swissprot``,
``bench_evalue``, ``bench_ladder``, ``bench_serve``, ``bench_scaling``;
the headline bench.py is ``swimm_tpu_torch.bench``).

This module holds what they share: the probe library, a device timer, the
card's name, hit-list equality, the SASS reader that counts the
instructions a step of a kernel's loop issues, and the bench scripts'
workload: the query set, the cached synthetic Swiss-Prot-scale DB, a
best-of-reps loop and the C oracle's check of the top hits. Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]

_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
PROBE_SIGNATURES = {
    "chain_launch": [_PTR, _PTR, _I64, _INT, _INT, _PTR],
    "narrow_launch": [_PTR, _PTR, _I64, _INT, _INT, _PTR],
}


def probe_kernels() -> ctypes.CDLL:
    """The built csrc/probe.cu (compiled on first call)."""
    from swimm_tpu_torch.ops import _build
    return _build.load("probe", PROBE_SIGNATURES)


def device_seconds(fn, device: torch.device) -> float:
    """Seconds one fn() call takes: CUDA events around it on a card (the
    device's own clock), the host clock on the CPU."""
    if device.type != "cuda":
        t = time.perf_counter()
        fn()
        return time.perf_counter() - t
    with torch.cuda.device(device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3


def same_hits(a, b) -> bool:
    """Equal (score, sorted index) hit lists, query for query."""
    return all([(h.score, h.sorted_idx) for h in x.hits]
               == [(h.score, h.sorted_idx) for h in y.hits]
               for x, y in zip(a, b))


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def launch_counts() -> dict:
    """Each search kernel's launches so far, by kernel name: the counters
    its wrapper adds one to at every launch on a card."""
    from swimm_tpu_torch.ops import longquery, scorer
    return {"sw_ragged_kernel": scorer.score_tiles.launches,
            "sw_ragged_qtile_kernel": longquery.score_qtile.launches,
            "sw_ragged_packed_kernel": scorer.score_tiles_packed.launches,
            "sw_chunk_kernel": scorer.score_chunks.launches,
            "sw_chunk_qtile_kernel": longquery.score_chunks_qtile.launches}


def where(device: torch.device) -> str:
    """What a measurement ran on: the card's name and power limit, or
    'cpu (no card)'."""
    return card() if device.type == "cuda" else "cpu (no card)"


def bench_queries(n_queries: int) -> list:
    """The bench scripts' query set: lengths from
    default_rng(0).integers(100, 501), then synth_queries(seed=1)."""
    from swimm_tpu_torch.utils.synth import synth_queries
    qlens = list(np.random.default_rng(0).integers(100, 501,
                                                   size=n_queries))
    return synth_queries(n_queries, qlens, seed=1)


def bench_db_dir(n_seqs: int, root=None) -> Path:
    """Where the synthetic DB of n_seqs sequences is cached: root (default
    the repository) / .bench_sp_torch_{n_seqs}."""
    return Path(REPO if root is None else root) / f".bench_sp_torch_{n_seqs}"


def bench_db(n_seqs: int, queries, root=None, fresh: bool = False):
    """The synthetic Swiss-Prot-scale DB of the headline bench and
    bench_swissprot: synth_fasta_fast(seed=2, homolog_frac=0.0005) with
    ``queries`` as the homologs' sources, packed by build_db's native route
    at V=128, both cached in bench_db_dir (sp.fasta, db/). A cached pack
    is loaded unless ``fresh``. Returns (packed, {"synth_s",
    "total_residues", "db_build_s"} of what this call made)."""
    from swimm_tpu_torch.db import build_db, load_db
    from swimm_tpu_torch.utils.synth import synth_fasta_fast
    root = bench_db_dir(n_seqs, root)
    root.mkdir(parents=True, exist_ok=True)
    fasta, dbdir = root / "sp.fasta", root / "db"
    if not fresh and (dbdir / "manifest.json").exists():
        return load_db(dbdir), {}
    made = {}
    if fresh or not fasta.exists():
        t = time.perf_counter()
        made["total_residues"] = synth_fasta_fast(
            fasta, n_seqs, seed=2, queries=[q.codes for q in queries],
            homolog_frac=0.0005)
        made["synth_s"] = time.perf_counter() - t
    t = time.perf_counter()
    packed = build_db(str(fasta), dbdir, V=128)
    made["db_build_s"] = time.perf_counter() - t
    return packed, made


class MissingDb(FileNotFoundError):
    """The cached bench DB a script reads is not there."""


def cached_bench_db(n_seqs: int, root=None):
    """The cached pack of bench_db, memmapped; MissingDb when absent."""
    from swimm_tpu_torch.db import load_db
    dbdir = bench_db_dir(n_seqs, root) / "db"
    if not (dbdir / "manifest.json").exists():
        raise MissingDb(dbdir)
    return load_db(dbdir)


def best_of(fn, reps: int, more=None):
    """Run fn() -> (results, SearchMetrics) once, then again while fewer
    than ``reps`` runs were made and ``more()`` (if given) is true.
    Returns (results, metrics) of the fastest run and the number of runs."""
    best, n = None, 0
    while n < reps and (n == 0 or more is None or more()):
        res, met = fn()
        n += 1
        if best is None or met.seconds < best[1].seconds:
            best = (res, met)
    return best[0], best[1], n


def check_hits_vs_oracle(packed, queries, results, n_queries: int = 3):
    """The top 4 hits of the first n_queries queries rescored by the C
    oracle (BLOSUM62 10/2) on the sequences read back from the pack;
    AssertionError on any difference."""
    from swimm_tpu_torch.matrices import get_matrix
    from swimm_tpu_torch.ops import cref
    sub = get_matrix("BLOSUM62")
    for q, res in list(zip(queries, results))[:n_queries]:
        seqs = [packed.seq_codes(h.sorted_idx) for h in res.hits[:4]]
        exp = [int(x) for x in cref.sw_score_many(q.codes, seqs, sub, 10, 2)]
        got = [h.score for h in res.hits[:4]]
        if exp != got:
            raise AssertionError(f"{q.title}: oracle {exp}, search {got}")


def _cuobjdump() -> str:
    from swimm_tpu_torch.ops import _build
    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = Path(_build._nvcc()).with_name("cuobjdump")
    if cand.exists():
        return str(cand)
    raise RuntimeError("cuobjdump not found next to nvcc")


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)|\.L_x_(\d+)")


def sass_functions(lib: Path) -> dict:
    """parse_sass of ``cuobjdump -sass`` of a built library."""
    return parse_sass(subprocess.run([_cuobjdump(), "-sass", str(lib)],
                                     capture_output=True, text=True,
                                     check=True).stdout)


def parse_sass(text: str) -> dict:
    """{function name: ([(address, opcode, operands), ...], {label:
    address})} from cuobjdump's SASS listing."""
    funcs, insns, labels, pending = {}, None, None, []
    for line in text.splitlines():
        head = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if head:
            insns, labels, pending = [], {}, []
            funcs[head.group(1)] = (insns, labels)
            continue
        lab = re.match(r"\s*\.L_x_(\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _INSN.search(line)
        if m and insns is not None:
            addr = int(m.group(1), 16)
            labels.update(dict.fromkeys(pending, addr))
            pending = []
            insns.append((addr, m.group(3), m.group(4).strip()))
    return funcs


def sass_loops(sass: dict, function: str) -> list:
    """The opcodes of each loop body of ``function`` (every backward
    branch, from its target to itself), from sass_functions' reading."""
    insns, labels = sass[function]
    bodies = []
    for addr, op, args in insns:
        if op.split(".")[0] != "BRA":
            continue
        t = _TARGET.search(args)
        if t is None:
            continue
        target = (int(t.group(1), 16) if t.group(1) is not None
                  else labels.get(t.group(2)))
        if target is not None and target <= addr:
            bodies.append([o for a, o, _ in insns if target <= a <= addr])
    return bodies


def counts_per_step(body: list, steps: int) -> dict:
    """A loop body's instructions per step, by opcode (the first word of
    the mnemonic, modifiers dropped)."""
    counts = Counter(op.split(".")[0] for op in body)
    return {op: n / steps for op, n in sorted(counts.items())}


def loop_counts(sass: dict, function: str, steps: int) -> dict:
    """Instructions per step of ``function``'s longest loop, by opcode, the
    loop's own bookkeeping (counter, compare, branch) included: its body
    divided by the ``steps`` it holds."""
    bodies = sass_loops(sass, function)
    if not bodies:
        raise RuntimeError(f"no loop found in the SASS of {function}")
    return counts_per_step(max(bodies, key=len), steps)
