"""Time variants of the walk of csrc/sw_walk_hg.cuh against each other on one
NVIDIA GPU, in turns, at chip_smoke.py's workload (570,000 synthetic
sequences; the 5,000-aa query's second 1024-row tile for
sw_ragged_qtile_kernel, query 0 for sw_ragged_kernel and sw_chunk_kernel,
the widest pack of the 20 queries for sw_ragged_packed_kernel).

    python3 tools/walk_variants.py [--parent DIR] [--out DIR]

Each variant is a copy of swimm_tpu_torch/csrc with one text substitution
(VARIANTS below; the script stops if a substitution no longer applies):

  shipped        the sources as they are
  S2             sw_ragged_qtile_kernel with two workers, not four
  signed         the carry form reads the code bytes signed, as the other
                 forms do
  signed_S2      both of the above
  fold_f         the carry form keeps a maximum of t0 with the incoming F
                 folded in, in place of the maximum of hg
  asm_nc_s8      the carry form loads the code bytes by ld.global.nc.s8
  all_unsigned   every form reads the code bytes unsigned (kernels 1, 3
                 and 4 too)

--parent DIR adds the csrc directory of another commit as variant
"parent", e.g. from `git archive <commit> swimm_tpu_torch/csrc | tar -x -C
build/parent`. Every variant's libraries are built side by side with the
package's nvcc flags, and every variant is checked against the first one
(scores and both carries of kernel 2, all scores of kernels 1, 3 and 4) and
kernel 2 also against its plain version on small cases with planted
incoming F. Prints the card's name and power limit, each variant's
registers and spills, and each timing; writes the timings as JSON and the
SASS of each library to --out (default build/walk_variants). Exits 1
without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "swimm_tpu_torch" / "csrc"
SOURCES = ("sw_ragged.cu", "sw_chunk.cu", "sw_walk.cuh", "sw_walk_hg.cuh")
SIGNED = ("  using Code = std::conditional_t<carry_form, uint8_t, int8_t>;\n",
          "  using Code = int8_t;\n")
TWO = ("constexpr int QTILE_WORKERS = 4;", "constexpr int QTILE_WORKERS = 2;")
ASM = """
__device__ __forceinline__ int load_code(const int8_t* p) {
  int x;
  asm("ld.global.nc.s8 %0, [%1];" : "=r"(x) : "l"(p));
  return x;
}

// One step of a strip"""
VARIANTS = {  # name -> [(file, old, new)]
    "shipped": [],
    "S2": [("sw_ragged.cu", *TWO)],
    "signed": [("sw_walk_hg.cuh", *SIGNED)],
    "signed_S2": [("sw_walk_hg.cuh", *SIGNED), ("sw_ragged.cu", *TWO)],
    "fold_f": [
        ("sw_walk_hg.cuh", "      if (!carry_form) {\n        if (r & 1) {",
         "      if (true) {\n        if (r & 1) {"),
        ("sw_walk_hg.cuh", "      if (carry_form) {\n        if (r & 1) {",
         "      if (false) {\n        if (r & 1) {"),
        ("sw_walk_hg.cuh", "    int f = top_q[0].y;\n",
         "    int f = top_q[0].y;\n"
         "    if (carry_form) gm[0] = max(gm[0], f);\n"),
        ("sw_walk_hg.cuh", "    gm[g] = CARRY ? -goe : 0;", "    gm[g] = 0;"),
        ("sw_walk_hg.cuh", "  int smax = CARRY ? gm[0] + goe : gm[0];",
         "  int smax = gm[0];")],
    "asm_nc_s8": [
        ("sw_walk_hg.cuh", *SIGNED),
        ("sw_walk_hg.cuh", "\n// One step of a strip", ASM),
        ("sw_walk_hg.cuh", "code_q[a] = cb[(int64_t)a * V];",
         "code_q[a] = carry_form ? load_code(codes + (int64_t)a * V) "
         ": cb[(int64_t)a * V];"),
        ("sw_walk_hg.cuh",
         "code_q[HG_AHEAD - 1] = cb[(int64_t)(j + HG_AHEAD) * V];",
         "code_q[HG_AHEAD - 1] = carry_form ? load_code(codes + "
         "(int64_t)(j + HG_AHEAD) * V) : cb[(int64_t)(j + HG_AHEAD) * V];")],
    "all_unsigned": [("sw_walk_hg.cuh", SIGNED[0],
                      "  using Code = uint8_t;\n")],
}
WHOLE = ("parent", "shipped", "all_unsigned")   # kernels 1, 3, 4 timed too


def note(msg: str) -> None:
    print(msg, flush=True)


def make_variants(work: Path, parent: Path | None) -> dict:
    dirs = {}
    if parent is not None:
        d = work / "parent"
        d.mkdir(parents=True)
        for f in SOURCES:
            shutil.copy(parent / f, d / f)
        dirs["parent"] = d
    for name, subs in VARIANTS.items():
        d = work / name
        d.mkdir(parents=True)
        text = {f: (CSRC / f).read_text() for f in SOURCES}
        for f, old, new in subs:
            if text[f].count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} not found once "
                                 f"in {f}")
            text[f] = text[f].replace(old, new)
        for f, t in text.items():
            (d / f).write_text(t)
        dirs[name] = d
    return dirs


def build(dirs: dict, out: Path) -> dict:
    from swimm_tpu_torch.ops import _build
    procs = []
    for name, d in dirs.items():
        for src in ("sw_ragged", "sw_chunk"):
            lib = d / f"lib{src}.so"
            procs.append((name, src, lib, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                 str(d / f"{src}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, src, lib, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}/{src}:\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        note(f"{name}/{src}: registers {regs}, spill stores {spills}")
        cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True).stdout
        (out / f"sass_{name}_{src}.txt").write_text(sass)
        libs[(name, src)] = lib
    return libs


def bind(path: Path, signatures: dict):
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--out", type=Path, default=ROOT / "build" /
                    "walk_variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("walk_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from swimm_tpu_torch.db import build_db
    from swimm_tpu_torch.models import engine, qpack
    from swimm_tpu_torch.models.profile import build_query_profile
    from swimm_tpu_torch.ops import longquery, scorer
    from swimm_tpu_torch.utils.synth import (random_codes, synth_fasta_fast,
                                             synth_queries)
    args.out.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    note(f"card: {card}")
    work = Path(tempfile.mkdtemp(prefix="walk_variants_"))
    try:
        dirs = make_variants(work, args.parent)
        libs = build(dirs, args.out)
        rag = {n: bind(libs[(n, "sw_ragged")], scorer.RAGGED_SIGNATURES)
               for n in dirs}
        chk = {n: bind(libs[(n, "sw_chunk")], scorer.CHUNK_SIGNATURES)
               for n in dirs}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    st = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def k2(lib, tiles, rs, n, qp, go, ge, h, f):
        out = torch.empty((n, tiles.shape[2]), dtype=torch.int32,
                          device="cuda")
        err = lib.sw_ragged_qtile_launch(
            tiles.data_ptr(), rs.data_ptr(), n, tiles.shape[2],
            tiles.shape[1], qp.data_ptr(), qp.shape[1], go + ge, ge,
            h.data_ptr(), f.data_ptr(), out.data_ptr(), st())
        if err:
            raise RuntimeError(f"sw_ragged_qtile_kernel: CUDA error {err}")
        return out

    # kernel 2 of every variant against its plain version, planted F
    rng = np.random.default_rng(11)
    errs = dict.fromkeys(dirs, 0)
    for counts, V, tm, go, ge in (([1, 5, 2], 128, 104, 10, 2),
                                  ([2, 1, 4], 128, 1024, 0, 3),
                                  ([1, 3], 256, 72, 5, 0),
                                  ([3, 1], 64, 40, 0, 0)):
        tiles, outrow, n = cs.ragged_case(rng, counts, V)
        rs = scorer.row_starts(outrow, n)
        hc, fc, _, _ = cs.random_carries(rng, tiles, rs)
        qp = cs.profile(rng, tm)
        ref = longquery.score_qtile_ref(tiles, outrow, n, qp, go, ge, hc, fc)
        for name, lib in rag.items():
            h, f = hc.clone(), fc.clone()
            got = (k2(lib, tiles, rs, n, qp, go, ge, h, f), h, f)
            torch.cuda.synchronize()
            errs[name] = max([errs[name]] + [cs.max_err(a, b)
                                             for a, b in zip(got, ref)])
    note(f"kernel 2 vs plain, small cases with planted F: max_abs_err "
         f"{errs}")

    # chip_smoke.py's workload
    rng = np.random.default_rng(0)
    queries = synth_queries(cs.N_QUERIES,
                            list(rng.integers(100, 501, size=cs.N_QUERIES)),
                            seed=1)
    with tempfile.TemporaryDirectory() as td:
        fasta = Path(td) / "sp.fasta"
        synth_fasta_fast(fasta, cs.N_SEQS, seed=2,
                         queries=[q.codes for q in queries],
                         homolog_frac=0.0005)
        packed = build_db(str(fasta), Path(td) / "db", V=128)
    tiles, _, n_rows, row_start = engine.device_tiles(packed)[:4]
    _, table = engine.device_chunk_table(packed)
    T, jt, V = tiles.shape
    lrng = np.random.default_rng(3)
    seg = queries[0].codes
    pre = (cs.LONG_LEN - len(seg)) // 2
    long_codes = np.concatenate([random_codes(lrng, pre), seg, random_codes(
        lrng, cs.LONG_LEN - pre - len(seg))])
    qp_l, n_qt = longquery.pad_to_tiles(torch.from_numpy(
        build_query_profile(long_codes, "BLOSUM62", 16)).cuda(), 1024)
    qts = [qp_l[:, i * 1024:(i + 1) * 1024].contiguous()
           for i in range(n_qt)]
    qp1 = torch.from_numpy(build_query_profile(queries[0].codes, "BLOSUM62",
                                               16)).cuda()
    m1 = qp1.shape[1]
    wide = max(qpack.build_query_packs(queries, "BLOSUM62"),
               key=lambda p: p.M)
    qp3, seg3 = (torch.from_numpy(wide.qp).cuda(),
                 torch.from_numpy(wide.seg_of_group).cuda())
    carry1 = scorer.strip_carry(m1, tiles.shape, "cuda")
    carry3 = scorer.strip_carry(wide.M, tiles.shape, "cuda")
    carry4 = scorer.strip_carry(m1, (table.numel,), "cuda")
    out4 = torch.empty((table.n_blocks, V), dtype=torch.int32, device="cuda")
    desc4 = table.bind(table.carry_views(carry4), None, table.out_views(out4))

    def k1(lib):
        out = torch.empty((n_rows, V), dtype=torch.int32, device="cuda")
        if lib.sw_ragged_launch(tiles.data_ptr(), row_start.data_ptr(),
                                n_rows, V, jt, qp1.data_ptr(), m1, 12, 2, 0,
                                0, carry1.data_ptr(), out.data_ptr(), st()):
            raise RuntimeError("sw_ragged_kernel launch failed")
        return out

    def k3(lib):
        out = torch.zeros((n_rows, 24, V), dtype=torch.int32, device="cuda")
        if lib.sw_ragged_packed_launch(
                tiles.data_ptr(), row_start.data_ptr(), n_rows, V, jt,
                qp3.data_ptr(), wide.M, seg3.data_ptr(), 24, 12, 2,
                carry3.data_ptr(), out.data_ptr(), st()):
            raise RuntimeError("sw_ragged_packed_kernel launch failed")
        return out

    def k4(lib):
        if lib.sw_chunk_launch(table.codes0, desc4.data_ptr(),
                               table.block_map.data_ptr(), table.n_blocks, V,
                               qp1.data_ptr(), m1, 12, 2, 0, 0, st()):
            raise RuntimeError("sw_chunk_kernel launch failed")
        return out4.clone()

    sargs = (tiles, row_start, n_rows)
    first = next(iter(dirs))
    h1 = torch.zeros(tiles.shape, dtype=torch.int32, device="cuda")
    f1 = torch.full(tiles.shape, scorer.NEG, dtype=torch.int32,
                    device="cuda")
    k2(rag[first], *sargs, qts[0], 10, 2, h1, f1)   # tile 1's carries in
    h, f = h1.clone(), f1.clone()
    ref2 = (k2(rag[first], *sargs, qts[1], 10, 2, h, f), h, f)
    ref = (k1(rag[first]), k3(rag[first]), k4(chk[first]))
    for name in dirs:
        h, f = h1.clone(), f1.clone()
        got2 = (k2(rag[name], *sargs, qts[1], 10, 2, h, f), h, f)
        e = [max(cs.max_err(a, b) for a, b in zip(got2, ref2)),
             cs.max_err(k1(rag[name]), ref[0]),
             cs.max_err(k3(rag[name]), ref[1]),
             cs.max_err(k4(chk[name]), ref[2])]
        errs[name] = max(errs[name], *e)
        note(f"{name} vs {first}, full size: kernels 2, 1, 3, 4 "
             f"max_abs_err {e}")
        del h, f, got2
    if any(errs.values()):
        raise SystemExit(f"a variant disagrees: {errs}")

    hk, fk = h1.clone(), f1.clone()
    times = {n: {} for n in dirs}
    order = list(dirs)
    for rnd in range(4):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            row = {"k2": cs.cuda_ms(lambda: k2(rag[name], *sargs, qts[1], 10,
                                               2, hk, fk), 3)}
            if name in WHOLE:
                for key, fn, lib in (("k1", k1, rag[name]),
                                     ("k3", k3, rag[name]),
                                     ("k4", k4, chk[name])):
                    fn(lib)
                    row[key] = cs.cuda_ms(lambda: fn(lib), 3)
            for key, ms in row.items():
                times[name].setdefault(key, []).append(ms)
            note(f"round {rnd} {name}: " + ", ".join(
                f"{key} {ms:.3f} ms" for key, ms in row.items()))
    five = {}
    for name in order + order[::-1]:
        h, f = torch.zeros_like(h1), torch.full_like(f1, scorer.NEG)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for q in qts:
            k2(rag[name], *sargs, q, 10, 2, h, f)
        torch.cuda.synchronize()
        five.setdefault(name, []).append(time.perf_counter() - t)
    for name, s in five.items():
        note(f"{name}: the 5,000-aa query's {n_qt} tiles of kernel 2: {s} s")
    (args.out / "walk_variants.json").write_text(json.dumps(
        {"card": card, "ms": times, "five_tiles_s": five}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
