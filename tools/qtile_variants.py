"""Time sw_chunk_qtile_kernel (kernel 5) in variants of
swimm_tpu_torch/csrc against each other on one NVIDIA GPU, in turns, at
chip_smoke.py's workload (570,000 synthetic sequences in 55 chunks; the
5,000-aa query's third 1024-row tile over every chunk in one launch, with
the second tile's carries in) and sw_ragged_qtile_kernel (kernel 2, which
shares its worker count: the long query's second tile over the stream, in
its int32 form and, where the variant has it, its pair form), and kernels
1, 3 and 4 of the variants in WHOLE beside them (query 0 for
sw_ragged_kernel and sw_chunk_kernel, the widest pack of the 20 queries for
sw_ragged_packed_kernel); kernel 1 also on the last of the stream's
8,192-tile windows (its longest blocks, as the streamed search walks them:
k1_last), and kernel 1's pair form (k1p, k1p_last) in every variant that
has it.

    python3 tools/qtile_variants.py [--parent DIR] [--out DIR]

Each variant is a copy of swimm_tpu_torch/csrc with text substitutions
(VARIANTS below; the script stops if a substitution no longer applies):

  shipped     the sources as they are (four workers in the carry form
              and in both pair forms, the pair form's position loop
              unrolled by 2)
  whole_S2    kernel 1's pair form with two workers (WHOLE_PAIR_WORKERS =
              2)
  whole_fast  kernel 1's pair form walking its full strips that have a
              row above and below on kernel 2's step (no test for a
              missing row in the position loop), its edge strips on its own

--parent DIR adds the csrc directory of another commit as variant "parent",
e.g. from `git archive <commit> swimm_tpu_torch/csrc | tar -x -C
build/parent` (then DIR is build/parent/swimm_tpu_torch/csrc); a library
that lacks a newer launcher (a pair form's) is timed without it. Every
variant's libraries are built side by side with the package's nvcc flags.
Every variant's kernel 5 is checked against its plain version on small
cases (chunks of 32 positions beside long ones, random carries in with
planted F), and at full size against the first variant (kernels 5 and 2,
scores and both carries; the pair form against the first variant's int32
form, carries unpacked; kernels 1, 3 and 4 too for the variants in
WHOLE; kernel 1's pair form against the first variant's int32 form).
Prints the card's
name and power limit, each kernel's registers and spills, the 8-bit loads
and PRMTs of kernel 5's SASS, both pair loops' SASS a cell in every variant
and whether every kernel of the parent compiles to the same SASS in
shipped (a kernel that gained a template parameter defaulting to false,
as sw_ragged_kernel<CEIL> did, matched under it),
each timing, and the 5,000-aa query's five
tiles of kernel 5 end to end; writes the timings as JSON and the SASS of
each library to --out (default build/qtile_variants). Exits 1 without a
CUDA device.
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
_HG = "sw_walk_hg.cuh"
VARIANTS = {  # name -> [(file, old, new)]
    "shipped": [],
    "whole_S2": [(_HG, "constexpr int WHOLE_PAIR_WORKERS = 4;",
                  "constexpr int WHOLE_PAIR_WORKERS = 2;")],
    "whole_fast": [(_HG, """      if (rows == STRIP) {
        hg_step_pairs<STRIP, WHOLE>(""", """      if (rows == STRIP && WHOLE && top.h && bot.h) {
        hg_step_pairs<STRIP, false>(hg, e, diag_top, gm, cw + off, n, W,
                                    prof, top, bot, goe2, ngoe2, nge2);
      } else if (rows == STRIP) {
        hg_step_pairs<STRIP, WHOLE>(""")],
}
WHOLE = ("parent", "shipped")   # kernels 1, 3, 4, 5 and 2 (int32) timed
# too; a variant with a pair form times it (pair_*: kernel 2's, whole_*:
# kernel 1's, shipped both)


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


def kernel_key(fn: str):
    """(kernel, its template bools as digits, '' for none) of a mangled
    kernel name, or None: sw_ragged_kernelILb0ELb1E -> ('sw_ragged_kernel',
    '01')."""
    m = re.search(r"(sw_[a-z_]+?kernel)(?:I((?:Lb[01]E)+)E)?", fn)
    return None if m is None else (m.group(1), "".join(
        re.findall(r"Lb([01])E", m.group(2) or "")))


def kernel_resources(log: str) -> dict:
    """ptxas -v output -> {kernel: (registers, spill stores, spill loads)}
    (a kernel named by the part of its mangled name after 'sw_', with its
    template bools: sw_ragged_kernel<01>)."""
    res, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = kernel_key(m.group(1))
            name = (k[0] + (f"<{k[1]}>" if k[1] else "")) if k else m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            res.setdefault(name, [None, int(m.group(1)), int(m.group(2))])
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            res.setdefault(name, [None, 0, 0])[0] = int(m.group(1))
    return res


def byte_loads(sass: str, kernel: str) -> dict:
    """The 8-bit global loads of one kernel's SASS and the PRMTs within six
    instructions behind each that read the loaded register."""
    out, body = {"loads": [], "prmt_behind": 0}, []
    inside = False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        if inside:
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
            if m:
                body.append(m.group(1))
    for i, ins in enumerate(body):
        m = re.match(r"(@\S+\s+)?(LDG\.E\.[US]8\S*)\s+(R\d+)", ins)
        if m:
            out["loads"].append(m.group(2))
            reg = m.group(3)
            if any(re.match(r"(@\S+\s+)?PRMT\s", b) and re.search(
                    rf"\b{reg}\b", b.split(",", 1)[1])
                   for b in body[i + 1:i + 7]):
                out["prmt_behind"] += 1
    return out


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
    libs, resources = {}, {}
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    for name, src, lib, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}/{src}:\n{log}")
        res = kernel_resources(log)
        resources.setdefault(name, {}).update(res)
        note(f"{name}/{src}: [registers, spill stores, spill loads] {res}")
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True).stdout
        (out / f"sass_{name}_{src}.txt").write_text(sass)
        if src == "sw_chunk":
            loads = byte_loads(sass, "sw_chunk_qtile_kernel")
            resources[name]["k5_byte_loads"] = loads
            note(f"{name}: sw_chunk_qtile_kernel 8-bit loads {loads}")
        libs[(name, src)] = lib
    return libs, resources


def bind(path: Path, signatures: dict):
    """The library with every function of `signatures` it has bound (a
    parent's library may lack the newer ones)."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in signatures.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def sass_bodies(path: Path) -> dict:
    """{function name: its instructions (opcode and operands)} of a saved
    SASS listing."""
    from swimm_tpu_torch.benchmarks import parse_sass
    return {name: [(op, args) for _, op, args in insns]
            for name, (insns, _) in parse_sass(path.read_text()).items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--out", type=Path, default=ROOT / "build" /
                    "qtile_variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("qtile_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from swimm_tpu_torch.db import build_db
    from swimm_tpu_torch.models import engine, qpack, stream
    from swimm_tpu_torch.models.profile import build_query_profile
    from swimm_tpu_torch.ops import longquery, scorer
    from swimm_tpu_torch.utils.synth import (random_codes, synth_fasta_fast,
                                             synth_queries)
    args.out.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    note(f"card: {card}")
    work = Path(tempfile.mkdtemp(prefix="qtile_variants_"))
    try:
        dirs = make_variants(work, args.parent)
        libs, resources = build(dirs, args.out)
        rag = {n: bind(libs[(n, "sw_ragged")], scorer.RAGGED_SIGNATURES)
               for n in dirs}
        chk = {n: bind(libs[(n, "sw_chunk")], scorer.CHUNK_SIGNATURES)
               for n in dirs}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    st = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def k5(lib, table, qp, go, ge, hcars, fcars):
        out = torch.empty((table.n_blocks, table.V), dtype=torch.int32,
                          device="cuda")
        desc = table.bind(hcars, fcars, table.out_views(out))
        err = lib.sw_chunk_qtile_launch(
            table.codes0, desc.data_ptr(), table.block_map.data_ptr(),
            table.n_blocks, table.V, qp.data_ptr(), qp.shape[1], go + ge, ge,
            st())
        if err:
            raise RuntimeError(f"sw_chunk_qtile_kernel: CUDA error {err}")
        return out

    # kernel 5 of every variant against its plain version, planted F, on
    # chunks of 32 positions beside long ones
    rng = np.random.default_rng(12)
    errs = dict.fromkeys(dirs, 0)
    for shapes, V, tm, go, ge in (
            (((1, 32), (3, 32), (2, 96), (1, 4480)), 128, 1024, 10, 2),
            (((2, 64), (1, 32), (3, 160)), 128, 104, 0, 3),
            (((1, 32), (2, 96)), 256, 72, 5, 0),
            (((3, 32), (1, 64)), 64, 40, 0, 0),
            (((1, 32), (2, 64)), 512, 1024, 10, 2)):
        clist = [cs.chunk_case(rng, B, L, V) for B, L in shapes]
        table = scorer.ChunkTable(clist)
        cars = [cs.chunk_carries(rng, c)[:2] for c in clist]
        qp = cs.profile(rng, tm)
        ref = [longquery.score_chunk_qtile_ref(c, qp, go, ge, h, f)
               for c, (h, f) in zip(clist, cars)]
        for name, lib in chk.items():
            hs, fs = [h.clone() for h, _ in cars], [f.clone() for _, f in cars]
            outs = table.out_views(k5(lib, table, qp, go, ge, hs, fs))
            torch.cuda.synchronize()
            errs[name] = max([errs[name]] + [
                cs.max_err(a, b) for i, r in enumerate(ref)
                for a, b in zip((outs[i], hs[i], fs[i]), r)])
    note(f"kernel 5 vs plain, small cases with planted F: max_abs_err "
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
    chunks, table = engine.device_chunk_table(packed)
    T, jt, V = tiles.shape
    lrng = np.random.default_rng(3)
    seg = queries[0].codes
    pre = (cs.LONG_LEN - len(seg)) // 2
    long_codes = np.concatenate([random_codes(lrng, pre), seg, random_codes(
        lrng, cs.LONG_LEN - pre - len(seg))])
    qts = longquery.tile_profiles(torch.from_numpy(
        build_query_profile(long_codes, "BLOSUM62", 16)).cuda(), 1024)
    n_qt = len(qts)
    qp1 = torch.from_numpy(build_query_profile(queries[0].codes, "BLOSUM62",
                                               16)).cuda()
    m1 = qp1.shape[1]
    wide = max(qpack.build_query_packs(queries, "BLOSUM62"),
               key=lambda p: p.M)
    qp3, seg3 = (torch.from_numpy(wide.qp).cuda(),
                 torch.from_numpy(wide.seg_of_group).cuda())
    carry1 = scorer.strip_carry(m1, tiles.shape, "cuda")
    carry1p = scorer.strip_carry(m1, tiles.shape, "cuda", pairs=True)
    # the last of the stream's 8,192-tile windows, as the streamed search
    # cuts it (models/stream.plan_windows): its longest blocks
    layout = stream.stream_layout(packed)
    g0, g1 = stream.plan_windows(layout, 8192)[0][-1]
    t0, t1 = int(layout["cum"][g0]), int(layout["cum"][g1])
    last = (tiles[t0:t1], torch.from_numpy(layout["cum"][g0:g1 + 1]
                                           - t0).cuda(), g1 - g0)
    note(f"the last window: blocks {g0}..{g1 - 1}, tiles {t0}..{t1 - 1}")
    carry3 = scorer.strip_carry(wide.M, tiles.shape, "cuda")
    carry4 = scorer.strip_carry(m1, (table.numel,), "cuda")
    out4 = torch.empty((table.n_blocks, V), dtype=torch.int32, device="cuda")
    desc4 = table.bind(table.carry_views(carry4), None, table.out_views(out4))

    def k1(lib, t=tiles, rs=row_start, n=n_rows):
        out = torch.empty((n, V), dtype=torch.int32, device="cuda")
        if lib.sw_ragged_launch(t.data_ptr(), rs.data_ptr(), n, V, jt,
                                qp1.data_ptr(), m1, 12, 2, 0, 0,
                                carry1.data_ptr(), out.data_ptr(), st()):
            raise RuntimeError("sw_ragged_kernel launch failed")
        return out

    def k1p(lib, t=tiles, rs=row_start, n=n_rows):
        # the pair scratch of a stream of T' tiles is 2 T' jt V / 2 words
        car = carry1p.view(-1)[:t.numel()]
        out = torch.empty((n, V), dtype=torch.int32, device="cuda")
        if lib.sw_ragged_pairs_launch(t.data_ptr(), rs.data_ptr(), n, V, jt,
                                      qp1.data_ptr(), m1, 12, 2,
                                      car.data_ptr(), out.data_ptr(), st()):
            raise RuntimeError("sw_ragged_kernel<false, true> launch failed")
        return out

    def k2(lib, h, f):
        out = torch.empty((n_rows, V), dtype=torch.int32, device="cuda")
        if lib.sw_ragged_qtile_launch(
                tiles.data_ptr(), row_start.data_ptr(), n_rows, V, jt,
                qts[1].data_ptr(), 1024, 12, 2, h.data_ptr(), f.data_ptr(),
                out.data_ptr(), st()):
            raise RuntimeError("sw_ragged_qtile_kernel launch failed")
        return out

    def k2p(lib, h, f):
        out = torch.empty((n_rows, V), dtype=torch.int32, device="cuda")
        if lib.sw_ragged_qtile_pairs_launch(
                tiles.data_ptr(), row_start.data_ptr(), n_rows, V, jt,
                qts[1].data_ptr(), 1024, 12, 2, h.data_ptr(), f.data_ptr(),
                out.data_ptr(), st()):
            raise RuntimeError("sw_ragged_qtile_kernel<true> launch failed")
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

    def fresh():
        return (table.carry_views(torch.zeros(
            table.numel, dtype=torch.int32, device="cuda")),
            table.carry_views(torch.full((table.numel,), scorer.NEG,
                                         dtype=torch.int32, device="cuda")))

    def clone(cars):
        return [c.clone() for c in cars]

    # kernel 5's carries entering the long query's third tile (its first
    # two tiles on the first variant), and kernel 2's after one tile
    first = next(iter(dirs))
    h2, f2 = fresh()
    for qt in range(2):
        k5(chk[first], table, qts[qt], 10, 2, h2, f2)
    h1 = torch.zeros(tiles.shape, dtype=torch.int32, device="cuda")
    f1 = torch.full(tiles.shape, scorer.NEG, dtype=torch.int32,
                    device="cuda")
    k2(rag[first], h1, f1)
    hs, fs = clone(h2), clone(f2)
    ref5 = (k5(chk[first], table, qts[2], 10, 2, hs, fs), hs, fs)
    h, f = h1.clone(), f1.clone()
    ref2 = (k2(rag[first], h, f), h, f)
    ref = (k1(rag[first]), k3(rag[first]), k4(chk[first]))
    ref1_last = k1(rag[first], *last)
    # the pair form's carries after the first tile (int32 carries packed)
    pairs = [n for n in dirs
             if hasattr(rag[n], "sw_ragged_qtile_pairs_launch")
             and not n.startswith("whole_")]
    pairs1 = [n for n in dirs if hasattr(rag[n], "sw_ragged_pairs_launch")
              and not n.startswith("pair_")]
    h1p, f1p = longquery.to_pairs(h1), longquery.to_pairs(f1)
    for name in dirs:
        hs, fs = clone(h2), clone(f2)
        got5 = k5(chk[name], table, qts[2], 10, 2, hs, fs)
        h, f = h1.clone(), f1.clone()
        got2 = (k2(rag[name], h, f), h, f)
        e = [max([cs.max_err(got5, ref5[0])] + [
            cs.max_err(a, b) for x, y in zip((hs, fs), ref5[1:])
            for a, b in zip(x, y)]),
             max(cs.max_err(a, b) for a, b in zip(got2, ref2))]
        if name in WHOLE:
            e += [cs.max_err(k1(rag[name]), ref[0]),
                  cs.max_err(k3(rag[name]), ref[1]),
                  cs.max_err(k4(chk[name]), ref[2])]
        if name in pairs:
            hp, fp = h1p.clone(), f1p.clone()
            e.append(max(cs.max_err(k2p(rag[name], hp, fp), ref2[0]),
                          cs.max_err(longquery.from_pairs(hp), ref2[1]),
                          cs.max_err(longquery.from_pairs(fp), ref2[2])))
            del hp, fp
        if name in pairs1:
            e.append(max(cs.max_err(k1p(rag[name]), ref[0]),
                         cs.max_err(k1p(rag[name], *last), ref1_last)))
        errs[name] = max(errs[name], *e)
        note(f"{name} vs {first}, full size: kernels 5, 2 (1, 3, 4) (2 "
             f"in pairs) (1 in pairs, whole stream and last window) "
             f"max_abs_err {e}")
        del hs, fs, got5, h, f, got2
    if any(errs.values()):
        raise SystemExit(f"a variant disagrees: {errs}")

    # the pair loop's SASS a cell in every variant; kernels 1, 3, 4 and 5
    # and kernel 2's int32 form the same SASS in parent and shipped
    sass = {(n, src): sass_bodies(args.out / f"sass_{n}_{src}.txt")
            for n in dirs for src in ("sw_ragged", "sw_chunk")}
    from swimm_tpu_torch.benchmarks import parse_sass
    from swimm_tpu_torch.benchmarks import roofline as rl
    for key, names, function in (
            ("k2p", pairs, "sw_ragged_qtile_kernelILb1E"),
            ("k1p", pairs1, "sw_ragged_kernelILb0ELb1E")):
        for name in names:
            per_cell = rl.walk_sass_per_cell(
                function=function, lanes=2,
                sass=parse_sass((args.out / f"sass_{name}_sw_ragged.txt")
                                .read_text()))
            resources[name][f"{key}_sass_per_cell"] = per_cell
            resources[name][f"{key}_load"] = rl.walk_load(per_cell)
            note(f"{name}: {function} pair loop, SASS a cell "
                 f"{rl.walk_load(per_cell)} {per_cell}")
    if "parent" in dirs:
        for src in ("sw_ragged", "sw_chunk"):
            a = {kernel_key(fn): body
                 for fn, body in sass[("parent", src)].items()}
            b = {kernel_key(fn): body
                 for fn, body in sass[("shipped", src)].items()}
            for key in sorted(k for k in a if k is not None):
                # a template parameter added behind the others defaults to
                # false: <0> in the parent is <00> in shipped
                body = b.get(key, b.get((key[0], key[1] + "0")))
                same = body is not None and a[key] == body
                resources["shipped"][f"same_sass_{key[0]}<{key[1]}>"] = same
                note(f"SASS {src} {key[0]}<{key[1]}>: parent and shipped "
                     f"{'the same' if same else 'DIFFER'} ({len(a[key])} / "
                     f"{len(body or ())} instructions)")
            for key in sorted(set(b) - set(a) - {
                    (k[0], k[1] + "0") for k in a if k is not None}):
                note(f"SASS {src} {key[0]}<{key[1]}>: new in shipped "
                     f"({len(b[key])} instructions)")
    h5, f5 = clone(h2), clone(f2)
    hk, fk = h1.clone(), f1.clone()
    hkp, fkp = h1p.clone(), f1p.clone()
    times = {n: {} for n in dirs}
    order = list(dirs)
    for rnd in range(6):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            row = {}
            if name in WHOLE or not name.startswith(("pair_", "whole_")):
                row["k5"] = cs.cuda_ms(lambda: k5(chk[name], table, qts[2],
                                                  10, 2, h5, f5), 3)
                row["k2"] = cs.cuda_ms(lambda: k2(rag[name], hk, fk), 3)
            if name in pairs:
                row["k2p"] = cs.cuda_ms(lambda: k2p(rag[name], hkp, fkp), 3)
            if name in pairs1:
                row["k1p"] = cs.cuda_ms(lambda: k1p(rag[name]), 3)
                row["k1p_last"] = cs.cuda_ms(lambda: k1p(rag[name], *last),
                                             3)
            if name in WHOLE:
                row["k1_last"] = cs.cuda_ms(lambda: k1(rag[name], *last), 3)
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
        hs, fs = fresh()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for q in qts:
            k5(chk[name], table, q, 10, 2, hs, fs)
        torch.cuda.synchronize()
        five.setdefault(name, []).append(time.perf_counter() - t)
    for name, s in five.items():
        note(f"{name}: the 5,000-aa query's {n_qt} tiles of kernel 5 over "
             f"all {len(chunks)} chunks: {s} s")
    (args.out / "qtile_variants.json").write_text(json.dumps(
        {"card": card, "ms": times, "five_tiles_s": five,
         "resources": resources}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
