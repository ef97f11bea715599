"""Roofline of the search walk on the card: the counterpart of the JAX
package's benchmarks/roofline.py, with the rates measured on the card
rather than taken from its data sheet.

1. ``ops_per_cell(m)``: the instructions a DP cell of the walk issues, by
   class, each term with the line of csrc/sw_walk_hg.cuh it counts (as the
   JAX function cites ``_dp_steps``).
2. ``measure_ops_per_sec(form)``: the attainable rate of each class, from
   chain_kernel (csrc/probe.cu), the counterpart of the TPU's vpu_kernel:
   8 independent chains v <- max(v + 1, 2000 - v) per element, timed with
   CUDA events as the slope between a short and a long loop count (which
   cancels the launch), in three forms: the TPU's f32 function, and the
   same function in int32 on each of the walk's two half-rate
   instructions, VIADDMNMX and VIMNMX3. The instructions a step issues are
   read from the kernel's SASS, not assumed.
3. ``speed_of_light_gcups(m)``: a band of GCUPS. Low: the slower of the
   half-rate pipe (the instructions of a cell on the pipe VIADDMNMX issues
   on, at that pipe's measured rate) and total issue (all the instructions
   of a cell at the best measured total rate), both counted in the walk's
   SASS with the opcode classes the rates were measured in
   (``walk_sass_per_cell``, ``walk_load``): a rate the card has been seen
   to reach. High: the nominal bound the search kernels are held to
   (``peak_instruction_rate``: every SM starting 128 thread-instructions a
   clock at its maximum clock, ``ops_per_cell``'s count).
4. ``measure_kernel_padded_gcups(m)``: sw_ragged_kernel (ops/scorer.py
   score_tiles) on the JAX function's random inputs, and MFU against the
   nominal peak.

Run: python -m swimm_tpu_torch.benchmarks.roofline [--device cpu]
prints one JSON line. On the CPU the plain versions run at small sizes and
nothing of the card is measured.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from swimm_tpu_torch.benchmarks import (card, counts_per_step,
                                        device_seconds, loop_counts,
                                        probe_kernels, sass_functions,
                                        sass_loops)
from swimm_tpu_torch.models.engine import resolve_device
from swimm_tpu_torch.ops.scorer import raise_on

CHAINS = 8            # independent chains per element (the TPU's STREAMS)
UNROLL = 8            # steps of every chain per loop iteration
ROWS, VK = 512, 128   # the TPU kernel's tile: 65,536 elements
LOOPS = (256, 1024)   # the short and the long loop count of the slope
FORMS = ("f32", "viaddmnmx", "vimnmx3")
# The opcodes that issue on the integer ALU pipe, 64 thread-instructions a
# clock on each SM: measured, the viaddmnmx form (IADD3 + VIADDMNMX a step)
# and a VIADDMNMX + IADD3 + VIMNMX step run at the same total rate, so IADD3
# shares the pipe of the half-rate instructions; VIADD (an addition of a
# constant, as in the walk's t0 - goe) does not: narrow_kernel's int32 step
# (VIADD, 2 VIADDMNMX, VIMNMX3) issues more than 64 a clock in all.
HALF_RATE_PIPE = ("IADD3", "IMNMX", "ISETP", "LOP3", "VIADDMNMX", "VIMNMX",
                  "VIMNMX3")
INSTR_PER_CLK_SM = 128   # thread-instructions an SM can start per clock:
# 4 warp schedulers x 32 lanes, one instruction per scheduler per clock
# (Hopper architecture white paper). The 64 int32 add/min/max results per
# clock per SM in NVIDIA's arithmetic throughput table for sm_90 is NOT
# the ceiling of the walk: sm_90 fuses an addition into a maximum, and a
# search kernel has already run below the time that table gives for 11
# additions and maxima per cell.
WALK = Path(__file__).resolve().parents[1] / "csrc" / "sw_walk_hg.cuh"
# The walk's instructions per DP cell, in the shortest sm_90 sequence
# (csrc/sw_walk_hg.cuh hg_step, one row r of one db position):
#   (class, per cell, lines of sw_walk_hg.cuh, what each line holds)
WALK_TERMS = (
    ("half_rate", 1.0, (285,), "__viaddmax_s32(e[r], nge, hg[r])"),
    ("half_rate", 1.0, (286,), "__viaddmax_s32_relu(diag,"),
    ("half_rate", 1.0, (297,), "__viaddmax_s32(f, -goe, t0g)"),
    ("half_rate", 1.0, (299,), "__viaddmax_s32(f, nge, t0g)"),
    # the running maximum, two rows per instruction: :290 in kernels 1, 3
    # and 4, :302 in the carry form (kernels 2 and 5)
    ("half_rate", 0.5, (290, 302), "__vimax3_s32(gm[g], tprev,"),
    ("full_rate", 1.0, (295,), "t0 - goe"),
    ("shared_load", 1.0, (286,), "col[r * TABLE_CODES]"),
)
# a VIMNMX in the SASS: on the half-rate pipe
CEILING_TERM = ("half_rate", 1.0, (287,), "min(t0, ceiling)")


def ops_per_cell(m: int, ceiling: bool = False) -> dict:
    """Instructions per DP cell of the walk (csrc/sw_walk_hg.cuh), by
    class: 'half_rate' (VIADDMNMX, VIMNMX3, and the ceiling's VIMNMX: the
    integer pipe of HALF_RATE_PIPE, 64 thread-instructions a clock on each
    SM), 'full_rate' (t0 - goe, a VIADD, which issues beside that pipe)
    and 'shared_load' (the profile entry S), and their 'total'. The
    ceiling variant (sw_*_kernel<true>) adds a minimum. The count is the
    same for every profile length m (a multiple of 8): the per-strip and
    per-position work (the code load, the strip carries, their addressing)
    is outside it, as the nominal bound of chip_smoke.py has always left
    it; walk_sass_per_cell reads it from a kernel's SASS."""
    if m <= 0 or m % 8:
        raise ValueError(f"m={m} must be a positive multiple of 8")
    out = {"half_rate": 0.0, "full_rate": 0.0, "shared_load": 0.0}
    for cls, n, _, _ in WALK_TERMS + ((CEILING_TERM,) if ceiling else ()):
        out[cls] += n
    out["total"] = sum(out.values())
    return out


def _stats(samples: list) -> dict:
    """Median and spread of repeated slope estimates (the JAX package's
    benchmarks/roofline._stats): one point cannot tell a change from the
    noise between runs. spread_pct = (max - min) / median."""
    s = sorted(samples)
    med = s[len(s) // 2] if len(s) % 2 else 0.5 * (s[len(s) // 2 - 1]
                                                   + s[len(s) // 2])
    return {"median": med, "min": s[0], "max": s[-1], "n": len(s),
            "spread_pct": 100.0 * (s[-1] - s[0]) / med if med else 0.0}


def _check_chains(x, loops: int, form: str) -> None:
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS} (got {form!r})")
    want = torch.float32 if form == "f32" else torch.int32
    if x.dtype != want:
        raise ValueError(f"the {form} form takes {want} (got {x.dtype})")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if not 0 <= loops < 1 << 31:
        raise ValueError(f"loops={loops} must be in 0..2^31-1")


def chains_ref(x, loops: int, form: str):
    """Plain PyTorch version of chain_kernel on any device: CHAINS chains
    started at x + 17 s, loops * UNROLL steps of v <- max(v + 1, 2000 - v),
    the maximum over the chains (every form computes it; the form only
    picks the type). In f32 the same operations in the same order as the
    TPU's vpu_kernel."""
    _check_chains(x, loops, form)
    s = torch.arange(CHAINS, device=x.device).view((CHAINS,) + (1,) * x.dim())
    v = x + (17 * s).to(x.dtype)
    for _ in range(loops * UNROLL):
        v = torch.maximum(v + 1, 2000 - v)
    return v.amax(0)


def chains(x, loops: int, form: str):
    """chain_kernel_<form> (csrc/probe.cu) on a CUDA tensor, chains_ref on
    a CPU one. x: float32 for 'f32', int32 for the int32 forms (the chains
    grow by one a step: keep |x| + 2,119 + loops * UNROLL below 2^31).
    Returns the maximum over the chains, shaped as x."""
    _check_chains(x, loops, form)
    if x.device.type == "cpu":
        return chains_ref(x, loops, form)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        err = probe_kernels().chain_launch(
            x.data_ptr(), out.data_ptr(), x.numel(), loops,
            FORMS.index(form), torch.cuda.current_stream(x.device).cuda_stream)
    raise_on(err, f"chain_kernel_{form}")
    chains.launches += 1
    return out


chains.launches = 0   # chain_kernel launches (never the plain path)


def chain_input(form: str, tiles: int, device) -> torch.Tensor:
    """(tiles, 512, 128) inputs: the TPU function's jnp.linspace(0, 1) in
    f32 (as JAX computes it: iota times 1 / 65,535, in f32); in int32,
    0..2,999 in turn (chains starting below and above 1,000)."""
    n = tiles * ROWS * VK
    if form == "f32":
        step = torch.tensor(1.0 / (ROWS * VK - 1), dtype=torch.float32)
        x = (torch.arange(ROWS * VK, dtype=torch.float32) * step).repeat(tiles)
    else:
        x = torch.arange(n, dtype=torch.int32) % 3000
    return x.view(tiles, ROWS, VK).to(device)


def card_filling_tiles(device) -> int:
    """TPU tiles (65,536 threads each) that fill the card: 8 waves of 8
    blocks of 256 threads on every SM (33 on 132 SMs). One tile is about
    15 warps an SM. 1 on the CPU."""
    if device.type != "cuda":
        return 1
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, sms // 4)


def step_counts(device) -> dict:
    """{form: instructions per chain step by class}: on a card read from
    the SASS of the built chain kernels (the loop holds UNROLL steps of
    CHAINS chains; its counter, compare and branch are counted in); on the
    CPU the plain version's torch operations per step."""
    if device.type != "cuda":
        return {f: {"torch_op": 3.0} for f in FORMS}
    from swimm_tpu_torch.ops import _build
    probe_kernels()
    sass = sass_functions(_build.build("probe")[0])
    return {f: loop_counts(sass, f"chain_kernel_{f}", UNROLL * CHAINS)
            for f in FORMS}


@functools.lru_cache(maxsize=None)
def _library_sass(lib: str) -> dict:
    """sass_functions of the built csrc/<lib>.cu (built here if need be)."""
    from swimm_tpu_torch.ops import _build
    return sass_functions(_build.build(lib)[0])


def walk_sass_per_cell(lib: str = "sw_ragged",
                       function: str = "sw_ragged_kernelILb0E") -> dict:
    """Instructions per DP cell that a search kernel issues, by opcode,
    read from its SASS: the innermost loop over db positions of a 32-row
    strip (the loop with the fewest instructions whose VIADDMNMX count is
    a multiple of 4 x 32; 4 a cell), its instructions over its cells.
    ``function`` is a fragment of the kernel's SASS name in the library
    ``lib`` (default kernel 1 without the ceiling). What ops_per_cell
    counts, and the addressing and bookkeeping it leaves out."""
    sass = _library_sass(lib)
    name = next((n for n in sass if function in n), None)
    if name is None:
        raise RuntimeError(f"no kernel {function!r} in the SASS of {lib}")
    strips = []
    for body in sass_loops(sass, name):
        n = sum(op.startswith("VIADDMNMX") for op in body)
        if n and n % (4 * 32) == 0:
            strips.append((len(body), n // 4, body))
    if not strips:
        raise RuntimeError(f"no 32-row strip loop in the SASS of {name}")
    _, cells, body = min(strips, key=lambda s: s[:2])
    return counts_per_step(body, cells)


def walk_load(per_cell: dict) -> dict:
    """A cell's instructions as the rates count them, from an opcode count
    (walk_sass_per_cell): 'pipe', those of HALF_RATE_PIPE, and 'total',
    every one."""
    return {"pipe": sum(n for op, n in per_cell.items()
                        if op in HALF_RATE_PIPE),
            "total": sum(per_cell.values())}


def measure_ops_per_sec(form: str, n_reps: int = 5, tiles: int = 1,
                        loops: tuple = LOOPS, device=None,
                        per_step: dict | None = None) -> dict:
    """Attainable rate of each instruction class in one chain form, as
    _stats over n_reps slope estimates: the counterpart of the JAX
    package's measure_vpu_ops_per_sec, on ``tiles`` TPU tiles (1: the TPU's
    shape, about 15 warps an SM; card_filling_tiles(): every SM full).
    Each estimate times one launch at loops[0] and one at loops[1] with
    CUDA events; the slope between them cancels the launch. ``per_step``
    is the form's instructions per step by class (step_counts(); read
    here when None)."""
    dev = resolve_device(device)
    if per_step is None:
        per_step = step_counts(dev)[form]
    x = chain_input(form, tiles, dev)
    lo, hi = loops
    chains(x, lo, form)                      # build + warm
    steps_lo = lo * UNROLL * CHAINS * x.numel()
    steps_hi = hi * UNROLL * CHAINS * x.numel()
    rates = []
    for _ in range(n_reps):
        t_lo = device_seconds(lambda: chains(x, lo, form), dev)
        t_hi = device_seconds(lambda: chains(x, hi, form), dev)
        rates.append(steps_hi / t_hi if t_hi <= t_lo
                     else (steps_hi - steps_lo) / (t_hi - t_lo))
    total = sum(per_step.values())
    return {"form": form, "tiles": tiles, "threads": x.numel(),
            "loops": list(loops), "per_step": per_step,
            "steps_per_s": _stats(rates),
            "total": _stats([r * total for r in rates]),
            "by_class": {c: _stats([r * n for r in rates])
                         for c, n in per_step.items()}}


def peak_instruction_rate() -> float:
    """The card's nominal thread-instruction rate: SMs x 128 a clock x the
    maximum SM clock, both read from card 0. What the search kernels'
    bound_ms has always been computed with."""
    resolve_device(None)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INSTR_PER_CLK_SM * mhz * 1e6


def walk_rates(forms: dict) -> dict:
    """The two rates the low end of the band needs, from measured forms
    ({form: measure_ops_per_sec(...)} at the card-filling size, with their
    SASS counts): 'half_rate_per_s', the instructions of HALF_RATE_PIPE a
    second in the best int32 form (the pipe VIADDMNMX and VIMNMX3 issue
    on, which the IADD3 of each step shares: VIADDMNMX alone is issued at
    half the pipe's rate in the viaddmnmx form, and the walk runs above
    that), and 'issue_per_s', the best total instruction rate of any
    form."""
    pipe = max(sum(r["by_class"][c]["median"] for c in HALF_RATE_PIPE
                   if c in r["by_class"])
               for f, r in forms.items() if f != "f32")
    return {"half_rate_per_s": pipe,
            "issue_per_s": max(r["total"]["median"] for r in forms.values())}


def walk_bound_s(cells: float, load: dict, rates: dict) -> dict:
    """The least seconds ``cells`` DP cells take on the measured rates, by
    what bounds them: 'half-rate pipe', load['pipe'] instructions a cell
    at rates['half_rate_per_s'], and 'issue', load['total'] a cell at
    rates['issue_per_s'] (load: walk_load; rates: walk_rates). The walk
    takes at least the larger."""
    return {"half-rate pipe": cells * load["pipe"] / rates["half_rate_per_s"],
            "issue": cells * load["total"] / rates["issue_per_s"]}


def speed_of_light_gcups(m: int, rates: dict | None = None,
                         peak: float | None = None,
                         ceiling: bool = False,
                         load: dict | None = None) -> dict:
    """The band of GCUPS the walk can reach at profile length m.

    low: the slower of walk_bound_s' two bounds for kernel 1's ``load``
    (walk_load of its SASS, with or without the ceiling) on ``rates``;
    'low_by' names which. high: the nominal bound, ops_per_cell's total
    at ``peak`` (peak_instruction_rate()). Each is measured or read on the
    card when not given."""
    opc = ops_per_cell(m, ceiling)
    if rates is None:
        dev = resolve_device(None)
        tiles = card_filling_tiles(dev)
        per_step = step_counts(dev)
        rates = walk_rates({f: measure_ops_per_sec(
            f, tiles=tiles, device=dev, per_step=per_step[f])
            for f in FORMS})
    if load is None:
        resolve_device(None)
        load = walk_load(walk_sass_per_cell(
            function=f"sw_ragged_kernelILb{int(ceiling)}E"))
    if peak is None:
        peak = peak_instruction_rate()
    t = walk_bound_s(1e9, load, rates)
    by = max(t, key=t.get)
    return {"low": 1.0 / t[by], "low_by": by,
            "pipe_gcups": 1.0 / t["half-rate pipe"],
            "issue_gcups": 1.0 / t["issue"],
            "high": peak / opc["total"] / 1e9}


def mfu_pct(padded_gcups: float, m: int, peak: float,
            ceiling: bool = False) -> float:
    """Instructions the kernel issues a second (padded cells x
    ops_per_cell) as a share of the nominal peak, in percent."""
    issued = padded_gcups * 1e9 * ops_per_cell(m, ceiling)["total"]
    return 100.0 * issued / peak


def kernel_inputs(m: int, tiles: int, device):
    """The JAX function's random inputs (rng 0): (T, 32, 128) int8 codes
    0-19, 8 tiles a block (the last block takes any remainder), and a
    (32, m) profile of -4..11 with rows 24 and above at -64."""
    jt, V = 32, 128
    rng = np.random.default_rng(0)
    n_rows = max(tiles // 8, 1)
    codes = rng.integers(0, 20, size=(tiles, jt, V), dtype=np.int8)
    outrow = np.minimum(np.arange(tiles) // (tiles // n_rows),
                        n_rows - 1).astype(np.int32)
    qp = rng.integers(-4, 12, size=(32, m), dtype=np.int32)
    qp[24:] = -64
    return (torch.from_numpy(codes).to(device),
            torch.from_numpy(outrow).to(device), n_rows,
            torch.from_numpy(qp).to(device))


def measure_kernel_padded_gcups(m: int = 1024, tiles: int | None = None,
                                n_reps: int = 5, device=None) -> dict:
    """Padded-cell GCUPS of sw_ragged_kernel (ops/scorer.score_tiles, gaps
    10/2) at profile length m on kernel_inputs, as _stats over n_reps
    slope estimates between 2 and 6 launches back to back (timed with CUDA
    events). tiles: 1,024 on a card by default (128 blocks, one CUDA block
    each: it fills 128 of 132 SMs once), 16 on the CPU; 50,865 is the
    search DB's size."""
    from swimm_tpu_torch.ops import scorer
    dev = resolve_device(device)
    T = tiles if tiles is not None else (1024 if dev.type == "cuda" else 16)
    codes, outrow, n_rows, qp = kernel_inputs(m, T, dev)
    row_start = scorer.row_starts(outrow, n_rows)

    def run(depth):
        for _ in range(depth):
            scorer.score_tiles(codes, outrow, n_rows, qp, 10, 2,
                               row_start=row_start)

    run(1)                                   # build + warm
    cells = codes.numel() * m
    rates = []
    for _ in range(n_reps):
        t_lo = device_seconds(lambda: run(2), dev)
        t_hi = device_seconds(lambda: run(6), dev)
        rates.append(6 * cells / t_hi / 1e9 if t_hi <= t_lo
                     else 4 * cells / (t_hi - t_lo) / 1e9)
    return dict(_stats(rates), tiles=T, blocks=n_rows, m=m)


def report(device=None, n_reps: int = 5) -> dict:
    """Everything main prints: the rates of every form at the TPU's shape
    and at the card-filling size, the band, kernel 1's padded GCUPS at
    1,024 tiles and at the search DB's 50,865, and MFU. On the CPU at small
    sizes, with nothing of the card."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    m = 1024 if on_card else 64
    loops = LOOPS if on_card else (1, 2)
    steps = step_counts(dev)
    fill = card_filling_tiles(dev)
    tile = {f: measure_ops_per_sec(f, n_reps, 1, loops, dev, steps[f])
            for f in FORMS}
    filled = {f: measure_ops_per_sec(f, n_reps, fill, loops, dev, steps[f])
              for f in FORMS}
    meas = measure_kernel_padded_gcups(m, None, n_reps, dev)
    big = measure_kernel_padded_gcups(m, 50_865 if on_card else 24,
                                      n_reps, dev)
    opc = ops_per_cell(m)

    def rates(forms):
        return {f: {"steps_per_s": r["steps_per_s"]["median"],
                    "total_per_s": r["total"]["median"],
                    "total_spread_pct": r["total"]["spread_pct"],
                    "by_class_per_s": {c: s["median"]
                                       for c, s in r["by_class"].items()}}
                for f, r in forms.items()}

    out = {"device": str(dev), "card": card() if on_card else None,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "m": m, "ops_per_cell": opc,
           "sass_per_step": steps if on_card else "not measured",
           "ops_per_sec_tpu_tile": rates(tile),
           "ops_per_sec_filled": dict(rates(filled), tiles=fill),
           "measured_padded_gcups": meas["median"],
           "measured_padded_gcups_band": [meas["min"], meas["max"]],
           "measured_padded_gcups_spread_pct": meas["spread_pct"],
           "filled_padded_gcups": big,
           "n_reps": meas["n"]}
    if not on_card:
        out.update(peak_instruction_rate="not measured",
                   sol_gcups_band="not measured", mfu_pct="not measured")
        return out
    walk = walk_rates(filled)
    peak = peak_instruction_rate()
    k1 = walk_sass_per_cell()
    sol = speed_of_light_gcups(m, walk, peak, load=walk_load(k1))
    out.update(walk_rates=walk, walk_sass_per_cell=k1,
               walk_load=walk_load(k1),
               peak_instruction_rate=peak,
               sol_gcups_band=[sol["low"], sol["high"]], sol=sol,
               kernel_issued_per_s=meas["median"] * 1e9 * opc["total"],
               mfu_pct=mfu_pct(meas["median"], m, peak),
               mfu_pct_band=[mfu_pct(meas["min"], m, peak),
                             mfu_pct(meas["max"], m, peak)],
               filled_mfu_pct=mfu_pct(big["median"], m, peak),
               filled_pct_of_low=100.0 * big["median"] / sol["low"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m swimm_tpu_torch.benchmarks.roofline",
        description="Measured instruction rates, speed-of-light GCUPS and "
                    "MFU of the search walk on the card (one JSON line).")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions at "
                         "small sizes; nothing of the card measured)")
    ap.add_argument("--n-reps", type=int, default=5)
    args = ap.parse_args(argv)
    print(json.dumps(report(args.device, args.n_reps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
