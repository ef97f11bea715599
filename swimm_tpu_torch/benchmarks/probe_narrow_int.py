"""Narrow integer lanes for the DP step's op mix on the card: the
counterpart of the JAX package's benchmarks/probe_narrow_int.py.

The JAX probe asks whether Mosaic compiles int16 and int8 elementwise
arithmetic, and whether it buys lane throughput. Here every type compiles,
so the question is the second one: does the step

    h = max(max(a + a, a - lo), max(a, lo)); o = max(h - a, lo)

(an addition, two subtractions and four maxima: "the DP inner step's op
mix", as the JAX probe calls it) run faster per element with two int16
lanes or four int8 lanes in a 32-bit word than in int32? The search
walk's 16-bit lanes wait on the answer. The arithmetic wraps, as JAX's
and torch's integer types do; lo is -1000 in int32 and -120 in int16 and
int8, as in the JAX probe.

``narrow`` runs narrow_kernel (csrc/probe.cu) on a CUDA tensor and
``narrow_ref`` on a CPU one; ``try_kernel`` times one type as the slope
between a short and a long chain of steps (CUDA events), where the launch
is bound by its instructions and not by its 4 MB of memory traffic.

Run: python -m swimm_tpu_torch.benchmarks.probe_narrow_int [--device cpu]
prints one JSON line with the JAX probe's keys (torch, cuda and device in
place of jaxlib and libtpu), and exits 1 when a lane type failed to build,
launch or equal narrow_ref.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from swimm_tpu_torch.benchmarks import (card, device_seconds, loop_counts,
                                        probe_kernels, sass_functions)
from swimm_tpu_torch.benchmarks.roofline import _stats
from swimm_tpu_torch.models.engine import resolve_device
from swimm_tpu_torch.ops.scorer import raise_on

# lane type -> (lo, lane bits, SASS name of its kernel)
LANES = {torch.int32: (-1000, 32, "narrow_kernel_i32"),
         torch.int16: (-120, 16, "narrow_kernel_i16x2"),
         torch.int8: (-120, 8, "narrow_kernel_i8x4")}
NAMES = {"int32": torch.int32, "int16": torch.int16, "int8": torch.int8}
SHAPE = (512, 1024)      # the JAX probe's
STEPS = (256, 4096)      # the short and the long chain of the slope
UNROLL = 8               # narrow steps in the kernel's loop


def _check(x, steps: int) -> None:
    if x.dtype not in LANES:
        raise ValueError(f"lane type must be int32, int16 or int8 (got "
                         f"{x.dtype})")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.numel() * x.element_size() % 4:
        raise ValueError(f"{x.numel()} {x.dtype} elements do not fill whole "
                         "32-bit words")
    if not 0 <= steps < 1 << 31:
        raise ValueError(f"steps={steps} must be in 0..2^31-1")


def narrow_ref(x, steps: int):
    """Plain PyTorch version of narrow_kernel on any device: the step
    chained ``steps`` times in x's own integer type (wrapping)."""
    _check(x, steps)
    lo = LANES[x.dtype][0]
    a = x
    for _ in range(steps):
        h = torch.maximum(torch.maximum(a + a, a - lo), torch.clamp_min(a, lo))
        a = torch.clamp_min(h - a, lo)
    return a


def narrow(x, steps: int, dtype=None):
    """narrow_kernel (csrc/probe.cu) on a CUDA tensor, narrow_ref on a CPU
    one. dtype: the lane type (int32, int16 or int8); x's own when None,
    else x is converted to it first (wrapping, as .to does)."""
    if dtype is not None:
        x = x.to(dtype)
    _check(x, steps)
    if x.device.type == "cpu":
        return narrow_ref(x, steps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.data_ptr() % 4:
        raise ValueError("x must start on a 4-byte boundary")
    bits, name = LANES[x.dtype][1:]
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        err = probe_kernels().narrow_launch(
            x.data_ptr(), out.data_ptr(), x.numel() * x.element_size() // 4,
            steps, bits, torch.cuda.current_stream(x.device).cuda_stream)
    raise_on(err, name)
    narrow.launches += 1
    return out


narrow.launches = 0   # narrow_kernel launches (never the plain path)


def probe_input(dtype, shape=SHAPE, device="cpu") -> torch.Tensor:
    """The JAX probe's input: default_rng(0).integers(-50, 50, shape) in
    the lane type."""
    x = np.random.default_rng(0).integers(-50, 50, size=shape)
    return torch.from_numpy(x).to(dtype).to(device)


def try_kernel(dtype, shape=SHAPE, steps=STEPS, n_reps: int = 5,
               device=None):
    """Build, run and time narrow_kernel in one lane type; return (ok,
    seconds per step of the whole array, error or None), as the JAX
    probe's _try_kernel. ok needs the kernel's 8 steps (the TPU function's
    scan) to equal narrow_ref's. The time is the median over n_reps slope
    estimates between steps[0] and steps[1] steps in one launch."""
    dev = resolve_device(device)
    x = probe_input(dtype, shape, dev)
    lo, hi = steps
    try:
        if not torch.equal(narrow(x, 8), narrow_ref(x, 8)):
            return False, None, "differs from narrow_ref"
        narrow(x, lo)                         # warm
        per = []
        for _ in range(n_reps):
            t_lo = device_seconds(lambda: narrow(x, lo), dev)
            t_hi = device_seconds(lambda: narrow(x, hi), dev)
            per.append(t_hi / hi if t_hi <= t_lo
                       else (t_hi - t_lo) / (hi - lo))
    except RuntimeError as e:   # the probe's job is to report which fail
        return False, None, f"{type(e).__name__}: {str(e)[:200]}"
    return True, _stats(per)["median"], None


def report(device=None, n_reps: int = 5) -> dict:
    """Everything main prints: each lane type at the JAX probe's shape and
    (on a card) at 16 times it, which fills every SM in int8 too; the
    speedups of int16 and int8 over int32; the SASS instructions of a
    step. On the CPU at small step counts, with nothing of the card."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    steps = STEPS if on_card else (1, 2)
    shapes = {"": SHAPE}
    if on_card:
        shapes["_filled"] = (SHAPE[0] * 16, SHAPE[1])
    out = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "device": str(dev), "card": card() if on_card else None,
           "shape": list(SHAPE), "steps": list(steps)}
    for suffix, shape in shapes.items():
        res = {name: try_kernel(dt, shape, steps, n_reps, dev)
               for name, dt in NAMES.items()}
        for name, (ok, per, err) in res.items():
            out[f"{name}_compiles{suffix}"] = ok
            out[f"{name}_s_per_step{suffix}"] = per
            if err:
                out[f"{name}_error{suffix}"] = err
        for name in ("int16", "int8"):
            ok = res["int32"][0] and res[name][0]
            out[f"{name}_speedup_vs_int32{suffix}"] = (
                res["int32"][1] / res[name][1] if ok else None)
    if on_card:
        from swimm_tpu_torch.ops import _build
        probe_kernels()
        sass = sass_functions(_build.build("probe")[0])
        out["sass_per_step"] = {
            name: loop_counts(sass, LANES[dt][2], UNROLL)
            for name, dt in NAMES.items()}
        out["shape_filled"] = list(shapes["_filled"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m swimm_tpu_torch.benchmarks.probe_narrow_int",
        description="The DP step's op mix in int32, 16x2 and 8x4 lanes on "
                    "the card (one JSON line).")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain version; "
                         "nothing of the card measured)")
    ap.add_argument("--n-reps", type=int, default=5)
    args = ap.parse_args(argv)
    out = report(args.device, args.n_reps)
    print(json.dumps(out), flush=True)
    failed = [k for k, v in out.items() if "_compiles" in k and not v]
    if failed:
        print(f"narrow_kernel failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
