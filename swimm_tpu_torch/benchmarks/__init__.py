"""Measurements of the card: counterparts of the JAX package's
benchmarks/roofline.py (``roofline``: the attainable instruction rates, the
walk's instructions per cell, speed-of-light GCUPS and MFU) and
benchmarks/probe_narrow_int.py (``probe_narrow_int``: the DP step's op mix
in int32, 16x2 and 8x4 lanes), whose two kernels are in csrc/probe.cu; and
the exactness guards, counterparts of benchmarks/fuzz_tpu.py (``fuzz``)
and benchmarks/acceptance.py (``acceptance``).

This module holds what they share: the probe library, a device timer, the
card's name, hit-list equality, and the SASS reader that counts the
instructions a step of a kernel's loop issues. Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path

import torch

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
