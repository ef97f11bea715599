"""Build and load the package's CUDA kernels.

Each ``swimm_tpu_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled on first use by ``nvcc`` into a shared library under
``<repo>/build/swimm_tpu_torch/`` (git-ignored), then loaded with ctypes.
The library's file name carries a hash of its source, so an edited source
is rebuilt and a stale library is never loaded. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "swimm_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: dict = {}
BUILD_LOGS: dict = {}   # source name -> nvcc's output (ptxas register report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of swimm_tpu_torch "
                       "are built on first use and need the CUDA toolkit")


def build(name: str) -> Path:
    """Compile csrc/<name>.cu (if not already built) and return the path
    of the shared library."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOGS[name] = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name} "
                           f"(exit {res.returncode}):\n{BUILD_LOGS[name]}")
    os.replace(tmp, lib)      # atomic: a concurrent build sees all or none
    return lib


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (once) and load csrc/<name>.cu; ``signatures`` maps each C
    function to its argtypes (restype is int: the CUDA error code)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib
