"""Build and load the package's CUDA kernels.

Each ``swimm_tpu_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled on first use by ``nvcc`` into a shared library under
``<repo>/build/swimm_tpu_torch/`` (git-ignored), then loaded with ctypes.
The library's file name carries a hash of its source and of every header
(``csrc/*.cuh``) beside it, so an edited source or header is rebuilt and a
stale library is never loaded. ``build`` takes several sources at once and
runs one nvcc process per source side by side. Nothing here runs at import
time.
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

_LOCK = threading.Lock()     # held while a library builds and loads
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


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha1(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build(*names: str) -> list:
    """Compile each csrc/<name>.cu that is not built yet, all nvcc
    processes started together, and return the shared libraries' paths in
    the order of ``names``."""
    libs = [_lib_path(name) for name in names]
    running = []
    for name, lib in zip(names, libs):
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        running.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, lib, tmp, proc in running:      # wait for every process
        BUILD_LOGS[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit "
                          f"{proc.returncode}):\n{BUILD_LOGS[name]}")
        else:
            os.replace(tmp, lib)  # atomic: a concurrent build sees all or none
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (once) and load csrc/<name>.cu; ``signatures`` maps each C
    function to its argtypes (restype is int: the CUDA error code)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)[0]))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib
