"""Build and load the native C helpers (counterpart of swimm_tpu/_cc.py).

The port reads the C sources of the repository's ``csrc/`` as they are:
``swref.c`` (the C reference scorer behind ``--selfcheck``, ops/cref.py)
and ``swpack.c`` (the FASTA parser and block packer, native.py). Each is
compiled on first use by the system C compiler (``$CC``, default ``cc``)
into ``<repo>/build/swimm_tpu_torch/lib<name>_<hash>.so`` (git-ignored);
nothing is written under ``csrc/``. The hash covers the source, the
compiler and its flags, so an edited source is rebuilt and a stale library
is never loaded. The compiler writes a temporary file that is renamed into
place, so concurrent processes (parallel test workers) never load a
half-written library; within a process one lock per library makes the
build and load happen once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

from swimm_tpu_torch.ops._build import BUILD_DIR

CSRC = Path(__file__).resolve().parents[1] / "csrc"
CFLAGS = ["-O2", "-shared", "-fPIC"]

_LOCKS_GUARD = threading.Lock()
_LOCKS: dict = {}    # library name -> its lock
_LIBS: dict = {}     # library name -> loaded CDLL


def lib_path(name: str) -> Path:
    cc = os.environ.get("CC", "cc")
    h = hashlib.sha1((CSRC / f"{name}.c").read_bytes())
    h.update(" ".join([cc, *CFLAGS]).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def _lock_of(name: str) -> threading.Lock:
    with _LOCKS_GUARD:
        return _LOCKS.setdefault(name, threading.Lock())


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (once) and load csrc/<name>.c; ``signatures`` maps each C
    function to its (restype, argtypes)."""
    with _lock_of(name):
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        path = lib_path(name)
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(BUILD_DIR))
            os.close(fd)
            try:
                subprocess.run([os.environ.get("CC", "cc"), *CFLAGS, "-o",
                                tmp, str(CSRC / f"{name}.c")], check=True,
                               capture_output=True)
                os.replace(tmp, path)   # atomic within the same directory
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(path))
        for fn, (restype, argtypes) in signatures.items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        _LIBS[name] = lib
        return lib
