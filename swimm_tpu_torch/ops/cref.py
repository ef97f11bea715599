"""ctypes wrapper for the C reference scorer (counterpart of
swimm_tpu/ops/cref.py).

csrc/swref.c, read as it is and built by swimm_tpu_torch/_cc.py into
build/swimm_tpu_torch/ on first use. The oracle behind the CLI's
``--selfcheck``: every reported hit is rescored here on the host.
"""

from __future__ import annotations

import ctypes

import numpy as np

from swimm_tpu_torch import _cc

_U8 = ctypes.POINTER(ctypes.c_uint8)
_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "swref_score": (ctypes.c_int32, [
        _U8, ctypes.c_int32, _U8, ctypes.c_int32, _I32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32]),
    "swref_score_many": (None, [
        _U8, ctypes.c_int32, _U8, _I64, _I32, ctypes.c_int32, _I32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _I32]),
}


def _load() -> ctypes.CDLL:
    return _cc.load("swref", _SIGNATURES)


def _u8(a: np.ndarray):
    return np.ascontiguousarray(a, dtype=np.uint8)


def sw_score(query: np.ndarray, db: np.ndarray, submat: np.ndarray,
             gap_open: int, gap_extend: int) -> int:
    dll = _load()
    q = _u8(query)
    d = _u8(db)
    sub = np.ascontiguousarray(submat, dtype=np.int32)
    res = dll.swref_score(
        q.ctypes.data_as(_U8), len(q), d.ctypes.data_as(_U8), len(d),
        sub.ctypes.data_as(_I32), sub.shape[0], int(gap_open),
        int(gap_extend))
    if res < 0:
        raise MemoryError("swref_score allocation failure")
    return int(res)


def sw_score_many(query: np.ndarray, db_seqs, submat: np.ndarray,
                  gap_open: int, gap_extend: int) -> np.ndarray:
    dll = _load()
    q = _u8(query)
    seqs = [_u8(s) for s in db_seqs]
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    offs = np.zeros(len(seqs), dtype=np.int64)
    if len(seqs) > 1:
        offs[1:] = np.cumsum(lens[:-1], dtype=np.int64)
    blob = _u8(np.concatenate(seqs) if seqs else np.zeros(0, np.uint8))
    sub = np.ascontiguousarray(submat, dtype=np.int32)
    out = np.zeros(len(seqs), dtype=np.int32)
    dll.swref_score_many(
        q.ctypes.data_as(_U8), len(q), blob.ctypes.data_as(_U8),
        offs.ctypes.data_as(_I64), lens.ctypes.data_as(_I32), len(seqs),
        sub.ctypes.data_as(_I32), sub.shape[0], int(gap_open),
        int(gap_extend), out.ctypes.data_as(_I32))
    if (out < 0).any():
        raise MemoryError("swref_score_many allocation failure")
    return out.astype(np.int64)
