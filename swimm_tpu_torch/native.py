"""ctypes bindings for the native FASTA parser and block packer
(counterpart of swimm_tpu/native.py).

csrc/swpack.c, read as it is and built by swimm_tpu_torch/_cc.py into
build/swimm_tpu_torch/ on first use. ``db.build_db`` takes this route for a
plain FASTA path; its pack is byte for byte the Python packer's. The
residue-encoding table is passed in from alphabet.py, so the native and
Python encoders cannot disagree.
"""

from __future__ import annotations

import ctypes
import subprocess

import numpy as np

from swimm_tpu_torch import _cc
from swimm_tpu_torch.alphabet import _ENCODE_LUT, ALPHABET


class _FastaData(ctypes.Structure):
    _fields_ = [
        ("codes", ctypes.POINTER(ctypes.c_uint8)),
        ("total_residues", ctypes.c_int64),
        ("lengths", ctypes.POINTER(ctypes.c_int32)),
        ("n_seqs", ctypes.c_int64),
        ("tit_offs", ctypes.POINTER(ctypes.c_int64)),
        # POINTER(c_char), not c_char_p: attribute access on c_char_p does
        # an unbounded strlen; exactly titles_len bytes are read instead
        ("titles", ctypes.POINTER(ctypes.c_char)),
        ("titles_len", ctypes.c_int64),
    ]


_SIGNATURES = {
    "swpack_parse_fasta": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(_FastaData)]),
    "swpack_free": (None, [ctypes.POINTER(_FastaData)]),
    "swpack_fill_chunk": (None, [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int8,
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int64]),
}


def _load() -> ctypes.CDLL:
    return _cc.load("swpack", _SIGNATURES)


def available() -> bool:
    """Whether the library builds and loads here (a C compiler is
    needed); build_db packs in Python when it does not."""
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def _lut_bytes() -> np.ndarray:
    # the Python table's -1 (unknown) is X, as in alphabet.encode
    lut = _ENCODE_LUT.copy()
    lut[lut < 0] = ALPHABET.index("X")
    return np.ascontiguousarray(lut.astype(np.uint8))


def parse_fasta(path) -> tuple[np.ndarray, np.ndarray, np.ndarray, list]:
    """Parse a plain (not gzip) FASTA file natively.

    Returns (codes_blob uint8, offsets int64 per seq, lengths int32,
    titles list[str]).
    """
    dll = _load()
    lut = _lut_bytes()
    data = _FastaData()
    rc = dll.swpack_parse_fasta(
        str(path).encode(), lut.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(data))
    if rc != 0:
        raise ValueError(f"swpack_parse_fasta failed rc={rc} for {path}")
    try:
        n = int(data.n_seqs)
        if n == 0:
            return (np.zeros(0, np.uint8), np.zeros(0, np.int64),
                    np.zeros(0, np.int32), [])
        if data.total_residues:
            codes = np.ctypeslib.as_array(
                data.codes, shape=(data.total_residues,)).copy()
        else:
            codes = np.zeros(0, np.uint8)   # all-empty sequences: NULL blob
        lengths = np.ctypeslib.as_array(data.lengths, shape=(n,)).copy()
        toffs = np.ctypeslib.as_array(data.tit_offs, shape=(n + 1,)).copy()
        tblob = ctypes.string_at(data.titles, data.titles_len)
        titles = [tblob[toffs[i]:toffs[i + 1]].decode("utf-8", "replace")
                  .rstrip("\n") for i in range(n)]
    finally:
        dll.swpack_free(ctypes.byref(data))
    offsets = np.zeros(n, dtype=np.int64)
    if n > 1:
        offsets[1:] = np.cumsum(lengths[:-1], dtype=np.int64)
    return codes, offsets, lengths, titles


def fill_chunk(codes_blob: np.ndarray, offsets: np.ndarray,
               lengths: np.ndarray, order: np.ndarray,
               L: int, V: int, pad: int) -> np.ndarray:
    """Pack len(order) sequences into an (ceil(len(order) / V), L, V) int8
    chunk natively."""
    dll = _load()
    n = len(order)
    out = np.empty((-(-n // V), L, V), dtype=np.int8)
    # the contiguous copies are named so they live through the call
    blob = np.ascontiguousarray(codes_blob, np.uint8)
    offs = np.ascontiguousarray(offsets, np.int64)
    lens = np.ascontiguousarray(lengths, np.int32)
    idx = np.ascontiguousarray(order, np.int64)
    dll.swpack_fill_chunk(
        blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, L, V, pad,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), out.size)
    return out
