"""FASTA reader/writer (L1 data layer).

Parity target: reference component C2 (SURVEY.md section 3): read FASTA,
keep titles, strip whitespace, encode residues. Streaming parser so a
Swiss-Prot-scale database (~0.5M sequences) never holds raw text twice.
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from swimm_tpu_torch.alphabet import encode

# Whitespace stripped from sequence lines: EXACTLY ' ' and '\t', matching
# csrc/swpack.c — any other control character is encoded through the LUT
# (to X) by both parsers, so the two encoders cannot disagree.
_DEL_WS = str.maketrans("", "", " \t")


@dataclass
class FastaRecord:
    title: str          # header line without '>'
    codes: np.ndarray   # uint8 residue codes in [0, 24)

    @property
    def length(self) -> int:
        return int(self.codes.shape[0])


def is_gzip(path) -> bool:
    """True if the file starts with the gzip magic (sniffed, not by
    extension — Swiss-Prot mirrors ship .fasta.gz but users rename)."""
    try:
        with open(path, "rb") as fh:
            return fh.read(2) == b"\x1f\x8b"
    except OSError:
        return False


def iter_fasta(path_or_handle) -> Iterator[FastaRecord]:
    """Stream records from a FASTA file (path, or text handle).

    Gzip-compressed files are detected by magic bytes and decompressed
    transparently (Swiss-Prot distributes .fasta.gz)."""
    own = False
    if isinstance(path_or_handle, (str, os.PathLike)):
        # newline="\n": disable universal-newline translation so a lone
        # '\r' is NOT a line break — it stays in the line and encodes to X
        # through the LUT, exactly like the native parser (csrc/swpack.c
        # splits on '\n' only); with default text mode the two encoders
        # could disagree on CR-only files (r2 review finding)
        if is_gzip(path_or_handle):
            import gzip
            handle = gzip.open(path_or_handle, "rt", newline="\n")
        else:
            handle = open(path_or_handle, "r", newline="\n")
        own = True
    else:
        handle = path_or_handle  # caller-owned handle: caller's newline
        # policy applies; pass a newline="\n" handle for native parity
    try:
        title = None
        chunks: list[str] = []
        for line in handle:
            # line-ending strip identical to the native parser: one '\n',
            # then at most one '\r'
            if line.endswith("\n"):
                line = line[:-1]
            if line.endswith("\r"):
                line = line[:-1]
            if not line:
                continue
            if line.startswith(">"):
                if title is not None:
                    yield FastaRecord(title, encode("".join(chunks)))
                title = line[1:].strip(" \t")
                chunks = []
            else:
                if title is None:
                    raise ValueError("FASTA data before first '>' header")
                chunks.append(line.translate(_DEL_WS))
        if title is not None:
            yield FastaRecord(title, encode("".join(chunks)))
    finally:
        if own:
            handle.close()


def read_fasta(path_or_handle) -> list[FastaRecord]:
    return list(iter_fasta(path_or_handle))


def parse_fasta_str(text: str) -> list[FastaRecord]:
    return read_fasta(io.StringIO(text))


def write_fasta(path, records, width: int = 60) -> None:
    from swimm_tpu_torch.alphabet import decode

    with open(path, "w") as fh:
        for rec in records:
            if isinstance(rec, FastaRecord):
                title, seq = rec.title, decode(rec.codes)
            else:
                title, seq = rec  # (title, str) tuple
            fh.write(f">{title}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i:i + width] + "\n")
