"""Protein alphabet codec (L1 data layer).

Parity target: reference component C2 (FASTA parser + residue encoder),
SURVEY.md section 3. The reference maps residues A..Z to a ~24-symbol
alphabet including ambiguity codes B/Z/X and the stop symbol '*'
(SURVEY.md section 3, C2). We use the canonical NCBI 24-letter ordering
(the same ordering the BLOSUM/PAM tables are published in) plus one extra
PAD symbol used for lane/len padding in the packed DB format.

The PAD symbol's substitution row is a large negative constant so padded
residues can never extend or start an alignment — this is what lets the
kernels skip per-lane end masking (SURVEY.md section 8 "hard parts":
padding residues must score as hard 0-contribution).
"""

from __future__ import annotations

import numpy as np

# Canonical NCBI residue ordering used by published BLOSUM/PAM tables.
ALPHABET = "ARNDCQEGHILKMFPSTWYVBZX*"
ALPHABET_SIZE = len(ALPHABET)  # 24

# Extra sentinel used only for padding packed DB blocks / query tails.
PAD_CODE = ALPHABET_SIZE  # 24
# Total number of codes incl. PAD; kernel-side tables are padded to 32 rows
# so a profile row per code covers every int8 code the kernels can read.
NUM_CODES = ALPHABET_SIZE + 1  # 25
TABLE_CODES = 32  # kernel-facing table height (codes are masked with 31)

# Substitution score assigned to PAD vs anything. Chosen very negative so
# H = max(0, H_diag + s, ...) clamps to 0 on any pad cell, but small enough
# in magnitude that int8 profiles and int16 arithmetic cannot wrap.
PAD_SCORE = -64

_ENCODE_LUT = np.full(256, -1, dtype=np.int16)
for _i, _c in enumerate(ALPHABET):
    _ENCODE_LUT[ord(_c)] = _i
    _ENCODE_LUT[ord(_c.lower())] = _i
# Common FASTA extras folded onto the ambiguity codes, matching the usual
# NCBI convention (and the reference's tolerant encoder, SURVEY.md C2):
#   U (selenocysteine) -> C, O (pyrrolysine) -> K, J (I/L ambiguity) -> L,
#   '-'/'.' (gaps in aligned FASTA) -> X.
for _src, _dst in (("U", "C"), ("O", "K"), ("J", "L"), ("-", "X"), (".", "X")):
    _ENCODE_LUT[ord(_src)] = ALPHABET.index(_dst)
    _ENCODE_LUT[ord(_src.lower())] = ALPHABET.index(_dst)

_DECODE_LUT = np.frombuffer((ALPHABET + "#").encode(), dtype=np.uint8)


def encode(seq: str | bytes) -> np.ndarray:
    """Encode a residue string to uint8 codes in [0, 24).

    Unknown characters map to X (ambiguity) rather than raising, matching
    tolerant research-tool behavior; whitespace is rejected upstream by the
    FASTA parser.
    """
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    raw = np.frombuffer(seq, dtype=np.uint8)
    codes = _ENCODE_LUT[raw]
    codes = np.where(codes < 0, np.int16(ALPHABET.index("X")), codes)
    return codes.astype(np.uint8)


def decode(codes: np.ndarray) -> str:
    """Decode uint8 codes back to a residue string. PAD decodes to '#'."""
    codes = np.asarray(codes)
    out = _DECODE_LUT[np.minimum(codes, NUM_CODES - 1)]
    return out.tobytes().decode("ascii")
