"""Synthetic protein data from a seed: the database and the queries.

A frozen, vectorised copy of the generator the port's bench scripts use
(``swimm_tpu_torch/utils/synth.py``: ``synth_fasta_fast`` and ``mutate``),
kept here so that the yardstick does not move when the program does:

- sequence lengths follow a lognormal law (median, sigma) clipped to
  [min_len, max_len]. They are drawn as the law's quantiles at (i + 0.5) / n
  and put in an order drawn from the seed, so every seed gets the same
  multiset of lengths (the same work) in another order;
- residues are drawn i.i.d. from Swiss-Prot's background frequencies
  (``AA_FREQ``), through a 65,536-entry lookup table in one call;
- a fraction of the database are planted homologs: mutated copies of the
  cell's own queries (substitutions at a rate drawn from a range, and
  indels), so that each hit list holds real alignments.

Sequences are kept as ASCII letter bytes; the database is written as one
FASTA file (``>S0000042`` headers, one line of residues each) that the
port's ``build_db`` packs, and the reference reads the same letters.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

#: the 20 standard amino acids in the order of AA_FREQ
LETTERS = b"ARNDCQEGHILKMFPSTWYV"

#: Swiss-Prot residue background frequencies (copy of the port's
#: utils/synth._AA_FREQ), normalised
AA_FREQ = np.array([
    0.0826, 0.0553, 0.0406, 0.0546, 0.0137, 0.0393, 0.0674, 0.0708,
    0.0227, 0.0593, 0.0965, 0.0582, 0.0241, 0.0386, 0.0472, 0.0660,
    0.0535, 0.0110, 0.0292, 0.0687,
])
AA_FREQ = AA_FREQ / AA_FREQ.sum()

#: width of the numeric part of a database title (S0000042)
TITLE_DIGITS = 7


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """An independent generator per (seed, named stream): adding a stream
    never shifts the numbers another stream draws."""
    tag = int.from_bytes(stream.encode()[:8].ljust(8, b"\0"), "little")
    return np.random.default_rng(np.random.SeedSequence([int(seed), tag]))


def _lut() -> np.ndarray:
    """(65536,) letter per uniform 16-bit draw, in the AA_FREQ shares."""
    edges = np.round(np.cumsum(AA_FREQ) * 65536).astype(np.int64)
    edges[-1] = 65536
    counts = np.diff(np.concatenate([[0], edges]))
    return np.repeat(np.frombuffer(LETTERS, np.uint8), counts)


def random_letters(rng: np.random.Generator, n: int) -> np.ndarray:
    """n residues (ASCII bytes) drawn from AA_FREQ."""
    return _lut()[rng.integers(0, 65536, size=n, dtype=np.uint16)]


def _ndtri(p: np.ndarray) -> np.ndarray:
    """The standard normal quantile (Acklam's rational approximation,
    relative error < 1.2e-9: far below one residue at any length here)."""
    a = [-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00]
    p = np.asarray(p, dtype=np.float64)
    out = np.empty_like(p)
    lo, hi = p < 0.02425, p > 1 - 0.02425
    mid = ~(lo | hi)
    q = p[mid] - 0.5
    r = q * q
    out[mid] = ((((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r
                 + a[5]) * q / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3])
                                 * r + b[4]) * r + 1))
    for sel, sign, pp in ((lo, 1.0, p[lo]), (hi, -1.0, 1 - p[hi])):
        q = np.sqrt(-2 * np.log(pp))
        out[sel] = sign * ((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q
                              + c[4]) * q + c[5])
                           / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q
                              + 1))
    return out


def lognormal_lengths(n: int, median: float, sigma: float, min_len: int,
                      max_len: int) -> np.ndarray:
    """The n quantiles of the clipped lognormal law at (i + 0.5) / n,
    ascending, as int64 lengths."""
    z = _ndtri((np.arange(n) + 0.5) / n)
    lens = np.exp(math.log(median) + sigma * z).astype(np.int64)
    return np.clip(lens, min_len, max_len)


def mutate(rng: np.random.Generator, letters: np.ndarray, sub_rate: float,
           indel_rate: float) -> np.ndarray:
    """Point substitutions at sub_rate, then deletions and insertions at
    indel_rate (the port's utils/synth.mutate, on letters)."""
    out = letters.copy()
    subs = rng.random(len(out)) < sub_rate
    out[subs] = random_letters(rng, int(subs.sum()))
    out = out[rng.random(len(out)) >= indel_rate]
    n_ins = rng.binomial(len(letters), indel_rate)
    if n_ins:
        pos = np.sort(rng.integers(0, len(out) + 1, size=n_ins))
        out = np.insert(out, pos, random_letters(rng, n_ins))
    return out


@dataclass
class Database:
    """The database as the harness made it, in original (FASTA) order."""
    letters: np.ndarray     # uint8 ASCII residues of all sequences, in order
    starts: np.ndarray      # int64 (n + 1,) offsets into letters
    homologs: np.ndarray    # int64 original indices of planted homologs
    homolog_source: np.ndarray  # int64 query index each homolog came from

    @property
    def n_seqs(self) -> int:
        return len(self.starts) - 1

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.starts)

    @property
    def total_residues(self) -> int:
        return int(self.starts[-1])

    def seq(self, i: int) -> np.ndarray:
        return self.letters[self.starts[i]:self.starts[i + 1]]


def make_db(spec: dict, queries: list, seed: int) -> Database:
    """The database of a configuration's ``db`` entry, from the seed:
    spec["n_seqs"] sequences of the lognormal law, of which
    int(n_seqs * homolog_frac) are planted homologs of ``queries`` (letter
    arrays), query j % len(queries) for the j-th homolog."""
    n = int(spec["n_seqs"])
    rng = rng_for(seed, "db")
    lens = lognormal_lengths(n, spec["median_len"], spec["sigma"],
                             spec["min_len"], spec["max_len"])
    lens = lens[rng.permutation(n)]
    n_hom = int(n * spec["homolog_frac"]) if queries else 0
    hom = np.sort(rng.choice(n, size=n_hom, replace=False)).astype(np.int64)
    src = np.arange(n_hom, dtype=np.int64) % max(len(queries), 1)
    lo, hi = spec["homolog_sub_rate"]
    made = []
    for j in range(n_hom):
        h = mutate(rng, queries[src[j]], float(rng.uniform(lo, hi)),
                   spec["homolog_indel_rate"])
        if len(h) < spec["min_len"]:
            h = np.concatenate([h, random_letters(rng,
                                                  spec["min_len"] - len(h))])
        made.append(h)
        lens[hom[j]] = len(h)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    letters = random_letters(rng, int(starts[-1]))
    for j, i in enumerate(hom):
        letters[starts[i]:starts[i + 1]] = made[j]
    return Database(letters, starts, hom, src)


def title(i: int) -> str:
    return f"S{i:0{TITLE_DIGITS}d}"


def orig_index(title_: str) -> int:
    """The original index a database title stands for; ValueError for a
    title the harness did not write."""
    if (len(title_) != TITLE_DIGITS + 1 or title_[0] != "S"
            or not title_[1:].isdigit()):
        raise ValueError(f"not a database title: {title_!r}")
    return int(title_[1:])


def write_fasta(db: Database, path) -> int:
    """Write the database as FASTA in one pass (``>S0000042`` and one line
    of residues per sequence); returns the bytes written."""
    n = db.n_seqs
    head = TITLE_DIGITS + 3                  # '>', 'S', digits, '\n'
    rec = head + db.lengths + 1              # header, residues, '\n'
    rstart = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(rec, out=rstart[1:])
    buf = np.empty(int(rstart[-1]), dtype=np.uint8)
    is_res = np.ones(len(buf), dtype=bool)
    hdr = np.empty((n, head), dtype=np.uint8)
    hdr[:, 0], hdr[:, 1], hdr[:, -1] = ord(">"), ord("S"), ord("\n")
    idx = np.arange(n, dtype=np.int64)
    for k in range(TITLE_DIGITS):
        hdr[:, 1 + TITLE_DIGITS - k] = 48 + (idx // 10 ** k) % 10
    pos = rstart[:-1, None] + np.arange(head)
    buf[pos] = hdr
    is_res[pos] = False
    buf[rstart[1:] - 1] = ord("\n")
    is_res[rstart[1:] - 1] = False
    buf[is_res] = db.letters
    buf.tofile(str(path))
    return len(buf)


def query_fasta(queries: list) -> str:
    """FASTA text of query letter arrays, titled Q0000, Q0001, ..."""
    return "".join(f">Q{i:04d}\n{q.tobytes().decode()}\n"
                   for i, q in enumerate(queries))
