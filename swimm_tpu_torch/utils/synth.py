"""Synthetic protein data generation (copy of swimm_tpu/utils/synth.py).

Generates databases with a realistic length distribution (log-normal, median
~280 aa, Swiss-Prot-like) plus planted homologs so top-k hit lists are
non-trivial. The same seed gives the same bytes as the JAX package's copy.
"""

from __future__ import annotations

import numpy as np

from swimm_tpu_torch.fasta import FastaRecord

# Approximate Swiss-Prot residue background frequencies (order ARNDCQEGHILKMFPSTWYV).
_AA_FREQ = np.array([
    0.0826, 0.0553, 0.0406, 0.0546, 0.0137, 0.0393, 0.0674, 0.0708,
    0.0227, 0.0593, 0.0965, 0.0582, 0.0241, 0.0386, 0.0472, 0.0660,
    0.0535, 0.0110, 0.0292, 0.0687,
])
_AA_FREQ = _AA_FREQ / _AA_FREQ.sum()


def random_codes(rng: np.random.Generator, length: int) -> np.ndarray:
    """Random residue codes over the 20 standard amino acids."""
    return rng.choice(20, size=length, p=_AA_FREQ).astype(np.uint8)


def mutate(rng: np.random.Generator, codes: np.ndarray,
           sub_rate: float = 0.1, indel_rate: float = 0.02) -> np.ndarray:
    """Point-mutate + indel a sequence (for planting homologs)."""
    out = codes.copy()
    subs = rng.random(len(out)) < sub_rate
    out[subs] = rng.choice(20, size=int(subs.sum()), p=_AA_FREQ)
    keep = rng.random(len(out)) >= indel_rate
    out = out[keep]
    n_ins = rng.binomial(len(codes), indel_rate)
    if n_ins:
        pos = np.sort(rng.integers(0, len(out) + 1, size=n_ins))
        out = np.insert(out, pos, random_codes(rng, n_ins))
    return out.astype(np.uint8)


def synth_db(n_seqs: int, seed: int = 0, median_len: int = 280,
             sigma: float = 0.55, min_len: int = 20, max_len: int = 6000,
             queries: list[np.ndarray] | None = None,
             homolog_frac: float = 0.01) -> list[FastaRecord]:
    """Generate a synthetic protein database.

    If ``queries`` are given, a ``homolog_frac`` fraction of db sequences are
    mutated copies of random queries (planted homologs -> realistic top-k).
    """
    rng = np.random.default_rng(seed)
    lens = np.exp(rng.normal(np.log(median_len), sigma, size=n_seqs))
    lens = np.clip(lens.astype(int), min_len, max_len)
    records = []
    n_hom = int(n_seqs * homolog_frac) if queries else 0
    hom_idx = set(rng.choice(n_seqs, size=n_hom, replace=False).tolist()) if n_hom else set()
    for i in range(n_seqs):
        if i in hom_idx:
            src = queries[rng.integers(len(queries))]
            codes = mutate(rng, np.asarray(src, dtype=np.uint8),
                           sub_rate=float(rng.uniform(0.05, 0.4)),
                           indel_rate=0.02)
            if len(codes) < min_len:
                codes = np.concatenate([codes, random_codes(rng, min_len - len(codes))])
            title = f"SYN{i:08d} planted_homolog"
        else:
            codes = random_codes(rng, int(lens[i]))
            title = f"SYN{i:08d} random"
        records.append(FastaRecord(title, codes))
    return records


def synth_fasta_fast(path, n_seqs: int, seed: int = 0,
                     median_len: int = 300, sigma: float = 0.55,
                     min_len: int = 20, max_len: int = 6000,
                     queries: list[np.ndarray] | None = None,
                     homolog_frac: float = 0.001) -> int:
    """Stream a LARGE synthetic FASTA straight to disk (Swiss-Prot scale:
    ~5.7e5 sequences / ~2e8 residues in seconds).

    Unlike synth_db (per-sequence rng calls, returns records), residues are
    drawn in one vectorized pass per buffer and written as single-line
    records; planted homologs use the same mutate() as synth_db. Returns
    the total residue count.
    """
    from swimm_tpu_torch.alphabet import ALPHABET

    rng = np.random.default_rng(seed)
    lens = np.exp(rng.normal(np.log(median_len), sigma, size=n_seqs))
    lens = np.clip(lens.astype(np.int64), min_len, max_len)
    n_hom = int(n_seqs * homolog_frac) if queries else 0
    hom_idx = (set(rng.choice(n_seqs, size=n_hom, replace=False).tolist())
               if n_hom else set())
    # full 24-symbol decode table: planted-homolog sources may carry
    # ambiguity codes (B/Z/X/*, codes 20-23) that mutate() preserves
    chars = np.frombuffer(ALPHABET.encode(), dtype="S1")

    total = 0
    BUF = 1 << 24                      # residues per vectorized draw
    pool = rng.choice(20, size=BUF, p=_AA_FREQ).astype(np.uint8)
    pos = 0
    with open(path, "w", buffering=1 << 22) as fh:
        for i in range(n_seqs):
            if i in hom_idx:
                src = queries[rng.integers(len(queries))]
                codes = mutate(rng, np.asarray(src, dtype=np.uint8),
                               sub_rate=float(rng.uniform(0.05, 0.4)),
                               indel_rate=0.02)
                if len(codes) < min_len:
                    codes = np.concatenate(
                        [codes, random_codes(rng, min_len - len(codes))])
                fh.write(f">SYN{i:08d} planted_homolog\n")
            else:
                L = int(lens[i])
                if pos + L > BUF:
                    pool = rng.choice(20, size=BUF,
                                      p=_AA_FREQ).astype(np.uint8)
                    pos = 0
                codes = pool[pos:pos + L]
                pos += L
                fh.write(f">SYN{i:08d} random\n")
            fh.write(chars[codes].tobytes().decode("ascii"))
            fh.write("\n")
            total += len(codes)
    return total


def synth_queries(n: int, lengths, seed: int = 1) -> list[FastaRecord]:
    """Generate query records with the given lengths (int or list)."""
    rng = np.random.default_rng(seed)
    if isinstance(lengths, int):
        lengths = [lengths] * n
    return [FastaRecord(f"QRY{i:04d} len={l}", random_codes(rng, int(l)))
            for i, l in enumerate(lengths[:n])]
