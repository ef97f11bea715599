"""Packed binary database format (counterpart of swimm_tpu/db.py).

Writes and reads the same on-disk format (version 1) as ``swimm_tpu.db``, so a
database packed by either package loads in the other:

- Sequences are length-sorted ascending and assigned to **blocks of V lanes**
  (default 128: one CUDA thread per lane, 128 consecutive bytes per db
  position, so the kernels' loads coalesce).
- Each block is padded to a length quantized at the kernels' 32-step tile
  granularity, and consecutive blocks with equal L form a **chunk**: one int8
  array of shape ``(n_blocks, L, V)`` with PAD_CODE fill.
- A versioned JSON manifest + .npy files enable memmap loading.

``build_db`` packs a plain FASTA path with the native C parser and packer
(native.py, csrc/swpack.c built by _cc.py) and everything else (records,
gzip input, no C compiler) with the Python packer; both write the same
bytes as each other and as ``swimm_tpu.db.build_db``.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from swimm_tpu_torch.alphabet import PAD_CODE
from swimm_tpu_torch.fasta import iter_fasta

FORMAT_VERSION = 1

# Length quantization: (max_len, multiple) — one 32-step tile everywhere.
_LEN_QUANTA = ((1 << 30, 32),)


def _input_digest(code_chunks, lengths, titles) -> str:
    """Content fingerprint of a parsed FASTA input (codes + lengths +
    titles), stored in the manifest so resume=True only reuses a pack of
    exactly this input."""
    h = hashlib.sha256()
    for c in code_chunks:
        h.update(np.ascontiguousarray(c).tobytes())
    h.update(np.ascontiguousarray(np.asarray(lengths, np.int64)).tobytes())
    for t in titles:
        h.update(t.encode("utf-8", "replace"))
        h.update(b"\0")
    return h.hexdigest()


def quantize_len(L: int) -> int:
    for cap, q in _LEN_QUANTA:
        if L <= cap:
            return max(q, ((L + q - 1) // q) * q)
    raise AssertionError


@dataclass
class DbChunk:
    """One rectangular pack: n_blocks blocks of V lanes, all padded to L."""
    chunk_id: int
    L: int                 # padded sequence length
    V: int                 # lanes per block
    n_blocks: int
    base: int              # first sorted-sequence index covered by this chunk
    n_seqs: int            # true sequences in this chunk (rest are pad lanes)
    codes: np.ndarray = field(repr=False)  # int8 (n_blocks, L, V)


@dataclass(eq=False)  # identity semantics: engines weak-cache per-DB device state
class PackedDb:
    """In-memory handle to a packed database (memmap-backed when loaded)."""
    chunks: list
    lengths: np.ndarray     # int32, per sequence in sorted order
    orig_index: np.ndarray  # int64, sorted position -> original FASTA position
    titles: list
    manifest: dict

    @property
    def n_seqs(self) -> int:
        return int(self.manifest["n_seqs"])

    @property
    def total_residues(self) -> int:
        return int(self.manifest["total_residues"])

    def title_of_sorted(self, sorted_idx: int) -> str:
        return self.titles[sorted_idx]

    def flat_tiles(self, jt: int = 32):
        """The whole database as ONE block-major stream of (jt, V) tiles.

        Returns (tiles, outrow, n_rows):
          tiles:  (T, jt, V) int8, each block's L/jt tiles consecutive,
                  blocks in chunk order;
          outrow: (T,) int32 tile -> global block row, nondecreasing;
          n_rows: total block count.
        Cached on the instance.
        """
        cached = getattr(self, "_flat_tiles_cache", None)
        if cached is not None and cached[0] == jt:
            return cached[1]
        parts, rows = [], []
        row = 0
        for ch in self.chunks:
            nb, L, V = ch.n_blocks, ch.L, ch.V
            if L % jt:
                raise ValueError(f"chunk length {L} is not a multiple of {jt}")
            parts.append(np.ascontiguousarray(ch.codes).reshape(-1, jt, V))
            rows.append(np.repeat(np.arange(row, row + nb, dtype=np.int32),
                                  L // jt))
            row += nb
        tiles = np.concatenate(parts) if parts else \
            np.zeros((0, jt, self.manifest["V"]), np.int8)
        outrow = np.concatenate(rows) if rows else np.zeros(0, np.int32)
        result = (tiles, outrow, row)
        self._flat_tiles_cache = (jt, result)
        return result

    def lane_maps(self):
        """Per flat lane (block-row-major, V lanes per row): validity mask
        and sorted-db index. Returns (mask bool (n_rows*V,), lane2sorted
        int32 (n_rows*V,)); pad lanes map to their chunk's last sequence
        and mask False."""
        cached = getattr(self, "_lane_maps_cache", None)
        if cached is not None:
            return cached
        masks, l2s = [], []
        for ch in self.chunks:
            nlane = ch.n_blocks * ch.V
            m = np.zeros(nlane, dtype=bool)
            m[:ch.n_seqs] = True
            masks.append(m)
            l2s.append(np.minimum(np.arange(nlane), max(ch.n_seqs - 1, 0))
                       + ch.base)
        mask = np.concatenate(masks) if masks else np.zeros(0, bool)
        lane2sorted = (np.concatenate(l2s).astype(np.int32)
                       if l2s else np.zeros(0, np.int32))
        self._lane_maps_cache = (mask, lane2sorted)
        return self._lane_maps_cache

    def block_max_lengths(self) -> np.ndarray:
        """Per global block row, the longest true sequence length in it
        (sequences are length-sorted ascending, so it is the last real
        lane): the per-block score bounds of the precision ladder
        (ops/ladder.py). int64, cached on the instance."""
        cached = getattr(self, "_block_maxlen_cache", None)
        if cached is not None:
            return cached
        out = []
        for ch in self.chunks:
            for b in range(ch.n_blocks):
                lo = ch.base + b * ch.V
                hi = min(lo + ch.V, self.n_seqs)
                out.append(int(self.lengths[hi - 1]) if hi > lo else 0)
        self._block_maxlen_cache = np.asarray(out, dtype=np.int64)
        return self._block_maxlen_cache

    def seq_codes(self, sorted_idx: int) -> np.ndarray:
        """Recover one sequence's residue codes from the packed chunks."""
        if not 0 <= sorted_idx < self.n_seqs:
            raise IndexError(sorted_idx)
        L = int(self.lengths[sorted_idx])
        for ch in self.chunks:
            if ch.base <= sorted_idx < ch.base + ch.n_seqs:
                blk, lane = divmod(sorted_idx - ch.base, ch.V)
                return np.asarray(ch.codes[blk, :L, lane], dtype=np.uint8)
        raise IndexError(sorted_idx)


def build_db(records, out_dir, V: int = 128, resume: bool = False,
             use_native: bool = True) -> PackedDb:
    """Pack FASTA records (iterable of FastaRecord, or a FASTA path):
    load -> encode -> sort by length ASC -> V-lane blocks -> chunks -> write.

    A plain (not gzip) FASTA path goes through the native parser and packer
    when it builds here (use_native, the default); the pack is the same
    bytes either way.

    resume=True: if a completed pack of exactly this input and lane width
    already exists at out_dir, reuse it.
    """
    if isinstance(records, (str, os.PathLike)):
        from swimm_tpu_torch.fasta import is_gzip
        if use_native and not is_gzip(records):
            from swimm_tpu_torch import native
            if native.available():
                return _build_db_native(records, out_dir, V, resume)
        records = list(iter_fasta(records))
    elif not isinstance(records, (list, tuple)):
        records = list(records)   # iterated twice and indexed by sort order
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    lengths = np.array([r.length for r in records], dtype=np.int32)
    digest = _input_digest((r.codes for r in records), lengths,
                           (r.title for r in records))
    existing = _reusable(out, len(records), V, digest) if resume else None
    if existing is not None:
        return existing
    order = np.argsort(lengths, kind="stable")

    def fill(L, base, n_chunk, nb):
        codes = np.full((nb, L, V), PAD_CODE, dtype=np.int8)
        for k in range(n_chunk):
            rec = records[order[base + k]]
            blk, lane = divmod(k, V)
            codes[blk, :rec.length, lane] = rec.codes.astype(np.int8)
        return codes

    return _write_pack(out, V, fill, lengths, order,
                       [records[i].title for i in order], digest)


def _build_db_native(fasta_path, out_dir, V: int, resume: bool) -> PackedDb:
    """build_db's native route: csrc/swpack.c parses the file and fills
    each chunk (the same on-disk bytes as the Python packer)."""
    from swimm_tpu_torch import native
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    codes_blob, offsets, lengths, titles = native.parse_fasta(fasta_path)
    digest = _input_digest([codes_blob], lengths, titles)
    existing = _reusable(out, len(lengths), V, digest) if resume else None
    if existing is not None:
        return existing
    order = np.argsort(lengths, kind="stable").astype(np.int64)

    def fill(L, base, n_chunk, nb):
        codes = native.fill_chunk(codes_blob, offsets, lengths,
                                  order[base:base + n_chunk], L, V, PAD_CODE)
        if codes.shape[0] < nb:   # trailing all-pad blocks
            codes = np.concatenate([codes, np.full(
                (nb - codes.shape[0], L, V), PAD_CODE, dtype=np.int8)])
        return codes

    return _write_pack(out, V, fill, lengths, order,
                       [titles[i] for i in order], digest)


def _reusable(out: Path, n: int, V: int, digest: str):
    """The completed pack at out if it is of exactly this input (sequence
    count, lane width, input digest), else None."""
    if not (out / "manifest.json").exists():
        return None
    try:
        existing = load_db(out)
    except (OSError, ValueError, KeyError):
        return None               # unreadable pack: rebuild it
    if (existing.n_seqs == n and existing.manifest["V"] == V
            and existing.manifest.get("input_digest") == digest):
        return existing
    return None


def _write_pack(out: Path, V: int, fill, lengths, order, sorted_titles,
                digest: str) -> PackedDb:
    """Write the chunks, the sorted lengths, orig_index, titles and the
    manifest of n = len(order) sequences. Block b covers sorted positions
    [b*V, (b+1)*V); consecutive blocks of equal quantized length form a
    chunk, whose (n_blocks, L, V) int8 codes fill(L, base, n_seqs_chunk,
    n_blocks) returns."""
    n = len(order)
    sorted_lengths = lengths[order].astype(np.int32)
    n_blocks_total = (n + V - 1) // V
    padded = np.zeros(n_blocks_total * V, dtype=np.int64)
    padded[:n] = sorted_lengths
    block_max = padded.reshape(n_blocks_total, V).max(axis=1)
    block_L = np.array([quantize_len(int(max(x, 1))) for x in block_max],
                       dtype=np.int64)

    chunks: list[DbChunk] = []
    chunk_descs = []
    b = 0
    while b < n_blocks_total:
        L = int(block_L[b])
        e = b
        while e < n_blocks_total and block_L[e] == L:
            e += 1
        nb, base = e - b, b * V
        n_seqs_chunk = min(e * V, n) - base
        codes = fill(L, base, n_seqs_chunk, nb)
        cid = len(chunks)
        fname = f"chunk_{cid:04d}.npy"
        np.save(out / fname, codes)
        chunk_descs.append({
            "chunk_id": cid, "L": L, "V": V, "n_blocks": nb,
            "base": base, "n_seqs": n_seqs_chunk, "file": fname,
        })
        chunks.append(DbChunk(cid, L, V, nb, base, n_seqs_chunk, codes))
        b = e

    np.save(out / "lengths.npy", sorted_lengths)
    np.save(out / "orig_index.npy", order.astype(np.int64))
    with open(out / "titles.txt", "w") as fh:
        for t in sorted_titles:
            fh.write(t.replace("\n", " ") + "\n")
    manifest = {
        "format_version": FORMAT_VERSION,
        "n_seqs": n,
        "total_residues": int(lengths.sum()),
        "V": V,
        "n_chunks": len(chunk_descs),
        "chunks": chunk_descs,
        "len_quanta": [list(t) for t in _LEN_QUANTA],
        "input_digest": digest,
    }
    with open(out / "manifest.json", "w") as fh:
        json.dump(manifest, fh, indent=1)
    return PackedDb(chunks, sorted_lengths, order.astype(np.int64),
                    list(sorted_titles), manifest)


def load_db(db_dir, mmap: bool = True) -> PackedDb:
    """Load a packed database; chunk arrays are memmapped by default."""
    d = Path(db_dir)
    with open(d / "manifest.json") as fh:
        manifest = json.load(fh)
    if manifest["format_version"] != FORMAT_VERSION:
        raise ValueError(
            f"unsupported db format_version {manifest['format_version']}")
    mode = "r" if mmap else None
    chunks = []
    for cd in manifest["chunks"]:
        codes = np.load(d / cd["file"], mmap_mode=mode)
        chunks.append(DbChunk(cd["chunk_id"], cd["L"], cd["V"],
                              cd["n_blocks"], cd["base"], cd["n_seqs"], codes))
    lengths = np.load(d / "lengths.npy")
    orig_index = np.load(d / "orig_index.npy")
    with open(d / "titles.txt") as fh:
        titles = [line.rstrip("\n") for line in fh]
    return PackedDb(chunks, lengths, orig_index, titles, manifest)
