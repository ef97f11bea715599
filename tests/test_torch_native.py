"""The port's native packer (native.py over csrc/swpack.c) and C oracle
(ops/cref.py over csrc/swref.c), both built by _cc.py: the native pack is
byte for byte the port's Python pack and swimm_tpu's (Python and native),
on plain, gzip and adversarial FASTA; the libraries are built under
build/swimm_tpu_torch/ and nothing is written under csrc/; without a C
compiler build_db packs in Python, the same bytes; cref's scores equal
ops/reference's."""

import gzip
from pathlib import Path

import numpy as np
import pytest

import swimm_tpu.db as jdb
from swimm_tpu_torch import _cc, native
from swimm_tpu_torch import db as tdb
from swimm_tpu_torch.fasta import read_fasta, write_fasta
from swimm_tpu_torch.matrices import get_matrix
from swimm_tpu_torch.ops import cref, reference
from swimm_tpu_torch.utils.synth import random_codes, synth_db
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ADVERSARIAL = {
    "no_trailing_newline": b">a\nACDE",
    "empty_seq_between": b">a\nACDE\n>b\n>c\nKLMN\n",
    "title_only": b">only title here\n",
    "giant_title": b">" + b"T" * 5000 + b"\nAC\n",
    "crlf": b">a\r\nAC\r\nDE\r\n>b\r\nKL\r\n",
    "blank_lines": b"\n\n>a\n\nAC\n\n\n>b\nKL\n\n",
    "whitespace": (b">  t1 \f\t \nAC\x0bDE FG\tHI\n\fKL\n"
                   b"> t2\t\nMN\x0cPQ\r\nRS TV \nacdxjou*\n"),
}


def _files(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def _fasta(tmp_path, kind):
    path = tmp_path / "db.fasta"
    if kind in ADVERSARIAL:
        path.write_bytes(ADVERSARIAL[kind])
        return path
    write_fasta(path, synth_db(300, seed=9, median_len=70, max_len=400))
    if kind == "gzip":
        path.write_bytes(gzip.compress(path.read_bytes()))
    return path


@pytest.mark.parametrize("kind", ["plain", "gzip", *ADVERSARIAL])
def test_native_pack_equals_python_and_reference(tmp_path, kind):
    path = _fasta(tmp_path, kind)
    V = 16 if kind in ("plain", "gzip") else 4
    nat = tdb.build_db(str(path), tmp_path / "nat", V=V)
    py = tdb.build_db(str(path), tmp_path / "py", V=V, use_native=False)
    jdb.build_db(str(path), tmp_path / "jpy", V=V, use_native=False)
    jdb.build_db(str(path), tmp_path / "jnat", V=V)
    want = _files(tmp_path / "py")
    assert "manifest.json" in want and "chunk_0000.npy" in want
    for d in ("nat", "jpy", "jnat"):
        assert _files(tmp_path / d) == want, d
    assert nat.titles == py.titles
    assert nat.manifest == py.manifest
    assert np.array_equal(nat.orig_index, py.orig_index)
    assert [r.title for r in read_fasta(str(path))] == [
        py.titles[i] for i in np.argsort(py.orig_index)]
    # the loaded pack and a resume of the same input are the same pack
    again = tdb.build_db(str(path), tmp_path / "nat", V=V, resume=True)
    assert again.manifest == nat.manifest


def test_resume_rebuilds_a_changed_input(tmp_path):
    path = _fasta(tmp_path, "plain")
    first = tdb.build_db(str(path), tmp_path / "d", V=16)
    text = path.read_text().replace(">SYN00000003", ">renamed", 1)
    path.write_text(text)
    rebuilt = tdb.build_db(str(path), tmp_path / "d", V=16, resume=True)
    assert (rebuilt.manifest["input_digest"]
            != first.manifest["input_digest"])
    assert "renamed random" in rebuilt.titles


def test_libraries_built_outside_csrc(tmp_path, monkeypatch):
    # the sources are read from a copy of csrc/ (the JAX package's own
    # tests may build their libraries in the real one meanwhile): the
    # copy must hold exactly its sources afterwards
    src = tmp_path / "csrc"
    src.mkdir()
    for name in ("swpack.c", "swref.c"):
        (src / name).write_bytes((_cc.CSRC / name).read_bytes())
    monkeypatch.setattr(_cc, "CSRC", src)
    monkeypatch.setattr(_cc, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cc, "_LIBS", {})
    assert native.available()
    assert cref.sw_score(np.array([1, 2, 3]), np.array([1, 2, 3]),
                         get_matrix("BLOSUM62"), 10, 2) > 0
    built = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert [n.split("_")[0] for n in built] == ["libswpack", "libswref"]
    assert all(n.endswith(".so") for n in built)
    assert sorted(p.name for p in src.iterdir()) == ["swpack.c", "swref.c"]
    assert _cc.lib_path("swref").parent == tmp_path / "build"


def test_without_a_compiler_packs_in_python(tmp_path, monkeypatch):
    path = _fasta(tmp_path, "plain")
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    monkeypatch.setattr(_cc, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cc, "_LIBS", {})
    assert not native.available()
    tdb.build_db(str(path), tmp_path / "a", V=16)
    monkeypatch.undo()
    tdb.build_db(str(path), tmp_path / "b", V=16)
    assert _files(tmp_path / "a") == _files(tmp_path / "b")


@pytest.mark.parametrize("matrix,gaps", [("BLOSUM62", (10, 2)),
                                         ("PAM30", (0, 3)),
                                         ("BLOSUM45", (0, 0)),
                                         ("BLOSUM80", (12, 1))])
def test_cref_equals_reference(matrix, gaps):
    rng = np.random.default_rng(sum(map(ord, matrix)))
    sub = get_matrix(matrix)
    q = random_codes(rng, 37)
    seqs = [random_codes(rng, int(n)) for n in rng.integers(0, 60, 12)]
    seqs += [np.zeros(0, np.uint8), q[5:30], q]
    want = [reference.sw_score(q, s, sub, *gaps) for s in seqs]
    assert [cref.sw_score(q, s, sub, *gaps) for s in seqs] == want
    assert cref.sw_score_many(q, seqs, sub, *gaps).tolist() == want
    assert cref.sw_score_many(q, [], sub, *gaps).tolist() == []
