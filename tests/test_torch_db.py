"""swimm_tpu_torch's host modules against swimm_tpu's: the packed DB format
(v1, readable by both packages in both directions), flat tiles, lane maps,
query profiles, matrices and the synthetic data generators (same seed, same
bytes)."""

import json

import numpy as np
import pytest

import swimm_tpu.db as jdb
from swimm_tpu import fasta as jfasta
from swimm_tpu.matrices import available_matrices as j_available
from swimm_tpu.matrices import kernel_table as j_kernel_table
from swimm_tpu.models.profile import build_query_profile as j_profile
from swimm_tpu.utils import synth as jsynth
from swimm_tpu_torch import db as tdb
from swimm_tpu_torch import fasta as tfasta
from swimm_tpu_torch.matrices import available_matrices, kernel_table
from swimm_tpu_torch.models.profile import build_query_profile
from swimm_tpu_torch.utils import synth as tsynth


def _same_pack(a, b):
    ta, oa, na = a.flat_tiles()
    tb, ob, nb = b.flat_tiles()
    assert na == nb
    assert np.array_equal(ta, tb) and np.array_equal(oa, ob)
    for x, y in zip(a.lane_maps(), b.lane_maps()):
        assert np.array_equal(x, y)
    assert np.array_equal(a.lengths, b.lengths)
    assert np.array_equal(a.orig_index, b.orig_index)
    assert a.titles == b.titles
    assert a.manifest == b.manifest


def test_build_db_matches_jax_python_packer(tmp_path):
    recs = tsynth.synth_db(300, seed=5)
    jrecs = jsynth.synth_db(300, seed=5)
    port = tdb.build_db(recs, tmp_path / "t", V=8)
    ref = jdb.build_db(jrecs, tmp_path / "j", V=8, use_native=False)
    _same_pack(port, ref)
    for name in ("lengths.npy", "orig_index.npy", "titles.txt",
                 "chunk_0000.npy"):
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes())
    for i in (0, 17, 299):
        assert np.array_equal(port.seq_codes(i), ref.seq_codes(i))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_packed_db_crosses_packages(tmp_path, direction):
    path = tmp_path / "db.fasta"
    jfasta.write_fasta(path, jsynth.synth_db(260, seed=7))
    if direction == "jax_to_port":
        built = jdb.build_db(str(path), tmp_path / "p", V=8)  # native if any
        loaded = tdb.load_db(tmp_path / "p")
    else:
        built = tdb.build_db(str(path), tmp_path / "p", V=8)
        loaded = jdb.load_db(tmp_path / "p")
    _same_pack(built, loaded)
    manifest = json.loads((tmp_path / "p" / "manifest.json").read_text())
    assert manifest["format_version"] == tdb.FORMAT_VERSION == 1


def test_build_db_resume_reuses_only_same_input(tmp_path):
    recs = tsynth.synth_db(50, seed=2)
    first = tdb.build_db(recs, tmp_path / "d", V=8)
    again = tdb.build_db(recs, tmp_path / "d", V=8, resume=True)
    assert again.manifest == first.manifest
    other = tsynth.synth_db(50, seed=3)
    rebuilt = tdb.build_db(other, tmp_path / "d", V=8, resume=True)
    assert rebuilt.manifest["input_digest"] != first.manifest["input_digest"]


@pytest.mark.parametrize("L", [1, 31, 32, 33, 700])
def test_quantize_len(L):
    assert tdb.quantize_len(L) == jdb.quantize_len(L)


def test_profiles_and_matrices_match():
    assert available_matrices() == j_available()
    rng = np.random.default_rng(3)
    q = tsynth.random_codes(rng, 37)
    for name in available_matrices():
        assert np.array_equal(kernel_table(name), j_kernel_table(name))
        for mm in (8, 16):
            assert np.array_equal(build_query_profile(q, name, mm),
                                  j_profile(q, name, mm))


def test_synth_generators_same_bytes(tmp_path):
    qs = tsynth.synth_queries(3, [40, 50, 60], seed=1)
    jqs = jsynth.synth_queries(3, [40, 50, 60], seed=1)
    for a, b in zip(qs, jqs):
        assert a.title == b.title and np.array_equal(a.codes, b.codes)
    codes = [q.codes for q in qs]
    for a, b in zip(tsynth.synth_db(120, seed=4, queries=codes),
                    jsynth.synth_db(120, seed=4, queries=codes)):
        assert a.title == b.title and np.array_equal(a.codes, b.codes)
    n_t = tsynth.synth_fasta_fast(tmp_path / "t.fa", 400, seed=2,
                                  queries=codes, homolog_frac=0.05)
    n_j = jsynth.synth_fasta_fast(tmp_path / "j.fa", 400, seed=2,
                                  queries=codes, homolog_frac=0.05)
    assert n_t == n_j
    assert (tmp_path / "t.fa").read_bytes() == (tmp_path / "j.fa").read_bytes()
    a = tfasta.read_fasta(tmp_path / "t.fa")
    b = jfasta.read_fasta(tmp_path / "j.fa")
    assert [r.title for r in a] == [r.title for r in b]
    assert all(np.array_equal(x.codes, y.codes) for x, y in zip(a, b))
