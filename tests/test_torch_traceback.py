"""swimm_tpu_torch.ops.traceback.sw_align against swimm_tpu's, field for
field, on seeded random pairs (three matrices; gaps 0/0, 10/2 and 0/3;
empty and one-residue sequences; homologous pairs with gaps), its score
against the C oracle (ops/cref.py), and formats.m8_rows against
swimm_tpu.formats'. Tolerance 0: the same integers and strings."""

import dataclasses

import numpy as np
import pytest

from swimm_tpu.formats import m8_rows as j_m8_rows
from swimm_tpu.models.engine import Hit as JHit
from swimm_tpu.models.engine import QueryResult as JResult
from swimm_tpu.ops.traceback import sw_align as j_sw_align
from swimm_tpu_torch.formats import m8_rows
from swimm_tpu_torch.matrices import get_matrix
from swimm_tpu_torch.models.engine import Hit, QueryResult
from swimm_tpu_torch.ops import cref
from swimm_tpu_torch.ops.traceback import sw_align
from swimm_tpu_torch.utils.synth import mutate, random_codes
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _pairs(seed):
    rng = np.random.default_rng(seed)
    q = random_codes(rng, int(rng.integers(12, 30)))
    homolog = mutate(rng, q, sub_rate=0.2, indel_rate=0.08)
    return [
        (q, random_codes(rng, int(rng.integers(10, 30)))),
        (q, np.concatenate([random_codes(rng, 5), homolog,
                            random_codes(rng, 4)])),
        (np.zeros(0, np.uint8), q),
        (q, np.zeros(0, np.uint8)),
        (q[:1], q),
        (q, q[3:4]),
    ]


@pytest.mark.parametrize("matrix", ["BLOSUM62", "PAM30", "BLOSUM45"])
@pytest.mark.parametrize("gaps", [(0, 0), (10, 2), (0, 3)])
def test_sw_align_equals_reference(matrix, gaps):
    go, ge = gaps
    sub = get_matrix(matrix)
    n_gapped = 0
    for q, d in _pairs(sum(map(ord, matrix)) + 31 * go + ge):
        got = sw_align(q, d, matrix=matrix, gap_open=go, gap_extend=ge)
        want = j_sw_align(q, d, matrix=matrix, gap_open=go, gap_extend=ge)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.pretty() == want.pretty()
        assert got.score == cref.sw_score(q, d, sub, go, ge)
        n_gapped += got.n_gaps > 0
    assert n_gapped > 0      # the pairs exercise the E and F paths


def _hits(cls, titles, scores, evalues):
    return [cls(i + 1, s, i, i, t, *(() if e is None else (e, 3.5 * s)))
            for i, (t, s, e) in enumerate(zip(titles, scores, evalues))]


@pytest.mark.parametrize("with_evalue", [False, True])
def test_m8_rows_equal_reference(with_evalue):
    rng = np.random.default_rng(5)
    q = random_codes(rng, 40)
    seqs = [np.concatenate([random_codes(rng, 3), mutate(
        rng, q, sub_rate=0.15, indel_rate=0.05)]) for _ in range(3)]
    aligns = [sw_align(q, d) for d in seqs]
    titles = ["sp|P1 first", "P2", "third seq here"]
    scores = [a.score for a in aligns]
    evs = [1e-9, 0.05, 2.5] if with_evalue else [None] * 3
    got = m8_rows(QueryResult("q one two", 40, _hits(Hit, titles, scores,
                                                     evs)), aligns)
    want = j_m8_rows(JResult("q one two", 40, _hits(JHit, titles, scores,
                                                    evs)),
                     [j_sw_align(q, d) for d in seqs])
    assert got == want and len(got) == 3
    assert all(len(r.split("\t")) == 12 for r in got)
