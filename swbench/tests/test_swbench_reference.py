"""The reference against hand-checked Gotoh alignments and an independent
scalar version, and the guaranteed tie order on a tiny database."""

import numpy as np
import pytest

from swbench import blosum62, dbgen, reference

SUB = blosum62.rows()
IDX = {c: i for i, c in enumerate(blosum62.ORDER)}


def scalar_gotoh(q: str, d: str, go=10, ge=2) -> int:
    """Textbook Gotoh, cell by cell: a gap of length g costs go + g * ge."""
    neg = -10 ** 9
    H = [[0] * (len(d) + 1) for _ in range(len(q) + 1)]
    E = [[neg] * (len(d) + 1) for _ in range(len(q) + 1)]
    F = [[neg] * (len(d) + 1) for _ in range(len(q) + 1)]
    best = 0
    for i in range(1, len(q) + 1):
        for j in range(1, len(d) + 1):
            E[i][j] = max(H[i - 1][j] - go - ge, E[i - 1][j] - ge)
            F[i][j] = max(H[i][j - 1] - go - ge, F[i][j - 1] - ge)
            s = SUB[IDX[q[i - 1]]][IDX[d[j - 1]]]
            H[i][j] = max(0, H[i - 1][j - 1] + s, E[i][j], F[i][j])
            best = max(best, H[i][j])
    return best


def ref(q: str, ds: list, **kw) -> list:
    arr = lambda s: np.frombuffer(s.encode(), np.uint8)  # noqa: E731
    return reference.score([arr(q)], [[arr(d) for d in ds]], 10, 2,
                           **kw)[0].tolist()


def test_hand_checked_alignments():
    # identity: the sum of BLOSUM62's diagonal over the 20 letters
    aa = "ACDEFGHIKLMNPQRSTVWY"
    assert ref(aa, [aa]) == [116]
    # WW-WW against WWGWW: 4 x 11 less one gap of 1 (10 + 2) = 32 beats
    # the gapless WWWW / WWGW (11 + 11 - 2 + 11 = 31)
    assert ref("WWWW", ["WWGWW"]) == [32]
    # a gap of 2 in the database direction: 44 - (10 + 2 * 2) = 30, and in
    # the query direction the same
    assert ref("WWWW", ["WWGGWW"]) == [30]
    assert ref("WWGGWW", ["WWWW"]) == [30]
    # nothing aligns positively: the local score is 0
    assert ref("WWW", ["PPP", "G"]) == [0, 0]
    # a segment boundary is no gap: WW | WW scores 22, not 44 - 12
    assert ref("WWWW", ["WW", "WW"]) == [22, 22]


def test_matches_scalar_gotoh_on_random_sequences():
    rng = np.random.default_rng(4)
    for _ in range(6):
        q = dbgen.random_letters(rng, int(rng.integers(1, 40)))
        ds = [dbgen.random_letters(rng, int(rng.integers(1, 50)))
              for _ in range(7)]
        ds.append(dbgen.mutate(rng, q, 0.2, 0.1))
        got = reference.score([q], [ds], 10, 2)[0].tolist()
        exp = [scalar_gotoh(q.tobytes().decode(), d.tobytes().decode())
               for d in ds]
        assert got == exp


def test_groups_give_the_same_scores_as_one_query_at_a_time():
    rng = np.random.default_rng(8)
    qs = [dbgen.random_letters(rng, n) for n in (5, 30, 31, 90)]
    cands = [[dbgen.random_letters(rng, int(n)) for n in
              rng.integers(1, 120, 9)] for _ in qs]
    together = reference.score(qs, cands, 10, 2, budget=1 << 30)
    alone = [reference.score([q], [c], 10, 2)[0] for q, c in zip(qs, cands)]
    assert all(np.array_equal(a, b) for a, b in zip(together, alone))


def test_a_long_list_scored_in_blocks_gives_the_same_scores():
    rng = np.random.default_rng(9)
    q = dbgen.random_letters(rng, 25)
    c = [dbgen.random_letters(rng, int(n)) for n in rng.integers(1, 300, 40)]
    assert len(reference._blocks(c, 1000)) > 3
    blocks = reference.score([q, q[:7]], [c, c[:5]], 10, 2, budget=1000)
    whole = reference.score([q, q[:7]], [c, c[:5]], 10, 2)
    assert all(np.array_equal(a, b) for a, b in zip(blocks, whole))


def test_ceiling_saturates():
    aa = "ACDEFGHIKLMNPQRSTVWY" * 2
    assert ref(aa, [aa], ceiling=127) == [127]
    assert ref(aa, [aa], ceiling=32767) == [232]


def test_tie_order_on_a_tiny_database():
    lengths = np.array([5, 3, 5, 3, 4])
    rank = reference.sorted_rank(lengths)
    # stable length-ascending: 1, 3 (len 3), 4 (len 4), 0, 2 (len 5)
    assert rank.tolist() == [3, 0, 4, 1, 2]
    cand = np.arange(5)
    scores = np.array([7, 9, 7, 7, 1])
    assert reference.top_k(cand, scores, rank, 3) == [(9, 1), (7, 3), (7, 0)]
    assert reference.top_k(cand, scores, rank, 3, reverse_ties=True) == [
        (9, 1), (7, 2), (7, 0)]


@pytest.mark.parametrize("p,expect", [(50, 3.0), (95, 5.0), (100, 5.0)])
def test_percentile_nearest_rank(p, expect):
    from swbench import stats
    assert stats.percentile([5.0, 1.0, 3.0, 2.0, 4.0], p) == expect
