"""Kernel 1's split plan (swimm_tpu_torch.ops.scorer: split_parts,
split_map, split_plan, upload_split; ops/lanes.Splits; the streamed path's
plans per window, models/stream.py) on the CPU: which DB blocks several
CUDA blocks walk, on the streamed cell's modelled windows and at resident
scale, the cap at the strips, the fit to the card's slots, the block map's
order, and that the CPU scores stay the plain walk's under any plan. The
split walk itself (with its gate, which lets a DB block whose parts do not
start together be walked by one of them) runs only on a card (chip_smoke.py's split phase and the
fuzz route k1_split hold it there). Tolerance: bit-exact int32."""

import numpy as np
import pytest
import torch

from swbench.dbgen import lognormal_lengths
from swimm_tpu_torch.db import build_db
from swimm_tpu_torch.fasta import FastaRecord
from swimm_tpu_torch.models import engine, stream
from swimm_tpu_torch.models.engine import SearchConfig
from swimm_tpu_torch.ops import lanes, scorer
from swimm_tpu_torch.utils import metrics
from swimm_tpu_torch.utils.synth import random_codes, synth_db
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# An H100's 132 SMs at one CUDA block of the pair form each, and at the two
# each that the card holds (sw_ragged_split_slots reads 264 there), the
# count the plans on the card are made with.
SLOTS = [132, 264]
H100_SLOTS = 264


def _layout(n_seqs=570_000, median=300, sigma=0.55, V=128):
    """The stream layout of swissprot_stream's length law (the lognormal
    quantiles, sorted, in blocks of V padded to 32 residues), from the
    lengths alone."""
    lens = lognormal_lengths(n_seqs, median, sigma, 20, 6000)
    nb = -(-n_seqs // V)
    pad = np.zeros(nb * V, np.int64)
    pad[:n_seqs] = lens
    tiles = -(-pad.reshape(nb, V).max(axis=1) // 32)
    cum = np.concatenate([[0], np.cumsum(tiles)])
    return {"n_rows": nb, "T": int(cum[-1]), "cum": cum, "jt": 32, "V": V}


@pytest.fixture(scope="module")
def sp_windows():
    lay = _layout()
    spans, _ = stream.plan_windows(lay, 8192)
    return [np.diff(lay["cum"][g0:g1 + 1]) * 32 for g0, g1 in spans]


@pytest.mark.parametrize("slots", SLOTS)
def test_stream_cell_splits_only_the_last_windows_longest_blocks(sp_windows,
                                                                  slots):
    # m = 448: 14 strips, four workers, four rounds unsplit
    assert len(sp_windows) == 7
    for lens in sp_windows[:-1]:
        assert (scorer.split_parts(lens, 448, 128, slots) == 1).all()
    last = sp_windows[-1]
    assert len(last) == 238
    k = scorer.split_parts(last, 448, 128, slots)
    split = dict(zip(last[k > 1].tolist(), k[k > 1].tolist()))
    if slots == 132:
        assert split == {4160: 4, 2752: 2, 2048: 2, 1856: 2, 1760: 2}
    else:   # the plan the card runs: 122 blocks, 254 CUDA blocks
        assert (int((k > 1).sum()), int(k[k > 1].sum())) == (122, 254)
        assert {L: p for L, p in split.items() if p == 4} == {
            4160: 4, 2752: 4, 2048: 4, 1856: 4, 1760: 4}
        assert min(split) == 896 and max(last[k == 1]) == 864
    assert int(k[k > 1].sum()) <= slots
    # each part's work is within the launch's mean work a slot, but where
    # four parts are the most allowed (at 264 slots the 4,160-position
    # block's one round of 16 strips, 4,160 against 3,511)
    work, budget = last * -(-14 // (4 * k)), last.sum() / slots * 4
    assert ((work <= budget) | (k == 4)).all()
    assert (work > budget).sum() == (slots == 264)


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("m", [112, 240, 448, 496])
def test_short_and_mid_queries_on_the_stream_cell(sp_windows, m, slots):
    # every batch length splits in the last window only, never by more
    # than its rounds of strips allow, and its parts fit the slots
    rounds = -(-scorer.n_strips(m) // 4)
    for w, lens in enumerate(sp_windows):
        k = scorer.split_parts(lens, m, 128, slots)
        assert k.max() <= min(rounds, 4)
        assert (k > 1).any() == (w == len(sp_windows) - 1)
        assert int(k[k > 1].sum()) <= slots


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("m", [40, 112, 448, 496, 2048])
def test_resident_scale_launch_never_splits(m, slots):
    # the whole stream in one launch: its share a slot (~12,300 positions
    # at 132 slots, ~6,150 at 264) is above its longest block (4,160)
    lay = _layout()
    lens = np.diff(lay["cum"]) * 32
    assert (scorer.split_parts(lens, m, 128, slots) == 1).all()
    assert scorer.split_plan(lens, m, 128, slots) == (None, 0, 0)


@pytest.mark.parametrize("m,V,cap", [
    (32, 128, 1), (128, 128, 1),      # one round: no part without a strip
    (136, 128, 2), (256, 128, 2),     # 5 and 8 strips: two rounds
    (264, 128, 2), (384, 128, 2),     # 9-12 strips: three rounds, k in 1, 2
    (392, 128, 4), (2048, 128, 4),    # four rounds and more
    (96, 512, 2), (136, 512, 2),      # two workers of 256 threads
    (200, 512, 4), (40, 128, 1)])     # 40 rows: a strip and a tail strip
def test_parts_capped_at_the_rounds(m, V, cap):
    lens = np.array([32] * 50 + [100_000])
    assert scorer.split_parts(lens, m, V, H100_SLOTS)[-1] == cap
    assert scorer.split_parts(lens, m, V, H100_SLOTS, force=4).max() == cap
    rounds = -(-scorer.n_strips(m) // scorer.pair_workers(V, m))
    assert cap <= rounds


def test_parts_fit_the_slots():
    # blocks of 5,000-14,000 positions against 16 slots: 14,000 takes
    # four parts, 8,000-13,000 two, and 7,000, which two parts would bring
    # within the budget, walks alone: its parts would pass the slots
    lens = np.array([64] * 200 + list(range(5000, 15000, 1000)))
    k = scorer.split_parts(lens, 448, 128, 16)
    assert int(k[k > 1].sum()) == 16
    assert k[-7:].tolist() == [2] * 6 + [4] and (k[:-7] == 1).all()
    # fewer than two slots: nothing splits; two or three: halves at most,
    # forced or not
    assert (scorer.split_parts(lens, 448, 128, 1, force=4) == 1).all()
    assert scorer.split_parts(lens, 448, 128, 3, force=4).max() == 2


def test_block_map_order():
    lens = np.array([96, 4160, 320, 4160, 2048, 96, 32])
    k = np.array([1, 4, 1, 2, 2, 1, 1])
    bmap = scorer.split_map(lens, k)
    rows, part, parts = bmap >> 4, (bmap >> 2) & 3, (bmap & 3) + 1
    assert bmap.dtype == np.int32 and len(bmap) == k.sum()
    # longest first, among equals the last first (as the unsplit kernel
    # takes them); a block's parts adjacent, part 0 first
    assert rows.tolist() == [3, 3, 1, 1, 1, 1, 4, 4, 2, 5, 0, 6]
    assert part.tolist() == [0, 1, 0, 1, 2, 3, 0, 1, 0, 0, 0, 0]
    assert (parts == k[rows]).all()
    assert np.array_equal(np.bincount(rows, minlength=len(lens)), k)
    # the predecessor of each part in the ring lies inside its block
    for b in range(len(bmap)):
        pred = b - 1 if part[b] else b + parts[b] - 1
        assert rows[pred] == rows[b]


def test_every_k_one_plan_is_the_unsplit_launch():
    lens = np.array([320, 96, 32] * 400)     # no block above its share
    assert scorer.split_map(lens, np.ones(len(lens))) is None
    assert scorer.split_plan(lens, 448, 128, H100_SLOTS) == (None, 0, 0)
    assert scorer.upload_split((None, 0, 0), "cpu") is None
    # no slots (the CPU) or lanes outside the pair form: no map at all
    assert scorer.split_plan(lens, 448, 128, None, force=4) == (None, 0, 0)
    assert scorer.split_plan(lens, 448, 96, 8, force=4) == (None, 0, 0)
    assert scorer.split_slots("cpu", 128) is None
    splits = lanes.Splits(lens, 128, "cpu")
    assert splits[448] is None and 448 in splits


def test_forced_plan_counts():
    lens = np.array([320, 96, 32, 640])
    bmap, rows, parts = scorer.split_plan(lens, 448, 128, 8, force=4)
    assert (rows, parts, len(bmap)) == (4, 12, 16)
    split = scorer.upload_split((bmap, rows, parts), "cpu")
    assert split.block_map.dtype == torch.int32
    assert split.block_map.tolist() == bmap.tolist()


def _blocks(rng, lengths, V=128):
    tiles = np.concatenate([rng.integers(0, 24, size=(L // 32, 32, V),
                                         dtype=np.int8) for L in lengths])
    outrow = np.repeat(np.arange(len(lengths), dtype=np.int32),
                       [L // 32 for L in lengths])
    return torch.from_numpy(tiles), torch.from_numpy(outrow)


@pytest.mark.parametrize("force", [2, 4])
def test_cpu_scores_unchanged_under_any_plan(force):
    rng = np.random.default_rng(4)
    lengths = [64, 320, 32, 128]
    tiles, outrow = _blocks(rng, lengths)
    qp = torch.from_numpy(rng.integers(-4, 12, size=(32, 176),
                                       dtype=np.int32))
    plan = scorer.split_plan(np.array(lengths), 176, 128, 8, force=force)
    split = scorer.upload_split(plan, "cpu")
    assert split is not None and split.rows == 4
    launches = metrics.counter("score_tiles.split_launches")
    want = scorer.score_tiles(tiles, outrow, 4, qp, 10, 2)
    got = scorer.score_tiles(tiles, outrow, 4, qp, 10, 2, split=split)
    assert torch.equal(got, want)
    assert torch.equal(got, scorer.score_tiles_ref(tiles, outrow, 4, qp,
                                                   10, 2))
    # the CPU launches nothing, split or not
    assert metrics.counter("score_tiles.split_launches") == launches


def test_streamed_plans_reach_kernel_1(tmp_path, monkeypatch):
    # with slots on the CPU (a card's stand-in), each window is planned
    # from its own blocks' lengths at the lengths of the batch's kernel-1
    # queries, and every launch gets its own window's plan; the hits stay
    # the resident search's
    rng = np.random.default_rng(8)
    build_db(synth_db(1500, seed=3, median_len=60, max_len=300),
             tmp_path / "db", V=128)
    from swimm_tpu_torch.db import load_db
    packed = load_db(tmp_path / "db")
    queries = [FastaRecord(f"q{i}", random_codes(rng, n))
               for i, n in enumerate((150, 300, 150))]
    monkeypatch.setattr(scorer, "split_slots", lambda dev, V: 4)
    seen = []
    real = scorer.score_tiles

    def spy(tiles, outrow, n_rows, qp, *a, split=None, **kw):
        seen.append((n_rows, qp.shape[1], split))
        return real(tiles, outrow, n_rows, qp, *a, split=split, **kw)

    spy.kernel = real.kernel
    monkeypatch.setattr(scorer, "score_tiles", spy)
    cfg = SearchConfig(top_k=5, db_stream=True, window_tiles=16)
    got, _ = engine.search(packed, queries, cfg, device="cpu")
    lay = stream.stream_layout(packed)
    spans, _ = stream.plan_windows(lay, 16)
    assert len(seen) == 3 * len(spans) and len(spans) >= 3
    for w, (g0, g1) in enumerate(spans):
        lens = np.diff(lay["cum"][g0:g1 + 1]) * 32
        for n_rows, m, split in seen[3 * w:3 * w + 3]:
            assert n_rows == g1 - g0
            bmap, rows, parts = scorer.split_plan(lens, m, 128, 4)
            if bmap is None:
                assert split is None
            else:
                assert split.block_map.tolist() == bmap.tolist()
                assert (split.rows, split.parts) == (rows, parts)
    assert any(s is not None for *_, s in seen)
    monkeypatch.setattr(scorer, "score_tiles", real)
    want, _ = engine.search(packed, queries, SearchConfig(top_k=5),
                            device="cpu")
    assert [[(h.sorted_idx, h.score) for h in r.hits] for r in got] == [
        [(h.sorted_idx, h.score) for h in r.hits] for r in want]


def test_streamed_score_db_gets_each_windows_plan(tmp_path, monkeypatch):
    # score_db_streaming's one query: a plan per window, from that window's
    # blocks, and the scores of the resident stream
    rng = np.random.default_rng(9)
    build_db(synth_db(1500, seed=6, median_len=60, max_len=300),
             tmp_path / "db", V=128)
    from swimm_tpu_torch.db import load_db
    packed = load_db(tmp_path / "db")
    query = FastaRecord("q", random_codes(rng, 300))
    monkeypatch.setattr(scorer, "split_slots", lambda dev, V: 4)
    seen = []
    real = scorer.score_tiles

    def spy(tiles, outrow, n_rows, qp, *a, split=None, **kw):
        seen.append((n_rows, split))
        return real(tiles, outrow, n_rows, qp, *a, split=split, **kw)

    spy.kernel = real.kernel
    monkeypatch.setattr(scorer, "score_tiles", spy)
    cfg = SearchConfig(top_k=5)
    got = engine.score_db_streaming(packed, query, cfg, window_tiles=16,
                                    device="cpu")
    lay = stream.stream_layout(packed)
    spans, _ = stream.plan_windows(lay, 16)
    assert [n for n, _ in seen] == [g1 - g0 for g0, g1 in spans]
    for (g0, g1), (_, split) in zip(spans, seen):
        bmap, rows, parts = scorer.split_plan(
            np.diff(lay["cum"][g0:g1 + 1]) * 32, 300, 128, 4)
        assert (split is None) == (bmap is None)
        if split is not None:
            assert split.block_map.tolist() == bmap.tolist()
    assert any(s is not None for _, s in seen)
    monkeypatch.setattr(scorer, "score_tiles", real)
    want = engine.score_db(packed, query, cfg, device="cpu")
    assert np.array_equal(np.asarray(got), np.asarray(want))


def test_no_block_past_its_share_plans_nothing():
    # the planner's early exit: the longest block within the mean work a
    # slot, at every length, whatever the spread below it
    lens = np.array([32] * 5000 + [3000])
    for m in (136, 448, 2048):
        assert (scorer.split_parts(lens, m, 128, 8) == 1).all()
    # at the mean of 8 slots it walks alone; one position past it, split
    for L, split in ((22857, False), (22858, True)):
        lens[-1] = L
        assert (L * 8 > lens.sum()) == split
        assert (scorer.split_parts(lens, 448, 128, 8)[-1] > 1) == split


def test_resident_splits_are_kept_per_db_and_device(tmp_path):
    build_db(synth_db(300, seed=5, median_len=60, max_len=300),
             tmp_path / "db", V=128)
    from swimm_tpu_torch.db import load_db
    packed = load_db(tmp_path / "db")
    splits = engine.device_splits(packed, "cpu")
    assert splits is engine.device_splits(packed, "cpu")
    lay = stream.stream_layout(packed)
    assert np.array_equal(splits.lens, np.diff(lay["cum"]) * 32)
    assert splits[448] is None
