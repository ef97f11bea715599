"""On a card: a short run of each cell through the command the benchmark
runs, correct and complete (skips without a card)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["sp_canonical20", "sp_serve_poisson"])
def test_a_short_run_on_the_card_is_correct(cell, card):
    out = subprocess.run(
        [sys.executable, "-m", "swbench", "--workload", cell, "--seed",
         str(2 ** 31 + 3), "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["platform"] == "gpu"
    assert "setup_s" in res["metrics"]
