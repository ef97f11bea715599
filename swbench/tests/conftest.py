"""Tests of the benchmark harness. They run on the CPU at small sizes
(``python -m pytest swbench/tests``); a test marked ``card`` needs a CUDA
card, finds out inside its ``card`` fixture, and skips here."""

import json

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda")


#: a CPU run's sizes: the port's plain scorers are slow, so few, short
TINY_DB = {"config": {"db": {"n_seqs": 240, "homolog_frac": 0.05}}}
TINY = {
    "sp_canonical20": {**TINY_DB, "traffic": {
        "queries": {"lengths": [21, 34, 55, 40]}}},
    "sp_serve_poisson": {**TINY_DB, "traffic": {
        "arrivals": {"poisson_rate": 4.0},
        "queries": {"median_len": 40, "max_len": 80}, "check_sample": 6}},
}
SECONDS = {"sp_canonical20": "0.5", "sp_serve_poisson": "2"}


def run_cell(capsys, cell, seed=7, trace=0, spec=None, overrides=None):
    """One CPU run of a cell at TINY's size through run.main; returns
    (exit code, the result line parsed or None)."""
    from swbench import run
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   SECONDS.get(cell, "1"), "--trace", str(trace)],
                  device="cpu", spec=spec,
                  overrides=overrides if overrides is not None
                  else TINY[cell])
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if rc == 0 and out else None)
