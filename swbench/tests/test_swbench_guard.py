"""Nothing a run loads is jax, jaxlib, flax or the JAX package, compared by
whole top-level name (the port's own name begins with the JAX package's)."""

import json
import subprocess
import sys
from pathlib import Path

from swbench.run import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


def test_names_are_compared_whole():
    assert forbidden_modules(["swimm_tpu_torch", "swimm_tpu_torch.db",
                              "jaxtyping", "flaxen", "numpy"]) == []
    assert forbidden_modules(["swimm_tpu.db", "swimm_tpu_torch"]) == [
        "swimm_tpu"]
    assert forbidden_modules(["jax._src.core", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]


def test_a_whole_run_loads_none_of_them():
    """A fresh interpreter drives a CPU run of each cell and then lists
    every loaded module's top-level name."""
    code = (
        "import json, sys\n"
        "from swbench import run\n"
        "from swbench.tests.conftest import TINY, SECONDS\n"
        "for cell in ('sp_canonical20', 'sp_serve_poisson'):\n"
        "    rc = run.main(['--workload', cell, '--seed', '3', '--seconds',\n"
        "                   SECONDS[cell], '--trace', '0'], device='cpu',\n"
        "                  overrides=TINY[cell])\n"
        "    assert rc == 0, rc\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "swimm_tpu_torch" in loaded and "torch" in loaded
    assert forbidden_modules(loaded) == []
    assert not {"jax", "jaxlib", "flax", "swimm_tpu"} & set(loaded)
