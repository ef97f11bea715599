"""swimm_tpu_torch.benchmarks.probe_narrow_int against the JAX package's
benchmarks/probe_narrow_int.py.

narrow_ref is held bit for bit against the TPU kernel's own body (``body``
of _try_kernel, a closure there, captured with a pallas_call that records
its kernel and stops the run; nothing under benchmarks/ changes), run by
pallas_call in interpret mode 8 times chained, as the JAX probe's scan
does, on default_rng(0).integers(-50, 50, (512, 1024)) in int32, int16 and
int8. int8 wraps on these inputs from the first step (a - lo = a + 120 for
a >= 8); a case at the edges of int16 and int8 wraps a + a as well, held
against the body and a numpy loop. Tolerance 0: the same integers."""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from swimm_tpu_torch.benchmarks import probe_narrow_int as pn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
JNP = {torch.int32: jnp.int32, torch.int16: jnp.int16, torch.int8: jnp.int8}


class _Captured(Exception):
    pass


def _jax_body(dtype, monkeypatch):
    """``body`` of the JAX probe's _try_kernel for this lane type (its lo
    depends on it), and the real pallas_call."""
    spec = importlib.util.spec_from_file_location(
        "jax_probe_narrow_int", REPO / "benchmarks/probe_narrow_int.py")
    jprobe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jprobe)
    real, box = pl.pallas_call, {}

    def record(kernel, **kw):
        box["kernel"] = kernel
        raise _Captured

    monkeypatch.setattr(pl, "pallas_call", record)
    ok, per, err = jprobe._try_kernel(JNP[dtype])   # reports the stop
    monkeypatch.setattr(pl, "pallas_call", real)
    assert not ok and per is None and "_Captured" in err
    return box["kernel"], real


def _run_body(body, real, x, steps):
    v = jnp.asarray(x)
    for _ in range(steps):
        v = real(body, out_shape=jax.ShapeDtypeStruct(v.shape, v.dtype),
                 interpret=True)(v)
    return np.asarray(v)


def _numpy_steps(x, steps, lo):
    a = x.copy()
    for _ in range(steps):
        h = np.maximum(np.maximum(a + a, a - lo), np.maximum(a, lo))
        a = np.maximum(h - a, lo).astype(x.dtype)
    return a


@pytest.mark.parametrize("dtype", [torch.int32, torch.int16, torch.int8])
def test_narrow_ref_equals_jax_body_chained_8_times(dtype, monkeypatch):
    body, real = _jax_body(dtype, monkeypatch)
    x = np.random.default_rng(0).integers(-50, 50, size=pn.SHAPE)
    xj = jnp.asarray(x, JNP[dtype])               # as the JAX probe makes it
    want = _run_body(body, real, xj, 8)
    xt = pn.probe_input(dtype)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    got = pn.narrow_ref(xt, 8)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), want)
    if dtype == torch.int8:   # the wrap is exercised, not avoided
        assert (got.numpy() != _numpy_steps(x, 8, -120)).any()


EDGES = {torch.int16: [32_767, -32_768, 32_766, -32_767, 16_384, 16_383,
                       -16_385, 20_000, 32_647, 32_648, 120, -120],
         torch.int8: [127, -128, 126, -127, 120, 8, 7, 64, 63, -64, 0,
                      -120]}


@pytest.mark.parametrize("dtype", [torch.int16, torch.int8])
@pytest.mark.parametrize("steps", [1, 8, 33])
def test_overflow_wraps_as_jax_and_numpy(dtype, steps, monkeypatch):
    body, real = _jax_body(dtype, monkeypatch)
    npt = {torch.int16: np.int16, torch.int8: np.int8}[dtype]
    x = np.array(EDGES[dtype] * 4, dtype=npt).reshape(4, -1)
    got = pn.narrow_ref(torch.from_numpy(x), steps).numpy()
    np.testing.assert_array_equal(got, _numpy_steps(x, steps, -120))
    np.testing.assert_array_equal(got, _run_body(body, real, x, steps))
    if dtype == torch.int16 and steps == 1:
        # 20,000 + 20,000 wraps to -25,536: a saturating add would give
        # max(32,767, 20,120) - 20,000 = 12,767 here, not 120
        assert got[0, 7] == 120


def test_narrow_wrapper_takes_the_plain_version_on_cpu():
    x = pn.probe_input(torch.int32, (8, 16))
    before = pn.narrow.launches
    assert torch.equal(pn.narrow(x, 3), pn.narrow_ref(x, 3))
    got = pn.narrow(x, 3, torch.int8)
    assert got.dtype == torch.int8
    assert torch.equal(got, pn.narrow_ref(x.to(torch.int8), 3))
    assert torch.equal(pn.narrow_ref(x, 0), x)
    assert pn.narrow.launches == before          # no kernel on the CPU


@pytest.mark.parametrize("bad", [
    lambda: pn.narrow(torch.zeros(8), 1),
    lambda: pn.narrow(torch.zeros(3, dtype=torch.int8), 1),
    lambda: pn.narrow(torch.zeros(5, dtype=torch.int16), 1),
    lambda: pn.narrow(torch.zeros(8, dtype=torch.int32), -1),
    lambda: pn.narrow(torch.zeros(4, 2, dtype=torch.int32).t(), 1),
])
def test_bad_arguments_raise(bad):
    with pytest.raises(ValueError):
        bad()


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch,
                                                           capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: pn.try_kernel(torch.int16), pn.report,
                 lambda: pn.main([])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    ok, per, err = pn.try_kernel(torch.int8, (16, 64), (1, 2), 1, "cpu")
    assert ok and per > 0 and err is None
    assert pn.main(["--device", "cpu", "--n-reps", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("int16_compiles", "int8_compiles", "int16_speedup_vs_int32",
                "int8_speedup_vs_int32", "torch", "cuda", "device"):
        assert key in line
    assert line["device"] == "cpu" and line["card"] is None
    assert line["int16_compiles"] is True and line["int8_compiles"] is True


def test_main_exits_nonzero_when_a_lane_type_fails(monkeypatch, capsys):
    real = pn.try_kernel

    def failing(dtype, *args, **kw):
        if dtype == torch.int8:
            return False, None, "RuntimeError: narrow_kernel_i8x4 failed"
        return real(dtype, *args, **kw)

    monkeypatch.setattr(pn, "try_kernel", failing)
    assert pn.main(["--device", "cpu", "--n-reps", "1"]) == 1
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert line["int8_compiles"] is False and line["int16_compiles"] is True
    assert line["int8_speedup_vs_int32"] is None
    assert "int8_compiles" in out.err
