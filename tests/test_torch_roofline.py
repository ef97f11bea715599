"""swimm_tpu_torch.benchmarks.roofline against the JAX package's
benchmarks/roofline.py.

chains_ref (f32 form) is held bit for bit against the TPU kernel's own body,
vpu_kernel, run by pallas_call in interpret mode on the same linspace input
at the TPU's (512, 128) tile and 256 loops. vpu_kernel is a closure inside
measure_vpu_ops_per_sec, so the test captures it with a pallas_call that
records its kernel and stops the run; nothing under benchmarks/ changes.
The int32 forms are held against the f32 form and a numpy loop, _stats
against the JAX module's, ops_per_cell against the lines of
csrc/sw_walk_hg.cuh it cites, and the band and MFU arithmetic on injected
rates. Tolerance 0 everywhere: the same floats and integers."""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from swimm_tpu_torch.benchmarks import (counts_per_step, loop_counts,
                                        parse_sass, sass_loops)
from swimm_tpu_torch.benchmarks import roofline as rl
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]


def _load(rel: str):
    """A module of the JAX package's benchmarks/ by its path (it imports no
    JAX at import time)."""
    spec = importlib.util.spec_from_file_location(
        "jax_" + Path(rel).stem, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Captured(Exception):
    pass


def _capture_vpu_kernel(monkeypatch):
    """vpu_kernel of measure_vpu_ops_per_sec at its first loop count
    (256), and the real pallas_call."""
    jroof = _load("benchmarks/roofline.py")
    real, box = pl.pallas_call, {}

    def record(kernel, **kw):
        box["kernel"], box["kw"] = kernel, kw
        raise _Captured

    monkeypatch.setattr(pl, "pallas_call", record)
    with pytest.raises(_Captured):
        jroof.measure_vpu_ops_per_sec(n_reps=1)
    monkeypatch.setattr(pl, "pallas_call", real)
    return box["kernel"], real


def test_f32_chains_equal_jax_vpu_kernel(monkeypatch):
    kernel, real = _capture_vpu_kernel(monkeypatch)
    x = jnp.linspace(0.0, 1.0, rl.ROWS * rl.VK,
                     dtype=jnp.float32).reshape(rl.ROWS, rl.VK)
    want = np.asarray(real(
        kernel, out_shape=jax.ShapeDtypeStruct((rl.ROWS, rl.VK),
                                               jnp.float32),
        interpret=True)(x))
    got = rl.chains_ref(torch.from_numpy(np.array(x)), rl.LOOPS[0], "f32")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the input the port's measurement uses is the JAX function's
    np.testing.assert_array_equal(rl.chain_input("f32", 1, "cpu")[0].numpy(),
                                  np.asarray(x))


def _numpy_chains(x, loops):
    s = np.arange(rl.CHAINS).reshape((-1,) + (1,) * x.ndim)
    v = x.astype(np.int64) + 17 * s
    for _ in range(loops * rl.UNROLL):
        v = np.maximum(v + 1, 2000 - v)
    return v.max(0)


@pytest.mark.parametrize("loops", [0, 1, 3])
def test_int32_forms_equal_f32_form_and_numpy(loops):
    rng = np.random.default_rng(loops)
    x = rng.integers(-3000, 3000, (64, 128), dtype=np.int32)
    x[0, :4] = [(1 << 24) - 200, 999, 1000, 1001]
    want = _numpy_chains(x, loops)
    xt = torch.from_numpy(x)
    for form in ("viaddmnmx", "vimnmx3"):
        got = rl.chains_ref(xt, loops, form)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    f32 = rl.chains_ref(xt.float(), loops, "f32")
    np.testing.assert_array_equal(f32.numpy(), want.astype(np.float32))


def test_chains_wrapper_takes_the_plain_version_on_cpu():
    x = rl.chain_input("viaddmnmx", 1, "cpu")
    before = rl.chains.launches
    for form in rl.FORMS:
        xf = rl.chain_input(form, 1, "cpu")
        assert torch.equal(rl.chains(xf, 2, form), rl.chains_ref(xf, 2, form))
    assert rl.chains.launches == before          # no kernel on the CPU
    assert x.shape == (1, rl.ROWS, rl.VK)
    assert sorted(set(x.view(-1).tolist()))[:3] == [0, 1, 2]


@pytest.mark.parametrize("bad", [
    lambda: rl.chains(torch.zeros(8, dtype=torch.int32), 1, "f32"),
    lambda: rl.chains(torch.zeros(8), 1, "viaddmnmx"),
    lambda: rl.chains(torch.zeros(8), 1, "f16"),
    lambda: rl.chains(torch.zeros(8), -1, "f32"),
    lambda: rl.chains(torch.zeros(8, 2).t(), 1, "f32"),
    lambda: rl.ops_per_cell(0),
    lambda: rl.ops_per_cell(12),
])
def test_bad_arguments_raise(bad):
    with pytest.raises(ValueError):
        bad()


@pytest.mark.parametrize("n", [1, 2, 5, 6, 9])
def test_stats_equal_jax_stats(n):
    jroof = _load("benchmarks/roofline.py")
    samples = list(np.random.default_rng(n).uniform(1e12, 3e12, n))
    assert rl._stats(samples) == jroof._stats(samples)
    assert rl._stats([0.0, 0.0]) == jroof._stats([0.0, 0.0])


@pytest.mark.parametrize("ceiling", [False, True])
def test_ops_per_cell_counts_the_cited_walk_lines(ceiling):
    opc = rl.ops_per_cell(448, ceiling)
    assert opc == {"half_rate": 5.5 if ceiling else 4.5, "full_rate": 1.0,
                   "shared_load": 1.0, "total": 7.5 if ceiling else 6.5}
    assert rl.ops_per_cell(8, ceiling) == rl.ops_per_cell(2048, ceiling)
    lines = rl.WALK.read_text().splitlines()
    terms = rl.WALK_TERMS + ((rl.CEILING_TERM,) if ceiling else ())
    for _, _, at, text in terms:
        for line in at:
            assert text in lines[line - 1], (line, text)


def test_chip_smoke_keeps_no_second_copy_of_the_count_or_the_peak():
    src = (REPO / "chip_smoke.py").read_text()
    for gone in ("OPS_PER_CELL", "INSTR_PER_CLK_SM", "def instruction_rate"):
        assert gone not in src
    assert "rl.peak_instruction_rate()" in src
    assert "rl.ops_per_cell(" in src
    assert "rl.walk_bound_s(" in src and "def pipe_bound" not in src


RATES = {"half_rate_per_s": 16.85e12, "issue_per_s": 30.75e12}
PEAK = 132 * 128 * 1.98e9
# kernel 1's strip loop, by opcode a cell (SASS of sm_90a)
K1_SASS = {"BRA": 0.0625, "IADD3": 0.0625, "IMAD": 0.40625, "ISETP": 0.1875,
           "LDS": 1.0, "LEA": 0.15625, "LOP3": 0.03125, "VIADD": 1.0625,
           "VIADDMNMX": 4.0, "VIMNMX3": 0.5}
LOAD = rl.walk_load(K1_SASS)


def test_walk_load_counts_the_opcodes_the_pipe_rate_counts():
    assert LOAD == {"pipe": 4.78125, "total": 7.46875}
    assert rl.walk_load({"VIMNMX": 1.0, "IMNMX": 0.5, "VIADD": 1.0}) == {
        "pipe": 1.5, "total": 2.5}


@pytest.mark.parametrize("rates,by", [
    (RATES, "half-rate pipe"),
    ({"half_rate_per_s": 16.85e12, "issue_per_s": 12e12}, "issue"),
])
def test_speed_of_light_band_on_injected_rates(rates, by):
    band = rl.speed_of_light_gcups(1024, rates, PEAK, load=LOAD)
    pipe = 1.0 / (1e9 * LOAD["pipe"] / rates["half_rate_per_s"])
    issue = 1.0 / (1e9 * LOAD["total"] / rates["issue_per_s"])
    assert band["pipe_gcups"] == pipe and band["issue_gcups"] == issue
    assert band["low"] == min(pipe, issue) and band["low_by"] == by
    assert band["high"] == PEAK / 6.5 / 1e9
    ceil = rl.speed_of_light_gcups(1024, rates, PEAK, ceiling=True,
                                   load=LOAD)
    assert ceil["high"] == PEAK / 7.5 / 1e9
    # the same rule chip_smoke.py bounds each search kernel with
    t = rl.walk_bound_s(2e9, LOAD, rates)
    assert t == {"half-rate pipe": 2e9 * LOAD["pipe"]
                 / rates["half_rate_per_s"],
                 "issue": 2e9 * LOAD["total"] / rates["issue_per_s"]}
    assert max(t, key=t.get) == by


def test_mfu_pct_arithmetic():
    want = 100.0 * (2589.3 * 1e9 * 6.5) / PEAK
    assert rl.mfu_pct(2589.3, 1024, PEAK) == want
    assert rl.mfu_pct(1000.0, 64, 1e13, ceiling=True) == 75.0


def test_walk_rates_take_the_half_rate_pipe_of_the_best_int_form():
    def form(total, by_class):
        return {"total": {"median": total},
                "by_class": {c: {"median": r} for c, r in by_class.items()}}

    forms = {"f32": form(30e12, {"FADD": 20e12, "FMNMX": 10e12}),
             "viaddmnmx": form(17e12, {"IADD3": 8e12, "VIADDMNMX": 8e12,
                                       "ISETP": 0.5e12, "BRA": 0.5e12}),
             "vimnmx3": form(16e12, {"IADD3": 6e12, "VIADDMNMX": 6e12,
                                     "VIMNMX3": 3e12, "UIADD3": 1e12})}
    assert rl.walk_rates(forms) == {"half_rate_per_s": 16.5e12,
                                    "issue_per_s": 30e12}


def test_kernel_inputs_are_the_jax_functions():
    rng = np.random.default_rng(0)
    tiles = rng.integers(0, 20, size=(16, 32, 128), dtype=np.int8)
    qp = rng.integers(-4, 12, size=(32, 64), dtype=np.int32)
    qp[24:] = -64
    codes, outrow, n_rows, q = rl.kernel_inputs(64, 16, "cpu")
    assert n_rows == 2
    np.testing.assert_array_equal(codes.numpy(), tiles)
    np.testing.assert_array_equal(q.numpy(), qp)
    np.testing.assert_array_equal(outrow.numpy(),
                                  np.repeat(np.arange(2, dtype=np.int32), 8))
    # a count that is no multiple of 8: the last block takes the rest
    assert rl.kernel_inputs(8, 17, "cpu")[1].tolist() == [0] * 8 + [1] * 9


SASS = """
        Function : chain_kernel_f32
        /*0000*/                   LDC R1, c[0x0][0x28] ; /* 0x00000a00ff01 */
                                                          /* 0x000fe4000000 */
        /*0010*/                   UMOV UR4, URZ ;
        /*0020*/                   FADD R2, R0, 1 ;
        /*0030*/                   FADD R3, -R0, 2000 ;
        /*0040*/                   FMNMX R0, R2, R3, !PT ;
        /*0050*/                   UIADD3 UR4, UR4, 0x1, URZ ;
        /*0060*/                   ISETP.NE.AND P0, PT, R4, UR4, PT ;
        /*0070*/               @P0 BRA 0x20 ;
        /*0080*/                   EXIT ;
        Function : narrow_kernel_i32
        /*0000*/                   MOV R1, c[0x0][0x28] ;
.L_x_3:
        /*0010*/                   VIADD R2, R0, 0x3e8 ;
        /*0020*/                   VIADDMNMX R0, R0, R0, R2, !PT ;
        /*0030*/                   VIMNMX3 R0, R0, 0xfffffc18, R2, !PT ;
        /*0040*/              @!P1 BRA `(.L_x_3) ;
        /*0050*/                   BRA `(.L_x_4) ;
.L_x_4:
        /*0060*/                   EXIT ;
"""


def test_sass_loop_counts():
    sass = parse_sass(SASS)
    assert sorted(sass) == ["chain_kernel_f32", "narrow_kernel_i32"]
    assert loop_counts(sass, "chain_kernel_f32", 1) == {
        "BRA": 1.0, "FADD": 2.0, "FMNMX": 1.0, "ISETP": 1.0, "UIADD3": 1.0}
    assert sass_loops(sass, "narrow_kernel_i32") == [
        ["VIADD", "VIADDMNMX", "VIMNMX3", "BRA"]]
    assert counts_per_step(["VIADDMNMX.RELU", "VIADDMNMX", "LDS.U8"], 2) == {
        "LDS": 0.5, "VIADDMNMX": 1.0}


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch,
                                                           capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: rl.measure_ops_per_sec("f32", 1),
                 lambda: rl.measure_kernel_padded_gcups(),
                 lambda: rl.speed_of_light_gcups(1024),
                 rl.peak_instruction_rate, rl.report,
                 lambda: rl.main([])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    got = rl.measure_ops_per_sec("viaddmnmx", 1, loops=(1, 2), device="cpu")
    assert got["per_step"] == {"torch_op": 3.0}
    assert got["threads"] == rl.ROWS * rl.VK and got["total"]["n"] == 1
    k1 = rl.measure_kernel_padded_gcups(16, 8, 1, "cpu")
    assert (k1["tiles"], k1["blocks"], k1["m"], k1["n"]) == (8, 1, 16, 1)
    assert rl.main(["--device", "cpu", "--n-reps", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device"] == "cpu" and line["card"] is None
    assert line["mfu_pct"] == "not measured"
    assert line["ops_per_cell"]["total"] == 6.5
    assert set(line["ops_per_sec_filled"]) >= set(rl.FORMS)


def _strip_sass(name, rows, extra):
    """A kernel whose outer loop holds an inner loop over db positions of
    a ``rows``-row strip: 4 VIADDMNMX and 1 LDS a row, then ``extra``."""
    lines = [f"        Function : {name}", ".L_x_1:"]
    ops = ["IADD3 R5, R5, 0x1, RZ", ".L_x_2:"]
    ops += ["VIADDMNMX R0, R0, R1, R2, !PT"] * 4 + ["LDS R1, [R3]"]
    ops = ops[:2] + ops[2:] * rows
    ops += extra + ["@P0 BRA `(.L_x_2)", "VIADDMNMX R0, R0, R1, R2, !PT",
                    "@P1 BRA `(.L_x_1)", "EXIT"]
    addr = 0
    for op in ops:
        if op.endswith(":"):
            lines.append(op)
            continue
        lines.append(f"        /*{addr:04x}*/                   {op} ;")
        addr += 16
    return "\n".join(lines)


def test_walk_sass_per_cell_reads_the_innermost_strip_loop(monkeypatch):
    text = "\n".join([
        _strip_sass("_Z16sw_ragged_kernelILb0EEvPKa", 32,
                    ["ISETP.NE.AND P0, PT, R5, R6, PT", "IADD3 R3, R3, R7, RZ",
                     "VIADD R8, R8, 0x1"]),
        _strip_sass("_Z16sw_ragged_kernelILb1EEvPKa", 16, ["VIADD R8, R8, 1"]),
    ])
    monkeypatch.setattr(rl, "_library_sass", lambda lib: parse_sass(text))
    got = rl.walk_sass_per_cell()
    assert got == {"BRA": 1 / 32, "IADD3": 1 / 32, "ISETP": 1 / 32,
                   "LDS": 1.0, "VIADD": 1 / 32, "VIADDMNMX": 4.0}
    assert rl.walk_load(got) == {"pipe": 4 + 2 / 32, "total": 5 + 4 / 32}
    with pytest.raises(RuntimeError, match="no 32-row strip loop"):
        rl.walk_sass_per_cell(function="sw_ragged_kernelILb1E")
    with pytest.raises(RuntimeError, match="no kernel"):
        rl.walk_sass_per_cell(function="sw_chunk_kernel")
