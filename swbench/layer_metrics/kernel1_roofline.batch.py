"""Kernels layer: kernel 1's share of its roofline: the frozen speed of
light's time for the real cells the window's ``engine.launch`` spans give
``sw_ragged_kernel``, over that kernel's device time by name (the
program's counts and the profiler's device timeline)."""

from swbench.program_spans import kernel_roofline


def read(rec):
    return kernel_roofline(rec, "sw_ragged_kernel")
