"""Kernels layer: the alignment kernel's share of its roofline: the frozen
speed of light's time (swbench/sol.py, the same as kernels 1 and 2's) for
the real cells (query length x hit length) that the window's
``align.launch`` spans give ``sw_align_kernel``, over that kernel's device
time by name. The cells of a pair do not depend on how its path is kept,
so neither does the bound."""

from swbench import sol
from swbench.program_spans import kernel_name, window_spans

KERNEL = "sw_align_kernel"


def read(rec):
    tl = rec.timeline
    launches = window_spans(rec, "align.launch")
    if tl is None or launches is None:
        return None
    cells = sum(r.attrs.get("cells", 0) for r in launches
                if r.attrs.get("kernel") == KERNEL)
    busy = sum(sec for op, sec in tl.by_name().items()
               if kernel_name(op) == KERNEL)
    if cells <= 0 or busy <= 0:
        return None
    return 100.0 * sol.seconds(cells) / busy
