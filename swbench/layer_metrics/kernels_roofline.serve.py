"""Kernels layer: the frozen speed of light's time for the window's real
cells (swbench/sol.py) over the device time of all kernels in the traced
window (the union of their intervals), as a percentage."""

from swbench import sol


def read(rec):
    tl = rec.timeline
    if tl is None:
        return None
    busy = tl.busy(cats=("kernel",))
    if busy <= 0:
        return None
    return 100.0 * sol.seconds(rec.counters["cells"],
                               rec.counters["db_bytes"]) / busy
