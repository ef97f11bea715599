"""Stream layer: the share of the traced window in which the card ran
nothing while a ``stream.wait`` (the search waiting on the reader thread
for its next window) or a ``stream.merge`` span (the candidates' copies
and host merge) was open (the program's spans and the profiler's device
timeline): idle time that the stream's own host work leaves."""

from swbench.program_spans import merged, overlap, window_spans


def read(rec):
    tl = rec.timeline
    if tl is None or tl.hi <= tl.lo or tl.busy() <= 0:
        return None
    found = [r for name in ("stream.wait", "stream.merge")
             for r in window_spans(rec, name) or ()]
    if not found:
        return None
    open_ = merged([(r.t0, r.t1) for r in found], tl.lo, tl.hi)
    return 100.0 * overlap(open_, tl.gaps()) / (tl.hi - tl.lo)
