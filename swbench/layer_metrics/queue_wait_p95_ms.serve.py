"""Server layer: the 95th percentile, over the window's requests, of the
time each waited in the Batcher's queue, from its enqueue to the pop that
put it into a dispatch (the program's ``batcher.queue`` spans)."""

from swbench import stats
from swbench.program_spans import window_spans


def read(rec):
    queued = window_spans(rec, "batcher.queue")
    if queued is None:
        return None
    return 1e3 * stats.percentile([r.t1 - r.t0 for r in queued], 95)
