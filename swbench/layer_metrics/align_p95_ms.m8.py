"""Server layer: the 95th percentile, over the window's requests that ask
for alignments, of the program's ``server.align`` span: on the dispatcher,
from the start of its dispatch's one alignment call (the traceback on the
card) to the end of the request's response, m8 rows included."""

from swbench import stats
from swbench.program_spans import window_spans


def read(rec):
    found = window_spans(rec, "server.align")
    if found is None:
        return None
    return 1e3 * stats.percentile([r.t1 - r.t0 for r in found], 95)
