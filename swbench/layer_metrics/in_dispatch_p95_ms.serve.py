"""Server layer: the 95th percentile, over the window's requests, of the
time each rode its coalesced search, from the end of its ``batcher.queue``
span to the end of its ``server.postprocess`` span (joined on the
request's ``seq``): the search of every query in its dispatch, and the
postprocess of the requests answered before it."""

from swbench import stats
from swbench.program_spans import window_spans


def read(rec):
    queued = window_spans(rec, "batcher.queue")
    post = window_spans(rec, "server.postprocess")
    if queued is None or post is None:
        return None
    done = {r.attrs["seq"]: r.t1 for r in post}
    rides = [done[r.attrs["seq"]] - r.t1 for r in queued
             if r.attrs["seq"] in done]
    if not rides:
        return None
    return 1e3 * stats.percentile(rides, 95)
