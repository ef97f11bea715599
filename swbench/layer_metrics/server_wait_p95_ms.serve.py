"""Server layer: the 95th percentile, over the answered requests, of the
client's latency less the search seconds its response reports (engine
.search's wall time, the response's metrics.seconds): the time a request
spends queued behind other searches, and in the server's parse, reply and
postprocess."""

from swbench import stats


def read(rec):
    waits = [r["latency_s"] - r["search_s"] for r in rec.requests
             if r["search_s"] is not None]
    if not waits:
        return None
    return 1e3 * stats.percentile(waits, 95)
