"""Server layer: queries searched per Batcher dispatch over the window
(the Batcher's n_dispatches and the SearchServer's n_queries counters):
how far concurrent requests coalesce."""


def read(rec):
    n = rec.counters.get("dispatches")
    if not n:
        return None
    return rec.counters["queries"] / n
