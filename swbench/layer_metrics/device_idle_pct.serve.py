"""Device layer: the share of the traced window in which no kernel, copy or
memset ran on the card (the profiler's trace)."""


def read(rec):
    tl = rec.timeline
    if tl is None or tl.hi <= tl.lo or tl.busy() <= 0:
        return None
    return 100.0 * (1.0 - tl.busy() / (tl.hi - tl.lo))
