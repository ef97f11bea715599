"""Stream layer: the share of the traced window in which a copy from
pinned host memory to the card ran and no kernel did (the profiler's
trace): the window copies that the ring of windows in flight failed to
hide behind the kernels. The queries' profiles, uploaded from pageable
memory at each batch's start, are not counted."""

from swbench.program_spans import merged, overlap


def read(rec):
    tl = rec.timeline
    if tl is None or tl.hi <= tl.lo:
        return None
    copies = merged([(a, b) for n, c, a, b in tl.device
                     if c == "gpu_memcpy" and "HtoD" in n and "Pinned" in n],
                    tl.lo, tl.hi)
    if not copies:
        return None
    kernels = merged([(a, b) for _, c, a, b in tl.device if c == "kernel"],
                     tl.lo, tl.hi)
    exposed = sum(b - a for a, b in copies) - overlap(copies, kernels)
    return 100.0 * exposed / (tl.hi - tl.lo)
