"""The program's own spans, read back for the per-layer metrics.

The port records spans and counts at its server and engine boundaries
while a torch profiler session is open (``swimm_tpu_torch.utils.metrics``:
``spans(lo, hi)``), so a ``--trace 1`` run holds them for its window. A
program without the recorder, or a run without the profiler, has none:
``window_spans`` then returns None, and a metric read from it is left out
of the result line rather than read as zero.
"""

from __future__ import annotations

from swbench.trace import short_name


def window_spans(rec, name: str) -> list | None:
    """The program's records called ``name`` that overlap the run's
    window, or None when there are none, or when the recorder's bounded
    buffer is full and may have dropped some of the window's records (its
    oldest kept record ended inside the window)."""
    try:
        from swimm_tpu_torch.utils import metrics
    except ImportError:
        return None
    read = getattr(metrics, "spans", None)
    if read is None:
        return None
    kept = read()
    if len(kept) >= metrics.MAX_SPANS and kept[0].t1 >= rec.window.t0:
        return None
    found = [r for r in kept if r.name == name
             and r.t1 >= rec.window.t0 and r.t0 <= rec.window.t1]
    return found or None


def merged(intervals, lo: float, hi: float) -> list:
    """The union of (start, end) intervals clipped to [lo, hi], as sorted
    disjoint intervals."""
    out = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def overlap(xs, ys) -> float:
    """Seconds that two lists of sorted disjoint intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def host_idle_pct(rec, name: str) -> float | None:
    """The share of the traced window in which the device ran nothing
    while a ``name`` span was open: idle time that host code of the
    program, not the absence of work, leaves. None without a device
    timeline, device activity or such spans."""
    tl = rec.timeline
    if tl is None or tl.hi <= tl.lo or tl.busy() <= 0:
        return None
    found = window_spans(rec, name)
    if found is None:
        return None
    open_ = merged([(r.t0, r.t1) for r in found], tl.lo, tl.hi)
    return 100.0 * overlap(open_, tl.gaps()) / (tl.hi - tl.lo)


def kernel_name(device_op: str) -> str:
    """A device operation's bare function name: no return type, namespace,
    template arguments or argument list (``sw_ragged_kernel<false>`` ->
    ``sw_ragged_kernel``)."""
    return short_name(device_op).split("<")[0].split("::")[-1]


def kernel_roofline(rec, kernel: str) -> float | None:
    """The frozen speed of light's time (swbench/sol.py) for the real cells
    that the window's ``engine.launch`` spans give ``kernel``, over that
    kernel's device time in the traced window, as a percentage. Each
    launch is one query's pass over the database, whose compute bound
    passes its byte bound at any query length, so the cells alone set
    the bound."""
    from swbench import sol
    tl = rec.timeline
    launches = window_spans(rec, "engine.launch")
    if tl is None or launches is None:
        return None
    cells = sum(r.attrs.get("cells", 0) for r in launches
                if r.attrs.get("kernel") == kernel)
    busy = sum(sec for op, sec in tl.by_name().items()
               if kernel_name(op) == kernel)
    if cells <= 0 or busy <= 0:
        return None
    return 100.0 * sol.seconds(cells) / busy
