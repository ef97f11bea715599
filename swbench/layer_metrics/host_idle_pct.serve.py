"""Server layer: the share of the traced window in which the card ran
nothing while a ``batcher.dispatch`` span was open (the program's spans
and the profiler's device timeline): idle time that host code in a
dispatch leaves. The rest of ``device_idle_pct.serve`` had no work."""

from swbench.program_spans import host_idle_pct


def read(rec):
    return host_idle_pct(rec, "batcher.dispatch")
