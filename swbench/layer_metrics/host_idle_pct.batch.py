"""Engine layer: the share of the traced window in which the card ran
nothing while an ``engine.search`` span was open (the program's spans and
the profiler's device timeline): idle time that host code in a search
leaves, out of ``device_idle_pct.batch``."""

from swbench.program_spans import host_idle_pct


def read(rec):
    return host_idle_pct(rec, "engine.search")
