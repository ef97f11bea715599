"""The traced run's device timeline and the benchmark's own spans.

``Tracer`` runs ``torch.profiler`` (CPU and CUDA activity) over the
measured window, exports its trace to a file under the run's data
directory and reads it back as intervals on the host's ``perf_counter``
clock: a ``record_function`` mark taken at a known ``perf_counter`` time
gives the offset. Device activity is every kernel, copy and memset.

``Spans`` is the benchmark's own record of the calls it makes into each
layer of the program (host clock, in memory, read when the run ends).
"""

from __future__ import annotations

import json
import re
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "swbench.clock_mark"


@dataclass
class Spans:
    """Named (start, end) host-clock intervals, from any thread."""
    items: list = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            with self._lock:
                self.items.append((name, t0, time.perf_counter()))

    def wrap(self, name: str, fn):
        def spanned(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)
        return spanned

    def open_at(self, t: float) -> list:
        return [n for n, a, b in self.items if a <= t < b]


@dataclass
class Timeline:
    """Device intervals [(name, cat, start, end)] on the perf_counter clock,
    and the traced window [lo, hi]."""
    device: list
    lo: float
    hi: float

    def clipped(self, cats=DEVICE_CATS) -> list:
        return sorted((max(a, self.lo), min(b, self.hi))
                      for _, c, a, b in self.device
                      if c in cats and b > self.lo and a < self.hi)

    def busy(self, cats=DEVICE_CATS) -> float:
        """Seconds of the window in which the device ran something: the
        union of the intervals, so overlaps count once."""
        total, end = 0.0, None
        for a, b in self.clipped(cats):
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total

    def gaps(self) -> list:
        """(start, end) of each stretch of the window with no device
        activity."""
        out, t = [], self.lo
        for a, b in self.clipped():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.hi > t:
            out.append((t, self.hi))
        return out

    def by_name(self) -> dict:
        """Seconds of the window each device operation took, by name."""
        out: dict = {}
        for n, c, a, b in self.device:
            if c in DEVICE_CATS and b > self.lo and a < self.hi:
                out[n] = out.get(n, 0.0) + min(b, self.hi) - max(a, self.lo)
        return out


class Tracer:
    """Profile the block on the card; ``timeline(lo, hi)`` afterwards."""

    def __init__(self, workdir: Path, enabled: bool = True):
        self.path = Path(workdir) / "trace.json"
        self.enabled = enabled
        self._prof = None
        self._t_mark = None

    def __enter__(self):
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            with torch.profiler.record_function(MARK):
                self._t_mark = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            self._prof.export_chrome_trace(str(self.path))
        return False

    def timeline(self, lo: float, hi: float) -> Timeline | None:
        if self._prof is None:
            return None
        with open(self.path) as fh:
            events = json.load(fh)["traceEvents"]
        self.path.unlink()
        mark = [e for e in events if e.get("name") == MARK
                and not str(e.get("cat", "")).startswith("gpu")]
        if not mark:
            raise RuntimeError("the profiler's trace lost the clock mark")
        off = self._t_mark - float(mark[0]["ts"]) / 1e6
        dev = [(e["name"], e["cat"], float(e["ts"]) / 1e6 + off,
                (float(e["ts"]) + float(e.get("dur", 0))) / 1e6 + off)
               for e in events
               if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        return Timeline(dev, lo, hi)


def short_name(name: str) -> str:
    """A device operation's name without its return type, its anonymous
    namespace and its argument list."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    return name.split("(")[0].strip()[:96]


def breakdown(tl: Timeline, label) -> dict:
    """The result line's ``breakdown``: the 10 device operations that took
    most time, and the 10 longest idle gaps, each named by ``label(t)`` at
    the gap's middle (the benchmark span open then)."""
    named: dict = {}
    for n, sec in tl.by_name().items():
        named[short_name(n)] = named.get(short_name(n), 0.0) + sec
    ops = sorted(named.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(tl.gaps(), key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[label((a + b) / 2), b - a] for a, b in gaps]}
