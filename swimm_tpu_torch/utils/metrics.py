"""Timing + GCUPS metrics (L0 results layer).

Parity target: reference component C14 (SURVEY.md section 3): wall-clock
timers and GCUPS = sum(len_q * len_db) / time / 1e9, extended with per-phase
timers and structured (JSON) output per SURVEY.md section 6.5.

The span recorder: ``span(name, **attrs)`` times a block on
``time.perf_counter`` and ``record(name, t0, t1, **attrs)`` keeps an
interval timed elsewhere, such as one that began on another thread (a
request's wait in a queue). Each record holds its name, ``t0``, ``t1`` and
its attrs, where counts go (``cells``, ``kernel``, ``seq``). Records stay in
memory, the newest ``MAX_SPANS``, and ``spans(lo, hi)`` reads them back.

Recording is on exactly while a torch profiler session is open in the
process (``torch.profiler.profile``, the CLI's ``--profile-dir``), on every
thread, threads started before the profiler included. On a thread whose
own profiler state is on (the one that opened it), ``span`` also opens
``torch.profiler.record_function(name)``, so the profiler's trace shows
the spans beside the kernels. Off, a span is one flag read and a shared
no-op context.
"""

from __future__ import annotations

import collections
import json
import sys
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

#: records kept: a served minute makes about 20,000
MAX_SPANS = 1 << 16

_records: collections.deque = collections.deque(maxlen=MAX_SPANS)


def tracing() -> bool:
    """Whether spans are recorded: a torch profiler session is open. The
    flag read is torch's process-global one, which every thread sees (the
    profiler's own per-thread state is off on threads started before it).
    No torch loaded means no profiler."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


_OFF = nullcontext()


class Span:
    """One record: ``name``, ``t0``, ``t1`` (perf_counter seconds) and
    ``attrs``. As a context manager it times its block and keeps it."""

    __slots__ = ("name", "t0", "t1", "attrs", "_rf")

    def __init__(self, name: str, attrs: dict, t0=None, t1=None):
        self.name, self.attrs, self.t0, self.t1 = name, attrs, t0, t1
        self._rf = None

    def __enter__(self) -> None:
        import torch
        if torch._C._autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        _records.append(self)
        return False


def span(name: str, **attrs):
    """Context manager that records one block with its attrs, only while
    ``tracing()``."""
    if not tracing():
        return _OFF
    return Span(name, attrs)


def record(name: str, t0: float, t1: float, **attrs) -> None:
    """Record an interval timed elsewhere (perf_counter seconds), such as
    one that began on another thread. Only while ``tracing()``."""
    if tracing():
        _records.append(Span(name, attrs, t0, t1))


def spans(lo: float = float("-inf"), hi: float = float("inf")) -> list:
    """The kept records that overlap [lo, hi] (perf_counter seconds), in
    the order they were kept."""
    return [r for r in _records.copy() if r.t1 >= lo and r.t0 <= hi]


def gcups(cells: int, seconds: float) -> float:
    """Billions of DP cell updates per second."""
    return cells / seconds / 1e9 if seconds > 0 else float("inf")


@dataclass
class PhaseTimer:
    """Named phase timers: with timer.phase("search"): ... accumulates
    each phase's total seconds and keeps each entry's duration, so a phase
    entered once per collective (the sharded merge) can be reported as
    (count, mean, max) rather than a sum."""
    phases: dict = field(default_factory=dict)
    events: dict = field(default_factory=dict)

    @contextmanager
    def phase(self, name: str):
        """Time the block, inside span ``phase.<name>``."""
        t0 = time.perf_counter()
        try:
            with span(f"phase.{name}"):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            self.events.setdefault(name, []).append(dt)

    def report(self) -> dict:
        return dict(self.phases)

    def event_stats(self, name: str) -> dict | None:
        """(count, mean, max) seconds over the entries of one phase; None
        if the phase never ran."""
        ev = self.events.get(name)
        if not ev:
            return None
        return {"count": len(ev), "mean_s": sum(ev) / len(ev),
                "max_s": max(ev)}


@dataclass
class SearchMetrics:
    cells: int = 0            # true DP cells (sum len_q * len_db, no padding)
    padded_cells: int = 0     # cells actually computed incl. padding
    n_db_seqs: int = 0
    n_queries: int = 0
    seconds: float = 0.0
    timers: dict = field(default_factory=dict)

    @property
    def gcups(self) -> float:
        return gcups(self.cells, self.seconds)

    @property
    def padded_gcups(self) -> float:
        return gcups(self.padded_cells, self.seconds)

    @property
    def seqs_per_sec(self) -> float:
        return self.n_db_seqs * self.n_queries / self.seconds if self.seconds else 0.0

    def to_json(self) -> str:
        d = {
            "cells": self.cells, "padded_cells": self.padded_cells,
            "n_db_seqs": self.n_db_seqs, "n_queries": self.n_queries,
            "seconds": self.seconds, "gcups": self.gcups,
            "padded_gcups": self.padded_gcups, "seqs_per_sec": self.seqs_per_sec,
            "timers": self.timers,
        }
        return json.dumps(d)
