"""Timing + GCUPS metrics (L0 results layer).

Parity target: reference component C14 (SURVEY.md section 3): wall-clock
timers and GCUPS = sum(len_q * len_db) / time / 1e9, extended with per-phase
timers and structured (JSON) output per SURVEY.md section 6.5.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field


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
        t0 = time.perf_counter()
        try:
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
