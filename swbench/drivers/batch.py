"""The batch screen (``swimm search`` of a query file): one client in a
closed loop, calling ``swimm_tpu_torch.models.engine.search`` over the
resident database with the whole query batch, back to back.

The window's rate is every batch's real cells over the time from the
window's start to the end of its last batch, which starts before
``seconds`` have passed and is finished and counted.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from swbench import dbgen, stats


@dataclass
class Window:
    t0: float
    t1: float
    answers: list                  # [(query index, [(score, title)])]
    e2e: dict
    counters: dict
    requests: list = field(default_factory=list)


class Session:
    def __init__(self, cfg, traffic, db, packed, device, seed, seconds,
                 spans, workdir):
        from swimm_tpu_torch.fasta import parse_fasta_str
        from swimm_tpu_torch.models.engine import SearchConfig
        self.cfg, self.traffic, self.db = cfg, traffic, db
        self.packed, self.device, self.seconds = packed, device, seconds
        self.spans = spans
        self.records = parse_fasta_str(dbgen.query_fasta(traffic.queries))
        self.config = SearchConfig(**cfg["search"])

    def _search(self):
        from swimm_tpu_torch.models import engine
        return engine.search(self.packed, self.records, self.config,
                             device=self.device)

    def setup(self):
        """The first search builds and loads the kernels, uploads the
        database and grows the allocator to this batch's shapes."""
        with self.spans.span("warmup.engine.search"):
            self._search()

    def window(self) -> Window:
        t0 = time.perf_counter()
        t_end = t0 + self.seconds
        answers, metrics = [], []
        while True:
            with self.spans.span("engine.search"):
                results, met = self._search()
            metrics.append(met)
            answers += [(qi, [(h.score, h.title) for h in r.hits])
                        for qi, r in enumerate(results)]
            t1 = time.perf_counter()
            if t1 >= t_end:
                break
        real = sum(stats.cells(self.traffic.lengths, self.db.total_residues)
                   for _ in metrics)
        counters = {"batches": len(metrics), "cells": real,
                    "program_cells": sum(m.cells for m in metrics),
                    "program_padded_cells": sum(m.padded_cells
                                                for m in metrics),
                    "db_bytes": len(metrics) * len(self.records)
                    * self.db.total_residues}
        return Window(t0, t1, answers, {"gcups": stats.gcups(real, t1 - t0)},
                      counters)

    def label(self, t: float) -> str:
        open_ = self.spans.open_at(t)
        return open_[-1] if open_ else "between batches"

    def close(self):
        self.records = None
