"""The one general traffic generator: reads a mix's data file
(``swbench/traffic/<name>.json``) and makes the cell's queries and, for an
open loop, their arrival times, from the seed.

A mix file holds:

- ``loop``: ``"closed"`` (one client; a batch of all the queries, issued
  again as soon as the last one returns) or ``"open"`` (requests due on a
  schedule, whatever the server does);
- ``queries``: in a closed loop ``{"lengths": [...]}`` (the exact
  lengths, in that order); in an open loop, which makes one query per
  request, the lognormal length law ``{"law": "lognormal", "median_len",
  "sigma", "min_len", "max_len"}``;
- ``arrivals`` (open loop): ``{"poisson_rate": r}``, requests a second;
- ``request`` (open loop): the per-request fields sent with each query
  (``top_k``, ``format``, ``align``);
- ``check_sample``: how many answers the correctness check compares with
  the reference (all of them when absent);
- ``schedule_seed`` (optional): where present, the order of the lengths and
  of the gaps between arrivals is drawn from it and not from the run's
  seed, so every run replays one schedule and only the residues change.

Every seed gets the same multiset of lengths and of gaps between arrivals
(quantiles of the laws), in an order drawn from the seed (or from
``schedule_seed``), so the work of a run does not depend on its seed; the
residues do. A law or an arrival process this file does not know is added
here, by a change to the benchmark, with the first mix that needs it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from swbench import dbgen


@dataclass
class Traffic:
    queries: list                    # uint8 letter arrays
    due: np.ndarray | None = None    # open loop: seconds after window start
    request: dict = field(default_factory=dict)

    @property
    def lengths(self) -> np.ndarray:
        return np.array([len(q) for q in self.queries], dtype=np.int64)


def query_lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """The n quantiles of a ``queries`` entry's law, in an order drawn
    from rng."""
    if spec["law"] != "lognormal":
        raise ValueError(f"unknown length law {spec['law']!r}")
    lens = dbgen.lognormal_lengths(n, spec["median_len"], spec["sigma"],
                                   spec["min_len"], spec["max_len"])
    return lens[rng.permutation(n)]


def arrival_times(rate: float, seconds: float,
                  rng: np.random.Generator) -> np.ndarray:
    """Poisson arrival times in [0, seconds) at ``rate`` a second:
    round(rate * seconds) arrivals, whose gaps are the quantiles of the
    exponential law in an order drawn from rng, scaled so that the first
    is at 0 and the last before ``seconds``."""
    n = int(round(rate * seconds))
    if n == 0:
        return np.zeros(0)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)[rng.permutation(n)]
    c = np.cumsum(gaps)
    return seconds * (c - gaps) / c[-1]


def make(spec: dict, seed: int, seconds: float) -> Traffic:
    """The cell's traffic from its mix file's contents."""
    rng = dbgen.rng_for(spec.get("schedule_seed", seed), "traffic")
    if spec["loop"] == "closed":
        lens = np.asarray(spec["queries"]["lengths"], dtype=np.int64)
        due = None
    elif spec["loop"] == "open":
        due = arrival_times(spec["arrivals"]["poisson_rate"], seconds, rng)
        lens = query_lengths(spec["queries"], len(due), rng)
    else:
        raise ValueError(f"unknown loop {spec['loop']!r}")
    qrng = dbgen.rng_for(seed, "queries")
    queries = [dbgen.random_letters(qrng, int(n)) for n in lens]
    return Traffic(queries, due, dict(spec.get("request", {})))
