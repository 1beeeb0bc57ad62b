"""Run-control DSL: step-function combinators and stop conditions (the
subset of ``meep_nl_tpu/models/run_control.py`` that `Simulation.run`
carries in this slice; analog of python/simulation.py:4991-5445).

Callbacks cannot run inside a kernel's time loop, so the runner splits the
time loop into blocks and calls them at block boundaries (every `dt` time
units); Harminv-style collectors instead ride the loop as per-step probe
series (stepper.step.ProbeSpec) and never interrupt it.

Not carried over yet (ROADMAP A13): the output functions and h5 writers,
`in_volume`, the time-gated combinators, `stop_when_dft_decayed` and the
other stop conditions, `WeightedProbe`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List

import numpy as np


@dataclasses.dataclass
class StepFuncs:
    """Parsed step functions for one run() invocation."""
    every: List          # (interval_time, fn)
    begin: List
    end: List
    after_sources_fns: List
    collectors: List     # Harminv-likes: (obj, only_after_sources)


def at_every(dt: float, *fns):
    """Apply fns every dt time units (simulation.py at_every)."""
    return ("at_every", dt, fns)


def at_beginning(*fns):
    return ("at_beginning", fns)


def at_end(*fns):
    return ("at_end", fns)


def during_sources(*fns):
    return ("during_sources", fns)


def after_sources(*step_funcs):
    """Marker: apply these step functions only once sources have turned off
    (simulation.py:5059 after_sources)."""
    return ("after_sources", step_funcs)


@dataclasses.dataclass
class stop_when_fields_decayed:
    """Stop condition: |component|^2 at pt decayed by decay_by from its peak
    (simulation.py:5225).  The decision uses the MAX of |f| over each dt
    window, never one instantaneous sample (which could land on a zero
    crossing): the runner rides a per-step probe at pt, so every step of
    the window is sampled."""
    dt: float
    c: str
    pt: Any
    decay_by: float = 1e-3
    _peak: float = 0.0

    def check_window(self, window_max_abs: float) -> bool:
        """Decide from the max |f| over the past dt window (probe-fed)."""
        cur = float(window_max_abs) ** 2
        self._peak = max(self._peak, cur)
        return self._peak > 0 and cur <= self.decay_by * self._peak


class FieldProbe:
    """In-loop point time-series sampler (run_control.py:143): records
    component `c` at `pt` every step, riding the probe series as Harminv
    does (no per-step host sync).  After run(), `.data` holds the series
    and `.dt` the timestep."""

    def __init__(self, c, pt):
        self.c = c
        self.pt = pt
        self.data = np.zeros(0)
        self.dt = None

    def _collect(self, data, dt):
        self.data = np.concatenate([self.data, np.asarray(data)])
        self.dt = dt

    def _analyze(self):
        pass


def _is_collector(x) -> bool:
    return hasattr(x, "_collect") and hasattr(x, "c") and hasattr(x, "pt")


def parse_step_funcs(step_funcs) -> StepFuncs:
    out = StepFuncs([], [], [], [], [])
    flat = []
    for sf in step_funcs:
        if isinstance(sf, list):
            flat.extend(sf)
        else:
            flat.append(sf)
    for sf in flat:
        if _is_collector(sf):
            out.collectors.append((sf, False))
        elif isinstance(sf, tuple) and sf:
            tag = sf[0]
            if tag == "after_sources":
                for fn in sf[1]:
                    if _is_collector(fn):
                        out.collectors.append((fn, True))
                    else:
                        out.after_sources_fns.append(fn)
            elif tag == "at_every":
                for fn in sf[2]:
                    out.every.append((sf[1], fn))
            elif tag == "at_beginning":
                out.begin.extend(sf[1])
            elif tag == "at_end":
                out.end.extend(sf[1])
            elif tag == "during_sources":
                for fn in sf[1]:
                    out.every.append((0.0, _only_during_sources(fn)))
        elif callable(sf):
            out.every.append((0.0, sf))
    return out


def _only_during_sources(fn):
    def inner(sim):
        last = max((s.src.last_time() for s in sim.sources), default=0.0)
        if sim.meep_time() <= last:
            fn(sim)
    return inner
