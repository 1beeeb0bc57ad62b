"""Source time profiles and source placement specs.

The port's own copy of the source-time classes of
``meep_nl_tpu/models/source.py``, which mirror the reference's src_time
hierarchy (meep.hpp:937-1092, sources.cpp:64-146) and the Python-level
Source class (python/source.py).  Time profiles are evaluated on the host
when building the per-step waveform tables (stepper.step.build_xs).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np


class SourceTime:
    """Base time profile (meep.hpp:937 src_time)."""

    is_integrated: bool = False

    def dipole(self, t: float) -> complex:
        raise NotImplementedError

    def current(self, t: float, dt: float) -> complex:
        """Default: discrete derivative of the dipole moment
        (meep.hpp:982)."""
        return (self.dipole(t + dt) - self.dipole(t)) / dt

    def last_time(self) -> float:
        return 0.0

    def get_fwidth(self) -> float:
        return 0.0


def _gaussian_bandwidth(width: float) -> float:
    """Bandwidth at which the gaussian spectrum decays below 1e-7
    (sources.cpp:67)."""
    tol = 1e-7
    return math.sqrt(-2.0 * math.log(tol)) / (width * math.pi)


@dataclasses.dataclass
class GaussianSource(SourceTime):
    """Gaussian pulse (sources.cpp:72-117, python/source.py GaussianSource).

    frequency: center frequency (units of c/a)
    fwidth: spectral width; envelope width = 1/fwidth
    cutoff: start/peak offset in widths (default 5)
    """
    frequency: float
    fwidth: float = 0.0
    width: float = 0.0
    start_time: float = 0.0
    cutoff: float = 5.0
    is_integrated: bool = False

    def __post_init__(self):
        if self.width == 0.0:
            if self.fwidth == 0.0:
                raise ValueError("GaussianSource needs fwidth or width")
            self.width = 1.0 / self.fwidth
        self.peak_time = self.start_time + self.width * self.cutoff
        self._cut = self.width * self.cutoff
        # shrink cutoff below the double-underflow horizon (sources.cpp:80)
        while math.exp(-self._cut ** 2 / (2 * self.width ** 2)) < 1e-100:
            self._cut *= 0.9
        self._cut = np.float32(self._cut)

    def dipole(self, t: float) -> complex:
        tt = t - self.peak_time
        if np.float32(abs(tt)) > self._cut:
            return 0.0
        # amp normalizes the *current* (d dipole/dt) to ~1 at the peak
        # (sources.cpp:104)
        amp = 1.0 / complex(0, -2 * math.pi * self.frequency)
        return (math.exp(-tt * tt / (2 * self.width ** 2))
                * np.exp(-2j * math.pi * self.frequency * tt) * amp)

    def fourier_transform(self, f: float) -> complex:
        """(1/sqrt(2 pi)) int e^{i w t} G(t) dt of the current envelope
        (sources.cpp:112)."""
        omega = 2 * math.pi * f
        omega0 = 2 * math.pi * self.frequency
        delta = (omega - omega0) * self.width
        return (self.width * np.exp(1j * omega * self.peak_time)
                * math.exp(-0.5 * delta * delta))

    def last_time(self) -> float:
        return float(np.float32(self.peak_time + self._cut))

    def get_fwidth(self) -> float:
        return _gaussian_bandwidth(self.width)


@dataclasses.dataclass
class ContinuousSource(SourceTime):
    """CW source with tanh turn-on (sources.cpp:128-146)."""
    frequency: float
    start_time: float = 0.0
    end_time: float = 1e20
    width: float = 0.0
    slowness: float = 3.0
    is_integrated: bool = False

    def dipole(self, t: float) -> complex:
        if np.float32(t) < self.start_time or np.float32(t) > self.end_time:
            return 0.0
        amp = 1.0 / complex(0, -2 * math.pi * self.frequency)
        osc = np.exp(-2j * math.pi * self.frequency * t) * amp
        if self.width == 0.0:
            return osc
        ts = (t - self.start_time) / self.width - self.slowness
        te = (self.end_time - t) / self.width - self.slowness
        return osc * (1 + math.tanh(ts)) * (1 + math.tanh(te)) * 0.25

    def last_time(self) -> float:
        return self.end_time

    def get_fwidth(self) -> float:
        return 0.0


@dataclasses.dataclass
class CustomSource(SourceTime):
    """User time function (meep.hpp:1058 custom_src_time)."""
    func: Callable[[float], complex]
    start_time: float = -1e20
    end_time: float = 1e20
    center_frequency: float = 0.0
    fwidth: float = 0.0
    is_integrated: bool = False

    def dipole(self, t: float) -> complex:
        if self.start_time <= np.float32(t) <= self.end_time:
            return self.func(t)
        return 0.0

    def current(self, t: float, dt: float) -> complex:
        if self.is_integrated:
            return super().current(t, dt)
        return self.dipole(t)

    def get_fwidth(self) -> float:
        return self.fwidth


@dataclasses.dataclass
class Source:
    """A current source over a point/volume (python/source.py Source)."""
    src: SourceTime
    component: str                      # 'ez', 'hx', ...
    center: Sequence[float]
    size: Optional[Sequence[float]] = None
    amplitude: complex = 1.0
    amp_func: Optional[Callable] = None
