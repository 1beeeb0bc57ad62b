"""Resonant-mode extraction from time series (the reference's libharminv
role: bands.cpp:51 do_harminv, python Harminv wrapper simulation.py:1052).

Implements the matrix-pencil / filter-diagonalization family: given a signal
c_n = sum_k a_k z_k^n (damped complex exponentials), recover the poles z_k
and amplitudes a_k.  The implementation is the SVD matrix-pencil method
(equivalent accuracy to harminv's Mandelshtam FDM for the mode counts used in
FDTD resonance extraction), restricted to a frequency window.

Runs entirely on the host as post-processing (numpy), like the reference's
library call.  The port's own copy of ``meep_nl_tpu/analysis/harminv.py``
(that package's ``__init__`` imports jax).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Mode:
    """One extracted resonance (harminv output columns)."""
    freq: float        # Re frequency in units of 1/dt-normalized input
    decay: float       # decay rate (positive = decaying)
    Q: float
    amp: float         # |amplitude|
    amplitude: complex
    err: float

    @property
    def omega(self) -> complex:
        return 2 * math.pi * self.freq - 1j * self.decay


def harminv(signal: Sequence[complex], dt: float, fmin: float, fmax: float,
            max_modes: int = 50, svd_tol: float = 1e-7) -> List[Mode]:
    """Extract modes with frequencies in [fmin, fmax].

    Args:
      signal: complex (or real) time series sampled every dt.
      dt: sample spacing in meep time units.
      fmin/fmax: frequency window (units of c/a, like the reference).
    """
    c = np.asarray(signal, dtype=np.complex128)
    # band-limited decimation: the window only needs Nyquist > ~4*fmax, and
    # the pencil SVD is O(n^3/27) (the reference's harminv does the same via
    # its spectral-window projection)
    dec = max(1, int(0.125 / (max(fmax, 1e-30) * dt)))
    if dec > 1:
        c = c[::dec]
        dt = dt * dec
    n = len(c)
    if n < 8:
        return []
    # pencil parameter ~ n/3 is the robust choice; cap for cost
    L = min(max(n // 3, max_modes + 2), n - 2, 600)
    m = n - L
    # Hankel data matrix Y: m x (L+1)
    Y = np.lib.stride_tricks.sliding_window_view(c, L + 1)[:m]
    Y0 = Y[:, :-1]
    Y1 = Y[:, 1:]
    # SVD rank truncation
    U, s, Vh = np.linalg.svd(Y0, full_matrices=False)
    if s[0] == 0:
        return []
    k = int(np.sum(s > svd_tol * s[0]))
    k = min(k, max_modes)
    if k == 0:
        return []
    U, s, Vh = U[:, :k], s[:k], Vh[:k]
    # pencil: z are eigenvalues of pinv(Y0) @ Y1 projected to rank k
    A = (U.conj().T @ Y1 @ Vh.conj().T) / s[:, None]
    z = np.linalg.eigvals(A)

    # amplitudes by least squares against the original signal
    tgood = np.arange(n)
    modes = []
    # filter window and non-physical poles first
    keep = []
    for zk in z:
        if abs(zk) < 1e-12:
            continue
        w = 1j * np.log(zk) / dt          # omega = 2 pi f - i decay
        f = w.real / (2 * math.pi)
        decay = -w.imag
        # positive-f window
        if fmin <= abs(f) <= fmax:
            keep.append((zk, abs(f), math.copysign(1.0, f)))
    if not keep:
        return []
    zs = np.array([kk[0] for kk in keep])
    V = zs[None, :] ** tgood[:, None]
    amp, *_ = np.linalg.lstsq(V, c, rcond=None)
    resid = c - V @ amp
    err_base = np.linalg.norm(resid) / max(np.linalg.norm(c), 1e-300)

    for (zk, fabs, sign), ak in zip(keep, amp):
        w = 1j * np.log(zk) / dt
        f = w.real / (2 * math.pi)
        decay = -w.imag
        Q = abs(f) * 2 * math.pi / (2 * max(decay, 1e-300)) if decay > 0 else np.inf
        modes.append(Mode(freq=f, decay=decay,
                          Q=Q, amp=abs(ak), amplitude=complex(ak),
                          err=float(err_base)))
    # drop tiny amplitudes (numerical poles)
    amax = max((mm.amp for mm in modes), default=0.0)
    modes = [mm for mm in modes if mm.amp > 1e-8 * amax]
    # a real signal contains conjugate-pair poles; report positive
    # frequencies only (matching the reference's harminv output)
    if np.allclose(c.imag, 0.0):
        modes = [mm for mm in modes if mm.freq > 0]
    modes.sort(key=lambda mm: abs(mm.freq))
    return modes


class Harminv:
    """Step-function-style wrapper mirroring python/simulation.py:1052.

    Usage:
        h = Harminv(component, pt, fcen, df)
        sim.run(after_sources(h), until_after_sources=T)
        h.modes -> [Mode]
    """

    def __init__(self, c: str, pt, fcen: float, df: float,
                 mxbands: Optional[int] = None):
        self.c = c
        self.pt = pt
        self.fcen = fcen
        self.df = df
        self.mxbands = mxbands or 50
        self.data: List[complex] = []
        self.modes: List[Mode] = []
        self._dt = None

    def _collect(self, series: np.ndarray, dt: float):
        self.data = list(series)
        self._dt = dt

    def _analyze(self):
        if not self.data:
            return
        self.modes = harminv(self.data, self._dt,
                             self.fcen - self.df / 2, self.fcen + self.df / 2,
                             max_modes=self.mxbands)
