"""DTFT monitor construction: volumes -> centered-grid regions + weights.

The port's own copy of the flux parts of ``meep_nl_tpu/stepper/monitors.py``
(pure numpy).  Implements the reference's integration-weight scheme
(loop_in_chunks.cpp:30-100 s0/s1/e0/e1 cases) on the centered grid, and the
dft_flux assembly (dft.cpp:533 `dft_flux::flux`, dft.cpp:578
`add_dft_flux`):

  * per flux plane, four DTFT accumulators: E tangential pair with
    interp+dV weights (stored weight +1/-1), H tangential pair raw;
  * flux(w) = sum Re(dftE * conj(dftH)) over points and pairs.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core import grid as G
from .plan import DftSpec, Plan


def _dv(arr) -> np.ndarray:
    """Host complex view of a real-pair (..., nfreq, 2) DFT accumulator
    (a tensor on any device, or an array)."""
    if hasattr(arr, "detach"):
        arr = arr.detach().cpu().numpy()
    arr = np.asarray(arr)
    return arr[..., 0] + 1j * arr[..., 1]


def _axis_weights(gv: G.GridVolume, axis: int, lo: float, hi: float
                  ) -> Tuple[int, int, np.ndarray]:
    """Integration/interpolation weights along one axis of the centered grid.

    Returns (start, stop, weights) with stop exclusive, implementing the four
    cases documented at loop_in_chunks.cpp:30-100."""
    c0 = gv.origin[axis] + 0.5 * gv.dx   # centered-lattice coordinate of i=0
    n = gv.num[axis]                     # centered lattice has n points
    fa = (lo - c0) / gv.dx
    fb = (hi - c0) / gv.dx
    return _axis_weights_lattice(fa, fb, n)


def _axis_weights_lattice(fa: float, fb: float, n: int
                          ) -> Tuple[int, int, np.ndarray]:
    """Weight engine on an abstract unit lattice of n points; fa/fb are the
    volume endpoints in lattice coordinates."""
    eps = 1e-9
    if abs(fb - fa) < eps:
        # case 4: pure interpolation
        i0 = int(math.floor(fa + eps))
        w0 = 1.0 - (fa - i0)
        pts = []
        if 0 <= i0 < n and w0 > eps:
            pts.append((i0, w0))
        if 0 <= i0 + 1 < n and (1 - w0) > eps:
            pts.append((i0 + 1, 1.0 - w0))
        if not pts:
            i0 = min(max(i0, 0), n - 1)
            pts = [(i0, 1.0)]
        start = pts[0][0]
        stop = pts[-1][0] + 1
        w = np.zeros(stop - start)
        for i, wi in pts:
            w[i - start] = wi
        return start, stop, w

    i_first = int(math.ceil(fa - eps))   # first lattice point >= a
    i_last = int(math.floor(fb + eps))   # last lattice point <= b
    w0 = i_first - fa                    # in [0, 1)
    w1 = fb - i_last
    if i_last >= i_first + 1:
        # case 1: at least two interior points
        start = i_first - 1
        stop = i_last + 2
        w = np.ones(stop - start)
        w[0] = w0 * w0 / 2
        w[1] = 1 - (1 - w0) ** 2 / 2
        w[-1] = w1 * w1 / 2
        w[-2] = 1 - (1 - w1) ** 2 / 2
    elif i_last == i_first:
        # case 2: one interior point; middle weight s1 = e1 =
        # 1 - (1-w0)^2/2 - (1-w1)^2/2
        start = i_first - 1
        stop = i_first + 2
        w = np.array([w0 * w0 / 2,
                      1 - (1 - w0) ** 2 / 2 - (1 - w1) ** 2 / 2,
                      w1 * w1 / 2])
    else:
        # case 3: no lattice point strictly inside
        start = i_last
        stop = i_first + 1
        s0 = w0 * w0 / 2 - (1 - w1) ** 2 / 2
        e0 = w1 * w1 / 2 - (1 - w0) ** 2 / 2
        w = np.array([s0, e0])

    # clip to the lattice
    if start < 0:
        w = w[-start:]
        start = 0
    if stop > n:
        w = w[: n - stop]
        stop = n
    return start, stop, w


def volume_region_weights(gv: G.GridVolume, center: Sequence[float],
                          size: Sequence[float]
                          ) -> Tuple[Tuple[Tuple[int, int], ...], np.ndarray, float]:
    """Region slices + outer-product weights on the centered lattice, and the
    integration dV0 (loop_in_chunks.cpp:505: dx per direction of nonzero
    extent)."""
    region = []
    axis_w = []
    dv = 1.0
    for ax in range(gv.ndim):
        lo = center[ax] - 0.5 * size[ax]
        hi = center[ax] + 0.5 * size[ax]
        start, stop, w = _axis_weights(gv, ax, lo, hi)
        region.append((start, stop))
        axis_w.append(w)
        if size[ax] > 0:
            dv *= gv.dx
    w_full = axis_w[0]
    for w in axis_w[1:]:
        w_full = np.multiply.outer(w_full, w)
    if gv.dim == "cyl":
        # cylindrical integration measure 2 pi r (loop_in_chunks.cpp:508-512)
        rax = gv.axis_of("r")
        r_cent = gv.origin[rax] + (np.arange(region[rax][0],
                                             region[rax][1]) + 0.5) * gv.dx
        shape = [1] * len(axis_w)
        shape[rax] = -1
        w_full = w_full * (2 * np.pi * np.abs(r_cent)).reshape(shape)
    return tuple(region), w_full, dv


# tangential pairs per flux normal (add_dft_flux, dft.cpp:600-612):
#   Sx: E=(Ey,Ez) H=(Hz,Hy);  Sy: E=(Ez,Ex) H=(Hx,Hz);  Sz: E=(Ex,Ey) H=(Hy,Hx)
_FLUX_PAIRS = {
    "x": (("ey", "ez"), ("hz", "hy")),
    "y": (("ez", "ex"), ("hx", "hz")),
    "z": (("ex", "ey"), ("hy", "hx")),
    "r": (("ep", "ez"), ("hz", "hp")),
    "p": (("ez", "er"), ("hr", "hz")),
}


def flux_specs(gv: G.GridVolume, name: str, normal: str,
               center: Sequence[float], size: Sequence[float],
               freqs: Sequence[float], decimation: int = 1,
               weight: float = 1.0,
               live: Optional[Sequence[str]] = None) -> List[DftSpec]:
    """Four DTFT specs implementing one flux plane (dft.cpp:578).

    `live` restricts to components actually stepped (e.g. TM-only runs), so
    monitors don't pull dead polarizations into the live set."""
    region, w_full, dv = volume_region_weights(gv, center, size)
    if gv.dim == "cyl" and normal == "z":
        # Sz in cylindrical: E=(Er,Ep), H=(Hp,Hr)  (dft.cpp:606)
        cE, cH = ("er", "ep"), ("hp", "hr")
    else:
        cE, cH = _FLUX_PAIRS[normal]
    freqs = np.asarray(freqs, dtype=np.float64)
    specs = []
    ones = np.ones_like(w_full)
    for i in range(2):
        ec, hc = cE[i], cH[i]
        if ec not in gv.e_components or hc not in gv.h_components:
            continue
        if live is not None and (ec not in live or hc not in live):
            continue
        sgn = 1.0 if i == 0 else -1.0
        specs.append(DftSpec(
            name=f"{name}:e{i}", component=ec, region=region,
            weights=w_full * dv, freqs=freqs, scale=weight * sgn,
            decimation=decimation))
        specs.append(DftSpec(
            name=f"{name}:h{i}", component=hc, region=region,
            weights=ones, freqs=freqs, scale=1.0, decimation=decimation))
    return specs


def get_flux(plan: Plan, state, name: str) -> np.ndarray:
    """flux(w) = sum Re(dftE * conj(dftH)) (dft.cpp:533)."""
    out = None
    for i in range(2):
        ekey, hkey = f"{name}:e{i}", f"{name}:h{i}"
        if ekey not in state["dft"]:
            continue
        dE = _dv(state["dft"][ekey])
        dH = _dv(state["dft"][hkey])
        f = np.real(dE * np.conj(dH))
        f = f.reshape(-1, f.shape[-1]).sum(axis=0)
        out = f if out is None else out + f
    return out
