"""Near-to-far field transformation (analog of src/near2far.cpp).

The port's own copy of ``meep_nl_tpu/analysis/near2far.py`` (numpy and
scipy; the state's accumulators may be tensors on any device).

From DTFT tangential fields on a closed near surface, computes far fields via
the free-space Green's functions (near2far.cpp:133 green3d, :208 green2d) and
the surface-equivalence weights of add_dft_near2far (near2far.cpp:625-637):
each tangential component c on a plane with normal nd contributes as an
equivalent current of component c0 (the dual field's other transverse
component) with sign s = +-1 from n x (.).

All post-processing on the host (numpy/scipy), like the reference's
sum-over-surface-points; the heavy part is a broadcasted evaluation over
(surface points x far points x frequencies).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.special import hankel1


def green3d_w(x: np.ndarray, freq: float, eps: float, mu: float,
              x0: np.ndarray, c0: str) -> np.ndarray:
    """Per-point far-field weights: (6, npts) such that the far fields at x
    from currents f0 are `green3d_w(...) @ f0` — the linearity of the
    Green's function made explicit so adjoint objectives can treat the
    near-to-far transform as a constant contraction over the DTFT leaves
    (the analog of near2far.cpp:340 farfield_lowlevel's per-point sum)."""
    rvec = x[None, :] - x0                      # (npts, 3)
    r = np.linalg.norm(rvec, axis=-1)
    rhat = rvec / r[:, None]
    n = np.sqrt(eps * mu)
    k = 2 * np.pi * freq * n
    ikr = 1j * k * r
    ikr2 = -(k * r) ** 2
    # J = -i w p  =>  divide by -i w relative to dipole-moment formulas
    expfac = (k * n / (4 * np.pi * r)) * np.exp(1j * (k * r + np.pi / 2))
    Z = np.sqrt(mu / eps)
    p = np.zeros(3)
    p["xyz".index(c0[1])] = 1.0
    pdotrhat = rhat @ p
    rhatcrossp = np.cross(rhat, p)
    term1 = 1.0 - 1.0 / ikr + 1.0 / ikr2
    term2 = (-1.0 + 3.0 / ikr - 3.0 / ikr2) * pdotrhat
    term3 = 1.0 - 1.0 / ikr
    EH = np.zeros((6, len(r)), np.complex128)
    if c0[0] == "e":
        ef = expfac / eps
        for d in range(3):
            EH[d] = ef * (term1 * p[d] + term2 * rhat[:, d])
            EH[3 + d] = ef * term3 * rhatcrossp[:, d] / Z
    else:
        ef = expfac / mu
        for d in range(3):
            EH[d] = -ef * term3 * rhatcrossp[:, d] * Z
            EH[3 + d] = ef * (term1 * p[d] + term2 * rhat[:, d])
    return EH


def green3d(x: np.ndarray, freq: float, eps: float, mu: float,
            x0: np.ndarray, c0: str, f0: np.ndarray) -> np.ndarray:
    """Fields (Ex,Ey,Ez,Hx,Hy,Hz) at x from point currents f0 of component
    c0 at x0 (near2far.cpp:133).  x: (3,), x0: (npts,3), f0: (npts,),
    returns (6,) summed over points."""
    return green3d_w(x, freq, eps, mu, x0, c0) @ f0


def green2d_w(x: np.ndarray, freq: float, eps: float, mu: float,
              x0: np.ndarray, c0: str) -> np.ndarray:
    """Per-point 2D far-field weights (6, npts); see green3d_w."""
    rvec = x[None, :] - x0
    r = np.linalg.norm(rvec, axis=-1)
    rhat = rvec / r[:, None]
    omega = 2 * np.pi * freq
    k = omega * np.sqrt(eps * mu)
    kr = k * r
    Z = np.sqrt(mu / eps)
    H0 = hankel1(0, kr)
    H1 = hankel1(1, kr)
    ikH1 = 0.25j * k * H1
    EH = np.zeros((6, len(r)), np.complex128)
    d0 = c0[1]
    if d0 == "z":
        if c0[0] == "e":     # Ez line current
            EH[2] = (-0.25 * omega * mu) * H0
            EH[3] = -rhat[:, 1] * ikH1
            EH[4] = rhat[:, 0] * ikH1
        else:                # Hz line current
            EH[0] = rhat[:, 1] * ikH1
            EH[1] = -rhat[:, 0] * ikH1
            EH[5] = (-0.25 * omega * eps) * H0
        return EH
    # in-plane current
    H2 = hankel1(2, kr)
    p = np.zeros(2)
    p["xy".index(d0)] = 1.0
    pdotrhat = rhat @ p
    rhatcrossp = rhat[:, 0] * p[1] - rhat[:, 1] * p[0]
    if c0[0] == "e":
        EH[0] = (-(rhat[:, 0] * (pdotrhat / r * 0.25 * Z)) * H1
                 + (rhat[:, 1] * (rhatcrossp * omega * mu * 0.125)) * (H0 - H2))
        EH[1] = (-(rhat[:, 1] * (pdotrhat / r * 0.25 * Z)) * H1
                 - (rhat[:, 0] * (rhatcrossp * omega * mu * 0.125)) * (H0 - H2))
        EH[5] = -rhatcrossp * ikH1
    else:
        EH[2] = rhatcrossp * ikH1
        EH[3] = (-(rhat[:, 0] * (pdotrhat / r * 0.25 / Z)) * H1
                 + (rhat[:, 1] * (rhatcrossp * omega * eps * 0.125)) * (H0 - H2))
        EH[4] = (-(rhat[:, 1] * (pdotrhat / r * 0.25 / Z)) * H1
                 - (rhat[:, 0] * (rhatcrossp * omega * eps * 0.125)) * (H0 - H2))
    return EH


def green2d(x: np.ndarray, freq: float, eps: float, mu: float,
            x0: np.ndarray, c0: str, f0: np.ndarray) -> np.ndarray:
    """2D Green's function (near2far.cpp:208): x (2,), x0 (npts,2)."""
    return green2d_w(x, freq, eps, mu, x0, c0) @ f0


def greencyl_w(x: np.ndarray, freq: float, eps: float, mu: float,
               x0: np.ndarray, c0: str, m: float,
               tol: float = 1e-3) -> np.ndarray:
    """Cylindrical far-field weights (6, npts) at the phi=0 plane
    (near2far.cpp:279 greencyl): the 3D Green's function integrated over
    the source ring with exp(i m phi) dependence, quadrature points
    doubled until the L1 change is below `tol`.  The 2*pi*r factor lives
    in the near-surface dV weights (near2far_specs), so the phi measure
    here is dphi/(2*pi) * 2*pi = dphi as in the reference.

    x: (2,) far point (r, z) evaluated at phi=0 -> 3D (r, 0, z);
    x0: (npts, 2) source (r, z) ring centers; c0 in {er, ep, ez, hr, hp,
    hz}."""
    x3 = np.array([x[0], 0.0, x[1]])
    r0 = x0[:, 0]
    z0 = x0[:, 1]
    d0 = c0[1]
    ft = c0[0]
    cx, cy, cz = ft + "x", ft + "y", ft + "z"

    def quad_term(phi, dphi):
        """Sum of rotated-source green3d weights at angles `phi`."""
        acc = np.zeros((6, len(r0)), np.complex128)
        for ph in phi:
            c, s = np.cos(ph), np.sin(ph)
            pts = np.stack([r0 * c, r0 * s, z0], axis=-1)
            w = np.exp(1j * m * ph) * dphi
            if d0 == "z":
                acc += w * green3d_w(x3, freq, eps, mu, pts, cz)
            elif d0 == "r":      # r_hat = c x_hat + s y_hat
                acc += (w * c) * green3d_w(x3, freq, eps, mu, pts, cx)
                acc += (w * s) * green3d_w(x3, freq, eps, mu, pts, cy)
            else:                # p: phi_hat = c y_hat - s x_hat
                acc += (w * -s) * green3d_w(x3, freq, eps, mu, pts, cx)
                acc += (w * c) * green3d_w(x3, freq, eps, mu, pts, cy)
        return acc

    N0 = 16 + int(4 * abs(m))
    ang = 2 * np.pi / N0
    # measure = dphi/(2*pi): the 2*pi*r ring factor lives in the near
    # weights, so the kernel is the phi-AVERAGE (the reference's
    # dphi = 2/N0 halved before first use, i.e. 1/N)
    EH = quad_term(np.arange(N0) * ang, 1.0 / N0)
    N = N0
    while N < 65536:
        N *= 2
        ang *= 0.5
        # previous points keep their sums (halved measure); add odd points
        EH_new = 0.5 * EH + quad_term((np.arange(1, N, 2)) * ang, 1.0 / N)
        sumdiff = np.abs(EH - EH_new).sum()
        sumabs = np.abs(EH_new).sum()
        EH = EH_new
        if sumdiff <= sumabs * tol:
            break
    return EH


# equivalent-current mapping for a plane with normal nd (near2far.cpp:584-637):
# transverse dirs fd in cyclic order; recorded component -> (c0, sign)
_CYCLIC_FD = {"x": ("y", "z"), "y": ("z", "x"), "z": ("x", "y")}
_CYCLIC_FD_CYL = {"r": ("p", "z"), "p": ("z", "r"), "z": ("r", "p")}


def equivalence_terms(normal: str, dim: str = "3d"):
    """[(recorded_component, equivalent_source_component, sign), ...]"""
    fd0, fd1 = (_CYCLIC_FD_CYL if dim == "cyl" else _CYCLIC_FD)[normal]
    out = []
    for i, ft in enumerate(("e", "h")):
        dual = "h" if ft == "e" else "e"
        for j, fd in enumerate((fd0, fd1)):
            c = ft + fd
            c0 = dual + (fd1 if j == 0 else fd0)
            s = 1.0 if j == 0 else -1.0
            if ft == "e":
                s = -s
            out.append((c, c0, s))
    return out


@dataclasses.dataclass
class Near2FarSurface:
    """One recorded near-surface term: the DTFT array + its site coords."""
    c0: str                 # equivalent source component
    coords: np.ndarray      # (npts, ndim) absolute coordinates
    dft_name: str           # key into state['dft'] (weights include s*dV)


def _current_parity(c0: str, d: str) -> float:
    """Sign of equivalent-current component c0 under a mirror in d.

    Electric currents J transform as E (polar vector), magnetic currents
    M as H (pseudovector); the surface normal flip is already baked in:
    J' = n' x H' = (Mn) x (-p MH) = p M (n x H) (symmetry.cpp
    transform applied to the equivalence currents)."""
    if c0[0] in ("e", "d"):
        return -1.0 if c0[1] == d else 1.0
    return 1.0 if c0[1] == d else -1.0


def farfield(surfaces: Sequence[Near2FarSurface], state, freqs,
             x: Sequence[float], dim: str, eps: float = 1.0, mu: float = 1.0,
             m: float = 0.0, periodic: Sequence = (),
             mirrors: Sequence = ()) -> np.ndarray:
    """(6, nfreq) far fields at x (farfield_lowlevel, near2far.cpp:340).

    `periodic` entries (axis_index, nper, phase_per_period, period)
    replicate the near surface over 2*nper+1 lattice images with the
    Bloch phase e^{i n k L} each (near2far.cpp:33-41, 370-380).
    `mirrors` entries (axis_index, d_letter, phase) add the mirror image
    of every stored surface (reflected coords, current-parity-weighted
    amplitudes) — the role of the reference's symmetry transforms in
    loop_in_chunks feeding the Green's sum.
    dim == 'cyl' integrates the ring sources via greencyl (m = azimuthal
    number)."""
    x = np.asarray(x, np.float64)
    nfreq = len(freqs)
    EH = np.zeros((6, nfreq), np.complex128)

    def images(coords, f0, c0):
        """Extend (coords, amplitudes) over periodic + mirror images."""
        cs, fs = [coords], [f0]
        for (ax, nper, kphase, period) in periodic:
            cs2, fs2 = [], []
            for n in range(-nper, nper + 1):
                for c_, f_ in zip(cs, fs):
                    cc = c_.copy()
                    cc[:, ax] = cc[:, ax] + n * period
                    cs2.append(cc)
                    fs2.append(f_ * np.exp(1j * n * kphase))
            cs, fs = cs2, fs2
        for (ax, d, phase) in mirrors:
            # image amplitudes pick up the current parity; points ON the
            # plane self-image with the engine's half weight, so stored +
            # image sum to (1+s)/2 of the full-cell row there — exact for
            # both parities (odd currents vanish on the plane)
            s = float(phase) * _current_parity(c0, d)
            cs2, fs2 = list(cs), list(fs)
            for c_, f_ in zip(cs, fs):
                cc = c_.copy()
                cc[:, ax] = -cc[:, ax]
                cs2.append(cc)
                fs2.append(s * f_)
            cs, fs = cs2, fs2
        return np.concatenate(cs, axis=0), np.concatenate(fs, axis=0)

    from ..stepper.monitors import _dv
    for surf in surfaces:
        dft = _dv(state["dft"][surf.dft_name])
        flat = dft.reshape(-1, nfreq)
        for i, f in enumerate(freqs):
            coords, f0 = images(surf.coords, flat[:, i], surf.c0) \
                if (periodic or mirrors) else (surf.coords, flat[:, i])
            if dim == "cyl":
                EH[:, i] += greencyl_w(x, f, eps, mu, coords,
                                       surf.c0, m) @ f0
            elif dim == "2d":
                EH[:, i] += green2d(x, f, eps, mu, coords, surf.c0, f0)
            else:
                EH[:, i] += green3d(x, f, eps, mu, coords, surf.c0, f0)
    return EH
