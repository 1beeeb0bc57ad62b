"""DTFT monitor construction: volumes -> centered-grid regions + weights.

The port's own copy of ``meep_nl_tpu/stepper/monitors.py`` (pure numpy).
Implements the reference's integration-weight scheme
(loop_in_chunks.cpp:30-100 s0/s1/e0/e1 cases) on the centered grid, and
the assembly of each monitor kind from its DTFT accumulators:

  * flux (dft.cpp:533 `dft_flux::flux`, dft.cpp:578 `add_dft_flux`): per
    plane four accumulators, the E tangential pair with interp+dV weights
    (stored weight +1/-1), the H pair raw; flux(w) = sum Re(dftE conj(dftH));
  * fields (`add_dft_fields`): one raw accumulator per component;
  * energy (`dft_energy`): E with D and H with B, u = 1/2 Re(F* G);
  * near2far (`add_dft_near2far`): the equivalent-current components on
    their own Yee lattices (uncentred), with the sites' coordinates;
  * force (`dft_force`, stress.cpp): the Maxwell stress-tensor products.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core import grid as G
from .plan import DftSpec, Plan


def _dv(arr) -> np.ndarray:
    """Host complex view of a real-pair (..., nfreq, 2) DFT accumulator
    (a tensor on any device, or an array): the reference's step.dft_view
    (step.py:1292-1299), whose accumulators are real pairs in every field
    storage, as the port's are."""
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


def field_specs(gv: G.GridVolume, name: str, component: str,
                center: Sequence[float], size: Sequence[float],
                freqs: Sequence[float], decimation: int = 1) -> List[DftSpec]:
    """dft_fields-style monitor: raw DTFT of one component over a volume
    (meep.hpp:1436), with interp weights but no dV."""
    region, w_full, _ = volume_region_weights(gv, center, size)
    return [DftSpec(name=name, component=component, region=region,
                    weights=w_full, freqs=freqs, scale=1.0,
                    decimation=decimation)]


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


# energy-density pairs: E with D, H with B (dft.cpp:657-687 dft_energy)
def energy_specs(gv: G.GridVolume, name: str, center, size, freqs,
                 live: Optional[Sequence[str]] = None,
                 decimation: int = 1, weight: float = 1.0) -> List[DftSpec]:
    """DTFT specs for u(w) = 1/2 Re(E* . D) + 1/2 Re(H* . B) over a volume
    (add_dft_energy; dft.cpp:689 total).  `weight` scales the assembled
    energy linearly (mirror-fold factor)."""
    region, w_full, dv = volume_region_weights(gv, center, size)
    dv = dv * weight
    freqs = np.asarray(freqs, dtype=np.float64)
    ones = np.ones_like(w_full)
    specs = []
    for c in list(gv.e_components) + list(gv.h_components):
        if live is not None and c not in live:
            continue
        pair = ("d" if c[0] == "e" else "b") + c[1]
        specs.append(DftSpec(name=f"{name}:{c}", component=c, region=region,
                             weights=w_full * dv, freqs=freqs,
                             decimation=decimation))
        specs.append(DftSpec(name=f"{name}:{pair}", component=pair,
                             region=region, weights=ones, freqs=freqs,
                             decimation=decimation))
    return specs


def get_energy(plan: Plan, state, name: str,
               which: str = "total") -> np.ndarray:
    """Assemble frequency-domain energy (dft_energy::electric/magnetic)."""
    gv = plan.gv
    out = None
    fts = {"electric": "e", "magnetic": "h"}.get(which)
    for key in state["dft"]:
        if not key.startswith(name + ":"):
            continue
        c = key.rsplit(":", 1)[1]
        if c[0] not in "eh":
            continue
        if fts is not None and c[0] != fts:
            continue
        pair = ("d" if c[0] == "e" else "b") + c[1]
        dF = _dv(state["dft"][key])
        dG = _dv(state["dft"][f"{name}:{pair}"])
        v = 0.5 * np.real(np.conj(dF) * dG)
        v = v.reshape(-1, v.shape[-1]).sum(axis=0)
        out = v if out is None else out + v
    return out


def comp_lattice_region_weights(gv: G.GridVolume, c: str, center, size
                                ) -> Tuple[Tuple[Tuple[int, int], ...],
                                           np.ndarray, float, np.ndarray]:
    """Region + weights on component c's own Yee lattice, plus the absolute
    coordinates of the selected sites (for near2far's Green sums)."""
    region = []
    axis_w = []
    dv = 1.0
    coord_list = []
    for ax in range(gv.ndim):
        coords = gv.comp_coords(c, ax)
        ys = G.yee_shift(c, gv.dim)[gv.axes[ax]]
        nlat = gv.num[ax] + (0 if ys else 1)
        lo = center[ax] - 0.5 * size[ax]
        hi = center[ax] + 0.5 * size[ax]
        fa = (lo - coords[0]) / gv.dx
        fb = (hi - coords[0]) / gv.dx
        start, stop, w = _axis_weights_lattice(fa, fb, nlat)
        region.append((start, stop))
        axis_w.append(w)
        coord_list.append(coords[start:stop])
        if size[ax] > 0:
            dv *= gv.dx
    w_full = axis_w[0]
    for w in axis_w[1:]:
        w_full = np.multiply.outer(w_full, w)
    mesh = np.meshgrid(*coord_list, indexing="ij")
    pts = np.stack([m.ravel() for m in mesh], axis=-1)
    return tuple(region), w_full, dv, pts


def near2far_specs(gv: G.GridVolume, name: str, normal: str, center, size,
                   freqs, weight: float = 1.0,
                   live: Optional[Sequence[str]] = None):
    """Specs + surface descriptors for one near2far plane
    (add_dft_near2far, near2far.cpp:558-641)."""
    from ..analysis.near2far import equivalence_terms, Near2FarSurface
    freqs = np.asarray(freqs, np.float64)
    specs, surfaces = [], []
    for c, c0, s in equivalence_terms(normal, gv.dim):
        if c not in list(gv.e_components) + list(gv.h_components):
            continue
        if live is not None and c not in live:
            continue
        region, w_full, dv, pts = comp_lattice_region_weights(gv, c, center,
                                                              size)
        if gv.dim == "cyl":
            # ring measure 2*pi*r: greencyl integrates dphi only
            # (near2far.cpp:279 note)
            rax = gv.axis_of("r")
            w_full = w_full * (2 * np.pi * np.abs(
                pts[:, rax].reshape(w_full.shape)))
        key = f"{name}:{c}"
        specs.append(DftSpec(name=key, component=c, region=region,
                             weights=w_full * dv, freqs=freqs,
                             scale=s * weight, centered=False))
        surfaces.append(Near2FarSurface(c0=c0, coords=pts, dft_name=key))
    return specs, surfaces


def force_specs(gv: G.GridVolume, name: str, force_dir: str, normal: str,
                center, size, freqs, weight: float = 1.0,
                live: Optional[Sequence[str]] = None) -> List[DftSpec]:
    """Maxwell stress-tensor monitor (add_dft_force, stress.cpp:153):
    off-diagonal E/H pair products for force_dir != normal, +-|E_d|^2/2
    diagonal terms otherwise."""
    region, w_full, dv = volume_region_weights(gv, center, size)
    freqs = np.asarray(freqs, np.float64)
    ones = np.ones_like(w_full)
    specs = []

    def live_ok(c):
        return live is None or c in live

    if force_dir != normal:
        for ft in ("e", "h"):
            c1, c2 = ft + force_dir, ft + normal
            if c1 in gv.e_components + gv.h_components and live_ok(c1) \
                    and live_ok(c2):
                specs.append(DftSpec(name=f"{name}:od1:{ft}", component=c1,
                                     region=region, weights=w_full * dv,
                                     freqs=freqs, scale=weight))
                specs.append(DftSpec(name=f"{name}:od2:{ft}", component=c2,
                                     region=region, weights=ones,
                                     freqs=freqs))
    else:
        for ft in ("e", "h"):
            for d in (gv.axes if gv.dim != "2d" else ("x", "y", "z")):
                c = ft + d
                if c not in gv.e_components + gv.h_components \
                        or not live_ok(c):
                    continue
                sgn = 0.5 if d == force_dir else -0.5
                specs.append(DftSpec(name=f"{name}:diag:{c}", component=c,
                                     region=region,
                                     weights=np.sqrt(np.maximum(
                                         w_full * dv, 0.0)),
                                     freqs=freqs, scale=sgn * weight))
    return specs


def get_force(plan: Plan, state, name: str) -> np.ndarray:
    """Assemble the stress-tensor force (dft_force::force, stress.cpp)."""
    out = None

    def acc(v):
        nonlocal out
        out = v if out is None else out + v

    for ft in ("e", "h"):
        k1, k2 = f"{name}:od1:{ft}", f"{name}:od2:{ft}"
        if k1 in state["dft"]:
            a = _dv(state["dft"][k1])
            b = _dv(state["dft"][k2])
            acc(np.real(np.conj(a) * b).reshape(-1, a.shape[-1]).sum(0))
    for key in state["dft"]:
        if key.startswith(f"{name}:diag:"):
            a = _dv(state["dft"][key])
            spec = next(s for s in plan.dfts if s.name == key)
            # scale was folded into the accumulation linearly; |a|^2 carries
            # scale^2, so divide one factor out and reapply its sign
            sc = spec.scale
            acc((np.abs(a) ** 2 / abs(sc) * np.sign(np.real(sc)))
                .reshape(-1, a.shape[-1]).sum(0))
    return out
