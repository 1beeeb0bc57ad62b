"""Scene rasterization: GeometricObject list -> MaterialSpec on Yee sites.

The port's own copy of ``meep_nl_tpu/models/scene.py::rasterize`` (numpy),
the analog of meepgeom.cpp `set_materials_from_geometry` (meepgeom.cpp:233)
with the subpixel smoothing of anisotropic_averaging.cpp.  The JAX package
may take a C++ fast path for the subpixel sums; this copy always runs the
numpy path, which sums the same samples in the same order.

Subpixel scheme: each component site's voxel is supersampled; for interface
voxels the interface normal (analytic where the shape knows it, else the
fill-fraction gradient) combines
    einv_eff = <1/eps> * n_d^2 + (1/<eps>) * (1 - n_d^2)
i.e. harmonic averaging along the normal and arithmetic tangentially.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import grid as G
from ..stepper.plan import MaterialSpec, PolSpec
from .geom import GeometricObject, Medium

_SLOT = {"x": 0, "y": 1, "z": 2, "r": 0, "p": 1}


def _material_at(pts: np.ndarray, geometry: Sequence[GeometricObject],
                 default: Medium) -> np.ndarray:
    """Index of the material governing each point (-1 = default).  Later
    objects take precedence (doc/docs/Python_User_Interface.md:136)."""
    idx = np.full(pts.shape[:-1], -1, dtype=np.int32)
    for i in range(len(geometry)):
        mask = geometry[i].inside(pts)
        idx = np.where(mask, i, idx)
    return idx


def _eps_of(idx: np.ndarray, geometry, default: Medium, dind: int) -> np.ndarray:
    """Diagonal epsilon entry `dind` (0/1/2 for x/y/z) per point."""
    out = np.full(idx.shape, tuple(default.eps_diag_vec())[dind])
    for i, obj in enumerate(geometry):
        v = tuple(obj.material.eps_diag_vec())[dind]
        out = np.where(idx == i, v, out)
    return out


def _scalar_of(idx: np.ndarray, geometry, default: Medium, getter) -> np.ndarray:
    out = np.full(idx.shape, getter(default), dtype=np.float64)
    for i, obj in enumerate(geometry):
        out = np.where(idx == i, getter(obj.material), out)
    return out


def _site_points(gv: G.GridVolume, c: str) -> np.ndarray:
    """(shape..., 3) absolute coordinates of component c's sample sites."""
    coords = [gv.comp_coords(c, ax) for ax in range(gv.ndim)]
    mesh = np.meshgrid(*coords, indexing="ij")
    pts = np.zeros(gv.shape + (3,))
    for ax, d in enumerate(gv.axes):
        pts[..., _SLOT[d]] = mesh[ax]
    if gv.dim == "1d":
        pts[..., 2] = mesh[0]
        pts[..., 0] = 0.0
    return pts


def _subsample_offsets(gv: G.GridVolume, n: int) -> np.ndarray:
    """(n^ndim, 3) offsets spanning one voxel around a site."""
    one = (np.arange(n) + 0.5) / n - 0.5
    grids = np.meshgrid(*([one] * gv.ndim), indexing="ij")
    offs = np.zeros((n ** gv.ndim, 3))
    for ax, d in enumerate(gv.axes):
        offs[:, _SLOT[d]] = grids[ax].ravel() * gv.dx
    if gv.dim == "1d":
        offs[:, 2] = grids[0].ravel() * gv.dx
        offs[:, 0] = 0.0
    return offs


def _corner_offsets(gv: G.GridVolume) -> List[np.ndarray]:
    """The 2^ndim voxel-corner offsets around a site."""
    half = 0.5 * gv.dx
    offs = []
    for combo in itertools.product((-half, half), repeat=gv.ndim):
        off = np.zeros(3)
        for ax, v in enumerate(combo):
            off[_SLOT[gv.axes[ax]]] = v
        if gv.dim == "1d":
            off[2] = combo[0]
            off[0] = 0.0
        offs.append(off)
    return offs


def _analytic_normals(gv: G.GridVolume, pts: np.ndarray,
                      geometry: Sequence[GeometricObject]
                      ) -> Optional[np.ndarray]:
    """(shape, 3) exact interface normals at voxels whose governing object
    boundary crosses them; NaN where no analytic normal is available."""
    normals = None
    corner = _corner_offsets(gv)
    for obj in geometry:                      # later objects overwrite
        ins = [obj.inside(pts + off) for off in corner]
        varies = np.logical_or.reduce(ins) & ~np.logical_and.reduce(ins)
        if not varies.any():
            continue
        n = obj.normal_at(pts)
        if normals is None:
            normals = np.full(pts.shape, np.nan)
        normals[varies] = np.nan if n is None else n[varies]
    return normals


def rasterize(gv: G.GridVolume, geometry: Sequence[GeometricObject],
              default_material: Medium = Medium(),
              eps_averaging: bool = True,
              subpixel_n: int = 3,
              live_e: Optional[Sequence[str]] = None,
              live_h: Optional[Sequence[str]] = None) -> MaterialSpec:
    geometry = list(geometry)
    live_e = list(live_e) if live_e is not None else list(gv.e_components)
    live_h = list(live_h) if live_h is not None else list(gv.h_components)

    chi1inv: Dict[str, Dict[str, Optional[np.ndarray]]] = {}
    cond: Dict[str, Optional[np.ndarray]] = {}
    chi2: Dict[str, Optional[np.ndarray]] = {}
    chi3: Dict[str, Optional[np.ndarray]] = {}
    nr_chi2: Dict[str, Optional[np.ndarray]] = {}

    all_media = [g.material for g in geometry] + [default_material]

    def nontrivial(getter):
        return any(abs(getter(m)) > 0 for m in all_media)

    # ---- epsilon rows on E sites -----------------------------------------
    for c in live_e:
        d_c = G.component_direction(c)
        dind = _SLOT[d_c]
        pts = _site_points(gv, c)
        if eps_averaging and geometry:
            offs = _subsample_offsets(gv, subpixel_n)
            eps_sum = np.zeros(gv.shape)
            inv_sum = np.zeros(gv.shape)
            for off in offs:
                idx = _material_at(pts + off, geometry, default_material)
                e = _eps_of(idx, geometry, default_material, dind)
                eps_sum += e
                inv_sum += 1.0 / e
            mean_eps = eps_sum / len(offs)
            mean_inv = inv_sum / len(offs)
            # interface normal: analytic per-shape where the surface is
            # known, else the fill-fraction-gradient estimate
            grads = [np.gradient(mean_eps, axis=ax)
                     for ax in range(gv.ndim)]
            grad2 = sum(g * g for g in grads)
            gnorm = np.sqrt(np.maximum(grad2, 1e-30))
            nvec = np.zeros(gv.shape + (3,))
            for ax in range(gv.ndim):
                slot = _SLOT[gv.axes[ax]]
                nvec[..., slot] = np.where(grad2 > 1e-30,
                                           grads[ax] / gnorm, 0.0)
            an = _analytic_normals(gv, pts, geometry)
            if an is not None:
                have = np.isfinite(an[..., 0])
                nvec = np.where(have[..., None], an, nvec)
            n_own = nvec[..., dind]
            nd2 = n_own * n_own
            # Kottke tensor for isotropic two-material voxels, diagonal row
            einv = mean_inv * nd2 + (1.0 / mean_eps) * (1.0 - nd2)
        else:
            idx = _material_at(pts, geometry, default_material)
            einv = 1.0 / _eps_of(idx, geometry, default_material, dind)
        if not np.allclose(einv, 1.0):
            chi1inv.setdefault(c, {})[d_c] = einv

        # pointwise scalars at this site
        idx0 = _material_at(pts, geometry, default_material)
        if nontrivial(lambda m: m.D_conductivity):
            cond["d" + c[1]] = _scalar_of(idx0, geometry, default_material,
                                          lambda m: m.D_conductivity)
        if nontrivial(lambda m: m.chi3):
            chi3[c] = _scalar_of(idx0, geometry, default_material,
                                 lambda m: m.chi3)
            chi2[c] = _scalar_of(idx0, geometry, default_material,
                                 lambda m: 0.0 if m.chi2_full_tensor else m.chi2)
        if nontrivial(lambda m: m.chi2 if m.chi2_full_tensor else 0.0):
            nr_chi2[c] = _scalar_of(idx0, geometry, default_material,
                                    lambda m: m.chi2 if m.chi2_full_tensor else 0.0)

    # ---- mu rows on H sites ------------------------------------------------
    for c in live_h:
        d_c = G.component_direction(c)
        dind = _SLOT[d_c]
        if nontrivial(lambda m: m.mu - 1.0):
            pts = _site_points(gv, c)
            idx = _material_at(pts, geometry, default_material)
            mu = np.full(idx.shape, tuple(default_material.mu_diag_vec())[dind])
            for i, obj in enumerate(geometry):
                v = tuple(obj.material.mu_diag_vec())[dind]
                mu = np.where(idx == i, v, mu)
            chi1inv.setdefault(c, {})[d_c] = 1.0 / mu
        if nontrivial(lambda m: m.B_conductivity):
            pts = _site_points(gv, c)
            idx = _material_at(pts, geometry, default_material)
            cond["b" + c[1]] = _scalar_of(idx, geometry, default_material,
                                          lambda m: m.B_conductivity)

    # ---- susceptibilities ----------------------------------------------------
    # one PolSpec per distinct (frequency, gamma, drude, family): the
    # Lorentzian family only (ROADMAP A9 brings gyrotropic, noisy and
    # multilevel media)
    pols: List[PolSpec] = []
    sus_keys = {}
    for m in all_media:
        for ft, sus_list in (("e", m.E_susceptibilities),
                             ("h", m.H_susceptibilities)):
            for s in sus_list:
                key = (s.frequency, s.gamma, s.drude, ft)
                sus_keys.setdefault(key, []).append((m, s))
    for (f0, gam, drude, ft) in sus_keys:
        sigma: Dict[Tuple[str, str], np.ndarray] = {}
        live = live_e if ft == "e" else live_h
        for c in live:
            d_c = G.component_direction(c)
            dind = _SLOT[d_c]
            pts = _site_points(gv, c)
            idx = _material_at(pts, geometry, default_material)
            arr = np.zeros(gv.shape)
            any_nonzero = False
            for i, obj in enumerate(list(geometry) + [None]):
                med = obj.material if obj is not None else default_material
                sus = (med.E_susceptibilities if ft == "e"
                       else med.H_susceptibilities)
                sv = 0.0
                for s in sus:
                    if (s.frequency, s.gamma, s.drude) == (f0, gam, drude):
                        sv += tuple(s.sigma_vec())[dind]
                if sv != 0.0:
                    any_nonzero = True
                    sel = (idx == i) if obj is not None else (idx == -1)
                    arr = np.where(sel, sv, arr)
            if any_nonzero:
                sigma[(c, d_c)] = arr
        if sigma:
            pols.append(PolSpec(field_type=ft, omega0=f0, gamma=gam,
                                sigma=sigma, drude=drude))

    return MaterialSpec(chi1inv=chi1inv, cond=cond, chi2=chi2, chi3=chi3,
                        nr_chi2=nr_chi2, pols=pols)
