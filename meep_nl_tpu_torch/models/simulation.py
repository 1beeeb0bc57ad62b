"""User-facing Simulation API: the subset of
``meep_nl_tpu/models/simulation.py`` this slice carries (3D Cartesian cells).

    sim = Simulation(cell_size=Vector3(8, 8, 8), resolution=16,
                     geometry=[Sphere(...)], sources=[Source(...)],
                     boundary_layers=[PML(1.0)])
    flux = sim.add_flux(fcen, df, nfreq, FluxRegion(center=..., size=...))
    sim.run(until=200)
    powers = sim.get_fluxes(flux)

Runs on CUDA unless constructed with ``device="cpu"``.  `run` routes each
stretch through the hybrid driver (the K2 and K1 kernels) and falls back to
the eager stepper only for plans the kernels decline; `Simulation.routes`
counts the stretches each route took, the kernel objects' own counters say
which kernel ran.  Step functions, symmetries, k-points, the
resident path and the other monitors wait for later slices (ROADMAP).
"""

from __future__ import annotations

import collections
import dataclasses
import os
from typing import Any, List, Optional, Sequence

import numpy as np

from ..core import grid as G
from ..core.device import resolve_device
from ..stepper import monitors as M
from ..stepper import step as S
from ..stepper.plan import DftSpec, PMLSpec, SrcVolSpec, compile_plan
from . import scene
from .geom import Medium, Vector3, _v3
from .source import Source

Ex, Ey, Ez = "ex", "ey", "ez"
Hx, Hy, Hz = "hx", "hy", "hz"
Dx, Dy, Dz = "dx", "dy", "dz"
Bx, By, Bz = "bx", "by", "bz"
X, Y, Z = "x", "y", "z"
ALL = "all"


@dataclasses.dataclass
class PML:
    """uPML boundary layer (python/simulation.py PML class)."""
    thickness: float
    direction: str = ALL
    side: int = 0               # 0 = both, -1 low, +1 high
    r_asymptotic: float = 1e-15
    mean_stretch: float = 1.0
    pml_profile_power: float = 2.0

    def __post_init__(self):
        if isinstance(self.side, str):
            self.side = {"low": -1, "high": +1, "all": 0, "both": 0}[
                self.side.lower()]


@dataclasses.dataclass
class FluxRegion:
    center: Any = None
    size: Any = None
    direction: Optional[str] = None
    weight: float = 1.0


@dataclasses.dataclass
class _FluxHandle:
    name: str
    freqs: np.ndarray
    nregions: int = 1
    sim: Any = None


def _vec_to_axes(gv: G.GridVolume, v) -> List[float]:
    """Map a Vector3-like to grid-axis coordinates."""
    v = _v3(v if v is not None else Vector3())
    return [tuple(v)[{"x": 0, "y": 1, "z": 2}[d]] for d in gv.axes]


class Simulation:
    """The top-level scene + run controller (simulation.py:1216), 3D
    Cartesian subset."""

    def __init__(self, cell_size, resolution: float,
                 geometry: Sequence = (),
                 sources: Sequence[Source] = (),
                 boundary_layers: Sequence[PML] = (),
                 default_material: Medium = None,
                 Courant: float = 0.5,
                 eps_averaging: bool = True,
                 subpixel_n: int = 3,
                 dtype=np.float32,
                 device=None):
        self.cell_size = _v3(cell_size)
        if min(self.cell_size.x, self.cell_size.y, self.cell_size.z) <= 0:
            raise NotImplementedError(
                "only 3D Cartesian cells are ported; 1D/2D/cylindrical "
                "cells run on the resident path (ROADMAP A7)")
        self.resolution = float(resolution)
        self.geometry = list(geometry)
        self.sources = list(sources)
        self.boundary_layers = list(boundary_layers)
        self.default_material = default_material or Medium()
        self.courant = Courant
        self.eps_averaging = eps_averaging
        self.subpixel_n = subpixel_n
        self.dtype = dtype
        self.device = resolve_device(device)
        cs = self.cell_size
        self.gv = G.GridVolume.create("3d", [cs.x, cs.y, cs.z],
                                      self.resolution)
        self._dft_specs: List[DftSpec] = []
        self._handles: List[Any] = []
        self._plan = None
        self._state = None
        self._t = 0
        #: stretches of run() by route ("hybrid": through K2/K1, "eager")
        self.routes = collections.Counter()

    # ------------------------------------------------------------------ setup
    @property
    def dt(self) -> float:
        return self.courant / self.resolution

    def _live_components(self):
        """Component closure from sources + monitors
        (fields::require_component)."""
        need = {s.component for s in self.sources}
        need |= {m.component for m in self._dft_specs}
        live = set(need)
        changed = True
        while changed:
            changed = False
            for c in list(live):
                dbc = ("d" if c[0] == "e" else "b") + c[1]
                plan = self.gv.step_plan(dbc)
                for g in (plan.plus, plan.minus):
                    if g is not None and g not in live:
                        live.add(g)
                        changed = True
        live_e = [c for c in self.gv.e_components if c in live]
        live_h = [c for c in self.gv.h_components if c in live]
        if not live_e and not live_h:
            live_e = list(self.gv.e_components)
            live_h = list(self.gv.h_components)
        return live_e, live_h

    def _build_sources(self) -> List[SrcVolSpec]:
        """Point sources by multilinear restriction weights; volume sources
        over the component sites inside, with monitor-style weights."""
        out = []
        gv = self.gv
        for s in self.sources:
            comp = s.component
            center = _vec_to_axes(gv, s.center)
            size = _vec_to_axes(gv, s.size) if s.size is not None else \
                [0.0] * gv.ndim
            if all(sz == 0 for sz in size):
                pts = gv.interp_weights(comp, center)
                idx = np.array([p for p, w in pts], np.int32)
                amps = np.array([w * s.amplitude for p, w in pts],
                                np.complex128)
                amps *= self.resolution ** gv.ndim
            else:
                slices, w_arr = _volume_sites(gv, comp, center, size)
                base = [sl.start for sl in slices]
                idx_list, amp_list = [], []
                for ind in np.ndindex(*w_arr.shape):
                    w = w_arr[ind]
                    if w == 0:
                        continue
                    gidx = tuple(b + i for b, i in zip(base, ind))
                    amp = s.amplitude * w
                    if s.amp_func is not None:
                        # meep convention: amp_func receives the point
                        # RELATIVE to the source center (python/source.py)
                        pt = [gv.comp_coords(comp, ax)[gidx[ax]]
                              for ax in range(3)]
                        c3 = _v3(s.center)
                        amp = amp * s.amp_func(Vector3(pt[0] - c3[0],
                                                       pt[1] - c3[1],
                                                       pt[2] - c3[2]))
                    idx_list.append(gidx)
                    amp_list.append(amp)
                idx = np.array(idx_list, np.int32).reshape(-1, gv.ndim)
                amps = np.array(amp_list, np.complex128)
                amps *= self.resolution ** sum(1 for sz in size if sz == 0)
            out.append(SrcVolSpec(comp, idx, amps, s.src,
                                  is_integrated=getattr(s.src,
                                                        "is_integrated",
                                                        False)))
        return out

    def init_sim(self):
        """Rasterize the scene and compile the plan (simulation.py:1262,
        the 3D path)."""
        if self._plan is not None:
            return
        live_e, live_h = self._live_components()
        mat = scene.rasterize(self.gv, self.geometry, self.default_material,
                              eps_averaging=self.eps_averaging,
                              subpixel_n=self.subpixel_n,
                              live_e=live_e, live_h=live_h)
        pmls = []
        for bl in self.boundary_layers:
            dirs = list(self.gv.axes) if bl.direction == ALL \
                else [bl.direction]
            for d in dirs:
                pmls.append(PMLSpec(d, bl.thickness, side=bl.side,
                                    r_asymptotic=bl.r_asymptotic,
                                    mean_stretch=bl.mean_stretch,
                                    pml_profile_power=bl.pml_profile_power))
        self._plan = compile_plan(
            self.gv, mat, pmls=pmls, sources=self._build_sources(),
            dfts=self._dft_specs, courant=self.courant, dtype=self.dtype,
            live_e=live_e, live_h=live_h,
            # x storage padded to a multiple of 8 like the JAX package
            # (simulation.py:1407), so both compile the same plan
            pad_to_multiple=(8, 1, 1), device=self.device)
        self._state = S.init_state(self._plan)

    # -------------------------------------------------------------- monitors
    def _resolve_decimation(self, decimation_factor, freqs):
        """0 = automatic Nyquist-safe subsampling (dft.cpp:195-216),
        disabled (1) for nonlinear media."""
        if decimation_factor != 0:
            return int(decimation_factor)
        for m in [g.material for g in self.geometry] + [self.default_material]:
            if abs(m.chi2) > 0 or abs(m.chi3) > 0:
                return 1
        f_mon = float(np.max(freqs))
        f_src = 0.0
        for s in self.sources:
            f0 = getattr(s.src, "frequency", 0.0) or 0.0
            f_src = max(f_src, f0 + 0.5 * s.src.get_fwidth())
        if f_src == 0.0:
            return 1
        return max(1, int(np.floor(1.0 / (2 * self.dt * (f_mon + f_src)))))

    def add_flux(self, fcen, df, nfreq, *regions, decimation_factor=0):
        if self._plan is not None:
            raise RuntimeError("add monitors before the first run() "
                               "(plan already compiled)")
        freqs = (np.array([fcen]) if nfreq == 1
                 else np.linspace(fcen - df / 2, fcen + df / 2, nfreq))
        name = f"flux{len(self._handles)}"
        for ri, reg in enumerate(regions):
            center = _vec_to_axes(self.gv, reg.center)
            size = _vec_to_axes(self.gv, reg.size)
            normal = reg.direction
            if normal is None:
                zero_axes = [self.gv.axes[i] for i, sz in enumerate(size)
                             if sz == 0]
                normal = zero_axes[0] if zero_axes else self.gv.axes[0]
            live_e, live_h = self._live_components()
            self._dft_specs += M.flux_specs(
                self.gv, f"{name}:{ri}", normal, center, size, freqs,
                weight=reg.weight, live=live_e + live_h,
                decimation=self._resolve_decimation(decimation_factor,
                                                    freqs))
        h = _FluxHandle(name, freqs, len(regions), self)
        self._handles.append(h)
        return h

    def get_fluxes(self, handle: _FluxHandle) -> np.ndarray:
        total = None
        for ri in range(handle.nregions):
            f = M.get_flux(self._plan, self._state, f"{handle.name}:{ri}")
            total = f if total is None else total + f
        return total

    # ------------------------------------------------------------------ run
    def run(self, until=None, until_after_sources=None):
        """Run for `until` more time units, or until `until_after_sources`
        time units past the last source turns off (simulation.py:2692).
        Stretches are bounded by MNT_FINITE_BLOCK steps, each followed by
        the NaN/Inf abort of step.cpp:138."""
        self.init_sim()
        last_src = max((s.src.last_time() for s in self.sources), default=0.0)
        if until_after_sources is not None:
            t_end = last_src + until_after_sources
        elif until is not None:
            t_end = self._t * self.dt + until
        else:
            raise ValueError("run() needs until= or until_after_sources=")
        total_steps = max(0, int(round(t_end / self.dt)) - self._t)
        guard = int(os.environ.get("MNT_FINITE_BLOCK", "1024"))
        done = 0
        while done < total_steps:
            n = min(guard, total_steps - done)
            self._run_steps_inner(n)
            done += n
            self._check_finite()

    def _run_steps_inner(self, nsteps):
        """Route a stretch: the hybrid driver (K2/K1), else the eager
        stepper."""
        from ..ops.hybrid import hybrid_run
        out = hybrid_run(self._plan, self._state, nsteps, self._t)
        if out is not None:
            self.routes["hybrid"] += 1
            self._state = out
        else:
            self.routes["eager"] += 1
            self._state = S.run(self._plan, self._state, nsteps, t0=self._t)
        self._t += nsteps

    def _check_finite(self):
        """Per-stretch NaN/Inf abort (step.cpp:138): one mid-plane of the
        first stepped component, summed on the device, one scalar read."""
        arr = next(iter(self._state["f"].values()))
        v = float(arr[arr.shape[0] // 2].sum())
        if not np.isfinite(v):
            raise RuntimeError(
                "simulation fields are NaN or Inf (step.cpp:138 abort)")

    # ------------------------------------------------------------- accessors
    def meep_time(self) -> float:
        return self._t * self.dt

    def get_array(self, component=None, center=None, size=None,
                  snap: bool = False) -> np.ndarray:
        """Dense array of a field component (array_slice.cpp analog).

        Default (snap=False): interpolated from the Yee sites onto the
        cell's integer lattice; along axes where the component sits at
        half-integer sites, 2-point averages with zero ghosts at both ends.
        snap=True returns the raw component-lattice array."""
        self.init_sim()
        arr = self._state["f"][component].detach().cpu().numpy()
        arr = arr[tuple(slice(0, n + 1) for n in self.gv.num)]
        coords = [self.gv.comp_coords(component, ax) for ax in range(3)]
        if not snap:
            ys = G.yee_shift(component, self.gv.dim)
            for ax, d in enumerate(self.gv.axes):
                if ys.get(d, 0):
                    pad = [(0, 0)] * arr.ndim
                    pad[ax] = (1, 1)
                    padded = np.pad(arr, pad)
                    lo_sl = [slice(None)] * arr.ndim
                    hi_sl = [slice(None)] * arr.ndim
                    lo_sl[ax] = slice(0, -1)
                    hi_sl[ax] = slice(1, None)
                    arr = 0.5 * (padded[tuple(lo_sl)] + padded[tuple(hi_sl)])
                    cs = coords[ax]
                    coords[ax] = np.concatenate(
                        [cs - 0.5 * self.gv.dx, [cs[-1] + 0.5 * self.gv.dx]])
        if center is None and size is None:
            return arr
        c_ax = _vec_to_axes(self.gv, center)
        s_ax = _vec_to_axes(self.gv, size)
        sl = []
        for ax in range(3):
            lo = c_ax[ax] - s_ax[ax] / 2
            hi = c_ax[ax] + s_ax[ax] / 2
            i0 = int(np.searchsorted(coords[ax], lo - 1e-9))
            i1 = int(np.searchsorted(coords[ax], hi + 1e-9))
            sl.append(slice(i0, max(i1, i0 + 1)))
        return arr[tuple(sl)]

    @property
    def plan(self):
        self.init_sim()
        return self._plan

    @property
    def fields_state(self):
        return self._state


def _volume_sites(gv: G.GridVolume, comp: str, center, size):
    """Component-site slices + integration weights over a volume (the source
    counterpart of the monitor weight scheme, sources.cpp:243)."""
    slices, ws = [], []
    for ax in range(gv.ndim):
        coords = gv.comp_coords(comp, ax)
        lo = center[ax] - size[ax] / 2
        hi = center[ax] + size[ax] / 2
        start, stop, w = M._axis_weights_lattice(
            (lo - coords[0]) / gv.dx, (hi - coords[0]) / gv.dx, len(coords))
        slices.append(slice(start, stop))
        ws.append(w)
    w_full = ws[0]
    for w in ws[1:]:
        w_full = np.multiply.outer(w_full, w)
    return slices, w_full


def get_fluxes(flux) -> np.ndarray:
    return flux.sim.get_fluxes(flux)
