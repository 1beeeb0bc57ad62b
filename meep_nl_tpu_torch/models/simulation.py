"""User-facing Simulation API: the subset of
``meep_nl_tpu/models/simulation.py`` the port carries so far (2D and 3D
Cartesian cells).

    sim = Simulation(cell_size=Vector3(8, 8, 8), resolution=16,
                     geometry=[Sphere(...)], sources=[Source(...)],
                     boundary_layers=[PML(1.0)])
    flux = sim.add_flux(fcen, df, nfreq, FluxRegion(center=..., size=...))
    sim.run(until=200)
    powers = sim.get_fluxes(flux)

The DFT monitors: flux (with the normalization recipe `get_flux_data` /
`load_minus_flux_data` and their .npz forms), `add_dft_fields` /
`get_dft_array`, energy, force, LDOS and near-to-far (`get_farfield(s)`,
`near2far_flux`), and the material accessors `get_epsilon` / `get_mu`.

Runs on CUDA unless constructed with ``device="cpu"``.  `run` routes each
stretch as the reference does: with `use_fused` (the default) the resident
kernels first (K3, or K4 for stretches that record probe series), then the
hybrid driver (K2 and K1) for plain stretches or `fused_probed_run` (K1)
for probed ones, and the eager stepper only for plans the kernels decline;
with `use_fused=False` every stretch goes to the eager stepper.  With
`use_pallas=True` the eager stepper's step is the fused half-step kernel
(K5) where the plan admits it.  `Simulation.routes` counts the stretches
each route took, the kernel objects' own counters say which kernel ran.
`run` takes the step-function DSL of models/run_control.py (at_every,
at_beginning, at_end, during_sources, after_sources, Harminv and
FieldProbe collectors, stop_when_fields_decayed).
Symmetries, k-points, 1D and cylindrical cells wait for later slices
(ROADMAP A5, A8, A9); each raises NotImplementedError naming its item.
"""

from __future__ import annotations

import collections
import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

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


Near2FarRegion = FluxRegion


@dataclasses.dataclass
class ForceRegion(FluxRegion):
    """Stress-tensor monitor region (python/simulation.py:571): the
    `direction` field is the force direction; the surface normal is
    inferred from the zero-size axis as for FluxRegion."""


@dataclasses.dataclass
class EnergyRegion(FluxRegion):
    """Energy-density monitor region (python/simulation.py:598)."""


@dataclasses.dataclass
class FieldsRegion:
    """add_dft_fields region spec (python/simulation.py:613): either a
    Volume in `where` or an explicit center+size pair."""
    where: Any = None
    center: Any = None
    size: Any = None


@dataclasses.dataclass
class _N2FHandle:
    name: str
    freqs: np.ndarray
    surfaces: list
    eps: float = 1.0          # ambient medium at the near surface
    mu: float = 1.0
    sim: Any = None


@dataclasses.dataclass
class _FluxHandle:
    """A flux, force, energy or LDOS monitor: its accumulators are the
    state's "dft" entries whose keys start with `name` + ":"."""
    name: str
    freqs: np.ndarray
    nregions: int = 1
    sim: Any = None


@dataclasses.dataclass
class _DftFieldsHandle:
    name: str
    components: List[str]
    freqs: np.ndarray
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
                 dimensions=None,
                 dtype=np.float32,
                 use_pallas: bool = False,
                 use_fused: bool = True,
                 symmetries: Sequence = (),
                 device=None):
        if symmetries:
            raise NotImplementedError(
                "symmetries (Mirror, Rotate2, Rotate4) and the monitors' "
                "fold branches are not ported yet (ROADMAP A5, symmetries)")
        self.cell_size = cs = _v3(cell_size)
        # infer dimensionality as the reference does (simulation.py:438-442)
        if dimensions == 1 or (cs.x == 0 and cs.y == 0 and cs.z > 0):
            raise NotImplementedError(
                "1D cells are not ported yet (ROADMAP A5)")
        if dimensions in (None, 2) and cs.z == 0 and cs.x > 0 and cs.y > 0:
            dim, size = "2d", [cs.x, cs.y]
        elif dimensions in (-2, "cyl", "CYLINDRICAL"):
            raise NotImplementedError(
                "cylindrical cells are not ported yet (ROADMAP A9)")
        else:
            dim, size = "3d", [cs.x, cs.y, cs.z]
        self.resolution = float(resolution)
        self.geometry = list(geometry)
        self.sources = list(sources)
        self.boundary_layers = list(boundary_layers)
        self.default_material = default_material or Medium()
        self.courant = Courant
        self.eps_averaging = eps_averaging
        self.subpixel_n = subpixel_n
        self.dtype = dtype
        #: step through the fused half-step kernel (K5) where the plan
        #: admits it
        self.use_pallas = use_pallas
        #: try the resident, hybrid and fused probed routes before the
        #: stepper
        self.use_fused = use_fused
        self.device = resolve_device(device)
        self.gv = G.GridVolume.create(dim, size, self.resolution)
        self._dft_specs: List[DftSpec] = []
        self._handles: List[Any] = []
        #: the LDOS monitor's handle: its specs are made in init_sim, from
        #: the discretized sources
        self._ldos = None
        self._plan = None
        self._state = None
        self._t = 0
        #: stretches of run() and step() by route ("resident": K3/K4,
        #: "hybrid": K2/K1, "fused_probed": K1 with probe series,
        #: "half_step": the stepper through K5, "eager": the plain stepper)
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
                if c[0] not in "eh":       # D/B of the energy monitors
                    continue
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
                        pt = [0.0, 0.0, 0.0]
                        for ax, d in enumerate(gv.axes):
                            pt["xyz".index(d)] = \
                                gv.comp_coords(comp, ax)[gidx[ax]]
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
        """Rasterize the scene and compile the plan (simulation.py:1262)."""
        if self._plan is not None:
            return
        live_e, live_h = self._live_components()
        mat = scene.rasterize(self.gv, self.geometry, self.default_material,
                              eps_averaging=self.eps_averaging,
                              subpixel_n=self.subpixel_n,
                              live_e=live_e, live_h=live_h)
        srcs = self._build_sources()
        if self._ldos is not None:
            # per source the DTFT of its component at its sites, weighted
            # by conj(amplitude) (dft_ldos.cpp; simulation.py:1372-1387)
            for si, sv in enumerate(srcs):
                lo = sv.indices.min(axis=0)
                hi = sv.indices.max(axis=0) + 1
                w = np.zeros(hi - lo, np.complex128)
                for pt, amp in zip(sv.indices, sv.amps):
                    w[tuple(pt - lo)] += np.conj(amp)
                self._dft_specs.append(DftSpec(
                    name=f"{self._ldos.name}:{si}", component=sv.component,
                    region=tuple((int(a), int(b)) for a, b in zip(lo, hi)),
                    weights=w, freqs=self._ldos.freqs, centered=False))
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
            self.gv, mat, pmls=pmls, sources=srcs,
            dfts=self._dft_specs, courant=self.courant, dtype=self.dtype,
            live_e=live_e, live_h=live_h,
            # 3D x storage padded to a multiple of 8 like the JAX package
            # (simulation.py:1407), so both compile the same plan
            pad_to_multiple=(8, 1, 1) if self.gv.dim == "3d" else 1,
            device=self.device)
        self._plan.use_pallas = self.use_pallas
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

    def _freqs(self, fcen, df, nfreq) -> np.ndarray:
        if self._plan is not None:
            raise RuntimeError("add monitors before the first run() "
                               "(plan already compiled)")
        return (np.array([fcen]) if nfreq == 1
                else np.linspace(fcen - df / 2, fcen + df / 2, nfreq))

    def _normal(self, size, direction=None) -> str:
        """A region's normal: `direction`, else its first zero-extent
        axis, else the first axis."""
        if direction is not None:
            return direction
        zero_axes = [self.gv.axes[i] for i, sz in enumerate(size) if sz == 0]
        return zero_axes[0] if zero_axes else self.gv.axes[0]

    def _live(self) -> List[str]:
        live_e, live_h = self._live_components()
        return live_e + live_h

    def add_flux(self, fcen, df, nfreq, *regions, decimation_factor=0):
        freqs = self._freqs(fcen, df, nfreq)
        name = f"flux{len(self._handles)}"
        for ri, reg in enumerate(regions):
            center = _vec_to_axes(self.gv, reg.center)
            size = _vec_to_axes(self.gv, reg.size)
            self._dft_specs += M.flux_specs(
                self.gv, f"{name}:{ri}", self._normal(size, reg.direction),
                center, size, freqs, weight=reg.weight, live=self._live(),
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

    # -- flux data: the normalization recipe (simulation.py:2621-2670) ----
    def get_flux_data(self, handle) -> Dict[str, Any]:
        """A snapshot of a monitor's DFT accumulators: copies of the
        state's tensors, on their device, keyed as in the state."""
        self.init_sim()
        return {k: t.clone() for k, t in self._state["dft"].items()
                if k.startswith(handle.name + ":")}

    def _put_flux_data(self, handle, data, minus: bool):
        """Replace (or subtract, `minus`) this monitor's accumulators by a
        snapshot's.  A key is matched by what follows its monitor's name,
        so a snapshot taken from another simulation's monitor of the same
        shape loads whatever that monitor's number was."""
        self.init_sim()
        dft = dict(self._state["dft"])
        for key, arr in data.items():
            key = f"{handle.name}:{key.split(':', 1)[1]}"
            if key not in dft:
                continue
            t = torch.as_tensor(np.asarray(arr) if not torch.is_tensor(arr)
                                else arr)
            t = t.to(device=dft[key].device, dtype=dft[key].dtype)
            if t.shape != dft[key].shape:
                raise ValueError(f"flux data {key}: shape {tuple(t.shape)} "
                                 f"!= the monitor's {tuple(dft[key].shape)}")
            dft[key] = dft[key] - t if minus else t.clone()
        self._state = {**self._state, "dft": dft}

    def load_minus_flux_data(self, handle, data):
        """Subtract a normalization run's DFT fields from this monitor: it
        then measures the scattered fields only."""
        self._put_flux_data(handle, data, minus=True)

    def load_flux_data(self, handle, data):
        """Replace this monitor's DFT fields with a snapshot."""
        self._put_flux_data(handle, data, minus=False)

    @staticmethod
    def _npz(fname: str) -> str:
        return fname if fname.endswith(".npz") else fname + ".npz"

    def save_flux(self, fname, handle):
        """Save a monitor's DFT fields to an .npz (the reference's HDF5
        save_flux role)."""
        np.savez(self._npz(fname), **{
            k: t.detach().cpu().numpy()
            for k, t in self.get_flux_data(handle).items()})

    def load_flux(self, fname, handle):
        with np.load(self._npz(fname)) as z:
            self.load_flux_data(handle, dict(z))

    def load_minus_flux(self, fname, handle):
        with np.load(self._npz(fname)) as z:
            self.load_minus_flux_data(handle, dict(z))

    # the same prefix-keyed snapshots for every DFT monitor kind
    get_force_data = get_near2far_data = get_energy_data = get_flux_data
    load_minus_force_data = load_minus_near2far_data = \
        load_minus_energy_data = load_minus_flux_data
    load_force_data = load_near2far_data = load_flux_data
    save_force = save_near2far = save_energy = save_flux
    load_force = load_near2far = load_energy = load_flux
    load_minus_force = load_minus_near2far = load_minus_energy = \
        load_minus_flux

    # -- dft fields (simulation.py:1526, :2685, :4081) ----------------------
    def add_dft_fields(self, components, fcen, df, nfreq, center=None,
                       size=None, decimation_factor=0):
        """The DTFT of each component over a volume, centred, with
        interpolation weights and no dV."""
        freqs = self._freqs(fcen, df, nfreq)
        name = f"dftf{len(self._handles)}"
        c_ax = _vec_to_axes(self.gv, center)
        s_ax = _vec_to_axes(self.gv, size)
        dec = self._resolve_decimation(decimation_factor, freqs)
        for c in components:
            self._dft_specs += M.field_specs(self.gv, f"{name}:{c}", c, c_ax,
                                             s_ax, freqs, decimation=dec)
        h = _DftFieldsHandle(name, list(components), freqs, self)
        self._handles.append(h)
        return h

    def get_dft_array(self, handle, component, num_freq=None) -> np.ndarray:
        """(region..., nfreq) complex DTFT of a component, or one
        frequency's (region...)."""
        arr = M._dv(self._state["dft"][f"{handle.name}:{component}"])
        return arr if num_freq is None else arr[..., num_freq]

    def get_dft_data(self, handle) -> np.ndarray:
        """All of a monitor's DFT accumulators, flattened complex, in key
        order."""
        self.init_sim()
        out = [M._dv(self._state["dft"][k]).ravel()
               for k in sorted(self._state["dft"])
               if k.startswith(handle.name + ":")]
        return np.concatenate(out) if out else np.zeros(0, np.complex128)

    # -- energy (simulation.py:2585) ----------------------------------------
    def add_energy(self, fcen, df, nfreq, *regions, decimation_factor=0):
        """Frequency-domain electric and magnetic energy in a volume
        (dft_energy): E with D, H with B."""
        freqs = self._freqs(fcen, df, nfreq)
        name = f"en{len(self._handles)}"
        dec = self._resolve_decimation(decimation_factor, freqs)
        for ri, reg in enumerate(regions):
            self._dft_specs += M.energy_specs(
                self.gv, f"{name}:{ri}", _vec_to_axes(self.gv, reg.center),
                _vec_to_axes(self.gv, reg.size), freqs, live=self._live(),
                decimation=dec, weight=reg.weight)
        h = _FluxHandle(name, freqs, len(regions), self)
        self._handles.append(h)
        return h

    def _energy(self, handle, which):
        total = None
        for ri in range(handle.nregions):
            e = M.get_energy(self._plan, self._state, f"{handle.name}:{ri}",
                             which)
            total = e if total is None else total + e
        return total

    def get_electric_energy(self, handle) -> np.ndarray:
        return self._energy(handle, "electric")

    def get_magnetic_energy(self, handle) -> np.ndarray:
        return self._energy(handle, "magnetic")

    def get_total_energy(self, handle) -> np.ndarray:
        return self._energy(handle, "total")

    # -- force (simulation.py:2501) -----------------------------------------
    def add_force(self, fcen, df, nfreq, *regions, decimation_factor=0):
        """Maxwell stress-tensor force monitor (add_dft_force).  Each
        region's `direction` is the force component; the surface normal is
        its zero-extent axis.  Sampled every step, as in the reference."""
        freqs = self._freqs(fcen, df, nfreq)
        name = f"force{len(self._handles)}"
        for ri, reg in enumerate(regions):
            center = _vec_to_axes(self.gv, reg.center)
            size = _vec_to_axes(self.gv, reg.size)
            normal = self._normal(size)
            self._dft_specs += M.force_specs(
                self.gv, f"{name}:{ri}", reg.direction or normal, normal,
                center, size, freqs, weight=reg.weight, live=self._live())
        h = _FluxHandle(name, freqs, len(regions), self)
        self._handles.append(h)
        return h

    def get_forces(self, handle) -> np.ndarray:
        total = None
        for ri in range(handle.nregions):
            f = M.get_force(self._plan, self._state, f"{handle.name}:{ri}")
            if f is not None:
                total = f if total is None else total + f
        return total

    # -- LDOS (simulation.py:2541) ------------------------------------------
    def add_ldos(self, fcen, df, nfreq, decimation_factor=0):
        """LDOS monitor (dft_ldos.cpp): the DTFT of each source's component
        at its sites weighted by conj(amplitude), made in init_sim once the
        sources are discretized; sampled every step."""
        h = _FluxHandle(f"ldos{len(self._handles)}",
                        self._freqs(fcen, df, nfreq), 1, self)
        self._ldos = h
        self._handles.append(h)
        return h

    def get_ldos(self, handle=None) -> np.ndarray:
        """ldos(w) = (4/pi) * -1/2 Re[F(w) conj(J(w))] / |J(w)|^2 / Jsum^2
        (dft_ldos::ldos, dft_ldos.cpp:60-79), J(w) the DTFT of each
        source's current over the steps run: D currents sampled at
        (n + 1/2) dt, B currents at n dt."""
        freqs = self._ldos.freqs
        dt = self._plan.dt
        out = np.zeros(len(freqs))
        steps = np.arange(self._t)
        for si, s in enumerate(self._plan.sources):
            key = f"{self._ldos.name}:{si}"
            F = M._dv(self._state["dft"][key]).reshape(-1, len(freqs)).sum(0)
            tt = (steps + (0.0 if s.component[0] == "h" else 0.5)) * dt
            cur = np.asarray([s.src_time.current(t, dt) for t in tt])
            jsum = float(np.sum(np.abs(np.asarray(s.amps))))
            for fi, f in enumerate(freqs):
                J = np.sum(cur * np.exp(2j * np.pi * f * tt)) * dt \
                    / np.sqrt(2 * np.pi)
                out[fi] += 4.0 / np.pi * -0.5 / (jsum * jsum) \
                    * np.real(F[fi] * np.conj(J)) / abs(J) ** 2
        return out

    # -- near-to-far (simulation.py:1557-1745) ------------------------------
    def add_near2far(self, fcen, df, nfreq, *regions, decimation_factor=0,
                     nperiods=1):
        """Record near-surface DTFTs for far-field transforms
        (add_dft_near2far, near2far.cpp:558): the equivalent-current
        components on their own Yee lattices, sampled every step."""
        if nperiods > 1:
            raise NotImplementedError(
                "near2far lattice images (nperiods > 1) need Bloch-periodic "
                "cells, which wait for the periodic drivers (ROADMAP A8)")
        freqs = self._freqs(fcen, df, nfreq)
        name = f"n2f{len(self._handles)}"
        surfaces = []
        for ri, reg in enumerate(regions):
            center = _vec_to_axes(self.gv, reg.center)
            size = _vec_to_axes(self.gv, reg.size)
            specs, surfs = M.near2far_specs(
                self.gv, f"{name}:{ri}", self._normal(size, reg.direction),
                center, size, freqs, weight=reg.weight, live=self._live())
            self._dft_specs += specs
            surfaces += surfs
        # the ambient medium at the first region's centre (the reference
        # requires a homogeneous surface medium, near2far.cpp:576)
        eps_amb = 1.0
        if regions:
            pt = np.zeros((1, 3))
            pt[0, :self.gv.ndim] = _vec_to_axes(self.gv, regions[0].center)
            idx = scene._material_at(pt, self.geometry,
                                     self.default_material)
            eps_amb = float(scene._eps_of(idx, self.geometry,
                                          self.default_material, 2)[0])
        h = _N2FHandle(name, freqs, surfaces, eps=eps_amb, sim=self)
        self._handles.append(h)
        return h

    def get_farfield_axes(self, handle, x_axes) -> np.ndarray:
        """(6, nfreq) = (Ex, Ey, Ez, Hx, Hy, Hz)(w) at a far point given
        in grid-axis coordinates (dft_near2far::farfield)."""
        from ..analysis.near2far import farfield
        return farfield(handle.surfaces, self._state, handle.freqs, x_axes,
                        self.gv.dim, eps=handle.eps, mu=handle.mu)

    def get_farfield(self, handle, pt) -> np.ndarray:
        """(6, nfreq) far fields at the point `pt`."""
        return self.get_farfield_axes(handle, _vec_to_axes(self.gv, pt))

    def get_farfields(self, handle, resolution, center=None, size=None
                      ) -> np.ndarray:
        """(6, nfreq, grid...) far fields on a `resolution`-spaced grid over
        a volume (get_farfields_array, near2far.cpp:400)."""
        c_ax = _vec_to_axes(self.gv, center)
        s_ax = _vec_to_axes(self.gv, size)
        axes_pts = []
        for c, sz in zip(c_ax, s_ax):
            n = max(1, int(round(sz * resolution)) + 1)
            axes_pts.append(np.linspace(c - sz / 2, c + sz / 2, n))
        mesh = np.meshgrid(*axes_pts, indexing="ij")
        shape = mesh[0].shape
        out = np.zeros((6, len(handle.freqs)) + shape, np.complex128)
        for ind in np.ndindex(*shape):
            out[(slice(None), slice(None)) + ind] = self.get_farfield_axes(
                handle, [m[ind] for m in mesh])
        return out

    def near2far_flux(self, handle, direction, center=None, size=None,
                      resolution=1.0) -> np.ndarray:
        """(nfreq,) Poynting flux through a far surface, from the far
        fields on a `resolution`-spaced grid over it (dft_near2far::flux,
        near2far.cpp:506): the sum of Re(E x H*) . n times the grid cell
        area."""
        d = direction if isinstance(direction, str) else "xyz"[direction]
        EH = self.get_farfields(handle, resolution, center=center, size=size)
        pairs = {"x": ((1, 5), (2, 4)), "y": ((2, 3), (0, 5)),
                 "z": ((0, 4), (1, 3))}[d]
        nfreq = len(handle.freqs)
        flat = EH.reshape(6, nfreq, -1)
        F = np.zeros(nfreq)
        for j, (ei, hi) in enumerate(pairs):
            F += np.real(flat[ei] * np.conj(flat[hi])).sum(axis=-1) \
                * (1 - 2 * j)
        dV = 1.0
        for ext in _vec_to_axes(self.gv, size):
            n = max(1, int(round(ext * resolution)) + 1)
            if n > 1:
                dV *= ext / (n - 1)
        return F * dV

    # ------------------------------------------------------------------ run
    def run(self, *step_funcs, until=None, until_after_sources=None):
        """Run the simulation (simulation.py:2692).

        `until` / `until_after_sources` take a time (after the last source
        turns off, for the latter) or, for `until_after_sources`, a stop
        condition (stop_when_fields_decayed).  `step_funcs` are the DSL of
        models/run_control.py: at_every / at_beginning / at_end /
        during_sources / after_sources(...) / bare callables, and Harminv
        collectors, which ride per-step probe series.  Without callbacks
        the run goes in stretches of MNT_FINITE_BLOCK steps, each followed by
        the NaN/Inf abort of step.cpp:138; with them, in blocks of the
        smallest callback interval (4 time units for a stop condition)."""
        from . import run_control as RC
        self.init_sim()
        sf = RC.parse_step_funcs(step_funcs)
        last_src = max((s.src.last_time() for s in self.sources), default=0.0)

        stop_cond = None
        if until_after_sources is not None and not isinstance(
                until_after_sources, (int, float)):
            stop_cond = until_after_sources
            t_end = None
            t_min = last_src
        elif until_after_sources is not None:
            t_end = last_src + until_after_sources
            t_min = 0.0
        elif until is None:
            raise ValueError("run() needs until= or until_after_sources=")
        elif isinstance(until, (int, float)):
            t_end = self._t * self.dt + until
            t_min = 0.0
        else:
            stop_cond = until
            t_end = None
            t_min = 0.0
        if stop_cond is not None and not (
                hasattr(stop_cond, "check_window")
                and getattr(stop_cond, "c", None) is not None):
            raise NotImplementedError(
                "only stop_when_fields_decayed is ported (ROADMAP A13)")

        for fn in sf.begin:
            fn(self)

        # one probe per collector, and one for the stop condition: its
        # decision sees the max over each dt window, not one instant
        probes = [self._point_probe(f"hm{i}", h.c, h.pt)
                  for i, (h, _) in enumerate(sf.collectors)]
        if stop_cond is not None:
            probes.append(self._point_probe("stopc", stop_cond.c,
                                            stop_cond.pt))
        series = {p.name: [] for p in probes}

        intervals = [iv for iv, _ in sf.every if iv > 0]
        if stop_cond is not None:
            intervals.append(stop_cond.dt)
        need_blocks = bool(intervals or sf.every or stop_cond is not None
                           or sf.after_sources_fns)
        total_steps = (max(0, int(round(t_end / self.dt)) - self._t)
                       if t_end is not None else None)

        if not need_blocks:
            guard = int(os.environ.get("MNT_FINITE_BLOCK", "1024"))
            done = 0
            while done < total_steps:
                n = min(guard, total_steps - done)
                self._run_steps_inner(n, probes, series)
                done += n
                self._check_finite()
            self._finish_collectors(sf, series)
            for fn in sf.end:
                fn(self)
            return

        block_steps = max(1, int(round(
            (min(intervals) if intervals else 4.0) / self.dt)))
        last_fire = {id(fn): self.meep_time() for _, fn in sf.every}
        max_steps = total_steps if total_steps is not None else 10 ** 9
        done = 0
        while done < max_steps:
            n = min(block_steps, max_steps - done)
            self._run_steps_inner(n, probes, series)
            done += n
            self._check_finite()
            now = self.meep_time()
            for iv, fn in sf.every:
                if iv <= 0 or now - last_fire[id(fn)] >= iv - 1e-9:
                    fn(self)
                    last_fire[id(fn)] = now
            if now > last_src and sf.after_sources_fns:
                fns = sf.after_sources_fns
                sf.after_sources_fns = []
                for fn in fns:
                    fn(self)
            if stop_cond is not None and now >= t_min:
                window = np.concatenate(series["stopc"])
                series["stopc"] = []
                if stop_cond.check_window(np.abs(window).max()):
                    break
        self._finish_collectors(sf, series)
        for fn in sf.end:
            fn(self)

    def _point_probe(self, name, component, pt) -> S.ProbeSpec:
        """A probe of `component` interpolated at point `pt`."""
        pts = self.gv.interp_weights(component, _vec_to_axes(self.gv, pt))
        return S.ProbeSpec(name, component,
                           np.array([p for p, w in pts], np.int32),
                           np.array([w for p, w in pts]))

    def _run_steps_inner(self, nsteps, probes=(), series=None):
        """Route a stretch as the reference does (simulation.py:2876-2928).
        With `use_fused`: with probes, the resident probed kernel (K4), then
        fused_probed_run (K1), then the stepper; without, the resident kernel
        (K3), then the hybrid driver (K2/K1), then the stepper.  Without
        `use_fused`, always the stepper.  Probe series are appended to
        `series` as numpy arrays."""
        from ..ops.hybrid import fused_probed_run, hybrid_run
        from ..ops.resident import resident_probed_run, resident_run
        out = None
        if probes:
            if self.use_fused:
                out = resident_probed_run(self._plan, self._state, nsteps,
                                          self._t, probes)
                if out is not None:
                    self.routes["resident"] += 1
                else:
                    out = fused_probed_run(self._plan, self._state, nsteps,
                                           self._t, probes)
                    if out is not None:
                        self.routes["fused_probed"] += 1
            if out is None:
                out = self._stepper_run(nsteps, probes)
            self._state, ys = out
            for k in series:
                series[k].append(ys[k].detach().cpu().numpy())
        else:
            if self.use_fused:
                out = resident_run(self._plan, self._state, nsteps, self._t)
                if out is not None:
                    self.routes["resident"] += 1
                else:
                    out = hybrid_run(self._plan, self._state, nsteps,
                                     self._t)
                    if out is not None:
                        self.routes["hybrid"] += 1
            if out is None:
                out = self._stepper_run(nsteps)
            self._state = out
        self._t += nsteps

    def _stepper_run(self, nsteps, probes=()):
        """A stretch through step.run, counted as "half_step" when its step
        is the fused half-step kernel, else "eager"."""
        from ..ops.fused import takes
        self.routes["half_step" if takes(self._plan) else "eager"] += 1
        return S.run(self._plan, self._state, nsteps, t0=self._t,
                     probes=probes)

    def step(self, nsteps: int = 1):
        """Advance nsteps through the stepper, without monitors' callbacks
        or the kernel routes (simulation.py:2945)."""
        self.init_sim()
        self._state = self._stepper_run(nsteps)
        self._t += nsteps

    def _finish_collectors(self, sf, series):
        """Hand each collector its series (after_sources ones from the step
        the last source turned off) and let it analyze
        (simulation.py:2930-2943)."""
        last_src = max((s.src.last_time() for s in self.sources), default=0.0)
        for i, (h, after) in enumerate(sf.collectors):
            chunks = series.get(f"hm{i}", [])
            if not chunks:
                continue
            data = np.concatenate(chunks)
            if after:
                n_skip = max(0, int(round(last_src / self.dt))
                             - (self._t - len(data)))
                data = data[n_skip:]
            h._collect(data, self.dt)
            h._analyze()

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

    def get_field_point(self, component, pt) -> complex:
        """The component interpolated at point `pt` (simulation.py:3456,
        without derived quantities and symmetry folds)."""
        self.init_sim()
        pts = self.gv.interp_weights(component, _vec_to_axes(self.gv, pt))
        arr = self._state["f"][component]
        return sum(w * complex(arr[tuple(idx)]) for idx, w in pts)

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
        coords = [self.gv.comp_coords(component, ax)
                  for ax in range(self.gv.ndim)]
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
        for ax in range(self.gv.ndim):
            lo = c_ax[ax] - s_ax[ax] / 2
            hi = c_ax[ax] + s_ax[ax] / 2
            i0 = int(np.searchsorted(coords[ax], lo - 1e-9))
            i1 = int(np.searchsorted(coords[ax], hi + 1e-9))
            sl.append(slice(i0, max(i1, i0 + 1)))
        return arr[tuple(sl)]

    def _inverse_u(self, specs, default) -> np.ndarray:
        """1 / u (the plan's inverse epsilon or mu) on the lattice of the
        first live component of `specs`; ones where the plan keeps no u."""
        c = specs[0].ec if specs else default
        u = self._plan.coefs.get(f"{c}:u")
        if u is None:
            return np.ones(self.gv.shape)
        u = u.detach().cpu().numpy().astype(np.float64)
        u = u[tuple(slice(0, n + 1) for n in self.gv.num)]
        return 1.0 / np.maximum(u, 1e-300)

    def get_epsilon(self) -> np.ndarray:
        """Permittivity on the first live E component's lattice
        (simulation.py:3388, without the symmetry unfold)."""
        return self._inverse_u(self.plan.eh_specs_e, "ez")

    def get_mu(self) -> np.ndarray:
        """Permeability on the first live H component's lattice
        (simulation.py:3420)."""
        return self._inverse_u(self.plan.eh_specs_h, "hz")

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


def get_forces(force) -> np.ndarray:
    return force.sim.get_forces(force)


def get_electric_energy(en) -> np.ndarray:
    return en.sim.get_electric_energy(en)


def get_magnetic_energy(en) -> np.ndarray:
    return en.sim.get_magnetic_energy(en)


def get_total_energy(en) -> np.ndarray:
    return en.sim.get_total_energy(en)


def _freqs_of(handle) -> List[float]:
    return list(np.asarray(handle.freqs))


get_flux_freqs = get_force_freqs = get_energy_freqs = get_ldos_freqs = \
    get_near2far_freqs = _freqs_of
