"""User-facing Simulation API: the subset of
``meep_nl_tpu/models/simulation.py`` the port carries so far (1D, 2D, 3D
and cylindrical cells).

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
`symmetries=[Mirror(...)]` halves the cell along each mirrored axis as
the reference does (simulation.py:455-611): the retained half is the high
one, the plane its low face, which becomes a metal wall (phase -1, even
cell count), a magnetic wall (phase +1, odd count; the cell grows by dx/2)
or, for phase +1 on an even count, no wall but the node-mirror ghost of
the stepper and the kernels (plan.mirror_node).  `Rotate2(w)` halves the
cell along the first axis perpendicular to w, `Rotate4(w)` quarters a
square cell in the plane perpendicular to w (even counts; the rotation
axis on whole sites, no wall): the stepper and K3/K4 read the C2 / C4
ghost across the fold planes (plan.rot2 / plan.rot4).  Sources,
monitors, probes and the getters fold and unfold through the planes.
1D cells (a cell size along z only) carry both transverse polarizations
and run on the eager stepper, as on the reference's jnp path.
`k_point=Vector3(...)` makes the cell Bloch-periodic (simulation.py:646):
every axis wraps with the phase exp(2 pi i k L) unless k is zero along it
and both its ends carry an absorbing layer.  Real phases (k = 0 or the
zone edge) run on the kernels as in the reference (K3/K4 with their wrap
ghosts; x-periodic 3D cells on the hybrid driver's periodic drivers,
ops/periodicx.py).  Any other k has complex phases and so complex fields,
as does `force_complex_fields=True` (simulation.py:1392, :1439-1448):
native complex64 on the CPU, the real pair (plan.real_pair: a leading
(re, im) channel axis, real arithmetic) on the card, where the kernels
take the pair as the reference's do; MNT_REAL_PAIR=1 asks for the pair
on the CPU too and MNT_COMPLEX_NATIVE=1 for native complex everywhere.
Getters return complex values then.  `bfast_scaled_k=Vector3(...)`
(simulation.py:370) runs the fork's BFAST: broadband oblique incidence at
a fixed angle in one run (the stepper's flip-flop auxiliary f_bfast,
step._bfast_update); its plan has complex fields, so on the card it runs
as a real pair, on K3/K4's direct schedule where the resident route takes
it (K1, K2 and K5 decline BFAST, as the reference's do).
`dimensions=CYLINDRICAL` (or "cyl", -2) makes an (r, z) cell of size
(cell_size.x, cell_size.z) with the axis at r = 0 and the fields' e^{i m
phi} dependence set by `m` (simulation.py:444-446): m = 0 steps real
fields, m != 0 complex ones (the real pair on the card); PML in r goes on
the high side only.  A 2D cell with a k_point whose z component is nonzero
(special_kz, simulation.py:377-425, :1366-1371) steps the exact e^{i beta
z} dependence, beta = 2 pi k.z, with every component live and complex
fields.  Both run on K3/K4 (their CYL variants) where the resident
route takes the plan, else on the eager stepper; K1, K2 and K5 decline
them.
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
Er, Ep, Hr, Hp = "er", "ep", "hr", "hp"
Dr, Dp, Br, Bp = "dr", "dp", "br", "bp"
CYLINDRICAL = "cyl"
X, Y, Z = "x", "y", "z"
ALL = "all"
Low, High = "low", "high"
Metallic, Magnetic = "metal", "magnetic"


class Symmetry:
    """Base symmetry declaration (python/simulation.py Symmetry)."""


@dataclasses.dataclass
class Identity(Symmetry):
    """The trivial symmetry (accepted and ignored, as in the reference)."""
    direction: str = "x"
    phase: int = 1


@dataclasses.dataclass
class Mirror(Symmetry):
    """Mirror-symmetry declaration (python/simulation.py Mirror;
    src/symmetry.cpp mirror_symmetry).  The cell is halved along
    `direction` about the plane through its centre: phase -1 needs an even
    cell count there (the plane on whole sites becomes a PEC wall); phase
    +1 on an odd count puts the plane on half-offset sites (a PMC wall), on
    an even count on whole sites (no wall: the stepper reads the mirror
    ghost across it).  Sources in the dropped half fold onto the retained
    half with the component's parity times `phase`; get_array unfolds."""
    direction: str = "y"
    phase: int = 1


@dataclasses.dataclass
class Rotate2(Symmetry):
    """C2 rotational-symmetry declaration (python/simulation.py Rotate2;
    vec.hpp:1189-1232 rotate2): a half turn about `direction`.  The cell
    is halved along the first perpendicular axis (even count there), the
    rotation axis on whole sites at its low face; a source in the dropped
    half maps to its C2 image with phase * the component's two mirror
    parities."""
    direction: str = "z"
    phase: int = 1


@dataclasses.dataclass
class Rotate4(Symmetry):
    """C4 rotational-symmetry declaration (python/simulation.py Rotate4;
    vec.hpp:1189-1232 rotate4): a quarter turn about `direction`, phase
    +1 or -1.  A square cell is quartered (even counts on both
    perpendicular axes), the rotation axis at the retained quadrant's
    low corner; sources outside it turn into it by quarter turns."""
    direction: str = "z"
    phase: int = 1


def _mirror_parity(comp: str, d: str) -> float:
    """Intrinsic sign of component `comp` under a mirror in direction `d`
    (vec.hpp:1189 symmetry::transform: E is a vector, H a pseudovector)."""
    if comp[0] in ("e", "d"):
        return -1.0 if comp[1] == d else 1.0
    return 1.0 if comp[1] == d else -1.0


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
    m: float = 0.0            # cylindrical azimuthal number
    sim: Any = None
    mirrors: tuple = ()       # (axis, letter, phase): images the far-field
                              # sum adds
    periodic: tuple = ()      # (axis, nper, phase per period, period):
                              # the Bloch lattice images


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


#: the Vector3 slot of each grid direction: a cylindrical cell's r is x
_SLOT = {"x": 0, "y": 1, "z": 2, "r": 0, "p": 1}


def _vec_to_axes(gv: G.GridVolume, v) -> List[float]:
    """Map a Vector3-like to grid-axis coordinates (cylindrical: (r, z) =
    (v.x, v.z), simulation.py:299-308)."""
    v = _v3(v if v is not None else Vector3())
    return [tuple(v)[_SLOT[d]] for d in gv.axes]


class Simulation:
    """The top-level scene + run controller (simulation.py:1216), the
    port's subset."""

    def __init__(self, cell_size, resolution: float,
                 geometry: Sequence = (),
                 sources: Sequence[Source] = (),
                 boundary_layers: Sequence[PML] = (),
                 default_material: Medium = None,
                 Courant: float = 0.5,
                 eps_averaging: bool = True,
                 subpixel_n: int = 3,
                 subpixel_tensor: bool = False,
                 dimensions=None,
                 dtype=np.float32,
                 use_pallas: bool = False,
                 use_fused: bool = True,
                 symmetries: Sequence = (),
                 k_point=None,
                 force_complex_fields: bool = False,
                 bfast_scaled_k=None,
                 m: float = 0.0,
                 kz_2d: str = "complex",
                 device=None):
        self.cell_size = cs = _v3(cell_size)
        # infer dimensionality as the reference does (simulation.py:438-442)
        if dimensions == 1 or (cs.x == 0 and cs.y == 0 and cs.z > 0):
            dim, size = "1d", [cs.z]
        elif dimensions in (None, 2) and cs.z == 0 and cs.x > 0 and cs.y > 0:
            dim, size = "2d", [cs.x, cs.y]
        elif dimensions in (-2, "cyl", "CYLINDRICAL"):
            dim, size = "cyl", [cs.x, cs.z]
        else:
            dim, size = "3d", [cs.x, cs.y, cs.z]
        self.resolution = float(resolution)
        #: the inferred dimensionality: "1d", "2d", "3d" or "cyl"
        self.dim = dim
        #: the cylindrical azimuthal number (fields ~ e^{i m phi})
        self.m = m
        # special_kz's modes as the reference accepts them
        # (simulation.py:418-425); every one integrates the complex (or
        # real-pair) fields, the reference's "complex" mode
        if kz_2d not in ("complex", "real/imag", "3d"):
            raise ValueError(f"kz_2d: unknown mode {kz_2d!r}")
        self.kz_2d = kz_2d
        self.geometry = list(geometry)
        self.sources = list(sources)
        self.boundary_layers = list(boundary_layers)
        self.default_material = default_material or Medium()
        #: the Bloch wave vector (units of 2 pi / a), or None: no wrap
        self.k_point = k_point
        #: step complex fields even where the phases are real
        self.force_complex_fields = force_complex_fields
        #: BFAST's scaled transverse k (sin of the angle, per axis), or
        #: None: off
        self.bfast_scaled_k = bfast_scaled_k
        self.courant = Courant
        self.eps_averaging = eps_averaging
        self.subpixel_n = subpixel_n
        #: the off-diagonal Kottke rows at interfaces (scene.rasterize)
        self.subpixel_tensor = subpixel_tensor
        self.dtype = dtype
        #: step through the fused half-step kernel (K5) where the plan
        #: admits it
        self.use_pallas = use_pallas
        #: try the resident, hybrid and fused probed routes before the
        #: stepper
        self.use_fused = use_fused
        self.device = resolve_device(device)
        #: (direction letter, 'low'|'high') -> 'metal' | 'magnetic' |
        #: 'none': the mirror walls and set_boundary's conditions
        self._boundaries: Dict[Any, str] = {}
        #: (axis index, direction letter, phase) of each Mirror
        self._mirrors: List[Any] = []
        #: axes whose mirror plane lies on whole sites (the ghost, no wall)
        self._mirror_node = set()
        #: the C2 fold (fold axis, flip axis, rotation axis letter, phase)
        #: and the C4 fold (ax1, ax2, rotation axis letter, phase), as
        #: plan.rot2 / plan.rot4
        self._rot2 = None
        self._rot4 = None
        self.symmetries = list(symmetries)
        origin = self._fold_cell(dim, size)
        self.gv = G.GridVolume.create(dim, size, self.resolution,
                                      origin=origin)
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

    def _fold_cell(self, dim, size):
        """Halve `size` (in place) along each Mirror's axis and record its
        wall or ghost, or halve / quarter it for a rotation
        (simulation.py:455-611); returns the grid origin, or None for the
        centred cell."""
        if not self.symmetries:
            return None
        axes = G._DIM_AXES[dim]
        dx = 1.0 / self.resolution
        origin = [0.0 if (dim == "cyl" and d == "r") else -sz / 2
                  for d, sz in zip(axes, size)]
        for sym in self.symmetries:
            if isinstance(sym, (Rotate2, Rotate4)) and \
                    self.k_point is not None:
                raise ValueError(
                    "rotational symmetries with k_point are not supported "
                    "(the rotation maps k onto its image; only k=0 is "
                    "invariant)")
            if isinstance(sym, (Rotate2, Rotate4)):
                self._fold_rotation(sym, dim, size, origin)
                continue
            if isinstance(sym, Identity):
                continue
            if not isinstance(sym, Mirror):
                raise NotImplementedError(
                    "only Mirror/Rotate2/Rotate4 symmetries are supported")
            if self._rot2 is not None or self._rot4 is not None:
                raise NotImplementedError(
                    "rotational symmetries combined with Mirror are not "
                    "supported")
            d = sym.direction
            if d not in axes:
                raise ValueError(f"no grid axis {d} in {dim}")
            if self.k_point is not None and (
                    tuple(_v3(self.k_point))["xyz".index(d)] != 0.0
                    or not self._absorbing_both_sides(d)):
                # the fold wall replaces the Bloch wrap: only an axis
                # without k whose ends absorb (so it is not wrapped,
                # `_periodic`) folds (simulation.py:566-585)
                raise ValueError(
                    f"Mirror({d}) with k_point requires k.{d} == 0 and "
                    f"absorbing layers on both {d} sides")
            ax = axes.index(d)
            n_full = int(round(size[ax] * self.resolution))
            if sym.phase == -1:
                if n_full % 2:
                    raise ValueError(
                        f"Mirror({d}, phase=-1) needs an even cell count "
                        f"along {d} (have {n_full}) so the symmetry plane "
                        "lands on a whole grid site")
                size[ax] = size[ax] / 2
                origin[ax] = 0.0
                self._boundaries[(d, "low")] = "metal"
            elif n_full % 2 == 0:
                # the plane on whole sites: no wall, the stepper reads the
                # mirror ghost across it (plan.mirror_node)
                size[ax] = size[ax] / 2
                origin[ax] = 0.0
                self._boundaries[(d, "low")] = "none"
                self._mirror_node.add(ax)
            else:
                size[ax] = size[ax] / 2 + dx / 2
                origin[ax] = -dx / 2
                self._boundaries[(d, "low")] = "magnetic"
            self._mirrors.append((ax, d, int(sym.phase)))
        return origin

    def _fold_rotation(self, sym, dim, size, origin):
        """The rotational branches of the constructor's fold
        (simulation.py:494-561): Rotate4 quarters a square cell, Rotate2
        halves the fold axis; even counts put the rotation axis on whole
        sites, whose low faces become "none" (the ghost, no wall)."""
        name = type(sym).__name__
        if dim not in ("2d", "3d"):
            raise NotImplementedError(f"{name} needs a 2d/3d cartesian cell")
        axes = G._DIM_AXES[dim]
        w = sym.direction
        perp = [d for d in ("x", "y", "z") if d != w]
        if any(d not in axes for d in perp):
            raise ValueError(f"{name}({w}) needs both {perp[0]} and "
                             f"{perp[1]} as grid axes")
        if self._mirrors or self._rot2 is not None \
                or self._rot4 is not None:
            raise NotImplementedError(
                f"{name} combined with other symmetries is not supported")
        if isinstance(sym, Rotate4):
            if sym.phase not in (1, -1):
                raise NotImplementedError(
                    "Rotate4 phase must be +1/-1 (the +/-i irreps need "
                    "complex fields)")
            folded = [axes.index(perp[0]), axes.index(perp[1])]
            if abs(size[folded[0]] - size[folded[1]]) > 1e-12:
                raise ValueError(f"Rotate4({w}) needs a square cell in the "
                                 f"{perp[0]}{perp[1]} plane")
        else:
            folded = [axes.index(perp[0])]
        for ax in folded:
            n_full = int(round(size[ax] * self.resolution))
            if n_full % 2:
                raise ValueError(
                    f"{name}({w}) needs an even cell count along {axes[ax]} "
                    f"(have {n_full}) so the rotation axis lands on a whole "
                    "grid site")
            size[ax] = size[ax] / 2
            origin[ax] = 0.0
            self._boundaries[(axes[ax], "low")] = "none"
        if isinstance(sym, Rotate4):
            self._rot4 = (folded[0], folded[1], w, int(sym.phase))
        else:
            self._rot2 = (folded[0], axes.index(perp[1]), w, int(sym.phase))

    def _special_kz(self) -> bool:
        """A 2D cell with a k_point whose z component is nonzero."""
        return self.gv.dim == "2d" and self.k_point is not None \
            and _v3(self.k_point).z != 0.0

    def _absorbing_both_sides(self, d) -> bool:
        """Whether absorbing layers cover both ends of direction `d`."""
        lo = hi = False
        for bl in self.boundary_layers:
            if bl.direction == ALL or bl.direction == d:
                lo = lo or bl.side in (0, -1)
                hi = hi or bl.side in (0, +1)
        return lo and hi

    def _periodic(self):
        """The Bloch-periodic axes (simulation.py:646-675): with a k_point
        every axis wraps, except one whose k component is zero and whose
        ends both carry an absorbing layer (the wrap there is inert below
        the PML floor, and the zero fill keeps the plan inside the kernels'
        envelopes)."""
        if self.k_point is None:
            return (False,) * self.gv.ndim
        kv = _vec_to_axes(self.gv, self.k_point)
        return tuple(not (kv[ax] == 0.0 and self._absorbing_both_sides(d))
                     for ax, d in enumerate(self.gv.axes))

    def _folded_axes(self):
        """The axes each of whose low face is a symmetry plane."""
        out = {ax for ax, _, _ in self._mirrors}
        if self._rot2 is not None:
            out.add(self._rot2[0])
        if self._rot4 is not None:
            out.update(self._rot4[:2])
        return out

    def set_boundary(self, side, direction, condition):
        """Set the wall condition on one cell face (meep.hpp:1776
        set_boundary; simulation.py:623-641): `side` Low / High (or -1 /
        +1), `direction` X / Y / Z (or 0-2), `condition` Metallic or
        Magnetic (or 0 / 1).  Before the plan is compiled."""
        if self._plan is not None:
            raise RuntimeError("set_boundary must precede init_sim()")
        sd = side if isinstance(side, str) else ("low" if side < 0 else "high")
        d = direction if isinstance(direction, str) else "xyz"[direction]
        cond = condition if isinstance(condition, str) else \
            ("metal" if condition == 0 else "magnetic")
        cond = {"metallic": "metal"}.get(cond.lower(), cond.lower())
        if cond not in ("metal", "magnetic", "none"):
            raise ValueError(f"unknown boundary condition {condition}")
        self._boundaries[(d, sd.lower())] = cond

    # ------------------------------------------------------------------ setup
    @property
    def dt(self) -> float:
        return self.courant / self.resolution

    def _live_components(self):
        """Component closure from sources + monitors
        (fields::require_component)."""
        if self._special_kz():
            # the i beta coupling mixes TE and TM: every component is live
            # (simulation.py:680-687)
            return list(self.gv.e_components), list(self.gv.h_components)
        need = {s.component for s in self.sources}
        need |= {m.component for m in self._dft_specs}
        # gyrotropic media precess P about the bias axis, coupling every
        # component of the susceptibility's field type
        # (susceptibility.cpp:519; simulation.py:696-710)
        for med in [getattr(g, "material", None) for g in self.geometry] \
                + [self.default_material]:
            if med is None:
                continue
            for ft, sus_list in (("e", med.E_susceptibilities),
                                 ("h", med.H_susceptibilities)):
                if any(np.linalg.norm(list(_v3(s_.bias))) > 0
                       for s_ in sus_list if hasattr(s_, "bias")):
                    comps = self.gv.e_components if ft == "e" \
                        else self.gv.h_components
                    if need & set(comps) or not need:
                        need |= set(comps)
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
        mirror_axes = {ax for ax, _, _ in self._mirrors}
        for s in self.sources:
            s = self._fold_source(s)
            comp = s.component
            center = _vec_to_axes(gv, s.center)
            size = _vec_to_axes(gv, s.size) if s.size is not None else \
                [0.0] * gv.ndim
            if all(sz == 0 for sz in size):
                pts = gv.interp_weights(comp, center)
                if mirror_axes:
                    # a weight on the below-plane row (the half-offset
                    # alignment keeps one at -dx/2) belongs to the image
                    # the symmetry already supplies: drop it
                    pts = [(p, w) for p, w in pts if all(
                        gv.comp_coords(comp, ax)[p[ax]] > -1e-9
                        for ax in mirror_axes)]
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
                    if mirror_axes:
                        drop = False
                        for ax in mirror_axes:
                            cv = gv.comp_coords(comp, ax)[gidx[ax]]
                            if cv < -1e-9:
                                drop = True            # the below-plane row
                            elif cv <= 1e-9 and \
                                    center[ax] - size[ax] / 2 < -1e-9:
                                # the plane row of a source that reaches
                                # below the plane: the clip gave it the edge
                                # weight, the full cell's row is interior
                                w = w * 2.0
                        if drop:
                            continue
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

    def _fold_source(self, s):
        """A source in the dropped half of a mirrored cell, reflected onto
        the retained half with phase * the component's mirror parity; one
        that straddles a plane asymmetrically raises; on a rotational fold,
        its image in the retained wedge (simulation.py:736-823)."""
        if self._rot4 is not None:
            return self._fold_source_rot4(s)
        if self._rot2 is not None:
            return self._fold_source_rot2(s)
        for ax, d, phase in self._mirrors:
            i = "xyz".index(d)
            c = list(_v3(s.center))
            sz = list(_v3(s.size)) if s.size is not None else [0.0] * 3
            if abs(c[i]) > 1e-12 and sz[i] > 2 * abs(c[i]) + 1e-12:
                raise ValueError(
                    f"source straddles the {d} mirror plane asymmetrically; "
                    "place it in the retained half (or symmetrically about "
                    "the plane)")
            if c[i] < -1e-12:
                c[i] = -c[i]
                s = dataclasses.replace(
                    s, center=Vector3(*c),
                    amplitude=s.amplitude * phase
                    * _mirror_parity(s.component, d))
        return s

    def _fold_source_rot4(self, s):
        """A source outside the retained quadrant turned into it by quarter
        turns R^-1: (x, y) -> (y, -x), its amplitude times phase per turn
        (F_w(R r) = phase F_w(r)); a source straddling a fold plane, or an
        in-plane component outside the quadrant (its fold swaps the
        component), raises (simulation.py:742-782)."""
        a1, a2, w, phase = self._rot4
        i, j = "xyz".index(self.gv.axes[a1]), "xyz".index(self.gv.axes[a2])
        c = list(_v3(s.center))
        sz = list(_v3(s.size)) if s.size is not None else [0.0] * 3
        lo_i, hi_i = c[i] - 0.5 * sz[i], c[i] + 0.5 * sz[i]
        lo_j, hi_j = c[j] - 0.5 * sz[j], c[j] + 0.5 * sz[j]
        if lo_i >= -1e-12 and lo_j >= -1e-12:
            return s
        if (lo_i < -1e-12 and hi_i > 1e-12) or \
                (lo_j < -1e-12 and hi_j > 1e-12):
            raise ValueError("source straddles a Rotate4 fold plane; place "
                             "it in one quadrant")
        if s.component[1] != w:
            raise ValueError(
                f"in-plane-component source ({s.component}) outside the "
                "retained Rotate4 quadrant: its fold swaps the component; "
                "place it in the retained quadrant")
        amp = s.amplitude
        for _ in range(3):
            if c[i] >= -1e-12 and c[j] >= -1e-12:
                break
            c[i], c[j] = c[j], -c[i]
            sz[i], sz[j] = sz[j], sz[i]
            amp = amp * phase
        return dataclasses.replace(s, center=Vector3(*c), size=Vector3(*sz),
                                   amplitude=amp)

    def _fold_source_rot2(self, s):
        """A source in the dropped half mapped to its C2 image (both
        perpendicular coordinates negated) with phase times the
        component's parities under the two perpendicular mirrors; one
        straddling the fold plane is kept only when centred on the
        rotation axis (its dropped part's image is the retained part), else
        raises (simulation.py:783-807)."""
        fax, lax, _, phase = self._rot2
        axes = self.gv.axes
        i, j = "xyz".index(axes[fax]), "xyz".index(axes[lax])
        c = list(_v3(s.center))
        sz = list(_v3(s.size)) if s.size is not None else [0.0] * 3
        if c[i] - 0.5 * sz[i] < -1e-12 and c[i] + 0.5 * sz[i] > 1e-12:
            if abs(c[i]) > 1e-12 or abs(c[j]) > 1e-12:
                raise ValueError(
                    "source straddles the Rotate2 fold plane; center it on "
                    "the rotation axis or place it in one half")
            return s
        if c[i] < -1e-12:
            c[i], c[j] = -c[i], -c[j]
            s = dataclasses.replace(
                s, center=Vector3(*c), amplitude=s.amplitude * phase
                * _mirror_parity(s.component, axes[fax])
                * _mirror_parity(s.component, axes[lax]))
        return s

    def init_sim(self):
        """Rasterize the scene and compile the plan (simulation.py:1262)."""
        if self._plan is not None:
            return
        live_e, live_h = self._live_components()
        mat = scene.rasterize(self.gv, self.geometry, self.default_material,
                              eps_averaging=self.eps_averaging,
                              subpixel_n=self.subpixel_n,
                              subpixel_tensor=self.subpixel_tensor,
                              live_e=live_e, live_h=live_h)
        srcs = self._build_sources()
        if self._ldos is not None:
            # per source the DTFT of its component at its sites, weighted
            # by conj(amplitude) (dft_ldos.cpp; simulation.py:1372-1387);
            # a recompiled plan (change_k_point) makes them anew
            self._dft_specs = [m for m in self._dft_specs if not
                               m.name.startswith(self._ldos.name + ":")]
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
        # a folded axis keeps its symmetry plane at the low side
        mirror_dirs = {self.gv.axes[ax] for ax in self._folded_axes()}
        for bl in self.boundary_layers:
            dirs = list(self.gv.axes) if bl.direction == ALL \
                else [bl.direction]
            for d in dirs:
                # a mirrored axis keeps its plane at the low side: PML on
                # the high side only (simulation.py:1315-1340)
                side = bl.side
                if d in mirror_dirs or (self.gv.dim == "cyl" and d == "r"):
                    # r = 0 is the coordinate axis, not a boundary: PML in
                    # r goes on the high side only (simulation.py:1333-1340)
                    if side == -1:
                        continue
                    side = +1
                pmls.append(PMLSpec(d, bl.thickness, side=side,
                                    r_asymptotic=bl.r_asymptotic,
                                    mean_stretch=bl.mean_stretch,
                                    pml_profile_power=bl.pml_profile_power))
        bloch_k, beta = None, 0.0
        if self.k_point is not None:
            kv = _v3(self.k_point)
            bloch_k = _vec_to_axes(self.gv, kv)
            if self._special_kz():
                # special_kz: the out-of-plane wavenumber (simulation.py:
                # 1368-1371), k in units of 2 pi / a
                beta = 2.0 * np.pi * float(kv.z)
        self._plan = compile_plan(
            self.gv, mat, pmls=pmls, sources=srcs,
            periodic=self._periodic(), bloch_k=bloch_k, beta=beta,
            dfts=self._dft_specs, courant=self.courant, dtype=self.dtype,
            live_e=live_e, live_h=live_h, m=float(self.m or 0.0),
            boundaries=self._boundaries or None,
            complex_fields=True if self.force_complex_fields else None,
            bfast_scaled_k=(tuple(_v3(self.bfast_scaled_k))
                            if self.bfast_scaled_k is not None else None),
            mirror_node=tuple(m for m in self._mirrors
                              if m[0] in self._mirror_node),
            rot2=self._rot2, rot4=self._rot4,
            # 3D x storage padded to a multiple of 8 like the JAX package
            # (simulation.py:1407), so both compile the same plan; a C4
            # fold keeps its rotation plane's storage square (its ghost is
            # a transposed read)
            pad_to_multiple=(8, 1, 1) if self.gv.dim == "3d"
            and self._rot4 is None else 1,
            device=self.device)
        self._check_rotation_plan()
        if self._plan.complex_fields:
            # the real pair: compulsory on the card (its kernels run real
            # arithmetic), asked for on the CPU by MNT_REAL_PAIR=1; native
            # complex everywhere with MNT_COMPLEX_NATIVE=1
            # (simulation.py:1439-1448)
            if os.environ.get("MNT_COMPLEX_NATIVE") != "1" and (
                    torch.device(self.device).type != "cpu"
                    or os.environ.get("MNT_REAL_PAIR") == "1"):
                self._plan.real_pair = True
        try:
            # pair fields with chi2/chi3 or multilevel media (init_state)
            S.check_supported(self._plan)
            self._plan.use_pallas = self.use_pallas
            self._state = S.init_state(self._plan)
        except NotImplementedError:
            self._plan = None
            raise

    def _check_rotation_plan(self):
        """What the reference rejects on a rotational fold once the plan is
        compiled (simulation.py:1409-1440): chi2/chi3 media (their
        neighbour sums do not fold), and for Rotate4 also anisotropic
        epsilon/mu (their neighbour averages cross the fold); BFAST,
        cylindrical and complex-field runs."""
        if self._rot2 is None and self._rot4 is None:
            return
        p = self._plan
        name = "Rotate4" if self._rot4 is not None else "Rotate2"
        specs = p.eh_specs_e + p.eh_specs_h
        why = None
        if any(sp.has_chi3 or sp.has_nr for sp in specs):
            why = "chi2/chi3 nonlinear media (the NL neighbor sums do not " \
                "fold)"
        elif self._rot4 is not None and any(sp.has_u1 or sp.has_u2
                                            for sp in specs):
            why = "anisotropic epsilon (the OFFDIAG neighbor averages " \
                "cross the fold)"
        elif p.bfast_k is not None or p.m:
            why = "BFAST/cylindrical runs"
        elif self._rot4 is not None and p.complex_fields:
            why = "complex fields (phase +/-1 irreps need real fields)"
        if why is not None:
            self._plan = None
            raise NotImplementedError(f"{name} with {why} is not supported")

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

    def _fold_region(self, center, size, parity_fn):
        """Fold a DFT monitor's region onto the retained half of a mirrored
        cell (simulation.py:853-950, mirror branch): (center, size, factor,
        axes).  `parity_fn(d)` is the parity of the monitored product
        under the mirror in d.  A region symmetric about the plane is
        clipped to the retained half, factor 1 + parity; one wholly in the
        dropped half maps to its image, factor parity; an asymmetric
        straddle raises.  `axes`: the half-offset-aligned axes folded
        symmetrically, whose plane row `_mirror_fix_dft_specs` reweights.
        On a rotational fold see `_fold_region_rot`."""
        center, size = list(center), list(size)
        if self._rot2 is not None or self._rot4 is not None:
            return self._fold_region_rot(center, size, parity_fn)
        factor = 1.0
        sym_axes = set()
        for ax, d, phase in self._mirrors:
            lo = center[ax] - 0.5 * size[ax]
            hi = center[ax] + 0.5 * size[ax]
            if lo >= -1e-9:
                continue                          # in the retained half
            par = parity_fn(d)
            if hi <= 1e-9:                        # wholly in the dropped half
                center[ax] = -center[ax]
                factor *= par
            elif abs(center[ax]) < 1e-9:          # symmetric about the plane
                lo2 = 0.0
                if phase == -1 or ax in self._mirror_node:
                    # the plane on whole sites lies midway between centred
                    # columns: reach just inside -dx/2 so the first retained
                    # column keeps its interior weight
                    lo2 = -0.5 * self.gv.dx * (1.0 - 1e-6)
                else:
                    # half-offset alignment: the plane is centred row 0;
                    # lo2 = 0 gives it the edge weight, restored with the
                    # component parity by _mirror_fix_dft_specs
                    sym_axes.add(ax)
                center[ax] = 0.5 * (lo2 + hi)
                size[ax] = hi - lo2
                factor *= 1.0 + par
            else:
                raise ValueError(
                    f"DFT region straddles the {d} mirror plane "
                    "asymmetrically; use a symmetric region or place it in "
                    "one half of the cell")
        return center, size, factor, sym_axes

    def _fold_region_rot(self, center, size, parity_fn):
        """`_fold_region` on a rotational fold (simulation.py:871-900).
        Rotate4: a region must lie in the retained quadrant (its images are
        rotated surfaces with swapped components, which no weight
        represents).  Rotate2: the product's C2 parity is its parities
        under the two perpendicular mirrors, without the phase (the
        monitored products are quadratic in the fields, so the phase
        squares away; the reference multiplies by it, which flips an
        imaged flux and zeroes a centred energy at phase -1, ROADMAP C.3);
        a region wholly in the dropped half maps to its C2 image with that
        factor, one centred on the rotation axis is clipped to the
        retained half with factor 1 + parity, its edge just inside -dx/2
        (the fold plane lies midway between centred columns, so the first
        retained column keeps its interior weight); any other straddle
        raises."""
        if self._rot4 is not None:
            for ax in self._rot4[:2]:
                if center[ax] - 0.5 * size[ax] < -1e-9:
                    raise ValueError(
                        "DFT region extends outside the retained Rotate4 "
                        "quadrant; place monitors in the quadrant (their "
                        "images are rotated surfaces with swapped "
                        "components, not representable by a weight)")
            return center, size, 1.0, set()
        fax, lax, _, _ = self._rot2
        par = parity_fn(self.gv.axes[fax]) * parity_fn(self.gv.axes[lax])
        lo = center[fax] - 0.5 * size[fax]
        hi = center[fax] + 0.5 * size[fax]
        if lo >= -1e-9:
            return center, size, 1.0, set()
        if hi <= 1e-9:
            center[fax], center[lax] = -center[fax], -center[lax]
            return center, size, par, set()
        if abs(center[fax]) < 1e-9 and abs(center[lax]) < 1e-9:
            lo2 = -0.5 * self.gv.dx * (1.0 - 1e-6)
            center[fax] = 0.5 * (lo2 + hi)
            size[fax] = hi - lo2
            return center, size, 1.0 + par, set()
        raise ValueError(
            "DFT region straddles the Rotate2 fold plane asymmetrically; "
            "center it on the rotation axis or place it in one half of the "
            "cell")

    def _mirror_fix_dft_specs(self, specs, sym_axes):
        """On a half-offset-aligned mirror the first centred row of a
        symmetrically folded region lies on the plane, and its centred
        average saw the zero row below the wall: weight it x(1 + s) with s
        = phase * the component's parity (simulation.py:825-851)."""
        for spec in specs:
            if not spec.centered:
                continue
            for ax, d, phase in self._mirrors:
                if ax not in sym_axes or spec.region[ax][0] != 0:
                    continue
                sgn = phase * _mirror_parity(spec.component, d)
                w = np.array(spec.weights, dtype=float)
                sl = [slice(None)] * w.ndim
                sl[ax] = slice(0, 1)
                w[tuple(sl)] *= 1.0 + sgn
                spec.weights = w
        return specs

    def _fold_point(self, component, c):
        """(component', axes coordinates', factor) of a point folded into
        the retained half or wedge (simulation.py:3494-3560):
        F_component(pt) == factor * F_component'(pt').  Mirrors reflect with
        phase * the component's parity; Rotate2 maps through the C2 image
        (both perpendicular coordinates negated, the two parities);
        Rotate4 turns the point by quarter turns, each swapping an in-plane
        component with its partner, with the rotation-matrix signs of
        step.rot4_ghost."""
        c = list(c)
        fac = 1.0
        axes = self.gv.axes
        for ax, d, phase in self._mirrors:
            if c[ax] < -1e-12:
                c[ax] = -c[ax]
                fac *= phase * _mirror_parity(component, d)
        if self._rot2 is not None:
            fax, lax, _, phase = self._rot2
            if c[fax] < -1e-12:
                c[fax], c[lax] = -c[fax], -c[lax]
                fac *= phase * _mirror_parity(component, axes[fax]) \
                    * _mirror_parity(component, axes[lax])
        if self._rot4 is not None:
            a1, a2, w, phase = self._rot4
            l1, l2 = axes[a1], axes[a2]
            for _ in range(3):
                if c[a1] >= -1e-12 and c[a2] >= -1e-12:
                    break
                c[a1], c[a2] = c[a2], -c[a1]
                if component[1] == l1:
                    fac *= -phase
                    component = component[0] + l2
                elif component[1] == l2:
                    fac *= phase
                    component = component[0] + l1
                else:
                    fac *= phase
        return component, c, fac

    def _live(self) -> List[str]:
        live_e, live_h = self._live_components()
        return live_e + live_h

    def add_flux(self, fcen, df, nfreq, *regions, decimation_factor=0):
        freqs = self._freqs(fcen, df, nfreq)
        name = f"flux{len(self._handles)}"
        for ri, reg in enumerate(regions):
            center = _vec_to_axes(self.gv, reg.center)
            size = _vec_to_axes(self.gv, reg.size)
            normal = self._normal(size, reg.direction)
            # the flux density S_n is odd under a mirror along n, else even
            center, size, fac, sym = self._fold_region(
                center, size, lambda d: -1.0 if d == normal else 1.0)
            self._dft_specs += self._mirror_fix_dft_specs(M.flux_specs(
                self.gv, f"{name}:{ri}", normal, center, size, freqs,
                weight=reg.weight * fac, live=self._live(),
                decimation=self._resolve_decimation(decimation_factor,
                                                    freqs)), sym)
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
        for ax in sorted(self._folded_axes()):
            if c_ax[ax] - s_ax[ax] / 2 < -1e-9:
                # per-site DTFTs have no scalar fold factor
                raise ValueError(
                    "add_dft_fields region extends into the dropped half of "
                    f"the folded {self.gv.axes[ax]} axis; restrict it to "
                    "the retained half (get_dft_array values there equal "
                    "the full cell's)")
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
            # the energy density is even under any mirror
            center, size, fac, sym = self._fold_region(
                _vec_to_axes(self.gv, reg.center),
                _vec_to_axes(self.gv, reg.size), lambda d: 1.0)
            self._dft_specs += self._mirror_fix_dft_specs(M.energy_specs(
                self.gv, f"{name}:{ri}", center, size, freqs,
                live=self._live(), decimation=dec,
                weight=reg.weight * fac), sym)
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
            fd = reg.direction or normal
            # the stress tensor T_fn has parity (-1)^([f == d] + [n == d])
            center, size, fac, sym = self._fold_region(
                center, size, lambda d: (-1.0 if fd == d else 1.0)
                * (-1.0 if normal == d else 1.0))
            self._dft_specs += self._mirror_fix_dft_specs(M.force_specs(
                self.gv, f"{name}:{ri}", fd, normal, center, size, freqs,
                weight=reg.weight * fac, live=self._live()), sym)
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
        components on their own Yee lattices, sampled every step.  With
        nperiods > 1 on a Bloch-periodic cell the far-field sum adds
        2 nperiods + 1 lattice images of each surface that spans the cell
        along a wrapped tangential axis, each with its Bloch phase
        (near2far.cpp:609-622, simulation.py:1562-1680)."""
        freqs = self._freqs(fcen, df, nfreq)
        name = f"n2f{len(self._handles)}"
        surfaces = []
        periodic = []
        per = self._periodic()
        kv = _vec_to_axes(self.gv, self.k_point)
        for ri, reg in enumerate(regions):
            center = _vec_to_axes(self.gv, reg.center)
            size = _vec_to_axes(self.gv, reg.size)
            normal = self._normal(size, reg.direction)
            clipped = self._fold_near2far(center, size)
            if clipped is None:
                continue
            specs, surfs = M.near2far_specs(
                self.gv, f"{name}:{ri}", normal, center, size, freqs,
                weight=reg.weight, live=self._live())
            for ax, d in clipped:
                # the first row on the clipped edge of a component that is
                # half-offset along d got the split edge weight against the
                # absent row below the plane; its image covers the pair, so
                # it keeps its interior weight (simulation.py:1620-1643)
                for spec in specs:
                    if spec.region[ax][0] != 0 or not G.yee_shift(
                            spec.component, self.gv.dim).get(d, 0):
                        continue
                    w = np.array(spec.weights)
                    if w.shape[ax] < 2:
                        continue
                    sl0 = [slice(None)] * w.ndim
                    sl1 = [slice(None)] * w.ndim
                    sl0[ax], sl1[ax] = 0, 1
                    w[tuple(sl0)] = w[tuple(sl1)]
                    spec.weights = w
            self._dft_specs += specs
            surfaces += surfs
            if nperiods > 1:
                n_ax = self.gv.axes.index(normal)
                for ax in range(self.gv.ndim):
                    width = self.gv.num[ax] * self.gv.dx
                    if ax != n_ax and per[ax] and size[ax] >= width - 1e-9:
                        periodic.append((ax, int(nperiods),
                                         2 * np.pi * kv[ax] * width, width))
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
        h = _N2FHandle(name, freqs, surfaces, eps=eps_amb,
                       m=float(self.m or 0.0), sim=self,
                       mirrors=tuple(self._mirrors),
                       periodic=tuple(periodic))
        self._handles.append(h)
        return h

    def _fold_near2far(self, center, size):
        """Clip a near2far surface (in place) to the retained half of each
        mirror whose plane it crosses symmetrically: [(axis, letter)] of
        those mirrors; None for a surface wholly in the dropped half, whose
        contribution is the image of the partner face the far-field sum
        adds (simulation.py:1595-1619).  On a rotational fold the surface
        must lie in the retained wedge (simulation.py:1584-1595)."""
        if self._rot2 is not None or self._rot4 is not None:
            for ax in sorted(self._folded_axes()):
                if center[ax] - 0.5 * size[ax] < -1e-9:
                    raise ValueError("near2far with a rotational fold needs "
                                     "the near surface in the retained "
                                     "wedge")
        clipped = []
        for ax, d, phase in self._mirrors:
            lo = center[ax] - 0.5 * size[ax]
            hi = center[ax] + 0.5 * size[ax]
            if lo >= -1e-9:
                continue
            if not (phase == -1 or ax in self._mirror_node):
                raise ValueError(
                    f"near2far on a half-offset-aligned {d} mirror is not "
                    "supported; use an even cell count (the plane then "
                    "lands on a grid site)")
            if hi <= 1e-9:
                return None
            if abs(center[ax]) > 1e-9:
                raise ValueError(f"near2far region straddles the {d} mirror "
                                 "plane asymmetrically")
            center[ax] = hi / 2
            size[ax] = hi
            clipped.append((ax, d))
        return clipped

    def get_farfield_axes(self, handle, x_axes) -> np.ndarray:
        """(6, nfreq) = (Ex, Ey, Ez, Hx, Hy, Hz)(w) at a far point given
        in grid-axis coordinates (dft_near2far::farfield)."""
        from ..analysis.near2far import farfield
        return farfield(handle.surfaces, self._state, handle.freqs, x_axes,
                        self.gv.dim, eps=handle.eps, mu=handle.mu,
                        m=handle.m, periodic=handle.periodic,
                        mirrors=handle.mirrors)

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
        """A probe of `component` interpolated at point `pt`, folded into
        the retained half (simulation.py:2735-2760)."""
        component, axc, fac = self._fold_point(component,
                                               _vec_to_axes(self.gv, pt))
        pts = self.gv.interp_weights(component, axc)
        return S.ProbeSpec(name, component,
                           np.array([p for p, w in pts], np.int32),
                           np.array([fac * w for p, w in pts]))

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
                arr = ys[k].detach().cpu().numpy()
                if self._plan.real_pair and arr.ndim == 2:
                    # a real pair's (re, im) rows (simulation.py:2902)
                    arr = arr[:, 0] + 1j * arr[:, 1]
                series[k].append(arr)
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

    # -- k-point sweeps (simulation.py:3832-4030) ---------------------------
    def change_k_point(self, k):
        """Change the Bloch wave vector (simulation.py:3923); the fields
        restart, since the wrapped axes and the phases make another
        plan."""
        self.k_point = k
        if self._plan is not None:
            self._plan = None
            self._state = None
            self._t = 0

    def change_m(self, m):
        """Change the cylindrical azimuthal number (simulation.py:3930); the
        fields restart, since m sets the plan's coefficients and whether
        its fields are complex."""
        self.m = m
        if self._plan is not None:
            self._plan = None
            self._state = None
            self._t = 0

    def restart_fields(self):
        """Zero the fields and the clock, keeping the DFT accumulators
        (simulation.py:3937)."""
        if self._state is None:
            self.init_sim()
            return
        st = self._state
        self._state = {
            **st, "t": 0,
            **{k: {c: torch.zeros_like(v) for c, v in st[k].items()}
               for k in ("f", "f_u", "f_cond", "f_w", "f_bfast")
               if k in st},
            "pol": [{k: {c: torch.zeros_like(v) for c, v in e[k].items()}
                     for k in ("p", "pp")} for e in st["pol"]]}
        self._t = 0

    def run_k_point(self, t: float = None, k=None):
        """One Bloch run at k (simulation.py:3986): the fields restart,
        then Harminv at the first source's point and component over the
        union of the sources' bandwidths, `t` time units after the sources
        (50 by default); returns the Harminv collector."""
        from ..analysis.harminv import Harminv
        from .run_control import after_sources
        if not self.sources:
            raise ValueError("run_k_point needs at least one source")
        lo, hi = [], []
        for s in self.sources:
            f0 = getattr(s.src, "frequency", None)
            w = getattr(s.src, "fwidth", None)
            if f0 is None or w is None:
                continue
            lo.append(f0 - w / 2)
            hi.append(f0 + w / 2)
        fmin, fmax = min(lo), max(hi)
        self.change_k_point(k)
        h = Harminv(self.sources[0].component, self.sources[0].center,
                    0.5 * (fmin + fmax), fmax - fmin)
        self.run(after_sources(h),
                 until_after_sources=t if t is not None else 50.0)
        return h

    def run_k_points(self, t: float = None, k_points=None):
        """Harminv's complex frequencies per Bloch k (simulation.py:4005):
        a list over `k_points`, each printed as the reference's freqs: /
        freqs-im: lines."""
        all_freqs = []
        for k_index, k in enumerate(k_points or [], start=1):
            h = self.run_k_point(t, k)
            freqs = [complex(m.freq, m.decay) for m in h.modes]
            kk = ", ".join(str(v) for v in tuple(_v3(k)))
            print(f"freqs:, {k_index}, {kk}, "
                  + ", ".join(str(f.real) for f in freqs))
            print(f"freqs-im:, {k_index}, {kk}, "
                  + ", ".join(str(f.imag) for f in freqs))
            all_freqs.append(freqs)
        return all_freqs

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
        v = complex(arr[arr.shape[0] // 2].sum())
        if not np.isfinite(v):
            raise RuntimeError(
                "simulation fields are NaN or Inf (step.cpp:138 abort)")

    # ------------------------------------------------------------- accessors
    def meep_time(self) -> float:
        return self._t * self.dt

    def using_real_fields(self) -> bool:
        """Whether this run steps real fields (simulation.py:3736-3748):
        not with force_complex_fields, a cylindrical m != 0, a complex
        symmetry phase, or a nonzero k_point (a 2D cell's k along z alone
        counts as zero)."""
        cond1 = self.gv.dim == "cyl" and self.m != 0
        cond2 = any(complex(getattr(s, "phase", 1)).imag
                    for s in self.symmetries if hasattr(s, "phase"))
        kp = _v3(self.k_point) if self.k_point is not None else None
        cond3 = kp is None
        cond4 = (kp is not None and self.gv.dim == "2d"
                 and kp.x == 0 and kp.y == 0)
        cond5 = not (cond3 or cond4 or (kp is not None and tuple(kp)
                                        == (0.0, 0.0, 0.0)))
        return not (self.force_complex_fields or cond1 or cond2 or cond5)

    def require_dimensions(self):
        """The dimensionality as the reference numbers it (simulation.py:
        3750): 1, 2, 3, or -2 for a cylindrical cell."""
        self.dimensions = {"1d": 1, "2d": 2, "3d": 3, "cyl": -2}[self.dim]
        return self.dimensions

    def get_field_point(self, component, pt) -> complex:
        """The component interpolated at point `pt`, folded into the
        retained half of a mirrored cell (simulation.py:3456, without
        derived quantities)."""
        self.init_sim()
        asked = component
        component, axc, fac = self._fold_point(component,
                                               _vec_to_axes(self.gv, pt))
        if component != asked and component not in self._state["f"]:
            # a Rotate4 fold swapped in a partner the cell does not carry
            return 0j
        pts = self.gv.interp_weights(component, axc)
        arr = self._state["f"][component]
        if arr.ndim == self.gv.ndim + 1:       # a real pair (re, im)
            return fac * sum(w * complex(float(arr[(0,) + tuple(idx)]),
                                         float(arr[(1,) + tuple(idx)]))
                             for idx, w in pts)
        return fac * sum(w * complex(arr[tuple(idx)]) for idx, w in pts)

    def get_array(self, component=None, center=None, size=None,
                  snap: bool = False) -> np.ndarray:
        """Dense array of a field component (array_slice.cpp analog).

        Default (snap=False): interpolated from the Yee sites onto the
        cell's integer lattice; along axes where the component sits at
        half-integer sites, 2-point averages with zero ghosts at both ends.
        snap=True returns the raw component-lattice array.  On a Rotate4
        fold an in-plane component unfolds on its raw lattice first (its
        rotated quadrants carry the swapped component,
        `_unfold_rot4_inplane`), then collapses on the full cell."""
        self.init_sim()
        arr = self._field_np(component)
        coords = [self.gv.comp_coords(component, ax)
                  for ax in range(self.gv.ndim)]
        rot4_inplane = self._rot4 is not None and \
            component[1] != self._rot4[2]
        if rot4_inplane:
            arr, coords = self._unfold_rot4_inplane(component, arr, coords)
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
        if not rot4_inplane:
            arr, coords = self._unfold(component, arr, coords)
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

    def _get_field_family(self, letter, snap=False) -> np.ndarray:
        """A field family's components stacked on the last axis
        (simulation.py:4346): (x, y, z), or on a cylindrical cell (r, p)
        as the reference stacks them; a component the plan does not step
        reads zeros, every array cut to the smallest extents."""
        comps = (letter + "r", letter + "p") if self.gv.dim == "cyl" \
            else (letter + "x", letter + "y", letter + "z")
        arrs = []
        for c in comps:
            try:
                arrs.append(np.asarray(self.get_array(component=c,
                                                      snap=snap)))
            except KeyError:
                arrs.append(None)
        have = [a for a in arrs if a is not None]
        shp = tuple(min(a.shape[i] for a in have)
                    for i in range(have[0].ndim))
        arrs = [np.zeros(shp) if a is None
                else a[tuple(slice(0, n) for n in shp)] for a in arrs]
        return np.stack(arrs, axis=-1)

    def get_efield(self, snap=False) -> np.ndarray:
        return self._get_field_family("e", snap)

    def get_hfield(self, snap=False) -> np.ndarray:
        return self._get_field_family("h", snap)

    def get_dfield(self, snap=False) -> np.ndarray:
        return self._get_field_family("d", snap)

    def get_bfield(self, snap=False) -> np.ndarray:
        return self._get_field_family("b", snap)

    def _field_np(self, component) -> np.ndarray:
        """A component's live storage as a host array, complex for complex
        fields (a real pair's channels recombined, simulation.py:3434)."""
        live = tuple(slice(0, n + 1) for n in self.gv.num)
        arr = self._state["f"][component].detach().cpu().numpy()
        if arr.ndim == self.gv.ndim + 1:
            return arr[(0,) + live] + 1j * arr[(1,) + live]
        return arr[live]

    def _wedge_images(self, coords):
        """The full cell's coordinates on a Rotate4 fold's two axes and,
        per full site, the retained-wedge site it turns into by quarter
        turns R^-1: (x, y) -> (y, -x): (full1, full2, X, Y, turns).  Sites
        past the live high edge (phantom rows of a half-offset lattice)
        have no image inside the cell: only the live span is mirrored."""
        a1, a2 = self._rot4[:2]
        cw1, cw2 = coords[a1], coords[a2]
        dx = self.gv.dx
        full = []
        for cw, ax in ((cw1, a1), (cw2, a2)):
            hi = self.gv.num[ax] * dx
            full.append(np.concatenate(
                [-np.flip(cw[(cw > 1e-12) & (cw <= hi + 1e-9)]), cw]))
        X = full[0][:, None] + 0 * full[1][None, :]
        Y = 0 * full[0][:, None] + full[1][None, :]
        turns = np.zeros(X.shape, dtype=int)
        for _ in range(3):
            neg = (X < -1e-12) | (Y < -1e-12)
            if not np.any(neg):
                break
            X, Y = np.where(neg, Y, X), np.where(neg, -X, Y)
            turns = turns + neg
        return full[0], full[1], X, Y, turns

    def _wedge_take(self, arr, cw1, cw2, X, Y):
        """arr (wedge lattice with coordinates cw1, cw2 on the fold axes)
        at the sites (X, Y), the fold axes moved to the front, and the
        largest distance of a site from its lattice point."""
        a1, a2 = self._rot4[:2]
        dx = self.gv.dx
        i1 = np.clip(np.round((X - cw1[0]) / dx).astype(int), 0, len(cw1) - 1)
        i2 = np.clip(np.round((Y - cw2[0]) / dx).astype(int), 0, len(cw2) - 1)
        err = np.maximum(np.abs(X - (cw1[0] + i1 * dx)),
                         np.abs(Y - (cw2[0] + i2 * dx)))
        take = np.moveaxis(np.asarray(arr), (a1, a2), (0, 1))
        return take[i1, i2], err

    def _wedge_place(self, out, full1, full2, coords):
        """`out` (fold axes in front) back in axis order, with the full
        cell's coordinates."""
        a1, a2 = self._rot4[:2]
        coords = list(coords)
        coords[a1], coords[a2] = full1, full2
        return np.moveaxis(out, (0, 1), (a1, a2)), coords

    def _unfold_rot4_inplane(self, component, arr, coords):
        """The full cell of an in-plane component on a Rotate4 fold, on its
        raw lattice (simulation.py:3081-3170): a full-cell site turned into
        the wedge by k quarter turns reads the component itself (k even)
        or its x<->y-swapped partner (k odd), each turn's sign -p for an
        ax1-directed and +p for an ax2-directed component, as
        step.rot4_ghost.  The turns map the two in-plane lattices onto
        each other exactly; a site that lands off its lattice raises."""
        a1, a2, _, phase = self._rot4
        l1, l2 = self.gv.axes[a1], self.gv.axes[a2]
        partner = component[0] + (l2 if component[1] == l1 else l1)
        coords2 = [self.gv.comp_coords(partner, ax)
                   for ax in range(self.gv.ndim)]
        full1, full2, X, Y, turns = self._wedge_images(coords)
        # the sign of each turn: the component it starts from is
        # ax1-directed on even turns of an ax1 component
        sgn = np.ones(X.shape)
        base1 = component[1] == l1
        for k in range(1, 4):
            cur1 = ((k - 1) % 2 == 0) == base1
            sgn = np.where(turns >= k, sgn * (-phase if cur1 else phase),
                           sgn)
        out_c, err_c = self._wedge_take(arr, coords[a1], coords[a2], X, Y)
        # a partner the cell does not carry reads zero
        arr_p = self._field_np(partner) if partner in self._state["f"] \
            else np.zeros_like(arr)
        out_p, err_p = self._wedge_take(arr_p,
                                        coords2[a1], coords2[a2], X, Y)
        even = turns % 2 == 0
        if np.where(even, err_c, err_p).max() > self.gv.dx / 4:
            raise AssertionError("rot4 in-plane unfold: a mapped site lies "
                                 "off its lattice")
        trail = (1,) * (out_c.ndim - 2)
        out = np.where(even.reshape(even.shape + trail), out_c, out_p) \
            * sgn.reshape(sgn.shape + trail)
        return self._wedge_place(out, full1, full2, coords)

    def _unfold_rot4(self, component, arr, coords):
        """The full cell of the rotation-axis component (or "eps") on a
        Rotate4 fold (simulation.py:3177-3230): each full site turned into
        the wedge by k quarter turns, times phase^k.  A component
        half-offset on both fold axes (Hz-like) was averaged on the wedge's
        fold-edge rows with a zero ghost: the missing half is the C4 image
        of the other fold edge's row (hz(-dx/2, y) = p hz(y, dx/2)), and
        the shared corner completes to the (1 + p)^2 quadruple image.
        That repair applies to the centred lattice only, whose first row
        lies on the plane: the raw lattice (get_array(snap=True)) has no
        such row, and the reference's repair there adds the image to the
        first half-site row (ROADMAP C.3)."""
        a1, a2, _, phase = self._rot4
        p = 1.0 if component == "eps" else float(phase)
        if component != "eps" and abs(coords[a1][0]) <= 1e-12 and \
                G.yee_shift(component, self.gv.dim)[self.gv.axes[a1]]:
            arr = np.array(arr)
            T = np.swapaxes(arr, a1, a2).copy()
            for ax in (a1, a2):
                sl = [slice(None)] * arr.ndim
                sl[ax] = 0
                arr[tuple(sl)] += p * T[tuple(sl)]
            sl = [slice(None)] * arr.ndim
            sl[a1] = sl[a2] = 0
            arr[tuple(sl)] += p * p * T[tuple(sl)]
        full1, full2, X, Y, turns = self._wedge_images(coords)
        out, _ = self._wedge_take(arr, coords[a1], coords[a2], X, Y)
        sgn = p ** turns
        out = out * sgn.reshape(sgn.shape + (1,) * (out.ndim - 2))
        return self._wedge_place(out, full1, full2, coords)

    def _unfold_rot2(self, component, arr, coords):
        """The full cell from a Rotate2 fold's retained half
        (simulation.py:3231-3290): f(-x, y) = s f(x, -y), s = phase times
        the component's two mirror parities ("eps": 1), the flip over the
        flip axis's symmetric live span (phantom rows past it have no
        image and read 0).  A component half-offset along the fold axis
        had its centred plane row averaged with a zero ghost: the true
        ghost is the C2 image of the first half-site, s times the flip of
        that row."""
        fax, lax, _, phase = self._rot2
        axes = self.gv.axes
        s = 1.0 if component == "eps" else phase \
            * _mirror_parity(component, axes[fax]) \
            * _mirror_parity(component, axes[lax])
        c_ax, c_fl = coords[fax], coords[lax]
        k_sym = int(np.sum(c_fl <= -c_fl[0] + 1e-9))

        def flip_l(a):
            out = np.zeros_like(a)
            sl = [slice(None)] * a.ndim
            sl[lax] = slice(0, k_sym)
            out[tuple(sl)] = np.flip(a[tuple(sl)], axis=lax)
            return out

        pos = np.where(c_ax > 1e-12)[0]
        onp = np.where(np.abs(c_ax) <= 1e-12)[0]
        pos_im = pos[c_ax[pos] <= self.gv.num[fax] * self.gv.dx + 1e-9]
        parts = [s * np.flip(flip_l(np.take(arr, pos_im, axis=fax)),
                             axis=fax)]
        cparts = [-np.flip(c_ax[pos_im])]
        if len(onp):
            a_on = np.take(arr, onp, axis=fax)
            if component != "eps" and \
                    G.yee_shift(component, self.gv.dim)[axes[fax]]:
                a_on = a_on + s * flip_l(a_on)
            parts.append(a_on)
            cparts.append(c_ax[onp])
        parts.append(np.take(arr, pos, axis=fax))
        cparts.append(c_ax[pos])
        coords = list(coords)
        coords[fax] = np.concatenate(cparts)
        return np.concatenate(parts, axis=fax), coords

    def _unfold(self, component, arr, coords):
        """The full mirrored cell from the retained half (simulation.py:
        3171-3330, mirror branch): rows above each plane reflect with sign
        phase * the component's mirror parity ("eps": 1), rows on the plane
        are shared, the one row below a half-offset plane is dropped.  On
        a whole-site plane the centred row of a half-offset component was
        averaged with a zero ghost: the true ghost is its image, s * itself.
        The reference restores that row on node mirrors only, so on a metal
        wall (phase -1) it returns half the full cell's value there for the
        components with s = +1 (ROADMAP C.3); the port restores it on both.
        Rotational folds: `_unfold_rot2`, `_unfold_rot4`.  Returns
        (array, coordinates)."""
        if self._rot4 is not None:
            return self._unfold_rot4(component, arr, coords)
        if self._rot2 is not None:
            return self._unfold_rot2(component, arr, coords)
        for ax, d, phase in self._mirrors:
            s = 1.0 if component == "eps" else \
                phase * _mirror_parity(component, d)
            c_ax = coords[ax]
            pos = np.where(c_ax > 1e-12)[0]
            onp = np.where(np.abs(c_ax) <= 1e-12)[0]
            if ax in self._mirror_node:
                # the image reaches down to the full cell's low edge only: a
                # half-offset site past the fold extent has no partner
                pos_im = pos[c_ax[pos] <= self.gv.num[ax] * self.gv.dx + 1e-9]
            else:
                pos_im = pos
            parts = [s * np.flip(np.take(arr, pos_im, axis=ax), axis=ax)]
            cparts = [-np.flip(c_ax[pos_im])]
            if len(onp):
                a_on = np.take(arr, onp, axis=ax)
                whole_site = phase == -1 or ax in self._mirror_node
                if whole_site and component != "eps" and \
                        G.yee_shift(component, self.gv.dim).get(d, 0):
                    a_on = a_on * (1.0 + s)
                parts.append(a_on)
                cparts.append(c_ax[onp])
            parts.append(np.take(arr, pos, axis=ax))
            cparts.append(c_ax[pos])
            arr = np.concatenate(parts, axis=ax)
            coords = list(coords)
            coords[ax] = np.concatenate(cparts)
        return arr, coords

    def _inverse_u(self, specs, default) -> np.ndarray:
        """1 / u (the plan's inverse epsilon or mu) on the lattice of the
        first live component of `specs`, unfolded over a folded cell;
        ones where the plan keeps no u.  A Rotate4 fold permutes its two
        axes, so it unfolds only a lattice whole on both (the rotation-axis
        component, preferred; simulation.py:3392-3415) and else returns
        the retained quadrant, as the reference's get_epsilon does for 2D
        TE."""
        c = specs[0].ec if specs else default
        unfold = True
        if self._rot4 is not None:
            good = [sp.ec for sp in specs
                    if not any(G.yee_shift(sp.ec, self.gv.dim)[
                        self.gv.axes[ax]] for ax in self._rot4[:2])]
            unfold = bool(good)
            c = good[0] if good else c
        u = self._plan.coefs.get(f"{c}:u")
        if u is None:
            inv = np.ones(self.gv.shape)
        else:
            u = u.detach().cpu().numpy().astype(np.float64)
            u = u[tuple(slice(0, n + 1) for n in self.gv.num)]
            inv = 1.0 / np.maximum(u, 1e-300)
        if not unfold:
            return inv
        coords = [np.asarray(self.gv.comp_coords(c, ax))
                  for ax in range(self.gv.ndim)]
        return self._unfold("eps", inv, coords)[0]

    def get_epsilon(self) -> np.ndarray:
        """Permittivity on the first live E component's lattice
        (simulation.py:3388)."""
        return self._inverse_u(self.plan.eh_specs_e, "ez")

    def get_mu(self) -> np.ndarray:
        """Permeability on the first live H component's lattice
        (simulation.py:3420), unfolded like get_epsilon (the reference
        returns the retained half)."""
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
