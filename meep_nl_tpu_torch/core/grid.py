"""Yee-grid core: directions, field components, and grid geometry.

The port's own copy of ``meep_nl_tpu/core/grid.py`` (pure numpy; the port
imports nothing of the JAX package).  Conventions are the reference's
(meep ``src/meep/vec.hpp``: ``component`` enum at vec.hpp:31,
``grid_volume`` at vec.hpp:1014, Yee offsets ``iyee_shift`` at vec.hpp:1133):

  * lengths are in user units `a`; `resolution` grid cells per unit.
  * dx = 1/resolution; dt = Courant * dx (c = 1, eps0 = mu0 = 1).
  * a field component `c` value stored at integer index i along axis `ax`
    sits at coordinate (i + 0.5*yee_shift(c)[ax]) * dx from the grid origin.
  * electric/D components are offset by half a cell in their own direction;
    magnetic/B components in the two transverse directions.

Every component is stored as a dense (N1+1, ..., Nd+1) array; entries that
stick out past the cell boundary are forced to zero by per-component masks
(the analog of the reference's owned-point logic and boundaries.cpp:304
zero_metal).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Directions
# ---------------------------------------------------------------------------

X, Y, Z, R, P = "x", "y", "z", "r", "p"

#: Cartesian cycle used by the curl and PML-direction assignments
#: (vec.hpp:586 `cycle_direction`: (d + shift) % 3 over X,Y,Z).
_CART = (X, Y, Z)
#: cylindrical cycle (R, P, Z)
_CYL = (R, P, Z)


def cycle_direction(dim: str, d: str, shift: int) -> str:
    """Cyclically shift direction `d`; mirrors vec.hpp:586."""
    cyc = _CYL if dim == "cyl" else _CART
    return cyc[(cyc.index(d) + shift) % 3]


# ---------------------------------------------------------------------------
# Components
# ---------------------------------------------------------------------------

E_STUFF, H_STUFF, D_STUFF, B_STUFF = "e", "h", "d", "b"

ELECTRIC = ("ex", "ey", "ez", "er", "ep")
MAGNETIC = ("hx", "hy", "hz", "hr", "hp")
D_COMPS = ("dx", "dy", "dz", "dr", "dp")
B_COMPS = ("bx", "by", "bz", "br", "bp")


def field_type(c: str) -> str:
    return c[0]


def component_direction(c: str) -> str:
    return c[1]


def direction_component(c: str, d: str) -> str:
    return c[0] + d


def is_electric(c: str) -> bool:
    return c[0] == "e"


def is_magnetic(c: str) -> bool:
    return c[0] == "h"


def ft_to_f(ft: str) -> str:
    """D_stuff -> e components etc: the field updated from this field type."""
    return {"d": "e", "b": "h", "e": "e", "h": "h"}[ft]


def field_type_component(ft: str, c: str) -> str:
    """Pair component: e.g. (d, 'ex') -> 'dx'  (meep.hpp field_type_component)."""
    return ft + c[1]


_SIGN = {(X, Y): +1, (Y, Z): +1, (Z, X): +1, (Y, X): -1, (Z, Y): -1, (X, Z): -1}


def cross_direction(a: str, b: str) -> str:
    """Direction of a x b for distinct cartesian-like directions.

    Mirrors fields.cpp:417 `cross` with the cylindrical mapping (R,P,Z) ->
    (X,Y,Z)."""
    m = {R: X, P: Y}
    a2, b2 = m.get(a, a), m.get(b, b)
    c = _CART[(3 + 2 * _CART.index(a2) - _CART.index(b2)) % 3]
    if a in (R, P) or b in (R, P):
        return {X: R, Y: P}.get(c, c)
    return c


def cross_negative(a: str, b: str) -> bool:
    """Mirrors fields.cpp:411 `cross_negative`."""
    m = {R: X, P: Y}
    a2, b2 = m.get(a, a), m.get(b, b)
    return (3 + _CART.index(b2) - _CART.index(a2)) % 3 == 2


# ---------------------------------------------------------------------------
# Grid volume
# ---------------------------------------------------------------------------


def yee_shift(c: str, dim: str) -> Dict[str, int]:
    """Half-cell offsets of component `c` along each axis (1 = half cell).

    Mirrors vec.hpp:1133 `iyee_shift`: electric (and D) components offset in
    their own direction, magnetic (and B) in the transverse directions."""
    d_c = component_direction(c)
    cyc = _CYL if dim == "cyl" else _CART
    out = {}
    for d in cyc:
        if field_type(c) in ("e", "d"):
            out[d] = 1 if d == d_c else 0
        else:
            out[d] = 0 if d == d_c else 1
    return out


# Components present per dimensionality, in the reference's arrangement:
#  - 1d: z axis only; fields Ex, Hy (meep D1)
#  - 2d: (x, y) axes; TM = Ez,Hx,Hy; TE = Ex,Ey,Hz
#  - 3d: all six
#  - cyl: (r, z) axes; Er,Ep,Ez,Hr,Hp,Hz
_DIM_AXES = {
    "1d": (Z,),
    "2d": (X, Y),
    "3d": (X, Y, Z),
    "cyl": (R, Z),
}

_DIM_E = {
    # 1d carries BOTH transverse polarizations (Ex/Hy and Ey/Hx), like the
    # reference (fields.cpp require_component in D1): gyrotropic media and
    # circularly-polarized sources couple them (e.g. Faraday rotation).
    # The live-component closure keeps single-polarization runs on the
    # two-component fast set.
    "1d": ("ex", "ey"),
    "2d": ("ex", "ey", "ez"),
    "3d": ("ex", "ey", "ez"),
    "cyl": ("er", "ep", "ez"),
}
_DIM_H = {
    "1d": ("hx", "hy"),
    "2d": ("hx", "hy", "hz"),
    "3d": ("hx", "hy", "hz"),
    "cyl": ("hr", "hp", "hz"),
}


@dataclasses.dataclass(frozen=True)
class GridVolume:
    """Geometry of the computational cell (analog of vec.hpp:1014).

    Attributes:
      dim: '1d' | '2d' | '3d' | 'cyl'
      axes: tuple of axis direction names, e.g. ('x','y') for 2d. Array axis
        k corresponds to direction axes[k].
      num: grid cells per axis (array extent is num+1 points per axis).
      resolution: cells per unit length.
      origin: coordinate of index 0 along each axis (user units).
    """

    dim: str
    axes: Tuple[str, ...]
    num: Tuple[int, ...]
    resolution: float
    origin: Tuple[float, ...]

    # -- constructors -------------------------------------------------------
    @staticmethod
    def create(dim: str, size: Sequence[float], resolution: float,
               origin: Optional[Sequence[float]] = None) -> "GridVolume":
        axes = _DIM_AXES[dim]
        if len(size) != len(axes):
            raise ValueError(f"size must have {len(axes)} entries for {dim}")
        num = tuple(int(round(s * resolution)) for s in size)
        if origin is None:
            # center the cell on the origin, like meep's vol2d/vol3d;
            # cylindrical cells start at the axis r=0 (volcyl)
            origin = tuple(
                0.0 if (dim == "cyl" and d == R) else -n / (2 * resolution)
                for d, n in zip(axes, num))
        return GridVolume(dim, axes, num, float(resolution), tuple(origin))

    # -- basic metrics ------------------------------------------------------
    @property
    def dx(self) -> float:
        return 1.0 / self.resolution

    @property
    def ndim(self) -> int:
        return len(self.axes)

    @property
    def shape(self) -> Tuple[int, ...]:
        """Common storage shape for every field component."""
        return tuple(n + 1 for n in self.num)

    @property
    def size(self) -> Tuple[float, ...]:
        return tuple(n * self.dx for n in self.num)

    @property
    def ntot(self) -> int:
        return int(np.prod(self.shape))

    def axis_of(self, d: str) -> int:
        return self.axes.index(d)

    def has_direction(self, d: str) -> bool:
        return d in self.axes

    # -- components ---------------------------------------------------------
    @property
    def e_components(self) -> Tuple[str, ...]:
        return _DIM_E[self.dim]

    @property
    def h_components(self) -> Tuple[str, ...]:
        return _DIM_H[self.dim]

    def components(self, ft: str) -> Tuple[str, ...]:
        if ft == E_STUFF:
            return self.e_components
        if ft == H_STUFF:
            return self.h_components
        if ft == D_STUFF:
            return tuple("d" + c[1] for c in self.e_components)
        if ft == B_STUFF:
            return tuple("b" + c[1] for c in self.h_components)
        raise ValueError(ft)

    # -- coordinates --------------------------------------------------------
    def comp_coords(self, c: str, axis: int) -> np.ndarray:
        """Physical coordinates of component `c` sample points along `axis`."""
        d = self.axes[axis]
        sh = yee_shift(c, self.dim)[d]
        n = self.num[axis]
        return self.origin[axis] + (np.arange(n + 1) + 0.5 * sh) * self.dx

    def comp_valid_mask_axis(self, c: str, axis: int) -> np.ndarray:
        """1 where the sample point lies within [origin, origin+size]."""
        d = self.axes[axis]
        sh = yee_shift(c, self.dim)[d]
        n = self.num[axis]
        m = np.ones(n + 1, dtype=bool)
        if sh:  # staggered: last sample sticks out of the cell
            m[n] = False
        return m

    def comp_valid_mask(self, c: str) -> np.ndarray:
        """Full-shape boolean mask of in-cell sample points for component c."""
        m = np.ones(self.shape, dtype=bool)
        for ax in range(self.ndim):
            mask = self.comp_valid_mask_axis(c, ax)
            m &= mask.reshape([-1 if a == ax else 1 for a in range(self.ndim)])
        return m

    def metal_mask(self, c: str, periodic: Sequence[bool],
                   boundaries=None) -> np.ndarray:
        """0/1 mask enforcing conducting walls (analog of
        boundaries.cpp:304 zero_metal and meep.hpp:1609
        boundary_condition::{Metallic, Magnetic}).

        On a Metallic (PEC) plane: tangential E/D and normal H/B vanish.
        On a Magnetic (PMC) plane: tangential H/B and normal E/D vanish.
        `boundaries` maps (direction_letter, side) with side in
        {'low','high'} to 'metal' | 'magnetic'; default is metal
        everywhere (set_boundary, meep.hpp:1776).
        Staggered components never lie exactly on their staggered planes.
        Periodic axes get no wall."""
        boundaries = boundaries or {}
        m = self.comp_valid_mask(c).astype(np.float64)
        ys = yee_shift(c, self.dim)
        ft_e = field_type(c) in ("e", "d")
        d_c = component_direction(c)
        for ax, d in enumerate(self.axes):
            if periodic[ax]:
                continue
            for side in ("low", "high"):
                cond = boundaries.get((d, side), "metal")
                if cond == "metal":
                    # Metallic zeroes the ON-PLANE components that must
                    # vanish on a PEC: tangential E/D, normal H/B
                    # (on_metal_boundary, boundaries.cpp:186-198)
                    if ys[d] != 0:
                        continue
                    zero_here = (d_c != d) if ft_e else (d_c == d)
                    i = 0 if side == "low" else self.num[ax]
                elif cond == "magnetic":
                    # Magnetic zeroes the whole HALF-OFFSET layer adjacent
                    # to the wall (boundaries.cpp:191: little_corner + 1 in
                    # doubled ivec coords) — i.e. every component staggered
                    # along d there: normal E/D and tangential H/B.  This
                    # puts the PMC mirror at the half-cell layer.
                    if ys[d] == 0:
                        continue
                    zero_here = True
                    i = 0 if side == "low" else self.num[ax] - 1
                else:   # 'none'
                    continue
                if not zero_here:
                    continue
                # cylindrical: the low-r side is the axis, not a wall
                if (side == "low" and self.dim == "cyl" and d == R
                        and abs(self.origin[ax]) < 1e-12):
                    continue
                idx = [slice(None)] * self.ndim
                idx[ax] = i
                m[tuple(idx)] = 0.0
        return m

    # -- point -> index helpers ---------------------------------------------
    def closest_index(self, c: str, pt: Sequence[float]) -> Tuple[int, ...]:
        out = []
        for ax in range(self.ndim):
            coords = self.comp_coords(c, ax)
            out.append(int(np.argmin(np.abs(coords - pt[ax]))))
        return tuple(out)

    def interp_weights(self, c: str, pt: Sequence[float]
                       ) -> List[Tuple[Tuple[int, ...], float]]:
        """Multilinear interpolation points/weights for component c at pt.

        The analog of the reference's point-source restriction weights
        (sources.cpp:243 src_vol_chunkloop with loop_in_chunks interpolation).
        """
        per_axis: List[List[Tuple[int, float]]] = []
        for ax in range(self.ndim):
            coords = self.comp_coords(c, ax)
            x = (pt[ax] - coords[0]) / self.dx
            i0 = int(math.floor(x))
            frac = x - i0
            n = self.num[ax]
            pts = []
            if 0 <= i0 <= n and abs(1 - frac) > 1e-12:
                pts.append((i0, 1.0 - frac))
            if 0 <= i0 + 1 <= n and abs(frac) > 1e-12:
                pts.append((i0 + 1, frac))
            if not pts:  # clamp
                pts.append((min(max(i0, 0), n), 1.0))
            per_axis.append(pts)
        out: List[Tuple[Tuple[int, ...], float]] = []

        def rec(ax, idx, w):
            if ax == self.ndim:
                out.append((tuple(idx), w))
                return
            for i, wi in per_axis[ax]:
                rec(ax + 1, idx + [i], w * wi)

        rec(0, [], 1.0)
        return out

    # -- step plan ------------------------------------------------------------
    def step_plan(self, c: str) -> "CurlPlan":
        """Curl contributions for updating D/B component `c`.

        Mirrors fields.cpp:441 figure_out_step_plan.  Returns which two field
        components feed the curl and along which axes their derivatives are
        taken."""
        assert field_type(c) in ("d", "b")
        d_c = component_direction(c)
        others = self.components("h" if field_type(c) == "d" else "e")
        plus = minus = None
        plus_d = minus_d = None
        for c2 in others:
            d2 = component_direction(c2)
            if d2 == d_c:
                continue
            dd = cross_direction(d_c, d2)
            if not self.has_direction(dd) and not (self.dim == "cyl" and dd == P):
                continue
            if cross_negative(d2, d_c):
                minus, minus_d = c2, dd
            else:
                plus, plus_d = c2, dd
        return CurlPlan(c, plus, plus_d, minus, minus_d)


@dataclasses.dataclass(frozen=True)
class CurlPlan:
    """df/dt = +-(d g_plus / d_plusdir - d g_minus / d_minusdir)."""
    comp: str
    plus: Optional[str]
    plus_dir: Optional[str]
    minus: Optional[str]
    minus_dir: Optional[str]
