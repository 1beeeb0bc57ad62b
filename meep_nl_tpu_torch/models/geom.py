"""Geometry and material scene objects (analog of python/geom.py).

The port's own copy of the subset of ``meep_nl_tpu/models/geom.py`` that
this slice needs: `Vector3`, `Medium` (eps/mu, conductivities,
susceptibilities, chi2/chi3 with `chi2_full_tensor`), the Lorentzian
susceptibility family, and the `Sphere` and `Block` primitives.  Objects are
pure descriptions; rasterization onto Yee sites happens in models.scene.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np


class Vector3:
    """Minimal Vector3 compatible with the reference's python/geom.py:Vector3."""

    __slots__ = ("x", "y", "z")

    def __init__(self, x=0.0, y=0.0, z=0.0):
        self.x, self.y, self.z = float(x), float(y), float(z)

    def __iter__(self):
        return iter((self.x, self.y, self.z))

    def __getitem__(self, i):
        return (self.x, self.y, self.z)[i]

    def __add__(self, o):
        return Vector3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return Vector3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, s):
        if isinstance(s, Vector3):
            return self.x * s.x + self.y * s.y + self.z * s.z
        return Vector3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def __truediv__(self, s):
        return Vector3(self.x / s, self.y / s, self.z / s)

    def __neg__(self):
        return Vector3(-self.x, -self.y, -self.z)

    def __eq__(self, o):
        return (isinstance(o, Vector3) and self.x == o.x and self.y == o.y
                and self.z == o.z)

    def __repr__(self):
        return f"Vector3({self.x}, {self.y}, {self.z})"

    def norm(self):
        return math.sqrt(self.x ** 2 + self.y ** 2 + self.z ** 2)


def _v3(v) -> Vector3:
    if isinstance(v, Vector3):
        return v
    if np.isscalar(v):
        return Vector3(v, v, v)
    t = tuple(v) + (0.0, 0.0, 0.0)
    return Vector3(*t[:3])


# ---------------------------------------------------------------------------
# Susceptibilities (python/geom.py Susceptibility hierarchy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LorentzianSusceptibility:
    """sigma * frequency^2 / (frequency^2 - f^2 - i f gamma)
    (susceptibility.cpp:188)."""
    frequency: float = 0.0
    gamma: float = 0.0
    sigma: float = 1.0
    sigma_diag: Optional[Vector3] = None

    drude: bool = False

    def sigma_vec(self) -> Vector3:
        if self.sigma_diag is not None:
            return _v3(self.sigma_diag)
        return Vector3(self.sigma, self.sigma, self.sigma)


@dataclasses.dataclass
class DrudeSusceptibility(LorentzianSusceptibility):
    """sigma * frequency^2 / (-f^2 - i f gamma): free carriers
    (no_omega_0_denominator, susceptibility.cpp:196)."""
    drude: bool = True


# ---------------------------------------------------------------------------
# Medium
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Medium:
    """Material description (python/geom.py:Medium).

    epsilon/mu may be scalars or diagonal Vector3.  chi2/chi3 are the
    scalar nonlinear susceptibilities;
    chi2_full_tensor selects the fork's Newton-Raphson coupled solve
    (zinc-blende chi2, newton_raphson.cpp)."""
    epsilon: float = 1.0
    epsilon_diag: Optional[Vector3] = None
    mu: float = 1.0
    mu_diag: Optional[Vector3] = None
    D_conductivity: float = 0.0
    B_conductivity: float = 0.0
    chi2: float = 0.0
    chi3: float = 0.0
    chi2_full_tensor: bool = False
    E_susceptibilities: List[LorentzianSusceptibility] = dataclasses.field(
        default_factory=list)
    H_susceptibilities: List[LorentzianSusceptibility] = dataclasses.field(
        default_factory=list)
    index: dataclasses.InitVar[Optional[float]] = None

    def __post_init__(self, index):
        if index is not None:
            self.epsilon = index ** 2

    def eps_diag_vec(self) -> Vector3:
        if self.epsilon_diag is not None:
            return _v3(self.epsilon_diag)
        return Vector3(self.epsilon, self.epsilon, self.epsilon)

    def mu_diag_vec(self) -> Vector3:
        if self.mu_diag is not None:
            return _v3(self.mu_diag)
        return Vector3(self.mu, self.mu, self.mu)


vacuum = Medium()
air = Medium()


# ---------------------------------------------------------------------------
# Geometric objects (python/geom.py GeometricObject hierarchy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GeometricObject:
    material: Medium = dataclasses.field(default_factory=Medium)
    center: Vector3 = dataclasses.field(default_factory=Vector3)

    def inside(self, pts: np.ndarray) -> np.ndarray:
        """pts: (..., 3) absolute coordinates -> boolean mask."""
        raise NotImplementedError

    def normal_at(self, pts: np.ndarray) -> Optional[np.ndarray]:
        """(..., 3) unit outward normal of the object's nearest surface
        (the role of the reference's normal_to_fixed_object,
        anisotropic_averaging.cpp:27), used by subpixel smoothing."""
        return None

    def _init_common(self, material, center):
        self.material = material if material is not None else Medium()
        self.center = center if center is not None else Vector3()


# NOTE: the reference's shapes take their defining parameter as the FIRST
# positional (Block(size), Sphere(radius); python/geom.py:1245), so these
# classes hand-write __init__ instead of relying on dataclass field order.
@dataclasses.dataclass(init=False)
class Sphere(GeometricObject):
    radius: float = 0.0

    def __init__(self, radius=0.0, material=None, center=None):
        self.radius = float(radius)
        self._init_common(material, center)

    def inside(self, pts):
        c = np.array(tuple(_v3(self.center)))
        d = pts - c
        return (d ** 2).sum(-1) <= self.radius ** 2

    def normal_at(self, pts):
        c = np.array(tuple(_v3(self.center)))
        d = pts - c
        r = np.sqrt(np.maximum((d ** 2).sum(-1, keepdims=True), 1e-300))
        return d / r


@dataclasses.dataclass(init=False)
class Block(GeometricObject):
    size: Vector3 = dataclasses.field(default_factory=Vector3)
    e1: Vector3 = dataclasses.field(default_factory=lambda: Vector3(1, 0, 0))
    e2: Vector3 = dataclasses.field(default_factory=lambda: Vector3(0, 1, 0))
    e3: Vector3 = dataclasses.field(default_factory=lambda: Vector3(0, 0, 1))

    def __init__(self, size=None, e1=None, e2=None, e3=None,
                 material=None, center=None):
        self.size = size if size is not None else Vector3()
        self.e1 = e1 if e1 is not None else Vector3(1, 0, 0)
        self.e2 = e2 if e2 is not None else Vector3(0, 1, 0)
        self.e3 = e3 if e3 is not None else Vector3(0, 0, 1)
        self._init_common(material, center)

    def inside(self, pts):
        c = np.array(tuple(_v3(self.center)))
        d = pts - c
        size = np.array(tuple(_v3(self.size)))
        ok = np.ones(pts.shape[:-1], dtype=bool)
        for ei, s in zip((self.e1, self.e2, self.e3), size):
            e = np.array(tuple(_v3(ei)), dtype=np.float64)
            e = e / np.linalg.norm(e)
            proj = (d * e).sum(-1)
            half = s / 2 if s != float("inf") else np.inf
            ok &= np.abs(proj) <= half + 1e-12
        return ok

    def normal_at(self, pts):
        # nearest face: the finite axis with the least distance to its face
        c = np.array(tuple(_v3(self.center)))
        d = pts - c
        size = np.array(tuple(_v3(self.size)))
        best = np.full(pts.shape[:-1], np.inf)
        normal = np.zeros(pts.shape[:-1] + (3,))
        for ei, s in zip((self.e1, self.e2, self.e3), size):
            if s == float("inf"):
                continue
            e = np.array(tuple(_v3(ei)), dtype=np.float64)
            e = e / np.linalg.norm(e)
            proj = (d * e).sum(-1)
            dist = np.abs(s / 2 - np.abs(proj))
            closer = dist < best
            best = np.where(closer, dist, best)
            sgn = np.where(proj >= 0, 1.0, -1.0)
            normal = np.where(closer[..., None], sgn[..., None] * e, normal)
        return normal if np.isfinite(best).any() else None
