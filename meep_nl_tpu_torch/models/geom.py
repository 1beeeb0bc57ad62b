"""Geometry and material scene objects (analog of python/geom.py).

The port's own copy of the subset of ``meep_nl_tpu/models/geom.py`` that
this slice needs: `Vector3`, `Matrix`, `Medium` (eps/mu with the
off-diagonal epsilon entries, conductivities, susceptibilities, chi2/chi3
with `chi2_full_tensor`; the frequency evaluator `m.epsilon(f)`,
`transform` and `rotate`), the Lorentzian and gyrotropic susceptibility
families, and the `Sphere`, `Cylinder` and `Block` primitives.  Objects
are pure descriptions; rasterization onto Yee sites happens in
models.scene.
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


@dataclasses.dataclass
class GyrotropicLorentzianSusceptibility(LorentzianSusceptibility):
    """A Lorentzian pole precessing about `bias` (python/geom.py;
    gyrotropic_susceptibility, susceptibility.cpp:445)."""
    bias: Vector3 = dataclasses.field(default_factory=Vector3)


@dataclasses.dataclass
class GyrotropicDrudeSusceptibility(GyrotropicLorentzianSusceptibility):
    """Gyrotropic free-carrier pole (python/geom.py)."""
    drude: bool = True


@dataclasses.dataclass
class GyrotropicSaturatedSusceptibility(GyrotropicLorentzianSusceptibility):
    """Linearized Landau-Lifshitz-Gilbert gyrotropy (python/geom.py;
    susceptibility.cpp:519 GYROTROPIC_SATURATED): `frequency` is the
    Larmor precession frequency, `gamma` the off-diagonal loss rate,
    `alpha` the diagonal (Gilbert) loss factor; `bias` sets the precession
    axis only (its magnitude is ignored: the medium is saturated)."""
    alpha: float = 0.0
    saturated: bool = True


# ---------------------------------------------------------------------------
# Medium
# ---------------------------------------------------------------------------


class _MediumEval(float):
    """A scalar medium parameter that is also the frequency evaluator:
    `m.epsilon` is the instantaneous float in arithmetic, `m.epsilon(f)`
    the full dispersive complex tensor (python/geom.py Medium.epsilon /
    Medium.mu):

        eps(f) = eps_inst + sum_j sigma_j f_j^2/(f_j^2 - f^2 - i f g_j)
                 (Drude: -f^2 - i f g denominator) + i sigma_cond / f
    """

    def __new__(cls, value, medium=None, kind="e"):
        o = super().__new__(cls, value)
        o._medium = medium
        o._kind = kind
        return o

    def __call__(self, freq):
        m = self._medium
        if self._kind == "e":
            return m._epsmu(m.eps_diag_vec(), m.epsilon_offdiag,
                            m.E_susceptibilities, m.cond_diag_vec(), freq)
        b = Vector3(m.B_conductivity, m.B_conductivity, m.B_conductivity)
        return m._epsmu(m.mu_diag_vec(), None, m.H_susceptibilities, b,
                        freq)


@dataclasses.dataclass
class Medium:
    """Material description (python/geom.py:Medium).

    epsilon/mu may be scalars or diagonal Vector3, with the off-diagonal
    epsilon entries (xy, xz, yz) in epsilon_offdiag.  chi2/chi3 are the
    scalar nonlinear susceptibilities;
    chi2_full_tensor selects the fork's Newton-Raphson coupled solve
    (zinc-blende chi2, newton_raphson.cpp)."""
    epsilon: float = 1.0
    epsilon_diag: Optional[Vector3] = None
    epsilon_offdiag: Optional[Vector3] = None    # (xy, xz, yz) entries
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
        self.epsilon = _MediumEval(self.epsilon, self, "e")
        self.mu = _MediumEval(self.mu, self, "h")

    def eps_diag_vec(self) -> Vector3:
        if self.epsilon_diag is not None:
            return _v3(self.epsilon_diag)
        return Vector3(self.epsilon, self.epsilon, self.epsilon)

    def mu_diag_vec(self) -> Vector3:
        if self.mu_diag is not None:
            return _v3(self.mu_diag)
        return Vector3(self.mu, self.mu, self.mu)

    def cond_diag_vec(self) -> Vector3:
        return Vector3(self.D_conductivity, self.D_conductivity,
                       self.D_conductivity)

    def _epsmu(self, diag, offdiag, sus, cond, freq) -> np.ndarray:
        fr = np.atleast_1d(np.asarray(freq, np.float64))
        out = np.zeros((len(fr), 3, 3), np.complex128)
        dv = tuple(diag)
        for i in range(3):
            out[:, i, i] = dv[i]
        if offdiag is not None:
            ov = _v3(offdiag)
            out[:, 0, 1] = out[:, 1, 0] = ov.x
            out[:, 0, 2] = out[:, 2, 0] = ov.y
            out[:, 1, 2] = out[:, 2, 1] = ov.z
        for s in sus:
            sv = tuple(s.sigma_vec())
            f0, g = s.frequency, s.gamma
            if getattr(s, "drude", False):
                chi = f0 ** 2 / (-fr ** 2 - 1j * fr * g)
            else:
                chi = f0 ** 2 / (f0 ** 2 - fr ** 2 - 1j * fr * g)
            for i in range(3):
                out[:, i, i] += sv[i] * chi
        cv = tuple(cond)
        for i in range(3):
            out[:, i, i] += 1j * cv[i] / np.where(fr == 0, np.inf, fr)
        return out[0] if np.isscalar(freq) else out

    def transform(self, m):
        """Transform epsilon, mu and the susceptibilities' sigmas by the
        3x3 matrix M: chi -> M chi M^T / |det M| (python/geom.py
        Medium.transform, transformation optics)."""
        M = np.asarray(m.m if hasattr(m, "m") else m, float).reshape(3, 3)
        det = abs(np.linalg.det(M))

        def xf(diag, offdiag):
            d = tuple(diag)
            o = tuple(_v3(offdiag)) if offdiag is not None else (0, 0, 0)
            chi = np.array([[d[0], o[0], o[1]],
                            [o[0], d[1], o[2]],
                            [o[1], o[2], d[2]]], float)
            t = M @ chi @ M.T / det
            return (Vector3(t[0, 0], t[1, 1], t[2, 2]),
                    Vector3(t[0, 1], t[0, 2], t[1, 2]))
        ed, eo = xf(self.eps_diag_vec(), self.epsilon_offdiag)
        self.epsilon_diag, self.epsilon_offdiag = ed, eo
        self.epsilon = _MediumEval(1.0, self, "e")   # the tensor is in diag
        md, _mo = xf(self.mu_diag_vec(), None)
        self.mu_diag = md
        self.mu = _MediumEval(1.0, self, "h")
        for s in list(self.E_susceptibilities) + \
                list(self.H_susceptibilities):
            sd, so = xf(s.sigma_vec(), getattr(s, "sigma_offdiag", None))
            s.sigma_diag = sd
            if hasattr(s, "sigma_offdiag"):
                s.sigma_offdiag = so
        return self

    def rotate(self, axis, theta):
        """Rotate the material tensors about `axis` by `theta` radians
        (python/geom.py Medium.rotate)."""
        return self.transform(get_rotation_matrix(axis, theta))


class Matrix:
    """3x3 matrix of column vectors (python/geom.py Matrix): products with
    matrices, vectors and scalars, inverse, transpose, determinant."""

    def __init__(self, c1=Vector3(), c2=Vector3(), c3=Vector3(),
                 diag=None, offdiag=None):
        if diag is not None:
            d = _v3(diag)
            o = _v3(offdiag) if offdiag is not None else Vector3()
            self.m = np.array([[d.x, o.x, o.y],
                               [o.x, d.y, o.z],
                               [o.y, o.z, d.z]], float)
        else:
            self.m = np.array([list(_v3(c1)), list(_v3(c2)),
                               list(_v3(c3))], float).T

    @property
    def c1(self):
        return Vector3(*self.m[:, 0])

    @property
    def c2(self):
        return Vector3(*self.m[:, 1])

    @property
    def c3(self):
        return Vector3(*self.m[:, 2])

    def __mul__(self, other):
        if isinstance(other, Matrix):
            out = Matrix()
            out.m = self.m @ other.m
            return out
        if isinstance(other, Vector3) or (
                isinstance(other, (tuple, list)) and len(other) == 3):
            return Vector3(*(self.m @ np.asarray(list(_v3(other)))))
        out = Matrix()
        out.m = self.m * float(other)
        return out

    def inverse(self):
        out = Matrix()
        out.m = np.linalg.inv(self.m)
        return out

    def transpose(self):
        out = Matrix()
        out.m = self.m.T
        return out

    def determinant(self):
        return float(np.linalg.det(self.m))

    def row(self, i):
        return Vector3(*self.m[i])

    def __repr__(self):
        return f"Matrix({self.m!r})"


def get_rotation_matrix(axis, theta) -> Matrix:
    """Rotation by angle theta (radians) about `axis` (python/geom.py
    get_rotation_matrix; Rodrigues form)."""
    a = np.asarray(list(_v3(axis)), float)
    n = np.linalg.norm(a)
    if n == 0:
        raise ValueError("zero rotation axis")
    a = a / n
    K = np.array([[0, -a[2], a[1]],
                  [a[2], 0, -a[0]],
                  [-a[1], a[0], 0]])
    R = np.eye(3) + math.sin(theta) * K + (1 - math.cos(theta)) * (K @ K)
    out = Matrix()
    out.m = R
    return out


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

    def bbox(self):
        """(lo, hi): per slot (x, y, z) bounds that hold every point
        `inside` admits (infinite where unbounded), or None; the scene
        tests an object only on the grid points in its box."""
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

    def bbox(self):
        return _box_around(self.center, [self.radius] * 3)


@dataclasses.dataclass(init=False)
class Cylinder(GeometricObject):
    """A right circular cylinder about `axis` (default z), infinitely tall
    unless `height` is given (python/geom.py Cylinder)."""
    radius: float = 0.0
    height: float = float("inf")
    axis: Vector3 = dataclasses.field(default_factory=lambda: Vector3(0, 0, 1))

    def __init__(self, radius=0.0, height=float("inf"), axis=None,
                 material=None, center=None):
        self.radius = float(radius)
        self.height = height
        self.axis = axis if axis is not None else Vector3(0, 0, 1)
        self._init_common(material, center)

    def _split(self, pts):
        """(axial coordinate, perpendicular offset) of each point."""
        c = np.array(tuple(_v3(self.center)))
        a = np.array(tuple(_v3(self.axis)), dtype=np.float64)
        a = a / np.linalg.norm(a)
        d = pts - c
        z = (d * a).sum(-1)
        return z, d - z[..., None] * a, a

    def inside(self, pts):
        z, perp, _ = self._split(pts)
        ok = (perp ** 2).sum(-1) <= self.radius ** 2
        if self.height != float("inf"):
            ok &= np.abs(z) <= self.height / 2
        return ok

    def bbox(self):
        a = np.abs(np.array(tuple(_v3(self.axis)), dtype=np.float64))
        a = a / np.linalg.norm(a)
        h = self.height / 2
        if np.count_nonzero(a) == 1:        # along a coordinate axis
            return _box_around(self.center, [h if v else self.radius
                                             for v in a])
        return _box_around(self.center, [self.radius + h] * 3)

    def normal_at(self, pts):
        # the side wall's radial normal, or the nearer end cap's axial one
        z, perp, a = self._split(pts)
        r = np.sqrt(np.maximum((perp ** 2).sum(-1), 1e-300))
        lat = perp / r[..., None]
        if self.height == float("inf"):
            return lat
        lat_dist = np.abs(r - self.radius)
        cap_dist = np.abs(self.height / 2 - np.abs(z))
        cap = np.where(z >= 0, 1.0, -1.0)[..., None] * a
        return np.where((lat_dist <= cap_dist)[..., None], lat, cap)


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

    def bbox(self):
        half = np.zeros(3)
        for ei, sz in zip((self.e1, self.e2, self.e3),
                          tuple(_v3(self.size))):
            e = np.array(tuple(_v3(ei)), dtype=np.float64)
            e = np.abs(e / np.linalg.norm(e))
            with np.errstate(invalid="ignore"):
                half = half + np.where(e > 0, e * (sz / 2 + 1e-12), 0.0)
        return _box_around(self.center, half)

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


def _box_around(center, half):
    """(lo, hi) of `center` +- `half` per slot, widened by a relative 1e-9
    so that no rounding of a point or the centre puts an inside point out
    of it."""
    c = np.array(tuple(_v3(center)), dtype=np.float64)
    half = np.asarray(half, dtype=np.float64)
    pad = 1e-9 * (1.0 + np.abs(c) + np.where(np.isfinite(half), half, 0.0))
    return c - half - pad, c + half + pad


def interpolate(n: int, nums) -> list:
    """Insert n linearly interpolated values between each pair of `nums`
    (Vector3s or numbers; the reference's geom.py:998, Meep's
    python/simulation.py interpolate): the k-point paths of band
    diagrams."""
    out = []
    items = list(nums)
    for a, b in zip(items[:-1], items[1:]):
        va = np.asarray(list(_v3(a)) if isinstance(a, Vector3) else
                        np.atleast_1d(a), float)
        vb = np.asarray(list(_v3(b)) if isinstance(b, Vector3) else
                        np.atleast_1d(b), float)
        for i in range(n + 1):
            v = va + (vb - va) * (i / (n + 1))
            out.append(Vector3(*v) if isinstance(a, Vector3)
                       else (v[0] if v.size == 1 else v))
    out.append(items[-1])
    return out
