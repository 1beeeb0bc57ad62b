"""Step-plan compiler: materials + grid + boundaries -> coefficient dict.

The port's own copy of ``meep_nl_tpu/stepper/plan.py`` (``compile_plan``
and the Spec dataclasses).  Both packages compile identical plans for
identical inputs; the only difference is that the coefficients here are
torch tensors on the plan's device (the JAX package materialises them with
``jnp.asarray``).

  * `specs`  - static Python structure controlling which branches of the
               update run (the analog of step_generic.cpp's special-casing).
  * `coefs`  - a dict of tensors (PML vectors, inverse-epsilon rows, masks,
               source indices, ...) on ``plan.device``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from ..core import grid as G
from ..core.device import resolve_device, torch_dtype

# ---------------------------------------------------------------------------
# Specs provided by the scene layer (models/)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PolSpec:
    """One dispersive susceptibility (lorentzian/drude family).

    Mirrors susceptibility.cpp:188 `lorentzian_susceptibility::update_P`:
        P_next = g1inv * (P*(2 - w0^2 dt^2 [unless drude]) - g1*P_prev
                  + w0^2 dt^2 * (sigma.W))
    with g1inv = 1/(1 + pi*gamma*dt), g1 = 1 - pi*gamma*dt.
    """
    field_type: str                      # 'e' or 'h'
    omega0: float
    gamma: float
    # sigma rows: {(comp, direction): array at comp sites}; only entries
    # that exist are stored. Diagonal entry (c, dir(c)) drives the update.
    sigma: Dict[Tuple[str, str], np.ndarray]
    drude: bool = False                  # no_omega_0_denominator
    kind: str = "lorentzian"             # | noisy | gyrotropic | multilevel
    noise_amp: float = 0.0
    bias: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # saturated (linearized Landau-Lifshitz-Gilbert) gyrotropy
    # (susceptibility.cpp:519): bias is the unit precession axis,
    # gyro_alpha the Gilbert damping
    gyro_alpha: float = 0.0
    saturated: bool = False
    # multilevel-atom parameters (multilevel-atom.cpp; meep.hpp:340):
    #   L levels, T transitions; Gamma (L,L) relaxation/pumping matrix;
    #   N0 (L,) initial populations; alpha (L,T) transition couplings;
    #   omega/gamma_t (T,) transition frequencies/linewidths;
    #   sigmat (T,3) per-direction transition strengths
    ml_Gamma: Any = None
    ml_N0: Any = None
    ml_alpha: Any = None
    ml_omega: Any = None
    ml_gamma: Any = None
    ml_sigmat: Any = None


@dataclasses.dataclass
class MaterialSpec:
    """Static material coefficient fields sampled at Yee sites."""
    # inverse-eps (E comps) / inverse-mu (H comps) rows:
    # chi1inv[c][d] -> array at c sites (None => kronecker delta row)
    chi1inv: Dict[str, Dict[str, Optional[np.ndarray]]]
    cond: Dict[str, Optional[np.ndarray]] = dataclasses.field(default_factory=dict)
    chi2: Dict[str, Optional[np.ndarray]] = dataclasses.field(default_factory=dict)
    chi3: Dict[str, Optional[np.ndarray]] = dataclasses.field(default_factory=dict)
    # full-tensor chi2 solved by vectorized Newton (the fork's NR path,
    # newton_raphson.cpp + step_generic.cpp:732):
    nr_chi2: Dict[str, Optional[np.ndarray]] = dataclasses.field(default_factory=dict)
    pols: List[PolSpec] = dataclasses.field(default_factory=list)

    def get_chi1inv(self, c: str, d: str) -> Optional[np.ndarray]:
        return self.chi1inv.get(c, {}).get(d)


@dataclasses.dataclass
class PMLSpec:
    """A uPML layer (analog of boundary_region / pml(), meep.hpp:651)."""
    direction: str            # axis direction name
    thickness: float
    side: int = 0             # -1 low, +1 high, 0 both
    r_asymptotic: float = 1e-15
    mean_stretch: float = 1.0
    pml_profile_power: float = 2.0
    pml_profile: Any = None   # arbitrary profile u in [0,1] -> weight
    #                           (python PML(pml_profile=...)); overrides
    #                           the power law when given


@dataclasses.dataclass
class SrcVolSpec:
    """Discretized source region: (component, indices, complex amplitudes).

    The analog of src_vol (meep_internals.hpp:49): `indices` are (npts, ndim)
    integer site indices of `component`, `amps` the interpolation-weighted
    complex amplitudes.  The time profile is factored out into per-step
    waveform tables by `build_xs`.
    """
    component: str            # e or h component ('ez', ...)
    indices: np.ndarray       # (npts, ndim) int32
    amps: np.ndarray          # (npts,) complex
    src_time: Any             # models.source.SourceTime
    is_integrated: bool = False


@dataclasses.dataclass
class DftSpec:
    """One DTFT accumulator region (analog of dft_chunk, dft.cpp:265).

    Accumulates sum_t exp(i w t_c) * scale * w * f_centered over a box of
    centered-grid points, where t_c is the E-time (t+1)*dt or H-time
    (t+0.5)*dt and scale = dt/sqrt(2 pi) * decimation.
    """
    name: str
    component: str
    # slices into the *centered* index lattice, one (start, stop) per axis
    region: Tuple[Tuple[int, int], ...]
    weights: np.ndarray       # integration weights, shape = region extents
    freqs: np.ndarray         # (nfreq,)
    scale: complex = 1.0
    decimation: int = 1
    #: True: region indexes the centered lattice with Yee->center averaging
    #: (use_centered_grid); False: the component's own Yee lattice (the
    #: near2far convention, add_dft(..., centered_grid=false))
    centered: bool = True


# ---------------------------------------------------------------------------
# Compiled per-component update specs (static)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CurlSpec:
    """step_db for one D/B component (step_db.cpp:44)."""
    c: str                    # 'dz' / 'bx' ...
    ec: str                   # paired E/H component
    g_plus: Optional[str]
    plus_axis: Optional[int]
    g_minus: Optional[str]
    minus_axis: Optional[int]
    is_d: bool                # D: backward diffs & +curl; B: forward & -curl
    dsig_axis: Optional[int]  # PML direction cycle(d_c,1) if sigma there
    dsigu_axis: Optional[int]
    has_cond: bool
    # --- cylindrical extras (step_db.cpp:86-294) ---
    #: the curl partner whose phi-derivative becomes the i*m/r term, and the
    #: sign it enters the curl with (+ for the plus slot, - for minus)
    phi_comp: Optional[str] = None
    phi_sign: float = 0.0
    #: z components: the radial derivative is (1/r) d(r g)/dr
    r_weighted: bool = False
    #: (lo_n, hi_n) site counts where the dsig / dsigu PML chains are
    #: non-identity; aux updates are exactly slab-local outside
    dsig_slabs: Optional[Tuple[int, int]] = None
    dsigu_slabs: Optional[Tuple[int, int]] = None
    #: conductivity folded into the chain1 coefs (the JAX package's
    #: ops/pallas/condfold; not yet ported):
    #: the kap/sig/siginv arrays are NOT identity outside dsig_slabs, so
    #: chain1 must run full-grid, and sources mirror into f_u (the inner
    #: chain is value-dependent at the conductive sites)
    folded_cond: bool = False


@dataclasses.dataclass
class EhSpec:
    """update_eh / step_update_EDHB for one E/H component
    (update_eh.cpp:67, step_generic.cpp:576)."""
    ec: str
    dc: str
    d_ec: str
    # off-diagonal chi1inv partners (dc_1/dc_2 with cycle directions):
    d1: str
    d2: str
    dc1: Optional[str]        # None if that component doesn't exist
    dc2: Optional[str]
    ax_own: Optional[int]     # array axis of d_ec (None if not an axis)
    ax_1: Optional[int]
    ax_2: Optional[int]
    has_u: bool
    has_u1: bool
    has_u2: bool
    has_chi3: bool            # Pade Kerr branch (calc_nonlinear_u)
    has_nr: bool              # fork's full-tensor chi2 Newton branch
    dsigw_axis: Optional[int]
    trivial: bool             # E aliases D (no transform needed)
    dsigw_slabs: Optional[Tuple[int, int]] = None


@dataclasses.dataclass
class Plan:
    gv: G.GridVolume
    courant: float
    dtype: Any
    complex_fields: bool
    periodic: Tuple[bool, ...]
    bloch_phase: Tuple[complex, ...]     # exp(+i k.L) per axis
    #: field storage shape: gv.shape padded per-axis (pad_to_multiple);
    #: the padded region is dead (masked zero)
    storage_shape: Tuple[int, ...]
    curl_specs_b: List[CurlSpec]
    curl_specs_d: List[CurlSpec]
    eh_specs_h: List[EhSpec]
    eh_specs_e: List[EhSpec]
    pol_specs_e: List[PolSpec]
    pol_specs_h: List[PolSpec]
    sources: List[SrcVolSpec]
    dfts: List[DftSpec]
    have_fmp_e: bool
    have_fmp_h: bool
    coefs: Dict[str, Any]                # tensors on `device` (compile_plan)
    #: cylindrical azimuthal number (exp(i m phi) dependence); 0 otherwise
    m: float = 0.0
    #: BFAST fixed-angle broadband scaled-k vector (the fork's machinery,
    #: step_generic.cpp:339 step_bfast); None = off
    bfast_k: Any = None
    #: per-component plane-zero mask representation: {c: [(axis, index), ...]}
    #: or None when the mask is not expressible as dead planes (then the
    #: full multiply is used)
    mask_planes: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: slab-local PML chains: outside the sigma slabs the aux recurrences
    #: are the identity (fu==f, E==u*D inductively), so chain updates touch
    #: only the slab slices.  Mathematically exact; the hybrid driver sets
    #: it, and the K1 kernel implements the same specialization.
    slab_opt: bool = False
    #: plane-zero masks via dynamic-update-slice (same aliasing caveat)
    plane_masks: bool = False
    #: the JAX package's round-1 half-step kernels (fused.py); kept for
    #: plan parity, not read by the port
    use_pallas: bool = False
    #: slab-stored stepper (stepper/slabstep.py): PML aux fields live only
    #: on their sigma slabs, E/H are the only full arrays; silently falls
    #: back to the uniform path outside the supported envelope
    slab_store: bool = False
    #: real-pair complex fields (a leading (re, im) channel axis); kept
    #: for plan parity, not supported by the port's stepper yet
    real_pair: bool = False
    #: nonzero-support bounding boxes per material-coefficient key (pol
    #: sigma rows, nrchi2, chi3/chi2), recorded at compile time so the
    #: fused kernels can specialize without device reads: {key: ((lo,
    #: hi), ...) per axis} or {key: None} for empty support
    support_boxes: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: C2 rotational symmetry fold (vec.hpp:1189-1232 rotate2): the cell
    #: is halved along `fold_ax` with the rotation axis plane at site 0;
    #: the stepper's backward differences across that plane read the C2
    #: ghost parity * flip(plane, flip_ax).  (fold_ax, flip_ax,
    #: w_letter, phase) or None
    rot2: Optional[Tuple[Any, ...]] = None
    #: C4 rotational symmetry fold (vec.hpp:1189-1232 rotate4): the cell
    #: is QUARTERED (both axes perpendicular to the rotation axis halved,
    #: rotation axis at their shared 0 corner); backward differences
    #: across either fold plane read the 90-degree-rotated ghost — a
    #: direct (unflipped) transposed read of the x<->y-SWAPPED component
    #: at the reflected source row, with the rotation-matrix sign.
    #: (ax1, ax2, w_letter, phase) or None
    rot4: Optional[Tuple[Any, ...]] = None
    #: node-aligned mirror folds (vec.hpp:1189 mirror_symmetry with the
    #: plane ON a whole grid site, i.e. phase=+1 on an even cell count):
    #: the cell is halved along each (ax, d_letter, phase) with the plane
    #: at site 0 and NO wall; backward differences across the plane read
    #: the mirror ghost phase * mirror_parity(g, d) * g[1 - yee_shift].
    #: Half-offset-plane (+1/odd) and metal-node (-1/even) mirrors keep
    #: the wall-mask implementation and do not appear here.
    mirror_node: Tuple[Tuple[Any, ...], ...] = ()
    #: 2D out-of-plane wavenumber (the reference's special_kz / kz_2d,
    #: fields.cpp beta): fields carry an exact e^{i beta z} dependence,
    #: so every dropped z-derivative curl term becomes the constant
    #: i*beta coupling (the cylindrical i*m/r machinery with a constant
    #: coefficient).  Forces complex (or real-pair) fields.
    beta: float = 0.0
    #: the torch device every coefficient tensor lives on
    device: Any = None

    @property
    def dt(self) -> float:
        return self.courant * self.gv.dx


# ---------------------------------------------------------------------------
# PML profile construction (structure.cpp:625-688)
# ---------------------------------------------------------------------------


def _pml_x(i: int, dx: float, bloc: float, a: float) -> float:
    """Quantized depth into the PML at half-pixel index i
    (structure.cpp:625 `pml_x`)."""
    here = i * 0.5 / a
    return 0.5 / a * (int(dx * 2 * a + 0.5) - int(abs(bloc - here) * 2 * a + 0.5))


def build_pml_arrays(gv: G.GridVolume, pmls: Sequence[PMLSpec], dt: float
                     ) -> Dict[str, Dict[str, np.ndarray]]:
    """Half-index sig/kap/siginv profiles per direction.

    Returns {direction: {'sig': (2N+2,), 'kap': ..., 'siginv': ...}} for
    directions that have PML; mirrors structure_chunk::use_pml
    (structure.cpp:630-688): sig = 0.5*dt*prefac*profile(u),
    kap = 1 + kappa_prefac*profile(u)*u, siginv = 1/(kap+sig),
    prefac = -ln(R)/(4*dx_pml*int profile), kappa smoother by one power.
    """
    out: Dict[str, Dict[str, np.ndarray]] = {}
    a = gv.resolution
    for spec in pmls:
        d = spec.direction
        if d not in gv.axes:
            raise ValueError(f"PML direction {d} not in grid axes {gv.axes}")
        ax = gv.axis_of(d)
        n = gv.num[ax]
        if d not in out:
            spml = 2 * n + 2
            out[d] = {
                "sig": np.zeros(spml),
                "kap": np.ones(spml),
                "siginv": np.ones(spml),
            }
        pw = spec.pml_profile_power
        prof_fn = getattr(spec, "pml_profile", None)
        if prof_fn is not None:
            # arbitrary user profile (python/simulation.py pml_profile):
            # normalizing integrals by fine-grid quadrature, matching the
            # reference's adaptive quadrature of profile(u) on [0, 1]
            uu = np.linspace(0.0, 1.0, 4097)
            pv = np.array([float(prof_fn(u)) for u in uu])
            profile_integral = float(np.trapezoid(pv, uu))
            profile_integral_u = float(np.trapezoid(pv * uu, uu))
            if profile_integral <= 0:
                raise ValueError("pml_profile must have positive integral")
            if profile_integral_u <= 0:
                profile_integral_u = profile_integral
        else:
            profile_integral = 1.0 / (pw + 1.0)
            profile_integral_u = 1.0 / (pw + 2.0)
        prefac = (-math.log(spec.r_asymptotic)) / (4 * spec.thickness * profile_integral)
        kappa_prefac = (spec.mean_stretch - 1) / profile_integral_u
        sides = [-1, +1] if spec.side == 0 else [spec.side]
        lo = 0.0                       # grid-local coordinate of low edge
        hi = n * gv.dx
        for side in sides:
            bloc = lo if side < 0 else hi
            for i in range(0, 2 * n + 2):
                x = _pml_x(i, spec.thickness, bloc, a)
                if x > 0:
                    u = x / spec.thickness
                    s = float(prof_fn(u)) if prof_fn is not None \
                        else u ** pw
                    out[d]["sig"][i] = 0.5 * dt * prefac * s
                    out[d]["kap"][i] = 1 + kappa_prefac * s * u
                    out[d]["siginv"][i] = 1.0 / (out[d]["kap"][i] + out[d]["sig"][i])
    return out


def _sample_pml_vec(full: np.ndarray, n: int, sh: int) -> np.ndarray:
    """Sample a half-index PML profile at component sites: k = 2*i + sh."""
    idx = 2 * np.arange(n + 1) + sh
    idx = np.clip(idx, 0, len(full) - 1)
    return full[idx]


def _bcast(vec: np.ndarray, axis: int, ndim: int) -> np.ndarray:
    """Reshape a per-axis vector for broadcasting against full-shape arrays."""
    shape = [1] * ndim
    shape[axis] = -1
    return vec.reshape(shape)


# ---------------------------------------------------------------------------
# Plan compilation
# ---------------------------------------------------------------------------


def compile_plan(
    gv: G.GridVolume,
    mat: MaterialSpec,
    pmls: Sequence[PMLSpec] = (),
    periodic: Optional[Sequence[bool]] = None,
    bloch_k: Optional[Sequence[float]] = None,   # k in units of 2pi/a (meep k_point)
    sources: Sequence[SrcVolSpec] = (),
    dfts: Sequence[DftSpec] = (),
    courant: float = 0.5,
    dtype=np.float32,
    complex_fields: Optional[bool] = None,
    live_e: Optional[Sequence[str]] = None,
    live_h: Optional[Sequence[str]] = None,
    pad_to_multiple: Any = 1,
    m: float = 0.0,
    bfast_scaled_k=None,
    boundaries=None,   # {(dir_letter, 'low'|'high'): 'metal'|'magnetic'}
    rot2=None,         # (fold_ax, flip_ax, w_ax, phase) C2 fold (Plan.rot2)
    rot4=None,         # (ax1, ax2, w_ax, phase) C4 fold (Plan.rot4)
    mirror_node=(),    # ((ax, d_letter, phase), ...) node-plane mirrors
    beta: float = 0.0,  # 2D out-of-plane wavenumber (special_kz, Plan.beta)
    device=None,       # torch device of the coefficients; None = cuda
) -> Plan:
    dev = resolve_device(device)
    mm = m
    ndim = gv.ndim
    if isinstance(pad_to_multiple, int):
        pad_to_multiple = (pad_to_multiple,) * ndim
    storage_shape = tuple(
        -(-s // m) * m for s, m in zip(gv.shape, pad_to_multiple))
    pad_amount = tuple(ss - s for ss, s in zip(storage_shape, gv.shape))

    def _pad_full(arr: np.ndarray, fill: str = "edge") -> np.ndarray:
        """Pad a full-shape coefficient array into the dead storage margin."""
        if not any(pad_amount):
            return arr
        pw = [(0, p) for p in pad_amount]
        if fill == "zero":
            return np.pad(arr, pw)
        return np.pad(arr, pw, mode="edge")
    periodic = tuple(periodic) if periodic is not None else (False,) * ndim
    if bloch_k is None:
        bloch_k = (0.0,) * ndim
    def _phase(ax, k):
        if not periodic[ax]:
            return 1.0
        ph = complex(np.exp(1j * 2 * np.pi * k * gv.size[ax]))
        # keep purely-real phases (k=0 or half-integer) as floats so the
        # wrap multiply doesn't promote real fields to complex
        if abs(ph.imag) < 1e-12:
            return float(ph.real)
        return ph

    bloch_phase = tuple(_phase(ax, k) for ax, k in enumerate(bloch_k))
    if bfast_scaled_k is not None and not any(bfast_scaled_k):
        bfast_scaled_k = None
    if bfast_scaled_k is not None:
        # BFAST tightens the CFL bound: the s*dH/dt terms add to the
        # update's spectral radius, shrinking the stable Courant factor by
        # roughly (1 - max|scaled_k|) (Liang et al.; observed empirically:
        # s=0.5 blows up at courant 0.5, stable at <=0.35 in 2D)
        smax = max(abs(float(s)) for s in bfast_scaled_k)
        climit = (1.0 - smax) / np.sqrt(gv.ndim)
        if smax >= 1.0:
            raise ValueError(f"bfast_scaled_k magnitude {smax} >= 1 "
                             "(|sin(theta)| must be < 1)")
        if courant > climit + 1e-9:
            raise ValueError(
                f"BFAST with max|scaled_k|={smax} needs Courant <= "
                f"(1-|s|)/sqrt(D) = {climit:.3f}; got {courant} "
                "(pass Courant=... to Simulation)")
    if beta != 0.0 and gv.dim != "2d":
        raise ValueError("beta (special_kz) applies to 2D cells only")
    if complex_fields is None:
        complex_fields = any(isinstance(ph, complex) for ph in bloch_phase) \
            or (gv.dim == "cyl" and mm != 0) or (bfast_scaled_k is not None) \
            or beta != 0.0

    dt = courant * gv.dx
    dtdx = courant
    if beta != 0.0:
        # stability: the i*beta coupling adds beta^2 to the curl
        # operator's squared norm (fields.cpp beta / special_kz):
        # dt <= 2 / sqrt(sum_i (2/dx_i)^2 + beta^2)
        wmax = float(np.sqrt(ndim * (2.0 / gv.dx) ** 2 + beta ** 2))
        if dt > 2.0 / wmax * (1.0 - 1e-9):
            raise ValueError(
                f"Courant {courant} unstable with kz beta={beta:g}: need "
                f"courant <= {2.0 / wmax / gv.dx:.4f}")

    # ------- which components are live ------------------------------------
    if live_e is None:
        live_e = _infer_live(gv, mat, sources, dfts, "e")
    if live_h is None:
        live_h = _infer_live(gv, mat, sources, dfts, "h")
    live_e, live_h = list(live_e), list(live_h)

    pml_full = build_pml_arrays(gv, pmls, dt)

    def sigsize_gt1(d: str) -> bool:
        return d in pml_full

    def slab_extents(d: str, sh: int) -> Tuple[int, int]:
        """(lo_n, hi_n): number of sites with nonzero sigma from each end
        of axis d at component sites with half-offset sh. The PML chain is
        the identity elsewhere (kappa=1, sigma=0), so aux-field updates are
        exactly slab-local."""
        nax = gv.num[gv.axis_of(d)]
        vec = _sample_pml_vec(pml_full[d]["sig"], nax, sh)
        kapv = _sample_pml_vec(pml_full[d]["kap"], nax, sh)
        live = (vec != 0) | (kapv != 1)
        n = len(live)
        lo = 0
        while lo < n and live[lo]:
            lo += 1
        hi = 0
        while hi < n and live[n - 1 - hi]:
            hi += 1
        if lo + hi >= n:   # PML covers everything; no interior
            return (n, 0)
        return (lo, hi)

    coefs: Dict[str, Any] = {}
    mask_planes: Dict[str, Any] = {}

    # per-axis bounding boxes of nonzero support, recorded at numpy stage
    # for material coefficients the fused kernels specialize on
    support_boxes: Dict[str, Any] = {}

    def put(key: str, arr, as_dtype=None, fill: str = "edge",
            support: bool = False) -> str:
        arr = np.asarray(arr)
        if arr.shape == gv.shape:
            arr = _pad_full(arr, fill)
        elif arr.ndim == ndim and any(
                arr.shape[ax] == gv.shape[ax] and pad_amount[ax] for ax in range(ndim)):
            # broadcastable per-axis vector: pad its long axis
            pw = [(0, pad_amount[ax]) if arr.shape[ax] == gv.shape[ax] else (0, 0)
                  for ax in range(ndim)]
            arr = np.pad(arr, pw, mode="edge")
        if support:
            nz = np.nonzero(np.asarray(arr) != 0)
            if len(nz[0]) == 0:
                support_boxes[key] = None            # empty support
            else:
                support_boxes[key] = tuple(
                    (int(ix.min()), int(ix.max()) + 1) for ix in nz)
        # contiguous: the kernels index these tensors by flat offsets (the
        # .real/.imag of a complex array are strided views)
        coefs[key] = torch.as_tensor(
            np.ascontiguousarray(arr, dtype=as_dtype or dtype),
            dtype=torch_dtype(as_dtype or dtype), device=dev)
        return key

    # ------- masks ---------------------------------------------------------
    for c in list(live_e) + list(live_h) + ["d" + c[1] for c in live_e] + \
            ["b" + c[1] for c in live_h]:
        mk = gv.metal_mask(c, periodic, boundaries)
        # periodic axes: ghost plane N is dead
        for ax in range(ndim):
            if periodic[ax]:
                idx = [slice(None)] * ndim
                idx[ax] = gv.num[ax]
                mk[tuple(idx)] = 0.0
        if gv.dim == "cyl" and abs(gv.origin[gv.axis_of(G.R)]) < 1e-12:
            # r=0 axis conditions (step_db.cpp:296-457): zero the components
            # the reference zeroes per m; |m|>=2 additionally zeroes the
            # first |m| rings for numerical stability (the zero-near-origin
            # hack documented at step_db.cpp:414-436)
            rax = gv.axis_of(G.R)
            d_c = G.component_direction(c)
            ftc = c[0]
            zero_rings = 0
            if mm == 0:
                if (ftc in "de" and d_c == G.P) or \
                        (ftc in "bh" and d_c == G.R):
                    zero_rings = 1
            elif abs(mm) == 1:
                if (ftc in "de" and d_c == G.Z):
                    zero_rings = 1
            else:
                if (ftc in "de" and d_c in (G.P, G.Z)) or \
                        (ftc in "bh" and d_c == G.R):
                    zero_rings = int(abs(mm))
            if zero_rings and G.yee_shift(c, gv.dim)[G.R] == 0:
                idx = [slice(None)] * ndim
                idx[rax] = slice(0, zero_rings)
                mk[tuple(idx)] = 0.0
        put(f"mask:{c}", mk, fill="zero")
        # plane-zero representation of the same mask: cheaper than a full
        # multiply when the mask is all-ones except axis-aligned slabs
        planes = []
        full = _pad_full(mk, "zero")
        ok_planes = True
        probe = np.ones_like(full)
        for ax in range(ndim):
            nax = full.shape[ax]
            other = [a for a in range(ndim) if a != ax]
            flat = full.min(axis=tuple(other)) if other else full
            flat_max = full.max(axis=tuple(other)) if other else full
            for i in range(nax):
                if flat_max[i] == 0.0:     # whole plane dead
                    planes.append((ax, i))
                    idxp = [slice(None)] * ndim
                    idxp[ax] = i
                    probe[tuple(idxp)] = 0.0
        if not np.array_equal(probe, full):
            ok_planes = False
        mask_planes[c] = planes if ok_planes else None

    # ------- curl (step_db) specs ------------------------------------------
    is_cyl = gv.dim == "cyl"

    def make_curl_specs(ft: str) -> List[CurlSpec]:
        specs = []
        live = live_e if ft == "d" else live_h
        for fc in live:
            c = ft + fc[1]
            plan = gv.step_plan(c)
            d_c = G.component_direction(c)
            dsig_d = G.cycle_direction(gv.dim, d_c, 1)
            dsigu_d = G.cycle_direction(gv.dim, d_c, 2)
            dsig_axis = gv.axis_of(dsig_d) if (gv.has_direction(dsig_d) and sigsize_gt1(dsig_d)) else None
            dsigu_axis = gv.axis_of(dsigu_d) if (gv.has_direction(dsigu_d) and sigsize_gt1(dsigu_d)) else None
            cnd = mat.cond.get(c)
            has_cond = cnd is not None
            ys = G.yee_shift(c, gv.dim)
            # cylindrical: pull phi-derivative partners out of the curl plan
            # (the i*m/r terms, step_db.cpp:178) and mark the z component's
            # (1/r) d(r g)/dr radial derivative (step_db.cpp:94-119)
            phi_comp, phi_sign, r_weighted = None, 0.0, False
            if is_cyl:
                if plan.plus is not None and plan.plus_dir == G.P:
                    phi_comp, phi_sign = plan.plus, +1.0
                    plan = dataclasses.replace(plan, plus=None, plus_dir=None)
                if plan.minus is not None and plan.minus_dir == G.P:
                    phi_comp, phi_sign = plan.minus, -1.0
                    plan = dataclasses.replace(plan, minus=None, minus_dir=None)
                if d_c == G.Z:
                    r_weighted = True
                # r coordinate vectors at this component's sites and at the
                # radial-partner's sites
                r_f = gv.comp_coords(c, gv.axis_of(G.R))
                rinv = np.where(np.abs(r_f) > 1e-12, 1.0 / np.where(
                    np.abs(r_f) > 1e-12, r_f, 1.0), 0.0)
                if mm != 0 and phi_comp is not None:
                    # i*m/r coefficient (times dx; dtdx multiplies later)
                    put(f"{c}:imr", _bcast(mm * gv.dx * rinv, gv.axis_of(G.R),
                                           ndim))
                if r_weighted and plan.plus is not None:
                    r_g = gv.comp_coords(plan.plus, gv.axis_of(G.R))
                    put(f"{c}:rg", _bcast(r_g, gv.axis_of(G.R), ndim))
                    put(f"{c}:rfinv", _bcast(rinv, gv.axis_of(G.R), ndim))
            if gv.dim == "2d" and beta != 0.0:
                # special_kz (the reference's kz_2d, fields.cpp beta):
                # the z dependence is exactly e^{i beta z}, so the
                # dropped d/dz curl terms become the constant i*beta
                # coupling to the OTHER in-plane transverse partner —
                # (curl H)_x = dy Hz - i*beta*Hy (minus slot),
                # (curl H)_y = i*beta*Hx - dx Hz (plus slot), and the
                # same pattern for curl E; the z components carry no
                # z-derivative.  Rides the cylindrical i*m/r machinery
                # with a constant coefficient.
                part = {"x": ("y", -1.0), "y": ("x", +1.0)}.get(c[1])
                if part is not None:
                    g_letter, psign = part
                    phi_comp = ("h" if ft == "d" else "e") + g_letter
                    phi_sign = psign
                    put(f"{c}:imr", np.float64(beta * gv.dx))
            dsig_slabs = dsigu_slabs = None
            if dsig_axis is not None:
                d = gv.axes[dsig_axis]
                sh = ys[d]
                nax = gv.num[dsig_axis]
                put(f"{c}:sig", _bcast(_sample_pml_vec(pml_full[d]["sig"], nax, sh), dsig_axis, ndim))
                put(f"{c}:kap", _bcast(_sample_pml_vec(pml_full[d]["kap"], nax, sh), dsig_axis, ndim))
                put(f"{c}:siginv", _bcast(_sample_pml_vec(pml_full[d]["siginv"], nax, sh), dsig_axis, ndim))
                dsig_slabs = slab_extents(d, sh)
            if dsigu_axis is not None:
                d = gv.axes[dsigu_axis]
                sh = ys[d]
                nax = gv.num[dsigu_axis]
                put(f"{c}:sigu", _bcast(_sample_pml_vec(pml_full[d]["sig"], nax, sh), dsigu_axis, ndim))
                put(f"{c}:kapu", _bcast(_sample_pml_vec(pml_full[d]["kap"], nax, sh), dsigu_axis, ndim))
                put(f"{c}:siginvu", _bcast(_sample_pml_vec(pml_full[d]["siginv"], nax, sh), dsigu_axis, ndim))
                dsigu_slabs = slab_extents(d, sh)
            if has_cond:
                put(f"{c}:cnd", cnd)
                put(f"{c}:cndinv", 1.0 / (1.0 + 0.5 * dt * cnd))
            if bfast_scaled_k is not None and pml_full:
                # taper the BFAST k smoothly to zero across every PML
                # depth: the deep-PML field is attenuated by e^{-2 int
                # sigma} anyway, and keeping the s*dH/dt coupling at full
                # strength there destabilizes the aux flip-flop (see
                # step._bfast_update); cos^2 ramp, 1 at the inner edge
                tap_total = None
                for d in pml_full:
                    ax = gv.axis_of(d)
                    sh = ys[d]
                    nax = gv.num[ax]
                    lo, hi = slab_extents(d, sh)
                    n_sites = len(_sample_pml_vec(pml_full[d]["sig"],
                                                  nax, sh))
                    tv = np.ones(n_sites)
                    for i in range(min(lo, n_sites)):
                        tv[i] = np.cos(0.5 * np.pi * (lo - i) / lo) ** 2
                    for i in range(min(hi, n_sites)):
                        tv[n_sites - 1 - i] = np.cos(
                            0.5 * np.pi * (hi - i) / hi) ** 2
                    tb = _bcast(tv, ax, ndim)
                    tap_total = tb if tap_total is None else tap_total * tb
                put(f"{c}:bftap", tap_total)
            specs.append(CurlSpec(
                c=c, ec=fc,
                g_plus=plan.plus,
                plus_axis=gv.axis_of(plan.plus_dir) if plan.plus else None,
                g_minus=plan.minus,
                minus_axis=gv.axis_of(plan.minus_dir) if plan.minus else None,
                is_d=(ft == "d"),
                dsig_axis=dsig_axis, dsigu_axis=dsigu_axis, has_cond=has_cond,
                phi_comp=phi_comp, phi_sign=phi_sign, r_weighted=r_weighted,
                dsig_slabs=dsig_slabs, dsigu_slabs=dsigu_slabs))
        return specs

    curl_d = make_curl_specs("d")
    curl_b = make_curl_specs("b")

    if bfast_scaled_k is not None:
        # BFAST envelope is a HARD error, not silent narrowing: the
        # s*dH/dt flip-flop is only stable when every curl has both
        # partners (the fork's supported 1D/3D-component-set mode,
        # test_refl_angular.py); a single-partner curl whose k component
        # is nonzero would silently drop a BFAST term.
        axes = gv.axes
        kidx = {"x": 0, "y": 1, "z": 2}
        for spec in curl_d + curl_b:
            single = (spec.g_plus is None) != (spec.g_minus is None)
            if not single:
                continue
            ax_have = spec.plus_axis if spec.g_plus is not None \
                else spec.minus_axis
            if abs(float(bfast_scaled_k[kidx[axes[ax_have]]])) > 0:
                raise ValueError(
                    f"BFAST: curl of {spec.c} has a single partner "
                    f"({spec.g_plus or spec.g_minus}) with a nonzero "
                    "scaled_k along its axis; this component set (e.g. 2D "
                    "TM) is outside the stable BFAST envelope -- use a 3D "
                    "cell / full component set (step_generic.cpp:339)")

    # ------- update_eh specs -------------------------------------------------
    def make_eh_specs(ft: str) -> List[EhSpec]:
        specs = []
        live = live_e if ft == "e" else live_h
        ft2 = "d" if ft == "e" else "b"
        for ec in live:
            d_ec = G.component_direction(ec)
            d1 = G.cycle_direction(gv.dim, d_ec, 1)
            d2 = G.cycle_direction(gv.dim, d_ec, 2)
            dc = ft2 + d_ec
            ec1 = ec[0] + d1
            ec2 = ec[0] + d2
            dc1 = ft2 + d1 if ec1 in live else None
            dc2 = ft2 + d2 if ec2 in live else None
            u = mat.get_chi1inv(ec, d_ec)
            u1 = mat.get_chi1inv(ec, d1) if dc1 else None
            u2 = mat.get_chi1inv(ec, d2) if dc2 else None
            chi3 = mat.chi3.get(ec)
            chi2 = mat.chi2.get(ec)
            nr = mat.nr_chi2.get(ec)
            dsigw_axis = (gv.axis_of(d_ec)
                          if (gv.has_direction(d_ec) and sigsize_gt1(d_ec)) else None)
            ys = G.yee_shift(ec, gv.dim)
            dsigw_slabs = None
            if dsigw_axis is not None:
                d = gv.axes[dsigw_axis]
                sh = ys[d]
                nax = gv.num[dsigw_axis]
                put(f"{ec}:sigw", _bcast(_sample_pml_vec(pml_full[d]["sig"], nax, sh), dsigw_axis, ndim))
                put(f"{ec}:kapw", _bcast(_sample_pml_vec(pml_full[d]["kap"], nax, sh), dsigw_axis, ndim))
                dsigw_slabs = slab_extents(d, sh)
            if u is not None:
                put(f"{ec}:u", u)
            if u1 is not None:
                put(f"{ec}:u1", u1)
            if u2 is not None:
                put(f"{ec}:u2", u2)
            if chi3 is not None:
                put(f"{ec}:chi3", chi3, support=True)
                put(f"{ec}:chi2", chi2 if chi2 is not None else np.zeros(gv.shape),
                    support=True)
            if nr is not None:
                put(f"{ec}:nrchi2", nr, support=True)
                # epsilon rows for the NR solve (inverse of diag chi1inv)
                eps = 1.0 / u if u is not None else np.ones(gv.shape)
                put(f"{ec}:nreps", eps)
            trivial = (u is None and u1 is None and u2 is None and chi3 is None
                       and nr is None and dsigw_axis is None)
            specs.append(EhSpec(
                ec=ec, dc=dc, d_ec=d_ec, d1=d1, d2=d2, dc1=dc1, dc2=dc2,
                ax_own=gv.axis_of(d_ec) if gv.has_direction(d_ec) else None,
                ax_1=gv.axis_of(d1) if gv.has_direction(d1) else None,
                ax_2=gv.axis_of(d2) if gv.has_direction(d2) else None,
                has_u=u is not None, has_u1=u1 is not None, has_u2=u2 is not None,
                has_chi3=chi3 is not None, has_nr=nr is not None,
                dsigw_axis=dsigw_axis, trivial=trivial,
                dsigw_slabs=dsigw_slabs))
        return specs

    eh_e = make_eh_specs("e")
    eh_h = make_eh_specs("h")

    # ------- susceptibilities ------------------------------------------------
    # discrete-ADE sampling guard: the leapfrog Lorentzian update's poles
    # leave the unit circle when (2 pi f0 dt) >= 2 (cf. the reference's
    # lorentzian_unstable check, susceptibility.cpp:160, disabled there as
    # "too conservative" --- at fp32 the margin matters)
    import warnings as _warnings
    for p in mat.pols:
        W = 2 * math.pi * p.omega0 * dt
        if W >= 2.0:
            raise ValueError(
                f"susceptibility pole at f0={p.omega0} is unstable at this "
                f"resolution (2 pi f0 dt = {W:.2f} >= 2); raise the "
                "resolution, use dtype=float64, or drop far-UV poles into "
                "epsilon")
        if W > 1.2 and dtype == np.float32:
            _warnings.warn(
                f"susceptibility pole at f0={p.omega0}: 2 pi f0 dt = "
                f"{W:.2f} is marginal at fp32; consider higher resolution "
                "or float64", stacklevel=2)
    pol_e = [p for p in mat.pols if p.field_type == "e"]
    pol_h = [p for p in mat.pols if p.field_type == "h"]
    for pi, p in enumerate(mat.pols):
        for (c, d), arr in p.sigma.items():
            put(f"pol{pi}:{c}:{d}", np.broadcast_to(arr, gv.shape),
                fill="zero", support=True)

    have_fmp_e = bool(pol_e) or any(s.is_integrated and s.component[0] == "e"
                                    for s in sources)
    have_fmp_h = bool(pol_h) or any(s.is_integrated and s.component[0] == "h"
                                    for s in sources)

    # ------- sources -----------------------------------------------------------
    for si, s in enumerate(sources):
        put(f"src{si}:idx", s.indices, np.int32)
        amp = np.asarray(s.amps, np.complex128)
        put(f"src{si}:amp_re", amp.real)
        put(f"src{si}:amp_im", amp.imag)
        # conductivity scaling at source points (step.cpp:300-309)
        dbc = ("d" if s.component[0] == "e" else "b") + s.component[1]
        cnd = mat.cond.get(dbc)
        if cnd is not None:
            vals = cnd[tuple(s.indices.T)]
            put(f"src{si}:cndinv", 1.0 / (1.0 + 0.5 * dt * vals))

    # ------- dft monitors --------------------------------------------------------
    for mi, mspec in enumerate(dfts):
        w = np.asarray(mspec.weights)
        if np.iscomplexobj(w):
            # complex monitor weights (LDOS conj-source weights) ship as
            # real pairs
            put(f"dft{mi}:wre", w.real)
            put(f"dft{mi}:wim", w.imag)
        else:
            put(f"dft{mi}:w", w)

    return Plan(
        gv=gv, courant=courant, dtype=dtype, complex_fields=complex_fields,
        periodic=periodic, bloch_phase=bloch_phase,
        storage_shape=storage_shape,
        curl_specs_b=curl_b, curl_specs_d=curl_d,
        eh_specs_h=eh_h, eh_specs_e=eh_e,
        pol_specs_e=pol_e, pol_specs_h=pol_h,
        sources=list(sources), dfts=list(dfts),
        have_fmp_e=have_fmp_e, have_fmp_h=have_fmp_h,
        coefs=coefs, m=mm,
        bfast_k=tuple(bfast_scaled_k) if bfast_scaled_k is not None else None,
        mask_planes=mask_planes, support_boxes=support_boxes,
        rot2=tuple(rot2) if rot2 is not None else None,
        rot4=tuple(rot4) if rot4 is not None else None,
        mirror_node=tuple(tuple(mn) for mn in mirror_node),
        beta=float(beta), device=dev)


def _infer_live(gv: G.GridVolume, mat: MaterialSpec, sources, dfts, ft: str
                ) -> List[str]:
    """Which E (or H) components must be stepped.

    The analog of fields::require_component + the step plan closure: a source
    or monitor on any component pulls in, via the two curl equations, the
    full mutually-coupled set.  We compute the closure over the curl graph.
    """
    all_e = list(gv.e_components)
    all_h = list(gv.h_components)
    need = set()
    for s in sources:
        need.add(s.component)
    for m in dfts:
        need.add(m.component)
    # material anisotropy couples components within a field type only through
    # the off-diagonal chi1inv rows:
    for c, rows in mat.chi1inv.items():
        for d, arr in rows.items():
            if arr is not None and d != G.component_direction(c):
                need.add(c)
                need.add(c[0] + d)
    for c in list(mat.chi2) + list(mat.chi3) + list(mat.nr_chi2):
        need.add(c)
    # gyrotropic/saturated susceptibilities precess the polarization about
    # the bias axis, coupling the two perpendicular components of their
    # field type (susceptibility.cpp:519 LLG / gyrotropic update): if any
    # component with such a pole is live, its partners must be stepped too
    for p in getattr(mat, "pols", []):
        if p.kind != "gyrotropic" and not p.saturated:
            continue
        for (c, _d) in p.sigma:
            need.add(c)
            for d in "xyz":
                need.add(c[0] + d)
    if not need:
        need = set(all_e + all_h)
    # closure over curl relations
    changed = True
    live = set(c for c in need if c in all_e + all_h)
    while changed:
        changed = False
        for c in list(live):
            dbc = ("d" if c[0] == "e" else "b") + c[1]
            plan = gv.step_plan(dbc)
            for g in (plan.plus, plan.minus):
                if g is not None and g not in live:
                    live.add(g)
                    changed = True
    if ft == "e":
        return [c for c in all_e if c in live]
    return [c for c in all_h if c in live]
