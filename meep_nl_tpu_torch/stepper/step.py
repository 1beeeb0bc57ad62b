"""The FDTD timestep as a plain PyTorch `state -> state` function.

The torch counterpart of ``meep_nl_tpu/stepper/step.py`` for the
Cartesian subset (1D, 2D and 3D cells, real or complex fields): the eager
stepper is the plain version
of the whole step and the port's own oracle (the K1, K2 and resident
kernels in ops/ are held against it).  Reference mapping, as in the JAX package:

  * fields::step ordering          -> `make_step` (step.cpp:35-140)
  * step_curl + PML chain          -> `_curl_update` (step_generic.cpp:69-253)
  * step_update_EDHB               -> `_eh_update` (step_generic.cpp:576-906)
  * Pade Kerr factor               -> `_nonlinear_u` (step_generic.cpp:546)
  * fork's chi2 Newton-Raphson     -> `_nr_solve` (newton_raphson.cpp:93)
  * fork's BFAST step_bfast        -> `_bfast_update` (step_generic.cpp:339)
  * lorentzian_susceptibility::update_P -> `_pol_update_lorentzian`
  * dft_chunk::update_dft          -> `_dft_update` (dft.cpp:265-306)
  * step_source                    -> `_apply_sources` (step.cpp:296-319)
  * get_field time series          -> `run(..., probes=...)`, `ProbeSpec`

The state is a dict of tensors: {"f", "f_u", "f_cond", "f_w": {comp:
tensor}, "pol": [{"p": {...}, "pp": {...}}], "dft": {name: (..., nfreq,
2)}, "t": int}, and for a BFAST plan "f_bfast": {comp: tensor}, the
flip-flop auxiliary of each curl component with both partners.  The step
is functional (it returns new tensors and leaves its input untouched),
like the JAX stepper it mirrors.

Complex fields (plan.complex_fields: a complex Bloch phase, or
Simulation(force_complex_fields=True)) come in the reference's two
storages (step.py:38-60, :134-160): native complex64, and the real pair
(plan.real_pair), where every field, auxiliary and polarization carries
a leading (re, im) channel axis and all arithmetic stays real -- the
coefficients are real, so the channels evolve apart except where the
Bloch wrap multiplies by a complex phase (`_sh`: a 2x2 rotation of the
channels) and where a complex source current enters (`_apply_sources`).
The DTFT accumulators and the step tables are real in both.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..core import grid as G
from ..core.device import torch_dtype
from ..ops.stencil import shift
from .plan import CurlSpec, EhSpec, Plan, PolSpec

#: fixed Newton iteration count of the chi2 solve (the JAX package's
#: `_nr_iters` default, step.py:108): from the perturbative seed, 3
#: quadratic steps reach r^16 in r = chi2 E / eps, below fp32 roundoff
NR_ITERS = 3


def check_supported(plan: Plan) -> None:
    """Raise NotImplementedError for plan features outside this slice,
    naming the ROADMAP item that brings each."""
    gv = plan.gv
    why = None
    if gv.dim == "cyl" or plan.m or plan.beta:
        why = "cylindrical / special_kz cells (ROADMAP A9)"
    elif any(s.has_cond or s.folded_cond
             for s in plan.curl_specs_d + plan.curl_specs_b):
        why = "conductivity (ROADMAP A6)"
    elif any(s.has_u1 or s.has_u2 for s in plan.eh_specs_e + plan.eh_specs_h):
        why = "off-diagonal epsilon/mu (ROADMAP A9)"
    elif any(s.is_integrated for s in plan.sources):
        why = "integrated sources (ROADMAP A9)"
    elif gv.dim == "1d" and any(s.has_nr for s in plan.eh_specs_e):
        # the neighbour averages of the Newton step run along the
        # component's own direction, which is no grid axis in 1D (the
        # reference's step fails there with a TypeError, ROADMAP C.3)
        why = "full-tensor chi2 in 1D cells (ROADMAP A9)"
    else:
        for p in plan.pol_specs_e + plan.pol_specs_h:
            if p.kind != "lorentzian":
                why = f"{p.kind} susceptibilities (ROADMAP A9)"
            elif any(d != c[1] for (c, d) in p.sigma):
                why = "off-diagonal susceptibility sigma (ROADMAP A9)"
    if why is not None:
        raise NotImplementedError(f"the torch stepper does not run {why} yet")


def _is_pair(plan: Plan) -> bool:
    """Complex fields in real-pair storage: a leading (re, im) channel axis
    on every field, auxiliary and polarization array (step.py:38-43)."""
    return bool(plan.real_pair and plan.complex_fields)


def _off(plan: Plan, arr) -> int:
    """Leading axes of `arr` before the grid's (the pair's channel)."""
    return arr.ndim - plan.gv.ndim


def _sh(plan: Plan, arr, axis: int, by: int):
    """Plan-bound shift: PEC zero-fill or Bloch wrap with the live extent.
    `axis` is the grid axis; a real pair's channel axis is offset here and
    takes a complex wrap phase as a rotation (step.py:46-54)."""
    off = _off(plan, arr)
    return shift(arr, axis + off, by, plan.periodic[axis],
                 plan.bloch_phase[axis], nlive=plan.gv.num[axis],
                 pair=_is_pair(plan) and off == 1)


def _apply_mask(plan: Plan, C: Dict[str, Any], c: str, arr):
    """Enforce the metal/dead-padding mask (boundaries.cpp:304 zero_metal
    analog): a full multiply when the mask is not a set of dead planes,
    else per-axis 0/1 vectors broadcast at use."""
    planes = plan.mask_planes.get(c) if plan.mask_planes else None
    if planes is None:
        return arr * C[f"mask:{c}"]
    for vec in alive_vectors(plan, c, arr.dtype, arr.device).values():
        arr = arr * vec
    return arr


def alive_vectors(plan: Plan, c: str, dtype, device) -> Dict[int, Any]:
    """{axis: 0/1 vector shaped to broadcast along that axis} whose product
    is the dead-plane mask of component c (axes without a dead plane are
    absent); cached on the plan.  The K1 kernel reads the same vectors."""
    cache = plan.__dict__.setdefault("_alive_cache", {})
    key = (c, dtype, str(device))
    if key not in cache:
        shape = tuple(plan.storage_shape or plan.gv.shape)
        by_ax: Dict[int, list] = {}
        for ax, i in plan.mask_planes.get(c) or ():
            by_ax.setdefault(ax, []).append(i)
        vecs = {}
        for ax, idxs in by_ax.items():
            alive = np.ones(shape[ax])
            alive[idxs] = 0.0
            bshape = [1] * len(shape)
            bshape[ax] = shape[ax]
            vecs[ax] = torch.as_tensor(alive.reshape(bshape), dtype=dtype,
                                       device=device)
        cache[key] = vecs
    return cache[key]


# ---------------------------------------------------------------------------
# State construction
# ---------------------------------------------------------------------------


def init_state(plan: Plan) -> Dict[str, Any]:
    """Zero fields, PML auxiliaries, polarizations and DFT accumulators;
    complex fields as complex64 (complex128 for fp64 plans) or, with
    plan.real_pair, as real pairs (2, ...) (step.py:134-160, :216).  Pair
    fields refuse multilevel atoms and chi2/chi3 media, as the
    reference's do; the accumulators are real in every storage."""
    check_supported(plan)
    shape = tuple(plan.storage_shape or plan.gv.shape)
    dtype = torch_dtype(plan.dtype)
    acc_dtype = dtype
    fshape = shape
    if _is_pair(plan):
        if any(p.kind == "multilevel"
               for p in plan.pol_specs_e + plan.pol_specs_h):
            raise NotImplementedError(
                "multilevel atoms with real-pair complex fields")
        if any(s.has_chi3 or s.has_nr
               for s in plan.eh_specs_e + plan.eh_specs_h):
            raise NotImplementedError(
                "nonlinear media require real fields (as in the reference)")
        fshape = (2,) + shape
    elif plan.complex_fields:
        dtype = torch.complex128 if plan.dtype == np.float64 \
            else torch.complex64

    def zeros(s=fshape):
        return torch.zeros(s, dtype=dtype, device=plan.device)

    f = {}
    for spec in plan.curl_specs_d + plan.curl_specs_b:
        f[spec.c] = zeros()
    for spec in plan.eh_specs_e + plan.eh_specs_h:
        f[spec.ec] = zeros()
    f_u = {s.c: zeros() for s in plan.curl_specs_d + plan.curl_specs_b
           if s.dsigu_axis is not None}
    f_w = {s.ec: zeros() for s in plan.eh_specs_e + plan.eh_specs_h
           if s.dsigw_axis is not None}
    pol = []
    for p in plan.pol_specs_e + plan.pol_specs_h:
        comps = sorted({c for (c, d) in p.sigma if d == G.component_direction(c)})
        pol.append({"p": {c: zeros() for c in comps},
                    "pp": {c: zeros() for c in comps}})
    dft = {}
    for m in plan.dfts:
        ext = tuple(b - a for a, b in m.region)
        dft[m.name] = torch.zeros(ext + (len(m.freqs), 2), dtype=acc_dtype,
                                  device=plan.device)
    out = {"f": f, "f_u": f_u, "f_cond": {}, "f_w": f_w, "pol": pol,
           "dft": dft, "t": 0}
    if plan.bfast_k is not None:
        # the flip-flop auxiliary of every curl with both partners, the
        # only ones _bfast_update steps (step.py:174-176 makes one for
        # every curl; the others stay zero there)
        out["f_bfast"] = {s.c: zeros() for s in bfast_specs(plan)}
    return out


# ---------------------------------------------------------------------------
# Update pieces
# ---------------------------------------------------------------------------


def mirror_ghost(gname: str, d_letter: str, phase: int, dim: str):
    """(k0, sign) of the node-mirror fold ghost of component `gname` for a
    mirror in direction `d_letter` (step.py:251 `_mirror_node_ghost`,
    vec.hpp:1189 mirror_symmetry): a backward difference across a mirror
    plane that lies on the whole sites at index 0 reads, below plane 0,

        g(-1) = sign * g(k0),   sign = phase * P_g(d)

    with P_g the vector / pseudovector parity (E_d and H_t odd, E_t and H_d
    even).  k0 is 1 - yee_shift: a half-offset component's plane 0 sits at
    +dx/2 and reflects onto -dx/2 (k0 = 0), a node component's plane 1
    reflects onto -dx (k0 = 1).  The kernels read the same table."""
    if gname[0] in ("e", "d"):
        sign = phase * (-1.0 if gname[1] == d_letter else 1.0)
    else:
        sign = phase * (1.0 if gname[1] == d_letter else -1.0)
    return 1 - G.yee_shift(gname, dim)[d_letter], float(sign)


def rot2_ghost(gname: str, plan: Plan):
    """(k0, sign, nl) of the C2-fold ghost of component `gname` (step.py:
    277 `_rot2_ghost`, vec.hpp:1189-1232 rotate2): a backward difference
    along the fold axis across the rotation-axis plane at site 0 reads,
    below plane 0,

        g(-1, j) = sign * g(k0, nl - 1 - j)   (j < nl; 0 beyond)

    with sign = phase * (+1 if g points along the rotation axis, else -1)
    (a proper rotation: E and H alike), k0 = 1 - yee_shift along the fold
    axis and the flip over the live flip-axis extent nl = num + (1 if g
    has no offset along the flip axis).  The kernels read the same
    table."""
    fold_ax, flip_ax, w_letter, phase = plan.rot2
    gv = plan.gv
    ys = G.yee_shift(gname, gv.dim)
    sign = float(phase) * (1.0 if gname[1] == w_letter else -1.0)
    nl = gv.num[flip_ax] + (1 if ys[gv.axes[flip_ax]] == 0 else 0)
    return 1 - ys[gv.axes[fold_ax]], sign, nl


def rot4_ghost(gname: str, a: int, plan: Plan):
    """(g2, k0, sign, other) of the C4-fold ghost of component `gname`
    across the fold plane of axis `a` (step.py:308 `_rot4_ghost`,
    vec.hpp:1189-1232 rotate4): with R the quarter turn taking ax1 into
    ax2, the ghost below plane 0 of `a` is a transposed read of the
    x<->y-swapped component g2 at row k0 = 1 - yee_shift(g, a) of the
    other folded axis:

        ghost(index j along `other`) = sign * g2(index j along a, k0
                                                 along other)

    with the rotation-matrix signs (-p, +p, +p) of (F_ax1, F_ax2, F_w)
    for the ax1 ghost and (+p, -p, +p) for the ax2 ghost."""
    ax1, ax2, w_letter, phase = plan.rot4
    gv = plan.gv
    l1, l2 = gv.axes[ax1], gv.axes[ax2]
    g2 = gname[0] + {l1: l2, l2: l1}.get(gname[1], gname[1])
    if gname[1] == w_letter or (gname[1] == l1) != (a == ax1):
        sign = float(phase)
    else:
        sign = -float(phase)
    k0 = 1 - G.yee_shift(gname, gv.dim)[gv.axes[a]]
    return g2, k0, sign, (ax2 if a == ax1 else ax1)


def _curl(plan: Plan, spec: CurlSpec, f: Dict[str, Any]):
    """dfl such that the no-PML update is f += dfl (step_generic.cpp:39-67).

    D components: +Courant * (bwd-diff g_plus - bwd-diff g_minus)
    B components: -Courant * (fwd-diff g_plus - fwd-diff g_minus)

    A fold through a plane on whole sites replaces the zero fill of the
    backward difference along its axis by the fold ghost, plane 0 of the
    shifted array (step.py:361-391): a node-aligned mirror's
    (plan.mirror_node, `mirror_ghost`), C2's (plan.rot2, `rot2_ghost`) or
    C4's (plan.rot4, `rot4_ghost`); nothing else of the step reads across
    the plane."""

    def diff(g, a, gname):
        if not spec.is_d:
            return _sh(plan, g, a, +1) - g
        sh = _sh(plan, g, a, -1)
        ghost = None
        o = _off(plan, g)                      # a real pair's channel axis
        ga = a + o
        for (ax, d, phase) in plan.mirror_node:
            if ax == a:
                k0, sign = mirror_ghost(gname, d, phase, plan.gv.dim)
                ghost = sign * g.narrow(ga, k0, 1)
        if plan.rot2 is not None and a == plan.rot2[0]:
            k0, sign, nl = rot2_ghost(gname, plan)
            fl = plan.rot2[1] + o
            rev = torch.flip(g.narrow(ga, k0, 1).narrow(fl, 0, nl), (fl,))
            pad = [0, 0] * (g.ndim - 1 - fl) + [0, g.shape[fl] - nl]
            ghost = sign * torch.nn.functional.pad(rev, pad)
        if plan.rot4 is not None and a in plan.rot4[:2]:
            g2, k0, sign, other = rot4_ghost(gname, a, plan)
            ghost = sign * f[g2].narrow(other + o, k0, 1).transpose(
                ga, other + o)
        if ghost is not None:
            sh = torch.cat([ghost, sh.narrow(ga, 1, sh.shape[ga] - 1)],
                           dim=ga)
        return g - sh

    total = None
    if spec.g_plus is not None:
        total = diff(f[spec.g_plus], spec.plus_axis, spec.g_plus)
    if spec.g_minus is not None:
        t2 = diff(f[spec.g_minus], spec.minus_axis, spec.g_minus)
        total = -t2 if total is None else total - t2
    if total is None:
        return torch.zeros_like(f[spec.c])
    sgn = 1.0 if spec.is_d else -1.0
    return sgn * plan.courant * total


def _slab_slices(slabs, axis: int, n_sites: int, ndim: int):
    """Storage slices of the lo/hi sigma slabs along `axis`."""
    lo, hi = slabs
    out = []
    if lo > 0:
        sl = [slice(None)] * ndim
        sl[axis] = slice(0, lo)
        out.append(tuple(sl))
    if hi > 0:
        sl = [slice(None)] * ndim
        sl[axis] = slice(n_sites - hi, n_sites)
        out.append(tuple(sl))
    return out


def _vsl(vec, sl):
    """Slice a broadcast coefficient only along the axes it extends."""
    return tuple(s if vec.shape[i] > 1 else slice(None)
                 for i, s in enumerate(sl))


def _curl_update(plan: Plan, C: Dict[str, Any], spec: CurlSpec,
                 state: Dict[str, Any]) -> Dict[str, Any]:
    """The PML chain around a curl delta (step_generic.cpp:89-253):
    dfl -> [dsig: f or fu] -> [dsigu: f].

    With plan.slab_opt the chains run only on the sigma slabs: outside them
    kappa=1/sigma=0 makes the chain the identity and fu==f inductively, so
    f_u stays zero there (the K1 kernel implements the same rule)."""
    c = spec.c
    f = state["f"][c]
    dfl = _curl(plan, spec, state["f"])
    new_state = state
    has_sig = spec.dsig_axis is not None
    has_sigu = spec.dsigu_axis is not None
    if has_sig:
        kap, sig, siginv = C[f"{c}:kap"], C[f"{c}:sig"], C[f"{c}:siginv"]
    if has_sigu:
        kapu, sigu, siginvu = (C[f"{c}:kapu"], C[f"{c}:sigu"],
                               C[f"{c}:siginvu"])

    # (a real pair's channel axis leads the field arrays' slices; the
    # reference runs its pairs on the full-grid chains, step.py:458, which
    # give the same fields)
    if plan.slab_opt and (has_sig or has_sigu):
        ndim = plan.gv.ndim
        lead = (slice(None),) * _off(plan, f)
        base = f + dfl
        if has_sig:
            n_sites = plan.gv.num[spec.dsig_axis] + 1
            for sl in _slab_slices(spec.dsig_slabs, spec.dsig_axis,
                                   n_sites, ndim):
                k, fs = _vsl(kap, sl), lead + sl
                base[fs] = ((kap[k] - sig[k]) * f[fs] + dfl[fs]) * siginv[k]
        if has_sigu:
            fu_full = state["f_u"][c]
            new_fu = fu_full.clone()
            n_sites = plan.gv.num[spec.dsigu_axis] + 1
            for sl in _slab_slices(spec.dsigu_slabs, spec.dsigu_axis,
                                   n_sites, ndim):
                ku, fs = _vsl(kapu, sl), lead + sl
                fu_old = fu_full[fs]
                if has_sig:
                    k = _vsl(kap, sl)
                    fu_new = ((kap[k] - sig[k]) * fu_old + dfl[fs]) * siginv[k]
                else:
                    fu_new = fu_old + dfl[fs]
                base[fs] = siginvu[ku] * ((kapu[ku] - sigu[ku]) * f[fs]
                                          + fu_new - fu_old)
                new_fu[fs] = fu_new
            new_state = {**new_state, "f_u": {**state["f_u"], c: new_fu}}
        f_new = _apply_mask(plan, C, c, base)
        return {**new_state, "f": {**new_state["f"], c: f_new}}

    def inner_update(g):
        if has_sig:
            return ((kap - sig) * g + dfl) * siginv
        return g + dfl

    if has_sigu:
        fu = state["f_u"][c]
        fu_new = inner_update(fu)
        f_new = siginvu * ((kapu - sigu) * f + fu_new - fu)
        new_state = {**new_state, "f_u": {**new_state["f_u"], c: fu_new}}
    else:
        f_new = inner_update(f)
    f_new = f_new * C[f"mask:{c}"]
    return {**new_state, "f": {**new_state["f"], c: f_new}}


def bfast_specs(plan: Plan):
    """The curl specs with both partners: BFAST's (step.py:560-567)."""
    return [s for s in plan.curl_specs_d + plan.curl_specs_b
            if s.g_plus is not None and s.g_minus is not None]


def bfast_ks(plan: Plan, spec: CurlSpec):
    """(k1, k2) of BFAST's two terms of a two-partner curl spec: the scaled
    k along each partner's differentiation axis, negated for the D family
    (step.py:568-572); both zero: no term."""
    kidx = {"x": 0, "y": 1, "z": 2}
    axes = plan.gv.axes
    k1 = plan.bfast_k[kidx[axes[spec.plus_axis]]]
    k2 = plan.bfast_k[kidx[axes[spec.minus_axis]]]
    return (-k1, -k2) if spec.is_d else (k1, k2)


def _bfast_update(plan: Plan, C: Dict[str, Any], spec: CurlSpec,
                  state: Dict[str, Any]) -> Dict[str, Any]:
    """BFAST fixed-angle broadband terms (the fork's step_bfast,
    step_generic.cpp:339-537; the reference's step.py:543-641), after the
    curl update of `spec`.

    The flip-flop auxiliary F multiplies by i tan(w dt / 2), an effective
    transverse k_x(w) = scaled_k w, which makes oblique incidence
    broadband at a fixed angle: A = (k1 pair(g+) - k2 pair(g-)) bftap,
    F_new = A - gam F_prev, and delta = F_new - F_prev goes through the PML
    chains into f (and f_u), additively like step_beta.  pair(g) is g plus
    its neighbour along the partner's axis (below it for D, above for B),
    shifted as the curl shifts (the Bloch wrap, zero off the grid).  gam is
    the per-site decay the fields see, (kap - sig) / (kap + sig) of each
    chain, or of the component's E/H W chain where it has none ({ec}:sigw),
    1 elsewhere.  Only two-partner curls take the terms, as in the
    reference.  Conductivity is refused (ROADMAP A6), so the reference's
    has_cond branches are not here.  Both storages: the real pair's
    channels alike (their wrap read through _sh)."""
    if plan.bfast_k is None:
        return state
    if spec.g_plus is None or spec.g_minus is None:
        return state
    k1, k2 = bfast_ks(plan, spec)
    if k1 == 0.0 and k2 == 0.0:
        return state
    c = spec.c

    def pair(g, a):
        if spec.is_d:
            return g + _sh(plan, g, a, -1)
        return _sh(plan, g, a, +1) + g

    f = state["f"]
    A = 0.0
    if k1 != 0.0:
        A = A + k1 * pair(f[spec.g_plus], spec.plus_axis)
    if k2 != 0.0:
        A = A - k2 * pair(f[spec.g_minus], spec.minus_axis)
    if f"{c}:bftap" in C:
        A = A * C[f"{c}:bftap"]
    F_prev = state["f_bfast"][c]
    gam = None
    if spec.dsig_axis is not None:
        gam = (C[f"{c}:kap"] - C[f"{c}:sig"]) * C[f"{c}:siginv"]
    if spec.dsigu_axis is not None:
        g2 = (C[f"{c}:kapu"] - C[f"{c}:sigu"]) * C[f"{c}:siginvu"]
        gam = g2 if gam is None else gam * g2
    if gam is None:
        ec = ("e" if c[0] == "d" else "h") + c[1]
        if f"{ec}:sigw" in C:
            gam = (C[f"{ec}:kapw"] - C[f"{ec}:sigw"]) \
                / (C[f"{ec}:kapw"] + C[f"{ec}:sigw"])
    F_new = A - (gam * F_prev if gam is not None else F_prev)
    delta = F_new - F_prev
    new_state = {**state, "f_bfast": {**state["f_bfast"], c: F_new}}
    if spec.dsig_axis is not None:
        delta = delta * C[f"{c}:siginv"]
    if spec.dsigu_axis is not None:
        fu = new_state["f_u"][c]
        new_state = {**new_state, "f_u": {**new_state["f_u"], c: fu + delta}}
        delta = delta * C[f"{c}:siginvu"]
    fc = _apply_mask(plan, C, c, f[c] + delta)
    return {**new_state, "f": {**f, c: fc}}


def _nonlinear_u(Dsqr, Di, u, chi2, chi3):
    """Pade approximant for the Kerr/chi2 scalar inversion
    (step_generic.cpp:546 calc_nonlinear_u)."""
    c2 = Di * chi2 * (u * u)
    c3 = Dsqr * chi3 * (u * u * u)
    return (1 + c2 + 2 * c3) / (1 + 2 * c2 + 3 * c3)


def _avg4(plan, g, ax_own, ax_off, sgn):
    """gs_2-style neighbor average (step_generic.cpp:740)."""
    g_s = _sh(plan, g, ax_own, sgn)
    g_x = _sh(plan, g, ax_off, -sgn)
    g_sx = _sh(plan, g_s, ax_off, -sgn)
    return 0.25 * (g + g_s + g_x + g_sx)


def _sum4(plan, g, ax_own, ax_off, sgn):
    g_s = _sh(plan, g, ax_own, sgn)
    g_x = _sh(plan, g, ax_off, -sgn)
    g_sx = _sh(plan, g_s, ax_off, -sgn)
    return g + g_s + g_x + g_sx


def _nr_solve(A_own, A_1, A_2, eps, chi2, seed_own, seed_1, seed_2):
    """Vectorized Newton for the zinc-blende chi2 system
    (newton_raphson.cpp:144 `equations`):

        A_own = eps*x + chi2*y*z
        A_1   = eps*y + chi2*x*z
        A_2   = eps*z + chi2*x*y

    NR_ITERS Newton iterations with an analytic 3x3 solve from the
    first-order perturbative seed x0 = (A - chi2 y0 z0)/eps.  Where
    chi2 == 0, returns the seeds."""
    ueff = 1.0 / torch.where(eps == 0, 1.0, eps)
    sx = A_own * ueff
    sy = A_1 * ueff
    sz = A_2 * ueff
    cu = chi2 * ueff
    x = sx - cu * sy * sz
    y = sy - cu * sx * sz
    z = sz - cu * sx * sy
    aa = eps * eps
    for _ in range(NR_ITERS):
        F1 = A_own - (eps * x + chi2 * y * z)
        F2 = A_1 - (eps * y + chi2 * x * z)
        F3 = A_2 - (eps * z + chi2 * x * y)
        # M = [[a, b, c], [b, a, d], [c, d, a]] (J = -M, symmetric)
        a, b_, c_, d_ = eps, chi2 * z, chi2 * y, chi2 * x
        b2, c2, d2 = b_ * b_, c_ * c_, d_ * d_
        det = a * (aa - b2 - c2 - d2) + 2.0 * (b_ * c_ * d_)
        det = torch.where(det.abs() < 1e-30, 1e-30, det)
        rdet = 1.0 / det
        i00 = aa - d2
        i01 = c_ * d_ - b_ * a
        i02 = b_ * d_ - c_ * a
        i11 = aa - c2
        i12 = c_ * b_ - a * d_
        i22 = aa - b2
        dx = (i00 * F1 + i01 * F2 + i02 * F3) * rdet
        dy = (i01 * F1 + i11 * F2 + i12 * F3) * rdet
        dz = (i02 * F1 + i12 * F2 + i22 * F3) * rdet
        x, y, z = x + dx, y + dy, z + dz
    live = chi2 != 0
    return (torch.where(live, x, seed_own), torch.where(live, y, seed_1),
            torch.where(live, z, seed_2))


def _eh_update(plan: Plan, C: Dict[str, Any], spec: EhSpec,
               state: Dict[str, Any], dmp: Dict[str, Any]) -> Dict[str, Any]:
    """E = chi1inv*(D - P) with Kerr Pade, the NR chi2 branch, and the PML
    W chain (step_generic.cpp:576-906)."""
    ec = spec.ec
    sgn = 1 if ec[0] == "e" else -1  # H strides negated (update_eh.cpp:192)
    gs = dmp[spec.dc]
    us = C[f"{ec}:u"] if spec.has_u else None
    lin = gs * us if us is not None else gs

    if spec.has_chi3:
        u_for_nl = us if us is not None else 1.0
        Dsqr = gs * gs
        if spec.dc1 is not None and spec.ax_1 is not None:
            g1s = _sum4(plan, dmp[spec.dc1], spec.ax_own, spec.ax_1, sgn)
            Dsqr = Dsqr + 0.0625 * (g1s * g1s)
        if spec.dc2 is not None and spec.ax_2 is not None:
            g2s = _sum4(plan, dmp[spec.dc2], spec.ax_own, spec.ax_2, sgn)
            Dsqr = Dsqr + 0.0625 * (g2s * g2s)
        lin = lin * _nonlinear_u(Dsqr, gs, u_for_nl, C[f"{ec}:chi2"],
                                 C[f"{ec}:chi3"])

    if spec.has_nr:
        # neighbor-averaged partner (D-P) values at ec sites
        # (step_generic.cpp:740-743)
        g_1 = _avg4(plan, dmp[spec.dc1], spec.ax_own, spec.ax_1, sgn) \
            if spec.dc1 is not None else torch.zeros_like(gs)
        g_2 = _avg4(plan, dmp[spec.dc2], spec.ax_own, spec.ax_2, sgn) \
            if spec.dc2 is not None else torch.zeros_like(gs)
        chi2 = C[f"{ec}:nrchi2"]
        u_lin = us if us is not None else 1.0
        own, _, _ = _nr_solve(gs, g_1, g_2, C[f"{ec}:nreps"], chi2,
                              state["f"][ec], g_1 * u_lin, g_2 * u_lin)
        lin = torch.where(chi2 != 0, own, lin)

    new_state = state
    has_pols = bool(plan.pol_specs_e if ec[0] == "e" else plan.pol_specs_h)
    if spec.dsigw_axis is not None:
        kapw, sigw = C[f"{ec}:kapw"], C[f"{ec}:sigw"]
        fw = state["f_w"][ec]
        f_old = state["f"][ec]
        if plan.slab_opt and spec.dsigw_slabs is not None and not has_pols:
            # outside the sigma_w slab E == u*D inductively (the W chain
            # copies lin); only the slabs need the chain and the fw storage
            f_new = lin.clone()
            new_fw = fw.clone()
            n_sites = plan.gv.num[spec.dsigw_axis] + 1
            lead = (slice(None),) * _off(plan, lin)
            for sl in _slab_slices(spec.dsigw_slabs, spec.dsigw_axis,
                                   n_sites, plan.gv.ndim):
                k, fs = _vsl(kapw, sl), lead + sl
                f_new[fs] = (f_old[fs] + (kapw[k] + sigw[k]) * lin[fs]
                             - (kapw[k] - sigw[k]) * fw[fs])
                new_fw[fs] = lin[fs]
        else:
            f_new = f_old + (kapw + sigw) * lin - (kapw - sigw) * fw
            new_fw = lin
        new_state = {**new_state, "f_w": {**state["f_w"], ec: new_fw}}
    else:
        f_new = lin
    f_new = _apply_mask(plan, C, ec, f_new)
    return {**new_state, "f": {**new_state["f"], ec: f_new}}


def _pol_update_lorentzian(plan: Plan, C: Dict[str, Any], pi: int,
                           p: PolSpec, state: Dict[str, Any]
                           ) -> Dict[str, Any]:
    """Lorentzian/Drude ADE leapfrog (susceptibility.cpp:188-260), diagonal
    sigma rows."""
    dt = plan.dt
    w2pi = 2 * math.pi * p.omega0
    g2pi = 2 * math.pi * p.gamma
    omega0dtsqr = (w2pi * dt) ** 2
    gamma1inv = 1.0 / (1 + 0.5 * g2pi * dt)
    gamma1 = 1 - 0.5 * g2pi * dt
    denom = 0.0 if p.drude else omega0dtsqr
    pol_st = state["pol"][pi]
    new_p = dict(pol_st["p"])
    new_pp = dict(pol_st["pp"])
    for c in pol_st["p"]:
        W = state["f_w"].get(c, state["f"].get(c))
        drive = C[f"pol{pi}:{c}:{c[1]}"] * W
        pcur = pol_st["p"][c]
        pprev = pol_st["pp"][c]
        new_p[c] = gamma1inv * (pcur * (2 - denom) - gamma1 * pprev
                                + omega0dtsqr * drive)
        new_pp[c] = pcur
    pols = list(state["pol"])
    pols[pi] = {"p": new_p, "pp": new_pp}
    return {**state, "pol": pols}


def _compute_fmp(plan: Plan, ft: str, state: Dict[str, Any]
                 ) -> Dict[str, Any]:
    """f_minus_p = D - sum P (update_eh.cpp:119-146)."""
    ft2 = "d" if ft == "e" else "b"
    specs = plan.eh_specs_e if ft == "e" else plan.eh_specs_h
    pol_off = 0 if ft == "e" else len(plan.pol_specs_e)
    npol = len(plan.pol_specs_e if ft == "e" else plan.pol_specs_h)
    fmp = {spec.dc: state["f"][spec.dc] for spec in specs}
    for pi in range(pol_off, pol_off + npol):
        for c, parr in state["pol"][pi]["p"].items():
            dc = ft2 + c[1]
            if dc in fmp:
                fmp[dc] = fmp[dc] - parr
    return fmp


def source_index(plan: Plan, si: int):
    """Long index tuple of source si's sites (cached on the plan)."""
    cache = plan.__dict__.setdefault("_src_index_cache", {})
    if si not in cache:
        cache[si] = tuple(plan.coefs[f"src{si}:idx"].long().unbind(1))
    return cache[si]


def _apply_sources(plan: Plan, C: Dict[str, Any], ft2: str,
                   state: Dict[str, Any], xs: Dict[str, Any]
                   ) -> Dict[str, Any]:
    """Current sources into D/B: f -= current * dt (step.cpp:296-319).
    Real fields take the real part of the complex current w * amp; complex
    fields take all of it, natively or as the (re, im) channels of a real
    pair (step.py:1224-1262)."""
    f = dict(state["f"])
    dt = plan.dt
    pair = _is_pair(plan)
    for si, s in enumerate(plan.sources):
        ftc = "d" if s.component[0] == "e" else "b"
        if ftc != ft2:
            continue
        dc = ft2 + s.component[1]
        w_re, w_im = xs[f"src{si}:cur_re"], xs[f"src{si}:cur_im"]
        if plan.scatter_free:
            # dense-source mode (the resident route, ops/resident.py): the
            # amplitude pattern pre-scattered into full-grid arrays, the
            # injection a multiply-add everywhere (step.py:1228-1246)
            dre, dim_ = C[f"src{si}:dense_re"], C[f"src{si}:dense_im"]
            if pair:
                delta = torch.stack([(w_re * dre - w_im * dim_) * dt,
                                     (w_re * dim_ + w_im * dre) * dt])
            elif plan.complex_fields:
                delta = complex(w_re, w_im) * torch.complex(dre, dim_) * dt
            else:
                delta = (w_re * dre - w_im * dim_) * dt
            f[dc] = f[dc] - delta
            continue
        a_re, a_im = C[f"src{si}:amp_re"], C[f"src{si}:amp_im"]
        idx = source_index(plan, si)
        if pair:
            A_re = (w_re * a_re - w_im * a_im) * dt
            A_im = (w_re * a_im + w_im * a_re) * dt
            f[dc] = torch.stack([
                f[dc][0].index_put(idx, -A_re, accumulate=True),
                f[dc][1].index_put(idx, -A_im, accumulate=True)])
            continue
        if plan.complex_fields:
            A = complex(w_re, w_im) * torch.complex(a_re, a_im) * dt
        else:
            A = (w_re * a_re - w_im * a_im) * dt
        f[dc] = f[dc].index_put(idx, -A, accumulate=True)
    return {**state, "f": f}


def _region_values(plan: Plan, m, arr):
    """Region slice of component m.component, centered-averaged when the
    monitor asks for it (dft.cpp:277 avg1/avg2).  The average needs one
    plane past the region along each averaged axis, so only the region and
    that halo are read; the values equal averaging the full array first
    (the reference's `_centered_avg`, step.py:1281).  On a Bloch-periodic
    axis the plane past the last live one is the phase times plane 0 and
    the dead planes' neighbours are zero (`_sh`), so that axis is read
    whole and shifted as the stepper shifts it."""
    gv = plan.gv
    o = _off(plan, arr)                    # a real pair's channel axis
    if not m.centered:
        return arr[(slice(None),) * o
                   + tuple(slice(a, b) for a, b in m.region)]
    ys = G.yee_shift(m.component, gv.dim)
    avg = [ax for ax, d in enumerate(gv.axes) if ys[d] == 0]
    wrap = {ax for ax in avg if plan.periodic[ax]}
    sl = [slice(None)] * o
    for ax, (a, b) in enumerate(m.region):
        if ax in wrap:
            sl.append(slice(None))
        elif ax in avg:
            sl.append(slice(a, min(b + 1, arr.shape[ax + o])))
        else:
            sl.append(slice(a, b))
    out = arr[tuple(sl)]
    # the full-array form is out = 0.5*(out + shift(out, ax, +1)) axis by
    # axis; each pass consumes its own axis's halo plane
    for ax in avg:
        a, b = m.region[ax]
        n = b - a
        oa = ax + o
        if ax in wrap:
            out = 0.5 * (out.narrow(oa, a, n)
                         + _sh(plan, out, ax, +1).narrow(oa, a, n))
            continue
        if out.shape[oa] < n + 1:              # past the storage: zero fill
            pad = [0, 0] * out.ndim
            pad[2 * (out.ndim - 1 - oa) + 1] = 1
            out = torch.nn.functional.pad(out, pad)
        out = 0.5 * (out.narrow(oa, 0, n) + out.narrow(oa, 1, n))
    return out


def _dft_update(plan: Plan, C: Dict[str, Any], state: Dict[str, Any],
                xs: Dict[str, Any], fv_of=None) -> Dict[str, Any]:
    """DTFT accumulator update (dft.cpp:265 in-step sampling), in the real
    (re, im) pair layout: with c = w fv = cr + i ci (ci for complex
    weights, the LDOS monitors' conj(amplitude), or complex fields, native
    or a real pair's channels), acc_re += cr ph_re - ci ph_im, acc_im +=
    cr ph_im + ci ph_re (step.py:1325-1375).

    `fv_of(mi, m)` optionally supplies monitor mi's region-sliced,
    centered-averaged field values (the hybrid driver samples x-planes that
    the K2 kernel captured; `state` then only needs its "dft" entry)."""
    dft = dict(state["dft"])
    for mi, m in enumerate(plan.dfts):
        if fv_of is not None:
            fv = fv_of(mi, m)
        else:
            fv = _region_values(plan, m, state["f"][m.component])
        phr = xs[f"dft{mi}:ph_re"]
        phi = xs[f"dft{mi}:ph_im"]
        if fv.ndim > len(m.region):          # a real pair's (2, ...) slice
            fr, fi = fv[0], fv[1]
        elif fv.is_complex():
            fr, fi = fv.real, fv.imag
        else:
            fr, fi = fv, None
        wi = None
        if f"dft{mi}:w" in C:
            wr = C[f"dft{mi}:w"]
        else:
            wr, wi = C[f"dft{mi}:wre"], C[f"dft{mi}:wim"]
        cr = wr * fr
        ci = wr * fi if fi is not None else None
        if wi is not None:
            if fi is not None:
                cr = cr - wi * fi
            ci = ci + wi * fr if ci is not None else wi * fr
        if plan.dft_front:
            # frequency-major accumulators (nfreq, 2, region...), the
            # resident route's layout (step.py:1357-1371)
            shp = (-1,) + (1,) * cr.ndim
            phr, phi, cr = phr.reshape(shp), phi.reshape(shp), cr[None]
            dre, dim = phr * cr, phi * cr
            if ci is not None:
                dre = dre - phi * ci[None]
                dim = dim + phr * ci[None]
            dft[m.name] = dft[m.name] + torch.stack([dre, dim], dim=1)
            continue
        dre = cr[..., None] * phr
        dim = cr[..., None] * phi
        if ci is not None:
            dre = dre - ci[..., None] * phi
            dim = dim + ci[..., None] * phr
        dft[m.name] = dft[m.name] + torch.stack([dre, dim], dim=-1)
    return {**state, "dft": dft}


# ---------------------------------------------------------------------------
# The full step + driver
# ---------------------------------------------------------------------------


def make_step(plan: Plan, dft: bool = True,
              use_pallas: Optional[bool] = None):
    """Returns step(state, xs_t, coefs=None) -> state implementing
    fields::step (step.cpp:35-140) for one timestep.  `dft=False` leaves
    the DTFT update out.

    With plan.use_pallas (or `use_pallas=True`) a plan the fused half-step
    kernel takes (ops/fused.py `takes`) steps through it, as the
    reference's step_pallas (step.py:1467-1492): the B half, its source
    fix-up, the D half, its fix-up (on the card each half's one launch adds
    its sources), t + 1, the DTFT update.  On a CPU state
    the kernel objects run their plain versions.  `use_pallas=False` always
    gives the eager step (with dft=False, the K1 kernel's plain version)."""
    check_supported(plan)
    if plan.use_pallas if use_pallas is None else use_pallas:
        from ..ops import fused
        if fused.takes(plan):
            ker = fused.kernels_of(plan)
            half_b, half_d = ker["b"], ker["d"]

            def step_pallas(state: Dict[str, Any], xs: Dict[str, Any],
                            C: Optional[Dict[str, Any]] = None
                            ) -> Dict[str, Any]:
                f, fu, fw = half_b(state["f"], state["f_u"], state["f_w"],
                                   xs, C)
                f, fu, fw = half_d(f, fu, fw, xs, C)
                state = {**state, "f": f, "f_u": fu, "f_w": fw,
                         "t": state["t"] + 1}
                if not dft:
                    return state
                return _dft_update(plan, plan.coefs if C is None else C,
                                   state, xs)

            return step_pallas

    def step(state: Dict[str, Any], xs: Dict[str, Any],
             C: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        if C is None:
            C = plan.coefs
        # --- B half ---------------------------------------------------------
        for spec in plan.curl_specs_b:
            state = _curl_update(plan, C, spec, state)
            state = _bfast_update(plan, C, spec, state)
        state = _apply_sources(plan, C, "b", state, xs)
        dmp_h = _compute_fmp(plan, "h", state)
        for spec in plan.eh_specs_h:
            state = _eh_update(plan, C, spec, state, dmp_h)
        for k in range(len(plan.pol_specs_h)):
            pi = len(plan.pol_specs_e) + k
            state = _pol_update_lorentzian(plan, C, pi, plan.pol_specs_h[k],
                                           state)
        # --- D half ---------------------------------------------------------
        for spec in plan.curl_specs_d:
            state = _curl_update(plan, C, spec, state)
            state = _bfast_update(plan, C, spec, state)
        state = _apply_sources(plan, C, "d", state, xs)
        dmp_e = _compute_fmp(plan, "e", state)
        for spec in plan.eh_specs_e:
            state = _eh_update(plan, C, spec, state, dmp_e)
        for k in range(len(plan.pol_specs_e)):
            state = _pol_update_lorentzian(plan, C, k, plan.pol_specs_e[k],
                                           state)
        state = {**state, "t": state["t"] + 1}
        if dft:
            state = _dft_update(plan, C, state, xs)
        return state

    return step


def build_xs(plan: Plan, nsteps: int, t0: int = 0) -> Dict[str, Any]:
    """Per-step host tables: source waveforms and DTFT phases (numpy).

    Source sampling times follow step.cpp:64-106: B currents at t*dt, D
    currents at (t+0.5)*dt.  DTFT phases use the *post-increment* step
    counter (dft.cpp:252-257): E components at (t+1)*dt, H at (t+0.5)*dt;
    rows of non-sample steps are zero (the decimation rule)."""
    dt = plan.dt
    steps = np.arange(t0, t0 + nsteps)
    xs: Dict[str, Any] = {}
    rdtype = np.float32 if plan.dtype != np.float64 else np.float64
    for si, s in enumerate(plan.sources):
        st = s.src_time
        is_h_family = s.component[0] == "h"
        if s.is_integrated:
            tt = (steps + (0.5 if is_h_family else 1.0)) * dt
            w = np.asarray([st.dipole(t) for t in tt], np.complex128)
            xs[f"src{si}:dip_re"] = w.real.astype(rdtype)
            xs[f"src{si}:dip_im"] = w.imag.astype(rdtype)
        else:
            tt = (steps + (0.0 if is_h_family else 0.5)) * dt
            w = np.asarray([st.current(t, dt) for t in tt], np.complex128)
            xs[f"src{si}:cur_re"] = w.real.astype(rdtype)
            xs[f"src{si}:cur_im"] = w.imag.astype(rdtype)
    for mi, m in enumerate(plan.dfts):
        is_h = m.component[0] in ("h", "b")
        tE = (steps + 1) * dt
        tt = tE - 0.5 * dt if is_h else tE
        omegas = 2 * np.pi * np.asarray(m.freqs)
        ph = np.exp(1j * omegas[None, :] * tt[:, None]) \
            * (m.scale * dt / math.sqrt(2 * math.pi) * m.decimation)
        live = ((steps + 1) % m.decimation) == 0
        ph = ph * live[:, None]
        xs[f"dft{mi}:ph_re"] = ph.real.astype(rdtype)
        xs[f"dft{mi}:ph_im"] = ph.imag.astype(rdtype)
    return xs


def xs_rows(plan: Plan, xs: Dict[str, Any]):
    """Split build_xs tables into per-step rows: source waveforms as Python
    floats, DTFT phase rows as tensors on the plan's device (uploaded once
    per table)."""
    dev = plan.device
    phase = {k: torch.as_tensor(v, device=dev) for k, v in xs.items()
             if k.startswith("dft")}
    scal = {k: v.tolist() for k, v in xs.items() if not k.startswith("dft")}
    n = len(next(iter(xs.values()))) if xs else 0
    return [{**{k: v[i] for k, v in scal.items()},
             **{k: v[i] for k, v in phase.items()}} for i in range(n)]


@dataclasses.dataclass
class ProbeSpec:
    """Point (or weighted-stencil) field sampler emitted every step
    (step.py:1666): sum_p weights[p] * f[component][indices[p]]."""
    name: str
    component: str
    indices: Any        # (npts, ndim) int
    weights: Any        # (npts,)


def run(plan: Plan, state: Dict[str, Any], nsteps: int,
        t0: Optional[int] = None, probes: Sequence[ProbeSpec] = ()):
    """Advance the state by nsteps eager steps (the inner loop of
    Simulation.run).  With `probes`, returns (state, {name: series}): each
    probe's weighted sum after every step, the analog of the scan-emitted
    probe series of step.py:1590-1663, summed point by point from 0.0 in
    the state's type (the resident probed kernel's order,
    ops/pallas/resident.py:336-339).  A series is (nsteps,), complex for
    native complex fields, and (nsteps, 2) (re, im) rows for a real pair,
    each point's product (fr wr - fi wi, fr wi + fi wr)."""
    if t0 is None:
        t0 = int(state["t"])
    step = make_step(plan)
    rows = xs_rows(plan, build_xs(plan, nsteps, t0))
    dtype = torch_dtype(plan.dtype)
    pair = _is_pair(plan)
    pidx = {p.name: tuple(torch.as_tensor(np.asarray(p.indices, np.int64),
                                          device=plan.device).unbind(1))
            for p in probes}
    if pair:
        pw = {p.name: tuple(torch.as_tensor(np.array(part(p.weights)),
                                            dtype=dtype, device=plan.device)
                            for part in (np.real, np.imag))
              for p in probes}
    elif plan.complex_fields:
        pw = {p.name: torch.as_tensor(
            np.asarray(p.weights, np.complex128),
            dtype=state["f"][p.component].dtype, device=plan.device)
            for p in probes}
    else:
        pw = {p.name: torch.as_tensor(np.asarray(p.weights), dtype=dtype,
                                      device=plan.device) for p in probes}
    prods = {p.name: [] for p in probes}
    for i in range(nsteps):
        state = step(state, rows[i] if rows else {})
        for p in probes:
            v = state["f"][p.component]
            if pair:
                fr, fi = v[0][pidx[p.name]], v[1][pidx[p.name]]
                wr, wi = pw[p.name]
                prods[p.name].append(torch.stack([fr * wr - fi * wi,
                                                  fr * wi + fi * wr], -1))
            else:
                prods[p.name].append(v[pidx[p.name]] * pw[p.name])
    if not probes:
        return state
    series = {}
    for p in probes:
        v = prods[p.name]
        acc = torch.zeros((nsteps, 2) if pair else (nsteps,),
                          dtype=pw[p.name][0].dtype if pair
                          else pw[p.name].dtype, device=plan.device)
        if v:
            pv = torch.stack(v)              # (nsteps, points[, 2])
            for q in range(pv.shape[1]):
                acc = acc + pv[:, q]
        series[p.name] = acc
    return state, series
