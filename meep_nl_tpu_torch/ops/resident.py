"""K3 and K4: the resident path, a whole chunk of steps of a small grid in
one launch (csrc/resident.cu).

The port of ``meep_nl_tpu/ops/pallas/resident.py``.  There the kernel body
is the eager stepper traced into one Mosaic program whose time loop keeps
the whole state in VMEM; `Simulation.run` tries this path first for every
stretch, so it carries every 2D run and every small 3D run.  Here the
kernel is hand-written CUDA that runs the time loop inside one cooperative
launch per chunk: tiles staged with their halos in shared memory, T steps
per pass, one grid barrier per pass (`tiling` picks the tile and T,
`boxes` gives the regions each step computes), or, where tiles give no
temporal reuse (T = 1 only, no tile fits, more than MAXSLOT arrays), the
direct schedule: the whole grid stepped in place in one device buffer, a
grid barrier per sub-update (`direct_tiling`); rotational folds (C2 and
C4) and Bloch-periodic plans always take the direct schedule, whose D
curl reads the fold ghosts, and whose curls and centred DTFT read the
wrap planes, anywhere on the grid; complex fields in real-pair storage
take the direct schedule's PAIR variant, both channels in one buffer,
the channels mixed where the wrap's complex phase rotates them, and a BFAST
plan (always complex, so a pair on the card) its PAIR_BFAST variant, which
adds the flip-flop term after each curl; a cylindrical plan, or a 2D plan
with an out-of-plane wavenumber beta, the CYL variant (real fields, m =
0) or PAIR_CYL (the pair: m != 0, beta), with the r-weighted curl, the
i m / r or i beta term and the r = 0 axis corrections; a plan with
off-diagonal epsilon rows, off-diagonal sigma or gyrotropic poles one of
the anisotropic modes (`ax_mode`: OFFDIAG, E's off-diagonal average;
GYRO, poles that read their partners' W in a sub-update of their own),
OFFDIAG on tiles or the direct schedule, GYRO on the direct schedule
only.  What it computes is the
eager `make_step` over
`resident_plan(plan)`: full-grid PML chains, dense pre-scattered sources,
the DTFT accumulated in the loop in the frequency-major layout; K4 adds the
probes' per-step weighted sums.

`ResidentKernel.run` / `run_probed` take and return the standard state
layout; the frequency-major DTFT layout exists only inside the call.  A
state on the CPU runs the plain version (`resident_ref`), a state on the
card the kernel, out of place between the state's tensors and a second set
the kernel object keeps (the input's tensors are handed over: use only the
returned state); `launches` (K3), `probed_launches` (K4) and `plain_steps`
count which ran.

Not carried over from the reference, each on purpose:
  * the environment switches MNT_RESIDENT_BUDGET / CHUNK / CPU / PREFER:
    module constants with the same values (VMEM_BUDGET, MAX_CHUNK,
    PREFER_BYTES; on the CPU the route always runs, through the plain
    version);
  * the `_resident_broken` fallback and its warnings (:500-507, :539-546):
    a kernel that fails to build or launch raises;
  * `_CoefRecorder` / `_used_coef_keys` (:119-155): the parameter block
    names what the kernel reads;
  * `validate_lowering` (:450), which only applies to Mosaic.
The envelope is the reference's (2D and 3D, fp32, real fields or the real
pair, no noisy media, a doubled state within VMEM_BUDGET; 1D and native
complex storage declined) intersected with
what the port's eager stepper and this kernel run: masks made of dead
planes, no H-family chi2/chi3, no chi2/chi3 on a rotational fold (no
Simulation makes one: it rejects them, as the reference's does), and on a
Bloch-periodic axis (real phases: k = 0 or the zone edge; complex ones
take the real pair, which has no chi2/chi3) chi2/chi3 support boxes clear
of the wrap planes (their neighbour sums do not wrap here, ROADMAP B3);
the anisotropic modes on linear real fields only, without a wrap, fold
rotation, cylindrical / beta terms or BFAST, and no off-diagonal mu row
(`_ax_supported`, ROADMAP C.2).
BFAST runs only as a real pair (the PAIR_BFAST variant; K1, K2 and K5
decline it, as the reference's do, so a BFAST plan above the budget runs on
the eager stepper).  Cylindrical and beta plans run without BFAST, a
cylindrical cell without a Bloch wrap and with its axis at r = 0; K1, K2
and K5 decline them too.
Folds: node mirrors on every axis, Rotate2 and Rotate4; a real pair with
a rotational fold (force_complex_fields and Rotate2; the kernel builds
the rotational ghosts without the pair) is declined and runs on the
stepper.  Monitors read any
field of the state (E/H, and D/B for the energy monitors), centred or on
their own lattice, with real or complex weights (the LDOS monitors'
conj(amplitude)).
"""

from __future__ import annotations

import copy
import ctypes
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from . import fdtd3d, fdtd3d_t2
from ..core import grid as G
from ..stepper.step import (ProbeSpec, _is_pair, axis_corrections,
                            bfast_ks, bfast_specs, build_xs,
                            check_supported, gyro_constants, mirror_ghost,
                            rot2_ghost, rot4_ghost, run)

#: the reference's VMEM budget for 2x state (resident.py:50); on the H100
#: the state lives in device memory, so this is a routing rule, not a limit
VMEM_BUDGET = 112 * 2 ** 20
#: max steps per launch (bounds the per-step tables)
MAX_CHUNK = 8192
#: 3D plans whose doubled state is larger prefer the hybrid route
#: (resident.py:525-533, MNT_RESIDENT_PREFER)
PREFER_BYTES = 32 * 2 ** 20
STEP_BSRC, STEP_DSRC, STEP_DFT = 1, 2, 4
#: the anisotropic modes (csrc/resident.cu AX_*)
AX_NONE, AX_OFFDIAG, AX_GYRO = 0, 1, 2


def resident_plan(plan):
    """A shallow clone of `plan` prepared for in-kernel stepping
    (resident.py:60-97): full-grid chain updates, dense pre-scattered source
    arrays (built in float64, then cast), frequency-major DTFT
    accumulators, BFAST's tapers expanded to the grid (the kernel reads
    them per site; the values are the plan's).  Cached on the plan."""
    cached = plan.__dict__.get("_resident_plan")
    if cached is not None:
        return cached
    p = copy.copy(plan)
    for attr in [a for a in p.__dict__ if a.startswith("_")]:
        del p.__dict__[attr]          # kernel objects and caches of `plan`
    p.slab_opt = False
    p.slab_store = False
    p.use_pallas = False
    p.scatter_free = True
    p.dft_front = True
    coefs = dict(plan.coefs)
    shape = tuple(plan.storage_shape or plan.gv.shape)
    for si, s in enumerate(plan.sources):
        if f"src{si}:idx" not in coefs:
            continue
        idx = coefs[f"src{si}:idx"].cpu().numpy()
        are = coefs[f"src{si}:amp_re"].cpu().numpy().astype(np.float64)
        aim = coefs[f"src{si}:amp_im"].cpu().numpy().astype(np.float64)
        if not s.is_integrated and f"src{si}:cndinv" in coefs:
            cnd = coefs[f"src{si}:cndinv"].cpu().numpy().astype(np.float64)
            are, aim = are * cnd, aim * cnd
        dre = np.zeros(shape, np.float64)
        dim_ = np.zeros(shape, np.float64)
        np.add.at(dre, tuple(idx.T), are)
        np.add.at(dim_, tuple(idx.T), aim)
        for key, arr in (("dense_re", dre), ("dense_im", dim_)):
            coefs[f"src{si}:{key}"] = torch.as_tensor(
                arr.astype(plan.dtype), device=plan.device)
    for key in [k for k in coefs if k.endswith(":bftap")]:
        coefs[key] = coefs[key].expand(shape).contiguous()
    p.coefs = coefs
    plan._resident_plan = p
    return p


def _state_bytes(plan) -> int:
    """Bytes of the stepper state of `plan` (as step.init_state makes it,
    with its 4-byte step counter; a real pair's fields twice), from the
    shapes alone."""
    shape = tuple(plan.storage_shape or plan.gv.shape)
    N = int(np.prod(shape)) * (2 if _is_pair(plan) else 1)
    curls = plan.curl_specs_d + plan.curl_specs_b
    ehs = plan.eh_specs_e + plan.eh_specs_h
    n = N * (len(curls) + len(ehs))
    n += N * sum(1 for s in curls if s.dsigu_axis is not None)
    n += N * sum(1 for s in ehs if s.dsigw_axis is not None)
    if plan.bfast_k is not None:
        n += N * len(bfast_specs(plan))
    for p in plan.pol_specs_e + plan.pol_specs_h:
        comps = {c for (c, d) in p.sigma if d == G.component_direction(c)}
        n += 2 * N * len(comps) * (3 if p.kind == "gyrotropic" else 1)
    for m in plan.dfts:
        n += int(np.prod([b - a for a, b in m.region])) * len(m.freqs) * 2
    return n * np.dtype(plan.dtype).itemsize + 4


def _rotational(plan) -> bool:
    return plan.rot2 is not None or plan.rot4 is not None


def _nl_clear_of_wrap(plan) -> bool:
    """Whether every chi2/chi3 support box lies a site clear of both ends
    of each Bloch-periodic axis: the four-site sums of a site in the box
    then read no wrapped plane (step._sum4 shifts through the wrap).  The
    H family carries none here (resident_supported)."""
    nl = fdtd3d.material_boxes(plan, pols=False)
    return nl is not None and all(
        b[ax][0] >= 1 and b[ax][1] <= plan.gv.num[ax] - 1
        for b in nl for ax, per in enumerate(plan.periodic) if per)


def _offdiag(plan) -> bool:
    """Whether an E or H row has off-diagonal chi1inv entries (u1 / u2)."""
    return any(s.has_u1 or s.has_u2
               for s in plan.eh_specs_e + plan.eh_specs_h)


def _sep_pole(p) -> bool:
    """Whether pole `p` reads partner W at neighbouring sites, and so runs
    in the GYRO mode's pole sub-update: a gyrotropic pole, or a Lorentzian
    one with off-diagonal sigma rows."""
    return p.kind == "gyrotropic" or any(d != G.component_direction(c)
                                         for (c, d) in p.sigma)


def _sep_poles(plan) -> bool:
    return any(_sep_pole(p) for p in plan.pol_specs_e + plan.pol_specs_h)


def _ax_supported(plan) -> bool:
    """The anisotropic modes' envelope (AX_OFFDIAG, AX_GYRO): real fields
    (the real pair declines them, ROADMAP C.2), no Bloch wrap, fold
    ghosts of a rotation, cylindrical or beta terms, BFAST or chi2/chi3;
    off-diagonal rows on the E family only (the H update runs fused with
    the B curl, and no scene makes an off-diagonal mu), each with both of
    its axes on the grid."""
    if _is_pair(plan) or any(plan.periodic) or _rotational(plan) \
            or _cyl(plan) or plan.bfast_k is not None:
        return False
    if any(s.has_chi3 or s.has_nr for s in plan.eh_specs_e + plan.eh_specs_h):
        return False
    if any(s.has_u1 or s.has_u2 for s in plan.eh_specs_h):
        return False
    return all(s.ax_own is not None
               and (not s.has_u1 or s.ax_1 is not None)
               and (not s.has_u2 or s.ax_2 is not None)
               for s in plan.eh_specs_e if s.has_u1 or s.has_u2)


def ax_mode(plan) -> int:
    """The anisotropic mode a plan needs: AX_GYRO where a pole runs in a
    sub-update of its own (`_sep_poles`), AX_OFFDIAG where only E rows
    have off-diagonal entries, else AX_NONE."""
    if _sep_poles(plan):
        return AX_GYRO
    return AX_OFFDIAG if _offdiag(plan) else AX_NONE


def resident_supported(plan) -> bool:
    """The static envelope (resident.py:158-182, see the module docstring):
    plans outside it are declined, never raised on."""
    if plan.gv.ndim < 2 or plan.dtype != np.float32:
        return False
    if _cyl(plan) and (plan.bfast_k is not None or (
            plan.gv.dim == "cyl" and (any(plan.periodic)
                                      or abs(plan.gv.origin[0]) > 1e-12))):
        # the CYL variants (linear: the stepper refuses chi2/chi3 on a
        # cylindrical cell, and a beta plan is a real pair) carry no BFAST
        # term, and a cylindrical cell's no Bloch wrap; its axis is at r = 0
        return False
    if plan.complex_fields and not plan.real_pair:
        return False                     # native complex storage
    if plan.bfast_k is not None and not _is_pair(plan):
        return False                     # BFAST's term: the pair's variant
    if _is_pair(plan) and _rotational(plan):
        return False
    if not _is_pair(plan) and any(isinstance(ph, complex)
                                  for ph in plan.bloch_phase):
        return False                     # the WRAP variant's phases are real
    if any(plan.periodic) and not _nl_clear_of_wrap(plan):
        return False
    if (_offdiag(plan) or _sep_poles(plan)) and not _ax_supported(plan):
        return False
    try:
        check_supported(plan)
    except NotImplementedError:
        return False
    if any(p.noise_amp != 0.0 for p in plan.pol_specs_e + plan.pol_specs_h):
        return False
    if max(len(plan.pol_specs_e), len(plan.pol_specs_h)) > fdtd3d.MAXPOL:
        return False
    if any(s.has_chi3 or s.has_nr for s in plan.eh_specs_h):
        return False
    if _rotational(plan) and any(s.has_chi3 or s.has_nr
                                 for s in plan.eh_specs_e):
        return False
    if any(planes is None for planes in (plan.mask_planes or {}).values()):
        return False
    if int(np.prod(plan.storage_shape or plan.gv.shape)) >= 2 ** 31:
        return False
    # the state of the resident plan has the shapes of the plan's
    return 2 * _state_bytes(plan) <= VMEM_BUDGET


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _to_front(state):
    """The standard state with frequency-major DTFT accumulators."""
    return {**state, "dft": {k: v.movedim((-2, -1), (0, 1))
                             for k, v in state["dft"].items()}}


def _from_front(state):
    return {**state, "dft": {k: v.movedim((0, 1), (-2, -1))
                             for k, v in state["dft"].items()}}


def _probe_table(plan, probes: Sequence[ProbeSpec]):
    """Per probe (name, component, flat int32 offsets, float32 weights):
    the weights in the kernel's type (a real pair's interleaved (re, im)),
    the offsets into the storage."""
    shape = tuple(plan.storage_shape or plan.gv.shape)
    out = []
    for p in probes:
        idx = np.asarray(p.indices, np.int64).reshape(-1, len(shape))
        w = np.asarray(p.weights)
        if _is_pair(plan):
            w = np.stack([np.real(w), np.imag(w)], -1).reshape(-1)
        elif np.iscomplexobj(w):
            if np.abs(w.imag).max() > 0:
                raise ValueError("complex probe weights need complex fields")
            w = w.real
        off = np.ravel_multi_index(tuple(idx.T), shape).astype(np.int32)
        out.append((p.name, p.component, off, w.astype(np.float32)))
    return out


def resident_ref(plan):
    """The plain version of K3/K4: `ref(state, nsteps, t0, probes=())` ->
    (state, {name: (nsteps,) series}), the eager stepper (`step.run`, whose
    probe sums follow K4's order) over `resident_plan(plan)` on the
    standard state layout."""
    rplan = resident_plan(plan)

    def ref(state, nsteps: int, t0: int, probes: Sequence[ProbeSpec] = ()):
        out = run(rplan, _to_front(state), nsteps, t0, probes)
        st, series = out if probes else (out, {})
        return _from_front(st), series

    return ref


# ---------------------------------------------------------------------------
# the schedule: tiles, passes, staged boxes
# ---------------------------------------------------------------------------

#: threads per block (csrc/resident.cu NTHR; the nonlinear variant half)
NTHR = 512
#: the most arrays a block stages (csrc/resident.cu MAXSLOT)
MAXSLOT = 96
#: the H100's shared memory for one block (the wrapper asks the card:
#: mnt_k3_smem)
SMEM_H100 = fdtd3d_t2.SMEM_H100
#: the longest pass
TMAX = 16
#: the tile extents tried along an axis (besides the whole axis)
TILE_SIZES = (4, 6, 8, 12, 16, 20, 24, 32, 40, 48, 56, 64, 80, 96, 128)
#: the cost model of a pass (microseconds; fitted on an H100 by
#: scripts/resident_time.py --sweep, PERF.md §6): a grid barrier, a block's
#: bytes staged or written back per us, one round of a component's
#: sub-update (NTHR sites)
COST_BARRIER, COST_BYTES_PER_US, COST_ROUND = 7.4411, 4952.7, 0.2608


def step_us(T, ntile, vol, interior, nslot: int, nstate: int, nloops: int,
            sms: int):
    """The cost model's microseconds per step of a tiling: per pass a grid
    barrier, then per wave of tiles (one block an SM) the staging and
    write-back and T steps of nloops component loops of ceil(vol / NTHR)
    rounds.  T, ntile, vol and interior may be integer arrays (tilings
    side by side)."""
    waves = -(-ntile // sms)
    moved = 4 * (nslot * vol + nstate * interior)
    rounds = -(-vol // NTHR)
    tile = moved / COST_BYTES_PER_US + T * nloops * rounds * COST_ROUND
    return (COST_BARRIER + waves * tile) / T


def tiling(shape, nslot: int, nstate: int, c: int, e, nloops: int,
           budget: int, sms: int, force=None, nvec: int = 0
           ) -> Dict[str, Any]:
    """T, the tile and the shared memory of K3/K4 for a grid `shape` (3
    extents, 1 on an absent axis) whose step stages `nslot` arrays per site
    (the first `nstate` written back) and `nvec` per-axis vectors, costs the
    valid region `c` sites per side (1, or 2 when E reads its neighbours'
    D - P), leaves `e[ax]` more sites valid above the interior (the DTFT's
    centred average) and runs `nloops` component loops a step.  A tile (t0,
    t1, t2) is staged grown by T c below and T c + e above (`boxes`): nslot
    arrays of `vol` floats (the grown extents' product) and nvec vectors of
    `gvec` floats (the largest grown extent), which must fit `budget` bytes;
    among those, the choice with the least modelled time per step on `sms`
    SMs (`step_us`).  `force` = ((t0, t1, t2), T) takes that choice
    instead (the tests' tile seams, scripts/resident_time.py's sweep;
    ValueError if it does not fit).
    Returns {"t", "nt", "e", "T", "c", "vol", "gvec", "smem", "ntile",
    "direct": False}, or None when not even the smallest tile fits at
    T = 1."""
    shape = tuple(int(s) for s in shape)
    e = tuple(int(v) for v in e)

    def grown(t, T):
        return tuple(min(S, ti + 2 * T * c + ei)
                     for S, ti, ei in zip(shape, t, e))

    def result(t, T):
        g = grown(t, T)
        vol = int(np.prod(g))
        nt = tuple(-(-S // ti) for S, ti in zip(shape, t))
        return {"t": t, "nt": nt, "e": e, "T": T, "c": c, "vol": vol,
                "gvec": max(g), "smem": 4 * (nslot * vol + nvec * max(g)),
                "ntile": int(np.prod(nt)), "direct": False}

    if force is not None:
        t, T = tuple(min(S, int(v)) for S, v in zip(shape, force[0])), \
            int(force[1])
        out = result(t, T)
        if out["smem"] > budget:
            raise ValueError(f"resident: forced tiling {force} needs "
                             f"{out['smem']} bytes of shared memory")
        return out
    # every (T, t0, t1, t2) at once, in the order of nested loops over
    # them: argmin takes the first of equal costs
    sizes = [sorted({min(S, v) for v in TILE_SIZES} | {S}) for S in shape]
    Tg, t0, t1, t2 = (g.ravel() for g in np.meshgrid(
        np.arange(1, TMAX + 1), *sizes, indexing="ij"))
    g = [np.minimum(S, ti + 2 * Tg * c + ei)
         for S, ti, ei in zip(shape, (t0, t1, t2), e)]
    vol = g[0] * g[1] * g[2]
    fits = 4 * (nslot * vol + nvec * np.maximum(np.maximum(g[0], g[1]),
                                                 g[2])) <= budget
    if not fits.any():
        return None
    ntile = ((-(-shape[0] // t0)) * (-(-shape[1] // t1))
             * (-(-shape[2] // t2)))
    cost = np.where(fits, step_us(Tg, ntile, vol, t0 * t1 * t2, nslot,
                                  nstate, nloops, sms), np.inf)
    k = int(np.argmin(cost))
    return result((int(t0[k]), int(t1[k]), int(t2[k])), int(Tg[k]))


#: the direct schedule's variants (Tiling.direct): plain, with the
#: rotational fold ghosts, with the Bloch wrap, a real pair (with or
#: without the wrap), a real pair with BFAST's term, a cylindrical plan on
#: real fields (m = 0), a cylindrical or beta plan on a real pair (with or
#: without the wrap)
DIRECT, DIRECT_ROT, DIRECT_WRAP, DIRECT_PAIR, DIRECT_PAIR_BFAST, \
    DIRECT_CYL, DIRECT_PAIR_CYL = 1, 2, 3, 4, 5, 6, 7


def direct_tiling(shape, c: int, e, variant: int = DIRECT
                  ) -> Dict[str, Any]:
    """The direct schedule in tiling()'s terms: one tile, the whole grid
    (`shape`, 3 extents), T = 1, no shared memory; its "vol" and "gvec"
    lay out the device buffer the kernel steps in (nslot arrays of vol
    floats, then the per-axis vectors, gvec floats each).  "direct" is
    the kernel's variant: DIRECT_ROT for a rotational fold (its ghosts),
    DIRECT_WRAP for a Bloch-periodic plan (the wrap reads), else
    DIRECT."""
    shape = tuple(int(s) for s in shape)
    return {"t": shape, "nt": (1, 1, 1), "e": tuple(int(v) for v in e),
            "T": 1, "c": c, "vol": int(np.prod(shape)), "gvec": max(shape),
            "smem": 0, "ntile": 1, "direct": variant}


def _cyl(plan) -> bool:
    """A cylindrical plan, or a 2D plan with an out-of-plane wavenumber:
    the CYL variants' terms."""
    return plan.gv.dim == "cyl" or plan.beta != 0.0


def direct_variant(plan) -> int:
    """The direct schedule's variant a plan needs."""
    if _cyl(plan):
        return DIRECT_PAIR_CYL if _is_pair(plan) else DIRECT_CYL
    if _is_pair(plan):
        return DIRECT_PAIR if plan.bfast_k is None else DIRECT_PAIR_BFAST
    if _rotational(plan):
        return DIRECT_ROT
    return DIRECT_WRAP if any(plan.periodic) else DIRECT


def staged_boxes(tl, shape, Tp: int):
    """Every tile's staged box in a pass of Tp steps: (lo, hi), each
    (ntile, 3) in grid coordinates (hi exclusive), the tile's interior grown
    by Tp c below and Tp c + e above, clipped to the grid."""
    at = np.stack(np.unravel_index(np.arange(tl["ntile"]), tl["nt"]), 1)
    lo = at * np.asarray(tl["t"])
    hi = np.minimum(shape, lo + np.asarray(tl["t"]))
    grow = Tp * tl["c"]
    return (np.maximum(0, lo - grow),
            np.minimum(shape, hi + grow + np.asarray(tl["e"])))


def boxes(tl, shape, tile: int, Tp: int, r: int) -> Dict[str, Any]:
    """The boxes (lo, hi per axis, grid coordinates, hi exclusive) of tile
    `tile` in a pass of Tp steps, at its step r, as csrc/resident.cu
    computes them: "interior", "staged" (grown by Tp c below and Tp c + e
    above, clipped to the grid) and the sub-updates' boxes "b" (B curl, B
    sources, H), "d" (D curl, D sources), "e" (E and the ADE)."""
    c, nl = tl["c"], tl["c"] - 1
    nt = tl["nt"]
    at = (tile // (nt[1] * nt[2]), (tile // nt[2]) % nt[1], tile % nt[2])
    lo = [a * t for a, t in zip(at, tl["t"])]
    hi = [min(S, a + t) for S, a, t in zip(shape, lo, tl["t"])]
    L = (Tp - r) * c
    out = {"interior": (lo, hi)}

    def box(dlo, dhi):
        return ([max(0, a - dlo) for a in lo],
                [min(S, b + dhi + ei) for S, b, ei in zip(shape, hi,
                                                           tl["e"])])

    slo, shi = staged_boxes(tl, shape, Tp)
    out["staged"] = (slo[tile].tolist(), shi[tile].tolist())
    out["b"] = box(L, L - 1)
    out["d"] = box(L - 1, L - 1)
    out["e"] = box(L - 1 - nl, L - 1 - nl)
    return out


# ---------------------------------------------------------------------------
# the C argument block (mirrors csrc/resident.cu; every member is 8 bytes)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_longlong


class _DftM(ctypes.Structure):
    _fields_ = ([(n, _P) for n in ("acc", "f", "w", "wi", "phr", "phi")]
                + [("nfreq", _I), ("R", _I), ("lo", _I * 3), ("n", _I * 3),
                   ("navg", _I), ("avg", _I * 3)])


class _SrcFam(ctypes.Structure):
    _fields_ = ([(n, _P) for n in ("slot_off", "slot_q", "slot_start",
                                   "c_src", "c_re", "c_im", "tstart",
                                   "tslot")]
                + [("nslot", _I)])


class _Probes(ctypes.Structure):
    _fields_ = ([(n, _P) for n in ("off", "tok", "w", "start", "tstart",
                                   "tpt", "series", "prod")]
                + [("nprobe", _I), ("npt", _I)])


class _Tiling(ctypes.Structure):
    _fields_ = [("t", _I * 3), ("nt", _I * 3), ("e", _I * 3)] + \
        [(n, _I) for n in ("T", "c", "vol", "nslot", "nstate", "nvec",
                           "gvec", "direct")]


class _CylP(ctypes.Structure):
    _fields_ = [(n, _I) for n in ("rg", "rfinv", "imr", "phi")] + \
        [(n, ctypes.c_double) for n in ("ps", "imc")] + \
        [(n, _I) for n in ("ag", "ar")] + \
        [(n, ctypes.c_double) for n in ("are", "aim")]


class _ResArgs(ctypes.Structure):
    _fields_ = [("pb", fdtd3d._Params * 2), ("pd", fdtd3d._Params * 2),
                ("src", _SrcFam * 2), ("pr", _Probes), ("tl", _Tiling),
                ("set", (_P * MAXSLOT) * 2), ("vec", _P), ("base", _P),
                ("dft", _P),
                ("cur", _P),
                ("flags", _P), ("dt", ctypes.c_double)] + \
        [(n, _I) for n in ("nsteps", "nsrc", "ndft", "e_local")] + \
        [("gk", (_I * 2) * fdtd3d.NCOMP),
         ("gs", (ctypes.c_double * 2) * fdtd3d.NCOMP)] + \
        [(n, (_I * 2) * fdtd3d.NCOMP)
         for n in ("gsrc", "goff", "gmul", "gax", "glim")] + \
        [("wn", _I * 3), ("wph", ctypes.c_double * 3),
         ("wphi", ctypes.c_double * 3), ("wphim", ctypes.c_double * 3),
         ("wphii", ctypes.c_double * 3), ("half", _I)] + \
        [(n, (_I * fdtd3d.NCOMP) * 2) for n in ("bf", "bt", "bw")] + \
        [("bk", ((ctypes.c_double * 2) * fdtd3d.NCOMP) * 2),
         ("cyl", _P), ("axmode", _I), ("ax", _P)]


class _SepP(ctypes.Structure):
    _fields_ = [("kind", _I), ("p", _I * 3), ("pp", _I * 3), ("sig", _I),
                ("so", _I * 2), ("w", _I * 3), ("av", (_I * 3) * 2),
                ("k", ctypes.c_double * 4), ("c", ctypes.c_double * 6),
                ("inv", ctypes.c_double * 9)]


class _AxTab(ctypes.Structure):
    _fields_ = [("u1", (_I * fdtd3d.NCOMP) * 2),
                ("u2", (_I * fdtd3d.NCOMP) * 2), ("sep", _I * 2),
                ("pole", ((_SepP * fdtd3d.NCOMP) * fdtd3d.MAXPOL) * 2)]


def set_ghosts(A, plan, slot):
    """The D curl's fold ghosts in a K3/K4 argument block, for D component
    q and its partner m (0: g_plus, 1: g_minus) differentiated along a
    fold axis; A.gs the sign (0: no ghost).  A node mirror's (every axis,
    x included): the row k0 (A.gk), as step.mirror_ghost.  A rotational
    fold's (the direct schedule, whose box is the grid; `slot`: state path
    -> slot): the ghost below plane 0 reads the array of slot token
    A.gsrc at the site's offset + A.goff + j * A.gmul, j the site's index
    along axis A.gax, and is 0 where j >= A.glim -- C2's flip over the
    live extent nl (step.rot2_ghost), C4's transposed read of the swapped
    component (step.rot4_ghost).

    The Bloch wrap of a periodic axis (the direct schedule's WRAP and PAIR
    variants, step._sh): A.wn[ax] its live extent n (0: not wrapped),
    A.wph / A.wphi the phase and its inverse, A.wphim / A.wphii their
    imaginary parts (a complex phase: the PAIR variant).  The B curl's forward difference at
    plane n - 1 reads wph * g(0), the D curl's backward difference at
    plane 0 reads wphi * g(n - 1), the centred DTFT's read past plane n - 1
    is wph * plane 0, and every read from a dead plane's site (index n and
    up) across the axis is zero."""
    for ax in range(3):
        per = ax < len(plan.periodic) and plan.periodic[ax]
        ph = plan.bloch_phase[ax] if per else 1.0
        inv = 1.0 / ph
        A.wn[ax] = plan.gv.num[ax] if per else 0
        A.wph[ax], A.wphi[ax] = float(np.real(ph)), float(np.real(inv))
        A.wphim[ax], A.wphii[ax] = float(np.imag(ph)), float(np.imag(inv))
    shape = tuple(plan.storage_shape or plan.gv.shape)
    shape = shape + (1,) * (3 - len(shape))
    st = (shape[1] * shape[2], shape[2], 1)
    for q, spec in enumerate(plan.curl_specs_d):
        for m, (g, ax) in enumerate(((spec.g_plus, spec.plus_axis),
                                     (spec.g_minus, spec.minus_axis))):
            A.gk[q][m], A.gs[q][m] = 0, 0.0
            A.gsrc[q][m] = A.goff[q][m] = A.gmul[q][m] = 0
            A.gax[q][m], A.glim[q][m] = -1, 0
            if g is None:
                continue
            for (mx, d, phase) in plan.mirror_node:
                if mx == ax:
                    A.gk[q][m], A.gs[q][m] = mirror_ghost(g, d, phase,
                                                          plan.gv.dim)
            if plan.rot2 is not None and ax == plan.rot2[0]:
                k0, sign, nl = rot2_ghost(g, plan)
                fl = plan.rot2[1]
                A.gs[q][m], A.gsrc[q][m] = sign, slot[("f", g)] + 1
                A.goff[q][m] = k0 * st[ax] + (nl - 1) * st[fl]
                A.gmul[q][m], A.gax[q][m], A.glim[q][m] = -2 * st[fl], fl, nl
            if plan.rot4 is not None and ax in plan.rot4[:2]:
                g2, k0, sign, other = rot4_ghost(g, ax, plan)
                A.gs[q][m], A.gsrc[q][m] = sign, slot[("f", g2)] + 1
                A.goff[q][m] = k0 * st[other]
                A.gmul[q][m] = st[ax] - st[other]
                A.gax[q][m], A.glim[q][m] = other, shape[other]


#: the kernel's static shared memory: its argument block, 16-byte aligned,
#: and the tile's four parameter-block descriptors (csrc/resident.cu FamT,
#: 736 bytes each; bind() checks the sum against the library's
#: mnt_k3_static_smem, a card test against the card's figure)
STATIC_SMEM = -(-ctypes.sizeof(_ResArgs) // 16) * 16 + 4 * 736


def bind(lib):
    """Declare the C interface of a loaded csrc/resident.cu library (the
    card's, or the host build of the emulation tests); checks that its
    argument block is the one mirrored here."""
    if not getattr(lib, "_mnt_bound", False):
        for name in ("mnt_k3_args_size", "mnt_k3_threads", "mnt_k3_maxslot",
                     "mnt_k3_static_smem"):
            getattr(lib, name).restype = ctypes.c_longlong
        lib.mnt_k3_threads.argtypes = [ctypes.c_int]
        lib.mnt_k3_smem.argtypes = [ctypes.c_void_p]
        lib.mnt_k3_smem.restype = ctypes.c_int
        lib.mnt_k3_sms.restype = ctypes.c_int
        lib.mnt_k3_max_blocks.argtypes = [ctypes.c_int] * 5
        lib.mnt_k3_max_blocks.restype = ctypes.c_int
        lib.mnt_k3_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
        lib.mnt_k3_launch.restype = ctypes.c_int
        if (lib.mnt_k3_args_size(), lib.mnt_k3_threads(0),
                lib.mnt_k3_threads(1), lib.mnt_k3_maxslot(),
                lib.mnt_k3_static_smem()) != \
                (ctypes.sizeof(_ResArgs), NTHR, NTHR // 2, MAXSLOT,
                 STATIC_SMEM):
            raise RuntimeError("csrc/resident.cu ResArgs layout does not "
                               "match ops/resident.py")
        lib._mnt_bound = True
    return lib


def _lib():
    from . import _build
    return bind(_build.load("resident"))


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


class _Tok:
    """A state array's slot token (slot + 1) in place of its address: what
    build_params reads from a state view (data_ptr)."""

    def __init__(self, slot: int):
        self.slot = slot

    def data_ptr(self) -> int:
        return self.slot + 1


def state_paths(plan):
    """The state arrays K3/K4 stage, in slot order: ("f", c), ("f_u", c),
    ("f_w", c), ("f_bfast", c), ("pol", index, "p" or "pp", c) -- the
    keys of step.init_state's state."""
    curls = plan.curl_specs_d + plan.curl_specs_b
    ehs = plan.eh_specs_e + plan.eh_specs_h
    paths = [("f", s.c) for s in curls] + [("f", s.ec) for s in ehs]
    paths += [("f_u", s.c) for s in curls if s.dsigu_axis is not None]
    paths += [("f_w", s.ec) for s in ehs if s.dsigw_axis is not None]
    if plan.bfast_k is not None:
        paths += [("f_bfast", s.c) for s in bfast_specs(plan)]
    for pi, p in enumerate(plan.pol_specs_e + plan.pol_specs_h):
        comps = sorted({c for (c, d) in p.sigma
                        if d == G.component_direction(c)})
        paths += [("pol", pi, k, c) for k in ("p", "pp") for c in comps]
        if p.kind == "gyrotropic":
            paths += [("pol", pi, k, f"{c}#{j}") for k in ("p", "pp")
                      for c in comps for j in (1, 2)]
    return paths


def _get(state, path):
    return state["pol"][path[1]][path[2]][path[3]] if path[0] == "pol" \
        else state[path[0]][path[1]]


def _with(state, paths, tensors):
    """`state` with the arrays at `paths` replaced by `tensors`."""
    out = {**state, **{key: dict(state[key]) for key in _KEYS
                       if key in state},
           "pol": [{k: dict(e[k]) for k in ("p", "pp")}
                   for e in state["pol"]]}
    for path, t in zip(paths, tensors):
        if path[0] == "pol":
            out["pol"][path[1]][path[2]][path[3]] = t
        else:
            out[path[0]][path[1]] = t
    return out


#: the state's dicts of per-component arrays a launch reads and writes
_KEYS = ("f", "f_u", "f_w", "f_bfast")


def _swap_pols(state):
    return {**state, "pol": [{"p": e["pp"], "pp": e["p"]}
                             for e in state["pol"]]}


class ResidentKernel:
    """The resident runner for one plan (resident.py:193)."""

    def __init__(self, plan):
        if not resident_supported(plan):
            raise ValueError("plan outside the resident envelope")
        self.plan = plan
        self.rplan = resident_plan(plan)
        self.shape = tuple(plan.storage_shape or plan.gv.shape)
        self._ref = resident_ref(plan)
        self.launches = 0                 # K3 launches
        self.probed_launches = 0          # K4 launches
        self.plain_steps = 0              # steps of the plain version
        self._tables = None
        self._layout_ = None
        self._spare = None                # the second state set (tiles)
        self._buf = None                  # the direct schedule's buffer
        self._const = None                # its coefficients and vectors
        self._probes_ = None              # the last probes' tables
        self._device = {}                 # device -> (budget, SMs)
        self._most = {}                   # (device, variant, smem) -> blocks
        self.schedule = None              # (device, the schedule)

    def run(self, state, nsteps: int, t0: int = 0):
        """Advance `state` by nsteps (chunks of at most MAX_CHUNK steps)."""
        return self._run(state, nsteps, t0, ())[0]

    def run_probed(self, state, nsteps: int, t0: int,
                   probes: Sequence[ProbeSpec]):
        """(state, {name: (nsteps,) float32 tensor}) with each probe's
        weighted sum after every step (resident.py:378)."""
        if not probes:
            raise ValueError("run_probed takes at least one probe")
        return self._run(state, nsteps, t0, probes)

    def _run(self, state, nsteps, t0, probes):
        if self.plan.slab_opt:
            raise RuntimeError(
                "resident: the plan's state was stepped with slab-local PML "
                "chains (the hybrid route); these kernels run the full-grid "
                "chains, which would read stale f_u / f_w outside the slabs")
        dev = state["f"][self.plan.curl_specs_d[0].c].device
        if dev.type == "cuda":
            return self._run_cuda(state, nsteps, t0, probes)
        if dev.type != "cpu":
            raise RuntimeError(f"resident: unsupported device {dev}")
        series = {p.name: [] for p in probes}
        for done in range(0, nsteps, MAX_CHUNK):
            n = min(nsteps - done, MAX_CHUNK)
            self.plain_steps += n
            state, ys = self._ref(state, n, t0 + done, probes)
            for k, v in ys.items():
                series[k].append(v)
        return state, {k: torch.cat(v) for k, v in series.items()}

    # ---- CUDA path ---------------------------------------------------------
    def _run_cuda(self, state, nsteps, t0, probes):
        """The kernel over chunks of at most MAX_CHUNK steps, out of place
        between the state's arrays and a second set (tiles), or in place in
        the direct schedule's buffer (the input's arrays are handed over:
        use only the returned state), the DTFT in place on frequency-major
        copies of the accumulators."""
        state = self._check(state)
        # copies, also where the moved view is contiguous already (a region
        # of one site, as an LDOS monitor's): the caller's accumulators
        # stay as they were
        state = {**state, "dft": {
            k: v.movedim((-2, -1), (0, 1)).clone(
                memory_format=torch.contiguous_format)
            for k, v in state["dft"].items()}}
        series = {p.name: [] for p in probes}
        for done in range(0, nsteps, MAX_CHUNK):
            n = min(nsteps - done, MAX_CHUNK)
            state, ys = self._launch(state, n, t0 + done, probes)
            for k, v in ys.items():
                series[k].append(v)
        state = {**_from_front(state), "t": state["t"] + nsteps}
        return state, {k: torch.cat(v) for k, v in series.items()}

    def _check(self, state):
        """Device, dtype, shape and contiguity of every state tensor; a new
        dict whose tensors share no storage (the kernel writes them)."""
        if torch.device(self.plan.device).type != "cuda":
            raise RuntimeError("resident: the plan's coefficients are not on "
                               "a CUDA device")
        seen = set()
        pair = _is_pair(self.plan)
        shape = (2,) + self.shape if pair else self.shape

        def own(t, what):
            # a real pair's channels contiguous each (the direct schedule's
            # views are two halves of its buffer)
            if t.device.type != "cuda" or t.dtype != torch.float32 \
                    or tuple(t.shape) != shape or not (
                        t[0].is_contiguous() and t[1].is_contiguous()
                        if pair else t.is_contiguous()):
                raise ValueError(
                    f"resident: {what} must be a contiguous float32 CUDA "
                    f"tensor of shape {shape}; got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
            if t.data_ptr() in seen:
                t = t.clone()
            seen.add(t.data_ptr())
            return t

        out = {**state}
        for key in [k for k in _KEYS if k in state]:
            out[key] = {c: own(t, f"{key}[{c}]")
                        for c, t in state[key].items()}
        out["pol"] = [{k: {c: own(t, f"pol[{pi}][{k}][{c}]")
                           for c, t in e[k].items()} for k in ("p", "pp")}
                      for pi, e in enumerate(state["pol"])]
        return out

    def _layout(self):
        """(state paths, parameter blocks, coefficients, vectors, vector
        table): the parameter blocks of both families and step parities
        with every per-site array named by its slot token -- the state
        arrays' slots first (state_paths), then the per-site coefficients'
        (chi1inv, the chi2/chi3 arrays, the ADE sigmas), whose tensors fill
        the rest of both sets -- and every per-axis vector (PML profiles,
        alive masks) by its vector token, the vectors' (tensor, axis)
        listed in `vectors` and their (address, axis), on the plan's
        device, in the table the kernel stages them from; built once."""
        if self._layout_ is not None:
            return self._layout_
        rp = self.rplan
        paths = state_paths(rp)
        tok = {p: _Tok(k) for k, p in enumerate(paths)}
        npol = len(rp.pol_specs_e + rp.pol_specs_h)
        view = {"f": {}, "f_u": {}, "f_w": {}, "f_bfast": {},
                "pol": [{"p": {}, "pp": {}} for _ in range(npol)]}
        for p in paths:
            if p[0] == "pol":
                view["pol"][p[1]][p[2]][p[3]] = tok[p]
            else:
                view[p[0]][p[1]] = tok[p]
        coef = []                        # addresses, in slot order
        vecs = []                        # (address, axis), in vector order
        pb, pd = [], []
        for par in (0, 1):
            # odd steps read P from the buffers even steps wrote into
            v = view if par == 0 else _swap_pols(view)
            for fam, out in (("b", pb), ("d", pd)):
                P = fdtd3d.build_params(rp, fam, v)
                for q in range(P.neh):
                    e = P.eh[q]
                    for name in ("u", "nreps", "nrchi2", "chi3", "chi2"):
                        setattr(e, name, self._coef_tok(
                            getattr(e, name), len(paths), coef))
                    for pc in e.pol:
                        pc.sigma = self._coef_tok(pc.sigma, len(paths), coef)
                    for name in ("kapw", "sigw"):
                        setattr(e, name, self._vec_tok(getattr(e, name),
                                                       e.w_ax, vecs))
                    for ax in range(3):
                        e.alive[ax] = self._vec_tok(e.alive[ax], ax, vecs)
                for q in range(P.ncurl):
                    cp = P.curl[q]
                    for names, ax in ((("kap", "sig", "siginv"), cp.sig_ax),
                                      (("kapu", "sigu", "siginvu"),
                                       cp.sigu_ax)):
                        for name in names:
                            setattr(cp, name, self._vec_tok(
                                getattr(cp, name), ax, vecs))
                    for ax in range(3):
                        cp.alive[ax] = self._vec_tok(cp.alive[ax], ax, vecs)
                out.append(P)
        self._bfast = self._bfast_table({p: k for k, p in enumerate(paths)},
                                        coef)
        ax = self._ax_table({p: k for k, p in enumerate(paths)}, coef)
        cyl = self._cyl_table({p: k for k, p in enumerate(paths)}, vecs)
        # the tensors behind the addresses the parameter blocks hold
        known = list(rp.coefs.values()) + [
            t for vv in rp.__dict__.get("_alive_cache", {}).values()
            for t in vv.values()]
        N = int(np.prod(self.shape))
        shape = self.shape + (1,) * (3 - len(self.shape))

        def tensor(addr, numel):
            for t in known:
                if t.data_ptr() == addr and t.numel() == numel:
                    return t.reshape(-1)
            raise RuntimeError(f"resident: no coefficient of {numel} "
                               f"values at address {addr:#x}")

        coef = [tensor(a, N) for a in coef]
        vec_t = [(tensor(a, shape[ax]), ax) for a, ax in vecs]
        table = torch.as_tensor(np.asarray(vecs, np.int64).reshape(-1, 2),
                                device=self.plan.device)
        self._cyl_dev = None if cyl is None else torch.frombuffer(
            bytearray(bytes(cyl)), dtype=torch.uint8).to(self.plan.device)
        self._ax_dev = None if ax is None else torch.frombuffer(
            bytearray(bytes(ax)), dtype=torch.uint8).to(self.plan.device)
        self._layout_ = (paths, pb, pd, coef, vec_t, table)
        return self._layout_

    def _cyl_table(self, slot, vecs):
        """The CYL variants' (2, NCOMP) CylP table (csrc/resident.cu), per
        family (0 B, 1 D) and curl component: the vector tokens of `{c}:rg`
        and `{c}:rfinv` (the r-weighted partner) and of `{c}:imr` (a beta
        plan's constant imr goes in `imc`), the slot token of the phi
        partner with ps = phi_sign sgn Courant (step._curl), and the axis
        correction of the component (step.axis_corrections): its partner's
        slot token, the partner's ring and the factor.  None for other
        plans."""
        rp = self.rplan
        if not _cyl(rp):
            return None
        tab = ((_CylP * fdtd3d.NCOMP) * 2)()
        phi_on = rp.m != 0 or rp.beta != 0.0
        for fam, specs, ft in ((0, rp.curl_specs_b, "b"),
                               (1, rp.curl_specs_d, "d")):
            fixes = {c: (g, ring, v)
                     for c, g, ring, v in axis_corrections(rp, ft)}
            for q, spec in enumerate(specs):
                c, t = spec.c, tab[fam][q]
                if spec.r_weighted and spec.g_plus is not None:
                    t.rg = self._vec_tok(rp.coefs[f"{c}:rg"].data_ptr(), 0,
                                         vecs)
                    t.rfinv = self._vec_tok(
                        rp.coefs[f"{c}:rfinv"].data_ptr(), 0, vecs)
                if spec.phi_comp is not None and phi_on:
                    sgn = 1.0 if spec.is_d else -1.0
                    t.phi = slot[("f", spec.phi_comp)] + 1
                    t.ps = spec.phi_sign * sgn * rp.courant
                    imr = rp.coefs[f"{c}:imr"]
                    if imr.numel() == 1:
                        t.imc = float(imr)
                    else:
                        t.imr = self._vec_tok(imr.data_ptr(), 0, vecs)
                if c in fixes:
                    g, ring, (re, im) = fixes[c]
                    t.ag, t.ar = slot[("f", g)] + 1, ring
                    t.are, t.aim = re, im
        return tab

    def _ax_table(self, slot, coef):
        """The anisotropic modes' AxTab (csrc/resident.cu), None for
        AX_NONE: per family (0 B, 1 D) and E (H) component the coefficient
        tokens of the off-diagonal chi1inv rows (step._eh_update's u1 and
        u2); the poles that run in the pole sub-update (gyrotropic ones,
        Lorentzian ones with an off-diagonal sigma row) as a bit mask, and
        for each of them and each component the SepP row: the kind, the
        slot tokens of its P entries, the tokens of sigma and of the
        off-diagonal rows the plain version adds (step.
        _pol_update_lorentzian's conditions), the drive fields' E (H)
        indices, the averages (step.gyro_avg) and the constants
        (step.gyro_constants)."""
        rp = self.rplan
        mode = ax_mode(rp)
        if mode == AX_NONE:
            return None
        gv = rp.gv
        tab = _AxTab()
        ns = len(slot)
        npol_e = len(rp.pol_specs_e)

        def ctok(key):
            return self._coef_tok(rp.coefs[key].data_ptr(), ns, coef)

        for fam, ehs, pols, pol0 in ((0, rp.eh_specs_h, rp.pol_specs_h,
                                      npol_e),
                                     (1, rp.eh_specs_e, rp.pol_specs_e, 0)):
            idx = {s.ec: q for q, s in enumerate(ehs)}
            for q, sp in enumerate(ehs):
                if sp.has_u1:
                    tab.u1[fam][q] = ctok(f"{sp.ec}:u1")
                if sp.has_u2:
                    tab.u2[fam][q] = ctok(f"{sp.ec}:u2")
            for p, pol in enumerate(pols):
                pi = pol0 + p
                gyro = pol.kind == "gyrotropic"
                if not _sep_pole(pol):
                    for q in range(fdtd3d.NCOMP):
                        tab.pole[fam][p][q].kind = -1
                    continue
                tab.sep[fam] |= 1 << p
                k = gyro_constants(rp, pol) if gyro else None
                for q in range(fdtd3d.NCOMP):
                    e = tab.pole[fam][p][q]
                    e.kind = -1
                    if q >= len(ehs):
                        continue
                    c = ehs[q].ec
                    if (c, G.component_direction(c)) not in pol.sigma:
                        continue
                    d0 = G.component_direction(c)
                    dd = (d0, G.cycle_direction(gv.dim, d0, 1),
                          G.cycle_direction(gv.dim, d0, 2))
                    keys = (c, f"{c}#1", f"{c}#2") if gyro else (c,)
                    for j, key in enumerate(keys):
                        e.p[j] = slot[("pol", pi, "p", key)] + 1
                        e.pp[j] = slot[("pol", pi, "pp", key)] + 1
                    e.sig = ctok(f"pol{pi}:{c}:{d0}")
                    for j, d in enumerate(dd):
                        e.w[j] = idx.get(c[0] + d, -1)
                    own = gv.axis_of(d0) if gv.has_direction(d0) else -1
                    for j, d in enumerate(dd[1:]):
                        off = gv.axis_of(d) if gv.has_direction(d) else -1
                        e.av[j][1], e.av[j][2] = own, off
                        e.av[j][0] = 0 if off < 0 and own < 0 else (
                            1 if off >= 0 and own >= 0 else
                            2 if own >= 0 else 3)
                    if not gyro:
                        e.kind = 0
                        for j, d in enumerate(dd[1:]):
                            key = f"pol{pi}:{c}:{d}"
                            if key in rp.coefs and e.w[j + 1] >= 0 \
                                    and gv.has_direction(d) and own >= 0:
                                e.so[j] = ctok(key)
                        continue
                    i0, i1, i2 = ("xyz".index(d) for d in dd)
                    g = k["gmat"]
                    if pol.saturated:
                        e.kind = 2
                        vals = (-k["w2pidt"], 0.5 * k["alpha"], k["dt2pi"],
                                k["g2pidt"])
                        pt = 1.0
                    else:
                        e.kind = 1
                        vals = (k["diag"], k["gamma1"], k["omega0dtsqr"],
                                0.0)
                        pt = k["pt"]
                    for m, v in enumerate(vals):
                        e.k[m] = v
                    for m, (a, b) in enumerate(((i0, i1), (i0, i2),
                                                (i1, i0), (i1, i2),
                                                (i2, i1), (i2, i0))):
                        e.c[m] = pt * float(g[a][b])
                    for m, (a, b) in enumerate(
                            (r, cc) for r in (i0, i1, i2)
                            for cc in (i0, i1, i2)):
                        e.inv[m] = float(k["inv"][a][b])
        return tab

    def _bfast_table(self, slot, coef):
        """BFAST's terms for the argument block (the PAIR_BFAST variant):
        per family (0 B, 1 D) and curl component q, [slot token of F, slot
        token of the taper (0: none), the E/H component whose W chain gives
        the decay where the curl has no chain (-1: none), k1, k2];
        components without a term get zeros (step._bfast_update)."""
        rp = self.rplan
        out = {}
        if rp.bfast_k is None:
            return out
        two = {s.c for s in bfast_specs(rp)}
        for fam, specs, ehs in ((0, rp.curl_specs_b, rp.eh_specs_h),
                                (1, rp.curl_specs_d, rp.eh_specs_e)):
            for q, spec in enumerate(specs):
                if spec.c not in two:
                    continue
                k1, k2 = bfast_ks(rp, spec)
                if k1 == 0.0 and k2 == 0.0:
                    continue
                c = spec.c
                tap = 0
                if f"{c}:bftap" in rp.coefs:
                    tap = self._coef_tok(rp.coefs[f"{c}:bftap"].data_ptr(),
                                         len(slot), coef)
                w = -1
                if spec.dsig_axis is None and spec.dsigu_axis is None:
                    ec = ("e" if c[0] == "d" else "h") + c[1]
                    if f"{ec}:sigw" in rp.coefs:
                        w = [s.ec for s in ehs].index(ec)
                out[fam, q] = (slot[("f_bfast", c)] + 1, tap, w,
                               float(k1), float(k2))
        return out

    @staticmethod
    def _vec_tok(addr, ax, vecs):
        """The token (vector + 1) of per-axis vector `addr` along axis `ax`
        (None or no axis: absent) in `vecs`."""
        if not addr or ax < 0:
            return 0
        if (addr, ax) not in vecs:
            vecs.append((addr, ax))
        return vecs.index((addr, ax)) + 1

    @staticmethod
    def _coef_tok(addr, nstate, coef):
        """The slot token of per-site coefficient array `addr` (None: absent)
        in `coef` (addresses of the slots from nstate on)."""
        if not addr:
            return 0
        if addr not in coef:
            coef.append(addr)
        return nstate + coef.index(addr) + 1

    def _device_key(self):
        """The device the launches go to: the current CUDA device (a plan
        on the host runs the host build of the emulation tests)."""
        if torch.device(self.plan.device).type == "cuda":
            return torch.cuda.current_device()
        return "host"

    def _tiling(self, lib):
        """The schedule of this plan on the current device: tiling()'s
        choice on the card's shared memory, or the direct schedule
        (`direct_tiling`) where tiles give no temporal reuse (more staged
        arrays than MAXSLOT, no tile that fits, or only T = 1), for a
        rotational fold or a Bloch-periodic plan, whose ghost and wrap
        reads lie outside any tile, and for a GYRO plan (its poles' sub-update
        runs on the direct schedule only).  Asked of the card once per
        device."""
        key = self._device_key()
        if self.schedule is not None and self.schedule[0] == key:
            return self.schedule[1]
        paths, pb, pd, coef, vecs, _ = self._layout()
        rp = self.rplan
        if key not in self._device:
            smem = (ctypes.c_int * 4)()
            rc = lib.mnt_k3_smem(smem)
            if rc != 0:
                raise RuntimeError(f"resident: shared memory (cudaError "
                                   f"{rc})")
            most, per_sm, reserve, _ = smem
            sms = lib.mnt_k3_sms()
            if sms < 1:
                raise RuntimeError(f"resident: SM count (cudaError {-sms})")
            self._device[key] = (min(most, per_sm - reserve) - STATIC_SMEM,
                                 sms)
        budget, sms = self._device[key]
        e = [0, 0, 0]
        for m in rp.dfts:
            if m.centered:
                ys_ = G.yee_shift(m.component, rp.gv.dim)
                for ax, dd in enumerate(rp.gv.axes):
                    if ys_[dd] == 0:
                        e[ax] = 1
        shape = self.shape + (1,) * (3 - len(self.shape))
        c = 1 if self._e_local() else 2
        nloops = len(rp.curl_specs_b + rp.eh_specs_h + rp.curl_specs_d
                     + rp.eh_specs_e)
        nslot = len(paths) + len(coef)
        tl = None
        variant = direct_variant(rp)
        if nslot <= MAXSLOT and variant == DIRECT and ax_mode(rp) != AX_GYRO:
            tl = tiling(shape, nslot, len(paths), c, e, nloops, budget, sms,
                        nvec=len(vecs))
        if tl is None or tl["T"] == 1:
            tl = direct_tiling(shape, c, e, variant)
        self.schedule = (key, tl)
        return tl

    def _nl(self):
        return int(any(s.has_chi3 or s.has_nr for s in self.rplan.eh_specs_e))

    def _blocks(self, lib, tl, probed):
        """The grid of a launch: min(tiles, co-resident blocks), or in the
        direct schedule one site per thread, at most the co-resident
        blocks; the occupancy asked once per device, variant and shared
        memory."""
        nl = self._nl()
        key = (self._device_key(), nl, int(probed), int(tl["direct"]),
               ax_mode(self.rplan), tl["smem"])
        if key not in self._most:
            most = lib.mnt_k3_max_blocks(*key[1:])
            if most < 1:
                raise RuntimeError(f"resident: occupancy (cudaError "
                                   f"{-most})")
            self._most[key] = most
        want = -(-tl["vol"] // (NTHR // 2 if nl else NTHR)) \
            if tl["direct"] else tl["ntile"]
        return min(want, self._most[key])

    def describe(self, nsteps: int, probed: bool) -> Dict[str, Any]:
        """The schedule of a stretch of nsteps on the current device:
        tiling()'s choice (or the direct schedule's), the grid's blocks,
        the passes and the grid barriers of the stretch: one per pass,
        less one per launch for K3, whose last pass needs none; in the
        direct schedule, a pass is a step and "barriers" gives the least
        and most a step takes (a step with sources of either family, or
        without a DTFT sample, differs)."""
        lib = _lib()
        tl = self._tiling(lib)
        chunks = [MAX_CHUNK] * (nsteps // MAX_CHUNK) + \
            ([nsteps % MAX_CHUNK] if nsteps % MAX_CHUNK else [])
        passes = sum(-(-n // tl["T"]) for n in chunks)
        if tl["direct"]:
            # the pole sub-updates' barriers: one after each family's
            sep = sum(any(_sep_pole(p) for p in pols) for pols in (
                self.rplan.pol_specs_e, self.rplan.pol_specs_h))
            least = 2 + int(not self._e_local()) + int(probed) + sep
            barriers = (least, 6 + sep
                        + int(probed or bool(self.rplan.dfts)))
        else:
            barriers = passes - (0 if probed else len(chunks))
        return {**tl, "blocks": self._blocks(lib, tl, probed),
                "passes": passes, "barriers": barriers}

    def _e_local(self):
        """E from D reads no neighbour (no live chi2/chi3 partner sums, no
        off-diagonal rows)."""
        rp = self.rplan
        live = {s.dc for s in rp.eh_specs_e}
        return not any(((s.has_chi3 or s.has_nr)
                        and (s.dc1 in live or s.dc2 in live))
                       or s.has_u1 or s.has_u2 for s in rp.eh_specs_e)

    def _site_tables(self, tl):
        """Per family, the source sites (every site where a source's dense
        arrays are nonzero), each with its sources' amplitudes in source
        order, as the kernel's CSR tables, and per tile the sites in its
        staged box; built once per tiling."""
        if self._tables is not None and self._tables[0] == tl:
            return self._tables[1]
        rp, dev = self.rplan, self.plan.device
        shape = self.shape + (1,) * (3 - len(self.shape))

        def i32(v):
            return torch.as_tensor(np.asarray(v, np.int32).reshape(-1),
                                   device=dev)

        def f32(v):
            return torch.as_tensor(np.asarray(v, np.float32).reshape(-1),
                                   device=dev)

        fams = []
        for fam, specs in (("b", rp.curl_specs_b), ("d", rp.curl_specs_d)):
            qof = {s.c: q for q, s in enumerate(specs)}
            contrib = {}                 # (q, off) -> [(si, re, im)]
            for si, s in enumerate(rp.sources):
                if ("d" if s.component[0] == "e" else "b") != fam:
                    continue
                dre = rp.coefs[f"src{si}:dense_re"].reshape(-1).cpu()
                dim_ = rp.coefs[f"src{si}:dense_im"].reshape(-1).cpu()
                q = qof[fam + s.component[1]]
                for off in torch.nonzero((dre != 0) | (dim_ != 0))[:, 0]:
                    o = int(off)
                    contrib.setdefault((q, o), []).append(
                        (si, dre[o].item(), dim_[o].item()))
            slots = sorted(contrib)
            start = np.cumsum([0] + [len(contrib[k]) for k in slots])
            flat = [c for k in slots for c in contrib[k]]
            where = np.array(np.unravel_index(
                np.asarray([o for _, o in slots], np.int64), shape),
                np.int64).reshape(3, -1).T
            lo, hi = staged_boxes(tl, shape, tl["T"])
            # (tile, site): the site lies in the tile's staged box
            inside = np.all((where[None] >= lo[:, None])
                            & (where[None] < hi[:, None]), axis=2)
            tstart = np.concatenate([[0], np.cumsum(inside.sum(1))])
            tslot = np.nonzero(inside)[1]
            fams.append({"slot_off": i32([o for _, o in slots]),
                         "slot_q": i32([q for q, _ in slots]),
                         "slot_start": i32(start),
                         "c_src": i32([c[0] for c in flat]),
                         "c_re": f32([c[1] for c in flat]),
                         "c_im": f32([c[2] for c in flat]),
                         "tstart": i32(tstart), "tslot": i32(tslot),
                         "nslot": len(slots)})
        self._tables = (tl, fams)
        return fams

    def _probe_tables(self, probes, tl, slot):
        """K4's tables for `probes` under tiling tl, on the plan's device:
        every probe's points (flat offsets, slot tokens, weights), each
        probe's and each tile's (its interior's) points, and the products'
        buffer (2, T, points); kept for the last probes and tiling."""
        cached = self._probes_
        if cached is not None and cached[1] is tl \
                and len(cached[0]) == len(probes) \
                and all(a is b for a, b in zip(cached[0], probes)):
            return cached[2]
        dev = self.plan.device
        shape = self.shape + (1,) * (3 - len(self.shape))
        table = _probe_table(self.rplan, probes)
        off = np.concatenate([o for _, _, o, _ in table])
        w = np.concatenate([w for _, _, _, w in table])
        tok = np.concatenate([np.full(len(o), slot[("f", c)] + 1)
                              for _, c, o, _ in table])
        where = np.array(np.unravel_index(off.astype(np.int64), shape))
        owner = np.zeros(len(off), np.int64)
        for ax in range(3):
            owner = owner * tl["nt"][ax] + where[ax] // tl["t"][ax]
        order = np.argsort(owner, kind="stable")
        tstart = np.searchsorted(owner[order], np.arange(tl["ntile"] + 1))

        def up(arr, dtype):
            return torch.as_tensor(np.ascontiguousarray(arr, dtype),
                                   device=dev)

        tabs = {"off": up(off, np.int32), "tok": up(tok, np.int32),
                "w": up(w, np.float32),
                "start": up(np.cumsum([0] + [len(o) for _, _, o, _ in table]),
                            np.int32),
                "tstart": up(tstart, np.int32), "tpt": up(order, np.int32),
                "prod": torch.empty(2 * tl["T"] * len(w),
                                    dtype=torch.float32, device=dev),
                "names": [name for name, _, _, _ in table],
                "npt": len(off)}
        self._probes_ = (list(probes), tl, tabs)
        return tabs

    def _pair(self, ins):
        """The second state set for `ins` (the state's arrays in slot
        order): the arrays an earlier call handed over, or new ones when
        there are none or one of them is among `ins`."""
        spare = self._spare
        mine = {t.data_ptr() for t in ins}
        if spare is None or any(t.data_ptr() in mine for t in spare):
            spare = [torch.empty_like(t) for t in ins]
        return spare

    def _direct_set(self, ins, tl):
        """The direct schedule's buffer for the state arrays `ins` (slot
        order) and the views of its state slots: one device buffer of the
        nslot arrays of tl["vol"] floats (the state's, then the
        coefficients') and the per-axis vectors (tl["gvec"] floats each),
        in which the kernel steps in place.  A state the last call returned
        comes back as those views, in the slots' order or with its P/PP
        roles swapped (then copied into slot order; the input's arrays are
        handed over); any other state is copied into a new buffer, so no
        state the caller still holds is written."""
        N, ns = tl["vol"], len(ins)
        pair = _is_pair(self.plan)
        got = [t.data_ptr() for t in ins]

        def fill(buf, half):
            # the state's arrays (a real pair's channel 1 in the second
            # half of the buffer)
            # (through a copy: the arrays may be views of this buffer)
            for ch in range(2 if pair else 1):
                buf[ch * half:ch * half + ns * N].copy_(torch.cat(
                    [(t[ch] if pair else t).reshape(-1) for t in ins]))

        if self._buf is not None:
            buf, views = self._buf
            mine = [t.data_ptr() for t in views]
            if got == mine:
                return self._buf
            if sorted(got) == sorted(mine):
                fill(buf, self._half)
                return self._buf
        if self._const is None:
            _, _, _, coef, vecs, _ = self._layout()
            gv = tl["gvec"]
            self._const = torch.cat(
                [t.to(torch.float32) for t in coef]
                + [torch.nn.functional.pad(t.to(torch.float32),
                                           (0, gv - t.numel()))
                   for t, _ in vecs]
                + [torch.zeros(0, device=self.plan.device)])
        half = ns * N + self._const.numel()
        buf = torch.empty((2 if pair else 1) * half, dtype=torch.float32,
                          device=self.plan.device)
        fill(buf, half)
        for ch in range(2 if pair else 1):
            buf[ch * half + ns * N:(ch + 1) * half].copy_(self._const)
        self._half = half
        if pair:
            st = tuple(torch.empty(self.shape, device="meta").stride())
            views = [buf.as_strided((2,) + self.shape, (half,) + st, k * N)
                     for k in range(ns)]
        else:
            views = [buf[k * N:(k + 1) * N].view(self.shape)
                     for k in range(ns)]
        self._buf = (buf, views)
        return self._buf

    def _launch(self, state, n, t0, probes):
        """One K3/K4 launch of n steps on the frequency-major state."""
        rp, dev = self.rplan, self.plan.device
        lib = _lib()
        paths, pb, pd, coef, vecs, vtab = self._layout()
        tl = self._tiling(lib)
        xs = build_xs(rp, n, t0)
        A = _ResArgs()
        keep = []                        # tensors the launch reads

        def up(arr, dtype):
            t = torch.as_tensor(np.ascontiguousarray(arr, dtype), device=dev)
            keep.append(t)
            return t.data_ptr()

        def up_table(table):
            """A ctypes structure or array copied to device memory; its
            address."""
            t = torch.frombuffer(bytearray(bytes(table)),
                                 dtype=torch.uint8).to(dev)
            keep.append(t)
            return t.data_ptr()

        for par in (0, 1):
            A.pb[par], A.pd[par] = pb[par], pd[par]
        ins = [_get(state, p) for p in paths]
        blocks = self._blocks(lib, tl, bool(probes))
        pair = _is_pair(rp)
        if tl["direct"]:
            buf, views = self._direct_set(ins, tl)
            A.base = buf.data_ptr()
            A.half = self._half if pair else 0
        else:
            spare = self._pair(ins)
            for k, (a, b) in enumerate(zip(ins, spare)):
                A.set[0][k], A.set[1][k] = a.data_ptr(), b.data_ptr()
            for k, t in enumerate(coef):
                A.set[0][len(paths) + k] = A.set[1][len(paths) + k] = \
                    t.data_ptr()
        t = A.tl
        for ax in range(3):
            t.t[ax], t.nt[ax], t.e[ax] = tl["t"][ax], tl["nt"][ax], \
                tl["e"][ax]
        t.T, t.c, t.vol = tl["T"], tl["c"], tl["vol"]
        t.nslot, t.nstate = len(paths) + len(coef), len(paths)
        t.nvec, t.gvec = len(vecs), tl["gvec"]
        t.direct = int(tl["direct"])
        A.vec = _ptr(vtab)
        # source currents (n, nsrc, 2) and the per-step flags
        nsrc = len(rp.sources)
        cur = np.zeros((n, max(nsrc, 1), 2), np.float32)
        flags = np.zeros(n, np.int32)
        for si, s in enumerate(rp.sources):
            cur[:, si, 0] = xs[f"src{si}:cur_re"]
            cur[:, si, 1] = xs[f"src{si}:cur_im"]
            on = (cur[:, si, 0] != 0) | (cur[:, si, 1] != 0)
            flags |= np.where(on, STEP_BSRC if s.component[0] == "h"
                              else STEP_DSRC, 0).astype(np.int32)
        A.cur, A.nsrc = up(cur, np.float32), nsrc
        for fi, tab in enumerate(self._site_tables(tl)):
            sf = A.src[fi]
            for key in ("slot_off", "slot_q", "slot_start", "c_src", "c_re",
                        "c_im", "tstart", "tslot"):
                setattr(sf, key, _ptr(tab[key]))
            sf.nslot = tab["nslot"]
        # DTFT monitors
        gv = rp.gv
        slot = {p: k for k, p in enumerate(paths)}
        dtab = (_DftM * max(len(rp.dfts), 1))()
        for mi, m in enumerate(rp.dfts):
            d = dtab[mi]
            phr, phi = xs[f"dft{mi}:ph_re"], xs[f"dft{mi}:ph_im"]
            flags |= np.where(np.any(phr != 0, 1) | np.any(phi != 0, 1),
                              STEP_DFT, 0).astype(np.int32)
            d.acc = _ptr(state["dft"][m.name])
            d.f = slot[("f", m.component)] + 1
            if f"dft{mi}:w" in rp.coefs:
                d.w = _ptr(rp.coefs[f"dft{mi}:w"])
            else:                          # complex weights (LDOS)
                d.w = _ptr(rp.coefs[f"dft{mi}:wre"])
                d.wi = _ptr(rp.coefs[f"dft{mi}:wim"])
            d.phr, d.phi = up(phr, np.float32), up(phi, np.float32)
            d.nfreq = len(m.freqs)
            ext = [b - a for a, b in m.region] + [1] * (3 - len(m.region))
            lo = [a for a, _ in m.region] + [0] * (3 - len(m.region))
            d.R = int(np.prod(ext))
            for ax in range(3):
                d.lo[ax], d.n[ax] = lo[ax], ext[ax]
            ys_ = G.yee_shift(m.component, gv.dim)
            avg = [ax for ax, dd in enumerate(gv.axes)
                   if ys_[dd] == 0] if m.centered else []
            d.navg = len(avg)
            for b, ax in enumerate(avg):
                d.avg[b] = ax
        A.dft, A.ndft = up_table(dtab), len(rp.dfts)
        A.flags = up(flags, np.int32)
        # probes (K4): every probe's points, and per tile the points of its
        # interior
        series = {}
        if probes:
            tabs = self._probe_tables(probes, tl, slot)
            pr = A.pr
            for key in ("off", "tok", "w", "start", "tstart", "tpt", "prod"):
                setattr(pr, key, tabs[key].data_ptr())
            out = torch.empty((len(tabs["names"]), n) + ((2,) if pair
                                                         else ()),
                              dtype=torch.float32, device=dev)
            pr.series = out.data_ptr()
            pr.nprobe, pr.npt = len(tabs["names"]), tabs["npt"]
            series = {name: out[i] for i, name in enumerate(tabs["names"])}
        A.dt = rp.dt
        A.nsteps = n
        A.e_local = int(self._e_local())
        set_ghosts(A, rp, slot)
        A.cyl = _ptr(self._cyl_dev)
        A.axmode, A.ax = ax_mode(rp), _ptr(self._ax_dev)
        for fam in (0, 1):
            for q in range(fdtd3d.NCOMP):
                A.bf[fam][q], A.bt[fam][q], A.bw[fam][q], k1, k2 = \
                    self._bfast.get((fam, q), (0, 0, -1, 0.0, 0.0))
                A.bk[fam][q][0], A.bk[fam][q][1] = k1, k2
        args = up_table(A)
        rc = lib.mnt_k3_launch(ctypes.byref(A), args, blocks, tl["smem"],
                               torch.cuda.current_stream().cuda_stream)
        if probes:
            self.probed_launches += 1
        else:
            self.launches += 1
        if rc != 0:
            raise RuntimeError(f"resident kernel launch failed: cudaError "
                               f"{rc}")
        if tl["direct"]:
            # stepped in place: the buffer's views hold the state
            state = _with(state, paths, views)
        elif -(-n // tl["T"]) % 2:
            # the last of the launch's ceil(n / T) passes wrote set 1 when
            # their count is odd: the input's arrays become the second set
            state = _with(state, paths, spare)
            self._spare = ins
        else:
            self._spare = spare
        # new P went into the PP buffers on even steps: after an odd count
        # the buffers' roles are swapped
        if n % 2:
            state = _swap_pols(state)
        return state, series


# ---------------------------------------------------------------------------
# the production entries
# ---------------------------------------------------------------------------


def _kernel(plan) -> ResidentKernel:
    ker = plan.__dict__.get("_resident_kernel")
    if ker is None:
        ker = plan._resident_kernel = ResidentKernel(plan)
    return ker


def _takes(plan) -> bool:
    """Whether the resident route may step this plan.  It keeps the PML
    auxiliaries full-grid; once the hybrid route has stepped the plan's
    state with slab-local chains (plan.slab_opt: f_u and f_w stale outside
    their slabs) the full-grid chains would read that stale state, so the
    plan stays off this route (the reverse switch is exact: a full-grid
    state is a valid slab-local one)."""
    return not plan.slab_opt and not plan.slab_store \
        and resident_supported(plan)


def resident_probed_run(plan, state, nsteps: int, t0: int,
                        probes: Sequence[ProbeSpec]) -> Optional[tuple]:
    """(state, {name: series}) through K4, or None outside the envelope
    (resident.py:478); the caller then runs the eager stepper."""
    if not _takes(plan):
        return None
    if any(p.component not in state["f"] for p in probes):
        return None
    return _kernel(plan).run_probed(state, nsteps, t0, probes)


def resident_run(plan, state, nsteps: int, t0: int
                 ) -> Optional[Dict[str, Any]]:
    """The state advanced by nsteps through K3, or None outside the
    envelope, and for 3D plans whose doubled state exceeds PREFER_BYTES
    when a hybrid kernel takes them (resident.py:510-533)."""
    if not _takes(plan):
        return None
    if plan.gv.dim == "3d" \
            and 2 * _state_bytes(plan) > PREFER_BYTES \
            and (fdtd3d_t2.supported(plan) or fdtd3d.supported(plan)):
        return None
    return _kernel(plan).run(state, nsteps, t0)


# ---------------------------------------------------------------------------
# the bound
# ---------------------------------------------------------------------------


def step_cost(plan, nsteps: int) -> Dict[str, float]:
    """Bytes and operations of one launch of nsteps steps: the state read
    once and written once, the coefficients and per-step tables read once
    (`bytes`); per site and step the arithmetic of the per-site functions
    (curl + chains ~12 per D/B component, E/H update ~6 per component, the
    NR solve ~150 and the ADE ~8 per material site, BFAST's term ~16 per
    component that has one; on a cylindrical or beta plan 3 per site of
    an r-weighted difference, 2 of a phi term, 3 per ring site of an axis
    correction; an off-diagonal chi1inv row 5 per site where it is
    nonzero, a gyrotropic pole ~60 per site of its sigma), the
    sources and the DTFT (`ops`).  `stream_bytes` is what
    a kernel that kept nothing on chip between steps would move per step:
    the state read and written and the coefficients read."""
    rp = resident_plan(plan)
    shape = tuple(rp.storage_shape or rp.gv.shape)
    N = int(np.prod(shape))
    state = _state_bytes(rp) - 4
    # what the kernel reads: the chain vectors and material arrays of each
    # component, the polarization sigmas, the monitor weights (both parts
    # of complex ones, `dft{mi}:wre` and `:wim`; the masks reach it as
    # per-axis vectors, the sources as site lists)
    comps = [s.c for s in rp.curl_specs_b + rp.curl_specs_d] + \
        [s.ec for s in rp.eh_specs_e + rp.eh_specs_h]
    keys = [k for k in rp.coefs
            if k.split(":")[0] in comps or k.startswith(("pol", "dft"))]
    coef = sum(int(rp.coefs[k].numel()) * rp.coefs[k].element_size()
               for k in keys)
    nfreq = sum(len(m.freqs) for m in rp.dfts)
    table = nsteps * 4 * (2 * len(rp.sources) + 2 * nfreq + 1)
    ncomp = len(rp.curl_specs_b + rp.curl_specs_d)
    nl = sum(int(torch.count_nonzero(rp.coefs[f"{s.ec}:nrchi2"]))
             for s in rp.eh_specs_e if s.has_nr)
    pol = sum(int(torch.count_nonzero(rp.coefs[f"pol{pi}:{c}:{d}"]))
              for pi, p in enumerate(rp.pol_specs_e + rp.pol_specs_h)
              for (c, d) in p.sigma)
    # per region site: the weight product(s), then per frequency 2
    # products and 2 sums, or with a complex weight or a real pair's
    # complex field 4 products and 4 sums; a real pair steps every field
    # twice
    pair = _is_pair(rp)
    region = sum(int(np.prod([b - a for a, b in m.region])) * (
        (4 + 4 * len(m.freqs)) if f"dft{mi}:w" in rp.coefs and not pair
        else (5 + 8 * len(m.freqs))) for mi, m in enumerate(rp.dfts))
    ch = 2 if pair else 1
    # BFAST: two partner sums, two scaled terms, the taper, the decay and
    # the flip-flop, the chains' scaling of the change, f and f_u
    nbf = 0 if rp.bfast_k is None else sum(
        1 for s in bfast_specs(rp) if any(bfast_ks(rp, s)))
    # cylindrical / beta: the r-weighted difference (3 more products), the
    # phi term (its factor phi_sign * sgn * dtdx * imr depends on r alone,
    # so a product by the partner and the sum; the pair's rotation only
    # swaps channels and folds its sign into that factor), and per ring
    # site of the axis corrections 3 (read in `bytes` with the coefficients)
    ncyl = 0
    if _cyl(rp):
        curls = rp.curl_specs_b + rp.curl_specs_d
        nrw = sum(1 for s in curls if s.r_weighted and s.g_plus is not None)
        nphi = sum(1 for s in curls if s.phi_comp is not None) \
            if rp.m != 0 or rp.beta != 0.0 else 0
        nax = len(axis_corrections(rp, "b") + axis_corrections(rp, "d"))
        ncyl = 3 * nrw * N + 2 * nphi * N + 3 * nax * (N // shape[0])
    # the off-diagonal rows (OFFDIAG), where a row is nonzero: t = (g + g
    # one site back along the partner's axis) u, a sum and a product per
    # site of u, which E at that site and E one site back along its own
    # axis share, then E's average t + t' scaled by 1/4 and its sum into
    # E, 5 (the partner's D - P, g, is its own E update's); a gyrotropic
    # pole (GYRO) per site of its sigma ~60 beside the ADE's 8 counted
    # above: the partners' two averages, the three r rows, the 3x3 solve
    nod_ops = 5 * sum(int(torch.count_nonzero(rp.coefs[f"{s.ec}:{u}"]))
                      for s in rp.eh_specs_e
                      for u, has in (("u1", s.has_u1), ("u2", s.has_u2))
                      if has)
    gyro = sum(int(torch.count_nonzero(rp.coefs[f"pol{pi}:{c}:{d}"]))
               for pi, p in enumerate(rp.pol_specs_e + rp.pol_specs_h)
               if p.kind == "gyrotropic" for (c, d) in p.sigma)
    ops_step = ch * (18 * ncomp * N + 8 * pol + 16 * nbf * N + ncyl
                     + nod_ops + 52 * gyro) + 150 * nl + region
    return {"bytes": float(2 * state + coef + table),
            "ops": float(nsteps * ops_step),
            "stream_bytes": float(2 * state + coef)}
