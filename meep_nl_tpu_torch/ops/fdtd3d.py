"""K1: one full 3D Yee step as hand-written CUDA kernels (csrc/fdtd3d.cu).

The port of ``meep_nl_tpu/ops/pallas/fdtd3d.py`` (``_build_call``, driven by
``Fdtd3dKernel``).  It computes exactly the eager ``make_step`` without the
DTFT update, on the eager stepper's own state dict, so ``to_full`` and
``from_full`` are the identity in this slice (the TPU kernel's compact
D/B-only layout is a bytes optimisation for a later slice).

`Fdtd3dKernel.step` launches the kernels when the state lies on a CUDA
device and updates its tensors in place (the returned dict carries the
swapped polarization buffers); for a state on the CPU it runs the plain
version `step_ref` instead.  Each kernel object counts its CUDA launches
(`launches`) and the steps its plain version took (`plain_steps`).
"""

from __future__ import annotations

import ctypes
import math
from typing import Any, Dict

import numpy as np
import torch

from ..core.device import torch_dtype
from ..stepper.step import (NR_ITERS, alive_vectors, build_xs, make_step,
                            source_index, xs_rows)

MAXPOL = 4
NCOMP = 3
MODE_B, MODE_H, MODE_BH, MODE_D, MODE_E = range(5)


def supported(plan) -> bool:
    """The semantic envelope of the JAX package's fdtd3d.supported
    (fdtd3d.py:105-197): 3D, real fields, no H polarizations, E-family
    Lorentzian/Drude with diagonal sigma and no noise, no conductivity, no
    off-diagonal u, no periodicity, no cylindrical m, no BFAST, no
    integrated sources, no rot2/rot4/x-mirror, plane-representable masks.

    Differences, all deliberate: the TPU-only conditions (the block depth
    bx, the VMEM budgets, the x-interior dispersive window of `_Layout`)
    are dropped, since this kernel has no x-blocks; y/z node mirrors, which
    the JAX kernel admits, are declined because the port's stepper does
    not run symmetry folds yet; at most MAXPOL polarizations."""
    gv = plan.gv
    if gv.dim != "3d" or plan.complex_fields or plan.bfast_k is not None:
        return False
    if plan.rot2 is not None or plan.rot4 is not None or plan.mirror_node:
        return False
    if plan.pol_specs_h or len(plan.pol_specs_e) > MAXPOL:
        return False
    for p in plan.pol_specs_e:
        if p.kind != "lorentzian" or p.noise_amp != 0.0:
            return False
        if any(d != c[1] for (c, d) in p.sigma):
            return False
    if any(plan.periodic) or plan.m:
        return False
    if any(s.has_cond or s.folded_cond
           for s in plan.curl_specs_d + plan.curl_specs_b):
        return False
    for s in plan.eh_specs_e + plan.eh_specs_h:
        if s.has_u1 or s.has_u2:
            return False
        if (s.has_chi3 or s.has_nr) and s.ec[0] != "e":
            return False
    if any(planes is None for planes in (plan.mask_planes or {}).values()):
        return False
    return not any(s.is_integrated for s in plan.sources)


def step_ref(plan):
    """The plain version: the eager make_step without the DTFT update
    (whatever plan.use_pallas says)."""
    return make_step(plan, dft=False, use_pallas=False)


# ---------------------------------------------------------------------------
# the C parameter block (mirrors csrc/fdtd3d_site.cuh; every member is 8
# bytes)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_longlong


class _CurlP(ctypes.Structure):
    _fields_ = ([(n, _P) for n in ("f", "fu", "gp", "gm", "kap", "sig",
                                   "siginv", "kapu", "sigu", "siginvu")]
                + [("alive", _P * 3)]
                + [(n, _I) for n in ("ap", "am", "sig_ax", "sig_lo",
                                     "sig_hi", "sig_n", "sigu_ax", "sigu_lo",
                                     "sigu_hi", "sigu_n", "slab")])


class _PolC(ctypes.Structure):
    _fields_ = [("p", _P), ("pp", _P), ("sigma", _P)]


class _EhP(ctypes.Structure):
    _fields_ = ([(n, _P) for n in ("f", "fw", "d", "u", "kapw", "sigw",
                                   "nreps", "nrchi2", "chi3", "chi2")]
                + [("alive", _P * 3), ("pol", _PolC * MAXPOL)]
                + [(n, _I) for n in ("w_ax", "w_lo", "w_hi", "w_n", "w_slab",
                                     "dc1", "dc2", "ax_own", "ax_1", "ax_2")])


class _Params(ctypes.Structure):
    _fields_ = [("curl", _CurlP * NCOMP), ("eh", _EhP * NCOMP),
                ("pg1inv", ctypes.c_double * MAXPOL),
                ("pg1", ctypes.c_double * MAXPOL),
                ("p2md", ctypes.c_double * MAXPOL),
                ("pw2", ctypes.c_double * MAXPOL),
                ("csgn", ctypes.c_double)] + \
        [(n, _I) for n in ("ncurl", "neh", "npol", "S0", "S1", "S2", "sgn",
                           "nr_iters", "R")]


def _lib():
    from . import _build
    lib = _build.load("fdtd3d")
    if not getattr(lib, "_mnt_bound", False):
        lib.mnt_k1_params_size.restype = ctypes.c_longlong
        lib.mnt_k1_half.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p]
        lib.mnt_k1_half.restype = ctypes.c_int
        lib.mnt_k1_source.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
        lib.mnt_k1_source.restype = ctypes.c_int
        if lib.mnt_k1_params_size() != ctypes.sizeof(_Params):
            raise RuntimeError("csrc/fdtd3d_site.cuh Params layout does not "
                               "match ops/fdtd3d.py")
        lib._mnt_bound = True
    return lib


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def build_params(plan, family: str, state) -> _Params:
    """The parameter block of one half step of `plan` over `state`: family
    'b' (curl B, H from B with the H-family polarizations) or 'd' (curl D,
    E from D with the E-family ones).  A 2D plan is the grid (S0, S1, 1):
    no curl partner or chain lies along the absent axis."""
    C = plan.coefs
    dtype = torch_dtype(plan.dtype)
    shape = tuple(plan.storage_shape or plan.gv.shape)
    P = _Params()
    P.S0, P.S1, P.S2 = shape + (1,) * (3 - len(shape))
    P.R = P.S0                        # the state holds every x-plane
    P.nr_iters = NR_ITERS
    is_d = family == "d"
    curls = plan.curl_specs_d if is_d else plan.curl_specs_b
    ehs = plan.eh_specs_e if is_d else plan.eh_specs_h
    P.csgn = (1.0 if is_d else -1.0) * plan.courant
    P.sgn = 1 if is_d else -1
    P.ncurl, P.neh = len(curls), len(ehs)
    slab = 1 if plan.slab_opt else 0

    def vec(key):
        return _ptr(C[key]) if key in C else 0

    for q, s in enumerate(curls):
        cp = P.curl[q]
        cp.f = _ptr(state["f"][s.c])
        cp.fu = _ptr(state["f_u"].get(s.c))
        cp.gp = _ptr(state["f"][s.g_plus]) if s.g_plus else 0
        cp.gm = _ptr(state["f"][s.g_minus]) if s.g_minus else 0
        cp.ap = s.plus_axis if s.plus_axis is not None else -1
        cp.am = s.minus_axis if s.minus_axis is not None else -1
        cp.kap, cp.sig, cp.siginv = (vec(f"{s.c}:kap"), vec(f"{s.c}:sig"),
                                     vec(f"{s.c}:siginv"))
        cp.kapu, cp.sigu, cp.siginvu = (vec(f"{s.c}:kapu"),
                                        vec(f"{s.c}:sigu"),
                                        vec(f"{s.c}:siginvu"))
        cp.sig_ax = -1 if s.dsig_axis is None else s.dsig_axis
        if s.dsig_axis is not None:
            cp.sig_lo, cp.sig_hi = s.dsig_slabs
            cp.sig_n = plan.gv.num[s.dsig_axis] + 1
        cp.sigu_ax = -1 if s.dsigu_axis is None else s.dsigu_axis
        if s.dsigu_axis is not None:
            cp.sigu_lo, cp.sigu_hi = s.dsigu_slabs
            cp.sigu_n = plan.gv.num[s.dsigu_axis] + 1
        cp.slab = slab
        alive = alive_vectors(plan, s.c, dtype, plan.device)
        for ax in range(3):
            cp.alive[ax] = _ptr(alive.get(ax))

    dc_index = {s.dc: q for q, s in enumerate(ehs)}
    pols = plan.pol_specs_e if is_d else plan.pol_specs_h
    pol0 = 0 if is_d else len(plan.pol_specs_e)      # index in state["pol"]
    has_pols = bool(pols)
    P.npol = len(pols)
    for pi, p in enumerate(pols):
        w2pi = 2 * math.pi * p.omega0
        g2pi = 2 * math.pi * p.gamma
        omega0dtsqr = (w2pi * plan.dt) ** 2
        P.pg1inv[pi] = 1.0 / (1 + 0.5 * g2pi * plan.dt)
        P.pg1[pi] = 1 - 0.5 * g2pi * plan.dt
        P.p2md[pi] = 2 - (0.0 if p.drude else omega0dtsqr)
        P.pw2[pi] = omega0dtsqr
    for q, s in enumerate(ehs):
        ep = P.eh[q]
        ep.f = _ptr(state["f"][s.ec])
        ep.fw = _ptr(state["f_w"].get(s.ec))
        ep.d = _ptr(state["f"][s.dc])
        ep.u = vec(f"{s.ec}:u") if s.has_u else 0
        ep.w_ax = -1 if s.dsigw_axis is None else s.dsigw_axis
        if s.dsigw_axis is not None:
            ep.kapw, ep.sigw = vec(f"{s.ec}:kapw"), vec(f"{s.ec}:sigw")
            ep.w_lo, ep.w_hi = s.dsigw_slabs
            ep.w_n = plan.gv.num[s.dsigw_axis] + 1
            ep.w_slab = 1 if (plan.slab_opt and not has_pols) else 0
        if s.has_nr:
            ep.nreps, ep.nrchi2 = (vec(f"{s.ec}:nreps"),
                                   vec(f"{s.ec}:nrchi2"))
        if s.has_chi3:
            ep.chi3, ep.chi2 = vec(f"{s.ec}:chi3"), vec(f"{s.ec}:chi2")
        ep.dc1 = dc_index.get(s.dc1, -1) if s.dc1 else -1
        ep.dc2 = dc_index.get(s.dc2, -1) if s.dc2 else -1
        ep.ax_own = -1 if s.ax_own is None else s.ax_own
        ep.ax_1 = -1 if s.ax_1 is None else s.ax_1
        ep.ax_2 = -1 if s.ax_2 is None else s.ax_2
        alive = alive_vectors(plan, s.ec, dtype, plan.device)
        for ax in range(3):
            ep.alive[ax] = _ptr(alive.get(ax))
        for pi in range(len(pols)):
            pst = state["pol"][pol0 + pi]
            if s.ec in pst["p"]:
                ep.pol[pi].p = _ptr(pst["p"][s.ec])
                ep.pol[pi].pp = _ptr(pst["pp"][s.ec])
                ep.pol[pi].sigma = vec(f"pol{pol0 + pi}:{s.ec}:{s.ec[1]}")
    return P


class Fdtd3dKernel:
    """One K1 step driver for one plan (the counterpart of the JAX
    package's Fdtd3dKernel)."""

    def __init__(self, plan):
        if not supported(plan):
            raise ValueError("plan outside the fdtd3d kernel envelope")
        self.plan = plan
        self.shape = tuple(plan.storage_shape or plan.gv.shape)
        self.dtype = torch_dtype(plan.dtype)
        self._ref = step_ref(plan)
        self.launches = 0                 # CUDA launches
        self.plain_steps = 0              # steps of the plain version
        b_src = [si for si, s in enumerate(plan.sources)
                 if s.component[0] == "h"]
        d_src = [si for si, s in enumerate(plan.sources)
                 if s.component[0] == "e"]
        self.sources = {"b": b_src, "d": d_src}
        #: CUDA launches per step
        self.launches_per_step = (3 + len(d_src)
                                  + (1 + len(b_src) if b_src else 0))
        # flat storage offsets of the source sites
        S1, S2 = self.shape[1], self.shape[2]
        self._src_off = {}
        for si in b_src + d_src:
            i, j, k = source_index(plan, si)
            self._src_off[si] = ((i * S1 + j) * S2 + k).contiguous()

    # ---- the identity conversions of this slice ---------------------------
    def to_full(self, state, C=None):
        return state

    def from_full(self, full):
        return full

    # ---- stepping ----------------------------------------------------------
    def step(self, state: Dict[str, Any], x_t: Dict[str, Any]
             ) -> Dict[str, Any]:
        """Advance one step.  CUDA state: in place through the kernels;
        CPU state: the plain version (a new state)."""
        dev = state["f"][self.plan.curl_specs_d[0].c].device
        if dev.type == "cpu":
            self.plain_steps += 1
            return self._ref(state, x_t)
        if dev.type != "cuda":
            raise RuntimeError(f"fdtd3d: unsupported device {dev}")
        return self._step_cuda(state, x_t)

    def run(self, state, nsteps: int, t0: int = 0):
        rows = xs_rows(self.plan, build_xs(self.plan, nsteps, t0))
        for i in range(nsteps):
            state = self.step(state, rows[i] if rows else {})
        return state

    # ---- CUDA path ---------------------------------------------------------
    def _check(self, state):
        """Device, dtype, shape and contiguity of every state tensor; clone
        tensors that share storage (the kernels update in place)."""
        if torch.device(self.plan.device).type != "cuda":
            raise RuntimeError("fdtd3d: the plan's coefficients are not on "
                               "a CUDA device")
        seen = set()
        for key in ("f", "f_u", "f_w"):
            for c, t in state[key].items():
                self._check_one(t, f"{key}[{c}]")
                if t.data_ptr() in seen:
                    state[key][c] = t = t.clone()
                seen.add(t.data_ptr())
        for pi, e in enumerate(state["pol"]):
            for k in ("p", "pp"):
                for c, t in e[k].items():
                    self._check_one(t, f"pol[{pi}][{k}][{c}]")
                    if t.data_ptr() in seen:
                        e[k][c] = t = t.clone()
                    seen.add(t.data_ptr())

    def _check_one(self, t, what):
        if t.device.type != "cuda" or t.dtype != self.dtype \
                or tuple(t.shape) != self.shape or not t.is_contiguous():
            raise ValueError(
                f"fdtd3d: {what} must be a contiguous {self.dtype} CUDA "
                f"tensor of shape {self.shape}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")

    def _launch(self, lib, P, mode):
        rc = lib.mnt_k1_half(ctypes.byref(P), mode,
                             1 if self.dtype == torch.float64 else 0,
                             torch.cuda.current_stream().cuda_stream)
        self.launches += 1
        if rc != 0:
            raise RuntimeError(f"fdtd3d kernel launch (mode {mode}) failed: "
                               f"cudaError {rc}")

    def _sources(self, lib, family, state, x_t):
        plan, C = self.plan, self.plan.coefs
        fp64 = 1 if self.dtype == torch.float64 else 0
        for si in self.sources[family]:
            s = plan.sources[si]
            f = state["f"][family + s.component[1]]
            off = self._src_off[si]
            rc = lib.mnt_k1_source(
                f.data_ptr(), off.data_ptr(), C[f"src{si}:amp_re"].data_ptr(),
                C[f"src{si}:amp_im"].data_ptr(), off.numel(),
                float(x_t[f"src{si}:cur_re"]), float(x_t[f"src{si}:cur_im"]),
                plan.dt, fp64, torch.cuda.current_stream().cuda_stream)
            self.launches += 1
            if rc != 0:
                raise RuntimeError(f"fdtd3d source launch failed: "
                                   f"cudaError {rc}")

    def _step_cuda(self, state, x_t):
        self._check(state)
        lib = _lib()
        pb = build_params(self.plan, "b", state)
        if self.sources["b"]:
            self._launch(lib, pb, MODE_B)
            self._sources(lib, "b", state, x_t)
            self._launch(lib, pb, MODE_H)
        else:
            self._launch(lib, pb, MODE_BH)
        pd = build_params(self.plan, "d", state)
        self._launch(lib, pd, MODE_D)
        self._sources(lib, "d", state, x_t)
        self._launch(lib, pd, MODE_E)
        # the new P was written into the PP buffers: swap the roles
        pol = [{"p": dict(e["pp"]), "pp": dict(e["p"])}
               for e in state["pol"]]
        return {**state, "pol": pol, "t": state["t"] + 1}


# ---------------------------------------------------------------------------
# the bound: bytes and operations one step must move / do
# ---------------------------------------------------------------------------


def _box_sites(plan, key, shape):
    box = (plan.support_boxes or {}).get(key, "full")
    if box == "full":
        return int(np.prod(shape))
    if box is None:
        return 0
    return int(np.prod([b - a for a, b in box]))


def step_cost(plan) -> Dict[str, float]:
    """Bytes and floating-point operations of one K1 step on the full-state
    layout, each input read once and each output written once, counting
    what this plan's data needs: f_u and the slab-mode f_w only on their
    PML slabs, polarizations and material windows only over the support
    boxes the plan recorded.  `ops` is a per-site count of the arithmetic
    in csrc/fdtd3d.cu (curl + chains ~12, E/H update ~6, the NR solve ~150
    per nonlinear site and component, the ADE ~8)."""
    shape = tuple(plan.storage_shape or plan.gv.shape)
    N = int(np.prod(shape))
    item = np.dtype(plan.dtype).itemsize
    plane = {ax: N // shape[ax] for ax in range(3)}

    def slab_sites(ax, slabs):
        lo, hi = slabs
        return (lo + hi) * plane[ax]

    has_pols = bool(plan.pol_specs_e)
    elems = 0
    for s in plan.curl_specs_b + plan.curl_specs_d:
        elems += 2 * N                                   # D/B read + write
        if s.dsigu_axis is not None:
            n = N if not plan.slab_opt else slab_sites(s.dsigu_axis,
                                                       s.dsigu_slabs)
            elems += 2 * n
    for s in plan.eh_specs_e + plan.eh_specs_h:
        elems += 2 * N                                   # E/H read + write
        if s.dsigw_axis is not None:
            full = not plan.slab_opt or (has_pols and s.ec[0] == "e")
            n = N if full else slab_sites(s.dsigw_axis, s.dsigw_slabs)
            elems += 2 * n
        if s.has_u:
            elems += N
        if s.has_nr:
            elems += N + _box_sites(plan, f"{s.ec}:nrchi2", shape)
        if s.has_chi3:
            elems += (_box_sites(plan, f"{s.ec}:chi3", shape)
                      + _box_sites(plan, f"{s.ec}:chi2", shape))
    nl_sites = 0
    for s in plan.eh_specs_e:
        if s.has_nr:
            nl_sites += _box_sites(plan, f"{s.ec}:nrchi2", shape)
    pol_sites = 0
    for pi, p in enumerate(plan.pol_specs_e):
        for (c, d) in p.sigma:
            n = _box_sites(plan, f"pol{pi}:{c}:{d}", shape)
            elems += 4 * n                    # sigma, P, PP read; new P
            pol_sites += n
    ncomp = len(plan.curl_specs_b + plan.curl_specs_d)
    ops = 12 * ncomp * N + 6 * ncomp * N + 150 * nl_sites + 8 * pol_sites
    return {"bytes": float(elems * item), "ops": float(ops)}
