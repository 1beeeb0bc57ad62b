"""K5: one fused half step (curl, PML chains, E/H from D/B, W chain, masks)
as a hand-written CUDA kernel (csrc/fused.cu), the step behind
``Simulation(use_pallas=True)``.

The port of ``meep_nl_tpu/ops/pallas/fused.py``.  `make_step` takes this
route when `plan.use_pallas` is set and `pallas_supported(plan)` holds (see
`takes`): per step the B half, its source fix-up, the D half, its fix-up,
then the DTFT update.  Unlike the eager stepper it injects the current
sources after E/H is computed and carries dD through the linear E-from-D at
the source sites only, so the two routes agree to round-off, not bit for
bit; the chains run full-grid, as the reference's do.

`HalfStepKernel(plan, ft2)` is one half ('b' or 'd'): on a state on the
card it launches the kernel and updates the tensors in place; on a CPU
state it runs the plain version `half_step_ref`.  `SourceFixup` is the
fix-up of one family: one small launch per current source on the card,
PyTorch scatter-adds on the CPU.  Each object counts its CUDA launches
(`launches`) and the calls its plain version took (`plain_steps`).

Not carried over, being TPU artifacts and not semantics: the VMEM tile
search (`tx`, MNT_PALLAS_VMEM_KIB, :78-95), the materialised x-shifted
copies (`make_shifted`, :315) and MNT_PALLAS_INTERPRET.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.device import torch_dtype
from ..stepper.step import _apply_mask, _curl, alive_vectors, source_index


def pallas_supported(plan) -> bool:
    """The envelope of the reference's pallas_supported (fused.py:37): 3D,
    real fields, diagonal (or vacuum) media, uPML, no conductivity,
    dispersion, nonlinearity, BFAST, periodic axes or symmetry folds, and
    every mask a list of dead planes."""
    if plan.rot2 is not None or plan.rot4 is not None or plan.mirror_node:
        return False
    if plan.gv.dim != "3d" or plan.complex_fields or plan.bfast_k is not None:
        return False
    if plan.pol_specs_e or plan.pol_specs_h:
        return False
    if plan.have_fmp_e or plan.have_fmp_h:
        return False
    for s in plan.curl_specs_d + plan.curl_specs_b:
        if s.has_cond:
            return False
    for s in plan.eh_specs_e + plan.eh_specs_h:
        if s.has_u1 or s.has_u2 or s.has_chi3 or s.has_nr:
            return False
    if any(plan.periodic):
        return False
    for planes in (plan.mask_planes or {}).values():
        if planes is None:
            return False
    return True


def takes(plan) -> bool:
    """Whether make_step steps `plan` through K5.  Besides the reference's
    rule (use_pallas and pallas_supported), a plan the hybrid route has
    stepped (plan.slab_opt) stays on the eager slab-local step: its state
    keeps f_w only on the sigma_w slabs, and the full-grid W chain would
    add the stale f_w back into E outside them (a fault of the reference,
    ROADMAP C)."""
    return bool(plan.use_pallas) and not plan.slab_opt \
        and pallas_supported(plan)


def _plane_lists(plan, c) -> Tuple[List[int], List[int], List[int]]:
    """Dead plane indices per axis of component c (fused.py:62)."""
    planes: Tuple[List[int], List[int], List[int]] = ([], [], [])
    for ax, i in plan.mask_planes.get(c, []):
        planes[ax].append(int(i))
    return planes


def _specs(plan, ft2: str):
    is_d = ft2 == "d"
    return (plan.curl_specs_d if is_d else plan.curl_specs_b,
            plan.eh_specs_e if is_d else plan.eh_specs_h)


def half_step_ref(plan, ft2: str):
    """The plain version of one half step, in the kernel's operation order
    (fused.py:229-281): half(f, fu, fw, C=None) -> new (f, fu, fw) dicts."""
    curls, ehs = _specs(plan, ft2)

    def half(f, fu, fw, C=None):
        C = plan.coefs if C is None else C
        f2, fu2, fw2 = dict(f), dict(fu), dict(fw)
        for s in curls:
            c = s.c
            dfl = _curl(plan, s, f)
            fold = f[c]
            if s.dsig_axis is not None:
                kap, sig, siginv = (C[f"{c}:kap"], C[f"{c}:sig"],
                                    C[f"{c}:siginv"])

                def inner(g):
                    return ((kap - sig) * g + dfl) * siginv
            else:
                def inner(g):
                    return g + dfl
            if s.dsigu_axis is not None:
                fu_old = fu[c]
                fu_new = inner(fu_old)
                fnew = C[f"{c}:siginvu"] * ((C[f"{c}:kapu"] - C[f"{c}:sigu"])
                                            * fold + fu_new - fu_old)
                fu2[c] = fu_new
            else:
                fnew = inner(fold)
            f2[c] = _apply_mask(plan, C, c, fnew)
        for s in ehs:
            ec = s.ec
            dnew = f2[s.dc]
            lin = dnew * C[f"{ec}:u"] if s.has_u else dnew
            if s.dsigw_axis is not None:
                kapw, sigw = C[f"{ec}:kapw"], C[f"{ec}:sigw"]
                enew = f[ec] + (kapw + sigw) * lin - (kapw - sigw) * fw[ec]
                fw2[ec] = lin
            else:
                enew = lin
            f2[ec] = _apply_mask(plan, C, ec, enew)
        return f2, fu2, fw2

    return half


def step_ref(plan):
    """The plain version of the K5 step without the DTFT update, on a state
    on any device: both halves' half_step_ref and the source fix-ups'
    PyTorch scatter-adds, step(state, x_t) -> state."""
    hb, hd = half_step_ref(plan, "b"), half_step_ref(plan, "d")
    fb, fd = build_source_fixup(plan, "b"), build_source_fixup(plan, "d")

    def step(state, x_t):
        f, fu, fw = hb(state["f"], state["f_u"], state["f_w"])
        if fb is not None:
            f, fw = fb._ref(f, fw, plan.coefs, x_t)
        f, fu, fw = hd(f, fu, fw)
        if fd is not None:
            f, fw = fd._ref(f, fw, plan.coefs, x_t)
        return {**state, "f": f, "f_u": fu, "f_w": fw, "t": state["t"] + 1}

    return step


# ---------------------------------------------------------------------------
# the C parameter blocks (mirror csrc/fused.cu; every member is 8 bytes)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_longlong


class _Coef(ctypes.Structure):
    _fields_ = [("p", _P), ("s0", _I), ("s1", _I), ("s2", _I)]


class _Curl(ctypes.Structure):
    _fields_ = ([(n, _P) for n in ("f", "fu", "gp", "gm")]
                + [("alive", _P * 3)]
                + [(n, _Coef) for n in ("kap", "sig", "siginv", "kapu",
                                        "sigu", "siginvu")]
                + [("ap", _I), ("am", _I)])


class _Eh(ctypes.Structure):
    _fields_ = ([("e", _P), ("fw", _P), ("alive", _P * 3)]
                + [(n, _Coef) for n in ("u", "kapw", "sigw")]
                + [("dq", _I)])


class _Params(ctypes.Structure):
    _fields_ = [("curl", _Curl * 3), ("eh", _Eh * 3),
                ("csgn", ctypes.c_double)] + \
        [(n, _I) for n in ("ncurl", "neh", "S0", "S1", "S2")]


class _FixArgs(ctypes.Structure):
    _fields_ = [(n, _P) for n in ("d", "e", "fw", "off", "are", "aim", "cnd",
                                  "alive", "u", "uoff", "kw", "kwoff", "sw",
                                  "swoff")] + \
        [("n", _I)] + [(n, ctypes.c_double) for n in ("wre", "wim", "dt")]


def _lib():
    from . import _build
    lib = _build.load("fused")
    if not getattr(lib, "_mnt_bound", False):
        lib.mnt_k5_params_size.restype = ctypes.c_longlong
        lib.mnt_k5_fixargs_size.restype = ctypes.c_longlong
        lib.mnt_k5_half.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p]
        lib.mnt_k5_half.restype = ctypes.c_int
        lib.mnt_k5_fixup.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p]
        lib.mnt_k5_fixup.restype = ctypes.c_int
        if (lib.mnt_k5_params_size() != ctypes.sizeof(_Params)
                or lib.mnt_k5_fixargs_size() != ctypes.sizeof(_FixArgs)):
            raise RuntimeError("csrc/fused.cu parameter layouts do not match "
                               "ops/fused.py")
        lib._mnt_bound = True
    return lib


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _coef(t) -> _Coef:
    """A coefficient tensor with its element strides, 0 on broadcast axes."""
    if t is None:
        return _Coef()
    st = [t.stride(ax) if t.shape[ax] > 1 else 0 for ax in range(3)]
    return _Coef(t.data_ptr(), *st)


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _check_state(what, plan, dtype, shape, groups):
    """Device, dtype, shape and contiguity of every tensor of `groups`
    ([(name, dict)]); tensors that share storage are cloned (the kernels
    update in place)."""
    if torch.device(plan.device).type != "cuda":
        raise RuntimeError(f"{what}: the plan's coefficients are not on a "
                           f"CUDA device")
    seen = set()
    for key, d in groups:
        for c, t in d.items():
            if t.device.type != "cuda" or t.dtype != dtype \
                    or tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(
                    f"{what}: {key}[{c}] must be a contiguous {dtype} CUDA "
                    f"tensor of shape {shape}; got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
            if t.data_ptr() in seen:
                d[c] = t = t.clone()
            seen.add(t.data_ptr())


class HalfStepKernel:
    """One K5 half step ('b': curl B, H from B; 'd': curl D, E from D) for
    one plan (the counterpart of the reference's build_half_step)."""

    def __init__(self, plan, ft2: str):
        if ft2 not in ("b", "d"):
            raise ValueError(f"half step 'b' or 'd', not {ft2!r}")
        if not pallas_supported(plan):
            raise ValueError("plan outside the fused half-step envelope")
        self.plan, self.ft2 = plan, ft2
        self.shape = tuple(plan.storage_shape or plan.gv.shape)
        self.dtype = torch_dtype(plan.dtype)
        self._ref = half_step_ref(plan, ft2)
        self.launches = 0                 # CUDA launches
        self.plain_steps = 0              # calls of the plain version

    def __call__(self, f, fu, fw):
        """(f, fu, fw) advanced by this half step.  CUDA state: in place
        through the kernel (the returned dicts hold the same tensors); CPU
        state: the plain version (new tensors)."""
        dev = f[_specs(self.plan, self.ft2)[0][0].c].device
        if dev.type == "cpu":
            self.plain_steps += 1
            return self._ref(f, fu, fw)
        if dev.type != "cuda":
            raise RuntimeError(f"fused half step: unsupported device {dev}")
        return self._half_cuda(dict(f), dict(fu), dict(fw))

    def _params(self, f, fu, fw) -> _Params:
        plan, C = self.plan, self.plan.coefs
        curls, ehs = _specs(plan, self.ft2)
        P = _Params()
        P.S0, P.S1, P.S2 = self.shape
        P.csgn = (1.0 if self.ft2 == "d" else -1.0) * plan.courant
        P.ncurl, P.neh = len(curls), len(ehs)
        for q, s in enumerate(curls):
            cp = P.curl[q]
            cp.f = _ptr(f[s.c])
            cp.gp = _ptr(f[s.g_plus]) if s.g_plus else 0
            cp.gm = _ptr(f[s.g_minus]) if s.g_minus else 0
            cp.ap = -1 if s.plus_axis is None else s.plus_axis
            cp.am = -1 if s.minus_axis is None else s.minus_axis
            if s.dsig_axis is not None:
                cp.kap, cp.sig, cp.siginv = (_coef(C[f"{s.c}:{nm}"])
                                             for nm in ("kap", "sig",
                                                        "siginv"))
            if s.dsigu_axis is not None:
                cp.fu = _ptr(fu[s.c])
                cp.kapu, cp.sigu, cp.siginvu = (_coef(C[f"{s.c}:{nm}"])
                                                for nm in ("kapu", "sigu",
                                                           "siginvu"))
            alive = alive_vectors(plan, s.c, self.dtype, plan.device)
            for ax in range(3):
                cp.alive[ax] = _ptr(alive.get(ax))
        dq = {s.c: q for q, s in enumerate(curls)}
        for q, s in enumerate(ehs):
            ep = P.eh[q]
            ep.e = _ptr(f[s.ec])
            ep.dq = dq[s.dc]
            if s.has_u:
                ep.u = _coef(C[f"{s.ec}:u"])
            if s.dsigw_axis is not None:
                ep.fw = _ptr(fw[s.ec])
                ep.kapw = _coef(C[f"{s.ec}:kapw"])
                ep.sigw = _coef(C[f"{s.ec}:sigw"])
            alive = alive_vectors(plan, s.ec, self.dtype, plan.device)
            for ax in range(3):
                ep.alive[ax] = _ptr(alive.get(ax))
        return P

    def _half_cuda(self, f, fu, fw):
        _check_state("fused half step", self.plan, self.dtype, self.shape,
                     (("f", f), ("f_u", fu), ("f_w", fw)))
        P = self._params(f, fu, fw)
        rc = _lib().mnt_k5_half(ctypes.byref(P), 1 if self.ft2 == "d" else 0,
                                1 if self.dtype == torch.float64 else 0,
                                _stream())
        self.launches += 1
        if rc != 0:
            raise RuntimeError(f"fused half-step kernel ({self.ft2}) launch "
                               f"failed: cudaError {rc}")
        return f, fu, fw


class SourceFixup:
    """Post-half current-source injection of one family (fused.py:358):
    dD = -J dt into D/B at the source sites, dlin = u dD into f_w, and
    (kapw + sigw) dlin (or dlin) into E/H at the live sites.  Calling it
    with a row of the xs table returns the new (f, fw)."""

    def __init__(self, plan, ft2: str, jobs):
        self.plan, self.ft2, self.jobs = plan, ft2, jobs
        self.dtype = torch_dtype(plan.dtype)
        self.launches = 0
        self.plain_steps = 0
        self._cuda = None

    def __call__(self, f, fw, C, x_t):
        dev = f[self.jobs[0][1].dc].device
        if dev.type == "cpu":
            self.plain_steps += 1
            return self._ref(f, fw, C, x_t)
        if dev.type != "cuda":
            raise RuntimeError(f"source fix-up: unsupported device {dev}")
        return self._fix_cuda(f, fw, x_t)

    def _gather_index(self, si, key):
        """The source sites' index into coefficient `key`, clamped to its
        extent per axis (broadcast axes read index 0; fused.py:389-391)."""
        A = self.plan.coefs[key]
        idx = self.plan.coefs[f"src{si}:idx"].long()
        return tuple(torch.clamp(idx[:, k], max=A.shape[k] - 1)
                     for k in range(3))

    def _ref(self, f, fw, C, x_t):
        f, fw = dict(f), dict(fw)
        dt = self.plan.dt
        for si, spec, alive in self.jobs:
            dc, ec = spec.dc, spec.ec
            w_re, w_im = x_t[f"src{si}:cur_re"], x_t[f"src{si}:cur_im"]
            dD = -(w_re * C[f"src{si}:amp_re"]
                   - w_im * C[f"src{si}:amp_im"]) * dt
            if f"src{si}:cndinv" in C:
                dD = dD * C[f"src{si}:cndinv"]
            pts = source_index(self.plan, si)
            f[dc] = f[dc].index_put(pts, dD, accumulate=True)
            dlin = dD * C[f"{ec}:u"][self._gather_index(si, f"{ec}:u")] \
                if spec.has_u else dD
            am = alive
            if spec.dsigw_axis is not None:
                kw = C[f"{ec}:kapw"][self._gather_index(si, f"{ec}:kapw")]
                sw = C[f"{ec}:sigw"][self._gather_index(si, f"{ec}:sigw")]
                fw[ec] = fw[ec].index_put(pts, dlin, accumulate=True)
                f[ec] = f[ec].index_put(pts, (kw + sw) * dlin * am,
                                        accumulate=True)
            else:
                f[ec] = f[ec].index_put(pts, dlin * am, accumulate=True)
        return f, fw

    def _tables(self):
        """Per job the device tables of the CUDA launch: flat offsets of the
        sites into the state and into u / kapw / sigw, and the liveness."""
        if self._cuda is None:
            C = self.plan.coefs
            shape = tuple(self.plan.storage_shape or self.plan.gv.shape)
            tabs = []
            for si, spec, alive in self.jobs:
                ec = spec.ec

                def flat(key):
                    A = C[key]
                    ii = self._gather_index(si, key)
                    return sum(ii[k] * A.stride(k) for k in range(3)
                               ).contiguous()

                i, j, k = source_index(self.plan, si)
                t = {"off": ((i * shape[1] + j) * shape[2] + k).contiguous(),
                     "alive": alive}
                if spec.has_u:
                    t["uoff"] = flat(f"{ec}:u")
                if spec.dsigw_axis is not None:
                    t["kwoff"] = flat(f"{ec}:kapw")
                    t["swoff"] = flat(f"{ec}:sigw")
                tabs.append(t)
            self._cuda = tabs
        return self._cuda

    def _fix_cuda(self, f, fw, x_t):
        C, lib = self.plan.coefs, _lib()
        fp64 = 1 if self.dtype == torch.float64 else 0
        for (si, spec, _), t in zip(self.jobs, self._tables()):
            dc, ec = spec.dc, spec.ec
            A = _FixArgs()
            A.d, A.e = _ptr(f[dc]), _ptr(f[ec])
            A.off, A.alive = _ptr(t["off"]), _ptr(t["alive"])
            A.are = _ptr(C[f"src{si}:amp_re"])
            A.aim = _ptr(C[f"src{si}:amp_im"])
            A.cnd = _ptr(C.get(f"src{si}:cndinv"))
            if spec.has_u:
                A.u, A.uoff = _ptr(C[f"{ec}:u"]), _ptr(t["uoff"])
            if spec.dsigw_axis is not None:
                A.fw = _ptr(fw[ec])
                A.kw, A.kwoff = _ptr(C[f"{ec}:kapw"]), _ptr(t["kwoff"])
                A.sw, A.swoff = _ptr(C[f"{ec}:sigw"]), _ptr(t["swoff"])
            A.n = t["off"].numel()
            A.wre = float(x_t[f"src{si}:cur_re"])
            A.wim = float(x_t[f"src{si}:cur_im"])
            A.dt = self.plan.dt
            rc = lib.mnt_k5_fixup(ctypes.byref(A), fp64, _stream())
            self.launches += 1
            if rc != 0:
                raise RuntimeError(f"source fix-up launch failed: "
                                   f"cudaError {rc}")
        return f, fw


def build_source_fixup(plan, ft2: str) -> Optional[SourceFixup]:
    """The fix-up of family ft2, or None when no current source injects
    into it (fused.py:358-375).  A source's sites on a dead plane of its E/H
    component get no E/H contribution, but D/B still takes dD, as in the
    eager ordering."""
    _, ehs = _specs(plan, ft2)
    eh_by_dc = {s.dc: s for s in ehs}
    jobs = []
    for si, s in enumerate(plan.sources):
        ftc = "d" if s.component[0] == "e" else "b"
        if ftc != ft2 or s.is_integrated:
            continue
        spec = eh_by_dc.get(ft2 + s.component[1])
        if spec is None:
            continue
        idx = np.asarray(s.indices)
        alive = np.ones(len(idx))
        for ax, planes in enumerate(_plane_lists(plan, spec.ec)):
            for p in planes:
                alive *= idx[:, ax] != p
        jobs.append((si, spec, torch.as_tensor(alive.astype(plan.dtype),
                                               device=plan.device)))
    return SourceFixup(plan, ft2, jobs) if jobs else None


def kernels_of(plan) -> Dict[str, Any]:
    """{"b", "d": HalfStepKernel, "fix_b", "fix_d": SourceFixup or None}
    of the plan, made once and cached on it (their counters say what ran)."""
    ker = plan.__dict__.get("_fused_kernels")
    if ker is None:
        ker = plan._fused_kernels = {
            "b": HalfStepKernel(plan, "b"), "d": HalfStepKernel(plan, "d"),
            "fix_b": build_source_fixup(plan, "b"),
            "fix_d": build_source_fixup(plan, "d")}
    return ker


# ---------------------------------------------------------------------------
# the bound: bytes and operations one step must move / do
# ---------------------------------------------------------------------------


def step_cost(plan) -> Dict[str, float]:
    """Bytes and floating-point operations of one K5 step (both halves),
    each array read once and written once per half: per half the three g
    components, D/B with f_u, E/H with f_w (read and written), and a full u
    where the medium has one; the chain vectors and masks are negligible.
    `ops` counts the arithmetic of csrc/fused.cu per site and component:
    the curl 4, the sigma chain 4, the sigma_u chain 5, the mask 3, u 1,
    the W chain 6, the E/H mask 3."""
    shape = tuple(plan.storage_shape or plan.gv.shape)
    N = int(np.prod(shape))
    elems = ops = 0
    for ft2 in ("b", "d"):
        curls, ehs = _specs(plan, ft2)
        gs = {g for s in curls for g in (s.g_plus, s.g_minus) if g}
        elems += len(gs) * N                               # the g family
        for s in curls:
            elems += 2 * N
            ops += 7
            if s.dsig_axis is not None:
                ops += 4
            if s.dsigu_axis is not None:
                elems += 2 * N
                ops += 5 + (4 if s.dsig_axis is not None else 1)
        for s in ehs:
            elems += 2 * N
            ops += 3
            if s.has_u:
                elems += N
                ops += 1
            if s.dsigw_axis is not None:
                elems += 2 * N
                ops += 6
    item = np.dtype(plan.dtype).itemsize
    return {"bytes": float(elems * item), "ops": float(ops * N)}
