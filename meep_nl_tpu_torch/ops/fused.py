"""K5: one fused half step (curl, PML chains, E/H from D/B, W chain, masks)
with the family's current sources, as a hand-written CUDA kernel
(csrc/fused.cu), the step behind ``Simulation(use_pallas=True)``.

The port of ``meep_nl_tpu/ops/pallas/fused.py``.  `make_step` takes this
route when `plan.use_pallas` is set and `pallas_supported(plan)` holds (see
`takes`): per step the B half with its source fix-up, the D half with its
fix-up, then the DTFT update.  Unlike the eager stepper it injects the
current sources after E/H is computed and carries dD through the linear
E-from-D at the source sites only, so the two routes agree to round-off,
not bit for bit; the chains run full-grid, as the reference's do.

`HalfStepKernel(plan, ft2)` is one half ('b' or 'd') with its fix-up
(`SourceFixup`, the reference's build_source_fixup): on a state on the
card one launch updates the tensors in place and adds the sources; on a
CPU state it runs the plain versions `half_step_ref` and
`SourceFixup._ref`.  Each object counts its CUDA launches (`launches`) and
the calls its plain version took (`plain_steps`).

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
from ..stepper.step import _apply_mask, _curl, source_index
from . import fdtd3d as K1

#: waveforms a launch takes by value (more go through a device table)
MAXSRC = K1.MAXSRC


def pallas_supported(plan) -> bool:
    """The envelope of the reference's pallas_supported (fused.py:37): 3D,
    real fields, diagonal (or vacuum) media, uPML, no conductivity,
    dispersion, nonlinearity, BFAST, periodic axes, node mirrors
    (plan.mirror_node, fused.py:40-41) or rotational folds, and every mask
    a list of dead planes.  A Mirror with a wall (metal or magnetic: its
    plane is a dead plane of the masks) and one-sided PML run as any other
    plan."""
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
# the C argument block (mirrors csrc/fused.cu's K5Args; its Params and the
# 32-bit copies CurlC / EhC are K1's, ops/fdtd3d.py)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p


class _K5Args(ctypes.Structure):
    _fields_ = ([("P", K1._Params), ("ring", _P * 3)]
                + [(n, _P) for n in ("src_ptr", "src_key", "src_id",
                                     "src_amp", "wave_dev")]
                + [("wave", ctypes.c_double * (2 * MAXSRC)),
                   ("dt", ctypes.c_double),
                   ("cc", K1._CurlC * 3), ("ec", K1._EhC * 3),
                   ("d_of", ctypes.c_int * 3)]
                + [(n, ctypes.c_int) for n in ("nring", "S0", "S1", "S2",
                                               "nty", "ntz", "ch", "nch")])


def _lib():
    from . import _build
    return bind(_build.load("fused"))


def bind(lib):
    """Declare csrc/fused.cu's C functions on a loaded library and check its
    argument layout against this module's (once per library)."""
    if not getattr(lib, "_mnt_bound", False):
        lib.mnt_k5_args_size.restype = ctypes.c_longlong
        lib.mnt_k5_params_size.restype = ctypes.c_longlong
        lib.mnt_k5_half.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p]
        lib.mnt_k5_half.restype = ctypes.c_int
        lib.mnt_k5_smem.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.mnt_k5_smem.restype = ctypes.c_longlong
        if (lib.mnt_k5_params_size() != ctypes.sizeof(K1._Params)
                or lib.mnt_k5_args_size() != ctypes.sizeof(_K5Args)):
            raise RuntimeError("csrc/fused.cu argument layout does not match "
                               "ops/fused.py")
        tile = (ctypes.c_int * 2)()
        lib.mnt_k5_tile(tile)
        lib.mnt_tile = tuple(tile)
        lib._mnt_bound = True
    return lib


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
    one plan (the counterpart of the reference's build_half_step), with the
    family's current sources (`fix`, the reference's build_source_fixup):
    on the card the kernel adds them itself.  `ch` sets the x-planes per
    chunk (default fdtd3d.chunk_planes).  The argument block is built at
    the first CUDA call and kept; it is rebuilt only when a tensor of the
    state it points at changes (its data_ptr), so a call's host work is the
    step's waveforms and the launch."""

    def __init__(self, plan, ft2: str, ch: Optional[int] = None):
        if ft2 not in ("b", "d"):
            raise ValueError(f"half step 'b' or 'd', not {ft2!r}")
        if not pallas_supported(plan):
            raise ValueError("plan outside the fused half-step envelope")
        self.plan, self.ft2, self.ch = plan, ft2, ch
        self.shape = tuple(plan.storage_shape or plan.gv.shape)
        if int(np.prod(self.shape)) >= 2 ** 31:
            raise ValueError(f"fused half step: a storage of {self.shape} "
                             f"has 2^31 sites or more (the kernel's offsets "
                             f"are 32-bit)")
        self.dtype = torch_dtype(plan.dtype)
        self.is_d = 1 if ft2 == "d" else 0
        self.fp64 = 1 if self.dtype == torch.float64 else 0
        self._ref = half_step_ref(plan, ft2)
        self.fix = build_source_fixup(plan, ft2)
        curls, ehs = _specs(plan, ft2)
        for s in ehs:          # the kernel reads u at the site's offset
            if s.has_u and tuple(plan.coefs[f"{s.ec}:u"].shape) != self.shape:
                raise ValueError(f"fused half step: {s.ec}:u is not a full "
                                 f"{self.shape} array")
        # the state tensors the kernel reads or writes: (f, f_u, f_w) index
        # and component, in the order of the argument block's key
        fs = [s.c for s in curls] + [s.ec for s in ehs] + [
            g for s in curls for g in (s.g_plus, s.g_minus) if g]
        self._slots = ([(0, c) for c in dict.fromkeys(fs)]
                       + [(1, s.c) for s in curls
                          if s.dsigu_axis is not None]
                       + [(2, s.ec) for s in ehs
                          if s.dsigw_axis is not None])
        self._args = self._key = None
        self.launches = 0                 # CUDA launches
        self.plain_steps = 0              # calls of the plain version

    def __call__(self, f, fu, fw, x_t=None, C=None):
        """(f, fu, fw) advanced by this half step, with the family's current
        sources of the xs row `x_t` added (none without it).  CUDA state:
        in place through the kernel (the returned dicts hold the same
        tensors); CPU state: the plain versions (new tensors)."""
        dev = f[self._slots[0][1]].device
        if dev.type == "cpu":
            self.plain_steps += 1
            C = self.plan.coefs if C is None else C
            f, fu, fw = self._ref(f, fu, fw, C)
            if x_t is not None and self.fix is not None:
                f, fw = self.fix(f, fw, C, x_t)
            return f, fu, fw
        if dev.type != "cuda":
            raise RuntimeError(f"fused half step: unsupported device {dev}")
        if C is not None and C is not self.plan.coefs:
            raise ValueError("fused half step: the kernel reads the plan's "
                             "own coefficients")
        return self._half_cuda(f, fu, fw, x_t)

    # ---- CUDA path ---------------------------------------------------------
    def launch_args(self, f, fu, fw, x_t=None):
        """(argument block, (f, fu, fw)) of one launch over the state with
        the sources of `x_t` (none without it): the block is built when a
        state tensor is new to it (after the checks, which may clone
        tensors that share storage: the returned dicts), else only its
        waveforms are written.  The kernel object keeps the block, and its
        next call overwrites them."""
        groups = (f, fu, fw)
        key = tuple(groups[g][c].data_ptr() for g, c in self._slots)
        if key != self._key:
            f, fu, fw = dict(f), dict(fu), dict(fw)
            _check_state("fused half step", self.plan, self.dtype,
                         self.shape, (("f", f), ("f_u", fu), ("f_w", fw)))
            self._build(f, fu, fw)
            groups = (f, fu, fw)
            self._key = tuple(groups[g][c].data_ptr()
                              for g, c in self._slots)
        A = self._args
        if self._src is None:
            return A, groups
        if x_t is None:
            A.src_ptr = 0
            return A, groups
        A.src_ptr = self._src["ptr"].data_ptr()
        wave = [x_t[k] for k in self._src["wave_keys"]]
        if len(wave) <= 2 * MAXSRC:
            A.wave[:len(wave)] = wave
        else:
            wd = torch.tensor(wave, dtype=torch.float64,
                              device=self.plan.device)
            A.wave_dev = wd.data_ptr()
            self._wave_dev = wd               # alive until the launch
        return A, groups

    def _half_cuda(self, f, fu, fw, x_t=None):
        A, (f, fu, fw) = self.launch_args(f, fu, fw, x_t)
        rc = _lib().mnt_k5_half(self._byref, self.is_d, self.fp64, _stream())
        self.launches += 1
        if rc != 0:
            raise RuntimeError(f"fused half-step kernel ({self.ft2}) launch "
                               f"failed: cudaError {rc}")
        return f, fu, fw

    def _build(self, f, fu, fw):
        """The argument block over (f, fu, fw): K1's parameter block with
        the chains on every site, the ring of curl partners, the launch
        geometry for the library's tile and the source lists."""
        plan = self.plan
        lib = _lib()
        curls, ehs = _specs(plan, self.ft2)
        A = _K5Args()
        A.P = K1.build_params(plan, self.ft2, {"f": f, "f_u": fu, "f_w": fw})
        for q in range(len(curls)):
            A.P.curl[q].slab = 0
        for q in range(len(ehs)):
            A.P.eh[q].w_slab = 0
        K1.compact(A)
        names = list(dict.fromkeys(g for s in curls
                                   for g in (s.g_plus, s.g_minus) if g))
        A.nring = len(names)
        for r, g in enumerate(names):
            A.ring[r] = f[g].data_ptr()
        q_of = {s.c: q for q, s in enumerate(curls)}
        for q in range(3):
            cc = A.cc[q]
            if q < len(curls):
                s = curls[q]
                cc.gp = names.index(s.g_plus) if s.g_plus else -1
                cc.gm = names.index(s.g_minus) if s.g_minus else -1
                if s.dsigu_axis is not None and s.c not in fu:
                    raise ValueError(f"fused half step: f_u[{s.c}] missing")
            else:
                cc.gp = cc.gm = cc.sax = cc.uax = -1
            if q < len(ehs):
                s = ehs[q]
                A.d_of[q] = q_of[s.dc]
                if s.dsigw_axis is not None and s.ec not in fw:
                    raise ValueError(f"fused half step: f_w[{s.ec}] missing")
            else:
                A.ec[q].wax = -1
        S0, S1, S2 = self.shape
        TY, TZ = lib.mnt_tile
        A.S0, A.S1, A.S2 = S0, S1, S2
        A.nty, A.ntz = -(-S1 // TY), -(-S2 // TZ)
        A.ch = self.ch or K1.chunk_planes(self.shape, lib.mnt_tile)
        A.nch = -(-S0 // A.ch)
        A.dt = plan.dt
        self._src = self._source_lists(lib.mnt_tile, A.ntz)
        if self._src is not None:
            A.src_key = self._src["key"].data_ptr()
            A.src_id = self._src["id"].data_ptr()
            A.src_amp = self._src["amp"].data_ptr()
        self._args, self._byref = A, ctypes.byref(A)

    def _source_lists(self, tile, ntz):
        """The family's current sources (those of `fix`) as per-(tile,
        plane) lists for the thread that owns each site: entries sorted by
        (tile, plane), then by site, then in plan.sources order and entry
        order (the plain version's order of accumulation); each keyed by
        its site in the tile and its D/B and E/H components."""
        if self.fix is None:
            return None
        plan, C = self.plan, self.plan.coefs
        curls, ehs = _specs(plan, self.ft2)
        qc_of = {s.c: q for q, s in enumerate(curls)}
        qe_of = {s.ec: q for q, s in enumerate(ehs)}
        S0 = self.shape[0]
        TY, TZ = tile
        buckets, keys, ids, amps, wave_keys = [], [], [], [], []
        for w, (si, spec, _) in enumerate(self.fix.jobs):
            if f"src{si}:cndinv" in C:
                raise ValueError("fused half step: a source with a "
                                 "conductivity factor")
            i, j, k = (t.cpu().numpy() for t in source_index(plan, si))
            buckets.append(((j // TY) * ntz + k // TZ) * S0 + i)
            keys.append((((j % TY) * TZ + k % TZ) << 4)
                        | (qe_of[spec.ec] << 2) | qc_of[spec.dc])
            ids.append(np.full(len(i), w))
            amps.append(torch.stack([C[f"src{si}:amp_re"],
                                     C[f"src{si}:amp_im"]], 1))
            wave_keys += [f"src{si}:cur_re", f"src{si}:cur_im"]
        bucket, key = np.concatenate(buckets), np.concatenate(keys)
        order = np.lexsort((np.arange(len(key)), key >> 4, bucket))
        ntile = -(-self.shape[1] // TY) * ntz
        ptr = np.searchsorted(bucket[order], np.arange(ntile * S0 + 1))
        dev = plan.device

        def i32(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                   device=dev)

        amp = torch.cat(amps)[torch.as_tensor(order, device=dev)]
        return {"ptr": i32(ptr), "key": i32(key[order]),
                "id": i32(np.concatenate(ids)[order]),
                "amp": amp.contiguous(), "wave_keys": wave_keys}


class SourceFixup:
    """Post-half current-source injection of one family (fused.py:358):
    dD = -J dt into D/B at the source sites, dlin = u dD into f_w, and
    (kapw + sigw) dlin (or dlin) into E/H at the live sites.  Calling it
    with a row of the xs table returns the new (f, fw).  This is the plain
    version only: on the card the half-step kernel adds the sources itself
    (HalfStepKernel with a row), so `launches` stays 0."""

    launches = 0

    def __init__(self, plan, ft2: str, jobs):
        self.plan, self.ft2, self.jobs = plan, ft2, jobs
        self.plain_steps = 0

    def __call__(self, f, fw, C, x_t):
        dev = f[self.jobs[0][1].dc].device
        if dev.type != "cpu":
            raise RuntimeError(f"source fix-up on {dev}: the half-step "
                               f"kernel adds the sources there")
        self.plain_steps += 1
        return self._ref(f, fw, C, x_t)

    def _gather_index(self, si, key):
        """The source sites' index into coefficient `key`, clamped to its
        extent per axis (broadcast axes read index 0; fused.py:389-391)."""
        A = self.plan.coefs[key]
        idx = self.plan.coefs[f"src{si}:idx"].long()
        return tuple(torch.clamp(idx[:, k], max=A.shape[k] - 1)
                     for k in range(3))

    def _layers(self, si):
        """Source si's entries in parts in which no site repeats: part r
        holds the (r + 1)-th listing of each site (None: one part, the
        source has no repeated site), so that scatter-adds part by part
        accumulate a site's entries in entry order on every device (a CUDA
        index_put sums the repeats of one call before adding them)."""
        cache = self.__dict__.setdefault("_layer_cache", {})
        if si not in cache:
            idx = np.asarray(self.plan.sources[si].indices)
            _, inv = np.unique(idx, axis=0, return_inverse=True)
            inv = inv.reshape(-1)
            rank = np.zeros(len(inv), np.int64)
            seen: Dict[int, int] = {}
            for e, site in enumerate(inv.tolist()):
                rank[e] = seen.get(site, 0)
                seen[site] = rank[e] + 1
            cache[si] = None if rank.max(initial=0) == 0 else [
                torch.as_tensor(np.nonzero(rank == r)[0],
                                device=self.plan.device)
                for r in range(rank.max() + 1)]
        return cache[si]

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
            dlin = dD * C[f"{ec}:u"][self._gather_index(si, f"{ec}:u")] \
                if spec.has_u else dD
            if spec.dsigw_axis is not None:
                kw = C[f"{ec}:kapw"][self._gather_index(si, f"{ec}:kapw")]
                sw = C[f"{ec}:sigw"][self._gather_index(si, f"{ec}:sigw")]
                de = (kw + sw) * dlin * alive
            else:
                de = dlin * alive
            pts = source_index(self.plan, si)
            for sel in self._layers(si) or [None]:
                def part(t):
                    return t if sel is None else t[sel]
                at = tuple(part(p) for p in pts)
                f[dc] = f[dc].index_put(at, part(dD), accumulate=True)
                if spec.dsigw_axis is not None:
                    fw[ec] = fw[ec].index_put(at, part(dlin),
                                              accumulate=True)
                f[ec] = f[ec].index_put(at, part(de), accumulate=True)
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
    """{"b", "d": HalfStepKernel, "fix_b", "fix_d": their SourceFixup or
    None} of the plan, made once and cached on it (their counters say what
    ran)."""
    ker = plan.__dict__.get("_fused_kernels")
    if ker is None:
        hb, hd = HalfStepKernel(plan, "b"), HalfStepKernel(plan, "d")
        ker = plan._fused_kernels = {"b": hb, "d": hd, "fix_b": hb.fix,
                                     "fix_d": hd.fix}
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
