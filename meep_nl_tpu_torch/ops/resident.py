"""K3 and K4: the resident path, a whole chunk of steps of a small grid in
one launch (csrc/resident.cu).

The port of ``meep_nl_tpu/ops/pallas/resident.py``.  There the kernel body
is the eager stepper traced into one Mosaic program whose time loop keeps
the whole state in VMEM; `Simulation.run` tries this path first for every
stretch, so it carries every 2D run and every small 3D run.  Here the
kernel is hand-written CUDA that runs the time loop inside one cooperative
launch per chunk, with the state in device memory (in the L2 at the sizes
this path takes).  What it computes is the eager `make_step` over
`resident_plan(plan)`: full-grid PML chains, dense pre-scattered sources,
the DTFT accumulated in the loop in the frequency-major layout; K4 adds the
probes' per-step weighted sums.

`ResidentKernel.run` / `run_probed` take and return the standard state
layout; the frequency-major DTFT layout exists only inside the call.  A
state on the CPU runs the plain version (`resident_ref`), a state on the
card the kernel, in place; `launches` (K3), `probed_launches` (K4) and
`plain_steps` count which ran.

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
The envelope is the reference's (2D and 3D, fp32, real fields, no noisy
media, a doubled state within VMEM_BUDGET) intersected with what the
port's eager stepper and this kernel run: no periodic axis (ROADMAP A8),
masks made of dead planes, no H-family chi2/chi3, real monitor weights.
"""

from __future__ import annotations

import copy
import ctypes
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from . import fdtd3d, fdtd3d_t2
from ..core import grid as G
from ..stepper.step import ProbeSpec, build_xs, check_supported, run

#: the reference's VMEM budget for 2x state (resident.py:50); on the H100
#: the state lives in device memory, so this is a routing rule, not a limit
VMEM_BUDGET = 112 * 2 ** 20
#: max steps per launch (bounds the per-step tables)
MAX_CHUNK = 8192
#: 3D plans whose doubled state is larger prefer the hybrid route
#: (resident.py:525-533, MNT_RESIDENT_PREFER)
PREFER_BYTES = 32 * 2 ** 20

STEP_BSRC, STEP_DSRC, STEP_DFT = 1, 2, 4


def resident_plan(plan):
    """A shallow clone of `plan` prepared for in-kernel stepping
    (resident.py:60-97): full-grid chain updates, dense pre-scattered source
    arrays (built in float64, then cast), frequency-major DTFT
    accumulators.  Cached on the plan."""
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
    p.coefs = coefs
    plan._resident_plan = p
    return p


def _state_bytes(plan) -> int:
    """Bytes of the stepper state of `plan` (as step.init_state makes it,
    with its 4-byte step counter), from the shapes alone."""
    shape = tuple(plan.storage_shape or plan.gv.shape)
    N = int(np.prod(shape))
    curls = plan.curl_specs_d + plan.curl_specs_b
    ehs = plan.eh_specs_e + plan.eh_specs_h
    n = N * (len(curls) + len(ehs))
    n += N * sum(1 for s in curls if s.dsigu_axis is not None)
    n += N * sum(1 for s in ehs if s.dsigw_axis is not None)
    for p in plan.pol_specs_e + plan.pol_specs_h:
        comps = {c for (c, d) in p.sigma if d == G.component_direction(c)}
        n += 2 * N * len(comps)
    for m in plan.dfts:
        n += int(np.prod([b - a for a, b in m.region])) * len(m.freqs) * 2
    return n * np.dtype(plan.dtype).itemsize + 4


def resident_supported(plan) -> bool:
    """The static envelope (resident.py:158-182, see the module docstring):
    plans outside it are declined, never raised on."""
    if plan.gv.ndim < 2 or plan.dtype != np.float32:
        return False
    if plan.complex_fields or plan.real_pair or any(plan.periodic):
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
    if any(planes is None for planes in (plan.mask_planes or {}).values()):
        return False
    if any(f"dft{mi}:w" not in plan.coefs for mi in range(len(plan.dfts))):
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
    the weights in the kernel's type, the offsets into the storage."""
    shape = tuple(plan.storage_shape or plan.gv.shape)
    out = []
    for p in probes:
        idx = np.asarray(p.indices, np.int64).reshape(-1, len(shape))
        w = np.asarray(p.weights)
        if np.iscomplexobj(w):
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
# the C argument block (mirrors csrc/resident.cu; every member is 8 bytes)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_longlong


class _DftM(ctypes.Structure):
    _fields_ = ([(n, _P) for n in ("acc", "f", "w", "phr", "phi")]
                + [("nfreq", _I), ("R", _I), ("lo", _I * 3), ("n", _I * 3),
                   ("navg", _I), ("avg", _I * 3)])


class _ProbeR(ctypes.Structure):
    _fields_ = [(n, _P) for n in ("f", "off", "w", "out")] + [("npts", _I)]


class _SrcFam(ctypes.Structure):
    _fields_ = ([(n, _P) for n in ("slot_off", "slot_q", "slot_start",
                                   "c_src", "c_re", "c_im")]
                + [("nslot", _I)])


class _ResArgs(ctypes.Structure):
    _fields_ = [("pb", fdtd3d._Params * 2), ("pd", fdtd3d._Params * 2),
                ("src", _SrcFam * 2), ("dft", _P), ("probe", _P),
                ("cur", _P), ("flags", _P), ("dt", ctypes.c_double)] + \
        [(n, _I) for n in ("nsteps", "nsrc", "ndft", "nprobe", "e_local")]


def _lib():
    from . import _build
    lib = _build.load("resident")
    if not getattr(lib, "_mnt_bound", False):
        lib.mnt_k3_args_size.restype = ctypes.c_longlong
        lib.mnt_k3_max_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.mnt_k3_max_blocks.restype = ctypes.c_int
        lib.mnt_k3_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_void_p]
        lib.mnt_k3_launch.restype = ctypes.c_int
        if lib.mnt_k3_args_size() != ctypes.sizeof(_ResArgs):
            raise RuntimeError("csrc/resident.cu ResArgs layout does not "
                               "match ops/resident.py")
        lib._mnt_bound = True
    return lib


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


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
        """The kernel over chunks of at most MAX_CHUNK steps, in place on
        frequency-major copies of the DTFT accumulators."""
        state = self._check(state)
        state = {**state, "dft": {k: v.movedim((-2, -1), (0, 1)).contiguous()
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
        dict whose tensors share no storage (the kernel updates in place)."""
        if torch.device(self.plan.device).type != "cuda":
            raise RuntimeError("resident: the plan's coefficients are not on "
                               "a CUDA device")
        seen = set()

        def own(t, what):
            if t.device.type != "cuda" or t.dtype != torch.float32 \
                    or tuple(t.shape) != self.shape or not t.is_contiguous():
                raise ValueError(
                    f"resident: {what} must be a contiguous float32 CUDA "
                    f"tensor of shape {self.shape}; got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
            if t.data_ptr() in seen:
                t = t.clone()
            seen.add(t.data_ptr())
            return t

        out = {**state}
        for key in ("f", "f_u", "f_w"):
            out[key] = {c: own(t, f"{key}[{c}]")
                        for c, t in state[key].items()}
        out["pol"] = [{k: {c: own(t, f"pol[{pi}][{k}][{c}]")
                           for c, t in e[k].items()} for k in ("p", "pp")}
                      for pi, e in enumerate(state["pol"])]
        return out

    def _site_tables(self):
        """Per family, the source sites (every site where a source's dense
        arrays are nonzero), each with its sources' amplitudes in source
        order, as the kernel's CSR tables; built once."""
        if self._tables is not None:
            return self._tables
        rp, dev = self.rplan, self.plan.device
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

            def i32(v):
                return torch.as_tensor(np.asarray(v, np.int32).reshape(-1),
                                       device=dev)

            def f32(v):
                return torch.as_tensor(np.asarray(v, np.float32).reshape(-1),
                                       device=dev)

            fams.append({"slot_off": i32([o for _, o in slots]),
                         "slot_q": i32([q for q, _ in slots]),
                         "slot_start": i32(start),
                         "c_src": i32([c[0] for c in flat]),
                         "c_re": f32([c[1] for c in flat]),
                         "c_im": f32([c[2] for c in flat]),
                         "nslot": len(slots)})
        self._tables = fams
        return fams

    def _launch(self, state, n, t0, probes):
        """One K3/K4 launch of n steps on the frequency-major state."""
        rp, dev = self.rplan, self.plan.device
        lib = _lib()
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
            # odd steps read P from the buffers even steps wrote into
            view = state if par == 0 else {**state, "pol": [
                {"p": e["pp"], "pp": e["p"]} for e in state["pol"]]}
            A.pb[par] = fdtd3d.build_params(rp, "b", view)
            A.pd[par] = fdtd3d.build_params(rp, "d", view)
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
        for fi, tab in enumerate(self._site_tables()):
            sf = A.src[fi]
            for key in ("slot_off", "slot_q", "slot_start", "c_src", "c_re",
                        "c_im"):
                setattr(sf, key, _ptr(tab[key]))
            sf.nslot = tab["nslot"]
        # DTFT monitors
        gv = rp.gv
        dtab = (_DftM * max(len(rp.dfts), 1))()
        for mi, m in enumerate(rp.dfts):
            d = dtab[mi]
            phr, phi = xs[f"dft{mi}:ph_re"], xs[f"dft{mi}:ph_im"]
            flags |= np.where(np.any(phr != 0, 1) | np.any(phi != 0, 1),
                              STEP_DFT, 0).astype(np.int32)
            d.acc = _ptr(state["dft"][m.name])
            d.f = _ptr(state["f"][m.component])
            d.w = _ptr(rp.coefs[f"dft{mi}:w"])
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
        # probes (K4)
        series = {}
        ptab = (_ProbeR * max(len(probes), 1))()
        for pi, (name, comp, off, w) in enumerate(_probe_table(rp, probes)):
            pr = ptab[pi]
            out = torch.empty(n, dtype=torch.float32, device=dev)
            series[name] = out
            pr.f = _ptr(state["f"][comp])
            pr.off, pr.w = up(off, np.int32), up(w, np.float32)
            pr.out, pr.npts = out.data_ptr(), len(off)
        A.probe, A.nprobe = up_table(ptab), len(probes)
        A.dt = rp.dt
        A.nsteps = n
        # E from D reads neighbours only through the chi2/chi3 partner sums
        live = {s.dc for s in rp.eh_specs_e}
        A.e_local = int(not any((s.has_chi3 or s.has_nr)
                                and (s.dc1 in live or s.dc2 in live)
                                for s in rp.eh_specs_e))
        args = up_table(A)
        N = int(np.prod(self.shape))
        rc = lib.mnt_k3_launch(ctypes.byref(A), args,
                               (N + 255) // 256,
                               torch.cuda.current_stream().cuda_stream)
        if probes:
            self.probed_launches += 1
        else:
            self.launches += 1
        if rc != 0:
            raise RuntimeError(f"resident kernel launch failed: cudaError "
                               f"{rc}")
        # new P went into the PP buffers on even steps: after an odd count
        # the buffers' roles are swapped
        if n % 2:
            state = {**state, "pol": [{"p": e["pp"], "pp": e["p"]}
                                      for e in state["pol"]]}
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
    NR solve ~150 and the ADE ~8 per material site), the sources and the
    DTFT (`ops`).  `stream_bytes` is what a kernel that kept nothing on
    chip between steps would move per step: the state read and written and
    the coefficients read."""
    rp = resident_plan(plan)
    shape = tuple(rp.storage_shape or rp.gv.shape)
    N = int(np.prod(shape))
    state = _state_bytes(rp) - 4
    # what the kernel reads: the chain vectors and material arrays of each
    # component, the polarization sigmas, the monitor weights (the masks
    # reach it as per-axis vectors, the sources as site lists)
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
    region = sum(int(np.prod([b - a for a, b in m.region])) * (4 + 4 * len(
        m.freqs)) for m in rp.dfts)
    ops_step = 18 * ncomp * N + 150 * nl + 8 * pol + region
    return {"bytes": float(2 * state + coef + table),
            "ops": float(nsteps * ops_step),
            "stream_bytes": float(2 * state + coef)}
