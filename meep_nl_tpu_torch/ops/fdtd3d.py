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
import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch

from ..core.device import torch_dtype
from ..stepper.step import (NR_ITERS, _is_pair, alive_vectors, build_xs,
                            make_step, mirror_ghost, source_index, xs_rows)

MAXPOL = 4
NCOMP = 3
MAXRING = NCOMP * (1 + MAXPOL)
#: waveforms a launch takes by value (more go through a device table)
MAXSRC = 32
#: the launch kinds of csrc/fdtd3d.cu
K_B, K_D, K_E = range(3)
#: streaming multiprocessors of the H100, and the (tile, chunk) items a
#: launch aims at for each
SMS = 132
ITEMS_PER_SM = 16


def material_boxes(plan, pols: bool = True):
    """The support boxes of the E family's chi3 / chi2 / nrchi2
    coefficients and (`pols`) its polarization sigmas, as ((lo, hi) per
    axis, ...), empty supports left out; None when one of them has no
    recorded box (its support is the whole grid)."""
    keys = []
    for s in plan.eh_specs_e:
        keys += [f"{s.ec}:chi3", f"{s.ec}:chi2"] if s.has_chi3 else []
        keys += [f"{s.ec}:nrchi2"] if s.has_nr else []
    if pols:
        keys += [f"pol{pi}:{c}:{d}" for pi, p in enumerate(plan.pol_specs_e)
                 for (c, d) in p.sigma]
    got = [(plan.support_boxes or {}).get(k, "full") for k in keys]
    if any(b == "full" for b in got):
        return None
    return [b for b in got if b is not None]


def _nl_clear_of_wrap(plan) -> bool:
    """The chi3 / chi2-NR support boxes at least 3 sites clear of both x
    wrap ends (the reference's periodicx._nl_clear_of_wrap :54-73), and the
    dispersive window (those boxes and the polarizations') a plane clear
    of them (periodic_supported :95-105)."""
    num0 = plan.gv.num[0]
    nl, disp = material_boxes(plan, pols=False), material_boxes(plan)
    if nl is None or disp is None:
        return False
    return all(b[0][0] >= 3 and b[0][1] <= num0 - 3 for b in nl) \
        and all(b[0][0] >= 1 and b[0][1] <= num0 - 1 for b in disp)


def supported(plan, allow_periodic_x: bool = False) -> bool:
    """The semantic envelope of the JAX package's fdtd3d.supported
    (fdtd3d.py:105-197): 3D, real fields, no H polarizations, E-family
    Lorentzian/Drude with diagonal sigma and no noise, no conductivity, no
    off-diagonal u, no periodicity, no cylindrical m, no BFAST, no
    integrated sources, no rot2/rot4/x-mirror, plane-representable masks.
    Node mirrors on y and z run as the reference's do (`mirror_yz_info`,
    fdtd3d.py:206): the D launch reads the fold ghost where the plain
    version's zero fill would be; an x mirror is declined (fdtd3d.py:121:
    the plan then runs on the eager stepper).  `allow_periodic_x` admits
    the reference's periodic_supported (periodicx.py:82-106): periodic
    along x only with a real phase, no node mirror, the nonlinear boxes 3
    sites and the dispersive window a plane clear of the wrap
    (`_nl_clear_of_wrap`); the B and D launches then read across the wrap
    (WRAP in csrc/fdtd3d.cu).

    Differences, all deliberate: the TPU-only conditions (the block depth
    bx, the VMEM budgets, the x-interior dispersive window of `_Layout`)
    are dropped, since this kernel has no x-blocks; at most MAXPOL
    polarizations."""
    gv = plan.gv
    if gv.dim != "3d" or plan.complex_fields or plan.bfast_k is not None:
        return False
    if plan.rot2 is not None or plan.rot4 is not None:
        return False
    if any(mn[0] == 0 for mn in plan.mirror_node):
        return False
    if plan.pol_specs_h or len(plan.pol_specs_e) > MAXPOL:
        return False
    for p in plan.pol_specs_e:
        if p.kind != "lorentzian" or p.noise_amp != 0.0:
            return False
        if any(d != c[1] for (c, d) in p.sigma):
            return False
    if plan.m or any(plan.periodic[1:]):
        return False
    if plan.periodic[0]:
        if not allow_periodic_x or plan.mirror_node \
                or isinstance(plan.bloch_phase[0], complex) \
                or not _nl_clear_of_wrap(plan):
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


def real_view(plan):
    """The single-channel view of a real-pair plan whose only complex part
    is the x Bloch phase (the reference's periodicx._real_view :231-241):
    every coefficient is real, so each channel steps as a real plan, and
    the phase, set to 1 here, enters only where a driver mixes the
    channels."""
    return dataclasses.replace(
        plan, complex_fields=False, real_pair=False,
        bloch_phase=(1.0,) + tuple(plan.bloch_phase[1:]))


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
                           "nr_iters")]


class _Box(ctypes.Structure):
    _fields_ = [("lo", ctypes.c_int * 3), ("hi", ctypes.c_int * 3)]


class _CurlC(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "gp", "gm", "ap", "am", "sax", "s_lo", "s_hi0", "s_n", "uax", "u_lo",
        "u_hi0", "u_n")]


class _EhC(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "wax", "w_lo", "w_hi0", "w_n", "has_u", "pols")]


#: the slab rule (lo, hi0, n) that holds at every site
EVERYWHERE = (2 ** 31 - 1, 0, 0)


def _rule(lo, hi, n, slab):
    """csrc/fdtd3d.cu's slab rule of a chain: on its slabs (c < lo or
    n - hi <= c < n) with plan.slab_opt, else everywhere."""
    return (lo, n - hi, n) if slab else EVERYWHERE


class _K1Args(ctypes.Structure):
    """Mirrors csrc/fdtd3d.cu's K1Args: one launch's argument block."""
    _fields_ = ([("P", _Params), ("ring", _P * MAXRING)]
                + [(n, _P) for n in ("src_ptr", "src_key", "src_id",
                                     "src_amp", "wave_dev")]
                + [("wave", ctypes.c_double * (2 * MAXSRC)),
                   ("dt", ctypes.c_double),
                   ("nl3", _Box * NCOMP), ("nlnr", _Box * NCOMP),
                   ("pol", (_Box * MAXPOL) * NCOMP), ("nl", _Box),
                   ("cc", _CurlC * NCOMP), ("ec", _EhC * NCOMP),
                   ("d_of", ctypes.c_int * NCOMP),
                   ("p_of", (ctypes.c_int * MAXPOL) * NCOMP)]
                + [(n, ctypes.c_int) for n in ("nring", "S0", "S1", "S2",
                                               "nty", "ntz", "ch", "nch",
                                               "mir")]
                + [("mk0", (ctypes.c_int * 2) * MAXRING),
                   ("msg", (ctypes.c_int * 2) * MAXRING),
                   ("wnum", ctypes.c_int), ("wpair", ctypes.c_int),
                   ("wsc", ctypes.c_double), ("wsci", ctypes.c_double)])


def set_mirror(A, plan, names):
    """The D launch's fold ghosts in an argument block (K1Args or K2Args),
    the reference's `mirror_yz_info` (fdtd3d.py:206): A.mir bit a - 1 on
    for a node mirror along axis a (1 y, 2 z), and for each H array
    `names[r]` of the launch's ring the ghost's (k0, sign) there
    (step.mirror_ghost): the backward difference at plane 0 reads
    sign * g[k0]."""
    A.mir = 0
    for (ax, d, phase) in plan.mirror_node:
        if ax == 0:
            continue
        A.mir |= 1 << (ax - 1)
        for r, g in enumerate(names):
            k0, sign = mirror_ghost(g, d, phase, plan.gv.dim)
            A.mk0[r][ax - 1], A.msg[r][ax - 1] = k0, int(sign)


def _lib():
    from . import _build
    return bind(_build.load("fdtd3d"))


def bind(lib):
    """Declare csrc/fdtd3d.cu's C functions on a loaded library and check
    its argument layout against this module's (once per library)."""
    if not getattr(lib, "_mnt_bound", False):
        lib.mnt_k1_params_size.restype = ctypes.c_longlong
        lib.mnt_k1_args_size.restype = ctypes.c_longlong
        lib.mnt_k1_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p]
        lib.mnt_k1_launch.restype = ctypes.c_int
        lib.mnt_k1_smem.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int]
        lib.mnt_k1_smem.restype = ctypes.c_longlong
        if lib.mnt_k1_params_size() != ctypes.sizeof(_Params) or \
                lib.mnt_k1_args_size() != ctypes.sizeof(_K1Args):
            raise RuntimeError("csrc/fdtd3d.cu argument layout does not "
                               "match ops/fdtd3d.py")
        tile = (ctypes.c_int * 2)()
        lib.mnt_k1_tile(tile)
        lib.mnt_tile = tuple(tile)
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


def _box(plan, keys, shape):
    """The union of the support boxes of coefficient `keys` as (lo, hi)
    per axis: a key without a recorded box covers the storage, a key with
    an empty support (None) nothing."""
    boxes = []
    for key in keys:
        b = (plan.support_boxes or {}).get(key, "full")
        if b == "full":
            b = tuple((0, n) for n in shape)
        if b is not None:
            boxes.append(b)
    if not boxes:
        return ((0, 0),) * 3
    return tuple((min(b[ax][0] for b in boxes), max(b[ax][1] for b in boxes))
                 for ax in range(3))


def _set_box(dst, box):
    for ax, (lo, hi) in enumerate(box):
        dst.lo[ax], dst.hi[ax] = lo, hi


def compact(A):
    """The 32-bit copies of the parameter block's fields that the site
    work reads (A.cc, A.ec), from A.P."""
    P = A.P
    for q in range(P.ncurl):
        c, cc = P.curl[q], A.cc[q]
        cc.ap, cc.am = c.ap, c.am
        cc.sax, cc.uax = c.sig_ax, c.sigu_ax
        cc.s_lo, cc.s_hi0, cc.s_n = _rule(c.sig_lo, c.sig_hi, c.sig_n,
                                          c.slab)
        cc.u_lo, cc.u_hi0, cc.u_n = _rule(c.sigu_lo, c.sigu_hi,
                                          c.sigu_n, c.slab)
    for q in range(P.neh):
        e, ec = P.eh[q], A.ec[q]
        ec.wax = e.w_ax
        ec.w_lo, ec.w_hi0, ec.w_n = _rule(e.w_lo, e.w_hi, e.w_n,
                                          e.w_slab)
        ec.has_u = 1 if e.u else 0
        ec.pols = sum(1 << p for p in range(P.npol) if e.pol[p].p)


#: K1's launches of a step: (family, [(kind, name)])
_LAUNCHES = (("b", ((K_B, "b_curl+src+h"),)),
             ("d", ((K_D, "d_curl+src"), (K_E, "e_from_d+pol"))))


def chunk_planes(shape, tile, items_per_sm: int = ITEMS_PER_SM) -> int:
    """x-planes per chunk of a K1 launch over y-z tiles of `tile` = (TY,
    TZ) sites: the fewest that still give `items_per_sm` (tile, chunk)
    items for each of the card's SMs."""
    S0, S1, S2 = shape
    tiles = -(-S1 // tile[0]) * -(-S2 // tile[1])
    nch = max(1, min(S0, -(-SMS * items_per_sm // tiles)))
    return -(-S0 // nch)


class Fdtd3dKernel:
    """One K1 step driver for one plan (the counterpart of the JAX
    package's Fdtd3dKernel): three launches per step (csrc/fdtd3d.cu: the
    B half with the H-family sources and H, the D half with the E-family
    sources, E with the ADE).  `ch` sets the x-planes per chunk (default
    `chunk_planes`).  The launch geometry, the source lists and the
    static parts of the argument blocks are made at the first CUDA step,
    for the tile of the loaded library.  `allow_periodic_x` takes an
    x-periodic plan (`supported`): its B and D launches read across the
    wrap, and leave the dead planes from num on to themselves (the plain
    version keeps them zero).  `pair` takes a real-pair plan whose
    `real_view` is in that envelope (ops/periodicx.py's
    PairPeriodicXKernel): each launch steps both channels (the PAIR
    kernels), its plain version is the eager pair step."""

    def __init__(self, plan, ch=None, allow_periodic_x: bool = False,
                 pair: bool = False):
        if not supported(real_view(plan) if pair else plan,
                         allow_periodic_x):
            raise ValueError("plan outside the fdtd3d kernel envelope")
        self.plan = plan
        self.pair = pair
        #: the x wrap: (live extent, phase), or None
        ph = complex(plan.bloch_phase[0])
        self.wrap = (plan.gv.num[0], ph if pair else ph.real) \
            if plan.periodic[0] else None
        self.shape = tuple(plan.storage_shape or plan.gv.shape)
        if int(np.prod(self.shape)) >= 2 ** 31:
            raise ValueError(f"fdtd3d: a storage of {self.shape} has 2^31 "
                             f"sites or more (the kernel's offsets are "
                             f"32-bit)")
        self.dtype = torch_dtype(plan.dtype)
        self._ref = step_ref(plan)
        self.launches = 0                 # CUDA launches
        self.plain_steps = 0              # steps of the plain version
        #: source indices by family (K2 takes them from here)
        self.sources = {
            "b": [si for si, s in enumerate(plan.sources)
                  if s.component[0] == "h"],
            "d": [si for si, s in enumerate(plan.sources)
                  if s.component[0] == "e"]}
        #: CUDA launches per step
        self.launches_per_step = 3
        S0, S1, S2 = self.shape
        self.ch = ch
        self.tile = self._key = None
        # flat storage offsets of the source sites (K2's source ops)
        self._src_off = {}
        for si in range(len(plan.sources)):
            i, j, k = source_index(plan, si)
            self._src_off[si] = ((i * S1 + j) * S2 + k).contiguous()

    def _setup(self, tile, state):
        """Launch geometry, source lists and, per launch, the argument
        block's parts that hold for every step, for y-z tiles of `tile` =
        (TY, TZ) sites and the plan's chain rule (plan.slab_opt)."""
        key = (tile, self.plan.slab_opt)
        if self._key == key:
            return
        S0, S1, S2 = self.shape
        self._key, self.tile = key, tile
        self.ch = self.ch or chunk_planes(self.shape, tile)
        self._geo = dict(S0=S0, S1=S1, S2=S2, nty=-(-S1 // tile[0]),
                         ntz=-(-S2 // tile[1]), ch=self.ch,
                         nch=-(-S0 // self.ch))
        self._src = {f: self._source_lists(f) for f in "bd"}
        self._static, self._ring_keys = {}, {}
        for fam, kinds in _LAUNCHES:
            P = build_params(self.plan, fam, state)
            for kind, _ in kinds:
                A = self._static_args(fam)
                A.P = P
                self._ring_keys[kind] = self._roles(A, kind, fam, state)
                compact(A)
                A.wpair = int(self.pair)
                if self.wrap is not None and kind != K_E:
                    # the live planes and the dead ones in chunks of
                    # their own; the wrapped plane's scale ph (B), 1/ph (D)
                    num, ph = self.wrap
                    A.wnum = num
                    sc = ph if kind == K_B else 1.0 / ph
                    A.wsc, A.wsci = float(np.real(sc)), float(np.imag(sc))
                    A.nch = -(-num // self.ch) + -(-(S0 - num) // self.ch)
                self._static[kind] = A

    def _source_lists(self, family):
        """The family's current sources as per-(tile, plane) lists for the
        thread that owns each site: entries sorted by (tile, plane), then
        by site and component, then in plan.sources order and entry order
        (the plain version's order of accumulation)."""
        plan = self.plan
        curls = plan.curl_specs_b if family == "b" else plan.curl_specs_d
        q_of = {s.c: q for q, s in enumerate(curls)}
        src = [si for si, s in enumerate(plan.sources)
               if (s.component[0] == "h") == (family == "b")]
        if not src:
            return None
        S0 = self.shape[0]
        ntz = self._geo["ntz"]
        TY, TZ = self.tile
        buckets, keys, ids, amps = [], [], [], []
        for w, si in enumerate(src):
            i, j, k = (t.cpu().numpy() for t in source_index(plan, si))
            q = q_of[family + plan.sources[si].component[1]]
            buckets.append(((j // TY) * ntz + k // TZ) * S0 + i)
            keys.append((((j % TY) * TZ + k % TZ) << 2) | q)
            ids.append(np.full(len(i), w))
            amps.append(torch.stack([plan.coefs[f"src{si}:amp_re"],
                                     plan.coefs[f"src{si}:amp_im"]], 1))
        bucket, key = np.concatenate(buckets), np.concatenate(keys)
        order = np.lexsort((np.arange(len(key)), key, bucket))
        ntile = self._geo["nty"] * ntz
        ptr = np.searchsorted(bucket[order], np.arange(ntile * S0 + 1))
        dev = plan.device

        def i32(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                   device=dev)

        amp = torch.cat(amps)[torch.as_tensor(order, device=dev)]
        return {"src": src, "ptr": i32(ptr), "key": i32(key[order]),
                "id": i32(np.concatenate(ids)[order]),
                "amp": amp.contiguous()}

    def _static_args(self, family):
        """What the argument blocks of a family's launches hold for every
        step: geometry, support boxes, source lists."""
        plan = self.plan
        shape = self.shape
        A = _K1Args()
        for k, v in self._geo.items():
            setattr(A, k, v)
        A.dt = plan.dt
        src = self._src[family]
        if src is not None:
            A.src_ptr, A.src_key = src["ptr"].data_ptr(), src["key"].data_ptr()
            A.src_id, A.src_amp = src["id"].data_ptr(), src["amp"].data_ptr()
        if family == "b":
            return A
        # the E launch's support boxes (coefficients zero outside them)
        nl = []
        for q, s in enumerate(plan.eh_specs_e):
            b3 = _box(plan, (f"{s.ec}:chi3", f"{s.ec}:chi2"), shape) \
                if s.has_chi3 else ((0, 0),) * 3
            bnr = _box(plan, (f"{s.ec}:nrchi2",), shape) if s.has_nr \
                else ((0, 0),) * 3
            _set_box(A.nl3[q], b3)
            _set_box(A.nlnr[q], bnr)
            nl += [b for b in (b3, bnr) if all(lo < hi for lo, hi in b)]
            for pi in range(len(plan.pol_specs_e)):
                _set_box(A.pol[q][pi],
                         _box(plan, (f"pol{pi}:{s.ec}:{s.ec[1]}",), shape))
        if nl:
            _set_box(A.nl, tuple((min(b[ax][0] for b in nl),
                                  max(b[ax][1] for b in nl))
                                 for ax in range(3)))
        return A

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
        shape = (2,) + self.shape if self.pair else self.shape
        if t.device.type != "cuda" or t.dtype != self.dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"fdtd3d: {what} must be a contiguous {self.dtype} CUDA "
                f"tensor of shape {shape}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")

    def launch_args(self, state, x_t):
        """[(name, kind, argument block)] of one step's launches over
        `state` with the source row `x_t`, in launch order."""
        plan = self.plan
        self._setup(_lib().mnt_tile, state)
        out = []
        for fam, kinds in _LAUNCHES:
            P = build_params(plan, fam, state)
            src = self._src[fam]
            wave = [] if src is None else [
                float(x_t[f"src{si}:cur_{p}"]) for si in src["src"]
                for p in ("re", "im")]
            wd = None
            if len(wave) > 2 * MAXSRC:
                wd = torch.tensor(wave, dtype=torch.float64,
                                  device=plan.device)
            for kind, name in kinds:
                A = _K1Args()
                ctypes.pointer(A)[0] = self._static[kind]
                A.P = P
                if wd is None:
                    A.wave[:len(wave)] = wave
                else:
                    A.wave_dev = wd.data_ptr()
                    A._wave_dev = wd            # alive until the launch
                for r, path in enumerate(self._ring_keys[kind]):
                    A.ring[r] = (state["f"][path[1]] if path[0] == "f" else
                                 state["pol"][path[1]]["p"][path[2]]
                                 ).data_ptr()
                out.append((name, kind, A))
        return out

    def _roles(self, A, kind, fam, state):
        """The arrays launch `kind` reads across sites (its plane ring):
        their roles in A, and their places in the state as a list of
        ("f", component) or ("p", polarization, component)."""
        plan = self.plan
        keys = []
        if kind == K_E:
            for q, s in enumerate(plan.eh_specs_e):
                A.d_of[q] = len(keys)
                keys.append(("f", s.dc))
                for pi in range(MAXPOL):
                    A.p_of[q][pi] = -1
                    if pi < len(state["pol"]) and \
                            s.ec in state["pol"][pi]["p"]:
                        A.p_of[q][pi] = len(keys)
                        keys.append(("p", pi, s.ec))
            A.nring = len(keys)
            return keys
        curls = plan.curl_specs_b if fam == "b" else plan.curl_specs_d
        names = []
        for s in curls:
            for g in (s.g_plus, s.g_minus):
                if g and g not in names:
                    names.append(g)
        A.nring = len(names)
        for q in range(NCOMP):
            A.cc[q].gp = A.cc[q].gm = -1
        for q, s in enumerate(curls):
            A.cc[q].gp = names.index(s.g_plus) if s.g_plus else -1
            A.cc[q].gm = names.index(s.g_minus) if s.g_minus else -1
        if kind == K_B:
            q_of = {s.c: q for q, s in enumerate(curls)}
            for q, s in enumerate(plan.eh_specs_h):
                A.d_of[q] = q_of[s.dc]
        else:
            set_mirror(A, plan, names)
        return [("f", g) for g in names]

    def _launch(self, lib, A, kind):
        rc = lib.mnt_k1_launch(ctypes.byref(A), kind,
                               1 if self.dtype == torch.float64 else 0,
                               torch.cuda.current_stream().cuda_stream)
        self.launches += 1
        if rc != 0:
            raise RuntimeError(f"fdtd3d kernel launch (kind {kind}) failed: "
                               f"cudaError {rc}")

    def _step_cuda(self, state, x_t):
        self._check(state)
        lib = _lib()
        for _, kind, A in self.launch_args(state, x_t):
            self._launch(lib, A, kind)
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
    PML slabs, the old H only where its W chain runs (the old E feeds the
    B curl everywhere), polarizations and material windows (nreps with
    nrchi2) only over the support boxes the plan recorded.  `ops` is a per-site count of the arithmetic
    in csrc/fdtd3d.cu (curl + chains ~12, E/H update ~6, the NR solve ~150
    per nonlinear site and component, the ADE ~8).  A real pair (K1's pair
    wrap) moves and steps both channels of every state array; it reads
    the coefficients once."""
    shape = tuple(plan.storage_shape or plan.gv.shape)
    N = int(np.prod(shape))
    item = np.dtype(plan.dtype).itemsize
    plane = {ax: N // shape[ax] for ax in range(3)}

    def slab_sites(ax, slabs):
        lo, hi = slabs
        return (lo + hi) * plane[ax]

    has_pols = bool(plan.pol_specs_e)
    elems = 0                                            # state arrays
    coef = 0                                             # coefficients
    for s in plan.curl_specs_b + plan.curl_specs_d:
        elems += 2 * N                                   # D/B read + write
        if s.dsigu_axis is not None:
            n = N if not plan.slab_opt else slab_sites(s.dsigu_axis,
                                                       s.dsigu_slabs)
            elems += 2 * n
    for s in plan.eh_specs_e + plan.eh_specs_h:
        n = 0                                            # W chain sites
        if s.dsigw_axis is not None:
            full = not plan.slab_opt or (has_pols and s.ec[0] == "e")
            n = N if full else slab_sites(s.dsigw_axis, s.dsigw_slabs)
            elems += 2 * n                               # f_w in and out
        elems += N + (N if s.ec[0] == "e" else n)        # E/H out, old in
        if s.has_u:
            coef += N
        if s.has_nr:
            coef += 2 * _box_sites(plan, f"{s.ec}:nrchi2", shape)
        if s.has_chi3:
            coef += (_box_sites(plan, f"{s.ec}:chi3", shape)
                     + _box_sites(plan, f"{s.ec}:chi2", shape))
    nl_sites = 0
    for s in plan.eh_specs_e:
        if s.has_nr:
            nl_sites += _box_sites(plan, f"{s.ec}:nrchi2", shape)
    pol_sites = 0
    for pi, p in enumerate(plan.pol_specs_e):
        for (c, d) in p.sigma:
            n = _box_sites(plan, f"pol{pi}:{c}:{d}", shape)
            elems += 3 * n                    # P, PP read; new P
            coef += n                         # sigma
            pol_sites += n
    ncomp = len(plan.curl_specs_b + plan.curl_specs_d)
    ops = 12 * ncomp * N + 6 * ncomp * N + 150 * nl_sites + 8 * pol_sites
    nch = 2 if _is_pair(plan) else 1
    return {"bytes": float((nch * elems + coef) * item),
            "ops": float(nch * ops)}


def launch_cost(plan) -> Dict[str, float]:
    """Bytes each of K1's launches must move per step, each array it reads
    read once and each it writes written once ('b': the B half, E read
    across sites, B in and out, H out, f_u and H's W chain where they run;
    'd': the D half, H read; 'e': E from D - P, D and u read, E out, E and
    f_w in and out where the W chain runs, P, PP and the new P over the
    grid, the material windows (nreps with nrchi2) over their support
    boxes).  The sum exceeds `step_cost`, which counts E and H once per
    step."""
    shape = tuple(plan.storage_shape or plan.gv.shape)
    N = int(np.prod(shape))
    item = np.dtype(plan.dtype).itemsize
    plane = {ax: N // shape[ax] for ax in range(3)}

    def sites(ax, slabs, full):
        return N if full else (slabs[0] + slabs[1]) * plane[ax]

    out = {}
    for fam, curls, ehs in (("b", plan.curl_specs_b, plan.eh_specs_h),
                            ("d", plan.curl_specs_d, ())):
        partners = {g for s in curls for g in (s.g_plus, s.g_minus) if g}
        elems = len(partners) * N
        for s in curls:
            elems += 2 * N
            if s.dsigu_axis is not None:
                elems += 2 * sites(s.dsigu_axis, s.dsigu_slabs,
                                   not plan.slab_opt)
        for s in ehs:
            elems += N + (N if s.has_u else 0)
            if s.dsigw_axis is not None:
                elems += 3 * sites(s.dsigw_axis, s.dsigw_slabs,
                                   not plan.slab_opt)
        out[fam] = float(elems * item)
    has_pols = bool(plan.pol_specs_e)
    elems = 0
    for s in plan.eh_specs_e:
        elems += 2 * N + (N if s.has_u else 0)
        if s.dsigw_axis is not None:
            elems += 3 * sites(s.dsigw_axis, s.dsigw_slabs,
                               not plan.slab_opt or has_pols)
        if s.has_nr:
            elems += 2 * _box_sites(plan, f"{s.ec}:nrchi2", shape)
        if s.has_chi3:
            elems += (_box_sites(plan, f"{s.ec}:chi3", shape)
                      + _box_sites(plan, f"{s.ec}:chi2", shape))
    for pi, p in enumerate(plan.pol_specs_e):
        for (c, d) in p.sigma:
            elems += 3 * N + _box_sites(plan, f"pol{pi}:{c}:{d}", shape)
    out["e"] = float(elems * item)
    return out
