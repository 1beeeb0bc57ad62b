"""K2: `depth` (2 or 3) Yee steps in one pass over the grid, as one
hand-written CUDA kernel (csrc/fdtd3d_t2.cu), with its capture variant.

The port of ``meep_nl_tpu/ops/pallas/fdtd3d_t2.py`` (``_build_call2``, driven
by ``Fdtd3dT2Kernel``).  One call computes `depth` applications of K1's step
(ops/fdtd3d.py), stage s with row s of the source table; with `cap_planes`
it also returns the E/H x-planes of the intermediate stages, which the
hybrid driver feeds to the DTFT so that a run that samples every step still
advances `depth` steps per pass.  The state is the eager stepper's own dict
(`to_full`/`from_full` are the identity, as K1's).

The kernel marches a wavefront along x over a ring of x-planes (scratch of
R = O(depth + bx) planes per state array): LOAD copies state planes into the
ring, the stages update the ring in place, STORE copies finished planes
back.  `program` lists the ops of one call with the planes each reads and
writes; `schedule` derives every op's phase and x offset from those sets;
the CUDA kernel executes that table (see the header of csrc/fdtd3d_t2.cu).

`Fdtd3dT2Kernel.step` launches the kernel when the state lies on a CUDA
device and updates its tensors in place; for a state on the CPU it runs the
plain version `steps_ref`.  `launches` counts the CUDA launches (one per
call), `plain_steps` the steps the plain version took; the residue of a
`run` whose length is no multiple of `depth` goes through K1, on K1's own
counters.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import fdtd3d
from ..stepper.step import build_xs, xs_rows

MAXDEPTH = 3
MAXOPS = 48
MAXCOPY = 64
MAXSRC = 8
MAXCAP = 48
OP_LOAD, OP_STORE, OP_BC, OP_BH, OP_HH, OP_DC, OP_EE, OP_SRC = range(8)

#: smallest and largest default block depth (x-planes per wavefront block)
BX_MIN, BX_MAX = 8, 32


def supported(plan, depth: int = 2) -> bool:
    """The semantic envelope of the JAX package's fdtd3d_t2.supported
    (fdtd3d_t2.py:129-172): K1's envelope (`fdtd3d.supported`), `depth` 2 or
    3, and at least two x-planes per stage (a stage trails the one before it
    by the +-1 x reach of the curls and of the chi2/chi3 neighbour sums).

    Differences, all deliberate.  Dropped, because they describe the TPU
    kernel's blocking and not the function: the VMEM budgets of `_pick_bx`
    (:68-100), the dispersive window clear of the edge calls (`_disp_fits`
    :54), the `bx >= 8` rule for folded conductivity at depth 3 (:157; the
    port's K1 declines conductivity altogether), `_cond_clear_of_window`
    (:103) and the block counts between the x-PML slabs (:164-169): this
    kernel has one schedule for every plane and no call segments.  Not
    needed: the reference declines `has_u` on an H spec (:146-148) because
    its trailing stage lacks the full mu-inverse; every stage here reads
    the coefficient arrays at the site's true index, so mu != 1 runs."""
    if depth not in (2, 3) or not fdtd3d.supported(plan):
        return False
    S0 = tuple(plan.storage_shape or plan.gv.shape)[0]
    return S0 >= 2 * depth


def capture_list(depth: int, cap_planes) -> List[Tuple[int, str, int]]:
    """[(stage, comp, x)] of the planes one call captures: E components
    after stages 1..depth-1 (the last stage's E is read from the advanced
    state), H components after every stage (the rule of the reference's
    Fdtd3dT2Kernel.__init__, fdtd3d_t2.py:2125-2134)."""
    out = []
    for comp, x in sorted(set(cap_planes or [])):
        last = depth - 1 if comp[0] == "e" else depth
        out += [(s, comp, int(x)) for s in range(1, last + 1)]
    return out


def cap_key(stage: int, comp: str, x: int) -> str:
    return f"cap:{stage}:{comp}:{x}"


def steps_ref(plan, depth: int, cap_planes=None):
    """The plain version: fn(state, rows) -> (state advanced `depth` steps,
    {cap:{stage}:{comp}:{x}: (1, S1, S2) plane}); `rows` are the `depth`
    per-step rows of the xs table."""
    step = fdtd3d.step_ref(plan)
    want = capture_list(depth, cap_planes)

    def run(state, rows):
        caps = {}
        for s in range(1, depth + 1):
            state = step(state, rows[s - 1] if rows else {})
            for st, comp, x in want:
                if st == s:
                    caps[cap_key(s, comp, x)] = state["f"][comp][x:x + 1]
        return state, caps

    return run


# ---------------------------------------------------------------------------
# the schedule: ops, the planes they read and write, phases and offsets
# ---------------------------------------------------------------------------

#: array groups of the ring: fields, PML auxiliaries, the two polarization
#: arrays (PA: the state's p, PB: its pp; their roles alternate per stage)
GROUPS = ("E", "H", "D", "B", "FUB", "FUD", "FWH", "FWE", "PA", "PB")


@dataclasses.dataclass
class Op:
    """One op of a call.  At wavefront step w it works on the x-planes
    [w*bx - off, w*bx - off + bx); `reads` holds (group, dx) pairs (it reads
    the group at x + dx), `writes` the groups it updates at x."""
    name: str
    kind: int
    stage: int                          # 0-based; -1 for LOAD/STORE
    reads: FrozenSet[Tuple[str, int]]
    writes: FrozenSet[str]
    arg: int = 0                        # OP_SRC: index into the source table
    phase: int = 0
    off: int = 0


def program(depth: int, b_src: Sequence[int] = (),
            d_src: Sequence[int] = ()) -> List[Op]:
    """The ops of one call in the order of the sequential algorithm, with
    their read and write sets (a transcription of what each op's code in
    csrc/fdtd3d_t2.cu touches).  `b_src` / `d_src`: indices into the source
    table of the B- and D-family sources."""
    def here(*groups):
        return {(g, 0) for g in groups}

    ops = [Op("load", OP_LOAD, -1, frozenset(), frozenset(GROUPS))]
    bc = (here("E", "B", "FUB") | {("E", 1)}, {"B", "FUB"})
    hh = (here("B", "H", "FWH"), {"H", "FWH"})
    for s in range(depth):
        pcur, pprev = ("PA", "PB") if s % 2 == 0 else ("PB", "PA")
        if b_src:
            ops.append(Op(f"bc{s}", OP_BC, s, frozenset(bc[0]),
                          frozenset(bc[1])))
            for a in b_src:
                ops.append(Op(f"bsrc{s}:{a}", OP_SRC, s,
                              frozenset(here("B")), frozenset({"B"}), arg=a))
            ops.append(Op(f"hh{s}", OP_HH, s, frozenset(hh[0]),
                          frozenset(hh[1])))
        else:
            ops.append(Op(f"bh{s}", OP_BH, s, frozenset(bc[0] | hh[0]),
                          frozenset(bc[1] | hh[1])))
        ops.append(Op(f"dc{s}", OP_DC, s,
                      frozenset(here("H", "D", "FUD") | {("H", -1)}),
                      frozenset({"D", "FUD"})))
        for a in d_src:
            ops.append(Op(f"dsrc{s}:{a}", OP_SRC, s, frozenset(here("D")),
                          frozenset({"D"}), arg=a))
        ee_reads = here("D", pcur, pprev, "E", "FWE") | {
            ("D", -1), ("D", 1), (pcur, -1), (pcur, 1)}
        ops.append(Op(f"ee{s}", OP_EE, s, frozenset(ee_reads),
                      frozenset({"E", "FWE", pprev})))
    ops.append(Op("store", OP_STORE, -1, frozenset(here(*GROUPS)),
                  frozenset()))
    return ops


def _reach(first: Op, then: Op) -> Optional[int]:
    """The largest dx such that `then` at plane x needs `first` done on
    plane x + dx (None: independent): read-after-write, write-after-write
    and write-after-read of the two ops' sets."""
    dxs = [dx for g, dx in then.reads if g in first.writes]
    dxs += [0 for g in then.writes if g in first.writes]
    dxs += [-dx for g, dx in first.reads if g in then.writes]
    return max(dxs) if dxs else None


def schedule(ops: List[Op], bx: int, nphase: Optional[int] = None
             ) -> Tuple[int, int]:
    """Give every op its phase and x offset (in place; `ops` stay in program
    order) and return (nphase, R).

    A wavefront step runs the phases in order, a grid-wide barrier after
    each.  `then` at plane x needs `first` done on plane x + dx; `first`
    reaches that plane at step (x + dx + first.off) // bx, so
    then.off >= first.off + dx does when first's phase is earlier, and a
    whole block more when it is not.  Each op greedily takes the phase that
    lets it trail least.  A ring slot is reloaded `R` planes later, after
    every op that touches its plane or the plane's x neighbours has passed:
    R = largest offset + 1 + bx."""
    nphase = nphase or len(ops)
    placed: List[Op] = []
    for op in ops:
        best = None
        for ph in range(nphase):
            off = 0
            for first in placed:
                dx = _reach(first, op)
                if dx is not None:
                    off = max(off, first.off + dx
                              + (0 if first.phase < ph else bx))
            if best is None or off < best[0]:
                best = (off, ph)
        op.off, op.phase = best
        placed.append(op)
    return nphase, max(op.off for op in ops) + 1 + bx


# ---------------------------------------------------------------------------
# the C argument block (mirrors csrc/fdtd3d_t2.cu; every member is 8 bytes)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_longlong
_D = ctypes.c_double


class _OpC(ctypes.Structure):
    _fields_ = [(n, _I) for n in ("kind", "stage", "phase", "off", "arg")]


class _CopyArr(ctypes.Structure):
    _fields_ = [("state", _P), ("ring", _P)] + \
        [(n, _I) for n in ("ax", "lo", "hi", "n")]


class _Src(ctypes.Structure):
    _fields_ = [("f", _P), ("off", _P), ("are", _P), ("aim", _P), ("n", _I),
                ("wre", _D * MAXDEPTH), ("wim", _D * MAXDEPTH)]


class _Cap(ctypes.Structure):
    _fields_ = [("out", _P)] + [(n, _I) for n in ("stage", "fam", "q", "x")]


class _K2Args(ctypes.Structure):
    _fields_ = [("pb", fdtd3d._Params * MAXDEPTH),
                ("pd", fdtd3d._Params * MAXDEPTH),
                ("ops", _OpC * MAXOPS),
                ("load", _CopyArr * MAXCOPY), ("store", _CopyArr * MAXCOPY),
                ("src", _Src * MAXSRC), ("cap", _Cap * MAXCAP),
                ("dt", _D)] + \
        [(n, _I) for n in ("nops", "nphase", "nload", "nstore", "ncap",
                           "depth", "bx", "nwave", "S0", "S1", "S2", "R")]


def _lib():
    from . import _build
    lib = _build.load("fdtd3d_t2")
    if not getattr(lib, "_mnt_bound", False):
        lib.mnt_k2_args_size.restype = ctypes.c_longlong
        lib.mnt_k2_max_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.mnt_k2_max_blocks.restype = ctypes.c_int
        lib.mnt_k2_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p]
        lib.mnt_k2_launch.restype = ctypes.c_int
        if lib.mnt_k2_args_size() != ctypes.sizeof(_K2Args):
            raise RuntimeError("csrc/fdtd3d_t2.cu K2Args layout does not "
                               "match ops/fdtd3d_t2.py")
        lib._mnt_bound = True
    return lib


def k1_of(plan) -> fdtd3d.Fdtd3dKernel:
    """The plan's one K1 kernel object (the residue step of every K2 kernel
    of the plan and the hybrid driver's one-step calls share it, so its
    counters see every K1 step of the plan)."""
    ker = plan.__dict__.get("_k1_kernel")
    if ker is None:
        ker = plan._k1_kernel = fdtd3d.Fdtd3dKernel(plan)
    return ker


class Fdtd3dT2Kernel:
    """`depth` steps per call for one plan (the counterpart of the JAX
    package's Fdtd3dT2Kernel).  `cap_planes`: [(comp, x)] monitor planes
    whose intermediate stages `capture_step` returns; `bx`: x-planes per
    wavefront block (default: `_pick_bx`).

    The CUDA kernel reads its argument block from one constant-memory
    symbol of the library, uploaded in stream order before each launch: all
    K2 calls of a process must be issued on one CUDA stream."""

    def __init__(self, plan, depth: int = 2, cap_planes=None,
                 bx: Optional[int] = None):
        if not supported(plan, depth):
            raise ValueError("plan outside the fdtd3d_t2 kernel envelope")
        self.plan = plan
        self.depth = depth
        self.k3 = None                    # ops/hybrid.py sets its depth-3 companion
        self._k1 = k1_of(plan)
        self.shape = self._k1.shape
        self.dtype = self._k1.dtype
        self.cap_planes = sorted(set((c, int(x)) for c, x in
                                     (cap_planes or [])))
        self.captures = capture_list(depth, self.cap_planes)
        comps = {s.ec for s in plan.eh_specs_e + plan.eh_specs_h}
        for comp, x in self.cap_planes:
            if comp not in comps or not 0 <= x < self.shape[0]:
                raise ValueError(f"no capture plane ({comp!r}, {x})")
        if len(self.captures) > MAXCAP or len(plan.sources) > MAXSRC:
            raise ValueError("too many capture planes or sources for the "
                             "fdtd3d_t2 kernel's argument block")
        self._ref = steps_ref(plan, depth, self.cap_planes)
        self.launches = 0                 # CUDA launches
        self.launches_per_call = 1
        self.plain_steps = 0              # steps of the plain version
        self.bx = bx
        self._cuda = None                 # built at the first CUDA call

    # ---- the identity conversions of this slice ---------------------------
    def to_full(self, state, C=None):
        return state

    def from_full(self, full):
        return full

    # ---- stepping ----------------------------------------------------------
    def capture_step(self, state: Dict[str, Any], rows
                     ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Advance `depth` steps with the `depth` rows of the xs table;
        returns (state, captured planes).  CUDA state: in place through the
        kernel (the capture tensors are this object's and are overwritten
        by its next call); CPU state: the plain version."""
        dev = state["f"][self.plan.curl_specs_d[0].c].device
        if dev.type == "cpu":
            self.plain_steps += self.depth
            return self._ref(state, rows)
        if dev.type != "cuda":
            raise RuntimeError(f"fdtd3d_t2: unsupported device {dev}")
        return self._step_cuda(state, rows)

    def step(self, state: Dict[str, Any], rows) -> Dict[str, Any]:
        return self.capture_step(state, rows)[0]

    def run(self, state, nsteps: int, t0: int = 0):
        """nsteps // depth calls, the residue through K1 (the reference's
        run, fdtd3d_t2.py:2196-2225)."""
        rows = xs_rows(self.plan, build_xs(self.plan, nsteps, t0))
        ncall = nsteps // self.depth
        for c in range(ncall):
            state = self.step(state, rows[c * self.depth:
                                          (c + 1) * self.depth])
        for i in range(ncall * self.depth, nsteps):
            state = self._k1.step(state, rows[i] if rows else {})
        return state

    # ---- CUDA path ---------------------------------------------------------
    def _pick_bx(self, threads: int) -> int:
        """x-planes per block: as many as one pass of the co-resident
        grid's `threads` covers, within [BX_MIN, BX_MAX] and the grid.  A
        deeper block means fewer barriers and a longer ring; measured on
        the H100 the time per step is flat from 8 planes on (PERF.md)."""
        per_pass = threads // (self.shape[1] * self.shape[2])
        return int(min(BX_MAX, max(BX_MIN, per_pass), self.shape[0]))

    def _ring_like(self, t_by_key, R):
        return {c: torch.zeros((R,) + self.shape[1:], dtype=self.dtype,
                               device=self.plan.device) for c in t_by_key}

    def _setup_cuda(self, state):
        """The ring, the schedule and the static part of the argument
        block, for the plan as it is now (plan.slab_opt included)."""
        plan, k1, depth = self.plan, self._k1, self.depth
        S0, S1, S2 = self.shape
        narr = (len(state["f"]) + len(state["f_u"]) + len(state["f_w"])
                + sum(2 * len(e["p"]) for e in state["pol"]))
        if narr > MAXCOPY:
            raise ValueError("too many state arrays for the fdtd3d_t2 "
                             "kernel's argument block")
        src_ids = k1.sources["b"] + k1.sources["d"]
        table = {si: a for a, si in enumerate(src_ids)}
        ops = program(depth, [table[si] for si in k1.sources["b"]],
                      [table[si] for si in k1.sources["d"]])
        if len(ops) > MAXOPS:
            raise ValueError("too many ops for the fdtd3d_t2 kernel")
        fp64 = 1 if self.dtype == torch.float64 else 0
        # the kernel has a variant without the chi3 / chi2-NR branches
        nl = 1 if any(s.has_chi3 or s.has_nr for s in plan.eh_specs_e) else 0
        most = _lib().mnt_k2_max_blocks(fp64, nl)
        if most < 1:
            raise RuntimeError(f"fdtd3d_t2: no co-resident grid "
                               f"(cudaError {-most})")
        bx = self.bx or self._pick_bx(most * 256)
        nphase, R = schedule(ops, bx)
        ring = {"f": self._ring_like(state["f"], R),
                "f_u": self._ring_like(state["f_u"], R),
                "f_w": self._ring_like(state["f_w"], R),
                "pol": [{k: self._ring_like(e[k], R) for k in ("p", "pp")}
                        for e in state["pol"]]}
        A = _K2Args()
        A.depth, A.bx, A.R, A.dt = depth, bx, R, plan.dt
        A.S0, A.S1, A.S2 = S0, S1, S2
        A.nphase = nphase
        A.nwave = (S0 - 1 + max(op.off for op in ops)) // bx + 1
        order = sorted(ops, key=lambda op: op.phase)     # stable
        A.nops = len(order)
        for o, op in enumerate(order):
            A.ops[o] = _OpC(op.kind, max(op.stage, 0), op.phase, op.off,
                            op.arg)
        # per stage: K1's parameter blocks over the ring, with the
        # polarization roles of that stage
        for s in range(depth):
            a, b = ("p", "pp") if s % 2 == 0 else ("pp", "p")
            view = {**ring, "pol": [{"p": e[a], "pp": e[b]}
                                    for e in ring["pol"]]}
            for fam, dst in (("b", A.pb), ("d", A.pd)):
                P = fdtd3d.build_params(k1.plan, fam, view)
                P.R = R
                dst[s] = P
        # LOAD / STORE: (path into the state, ring tensor, slab).  f_u and
        # the slab-mode f_w exist only on their PML slabs (plan.slab_opt)
        copies = [(("f", c), t, None) for c, t in ring["f"].items()]
        has_pols = bool(plan.pol_specs_e)
        for s in plan.curl_specs_d + plan.curl_specs_b:
            if s.c in ring["f_u"]:
                slab = ((s.dsigu_axis, s.dsigu_slabs) if plan.slab_opt
                        else None)
                copies.append((("f_u", s.c), ring["f_u"][s.c], slab))
        for s in plan.eh_specs_e + plan.eh_specs_h:
            if s.ec in ring["f_w"]:
                local = plan.slab_opt and not (has_pols and s.ec[0] == "e")
                slab = (s.dsigw_axis, s.dsigw_slabs) if local else None
                copies.append((("f_w", s.ec), ring["f_w"][s.ec], slab))
        # after `depth` stages the newest P lies in the ring's p array when
        # depth is even, else in its pp array
        new, old = ("p", "pp") if depth % 2 == 0 else ("pp", "p")
        load = list(copies)
        store = list(copies)
        for pi, e in enumerate(ring["pol"]):
            for c in e["p"]:
                load += [(("pol", pi, "p", c), e["p"][c], None),
                         (("pol", pi, "pp", c), e["pp"][c], None)]
                store += [(("pol", pi, "p", c), e[new][c], None),
                          (("pol", pi, "pp", c), e[old][c], None)]
        for lst, dst in ((load, A.load), (store, A.store)):
            for a, (_, t, slab) in enumerate(lst):
                dst[a].ring = t.data_ptr()
                dst[a].ax = -1
                if slab is not None:
                    ax, (lo, hi) = slab
                    dst[a].ax, dst[a].lo, dst[a].hi = ax, lo, hi
                    dst[a].n = plan.gv.num[ax] + 1
        A.nload, A.nstore = len(load), len(store)
        C = plan.coefs
        for si, a in table.items():
            s = plan.sources[si]
            fam = "b" if s.component[0] == "h" else "d"
            A.src[a].f = ring["f"][fam + s.component[1]].data_ptr()
            A.src[a].off = k1._src_off[si].data_ptr()
            A.src[a].are = C[f"src{si}:amp_re"].data_ptr()
            A.src[a].aim = C[f"src{si}:amp_im"].data_ptr()
            A.src[a].n = k1._src_off[si].numel()
        q_of = {s.ec: q for specs in (plan.eh_specs_e, plan.eh_specs_h)
                for q, s in enumerate(specs)}
        caps = {}
        for a, (st, comp, x) in enumerate(self.captures):
            out = caps[cap_key(st, comp, x)] = torch.zeros(
                (1, S1, S2), dtype=self.dtype, device=plan.device)
            A.cap[a] = _Cap(out.data_ptr(), st - 1,
                            1 if comp[0] == "e" else 0, q_of[comp], x)
        A.ncap = len(self.captures)
        busiest = max(sum(1 for op in ops if op.phase == ph)
                      for ph in range(nphase))
        self._cuda = {
            "args": A, "ring": ring, "caps": caps, "load": load,
            "store": store, "sources": table, "slab_opt": plan.slab_opt,
            "blocks": -(-(bx * S1 * S2 * busiest) // 256),
            "ops": ops, "bx": bx, "R": R}
        return self._cuda

    @staticmethod
    def _lookup(state, path):
        t = state
        for key in path:
            t = t[key]
        return t

    def _step_cuda(self, state, rows):
        self._k1._check(state)
        if len(rows) != self.depth and (rows or self.plan.sources):
            raise ValueError(f"fdtd3d_t2: {self.depth} rows of the xs table "
                             f"expected, got {len(rows)}")
        lib = _lib()
        cu = self._cuda
        if cu is None or cu["slab_opt"] != self.plan.slab_opt:
            cu = self._setup_cuda(state)
        A = cu["args"]
        for name, dst in (("load", A.load), ("store", A.store)):
            for a, (path, _, _) in enumerate(cu[name]):
                dst[a].state = self._lookup(state, path).data_ptr()
        for si, a in cu["sources"].items():
            for s in range(self.depth):
                A.src[a].wre[s] = float(rows[s][f"src{si}:cur_re"])
                A.src[a].wim[s] = float(rows[s][f"src{si}:cur_im"])
        rc = lib.mnt_k2_launch(ctypes.byref(A), cu["blocks"],
                               1 if self.dtype == torch.float64 else 0,
                               torch.cuda.current_stream().cuda_stream)
        self.launches += 1
        if rc != 0:
            raise RuntimeError(f"fdtd3d_t2 kernel launch failed: "
                               f"cudaError {rc}")
        return {**state, "t": state["t"] + self.depth}, cu["caps"]


# ---------------------------------------------------------------------------
# the bound: bytes and operations one call must move / do
# ---------------------------------------------------------------------------


def step_cost(plan, depth: int = 2, ncap: int = 0) -> Dict[str, float]:
    """Bytes and floating-point operations of one call, whatever design
    implements it: every state array read once and written once per `depth`
    steps (K1's byte count, not multiplied), `ncap` captured (S1, S2)
    planes written once, `depth` times K1's operations."""
    one = fdtd3d.step_cost(plan)
    S = tuple(plan.storage_shape or plan.gv.shape)
    item = np.dtype(plan.dtype).itemsize
    return {"bytes": one["bytes"] + float(ncap * S[1] * S[2] * item),
            "ops": depth * one["ops"]}
