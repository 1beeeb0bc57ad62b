"""The hybrid route's drivers for 3D cells Bloch-periodic along x with a
real phase ph = +-1 (k_x = 0 or the zone edge).

The port of ``meep_nl_tpu/ops/pallas/periodicx.py``; `hybrid._get_kernel`
picks them in the reference's order (hybrid.py:79-113):

  * the ghost ring (`PeriodicGhostT2Kernel`, :786-927), for plans without
    DFT monitors: the x period [0, N) is embedded in an aperiodic grid
    with ghost planes on both sides (`ghost_ring_ext`, :657-769), whose
    coefficients are the period's wrapped without the phase and whose
    sources have images in the opposite ghost zone; K2 runs unchanged on
    that extended plan, and before every call the ghost zones are
    re-seeded from the interior times ph (left: the period's last planes,
    right: its first).  A K2 call of depth d moves the corruption from the
    extended grid's edges at most a few planes a step, which dies inside
    the margin;
  * K1's x-wrap variant (`PeriodicXKernel`, :109-228) behind the two-step
    adapter, for everything else in its envelope (`periodic_supported`,
    :82-106): the B launch reads plane num as ph E(0), the D launch plane
    -1 as (1 / ph) H(num - 1) (WRAP in csrc/fdtd3d.cu).

Not copied: the reference's ghost-plane refresh and wrap carry of the
x-wrap driver (`fused_mesh.carry_plane`, `boundary_statics`, `strip.py`):
K1 runs B, D and E as separate launches, so the D launch reads the
H(num - 1) the B launch has written, and the dead planes from num on are
never written (there is no ghost residue to kill: `to_full` is the
identity, as K1's).  `PeriodicXT2Kernel` (:540-655), the reference's
choice for linear monitored plans, needs K2's periodic mode (ROADMAP
B1.2); this port takes K1's x wrap there, which is exact (ROADMAP C.2).
Complex phases wait for complex fields (ROADMAP A9).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import fdtd3d, fdtd3d_t2
from ..stepper.step import build_xs, xs_rows

#: ghost planes on each side of the period (the reference's `margin`)
MARGIN = 12
#: planes of x = 0 and x = N a dispersive / nonlinear window keeps clear of
#: on the ghost ring (ROADMAP C.3 item 4: the reference admits windows
#: flush with the wrap, where its ghost ring drifts from the stepper)
WINDOW_CLEAR = 4


def periodic_supported(plan) -> bool:
    """K1's x-wrap envelope (the reference's periodic_supported,
    periodicx.py:82-106, without its TPU-only block and layout rules):
    `fdtd3d.supported(plan, allow_periodic_x=True)` on an x-periodic 3D
    plan."""
    return plan.gv.dim == "3d" and bool(plan.periodic[0]) \
        and fdtd3d.supported(plan, allow_periodic_x=True)


class PeriodicXKernel(fdtd3d.Fdtd3dKernel):
    """K1 on an x-periodic plan: the same three launches a step, the B and
    D launches in their WRAP variant.  Its plain version is `step_ref`,
    whose eager shifts wrap with the phase (step._sh)."""

    def __init__(self, plan, ch=None):
        if not periodic_supported(plan):
            raise ValueError("plan outside the periodic-x kernel envelope")
        super().__init__(plan, ch=ch, allow_periodic_x=True)


# ---------------------------------------------------------------------------
# the ghost ring
# ---------------------------------------------------------------------------


def ghost_ring_ext(plan, margin: int = MARGIN) -> Optional[tuple]:
    """(ext_plan, Gl, Gr, N, ph) of the ghost-ring layout, or None (the
    reference's _ghost_ring_ext, periodicx.py:657-769).

    The period [0, N) becomes planes [Gl, Gl + N) of an aperiodic grid of
    Gl + N + Gr x-planes: the x-leading coefficient arrays are wrapped
    without the phase (the material is periodic, F(x + L) = ph F(x) holds
    for the fields only), the x mask planes at i >= N (the dead plane and
    the padding) are dropped, the support boxes are those of the wrapped
    arrays, and each source site within a margin of an end has an image
    in the opposite ghost zone (left: amplitude times conj(ph), right:
    times ph).  A source entry on a dead plane (x >= N: no live field
    reads it) is left out.  Declined, besides what K2 declines on the
    extended plan (`periodic_ghost_supported`): other periodic axes, node
    mirrors, complex fields, DFT monitors, PML chains along x, an x mask
    plane inside the period, a margin of N or more (ROADMAP C.3 item 5:
    the right ghosts must be interior planes), a dispersive or nonlinear
    window within WINDOW_CLEAR planes of x = 0 or x = N (C.3 item 4)."""
    gv = plan.gv
    if gv.dim != "3d" or not plan.periodic[0] or any(plan.periodic[1:]):
        return None
    if plan.mirror_node or plan.complex_fields or plan.real_pair \
            or plan.dfts:
        return None
    ph_c = complex(plan.bloch_phase[0])
    if abs(ph_c.imag) > 1e-12 or abs(abs(ph_c.real) - 1.0) > 1e-12:
        return None
    ph = float(ph_c.real)
    N = gv.num[0]
    if any(ax == 0 for s in plan.curl_specs_b + plan.curl_specs_d
           for ax in (s.dsig_axis, s.dsigu_axis)) \
            or any(s.dsigw_axis == 0
                   for s in plan.eh_specs_e + plan.eh_specs_h):
        return None
    win = fdtd3d.material_boxes(plan)
    if plan.pol_specs_h or win is None or any(
            b[0][0] < WINDOW_CLEAR or b[0][1] > N - WINDOW_CLEAR
            for b in win):
        return None
    Gl = Gr = margin
    if Gl >= N or Gr > N:
        return None
    ext_masks: Dict[str, Any] = {}
    for c, planes in (plan.mask_planes or {}).items():
        if planes is None:
            return None
        if any(ax == 0 and i < N for ax, i in planes):
            return None
        ext_masks[c] = [(ax, i) for ax, i in planes if ax != 0]
    S = tuple(plan.storage_shape or gv.shape)
    ext = Gl + N + Gr

    def wrapx(t):
        if t.ndim == 3 and t.shape[0] == S[0]:
            live = t[:N]
            return torch.cat([live[N - Gl:], live, live[:Gr]], 0)
        return t

    coefs = {k: wrapx(v) for k, v in plan.coefs.items()
             if not k.startswith("src")}
    boxes = {}
    for k, b in (plan.support_boxes or {}).items():
        if b is None:
            boxes[k] = None
            continue
        nz = torch.nonzero(coefs[k] != 0) if k in coefs else None
        boxes[k] = None if nz is None or len(nz) == 0 else tuple(
            (int(nz[:, ax].min()), int(nz[:, ax].max()) + 1)
            for ax in range(3))
    sources = []
    for si, s in enumerate(plan.sources):
        idx = np.asarray(s.indices).copy()
        amps = np.asarray(s.amps).copy()
        keep = idx[:, 0] < N
        idx, amps = idx[keep], amps[keep]
        rows = [np.concatenate([idx[:, :1] + Gl, idx[:, 1:]], 1)]
        arows = [amps]
        left = idx[:, 0] >= N - Gl
        im = idx[left].copy()
        im[:, 0] += Gl - N
        rows.append(im)
        arows.append(amps[left] * np.conj(ph))
        right = idx[:, 0] < Gr
        im = idx[right].copy()
        im[:, 0] += Gl + N
        rows.append(im)
        arows.append(amps[right] * ph)
        s2 = dataclasses.replace(s, indices=np.concatenate(rows).astype(
            np.int32), amps=np.concatenate(arows))
        sources.append(s2)
        amp = np.asarray(s2.amps, np.complex128)
        dt = plan.coefs[f"src{si}:amp_re"].dtype
        for key, val in (("idx", s2.indices), ("amp_re", amp.real),
                         ("amp_im", amp.imag)):
            coefs[f"src{si}:{key}"] = torch.as_tensor(
                np.ascontiguousarray(val), device=plan.device,
                dtype=torch.int32 if key == "idx" else dt)
    ext_plan = dataclasses.replace(
        plan, storage_shape=(ext,) + S[1:], coefs=coefs, sources=sources,
        periodic=(False,) + tuple(plan.periodic[1:]),
        bloch_phase=(1.0,) + tuple(plan.bloch_phase[1:]),
        support_boxes=boxes, mask_planes=ext_masks)
    return ext_plan, Gl, Gr, N, ph


def _ext_of(plan):
    """ghost_ring_ext(plan), made once per plan."""
    if "_ghost_ring_ext" not in plan.__dict__:
        plan._ghost_ring_ext = ghost_ring_ext(plan)
    return plan._ghost_ring_ext


def periodic_ghost_supported(plan, depth: int = 2) -> bool:
    """The ghost ring's envelope: `ghost_ring_ext` and K2 at `depth` on the
    extended plan (periodicx.py:772-783)."""
    p = _ext_of(plan)
    return p is not None and fdtd3d_t2.supported(p[0], depth)


class PeriodicGhostT2Kernel:
    """K2 at `depth` on the ghost ring's extended plan, for one x-periodic
    plan (periodicx.py:786-927).  `step` takes and returns the extended
    layout (`from_full` / `to_full` convert), re-seeding the ghost zones
    from the interior times ph before each K2 call; `run` takes the
    plan's own state.  Like the reference's it has no `_k1`: the hybrid
    driver's cycle and probed routes would step the extended plan's K1
    without the refresh (its envelope has no DFT monitors, and
    `fused_probed_run` then leaves probed stretches to the stepper)."""

    def __init__(self, plan, depth: int = 2):
        if not periodic_ghost_supported(plan, depth):
            raise ValueError("plan outside the ghost-ring envelope")
        self.plan = plan
        self.ext_plan, self.Gl, self.Gr, self.N, self.ph = _ext_of(plan)
        self.depth = depth
        self.k3 = None
        self.ker = fdtd3d_t2.Fdtd3dT2Kernel(self.ext_plan, depth=depth)

    def from_full(self, full):
        """The plan's state in the extended layout: each x-leading array
        wrapped, its ghost zones the period's ends times ph."""
        Gl, Gr, N, ph = self.Gl, self.Gr, self.N, self.ph
        S0 = tuple(self.plan.storage_shape or self.plan.gv.shape)[0]

        def ext(t):
            if t.ndim == 3 and t.shape[0] == S0:
                live = t[:N]
                return torch.cat([ph * live[N - Gl:], live, ph * live[:Gr]],
                                 0).contiguous()
            return t

        return {**full,
                **{k: {c: ext(t) for c, t in full[k].items()}
                   for k in ("f", "f_u", "f_w")},
                "pol": [{k: {c: ext(t) for c, t in e[k].items()}
                         for k in ("p", "pp")} for e in full["pol"]]}

    def to_full(self, state):
        """The interior planes in the plan's layout, the dead planes from N
        on zero (the stepper keeps them so)."""
        Gl, N = self.Gl, self.N
        S0 = tuple(self.plan.storage_shape or self.plan.gv.shape)[0]

        def cut(t):
            out = torch.zeros((S0,) + tuple(t.shape[1:]), dtype=t.dtype,
                              device=t.device)
            out[:N] = t[Gl:Gl + N]
            return out

        return {**state,
                **{k: {c: cut(t) for c, t in state[k].items()}
                   for k in ("f", "f_u", "f_w")},
                "pol": [{k: {c: cut(t) for c, t in e[k].items()}
                         for k in ("p", "pp")} for e in state["pol"]]}

    def _refresh(self, state):
        """Re-seed the ghost zones in place: left = ph * planes [N, N + Gl)
        (the period's last Gl), right = ph * planes [Gl, Gl + Gr) (its
        first Gr), in every state array."""
        Gl, Gr, N, ph = self.Gl, self.Gr, self.N, self.ph
        arrays = [t for k in ("f", "f_u", "f_w") for t in state[k].values()]
        arrays += [t for e in state["pol"] for k in ("p", "pp")
                   for t in e[k].values()]
        done = set()
        for t in arrays:
            if t.data_ptr() in done:
                continue
            done.add(t.data_ptr())
            torch.mul(t[N:N + Gl], ph, out=t[:Gl])
            torch.mul(t[Gl:Gl + Gr], ph, out=t[Gl + N:])
        return state

    def step(self, state, rows):
        """`depth` steps on the extended layout: the refresh, one K2 call
        (out of place on the card: use only the returned state)."""
        self.ext_plan.slab_opt = self.plan.slab_opt
        return self.ker.step(self._refresh(state), rows)

    def run(self, state, nsteps: int, t0: int = 0):
        """The plan's state advanced by nsteps: nsteps // depth refreshed
        K2 calls, the residue as refreshed steps of the extended plan's
        K1 (periodicx.py:897-927)."""
        self.ext_plan.slab_opt = self.plan.slab_opt
        rows = xs_rows(self.ext_plan, build_xs(self.ext_plan, nsteps, t0))
        st = self.from_full(state)
        ncall = nsteps // self.depth
        for c in range(ncall):
            st = self.step(st, rows[c * self.depth:(c + 1) * self.depth])
        k1 = self.ker._k1
        for i in range(ncall * self.depth, nsteps):
            st = k1.step(self._refresh(st), rows[i] if rows else {})
        return {**self.to_full(st), "dft": state["dft"],
                "t": state["t"] + nsteps}
