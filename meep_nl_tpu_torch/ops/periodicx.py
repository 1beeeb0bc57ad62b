"""The hybrid route's drivers for 3D cells Bloch-periodic along x: with a
real phase ph = +-1 (k_x = 0 or the zone edge), and with any phase on
complex fields in real-pair storage.

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
  * `PeriodicXT2Kernel` (:540-655), for linear plans the ghost ring
    declines (those with DFT monitors: the usual periodic 3D run, a
    grating or metasurface with a flux plane) within
    `periodic_t2_supported` (:507-537): K2 at depth 2 in its x-wrap
    variant (W in csrc/fdtd3d_t2.cu), a chunk at the wrap reading its
    halo across it, the odd step through K1's x wrap;
  * K1's x-wrap variant (`PeriodicXKernel`, :109-228) behind the two-step
    adapter, for everything else in its envelope (`periodic_supported`,
    :82-106): the B launch reads plane num as ph E(0), the D launch plane
    -1 as (1 / ph) H(num - 1) (WRAP in csrc/fdtd3d.cu).

Not copied: the reference's ghost-plane refresh and wrap carry of the
x-wrap drivers (`fused_mesh.carry_plane`, `boundary_statics`, `strip.py`,
`wrap2_carries` :447-505): K1 runs B, D and E as separate launches, so
the D launch reads the H(num - 1) the B launch has written; K2's items
recompute their halo planes across the wrap from the input state (the
halo-in-time pattern, done on chip), so no carry comes from the host; and
the dead planes from num on are stepped as the stepper steps them (there
is no ghost residue to kill: `to_full` is the identity, as K1's).

Complex phases ride the real pair (the reference's :225-420, :929-1127):
every coefficient is real, so the (re, im) channels step as two real
problems of the single-channel view (`fdtd3d.real_view`), and the phase
mixes them only across the wrap:

  * the ghost ring with two channels (`PeriodicGhostT2Kernel` on a pair
    plan), for plans without DFT monitors: two single-channel states on
    the ghost ring's extended plan, whose source
    images carry the complex phase (`ghost_ring_ext(img_ph=ph)`); before
    each K2 call the ghost zones are re-seeded as 2x2 rotations of the
    interior's channels (left: conj(ph) F, right: ph F), and channel 1's
    calls read the waveform rows swapped, (w_re, w_im) -> (w_im, -w_re),
    which gives Im(w amp);
  * `PairPeriodicXKernel`, for everything else in K1's x-wrap envelope:
    K1's PAIR launches step both channels and rotate the wrapped planes
    (csrc/fdtd3d.cu).  As for the real wrap, the reference's ghost refresh
    and carry recompute are not needed.

The pair ring agrees with the eager pair stepper to fp32 round-off, not
bit for bit: its ghosts are stepped as interior planes from their
rotated seeds, where the stepper rotates at every read (the rotation
does not commute with rounding; at ph = +-1 it is exact).
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


def _has_disp(plan) -> bool:
    """Dispersive or nonlinear media (the reference's fdtd3d._has_disp)."""
    return bool(plan.pol_specs_e or plan.pol_specs_h
                or any(s.has_chi3 or s.has_nr
                       for s in plan.eh_specs_e + plan.eh_specs_h))


def periodic_t2_supported(plan) -> bool:
    """The envelope of `PeriodicXT2Kernel` (the reference's
    periodic_t2_supported, periodicx.py:507-537): K1's x-wrap envelope
    (3D, periodic along x only with a real phase, no node mirror), linear
    (no pole, no chi2/chi3), no mu != 1 on the H family (has_u), every
    source entry at least 2 planes clear of both wrap planes (a halo plane
    across the wrap is an image of the state, which carries no source),
    and K2's envelope with the x wrap (`fdtd3d_t2.supported(plan, 2,
    allow_periodic_x=True)`, which asks for at least 6 live x-planes).  Dropped, as
    they describe the TPU kernel's blocking: `lo_blocks`, `hi_block0`, at
    least two x-blocks and `_pick_bx`; K2's items cut the live planes and
    the dead ones apart whatever the chunk length."""
    if not periodic_supported(plan) or _has_disp(plan):
        return False
    if any(s.has_u for s in plan.eh_specs_h):
        return False
    num0 = plan.gv.num[0]
    for s in plan.sources:
        idx = np.asarray(s.indices)
        if np.any((idx[:, 0] < 2) | (idx[:, 0] > num0 - 3)):
            return False
    return fdtd3d_t2.supported(plan, 2, allow_periodic_x=True)


class PeriodicXT2Kernel(fdtd3d_t2.Fdtd3dT2Kernel):
    """Two steps a call across an x-Bloch wrap with a real phase
    (periodicx.py:540-655): K2 at depth 2 in its x-wrap variant, the live
    planes [0, num) and the dead ones in items of their own, an item at
    the wrap recomputing its halo planes as images of the far end times
    the phase.  `run` takes the residue of an odd count through K1's x
    wrap (`_k1`, the reference's `_k1` too); `k3` is None (no depth-3
    companion, as the reference's).  Its plain version is `steps_ref`:
    two eager steps, which wrap through step._sh."""

    def __init__(self, plan, ch=None):
        if not periodic_t2_supported(plan):
            raise ValueError("plan outside the periodic t2 envelope")
        super().__init__(plan, depth=2, ch=ch, allow_periodic_x=True)


class PeriodicXKernel(fdtd3d.Fdtd3dKernel):
    """K1 on an x-periodic plan: the same three launches a step, the B and
    D launches in their WRAP variant.  Its plain version is `step_ref`,
    whose eager shifts wrap with the phase (step._sh)."""

    def __init__(self, plan, ch=None):
        if not periodic_supported(plan):
            raise ValueError("plan outside the periodic-x kernel envelope")
        super().__init__(plan, ch=ch, allow_periodic_x=True)


def _unit_x_phase(plan) -> bool:
    """A real-pair 3D plan periodic along x with a phase on the unit
    circle (an arbitrary k_x)."""
    return bool(plan.real_pair and plan.complex_fields) \
        and plan.gv.dim == "3d" and bool(plan.periodic[0]) \
        and abs(abs(complex(plan.bloch_phase[0])) - 1.0) <= 1e-9


def pair_periodic_supported(plan) -> bool:
    """K1's pair wrap envelope (periodicx.py:243-256): a real-pair plan
    whose only complex coupling is the x Bloch phase, and whose
    single-channel view K1's x wrap takes."""
    return _unit_x_phase(plan) \
        and periodic_supported(fdtd3d.real_view(plan))


class PairPeriodicXKernel(fdtd3d.Fdtd3dKernel):
    """K1 on a real-pair x-periodic plan with any phase (periodicx.py:
    257-420): three launches a step, each stepping both channels, the B
    and D launches rotating the wrapped plane's channels by ph (B) and
    1 / ph (D); channel 1's sources read the waveform rows swapped.  Its
    plain version is the eager pair step."""

    def __init__(self, plan, ch=None):
        if not pair_periodic_supported(plan):
            raise ValueError("plan outside the pair-periodic envelope")
        super().__init__(plan, ch=ch, allow_periodic_x=True, pair=True)


# ---------------------------------------------------------------------------
# the ghost ring
# ---------------------------------------------------------------------------


def ghost_ring_ext(plan, margin: int = MARGIN, img_ph=None
                   ) -> Optional[tuple]:
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
    window within WINDOW_CLEAR planes of x = 0 or x = N (C.3 item 4).
    `img_ph` (a real pair's complex phase, on its single-channel view)
    replaces the plan's phase in the source images."""
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
        iph = ph if img_ph is None else img_ph
        left = idx[:, 0] >= N - Gl
        im = idx[left].copy()
        im[:, 0] += Gl - N
        rows.append(im)
        arows.append(amps[left] * np.conj(iph))
        right = idx[:, 0] < Gr
        im = idx[right].copy()
        im[:, 0] += Gl + N
        rows.append(im)
        arows.append(amps[right] * iph)
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
    """ghost_ring_ext(plan), made once per plan; of a real pair with a
    complex x phase, of its single-channel view with the phase in the
    source images."""
    if "_ghost_ring_ext" not in plan.__dict__:
        plan._ghost_ring_ext = ghost_ring_ext(
            fdtd3d.real_view(plan), img_ph=complex(plan.bloch_phase[0])) \
            if _unit_x_phase(plan) else ghost_ring_ext(plan)
    return plan._ghost_ring_ext


def periodic_ghost_supported(plan, depth: int = 2) -> bool:
    """The ghost ring's envelope: `ghost_ring_ext` and K2 at `depth` on the
    extended plan (periodicx.py:772-783, for a pair :929-940)."""
    p = _ext_of(plan)
    return p is not None and fdtd3d_t2.supported(p[0], depth)


class PeriodicGhostT2Kernel:
    """K2 at `depth` on the ghost ring's extended plan, for one x-periodic
    plan (periodicx.py:786-927; for a real pair :943-1127).  The state is
    a list of channel states in the extended layout: one for a real
    phase, two single-channel states (re, im) for a pair, each with a K2
    kernel object of its own (on a copy of the extended plan, so each
    keeps its own second state set).  `step` takes and returns that list
    (`from_full` / `to_full` convert), re-seeding the ghost zones before
    each K2 call as the interior times ph, which rotates a pair's
    channels; channel 1 reads the waveform rows swapped.  `run` takes the
    plan's own state.  Like the reference's it has no `_k1`: the hybrid
    driver's cycle and probed routes would step the extended plan's K1
    without the refresh (its envelope has no DFT monitors, and
    `fused_probed_run` then leaves probed stretches to the stepper)."""

    def __init__(self, plan, depth: int = 2):
        if not periodic_ghost_supported(plan, depth):
            raise ValueError("plan outside the ghost-ring envelope")
        self.plan = plan
        self.pair = _unit_x_phase(plan)
        ext, self.Gl, self.Gr, self.N, _ = _ext_of(plan)
        self.ext_plans = (ext, dataclasses.replace(ext)) if self.pair \
            else (ext,)
        self.depth = depth
        self.k3 = None
        self.kers = [fdtd3d_t2.Fdtd3dT2Kernel(p, depth=depth)
                     for p in self.ext_plans]
        ph = complex(plan.bloch_phase[0])
        self._a, self._b = float(ph.real), float(ph.imag)

    @property
    def ext_plan(self):
        return self.ext_plans[0]

    @property
    def ker(self):
        return self.kers[0]

    @staticmethod
    def _arrays(st):
        return [t for k in ("f", "f_u", "f_w") for t in st[k].values()] + \
            [t for e in st["pol"] for k in ("p", "pp") for t in e[k].values()]

    @staticmethod
    def _map(st, fn):
        return {**st, **{k: {c: fn(t) for c, t in st[k].items()}
                         for k in ("f", "f_u", "f_w")},
                "pol": [{k: {c: fn(t) for c, t in e[k].items()}
                         for k in ("p", "pp")} for e in st["pol"]]}

    def _rot(self, parts, inv):
        """The channels `parts` times ph (inv: times conj(ph) = 1 / ph)."""
        a, b = self._a, (-self._b if inv else self._b)
        if len(parts) == 1:
            return [a * parts[0]]
        re, im = parts
        return [a * re - b * im, b * re + a * im]

    def from_full(self, full):
        """The plan's state as the channels' extended states, the ghost
        zones the ends of the period times ph (left: its last Gl planes
        times conj(ph), right: its first Gr times ph)."""
        Gl, Gr, N = self.Gl, self.Gr, self.N

        def ext(t):
            live = [c[:N] for c in (t if self.pair else (t,))]
            left = self._rot([c[N - Gl:] for c in live], True)
            right = self._rot([c[:Gr] for c in live], False)
            return [torch.cat(p, 0).contiguous()
                    for p in zip(left, live, right)]

        flat = {}
        for t in self._arrays(full):
            flat[t.data_ptr()] = ext(t)
        return [self._map(full, lambda t, c=c: flat[t.data_ptr()][c])
                for c in range(len(self.kers))]

    def to_full(self, states):
        """The channels' interior planes in the plan's layout (a pair's
        stacked on its channel axis), the dead planes from N on zero (the
        stepper keeps them so)."""
        Gl, N = self.Gl, self.N
        S0 = tuple(self.plan.storage_shape or self.plan.gv.shape)[0]
        flat = {}
        for ts in zip(*[self._arrays(s) for s in states]):
            t = ts[0]
            out = torch.zeros((len(ts), S0) + tuple(t.shape[1:]),
                              dtype=t.dtype, device=t.device)
            for o, c in zip(out, ts):
                o[:N] = c[Gl:Gl + N]
            flat[t.data_ptr()] = out if self.pair else out[0]
        return self._map(states[0], lambda t: flat[t.data_ptr()])

    def _refresh(self, states):
        """Re-seed every channel's ghost zones in place: left = conj(ph)
        times planes [N, N + Gl) (the period's last Gl), right = ph times
        planes [Gl, Gl + Gr) (its first Gr), in every state array."""
        Gl, Gr, N = self.Gl, self.Gr, self.N
        done = set()
        for ts in zip(*[self._arrays(s) for s in states]):
            if ts[0].data_ptr() in done:
                continue
            done.add(ts[0].data_ptr())
            if not self.pair:
                torch.mul(ts[0][N:N + Gl], self._a, out=ts[0][:Gl])
                torch.mul(ts[0][Gl:Gl + Gr], self._a, out=ts[0][Gl + N:])
                continue
            left = self._rot([c[N:N + Gl] for c in ts], True)
            right = self._rot([c[Gl:Gl + Gr] for c in ts], False)
            for c, lo, hi in zip(ts, left, right):
                c[:Gl], c[Gl + N:] = lo, hi
        return states

    @staticmethod
    def _rows_im(rows):
        """Channel 1's rows: every source's (w_re, w_im) -> (w_im, -w_re)."""
        out = []
        for r in rows:
            r = dict(r)
            for k in [k for k in r if k.endswith(":cur_re")]:
                ki = k[:-2] + "im"
                r[k], r[ki] = r[ki], -r[k]
            out.append(r)
        return out

    def step(self, states, rows):
        """`depth` steps of every channel: the refresh, one K2 call each
        (out of place on the card: use only the returned states)."""
        for p in self.ext_plans:
            p.slab_opt = self.plan.slab_opt
        states = self._refresh(states)
        return [k.step(s, r) for k, s, r in
                zip(self.kers, states, (rows, self._rows_im(rows)))]

    def run(self, state, nsteps: int, t0: int = 0):
        """The plan's state advanced by nsteps: nsteps // depth refreshed
        K2 calls, the residue as refreshed steps of the extended plan's
        K1 per channel (periodicx.py:897-927)."""
        for p in self.ext_plans:
            p.slab_opt = self.plan.slab_opt
        rows = xs_rows(self.ext_plan, build_xs(self.ext_plan, nsteps, t0))
        states = self.from_full(state)
        ncall = nsteps // self.depth
        for c in range(ncall):
            states = self.step(states,
                               rows[c * self.depth:(c + 1) * self.depth])
        for i in range(ncall * self.depth, nsteps):
            r = [rows[i] if rows else {}]
            states = [k._k1.step(s, rr[0]) for k, s, rr in
                      zip(self.kers, self._refresh(states),
                          (r, self._rows_im(r)))]
        return {**self.to_full(states), "dft": state["dft"],
                "t": state["t"] + nsteps}
