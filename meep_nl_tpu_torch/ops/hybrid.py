"""Hybrid production run path: every step through the fused kernels, the
DTFT accumulated from x-planes on each sample step.

The port of ``meep_nl_tpu/ops/pallas/hybrid.py``: `build_xs` zeroes every
monitor's phase rows on non-sample steps (the automatic Nyquist decimation,
dft.cpp:195-216), so a run splits into uniform cycles of `d` steps whose
last step samples.  The routes, as the reference takes them:

  * no sample step in the stretch: the deepest kernel (K2 at depth 3 where
    the plan admits it, else depth 2) over nsteps // depth calls, the
    remainder through K1 ("no_sample" in `hybrid_routes`);
  * d > 1: each cycle is cut into 3-, 2- and 1-step kernel calls
    (`decompose`), then the DTFT reads the monitors' x-planes ("planes"),
    or the full state ("full_state") where `_dft_plane_meta` declines the
    monitors (D/B components, planes across most of x); d == 1 without
    the capture route is this route with one K1 step per cycle;
  * d == 1 (nonlinear media disable decimation, so every step samples): the
    capture route, supercycles of `depth` steps through K2's capture
    variant, the monitor planes of the intermediate steps written by the
    kernel itself, and a tail of K1 steps ("capture");
  * a plan that K2 declines but K1 takes: the same driver with K1 behind a
    two-step adapter;
  * a stretch that records probe series (`fused_probed_run`): K1 once per
    step, the probes gathered on the device after every step.

The kernels keep the eager state layout, so a monitor's x-plane is the slice
state["f"][c][x:x+1] (where the reference assembles fused_mesh.e_eff_plane
from its compact state).  Only the kernel objects are cached on the plan;
there is no compiled runner to cache.

Unlike the JAX package this driver does not catch build or launch errors:
on CUDA a failure raises.  The eager route is taken only for plans that
both kernels decline (or stretches too short to fuse).  Mirror folds route
as in the reference (hybrid.py:71): y/z node mirrors run every route above
(K1 and K2 read the fold ghost), a 3D plan with an x mirror is declined by
both kernels and runs on the eager stepper.  A plan Bloch-periodic along x
with a real phase takes the periodic drivers of ops/periodicx.py in the
reference's order (hybrid.py:79-113): the ghost ring (K2 on an extended
aperiodic plan, with its depth-3 companion) where it applies, then
PeriodicXT2Kernel (K2's x-wrap variant at depth 2: a monitored linear
plan runs d // 2 of its calls and d % 2 K1 steps a cycle of d steps),
else K1's x wrap behind the two-step adapter; a plan periodic along y or
z runs on the eager stepper, as in the reference.  Complex fields (real-pair storage,
an arbitrary x phase) take the pair drivers first, in the reference's
order (hybrid.py:93-104): the pair ghost ring with its depth-3 companion,
then K1's pair wrap; their monitored stretches read the DTFT from the
full state (`_dft_plane_meta` and `fused_probed_run` decline complex
plans, as the reference's do).
"""

from __future__ import annotations

import collections
import hashlib
import types
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import fdtd3d, fdtd3d_t2, periodicx
from ..core import grid as G
from ..core.device import torch_dtype
from ..stepper.step import (_dft_update, _region_values, build_xs,
                            run as eager_run, xs_rows)


def _sample_steps(plan, t0: int, nsteps: int) -> np.ndarray:
    """Steps whose xs rows carry a nonzero DFT phase: build_xs's decimation
    rule ((step+1) % decimation == 0) in closed form."""
    steps = t0 + np.arange(nsteps)
    active = np.zeros(nsteps, bool)
    for m in plan.dfts:
        active |= ((steps + 1) % max(int(m.decimation), 1)) == 0
    return active


def cycle_structure(plan, t0: int, nsteps: int):
    """Split a monitored stretch into (prefix, d, ncyc, suffix) uniform
    decimation cycles whose last step is the DFT sample step, or None when
    there is no sample step or no full cycle.  Where monitors of different
    decimations make the sampling non-uniform, every step is a cycle of one
    (d = 1): the DTFT update after each step adds zero for the monitors
    that do not sample there, as the eager stepper's does (the reference
    sends such stretches to the eager stepper)."""
    active = _sample_steps(plan, t0, nsteps)
    idx = np.nonzero(active)[0]
    if len(idx) == 0:
        return None
    gaps = np.diff(idx)
    if len(gaps) and len(set(gaps.tolist())) != 1:
        return 0, 1, nsteps, 0
    d = int(gaps[0]) if len(gaps) else nsteps - int(idx[0])
    if d < 1:
        return None
    a0 = int(idx[0])
    prefix = a0 + 1 - d if a0 + 1 >= d else a0 + 1
    ncyc = (nsteps - prefix) // d
    suffix = nsteps - prefix - ncyc * d
    if ncyc < 1:
        return None
    return prefix, d, ncyc, suffix


def hybrid_routes(plan) -> collections.Counter:
    """Stretches of this plan by the hybrid driver's route ("no_sample",
    "capture", "planes", "full_state")."""
    return plan.__dict__.setdefault("_hybrid_routes", collections.Counter())


def hybrid_applicable(plan) -> bool:
    """Whether a kernel of this driver covers the plan (hybrid.py:174-191):
    for an x-periodic plan K1's x-wrap envelope, its pair wrap's for
    complex fields (hybrid.py:186-190)."""
    if any(plan.periodic):
        if plan.complex_fields:
            return periodicx.pair_periodic_supported(plan)
        return periodicx.periodic_supported(plan)
    return fdtd3d_t2.supported(plan) or fdtd3d.supported(plan)


class _K1Adapter:
    """K1 behind the two-step interface the cycle driver expects (a 'pair'
    is two sequential one-step calls); hybrid.py:146-171."""

    depth = 2
    k3 = None

    def __init__(self, k1):
        self._k1 = k1

    def step(self, state, rows):
        for row in rows:
            state = self._k1.step(state, row)
        return state

    def run(self, state, nsteps, t0=0):
        return self._k1.run(state, nsteps, t0=t0)


def _get_kernel(plan):
    """The deepest fused kernel covering this plan: K2 at depth 2 with a
    depth-3 companion `k3` where the plan admits it, else K1 behind the
    two-step adapter (hybrid.py:119-141); for an x-periodic plan the ghost
    ring at depth 2 with its depth-3 companion, then PeriodicXT2Kernel
    (K2's x wrap at depth 2), else K1's x wrap behind the adapter
    (hybrid.py:79-113), for complex fields the ring with two channels or
    K1's pair wrap.  Cached on the plan."""
    ker = plan.__dict__.get("_t2_kernel")
    if ker is None:
        if any(plan.periodic):
            if periodicx.periodic_ghost_supported(plan, depth=2):
                ker = periodicx.PeriodicGhostT2Kernel(plan, depth=2)
                if periodicx.periodic_ghost_supported(plan, depth=3):
                    ker.k3 = periodicx.PeriodicGhostT2Kernel(plan, depth=3)
            elif periodicx.periodic_t2_supported(plan):
                ker = periodicx.PeriodicXT2Kernel(plan)
            else:
                ker = _K1Adapter(fdtd3d_t2.k1_of(plan))
        elif fdtd3d_t2.supported(plan, depth=2):
            ker = fdtd3d_t2.Fdtd3dT2Kernel(plan, depth=2)
            if fdtd3d_t2.supported(plan, depth=3):
                ker.k3 = fdtd3d_t2.Fdtd3dT2Kernel(plan, depth=3)
        else:
            ker = _K1Adapter(fdtd3d_t2.k1_of(plan))
        plan._t2_kernel = ker
    return ker


def _capture_kernel(plan, depth: int, cap_planes):
    """The capture kernel of (depth, cap_planes), cached on the plan by
    both: another set of planes is another kernel."""
    cache = plan.__dict__.setdefault("_cap_kernels", {})
    key = (depth, tuple(cap_planes))
    if key not in cache:
        cache[key] = fdtd3d_t2.Fdtd3dT2Kernel(plan, depth=depth,
                                              cap_planes=cap_planes)
    return cache[key]


def decompose(d: int, has_k3: bool) -> Tuple[int, int, int]:
    """d = 3*n3 + 2*npair + rem: the d fused steps of a cycle as 3-, 2- and
    1-step kernel calls, the deepest first; rem only for odd d without a
    depth-3 kernel, or d == 1 (hybrid.py:566-580)."""
    if has_k3 and d >= 3:
        r3 = d % 3
        if r3 == 0:
            return d // 3, 0, 0
        if r3 == 2:
            return d // 3, 1, 0
        return (d - 4) // 3, 2, 0              # r3 == 1, d >= 4
    return 0, d // 2, d % 2


# ---------------------------------------------------------------------------
# the plane-sampled DTFT
# ---------------------------------------------------------------------------


def _dft_plane_meta(plan) -> Optional[List[tuple]]:
    """Per monitor (component, x0, x1e, avg_axes, yz_slices): the x-planes
    its DTFT reads, or None when a monitor falls outside the exact envelope
    (not an E/H component of the plan, x-centred averaging that touches
    the live edge, complex or periodic plans) or the planes are so many
    that the full state serves as well (hybrid.py:308-340)."""
    gv = plan.gv
    if gv.dim != "3d" or not plan.dfts:
        return None
    if any(plan.periodic) or plan.complex_fields or plan.real_pair:
        return None
    comps = {s.ec for s in plan.eh_specs_e + plan.eh_specs_h}
    S0 = tuple(plan.storage_shape or gv.shape)[0]
    meta, total = [], 0
    for m in plan.dfts:
        c = m.component
        if c not in comps or len(m.region) != 3:
            return None
        ys = G.yee_shift(c, gv.dim)
        avg = tuple(ax for ax, d2 in enumerate(gv.axes)
                    if ys[d2] == 0) if m.centered else ()
        x0, x1 = int(m.region[0][0]), int(m.region[0][1])
        x1e = x1 + (1 if 0 in avg else 0)
        if x1e > S0 or (0 in avg and x1 >= gv.num[0]):
            return None
        meta.append((c, x0, x1e, avg,
                     (slice(*m.region[1]), slice(*m.region[2]))))
        total += x1e - x0
    if total > max(8, S0 // 3):
        return None
    return meta


def _fv_from_planes(plan, planes, meta_mi):
    """Region-sliced, centred-averaged monitor values from the monitor's
    x-planes x0..x1e-1 (hybrid.py:343-354).  The planes are read as a short
    array whose x origin is x0, through the eager stepper's own region read
    (it slices the region and its one-plane halo first, then averages), so
    the values equal the eager `_dft_update`'s bit for bit."""
    c, x0, x1e, avg, sl_yz = meta_mi
    sub = planes[0] if len(planes) == 1 else torch.cat(planes, 0)
    nx = x1e - x0 - (1 if 0 in avg else 0)
    window = types.SimpleNamespace(
        component=c, centered=bool(avg),
        region=((0, nx),) + tuple((sl.start, sl.stop) for sl in sl_yz))
    return _region_values(plan, window, sub)


def _fv_planes(plan, state, meta_mi):
    """The same values read from the state: in the eager layout a monitor's
    x-plane is a slice of the component (hybrid.py:357-366)."""
    c, x0, x1e, avg, sl_yz = meta_mi
    return _fv_from_planes(plan, [state["f"][c][x0:x1e]], meta_mi)


def _capture_run(plan, deep, k1, plane_meta, state, rows, ncyc):
    """A d == 1 monitored stretch through the capture kernel: supercycles
    of `deep.depth` steps per call, the monitor planes of every stage but
    the last step's E written by the kernel, the last step's E planes read
    from the advanced state; the tail through K1 (hybrid.py:369-456)."""
    C = plan.coefs
    dd = deep.depth
    nsuper = ncyc // dd
    cap_planes = sorted({(m[0], x) for m in plane_meta
                         for x in range(m[1], m[2])})
    capker = _capture_kernel(plan, dd, cap_planes)
    dft = state["dft"]
    for sc in range(nsuper):
        xc = rows[sc * dd:(sc + 1) * dd]
        state, caps = capker.capture_step(state, xc)
        for u in range(1, dd + 1):

            def fv_of(mi, m, u=u):
                c, x0, x1e, avg, sl_yz = plane_meta[mi]
                if c[0] == "h" or u < dd:
                    planes = [caps[fdtd3d_t2.cap_key(u, c, x)]
                              for x in range(x0, x1e)]
                    return _fv_from_planes(plan, planes, plane_meta[mi])
                return _fv_planes(plan, state, plane_meta[mi])

            dft = _dft_update(plan, C, {"dft": dft}, xc[u - 1],
                              fv_of=fv_of)["dft"]
    for i in range(nsuper * dd, ncyc):
        state = k1.step(state, rows[i])
        dft = _dft_update(
            plan, C, {"dft": dft}, rows[i],
            fv_of=lambda mi, m: _fv_planes(plan, state,
                                           plane_meta[mi]))["dft"]
    return {**state, "dft": dft}


def _probe_gathers(plan, probes):
    """Per probe (name, component, flat storage offsets, weights) as device
    tensors, uploaded once and cached on the plan by the probes' (name,
    component, indices, weights) (hybrid.py:261-271); None when a probe has
    complex weights with a nonzero imaginary part."""
    cache = plan.__dict__.setdefault("_fused_probe_cache", {})
    key = tuple((p.name, p.component, hashlib.sha1(
        np.ascontiguousarray(p.indices).tobytes()
        + np.ascontiguousarray(p.weights).tobytes()).hexdigest())
        for p in probes)
    if key not in cache:
        shape = tuple(plan.storage_shape or plan.gv.shape)
        dtype = torch_dtype(plan.dtype)
        out = []
        for p in probes:
            w = np.asarray(p.weights)
            if np.iscomplexobj(w):
                if np.abs(w.imag).max() > 0:
                    return None
                w = w.real
            idx = np.asarray(p.indices, np.int64).reshape(-1, len(shape))
            off = np.ravel_multi_index(tuple(idx.T), shape)
            out.append((p.name, p.component,
                        torch.as_tensor(off, device=plan.device),
                        torch.as_tensor(w, dtype=dtype, device=plan.device)))
        cache[key] = out
    return cache[key]


def fused_probed_run(plan, state: Dict[str, Any], nsteps: int, t0: int,
                     probes) -> Optional[tuple]:
    """Probe-emitting fused run (hybrid.py:194-305): K1 once per step, each
    probe's weighted point sample gathered on the device after every step,
    so Harminv / FieldProbe / decay-stop stretches of plans the resident
    route declines leave the eager stepper.  Returns (state, {name:
    (nsteps,) series}), or None for plans with DFT monitors, complex
    fields, conductivity (ROADMAP A6), plans outside the kernels' envelope,
    a probe component outside the state, or complex probe weights.

    An x-periodic plan whose kernel is the ghost ring has no K1 here
    (periodicx), so its probed stretches run on the stepper, as the
    reference's.

    In the full-state layout E is stored, so a probe reads state["f"][c]
    directly (no e_eff_plane).  The products of every step go into one
    preallocated (nsteps, npts) device tensor, with no host sync in the
    stretch; each series is then summed point by point from 0.0 in the
    state's type, in `step.run`'s order, so it equals the eager stepper's
    bit for bit.  K1 keeps the plan's chain semantics (slab-local once the
    hybrid route has stepped the plan, full-grid before).  Not carried
    over: the jax.jit runner cache and the `_hybrid_broken` fallback (a
    failure raises)."""
    if plan.dfts or plan.complex_fields:
        return None
    if any(s.has_cond for s in plan.curl_specs_d + plan.curl_specs_b):
        return None
    if not hybrid_applicable(plan):
        return None
    k1 = getattr(_get_kernel(plan), "_k1", None)
    if k1 is None:
        return None
    if any(p.component not in state["f"] for p in probes):
        return None
    gathers = _probe_gathers(plan, probes)
    if gathers is None:
        return None
    dtype = torch_dtype(plan.dtype)
    prods = [torch.empty((nsteps, len(off)), dtype=dtype, device=plan.device)
             for (_, _, off, _) in gathers]
    rows = xs_rows(plan, build_xs(plan, nsteps, t0))
    for i in range(nsteps):
        state = k1.step(state, rows[i] if rows else {})
        for (_, comp, off, w), pr in zip(gathers, prods):
            torch.mul(state["f"][comp].reshape(-1)[off], w, out=pr[i])
    series = {}
    for (name, _, _, _), pr in zip(gathers, prods):
        acc = torch.zeros(nsteps, dtype=dtype, device=plan.device)
        for q in range(pr.shape[1]):
            acc = acc + pr[:, q]
        series[name] = acc
    return state, series


def hybrid_run(plan, state: Dict[str, Any], nsteps: int, t0: int
               ) -> Optional[Dict[str, Any]]:
    """Advance the full state by nsteps through the fused kernels, or None
    when the plan is outside both kernel envelopes / the stretch is
    shorter than 4 steps or has no full decimation cycle (the caller then
    runs the eager stepper).  The
    counterpart of the JAX package's hybrid_run and _hybrid_run_inner
    (hybrid.py:459, :497)."""
    if not hybrid_applicable(plan) or nsteps < 4:
        return None
    # the kernels keep slab semantics for the PML auxiliaries (f_u, and f_w
    # without polarizations, stay zero outside their slabs); the eager
    # steps of the prefix and suffix take the same slab-local path (exact:
    # test_slab_opt in the JAX package)
    plan.slab_opt = True
    ker = _get_kernel(plan)
    # the ghost ring has no K1 (its kernels step against the extended
    # plan's coefficients, hybrid.py:513); its envelope has no monitors,
    # so it takes only the no-sample route
    k1 = getattr(ker, "_k1", None)
    deep = ker.k3 if ker.k3 is not None else ker
    C = plan.coefs
    if not np.any(_sample_steps(plan, t0, nsteps)):
        hybrid_routes(plan)["no_sample"] += 1
        return deep.run(state, nsteps, t0=t0)
    cs = cycle_structure(plan, t0, nsteps)
    if cs is None:
        return None
    prefix, d, ncyc, suffix = cs
    n3, npair, rem = decompose(d, ker.k3 is not None)
    t = t0
    if prefix:
        state = eager_run(plan, state, prefix, t0=t)
        t += prefix
    rows = xs_rows(plan, build_xs(plan, ncyc * d, t))
    plane_meta = _dft_plane_meta(plan)

    # d == 1 supercycles: the monitor planes captured in the kernel
    # (hybrid.py:601-624)
    if (d == 1 and plane_meta is not None
            and isinstance(ker, fdtd3d_t2.Fdtd3dT2Kernel)
            and ncyc >= deep.depth):
        hybrid_routes(plan)["capture"] += 1
        state = _capture_run(plan, deep, k1, plane_meta, state, rows, ncyc)
    else:
        hybrid_routes(plan)["planes" if plane_meta is not None
                            else "full_state"] += 1
        for cyc in range(ncyc):
            xc = rows[cyc * d:(cyc + 1) * d]
            o = 0
            for _ in range(n3):
                state = ker.k3.step(state, xc[o:o + 3])
                o += 3
            for _ in range(npair):
                state = ker.step(state, xc[o:o + 2])
                o += 2
            if rem:
                state = k1.step(state, xc[d - 1])
            # the cycle's last step is the sample step: E at (t+1)dt, H at
            # (t+1/2)dt, exactly what the eager in-step _dft_update sees
            if plane_meta is not None:
                state = {**state, **_dft_update(
                    plan, C, {"dft": state["dft"]}, xc[d - 1],
                    fv_of=lambda mi, m: _fv_planes(plan, state,
                                                   plane_meta[mi]))}
            else:
                state = _dft_update(plan, C, state, xc[d - 1])
    t += ncyc * d
    if suffix:
        state = eager_run(plan, state, suffix, t0=t)
    return state
