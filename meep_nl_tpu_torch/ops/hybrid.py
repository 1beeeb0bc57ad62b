"""Hybrid production run path: every step through the K1 kernel, the DTFT
accumulated from the full state on each sample step.

The port of ``meep_nl_tpu/ops/pallas/hybrid.py`` on its one-step route (the
`_K1Adapter` route, hybrid.py:140-171, that the JAX package takes whenever
its temporally fused K2 declines a plan): `build_xs` zeroes every monitor's
phase rows on non-sample steps (the automatic Nyquist decimation,
dft.cpp:195-216), so the run splits into uniform cycles of `d` steps; all d
advance through K1 and the cycle's last step samples the DTFT.  K1 keeps
the eager state layout, so sampling reads the state directly.  Nonlinear
media disable decimation, so monitored nonlinear runs sample every step
(d = 1).

Unlike the JAX package this driver does not catch build or launch errors:
on CUDA a failure raises.  The eager route is taken only for plans that
`fdtd3d.supported` declines (or stretches too short to fuse).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from . import fdtd3d
from ..stepper.step import _dft_update, build_xs, run as eager_run, xs_rows


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
    the sampling isn't uniformly spaced or there is no full cycle."""
    active = _sample_steps(plan, t0, nsteps)
    idx = np.nonzero(active)[0]
    if len(idx) == 0:
        return None
    gaps = np.diff(idx)
    if len(gaps) and len(set(gaps.tolist())) != 1:
        return None
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


def hybrid_applicable(plan) -> bool:
    return fdtd3d.supported(plan)


def _get_kernel(plan) -> fdtd3d.Fdtd3dKernel:
    ker = plan.__dict__.get("_k1_kernel")
    if ker is None:
        ker = plan._k1_kernel = fdtd3d.Fdtd3dKernel(plan)
    return ker


def hybrid_run(plan, state: Dict[str, Any], nsteps: int, t0: int
               ) -> Optional[Dict[str, Any]]:
    """Advance the full state by nsteps through K1, or None when the plan
    is outside the kernel envelope / the stretch has no uniform cycle
    (the caller then runs the eager stepper).  The counterpart of the JAX
    package's hybrid_run and _hybrid_run_inner (hybrid.py:459, :497)."""
    if not hybrid_applicable(plan) or nsteps < 4:
        return None
    # K1 keeps slab semantics for the PML auxiliaries (f_u, and f_w without
    # polarizations, stay zero outside their slabs); the eager steps of the
    # cycle take the same slab-local path (exact: test_slab_opt in the JAX
    # package)
    plan.slab_opt = True
    ker = _get_kernel(plan)
    C = plan.coefs
    if not np.any(_sample_steps(plan, t0, nsteps)):
        return ker.run(state, nsteps, t0=t0)
    cs = cycle_structure(plan, t0, nsteps)
    if cs is None:
        return None
    prefix, d, ncyc, suffix = cs
    t = t0
    if prefix:
        state = eager_run(plan, state, prefix, t0=t)
        t += prefix
    rows = xs_rows(plan, build_xs(plan, ncyc * d, t))
    for cyc in range(ncyc):
        for s in range(d):
            state = ker.step(state, rows[cyc * d + s])
        # the cycle's last step is the sample step: E at (t+1)dt, H at
        # (t+1/2)dt, exactly what the eager in-step _dft_update sees
        state = _dft_update(plan, C, state, rows[cyc * d + d - 1])
    t += ncyc * d
    if suffix:
        state = eager_run(plan, state, suffix, t0=t)
    return state
