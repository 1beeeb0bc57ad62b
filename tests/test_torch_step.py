"""The port's eager stepper against the JAX package's jnp stepper
(meep_nl_tpu.stepper.step.run): one random state (numpy seed) goes into
both packages through meep_nl_tpu_torch.interop, and both advance N = 8
steps.

Tolerances, relative to the field maximum (the DTFT accumulators to their
own maximum): fp64 1e-12 (both run the same elementwise ops, rounding
differs only where XLA fuses); fp32 1e-5 (XLA may reassociate the curl sums
and the Newton solve's products)."""

import jax
import numpy as np
import pytest
import torch

from meep_nl_tpu.stepper import step as JS
from meep_nl_tpu_torch import interop
from meep_nl_tpu_torch.stepper import step as TS

from test_torch_plan import CASES, JAX, PORT, build_plan, random_state

torch.set_num_threads(2)

NSTEPS = 8
TOL = {np.float32: 1e-5, np.float64: 1e-12}


def jax_run(plan_kw, dtype, slab, st_np, nsteps):
    """Compile the JAX plan and run its jnp stepper from a numpy state;
    fp64 runs inside jax.enable_x64 (the flag is scoped, not global)."""
    with jax.enable_x64(dtype == np.float64):
        pj = build_plan(JAX, dtype=dtype, **plan_kw)
        pj.slab_opt = slab
        st = jax.tree_util.tree_map(jax.numpy.asarray, st_np)
        out = JS.run(pj, st, nsteps, t0=0)
        return jax.tree_util.tree_map(np.asarray, out)


def assert_states_close(got, want, tol, keys=("f", "f_u", "f_w", "dft")):
    scale = max(float(np.abs(v).max()) for v in want["f"].values())
    assert scale > 0
    for key in keys:
        for c, w in want[key].items():
            ref = scale if key != "dft" else max(float(np.abs(w).max()),
                                                 1e-30)
            err = float(np.abs(got[key][c] - w).max()) / ref
            assert err <= tol, f"{key}[{c}]: rel err {err:.3e} > {tol:.0e}"
    for pi, e in enumerate(want["pol"]):
        for k in ("p", "pp"):
            for c, w in e[k].items():
                err = float(np.abs(got["pol"][pi][k][c] - w).max()) / scale
                assert err <= tol, f"pol[{pi}][{k}][{c}]: {err:.3e}"
    assert int(got["t"]) == int(want["t"])


#: eager-only configurations (outside K1's envelope or beyond the main
#: path): an x-periodic cell (real Bloch wrap), chi3 with a Drude pole, and
#: an H-family Lorentz pole
EAGER_CASES = {**CASES,
               "periodic_x": dict(pml_axes="yz", periodic=(True, False, False)),
               "chi3_drude": dict(ball=True, pol=True, drude=True, nr=True,
                                  chi3=True, flux=True),
               "h_pole": dict(ball=True, hpol=True)}

STEP_PARAMS = ([(c, np.float32, False) for c in sorted(CASES)]
               + [(c, np.float64, False) for c in sorted(CASES)]
               + [("upml_subset", np.float32, True),
                  ("flagship", np.float32, True),
                  ("flagship", np.float64, True),
                  ("periodic_x", np.float32, False),
                  ("periodic_x", np.float64, True),
                  ("chi3_drude", np.float32, True),
                  ("h_pole", np.float32, False)])


@pytest.mark.parametrize("case,dtype,slab", STEP_PARAMS,
                         ids=[f"{c}-{d.__name__}-{'slab' if s else 'full'}"
                              for c, d, s in STEP_PARAMS])
def test_eager_matches_jax(case, dtype, slab):
    kw = EAGER_CASES[case]
    with jax.enable_x64(dtype == np.float64):
        st_np = random_state(build_plan(JAX, dtype=dtype, **kw), seed=3)
    want = jax_run(kw, dtype, slab, st_np, NSTEPS)
    pt = build_plan(PORT, device="cpu", dtype=dtype, **kw)
    pt.slab_opt = slab
    got = TS.run(pt, interop.state_from_numpy(st_np, "cpu"), NSTEPS, t0=0)
    assert_states_close(interop.state_to_numpy(got), want, TOL[dtype])


@pytest.mark.parametrize("slab", [True, False], ids=["slab", "full"])
def test_source_inside_pml_slab_follows_jax(slab):
    """A fault of the reference, pinned: with a current source inside a PML
    sigma slab (here 2-3 cells inside the x slab of a 0.75 PML), the
    slab-local chains (plan.slab_opt, the route of the fused kernels) and
    the full-grid chains give different fields, because the source enters f
    only and breaks the f_u == f invariant the slab path rests on.  The
    port follows the reference on each route; the two routes differ far
    beyond roundoff."""
    kw = dict(pml=0.75)
    nsteps, t0 = 60, 120                    # around the source's peak
    pj = build_plan(JAX, **kw)
    lo = pj.curl_specs_d[2].dsig_slabs[0]
    assert pj.curl_specs_d[2].dsig_axis == 0
    assert np.asarray(pj.coefs["src0:idx"])[:, 0].max() < lo
    pj.slab_opt = slab
    want = jax.tree_util.tree_map(
        np.asarray, JS.run(pj, JS.init_state(pj), nsteps, t0=t0))
    out = {}
    for route in (True, False):
        pt = build_plan(PORT, device="cpu", **kw)
        pt.slab_opt = route
        out[route] = interop.state_to_numpy(
            TS.run(pt, TS.init_state(pt), nsteps, t0=t0))
    assert_states_close(out[slab], want, 1e-5, keys=("f", "f_u", "f_w"))
    scale = float(np.abs(want["f"]["ez"]).max())
    gap = float(np.abs(out[True]["f"]["ez"] - out[False]["f"]["ez"]).max())
    assert gap > 0.1 * scale


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_nr_solve_matches_jax(dtype):
    """Three Newton iterations from the perturbative seed, on random
    inputs (some sites with chi2 = 0, which return the seeds)."""
    rng = np.random.default_rng(11)
    n = 4096
    A = [0.3 * rng.standard_normal(n).astype(dtype) for _ in range(3)]
    eps = rng.uniform(1.0, 4.0, n).astype(dtype)
    chi2 = np.where(rng.random(n) < 0.2, 0.0,
                    rng.uniform(0.0, 0.2, n)).astype(dtype)
    seeds = [rng.standard_normal(n).astype(dtype) for _ in range(3)]
    with jax.enable_x64(dtype == np.float64):
        want = [np.asarray(v) for v in JS._nr_solve(
            *[jax.numpy.asarray(a) for a in A + [eps, chi2] + seeds])]
    got = [v.numpy() for v in TS._nr_solve(
        *[torch.from_numpy(a) for a in A + [eps, chi2] + seeds])]
    tol = TOL[dtype]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * np.abs(w).max())
    # the solution satisfies the chi2 system where chi2 != 0
    x, y, z = got
    live = chi2 != 0
    res = A[0] - (eps * x + chi2 * y * z)
    assert np.abs(res[live]).max() <= 50 * np.finfo(dtype).eps
    np.testing.assert_array_equal(x[~live], seeds[0][~live])


@pytest.mark.parametrize("feature", ["cond", "noisy", "offdiag",
                                     "integrated"])
def test_outside_the_slice_raises(feature):
    """Features of later slices raise NotImplementedError naming the
    ROADMAP item, never run silently wrong."""
    kw = {"cond": dict(ball=True, cond=True),
          "noisy": dict(ball=True, noisy=True),
          "offdiag": dict(ball=True, offdiag=True),
          "integrated": dict(integrated=True)}[feature]
    pt = build_plan(PORT, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TS.init_state(pt)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TS.make_step(pt)
