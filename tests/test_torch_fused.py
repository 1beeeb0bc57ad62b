"""K5, the fused half-step kernel (meep_nl_tpu_torch/ops/fused.py), on the
CPU, where its kernel objects run their plain versions: the K5 branch of
`make_step` and the `HalfStepKernel` plain version against the JAX
package's `make_step` with `use_pallas` (its pallas_call in interpret
mode), `pallas_supported` against the reference's, and `Simulation(
use_pallas=True, use_fused=False)` against the JAX one.

The plans are those of tests/test_pallas.py (2.0^3 at resolution 8, PML 0.5,
an Ez point source): vacuum unpadded, vacuum padded to (8, 8, 128) and an
eps=4 ball.  Each starts from one seeded random state at step 150, where the
source is near its peak, so the source fix-up matters.  Tolerances: 1e-5 of
the field maximum in fp32, 1e-12 in fp64.  One JAX run per plan (module
fixtures) and one stretch length per JAX Simulation (its runners compile
once per length)."""

import jax
import numpy as np
import pytest
import torch

import meep_nl_tpu as mnt
from meep_nl_tpu.core import grid as JG
from meep_nl_tpu.ops.pallas import fused as JFU
from meep_nl_tpu.stepper import plan as JP
from meep_nl_tpu.stepper import step as JS

import meep_nl_tpu_torch as mtt
from meep_nl_tpu_torch import interop
from meep_nl_tpu_torch.core import grid as TG
from meep_nl_tpu_torch.ops import fused as TFU
from meep_nl_tpu_torch.stepper import plan as TP
from meep_nl_tpu_torch.stepper import step as TS

from test_torch_fused_gpu import pallas_plan
from test_torch_plan import JAX, PORT, build_plan, random_state

torch.set_num_threads(2)

NSTEPS, T0 = 6, 150
TOL = {np.float32: 1e-5, np.float64: 1e-12}
#: plan -> (pad_to_multiple, dielectric ball, dtype)
PLANS = {"vacuum": ((1, 1, 1), False, np.float32),
         "vacuum_padded": ((8, 8, 128), False, np.float32),
         "dielectric": ((8, 8, 128), True, np.float32),
         "dielectric_fp64": ((1, 1, 1), True, np.float64)}


def jax_plan(name):
    pad, ball, dtype = PLANS[name]
    return pallas_plan(JG, JP, mnt.GaussianSource, pad, ball, dtype)


def port_plan(name):
    pad, ball, dtype = PLANS[name]
    return pallas_plan(TG, TP, mtt.GaussianSource, pad, ball, dtype,
                       device="cpu")


@pytest.fixture(scope="module")
def jax_runs():
    """{plan: (numpy start state, the JAX K5 steps' end state)}, made on
    first use: the JAX make_step with use_pallas, its kernel interpreted;
    the compiled steps stay in `.steps` ({plan: jitted step})."""
    cache = {}

    def get(name):
        if name not in cache:
            dtype = PLANS[name][2]
            with pytest.MonkeyPatch.context() as mp, \
                    jax.enable_x64(dtype == np.float64):
                mp.setenv("MNT_PALLAS_INTERPRET", "1")
                pj = jax_plan(name)
                assert JFU.pallas_supported(pj)
                st_np = random_state(pj, seed=3)
                st_np["t"] = T0
                step = get.steps[name] = jax.jit(JS.make_step(pj))
                xs = JS.build_xs(pj, NSTEPS, T0)
                st = jax.tree_util.tree_map(jax.numpy.asarray, st_np)
                for n in range(NSTEPS):
                    st = step(st, {k: v[n] for k, v in xs.items()}, pj.coefs)
                cache[name] = (st_np, jax.tree_util.tree_map(np.asarray, st))
        return cache[name]

    get.steps = {}
    return get


def assert_fields_close(got, want, tol):
    """f, f_u and f_w against the field maximum of their family (E/D or
    H/B), as test_pallas.py scales them."""
    for key in ("f", "f_u", "f_w"):
        for c, w in want[key].items():
            scale = max(float(np.abs(want["f"][k]).max())
                        for k in want["f"] if (k[0] in "ed") == (c[0] in "ed"))
            assert scale > 0
            err = float(np.abs(np.asarray(got[key][c]) - w).max()) / scale
            assert err <= tol, f"{key}[{c}]: rel err {err:.3e} > {tol:.0e}"


@pytest.mark.parametrize("name", sorted(PLANS))
def test_make_step_matches_jax_step_pallas(name, jax_runs):
    """The port's K5 step (both half-step kernels' plain versions and both
    source fix-ups) against the JAX step_pallas."""
    st_np, want = jax_runs(name)
    pt = port_plan(name)
    assert TFU.pallas_supported(pt) and TFU.takes(pt)
    step = TS.make_step(pt)
    rows = TS.xs_rows(pt, TS.build_xs(pt, NSTEPS, T0))
    st = interop.state_from_numpy(st_np, "cpu")
    for n in range(NSTEPS):
        st = step(st, rows[n])
    ker = pt._fused_kernels
    assert ker["b"].plain_steps == ker["d"].plain_steps == NSTEPS
    assert ker["fix_b"] is None and ker["fix_d"].plain_steps == NSTEPS
    assert ker["b"].launches == ker["d"].launches == ker["fix_d"].launches == 0
    assert st["t"] == T0 + NSTEPS == int(want["t"])
    moved = float(np.abs(np.asarray(st["f"]["ez"]) - st_np["f"]["ez"]).max())
    assert moved > 0
    assert_fields_close(interop.state_to_numpy(st), want,
                        TOL[PLANS[name][2]])


@pytest.mark.parametrize("name", ["vacuum_padded", "dielectric_fp64"])
def test_half_step_kernel_and_fixup_match_jax(name, jax_runs):
    """The kernel objects driven by hand (B half, D half, D fix-up) give
    the same steps as the JAX step_pallas."""
    st_np, want = jax_runs(name)
    pt = port_plan(name)
    half_b, half_d = TFU.HalfStepKernel(pt, "b"), TFU.HalfStepKernel(pt, "d")
    assert TFU.build_source_fixup(pt, "b") is None
    fix_d = TFU.build_source_fixup(pt, "d")
    rows = TS.xs_rows(pt, TS.build_xs(pt, NSTEPS, T0))
    st = interop.state_from_numpy(st_np, "cpu")
    f, fu, fw = st["f"], st["f_u"], st["f_w"]
    for n in range(NSTEPS):
        f, fu, fw = half_b(f, fu, fw)
        f, fu, fw = half_d(f, fu, fw)
        f, fw = fix_d(f, fw, pt.coefs, rows[n])
    assert (half_b.plain_steps, half_d.plain_steps) == (NSTEPS, NSTEPS)
    assert_fields_close({"f": f, "f_u": fu, "f_w": fw}, want,
                        TOL[PLANS[name][2]])
    # the plain version as one step (the one chip_smoke.py holds K5 to)
    ref, sr = TFU.step_ref(pt), st
    for n in range(NSTEPS):
        sr = ref(sr, rows[n])
    for key, got in (("f", f), ("f_u", fu), ("f_w", fw)):
        for c, t in got.items():
            assert torch.equal(sr[key][c], t), (key, c)
    with pytest.raises(ValueError):
        TFU.HalfStepKernel(pt, "e")


#: plan -> build_plan kwargs (or "2d") for the envelope check
ENVELOPE = {"upml": dict(), "flagship": dict(ball=True, pol=True, nr=True),
            "dispersive": dict(ball=True, pol=True), "chi2": dict(ball=True,
                                                                 nr=True),
            "chi3": dict(ball=True, chi3=True), "conductive": dict(
                ball=True, cond=True), "periodic": dict(
                pml_axes="yz", periodic=(True, False, False)), "2d": "2d"}


@pytest.mark.parametrize("case", sorted(ENVELOPE) + sorted(PLANS))
def test_pallas_supported_matches_reference(case):
    if case in PLANS:
        with jax.enable_x64(PLANS[case][2] == np.float64):
            j = jax_plan(case)
        t = port_plan(case)
    elif ENVELOPE[case] == "2d":
        j, t = [pkg.P.compile_plan(
            pkg.G.GridVolume.create("2d", [2.0, 2.0], 8.0),
            pkg.P.MaterialSpec(chi1inv={}),
            pmls=[pkg.P.PMLSpec(d, 0.5) for d in "xy"], **extra)
            for pkg, extra in ((JAX, {}), (PORT, {"device": "cpu"}))]
    else:
        kw = ENVELOPE[case]
        j, t = build_plan(JAX, **kw), build_plan(PORT, device="cpu", **kw)
    assert JFU.pallas_supported(j) == TFU.pallas_supported(t)
    assert TFU.pallas_supported(t) == (case in PLANS or case == "upml")


def test_plan_the_hybrid_route_stepped_stays_eager(jax_runs):
    """A fault of the reference: once the hybrid route has stepped a plan
    (slab_opt), its state keeps f_w only on the sigma_w slabs, and the
    reference's step_pallas, which runs the W chain full-grid, adds the
    stale f_w back into E outside them.  On such a state the JAX step_pallas
    leaves the JAX slab-local jnp step by the size of the field itself; the
    port's make_step declines K5 there and equals its slab-local step."""
    st_np, _ = jax_runs("vacuum")
    st_np = {**st_np, "f_w": {c: np.zeros_like(v)
                              for c, v in st_np["f_w"].items()}}
    xs = JS.build_xs(jax_plan("vacuum"), 1, T0)
    row = {k: v[0] for k, v in xs.items()}
    out = {}
    for use_pallas in (True, False):
        pj = jax_plan("vacuum")
        pj.slab_opt, pj.use_pallas = True, use_pallas
        st = jax.tree_util.tree_map(jax.numpy.asarray, st_np)
        # the reference's step_pallas does not read slab_opt: it is the
        # step jax_runs compiled; the slab-local jnp step compiled once
        step = jax_runs.steps["vacuum"] if use_pallas \
            else jax.jit(JS.make_step(pj))
        out[use_pallas] = np.asarray(step(st, row, pj.coefs)["f"]["ez"])
    scale = float(np.abs(out[False]).max())
    assert float(np.abs(out[True] - out[False]).max()) > 0.1 * scale
    pt = port_plan("vacuum")
    pt.slab_opt = True
    assert not TFU.takes(pt)
    st = interop.state_from_numpy(st_np, "cpu")
    got = TS.make_step(pt)(st, TS.xs_rows(pt, TS.build_xs(pt, 1, T0))[0])
    want = TS.make_step(pt, use_pallas=False)(
        st, TS.xs_rows(pt, TS.build_xs(pt, 1, T0))[0])
    assert "_fused_kernels" not in pt.__dict__
    assert torch.equal(got["f"]["ez"], want["f"]["ez"])
    assert float(np.abs(got["f"]["ez"].numpy() - out[False]).max()) \
        <= 1e-5 * scale


def make_sim(mp, **kw):
    """A 2^3 cell at resolution 8 (storage (24, 17, 17)), PML 0.5, a
    Gaussian Ez point source and an x-normal flux plane outside the PML."""
    sim = mp.Simulation(
        cell_size=mp.Vector3(2.0, 2.0, 2.0), resolution=8,
        sources=[mp.Source(mp.GaussianSource(1.0, fwidth=1.0),
                           component=mp.Ez, center=mp.Vector3(-0.3, 0.02, 0))],
        boundary_layers=[mp.PML(0.5)], eps_averaging=False, **kw)
    flux = sim.add_flux(1.0, 0.4, 3, mp.FluxRegion(
        center=mp.Vector3(0.3, 0, 0), size=mp.Vector3(0, 0.8, 0.8)))
    return sim, flux


def test_simulation_use_pallas_matches_jax(monkeypatch):
    """Simulation(use_pallas=True, use_fused=False): every stretch through
    the K5 step (its plain version here), fluxes and Ez against the JAX
    package's to 1e-4 of their maximum."""
    monkeypatch.setenv("MNT_PALLAS_INTERPRET", "1")
    sj, fj = make_sim(mnt, use_pallas=True, use_fused=False)
    st, ft = make_sim(mtt, use_pallas=True, use_fused=False, device="cpu")
    for _ in range(2):                  # one JAX runner for both
        sj.run(until=2.0625)            # 33 steps: not a multiple of 4
        st.run(until=2.0625)
    assert st._t == sj._t == 66
    for got, want, what in ((st.get_fluxes(ft), sj.get_fluxes(fj), "flux"),
                            (st.get_array(mtt.Ez), sj.get_array(mnt.Ez),
                             "ez")):
        scale = float(np.abs(want).max())
        assert scale > 0
        err = float(np.abs(np.asarray(got) - want).max())
        assert err <= 1e-4 * scale, f"{what}: {err:.3e} vs {scale:.3e}"
    assert dict(st.routes) == {"half_step": 2}
    ker = st.plan._fused_kernels
    assert ker["b"].plain_steps == ker["d"].plain_steps == 66
    assert st.plan.use_pallas and not st.plan.slab_opt


def test_step_matches_run():
    """Simulation.step() advances through the same stepper as run(), and
    counts its stretches by route."""
    sims = [make_sim(mtt, use_pallas=p, use_fused=False, device="cpu")[0]
            for p in (True, True, False)]
    sims[0].run(until=12 * sims[0].dt)
    sims[1].step()
    sims[1].step(11)
    sims[2].step(12)
    assert dict(sims[0].routes) == {"half_step": 1}
    assert sims[0]._t == sims[1]._t == sims[2]._t == 12
    assert dict(sims[1].routes) == {"half_step": 2}
    assert dict(sims[2].routes) == {"eager": 1}
    for key in ("f", "f_u", "f_w", "dft"):
        for c, t in sims[0].fields_state[key].items():
            assert torch.equal(sims[1].fields_state[key][c], t), (key, c)
    ez = [s.fields_state["f"]["ez"] for s in sims]
    assert float(ez[2].abs().max()) > 0
    assert float((ez[2] - ez[0]).abs().max()) \
        <= 1e-5 * float(ez[2].abs().max())


def test_step_cost_counts_the_streams():
    """The bound's byte count: per half 3 g, D/B and f_u, E/H and f_w (27
    arrays with uPML on every face), plus u where the medium has one."""
    pt = port_plan("vacuum")
    n = int(np.prod(pt.storage_shape))
    assert TFU.step_cost(pt)["bytes"] == 54 * n * 4
    assert TFU.step_cost(port_plan("dielectric_fp64"))["bytes"] \
        == 57 * n * 8
