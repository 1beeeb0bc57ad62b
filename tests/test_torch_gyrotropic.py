"""Gyrotropic media in the port against the JAX package, on the CPU: the
Lorentzian, Drude and saturated (Landau-Lifshitz-Gilbert) gyrotropic
susceptibilities on the E and the H family, from the scene (the pole key
with its kind, bias and alpha; every component of the family made live)
through the plan, the eager stepper (fp32 and fp64 real fields, complex64
and the real pair; the off-axis P entries `c#1` / `c#2` carried by
interop), 1D Faraday rotation, ResidentKernel's plain version against the
JAX ResidentKernel in interpret mode and the 2D Simulation on its resident
route; and the resident envelope's declines.

Tolerances as test_torch_anisotropic.py: the plan to fp64 roundoff, the
stepper and the resident kernel to 1e-5 (fp32) and 1e-12 (fp64),
Simulation fields and fluxes to 1e-4."""

import functools

import jax
import numpy as np
import pytest
import torch

import meep_nl_tpu as mnt
from meep_nl_tpu.ops.pallas import resident as JR
from meep_nl_tpu.stepper import step as JS

import meep_nl_tpu_torch as mtt
from meep_nl_tpu_torch import interop
from meep_nl_tpu_torch.ops import resident as R
from meep_nl_tpu_torch.stepper import step as TS

from test_torch_plan import random_state
from test_torch_step import assert_states_close

torch.set_num_threads(2)

TOL = {np.float32: 1e-5, np.float64: 1e-12}

#: the three gyrotropic poles (name -> constructor keywords)
POLES = {"lorentzian": ("GyrotropicLorentzianSusceptibility",
                        dict(frequency=1.1, gamma=0.08, sigma=0.5,
                             bias=(0.1, 0.2, 0.6))),
         "drude": ("GyrotropicDrudeSusceptibility",
                   dict(frequency=0.8, gamma=0.2, sigma=0.3,
                        bias=(0.0, 0.0, 0.5))),
         "saturated": ("GyrotropicSaturatedSusceptibility",
                       dict(frequency=0.9, gamma=0.05, sigma=0.6, alpha=0.05,
                            bias=(0.3, 0.0, 1.0)))}


def pole(mp, name):
    cls, kw = POLES[name]
    return getattr(mp, cls)(**{**kw, "bias": mp.Vector3(*kw["bias"])})


def gyro_sim(mp, fam, names=tuple(POLES), comp=None, **kw):
    """A 4 x 3.5 cell at resolution 10 (40 x 35), PML 0.6, an eps=4
    cylinder of radius 0.9 carrying the poles `names` on family `fam`
    ("e", "h", or "eh": on both), a Gaussian point source (Ez unless
    `comp`) and an x-normal flux line."""
    med = mp.Medium(epsilon=4, **{
        key: [pole(mp, n) for n in names]
        for f, key in (("e", "E_susceptibilities"),
                       ("h", "H_susceptibilities")) if f in fam})
    sim = mp.Simulation(
        cell_size=mp.Vector3(4, 3.5), resolution=10,
        geometry=[mp.Cylinder(radius=0.9, material=med)],
        sources=[mp.Source(mp.GaussianSource(0.6, fwidth=0.3),
                           comp or mp.Ez, center=mp.Vector3(-1.3, 0.15))],
        boundary_layers=[mp.PML(0.6)], **kw)
    fl = sim.add_flux(0.6, 0.3, 3, mp.FluxRegion(
        center=mp.Vector3(1.2, 0), size=mp.Vector3(0, 2)))
    return sim, fl


def plans(fam, dtype=np.float32, **kw):
    with jax.enable_x64(dtype == np.float64):
        sj, _ = gyro_sim(mnt, fam, dtype=dtype, **kw)
        sj.init_sim()
    st, _ = gyro_sim(mtt, fam, dtype=dtype, device="cpu", **kw)
    st.init_sim()
    return sj._plan, st.plan


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("fam", ["e", "h"])
@pytest.mark.parametrize("name", sorted(POLES))
def test_plan_matches_jax(name, fam):
    """One gyrotropic pole on the E or H family: every component of the
    family live (and through the curls the other's), the pole's kind,
    bias, alpha and saturation, and every coefficient to fp64 roundoff."""
    pj, pt = plans(fam, np.float64, names=(name,))
    assert [s.ec for s in pt.eh_specs_e + pt.eh_specs_h] == \
        [s.ec for s in pj.eh_specs_e + pj.eh_specs_h]
    assert len(pt.eh_specs_e) == 3 and len(pt.eh_specs_h) == 3
    (p,) = pt.pol_specs_e + pt.pol_specs_h
    (q,) = pj.pol_specs_e + pj.pol_specs_h
    assert p.field_type == q.field_type == fam
    assert (p.kind, p.drude, p.saturated, p.gyro_alpha) == \
        (q.kind, q.drude, q.saturated, q.gyro_alpha)
    np.testing.assert_allclose(p.bias, q.bias, rtol=1e-15)
    assert set(pt.coefs) == set(pj.coefs)
    for k, v in pj.coefs.items():
        want = np.asarray(v)
        got = pt.coefs[k].numpy()
        scale = max(float(np.abs(want).max()), 1e-300)
        assert float(np.abs(got - want).max()) <= 1e-12 * scale, k
    st = TS.init_state(pt)
    assert set(st["pol"][0]["p"]) == set(JS.init_state(pj)["pol"][0]["p"])


#: the poles of the stepper's JAX comparison: all three in fp32, the
#: saturated one (the one-way waveguide's) in fp64, on both families
STEP_POLES = {np.float32: tuple(POLES), np.float64: ("saturated",)}


@functools.lru_cache(maxsize=None)
def jax_stepped(dtype):
    """STEP_POLES[dtype] on both families: a random state (every P entry
    random) and 23 steps of the JAX package's eager stepper from it (one
    compile per dtype, shared by the parametrized cases)."""
    with jax.enable_x64(dtype == np.float64):
        sj, _ = gyro_sim(mnt, "eh", names=STEP_POLES[dtype], dtype=dtype)
        sj.init_sim()
        pj = sj._plan
        st = random_state(pj, 11)
        want = to_np(JS.run(pj, jax.tree_util.tree_map(jax.numpy.asarray,
                                                        st), 23, t0=6))
    return st, want


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["fp32", "fp64"])
@pytest.mark.parametrize("fam", ["e", "h"])
def test_stepper_matches_jax(fam, dtype):
    """The three poles side by side (fp32; fp64: the saturated one) on the
    E and the H family: 23 steps of both packages' eager steppers from one
    random state, carried into the port by interop; the family's poles' P
    entries and every field."""
    st, want = jax_stepped(dtype)
    assert any("#" in c for e in st["pol"] for c in e["p"])
    sim, _ = gyro_sim(mtt, "eh", names=STEP_POLES[dtype], dtype=dtype,
                      device="cpu")
    sim.init_sim()
    got = TS.run(sim.plan, interop.state_from_numpy(st, "cpu"), 23, t0=6)
    back = interop.state_to_numpy(got)
    pols = [pi for pi, p in enumerate(sim.plan.pol_specs_e
                                      + sim.plan.pol_specs_h)
            if p.field_type == fam]
    assert len(pols) == len(STEP_POLES[dtype])
    for pi in pols:
        assert set(back["pol"][pi]["pp"]) == set(want["pol"][pi]["pp"])
    assert_states_close(back, want, TOL[dtype])


@functools.lru_cache(maxsize=None)
def jax_complex():
    """The JAX package's native complex run of the H-family Lorentzian pole
    (its bias tilted off every axis) with force_complex_fields, 31 steps
    from zero (shared by both storages)."""
    pj, _ = plans("h", names=("lorentzian",), force_complex_fields=True)
    return to_np(JS.run(pj, JS.init_state(pj), 31, t0=0))


@pytest.mark.parametrize("pair", [False, True], ids=["native", "pair"])
def test_complex_storages_match_jax(pair):
    """force_complex_fields with the H-family Lorentzian pole (the three
    kinds differ only in real host constants): the port's native complex64
    and real pair against the JAX package's native complex run, 31 steps
    from zero."""
    want = jax_complex()
    _, pt = plans("h", names=("lorentzian",), force_complex_fields=True)
    pt.real_pair = pair
    got = TS.run(pt, TS.init_state(pt), 31, t0=0)
    scale = max(float(np.abs(v).max()) for v in want["f"].values())
    assert scale > 0
    for c, w in want["f"].items():
        g = got["f"][c].numpy()
        g = g[0] + 1j * g[1] if pair else g
        assert float(np.abs(g - w).max()) <= 2e-6 * scale, c
    for pi, e in enumerate(want["pol"]):
        for c, w in e["p"].items():
            g = got["pol"][pi]["p"][c].numpy()
            g = g[0] + 1j * g[1] if pair else g
            assert float(np.abs(g - w).max()) <= 2e-6 * scale, c


def faraday_sim(mp, **kw):
    """tests/test_faraday.py's 1D cell (a z-biased gyrotropic Lorentzian,
    an Ex continuous source, PML on z) at resolution 10."""
    med = mp.Medium(epsilon=1.5, E_susceptibilities=[
        mp.GyrotropicLorentzianSusceptibility(
            frequency=1.0, gamma=1e-6, sigma=0.1,
            bias=mp.Vector3(0, 0, 0.15))])
    return mp.Simulation(
        cell_size=mp.Vector3(0, 0, 16.0), resolution=10, dimensions=1,
        default_material=med,
        sources=[mp.Source(mp.ContinuousSource(0.8, width=2.0), mp.Ex,
                           center=mp.Vector3(0, 0, -6.5))],
        boundary_layers=[mp.PML(1.0, direction="z")], **kw)


def test_faraday_rotation_matches_jax():
    """The 1D Faraday rotation run (both transverse polarizations, the
    reduced-grid averages of the gyrotropic update) for 599 steps: the
    port's Ex and Ey against the JAX package's, and the rotation present
    (Ey grows from nothing)."""
    sj, st = faraday_sim(mnt), faraday_sim(mtt, device="cpu")
    until = 599 * 0.05
    sj.run(until=until)
    st.run(until=until)
    assert st._t == sj._t == 599
    assert set(st.plan.coefs) == set(sj._plan.coefs)
    ex = np.asarray(sj.get_array("ex"))
    for c in ("ex", "ey", "hx", "hy"):
        want = np.asarray(sj.get_array(c))
        got = np.asarray(st.get_array(c))
        assert float(np.abs(got - want).max()) <= 1e-4 * float(
            np.abs(ex).max()), c
    assert float(np.abs(st.get_array("ey")).max()) > 1e-2 * float(
        np.abs(ex).max())


@pytest.fixture
def jax_resident_cpu(monkeypatch):
    monkeypatch.setenv("MNT_RESIDENT_CPU", "1")


def test_resident_kernel_matches_jax_kernel(jax_resident_cpu):
    """ResidentKernel.run (its plain version on the CPU, the GYRO mode's
    plan) against the JAX ResidentKernel in interpret mode: 13 steps of
    the saturated pole on the H family (the one-way waveguide's) from a
    random state.  The other poles and the E family's go through the same
    plain version (the eager stepper), held against the JAX package's
    above."""
    pj, pt = plans("h", names=("saturated",))
    assert R.resident_supported(pt) and R.ax_mode(pt) == R.AX_GYRO
    st = random_state(pj, 5)
    want = to_np(JR.ResidentKernel(pj).run(
        jax.tree_util.tree_map(jax.numpy.asarray, st), 13, 30))
    ker = R.ResidentKernel(pt)
    got = ker.run(interop.state_from_numpy(st, "cpu"), 13, 30)
    assert ker.plain_steps == 13 and ker.launches == 0
    assert_states_close(interop.state_to_numpy(got), want, 1e-5)


def test_simulation_route_and_fluxes_match_jax():
    """The 2D Simulation with the saturated H-family pole (a gyromagnetic
    rod, TM source) takes the resident route and gives the JAX package's
    fields and fluxes over one stretch of 151 steps."""
    sj, fj = gyro_sim(mnt, "h", names=("saturated",))
    st, ft = gyro_sim(mtt, "h", names=("saturated",), device="cpu")
    until = 151 * 0.05
    sj.run(until=until)
    st.run(until=until)
    assert dict(st.routes) == {"resident": 1}
    for c in ("ez", "hx", "hy"):
        want = np.asarray(sj.get_array(c))
        got = np.asarray(st.get_array(c))
        scale = float(np.abs(want).max())
        assert scale > 0 and float(np.abs(got - want).max()) <= 1e-4 * scale
    a, b = np.asarray(sj.get_fluxes(fj)), np.asarray(st.get_fluxes(ft))
    assert float(np.abs(a - b).max()) <= 1e-4 * float(np.abs(a).max())


@pytest.mark.parametrize("case", ["pair", "periodic", "chi2", "h-offdiag"])
def test_resident_envelope_declines(case):
    """The OFFDIAG and GYRO modes run linear real fields without a Bloch
    wrap, and off-diagonal rows on the E family only: a real pair (ROADMAP
    C.2), a Bloch-periodic cell, chi2 beside a gyrotropic pole and an
    off-diagonal mu row (a MaterialSpec's) are declined and run on the
    eager stepper."""
    if case == "h-offdiag":
        gv = mtt.GridVolume.create("2d", [2.0, 2.0], 10.0)
        mat = mtt.MaterialSpec(chi1inv={"hx": {"x": np.ones(gv.shape),
                                               "y": 0.1 * np.ones(gv.shape)}})
        plan = mtt.compile_plan(gv, mat, device="cpu")
        TS.init_state(plan)
    else:
        kw = {"pair": {"force_complex_fields": True},
              "periodic": {"k_point": mtt.Vector3(0, 0.5 / 3.5, 0)},
              "chi2": {}}[case]
        sim, _ = gyro_sim(mtt, "h", names=("saturated",), device="cpu", **kw)
        if case == "chi2":
            sim.geometry.append(mtt.Block(
                size=mtt.Vector3(0.5, 0.5, mtt.inf),
                material=mtt.Medium(epsilon=2, chi3=0.01)))
        sim.init_sim()
        plan = sim.plan
        if case == "pair":
            plan.real_pair = True
    assert R._sep_poles(plan) or R._offdiag(plan)
    assert not R.resident_supported(plan)
