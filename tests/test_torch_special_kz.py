"""2D cells with an out-of-plane wavenumber (the reference's special_kz /
kz_2d: `Simulation(k_point=Vector3(kx, ky, kz))` with kz != 0 on a 2D
cell) in the port against the JAX package, on the CPU.

The fields carry an exact e^{i beta z} dependence, beta = 2 pi kz: the
dropped d/dz curl terms become the constant i beta coupling to the other
in-plane partner (the cylindrical i m / r machinery with a constant
coefficient), every component is live and the fields are complex (native
complex64 on the CPU, the real pair on the card and with
MNT_REAL_PAIR=1).  Tolerances: the plan to fp64 roundoff, the steppers and
the resident kernel to 1e-5 of the field maximum, Simulation runs to 1e-4
(test_torch_resident's)."""

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

from test_torch_cylindrical import (_assert_plans_equal, _close, _joined,
                                    _random_complex_state, _split)
from test_torch_step import assert_states_close

torch.set_num_threads(2)


def kz_sim(mp, k=(0.2, 0.0, 0.3), pml=False, res=16, courant=0.25, **kw):
    """test_special_kz.py's scene: a 1 x 1 cell at resolution 16, Courant
    0.25, an Ex Gaussian source (0.36, fwidth 0.25) at (0.1, -0.17),
    k_point k (every axis Bloch-periodic); with `pml` a 3 x 2 cell with
    PML 0.5 and an eps=4 cylinder instead (no wrap where k is 0)."""
    return mp.Simulation(
        cell_size=mp.Vector3(3, 2) if pml else mp.Vector3(1, 1),
        resolution=res, Courant=courant,
        geometry=[mp.Cylinder(radius=0.5, material=mp.Medium(epsilon=4))]
        if pml else [],
        boundary_layers=[mp.PML(0.5)] if pml else [],
        sources=[mp.Source(mp.GaussianSource(frequency=0.36, fwidth=0.25),
                           component=mp.Ex, center=mp.Vector3(0.1, -0.17))],
        k_point=mp.Vector3(*k), **kw)


def _plans(pml):
    kw = dict(k=(0.0, 0.0, 0.4), pml=True, res=10) if pml else {}
    sj = kz_sim(mnt, **kw)
    st = kz_sim(mtt, device="cpu", **kw)
    sj.init_sim()
    st.init_sim()
    return sj._plan, st.plan


@pytest.mark.parametrize("pml", [False, True], ids=["wrap", "pml"])
def test_plan_equals_the_reference(pml):
    """The beta plan of a Simulation: every component live, beta = 2 pi kz,
    the constant `:imr` = beta dx of the in-plane components, complex
    fields, and every coefficient and spec as the reference's."""
    pj, pt = _plans(pml)
    _assert_plans_equal(pj, pt)
    assert pt.beta == pytest.approx(2 * np.pi * (0.4 if pml else 0.3))
    assert pt.complex_fields
    assert [s.c for s in pt.curl_specs_d] == ["dx", "dy", "dz"]
    imr = {k: float(v) for k, v in pt.coefs.items() if k.endswith(":imr")}
    assert set(imr) == {"dx:imr", "dy:imr", "bx:imr", "by:imr"} and all(
        v == pytest.approx(pt.beta * pt.gv.dx) for v in imr.values())


@pytest.mark.parametrize("pml", [False, True], ids=["wrap", "pml"])
def test_stepper_matches_jax(pml):
    """9 steps from one seeded random complex state: the port's native
    stepper and its real pair against the JAX package's native run, to
    1e-5 of the field maximum (across a complex Bloch wrap, and with PML
    and a dielectric)."""
    pj, pt = _plans(pml)
    st = _random_complex_state(pj, 11)
    want = jax.tree_util.tree_map(np.asarray, JS.run(
        pj, jax.tree_util.tree_map(jax.numpy.asarray, st), 9))
    got = TS.run(pt, interop.state_from_numpy(st, "cpu"), 9, t0=0)
    assert_states_close(interop.state_to_numpy(got), want, 1e-5)
    pt.real_pair = True
    gp = TS.run(pt, _split(interop.state_from_numpy(st, "cpu")), 9, t0=0)
    assert_states_close(_joined(gp), want, 1e-5)


def test_resident_kernel_matches_jax_kernel(monkeypatch):
    """ResidentKernel.run on the beta pair with PML (its plain version on
    the CPU) against the JAX package's ResidentKernel in interpret mode
    (MNT_RESIDENT_CPU=1 for the JAX side), 12 steps from one seeded random
    state, to 1e-5 of the field maximum."""
    monkeypatch.setenv("MNT_RESIDENT_CPU", "1")
    pj, pt = _plans(True)
    st = _random_complex_state(pj, 13)
    pair = {**st, **{k: {c: np.stack([v.real, v.imag]).astype(np.float32)
                         for c, v in st[k].items()}
                     for k in ("f", "f_u", "f_w")}}
    pj.real_pair = True
    assert JR.resident_supported(pj)
    want = jax.tree_util.tree_map(np.asarray, JR.ResidentKernel(pj).run(
        jax.tree_util.tree_map(jax.numpy.asarray, pair), 12, 30))
    pt.real_pair = True
    ker = R.ResidentKernel(pt)
    assert R.direct_variant(ker.rplan) == R.DIRECT_PAIR_CYL
    got = ker.run(interop.state_from_numpy(pair, "cpu"), 12, 30)
    assert ker.plain_steps == 12 and ker.launches == 0
    assert_states_close(interop.state_to_numpy(got), want, 1e-5)


def test_simulation_matches_jax(monkeypatch):
    """The vacuum-dispersion cell, 319 steps (one stretch) with a flux
    line: native complex on the eager stepper against the JAX package,
    then the real pair on the resident route (K3's plain version) against
    that native run; Ex, Hy (the TM sector the TE source excites only
    through beta) and Ez and the flux to 1e-4."""
    def mk(mp, **kw):
        sim = kz_sim(mp, **kw)
        fl = sim.add_flux(0.36, 0.25, 3, mp.FluxRegion(
            center=mp.Vector3(0.2, 0), size=mp.Vector3(0, 0.8)))
        sim.run(until=319 * sim.dt)
        return sim, fl
    sj, fj = mk(mnt, use_fused=False)
    hy = np.abs(sj.get_array(mnt.Hy)).max()
    assert hy > 1e-3 * np.abs(sj.get_array(mnt.Ex)).max()
    want, wf = sj, fj
    for pair in (False, True):
        if pair:
            monkeypatch.setenv("MNT_REAL_PAIR", "1")
        st, ft = mk(mtt, device="cpu")
        assert st.plan.real_pair == pair
        assert dict(st.routes) == ({"resident": 1} if pair
                                   else {"eager": 1})
        for c in (mnt.Ex, mnt.Hy, mnt.Ez):
            _close(st.get_array(c), want.get_array(c), c)
        _close(st.get_fluxes(ft), want.get_fluxes(wf), "flux")
        assert st.using_real_fields() is sj.using_real_fields() is False
        want, wf = st, ft


def test_refusals_match_the_reference():
    """The Courant guard (an unstable Courant / beta pair), an unknown
    kz_2d and beta on a 3D cell raise the reference's ValueErrors."""
    msgs = []
    for mp, kw in ((mnt, {}), (mtt, {"device": "cpu"})):
        sim = kz_sim(mp, k=(0, 0, 5.0), res=8, courant=0.5, **kw)
        with pytest.raises(ValueError, match="unstable") as e:
            sim.init_sim()
        msgs.append(str(e.value))
        with pytest.raises(ValueError, match="kz_2d"):
            kz_sim(mp, kz_2d="bogus", **kw)
    assert msgs[0] == msgs[1]
    from meep_nl_tpu_torch.core import grid as TG
    from meep_nl_tpu_torch.stepper import plan as TP
    gv = TG.GridVolume.create("3d", [1.0, 1.0, 1.0], 4.0)
    with pytest.raises(ValueError, match="2D"):
        TP.compile_plan(gv, TP.MaterialSpec(chi1inv={}), beta=1.0,
                        device="cpu")
