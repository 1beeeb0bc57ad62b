"""BFAST (the fork's fixed-angle broadband oblique incidence,
`Simulation(bfast_scaled_k=...)`) in the port against the JAX package.

The plan compiler's BFAST pieces (the `:bftap` PML tapers, the CFL and the
single-partner ValueErrors) equal the reference's; one step stretch of 9
steps (not a multiple of 4: the JAX package's run unrolls those) from a
seeded random state, the flip-flop auxiliary f_bfast included, equals the
JAX jnp stepper's in native complex storage to 1e-5 of the field maximum,
on a cell Bloch-periodic across x and y with PML on z (the decay of the
W chain where a curl has no chain) and on one with PML on every face
(both chains' decay); the port's real-pair stepper equals its native
complex one; refl_angular_bfast.py's two runs (normalization, then the
interface with the incident flux subtracted) at a reduced length and
resolution give the JAX package's R(f) to 1e-4 of its maximum on the
resident route (the real pair, K3's plain version on the CPU); K1, K2
and K5 decline BFAST; f_bfast crosses interop both ways."""

import jax
import numpy as np
import pytest
import torch

import meep_nl_tpu as mnt
import meep_nl_tpu_torch as mtt
from meep_nl_tpu.stepper import step as JS
from meep_nl_tpu_torch import interop
from meep_nl_tpu_torch.ops import resident as R
from meep_nl_tpu_torch.stepper import step as TS

from test_torch_plan import JAX, PORT, build_plan
from test_torch_step import assert_states_close

torch.set_num_threads(2)

NSTEPS = 9

#: case -> build_plan kwargs: a cell periodic across x and y (k = 0) with
#: PML on z, and a cell with PML on every face; both with an eps=4 ball
CASES = {
    "wrap-xy": dict(cells=(4, 4, 16), pml_axes="z",
                    periodic=(True, True, False), bloch_k=(0.0, 0.0, 0.0),
                    bfast_scaled_k=(0.5, 0.0, 0.0),
                    courant=0.5 / np.sqrt(3)),
    "pml": dict(cells=(12, 12, 12), pml_axes="xyz",
                bfast_scaled_k=(0.3, 0.2, 0.0), courant=0.7 / np.sqrt(3)),
}


def _plans(case):
    kw = dict(ball=True, **CASES[case])
    pj = build_plan(JAX, **kw)
    pt = build_plan(PORT, device="cpu", **kw)
    assert pj.complex_fields and pt.complex_fields and pt.bfast_k
    return pj, pt


def _random_complex_state(pj, seed):
    """A seeded random native-complex state in the JAX plan's layout
    (fields masked), f_bfast included."""
    rng = np.random.default_rng(seed)
    st = jax.tree_util.tree_map(np.asarray, JS.init_state(pj))

    def rnd(v):
        return (1e-2 * (rng.standard_normal(v.shape)
                        + 1j * rng.standard_normal(v.shape))
                ).astype(v.dtype)

    C = pj.coefs
    out = {**st, "f": {c: (rnd(v) * np.asarray(C[f"mask:{c}"])).astype(
        v.dtype) for c, v in st["f"].items()}}
    for key in ("f_u", "f_w", "f_bfast"):
        out[key] = {c: rnd(v) for c, v in st[key].items()}
    return out


def test_plan_pieces_equal_the_reference():
    """The tapers of every curl equal the reference's; a Courant above
    (1 - max|s|) / sqrt(D), |s| >= 1 and a single-partner curl with k
    along its axis (2D TM) raise the reference's ValueErrors."""
    pj, pt = _plans("wrap-xy")
    keys = [k for k in pt.coefs if k.endswith(":bftap")]
    assert len(keys) == 6
    for k in keys:
        np.testing.assert_allclose(pt.coefs[k].numpy(),
                                   np.asarray(pj.coefs[k]), atol=1e-7,
                                   err_msg=k)
        assert float(pt.coefs[k].min()) < 1.0 <= float(pt.coefs[k].max())
    for kw in (dict(courant=0.5), dict(bfast_scaled_k=(1.0, 0.0, 0.0))):
        msgs = []
        for pkg, extra in ((JAX, {}), (PORT, {"device": "cpu"})):
            with pytest.raises(ValueError) as e:
                build_plan(pkg, **{**CASES["wrap-xy"], **kw}, **extra)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    msgs = []
    for mp, extra in ((mnt, {}), (mtt, {"device": "cpu"})):
        sim = mp.Simulation(
            cell_size=mp.Vector3(2, 2), resolution=8, Courant=0.3,
            sources=[mp.Source(mp.GaussianSource(1.0, fwidth=0.5), mp.Ez,
                               center=mp.Vector3())],
            bfast_scaled_k=mp.Vector3(0.3, 0, 0), **extra)
        with pytest.raises(ValueError) as e:
            sim.init_sim()
        msgs.append(str(e.value))
    assert "single partner" in msgs[1] and msgs[0] == msgs[1]


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_matches_jax(case):
    """NSTEPS steps of both steppers from one seeded random native-complex
    state: fields, PML auxiliaries and f_bfast to 1e-5 of the field
    maximum; then the port's real pair from the same state equals its
    native complex stepper to 1e-6."""
    pj, pt = _plans(case)
    st_np = _random_complex_state(pj, 3)
    want = jax.tree_util.tree_map(
        np.asarray, JS.run(pj, jax.tree_util.tree_map(jax.numpy.asarray,
                                                      st_np), NSTEPS))
    got = TS.run(pt, interop.state_from_numpy(st_np, "cpu"), NSTEPS, t0=0)
    assert set(got["f_bfast"]) == set(want["f_bfast"])
    assert_states_close(interop.state_to_numpy(got), want, 1e-5,
                        keys=("f", "f_u", "f_w", "f_bfast"))
    # the real pair: the same plan, every array (2, ...) real
    pp = build_plan(PORT, device="cpu", ball=True, **CASES[case])
    pp.real_pair = True
    st = interop.state_from_numpy(st_np, "cpu")

    def split(t):
        return torch.stack([t.real, t.imag]).contiguous()

    sp = {**st, **{k: {c: split(t) for c, t in st[k].items()}
                   for k in ("f", "f_u", "f_w", "f_bfast")}}
    gp = TS.run(pp, sp, NSTEPS, t0=0)
    for key in ("f", "f_u", "f_w", "f_bfast"):
        for c, t in got[key].items():
            a = torch.complex(gp[key][c][0], gp[key][c][1])
            err = float((a - t).abs().max())
            assert err <= 1e-6 * float(t.abs().max()) + 1e-12, \
                f"pair {key}[{c}]: {err:.3e}"


def refl_angular(mp, interface, **kw):
    """refl_angular_bfast.py's scene at a reduced size: a 0.2 x 0.2 x 6
    cell at resolution 10 (two sites across each periodic axis), PML 1 on
    z, glass (n = 1.5) on the upper half when `interface`, an Ex plane
    source and the reflection flux plane, BFAST at 30 degrees."""
    S = 0.5
    geom = [mp.Block(center=mp.Vector3(0, 0, 1.5),
                     size=mp.Vector3(mp.inf, mp.inf, 3.0),
                     material=mp.Medium(epsilon=2.25))] if interface else []
    sim = mp.Simulation(
        cell_size=mp.Vector3(0.2, 0.2, 6), resolution=10,
        Courant=(1 - S) / np.sqrt(3), geometry=geom,
        sources=[mp.Source(mp.GaussianSource(frequency=1.0, fwidth=0.5),
                           component=mp.Ex, center=mp.Vector3(0, 0, -1.3),
                           size=mp.Vector3(0.2, 0.2, 0))],
        boundary_layers=[mp.PML(1.0, direction=mp.Z)],
        k_point=mp.Vector3(0, 0, 0),
        bfast_scaled_k=mp.Vector3(S, 0, 0), eps_averaging=False, **kw)
    refl = sim.add_flux(1.0, 0.5, 5, mp.FluxRegion(
        center=mp.Vector3(0, 0, -0.8), size=mp.Vector3(0.2, 0.2, 0)))
    return sim, refl


def reflectance(mp, **kw):
    # both runs 1005 steps, one stretch each: the JAX package compiles its
    # runner once per stretch length, so the second run reuses the first's
    s0, r0 = refl_angular(mp, False, **kw)
    s0.run(until=29.0)
    inc = np.asarray(s0.get_fluxes(r0))
    s1, r1 = refl_angular(mp, True, **kw)
    s1.load_minus_flux_data(r1, s0.get_flux_data(r0))
    s1.run(until=29.0)
    return -np.asarray(s1.get_fluxes(r1)) / inc, (s0, s1)


def test_refl_angular_matches_jax(monkeypatch):
    """Both runs of the example on the port's resident route (the real
    pair; on the CPU K3's plain version) against the JAX package: R(f) at
    the 5 frequencies to 1e-4 of its maximum."""
    want, _ = reflectance(mnt)
    monkeypatch.setenv("MNT_REAL_PAIR", "1")
    got, sims = reflectance(mtt, device="cpu")
    for s in sims:
        assert s.plan.real_pair and s.plan.bfast_k == (0.5, 0.0, 0.0)
        assert set(s.routes) == {"resident"}
        assert s.plan._resident_kernel.plain_steps == s._t
        assert R._kernel(s.plan).schedule is None      # no kernel ran
        assert R.direct_variant(R.resident_plan(s.plan)) == \
            R.DIRECT_PAIR_BFAST
    assert np.all(np.isfinite(got)) and np.all(got > 0)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 1e-4 * scale, (got, want)


def test_fused_kernels_decline_bfast(monkeypatch):
    """K1, K2 and K5 decline BFAST, as the reference's do, so a BFAST plan
    above the resident budget runs on the eager stepper."""
    from meep_nl_tpu_torch.ops import fdtd3d, fdtd3d_t2, fused
    from meep_nl_tpu_torch.ops import hybrid as HY
    _, pt = _plans("pml")
    assert not (fdtd3d.supported(pt) or fdtd3d_t2.supported(pt)
                or fused.takes(pt) or HY.hybrid_applicable(pt))
    monkeypatch.setattr(R, "VMEM_BUDGET", 0)
    sim, _ = refl_angular(mtt, False, device="cpu")
    sim.run(until=5 * sim.dt)
    assert dict(sim.routes) == {"eager": 1}


def test_interop_carries_f_bfast():
    """f_bfast from a JAX state into the port and back, unchanged."""
    pj, pt = _plans("wrap-xy")
    st_np = _random_complex_state(pj, 5)
    back = interop.state_to_numpy(interop.state_from_numpy(st_np, "cpu"))
    assert set(back["f_bfast"]) == set(st_np["f_bfast"])
    for c, v in st_np["f_bfast"].items():
        assert back["f_bfast"][c].dtype == v.dtype
        np.testing.assert_array_equal(back["f_bfast"][c], v)
    assert set(TS.init_state(pt)["f_bfast"]) == set(st_np["f_bfast"])
