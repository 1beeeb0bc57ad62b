"""Cylindrical (r, z) cells in the port against the JAX package, on the
CPU.

A cylindrical cell's fields carry an exact e^{i m phi} dependence: the
curl's phi derivatives become i m / r terms, the z component's radial
derivative is (1 / r) d(r g)/dr and the r = 0 ring takes the reference's
axis corrections.  m = 0 runs on real fields; m != 0 forces complex fields
(native complex64 on the CPU, the real pair on the card and with
MNT_REAL_PAIR=1).  Grids stay at most 72x60."""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import meep_nl_tpu as mnt
from meep_nl_tpu.core import grid as JG
from meep_nl_tpu.ops.pallas import resident as JR
from meep_nl_tpu.stepper import plan as JP
from meep_nl_tpu.stepper import step as JS

import meep_nl_tpu_torch as mtt
from meep_nl_tpu_torch import interop
from meep_nl_tpu_torch.core import grid as TG
from meep_nl_tpu_torch.ops import resident as R
from meep_nl_tpu_torch.stepper import plan as TP
from meep_nl_tpu_torch.stepper import step as TS

from test_torch_plan import _assert_same, _spec_fields, random_state
from test_torch_step import assert_states_close

torch.set_num_threads(2)

JAX = types.SimpleNamespace(G=JG, P=JP, Gaussian=mnt.GaussianSource)
PORT = types.SimpleNamespace(G=TG, P=TP, Gaussian=mtt.GaussianSource)


def cyl_plan(pkg, m=0, size=(2.0, 3.0), res=10.0, pml=0.5, src="ez",
             at=(0.7, 0.2), **extra):
    """A cylindrical plan from numpy inputs through package `pkg`: a cell
    of `size` (r, z) at `res`, PML `pml` on the high r side and both z
    sides (0: none), an eps=4 ring (0.5 <= r < 0.9), a point source of
    component `src` at (r, z) `at`."""
    gv = pkg.G.GridVolume.create("cyl", list(size), res)
    r = gv.comp_coords("ez", 0)
    ring = ((r >= 0.5) & (r < 0.9))[:, None] * np.ones(gv.shape)
    chi1inv = {c: {c[1]: 1.0 / np.where(ring > 0, 4.0, 1.0)}
               for c in gv.e_components}
    mat = pkg.P.MaterialSpec(chi1inv=chi1inv)
    pts = gv.interp_weights(src, list(at))
    srcs = [pkg.P.SrcVolSpec(src, np.array([p for p, w in pts], np.int32),
                             np.array([w * res ** 2 for p, w in pts],
                                      np.complex128),
                             pkg.Gaussian(frequency=1.0, fwidth=0.5))]
    pmls = [pkg.P.PMLSpec("r", pml, side=+1), pkg.P.PMLSpec("z", pml)] \
        if pml else []
    return pkg.P.compile_plan(gv, mat, pmls=pmls, sources=srcs, m=m,
                              live_e=list(gv.e_components),
                              live_h=list(gv.h_components), **extra)


def test_resident_declines_cylindrical_and_beta_plans(monkeypatch):
    """K3/K4 decline on their own, whatever the stepper admits, the
    cylindrical and beta plans their CYL variants do not step: a
    cylindrical cell with a Bloch wrap or with its axis off r = 0, and a
    BFAST term; they admit the rest (m = 0 real, the pair)."""
    monkeypatch.setattr(R, "check_supported", lambda plan: None)
    assert R.resident_supported(cyl_plan(PORT, m=0, device="cpu"))
    assert not R.resident_supported(cyl_plan(
        PORT, m=0, pml=0, device="cpu", periodic=(False, True),
        bloch_k=(0.0, 0.0)))
    p = cyl_plan(PORT, m=0, device="cpu")
    p.gv = dataclasses.replace(p.gv, origin=(0.5, p.gv.origin[1]))
    assert not R.resident_supported(p)
    gv = TG.GridVolume.create("2d", [1.0, 1.0], 8.0)
    p2 = TP.compile_plan(gv, TP.MaterialSpec(chi1inv={}),
                         periodic=(True, True), bloch_k=(0.0, 0.0),
                         beta=2.0, courant=0.25, device="cpu")
    p2.real_pair = True
    assert TS._is_pair(p2) and R.resident_supported(p2)
    p2.bfast_k = (0.3, 0.0, 0.0)
    assert not R.resident_supported(p2)


def _assert_plans_equal(pj, pt):
    """Every coefficient to fp64 roundoff and every spec field equal."""
    cj = {k: np.asarray(v) for k, v in pj.coefs.items()}
    ct = interop.coefs_to_numpy(pt.coefs)
    assert set(cj) == set(ct)
    for k in cj:
        assert cj[k].shape == ct[k].shape, k
        np.testing.assert_allclose(ct[k], cj[k], rtol=1e-15, atol=0,
                                   err_msg=k)
    for f in dataclasses.fields(pj):
        if f.name in ("coefs", "device", "gv"):
            continue
        a, b = getattr(pj, f.name), getattr(pt, f.name)
        if f.name in ("curl_specs_b", "curl_specs_d", "eh_specs_h",
                      "eh_specs_e", "pol_specs_e", "pol_specs_h",
                      "sources", "dfts"):
            a = [_spec_fields(s) for s in a]
            b = [_spec_fields(s) for s in b]
        _assert_same(a, b, f.name)
    assert dataclasses.asdict(pj.gv) == dataclasses.asdict(pt.gv)


@pytest.mark.parametrize("m", [0, 1, -1, 3])
def test_plan_equals_the_reference(m):
    """The cylindrical plan pieces -- i m / r (`:imr`), the r-weighted
    curl's `:rg` / `:rfinv`, the r = 0 masks per m, PML on the high r side
    and both z sides -- equal the reference's compile; m != 0 makes the
    fields complex."""
    pj, pt = cyl_plan(JAX, m=m), cyl_plan(PORT, m=m, device="cpu")
    _assert_plans_equal(pj, pt)
    assert pt.complex_fields == (m != 0)
    keys = set(pt.coefs)
    assert {"dz:rg", "dz:rfinv", "bz:rg", "bz:rfinv"} <= keys
    assert any(k.endswith(":imr") for k in keys) == (m != 0)
    for s in pt.curl_specs_d + pt.curl_specs_b:
        if s.dsig_axis == 0:
            assert s.dsig_slabs[0] == 0            # no PML at the axis
    # the r = 0 ring of the components the reference zeroes there
    dead = {c for c in pt.mask_planes if (0, 0) in (pt.mask_planes[c] or ())}
    want = {0: {"dp", "ep", "br", "hr"}, 1: {"dz", "ez"},
            3: {"dp", "ep", "dz", "ez", "br", "hr"}}[abs(m)]
    assert want <= dead


def test_grid_equals_the_reference():
    """core/grid.py's cylindrical grid: the axes (r, z), the origin on the
    axis, component sites and the r-low side that is the axis, not a
    wall."""
    gj = JG.GridVolume.create("cyl", [2.0, 3.0], 10.0)
    gt = TG.GridVolume.create("cyl", [2.0, 3.0], 10.0)
    assert dataclasses.asdict(gj) == dataclasses.asdict(gt)
    assert gt.axes == ("r", "z") and gt.origin[0] == 0.0
    for c in gt.e_components + gt.h_components:
        for ax in range(2):
            np.testing.assert_array_equal(gt.comp_coords(c, ax),
                                          gj.comp_coords(c, ax))
        np.testing.assert_array_equal(gt.metal_mask(c, (False, False)),
                                      np.asarray(gj.metal_mask(
                                          c, (False, False))))
        dc = {"e": "d", "h": "b"}[c[0]] + c[1]
        assert dataclasses.astuple(gt.step_plan(dc)) == \
            dataclasses.astuple(gj.step_plan(dc))


# ---------------------------------------------------------------------------
# the eager stepper against the JAX package's
# ---------------------------------------------------------------------------


def _random_complex_state(pj, seed):
    """A seeded random native-complex state in the JAX plan's layout."""
    rng = np.random.default_rng(seed)
    st = jax.tree_util.tree_map(np.asarray, JS.init_state(pj))

    def rnd(v):
        return (1e-2 * (rng.standard_normal(v.shape)
                        + 1j * rng.standard_normal(v.shape))
                ).astype(v.dtype)

    return {**st, "f": {c: (rnd(v) * np.asarray(pj.coefs[f"mask:{c}"])
                            ).astype(v.dtype) for c, v in st["f"].items()},
            "f_u": {c: rnd(v) for c, v in st["f_u"].items()},
            "f_w": {c: rnd(v) for c, v in st["f_w"].items()}}


def _split(st):
    """A native complex port state as a real pair's."""
    def sp(t):
        return torch.stack([t.real, t.imag]).contiguous()
    return {**st, **{k: {c: sp(t) for c, t in st[k].items()}
                     for k in ("f", "f_u", "f_w")}}


def _joined(st):
    """A real pair's numpy state as native complex."""
    out = interop.state_to_numpy(st)
    for k in ("f", "f_u", "f_w"):
        out[k] = {c: v[0] + 1j * v[1] for c, v in out[k].items()}
    return out


NSTEPS = 9


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["fp32", "fp64"])
def test_stepper_m0_matches_jax(dtype):
    """m = 0 on real fields: 9 steps of both steppers from one seeded random
    state (the axis ring's dz correction under the z PML corner included):
    1e-5 of the field maximum in fp32, 1e-12 in fp64."""
    kw = dict(m=0, dtype=dtype, at=(0.0, 0.2))
    with jax.enable_x64(dtype == np.float64):
        pj = cyl_plan(JAX, **kw)
        st = random_state(pj, 3)
        want = jax.tree_util.tree_map(np.asarray, JS.run(
            pj, jax.tree_util.tree_map(jax.numpy.asarray, st), NSTEPS))
    pt = cyl_plan(PORT, device="cpu", **kw)
    got = TS.run(pt, interop.state_from_numpy(st, "cpu"), NSTEPS, t0=0)
    assert_states_close(interop.state_to_numpy(got), want,
                        1e-5 if dtype == np.float32 else 1e-12)


@pytest.mark.parametrize("m", [1, -1, 3])
def test_stepper_m_matches_jax(m):
    """m != 0: 9 steps from one seeded random complex state, the port's
    native complex64 stepper and its real pair (MNT_REAL_PAIR's storage)
    against the JAX package's native run, to 1e-5 of the field maximum
    (the phi term, and for |m| = 1 the dp and br axis corrections)."""
    pj = cyl_plan(JAX, m=m, src="er", at=(0.6, 0.1))
    st = _random_complex_state(pj, 5)
    want = jax.tree_util.tree_map(np.asarray, JS.run(
        pj, jax.tree_util.tree_map(jax.numpy.asarray, st), NSTEPS))
    pt = cyl_plan(PORT, m=m, src="er", at=(0.6, 0.1), device="cpu")
    got = TS.run(pt, interop.state_from_numpy(st, "cpu"), NSTEPS, t0=0)
    assert_states_close(interop.state_to_numpy(got), want, 1e-5)
    pp = cyl_plan(PORT, m=m, src="er", at=(0.6, 0.1), device="cpu")
    pp.real_pair = True
    gp = TS.run(pp, _split(interop.state_from_numpy(st, "cpu")), NSTEPS,
                t0=0)
    assert gp["f"]["er"].shape == (2,) + pp.gv.shape
    assert_states_close(_joined(gp), want, 1e-5)
    if abs(m) == 1:
        assert {c for c, *_ in TS.axis_corrections(pt, "d")} == {"dp"}
        assert {c for c, *_ in TS.axis_corrections(pt, "b")} == {"br"}
    else:
        assert TS.axis_corrections(pt, "d") == []


def test_resident_kernel_m1_matches_jax_kernel(monkeypatch):
    """ResidentKernel.run on the m = 1 pair (its plain version on the CPU)
    against the JAX package's ResidentKernel in interpret mode
    (MNT_RESIDENT_CPU=1 for the JAX side), 12 steps from one seeded random
    state around the source's peak, to 1e-5 of the field maximum."""
    monkeypatch.setenv("MNT_RESIDENT_CPU", "1")
    kw = dict(m=1, src="er", at=(0.6, 0.1))
    pj = cyl_plan(JAX, **kw)
    pj.real_pair = True
    st = _random_complex_state(cyl_plan(JAX, **kw), 7)
    pair = {**st, **{k: {c: np.stack([v.real, v.imag]).astype(np.float32)
                         for c, v in st[k].items()}
                     for k in ("f", "f_u", "f_w")}}
    assert JR.resident_supported(pj)
    want = jax.tree_util.tree_map(np.asarray, JR.ResidentKernel(pj).run(
        jax.tree_util.tree_map(jax.numpy.asarray, pair), 12, 20))
    pt = cyl_plan(PORT, device="cpu", **kw)
    pt.real_pair = True
    ker = R.ResidentKernel(pt)
    got = ker.run(interop.state_from_numpy(pair, "cpu"), 12, 20)
    assert ker.plain_steps == 12 and ker.launches == 0
    assert_states_close(interop.state_to_numpy(got), want, 1e-5)


# ---------------------------------------------------------------------------
# Simulation
# ---------------------------------------------------------------------------


def purcell_box(mp, res=10, **kw):
    """test_cylindrical.py::test_cyl_mirror_purcell_ratio's vacuum
    normalization run: a 2.5 x 6 (r, z) cell, PML 0.8 (on the high r side
    and both z sides), an on-axis Ez dipole at the origin, the closed flux
    box (side at r = 1.2, caps at z = +-1.5), and an energy box."""
    sim = mp.Simulation(
        cell_size=mp.Vector3(2.5, 0, 6.0), resolution=res,
        dimensions=mp.CYLINDRICAL, m=0, boundary_layers=[mp.PML(0.8)],
        sources=[mp.Source(mp.GaussianSource(frequency=1.0, fwidth=0.3),
                           component=mp.Ez, center=mp.Vector3())], **kw)
    r0, z0 = 1.2, 1.5
    fl = [sim.add_flux(1.0, 0.2, 3, mp.FluxRegion(
              center=mp.Vector3(r0, 0, 0), size=mp.Vector3(0, 0, 2 * z0))),
          sim.add_flux(1.0, 0.2, 3, mp.FluxRegion(
              center=mp.Vector3(r0 / 2, 0, z0), size=mp.Vector3(r0, 0, 0))),
          sim.add_flux(1.0, 0.2, 3, mp.FluxRegion(
              center=mp.Vector3(r0 / 2, 0, -z0),
              size=mp.Vector3(r0, 0, 0)))]
    en = sim.add_energy(1.0, 0.2, 3, mp.EnergyRegion(
        center=mp.Vector3(r0 / 2, 0, 0), size=mp.Vector3(r0, 0, 1.0)))
    return sim, fl, en


def _close(got, want, what, scale=None, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max()) if scale is None else scale
    assert scale > 0, what
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:.0e} * {scale:.3e}"


def test_purcell_box_matches_jax():
    """The Purcell vacuum box at resolution 10, 399 steps (one stretch of a
    length the JAX runner does not unroll, so it compiles fast): on
    the port's resident route (K3's plain version on the CPU), Ez, Hp,
    the three fluxes and the energy against the JAX package to 1e-4; the
    fields of the r = 0 ring; the getters on (r, z)."""
    sj, fj, ej = purcell_box(mnt, use_fused=False)
    st, ft, et = purcell_box(mtt, device="cpu")
    sj.run(until=19.95)
    st.run(until=19.95)
    assert dict(st.routes) == {"resident": 1}
    assert st.plan._resident_kernel.plain_steps == st._t == 399
    for c in (mnt.Ez, mnt.Hp, mnt.Er):
        _close(st.get_array(c), sj.get_array(c), c)
    for a, b in zip(ft, fj):
        _close(st.get_fluxes(a), sj.get_fluxes(b), "flux", tol=1e-4)
    _close(st.get_total_energy(et), sj.get_total_energy(ej), "energy")
    ez = sj.get_array(mnt.Ez)
    for pt in (mnt.Vector3(0.0, 0, 0.3), mnt.Vector3(0.55, 0, -0.2)):
        assert st.get_field_point(mtt.Ez, mtt.Vector3(*pt)) == pytest.approx(
            sj.get_field_point(mnt.Ez, pt), abs=1e-4 * np.abs(ez).max())
    np.testing.assert_array_equal(st.get_epsilon(), sj.get_epsilon())
    # the on-axis point source's ring current: the reference's entries (no
    # 1 / (2 pi r) in the amplitude)
    _assert_same([_spec_fields(x) for x in sj._plan.sources],
                 [_spec_fields(x) for x in st.plan.sources], "sources")
    assert st.require_dimensions() == sj.require_dimensions() == -2
    assert st.using_real_fields() and st.get_efield().shape[-1] == 2


def ring_cyl(mp, m=3, res=10, fwidth=0.1, **kw):
    """Meep's ring-cyl.py at resolution 10 with a smaller pad and PML
    (2.5 and 1.5 for 4 and 2: a 60 x 20 grid): n = 3.4, w = 1, r = 1, an
    Ez Gaussian source (0.15, `fwidth`) at r + 0.1, PML in r."""
    n, w, r, pad, dpml = 3.4, 1.0, 1.0, 2.5, 1.5
    return mp.Simulation(
        cell_size=mp.Vector3(r + w + pad + dpml, 0, 2.0), resolution=res,
        dimensions=mp.CYLINDRICAL, m=m,
        geometry=[mp.Block(center=mp.Vector3(r + w / 2, 0, 0),
                           size=mp.Vector3(w, mp.inf, mp.inf),
                           material=mp.Medium(index=n))],
        sources=[mp.Source(mp.GaussianSource(frequency=0.15, fwidth=fwidth),
                           component=mp.Ez,
                           center=mp.Vector3(r + 0.1, 0, 0))],
        boundary_layers=[mp.PML(dpml, direction="r", side=+1)], **kw)


def test_ring_m3_harminv_matches_jax(monkeypatch):
    """The m = 3 ring with a shorter pulse (fwidth 0.3), 1023 steps (one
    stretch) with an after_sources Harminv collector at r + 0.2: on the
    port as the real pair (MNT_REAL_PAIR=1: the resident route, K4's plain
    version), the series against the JAX package's native complex run to
    1e-4, the fields Ez, Ep and Hz to 1e-4, and the resonance (Q > 20,
    amplitude above 1e-3 of the largest) to 1e-5 in frequency (Harminv
    under one BLAS thread)."""
    out = {}
    for name, mp, kw in (("jax", mnt, {"use_fused": False}),
                         ("port", mtt, {"device": "cpu"})):
        if name == "port":
            monkeypatch.setenv("MNT_REAL_PAIR", "1")
        sim = ring_cyl(mp, fwidth=0.3, **kw)
        h = mp.Harminv(mp.Ez, mp.Vector3(1.2, 0, 0), 0.15, 0.1)
        with threadpool_limits(limits=1, user_api="blas"):
            sim.run(mp.after_sources(h), until=51.15)
        out[name] = (sim, np.asarray(h.data), h.modes)
    (sj, dj, mj), (st, dt_, mt) = out["jax"], out["port"]
    assert st.plan.real_pair and not st.using_real_fields()
    assert dict(st.routes) == {"resident": 1} and st._t == 1023
    assert dj.shape == dt_.shape and len(dt_) > 300
    assert np.iscomplexobj(dt_)
    _close(dt_, dj, "series")
    for c in (mnt.Ez, mnt.Ep, mnt.Hz):
        _close(st.get_array(c), sj.get_array(c), c)
    # the ring (a Block of size (w, inf, inf) at (r + w / 2, 0, 0)) and
    # the source at r > 0, as the reference rasterizes and discretizes them
    # (epsilon to fp32 roundoff: 1 / the inverse epsilon the plan stores)
    np.testing.assert_allclose(st.get_epsilon(), sj.get_epsilon(),
                               rtol=1e-6)
    assert float(st.get_epsilon().max()) == pytest.approx(3.4 ** 2)
    _assert_same([_spec_fields(x) for x in sj._plan.sources],
                 [_spec_fields(x) for x in st.plan.sources], "sources")
    amax = max(m_.amp for m_ in mj)
    held = [m_ for m_ in mj if m_.amp > 1e-3 * amax and 20 < m_.Q < np.inf]
    assert held and all(0.1 < m_.freq < 0.2 for m_ in held)
    for m_ in held:
        f = min((x.freq for x in mt), key=lambda v: abs(v - m_.freq))
        assert abs(f - m_.freq) <= 1e-5 * m_.freq, (m_.freq, f)


# ---------------------------------------------------------------------------
# routes and refusals
# ---------------------------------------------------------------------------


def test_routes_and_kernel_declines(monkeypatch):
    """m = 0 takes the resident route (K3/K4 on the CYL variant), m != 0
    the resident route as a real pair (the PAIR_CYL variant) and the eager
    stepper in native complex storage, which K3/K4 decline; K1, K2 and K5
    decline cylindrical plans; a periodic cylindrical cell stays on the
    eager stepper; change_m recompiles the plan."""
    from meep_nl_tpu_torch.ops import fdtd3d, fdtd3d_t2, fused
    p0 = cyl_plan(PORT, m=0, device="cpu")
    assert R.resident_supported(p0)
    assert R.direct_variant(R.resident_plan(p0)) == R.DIRECT_CYL
    p1 = cyl_plan(PORT, m=1, device="cpu")
    assert not R.resident_supported(p1)            # native complex
    p1.real_pair = True
    assert R.resident_supported(p1)
    assert R.direct_variant(R.resident_plan(p1)) == R.DIRECT_PAIR_CYL
    for p in (p0, p1):
        assert not (fdtd3d.supported(p) or fdtd3d_t2.supported(p)
                    or fused.takes(p))
    pz = cyl_plan(PORT, m=0, pml=0, device="cpu", periodic=(False, True),
                  bloch_k=(0.0, 0.0))
    assert not R.resident_supported(pz)
    sim = mtt.Simulation(
        cell_size=mtt.Vector3(1.5, 0, 2.0), resolution=8,
        dimensions=mtt.CYLINDRICAL, m=2, device="cpu",
        sources=[mtt.Source(mtt.GaussianSource(1.0, fwidth=0.5), mtt.Er,
                            center=mtt.Vector3(0.3, 0, 0))])
    sim.run(until=4 * sim.dt)
    assert dict(sim.routes) == {"eager": 1}
    monkeypatch.setenv("MNT_REAL_PAIR", "1")
    sim.change_m(1)
    assert sim._plan is None and sim.m == 1
    sim.run(until=4 * sim.dt)
    assert dict(sim.routes) == {"eager": 1, "resident": 1}
    assert sim.plan.m == 1.0 and sim.plan.real_pair


def test_refusals_match_the_reference():
    """What the reference refuses on a cylindrical cell, the port refuses
    alike: Rotate2 / Rotate4 (their cartesian cells), and the A9 pieces
    the port does not carry yet (conductivity) raise NotImplementedError
    naming their ROADMAP item."""
    for sym in ("Rotate2", "Rotate4"):
        msgs = []
        for mp, kw in ((mnt, {}), (mtt, {"device": "cpu"})):
            with pytest.raises(NotImplementedError) as e:
                mp.Simulation(cell_size=mp.Vector3(2, 0, 2), resolution=8,
                              dimensions=mp.CYLINDRICAL,
                              symmetries=[getattr(mp, sym)(mp.Z)], **kw)
            msgs.append(str(e.value))
        assert "cartesian" in msgs[1]
    gv = TG.GridVolume.create("cyl", [1.0, 1.0], 8.0)
    mat = TP.MaterialSpec(chi1inv={}, cond={"dz": 0.1 * np.ones(gv.shape)})
    plan = TP.compile_plan(gv, mat, m=0, device="cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        TS.init_state(plan)
    # chi2 / chi3: the phi component's neighbour sums run along no grid
    # axis; the reference's step fails with a TypeError there
    for med in ({"chi3": 0.01}, {"chi2": 0.01, "chi2_full_tensor": True}):
        for mp, kw, err in ((mnt, {}, TypeError),
                            (mtt, {"device": "cpu"}, NotImplementedError)):
            sim = mp.Simulation(
                cell_size=mp.Vector3(1.5, 0, 2.0), resolution=8,
                dimensions=mp.CYLINDRICAL, m=0,
                geometry=[mp.Block(center=mp.Vector3(0.5, 0, 0),
                                   size=mp.Vector3(0.4, mp.inf, mp.inf),
                                   material=mp.Medium(epsilon=2, **med))],
                sources=[mp.Source(mp.GaussianSource(1.0, fwidth=0.5), mp.Ez,
                                   center=mp.Vector3(0.3, 0, 0))], **kw)
            with pytest.raises(err):
                sim.run(until=2 * sim.dt)
