"""Bloch-periodic cells with real phases in the port (meep_nl_tpu_torch,
device="cpu") against the JAX package (meep_nl_tpu, its jnp stepper on the
CPU) and against the port's own eager stepper.

`Simulation(k_point=...)` wraps every axis with the phase exp(2 pi i k L)
unless k is zero along it and both its ends absorb.  Held against the JAX
package once per feature, on stretches whose lengths are not multiples of
4 (the JAX package's run unrolls those 4 times): the centred DTFT read on a
wrapped axis (exact), a 2D grating-like cell periodic in y at phase +1 and
-1 (fluxes, get_array and near2far with nperiods=3 to 1e-4 of their
maximum), a 2D zone-edge cell's probe series (5e-6) and run_k_points'
modes (1e-4), a 3D x-periodic cell with the flagship material at phase +1
and -1 (fluxes and get_array to 1e-4), a JAX periodic state carried
into the port (interop) and stepped on by both (1e-5), PeriodicXT2Kernel's
run (K2's x wrap two steps a call, its plain version on the CPU) on the
reference's periodic test plan against the jnp run (1e-5), and the cell of a
complex phase (k = (0, 0.1): complex fields, tests/test_torch_complex.py
holds the rest of them) to 1e-4.  Further cases hold the ghost ring's and
K1's x-wrap plain versions against the port's eager stepper (bit for bit
on the live planes), the refusals and the routes."""

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import meep_nl_tpu as mnt
import meep_nl_tpu_torch as mtt
from meep_nl_tpu.stepper import step as JS
from meep_nl_tpu_torch import interop
from meep_nl_tpu_torch.ops import fdtd3d as TF
from meep_nl_tpu_torch.ops import fdtd3d_t2 as T2
from meep_nl_tpu_torch.ops import hybrid as HY
from meep_nl_tpu_torch.ops import periodicx as PX
from meep_nl_tpu_torch.ops import resident as R
from meep_nl_tpu_torch.stepper import step as TS

from test_torch_plan import JAX, PORT
from test_torch_step import assert_states_close

torch.set_num_threads(2)


def _close(got, want, what, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    assert scale > 0, what
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} vs max {scale:.3e}"


# ---------------------------------------------------------------------------
# the centred DTFT read on a wrapped axis
# ---------------------------------------------------------------------------


def test_centred_dtft_read_wraps_like_the_reference():
    """A 4 x 2 cell at resolution 8, periodic in y, with an x-normal flux
    line over the whole period: the monitors' region values of a seeded
    random field (its dead plane zeroed, as the masks keep it) equal the
    reference's _centered_avg over the region, at phase +1 and -1.  The
    parent's read zero-filled past the storage instead of wrapping, and
    differed on the last live row."""
    rng = np.random.default_rng(5)
    for ky in (0.0, 0.25):
        plans = []
        for mp in (mnt, mtt):
            kw = {"device": "cpu"} if mp is mtt else {}
            sim = mp.Simulation(
                cell_size=mp.Vector3(4, 2), resolution=8,
                sources=[mp.Source(mp.GaussianSource(1.0, fwidth=0.5),
                                   mp.Ez, center=mp.Vector3(-1, 0))],
                boundary_layers=[mp.PML(0.5, direction=mp.X)],
                k_point=mp.Vector3(0, ky), **kw)
            sim.add_flux(1.0, 0.5, 2, mp.FluxRegion(
                center=mp.Vector3(1, 0), size=mp.Vector3(0, 2)))
            sim.init_sim()
            plans.append(sim.plan if mp is mtt else sim._plan)
        pj, pt = plans
        assert pt.periodic == (False, True)
        assert pt.bloch_phase[1] == (1.0 if ky == 0 else -1.0)
        for m in pt.dfts:
            arr = rng.standard_normal(pt.gv.shape).astype(np.float32)
            arr[:, pt.gv.num[1]] = 0.0
            want = np.asarray(JS._centered_avg(
                pj, m.component, jax.numpy.asarray(arr)))[
                    tuple(slice(a, b) for a, b in m.region)]
            got = TS._region_values(pt, m, torch.from_numpy(arr)).numpy()
            assert m.region[1] == (0, pt.gv.num[1])    # the whole period
            np.testing.assert_array_equal(got, want, err_msg=m.component)


# ---------------------------------------------------------------------------
# 2D: a grating-like cell periodic in y
# ---------------------------------------------------------------------------


def grating(mp, ky, **kw):
    """A 4 x 2 cell at resolution 10 with PML 0.5 on x only, periodic in y
    (k_y = 0: phase +1; 0.25: the zone edge, -1), a glass block off the
    y axis, a Gaussian Ez line source over the period, an x-normal flux
    line over the period and a near2far line with nperiods=3; 301 steps.
    Returns the outputs."""
    sim = mp.Simulation(
        cell_size=mp.Vector3(4, 2), resolution=10,
        geometry=[mp.Block(mp.Vector3(0.6, 1.0, mp.inf),
                           center=mp.Vector3(0.5, 0.3),
                           material=mp.Medium(epsilon=2.25))],
        sources=[mp.Source(mp.GaussianSource(1.0, fwidth=0.6), mp.Ez,
                           center=mp.Vector3(-1.2, 0),
                           size=mp.Vector3(0, 2))],
        boundary_layers=[mp.PML(0.5, direction=mp.X)],
        k_point=mp.Vector3(0, ky), **kw)
    fl = sim.add_flux(1.0, 0.6, 5, mp.FluxRegion(
        center=mp.Vector3(1.2, 0), size=mp.Vector3(0, 2)))
    n2f = sim.add_near2far(1.0, 0.6, 3, mp.Near2FarRegion(
        center=mp.Vector3(1.3, 0), size=mp.Vector3(0, 2)), nperiods=3)
    sim.run(until=15.05)
    return {"flux": sim.get_fluxes(fl), "ez": sim.get_array(mp.Ez),
            "hx": sim.get_array(mp.Hx), "hy": sim.get_array(mp.Hy),
            "far": np.stack([sim.get_farfield(n2f, mp.Vector3(*p))
                             for p in ((20, 3), (15, -6))]),
            "sim": sim}


@pytest.mark.parametrize("ky", [0.0, 0.25], ids=["k0", "zone-edge"])
def test_2d_periodic_cell_matches_jax(ky):
    """Fluxes, get_array (its zero ghosts at both ends, as the
    reference's) and the near2far lattice images (nperiods=3, the Bloch
    phase per period) to 1e-4; the port's stretch ran on the resident
    route (K3's plain version on the CPU)."""
    a = grating(mnt, ky)
    b = grating(mtt, ky, device="cpu")
    for k in ("flux", "ez", "hx", "hy", "far"):
        _close(b[k], np.asarray(a[k]), k)
    assert b["sim"].routes == {"resident": 1}
    assert b["sim"].plan.periodic == (False, True)


# ---------------------------------------------------------------------------
# 2D zone edge with a probe; k-point sweeps
# ---------------------------------------------------------------------------


def holey(mp, **kw):
    """Meep's holey-wvg-bands.py cut to 1 x 6 at resolution 10: eps=13,
    width 1.2, a hole of radius 0.36, an Hz source at (0.1234, 0), PML 1
    on y, Mirror(Y, phase=-1) (a metal wall on y = 0)."""
    return mp.Simulation(
        cell_size=mp.Vector3(1, 6), resolution=10,
        geometry=[mp.Block(mp.Vector3(mp.inf, 1.2, mp.inf),
                           material=mp.Medium(epsilon=13)),
                  mp.Cylinder(0.36)],
        sources=[mp.Source(mp.GaussianSource(0.25, fwidth=1.5), mp.Hz,
                           center=mp.Vector3(0.1234, 0))],
        boundary_layers=[mp.PML(1, direction=mp.Y)],
        symmetries=[mp.Mirror(mp.Y, phase=-1)], **kw)


def test_zone_edge_probe_series_matches_jax():
    """The holey waveguide at k_x = 0.5 (phase -1): FieldProbe series over
    701 steps, one inside the period and one at its high edge (its
    interpolation reaches the dead plane x = N, as the reference's
    does), equal the reference's to 5e-6 of their maximum, and the port
    took K4's route (its plain version)."""
    out = []
    for mp, kw in ((mnt, {}), (mtt, {"device": "cpu"})):
        sim = holey(mp, k_point=mp.Vector3(0.5), **kw)
        probes = [mp.FieldProbe(mp.Hz, mp.Vector3(0.1234, 0.3)),
                  mp.FieldProbe(mp.Ey, mp.Vector3(0.47, 0.25))]
        sim.run(*probes, until=35.05)
        out.append(([np.asarray(p.data) for p in probes], sim))
    (a, _), (b, sim) = out
    for got, want in zip(b, a):
        assert len(want) == len(got) == 701
        _close(got, want, "series", 5e-6)
    assert sim.plan.periodic == (True, False)
    assert sim.plan.bloch_phase[0] == -1.0
    assert sim.routes == {"resident": 1}


def test_run_k_points_matches_jax():
    """run_k_points at the band edges k_x = 0 and 0.5, 100 time units
    after the sources: the modes Harminv finds at each (Q > 10) equal the
    reference's to 1e-4 (a shorter window moves the decay rates of the
    Q ~ 90 modes with the series' fp32 round-off); change_k_point
    restarts the fields and the clock."""
    res = []
    for mp, kw in ((mnt, {}), (mtt, {"device": "cpu"})):
        sim = holey(mp, **kw)
        # one BLAS thread for Harminv's SVD (a minute on loaded CPUs else)
        with threadpool_limits(limits=1, user_api="blas"):
            res.append(sim.run_k_points(100, [mp.Vector3(0),
                                              mp.Vector3(0.5)]))
    for fa, fb in zip(*res):
        good = [f for f in fa if abs(f.real / (2 * f.imag)) > 10]
        assert good
        for f in good:
            near = min(fb, key=lambda g: abs(g - f))
            assert abs(near - f) <= 1e-4 * abs(f), (f, near)
    sim = holey(mtt, device="cpu", k_point=mtt.Vector3(0.5))
    sim.run(until=1.0)
    assert sim.meep_time() > 0
    sim.change_k_point(mtt.Vector3(0))
    assert sim._plan is None and sim.meep_time() == 0
    sim.init_sim()
    assert sim.plan.bloch_phase[0] == 1.0


def test_restart_fields_keeps_the_accumulators():
    sim = holey(mtt, device="cpu", k_point=mtt.Vector3(0.5))
    fl = sim.add_flux(0.25, 0.5, 2, mtt.FluxRegion(
        center=mtt.Vector3(0, 1.5), size=mtt.Vector3(1, 0)))
    sim.run(until=5.05)
    flux = sim.get_fluxes(fl)
    assert np.abs(flux).max() > 0
    sim.restart_fields()
    assert sim.meep_time() == 0
    assert all(float(t.abs().max()) == 0 for t in sim.fields_state["f"]
               .values())
    np.testing.assert_array_equal(sim.get_fluxes(fl), flux)


# ---------------------------------------------------------------------------
# 3D x-periodic cells
# ---------------------------------------------------------------------------


def flagship3d(mp, kx, flux=True, linear=False, **kw):
    """A 3 x 2.5 x 2.5 cell at resolution 8 (24 x 20 x 20) with PML 0.5 on
    y and z, periodic in x (k_x = 0: phase +1, 1/6: -1), the flagship
    material (eps=4, a Lorentz pole, full-tensor chi2 0.05; `linear`: eps=4
    alone) on a ball of radius 0.5 at the centre, a Gaussian Ez point
    source and (`flux`) an x-normal flux plane."""
    med = mp.Medium(epsilon=4.0) if linear else mp.Medium(
        epsilon=4.0, chi2=0.05, chi2_full_tensor=True,
        E_susceptibilities=[mp.LorentzianSusceptibility(
            frequency=2.0, gamma=0.05, sigma=0.2)])
    sim = mp.Simulation(
        cell_size=mp.Vector3(3, 2.5, 2.5), resolution=8,
        geometry=[mp.Sphere(0.5, material=med)],
        sources=[mp.Source(mp.GaussianSource(1.0, fwidth=0.8), mp.Ez,
                           center=mp.Vector3(-0.9, 0.1, 0))],
        boundary_layers=[mp.PML(0.5, direction=mp.Y),
                         mp.PML(0.5, direction=mp.Z)],
        k_point=mp.Vector3(kx), eps_averaging=False, **kw)
    fl = sim.add_flux(1.0, 0.6, 3, mp.FluxRegion(
        center=mp.Vector3(0.8, 0, 0), size=mp.Vector3(0, 1.5, 1.5))) \
        if flux else None
    return sim, fl


@pytest.mark.parametrize("kx", [0.0, 1 / 6], ids=["k0", "zone-edge"])
def test_3d_x_periodic_cell_matches_jax(kx):
    """The flagship material on an x-periodic 3D cell, 75 steps: fluxes
    and get_array(Ez) to 1e-4 of their maximum."""
    out = []
    for mp, kw in ((mnt, {}), (mtt, {"device": "cpu"})):
        sim, fl = flagship3d(mp, kx, **kw)
        sim.run(until=75 * 0.0625)
        out.append((sim.get_fluxes(fl), sim.get_array(mp.Ez), sim))
    (fa, ea, _), (fb, eb, sim) = out
    assert sim.plan.periodic == (True, False, False)
    _close(fb, np.asarray(fa), "flux")
    _close(eb, np.asarray(ea), "ez")


def test_interop_carries_a_periodic_state():
    """A JAX x-periodic state (the run above's scene at the zone edge)
    carried into the port by interop (no array beyond the usual ones)
    and stepped 9 more steps by both packages' steppers: 1e-5."""
    sj, _ = flagship3d(mnt, 1 / 6, flux=False)
    sj.run(until=11 * 0.0625)
    st_np = jax.tree_util.tree_map(np.asarray, sj._state)
    sp, _ = flagship3d(mtt, 1 / 6, flux=False, device="cpu")
    sp.init_sim()
    st = interop.state_from_numpy(st_np, "cpu")
    assert set(st["f"]) == set(sp.fields_state["f"])
    got = TS.run(sp.plan, st, 9, t0=11)
    want = jax.tree_util.tree_map(np.asarray,
                                  JS.run(sj._plan, sj._state, 9, t0=11))
    assert_states_close(interop.state_to_numpy(got), want, 1e-5,
                        keys=("f", "f_u", "f_w"))


def _reference_periodic_plan(pkg, kx, device=None):
    """The JAX package's periodic test plan (tests/test_periodic_fused.py:
    24-48) compiled by `pkg` (test_torch_plan.JAX or PORT) from numpy
    inputs: 24 x 16 x 16 at resolution 8, Bloch-periodic along x with
    k_x = kx, PML 0.5 on y and z, eps = 4 on the slab |x - cx| < L / 6, an
    Ez point source at x = 0.3; slab-local PML chains."""
    res, cells = 8.0, (24, 16, 16)
    size = [n / res for n in cells]
    gv = pkg.G.GridVolume.create("3d", size, res)
    chi1inv = {}
    x = gv.comp_coords("ez", 0)
    cx = 0.5 * (x[0] + x[-1])
    for c in ("ex", "ey", "ez"):
        e = np.ones(gv.shape)
        xx = gv.comp_coords(c, 0)
        e[np.abs(xx - cx) < size[0] / 6, :, :] = 4.0
        chi1inv[c] = {c[1]: 1.0 / e}
    pts = gv.interp_weights("ez", [0.3, 0.0, 0.0])
    src = pkg.P.SrcVolSpec(
        "ez", np.array([p for p, w in pts], np.int32),
        np.array([w for p, w in pts], np.complex128),
        pkg.Gaussian(frequency=1.0, fwidth=0.5))
    extra = {} if device is None else {"device": device}
    plan = pkg.P.compile_plan(
        gv, pkg.P.MaterialSpec(chi1inv=chi1inv),
        pmls=[pkg.P.PMLSpec(d, 0.5) for d in "yz"],
        periodic=(True, False, False), bloch_k=(kx, 0.0, 0.0),
        sources=[src], pad_to_multiple=(8, 1, 1), **extra)
    plan.slab_opt = True
    return plan


@pytest.mark.parametrize("edge", [False, True], ids=["k0", "zone-edge"])
def test_periodic_t2_kernel_matches_jax(edge):
    """PeriodicXT2Kernel (K2's x wrap at depth 2, the residue through K1's
    x wrap; on the CPU their plain versions) on the reference's periodic
    test plan at phase +1 and -1, against the JAX package's jnp run from
    zero fields: 11 steps (five calls and a K1 step) and 22 (eleven
    calls), fields and PML auxiliaries to 1e-5 of the field maximum, the
    pulse across the wrap by then."""
    kx = 0.5 / 3.0 if edge else 0.0
    pj = _reference_periodic_plan(JAX, kx)
    pt = _reference_periodic_plan(PORT, kx, device="cpu")
    assert pt.bloch_phase[0] == (-1.0 if edge else 1.0)
    assert PX.periodic_t2_supported(pt)
    sj = JS.init_state(pj)
    for n in (11, 22):
        sj = JS.run(pj, sj, 11, t0=n - 11)
        ker = PX.PeriodicXT2Kernel(pt)
        k1_before = ker._k1.plain_steps           # the plan's one K1
        got = ker.run(TS.init_state(pt), n)
        assert ker.plain_steps == 2 * (n // 2)
        assert ker._k1.plain_steps - k1_before == n % 2
        want = jax.tree_util.tree_map(np.asarray, sj)
        assert_states_close(interop.state_to_numpy(got), want, 1e-5,
                            keys=("f", "f_u", "f_w"))
    ez = want["f"]["ez"]
    assert np.abs(ez[:2]).max() > 1e-5 * np.abs(ez).max()


def _live_equal(got, want, n):
    """Every state array equal on the live x-planes [0, n)."""
    for key in ("f", "f_u", "f_w"):
        for c, t in want[key].items():
            assert torch.equal(got[key][c][:n], t[:n]), f"{key}[{c}]"
    for pg, pw in zip(got["pol"], want["pol"]):
        for k in ("p", "pp"):
            for c, t in pw[k].items():
                assert torch.equal(pg[k][c][:n], t[:n]), f"pol {k}[{c}]"


@pytest.mark.parametrize("kx", [0.0, 1 / 6], ids=["k0", "zone-edge"])
def test_periodic_drivers_plain_versions_match_eager(kx):
    """K1's x wrap (PeriodicXKernel) and the ghost ring at depth 2 and 3
    (K2 on the extended plan, its ghosts re-seeded every call) against the
    port's eager stepper over 29 steps from a seeded random state (more
    than the margin: without the refresh the edges' corruption reaches
    the period), bit for bit on the live planes (the ghost ring leaves
    the dead planes zero; the stepper adds a source landing there to D,
    which nothing reads)."""
    sim, _ = flagship3d(mtt, kx, flux=False, device="cpu")
    sim.init_sim()
    plan = sim.plan
    plan.slab_opt = True
    rng = np.random.default_rng(7)
    st0 = TS.init_state(plan)

    def rnd(t):
        return torch.from_numpy(1e-2 * rng.standard_normal(
            tuple(t.shape)).astype(np.float32))

    st0 = {**st0, "f": {c: TS._apply_mask(plan, plan.coefs, c, rnd(t))
                        for c, t in st0["f"].items()},
           "f_u": {c: rnd(t) for c, t in st0["f_u"].items()},
           "f_w": {c: rnd(t) for c, t in st0["f_w"].items()},
           "pol": [{k: {c: rnd(t) for c, t in e[k].items()}
                    for k in ("p", "pp")} for e in st0["pol"]]}
    want = TS.run(plan, st0, 29, t0=5)
    n = plan.gv.num[0]
    k1 = PX.PeriodicXKernel(plan)
    _live_equal(k1.run(st0, 29, t0=5), want, n)
    assert k1.plain_steps == 29
    for depth in (2, 3):
        assert PX.periodic_ghost_supported(plan, depth)
        ring = PX.PeriodicGhostT2Kernel(plan, depth)
        assert ring.Gl == ring.Gr == PX.MARGIN
        _live_equal(ring.run(st0, 29, t0=5), want, n)
        assert ring.ker.plain_steps == depth * (29 // depth)


def test_periodic_envelopes_decline():
    """K1's x wrap declines material within 3 sites of the wrap (the
    ghost ring within WINDOW_CLEAR planes), node mirrors, y/z periodicity
    and complex phases; K3/K4 decline chi2 at a wrap plane; the ghost ring
    declines monitored plans; PeriodicXT2Kernel declines dispersive media
    and sources within 2 planes of the wrap."""
    sim, _ = flagship3d(mtt, 0.0, device="cpu")
    sim.init_sim()
    plan = sim.plan
    assert PX.periodic_supported(plan) and R.resident_supported(plan)
    assert not PX.periodic_ghost_supported(plan)          # the flux plane
    assert not TF.supported(plan)                 # without allow_periodic_x
    assert not PX.periodic_t2_supported(plan)             # dispersive
    lin, _ = flagship3d(mtt, 0.0, linear=True, device="cpu")
    lin.init_sim()
    assert PX.periodic_t2_supported(lin.plan)
    assert not T2.supported(lin.plan)             # without allow_periodic_x
    lin, _ = flagship3d(mtt, 0.0, linear=True, device="cpu")
    lin.sources[0].center = mtt.Vector3(-1.4, 0.1, 0)      # planes 0, 1
    lin.init_sim()
    assert not PX.periodic_t2_supported(lin.plan)
    med = mtt.Medium(epsilon=4.0, chi2=0.05, chi2_full_tensor=True)
    for cx, k1, ring, res in ((-1.3, False, False, False),
                              (-0.8, True, False, True)):
        s = mtt.Simulation(
            cell_size=mtt.Vector3(3, 2.5, 2.5), resolution=8,
            geometry=[mtt.Sphere(0.3, center=mtt.Vector3(cx),
                                 material=med)],
            sources=[mtt.Source(mtt.GaussianSource(1.0, fwidth=0.8),
                                mtt.Ez, center=mtt.Vector3(0.2))],
            boundary_layers=[mtt.PML(0.5, direction=mtt.Y),
                             mtt.PML(0.5, direction=mtt.Z)],
            k_point=mtt.Vector3(), eps_averaging=False, device="cpu")
        s.init_sim()
        assert PX.periodic_supported(s.plan) == k1, cx
        assert PX.periodic_ghost_supported(s.plan) == ring, cx
        assert R.resident_supported(s.plan) == res, cx
    yper, _ = flagship3d(mtt, 0.0, flux=False, device="cpu")
    yper.k_point = mtt.Vector3(0, 0.2)
    yper.init_sim()
    assert yper.plan.periodic == (True, True, False)
    assert not PX.periodic_supported(yper.plan)


# ---------------------------------------------------------------------------
# refusals and routes
# ---------------------------------------------------------------------------


def _kz_cell(mp, k, **kw):
    sim = mp.Simulation(
        cell_size=mp.Vector3(4, 2), resolution=8,
        sources=[mp.Source(mp.GaussianSource(1.0, fwidth=0.5), mp.Ez,
                           center=mp.Vector3())],
        boundary_layers=[mp.PML(0.5, direction=mp.X)], k_point=k, **kw)
    fl = sim.add_flux(1.0, 0.5, 3, mp.FluxRegion(
        center=mp.Vector3(1.2, 0), size=mp.Vector3(0, 2)))
    return sim, fl


@pytest.mark.parametrize("case", ["special-kz"])
def test_complex_fields_are_refused(case):
    """A 2D cell with k along z (special_kz), which the port refused until
    the stepper carried the out-of-plane coupling, now runs: complex
    fields (native on the CPU) with every component live, 93 steps,
    get_array(Ez), get_array(Ex) (driven only through beta) and the
    fluxes equal the JAX package's to 1e-4 of their maximum."""
    out = []
    for mp, kw in ((mnt, {}), (mtt, {"device": "cpu"})):
        sim, fl = _kz_cell(mp, mp.Vector3(0, 0, 0.3), **kw)
        sim.run(until=93 * sim.dt)
        out.append((np.asarray(sim.get_array(mp.Ez)),
                    np.asarray(sim.get_array(mp.Ex)),
                    np.asarray(sim.get_fluxes(fl)), sim))
    (ea, xa, fa, _), (eb, xb, fb, sim) = out
    assert sim.plan.complex_fields and sim.plan.beta > 0
    assert np.abs(xb).max() > 1e-3 * np.abs(eb).max()
    _close(eb, ea, "ez")
    _close(xb, xa, "ex")
    _close(fb, fa, "flux")


def test_complex_phase_matches_jax():
    """The cell the port used to refuse, k = (0, 0.1): a complex phase on
    y, complex fields (native on the CPU), 93 steps: get_array(Ez) and the
    fluxes equal the JAX package's to 1e-4 of their maximum."""
    out = []
    for mp, kw in ((mnt, {}), (mtt, {"device": "cpu"})):
        sim, fl = _kz_cell(mp, mp.Vector3(0, 0.1), **kw)
        sim.run(until=93 * sim.dt)
        out.append((np.asarray(sim.get_array(mp.Ez)),
                    np.asarray(sim.get_fluxes(fl)), sim))
    (ea, fa, _), (eb, fb, sim) = out
    assert sim.plan.complex_fields and np.abs(eb.imag).max() > 0
    _close(eb, ea, "ez")
    _close(fb, fa, "flux")


def test_symmetries_with_k_point_are_refused():
    kw = dict(cell_size=mtt.Vector3(4, 2), resolution=8, device="cpu",
              boundary_layers=[mtt.PML(0.5, direction=mtt.X)])
    with pytest.raises(ValueError, match="rotational"):
        mtt.Simulation(symmetries=[mtt.Rotate2(mtt.Z)],
                       k_point=mtt.Vector3(), **kw)
    with pytest.raises(ValueError, match="Mirror"):
        mtt.Simulation(symmetries=[mtt.Mirror(mtt.Y)],      # wrapped
                       k_point=mtt.Vector3(), **kw)
    with pytest.raises(ValueError, match="Mirror"):
        mtt.Simulation(symmetries=[mtt.Mirror(mtt.X)],      # k.x != 0
                       k_point=mtt.Vector3(0.1), **kw)
    sim = mtt.Simulation(symmetries=[mtt.Mirror(mtt.X, phase=-1)],
                         k_point=mtt.Vector3(0, 0.25), **kw)
    assert sim._periodic() == (False, True)


def test_routes(monkeypatch):
    """2D and small 3D periodic plans run on the resident route; a 3D
    x-periodic plan above its budget on the hybrid route, through the
    ghost ring without monitors (a probed stretch of the ghost ring's plan
    on the stepper, as the reference's fused_probed_run needs a K1), with
    monitors through PeriodicXT2Kernel where the plan is linear (d // 2
    K2 calls and d % 2 K1 steps a cycle of d steps) and K1's x wrap where
    it is dispersive; a 3D plan periodic on y above the budget, and a 1D
    one, on the eager stepper.
    No route raises on a real phase."""
    def routes(sim, steps=5):
        sim.run(until=steps * sim.dt)
        return dict(sim.routes)

    src = [mtt.Source(mtt.GaussianSource(1.0, fwidth=0.5), mtt.Ez,
                      center=mtt.Vector3(0.1))]
    s2 = mtt.Simulation(cell_size=mtt.Vector3(2, 2), resolution=8,
                        sources=src, k_point=mtt.Vector3(0.25, 0),
                        device="cpu")
    assert routes(s2) == {"resident": 1}
    s3, _ = flagship3d(mtt, 0.0, flux=False, device="cpu")
    assert routes(s3) == {"resident": 1}
    monkeypatch.setattr(R, "VMEM_BUDGET", 0)
    s3, _ = flagship3d(mtt, 1 / 6, flux=False, device="cpu")
    assert routes(s3) == {"hybrid": 1}
    ker = s3.plan._t2_kernel
    assert isinstance(ker, PX.PeriodicGhostT2Kernel) and ker.k3 is not None
    assert HY.hybrid_routes(s3.plan) == {"no_sample": 1}
    # a probed stretch: the ghost ring has no K1, so the stepper runs it
    s3.routes.clear()
    s3.run(mtt.FieldProbe(mtt.Ez, mtt.Vector3(0.2)), until=5 * s3.dt)
    assert dict(s3.routes) == {"eager": 1}
    s3, _ = flagship3d(mtt, 1 / 6, device="cpu")
    assert routes(s3) == {"hybrid": 1}
    assert isinstance(s3.plan._t2_kernel, HY._K1Adapter)
    assert isinstance(s3.plan._t2_kernel._k1, PX.PeriodicXKernel)
    assert HY.hybrid_routes(s3.plan) == {"full_state": 1}
    for kx in (0.0, 1 / 6):
        s3, _ = flagship3d(mtt, kx, linear=True, device="cpu")
        assert routes(s3, 21) == {"hybrid": 1}
        ker = s3.plan._t2_kernel
        assert isinstance(ker, PX.PeriodicXT2Kernel) and ker.k3 is None
        assert HY.hybrid_routes(s3.plan) == {"full_state": 1}
        prefix, d, ncyc, suffix = HY.cycle_structure(s3.plan, 0, 21)
        assert d >= 2 and ncyc >= 1
        assert ker.plain_steps == ncyc * 2 * (d // 2)
        assert ker._k1.plain_steps == ncyc * (d % 2)
    s3, _ = flagship3d(mtt, 0.0, flux=False, device="cpu")
    s3.k_point = mtt.Vector3(0, 0.2)
    assert routes(s3) == {"eager": 1}
    s1 = mtt.Simulation(cell_size=mtt.Vector3(0, 0, 4), resolution=8,
                        sources=[mtt.Source(mtt.GaussianSource(
                            1.0, fwidth=0.5), mtt.Ex,
                            center=mtt.Vector3())],
                        k_point=mtt.Vector3(), device="cpu")
    assert routes(s1) == {"eager": 1}
