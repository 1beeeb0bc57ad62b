"""The DFT monitor family through meep_nl_tpu (the JAX package, on the CPU
its jnp stepper) and meep_nl_tpu_torch(device="cpu"), from the same
scenes: `add_dft_fields` / `get_dft_array` (mirrors the reference's
test_sim_methods.py), the flux normalization recipe `get_flux_data` /
`load_minus_flux_data` (test_flux.py), energy (test_energy.py), force
(test_force_ldos.py::test_radiation_pressure_on_mirror), LDOS with an E and
with an H source (test_force_ldos.py:58,78), near2far in 2D and 3D
(test_near2far.py:9,147), `get_epsilon` / `get_mu`.  Each output agrees
to 1e-4 of its own maximum (fp32; the two round in different orders).
The runs' lengths are not multiples of 4 steps, which the JAX package's
run would unroll 4 times (a compile several times longer).
Each feature is compared with the JAX package once, on one of three small
scenes that a module fixture runs once per package (2D 60x50, 2D TE
60x50 with a mu block, 3D 24x20x20); the routes are held against the
port's own eager stepper (itself held against JAX) to 1e-5: the hybrid
capture route, the hybrid full-state cycle, the resident route with
complex (LDOS) weights, and the use_pallas step (K5).  What the port does
not run yet raises NotImplementedError naming its ROADMAP item."""

import numpy as np
import pytest
import torch

import meep_nl_tpu as mnt
import meep_nl_tpu_torch as mtt
from meep_nl_tpu.analysis import near2far as JN
from meep_nl_tpu_torch.analysis import near2far as TN
from meep_nl_tpu_torch.ops import hybrid as HY
from meep_nl_tpu_torch.ops import resident as R
from meep_nl_tpu_torch.stepper import step as TS

from test_torch_fused import make_sim as fused_sim
from test_torch_hybrid import assert_close, make_sim as hybrid_sim, \
    plain_steps, random_state

torch.set_num_threads(2)


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    assert scale > 0, what
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * scale, f"{what}: {err:.3e} vs max {scale:.3e}"


# ---------------------------------------------------------------------------
# the scenes, run once per package
# ---------------------------------------------------------------------------


def _src(mp, comp, at, fcen=0.5, fwidth=0.4, amplitude=0.8 - 0.6j):
    """A Gaussian point source; its complex amplitude makes the LDOS
    weights conj(amplitude) complex in both parts."""
    return [mp.Source(mp.GaussianSource(fcen, fwidth=fwidth), comp,
                      center=at, amplitude=amplitude)]


def tm_runs(mp, **kw):
    """The flux normalization recipe in 2D (a 6x5 cell at resolution 10,
    PML 0.8, an Ez source): a vacuum run, then the same cell with an eps=12
    cylinder that loads the vacuum run's reflection data with its sign
    flipped, and carries every other monitor: dft fields, energy, an
    x-force plane, LDOS, a closed near2far box."""
    def sim_of(geometry):
        return mp.Simulation(cell_size=mp.Vector3(6, 5), resolution=10,
                             geometry=geometry,
                             sources=_src(mp, mp.Ez, mp.Vector3(-1.5, 0.1)),
                             boundary_layers=[mp.PML(0.8)], **kw)

    def fluxes(sim):
        return [sim.add_flux(0.5, 0.4, 5, mp.FluxRegion(
            center=mp.Vector3(x, 0), size=mp.Vector3(0, 3)))
            for x in (-1.0, 1.6)]

    norm = sim_of([])
    n_refl, n_tran = fluxes(norm)
    norm.run(until=24.95)                # 499 steps: not a multiple of 4
    sim = sim_of([mp.Cylinder(radius=0.5, center=mp.Vector3(0.3, 0),
                              material=mp.Medium(epsilon=12))])
    refl, tran = fluxes(sim)
    out = {"norm_refl": norm.get_fluxes(n_refl),
           "norm_tran": norm.get_fluxes(n_tran)}
    h = {"dftf": sim.add_dft_fields([mp.Ez, mp.Hy], 0.5, 0.4, 3,
                                    center=mp.Vector3(0.3, 0),
                                    size=mp.Vector3(1.6, 1.6)),
         "energy": sim.add_energy(0.5, 0.4, 3, mp.EnergyRegion(
             center=mp.Vector3(0.3, 0), size=mp.Vector3(1.4, 1.4))),
         "force": sim.add_force(0.5, 0.4, 3, mp.ForceRegion(
             center=mp.Vector3(1.0, 0), size=mp.Vector3(0, 2),
             direction=mp.X)),
         "ldos": sim.add_ldos(0.5, 0.4, 3),
         "n2f": sim.add_near2far(0.5, 0.4, 3, *[
             mp.Near2FarRegion(center=c, size=s, weight=w)
             for c, s, w in ((mp.Vector3(1.2, 0), mp.Vector3(0, 2.4), 1),
                             (mp.Vector3(-1.2, 0), mp.Vector3(0, 2.4), -1),
                             (mp.Vector3(0, 1.2), mp.Vector3(2.4, 0), 1),
                             (mp.Vector3(0, -1.2), mp.Vector3(2.4, 0), -1))])}
    sim.load_minus_flux_data(refl, norm.get_flux_data(n_refl))
    sim.run(until=24.95)
    out.update(
        refl=sim.get_fluxes(refl), tran=sim.get_fluxes(tran),
        ez=sim.get_dft_array(h["dftf"], mp.Ez),
        hy=sim.get_dft_array(h["dftf"], mp.Hy, 1),
        dft_data=sim.get_dft_data(h["dftf"]),
        e_energy=sim.get_electric_energy(h["energy"]),
        h_energy=sim.get_magnetic_energy(h["energy"]),
        energy=mp.get_total_energy(h["energy"]),
        force=mp.get_forces(h["force"]),
        ldos=sim.get_ldos(h["ldos"]),
        far=np.stack([sim.get_farfield(h["n2f"], mp.Vector3(*p))
                      for p in ((8, 3), (-6, 5))]),
        eps=sim.get_epsilon())
    return out, sim, h


def te_run(mp, **kw):
    """An Hz source in 2D (TE) beside a block with eps = 2 and mu = 3:
    the LDOS of a magnetic source (dft_ldos.cpp's H branch) and get_mu.
    The port runs it with use_fused=False: the eager stepper's
    accumulator layout (the resident route's is frequency-major)."""
    sim = mp.Simulation(
        cell_size=mp.Vector3(6, 5), resolution=10,
        geometry=[mp.Block(size=mp.Vector3(1, 1, mp.inf),
                           center=mp.Vector3(0.5, 0),
                           material=mp.Medium(epsilon=2, mu=3))],
        sources=_src(mp, mp.Hz, mp.Vector3(-1.1, 0.2)),
        boundary_layers=[mp.PML(0.8)], **kw)
    ldos = sim.add_ldos(0.5, 0.4, 4)
    sim.run(until=15.05)
    assert mp.get_ldos_freqs(ldos) == list(np.linspace(0.3, 0.7, 4))
    return {"ldos": sim.get_ldos(ldos), "mu": sim.get_mu(),
            "eps": sim.get_epsilon(), "routes": getattr(sim, "routes", None)}


def n2f3d_run(mp, **kw):
    """A closed 6-face near2far box around an Ez point source in 3D (a
    3x2.5x2.5 cell at resolution 8, PML 0.5), far fields at the 4 points
    of a get_farfields grid; and a z-normal dft_fields plane."""
    sim = mp.Simulation(cell_size=mp.Vector3(3, 2.5, 2.5), resolution=8,
                        sources=_src(mp, mp.Ez, mp.Vector3(0.05, 0.02, 0),
                                     fcen=1.0, fwidth=0.5),
                        boundary_layers=[mp.PML(0.5)], **kw)
    faces = []
    for ax in range(3):
        for sgn in (1, -1):
            c, s = [0.0] * 3, [1.2] * 3
            c[ax], s[ax] = 0.6 * sgn, 0.0
            faces.append(mp.Near2FarRegion(center=mp.Vector3(*c),
                                           size=mp.Vector3(*s), weight=sgn))
    n2f = sim.add_near2far(1.0, 0.5, 2, *faces)
    dftf = sim.add_dft_fields([mp.Ez], 1.0, 0.5, 2, center=mp.Vector3(),
                              size=mp.Vector3(1.5, 1.5, 0))
    sim.run(until=8.0625)
    return {"far": sim.get_farfields(n2f, 1, center=mp.Vector3(10, 0, 0),
                                     size=mp.Vector3(0, 1, 1)),
            "ez": sim.get_dft_array(dftf, mp.Ez)}


@pytest.fixture(scope="module")
def tm():
    return (tm_runs(mnt)[0], tm_runs(mtt, device="cpu"))


@pytest.fixture(scope="module")
def te():
    return te_run(mnt), te_run(mtt, device="cpu", use_fused=False)


@pytest.fixture(scope="module")
def n2f3d():
    return n2f3d_run(mnt), n2f3d_run(mtt, device="cpu")


# ---------------------------------------------------------------------------
# against the JAX package, once per feature
# ---------------------------------------------------------------------------


def test_flux_normalization_matches_jax(tm):
    want, (got, sim, _) = tm
    assert sim.routes == {"resident": 1}
    for k in ("norm_refl", "norm_tran", "refl", "tran"):
        _close(got[k], want[k], k)
    # the scattered field's reflection is far below the incident flux
    assert np.abs(want["refl"]).max() < 0.5 * np.abs(want["norm_tran"]).max()


def test_dft_fields_match_jax(tm):
    want, (got, _, _) = tm
    assert got["ez"].shape == want["ez"].shape == (18, 18, 3)
    for k in ("ez", "hy", "dft_data"):
        _close(got[k], want[k], k)


def test_energy_matches_jax(tm):
    want, (got, _, _) = tm
    for k in ("e_energy", "h_energy", "energy"):
        _close(got[k], want[k], k)
    _close(got["e_energy"] + got["h_energy"], got["energy"], "sum")


def test_force_matches_jax(tm):
    want, (got, _, _) = tm
    _close(got["force"], want["force"], "force")


@pytest.mark.parametrize("source", ["e", "h"])
def test_ldos_matches_jax(source, tm, te):
    want, got = (tm[0], tm[1][0]) if source == "e" else te
    assert source == "e" or got["routes"] == {"eager": 1}
    _close(got["ldos"], want["ldos"], "ldos")
    assert np.all(np.isfinite(got["ldos"]))


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_near2far_matches_jax(dim, tm, n2f3d):
    want, got = (tm[0], tm[1][0]) if dim == "2d" else n2f3d
    assert got["far"].shape == want["far"].shape
    _close(got["far"], want["far"], "far fields")
    if dim == "3d":
        assert got["far"].shape == (6, 2, 1, 2, 2)
        _close(got["ez"], want["ez"], "ez plane")


def test_epsilon_and_mu_match_jax(tm, te):
    _close(tm[1][0]["eps"], tm[0]["eps"], "eps")
    assert tm[1][0]["eps"].max() == pytest.approx(12.0)
    want, got = te
    for k in ("eps", "mu"):
        _close(got[k], want[k], k)
    assert got["mu"].max() == pytest.approx(3.0)


def test_flux_data_round_trips(tm, tmp_path):
    """get_flux_data / load_flux_data and the .npz forms (save_flux,
    load_flux, load_minus_flux) work on the state's accumulators."""
    _, (_, sim, h) = tm
    data = sim.get_force_data(h["force"])
    assert data and all(torch.is_tensor(t) for t in data.values())
    before = sim.get_forces(h["force"])
    sim.save_force(str(tmp_path / "f"), h["force"])
    sim.load_minus_force(str(tmp_path / "f.npz"), h["force"])
    assert np.abs(sim.get_forces(h["force"])).max() == 0
    sim.load_force(str(tmp_path / "f"), h["force"])
    np.testing.assert_array_equal(sim.get_forces(h["force"]), before)
    sim.load_minus_flux_data(h["force"], data)
    sim.load_flux_data(h["force"], data)
    np.testing.assert_array_equal(sim.get_forces(h["force"]), before)


def test_flux_data_loads_across_monitor_numbers():
    """The normalization recipe when the second run numbers its monitors
    differently (an add_dft_fields first, so its flux monitor is "flux1",
    the normalization run's "flux0"): load_minus_flux_data matches a
    snapshot's keys by what follows the monitor's name, so the reflected
    fluxes equal those of a second run whose monitor has the same name
    (ROADMAP C.2; the reference matches whole keys, C.3 item 3)."""
    def sim_of(extra):
        sim = mtt.Simulation(cell_size=mtt.Vector3(6, 5), resolution=10,
                             sources=_src(mtt, mtt.Ez,
                                          mtt.Vector3(-1.5, 0.1)),
                             boundary_layers=[mtt.PML(0.8)], device="cpu")
        if extra:
            sim.add_dft_fields([mtt.Ez], 0.5, 0.4, 1, center=mtt.Vector3(),
                               size=mtt.Vector3(1, 1))
        refl = sim.add_flux(0.5, 0.4, 3, mtt.FluxRegion(
            center=mtt.Vector3(-1.0, 0), size=mtt.Vector3(0, 3)))
        return sim, refl

    norm, n_refl = sim_of(False)
    norm.run(until=10.05)
    data = norm.get_flux_data(n_refl)
    out = {}
    for extra in (False, True):
        sim, refl = sim_of(extra)
        assert refl.name == ("flux1" if extra else "flux0")
        sim.load_minus_flux_data(refl, data)
        sim.run(until=10.05)
        out[extra] = sim.get_fluxes(refl)
    np.testing.assert_array_equal(out[True], out[False])
    # the incident flux is subtracted: what is left is far below it
    assert np.abs(out[True]).max() < 1e-2 * np.abs(norm.get_fluxes(
        n_refl)).max()


# ---------------------------------------------------------------------------
# the routes against the port's eager stepper
# ---------------------------------------------------------------------------


def monitored(scene, kinds, dec=0):
    """test_torch_hybrid's 32x12x12 cell with the monitors `kinds` beside
    its flux plane: "planes" (LDOS, an x-normal near2far plane: few
    x-planes, complex and uncentred) or "full" (an energy box: D and B
    components; an x-normal force plane; a z-normal dft_fields plane that
    spans every x-plane; the last two decimated by `dec`)."""
    sim, _ = hybrid_sim(mtt, scene, device="cpu")
    mp = mtt
    if "planes" in kinds:
        sim.add_ldos(1.0, 0.4, 2)
        sim.add_near2far(1.0, 0.4, 2, mp.Near2FarRegion(
            center=mp.Vector3(0.375, 0, 0), size=mp.Vector3(0, 0.6, 0.6)))
    if "full" in kinds:
        sim.add_energy(1.0, 0.4, 2, mp.EnergyRegion(
            center=mp.Vector3(), size=mp.Vector3(1, 0.6, 0.6)),
            decimation_factor=dec)
        sim.add_force(1.0, 0.4, 2, mp.ForceRegion(
            center=mp.Vector3(0.6, 0, 0), size=mp.Vector3(0, 0.8, 0.8),
            direction=mp.Y))
        sim.add_dft_fields([mp.Ez], 1.0, 0.4, 2, center=mp.Vector3(),
                           size=mp.Vector3(3, 1, 0), decimation_factor=dec)
    sim.init_sim()
    return sim.plan


#: route -> (scene, monitors, decimation of the "full" ones, plain steps
#: the kernels take over 7 steps from step 3; `hybrid_routes` is the
#: route's name)
MONITORED = {
    # d = 1, planes only: 2 capture supercycles of 3, then 1 K1 step
    "capture": ("flagship", "planes", 0, {"cap_d3": 6, "k1": 1}),
    # D/B and a plane across every x: the full-state DTFT after each K1
    # step (d = 1)
    "full-cycle": ("flagship", "planes+full", 0, {"k1": 7}),
    # the flux plane samples every 4th step, the energy and dft fields
    # every 3rd, the force every step: no uniform cycle, so every step is
    # a cycle of one (K1, then the full-state DTFT)
    "mixed-decimation": ("linear", "full", 3, {"k1": 7}),
}


@pytest.mark.parametrize("route", sorted(MONITORED))
def test_monitored_hybrid_routes_match_eager(route):
    scene, kinds, dec, want_plain = MONITORED[route]
    plan = monitored(scene, kinds, dec)
    assert (HY._dft_plane_meta(plan) is None) == ("full" in kinds)
    assert any(f"dft{mi}:wre" in plan.coefs for mi in range(len(plan.dfts))) \
        == ("planes" in kinds)
    st0 = random_state(plan, 5)
    got = HY.hybrid_run(plan, dict(st0), 7, 3)
    want = TS.run(plan, dict(st0), 7, t0=3)
    assert plain_steps(plan) == want_plain
    assert HY.hybrid_routes(plan) == {
        "capture" if route == "capture" else "full_state": 1}
    assert_close(got, want)
    assert all(float(t.abs().max()) > 0 for t in want["dft"].values())


def test_resident_route_with_complex_weights_matches_eager():
    """A 2D plan with LDOS (complex, uncentred), energy (D/B) and dft
    fields is inside the resident envelope; K3's plain version (the eager
    stepper over the frequency-major resident plan) equals the eager
    stepper on the plan."""
    sim = mtt.Simulation(cell_size=mtt.Vector3(6, 5), resolution=10,
                         sources=_src(mtt, mtt.Ez, mtt.Vector3(-1.5, 0.1)),
                         boundary_layers=[mtt.PML(0.8)], device="cpu")
    sim.add_ldos(0.5, 0.4, 3)
    sim.add_energy(0.5, 0.4, 2, mtt.EnergyRegion(center=mtt.Vector3(),
                                                 size=mtt.Vector3(1, 1)))
    sim.init_sim()
    plan = sim.plan
    assert any(k.endswith(":wre") for k in plan.coefs)
    assert R.resident_supported(plan)
    st0 = random_state(plan, 7)
    got, _ = R.resident_ref(plan)(dict(st0), 11, 4)
    want = TS.run(plan, dict(st0), 11, t0=4)
    assert_close(got, want)


def test_use_pallas_step_with_monitors_matches_eager():
    """Simulation(use_pallas=True): K5 (its plain version here) steps the
    plan and `_dft_update` accumulates the monitors after each step as the
    eager stepper does, LDOS (complex weights), energy (D/B) and near2far
    (uncentred) beside the flux plane."""
    sims = []
    for pallas in (True, False):
        sim, _ = fused_sim(mtt, use_pallas=pallas, use_fused=False,
                           device="cpu")
        sim.add_ldos(1.0, 0.4, 2)
        sim.add_energy(1.0, 0.4, 2, mtt.EnergyRegion(
            center=mtt.Vector3(), size=mtt.Vector3(0.5, 0.5, 0.5)))
        sim.add_near2far(1.0, 0.4, 2, mtt.Near2FarRegion(
            center=mtt.Vector3(0.25, 0, 0), size=mtt.Vector3(0, 0.5, 0.5)))
        sim.run(until=7 * sim.dt)
        sims.append(sim)
    assert dict(sims[0].routes) == {"half_step": 1}
    assert dict(sims[1].routes) == {"eager": 1}
    assert sims[0].plan._fused_kernels["b"].plain_steps == 7
    got, want = sims[0].fields_state, sims[1].fields_state
    scale = max(float(t.abs().max()) for t in want["f"].values())
    for c, t in want["f"].items():
        assert float((got["f"][c] - t).abs().max()) <= 1e-5 * scale, c
    # each accumulator to 1e-5 of its monitor's largest (the Hz and Bz of
    # the energy box are round-off: an Ez dipole in vacuum makes none)
    for k, t in want["dft"].items():
        mon = k.split(":")[0]
        top = max(float(v.abs().max()) for kk, v in want["dft"].items()
                  if kk.split(":")[0] == mon)
        assert float((got["dft"][k] - t).abs().max()) <= 1e-5 * top, k
        assert top > 0, k


# ---------------------------------------------------------------------------
# what the port refuses, and the near2far module against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,item", [("nperiods", "A9"),
                                       ("symmetries", "complex fields"),
                                       ("cylindrical", "A9")],
                         ids=["nperiods-A8", "symmetries-A5",
                              "cylindrical-A9"])
def test_unported_monitor_features_raise(case, item):
    """What the port refuses: the +-i irreps of a C4 fold.  Lattice images
    at a complex phase (nperiods with k = (0, 0.1)) ran into the
    complex-fields refusal until complex fields were ported; they now run
    on complex fields, and the far field with its complex per-period
    phases equals the JAX package's to 1e-4 of its maximum (47 steps).
    Cylindrical cells (test_near2far's cylindrical cases) were refused
    until they were ported; an on-axis dipole's far field through the
    port's greencyl (m = 0, a side and two caps) now equals the JAX
    package's to 1e-4 of its maximum at three angles (47 steps)."""
    kw = dict(cell_size=mtt.Vector3(4, 4), resolution=8)
    if case == "nperiods":
        far = []
        for mp, dev in ((mnt, {}), (mtt, {"device": "cpu"})):
            sim = mp.Simulation(k_point=mp.Vector3(0, 0.1),
                                sources=_src(mp, mp.Ez, mp.Vector3()),
                                **kw, **dev)
            n2f = sim.add_near2far(
                0.5, 0.2, 1, mp.Near2FarRegion(
                    center=mp.Vector3(1, 0), size=mp.Vector3(0, 4)),
                nperiods=3)
            sim.run(until=47 * sim.dt)
            far.append(np.asarray(sim.get_farfield(n2f, mp.Vector3(8, 1))))
        assert sim.plan.complex_fields
        assert np.abs(far[1].imag).max() > 0
        _close(far[1], far[0], "far field")
        return
    if case == "cylindrical":
        far = []
        for mp, dev in ((mnt, {}), (mtt, {"device": "cpu"})):
            sim = mp.Simulation(cell_size=mp.Vector3(2, 0, 3), resolution=8,
                                dimensions=-2, m=0,
                                boundary_layers=[mp.PML(0.5)],
                                sources=_src(mp, mp.Ez, mp.Vector3()), **dev)
            n2f = sim.add_near2far(
                0.5, 0.2, 1,
                mp.Near2FarRegion(center=mp.Vector3(1, 0, 0),
                                  size=mp.Vector3(0, 0, 1.6), weight=+1),
                mp.Near2FarRegion(center=mp.Vector3(0.5, 0, 0.8),
                                  size=mp.Vector3(1, 0, 0), weight=+1),
                mp.Near2FarRegion(center=mp.Vector3(0.5, 0, -0.8),
                                  size=mp.Vector3(1, 0, 0), weight=-1))
            sim.run(until=47 * sim.dt)
            far.append(np.array([np.asarray(sim.get_farfield(
                n2f, mp.Vector3(50 * np.sin(th), 0, 50 * np.cos(th))))
                for th in (0.5, 1.2, 2.2)]))
        assert np.abs(far[1]).max() > 0
        _close(far[1], far[0], "far field")
        return
    kw.update(sources=_src(mtt, mtt.Ez, mtt.Vector3()), device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        # the +-i irreps of a C4 fold
        mtt.Simulation(symmetries=[mtt.Rotate4(mtt.Z, phase=1j)], **kw)


def test_near2far_module_matches_reference():
    """The port's copy of analysis/near2far.py: the Green's functions (3D,
    2D, cylindrical) and farfield with lattice images and mirror images,
    on seeded surfaces, equal the reference's."""
    rng = np.random.default_rng(11)
    pts = rng.uniform(-1, 1, (7, 3))
    x = np.array([5.0, -3.0, 2.0])
    f0 = rng.standard_normal(7) + 1j * rng.standard_normal(7)
    for c0 in ("ex", "ey", "hz", "hx"):
        np.testing.assert_array_equal(
            TN.green3d(x, 0.7, 1.5, 1.0, pts, c0, f0),
            JN.green3d(x, 0.7, 1.5, 1.0, pts, c0, f0))
        np.testing.assert_array_equal(
            TN.green2d(x[:2], 0.7, 1.0, 1.0, pts[:, :2], c0, f0),
            JN.green2d(x[:2], 0.7, 1.0, 1.0, pts[:, :2], c0, f0))
        np.testing.assert_array_equal(
            TN.greencyl_w(x[[0, 2]], 0.7, 1.0, 1.0, np.abs(pts[:, [0, 2]]),
                          c0, 1),
            JN.greencyl_w(x[[0, 2]], 0.7, 1.0, 1.0, np.abs(pts[:, [0, 2]]),
                          c0, 1))
    for normal in "xyz":
        assert TN.equivalence_terms(normal) == JN.equivalence_terms(normal)
    dft = rng.standard_normal((7, 2, 2)).astype(np.float32)
    surfs = [(TN, JN)[i].Near2FarSurface("hy", pts, "n") for i in (0, 1)]
    kw = dict(periodic=[(1, 2, 0.3, 2.0)], mirrors=[(2, "z", -1)])
    np.testing.assert_array_equal(
        TN.farfield([surfs[0]], {"dft": {"n": torch.from_numpy(dft)}},
                    [0.5, 0.8], x, "3d", **kw),
        JN.farfield([surfs[1]], {"dft": {"n": dft}}, [0.5, 0.8], x, "3d",
                    **kw))
