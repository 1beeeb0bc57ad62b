"""The hybrid driver (meep_nl_tpu_torch/ops/hybrid.py) on the CPU, where
every kernel wrapper runs its plain version: its cycle decomposition against
the reference's arithmetic, its K2, capture and K1-adapter routes against
the port's eager stepper (state and DTFT accumulators to 1e-5) and, once
each, against the JAX package's Simulation (fluxes and fields to 1e-4 of
their maximum, as test_torch_simulation does), with the kernels' counters
showing which route ran."""

import numpy as np
import pytest
import torch

import meep_nl_tpu as mnt
import meep_nl_tpu_torch as mtt
from meep_nl_tpu_torch.ops import fdtd3d_t2 as T2
from meep_nl_tpu_torch.ops import hybrid as HY
from meep_nl_tpu_torch.stepper import step as TS

from test_torch_fdtd3d_t2_gpu import _random_state as random_state

torch.set_num_threads(2)


def reference_decomposition(d, has_k3):
    """meep_nl_tpu/ops/pallas/hybrid.py:566-580, verbatim arithmetic."""
    if has_k3 and d >= 3:
        r3 = d % 3
        if r3 == 0:
            n3, npair, rem = d // 3, 0, 0
        elif r3 == 2:
            n3, npair, rem = d // 3, 1, 0
        else:
            n3, npair, rem = (d - 4) // 3, 2, 0
    else:
        n3 = 0
        npair = d // 2
        rem = d % 2
    return n3, npair, rem


@pytest.mark.parametrize("has_k3", [True, False], ids=["k3", "no-k3"])
@pytest.mark.parametrize("d", range(1, 10))
def test_decomposition_matches_reference(d, has_k3):
    n3, npair, rem = HY.decompose(d, has_k3)
    assert (n3, npair, rem) == reference_decomposition(d, has_k3)
    assert 3 * n3 + 2 * npair + rem == d
    assert min(n3, npair, rem) >= 0 and rem <= 1
    assert has_k3 or n3 == 0


def make_sim(mp, scene, lx=4.0, flux_x=1.0625, **kw):
    """A 32x12x12 cell (4x1.5x1.5 at resolution 8; x storage 40 planes, so
    the flux monitors' x-planes have their plane form), PML 0.25 on every
    face, a Gaussian Ez point source and an x-normal flux plane on a lattice
    plane, both outside the PML.  scene: "flagship" (eps=4 ball, Lorentz
    pole, full-tensor chi2: DTFT decimation off, d = 1), "linear" (the
    eps=4 ball alone: d = 4) or "vacuum"."""
    geometry = []
    if scene != "vacuum":
        med = mp.Medium(epsilon=4.0) if scene == "linear" else mp.Medium(
            epsilon=4.0, chi2=0.05, chi2_full_tensor=True,
            E_susceptibilities=[mp.LorentzianSusceptibility(
                frequency=2.0, gamma=0.05, sigma=0.2)])
        geometry = [mp.Sphere(0.4, material=med)]
    sim = mp.Simulation(
        cell_size=mp.Vector3(lx, 1.5, 1.5), resolution=8, geometry=geometry,
        sources=[mp.Source(mp.GaussianSource(1.0, fwidth=1.0),
                           component=mp.Ez,
                           center=mp.Vector3(-0.25 * lx, 0.02, 0))],
        boundary_layers=[mp.PML(0.25)], eps_averaging=False, **kw)
    flux = sim.add_flux(1.0, 0.4, 3, mp.FluxRegion(
        center=mp.Vector3(flux_x, 0, 0), size=mp.Vector3(0, 0.8, 0.8)),
        decimation_factor=4 if scene == "linear" else 0)
    return sim, flux


def plain_steps(plan):
    """{label: steps its plain version took} of the plan's kernel objects."""
    ker = plan._t2_kernel
    out = {"k1": ker._k1.plain_steps}
    if isinstance(ker, T2.Fdtd3dT2Kernel):
        out["k2_d2"] = ker.plain_steps
        out["k2_d3"] = ker.k3.plain_steps if ker.k3 is not None else 0
    for (depth, _), capker in plan.__dict__.get("_cap_kernels", {}).items():
        assert capker.launches == 0
        out[f"cap_d{depth}"] = out.get(f"cap_d{depth}", 0) + capker.plain_steps
    return {k: v for k, v in out.items() if v}


def assert_close(got, want, tol=1e-5):
    scale = max(float(t.abs().max()) for t in want["f"].values())
    for key in ("f", "f_u", "f_w", "dft"):
        for c, w in want[key].items():
            ref = scale if key != "dft" else max(float(w.abs().max()), 1e-30)
            err = float((got[key][c] - w).abs().max()) / ref
            assert err <= tol, f"{key}[{c}]: {err:.3e}"
    for eg, ew in zip(got["pol"], want["pol"]):
        for k in ("p", "pp"):
            for c, w in ew[k].items():
                assert float((eg[k][c] - w).abs().max()) <= tol * scale
    assert int(got["t"]) == int(want["t"])


#: route -> (scene, force the K1 adapter, t0, nsteps, expected plain steps)
ROUTES = {
    # d = 1: 47 = 15 supercycles of 3 through the capture kernel + 2 K1
    "capture": ("flagship", False, 5, 47, {"cap_d3": 45, "k1": 2}),
    # d = 4 from t0 = 5: prefix 3 and suffix 1 eager, 10 cycles of 2 + 2
    "cycles_d4": ("linear", False, 5, 44, {"k2_d2": 40}),
    # a plan K2 declines: K1 behind the two-step adapter
    "k1_adapter": ("linear", True, 5, 44, {"k1": 40}),
    "k1_adapter_d1": ("flagship", True, 0, 10, {"k1": 10}),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_hybrid_run_matches_eager(route, monkeypatch):
    scene, adapter, t0, nsteps, want_plain = ROUTES[route]
    if adapter:
        monkeypatch.setattr(T2, "supported", lambda plan, depth=2: False)
    sim, _ = make_sim(mtt, scene, device="cpu")
    plan = sim.plan
    st0 = random_state(plan, 3)
    assert HY.hybrid_run(plan, dict(st0), 3, t0) is None   # too short
    got = HY.hybrid_run(plan, dict(st0), nsteps, t0)
    want = TS.run(plan, dict(st0), nsteps, t0=t0)
    assert plain_steps(plan) == want_plain
    assert plan.slab_opt
    assert isinstance(plan._t2_kernel, HY._K1Adapter) == adapter
    assert_close(got, want)
    assert any(float(t.abs().max()) > 0 for t in want["dft"].values())


def test_nosample_route_without_monitor():
    """No monitor at all: the deepest kernel over nsteps // 3 calls, the
    remainder through K1 (hybrid.py:515-559)."""
    sim = mtt.Simulation(
        cell_size=mtt.Vector3(2, 1.5, 1.5), resolution=8,
        sources=[mtt.Source(mtt.GaussianSource(1.0, fwidth=1.0),
                            component=mtt.Ez, center=mtt.Vector3())],
        boundary_layers=[mtt.PML(0.25)], device="cpu")
    sim.init_sim()
    plan = sim.plan
    st0 = random_state(plan, 4)
    got = HY.hybrid_run(plan, dict(st0), 17, 100)
    assert plain_steps(plan) == {"k2_d3": 15, "k1": 2}
    assert_close(got, TS.run(plan, dict(st0), 17, t0=100))


def test_capture_kernels_are_keyed_by_their_planes():
    """Two sets of capture planes on one plan are two kernels (the
    reference's cache key leaves the planes out)."""
    sim, _ = make_sim(mtt, "flagship", device="cpu")
    plan = sim.plan
    a = HY._capture_kernel(plan, 3, [("ey", 24), ("hz", 24)])
    b = HY._capture_kernel(plan, 3, [("ey", 25), ("hz", 24)])
    assert a is not b and a.cap_planes != b.cap_planes
    assert HY._capture_kernel(plan, 3, [("ey", 24), ("hz", 24)]) is a
    assert HY._capture_kernel(plan, 2, [("ey", 24), ("hz", 24)]).depth == 2
    assert len(plan._cap_kernels) == 3
    assert a._k1 is b._k1 is T2.k1_of(plan)


def test_plane_meta_and_plane_values():
    """The plane form of the flux monitors, and the DTFT values read
    through it equal the eager region read bit for bit."""
    sim, _ = make_sim(mtt, "flagship", device="cpu")
    plan = sim.plan
    meta = HY._dft_plane_meta(plan)
    assert meta is not None and len(meta) == len(plan.dfts) == 4
    assert all(x1e - x0 <= 2 for (_, x0, x1e, _, _) in meta)
    st = random_state(plan, 6)
    for mi, m in enumerate(plan.dfts):
        want = TS._region_values(plan, m, st["f"][m.component])
        got = HY._fv_planes(plan, st, meta[mi])
        assert torch.equal(got, want), m.component
    # a short cell whose off-lattice flux plane reads 10 x-planes of 24:
    # no plane form (the full-state read serves as well), nor for a
    # periodic plan
    short, _ = make_sim(mtt, "vacuum", lx=2.0, flux_x=0.6, device="cpu")
    assert HY._dft_plane_meta(short.plan) is None
    plan.periodic = (True, False, False)
    assert HY._dft_plane_meta(plan) is None


def _close(got, want, what, scale=None):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    scale = scale or float(np.abs(np.asarray(want)).max())
    assert scale > 0, what
    assert err <= 1e-4 * scale, f"{what}: {err:.3e} vs max {scale:.3e}"


@pytest.mark.parametrize("scene", ["flagship", "linear"])
def test_simulation_routes_match_jax(scene):
    """Simulation.run through the capture route (flagship) and the cycle
    route (linear) against the JAX package's Simulation."""
    sj, fj = make_sim(mnt, scene)
    st, ft = make_sim(mtt, scene, device="cpu")
    sj.init_sim()
    sj._plan.slab_opt = True            # the route the port follows
    peak = {}
    for until in (4.0, 2.0):
        sj.run(until=until)
        st.run(until=until)
        assert st._t == sj._t
        for c in ("ez", "hy"):
            want = sj.get_array(c)
            peak[c] = max(peak.get(c, 0.0), float(np.abs(want).max()))
            _close(st.get_array(c), want, c, peak[c])
    _close(st.get_fluxes(ft), sj.get_fluxes(fj), "flux")
    assert dict(st.routes) == {"hybrid": 2}
    plain = plain_steps(st.plan)
    if scene == "flagship":
        assert [m.decimation for m in st.plan.dfts] == [1] * 4
        assert plain["cap_d3"] >= st._t - 4 and "k2_d2" not in plain
    else:
        assert [m.decimation for m in st.plan.dfts] == [4] * 4
        assert plain["k2_d2"] >= st._t - 8 and "cap_d3" not in plain
    assert st._t == 96
