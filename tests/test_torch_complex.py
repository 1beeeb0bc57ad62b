"""Complex fields in the port (meep_nl_tpu_torch, device="cpu"): arbitrary
Bloch k, in native complex64 and in the real pair (a leading (re, im)
channel axis), against the JAX package's jnp stepper and against the
port's own stepper.

Held against the JAX package once per feature, on the cases of the JAX
package's tests/test_real_pair.py (2D oblique Bloch with a complex
amplitude, a DFT flux line and a probe with a complex weight; 3D with PML
on z; a dispersive Bloch cell), on stretches whose lengths are not
multiples of 4 (the JAX package's run unrolls those 4 times), in both of
the port's storages to 2e-6 of the field maximum, as there; then at
Simulation level: a 2D run_k_point at k = 0.25 (Harminv frequencies to
1e-6) and the storage rule.  Further cases hold the port's pair against
its native complex, and the plain versions of K3/K4's pair layout and of
both pair drivers (K1's pair wrap, the pair ghost ring) against the
port's eager pair stepper."""

import functools

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import meep_nl_tpu as mnt
import meep_nl_tpu_torch as mtt
from meep_nl_tpu.core import grid as JG
from meep_nl_tpu.stepper import plan as JP
from meep_nl_tpu.stepper import step as JS
from meep_nl_tpu_torch import interop
from meep_nl_tpu_torch.core import grid as TG
from meep_nl_tpu_torch.stepper import plan as TP
from meep_nl_tpu_torch.stepper import step as TS

torch.set_num_threads(2)

ATOL = 2e-6


# ---------------------------------------------------------------------------
# the eager stepper against the JAX package's
# ---------------------------------------------------------------------------


def _src(pk, G, gv, comp, pos, amp=1.0):
    mp = mnt if pk is JP else mtt
    pts = gv.interp_weights(comp, pos)
    return pk.SrcVolSpec(comp, np.array([p for p, w in pts], np.int32),
                         np.array([w * amp for p, w in pts], np.complex128),
                         mp.GaussianSource(frequency=0.8, fwidth=0.4))


def _plan(pk, case):
    """The case's plan compiled by package pk (the JAX package's or the
    port's plan module) from the same numpy inputs, complex fields."""
    G = JG if pk is JP else TG
    kw = {} if pk is JP else {"device": "cpu"}
    if case == "oblique":
        from meep_nl_tpu_torch.stepper import monitors as TM
        from meep_nl_tpu.stepper import monitors as JM
        M = JM if pk is JP else TM
        gv = G.GridVolume.create("2d", [2.0, 2.0], 10)
        dfts = M.flux_specs(gv, "fl", "x", [0.5, 0.0], [0.0, 1.0],
                            np.linspace(0.6, 1.0, 3))
        return pk.compile_plan(
            gv, pk.MaterialSpec(chi1inv={}),
            sources=[_src(pk, G, gv, "ez", [0.3, -0.2], 1 + 0.5j)],
            periodic=(True, True), bloch_k=(0.13, 0.31), dfts=dfts,
            complex_fields=True, **kw)
    if case == "pml_z":
        gv = G.GridVolume.create("3d", [1.5, 1.5, 2.0], 8)
        return pk.compile_plan(
            gv, pk.MaterialSpec(chi1inv={}),
            sources=[_src(pk, G, gv, "ex", [0.1, 0.0, -0.3])],
            periodic=(True, True, False), bloch_k=(0.2, 0.1, 0.0),
            pmls=[pk.PMLSpec("z", 0.5)], complex_fields=True, **kw)
    gv = G.GridVolume.create("2d", [2.0, 2.0], 10)
    sig = np.zeros(gv.shape)
    sig[5:12, 5:12] = 0.4
    pol = pk.PolSpec(field_type="e", omega0=1.5, gamma=0.1,
                     sigma={("ez", "z"): sig})
    return pk.compile_plan(
        gv, pk.MaterialSpec(chi1inv={}, pols=[pol]),
        sources=[_src(pk, G, gv, "ez", [0.3, -0.2])],
        periodic=(True, True), bloch_k=(0.11, 0.0), complex_fields=True,
        **kw)


NSTEPS = {"oblique": 29, "pml_z": 23, "dispersive": 39}
TOL = {"oblique": ATOL, "pml_z": ATOL, "dispersive": 5e-6}


#: per case a probe (component, points, weights); complex weights on
#: complex fields
PROBE = {"oblique": ("ez", [[11, 9]], [1.0 + 0.25j]),
         "pml_z": ("ex", [[3, 4, 5]], [1.0]),
         "dispersive": ("ez", [[7, 8], [8, 8]], [0.5 - 0.5j, 0.25])}


def _probes(pk_step, case):
    c, idx, w = PROBE[case]
    return (pk_step.ProbeSpec("p0", c, np.array(idx, np.int32),
                              np.array(w, np.complex128)),)


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """The JAX package's native complex run of the case (one compile)."""
    plan = _plan(JP, case)
    st, ys = JS.run(plan, JS.init_state(plan), NSTEPS[case], t0=0,
                    probes=_probes(JS, case))
    return (jax.tree_util.tree_map(np.asarray, st),
            {k: np.asarray(v) for k, v in ys.items()})


def _port_run(case, pair):
    plan = _plan(TP, case)
    plan.real_pair = pair
    return plan, TS.run(plan, TS.init_state(plan), NSTEPS[case], t0=0,
                        probes=_probes(TS, case))


def _as_complex(v, pair):
    v = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
    return v[0] + 1j * v[1] if pair else v


@pytest.mark.parametrize("pair", [False, True], ids=["native", "pair"])
@pytest.mark.parametrize("case", sorted(NSTEPS))
def test_stepper_matches_jax(case, pair):
    """Fields, auxiliaries, polarizations, DTFT accumulators and probe
    series of the port's stepper in either storage against the JAX
    package's native complex run, to 2e-6 of the field maximum (5e-6 for
    the dispersive case, as test_real_pair.py)."""
    want, ys_want = _jax_run(case)
    plan, (got, ys) = _port_run(case, pair)
    tol = TOL[case]
    f0 = next(iter(got["f"].values()))
    assert f0.dtype == (torch.float32 if pair else torch.complex64)
    assert f0.ndim == plan.gv.ndim + (1 if pair else 0)
    scale = max(float(np.abs(v).max()) for v in want["f"].values())
    assert scale > 0
    for key in ("f", "f_u", "f_w"):
        for c, w in want[key].items():
            g = _as_complex(got[key][c], pair)
            err = float(np.abs(g - w).max())
            assert err <= tol * scale, (key, c, err, scale)
    for pi, e in enumerate(want["pol"]):
        for k in ("p", "pp"):
            for c, w in e[k].items():
                g = _as_complex(got["pol"][pi][k][c], pair)
                assert float(np.abs(g - w).max()) <= tol * scale, (k, c)
    for name, w in want["dft"].items():
        g = got["dft"][name].numpy()
        assert g.dtype == np.float32
        assert float(np.abs(g - w).max()) <= tol * scale, name
    for name, w in ys_want.items():
        g = ys[name].numpy()
        g = g[:, 0] + 1j * g[:, 1] if pair else g
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= tol * scale, name


def test_pair_matches_native():
    """Inside the port the two storages agree to fp32 round-off, on the
    oblique case (the wrap rotation, the complex source, the DTFT of
    complex fields, complex probe weights)."""
    _, (na, ya) = _port_run("oblique", False)
    _, (pa, yp) = _port_run("oblique", True)
    scale = max(float(v.abs().max()) for v in na["f"].values())
    for c, v in na["f"].items():
        err = float(np.abs(_as_complex(pa["f"][c], True) - v.numpy()).max())
        assert err <= 1e-6 * scale, c
    for name, v in na["dft"].items():
        assert float((pa["dft"][name] - v).abs().max()) <= 1e-6 * scale
    g = yp["p0"].numpy()
    np.testing.assert_allclose(g[:, 0] + 1j * g[:, 1], ya["p0"].numpy(),
                               atol=1e-6 * scale)


def test_interop_carries_complex_and_pair_states():
    """A JAX native complex state carried into the port by interop, and
    the same state as a pair, stepped 9 more steps by both packages:
    leaf for leaf to 1e-5."""
    plan_j = _plan(JP, "dispersive")
    sj = JS.run(plan_j, JS.init_state(plan_j), 11, t0=0)
    st_np = jax.tree_util.tree_map(np.asarray, sj)
    want = jax.tree_util.tree_map(np.asarray, JS.run(plan_j, sj, 9, t0=11))
    for pair in (False, True):
        plan = _plan(TP, "dispersive")
        plan.real_pair = pair
        tree = st_np if not pair else jax.tree_util.tree_map(
            lambda a: np.stack([a.real, a.imag]).astype(np.float32)
            if np.iscomplexobj(a) else a, st_np)
        st = interop.state_from_numpy(tree, "cpu")
        got = interop.state_to_numpy(TS.run(plan, st, 9, t0=11))
        scale = max(float(np.abs(v).max()) for v in want["f"].values())
        for key in ("f", "f_u", "f_w"):
            for c, w in want[key].items():
                g = got[key][c]
                g = g[0] + 1j * g[1] if pair else g
                assert float(np.abs(g - w).max()) <= 1e-5 * scale, (key, c)
        assert int(got["t"]) == 20


def test_pair_refuses_nonlinear_media():
    """Pair fields with chi2 (or chi3) raise at init_state, as the
    reference's; native complex fields step them."""
    gv = TG.GridVolume.create("2d", [2.0, 2.0], 8)
    chi2 = np.zeros(gv.shape)
    chi2[6:10, 6:10] = 0.1
    plan = TP.compile_plan(
        gv, TP.MaterialSpec(chi1inv={}, chi3={"ez": chi2}),
        sources=[_src(TP, TG, gv, "ez", [0.3, -0.2])],
        periodic=(True, True), bloch_k=(0.13, 0.0), complex_fields=True,
        device="cpu")
    plan.real_pair = True
    with pytest.raises(NotImplementedError, match="nonlinear"):
        TS.init_state(plan)


# ---------------------------------------------------------------------------
# the pair drivers' and K3/K4's plain versions against the eager stepper
# ---------------------------------------------------------------------------


def _pair_sim(mp, k, flux=False, **kw):
    """A 3 x 2.5 x 2.5 cell at resolution 8 (24 x 20 x 20) with PML 0.5 on
    y and z, Bloch-periodic along x at `k`, an eps=4 ball of radius 0.5
    with a Lorentz pole at the centre, a Gaussian Ez point source with a
    complex amplitude and (`flux`) an x-normal flux plane."""
    med = mp.Medium(epsilon=4.0, E_susceptibilities=[
        mp.LorentzianSusceptibility(frequency=2.0, gamma=0.05, sigma=0.2)])
    sim = mp.Simulation(
        cell_size=mp.Vector3(3, 2.5, 2.5), resolution=8,
        geometry=[mp.Sphere(0.5, material=med)],
        sources=[mp.Source(mp.GaussianSource(1.0, fwidth=0.8), mp.Ez,
                           center=mp.Vector3(-0.9, 0.1, 0),
                           amplitude=0.8 + 0.6j)],
        boundary_layers=[mp.PML(0.5, direction=mp.Y),
                         mp.PML(0.5, direction=mp.Z)],
        k_point=k, eps_averaging=False, **kw)
    fl = sim.add_flux(1.0, 0.6, 3, mp.FluxRegion(
        center=mp.Vector3(0.8, 0, 0), size=mp.Vector3(0, 1.5, 1.5))) \
        if flux else None
    return sim, fl


def _random_pair_state(plan, seed):
    rng = np.random.default_rng(seed)
    st = TS.init_state(plan)

    def rnd(t):
        return torch.from_numpy(1e-2 * rng.standard_normal(
            tuple(t.shape)).astype(np.float32))

    return {**st, "f": {c: TS._apply_mask(plan, plan.coefs, c, rnd(t))
                        for c, t in st["f"].items()},
            "f_u": {c: rnd(t) for c, t in st["f_u"].items()},
            "f_w": {c: rnd(t) for c, t in st["f_w"].items()},
            "pol": [{k: {c: rnd(t) for c, t in e[k].items()}
                     for k in ("p", "pp")} for e in st["pol"]]}


def _live_close(got, want, n, tol):
    """Every state array on the live x-planes [0, n): equal (tol 0) or
    within tol of the fields' maximum."""
    scale = max(float(t.abs().max()) for t in want["f"].values())
    pairs = [(f"{k}[{c}]", got[k][c], t) for k in ("f", "f_u", "f_w")
             for c, t in want[k].items()]
    pairs += [(f"pol {k}[{c}]", pg[k][c], t)
              for pg, pw in zip(got["pol"], want["pol"])
              for k in ("p", "pp") for c, t in pw[k].items()]
    for what, g, w in pairs:
        err = float((g[:, :n] - w[:, :n]).abs().max())
        assert err <= tol * scale, f"{what}: {err:.3e}"


def test_pair_drivers_plain_versions_match_eager(monkeypatch):
    """K1's pair wrap (PairPeriodicXKernel) over 29 steps from a seeded
    random pair state: bit for bit with the eager pair stepper on the live
    planes; the pair ghost ring at depth 2 and 3 (K2's plain version on
    the extended plan, its ghosts re-seeded as rotations every call): to
    4e-6 of the field maximum (its ghosts are stepped, not rotated at
    each read); both pick their envelopes as the reference's."""
    from meep_nl_tpu_torch.ops import periodicx as PX
    monkeypatch.setenv("MNT_REAL_PAIR", "1")
    sim, _ = _pair_sim(mtt, mtt.Vector3(0.23), device="cpu")
    sim.init_sim()
    plan = sim.plan
    assert plan.real_pair and isinstance(plan.bloch_phase[0], complex)
    assert PX.pair_periodic_supported(plan)
    assert not PX.periodic_supported(plan)
    plan.slab_opt = True
    st0 = _random_pair_state(plan, 7)
    want = TS.run(plan, st0, 29, t0=5)
    n = plan.gv.num[0]
    k1 = PX.PairPeriodicXKernel(plan)
    _live_close(k1.run(st0, 29, t0=5), want, n, 0.0)
    assert k1.plain_steps == 29
    for depth in (2, 3):
        assert PX.periodic_ghost_supported(plan, depth)
        ring = PX.PeriodicGhostT2Kernel(plan, depth)
        assert ring.pair and len(ring.kers) == 2
        _live_close(ring.run(st0, 29, t0=5), want, n, 4e-6)
        assert all(k.plain_steps == depth * (29 // depth) for k in ring.kers)


@pytest.mark.parametrize("case", ["ghost-ring", "k1-pair-wrap", "resident"])
def test_3d_k_point_takes_the_pair_routes(case, monkeypatch):
    """k_point = (0.23, 0, 0) on the small 3D cell with the pair asked for
    on the CPU (MNT_REAL_PAIR=1), 47 steps: below the resident budget K3's
    pair layout, above it the hybrid route through the pair ghost ring
    without a monitor and K1's pair wrap with the flux plane (the full
    state's DTFT), as the reference routes it; fields and fluxes to 1e-5
    of the native complex eager run's."""
    from meep_nl_tpu_torch.ops import hybrid as HY
    from meep_nl_tpu_torch.ops import resident as R
    flux = case == "k1-pair-wrap"
    ref, rfl = _pair_sim(mtt, mtt.Vector3(0.23), flux=flux, device="cpu",
                         use_fused=False)
    ref.run(until=47 * ref.dt)
    monkeypatch.setenv("MNT_REAL_PAIR", "1")
    if case != "resident":
        monkeypatch.setattr(R, "VMEM_BUDGET", 0)
    sim, fl = _pair_sim(mtt, mtt.Vector3(0.23), flux=flux, device="cpu")
    sim.run(until=47 * sim.dt)
    assert sim.plan.real_pair and not ref.plan.real_pair
    if case == "resident":
        assert sim.routes == {"resident": 1}
    else:
        assert sim.routes == {"hybrid": 1}
        assert dict(HY.hybrid_routes(sim.plan)) == (
            {"full_state": 1} if flux else {"no_sample": 1})
    a, b = sim.get_array(mtt.Ez), ref.get_array(mtt.Ez)
    assert np.iscomplexobj(a)
    scale = float(np.abs(b).max())
    assert float(np.abs(a - b).max()) <= 1e-5 * scale
    if flux:
        fa, fb = np.asarray(sim.get_fluxes(fl)), np.asarray(ref.get_fluxes(rfl))
        assert float(np.abs(fa - fb).max()) <= 1e-5 * float(np.abs(fb).max())


# ---------------------------------------------------------------------------
# Simulation level
# ---------------------------------------------------------------------------


def holey(mp, **kw):
    """Meep's holey-wvg-bands.py cut to 1 x 6 at resolution 10: eps=13,
    width 1.2, a hole of radius 0.36, an Hz source at (0.1234, 0), PML 1
    on y, Mirror(Y, phase=-1)."""
    return mp.Simulation(
        cell_size=mp.Vector3(1, 6), resolution=10,
        geometry=[mp.Block(mp.Vector3(mp.inf, 1.2, mp.inf),
                           material=mp.Medium(epsilon=13)),
                  mp.Cylinder(0.36)],
        sources=[mp.Source(mp.GaussianSource(0.25, fwidth=1.5), mp.Hz,
                           center=mp.Vector3(0.1234, 0))],
        boundary_layers=[mp.PML(1, direction=mp.Y)],
        symmetries=[mp.Mirror(mp.Y, phase=-1)], **kw)


@functools.lru_cache(maxsize=None)
def _jax_k_point():
    # one BLAS thread for Harminv's SVD: on CPUs that other test workers
    # load, OpenBLAS's thread team beside JAX's pool takes a minute
    with threadpool_limits(limits=1, user_api="blas"):
        h = holey(mnt).run_k_point(150, mnt.Vector3(0.25))
    return [complex(m.freq, m.decay) for m in h.modes
            if m.Q > 20]


@pytest.mark.parametrize("pair", [False, True], ids=["native", "pair"])
def test_run_k_point_matches_jax(pair, monkeypatch):
    """run_k_point at k_x = 0.25 (phase i: complex fields), 150 time units
    after the source: the Q > 20 modes Harminv finds equal the JAX
    package's to 1e-6 of their frequency, in both storages (the pair on
    K4's route, its plain version)."""
    if pair:
        monkeypatch.setenv("MNT_REAL_PAIR", "1")
    sim = holey(mtt, device="cpu")
    with threadpool_limits(limits=1, user_api="blas"):
        h = sim.run_k_point(150, mtt.Vector3(0.25))
    assert sim.plan.real_pair == pair
    assert abs(sim.plan.bloch_phase[0] - 1j) < 1e-12
    assert set(sim.routes) == ({"resident"} if pair else {"eager"})
    got = [complex(m.freq, m.decay) for m in h.modes]
    want = _jax_k_point()
    assert want
    for f in want:
        near = min(got, key=lambda g: abs(g - f))
        assert abs(near - f) <= 1e-6 * abs(f), (f, near)


def test_storage_rule_and_getters(monkeypatch):
    """Complex fields are native complex64 on the CPU, the real pair with
    MNT_REAL_PAIR=1 (and on the card), native again with
    MNT_COMPLEX_NATIVE=1; force_complex_fields makes them at k = 0 and
    using_real_fields says so; get_field_point and get_array give the same
    complex values from both storages; a pair with a Rotate2 fold runs on
    the stepper."""
    def run(**kw):
        sim = holey(mtt, device="cpu", **kw)
        sim.run(until=3.05)
        return sim

    nat = run(k_point=mtt.Vector3(0.1))
    assert not nat.plan.real_pair and not nat.using_real_fields()
    assert nat.fields_state["f"]["hz"].dtype == torch.complex64
    monkeypatch.setenv("MNT_REAL_PAIR", "1")
    pair = run(k_point=mtt.Vector3(0.1))
    assert pair.plan.real_pair
    assert pair.fields_state["f"]["hz"].shape[0] == 2
    a, b = pair.get_array(mtt.Hz), nat.get_array(mtt.Hz)
    assert np.iscomplexobj(a) and np.abs(b.imag).max() > 0
    np.testing.assert_allclose(a, b, atol=1e-5 * np.abs(b).max())
    pt = mtt.Vector3(0.3, 0.7)
    assert abs(pair.get_field_point(mtt.Hz, pt)
               - nat.get_field_point(mtt.Hz, pt)) <= 1e-5 * np.abs(b).max()
    monkeypatch.setenv("MNT_COMPLEX_NATIVE", "1")
    assert not run(k_point=mtt.Vector3(0.1)).plan.real_pair
    forced = holey(mtt, device="cpu", force_complex_fields=True)
    forced.init_sim()
    assert forced.plan.complex_fields and not forced.using_real_fields()
    assert holey(mtt, device="cpu", k_point=mtt.Vector3(0.5)) \
        .using_real_fields() is False
    assert holey(mtt, device="cpu").using_real_fields()
    # a real pair with a rotational fold: K3/K4 decline it (ROADMAP C.2),
    # the stepper runs it
    from meep_nl_tpu_torch.ops import resident as R
    monkeypatch.delenv("MNT_COMPLEX_NATIVE")
    rot = mtt.Simulation(
        cell_size=mtt.Vector3(2, 2), resolution=8, device="cpu",
        sources=[mtt.Source(mtt.GaussianSource(1.0, fwidth=0.5), mtt.Ez,
                            center=mtt.Vector3(0.3, 0.2))],
        symmetries=[mtt.Rotate2(mtt.Z)], force_complex_fields=True)
    rot.run(until=1.0)
    assert rot.plan.real_pair and not R.resident_supported(rot.plan)
    assert rot.routes == {"eager": 1}
