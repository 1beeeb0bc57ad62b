"""The resident path of the port (meep_nl_tpu_torch/ops/resident.py and the
2D Simulation around it) against the JAX package, on the CPU.

On the CPU the port's K3/K4 wrapper runs its plain version, `resident_ref`
(the eager stepper over the resident plan); the JAX side runs its resident
kernel in interpret mode (MNT_RESIDENT_CPU=1 for the JAX side only) or its
jnp stepper.  Both start from one numpy state (meep_nl_tpu_torch.interop).
Tolerances, relative to the field maximum (DTFT accumulators and series to
their own maximum): 1e-5 for a kernel against a kernel or stepper (fp32; XLA
may reassociate sums and products), 1e-4 for whole Simulation runs (the
rounding differences grow over a few hundred steps), as
test_torch_simulation does.  Grids are at most 72x60 (2D) or 24^3 (3D)."""

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import meep_nl_tpu as mnt
from meep_nl_tpu.analysis import harminv as JH
from meep_nl_tpu.ops.pallas import resident as JR
from meep_nl_tpu.stepper import step as JS

import meep_nl_tpu_torch as mtt
from meep_nl_tpu_torch import interop
from meep_nl_tpu_torch.analysis import harminv as TH
from meep_nl_tpu_torch.ops import resident as R
from meep_nl_tpu_torch.stepper import step as TS

from test_torch_plan import random_state
from test_torch_step import assert_states_close

torch.set_num_threads(2)


def tm2d(mp, src=None, flux=False, src_x=-2.0, **kw):
    """The reference's resident test scene (test_resident.py::_mk_2d): a
    6x5 cell at resolution 12 (72x60), an eps=12 cylinder of radius 1,
    subpixel averaged, PML 1 and a Gaussian point source (Ez unless `src`)
    at (src_x, 0); `flux` adds an x-normal flux line."""
    sim = mp.Simulation(
        cell_size=mp.Vector3(6, 5), resolution=12,
        geometry=[mp.Cylinder(radius=1.0, material=mp.Medium(epsilon=12))],
        sources=[mp.Source(mp.GaussianSource(0.5, fwidth=0.2), src or mp.Ez,
                           center=mp.Vector3(src_x, 0.1))],
        boundary_layers=[mp.PML(1.0)], **kw)
    fl = sim.add_flux(0.5, 0.2, 5, mp.FluxRegion(
        center=mp.Vector3(1.9, 0), size=mp.Vector3(0, 3))) if flux else None
    sim.init_sim()
    return sim, fl


def disp2d(mp, **kw):
    """test_resident.py::_mk_disp with the chi2 as a full tensor (so the
    Newton-Raphson solve runs): a Lorentz + chi2 block, 60x48, PML 0.8."""
    med = mp.Medium(epsilon=3, chi2=0.2, chi2_full_tensor=True,
                    E_susceptibilities=[mp.LorentzianSusceptibility(
                        frequency=1.1, gamma=0.1, sigma=0.4)])
    sim = mp.Simulation(
        cell_size=mp.Vector3(5, 4), resolution=12,
        geometry=[mp.Block(size=mp.Vector3(2, 2, mp.inf), material=med)],
        sources=[mp.Source(mp.GaussianSource(0.4, fwidth=0.15), mp.Ez,
                           center=mp.Vector3(-1.6, 0))],
        boundary_layers=[mp.PML(0.8)], **kw)
    sim.init_sim()
    return sim, None


def small3d(mp, **kw):
    """test_resident.py::_mk_3d: an eps=8 ball in a 3^3 cell at resolution
    8 (24^3), PML 0.8, with an x-normal flux plane."""
    sim = mp.Simulation(
        cell_size=mp.Vector3(3, 3, 3), resolution=8,
        geometry=[mp.Sphere(radius=0.7, material=mp.Medium(epsilon=8))],
        sources=[mp.Source(mp.GaussianSource(0.8, fwidth=0.3), mp.Ez,
                           center=mp.Vector3(-0.6, 0, 0))],
        boundary_layers=[mp.PML(0.8)], **kw)
    fl = sim.add_flux(0.8, 0.3, 3, mp.FluxRegion(
        center=mp.Vector3(0.6, 0, 0), size=mp.Vector3(0, 1, 1)))
    sim.init_sim()
    return sim, fl


SCENES = {"tm": lambda mp, **kw: tm2d(mp, flux=True, **kw),
          "te": lambda mp, **kw: tm2d(mp, src=mp.Hz, **kw),
          "disp": disp2d, "3d": small3d}


def both(scene, **kw):
    """The scene's plan in both packages and one random numpy state."""
    sj, _ = SCENES[scene](mnt, **kw)
    st, _ = SCENES[scene](mtt, device="cpu", **kw)
    return sj._plan, st.plan, random_state(sj._plan, 5)


def to_np(state):
    return jax.tree_util.tree_map(np.asarray, state)


@pytest.fixture
def jax_resident_cpu(monkeypatch):
    """The JAX package's resident route on its CPU backend (interpret
    mode); the port reads no environment switch."""
    monkeypatch.setenv("MNT_RESIDENT_CPU", "1")


# ---------------------------------------------------------------------------
# the eager 2D stepper and the resident plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scene", ["tm", "te", "disp"])
def test_eager_2d_stepper_matches_jax(scene):
    """TM with PML and a subpixel-averaged cylinder, TE with PML, 2D
    Lorentz + chi2-NR: 30 steps of both packages' plain steppers."""
    pj, pt, st = both(scene)
    want = to_np(JS.run(pj, jax.tree_util.tree_map(jax.numpy.asarray, st),
                        30, t0=40))
    got = TS.run(pt, interop.state_from_numpy(st, "cpu"), 30, t0=40)
    assert_states_close(interop.state_to_numpy(got), want, 1e-5)


def test_resident_plan_dense_sources_match_jax():
    """Dense pre-scattered source arrays of a point and a line source,
    built in float64 and cast, equal the reference's; the resident plan
    runs full-grid chains and the frequency-major DTFT."""
    def mk(mp, **kw):
        sim = mp.Simulation(
            cell_size=mp.Vector3(4, 3), resolution=10,
            sources=[mp.Source(mp.GaussianSource(0.5, fwidth=0.2), mp.Ez,
                               center=mp.Vector3(-1.03, 0.27)),
                     mp.Source(mp.GaussianSource(0.7, fwidth=0.2), mp.Ez,
                               center=mp.Vector3(0.5, 0),
                               size=mp.Vector3(0, 1.3), amplitude=0.5)],
            boundary_layers=[mp.PML(0.5)], **kw)
        sim.init_sim()
        return sim._plan
    rj = JR.resident_plan(mk(mnt))
    pt = mk(mtt, device="cpu")
    pt.slab_opt = False
    rt = R.resident_plan(pt)
    assert R.resident_plan(pt) is rt and rt is not pt
    assert rt.scatter_free and rt.dft_front and not rt.slab_opt
    assert not pt.scatter_free
    for si in range(2):
        for key in ("dense_re", "dense_im"):
            want = np.asarray(rj.coefs[f"src{si}:{key}"])
            got = rt.coefs[f"src{si}:{key}"].numpy()
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
        assert np.count_nonzero(want) > 0 or key == "dense_im"


@pytest.mark.parametrize("scene", ["tm", "disp", "3d"])
def test_state_bytes_and_envelope_match_jax(scene):
    pj, pt, _ = both(scene)
    assert R._state_bytes(pt) == JR._state_bytes(JR.resident_plan(pj))
    assert R.resident_supported(pt) == JR.resident_supported(pj) is True


def test_envelope_declines(monkeypatch):
    _, pt, _ = both("tm")
    assert R.resident_supported(pt)
    pt.periodic = (True, False)
    assert R.resident_supported(pt)           # a real Bloch phase
    pt.bloch_phase = (complex(0.8, 0.6), 1.0)
    assert not R.resident_supported(pt)       # a complex one: ROADMAP A9
    # a state the hybrid route stepped (slab-local chains) stays off it
    _, pt, _ = both("tm")
    ker = R.ResidentKernel(pt)
    pt.slab_opt = True
    assert R.resident_run(pt, TS.init_state(pt), 4, 0) is None
    with pytest.raises(RuntimeError, match="slab-local"):
        ker.run(TS.init_state(pt), 4, 0)
    _, pt, _ = both("tm")
    monkeypatch.setattr(R, "VMEM_BUDGET", 2 * R._state_bytes(pt) - 1)
    assert not R.resident_supported(pt)
    assert R.resident_run(pt, TS.init_state(pt), 4, 0) is None
    p64 = tm2d(mtt, device="cpu", dtype=np.float64)[0].plan
    assert not R.resident_supported(p64)


# ---------------------------------------------------------------------------
# K3 / K4 (their plain version on the CPU) against the JAX resident kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scene", ["tm", "disp", "3d"])
def test_resident_kernel_matches_jax_kernel(scene, jax_resident_cpu):
    """ResidentKernel.run (and resident_ref) against the JAX package's
    ResidentKernel in interpret mode, 25 steps from a random state around
    the source's peak, DTFT accumulators included."""
    pj, pt, st = both(scene)
    t0 = 40 if scene != "3d" else 20
    want = to_np(JR.ResidentKernel(pj).run(
        jax.tree_util.tree_map(jax.numpy.asarray, st), 25, t0))
    ker = R.ResidentKernel(pt)
    got = ker.run(interop.state_from_numpy(st, "cpu"), 25, t0)
    assert ker.plain_steps == 25 and ker.launches == 0
    assert_states_close(interop.state_to_numpy(got), want, 1e-5)
    ref, _ = R.resident_ref(pt)(interop.state_from_numpy(st, "cpu"), 25, t0)
    for c, t in ref["f"].items():
        assert torch.equal(t, got["f"][c])


def test_probed_series_match_jax(jax_resident_cpu):
    """K4's series (its plain version: point by point from 0 in float32)
    against the JAX resident probed kernel, and against the port's eager
    stepper (which sums in the same order), 60 steps."""
    pj, pt, st = both("tm")
    idx = np.array([[30, 28], [30, 29], [31, 29]])
    w = np.array([0.5, 0.3, 0.2])
    _, want = JR.ResidentKernel(pj).run_probed(
        jax.tree_util.tree_map(jax.numpy.asarray, st), 60, 30,
        [JS.ProbeSpec("p0", "ez", idx, w)])
    pr = [TS.ProbeSpec("p0", "ez", idx, w)]
    ker = R.ResidentKernel(pt)
    got_st, got = ker.run_probed(interop.state_from_numpy(st, "cpu"), 60, 30,
                                 pr)
    a, b = np.asarray(want["p0"]), got["p0"].numpy()
    assert a.shape == b.shape == (60,) and b.dtype == np.float32
    assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()
    eager_st, eager = TS.run(pt, interop.state_from_numpy(st, "cpu"), 60,
                             t0=30, probes=pr)
    assert torch.equal(eager["p0"], got["p0"])
    for c, t in eager_st["f"].items():
        assert torch.equal(t, got_st["f"][c])
    assert ker.probed_launches == 0 and ker.plain_steps == 60


def test_probed_route_takes_any_number_of_probes():
    """The probe table has no fixed capacity: 20 probes (a Simulation with
    many Harminv collectors) stay on the resident route."""
    _, pt, _ = both("tm")
    probes = [TS.ProbeSpec(f"p{i}", "ez", np.array([[20 + i, 28]]),
                           np.array([1.0])) for i in range(20)]
    out = R.resident_probed_run(pt, TS.init_state(pt), 3, 0, probes)
    assert out is not None and set(out[1]) == {p.name for p in probes}
    assert R._kernel(pt).plain_steps == 3


def test_source_inside_pml_follows_the_jax_resident_route(jax_resident_cpu):
    """A source inside the x PML slab: the port's resident route runs the
    full-grid chains, as the reference's resident route does."""
    sj, _ = tm2d(mnt, src_x=-2.6)
    st, _ = tm2d(mtt, src_x=-2.6, device="cpu")
    lo = st.plan.curl_specs_d[0].dsig_slabs[0]
    assert st.plan.coefs["src0:idx"][:, 0].max() < lo
    want = to_np(JR.resident_run(sj._plan, sj._state, 120, 0))
    got = R.resident_run(st.plan, TS.init_state(st.plan), 120, 0)
    assert_states_close(interop.state_to_numpy(got), want, 1e-5,
                        keys=("f", "f_u", "f_w"))


def test_chunk_seam(monkeypatch):
    """MAX_CHUNK splitting is seam-free: the per-step tables restart at each
    chunk's first step."""
    _, pt, st = both("tm")
    one = R.resident_run(pt, interop.state_from_numpy(st, "cpu"), 96, 7)
    monkeypatch.setattr(R, "MAX_CHUNK", 40)
    pt2 = both("tm")[1]
    ker = R._kernel(pt2)
    three = R.resident_run(pt2, interop.state_from_numpy(st, "cpu"), 96, 7)
    assert ker.plain_steps == 96 and int(three["t"]) == int(one["t"]) == 96
    for key in ("f", "dft"):
        for c, t in one[key].items():
            assert torch.equal(t, three[key][c]), f"{key}[{c}]"


# ---------------------------------------------------------------------------
# the 2D Simulation through the resident route
# ---------------------------------------------------------------------------


def _close(got, want, what, scale=None, tol=1e-4):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    scale = scale or float(np.abs(np.asarray(want)).max())
    assert scale > 0, what
    assert err <= tol * scale, f"{what}: {err:.3e} vs max {scale:.3e}"


def test_simulation_2d_matches_jax():
    """run(until=27) then run(until_after_sources=4), two stretches of 648
    steps (so the JAX side compiles its runner once), on the TM scene with
    a flux line: every stretch through the resident route, Ez and the
    fluxes against the JAX package's jnp stepper (use_fused=False) to
    1e-4."""
    sj, fj = tm2d(mnt, flux=True, use_fused=False)
    st, ft = tm2d(mtt, flux=True, device="cpu")
    peak = 0.0
    for kw in ({"until": 27.0}, {"until_after_sources": 4.0}):
        sj.run(**kw)
        st.run(**kw)
        assert st._t == sj._t
        want = sj.get_array(mnt.Ez)
        peak = max(peak, float(np.abs(want).max()))
        _close(st.get_array(mtt.Ez), want, "ez", peak)
    _close(st.get_fluxes(ft), sj.get_fluxes(fj), "flux", tol=1e-5)
    assert st._t == 1296 and dict(st.routes) == {"resident": 2}
    ker = st.plan._resident_kernel
    assert ker.plain_steps == st._t and ker.launches == 0
    assert st.get_field_point(mtt.Ez, mtt.Vector3(0.4, 0.3)) == \
        pytest.approx(sj.get_field_point(mnt.Ez, mnt.Vector3(0.4, 0.3)),
                      abs=1e-4 * peak)


def ring(mp, res, **kw):
    """Meep's ring-resonator tutorial (python/examples/ring.py) without its
    Mirror(Y) symmetry: n = 3.4, w = 1, r = 1, pad = 4, dpml = 2, an Ez
    Gaussian source (0.15, fwidth 0.1) at (r + 0.1, 0)."""
    n, w, r, pad, dpml = 3.4, 1, 1, 4, 2
    sxy = 2 * (r + w + pad + dpml)
    return mp.Simulation(
        cell_size=mp.Vector3(sxy, sxy), resolution=res,
        geometry=[mp.Cylinder(radius=r + w, material=mp.Medium(index=n)),
                  mp.Cylinder(radius=r)],
        sources=[mp.Source(mp.GaussianSource(0.15, fwidth=0.1), mp.Ez,
                           center=mp.Vector3(r + 0.1))],
        boundary_layers=[mp.PML(dpml)], **kw)


def test_ring_harminv_matches_jax():
    """The ring at resolution 5, run(after_sources(Harminv), ...): the
    collector's series rides K4 (its plain version here) and agrees with
    the JAX package's scan to 1e-5; the resonances (amplitude above 1e-3
    of the largest, Q above 50) to 1e-5 in frequency.  The fit of the
    low-Q background poles in a window of ~300 samples moves with the
    series' fp32 round-off, in either package, so those are not held."""
    out = {}
    for name, mp, kw in (("jax", mnt, {}), ("port", mtt, {"device": "cpu"})):
        sim = ring(mp, 5, **kw)
        h = mp.Harminv(mp.Ez, mp.Vector3(1.1), 0.15, 0.1)
        # one BLAS thread for Harminv's SVD (slow on loaded CPUs else)
        with threadpool_limits(limits=1, user_api="blas"):
            sim.run(mp.after_sources(h), until_after_sources=150)
        out[name] = (np.asarray(h.data), h.modes)
    assert dict(sim.routes) == {"resident": -(-sim._t // 1024)}
    assert sim.plan._resident_kernel.plain_steps == sim._t
    (dj, mj), (dt_, mt) = out["jax"], out["port"]
    assert dj.shape == dt_.shape and len(dj) > 1000
    _close(dt_, dj, "series", tol=1e-5)
    amax = max(m.amp for m in mj)
    held = [m for m in mj if m.amp > 1e-3 * amax and m.Q > 50]
    assert len(held) >= 3
    for m in held:
        f = min((x.freq for x in mt), key=lambda v: abs(v - m.freq))
        assert abs(f - m.freq) <= 1e-5 * m.freq, (m.freq, f)


def test_stop_when_fields_decayed_matches_jax():
    """until_after_sources=stop_when_fields_decayed: the in-loop probe's
    window maxima stop both packages at the same step; at_every and
    at_end callbacks fire at the block boundaries."""
    steps = {}
    for name, mp, kw in (("jax", mnt, {"use_fused": False}),
                         ("port", mtt, {"device": "cpu"})):
        sim, _ = tm2d(mp, **kw)
        seen = []
        sim.run(mp.at_every(5.0, lambda s: seen.append(s._t)),
                mp.at_end(lambda s: seen.append(-s._t)),
                until_after_sources=mp.stop_when_fields_decayed(
                    5.0, mp.Ez, mp.Vector3(1.5, 0.5), 1e-2))
        steps[name] = (sim._t, seen)
    assert steps["port"] == steps["jax"]
    assert dict(sim.routes) == {"resident": len(steps["port"][1]) - 1}


def test_harminv_matches_reference():
    """The port's harminv copy on a synthetic two-pole signal (with a little
    noise) gives the reference's modes."""
    rng = np.random.default_rng(2)
    t = np.arange(1500) * 0.1
    sig = (np.exp((2j * np.pi * 0.16 - 0.002) * t).real
           + 0.5 * np.exp((2j * np.pi * 0.19 - 0.01) * t).real
           + 1e-6 * rng.standard_normal(len(t)))
    with threadpool_limits(limits=1, user_api="blas"):
        want = JH.harminv(sig, 0.1, 0.1, 0.25)
        got = TH.harminv(sig, 0.1, 0.1, 0.25)
    assert [m.freq for m in got] == [m.freq for m in want]
    assert [m.Q for m in got] == [m.Q for m in want]
    assert min(abs(m.freq - 0.16) for m in got) < 1e-6
    assert min(abs(m.freq - 0.19) for m in got) < 1e-6
