"""The same Simulation through meep_nl_tpu (the JAX package, on the CPU its
jnp stepper) and meep_nl_tpu_torch(device="cpu"): fluxes and fields agree
to 1e-4 of their maximum (fp32; the two round in different orders over
~130 steps).  These small 3D cells take the resident route first, as in the
reference; with PREFER_BYTES set to 0 they take the hybrid driver instead,
whose kernel wrappers (K2 at depth 2 and 3, K1) take their plain versions
on the CPU.  The route and step counters show which ran."""

import numpy as np
import pytest
import torch

import meep_nl_tpu as mnt
import meep_nl_tpu_torch as mtt
from meep_nl_tpu_torch.ops import resident as R

torch.set_num_threads(2)


def make_sim(mp, flagship=True, eps_averaging=False, **kw):
    """A 24x16x16 cell (3x2x2 at resolution 8) with PML on every face, a
    Gaussian Ez point source and an x-normal flux plane, both outside the
    PML; `flagship` adds the eps=4 ball with a Lorentz pole and
    full-tensor chi2.  (A source inside a PML slab is avoided on purpose:
    there the JAX package's own slab-local and full-grid chains differ.)"""
    geometry = []
    if flagship:
        med = mp.Medium(epsilon=4.0, chi2=0.05, chi2_full_tensor=True,
                        E_susceptibilities=[mp.LorentzianSusceptibility(
                            frequency=2.0, gamma=0.05, sigma=0.2)])
        geometry = [mp.Sphere(0.4, material=med)]
    sim = mp.Simulation(
        cell_size=mp.Vector3(3, 2, 2), resolution=8, geometry=geometry,
        sources=[mp.Source(mp.GaussianSource(1.0, fwidth=1.0),
                           component=mp.Ez,
                           center=mp.Vector3(-0.9, 0.02, 0))],
        boundary_layers=[mp.PML(0.5)], eps_averaging=eps_averaging, **kw)
    flux = sim.add_flux(1.0, 0.4, 3, mp.FluxRegion(
        center=mp.Vector3(0.9, 0, 0), size=mp.Vector3(0, 1, 1)))
    return sim, flux


def _close(got, want, what, scale=None):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    scale = scale or float(np.abs(np.asarray(want)).max())
    assert scale > 0, what
    assert err <= 1e-4 * scale, f"{what}: {err:.3e} vs max {scale:.3e}"


@pytest.mark.parametrize("flagship,eps_averaging,first,last", [
    (True, False, 4.0625, {"until": 4.0625}),
    (True, True, 4.0625, {"until": 4.0625}),
    (False, False, 5.625, {"until_after_sources": 1.25}),
], ids=["flagship", "flagship-subpixel", "vacuum-after-sources"])
def test_simulation_matches_jax(flagship, eps_averaging, first, last,
                                monkeypatch):
    """Two stretches through the hybrid route: run(until=first) while the
    pulse is in the cell, then `last`, a stretch of as many steps (so the
    JAX side compiles its runner once; 65 or 90 steps, not a multiple of 4,
    which the JAX package's run would unroll 4 times).  Fields are held to 1e-4 of the
    run's peak field (by the end the pulse has mostly left through the PML,
    and fp32 round-off is relative to the peak); fluxes to 1e-4 of their
    maximum."""
    monkeypatch.setattr(R, "PREFER_BYTES", 0)     # the hybrid route
    sj, fj = make_sim(mnt, flagship, eps_averaging)
    st, ft = make_sim(mtt, flagship, eps_averaging, device="cpu")
    # the JAX package's production route (its hybrid driver) runs the
    # slab-local PML chains, as the port's does; on the CPU its jnp
    # stepper would take the full-grid chains, which agree only to the
    # round-off that the source's static charge then amplifies
    sj.init_sim()
    sj._plan.slab_opt = True
    peak = {}
    for run_kw in ({"until": first}, last):
        sj.run(**run_kw)
        st.run(**run_kw)
        assert st._t == sj._t
        for c in ("ez", "hy"):
            want = sj.get_array(c)
            peak[c] = max(peak.get(c, 0.0), float(np.abs(want).max()))
            _close(st.get_array(c), want, c, peak[c])
        _close(st.get_array("ez", snap=True), sj.get_array("ez", snap=True),
               "ez snap", peak["ez"])
        _close(st.get_array("ez", center=mtt.Vector3(0.9, 0, 0),
                            size=mtt.Vector3(0, 1, 1)),
               sj.get_array("ez", center=mnt.Vector3(0.9, 0, 0),
                            size=mnt.Vector3(0, 1, 1)), "ez plane",
               peak["ez"])
    _close(st.get_fluxes(ft), sj.get_fluxes(fj), "flux")
    assert st._t > 100
    assert dict(st.routes) == {"hybrid": 2}
    # every step went through a kernel wrapper's plain version: the
    # flagship scenes sample every step and take the capture route (K2 at
    # depth 3 with capture planes, the tail of each stretch through K1);
    # the vacuum scene's two-step decimation cycles take K2 at depth 2
    ker = st.plan._t2_kernel
    kers = {"k1": ker._k1, "k2_d2": ker, "k2_d3": ker.k3}
    for (depth, _), k in st.plan.__dict__.get("_cap_kernels", {}).items():
        kers[f"k2_cap_d{depth}"] = k
    assert all(k.launches == 0 for k in kers.values())
    plain = {n: k.plain_steps for n, k in kers.items() if k.plain_steps}
    assert sum(plain.values()) == st._t
    if flagship:
        assert set(plain) <= {"k2_cap_d3", "k1"} and plain.get("k1", 0) <= 4
    else:
        assert plain == {"k2_d2": st._t}
    assert st.meep_time() == pytest.approx(sj.meep_time())


def test_simulation_default_device_is_cuda():
    if torch.cuda.is_available():
        assert make_sim(mtt)[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_sim(mtt)


def test_simulation_resident_route_matches_jax():
    """The flagship cell on the resident route (K3's plain version on the
    CPU: full-grid PML chains) against the JAX package's jnp stepper, which
    runs the full-grid chains too: two stretches of 41 steps."""
    sj, fj = make_sim(mnt, True, use_fused=False)
    st, ft = make_sim(mtt, True, device="cpu")
    peak = 0.0
    for until in (2.5625, 2.5625):
        sj.run(until=until)
        st.run(until=until)
        assert st._t == sj._t
        want = sj.get_array("ez")
        peak = max(peak, float(np.abs(want).max()))
        _close(st.get_array("ez"), want, "ez", peak)
    _close(st.get_fluxes(ft), sj.get_fluxes(fj), "flux")
    assert dict(st.routes) == {"resident": 2}
    ker = st.plan._resident_kernel
    assert ker.plain_steps == st._t == 82 and ker.launches == 0
    assert not st.plan.slab_opt and "_t2_kernel" not in st.plan.__dict__


@pytest.mark.parametrize("cell,kw,item", [
    ((0, 0, 2), {"symmetries": [mtt.Rotate2("x")]}, "2d/3d"),
    ((2, 0, 2), {"dimensions": -2, "symmetries": [mtt.Rotate2("z")]},
     "2d/3d cartesian")], ids=["1d", "cylindrical"])
def test_simulation_rejects_1d_and_cylindrical(cell, kw, item):
    """A 1D cell and a cylindrical cell run, but not with a rotational
    symmetry (the reference refuses both too)."""
    with pytest.raises(NotImplementedError, match=item):
        mtt.Simulation(cell_size=mtt.Vector3(*cell), resolution=8,
                       device="cpu", **kw)


#: the third-harmonic scene's pump frequency (tests/test_nonlinear.py
#: thg_amplitude, Meep's python/tests/test_3rd_harm_1d.py)
F0 = 1.0 / 3.0


def thg_sim(mp, chi3, fwidth, res=20, **kw):
    """thg_amplitude's Kerr medium through the public Simulation: a cell
    size along z only (a 1D cell, inferred), PML 2, an Ex pump at z = -4 in
    a chi3 medium; an Ey source at z = -3 too, unless `fwidth` is None
    (the other polarization, Ey/Hx); a flux point and the DTFT of Ex at
    z = 4, at f0 and 3 f0."""
    src = mp.GaussianSource(F0, fwidth=fwidth or F0 / 4)
    sources = [mp.Source(src, mp.Ex, center=mp.Vector3(0, 0, -4))]
    if fwidth is not None:
        sources.append(mp.Source(mp.GaussianSource(0.5, fwidth=0.4), mp.Ey,
                                 center=mp.Vector3(0, 0, -3),
                                 amplitude=0.7))
    sim = mp.Simulation(cell_size=mp.Vector3(0, 0, 12), resolution=res,
                        default_material=mp.Medium(chi3=chi3),
                        sources=sources, boundary_layers=[mp.PML(2.0)],
                        **kw)
    h = {"dft": sim.add_dft_fields([mp.Ex], 2 * F0, 2 * F0, 2,
                                   center=mp.Vector3(0, 0, 4),
                                   size=mp.Vector3()),
         "flux": sim.add_flux(2 * F0, 2 * F0, 2,
                              mp.FluxRegion(center=mp.Vector3(0, 0, 4)))}
    return sim, h


def test_1d_matches_jax():
    """A 1D cell (the dimension inferred from a cell size along z only)
    with both transverse polarizations (an Ex and an Ey source), chi3, a
    flux point: 601 steps on the eager stepper (K3/K4 decline 1D, as the
    reference's do), fields and fluxes to 1e-4 of their maximum."""
    sj, hj = thg_sim(mnt, 1e-2, F0 / 2)
    st, ht = thg_sim(mtt, 1e-2, F0 / 2, device="cpu")
    assert st.gv.dim == sj.gv.dim == "1d" and st.gv.shape == (241,)
    for sim in (sj, st):
        sim.run(until=15.025)
    assert st._t == sj._t == 601 and dict(st.routes) == {"eager": 1}
    assert not R.resident_supported(st.plan)
    assert set(st.fields_state["f"]) == {"dx", "dy", "bx", "by", "ex", "ey",
                                          "hx", "hy"}
    for c in ("ex", "ey", "hx", "hy"):
        _close(st.get_array(c), sj.get_array(c), c)
    _close(st.get_fluxes(ht["flux"]), sj.get_fluxes(hj["flux"]), "flux")


def test_1d_full_tensor_chi2_is_refused():
    """The Newton step's neighbour averages run along a component's own
    direction, which is no grid axis in a 1D cell: the port refuses the
    plan (the reference's step fails there with a TypeError, ROADMAP
    C.3); the scalar chi2 runs (test_1d_matches_jax's chi3 path)."""
    sim = mtt.Simulation(
        cell_size=mtt.Vector3(0, 0, 4), resolution=10, device="cpu",
        default_material=mtt.Medium(chi2=0.05, chi2_full_tensor=True),
        sources=[mtt.Source(mtt.GaussianSource(F0, fwidth=F0), mtt.Ex,
                            center=mtt.Vector3())])
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        sim.init_sim()


def test_1d_third_harmonic_scales_with_chi3():
    """Third-harmonic generation in the Kerr medium (thg_amplitude, Meep's
    test_3rd_harm_1d.py) through the port's 1D Simulation: the DTFT of Ex
    at 3 f0 doubles with chi3 within 5 %, the pump's barely moves."""
    amp = []
    for chi3 in (1e-3, 2e-3):
        sim, h = thg_sim(mtt, chi3, None, device="cpu")
        sim.run(until_after_sources=20)
        amp.append(np.abs(sim.get_dft_array(h["dft"], mtt.Ex)
                          .reshape(-1, 2).sum(0)))
    np.testing.assert_allclose(amp[1][0], amp[0][0], rtol=1e-3)
    assert amp[0][1] > 1e-4 * amp[0][0]
    np.testing.assert_allclose(amp[1][1] / amp[0][1], 2.0, rtol=0.05)
