"""The same Simulation through meep_nl_tpu (the JAX package, on the CPU its
jnp stepper) and meep_nl_tpu_torch(device="cpu"): fluxes and fields agree
to 1e-4 of their maximum (fp32; the two round in different orders over
~130 steps).  On the CPU the port's run goes through the hybrid driver,
whose kernel wrappers (K2 at depth 2 and 3, K1) take their plain versions
there; the route and step counters show it."""

import numpy as np
import pytest
import torch

import meep_nl_tpu as mnt
import meep_nl_tpu_torch as mtt

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


@pytest.mark.parametrize("flagship,eps_averaging,last", [
    (True, False, {"until": 3.0}),
    (True, True, {"until": 3.0}),
    (False, False, {"until_after_sources": 1.0}),
], ids=["flagship", "flagship-subpixel", "vacuum-after-sources"])
def test_simulation_matches_jax(flagship, eps_averaging, last):
    """Two stretches: run(until=5) while the pulse is in the cell, then
    `last`.  Fields are held to 1e-4 of the run's peak field (by the end
    the pulse has mostly left through the PML, and fp32 round-off is
    relative to the peak); fluxes to 1e-4 of their maximum."""
    sj, fj = make_sim(mnt, flagship, eps_averaging)
    st, ft = make_sim(mtt, flagship, eps_averaging, device="cpu")
    # the JAX package's production route (its hybrid driver) runs the
    # slab-local PML chains, as the port's does; on the CPU its jnp
    # stepper would take the full-grid chains, which agree only to the
    # round-off that the source's static charge then amplifies
    sj.init_sim()
    sj._plan.slab_opt = True
    peak = {}
    for run_kw in ({"until": 5.0}, last):
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


def test_simulation_rejects_2d():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mtt.Simulation(cell_size=mtt.Vector3(2, 2, 0), resolution=8,
                       device="cpu")
