"""Mirror symmetry in the port (meep_nl_tpu_torch, device="cpu") against the
JAX package (meep_nl_tpu, its jnp stepper on the CPU) and against the
port's own full cell.

`Simulation(symmetries=[Mirror(...)])` halves the cell along each mirrored
axis, with three alignments of the plane: phase -1 on an even cell count (a
metal wall), phase +1 on an odd count (a magnetic wall, the cell grown by
dx/2) and phase +1 on an even count (no wall: the node-mirror ghost of the
stepper, plan.mirror_node).  Each alignment is compared with the JAX
package once, on a 2D 60x50 (or 60x49) scene stepped 301 steps (not a
multiple of 4, which the JAX package's run would unroll 4 times): the
unfolded get_array and a flux line through the plane, to 1e-4 of their
maximum; the node scene also carries the whole monitor family (energy,
force, dft fields, LDOS, near2far), get_epsilon and get_field_point.  A 3D
plan with y and z node mirrors, the flagship ball and one-sided PML is
stepped in both packages from one state (interop) to 1e-5.  Further cases
hold the port against its own full cell (fold, unfold, probes) and check
the routes: a mirrored 2D plan runs on the resident route, a y/z-mirrored
3D plan on the hybrid route, an x-mirrored one on the eager stepper, as in
the reference."""

import jax
import numpy as np
import pytest
import torch

import meep_nl_tpu as mnt
import meep_nl_tpu_torch as mtt
from meep_nl_tpu.stepper import step as JS
from meep_nl_tpu_torch import interop
from meep_nl_tpu_torch.ops import hybrid as HY
from meep_nl_tpu_torch.stepper import step as TS

from test_torch_plan import random_state
from test_torch_step import assert_states_close

torch.set_num_threads(2)

#: alignment -> (cell count along y at resolution 10, phase)
ALIGN = {"metal": (50, -1), "magnetic": (49, 1), "node": (50, 1)}


def _close(got, want, what, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    assert scale > 0, what
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} vs max {scale:.3e}"


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def scene2d(mp, align, **kw):
    """A 6 x 5 (or 4.9) cell at resolution 10 with PML 0.8, an eps=6
    cylinder on the plane y = 0, an Ez point source at (-1, 0.4) in the
    retained half (its image is the symmetry's), Mirror(Y) of the
    alignment, a flux line through the plane.  The node scene carries the
    monitor family: a symmetric energy box, an x-normal force line across
    the plane, dft fields in the retained half, LDOS, and a near2far box
    whose y = -1.2 face lies in the dropped half.  Returns the outputs."""
    ny, phase = ALIGN[align]
    sim = mp.Simulation(
        cell_size=mp.Vector3(6, ny / 10), resolution=10,
        geometry=[mp.Cylinder(radius=0.5, center=mp.Vector3(0.6, 0),
                              material=mp.Medium(epsilon=6))],
        sources=[mp.Source(mp.GaussianSource(0.5, fwidth=0.4), mp.Ez,
                           center=mp.Vector3(-1.0, 0.4),
                           amplitude=0.8 - 0.6j)],
        boundary_layers=[mp.PML(0.8)],
        symmetries=[mp.Mirror(mp.Y, phase=phase)], **kw)
    flux = sim.add_flux(0.5, 0.4, 4, mp.FluxRegion(
        center=mp.Vector3(1.6, 0), size=mp.Vector3(0, 3)))
    h = {}
    if align == "node":
        h = {"dftf": sim.add_dft_fields([mp.Ez, mp.Hx], 0.5, 0.4, 2,
                                        center=mp.Vector3(0.3, 0.5),
                                        size=mp.Vector3(1.6, 1.0)),
             "energy": sim.add_energy(0.5, 0.4, 3, mp.EnergyRegion(
                 center=mp.Vector3(0.3, 0), size=mp.Vector3(1.4, 1.4))),
             "force": sim.add_force(0.5, 0.4, 3, mp.ForceRegion(
                 center=mp.Vector3(1.0, 0), size=mp.Vector3(0, 2),
                 direction=mp.X)),
             "ldos": sim.add_ldos(0.5, 0.4, 3),
             "n2f": sim.add_near2far(0.5, 0.4, 3, *[
                 mp.Near2FarRegion(center=c, size=s, weight=w)
                 for c, s, w in (
                     (mp.Vector3(1.2, 0), mp.Vector3(0, 2.4), 1),
                     (mp.Vector3(-1.2, 0), mp.Vector3(0, 2.4), -1),
                     (mp.Vector3(0, 1.2), mp.Vector3(2.4, 0), 1),
                     (mp.Vector3(0, -1.2), mp.Vector3(2.4, 0), -1))])}
    sim.run(until=15.05)                        # 301 steps
    cell = mp.Vector3(6, ny / 10)
    out = {"flux": sim.get_fluxes(flux),
           "ez": sim.get_array(mp.Ez),
           "ez_cell": sim.get_array(mp.Ez, center=mp.Vector3(), size=cell),
           "hx": sim.get_array(mp.Hx),
           "eps": sim.get_epsilon(),
           "pt": sim.get_field_point(mp.Hx, mp.Vector3(0.45, -0.35)),
           "sim": sim}
    if h:
        out.update(
            dftf=sim.get_dft_array(h["dftf"], mp.Ez),
            dft_hx=sim.get_dft_array(h["dftf"], mp.Hx, 1),
            energy=sim.get_total_energy(h["energy"]),
            e_energy=sim.get_electric_energy(h["energy"]),
            force=sim.get_forces(h["force"]),
            ldos=sim.get_ldos(h["ldos"]),
            far=np.stack([sim.get_farfield(h["n2f"], mp.Vector3(*p))
                          for p in ((8, 3), (-6, -5))]))
    return out


@pytest.fixture(scope="module")
def runs():
    return {a: (scene2d(mnt, a), scene2d(mtt, a, device="cpu"))
            for a in ALIGN}


@pytest.mark.parametrize("align", sorted(ALIGN))
def test_2d_alignment_matches_jax(align, runs):
    want, got = runs[align]
    sim = got["sim"]
    ny, phase = ALIGN[align]
    assert dict(sim.routes) == {"resident": 1}
    assert sim.gv.num[1] == (ny + 1) // 2
    assert sim.plan.mirror_node == (((1, "y", 1),) if align == "node"
                                    else ())
    for k in ("flux", "ez", "ez_cell", "eps"):
        _close(got[k], want[k], k)
    hx, hx_want = got["hx"], want["hx"].copy()
    if align == "metal":
        # on a metal wall the reference unfolds the plane row of a
        # half-offset component with s = +1 (Hx here) at half the full
        # cell's value; the port restores it (ROADMAP C.3)
        j0 = hx.shape[1] // 2
        hx_want[:, j0] *= 2.0
        assert np.abs(hx[:, j0]).max() > 0.1 * np.abs(hx).max()
    _close(hx, hx_want, "hx")
    assert got["ez_cell"].shape == (61, ny + 1)
    assert got["pt"] == pytest.approx(want["pt"], abs=1e-4 * np.abs(
        want["hx"]).max())


@pytest.mark.parametrize("monitor", ["dftf", "dft_hx", "energy", "e_energy",
                                     "force", "ldos", "far"])
def test_monitor_family_on_the_folded_cell_matches_jax(monitor, runs):
    want, got = runs["node"]
    _close(got[monitor], want[monitor], monitor)


def test_3d_yz_node_mirrors_step_like_jax():
    """One 3D plan of a 32x24x24 cell halved on y and z (32x12x12; node
    mirrors, phase +1), the flagship ball (a Lorentz pole and full-tensor
    chi2: the NR solve) at the planes' corner, PML on the high side of y
    and z: the plans agree, and 9 eager steps of either package from one
    state agree to 1e-5."""
    plans = []
    for mp, kw in ((mnt, {}), (mtt, {"device": "cpu"})):
        med = mp.Medium(epsilon=4.0, chi2=0.05, chi2_full_tensor=True,
                        E_susceptibilities=[mp.LorentzianSusceptibility(
                            frequency=2.0, gamma=0.05, sigma=0.2)])
        sim = mp.Simulation(
            cell_size=mp.Vector3(4, 3, 3), resolution=8,
            geometry=[mp.Sphere(0.6, material=med)],
            sources=[mp.Source(mp.GaussianSource(1.0, fwidth=1.0), mp.Ex,
                               center=mp.Vector3(-1.2, 0, 0))],
            boundary_layers=[mp.PML(0.5)], eps_averaging=False,
            symmetries=[mp.Mirror(mp.Y), mp.Mirror(mp.Z)], **kw)
        sim.init_sim()
        plans.append(sim._plan)
    pj, pt = plans
    assert pt.mirror_node == ((1, "y", 1), (2, "z", 1)) == pj.mirror_node
    assert tuple(pt.storage_shape) == (40, 13, 13)
    for key in ("ex:kap", "dx:sig", "dy:sigu", "mask:hx", "ex:nrchi2"):
        if key in pj.coefs:
            np.testing.assert_array_equal(
                pt.coefs[key].cpu().numpy(), np.asarray(pj.coefs[key]))
    st_np = random_state(pj, seed=3)
    want = jax.tree_util.tree_map(
        np.asarray, JS.run(pj, jax.tree_util.tree_map(jax.numpy.asarray,
                                                      st_np), 9, t0=20))
    got = TS.run(pt, interop.state_from_numpy(st_np, "cpu"), 9, t0=20)
    assert_states_close(interop.state_to_numpy(got), want, 1e-5)


def test_set_boundary_matches_jax():
    """set_boundary(Low, Y, Magnetic) on a 2D cell: the plan's masks equal
    the JAX package's (no stepping)."""
    masks = []
    for mp, kw in ((mnt, {}), (mtt, {"device": "cpu"})):
        sim = mp.Simulation(
            cell_size=mp.Vector3(3, 2), resolution=10,
            sources=[mp.Source(mp.GaussianSource(0.5, fwidth=0.4), mp.Hz,
                               center=mp.Vector3(0.1, 0.2))], **kw)
        sim.set_boundary(mp.Low, mp.Y, mp.Magnetic)
        sim.init_sim()
        masks.append({k: np.asarray(v.cpu() if torch.is_tensor(v) else v)
                      for k, v in sim._plan.coefs.items()
                      if k.startswith("mask:")})
    assert set(masks[0]) == set(masks[1]) and "mask:hz" in masks[1]
    for k, v in masks[0].items():
        np.testing.assert_array_equal(masks[1][k], v)
    # the magnetic wall zeroes the half-offset row above the low y face
    assert not masks[1]["mask:hz"][5, 0].any() \
        and masks[1]["mask:hz"][5, 1] == 1


# ---------------------------------------------------------------------------
# against the port's own full cell
# ---------------------------------------------------------------------------


def _tm(sym, align, comp, sources, until=6.05, **kw):
    """A 4 x 3.6 (or 3.5) cell at resolution 10 with an eps=4 block on
    the plane and PML 0.5; `sources` [(y, amplitude)] of `comp` at x = -0.8;
    Mirror(Y) of the alignment when `sym`; a flux line across the plane."""
    ny, phase = ALIGN[align]
    ny = ny - 14
    mp = mtt
    sim = mp.Simulation(
        cell_size=mp.Vector3(4, ny / 10), resolution=10,
        geometry=[mp.Block(center=mp.Vector3(0.7, 0),
                           size=mp.Vector3(0.6, 1.2, mp.inf),
                           material=mp.Medium(epsilon=4))],
        sources=[mp.Source(mp.GaussianSource(1.0, fwidth=0.5), comp,
                           center=mp.Vector3(-0.8, y), amplitude=a)
                 for y, a in sources],
        boundary_layers=[mp.PML(0.5)], device="cpu",
        symmetries=[mp.Mirror(mp.Y, phase=phase)] if sym else [], **kw)
    fl = sim.add_flux(1.0, 0.5, 3, mp.FluxRegion(
        center=mp.Vector3(1.2, 0), size=mp.Vector3(0, ny / 10 - 1.2)))
    return sim, fl, mp.Vector3(4, ny / 10)


#: alignment -> a source component consistent with the symmetry on the
#: plane (phase times its parity under the y mirror is +1) and the
#: components its fields have
ON_PLANE = {"metal": ("ey", ("hz", "ey", "ex")),
            "magnetic": ("ez", ("ez", "hx", "hy")),
            "node": ("ez", ("ez", "hx", "hy"))}


@pytest.mark.parametrize("align", sorted(ALIGN))
def test_folded_run_equals_the_full_cell(align):
    """A source on the plane: the half cell, unfolded, equals the full
    cell (every field the scene has, to 1e-4 of its maximum), and so does
    the flux through the plane."""
    src, comps = ON_PLANE[align]
    out = []
    for sym in (False, True):
        sim, fl, cell = _tm(sym, align, src, [(0.0, 1.0)])
        sim.run(until=6.05)
        out.append((sim, {c: sim.get_array(c, center=mtt.Vector3(),
                                           size=cell) for c in comps},
                    sim.get_fluxes(fl)))
    (full, a, fa), (half, b, fb) = out
    assert half.gv.num[1] < 0.6 * full.gv.num[1]
    for c in comps:
        _close(b[c], a[c], c)
    _close(fb, fa, "flux")
    _close(half.get_epsilon()[:, :full.gv.num[1] + 1],
           full.get_epsilon(), "eps", tol=0.0)
    np.testing.assert_array_equal(half.get_mu(), 1.0)
    assert half.get_mu().shape[1] > full.gv.num[1]        # unfolded


@pytest.mark.parametrize("align", sorted(ALIGN))
def test_dropped_half_source_probe_and_point_fold(align):
    """A source in the dropped half folds onto the retained half with phase
    times its parity: the half cell equals a full cell holding the source
    and its image.  get_field_point and a Harminv collector at a point in
    the dropped half read the folded value (Hx: odd parity)."""
    ny, phase = ALIGN[align]
    pt = mtt.Vector3(0.45, -0.55)
    out = []
    for sym in (False, True):
        srcs = [(-0.6, 1.0)] + ([] if sym else [(0.6, float(phase))])
        sim, fl, cell = _tm(sym, align, "ez", srcs)
        h = mtt.Harminv(mtt.Hx, pt, 1.0, 0.5)
        sim.run(h, until=6.05)
        out.append((sim.get_array(mtt.Ez, center=mtt.Vector3(), size=cell),
                    sim.get_field_point(mtt.Hx, pt), np.asarray(h.data),
                    sim.get_fluxes(fl)))
    (a, pa, ha, fa), (b, pb, hb, fb) = out
    _close(b, a, "ez")
    _close(fb, fa, "flux")
    _close(hb, ha, "harminv series")
    assert pb == pytest.approx(pa, abs=1e-4 * np.abs(ha).max())
    assert abs(pa) > 1e-3 * np.abs(ha).max()


def test_near2far_on_a_node_mirror_equals_the_full_cell():
    """A near2far box around a source on a node mirror's plane: the folded
    cell stores the retained faces (the y < 0 face is dropped, the x faces
    clipped) and the far-field sum adds their mirror images; the far fields
    equal the full cell's to 2e-3 (tests/test_near2far.py:191)."""
    far = []
    for sym in (False, True):
        sim = mtt.Simulation(
            cell_size=mtt.Vector3(6, 6), resolution=10,
            sources=[mtt.Source(mtt.GaussianSource(0.6, fwidth=0.3), mtt.Ez,
                                center=mtt.Vector3())],
            boundary_layers=[mtt.PML(1.0)], device="cpu",
            symmetries=[mtt.Mirror(mtt.Y)] if sym else [])
        s = 1.5
        h = sim.add_near2far(0.6, 0, 1, *[
            mtt.Near2FarRegion(center=c, size=sz, weight=w)
            for c, sz, w in ((mtt.Vector3(s, 0), mtt.Vector3(0, 2 * s), 1),
                             (mtt.Vector3(-s, 0), mtt.Vector3(0, 2 * s), -1),
                             (mtt.Vector3(0, s), mtt.Vector3(2 * s, 0), 1),
                             (mtt.Vector3(0, -s), mtt.Vector3(2 * s, 0),
                              -1))])
        sim.run(until=20.05)
        far.append(np.array([sim.get_farfield(h, mtt.Vector3(
            40 * np.cos(t), 40 * np.sin(t)))
            for t in np.linspace(-1.4, np.pi / 2, 5)]))
        if sym:
            assert len(h.surfaces) < len(full_surfaces)
        full_surfaces = h.surfaces
    _close(far[1], far[0], "far fields", tol=2e-3)


def test_alignment_and_straddle_errors():
    """As tests/test_symmetry.py:67-102 for the JAX package."""
    kw = dict(resolution=10, device="cpu")
    with pytest.raises(ValueError, match="even cell count"):
        mtt.Simulation(cell_size=mtt.Vector3(8, 8.1),
                       symmetries=[mtt.Mirror(mtt.Y, phase=-1)], **kw)
    sim = mtt.Simulation(cell_size=mtt.Vector3(8, 8),
                         symmetries=[mtt.Mirror(mtt.Y, phase=+1)], **kw)
    assert sim._mirror_node == {1}
    mtt.Simulation(cell_size=mtt.Vector3(8, 8),
                   symmetries=[mtt.Identity(mtt.X)], **kw)
    for y in (-0.5, 0.5):            # dropped and retained side
        sim = mtt.Simulation(
            cell_size=mtt.Vector3(8, 8),
            sources=[mtt.Source(mtt.GaussianSource(0.5, fwidth=0.2),
                                mtt.Ez, center=mtt.Vector3(0, y),
                                size=mtt.Vector3(0, 4))],
            symmetries=[mtt.Mirror(mtt.Y, phase=-1)], **kw)
        with pytest.raises(ValueError, match="straddles"):
            sim.init_sim()
    sim = mtt.Simulation(cell_size=mtt.Vector3(8, 8),
                         symmetries=[mtt.Mirror(mtt.Y)], **kw)
    with pytest.raises(ValueError, match="straddles"):
        sim.add_flux(0.5, 0.2, 1, mtt.FluxRegion(center=mtt.Vector3(0, 0.5),
                                                 size=mtt.Vector3(0, 3)))
    with pytest.raises(ValueError, match="dropped half"):
        sim.add_dft_fields([mtt.Ez], 0.5, 0.2, 1, center=mtt.Vector3(),
                           size=mtt.Vector3(1, 1))
    # the rotations' alignment: the rotation axis on whole sites
    for rot in (mtt.Rotate2, mtt.Rotate4):
        with pytest.raises(ValueError, match="even cell count"):
            mtt.Simulation(cell_size=mtt.Vector3(8.1, 8.1),
                           symmetries=[rot(mtt.Z)], **kw)


# ---------------------------------------------------------------------------
# the routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axes,route", [("yz", "hybrid"), ("x", "eager")])
def test_3d_mirrored_plans_take_the_reference_routes(axes, route):
    """A y/z-mirrored 3D plan runs on the hybrid route (K2 and K1, their
    plain versions here); an x mirror is declined by K1/K2 and runs on the
    eager stepper, as the reference's hybrid._get_kernel sends it to the
    jnp path.  (The resident route is kept off with a zero budget, so that
    the small cell reaches these routes.)"""
    from meep_nl_tpu_torch.ops import resident as R
    budget, R.VMEM_BUDGET = R.VMEM_BUDGET, 0
    try:
        sim = mtt.Simulation(
            cell_size=mtt.Vector3(2, 1.5, 1.5), resolution=8,
            sources=[mtt.Source(mtt.GaussianSource(1.0, fwidth=1.0), mtt.Ex,
                                center=mtt.Vector3(0.3, 0, 0))],
            boundary_layers=[mtt.PML(0.25)], device="cpu",
            symmetries=[mtt.Mirror(d) for d in axes])
        sim.run(until=11 * sim.dt)
    finally:
        R.VMEM_BUDGET = budget
    assert dict(sim.routes) == {route: 1}
    assert HY.hybrid_applicable(sim.plan) == (route == "hybrid")
    if route == "hybrid":
        assert sum(HY.hybrid_routes(sim.plan).values()) == 1
