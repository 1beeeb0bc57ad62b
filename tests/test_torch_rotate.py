"""Rotational symmetry in the port (meep_nl_tpu_torch, device="cpu") against
the JAX package (meep_nl_tpu, its jnp stepper on the CPU) and against the
port's own full cell.

`Simulation(symmetries=[Rotate2(w)])` halves the cell along the first axis
perpendicular to w, `[Rotate4(w)]` quarters a square cell in the plane
perpendicular to w; the rotation axis lies on whole sites at the retained
part's low faces, and the D curl's backward differences across those
planes read the C2 ghost (the partner flipped over the flip axis) or the
C4 ghost (the x<->y-swapped partner, transposed) of step.rot2_ghost /
rot4_ghost.  Each feature is compared with the JAX package once, on the
8 x 8 cell at resolution 10 of the reference's tests/test_rot2.py and
test_rot4.py, 121 steps (not a multiple of 4, which the JAX package's run
would unroll 4 times): C2 at phases +1 and -1 (a source in each half, the
dropped one folded; fields, a flux line in each half, a C2-centred energy
box, point queries in the dropped half, get_epsilon), C4 with its
in-plane get_array (TE, a source outside the quadrant turned into it),
and C2 in 3D (test_rot2_3d_small's cell), to 1e-4 of their maximum.
Further cases hold the folded runs against the port's own full cell
carrying the source's C2 or C4 images (3e-6 of the maximum, as the
reference's tests gate), the monitors' folds, the point folds, the
rejections and the routes."""

import numpy as np
import pytest
import torch

import meep_nl_tpu as mnt
import meep_nl_tpu_torch as mtt
from meep_nl_tpu_torch.ops import fdtd3d, fdtd3d_t2, fused
from meep_nl_tpu_torch.ops import resident as R

torch.set_num_threads(2)

#: 121 steps at resolution 10 (Courant 0.5)
UNTIL = 6.05


def _close(got, want, what, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    assert scale > 0, what
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} vs max {scale:.3e}"


def _src(mp, comp, x, y, amp=1.0, z=None):
    return mp.Source(mp.GaussianSource(frequency=1.0, fwidth=0.5),
                     component=comp, amplitude=amp,
                     center=mp.Vector3(x, y) if z is None
                     else mp.Vector3(x, y, z))


def _geom2d(mp, pts):
    return [mp.Cylinder(radius=0.47, center=mp.Vector3(*p),
                        material=mp.Medium(epsilon=4)) for p in pts]


# ---------------------------------------------------------------------------
# against the JAX package, once per feature
# ---------------------------------------------------------------------------


def rot2_scene(mp, phase, **kw):
    """The reference's C2 scene (tests/test_rot2.py): two eps=4 cylinders,
    C2 images of each other, an Ez source at (1.23, 0.71) and a second at
    (-1.23, 0.4) in the dropped half (folded onto the retained one);
    Rotate2("z", phase); a y-normal flux line in each half, a C2-centred
    energy box.  Returns the outputs."""
    sim = mp.Simulation(
        cell_size=mp.Vector3(8, 8, 0), resolution=10,
        boundary_layers=[mp.PML(1.0)],
        geometry=_geom2d(mp, [(0.9, -0.9), (-0.9, 0.9)]),
        sources=[_src(mp, mp.Ez, 1.23, 0.71),
                 _src(mp, mp.Ez, -1.23, 0.4, amp=0.5)],
        symmetries=[mp.Rotate2("z", phase=phase)], eps_averaging=False,
        **kw)
    hi = sim.add_flux(1.0, 0.4, 3, mp.FluxRegion(
        center=mp.Vector3(1.75, 2.2), size=mp.Vector3(2.5, 0),
        direction="y"))
    lo = sim.add_flux(1.0, 0.4, 3, mp.FluxRegion(
        center=mp.Vector3(-1.75, -2.2), size=mp.Vector3(2.5, 0),
        direction="y"))
    en = sim.add_energy(1.0, 0.4, 2, mp.EnergyRegion(
        center=mp.Vector3(), size=mp.Vector3(4.0, 4.0)))
    sim.run(until=UNTIL)
    return {"ez": sim.get_array(component=mp.Ez),
            "hx": sim.get_array(component=mp.Hx),
            "flux_hi": sim.get_fluxes(hi), "flux_lo": sim.get_fluxes(lo),
            "energy": sim.get_electric_energy(en),
            "eps": sim.get_epsilon(),
            "pts": [sim.get_field_point(c, mp.Vector3(*p))
                    for c in (mp.Ez, mp.Hy)
                    for p in ((-1.3, 0.7), (-0.9, -1.7))]}


@pytest.mark.parametrize("phase", [1, -1])
def test_rot2_matches_jax(phase):
    """At phase -1 the reference multiplies the folded monitors by the
    phase (ROADMAP C.3): its flux through the dropped half's line comes
    back negated and its C2-centred energy 0; the port's equal the full
    cell's there (test_monitor_folds_equal_the_full_cell[rot2--1])."""
    a = rot2_scene(mnt, phase)
    b = rot2_scene(mtt, phase, device="cpu")
    for k in ("ez", "hx", "flux_hi", "eps"):
        _close(b[k], np.asarray(a[k]), k)
    _close(b["flux_lo"], phase * np.asarray(a["flux_lo"]), "flux_lo")
    if phase == 1:
        _close(b["energy"], np.asarray(a["energy"]), "energy")
    else:
        assert not np.any(np.asarray(a["energy"])) and np.all(
            b["energy"] > 0)
    scale = max(abs(v) for v in a["pts"])
    for va, vb in zip(a["pts"], b["pts"]):
        assert abs(va - vb) <= 1e-4 * scale, (va, vb)


def rot4_scene(mp, **kw):
    """The reference's C4 TE scene (tests/test_rot4.py
    test_rot4_inplane_get_array) at phase -1: an Hz source outside the
    retained quadrant (turned into it), an eps=4 cylinder in the quadrant
    (and its C4 orbit through the fold); a flux line in the quadrant.
    Returns the outputs: the in-plane Ex / Ey unfolded on the raw lattice
    and collapsed, Hz, a point query of the swapped component."""
    sim = mp.Simulation(
        cell_size=mp.Vector3(8, 8, 0), resolution=10,
        boundary_layers=[mp.PML(1.0)],
        geometry=_geom2d(mp, [(0.9, 1.6)]),
        sources=[_src(mp, mp.Hz, -0.71, 1.23)],
        symmetries=[mp.Rotate4("z", phase=-1)], eps_averaging=False, **kw)
    fl = sim.add_flux(1.0, 0.4, 3, mp.FluxRegion(
        center=mp.Vector3(2.0, 1.5), size=mp.Vector3(0, 2.0)))
    sim.run(until=UNTIL)
    out = {f"{c}{s}": sim.get_array(component=c, snap=s)
           for c in (mp.Ex, mp.Ey) for s in (False, True)}
    out.update(hz=sim.get_array(component=mp.Hz),
               hz_raw=sim.get_array(component=mp.Hz, snap=True),
               flux=sim.get_fluxes(fl),
               pt=sim.get_field_point(mp.Ex, mp.Vector3(-1.3, -0.7)))
    return out


def test_rot4_matches_jax():
    """The C4 fold with its swapped-component ghosts and in-plane unfold.
    Hz on the raw lattice (get_array(snap=True)) is the port's own: the
    reference's unfold adds the C4 image of the centred lattice's
    fold-edge row to the raw lattice's first half-site row (ROADMAP C.3),
    so there it is held against the port's full cell
    (test_folded_equals_the_full_cell[rot4-te])."""
    a = rot4_scene(mnt)
    b = rot4_scene(mtt, device="cpu")
    for k in ("exFalse", "exTrue", "eyFalse", "eyTrue", "hz", "flux"):
        _close(b[k], np.asarray(a[k]), k)
    assert abs(b["pt"] - a["pt"]) <= 1e-4 * float(np.abs(a["exFalse"]).max())
    # the reference's raw-lattice Hz differs on the half-site rows next to
    # the fold planes, and agrees away from them
    raw_a, raw_b = np.asarray(a["hz_raw"]), b["hz_raw"]
    assert raw_a.shape == raw_b.shape
    n = raw_a.shape[0] // 2
    off = np.ones(raw_a.shape, bool)
    off[[n - 1, n], :] = off[:, [n - 1, n]] = False
    _close(raw_b[off], raw_a[off], "hz raw, away from the planes")
    assert np.abs(raw_b - raw_a).max() > 1e-2 * np.abs(raw_a).max()


def rot2_3d(mp, sym, **kw):
    """tests/test_rot2.py's 3D cell: 4^3 at resolution 8, PML 0.75, an Ez
    source at (0.81, 0.42, 0) and, without the symmetry, its C2 image."""
    srcs = [_src(mp, mp.Ez, 0.81, 0.42, z=0.0)]
    if not sym:
        srcs.append(_src(mp, mp.Ez, -0.81, -0.42, z=0.0))
    sim = mp.Simulation(
        cell_size=mp.Vector3(4, 4, 4), resolution=8,
        boundary_layers=[mp.PML(0.75)], sources=srcs,
        symmetries=[mp.Rotate2("z")] if sym else [], eps_averaging=False,
        **kw)
    sim.run(until=2.9375)                          # 47 steps
    return sim


def test_rot2_3d_matches_jax():
    a = rot2_3d(mnt, True)
    b = rot2_3d(mtt, True, device="cpu")
    assert b.plan.rot2 == (0, 1, "z", 1) and b.routes == {"resident": 1}
    for c in (mtt.Ez, mtt.Hx):
        _close(b.get_array(component=c), np.asarray(a.get_array(
            component=c)), c)
    # and the port's full cell
    full = rot2_3d(mtt, False, device="cpu")
    _close(b.get_array(component=mtt.Ez),
           full.get_array(component=mtt.Ez), "3d fold vs full", 3e-6)


# ---------------------------------------------------------------------------
# against the port's own full cell
# ---------------------------------------------------------------------------


def _images(sym, phase, comp, x, y):
    """The source at (x, y) and its C2 or C4 images with their amplitudes
    (a rotation-axis component: phase^k)."""
    if sym == "rot2":
        return [(x, y, 1.0), (-x, -y, float(phase))]
    pts = [(x, y), (-y, x), (-x, -y), (y, -x)]
    return [(px, py, float(phase) ** k) for k, (px, py) in enumerate(pts)]


def fold_pair(sym, phase, comp, geom_pts=(), cell=(8, 8), res=10,
              until=UNTIL):
    """(folded, full) port simulations: a source at (1.23, 0.71) of `comp`
    (its images in the full cell), cylinders at `geom_pts` and their
    images, Rotate2 / Rotate4("z", phase)."""
    out = []
    for folded in (True, False):
        imgs = _images(sym, phase, comp, 1.23, 0.71)
        gimg = [p[:2] for g in geom_pts
                for p in _images(sym, 1, comp, *g)]
        R_ = mtt.Rotate2 if sym == "rot2" else mtt.Rotate4
        sim = mtt.Simulation(
            cell_size=mtt.Vector3(*cell), resolution=res,
            boundary_layers=[mtt.PML(1.0)], geometry=_geom2d(mtt, gimg),
            sources=[_src(mtt, comp, px, py, amp)
                     for px, py, amp in (imgs[:1] if folded else imgs)],
            symmetries=[R_("z", phase=phase)] if folded else [],
            eps_averaging=False, device="cpu")
        sim.run(until=until)
        out.append(sim)
    return out


@pytest.mark.parametrize("case", ["rot2-tm", "rot2-te", "rot4-tm",
                                  "rot4-te"])
def test_folded_equals_the_full_cell(case):
    """Every component, on the centred and (C4) the raw lattice, equals
    the full C2 / C4-symmetric cell to 3e-6 of its maximum, phase -1 on
    the TE cases; with geometry on the TM ones."""
    sym, pol = case.split("-")
    phase = 1 if pol == "tm" else -1
    comp = mtt.Ez if pol == "tm" else mtt.Hz
    geom = [(0.9, 1.6)] if pol == "tm" else []
    half, full = fold_pair(sym, phase, comp, geom)
    comps = (mtt.Ez, mtt.Hx, mtt.Hy) if pol == "tm" else \
        (mtt.Hz, mtt.Ex, mtt.Ey)
    for c in comps:
        for snap in (False, True):
            _close(half.get_array(component=c, snap=snap),
                   full.get_array(component=c, snap=snap),
                   f"{case} {c} snap={snap}", 3e-6)
    # point queries anywhere, the dropped part's through the fold
    for c in comps:
        for p in ((-1.3, 0.7), (-0.9, -1.7), (1.1, -0.4), (0.6, 1.9)):
            va = full.get_field_point(c, mtt.Vector3(*p))
            vb = half.get_field_point(c, mtt.Vector3(*p))
            assert abs(va - vb) <= 5e-6 * max(abs(va), 1e-2), (c, p)
    if pol == "tm" or sym == "rot2":      # (C4 TE: no lattice whole on
        _close(half.get_epsilon(), full.get_epsilon(), "eps", 1e-6)
                                          # both axes, the quadrant comes
                                          # back as it is)


def test_rot4_3d_equals_the_full_cell():
    """A 3D quarter cell about z (every ghost pair hx<->hy, hz, both folds;
    square x-y storage, no x padding) against the full cell."""
    def run(sym):
        imgs = _images("rot4", 1, mtt.Ez, 0.9, 0.35)
        sim = mtt.Simulation(
            cell_size=mtt.Vector3(4, 4, 2), resolution=8,
            boundary_layers=[mtt.PML(0.5)],
            sources=[_src(mtt, mtt.Ez, x, y, a, z=0.1)
                     for x, y, a in (imgs[:1] if sym else imgs)],
            symmetries=[mtt.Rotate4("z")] if sym else [],
            eps_averaging=False, device="cpu")
        sim.run(until=2.5)
        return sim
    half, full = run(True), run(False)
    assert half.plan.storage_shape in (None, (17, 17, 17))
    for c in (mtt.Ez, mtt.Hx, mtt.Ey):
        _close(half.get_array(component=c), full.get_array(component=c),
               c, 3e-6)


@pytest.mark.parametrize("sym,phase", [("rot2", 1), ("rot2", -1),
                                       ("rot4", -1)])
def test_monitor_folds_equal_the_full_cell(sym, phase):
    """C2: a flux line in the dropped half (its image with the product's
    parity), a C2-centred energy box (clipped, factor 1 + parity), a force
    line; C4: monitors in the quadrant; each equals the full cell's, the
    dft fields in the retained part too, at phase +1 and -1."""
    def run(folded):
        imgs = _images(sym, phase, mtt.Ez, 1.23, 0.71)
        R_ = mtt.Rotate2 if sym == "rot2" else mtt.Rotate4
        sim = mtt.Simulation(
            cell_size=mtt.Vector3(8, 8), resolution=10,
            boundary_layers=[mtt.PML(1.0)],
            sources=[_src(mtt, mtt.Ez, x, y, a)
                     for x, y, a in (imgs[:1] if folded else imgs)],
            symmetries=[R_("z", phase=phase)] if folded else [],
            eps_averaging=False, device="cpu")
        h = {"flux": sim.add_flux(1.0, 0.4, 3, mtt.FluxRegion(
                 center=mtt.Vector3(2.0, 1.0), size=mtt.Vector3(0, 1.6))),
             "en": sim.add_energy(1.0, 0.4, 2, mtt.EnergyRegion(
                 center=mtt.Vector3(1.5, 1.5), size=mtt.Vector3(1.0, 1.2))),
             "force": sim.add_force(1.0, 0.4, 2, mtt.ForceRegion(
                 center=mtt.Vector3(2.2, 1.4), size=mtt.Vector3(0, 1.0),
                 direction=mtt.Y)),
             "dft": sim.add_dft_fields([mtt.Ez], 1.0, 0.4, 2,
                                       center=mtt.Vector3(1.0, 1.0),
                                       size=mtt.Vector3(0.8, 0.6))}
        if sym == "rot2":
            h["dropped"] = sim.add_flux(1.0, 0.4, 3, mtt.FluxRegion(
                center=mtt.Vector3(-1.75, -2.2), size=mtt.Vector3(2.5, 0)))
            h["box"] = sim.add_energy(1.0, 0.4, 2, mtt.EnergyRegion(
                center=mtt.Vector3(), size=mtt.Vector3(3.0, 3.0)))
        sim.run(until=UNTIL)
        out = {k: sim.get_fluxes(v) for k, v in h.items()
               if k in ("flux", "dropped")}
        out.update(force=sim.get_forces(h["force"]),
                   en=sim.get_total_energy(h["en"]),
                   dft=sim.get_dft_array(h["dft"], mtt.Ez))
        if "box" in h:
            out["box"] = sim.get_electric_energy(h["box"])
        return out
    half, full = run(True), run(False)
    for k in full:
        _close(half[k], full[k], k, 1e-5)


def test_probes_fold_and_route_through_the_resident_kernel():
    """A Harminv probe of Ex in a dropped quadrant folds onto the swapped
    component Ey with the rotation sign, and the probed run stays on the
    resident route; its series equals the full cell's."""
    pt = mtt.Vector3(-0.6, 1.1)               # one quarter turn from (1.1, 0.6)

    def run(folded):
        imgs = _images("rot4", -1, mtt.Hz, 1.23, 0.71)
        sim = mtt.Simulation(
            cell_size=mtt.Vector3(8, 8), resolution=10,
            boundary_layers=[mtt.PML(1.0)],
            sources=[_src(mtt, mtt.Hz, x, y, a)
                     for x, y, a in (imgs[:1] if folded else imgs)],
            symmetries=[mtt.Rotate4("z", phase=-1)] if folded else [],
            eps_averaging=False, device="cpu")
        h = mtt.Harminv(mtt.Ex, pt, 1.0, 0.5)
        sim.run(h, until=UNTIL)
        return sim, np.asarray(h.data)
    (half, a), (full, b) = run(True), run(False)
    assert half.routes == {"resident": 1}
    probe = half._point_probe("p", mtt.Ex, pt)
    assert probe.component == "ey" and probe.weights.sum() > 0
    _close(a, b, "Harminv series", 3e-6)


def test_rejections():
    """What the reference refuses (tests/test_rot2.py, test_rot4.py): odd
    counts, a non-square Rotate4 cell, combinations with Mirror or another
    rotation, rotations of 1D cells, chi2/chi3 media, in-plane sources
    outside the C4 quadrant, straddling sources, monitors outside the
    wedge or straddling the C2 fold asymmetrically, dft fields and
    near2far surfaces in the dropped part."""
    V = mtt.Vector3

    def sim(cell=V(8, 8), syms=(mtt.Rotate2("z"),), **kw):
        return mtt.Simulation(cell_size=cell, resolution=10,
                              symmetries=list(syms), device="cpu", **kw)
    with pytest.raises(ValueError):
        sim(V(8.1, 8))                                   # odd fold count
    with pytest.raises(ValueError):
        sim(V(8, 6), [mtt.Rotate4("z")])                 # not square
    with pytest.raises(ValueError):
        sim(V(8.1, 8.1), [mtt.Rotate4("z")])             # odd counts
    for syms in ([mtt.Rotate2("z"), mtt.Mirror("y")],
                 [mtt.Mirror("y"), mtt.Rotate2("z")],
                 [mtt.Rotate2("z"), mtt.Rotate4("z")]):
        with pytest.raises(NotImplementedError):
            sim(syms=syms)
    with pytest.raises(NotImplementedError):
        sim(V(0, 0, 8), [mtt.Rotate2("x")])              # 1D
    with pytest.raises(ValueError):
        sim(V(8, 8), [mtt.Rotate2("x")])                 # no z axis in 2D
    for R_ in (mtt.Rotate2, mtt.Rotate4):
        s = sim(syms=[R_("z")], geometry=[mtt.Cylinder(
            radius=0.5, center=V(0.9, 0.9),
            material=mtt.Medium(epsilon=4, chi3=0.1))],
            sources=[_src(mtt, mtt.Ez, 1.23, 0.71)])
        with pytest.raises(NotImplementedError, match="chi2/chi3"):
            s.init_sim()
    with pytest.raises(ValueError, match="in-plane"):
        sim(syms=[mtt.Rotate4("z")],
            sources=[_src(mtt, mtt.Ex, -1.2, 0.7)]).init_sim()
    with pytest.raises(ValueError, match="straddles"):
        sim(sources=[mtt.Source(mtt.GaussianSource(1.0, fwidth=0.5),
                                mtt.Ez, center=V(0.5, 0.3),
                                size=V(2.0, 0))]).init_sim()
    s = sim(syms=[mtt.Rotate4("z")])
    with pytest.raises(ValueError, match="quadrant"):
        s.add_flux(1.0, 0, 1, mtt.FluxRegion(center=V(0, 2.0),
                                             size=V(3.0, 0)))
    with pytest.raises(ValueError, match="dropped half"):
        s.add_dft_fields([mtt.Ez], 1.0, 0, 1, center=V(1.0, 0),
                         size=V(1.0, 1.0))
    with pytest.raises(ValueError, match="retained wedge"):
        s.add_near2far(1.0, 0, 1, mtt.Near2FarRegion(center=V(1.0, 0),
                                                     size=V(0, 2.0)))
    s = sim()
    with pytest.raises(ValueError, match="asymmetrically"):
        s.add_flux(1.0, 0, 1, mtt.FluxRegion(center=V(0, 2.2),
                                             size=V(6.0, 0),
                                             direction="y"))


def test_routes():
    """2D and small 3D rotational plans take K3 (the direct schedule's
    variant with the ghosts); K1, K2 and K5 decline rotational plans, as
    the reference's do, so a 3D plan above the resident budget runs on
    the eager stepper (the hybrid route declines it); no route raises."""
    half, _ = fold_pair("rot2", 1, mtt.Ez, until=1.05)
    assert half.routes == {"resident": 1}
    plan = half.plan
    assert R.resident_supported(plan)
    sim = rot2_3d(mtt, True, device="cpu")
    plan = sim.plan
    assert sim.routes == {"resident": 1}
    assert not (fdtd3d.supported(plan) or fdtd3d_t2.supported(plan)
                or fused.takes(plan))
    R_plan = sim.plan
    saved = R.VMEM_BUDGET
    try:
        R.VMEM_BUDGET = 0
        assert not R.resident_supported(R_plan)
        sim.run(until=0.125)
    finally:
        R.VMEM_BUDGET = saved
    assert sim.routes == {"resident": 1, "eager": 1}
