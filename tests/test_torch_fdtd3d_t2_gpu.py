"""The K2 CUDA kernel against its plain version, both on the card.

Marked `gpu`: skips without a CUDA device (the kernel has no CPU mode).
Imports only the port, so it runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_fdtd3d_t2_gpu.py -m gpu

(`--noconftest`: tests/conftest.py imports jax.)

The kernel is built without FMA contraction and runs the plain version's
operation order, so the cases of `CASES` (shared with the host emulation
test_torch_fdtd3d_t2_emul.py) are held bit for bit in fp32 and to 1e-12 of
the field maximum in fp64, against the plain version on the host (where
its current sources accumulate repeated sites in entry order, which the
kernel keeps)."""

import numpy as np
import pytest
import torch

import meep_nl_tpu_torch as mp
from meep_nl_tpu_torch.ops import fdtd3d_t2 as T2
from meep_nl_tpu_torch.ops import resident as R
from meep_nl_tpu_torch.stepper import step as TS

from chip_smoke import nine_source_sim

NCALL = 2
T0 = 20             # near the source's peak: every stage's source row matters


def _sources(src):
    """Ez point sources (src a component: one of it), or "many": 11
    current sources of both families, each with its own frequency, two
    pairs of them on the same spot (repeated sites across sources) and
    several whose interpolation stencils straddle the y = 8, 16 and z = 8,
    16 tile edges of a 24-site plane (the card's tiles and the host
    emulation's 4 x 8 ones)."""
    if src != "many":
        return [mp.Source(mp.GaussianSource(1.0, fwidth=1.0), component=src,
                          center=mp.Vector3(-1.2, 0, 0))]
    spots = [(-1.2, -0.5, 0.0), (-0.9, 0.5, -0.5), (-0.3, 0.0, 0.5),
             (0.2, -0.5, -0.5), (0.6, 0.3, 0.1), (1.1, -0.2, 0.5),
             (-1.2, -0.5, 0.0), (0.6, 0.3, 0.1), (0.0, 0.5, 0.0),
             (0.9, -0.5, 0.5), (-0.6, 0.1, -0.5)]
    comps = [mp.Ez, mp.Hz, mp.Ex, mp.Hy, mp.Ez, mp.Ez, mp.Ez, mp.Hz,
             mp.Hx, mp.Ey, mp.Hz]
    return [mp.Source(mp.GaussianSource(1.0 + 0.02 * i, fwidth=1.0),
                      component=c, center=mp.Vector3(*at),
                      amplitude=np.exp(0.4j * i))
            for i, (c, at) in enumerate(zip(comps, spots))]


def _plan(scene, device, dtype=np.float32, src=mp.Ez):
    """A 32x24x24 cell with PML on every face; scene "flagship" adds the
    eps=4 ball with a Lorentz pole and full-tensor chi2, "mu" a mu=2 ball
    (has_u on the H specs), "poles" a ball with a Lorentz and a Drude
    pole; `src` as `_sources`.  A suffix "+y" / "+yz" declares Mirror(Y)
    (and Mirror(Z)) with phase +1: the cell is halved there, the planes on
    whole sites (node mirrors, the fold ghost in the D sub-update), the
    PML on the high side only, the ball's nonlinear box on the planes.
    "wrap" / "wrap-edge": a 4 x 2 x 2 cell Bloch-periodic along x (k_x =
    0: phase +1; 1/8: -1; 32 live planes, 8 dead ones) with PML on y and z
    only and an eps=4 ball: K2's x-wrap variant."""
    scene, _, mirrors = scene.partition("+")
    symmetries = [mp.Mirror(d) for d in mirrors]
    geometry = []
    kw = {"boundary_layers": [mp.PML(0.5)]}
    cell = mp.Vector3(4, 3, 3)
    if scene.startswith("wrap"):
        cell = mp.Vector3(4, 2, 2)
        kw = {"boundary_layers": [mp.PML(0.5, direction=mp.Y),
                                  mp.PML(0.5, direction=mp.Z)],
              "k_point": mp.Vector3(0.125 if scene == "wrap-edge" else 0.0)}
        geometry = [mp.Sphere(0.6, material=mp.Medium(epsilon=4.0))]
    if scene == "flagship":
        med = mp.Medium(epsilon=4.0, chi2=0.05, chi2_full_tensor=True,
                        E_susceptibilities=[mp.LorentzianSusceptibility(
                            frequency=2.0, gamma=0.05, sigma=0.2)])
        geometry = [mp.Sphere(0.6, material=med)]
    elif scene == "mu":
        geometry = [mp.Sphere(0.6, material=mp.Medium(epsilon=2.0, mu=2.0))]
    elif scene == "poles":
        med = mp.Medium(epsilon=2.0, E_susceptibilities=[
            mp.LorentzianSusceptibility(frequency=2.0, gamma=0.05,
                                        sigma=0.2),
            mp.DrudeSusceptibility(frequency=1.5, gamma=0.1, sigma=0.1)])
        geometry = [mp.Sphere(0.6, material=med)]
    sim = mp.Simulation(
        cell_size=cell, resolution=8, geometry=geometry,
        sources=_sources(src), eps_averaging=False, device=device,
        dtype=dtype, symmetries=symmetries, **kw)
    sim.init_sim()
    sim.plan.slab_opt = True
    return sim.plan


def _random_state(plan, seed):
    rng = np.random.default_rng(seed)
    st = TS.init_state(plan)

    def rnd(t):
        return torch.from_numpy(1e-2 * rng.standard_normal(
            tuple(t.shape)).astype(plan.dtype)).to(t.device)

    st["f"] = {c: TS._apply_mask(plan, plan.coefs, c, rnd(t))
               for c, t in st["f"].items()}
    for key in ("f_u", "f_w"):
        st[key] = {c: rnd(t) for c, t in st[key].items()}
    st["pol"] = [{k: {c: rnd(t) for c, t in e[k].items()}
                  for k in ("p", "pp")} for e in st["pol"]]
    return st


def _clone(st):
    return {**st, **{k: {c: t.clone() for c, t in st[k].items()}
                     for k in ("f", "f_u", "f_w")},
            "pol": [{k: {c: t.clone() for c, t in e[k].items()}
                     for k in ("p", "pp")} for e in st["pol"]]}


def _host(st):
    return {**st, **{k: {c: t.cpu().clone() for c, t in st[k].items()}
                     for k in ("f", "f_u", "f_w")},
            "pol": [{k: {c: t.cpu().clone() for c, t in e[k].items()}
                     for k in ("p", "pp")} for e in st["pol"]]}


#: case -> (scene, depth, capture planes, dtype, sources, x-planes per
#: item).  Capture planes: None, "mon" (monitor-like planes in the cell and
#: on x = 0 and S0 - 1) or "chunk" (also on both sides of every chunk edge
#: of `ch` = 5); every capture plane crosses the tile edges in y and z.
#: The flagship scenes have a nonlinear box, so their items split into the
#: two classes (h = 2 around the ball, h = 1 elsewhere).  The "mirror"
#: cases fold the cell on y and z (or y): their items' halo stages cross
#: the planes, each stage reading its own fold ghost.  The "wrap" cases
#: are x-periodic (K2's x-wrap variant, depth 2 as PeriodicXT2Kernel
#: drives it): the chunks next to x = 0 and x = 32 read their halo across
#: the wrap at phase +1 and -1, the dead planes 32-39 form chunks of their
#: own, and `ch` puts chunk edges on both sides of the wrap.
CASES = {
    "upml-d2": ("vacuum", 2, None, np.float32, mp.Ez, None),
    "upml-d3-caps": ("vacuum", 3, "mon", np.float32, mp.Ez, None),
    "flagship-d2-caps": ("flagship", 2, "mon", np.float32, mp.Ez, None),
    "flagship-d3": ("flagship", 3, None, np.float32, mp.Ez, None),
    "flagship-d3-caps-fp64": ("flagship", 3, "mon", np.float64, mp.Ez, None),
    "upml-d2-fp64": ("vacuum", 2, None, np.float64, mp.Ez, None),
    "h-source-d3-caps": ("vacuum", 3, "mon", np.float32, mp.Hz, None),
    "mu-d3": ("mu", 3, None, np.float32, mp.Ez, None),
    "flagship-d3-caps-ch3": ("flagship", 3, "mon", np.float32, mp.Ez, 3),
    "flagship-d2-ch40": ("flagship", 2, None, np.float32, mp.Ez, 40),
    "many-sources-d3-caps": ("vacuum", 3, "mon", np.float32, "many", None),
    "many-sources-flagship-d2": ("flagship", 2, None, np.float32, "many",
                                 4),
    "chunk-edges-d3-caps": ("flagship", 3, "chunk", np.float32, mp.Ez, 5),
    "two-poles-d3-caps": ("poles", 3, "mon", np.float32, mp.Ez, 7),
    "mirror-yz-flagship-d3-caps": ("flagship+yz", 3, "mon", np.float32,
                                   mp.Ex, None),
    "mirror-y-flagship-d2": ("flagship+y", 2, None, np.float32, mp.Ex, 5),
    "mirror-yz-upml-d3": ("vacuum+yz", 3, None, np.float32, mp.Ex, None),
    "wrap-x-edge-d2-ch5": ("wrap-edge", 2, None, np.float32, mp.Ez, 5),
    "wrap-x-edge-d2-fp64-ch3": ("wrap-edge", 2, None, np.float64, mp.Ez, 3),
    "wrap-x-d2-many-ch4": ("wrap", 2, None, np.float32, "many", 4),
}


def case_planes(kind, plan, ch):
    if kind is None:
        return None
    S0 = plan.storage_shape[0]
    planes = [("ey", 20), ("ez", 20), ("ez", 21), ("hy", 20), ("hz", 0),
              ("hz", S0 - 1)]
    if kind == "chunk":
        edges = range(ch, S0, ch)
        planes += [(c, x) for e in edges for c, x in
                   (("ez", e - 1), ("hy", e))]
    return planes


def hold_case(case, device, capture_step):
    """K2 (`capture_step(ker, state, rows)`, on a plan on `device`) against
    steps_ref on the host over NCALL calls of CASES[case] from one seeded
    random state: state and captures bit for bit in fp32, to 1e-12 of the
    field maximum in fp64.  Returns the kernel object."""
    scene, depth, kind, dtype, src, ch = CASES[case]
    plan = _plan(scene, device, dtype, src)
    ref_plan = _plan(scene, "cpu", dtype, src)
    planes = case_planes(kind, plan, ch)
    ker = T2.Fdtd3dT2Kernel(plan, depth=depth, cap_planes=planes, ch=ch,
                            allow_periodic_x=bool(plan.periodic[0]))
    ref = T2.steps_ref(ref_plan, depth, planes)
    xs = TS.build_xs(plan, NCALL * depth, T0)
    rows, ref_rows = TS.xs_rows(plan, xs), TS.xs_rows(ref_plan, xs)
    st0 = _random_state(plan, 9)
    scale = max(float(t.abs().max()) for t in st0["f"].values())
    tol = 0.0 if dtype == np.float32 else 1e-12 * scale

    def same(a, b, what):
        err = float((a.cpu() - b).abs().max())
        assert err <= tol, f"{what}: {err:.3e}"

    sk, sr = _clone(st0), _host(st0)
    for c in range(NCALL):
        sl = slice(c * depth, (c + 1) * depth)
        sk, ck = capture_step(ker, sk, rows[sl])
        sr, cr = ref(sr, ref_rows[sl])
        assert set(ck) == set(cr)
        for key in cr:
            same(ck[key], cr[key], f"call {c} {key}")
    assert int(sk["t"]) == NCALL * depth
    assert not torch.equal(sr["f"]["ez"], _host(st0)["f"]["ez"])
    for key in ("f", "f_u", "f_w"):
        for c, t in sr[key].items():
            same(sk[key][c], t, f"{key}[{c}]")
    for pk, pr in zip(sk["pol"], sr["pol"]):
        for k in ("p", "pp"):
            for c, t in pr[k].items():
                same(pk[k][c], t, f"pol {k}[{c}]")
    return ker


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_cuda(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    ker = hold_case(case, "cuda", lambda k, s, r: k.capture_step(s, r))
    torch.cuda.synchronize()
    assert ker.launches == NCALL * ker.launches_per_call
    assert ker.plain_steps == 0 and ker._k1.launches == 0
    if CASES[case][5] is not None:
        assert ker._cuda["ch"] == CASES[case][5]


@pytest.mark.gpu
def test_run_takes_the_residue_through_k1_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan = _plan("flagship", "cuda")
    ker = T2.Fdtd3dT2Kernel(plan, depth=3)
    st0 = _random_state(plan, 2)
    got = ker.run(_clone(st0), 8, t0=20)
    want = _clone(st0)
    step = T2.fdtd3d.step_ref(plan)
    for row in TS.xs_rows(plan, TS.build_xs(plan, 8, 20)):
        want = step(want, row)
    assert ker.launches == 2 * ker.launches_per_call
    assert ker._k1.launches == 2 * ker._k1.launches_per_step
    for key in ("f", "f_u", "f_w"):
        for c, t in want[key].items():
            assert torch.equal(got[key][c], t), f"{key}[{c}]"
    for c, t in want["pol"][0]["p"].items():
        assert torch.equal(got["pol"][0]["p"][c], t)


def _periodic_plan(device, kx):
    """A 3 x 2.5 x 2.5 cell at resolution 8 (24 x 20 x 20), Bloch-periodic
    along x (k_x = 0: phase +1; 1/6: -1), PML 0.5 on y and z, the flagship
    material on a ball of radius 0.5 at the centre, an Ez point source."""
    med = mp.Medium(epsilon=4.0, chi2=0.05, chi2_full_tensor=True,
                    E_susceptibilities=[mp.LorentzianSusceptibility(
                        frequency=2.0, gamma=0.05, sigma=0.2)])
    sim = mp.Simulation(
        cell_size=mp.Vector3(3, 2.5, 2.5), resolution=8,
        geometry=[mp.Sphere(0.5, material=med)],
        sources=[mp.Source(mp.GaussianSource(1.0, fwidth=0.8), mp.Ez,
                           center=mp.Vector3(-0.9, 0.1, 0))],
        boundary_layers=[mp.PML(0.5, direction=mp.Y),
                         mp.PML(0.5, direction=mp.Z)],
        k_point=mp.Vector3(kx), eps_averaging=False, device=device)
    sim.init_sim()
    sim.plan.slab_opt = True
    return sim.plan


@pytest.mark.gpu
@pytest.mark.parametrize("kx", [0.0, 1 / 6], ids=["k0", "zone-edge"])
def test_ghost_ring_matches_plain_on_cuda(kx):
    """The ghost ring (ops/periodicx.py: K2 at depth 2 and 3 on the
    extended aperiodic plan, its ghost zones re-seeded times the phase
    before every call, the residue through the extended plan's K1) on the
    card against the same driver on the host, where K2 and K1 run their
    plain versions: 11 steps from a seeded random state, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from meep_nl_tpu_torch.ops import periodicx as PX
    st0 = _random_state(_periodic_plan("cuda", kx), 3)
    for depth in (2, 3):
        ring = PX.PeriodicGhostT2Kernel(_periodic_plan("cuda", kx), depth)
        host = PX.PeriodicGhostT2Kernel(_periodic_plan("cpu", kx), depth)
        got = _host(ring.run(_clone(st0), 11, t0=T0))
        want = host.run(_host(st0), 11, t0=T0)
        torch.cuda.synchronize()
        assert ring.ker.launches == 11 // depth * ring.ker.launches_per_call
        assert ring.ker._k1.launches == 11 % depth * 3
        assert ring.ker.plain_steps == 0
        for key in ("f", "f_u", "f_w"):
            for c, t in want[key].items():
                assert torch.equal(got[key][c], t), f"{key}[{c}]"
        for pg, pw in zip(got["pol"], want["pol"]):
            for k in ("p", "pp"):
                for c, t in pw[k].items():
                    assert torch.equal(pg[k][c], t), f"pol {k}[{c}]"


@pytest.mark.gpu
def test_out_of_place_hands_the_input_over_on_cuda():
    """A call returns new tensors and leaves its input untouched; the next
    call writes into the tensors the first one was given, so two calls
    cycle between two sets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan = _plan("flagship", "cuda")
    ker = T2.Fdtd3dT2Kernel(plan, depth=2)
    rows = TS.xs_rows(plan, TS.build_xs(plan, 4, T0))
    s0 = _random_state(plan, 5)
    keep = _clone(s0)
    s1 = ker.step(s0, rows[:2])
    for c, t in keep["f"].items():
        assert torch.equal(s0["f"][c], t)
        assert s1["f"][c].data_ptr() != t.data_ptr()
    s2 = ker.step(s1, rows[2:])
    for c in s0["f"]:
        assert s2["f"][c].data_ptr() == s0["f"][c].data_ptr()


@pytest.mark.gpu
def test_nine_sources_through_the_hybrid_route_on_cuda(monkeypatch):
    """The nine-source scene on the card: the hybrid route's K2 launches and
    the fields of the eager stepper."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(R, "VMEM_BUDGET", 0)
    sim = nine_source_sim(mp, "cuda")
    sim.run(until=2.0)
    assert dict(sim.routes) == {"hybrid": 1}
    ker = sim.plan._t2_kernel
    assert ker.k3.launches + ker.launches > 0
    eager = nine_source_sim(mp, "cuda", use_fused=False)
    eager.run(until=2.0)
    want = eager.get_array(mp.Ez)
    got = sim.get_array(mp.Ez)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.gpu
def test_kernel_refuses_bad_tensors_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan = _plan("vacuum", "cuda")
    ker = T2.Fdtd3dT2Kernel(plan)
    rows = TS.xs_rows(plan, TS.build_xs(plan, 2, 0))
    st = TS.init_state(plan)
    st["f"]["ez"] = st["f"]["ez"].double()
    with pytest.raises(ValueError, match="contiguous"):
        ker.step(st, rows)
    with pytest.raises(ValueError, match="rows"):
        ker.step(TS.init_state(plan), rows[:1])
    assert ker.launches == 0


@pytest.mark.gpu
def test_block_budget_is_what_supported_admits_by_on_cuda():
    """`supported` admits a plan by SMEM_H100, the wrapper sizes the items
    by what the card reports: on the H100 the two are one number, so a
    plan `supported` admits always finds a tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if "H100" not in torch.cuda.get_device_name(0):
        pytest.skip("SMEM_H100 is the H100's figure")
    import ctypes
    smem = (ctypes.c_int * 3)()
    assert T2._lib().mnt_k2_smem(smem) == 0
    most, per_sm, reserve = smem
    assert min(most, per_sm - reserve) == T2.SMEM_H100
