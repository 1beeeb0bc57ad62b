"""Anisotropic epsilon in the port against the JAX package, on the CPU: the
off-diagonal entries (Medium.epsilon_offdiag), rotated and transformed
media (Medium.rotate / transform, Matrix, get_rotation_matrix), tensor
subpixel averaging (Simulation(subpixel_tensor=True)), the off-diagonal
susceptibility sigma rows of a MaterialSpec, and the routes that run them:
the eager stepper (real, complex64 and the real pair), ResidentKernel's
plain version against the JAX ResidentKernel in interpret mode, and the 2D
Simulation on its resident route.

Tolerances: the plan to fp64 roundoff (1e-12 of each array's maximum); the
stepper and the resident kernel to 1e-5 (fp32) and 1e-12 (fp64) of the
field maximum; Simulation fields and fluxes to 1e-4.  Stretches are not
multiples of 4 (the JAX package's run unrolls its scan 4 times for those,
which makes its CPU compile several times longer)."""

import functools

import jax
import numpy as np
import pytest
import torch

import meep_nl_tpu as mnt
from meep_nl_tpu.ops.pallas import resident as JR
from meep_nl_tpu.stepper import plan as JP
from meep_nl_tpu.stepper import step as JS

import meep_nl_tpu_torch as mtt
from meep_nl_tpu_torch import interop
from meep_nl_tpu_torch.core import grid as TG
from meep_nl_tpu_torch.ops import resident as R
from meep_nl_tpu_torch.stepper import monitors as TM
from meep_nl_tpu_torch.stepper import plan as TP
from meep_nl_tpu_torch.stepper import step as TS

from meep_nl_tpu.core import grid as JG
from meep_nl_tpu.stepper import monitors as JM
from meep_nl_tpu_torch.models import scene as TSC

from test_torch_plan import random_state
from test_torch_step import assert_states_close

torch.set_num_threads(2)

TOL = {np.float32: 1e-5, np.float64: 1e-12}


def aniso_sim(mp, kind, **kw):
    """A 4 x 3.5 TE cell at resolution 10 (40 x 35), PML 0.6, an Hz point
    source and an x-normal flux line, with `kind`: offdiag, a block with
    epsilon_diag (3, 4, 2) and the xy entry 1; rotated, a block of a
    uniaxial crystal (2, 5, 3) rotated 30 degrees about z; tensor, an eps=8
    cylinder with subpixel_tensor."""
    if kind == "offdiag":
        geom = [mp.Block(size=mp.Vector3(1.6, 1.4, mp.inf),
                         material=mp.Medium(
                             epsilon_diag=mp.Vector3(3, 4, 2),
                             epsilon_offdiag=mp.Vector3(1.0, 0, 0)))]
    elif kind == "rotated":
        geom = [mp.Block(size=mp.Vector3(1.6, 1.4, mp.inf),
                         material=mp.Medium(
                             epsilon_diag=mp.Vector3(2, 5, 3)).rotate(
                                 mp.Vector3(0, 0, 1), np.pi / 6))]
    else:
        geom = [mp.Cylinder(radius=0.8, material=mp.Medium(epsilon=8))]
        kw = {"subpixel_tensor": True, **kw}
    sim = mp.Simulation(
        cell_size=mp.Vector3(4, 3.5), resolution=10, geometry=geom,
        sources=[mp.Source(mp.GaussianSource(0.6, fwidth=0.3), mp.Hz,
                           center=mp.Vector3(-1.2, 0.15))],
        boundary_layers=[mp.PML(0.6)], **kw)
    fl = sim.add_flux(0.6, 0.3, 3, mp.FluxRegion(
        center=mp.Vector3(1.1, 0), size=mp.Vector3(0, 2)))
    return sim, fl


def plans(kind, dtype=np.float32, **kw):
    """The scene's plan in both packages (fp64 plans inside
    jax.enable_x64 on the JAX side)."""
    with jax.enable_x64(dtype == np.float64):
        sj, _ = aniso_sim(mnt, kind, dtype=dtype, **kw)
        sj.init_sim()
    st, _ = aniso_sim(mtt, kind, dtype=dtype, device="cpu", **kw)
    st.init_sim()
    return sj._plan, st.plan


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("kind", ["offdiag", "rotated", "tensor"])
def test_plan_matches_jax(kind):
    """The fp64 plans: the same live components, coefficient keys (the
    u1 / u2 rows among them) and values to roundoff, and the same specs."""
    pj, pt = plans(kind, np.float64)
    assert set(pj.coefs) == set(pt.coefs)
    assert any(k.endswith((":u1", ":u2")) for k in pt.coefs)
    for k, v in pj.coefs.items():
        want = np.asarray(v)
        got = pt.coefs[k].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, k
        scale = max(float(np.abs(want).max()), 1e-300)
        assert float(np.abs(got - want).max()) <= 1e-12 * scale, k
    for a, b in ((pj.eh_specs_e, pt.eh_specs_e),
                 (pj.eh_specs_h, pt.eh_specs_h)):
        assert [(s.ec, s.has_u, s.has_u1, s.has_u2, s.dc1, s.dc2)
                for s in a] == [(s.ec, s.has_u, s.has_u1, s.has_u2, s.dc1,
                                 s.dc2) for s in b]


def test_medium_tensor_api_matches_jax():
    """m.epsilon(f) (the full dispersive tensor), transform, rotate,
    Matrix and get_rotation_matrix give the reference's values."""
    out = []
    for mp in (mnt, mtt):
        m = mp.Medium(epsilon_diag=mp.Vector3(2, 3, 4),
                      epsilon_offdiag=mp.Vector3(0.2, 0.1, -0.3),
                      E_susceptibilities=[mp.LorentzianSusceptibility(
                          frequency=1.1, gamma=0.05, sigma=0.4)])
        t0 = m.epsilon(np.array([0.3, 0.7]))
        m.transform(mp.Matrix(mp.Vector3(1, 0.2, 0), mp.Vector3(0, 1, 0.1),
                              mp.Vector3(0.3, 0, 1.2)))
        r = mp.Medium(epsilon_diag=mp.Vector3(2, 5, 3)).rotate(
            mp.Vector3(1, 1, 1), 0.4)
        R3 = mp.get_rotation_matrix(mp.Vector3(0, 1, 1), 0.7)
        v = R3 * mp.Vector3(1, 2, 3)
        out.append((t0, m.epsilon(0.5), tuple(m.epsilon_diag),
                    tuple(m.epsilon_offdiag),
                    tuple(m.E_susceptibilities[0].sigma_diag),
                    tuple(r.epsilon_diag), tuple(r.epsilon_offdiag),
                    R3.m, R3.inverse().m, R3.determinant(), tuple(v),
                    float(m.epsilon), float(m.mu)))
    for a, b in zip(*out):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-14, atol=1e-14)
    assert out[1][0].shape == (2, 3, 3)


def test_uniform_tensor_inversion():
    """tests/test_aniso_beam.py's uniform medium in the port: one step from
    a planted D gives E = eps^-1 D with the off-diagonal rows."""
    eps_t = np.array([[5.0, 3.0, 0.0], [3.0, 5.0, 0.0], [0.0, 0.0, 2.0]])
    D = np.array([0.4, -0.3, 0.2])
    gv = TG.GridVolume.create("3d", [2.0, 2.0, 2.0], 8.0)
    med = mtt.Medium(epsilon_diag=mtt.Vector3(5, 5, 2),
                     epsilon_offdiag=mtt.Vector3(3, 0, 0))
    mat = TSC.rasterize(
        gv, [mtt.Block(size=mtt.Vector3(9, 9, 9), material=med)], med)
    plan = TP.compile_plan(gv, mat, live_e=["ex", "ey", "ez"],
                           live_h=["hx", "hy", "hz"], device="cpu")
    st = TS.init_state(plan)
    f = {c: t + D["xyz".index(c[1])] if c[0] == "d" else t
         for c, t in st["f"].items()}
    st = TS.make_step(plan)({**st, "f": f}, {})
    got = [float(st["f"][c][8, 8, 8]) for c in ("ex", "ey", "ez")]
    want = np.linalg.inv(eps_t) @ D
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert abs(want[0] - D[0] / 5.0) > 1e-3


# ---------------------------------------------------------------------------
# the off-diagonal susceptibility sigma (a MaterialSpec: no medium makes one)
# ---------------------------------------------------------------------------


def sigma_plan(pk, dtype=np.float32, complex_fields=False):
    """A 2D TE plan (36 x 30 at resolution 10, PML 0.6) of an eps=3 block
    with a Lorentz pole whose sigma rows have off-diagonal entries (ex's y
    entry and ey's x entry; zero diagonal sigma on part of the block, so
    the s != 0 guard holds P there), an Ex line and an Hz point source and
    a flux line, through package `pk` (JAX or the port)."""
    G, P, M, mp = pk
    gv = G.GridVolume.create("2d", [3.6, 3.0], 10.0)
    shape = gv.shape
    x = np.arange(shape[0])[:, None] * np.ones(shape)
    y = np.arange(shape[1])[None, :] * np.ones(shape)
    inside = ((np.abs(x - 18) < 8) & (np.abs(y - 15) < 7)).astype(float)
    diag = inside * (x < 22)
    mat = P.MaterialSpec(
        chi1inv={c: {c[1]: 1.0 / (1 + 2 * inside)} for c in ("ex", "ey")},
        pols=[P.PolSpec(field_type="e", omega0=1.2, gamma=0.1, sigma={
            ("ex", "x"): 0.5 * diag, ("ex", "y"): 0.2 * inside,
            ("ey", "y"): 0.4 * diag, ("ey", "x"): -0.15 * inside})])
    srcs = []
    for comp, pos, amp in (("ex", [-1.0, 0.1], 1.0), ("hz", [-0.9, -0.3],
                                                      0.7)):
        pts = gv.interp_weights(comp, pos)
        srcs.append(P.SrcVolSpec(
            comp, np.array([p for p, w in pts], np.int32),
            np.array([w * 100 * amp for p, w in pts], np.complex128),
            mp.GaussianSource(frequency=0.8, fwidth=0.4)))
    dfts = M.flux_specs(gv, "flux", "x", [1.0, 0.0], [0.0, 1.6],
                        np.linspace(0.6, 1.0, 3))
    kw = {} if pk[3] is mnt else {"device": "cpu"}
    return P.compile_plan(gv, mat, pmls=[P.PMLSpec(d, 0.6) for d in "xy"],
                          sources=srcs, dfts=dfts, dtype=dtype,
                          complex_fields=complex_fields or None, **kw)


JAXP = (JG, JP, JM, mnt)
PORT = (TG, TP, TM, mtt)
SIGMA_STEPS = 23


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["fp32", "fp64"])
def test_offdiag_sigma_stepper_matches_jax(dtype):
    """23 steps of both packages' eager steppers from one random state."""
    with jax.enable_x64(dtype == np.float64):
        pj = sigma_plan(JAXP, dtype)
        st = random_state(pj, 7)
        want = to_np(JS.run(pj, jax.tree_util.tree_map(jax.numpy.asarray,
                                                        st),
                            SIGMA_STEPS, t0=4))
    pt = sigma_plan(PORT, dtype)
    assert any(d != c[1] for (c, d) in pt.pol_specs_e[0].sigma)
    got = TS.run(pt, interop.state_from_numpy(st, "cpu"), SIGMA_STEPS, t0=4)
    assert_states_close(interop.state_to_numpy(got), want, TOL[dtype])


@functools.lru_cache(maxsize=None)
def jax_complex_sigma():
    """The JAX package's native complex run of sigma_plan, 23 steps from
    zero (one compile, shared by both storages)."""
    pj = sigma_plan(JAXP, complex_fields=True)
    return to_np(JS.run(pj, JS.init_state(pj), SIGMA_STEPS, t0=0))


@pytest.mark.parametrize("pair", [False, True], ids=["native", "pair"])
def test_offdiag_sigma_complex_storages_match_jax(pair):
    """Complex fields: the port's native complex64 and its real pair
    against the JAX package's native complex run, 23 steps from zero."""
    want = jax_complex_sigma()
    pt = sigma_plan(PORT, complex_fields=True)
    pt.real_pair = pair
    got = TS.run(pt, TS.init_state(pt), SIGMA_STEPS, t0=0)
    scale = max(float(np.abs(v).max()) for v in want["f"].values())
    assert scale > 0
    for c, w in want["f"].items():
        g = got["f"][c].numpy()
        g = g[0] + 1j * g[1] if pair else g
        assert float(np.abs(g - w).max()) <= 2e-6 * scale, c
    for k in ("p", "pp"):
        for c, w in want["pol"][0][k].items():
            g = got["pol"][0][k][c].numpy()
            g = g[0] + 1j * g[1] if pair else g
            assert float(np.abs(g - w).max()) <= 2e-6 * scale, (k, c)


# ---------------------------------------------------------------------------
# the routes: the resident kernel's plain version, the 2D Simulation
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_resident_cpu(monkeypatch):
    monkeypatch.setenv("MNT_RESIDENT_CPU", "1")


def test_resident_kernel_matches_jax_kernel(jax_resident_cpu):
    """ResidentKernel.run (its plain version on the CPU, the OFFDIAG
    mode's plan) against the JAX ResidentKernel in interpret mode, 25
    steps of the rotated crystal from a random state, and bit for bit
    against resident_ref."""
    pj, pt = plans("rotated")
    assert R.resident_supported(pt) and R.ax_mode(pt) == R.AX_OFFDIAG
    st = random_state(pj, 5)
    want = to_np(JR.ResidentKernel(pj).run(
        jax.tree_util.tree_map(jax.numpy.asarray, st), 25, 30))
    ker = R.ResidentKernel(pt)
    got = ker.run(interop.state_from_numpy(st, "cpu"), 25, 30)
    assert ker.plain_steps == 25 and ker.launches == 0
    assert_states_close(interop.state_to_numpy(got), want, 1e-5)


@pytest.mark.parametrize("kind", ["rotated", "tensor"])
def test_simulation_route_and_fluxes_match_jax(kind):
    """The 2D Simulation with a rotated crystal or tensor averaging takes
    the resident route (its plain version here) and gives the JAX
    package's fields and fluxes, one stretch of 151 steps."""
    sj, fj = aniso_sim(mnt, kind)
    st, ft = aniso_sim(mtt, kind, device="cpu")
    until = 151 * 0.05
    sj.run(until=until)
    st.run(until=until)
    assert st._t == sj._t == 151
    assert dict(st.routes) == {"resident": 1}
    for c in ("ex", "ey", "hz"):
        want = np.asarray(sj.get_array(c))
        got = np.asarray(st.get_array(c))
        scale = float(np.abs(want).max())
        assert scale > 0 and float(np.abs(got - want).max()) <= 1e-4 * scale
    a, b = np.asarray(sj.get_fluxes(fj)), np.asarray(st.get_fluxes(ft))
    assert float(np.abs(a - b).max()) <= 1e-4 * float(np.abs(a).max())


def test_pair_offdiag_matches_jax():
    """force_complex_fields on the rotated crystal: the port's real pair
    (MNT_REAL_PAIR) and the JAX package's native complex fields, 31 steps
    of the eager stepper (K3/K4 decline the pair with these media)."""
    pj, pt = plans("rotated", force_complex_fields=True)
    want = to_np(JS.run(pj, JS.init_state(pj), 31, t0=0))
    pt.real_pair = True
    assert not R.resident_supported(pt)
    got = TS.run(pt, TS.init_state(pt), 31, t0=0)
    scale = max(float(np.abs(v).max()) for v in want["f"].values())
    for c, w in want["f"].items():
        g = got["f"][c].numpy()
        assert float(np.abs(g[0] + 1j * g[1] - w).max()) <= 2e-6 * scale, c


def test_step_cost_counts_offdiag_rows_where_nonzero():
    """K3/K4's bound counts an off-diagonal row's 5 operations only at the
    sites where the row is nonzero (the rotated block, not the cell)."""
    sim, _ = aniso_sim(mtt, "rotated", device="cpu")
    sim.init_sim()
    ops = R.step_cost(sim.plan, 7)["ops"]
    rp = R.resident_plan(sim.plan)
    u = [k for k in rp.coefs if k.endswith((":u1", ":u2"))]
    nnz = sum(int(torch.count_nonzero(rp.coefs[k])) for k in u)
    assert 0 < nnz < len(u) * int(np.prod(rp.gv.shape)) // 4
    rp.coefs.update({k: torch.zeros_like(rp.coefs[k]) for k in u})
    assert ops - R.step_cost(sim.plan, 7)["ops"] == 7 * 5 * nnz
