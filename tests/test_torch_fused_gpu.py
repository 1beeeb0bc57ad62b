"""K5 (csrc/fused.cu) and the fused probed route on the card.

Marked `gpu`: skips without a CUDA device (the kernel has no CPU mode).
Imports only the port, so it runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_fused_gpu.py -m gpu

From a seeded random state at step 150 (the source near its peak): the K5
step (both half-step launches, each with its family's current sources)
against its plain version (`step_ref`: half_step_ref and the fix-ups'
PyTorch scatter-adds) on the card, on tests/test_pallas.py's plans, an
Hz-source plan with mu = 2 (the B family's sources) and the `SEAMS` plans
(sources on the tile seams of the card's (8, 32) y-z tile and of a (4, 8)
one, on chunk edges, repeated within a source, shared by two sources and
on dead planes of their E/H component), bit for bit in fp32 and to 1e-12
of the field maximum in fp64 (the kernel is built without FMA contraction
in the plain version's operation order); and fused_probed_run against the
eager stepper's probe series, bit for bit.  The same cases run through
the host emulation of the kernel source in test_torch_fused_emul.py."""

import numpy as np
import pytest
import torch

import meep_nl_tpu_torch as mp
from meep_nl_tpu_torch.core import grid as TG
from meep_nl_tpu_torch.ops import fused as TFU
from meep_nl_tpu_torch.ops import hybrid as HY
from meep_nl_tpu_torch.stepper import plan as TP
from meep_nl_tpu_torch.stepper import step as TS

from test_torch_fdtd3d_t2_gpu import _clone, _random_state

T0 = 150


def pallas_plan(G, P, gauss, pad, ball, dtype, src="ez", mu=False,
                **extra):
    """tests/test_pallas.py's plan (2.0^3 at resolution 8, PML 0.5 on every
    face, a point source at (0.1, 0, 0); `ball`: chi1inv 0.25 inside a
    sphere of radius 0.6, `mu`: the same for mu), compiled by either package
    (G, P: its grid and plan modules) from numpy inputs, with use_pallas."""
    gv = G.GridVolume.create("3d", [2.0, 2.0, 2.0], 8.0)
    chi1inv = {}
    for fam, on in (("e", ball), ("h", mu)):
        if not on:
            continue
        for c in (fam + "x", fam + "y", fam + "z"):
            xx, yy, zz = np.meshgrid(*[gv.comp_coords(c, a) for a in range(3)],
                                     indexing="ij")
            chi1inv[c] = {c[1]: np.where(xx * xx + yy * yy + zz * zz < 0.36,
                                         0.25, 1.0)}
    pts = gv.interp_weights(src, [0.1, 0.0, 0.0])
    source = P.SrcVolSpec(src, np.array([p for p, w in pts], np.int32),
                          np.array([w for p, w in pts], np.complex128),
                          gauss(frequency=1.0, fwidth=0.5))
    plan = P.compile_plan(gv, P.MaterialSpec(chi1inv=chi1inv),
                          pmls=[P.PMLSpec(d, 0.5) for d in "xyz"],
                          sources=[source], pad_to_multiple=pad, dtype=dtype,
                          **extra)
    plan.use_pallas = True
    return plan


#: case -> pallas_plan arguments (pad, ball, dtype, src, mu)
CASES = {"vacuum": ((1, 1, 1), False, np.float32, "ez", False),
         "vacuum_padded": ((8, 8, 128), False, np.float32, "ez", False),
         "dielectric_padded": ((8, 8, 128), True, np.float32, "ez", False),
         "dielectric_fp64": ((1, 1, 1), True, np.float64, "ez", False),
         "hz_source_mu": ((8, 1, 1), True, np.float32, "hz", True)}


def port_plan(case, device):
    if case in SEAMS:
        return seam_plan(device, *SEAMS[case])
    pad, ball, dtype, src, mu = CASES[case]
    return pallas_plan(TG, TP, mp.GaussianSource, pad, ball, dtype, src=src,
                       mu=mu, device=device)


#: case -> seam_plan arguments (family, dtype)
SEAMS = {"seams_ez": ("d", np.float32), "seams_hz_mu_fp64": ("b", np.float64)}
#: the family's sites on dead planes of its E/H component
DEAD_SITES = {"d": [(0, 5, 9), (7, 16, 20)], "b": [(4, 5, 0)]}


def seam_sites():
    """Sites on both sides of the first y and z seams of the card's (8, 32)
    y-z tile and the host emulation's (4, 8), on the x-planes 2|3 and 5|6
    (chunk edges of 3 planes), and the second of them once more (a
    repeated site)."""
    sites = []
    for ty, tz in ((8, 32), (4, 8)):
        sites += [(2, ty - 1, tz - 1), (3, ty, tz), (5, ty - 1, tz),
                  (6, ty, tz - 1)]
    return sites + [sites[1]]


def seam_plan(device, fam, dtype):
    """A 2 x 2 x 4.5 cell at resolution 8 (storage 17 x 17 x 37), PML 0.5
    on every face, chi1inv 0.25 of the E components (and, family 'b', of
    the H ones) inside a sphere of radius 0.6 at the centre, and two current
    sources of the family's z component with seeded complex amplitudes and
    their own waveforms: the first on `seam_sites` and the family's
    DEAD_SITES (dead planes of its E/H component: D/B takes the current,
    E/H not), the second on two of those sites; use_pallas."""
    gv = TG.GridVolume.create("3d", [2.0, 2.0, 4.5], 8.0)
    seams = seam_sites()
    chi1inv = {}
    for c in ("ex", "ey", "ez") + (("hx", "hy", "hz") if fam == "b" else ()):
        xx, yy, zz = np.meshgrid(*[gv.comp_coords(c, a) - 0.5 * gv.size[a]
                                   for a in range(3)], indexing="ij")
        chi1inv[c] = {c[1]: np.where(xx * xx + yy * yy + zz * zz < 0.36,
                                     0.25, 1.0)}
    comp = "ez" if fam == "d" else "hz"
    rng = np.random.default_rng(11)

    def source(sites, freq):
        amps = 50.0 * (rng.standard_normal(len(sites))
                       + 1j * rng.standard_normal(len(sites)))
        return TP.SrcVolSpec(comp, np.array(sites, np.int32), amps,
                             mp.GaussianSource(frequency=freq, fwidth=0.5))

    sources = [source(seams + DEAD_SITES[fam], 1.0),
               source([seams[1], seams[5]], 0.8)]
    plan = TP.compile_plan(gv, TP.MaterialSpec(chi1inv=chi1inv),
                           pmls=[TP.PMLSpec(d, 0.5) for d in "xyz"],
                           sources=sources, dtype=dtype, device=device)
    plan.use_pallas = True
    dead = TS.alive_vectors(plan, comp, torch.float64, "cpu")
    for site in DEAD_SITES[fam]:
        assert any(float(v.flatten()[site[ax]]) == 0.0
                   for ax, v in dead.items()), site
    return plan


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def hold_step(plan, run, nsteps):
    """The plain version of nsteps K5 steps and then one pair of halves
    without sources (step_ref, half_step_ref) against `run(state, rows)`,
    the state after the same (the last row is None), from a seeded random
    state at step T0: bit for bit in fp32, 1e-12 of the field maximum in
    fp64."""
    st0 = _random_state(plan, 5)
    st0["t"] = T0
    rows = TS.xs_rows(plan, TS.build_xs(plan, nsteps, T0)) + [None]
    ref = TFU.step_ref(plan)
    halves = [TFU.half_step_ref(plan, f) for f in "bd"]
    sr = _clone(st0)
    for row in rows:
        if row is not None:
            sr = ref(sr, row)
            continue
        for h in halves:
            sr["f"], sr["f_u"], sr["f_w"] = h(sr["f"], sr["f_u"], sr["f_w"])
    sk = run(_clone(st0), rows)
    assert float((sr["f"]["ez"] - st0["f"]["ez"]).abs().max()) > 0
    scale = max(float(t.abs().max()) for t in sr["f"].values())
    for key in ("f", "f_u", "f_w"):
        for c, t in sr[key].items():
            if plan.dtype == np.float32:
                assert torch.equal(sk[key][c], t), f"{key}[{c}]"
            else:
                err = float((sk[key][c] - t).abs().max())
                assert err <= 1e-12 * scale, f"{key}[{c}]: {err:.3e}"


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES) + sorted(SEAMS))
def test_kernel_matches_plain_on_cuda(case, cuda):
    plan = port_plan(case, cuda)
    step = TS.make_step(plan, dft=False)

    def run(sk, rows):
        for row in rows[:-1]:
            sk = step(sk, row)
        for f in "bd":              # the last pair of halves: no sources
            sk["f"], sk["f_u"], sk["f_w"] = plan._fused_kernels[f](
                sk["f"], sk["f_u"], sk["f_w"])
        torch.cuda.synchronize()
        return sk

    hold_step(plan, run, 12)
    ker = plan._fused_kernels
    assert ker["b"].launches == ker["d"].launches == 13
    assert ker["b"].plain_steps == ker["d"].plain_steps == 0
    fam = family(case)
    fix = ker["fix_" + fam]
    assert fix.launches == 0 and fix.plain_steps == 0
    assert ker["fix_" + "bd".replace(fam, "")] is None


def family(case):
    """'b' or 'd': the family of the case's current sources."""
    if case in SEAMS:
        return SEAMS[case][0]
    return "b" if CASES[case][3] == "hz" else "d"


@pytest.mark.gpu
def test_fused_probed_run_matches_eager_on_cuda(cuda):
    """The reference test_fused_probed_run's scene (4x2x2 at resolution 8,
    an eps=4 block, PML 0.5): fused_probed_run's series and state equal the
    eager stepper's on the card."""
    sim = mp.Simulation(
        cell_size=mp.Vector3(4.0, 2.0, 2.0), resolution=8,
        geometry=[mp.Block(center=mp.Vector3(0.3, 0, 0),
                           size=mp.Vector3(0.7, 0.7, 0.7),
                           material=mp.Medium(epsilon=4.0))],
        sources=[mp.Source(mp.GaussianSource(frequency=1.0, fwidth=0.4),
                           component=mp.Ez, center=mp.Vector3(-1.2, 0, 0))],
        boundary_layers=[mp.PML(0.5)], device=cuda)
    sim.init_sim()
    plan = sim.plan
    probes = [sim._point_probe("p0", mp.Ez, mp.Vector3(0.3, 0.1, 0.0)),
              sim._point_probe("p1", mp.Hy, mp.Vector3(-0.2, 0.0, 0.1))]
    st0 = _random_state(plan, 6)
    st0["t"] = 40
    sk, yk = HY.fused_probed_run(plan, _clone(st0), 30, 40, probes)
    sr, yr = TS.run(plan, _clone(st0), 30, t0=40, probes=probes)
    k1 = plan._t2_kernel._k1
    assert k1.launches == 30 * k1.launches_per_step and k1.plain_steps == 0
    for name in ("p0", "p1"):
        assert yk[name].shape == (30,) and torch.equal(yk[name], yr[name])
    for key in ("f", "f_u", "f_w"):
        for c, t in sr[key].items():
            assert torch.equal(sk[key][c], t), f"{key}[{c}]"
