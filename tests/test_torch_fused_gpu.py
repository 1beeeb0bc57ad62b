"""K5 (csrc/fused.cu) and the fused probed route on the card.

Marked `gpu`: skips without a CUDA device (the kernel has no CPU mode).
Imports only the port, so it runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_fused_gpu.py -m gpu

From a seeded random state at step 150 (the source near its peak): the K5
step (both half-step kernels and the source fix-ups) against its plain
version on the card, on tests/test_pallas.py's plans and an Hz-source plan
with mu = 2 (the B family's fix-up), tolerance 1e-5 of the field maximum in
fp32 and 1e-12 in fp64 (the kernel is built without FMA contraction in the
plain version's operation order, so in practice the two agree bit for
bit); and fused_probed_run against the eager stepper's probe series, bit
for bit."""

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
    pad, ball, dtype, src, mu = CASES[case]
    return pallas_plan(TG, TP, mp.GaussianSource, pad, ball, dtype, src=src,
                       mu=mu, device=device)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_cuda(case, cuda):
    plan = port_plan(case, cuda)
    st0 = _random_state(plan, 5)
    st0["t"] = T0
    rows = TS.xs_rows(plan, TS.build_xs(plan, 12, T0))
    ref = TFU.step_ref(plan)
    sr = _clone(st0)
    for row in rows:
        sr = ref(sr, row)
    step = TS.make_step(plan, dft=False)
    sk = _clone(st0)
    for row in rows:
        sk = step(sk, row)
    torch.cuda.synchronize()
    ker = plan._fused_kernels
    assert ker["b"].launches == ker["d"].launches == 12
    assert ker["b"].plain_steps == ker["d"].plain_steps == 0
    fix = ker["fix_b"] if CASES[case][3] == "hz" else ker["fix_d"]
    assert fix.launches == 12 and fix.plain_steps == 0
    scale = max(float(t.abs().max()) for t in sr["f"].values())
    tol = (1e-5 if plan.dtype == np.float32 else 1e-12) * scale
    assert float((sr["f"]["ez"] - st0["f"]["ez"]).abs().max()) > 0
    for key in ("f", "f_u", "f_w"):
        for c, t in sr[key].items():
            err = float((sk[key][c] - t).abs().max())
            assert err <= tol, f"{key}[{c}]: {err:.3e} > {tol:.3e}"


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
