"""The K2 CUDA kernel against its plain version, both on the card.

Marked `gpu`: skips without a CUDA device (the kernel has no CPU mode).
Imports only the port, so it runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_fdtd3d_t2_gpu.py -m gpu

(`--noconftest`: tests/conftest.py imports jax.)

Tolerance 1e-5 of the field maximum in fp32 and 1e-12 in fp64 (the kernel
is built without FMA contraction from K1's per-site functions and in the
plain version's operation order, so in practice the two agree bit for
bit)."""

import numpy as np
import pytest
import torch

import meep_nl_tpu_torch as mp
from meep_nl_tpu_torch.ops import fdtd3d_t2 as T2
from meep_nl_tpu_torch.stepper import step as TS

NCALL = 4


def _plan(scene, device, dtype=np.float32, src=mp.Ez):
    """A 32x24x24 cell with PML on every face and a point source; scene
    "flagship" adds the eps=4 ball with a Lorentz pole and full-tensor chi2,
    "mu" a mu=2 ball (has_u on the H specs)."""
    geometry = []
    if scene == "flagship":
        med = mp.Medium(epsilon=4.0, chi2=0.05, chi2_full_tensor=True,
                        E_susceptibilities=[mp.LorentzianSusceptibility(
                            frequency=2.0, gamma=0.05, sigma=0.2)])
        geometry = [mp.Sphere(0.6, material=med)]
    elif scene == "mu":
        geometry = [mp.Sphere(0.6, material=mp.Medium(epsilon=2.0, mu=2.0))]
    sim = mp.Simulation(
        cell_size=mp.Vector3(4, 3, 3), resolution=8, geometry=geometry,
        sources=[mp.Source(mp.GaussianSource(1.0, fwidth=1.0),
                           component=src, center=mp.Vector3(-1.2, 0, 0))],
        boundary_layers=[mp.PML(0.5)], eps_averaging=False, device=device,
        dtype=dtype)
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


CASES = {
    "upml-d2": ("vacuum", 2, False, np.float32, mp.Ez, None),
    "upml-d3-caps": ("vacuum", 3, True, np.float32, mp.Ez, None),
    "flagship-d2-caps": ("flagship", 2, True, np.float32, mp.Ez, None),
    "flagship-d3": ("flagship", 3, False, np.float32, mp.Ez, None),
    "flagship-d3-caps-fp64": ("flagship", 3, True, np.float64, mp.Ez, None),
    "upml-d2-fp64": ("vacuum", 2, False, np.float64, mp.Ez, None),
    "h-source-d3-caps": ("vacuum", 3, True, np.float32, mp.Hz, None),
    "mu-d3": ("mu", 3, False, np.float32, mp.Ez, None),
    "flagship-d3-caps-bx3": ("flagship", 3, True, np.float32, mp.Ez, 3),
    "flagship-d2-bx40": ("flagship", 2, False, np.float32, mp.Ez, 40),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_cuda(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    scene, depth, caps, dtype, src, bx = CASES[case]
    plan = _plan(scene, "cuda", dtype, src)
    planes = [("ey", 20), ("ez", 20), ("ez", 21), ("hy", 20), ("hz", 0),
              ("hz", plan.storage_shape[0] - 1)] if caps else None
    # t0 near the source's peak, so every stage's source row matters
    rows = TS.xs_rows(plan, TS.build_xs(plan, NCALL * depth, 20))
    ker = T2.Fdtd3dT2Kernel(plan, depth=depth, cap_planes=planes, bx=bx)
    ref = T2.steps_ref(plan, depth, planes)
    st0 = _random_state(plan, 9)
    sk, sr = _clone(st0), _clone(st0)
    tol = 1e-5 if dtype == np.float32 else 1e-12
    scale = max(float(t.abs().max()) for t in st0["f"].values())
    for c in range(NCALL):
        xc = rows[c * depth:(c + 1) * depth]
        sk, ck = ker.capture_step(sk, xc)
        sr, cr = ref(sr, xc)
        assert set(ck) == set(cr)
        for key in cr:
            err = float((ck[key] - cr[key]).abs().max())
            assert err <= tol * scale, f"call {c} {key}: {err:.3e}"
    torch.cuda.synchronize()
    assert ker.launches == NCALL * ker.launches_per_call
    assert ker.plain_steps == 0 and ker._k1.launches == 0
    assert int(sk["t"]) == NCALL * depth
    if bx is not None:
        assert ker._cuda["bx"] == bx
    for key in ("f", "f_u", "f_w"):
        for c, t in sr[key].items():
            err = float((sk[key][c] - t).abs().max())
            assert err <= tol * scale, f"{key}[{c}]: {err:.3e}"
    for pk, pr in zip(sk["pol"], sr["pol"]):
        for k in ("p", "pp"):
            for c, t in pr[k].items():
                assert float((pk[k][c] - t).abs().max()) <= tol * scale


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
    assert ker.launches == 2
    assert ker._k1.launches == 2 * ker._k1.launches_per_step
    scale = max(float(t.abs().max()) for t in want["f"].values())
    for c, t in want["f"].items():
        assert float((got["f"][c] - t).abs().max()) <= 1e-5 * scale
    for c, t in want["pol"][0]["p"].items():
        assert float((got["pol"][0]["p"][c] - t).abs().max()) <= 1e-5 * scale


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
