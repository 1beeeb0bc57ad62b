"""The K1 CUDA kernel against its plain version, both on the card.

Marked `gpu`: skips without a CUDA device (the kernel has no CPU mode).
Imports only the port, so it runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_fdtd3d_gpu.py -m gpu

(`--noconftest`: tests/conftest.py imports jax.)

fp32 tolerance 1e-5 of the field maximum (the kernel is built without FMA
contraction and in the plain version's operation order, so in practice
the two agree bit for bit)."""

import numpy as np
import pytest
import torch

import meep_nl_tpu_torch as mp
from meep_nl_tpu_torch.ops import fdtd3d as TF
from meep_nl_tpu_torch.stepper import step as TS

NSTEPS = 8


def _sim(flagship, device, dtype=np.float32):
    geometry = []
    if flagship:
        med = mp.Medium(epsilon=4.0, chi2=0.05, chi2_full_tensor=True,
                        E_susceptibilities=[mp.LorentzianSusceptibility(
                            frequency=2.0, gamma=0.05, sigma=0.2)])
        geometry = [mp.Sphere(0.6, material=med)]
    sim = mp.Simulation(
        cell_size=mp.Vector3(4, 3, 3), resolution=8, geometry=geometry,
        sources=[mp.Source(mp.GaussianSource(1.0, fwidth=1.0),
                           component=mp.Ez, center=mp.Vector3(-1.2, 0, 0))],
        boundary_layers=[mp.PML(0.5)], eps_averaging=False, device=device,
        dtype=dtype)
    sim.init_sim()
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


@pytest.mark.gpu
@pytest.mark.parametrize("flagship", [False, True], ids=["upml", "flagship"])
def test_kernel_matches_plain_on_cuda(flagship):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    plan = _sim(flagship, "cuda")
    plan.slab_opt = True
    rows = TS.xs_rows(plan, TS.build_xs(plan, NSTEPS, 0))
    ker, ref = TF.Fdtd3dKernel(plan), TF.step_ref(plan)
    st0 = _random_state(plan, 9)
    sk, sr = _clone(st0), _clone(st0)
    for i in range(NSTEPS):
        sk = ker.step(sk, rows[i])
        sr = ref(sr, rows[i])
    torch.cuda.synchronize()
    assert ker.launches == NSTEPS * ker.launches_per_step
    scale = max(float(t.abs().max()) for t in sr["f"].values())
    for key in ("f", "f_u", "f_w"):
        for c, t in sr[key].items():
            err = float((sk[key][c] - t).abs().max())
            assert err <= 1e-5 * scale, f"{key}[{c}]: {err:.3e}"
    for pk, pr in zip(sk["pol"], sr["pol"]):
        for k in ("p", "pp"):
            for c, t in pr[k].items():
                assert float((pk[k][c] - t).abs().max()) <= 1e-5 * scale


@pytest.mark.gpu
def test_kernel_matches_plain_on_cuda_fp64():
    """fp64, from a step where the source's amplitude matters (the kernel
    reads the source tables by flat offset)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    plan = _sim(True, "cuda", np.float64)
    plan.slab_opt = True
    rows = TS.xs_rows(plan, TS.build_xs(plan, NSTEPS, 20))
    ker, ref = TF.Fdtd3dKernel(plan), TF.step_ref(plan)
    sk = sr = TS.init_state(plan)
    for i in range(NSTEPS):
        sk = ker.step(_clone(sk) if i == 0 else sk, rows[i])
        sr = ref(sr, rows[i])
    scale = max(float(t.abs().max()) for t in sr["f"].values())
    assert scale > 0
    for c, t in sr["f"].items():
        assert float((sk["f"][c] - t).abs().max()) <= 1e-12 * scale, c


@pytest.mark.gpu
def test_kernel_refuses_bad_tensors_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan = _sim(False, "cuda")
    ker = TF.Fdtd3dKernel(plan)
    st = TS.init_state(plan)
    st["f"]["ez"] = st["f"]["ez"].double()
    with pytest.raises(ValueError, match="contiguous"):
        ker.step(st, TS.xs_rows(plan, TS.build_xs(plan, 1, 0))[0])
