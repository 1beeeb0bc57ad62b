"""K3 and K4 (csrc/resident.cu) against their plain version, both on the
card.

Marked `gpu`: skips without a CUDA device (the kernel has no CPU mode).
Imports only the port, so it runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_resident_gpu.py -m gpu

From a seeded random state, on the 2D flagship-material plans (TM: E from
D is site-local and fuses with the D curl; TE: the chi2 partner sums read
neighbours), the TM plan with 26 flux lines (52 DTFT monitors) and a
24^3 plan, with flux monitors and (K4) 20 probes, over two chunks.  Tolerance 1e-5 of the field maximum (fp32; the kernel is built
without FMA contraction from the plain version's per-site operation order,
so in practice the two agree bit for bit)."""

import numpy as np
import pytest
import torch

from meep_nl_tpu_torch.ops import resident as R
from meep_nl_tpu_torch.stepper import step as TS

from test_torch_resident_emul import random_state, scene


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _err(a, b):
    return float((a - b).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("probed", [False, True], ids=["k3", "k4"])
@pytest.mark.parametrize("kind", ["flag-tm", "flag-te", "tm-many", "3d"])
def test_kernel_matches_plain_on_cuda(kind, probed, cuda, monkeypatch):
    monkeypatch.setattr(R, "MAX_CHUNK", 17)
    plan = scene(kind, device=cuda, res=16)
    st0 = random_state(plan, 8)
    comp = "ey" if kind == "flag-te" else "ez"
    pt = [20, 20] + ([10] if kind == "3d" else [])
    probes = [TS.ProbeSpec(f"p{i}", comp,
                           np.array([[pt[0], pt[1] - i] + pt[2:],
                                     [pt[0] + 1, pt[1] - i] + pt[2:]]),
                           np.array([0.6, 0.4]))
              for i in range(20)] if probed else []
    # the plain version first: the kernel updates the state it is given in
    # place, the plain version returns new tensors
    sr, yr = R.resident_ref(plan)(st0, 30, 40, probes)
    ker = R.ResidentKernel(plan)
    sk, yk = ker._run(st0, 30, 40, probes)
    torch.cuda.synchronize()
    assert (ker.probed_launches if probed else ker.launches) == 2
    assert ker.plain_steps == 0
    scale = max(float(t.abs().max()) for t in sr["f"].values())
    for key in ("f", "f_u", "f_w"):
        for c, t in sr[key].items():
            assert _err(sk[key][c], t) <= 1e-5 * scale, f"{key}[{c}]"
    for pk, pr in zip(sk["pol"], sr["pol"]):
        for k in ("p", "pp"):
            for c, t in pr[k].items():
                assert _err(pk[k][c], t) <= 1e-5 * scale, f"pol {k}[{c}]"
    for c, t in sr["dft"].items():
        assert float(t.abs().max()) > 0
        assert _err(sk["dft"][c], t) <= 1e-5 * float(t.abs().max()), c
    for k, t in yr.items():
        assert _err(yk[k], t) <= 1e-5 * float(t.abs().max()), k
    assert int(sk["t"]) == 30


@pytest.mark.gpu
def test_launch_refuses_cpu_fallback(cuda):
    """A state on the card never runs the plain version; the counters say
    which kernel ran."""
    plan = scene("tm", device=cuda)
    ker = R.ResidentKernel(plan)
    out = ker.run(TS.init_state(plan), 5, 0)
    torch.cuda.synchronize()
    assert ker.launches == 1 and ker.plain_steps == 0
    assert out["f"]["ez"].device.type == "cuda"
