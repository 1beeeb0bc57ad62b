"""K1 (meep_nl_tpu_torch/ops/fdtd3d.py): its plain version against the JAX
package's jnp stepper and its envelope against the JAX kernel's.  The CUDA
kernel itself is held against its plain version in
test_torch_fdtd3d_gpu.py, which imports no JAX so that it runs on the card.

The plain version is the eager step without the DTFT update; the kernel
route runs with the slab-local PML chains (plan.slab_opt, as the hybrid
driver sets it), so the JAX side runs with the same flag.  Tolerances as
in test_torch_step: fp32 1e-5 relative to the field maximum."""

import numpy as np
import pytest
import torch

from meep_nl_tpu.ops.pallas import fdtd3d as JF
from meep_nl_tpu_torch import interop
from meep_nl_tpu_torch.ops import fdtd3d as TF

from test_torch_plan import CASES, JAX, PORT, build_plan, random_state
from test_torch_step import NSTEPS, assert_states_close, jax_run

torch.set_num_threads(2)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_jax(case):
    kw = CASES[case]
    st_np = random_state(build_plan(JAX, **kw), seed=5)
    want = jax_run(kw, np.float32, True, st_np, NSTEPS)
    pt = build_plan(PORT, device="cpu", **kw)
    pt.slab_opt = True
    ker = TF.Fdtd3dKernel(pt)
    got = ker.run(interop.state_from_numpy(st_np, "cpu"), NSTEPS, t0=0)
    # a CPU state runs the plain version, and launches nothing
    assert ker.plain_steps == NSTEPS and ker.launches == 0
    assert_states_close(interop.state_to_numpy(got), want, 1e-5,
                        keys=("f", "f_u", "f_w"))


#: case -> (build_plan kwargs, why the port's envelope differs or None)
ENVELOPE = {
    "vacuum_upml": (dict(), None),
    "flagship_32": (dict(cells=(32, 24, 24), ball=True, pol=True, nr=True,
                         flux=True), None),
    "chi3_drude_32": (dict(cells=(32, 24, 24), ball=True, pol=True,
                           drude=True, chi3=True), None),
    "h_source": (dict(src_comp="hz"), None),
    "conductivity": (dict(ball=True, cond=True), None),
    "h_pole": (dict(ball=True, hpol=True), None),
    "noisy_pole": (dict(ball=True, noisy=True), None),
    "offdiag_eps": (dict(ball=True, offdiag=True), None),
    "integrated_src": (dict(integrated=True), None),
    "periodic_x": (dict(periodic=(True, False, False)), None),
    "bloch_complex": (dict(periodic=(True, False, False),
                           bloch_k=(0.3, 0.0, 0.0)), None),
    # TPU-only condition: the dispersive window of _Layout must clear the
    # x-PML edge blocks, which a 16^3 ball does not
    "flagship_16": (dict(ball=True, pol=True, nr=True), "tpu_layout"),
    # TPU-only condition: 17 x-sites give no block depth bx >= 2
    "unpadded_x": (dict(pad=1), "tpu_bx"),
    # node mirrors: y and z run (the fold ghost in the D launch), x is
    # declined by both (it would change the reference's x-block topology)
    "mirror_y": (dict(mirror_node=((1, "y", 1),)), None),
    "mirror_x": (dict(mirror_node=((0, "x", 1),)), None),
}


@pytest.mark.parametrize("case", sorted(ENVELOPE))
def test_envelope_matches_jax(case):
    kw, why = ENVELOPE[case]
    j = JF.supported(build_plan(JAX, **kw))
    t = TF.supported(build_plan(PORT, device="cpu", **kw))
    if why is None:
        assert j == t
    elif why in ("tpu_layout", "tpu_bx"):
        assert (j, t) == (False, True)
    else:
        assert (j, t) == (True, False)


def test_envelope_declines_2d():
    for pkg in (JAX, PORT):
        gv = pkg.G.GridVolume.create("2d", [2.0, 2.0], 8.0)
        extra = {"device": "cpu"} if pkg is PORT else {}
        plan = pkg.P.compile_plan(gv, pkg.P.MaterialSpec(chi1inv={}),
                                  pmls=[pkg.P.PMLSpec("x", 0.5)], **extra)
        sup = (JF if pkg is JAX else TF).supported(plan)
        assert sup is False


def test_kernel_state_checks():
    """The CUDA path refuses CPU or mis-shaped tensors (checked without a
    device: the checks run before any launch)."""
    pt = build_plan(PORT, device="cpu")
    ker = TF.Fdtd3dKernel(pt)
    st = interop.state_from_numpy(random_state(build_plan(JAX), 1), "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ker._step_cuda(st, {})
    assert ker.launches_per_step == 3
    assert TF.Fdtd3dKernel(build_plan(PORT, device="cpu",
                                      src_comp="hz")).launches_per_step == 3
    with pytest.raises(ValueError):
        TF.Fdtd3dKernel(build_plan(PORT, device="cpu", cond=True, ball=True))


def test_step_cost_counts_the_slabs():
    """The bound's byte count: full-grid E/H/D/B, slab-only f_u."""
    pt = build_plan(PORT, device="cpu")
    pt.slab_opt = True
    n = int(np.prod(pt.storage_shape))
    cost = TF.step_cost(pt)
    assert 24 * n * 4 < cost["bytes"] < 48 * n * 4
    pt.slab_opt = False
    assert TF.step_cost(pt)["bytes"] > cost["bytes"]
