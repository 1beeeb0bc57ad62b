"""K3 and K4 (csrc/resident.cu) against their plain version, both on the
card.

Marked `gpu`: skips without a CUDA device (the kernel has no CPU mode).
Imports only the port, so it runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_resident_gpu.py -m gpu

From a seeded random state, on the 2D flagship-material plans (TM: E from
D is site-local and fuses with the D curl; TE: the chi2 partner sums read
neighbours), the TM plan with 26 flux lines (52 DTFT monitors), a 24^3
plan and the two 3D plans that take the direct schedule (the flagship
material, whose tiles would fit only at T = 1; 4 E and 4 H poles, more
staged arrays than MAXSLOT), the TM and TE plans with the LDOS (complex
weights), energy and dft-fields monitors, node-mirror folds and the
rotational folds (Rotate2 / Rotate4: the direct schedule's variant with
their ghosts), Bloch-periodic plans (the direct schedule's WRAP variant,
phase +1 and -1, beside a node mirror, with chi2), with flux monitors and (K4) 20 probes, over
two chunks, with the wrapper's own schedule; BFAST plans (the PAIR_BFAST
variant: refl_angular_bfast's cell cut down, and a cell with PML on every
face), F included; cylindrical cells and special_kz (the CYL variants:
m = 0 on real fields, a complex m = 0, m = 1, -1 and 3 and beta on the
pair); the OFFDIAG and GYRO modes (off-diagonal chi1inv rows,
off-diagonal sigma, gyrotropic poles of both families); and
test_torch_resident_emul.py's schedule cases (small forced tiles, a
source, probe points and the flux line on tile seams, T not dividing the
stretch; the direct schedule forced on 2D plans).  Tolerance
1e-5 of the field maximum (fp32; the kernel is built without FMA
contraction from the plain version's per-site operation order, so in
practice the two agree bit for bit)."""

import numpy as np
import pytest
import torch

from meep_nl_tpu_torch.ops import resident as R
from meep_nl_tpu_torch.stepper import step as TS

from test_torch_resident_emul import (COMP, CASES, base_kind, force,
                                      random_state, scene)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _err(a, b):
    return float((a - b).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("probed", [False, True], ids=["k3", "k4"])
@pytest.mark.parametrize("kind", ["flag-tm", "flag-te", "tm-many", "3d",
                                  "nl3d", "poles3d", "ldos", "ldos-te",
                                  "tm+xy", "3d+xz", "nl3d+y", "tm@r2",
                                  "te-lin@r4-", "3d@r4", "tm~y-",
                                  "te+x~y", "3d~x-", "nl3d~x"])
def test_kernel_matches_plain_on_cuda(kind, probed, cuda, monkeypatch):
    monkeypatch.setattr(R, "MAX_CHUNK", 17)
    plan = scene(kind, device=cuda, res=16)
    st0 = random_state(plan, 8)
    # 20 probes of two points each; on the small 3D grids in two rows, on
    # the folded 3D grids in five
    pt = {"3d": [20, 20, 10], "nl3d": [5, 12, 7], "poles3d": [5, 12, 7],
          "3d+xz": [5, 20, 5], "nl3d+y": [3, 6, 7],
          "3d@r4": [2, 10, 10], "3d~x-": [20, 20, 10],
          "nl3d~x": [5, 12, 7], "te+x~y": [5, 20]}.get(kind, [20, 20])
    at = [(i // 4, i % 4) if kind in ("3d+xz", "nl3d+y", "3d@r4")
          else (0, i)
          if base_kind(kind) not in ("nl3d", "poles3d")
          else (i // 10 * 3, i % 10)
          for i in range(20)]
    rotational, periodic = "@" in kind, "~" in kind
    kind = base_kind(kind)                 # the folds' ghosts aside
    comp = COMP.get(kind, "ez")
    probes = [TS.ProbeSpec(f"p{i}", comp,
                           np.array([[pt[0] + dx, pt[1] - dy] + pt[2:],
                                     [pt[0] + dx + 1, pt[1] - dy] + pt[2:]]),
                           np.array([0.6, 0.4]))
              for i, (dx, dy) in enumerate(at)] if probed else []
    # the plain version first: the kernel takes the state's arrays over
    # (it runs out of place between them and a second set), the plain
    # version returns new tensors
    sr, yr = R.resident_ref(plan)(st0, 30, 40, probes)
    ker = R.ResidentKernel(plan)
    sk, yk = ker._run(st0, 30, 40, probes)
    torch.cuda.synchronize()
    assert (ker.probed_launches if probed else ker.launches) == 2
    assert ker.plain_steps == 0
    assert ker.schedule[1]["direct"] == (
        2 if rotational else 3 if periodic else kind in ("nl3d", "poles3d"))
    _agree(sk, yk, sr, yr)
    assert int(sk["t"]) == 30


@pytest.mark.gpu
@pytest.mark.parametrize("probed", [False, True], ids=["k3", "k4"])
@pytest.mark.parametrize("kind", ["bf*", "bf-pml*"])
def test_bfast_matches_plain_on_cuda(kind, probed, cuda, monkeypatch):
    """BFAST's term on the card (Tiling.direct 5) from a seeded random
    state, F included, over two chunks; K4 with a complex-weighted probe
    of two points."""
    monkeypatch.setattr(R, "MAX_CHUNK", 17)
    plan = scene(kind, device=cuda)
    st0 = random_state(plan, 8)
    probes = [TS.ProbeSpec("p0", "ex", np.array([[0, 1, 9], [1, 1, 9]]),
                           np.array([0.6 + 0.2j, 0.4]))] if probed else []
    sr, yr = R.resident_ref(plan)(st0, 30, 40, probes)
    ker = R.ResidentKernel(plan)
    sk, yk = ker._run(st0, 30, 40, probes)
    torch.cuda.synchronize()
    assert (ker.probed_launches if probed else ker.launches) == 2
    assert ker.plain_steps == 0
    assert ker.schedule[1]["direct"] == R.DIRECT_PAIR_BFAST
    _agree(sk, yk, sr, yr)


@pytest.mark.gpu
@pytest.mark.parametrize("probed", [False, True], ids=["k3", "k4"])
@pytest.mark.parametrize("kind", ["cyl0", "cyl0*", "cyl1*", "cyl-1*",
                                  "cyl3*", "kz*", "kz-pml*"])
def test_cyl_matches_plain_on_cuda(kind, probed, cuda, monkeypatch):
    """Cylindrical and special_kz plans on the card (Tiling.direct 6 on
    real fields, 7 on the pair) from a seeded random state over two
    chunks: the r-weighted curl, the phi term, the axis corrections and the
    2 pi r flux weights; K4 with a (complex on the pair) probe of two
    points."""
    monkeypatch.setattr(R, "MAX_CHUNK", 17)
    plan = scene(kind, device=cuda)
    st0 = random_state(plan, 8)
    pair = kind.endswith("*")
    comp = COMP.get(base_kind(kind), "ez")
    probes = [TS.ProbeSpec("p0", comp, np.array([[0, 9], [1, 9]]),
                           np.array([0.6 + 0.2j, 0.4]) if pair
                           else np.array([0.6, 0.4]))] if probed else []
    sr, yr = R.resident_ref(plan)(st0, 30, 40, probes)
    ker = R.ResidentKernel(plan)
    sk, yk = ker._run(st0, 30, 40, probes)
    torch.cuda.synchronize()
    assert (ker.probed_launches if probed else ker.launches) == 2
    assert ker.plain_steps == 0
    assert ker.schedule[1]["direct"] == (R.DIRECT_PAIR_CYL if pair
                                         else R.DIRECT_CYL)
    _agree(sk, yk, sr, yr)


@pytest.mark.gpu
@pytest.mark.parametrize("probed", [False, True], ids=["k3", "k4"])
@pytest.mark.parametrize("kind", ["aniso", "aniso-pole", "tensor", "asig",
                                  "gyro-h", "gyro-e", "gyro3d"])
def test_ax_matches_plain_on_cuda(kind, probed, cuda, monkeypatch):
    """The OFFDIAG and GYRO modes on the card with the wrapper's own
    schedule, from a seeded random state over two chunks: the off-diagonal
    rows, the off-diagonal sigma drive and the gyrotropic poles of both
    families in their own sub-update; K4 with a probe of two points."""
    monkeypatch.setattr(R, "MAX_CHUNK", 17)
    plan = scene(kind, device=cuda)
    st0 = random_state(plan, 8)
    comp = COMP.get(kind, "ez")
    pt = [10, 10] + ([7] if plan.gv.ndim == 3 else [])
    probes = [TS.ProbeSpec("p0", comp, np.array([pt, [pt[0] + 1] + pt[1:]]),
                           np.array([0.6, 0.4]))] if probed else []
    sr, yr = R.resident_ref(plan)(st0, 30, 40, probes)
    ker = R.ResidentKernel(plan)
    sk, yk = ker._run(st0, 30, 40, probes)
    torch.cuda.synchronize()
    assert (ker.probed_launches if probed else ker.launches) == 2
    assert ker.plain_steps == 0
    assert R.ax_mode(plan) == (R.AX_OFFDIAG if kind in ("aniso",
                                                       "aniso-pole",
                                                       "tensor")
                               else R.AX_GYRO)
    _agree(sk, yk, sr, yr)


def _agree(sk, yk, sr, yr):
    scale = max(float(t.abs().max()) for t in sr["f"].values())
    for key in ("f", "f_u", "f_w", "f_bfast"):
        for c, t in sr.get(key, {}).items():
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


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(c for c in CASES if CASES[c][4]))
def test_tile_seams_match_plain_on_cuda(case, cuda, monkeypatch):
    """The emulation's schedule cases on the card: forced tiles and T, with
    a source, probe points and the flux line on tile seams; the direct
    schedule forced (tile None)."""
    kind, probed, nsteps, chunk, (tile, T, _, _) = CASES[case]
    monkeypatch.setattr(R, "MAX_CHUNK", chunk)
    plan = scene(kind, device=cuda)
    kind = base_kind(kind)
    st0 = random_state(plan, 4)
    comp = COMP.get(kind, "ez")
    is3d = plan.gv.ndim == 3
    pt = ([10, 10] if tile is None else [tile[0], tile[1] + 1]) \
        + ([5] if is3d else [])
    if kind.startswith("bf"):              # two sites across x and y
        pt = [1, 1, 9]
    probes = [TS.ProbeSpec("p0", comp, np.array([[pt[0] - 1] + pt[1:], pt]),
                           np.array([0.6, 0.4])),
              TS.ProbeSpec("p1", comp, np.array([pt]), np.array([1.0]))] \
        if probed else []
    sr, yr = R.resident_ref(plan)(st0, nsteps, 5, probes)
    ker = R.ResidentKernel(plan)
    force(monkeypatch, tile, T)
    sk, yk = ker._run(st0, nsteps, 5, probes)
    torch.cuda.synchronize()
    tl = ker.schedule[1]
    assert tl["direct"] if tile is None else (tl["t"], tl["T"]) == (tile, T)
    _agree(sk, yk, sr, yr)


@pytest.mark.gpu
def test_shared_memory_rule_matches_the_card(cuda):
    """The wrapper sizes tiles by SMEM_H100 less STATIC_SMEM: the card's
    figures (a block's most, an SM's less its reserve) and the kernel's
    static shared memory; the ring's and 767^2's tilings launch, and the
    direct schedule's variants have a block on every SM."""
    import ctypes
    lib = R._lib()
    smem = (ctypes.c_int * 4)()
    assert lib.mnt_k3_smem(smem) == 0
    most, per_sm, reserve, static = smem
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("SMEM_H100 is the H100's figure")
    assert min(most, per_sm - reserve) == R.SMEM_H100
    assert static == R.STATIC_SMEM
    sms = lib.mnt_k3_sms()
    budget = R.SMEM_H100 - R.STATIC_SMEM
    for shape in ((161, 161, 1), (767, 767, 1)):
        tl = R.tiling(shape, 11, 10, 1, (1, 0, 0), 6, budget, sms)
        assert tl["T"] >= 2
        for nl in (0, 1):
            assert lib.mnt_k3_max_blocks(nl, 1, 0, 0, tl["smem"]) >= sms
    for nl in (0, 1):
        for probed in (0, 1):
            assert lib.mnt_k3_max_blocks(nl, probed, 1, 0, 0) >= sms
    # the rotational folds' variant (linear plans only), the Bloch wrap's
    for probed in (0, 1):
        assert lib.mnt_k3_max_blocks(0, probed, 2, 0, 0) >= sms
        assert lib.mnt_k3_max_blocks(1, probed, 2, 0, 0) < 0
        for nl in (0, 1):
            assert lib.mnt_k3_max_blocks(nl, probed, 3, 0, 0) >= sms
        # the CYL variants (linear plans only)
        for direct in (R.DIRECT_CYL, R.DIRECT_PAIR_CYL):
            assert lib.mnt_k3_max_blocks(0, probed, direct, 0, 0) >= sms
            assert lib.mnt_k3_max_blocks(1, probed, direct, 0, 0) < 0
        # the OFFDIAG and GYRO modes: linear plans on the plain direct
        # schedule, OFFDIAG on tiles too
        for mode in (R.AX_OFFDIAG, R.AX_GYRO):
            assert lib.mnt_k3_max_blocks(0, probed, 1, mode, 0) >= sms
            assert lib.mnt_k3_max_blocks(1, probed, 1, mode, 0) < 0
            assert lib.mnt_k3_max_blocks(0, probed, 3, mode, 0) < 0
        assert lib.mnt_k3_max_blocks(0, probed, 0, R.AX_OFFDIAG, 65536) >= 1
        assert lib.mnt_k3_max_blocks(0, probed, 0, R.AX_GYRO, 65536) < 0


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
