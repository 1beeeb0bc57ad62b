"""The K1 CUDA kernel against its plain version, both on the card.

Marked `gpu`: skips without a CUDA device (the kernel has no CPU mode).
Imports only the port, so it runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_fdtd3d_gpu.py -m gpu

(`--noconftest`: tests/conftest.py imports jax.)

The kernel is built without FMA contraction and runs the plain version's
operation order, so in fp32 the two agree bit for bit (the scenes of
`test_kernel_matches_plain_on_cuda` keep a 1e-5 gate; the cases of
`CASES`, shared with the host emulation test_torch_fdtd3d_emul.py, are held
bit for bit, fp64 to 1e-12 of the field maximum)."""

import numpy as np
import pytest
import torch

import meep_nl_tpu_torch as mp
from meep_nl_tpu_torch.core import grid as TG
from meep_nl_tpu_torch.ops import fdtd3d as TF
from meep_nl_tpu_torch.ops import periodicx as PX
from meep_nl_tpu_torch.stepper import plan as TP
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


#: case -> k1_plan kwargs.  Storage shapes up to 32x24x19, none a multiple
#: of K1's (8, 32) y-z tile ("tiny" is smaller than one); the flagship
#: ball's nonlinear box crosses the tile edge at j = 8, and `ch` puts chunk
#: edges inside it; every plan has dead mask planes (PEC walls, padding);
#: "pml-xz-only" lacks the y chains, so K1 runs its general layout, the
#: others its uPML one; "many-sources" has more current sources in each
#: family than a launch takes waveforms by value (MAXSRC), so K1 reads
#: them from a device table; "mirror-yz" (node mirrors on y, phase +1,
#: and z, phase -1: fold ghosts of both signs) and "mirror-y" put the
#: fold ghost in the D launch's halo, with the PML on the high side of
#: the mirrored axes only; "wrap-x" (phase +1, storage padded past the
#: dead plane to 32 x-planes, so two chunks of dead planes) and
#: "wrap-x-edge" (phase -1 at the zone edge) are Bloch-periodic along x
#: (the WRAP launches), with the PML on y and z and without the ball
#: (whose boxes here reach the wrap: K1's x-wrap envelope declines them);
#: "pair-wrap-x" (k_x = 0.13 / the period: a complex phase, storage padded
#: to two chunks of dead planes) and "pair-wrap-x-lorentz" (a Lorentz pole
#: on a block clear of the wrap) carry complex fields as a real pair: the
#: PAIR launches, both channels a launch, the wrapped planes rotated
CASES = {
    "flagship": dict(ch=7),
    "flagship-padded-full-chains": dict(pad=(8, 8, 1), slab=False),
    "chi3-drude-fp64": dict(chi3=True, drude=True, dtype=np.float64, ch=4),
    "two-poles": dict(poles=2, ch=9),
    "h-and-volume-sources": dict(ball=False, sources="hv", ch=5),
    "pml-xz-only": dict(pml_axes="xz", ch=6),
    "tiny": dict(cells=(6, 5, 4), pml=0.25, ball=False, sources="hv"),
    "many-sources": dict(ball=False, sources="m", ch=5),
    "mirror-yz": dict(mirror={"y": 1, "z": -1}, ch=7),
    "mirror-y": dict(mirror={"y": 1}, sources="hv", ch=5),
    "wrap-x": dict(wrap=1, ball=False, pad=(8, 1, 1), ch=5),
    "wrap-x-edge": dict(wrap=-1, ball=False, sources="hv", ch=7),
    "pair-wrap-x": dict(wrap="pair", ball=False, sources="hv", pad=(8, 1, 1),
                        ch=5),
    "pair-wrap-x-lorentz": dict(wrap="pair", ball=False, block=True,
                                sources="m", ch=7),
}
T0, NSTEP_CASE = 40, 3


def k1_plan(device, cells=(24, 20, 18), res=8.0, pml=0.5, pml_axes="xyz",
            ball=True, chi3=False, drude=False, poles=1, sources="p", pad=1,
            slab=True, dtype=np.float32, ch=None, mirror=None, wrap=None,
            block=False):
    """A K1 plan from numpy inputs: uPML on the faces of `pml_axes`;
    `ball` an eps=4 sphere of radius min(size)/4 at the centre with a
    Lorentz (or Drude) pole (`poles` 2: and a Drude pole on the half x > 0
    of the ball) and full-tensor chi2 (the NR solve), and chi3 with `chi3`;
    sources "p" an Ez point source, "hv" also an Hz point source, a volume
    source of Ez over 8 sites each listed twice, and an Ez point source on
    two of those sites (repeated sites within and across sources), "m"
    TF.MAXSRC + 1 Ez and as many Hz point sources, each with its own
    frequency and a complex phase, at 11 spots (repeated sites across
    sources); `mirror` {axis letter: phase} node mirrors at index 0 of
    those axes (no wall there, the PML on their high side only); `wrap`
    the Bloch phase (+1 or -1) of an x-periodic cell, the PML then on y
    and z only, or "pair": k_x = 0.13 / the period, complex fields as a
    real pair; `block` an eps=3 block with a Lorentz pole on the x-planes
    [6, 14).  Returns (plan, ch)."""
    size = [n / res for n in cells]
    gv = TG.GridVolume.create("3d", size, res)
    XX, YY, ZZ = np.meshgrid(*[gv.comp_coords("ez", ax) - 0.5 * size[ax]
                               for ax in range(3)], indexing="ij")
    inside = (XX ** 2 + YY ** 2 + ZZ ** 2 < (min(size) / 4) ** 2) & ball
    mat = TP.MaterialSpec(chi1inv={})
    if block:
        comps = ("ex", "ey", "ez")
        blk = np.zeros(XX.shape, bool)
        blk[6:14] = True
        mat = TP.MaterialSpec(
            chi1inv={c: {c[1]: np.where(blk, 1 / 3, 1.0)} for c in comps},
            pols=[TP.PolSpec(field_type="e", omega0=1.5, gamma=0.1,
                             sigma={(c, c[1]): 0.3 * blk.astype(float)
                                    for c in comps})])
    if ball:
        comps = ("ex", "ey", "ez")
        mat = TP.MaterialSpec(
            chi1inv={c: {c[1]: np.where(inside, 0.25, 1.0)} for c in comps},
            pols=[TP.PolSpec(field_type="e", omega0=2.0, gamma=0.05,
                             drude=drude,
                             sigma={(c, c[1]): 0.2 * inside.astype(float)
                                    for c in comps})]
            + [TP.PolSpec(field_type="e", omega0=1.5, gamma=0.1, drude=True,
                          sigma={(c, c[1]): 0.1 * (inside & (XX > 0))
                                 .astype(float) for c in comps})]
            * (poles - 1),
            nr_chi2={c: 0.05 * inside.astype(float) for c in comps},
            chi3={c: 0.02 * inside.astype(float) for c in comps}
            if chi3 else {})
    src_t = mp.GaussianSource(frequency=1.0, fwidth=1.0)

    def point(comp, at, src=src_t, phase=1.0):
        pts = gv.interp_weights(comp, at)
        return TP.SrcVolSpec(comp, np.array([p for p, w in pts], np.int32),
                             np.array([w * res ** 3 * phase for p, w in pts],
                                      np.complex128), src)

    at = [0.2 * size[0], 0.45 * size[1], 0.55 * size[2]]
    srcs = [point("ez", at)]
    if "v" in sources:
        rng = np.random.default_rng(3)
        base = np.array([int(0.25 * n) for n in cells])
        blk = np.array([base + (a, b, c) for a in (0, 1) for b in (0, 1)
                        for c in (0, 1)], np.int32)
        idx = np.concatenate([blk, blk[::-1]])
        amps = rng.standard_normal(len(idx)) \
            + 1j * rng.standard_normal(len(idx))
        srcs = [point("hz", [0.7 * size[0], 0.5 * size[1], 0.5 * size[2]]),
                TP.SrcVolSpec("ez", idx, amps, src_t),
                TP.SrcVolSpec("ez", blk[2:4].copy(),
                              np.array([0.5 + 0.25j, -0.75 + 1j]), src_t)]
    if "m" in sources:
        rng = np.random.default_rng(4)
        spots = [list(rng.uniform(0.3, 0.7, 3) * size) for _ in range(11)]
        srcs = [point(comp, spots[i % 11],
                      mp.GaussianSource(frequency=1.0 + 0.01 * i, fwidth=1.0),
                      np.exp(0.3j * i))
                for i in range(TF.MAXSRC + 1) for comp in ("ez", "hz")]
    mirror = mirror or {}
    if wrap is not None:
        pml_axes = pml_axes.replace("x", "")
    plan = TP.compile_plan(
        gv, mat, pmls=[TP.PMLSpec(d, pml, side=+1 if d in mirror else 0)
                       for d in pml_axes],
        sources=srcs, pad_to_multiple=pad, dtype=dtype, device=device,
        boundaries={(d, "low"): "none" for d in mirror} or None,
        periodic=(True, False, False) if wrap is not None else None,
        bloch_k=(0.0 if wrap == 1 else 0.13 / size[0] if wrap == "pair"
                 else 0.5 / size[0], 0.0, 0.0),
        complex_fields=True if wrap == "pair" else None,
        mirror_node=tuple(("xyz".index(d), d, ph)
                          for d, ph in mirror.items()))
    plan.real_pair = wrap == "pair"
    plan.slab_opt = slab
    return plan, ch


def hold_case(case, device, step):
    """K1 (`step(ker, state, row)`, on a plan on `device`) against step_ref
    on the host over NSTEP_CASE steps of CASES[case] from one seeded random
    state: fp32 bit for bit, fp64 to 1e-12 of the field maximum; returns
    the kernel object.  The plain version runs on the host because there
    its current sources accumulate repeated sites in entry order, which
    the kernel keeps; on the card PyTorch's index_put does not fix that
    order."""
    plan, ch = k1_plan(device, **CASES[case])
    ref_plan, _ = k1_plan("cpu", **CASES[case])
    ker = PX.PairPeriodicXKernel(plan, ch=ch) if plan.real_pair else \
        TF.Fdtd3dKernel(plan, ch=ch,
                        allow_periodic_x=bool(plan.periodic[0]))
    ref = TF.step_ref(ref_plan)
    assert ker.launches_per_step == 3
    xs = TS.build_xs(plan, NSTEP_CASE, T0)
    assert all(np.all(xs[f"src{si}:cur_re"] != 0)
               for si in range(len(plan.sources)))
    rows = TS.xs_rows(plan, xs)
    ref_rows = TS.xs_rows(ref_plan, xs)
    st0 = _random_state(plan, 9)
    scale = max(float(t.abs().max()) for t in st0["f"].values())
    tol = 0.0 if plan.dtype == np.float32 else 1e-12 * scale
    sk, sr = _clone(st0), _host(st0)
    for row, ref_row in zip(rows, ref_rows):
        sk = step(ker, sk, row)
        sr = ref(sr, ref_row)
    sk = _host(sk)
    assert not torch.equal(sr["f"]["ez"], _host(st0)["f"]["ez"])
    for key in ("f", "f_u", "f_w"):
        for c, t in sr[key].items():
            err = float((sk[key][c] - t).abs().max())
            assert err <= tol, f"{key}[{c}]: {err:.3e}"
    for pk, pr in zip(sk["pol"], sr["pol"]):
        for k in ("p", "pp"):
            for c, t in pr[k].items():
                err = float((pk[k][c] - t).abs().max())
                assert err <= tol, f"pol {k}[{c}]: {err:.3e}"
    return ker


def _host(st):
    """A copy of a state on the host."""
    return {**st, **{k: {c: t.cpu().clone() for c, t in st[k].items()}
                     for k in ("f", "f_u", "f_w")},
            "pol": [{k: {c: t.cpu().clone() for c, t in e[k].items()}
                     for k in ("p", "pp")} for e in st["pol"]]}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_cases_bit_for_bit_on_cuda(case):
    """Every launch checked by the wrapper (cudaGetLastError), the state
    bit for bit, three launches a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    ker = hold_case(case, "cuda", lambda k, s, r: k.step(s, r))
    torch.cuda.synchronize()
    assert ker.launches == 3 * NSTEP_CASE and ker.plain_steps == 0
