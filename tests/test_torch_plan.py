"""The port's plan compiler against the JAX package's: identical inputs give
identical plans (every coefficient array to fp64 roundoff, every Spec field
equal).  Also home of the shared case builders of the tests/test_torch_*
modules: each case is made from numpy inputs and compiled by either
package."""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

import meep_nl_tpu as mnt
from meep_nl_tpu.core import grid as JG
from meep_nl_tpu.stepper import monitors as JM
from meep_nl_tpu.stepper import plan as JP

import meep_nl_tpu_torch as mtt
from meep_nl_tpu_torch import interop
from meep_nl_tpu_torch.core import grid as TG
from meep_nl_tpu_torch.stepper import monitors as TM
from meep_nl_tpu_torch.stepper import plan as TP

torch.set_num_threads(2)

JAX = types.SimpleNamespace(G=JG, P=JP, M=JM, Gaussian=mnt.GaussianSource)
PORT = types.SimpleNamespace(G=TG, P=TP, M=TM, Gaussian=mtt.GaussianSource)


def build_plan(pkg, cells=(16, 16, 16), res=8.0, pml_axes="xyz",
               pml=0.5, ball=False, pol=False, nr=False, chi3=False,
               drude=False, flux=False, src_comp="ez", pad=(8, 1, 1),
               dtype=np.float32, cond=False, hpol=False, noisy=False,
               offdiag=False, integrated=False, **extra):
    """One plan from numpy inputs through package `pkg` (JAX or PORT).

    ball: eps=4 sphere of radius min(size)/4 at the center; pol: a Lorentz
    pole (f0=2, gamma=0.05, sigma=0.2) on it; nr: full-tensor chi2 = 0.05
    (the NR solve); chi3: chi3 = 0.02 on it; flux: an x-normal flux plane.
    Features outside the kernel envelope: cond (D conductivity), hpol (an
    H-family pole), noisy (a noisy pole), offdiag (an off-diagonal
    chi1inv row), integrated (an integrated source).  `extra` goes to
    compile_plan (the port's `device` included)."""
    size = [n / res for n in cells]
    gv = pkg.G.GridVolume.create("3d", size, res)
    shape = gv.shape
    x, y, z = [gv.comp_coords("ez", ax) for ax in range(3)]
    cx, cy, cz = [0.5 * (c[0] + c[-1]) for c in (x, y, z)]
    XX, YY, ZZ = np.meshgrid(x - cx, y - cy, z - cz, indexing="ij")
    inside = (XX ** 2 + YY ** 2 + ZZ ** 2 < (min(size) / 4) ** 2) & ball
    eps = np.where(inside, 4.0, 1.0)
    chi1inv = {c: {c[1]: 1.0 / eps} for c in ("ex", "ey", "ez")} \
        if ball else {}
    pols = []
    if pol:
        pols = [pkg.P.PolSpec(field_type="e", omega0=2.0, gamma=0.05,
                              drude=drude,
                              sigma={(c, c[1]): 0.2 * inside.astype(float)
                                     for c in ("ex", "ey", "ez")})]
    nr_chi2 = {c: 0.05 * inside.astype(float) for c in ("ex", "ey", "ez")} \
        if nr else {}
    chi3_d = {c: 0.02 * inside.astype(float) for c in ("ex", "ey", "ez")} \
        if chi3 else {}
    sig_b = {(c, c[1]): 0.2 * inside.astype(float) for c in ("hx", "hy", "hz")}
    if hpol:
        pols.append(pkg.P.PolSpec(field_type="h", omega0=2.0, gamma=0.05,
                                  sigma=sig_b))
    if noisy:
        pols.append(pkg.P.PolSpec(field_type="e", omega0=2.0, gamma=0.05,
                                  kind="noisy", noise_amp=0.1,
                                  sigma={("ez", "z"): 0.2 * inside}))
    if offdiag:
        chi1inv = {"ex": {"x": 1.0 / eps, "y": 0.05 * inside}}
    mat = pkg.P.MaterialSpec(
        chi1inv=chi1inv, pols=pols, nr_chi2=nr_chi2, chi3=chi3_d,
        cond={"dz": 0.1 * inside.astype(float)} if cond else {})
    src_t = pkg.Gaussian(frequency=1.0, fwidth=0.5)
    pts = gv.interp_weights(src_comp, [-size[0] * 0.3, 0.05, 0.0])
    idx = np.array([p for p, w in pts], np.int32)
    amps = np.array([w * res ** 3 for p, w in pts], np.complex128)
    src = pkg.P.SrcVolSpec(src_comp, idx, amps, src_t,
                           is_integrated=integrated)
    dfts = []
    if flux:
        dfts = pkg.M.flux_specs(gv, "flux", "x", [size[0] * 0.3, 0.0, 0.0],
                                [0.0, size[1] * 0.5, size[2] * 0.5],
                                np.linspace(0.8, 1.2, 3))
    pmls = [pkg.P.PMLSpec(d, pml) for d in pml_axes]
    return pkg.P.compile_plan(gv, mat, pmls=pmls, sources=[src], dfts=dfts,
                              pad_to_multiple=pad, dtype=dtype, **extra)


#: the configurations the parity tests step (name -> build_plan kwargs)
CASES = {
    "no_pml": dict(pml_axes=""),
    "upml": dict(),
    "upml_subset": dict(pml_axes="xz"),
    "flagship": dict(ball=True, pol=True, nr=True, flux=True),
}


def random_state(plan_j, seed, scale=1e-2):
    """A random numpy state in the JAX plan's state layout (fields masked;
    PML auxiliaries and polarizations random everywhere)."""
    from meep_nl_tpu.stepper.step import init_state
    rng = np.random.default_rng(seed)
    st = init_state(plan_j)
    C = plan_j.coefs
    out = {"f": {}, "f_u": {}, "f_cond": {}, "f_w": {}, "pol": [],
           "dft": {k: np.asarray(v) for k, v in st["dft"].items()}, "t": 0}
    dt = plan_j.dtype
    for c, v in st["f"].items():
        out["f"][c] = (scale * rng.standard_normal(v.shape)
                       * np.asarray(C[f"mask:{c}"])).astype(dt)
    for key in ("f_u", "f_w"):
        for c, v in st[key].items():
            out[key][c] = (scale * rng.standard_normal(v.shape)).astype(dt)
    for e in st["pol"]:
        out["pol"].append({
            k: {c: (scale * rng.standard_normal(v.shape)).astype(dt)
                for c, v in e[k].items()} for k in ("p", "pp")})
    return out


# ---------------------------------------------------------------------------
# the plan parity tests
# ---------------------------------------------------------------------------


def _spec_fields(spec):
    out = {}
    for f in dataclasses.fields(spec):
        v = getattr(spec, f.name)
        if f.name == "src_time":
            v = dataclasses.asdict(v)
        out[f.name] = v
    return out


def _assert_same(a, b, what):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _assert_same(a[k], b[k], f"{what}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=what)
    else:
        assert a == b, f"{what}: {a!r} != {b!r}"


PLAN_CASES = {
    "vacuum_upml": dict(),
    "flagship": dict(ball=True, pol=True, nr=True, flux=True),
    "flagship_fp64_chi3": dict(ball=True, pol=True, nr=True, chi3=True,
                               flux=True, dtype=np.float64),
}


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_plans_agree(name):
    kw = PLAN_CASES[name]
    with jax.enable_x64(kw.get("dtype") == np.float64):
        pj = build_plan(JAX, **kw)
        cj = {k: np.asarray(v) for k, v in pj.coefs.items()}
    pt = build_plan(PORT, device="cpu", **kw)
    ct = interop.coefs_to_numpy(pt.coefs)
    assert set(cj) == set(ct)
    for k in cj:
        assert cj[k].dtype == ct[k].dtype, k
        assert cj[k].shape == ct[k].shape, k
        if cj[k].dtype.kind == "f":
            np.testing.assert_allclose(ct[k], cj[k], rtol=1e-15, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(ct[k], cj[k], err_msg=k)
    # the JAX coefficients carried across into tensors and back are intact
    back = interop.coefs_to_numpy(interop.coefs_from_numpy(cj, "cpu"))
    for k in cj:
        np.testing.assert_array_equal(back[k], cj[k], err_msg=k)
    skip = {"coefs", "device", "gv"}
    for f in dataclasses.fields(pj):
        if f.name in skip:
            continue
        a, b = getattr(pj, f.name), getattr(pt, f.name)
        if f.name in ("curl_specs_b", "curl_specs_d", "eh_specs_h",
                      "eh_specs_e", "pol_specs_e", "pol_specs_h",
                      "sources", "dfts"):
            a = [_spec_fields(s) for s in a]
            b = [_spec_fields(s) for s in b]
        _assert_same(a, b, f.name)
    assert dataclasses.asdict(pj.gv) == dataclasses.asdict(pt.gv)


def test_plan_device_default_is_cuda():
    """compile_plan runs on CUDA unless told otherwise, and raises where
    there is none."""
    if torch.cuda.is_available():
        assert build_plan(PORT).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            build_plan(PORT)
