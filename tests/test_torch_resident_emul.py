"""K3/K4's CUDA source on the CPU: csrc/resident.cu compiled by the host's
C++ compiler against the stand-in headers of tests/cuda_stub and run as one
thread through the real wrapper (`ResidentKernel._run_cuda`), against the
plain version `resident_ref`.

This executes the kernel's own code -- the phases and their order, the
fused and split E/H phases, the source site tables, the P/PP roles of odd
and even steps across chunk seams, the DTFT with its centred average, the
probe sums -- through the wrapper's argument block.  Both sides round alike
(no FMA contraction), so they agree bit for bit.  One thread hides every
race; the parallel kernel is held against the plain version on the card by
test_torch_resident_gpu.py and chip_smoke.py.  Skips where there is no
g++."""

import ctypes
import os
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

import meep_nl_tpu_torch as mp
from meep_nl_tpu_torch.ops import _build
from meep_nl_tpu_torch.ops import resident as R
from meep_nl_tpu_torch.stepper import step as TS

torch.set_num_threads(2)
STUB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_stub")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    out = str(tmp_path_factory.mktemp("k3") / "libk3_host.so")
    subprocess.run(
        ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-Wno-unknown-pragmas", "-I", STUB, "-I", _build.CSRC, "-x", "c++",
         os.path.join(_build.CSRC, "resident.cu"), "-o", out], check=True)
    lib = ctypes.CDLL(out)
    lib.mnt_k3_args_size.restype = ctypes.c_longlong
    lib.mnt_k3_max_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.mnt_k3_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_void_p]
    lib.mnt_k3_launch.restype = ctypes.c_int
    assert lib.mnt_k3_args_size() == ctypes.sizeof(R._ResArgs)
    return lib


def scene(kind, device="cpu", res=10):
    """tm: 2D TM, eps=12 cylinder, PML, Ez point source, flux line; disp:
    2D Lorentz + chi2-NR block; te: 2D TE with an Hz point source and an Ex
    line source on a chi2-NR cylinder (E reads neighbours: split phases);
    flag-tm / flag-te: the flagship material (eps=4, a Lorentz pole,
    full-tensor chi2) on a cylinder, TM or TE; tm-many: tm with 25 more
    flux lines (52 DTFT monitors); 3d: a 24^3 eps=8 ball with a flux
    plane."""
    src = [mp.Source(mp.GaussianSource(0.5, fwidth=0.2), mp.Ez,
                     center=mp.Vector3(-2, 0.1))]
    geom = [mp.Cylinder(radius=1.0, material=mp.Medium(epsilon=12))]
    cell, flux_size = mp.Vector3(6, 5), mp.Vector3(0, 1.5)
    if kind.startswith("flag"):
        geom = [mp.Cylinder(radius=1.2, material=mp.Medium(
            epsilon=4.0, chi2=0.05, chi2_full_tensor=True,
            E_susceptibilities=[mp.LorentzianSusceptibility(
                frequency=2.0, gamma=0.05, sigma=0.2)]))]
        if kind == "flag-te":
            src = [mp.Source(mp.GaussianSource(0.5, fwidth=0.2), mp.Ey,
                             center=mp.Vector3(-2, 0.1))]
    elif kind == "disp":
        geom = [mp.Block(size=mp.Vector3(2, 2, mp.inf), material=mp.Medium(
            epsilon=3, chi2=0.2, chi2_full_tensor=True,
            E_susceptibilities=[mp.LorentzianSusceptibility(
                frequency=1.1, gamma=0.1, sigma=0.4)]))]
    elif kind == "te":
        geom = [mp.Cylinder(radius=1.0, material=mp.Medium(
            epsilon=4, chi2=0.1, chi2_full_tensor=True))]
        src = [mp.Source(mp.GaussianSource(0.5, fwidth=0.2), mp.Hz,
                         center=mp.Vector3(-2, 0.3)),
               mp.Source(mp.GaussianSource(0.6, fwidth=0.2), mp.Ex,
                         center=mp.Vector3(-2, 0.3), size=mp.Vector3(0, 1))]
    elif kind == "3d":
        geom = [mp.Sphere(radius=0.7, material=mp.Medium(epsilon=8))]
        src = [mp.Source(mp.GaussianSource(0.8, fwidth=0.3), mp.Ez,
                         center=mp.Vector3(-0.6, 0, 0))]
        cell, res, flux_size = mp.Vector3(3, 3, 3), 8, mp.Vector3(0, 1, 1)
    sim = mp.Simulation(cell_size=cell, resolution=res, geometry=geom,
                        sources=src, boundary_layers=[mp.PML(0.8)],
                        device=device)
    sim.add_flux(0.5, 0.2, 3, mp.FluxRegion(center=mp.Vector3(0.9, 0, 0),
                                            size=flux_size))
    if kind == "tm-many":
        for i in range(25):
            sim.add_flux(0.5, 0.2, 2, mp.FluxRegion(
                center=mp.Vector3(-1.8 + 0.15 * i, 0), size=flux_size))
    sim.init_sim()
    return sim.plan


def random_state(plan, seed):
    rng = np.random.default_rng(seed)
    st = TS.init_state(plan)

    def rnd(t):
        return torch.from_numpy(1e-2 * rng.standard_normal(
            tuple(t.shape)).astype(np.float32)).to(t.device)

    st["f"] = {c: TS._apply_mask(plan, plan.coefs, c, rnd(t))
               for c, t in st["f"].items()}
    for key in ("f_u", "f_w"):
        st[key] = {c: rnd(t) for c, t in st[key].items()}
    st["pol"] = [{k: {c: rnd(t) for c, t in e[k].items()}
                  for k in ("p", "pp")} for e in st["pol"]]
    return st


def _own(self, st):
    """The wrapper's check, on host tensors: private copies of the state."""
    return {**st, **{k: {c: t.clone() for c, t in st[k].items()}
                     for k in ("f", "f_u", "f_w")},
            "pol": [{k: {c: t.clone() for c, t in e[k].items()}
                     for k in ("p", "pp")} for e in st["pol"]]}


#: case -> (scene, probed, steps, MAX_CHUNK)
CASES = {"tm-k3": ("tm", False, 13, 8192), "tm-k4": ("tm", True, 13, 8192),
         "many-k4": ("tm-many", True, 7, 8192),
         "disp-k4-seams": ("disp", True, 13, 5),
         "flag-te-k4": ("flag-te", True, 13, 8192),
         "te-k3-seams": ("te", False, 13, 5),
         "3d-k3": ("3d", False, 9, 8192), "3d-k4-seams": ("3d", True, 9, 4)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_source_matches_plain_on_the_host(case, host_lib,
                                                 monkeypatch):
    kind, probed, nsteps, chunk = CASES[case]
    monkeypatch.setattr(R, "_lib", lambda: host_lib)
    monkeypatch.setattr(R, "MAX_CHUNK", chunk)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(R.ResidentKernel, "_check", _own)
    plan = scene(kind)
    st0 = random_state(plan, 4)
    comp = {"te": "hz", "flag-te": "ey"}.get(kind, "ez")
    pt = [10, 10] + ([10] if kind == "3d" else [])
    probes = [TS.ProbeSpec("p0", comp, np.array([pt, [pt[0] + 1] + pt[1:]]),
                           np.array([0.6, 0.4])),
              TS.ProbeSpec("p1", comp, np.array([pt]), np.array([1.0]))] \
        if probed else []
    if kind == "tm-many":                  # tables of any length
        assert len(plan.dfts) > 50
        probes += [TS.ProbeSpec(f"q{i}", "ez" if i % 2 else "hy",
                                np.array([[10 + i, 12], [10 + i, 13]]),
                                np.array([0.25, 0.75])) for i in range(20)]
    ker = R.ResidentKernel(plan)
    t0 = 5                                 # the sources are on
    sk, yk = ker._run_cuda(st0, nsteps, t0, probes)
    sr, yr = R.resident_ref(plan)(st0, nsteps, t0, probes)
    nlaunch = -(-nsteps // chunk)
    assert (ker.probed_launches, ker.launches) == \
        ((nlaunch, 0) if probed else (0, nlaunch))
    assert int(sk["t"]) == int(sr["t"]) == nsteps
    for key in ("f", "f_u", "f_w", "dft"):
        for c, t in sr[key].items():
            assert torch.equal(sk[key][c], t), f"{key}[{c}]"
            assert key != "dft" or float(t.abs().max()) > 0
    for pk, pr in zip(sk["pol"], sr["pol"]):
        for k in ("p", "pp"):
            for c, t in pr[k].items():
                assert torch.equal(pk[k][c], t), f"pol {k}[{c}]"
    assert set(yk) == set(yr) == {p.name for p in probes}
    for k, t in yr.items():
        assert t.shape == (nsteps,) and torch.equal(yk[k], t), k
    assert float((sr["f"][comp] - st0["f"][comp]).abs().max()) > 0
