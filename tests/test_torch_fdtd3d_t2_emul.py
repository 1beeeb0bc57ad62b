"""K2's CUDA source on the CPU: csrc/fdtd3d_t2.cu compiled by the host's C++
compiler against the stand-in headers of tests/cuda_stub and run as one
thread, against the plain version `steps_ref`.

This executes the kernel's own code -- the op table, the ring addressing,
the LOAD/STORE tables with their slab rules, the polarization roles, the
source and capture ops -- through the wrapper's argument block.  In fp32 it
agrees with the plain version bit for bit (both sides round alike: no FMA
contraction); in fp64 to 1e-12 of the field maximum.
One thread hides every race, so the ordering of the ops is checked
separately (test_torch_fdtd3d_t2.py replays the schedule), and the parallel
kernel on the card by test_torch_fdtd3d_t2_gpu.py and chip_smoke.py.  Skips
where there is no g++."""

import ctypes
import os
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from meep_nl_tpu_torch.ops import _build
from meep_nl_tpu_torch.ops import fdtd3d as TF
from meep_nl_tpu_torch.ops import fdtd3d_t2 as T2
from meep_nl_tpu_torch.stepper import step as TS

from test_torch_fdtd3d_t2_gpu import CASES, _clone, _plan, _random_state

torch.set_num_threads(2)
STUB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_stub")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    out = str(tmp_path_factory.mktemp("k2") / "libk2_host.so")
    subprocess.run(
        ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-Wno-unknown-pragmas", "-I", STUB, "-I", _build.CSRC, "-x", "c++",
         os.path.join(_build.CSRC, "fdtd3d_t2.cu"), "-o", out], check=True)
    lib = ctypes.CDLL(out)
    lib.mnt_k2_args_size.restype = ctypes.c_longlong
    lib.mnt_k2_max_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.mnt_k2_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p]
    assert lib.mnt_k2_args_size() == ctypes.sizeof(T2._K2Args)
    return lib


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_source_matches_plain_on_the_host(case, host_lib, monkeypatch):
    scene, depth, caps, dtype, src, bx = CASES[case]
    monkeypatch.setattr(T2, "_lib", lambda: host_lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    # the wrapper's tensor checks want CUDA tensors; here they are the host's
    monkeypatch.setattr(TF.Fdtd3dKernel, "_check", lambda self, state: None)
    plan = _plan(scene, "cpu", dtype, src)
    planes = [("ey", 20), ("ez", 20), ("ez", 21), ("hy", 20), ("hz", 0),
              ("hz", plan.storage_shape[0] - 1)] if caps else None
    ker = T2.Fdtd3dT2Kernel(plan, depth=depth, cap_planes=planes,
                            bx=bx or 5)
    ref = T2.steps_ref(plan, depth, planes)
    rows = TS.xs_rows(plan, TS.build_xs(plan, 2 * depth, 20))
    st0 = _random_state(plan, 9)
    scale = max(float(t.abs().max()) for t in st0["f"].values())
    tol = 0.0 if dtype == np.float32 else 1e-12 * scale

    def same(a, b):
        return float((a - b).abs().max()) <= tol

    sk, sr = _clone(st0), _clone(st0)
    for c in range(2):
        xc = rows[c * depth:(c + 1) * depth]
        sk, ck = ker._step_cuda(sk, xc)
        sr, cr = ref(sr, xc)
        assert set(ck) == set(cr)
        for key in cr:
            assert same(ck[key], cr[key]), key
    assert ker.launches == 2 and ker._cuda["R"] < plan.storage_shape[0] \
        or bx == 40
    assert float((sr["f"]["ez"] - st0["f"]["ez"]).abs().max()) > 0
    for key in ("f", "f_u", "f_w"):
        for c, t in sr[key].items():
            assert same(sk[key][c], t), f"{key}[{c}]"
    for pk, pr in zip(sk["pol"], sr["pol"]):
        for k in ("p", "pp"):
            for c, t in pr[k].items():
                assert same(pk[k][c], t), f"pol {k}[{c}]"
