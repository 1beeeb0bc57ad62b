"""K5's CUDA source on the CPU: csrc/fused.cu compiled by the host's C++
compiler against the stand-in headers of tests/cuda_stub and run as one
thread through the real wrappers (`HalfStepKernel._half_cuda`,
`SourceFixup._fix_cuda`), against the plain versions `half_step_ref` and
the fix-up's PyTorch scatter-adds.

This executes the kernel's own code -- the neighbour reads with their zero
fill, the coefficient strides, the chains, the masks, the site tables of
the fix-up -- through the wrappers' argument blocks, on a padded fp32 plan,
an fp32 dielectric plan, an fp64 plan and an Hz-source plan with mu != 1
(the B family's fix-up).  Both sides round alike (no FMA contraction), so
they agree bit for bit.  One thread hides every race; the parallel kernel
is held on the card by test_torch_fused_gpu.py and chip_smoke.py.  Skips
where there is no g++."""

import ctypes
import os
import shutil
import subprocess
import types

import pytest
import torch

from meep_nl_tpu_torch.ops import _build
from meep_nl_tpu_torch.ops import fused as TFU
from meep_nl_tpu_torch.stepper import step as TS

from test_torch_fdtd3d_t2_gpu import _clone, _random_state
from test_torch_fused_gpu import CASES, T0, port_plan

torch.set_num_threads(2)
STUB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_stub")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    out = str(tmp_path_factory.mktemp("k5") / "libk5_host.so")
    subprocess.run(
        ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-Wno-unknown-pragmas", "-I", STUB, "-I", _build.CSRC, "-x", "c++",
         os.path.join(_build.CSRC, "fused.cu"), "-o", out], check=True)
    lib = ctypes.CDLL(out)
    lib.mnt_k5_params_size.restype = ctypes.c_longlong
    lib.mnt_k5_fixargs_size.restype = ctypes.c_longlong
    lib.mnt_k5_half.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p]
    lib.mnt_k5_fixup.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p]
    assert lib.mnt_k5_params_size() == ctypes.sizeof(TFU._Params)
    assert lib.mnt_k5_fixargs_size() == ctypes.sizeof(TFU._FixArgs)
    return lib


@pytest.mark.parametrize("case", sorted(set(CASES) - {"vacuum"}))
def test_kernel_source_matches_plain_on_the_host(case, host_lib,
                                                 monkeypatch):
    monkeypatch.setattr(TFU, "_lib", lambda: host_lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    # the wrapper's tensor checks want CUDA tensors; here they are the host's
    monkeypatch.setattr(TFU, "_check_state", lambda *args: None)
    plan = port_plan(case, "cpu")
    halves = {f: TFU.HalfStepKernel(plan, f) for f in "bd"}
    fixes = {f: TFU.build_source_fixup(plan, f) for f in "bd"}
    fam = "b" if CASES[case][3] == "hz" else "d"
    assert fixes[fam] is not None and fixes["bd".replace(fam, "")] is None
    rows = TS.xs_rows(plan, TS.build_xs(plan, 3, T0))
    st0 = _random_state(plan, 9)
    sk, sr = _clone(st0), _clone(st0)
    for row in rows:
        for f in "bd":
            sk["f"], sk["f_u"], sk["f_w"] = halves[f]._half_cuda(
                sk["f"], sk["f_u"], sk["f_w"])
            sr["f"], sr["f_u"], sr["f_w"] = halves[f]._ref(
                sr["f"], sr["f_u"], sr["f_w"])
            if fixes[f] is not None:
                sk["f"], sk["f_w"] = fixes[f]._fix_cuda(sk["f"], sk["f_w"],
                                                        row)
                sr["f"], sr["f_w"] = fixes[f]._ref(sr["f"], sr["f_w"],
                                                   plan.coefs, row)
    assert halves["b"].launches == halves["d"].launches == 3
    assert fixes[fam].launches == 3
    assert float((sr["f"]["ez"] - st0["f"]["ez"]).abs().max()) > 0
    for key in ("f", "f_u", "f_w"):
        for c, t in sr[key].items():
            assert torch.equal(sk[key][c], t), f"{key}[{c}]"
