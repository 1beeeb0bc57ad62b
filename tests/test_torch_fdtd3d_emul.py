"""K1's CUDA source on the CPU: csrc/fdtd3d.cu compiled by the host's C++
compiler against the stand-in headers of tests/cuda_stub and run as one
thread of one block, through the real wrapper (`Fdtd3dKernel._step_cuda`:
its argument blocks, ring roles, support boxes and per-tile source lists),
against the plain version `step_ref`.

This executes the kernel's own code -- the tile and chunk walk, the plane
ring with its halos and zero fill, the staged per-axis vectors, the
support-box skips, the sources' binary search and order -- on the cases of
test_torch_fdtd3d_gpu.CASES (grids that are not multiples of the tile and
one smaller than a tile, the flagship material with its nonlinear box
across a tile edge and chunk edges, H-family and volume sources with
repeated sites, more current sources than a launch takes by value, dead
mask planes, slab and full-grid chains, padded storage), built with the
card's (8, 32) y-z tile and with a (4, 8) tile that puts tile edges, and
so ring halos read from a neighbour tile, inside these small grids.  In
fp32 it agrees with the plain version bit for bit (both round alike: no
FMA contraction), in fp64 to 1e-12 of the field maximum.
One thread hides every race: the parallel kernel is held on the card by
test_torch_fdtd3d_gpu.py and chip_smoke.py.  Skips where there is no
g++."""

import ctypes
import os
import shutil
import subprocess
import types

import pytest
import torch

from meep_nl_tpu_torch.ops import _build
from meep_nl_tpu_torch.ops import fdtd3d as TF

from test_torch_fdtd3d_gpu import CASES, NSTEP_CASE, hold_case

torch.set_num_threads(2)
STUB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_stub")


#: y-z tiles the source is built with: the card's, and one smaller than
#: the test grids
TILES = {"tile8x32": (), "tile4x8": ("-DK1_TY=4", "-DK1_TZ=8")}


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    # one g++ per tile variant, all started together
    outs, procs = {}, []
    for name, flags in TILES.items():
        outs[name] = str(tmp_path_factory.mktemp("k1") / f"libk1_{name}.so")
        procs.append(subprocess.Popen(
            ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
             "-fPIC", "-Wno-unknown-pragmas", *flags, "-I", STUB, "-I",
             _build.CSRC, "-x", "c++",
             os.path.join(_build.CSRC, "fdtd3d.cu"), "-o", outs[name]]))
    assert all(p.wait() == 0 for p in procs), "g++ failed"
    return {name: TF.bind(ctypes.CDLL(out)) for name, out in outs.items()}


@pytest.mark.parametrize("tile", sorted(TILES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_source_matches_plain_on_the_host(case, tile, host_libs,
                                                 monkeypatch):
    lib = host_libs[tile]
    monkeypatch.setattr(TF, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    # the wrapper's tensor checks want CUDA tensors; here they are the host's
    monkeypatch.setattr(TF.Fdtd3dKernel, "_check", lambda self, state: None)
    ker = hold_case(case, "cpu", lambda k, s, r: k._step_cuda(s, r))
    assert ker.launches == 3 * NSTEP_CASE
