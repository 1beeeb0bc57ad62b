"""K2's CUDA source on the CPU: csrc/fdtd3d_t2.cu compiled by the host's C++
compiler against the stand-in headers of tests/cuda_stub, each block run
as one thread, through the real wrapper (`Fdtd3dT2Kernel._step_cuda`: its
items and ring layouts, source and capture lists, argument block and
out-of-place pairing), against the plain version `steps_ref` on the cases
of test_torch_fdtd3d_t2_gpu.CASES.

This executes the kernel's own code -- the x-march with its stage lags,
the overlapped regions and their clipping, the shared-memory rings, both
item classes, the sources of halo sites, the captures of owned sites --
built with the card's largest tile (16 x 16), with an 8 x 32 one and with
a 4 x 8 one, which put tile edges, and so overlapped halos, inside these
small grids.  In
fp32 it agrees with the plain version bit for bit (both round alike: no
FMA contraction), in fp64 to 1e-12 of the field maximum.

The stub runs a launch's blocks one after another, in an order it is told:
an item reads only the input state and writes only the output, so every
order gives the same result, which an in-place design would not.  One
thread per block hides races inside a block; those are left to the card
(test_torch_fdtd3d_t2_gpu.py, chip_smoke.py).  Skips where there is no
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
from meep_nl_tpu_torch.ops import fdtd3d_t2 as T2

from test_torch_fdtd3d_t2_gpu import CASES, NCALL, hold_case

torch.set_num_threads(2)
STUB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_stub")

#: the largest output tile the source is built with: the card's, a long
#: one, and one smaller than the test grids
TILES = {"tile16x16": (), "tile8x32": ("-DK2_TY=8", "-DK2_TZ=32"),
         "tile4x8": ("-DK2_TY=4", "-DK2_TZ=8")}
#: block orders of the stub: forward, reversed, a seeded shuffle
ORDERS = {"forward": 0, "reversed": 1, "shuffled": 7}


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    # one g++ per tile variant, all started together
    outs, procs = {}, []
    for name, flags in TILES.items():
        outs[name] = str(tmp_path_factory.mktemp("k2") / f"libk2_{name}.so")
        procs.append(subprocess.Popen(
            ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
             "-fPIC", "-Wno-unknown-pragmas", *flags, "-I", STUB, "-I",
             _build.CSRC, "-x", "c++",
             os.path.join(_build.CSRC, "fdtd3d_t2.cu"), "-o", outs[name]]))
    assert all(p.wait() == 0 for p in procs), "g++ failed"
    libs = {}
    for name, out in outs.items():
        lib = T2.bind(ctypes.CDLL(out))
        lib.stub_set_block_order.argtypes = [ctypes.c_int]
        libs[name] = lib
    return libs


def _emulate(monkeypatch, lib, order):
    lib.stub_set_block_order(order)
    monkeypatch.setattr(T2, "_lib", lambda: lib)
    # streams: the stub runs every launch when it is made
    stream = types.SimpleNamespace(cuda_stream=0,
                                   wait_stream=lambda other: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: stream)
    monkeypatch.setattr(T2, "side_stream", lambda device: stream)
    # the wrapper's tensor checks want CUDA tensors; here they are the host's
    monkeypatch.setattr(TF.Fdtd3dKernel, "_check", lambda self, state: None)


@pytest.mark.parametrize("tile", sorted(TILES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_source_matches_plain_on_the_host(case, tile, host_libs,
                                                 monkeypatch):
    _emulate(monkeypatch, host_libs[tile], ORDERS["forward"])
    ker = hold_case(case, "cpu", lambda k, s, r: k._step_cuda(s, r))
    assert ker.launches == NCALL * ker.launches_per_call
    assert ker._cuda["tile"] == host_libs[tile].mnt_tile
    if CASES[case][0] == "flagship":
        # both item classes ran
        assert 0 < ker._cuda["nl_items"] < ker._cuda["nitems"] or \
            tile != "tile4x8"


@pytest.mark.parametrize("order", ["reversed", "shuffled"])
@pytest.mark.parametrize("case", ["chunk-edges-d3-caps",
                                  "many-sources-d3-caps"])
def test_item_order_does_not_matter(case, order, host_libs, monkeypatch):
    """The overlapped items in other orders than forward give the plain
    version's state and captures bit for bit, as forward does."""
    _emulate(monkeypatch, host_libs["tile4x8"], ORDERS[order])
    ker = hold_case(case, "cpu", lambda k, s, r: k._step_cuda(s, r))
    assert ker._cuda["nitems"] > 8
