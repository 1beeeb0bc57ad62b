"""K5's CUDA source on the CPU: csrc/fused.cu compiled by the host's C++
compiler against the stand-in headers of tests/cuda_stub, each block run
as one thread that owns every site of its tile, through the real wrapper
(`HalfStepKernel._half_cuda`: its argument block, ring roles and per-tile
source lists), against the plain versions `half_step_ref` and
`SourceFixup._ref`.

This executes the kernel's own code -- the tile and chunk walk, the plane
ring with its halos and zero fill, the staged per-axis vectors, the chains,
the masks, the sources' binary search and order -- built once with a
(4, 8) y-z tile and run with chunks of 3 x-planes, so that tile seams,
ring halos read from a neighbour tile and chunk edges fall inside these
small grids: on test_torch_fused_gpu.CASES (tests/test_pallas.py's plans,
padded storage, fp64, an Hz source with mu != 1) and on its SEAMS plans
(current sources on tile seams and chunk edges, repeated within a source,
shared by two sources, on dead E/H planes; E and H families), the latter
with the grid's blocks run forward, reversed and in a seeded shuffle (the
halves are in place and read across sites only the other family, so every
order gives the same result).  Both sides round alike (no FMA
contraction): fp32 bit for bit, fp64 to 1e-12 of the field maximum.  One
thread per block hides races inside a block; the parallel kernel is held on
the card by test_torch_fused_gpu.py and chip_smoke.py.  Skips where there
is no g++."""

import ctypes
import os
import shutil
import subprocess
import types

import pytest
import torch

from meep_nl_tpu_torch.ops import _build
from meep_nl_tpu_torch.ops import fused as TFU

from test_torch_fused_gpu import CASES, SEAMS, hold_step, port_plan

torch.set_num_threads(2)
STUB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_stub")
#: block orders of the stub: forward, reversed, a seeded shuffle
ORDERS = {"forward": 0, "reversed": 1, "shuffled": 7}
#: x-planes per chunk
CH = 3


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    out = str(tmp_path_factory.mktemp("k5") / "libk5_host.so")
    subprocess.run(
        ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-Wno-unknown-pragmas", "-DK5_TY=4", "-DK5_TZ=8", "-I", STUB, "-I",
         _build.CSRC, "-x", "c++", os.path.join(_build.CSRC, "fused.cu"),
         "-o", out], check=True)
    lib = TFU.bind(ctypes.CDLL(out))
    lib.stub_set_block_order.argtypes = [ctypes.c_int]
    assert lib.mnt_tile == (4, 8)
    return lib


def emulated_run(case, order, lib, monkeypatch):
    """hold_step on the case's plan with the kernel source run on the host,
    the blocks in `order`, chunks of CH planes."""
    lib.stub_set_block_order(ORDERS[order])
    monkeypatch.setattr(TFU, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    # the wrapper's tensor checks want CUDA tensors; here they are the host's
    monkeypatch.setattr(TFU, "_check_state", lambda *args: None)
    plan = port_plan(case, "cpu")
    halves = [TFU.HalfStepKernel(plan, f, ch=CH) for f in "bd"]

    def run(sk, rows):
        for row in rows:
            for h in halves:
                sk["f"], sk["f_u"], sk["f_w"] = h._half_cuda(
                    sk["f"], sk["f_u"], sk["f_w"], row)
        return sk

    hold_step(plan, run, 3)
    assert [h.launches for h in halves] == [4, 4]


@pytest.mark.parametrize("case", sorted(set(CASES) - {"vacuum"}))
def test_kernel_source_matches_plain_on_the_host(case, host_lib,
                                                 monkeypatch):
    emulated_run(case, "forward", host_lib, monkeypatch)


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("case", sorted(SEAMS))
def test_seam_sources_match_plain_in_any_block_order(case, order, host_lib,
                                                     monkeypatch):
    emulated_run(case, order, host_lib, monkeypatch)


def test_waveforms_from_a_device_table(host_lib, monkeypatch):
    """Waveforms that do not fit the argument block (here MAXSRC = 0) come
    from a device table."""
    monkeypatch.setattr(TFU, "MAXSRC", 0)
    emulated_run("seams_ez", "shuffled", host_lib, monkeypatch)
