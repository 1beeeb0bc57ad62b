#!/usr/bin/env python3
"""Time K3 and K4 (csrc/resident.cu) on one GPU at chip_smoke.py's phase 7
and 8 shapes, for comparing two trees in one call.

    python3 scripts/resident_time.py [--root DIR]

Imports the port and chip_smoke.py from DIR (default: this checkout), so a
second unpacked tree can be timed by the same script.  Scenes: the 767^2
resident scene without a monitor and with its flux line (K3, 1000-step
launches from the state after 24 steps), and the ring resonator at
resolution 10 with one Ez point probe (K4, 1024-step launches from the
state after 2000 steps).  Prints ptxas's report on each variant of the
kernel (registers, stack frame, spills; csrc/resident.cu compiled with the
port's nvcc flags), ms/step of the launches alone (CUDA events, best of 5
calls) and of the wrapper's call, and the card's name and power limit;
needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def ptxas_report(build) -> str:
    """ptxas -v's lines on csrc/resident.cu's kernels, built as `build`
    (the port's ops/_build module) builds them."""
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    out = os.path.join(build.BUILD_DIR, "ptxas_report.so")
    res = subprocess.run(
        [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", build.CSRC,
         "-o", out, os.path.join(build.CSRC, "resident.cu")],
        capture_output=True, text=True, check=True)
    os.remove(out)
    keep = ("Compiling entry", "stack frame", "Used")
    return "\n".join(ln.strip() for ln in res.stderr.splitlines()
                     if any(k in ln for k in keep))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    import torch
    if not torch.cuda.is_available():
        print("resident_time: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    import meep_nl_tpu_torch as mp
    from meep_nl_tpu_torch.ops import _build
    from meep_nl_tpu_torch.ops import resident as R

    card = CS.card_line()
    print(f"ptxas [{a.root}]:\n{ptxas_report(_build)}", flush=True)
    for flux in (False, True):
        sim, _ = CS.resident_sim(mp, 767, "cuda", flux)
        sim.run(until=24 * sim.dt)
        ker, st, t = sim.plan._resident_kernel, sim.fields_state, sim._t
        ms, call = CS.time_resident(lambda s_, n_: ker._run(s_, n_, t, ()),
                                    st, 1000, reps=5)
        print(f"K3 767^2 {'flux line' if flux else 'no monitor'}: {ms:.4f} "
              f"ms/step (call {call:.4f}) [{a.root}] ({card})", flush=True)
        del sim, st
    sim = CS.ring_sim(mp, 10, "cuda")
    sim.run(until=2000 * sim.dt)
    ker, st, t = R._kernel(sim.plan), sim.fields_state, sim._t
    probe = [sim._point_probe("hm0", mp.Ez, mp.Vector3(1.1))]
    ms, call = CS.time_resident(lambda s_, n_: ker._run(s_, n_, t, probe),
                                st, 1024, reps=5)
    print(f"K4 ring 161^2: {ms:.4f} ms/step (call {call:.4f}) [{a.root}] "
          f"({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
