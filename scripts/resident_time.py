#!/usr/bin/env python3
"""Time K3 and K4 (csrc/resident.cu) on one GPU at chip_smoke.py's phase 4,
7 and 8 shapes, for comparing two trees in one call.

    python3 scripts/resident_time.py [--root DIR] [--sweep]

Imports the port and chip_smoke.py from DIR (default: this checkout), so a
second unpacked tree can be timed by the same script; run it for parent,
change, change, parent in one call.  Scenes: the 767^2 resident scene
without a monitor and with its flux line (K3, 1000-step launches from the
state after 24 steps), the ring resonator at resolution 10 with one Ez
point probe (K4, 1024-step launches from the state after 2000 steps),
phase 4's 16^3 flagship scene (K3 in 3D: chi2, a Lorentz pole; 200-step
launches from the state after 24 steps) and the walls of chip_smoke.py
phase 8's two ring runs through `Simulation.run` (Harminv with
until_after_sources=300; the decay stop), each twice.  Prints ptxas's
report on each variant of the kernel (registers, stack frame, spills;
csrc/resident.cu compiled with the port's nvcc flags), each scene's
schedule where the tree has one (tiles, T, blocks, passes), ms/step of the
launches alone (CUDA events, best of 5 calls) and of the wrapper's call,
and the card's name and power limit; on a tree with the direct schedule
(`resident.direct_tiling`) also the 767^2 and ring scenes forced onto it.
Needs a CUDA device.  `--sweep` also times K4 at the ring and K3 at 767^2
(flux line) over a set of tiles and T (`resident.tiling`'s `force`) and
fits ops/resident.py's cost model (COST_*) to those times by non-negative
least squares (`fit`).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


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


#: (tile, T) pairs of the sweep, per scene
SWEEP = {"ring": [((16, 16, 1), 4), ((16, 16, 1), 8), ((16, 16, 1), 12),
                  ((24, 24, 1), 8), ((32, 32, 1), 8), ((32, 32, 1), 4),
                  ((12, 12, 1), 6), ((16, 32, 1), 8), ((41, 41, 1), 8),
                  ((24, 24, 1), 12)],
         "767": [((56, 56, 1), 4), ((48, 48, 1), 4), ((48, 48, 1), 8),
                 ((64, 48, 1), 4), ((40, 40, 1), 6), ((32, 32, 1), 8),
                 ((64, 64, 1), 2), ((80, 48, 1), 3), ((96, 32, 1), 4),
                 ((32, 64, 1), 6)]}


def features(R, tl, nslot, nstate, nloops, sms):
    """The terms of ops/resident.py::step_us for tiling `tl`, in the order
    of its constants: barrier, bytes, rounds; each per step."""
    import numpy as np
    T, vol = tl["T"], tl["vol"]
    waves = -(-tl["ntile"] // sms)
    moved = 4 * (nslot * vol + nstate * int(np.prod(tl["t"])))
    rounds = -(-vol // R.NTHR)
    return [1 / T, waves * moved / T, waves * nloops * rounds]


def fit(rows):
    """Non-negative least-squares constants (barrier us, us per byte,
    round us) from rows of (features, measured us per step), and the worst
    relative misfit."""
    import numpy as np
    from scipy.optimize import nnls
    X = np.array([r[0] for r in rows])
    y = np.array([r[1] for r in rows])
    c, _ = nnls(X, y)
    return c, float(np.max(np.abs(X @ c - y) / y))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--sweep", action="store_true")
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

    def sched(ker, n, probed):
        text = getattr(CS, "schedule_text", None)
        return f"; {text(ker, n, probed)}" if text else ""

    rows = []
    has_direct = hasattr(R, "direct_tiling")
    tiling = getattr(R, "tiling", None)

    def timed(what, ker, st, t, n, probes=(), force=None):
        """Time ker over n steps from (st, t), with tiling() forced to
        `force` = (tile, T), or "direct" for the direct schedule."""
        if force is not None:
            def forced(*args, **kw):
                return None if force == "direct" else \
                    tiling(*args, **kw, force=force)
            R.tiling, ker.schedule = forced, None
        try:
            ms, call = CS.time_resident(
                lambda s_, n_: ker._run(s_, n_, t, probes), st, n, reps=5)
            text = sched(ker, n, bool(probes))
        finally:
            if force is not None:
                R.tiling = tiling
        print(f"{what}: {ms:.4f} ms/step (call {call:.4f}) [{a.root}] "
              f"({card}){text}", flush=True)
        if force not in (None, "direct"):
            paths, _, _, coef, _, _ = ker._layout()
            rp = ker.rplan
            nloops = len(rp.curl_specs_b + rp.eh_specs_h + rp.curl_specs_d
                         + rp.eh_specs_e)
            rows.append((features(R, ker.schedule[1],
                                  len(paths) + len(coef), len(paths), nloops,
                                  R._lib().mnt_k3_sms()), 1e3 * ms))
        if force is not None:
            ker.schedule = None

    def wall(what, run):
        """The wall of run(sim) on a fresh ring simulation whose kernel is
        made first, twice."""
        for rep_ in range(2):
            sim = CS.ring_sim(mp, 10, "cuda")
            sim.init_sim()
            R._kernel(sim.plan)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(sim)
            torch.cuda.synchronize()
            w = time.perf_counter() - t0
            print(f"{what} wall, run {rep_ + 1}: {sim._t} steps in {w:.4f} s "
                  f"= {w / sim._t * 1e3:.4f} ms/step, routes "
                  f"{dict(sim.routes)} [{a.root}] ({card})", flush=True)

    for flux in (False, True):
        sim, _ = CS.resident_sim(mp, 767, "cuda", flux)
        sim.run(until=24 * sim.dt)
        ker, st, t = sim.plan._resident_kernel, sim.fields_state, sim._t
        label = "flux line" if flux else "no monitor"
        timed(f"K3 767^2 {label}", ker, st, t, 1000)
        if has_direct:
            timed(f"K3 767^2 {label}, direct schedule forced", ker, st, t,
                  1000, force="direct")
        if a.sweep and flux:
            for force in SWEEP["767"]:
                timed(f"sweep K3 767^2 {label} {force}", ker, st, t, 1000,
                      force=force)
        del sim, st
    sim = CS.ring_sim(mp, 10, "cuda")
    sim.run(until=2000 * sim.dt)
    ker, st, t = R._kernel(sim.plan), sim.fields_state, sim._t
    probe = [sim._point_probe("hm0", mp.Ez, mp.Vector3(1.1))]
    timed("K4 ring 161^2", ker, st, t, 1024, probe)
    if has_direct:
        timed("K4 ring 161^2, direct schedule forced", ker, st, t, 1024,
              probe, force="direct")
    if a.sweep:
        for force in SWEEP["ring"]:
            timed(f"sweep K4 ring 161^2 {force}", ker, st, t, 1024, probe,
                  force=force)
    del sim, st
    if rows:
        c, worst = fit(rows)
        print("cost model fit (COST_BARRIER, COST_BYTES_PER_US, COST_ROUND): "
              f"{c[0]:.4f}, {1 / c[1] if c[1] > 0 else float('inf'):.1f}, "
              f"{c[2]:.4f}; worst relative misfit {worst:.3f} over "
              f"{len(rows)} timings", flush=True)
    sim, _ = CS.flagship_sim(mp, 16, 8.0, "cuda", pml=0.25)
    sim.run(until=24 * sim.dt)
    ker, st, t = sim.plan._resident_kernel, sim.fields_state, sim._t
    timed(f"K3 16^3 flagship {sim.plan.storage_shape}", ker, st, t, 200)
    del sim, st
    wall("ring Harminv run (after_sources(Harminv), until_after_sources="
         "300)", lambda sim: sim.run(mp.after_sources(mp.Harminv(
             mp.Ez, mp.Vector3(1.1), 0.15, 0.1)), until_after_sources=300))
    wall("ring decay run (stop_when_fields_decayed(50, Ez, (1.1, 0), "
         "1e-3))", lambda sim: sim.run(
             until_after_sources=mp.stop_when_fields_decayed(
                 50, mp.Ez, mp.Vector3(1.1), 1e-3)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
