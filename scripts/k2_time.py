#!/usr/bin/env python3
"""K2 (meep_nl_tpu_torch/ops/fdtd3d_t2.py, csrc/fdtd3d_t2.cu) on one GPU:
its agreement with the plain version and its time per call beside K1's
launches replayed `depth` times and its bound, at the plans K2 runs in
chip_smoke.py.

    python3 scripts/k2_time.py [--tree DIR]

--tree imports meep_nl_tpu_torch and chip_smoke from DIR (an unpacked
commit), so that two trees are compared in one call by running the script
once per tree, in turns (parent, change, change, parent).  Plans, each
from a seeded random state at step 150 (the source near its peak), with
the slab-local chains of the hybrid route: the 128^3 flagship (depth 3
with the main path's capture planes, the flux plane's x-planes; depth 2
without), the 96^3 linear monitored scene and 255^3 vacuum uPML (depths 3
and 2).  For each plan and depth it prints
  * the largest |K2 - steps_ref| over one call (0.0: bit for bit);
  * K2's ms per call through the wrapper, CUDA events over 10 calls;
  * K1's step as its launches back to back with no host work
    (chip_smoke.launch_breakdown), times `depth`: the yardstick;
  * the bound (`step_cost` at 3.35 TB/s or 67 TFLOP/s) and the share of
    it K2 reaches;
  * for a tree whose K2 lists items: their count, the nonlinear ones, the
    two classes' shared memory, the linear blocks an SM, and (`class_times`)
    each class timed alone and the call with no narrow side;
then ptxas's report on the tree's csrc/fdtd3d_t2.cu (registers, stack,
spills per variant) and the card's name and power limit.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ptxas_report(build) -> str:
    """ptxas's report on the tree's csrc/fdtd3d_t2.cu, built with the
    port's flags."""
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    out = os.path.join(build.BUILD_DIR, f"ptxas_k2_{os.getpid()}.so")
    res = subprocess.run(
        [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", build.CSRC,
         "-o", out, os.path.join(build.CSRC, "fdtd3d_t2.cu")],
        capture_output=True, text=True, check=True)
    os.remove(out)
    keep = ("Compiling entry", "stack frame", "Used")
    return "\n".join("    " + ln.strip() for ln in res.stderr.splitlines()
                     if any(k in ln for k in keep))


def class_times(T2, CS, plan, ker, st, rows, depth, caps) -> str:
    """For a tree whose K2 splits its items into a linear and a nonlinear
    class: each class's launch timed alone (the other class's item count
    set to 0, so the state is wrong and only the time counts), and where
    the tree grows a nonlinear item's sides by 1 where it may
    (`side_widths`), the call with every side grown by 2."""
    cu = ker._cuda
    if not cu.get("nl_items") or cu["nitems"] == cu["nl_items"]:
        return ""
    A = cu["args"]
    n0, n1 = A.nitems[0], A.nitems[1]
    A.nitems[1] = 0
    lin, _ = CS.time_steps(ker.step, CS.clone_state(st), rows, per=depth,
                           nwarm=2)
    A.nitems[0], A.nitems[1] = 0, n1
    A.items = cu["items"][n0:].data_ptr()
    nl, _ = CS.time_steps(ker.step, CS.clone_state(st), rows, per=depth,
                          nwarm=2)
    A.nitems[0] = n0
    A.items = cu["items"].data_ptr()
    out = f"; linear class alone {lin:.4f} ms, nonlinear class alone {nl:.4f}"
    if hasattr(T2, "side_widths"):
        real = T2.side_widths
        T2.side_widths = lambda depth, sat, box: 63
        try:
            wide = T2.Fdtd3dT2Kernel(plan, depth=depth, cap_planes=caps)
            ms, _ = CS.time_steps(wide.step, CS.clone_state(st), rows,
                                  per=depth, nwarm=2)
        finally:
            T2.side_widths = real
        out += f"; every nonlinear side grown by 2: {ms:.4f} ms/call"
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("k2_time: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    import meep_nl_tpu_torch as mp
    from meep_nl_tpu_torch.ops import _build
    from meep_nl_tpu_torch.ops import fdtd3d_t2 as T2
    from meep_nl_tpu_torch.stepper.step import build_xs, xs_rows
    card = CS.card_line()
    label = os.path.relpath(tree, ROOT)
    CS.build_all()
    scenes = (("flagship 128^3", 128, dict()),
              ("linear 96^3", 96, dict(linear=True, decimation=5)),
              ("vacuum 255^3", 255, dict(flux=False, ball=False)))
    for scene, n, kw in scenes:
        sim, _ = CS.flagship_sim(mp, n, 16.0, "cuda", **kw)
        plan = sim.plan
        plan.slab_opt = True
        st = CS.random_state(plan, 5, "cuda")
        rows = xs_rows(plan, build_xs(plan, 36, 150))
        k1 = T2.k1_of(plan)
        k1_ms = CS.launch_breakdown(k1, CS.clone_state(st), rows[0])[
            "step"][0]
        for depth in (3, 2):
            caps = CS.flux_planes(plan) if n == 128 and depth == 3 else None
            ker = T2.Fdtd3dT2Kernel(plan, depth=depth, cap_planes=caps)
            ref = T2.steps_ref(plan, depth, caps)
            a, ca = ker.capture_step(CS.clone_state(st), rows[:depth])
            b, cb = ref(CS.clone_state(st), rows[:depth])
            err, _ = CS.state_error(a, b)
            err = max([err] + [float((ca[k] - cb[k]).abs().max())
                               for k in cb])
            del a, b, ca, cb
            ms, _ = CS.time_steps(ker.step, CS.clone_state(st), rows,
                                  per=depth, nwarm=2)
            b_ms, b_by = CS.bound(T2.step_cost(plan, depth,
                                               len(ker.captures)))
            items = ""
            cu = ker._cuda
            if "nitems" in cu:
                smem = [lay[0] * 4 / 1024 if lay else 0.0
                        for lay in cu["lays"]]
                items = (f"; {cu['nitems']} items ({cu['nl_items']} "
                         f"nonlinear), x-chunk {cu['ch']}, shared memory "
                         f"{smem[0]:.1f} / {smem[1]:.1f} KiB (linear / "
                         f"nonlinear class), linear blocks an SM "
                         f"{1 + cu.get('pair', 0)}")
            items += class_times(T2, CS, plan, ker, st, rows, depth, caps)
            cap = f" + {len(ker.captures)} captures" if caps else ""
            print(f"[{label}] {scene} K2 depth {depth}{cap}"
                  f": max abs vs plain {err:.3e}; {ms:.4f} ms/call = "
                  f"{ms / depth:.4f} ms/step; K1's launches x {depth} "
                  f"{k1_ms * depth:.4f} ms ({k1_ms:.4f} ms/step); bound "
                  f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f} % of it"
                  f"{items} ({card})", flush=True)
            del ker
            torch.cuda.empty_cache()
        del sim, plan, st, k1
        torch.cuda.empty_cache()
    print(f"[{label}] ptxas, csrc/fdtd3d_t2.cu:\n{ptxas_report(_build)}",
          flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
