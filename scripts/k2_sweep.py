#!/usr/bin/env python3
"""Time K2 (meep_nl_tpu_torch/ops/fdtd3d_t2.py) over its block depth bx on
one GPU, beside K1, on chip_smoke.py's two scenes.

    python3 scripts/k2_sweep.py [--sizes 128,255] [--bx 2,4,8,16,32]

For each scene (flagship ball with a flux plane at the first size, vacuum
uPML at the others), each depth (2, 3) and each bx: ms per call and per
step by CUDA events, the ring's planes and bytes, the wavefront steps and
phases (grid syncs per call = their product at most), and the agreement
with the plain version over one call.  Prints one line per cell and the
card's name and power limit; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as CS  # noqa: E402


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k2_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    import meep_nl_tpu_torch as mp
    from meep_nl_tpu_torch.ops import fdtd3d_t2
    from meep_nl_tpu_torch.stepper.step import build_xs, xs_rows
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="128,255")
    ap.add_argument("--bx", default="2,4,8,16,32")
    args = ap.parse_args()
    card = CS.card_line()
    CS.build_all()
    lib = fdtd3d_t2._lib()
    print(f"K2's largest co-resident grid: {lib.mnt_k2_max_blocks(0, 0)} "
          f"blocks of 256 threads, {lib.mnt_k2_max_blocks(0, 1)} for "
          f"nonlinear plans",
          flush=True)
    for i, n in enumerate(int(v) for v in args.sizes.split(",")):
        flagship = i == 0
        sim, _ = CS.flagship_sim(mp, n, 16.0, "cuda", flux=flagship,
                                 ball=flagship)
        plan = sim.plan
        plan.slab_opt = True
        caps = CS.flux_planes(plan) if flagship else None
        st = CS.random_state(plan, 5, "cuda", scale=1e-3)
        rows = xs_rows(plan, build_xs(plan, 24, 150))
        k1 = fdtd3d_t2.k1_of(plan)
        ms1, _ = CS.time_steps(k1.step, CS.clone_state(st), rows[:12])
        print(f"{'flagship' if flagship else 'vacuum'} {n}^3: K1 "
              f"{ms1:.4f} ms/step ({card})", flush=True)
        for depth in (2, 3):
            for bx in [None] + [int(v) for v in args.bx.split(",")]:
                ker = fdtd3d_t2.Fdtd3dT2Kernel(plan, depth=depth,
                                               cap_planes=caps, bx=bx)
                ref = fdtd3d_t2.steps_ref(plan, depth, caps)
                a, _ = ker.capture_step(CS.clone_state(st), rows[:depth])
                b, _ = ref(CS.clone_state(st), rows[:depth])
                err, rel = CS.state_error(a, b)
                ms, _ = CS.time_steps(ker.step, CS.clone_state(st), rows,
                                      per=depth)
                cu = ker._cuda
                narr = cu["args"].nload
                ring_mb = (narr * cu["R"] * plan.storage_shape[1]
                           * plan.storage_shape[2] * 4 / 2 ** 20)
                print(f"  depth {depth} bx {cu['bx']:2d}"
                      f"{' (default)' if bx is None else ''}: {ms:.4f} "
                      f"ms/call = {ms / depth:.4f} ms/step; ring "
                      f"{cu['R']} planes = {ring_mb:.1f} MiB; "
                      f"{cu['args'].nwave} wavefront steps x "
                      f"{cu['args'].nphase} phases; rel err {rel:.1e} "
                      f"({card})", flush=True)
                del ker
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
