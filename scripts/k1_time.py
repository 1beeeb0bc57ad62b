#!/usr/bin/env python3
"""K1 (meep_nl_tpu_torch/ops/fdtd3d.py, csrc/fdtd3d.cu) on one GPU: its
agreement with the plain version, its time per step and per launch beside
each launch's byte floor, over the x-planes per chunk and the y-z tile, at
the plans K1 runs in chip_smoke.py.

    python3 scripts/k1_time.py [--tree DIR] [--ch 6,11,17,34]
                               [--variants "K1_TY=4,K1_TZ=32;..."]

--tree imports meep_nl_tpu_torch and chip_smoke from DIR (an unpacked
commit), so that two trees are compared in one call by running the script
once per tree, in turns.  Scenes, each from a seeded random state at step
150 (the source near its peak): the 128^3 flagship with slab-local chains
(the main path's K1 steps), the same without its flux plane and with
full-grid chains (plan.slab_opt False: the fused probed route's plan, phase
10), and 255^3 vacuum uPML.  For each it prints
  * the largest |K1 - step_ref| over 3 steps (0.0: bit for bit);
  * K1's ms/step through the wrapper (host work included), CUDA events
    over 20 steps, the host's share alone, and the plain version's;
  * the step's launches alone, with no host work between them: those of
    one wrapper step recorded and replayed (CUDA events over 20 repeats),
    for the tree's K1 whatever its launches;
  * with the tree's own K1 (a tree that has `launch_args`): each launch
    alone from prebuilt argument blocks beside its byte floor
    (`launch_cost` at 3.35 TB/s), for each `--ch` and for each
    `--variants` build of csrc/fdtd3d.cu (compile-time macros: K1_TY,
    K1_TZ the y-z tile), built beside the default one;
  * ptxas's report on csrc/fdtd3d.cu (registers, shared memory, spills);
and the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_variant(build, defs, ptxas=False):
    """csrc/fdtd3d.cu built with the -D macros `defs` (a list); returns
    (library path, ptxas's report when asked)."""
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tag = "_".join(d.replace("=", "") for d in defs) or "default"
    out = os.path.join(build.BUILD_DIR, f"libfdtd3d_variant_{tag}.so")
    res = subprocess.run(
        [build.nvcc(), *build.NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas
                                              else []),
         *[f"-D{d}" for d in defs], "-I", build.CSRC, "-o", out,
         os.path.join(build.CSRC, "fdtd3d.cu")],
        capture_output=True, text=True, check=True)
    keep = ("Compiling entry", "stack frame", "Used")
    return out, "\n".join(ln.strip() for ln in res.stderr.splitlines()
                          if any(k in ln for k in keep))


def events_ms(fn, n, nwarm=3):
    """ms per call of fn(), CUDA events around n calls after nwarm."""
    import torch
    for _ in range(nwarm):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def host_ms(ker, st, rows):
    """ms per step the host spends in the wrapper's step (enqueue), by the
    host's clock over the rows without a synchronise, after a warm-up
    (the device may lag behind; the caller synchronises after)."""
    import time
    import torch
    st = ker.step(st, rows[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for row in rows[1:]:
        st = ker.step(st, row)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / (len(rows) - 1)


def replay_ms(F, ker, st, row, n=20):
    """ms per step of the CUDA launches of one wrapper step on `st`,
    recorded through a stand-in for the kernel library and replayed back
    to back (the device's time without the wrapper's host work, for any
    version of the wrapper), and [(launch, ms)] of each replayed alone
    (`half(mode)` / `launch(kind)` by the library's mode or kind
    argument)."""
    lib = F._lib()
    calls = []

    class Recorder:
        def __getattr__(self, name):
            f = getattr(lib, name)
            if not (name.startswith("mnt_") and callable(f)):
                return f

            def call(*a):
                calls.append((f, a))
                return f(*a)
            return call

    load = F._lib
    F._lib = lambda: Recorder()
    try:
        ker.step(st, row)
    finally:
        F._lib = load
    launches = [(f, a) for f, a in calls if "launch" in f.__name__
                or "half" in f.__name__ or "source" in f.__name__]

    def step():
        for f, a in launches:
            f(*a)
    alone = []
    for f, a in launches:
        what = "source" if "source" in f.__name__ else \
            f"{f.__name__[len('mnt_k1_'):]}({a[1]})"
        alone.append((what, events_ms(lambda: f(*a), n)))
    return events_ms(step, n), alone


def per_launch(F, ker, st, row, hbm):
    """{launch: (ms, floor ms)} of each launch alone and 'all' back to
    back, from argument blocks built once."""
    lib = F._lib()
    args = ker.launch_args(st, row)
    floors = F.launch_cost(ker.plan)
    out = {}
    for name, kind, A in args:
        fl = floors[name[0]] / hbm * 1e3
        out[name] = (events_ms(lambda: ker._launch(lib, A, kind), 20), fl)

    def all_():
        for _, kind, A in args:
            ker._launch(lib, A, kind)
    out["all"] = (events_ms(all_, 20), sum(floors.values()) / hbm * 1e3)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--ch", default="")
    ap.add_argument("--variants", default="")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("k1_time: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    import meep_nl_tpu_torch as mp
    from meep_nl_tpu_torch.ops import _build
    from meep_nl_tpu_torch.ops import fdtd3d as F
    from meep_nl_tpu_torch.stepper.step import build_xs, xs_rows
    card = CS.card_line()
    label = os.path.relpath(tree, ROOT)
    new = hasattr(F.Fdtd3dKernel, "launch_args")
    variants = [[]] + ([v.split(",") for v in args.variants.split(";") if v]
                       if new else [])
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as ex:
        built = list(ex.map(lambda d: build_variant(_build, d, True),
                            variants))
    libs = []
    for defs, (path, report) in zip(variants, built):
        name = " ".join(defs) or "(default)"
        print(f"[{label}] ptxas, csrc/fdtd3d.cu {name}:\n{report}",
              flush=True)
        if new:
            libs.append((" ".join(defs) or "default",
                         F.bind(ctypes.CDLL(path))))
    if not new:
        _build.build("fdtd3d")
        libs = [("default", None)]
    scenes = (("flagship 128^3, slab chains", 128, True, True),
              ("flagship 128^3, full-grid chains (probed route)", 128, False,
               False),
              ("vacuum 255^3", 255, False, True))
    for scene, n, flux, slab in scenes:
        flagship = n == 128
        sim, _ = CS.flagship_sim(mp, n, 16.0, "cuda", flux=flux,
                                 ball=flagship)
        plan = sim.plan
        plan.slab_opt = slab
        st = CS.random_state(plan, 5, "cuda")
        rows = xs_rows(plan, build_xs(plan, 23, 150))
        ref = F.step_ref(plan)
        chs = [None] + [int(v) for v in args.ch.split(",") if v]
        cells = [(vn, lib, ch) for vn, lib in libs
                 for ch in (chs if new else [None])]
        for vn, lib, ch in cells:
            if lib is not None:
                F._lib = lambda lib=lib: lib
            ker = F.Fdtd3dKernel(plan, ch=ch) if new \
                else F.Fdtd3dKernel(plan)
            a, b = CS.clone_state(st), CS.clone_state(st)
            for row in rows[:3]:
                a = ker.step(a, row)
                b = ref(b, row)
            err, _ = CS.state_error(a, b)
            del a, b
            ms, _ = CS.time_steps(ker.step, CS.clone_state(st), rows)
            host = host_ms(ker, CS.clone_state(st), rows)
            dev, alone = replay_ms(F, ker, CS.clone_state(st), rows[0])
            nl = len(alone)
            what = (f"{vn}, ch {ker.ch}{' (default)' if ch is None else ''}, "
                    if new else "")
            line = (f"[{label}] {scene} K1 {what}{nl} launches/step: max abs "
                    f"vs plain {err:.3e}; {ms:.4f} ms/step (the wrapper's "
                    f"host work alone {host:.4f} ms/step); the step's "
                    f"launches replayed {dev:.4f} ms/step, alone "
                    + ", ".join(f"{w} {t:.4f}" for w, t in alone))
            if new:
                parts = per_launch(F, ker, CS.clone_state(st), rows[0],
                                   CS.HBM_BYTES_PER_S)
                line += "; alone (ms, floor ms, % of floor): " + ", ".join(
                    f"{k} {v:.4f}/{f:.4f}/{100 * f / v:.0f}%"
                    for k, (v, f) in parts.items())
            print(line + f" ({card})", flush=True)
            del ker
        p_ms, _ = CS.time_steps(ref, CS.clone_state(st), rows[:11])
        b_ms, b_by = CS.bound(F.step_cost(plan))
        print(f"[{label}] {scene}: plain {p_ms:.4f} ms/step, bound "
              f"{b_ms:.4f} ms ({b_by}) ({card})", flush=True)
        del sim, plan, st
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
