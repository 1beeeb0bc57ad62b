#!/usr/bin/env python3
"""Where K5's step time goes on one GPU, at chip_smoke.py's phase 9 shapes,
for comparing two trees in one call.

    python3 scripts/k5_time.py [--root DIR] [--ch N]
                               [--variants "K5_TY=16,K5_TZ=16;K5_TY=4"]

Imports the port and chip_smoke.py from DIR (default: this checkout), so a
second unpacked tree (the parent commit, say, in a git-ignored directory)
can be timed by the same script; run it for parent, change, change, parent
in one call.  Scenes (both with use_pallas, from the state after a 9-step
warm-up): the 255^3 vacuum uPML cell and the 96^3 linear monitored cell.
For each it prints ms per step of
  * K5's launches alone: CUDA events recorded just around each launch of
    the wrapper's calls, summed (the device time of K5; a tree whose
    source fix-up is a launch of its own counts it here too, and the two
    half-step launches apart);
  * the same launches back to back from argument blocks built beforehand
    (no host work between launches);
  * the wrapper's calls of one step (with the step's sources), CUDA events
    around the loop, and the host's clock per step without a synchronise
    (what enqueuing costs);
  * the whole use_pallas step with the DTFT update (`make_step`), CUDA
    events around the loop;
beside step_cost's bound, with the tree's launch geometry where it has one,
ptxas's report on csrc/fused.cu (the port's nvcc flags), and the card's
name and power limit.  `--ch N` sets the x-planes per chunk of a tree
whose K5 marches along x (default: fdtd3d.chunk_planes); `--variants`
also builds csrc/fused.cu with other compile-time y-z tiles (K5_TY,
K5_TZ; `;` between builds) and times each build's launches
back to back from its own argument blocks, after checking that one step
of it equals the default build's bit for bit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import os
import subprocess
import sys
import time


def ptxas_report(build) -> str:
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    out = os.path.join(build.BUILD_DIR, "ptxas_report_k5.so")
    res = subprocess.run(
        [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", build.CSRC,
         "-o", out, os.path.join(build.CSRC, "fused.cu")],
        capture_output=True, text=True, check=True, timeout=600)
    os.remove(out)
    keep = ("Compiling entry", "stack frame", "Used")
    return "\n".join(ln.strip() for ln in res.stderr.splitlines()
                     if any(k in ln for k in keep))


def build_variant(build, defs):
    """csrc/fused.cu built with the -D macros `defs` (a list); returns
    (library path, ptxas's report)."""
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tag = "_".join(d.replace("=", "") for d in defs)
    out = os.path.join(build.BUILD_DIR, f"libfused_variant_{tag}.so")
    res = subprocess.run(
        [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
         *[f"-D{d}" for d in defs], "-I", build.CSRC, "-o", out,
         os.path.join(build.CSRC, "fused.cu")],
        capture_output=True, text=True, check=True, timeout=600)
    keep = ("Compiling entry", "stack frame", "Used")
    return out, "\n".join(ln.strip() for ln in res.stderr.splitlines()
                          if any(k in ln for k in keep))


def raw_blocks(fused, kers, st, row):
    """Copies of the two halves' argument blocks over state `st` with the
    sources of `row`, built by the kernel objects for the loaded library."""
    blocks = []
    f, fu, fw = st["f"], st["f_u"], st["f_w"]
    for h in kers:
        A, (f, fu, fw) = h.launch_args(f, fu, fw, row)
        B = fused._K5Args()
        ctypes.pointer(B)[0] = A
        blocks.append((h, B))
    return blocks


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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--ch", type=int, default=None)
    ap.add_argument("--variants", default="")
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    import torch
    if not torch.cuda.is_available():
        print("k5_time: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    import meep_nl_tpu_torch as mp
    from meep_nl_tpu_torch.ops import _build
    from meep_nl_tpu_torch.ops import fused
    from meep_nl_tpu_torch.stepper.step import build_xs, make_step, xs_rows

    card = CS.card_line()
    print(f"ptxas [{a.root}]:\n{ptxas_report(_build)}", flush=True)
    lib = fused._lib()
    folded = hasattr(fused.HalfStepKernel, "launch_args")
    variants = [v.split(",") for v in a.variants.split(";") if v] \
        if folded else []
    vlibs = []
    with concurrent.futures.ThreadPoolExecutor(max(1, len(variants))) as ex:
        built = list(ex.map(lambda d: build_variant(_build, d), variants))
    for defs, (path, report) in zip(variants, built):
        print(f"ptxas [{a.root}] {' '.join(defs)}:\n{report}", flush=True)
        vlibs.append((" ".join(defs), fused.bind(ctypes.CDLL(path))))
    launch_names = [n for n in ("mnt_k5_half", "mnt_k5_fixup")
                    if hasattr(lib, n)]
    for label, n, kw in (("255^3 vacuum", 255, dict(flux=False, ball=False)),
                         ("96^3 linear monitored", 96,
                          dict(linear=True, decimation=5))):
        sim, _ = CS.flagship_sim(mp, n, 16.0, "cuda", use_pallas=True,
                                 use_fused=False, **kw)
        sim.run(until=9 * sim.dt)
        plan, st = sim.plan, CS.clone_state(sim.fields_state)
        ker = fused.kernels_of(plan)
        hb, hd = ker["b"], ker["d"]
        if folded:                  # the blocks are built at the first call
            hb._key = hd._key = None
            hb.ch = hd.ch = a.ch
        nrep = 20
        rows = xs_rows(plan, build_xs(plan, 1, sim._t))
        row = rows[0]

        if folded:
            def wrapper_step():
                f, fu, fw = hb(st["f"], st["f_u"], st["f_w"], row)
                hd(f, fu, fw, row)
        else:
            def wrapper_step():
                f, fu, fw = hb(st["f"], st["f_u"], st["f_w"])
                fw_ = fw
                if ker["fix_b"] is not None:
                    f, fw_ = ker["fix_b"](f, fw_, plan.coefs, row)
                f, fu, fw_ = hd(f, fu, fw_)
                if ker["fix_d"] is not None:
                    ker["fix_d"](f, fw_, plan.coefs, row)

        events = []

        class Timed:
            """The library with CUDA events around each launch."""

            def __getattr__(self, name):
                fn = getattr(lib, name)
                if name not in launch_names:
                    return fn

                def timed(*args):
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                    ev[0].record()
                    rc = fn(*args)
                    ev[1].record()
                    events.append((name, ev))
                    return rc
                return timed

        saved, fused._lib = fused._lib, Timed
        try:
            wrapper_step()
            torch.cuda.synchronize()
            events.clear()
            for _ in range(nrep):
                wrapper_step()
            torch.cuda.synchronize()
            alone = sum(e[0].elapsed_time(e[1]) for _, e in events) / nrep
            halves = sum(e[0].elapsed_time(e[1]) for nm, e in events
                         if nm == "mnt_k5_half") / nrep
            per_step = len(events) // nrep
        finally:
            fused._lib = saved
        stream = torch.cuda.current_stream().cuda_stream
        geo = ""
        if folded:
            blocks = raw_blocks(fused, (hb, hd), st, row)
            A = blocks[0][1]
            geo = (f"; tile {lib.mnt_tile}, chunk {A.ch} planes, "
                   f"{A.nch * A.nty * A.ntz} blocks, "
                   f"{lib.mnt_k5_smem(ctypes.byref(A), hb.fp64) / 1024:.1f} "
                   f"KiB dynamic shared memory")

            def raw_step():
                for h, B in blocks:
                    lib.mnt_k5_half(ctypes.byref(B), h.is_d, h.fp64, stream)
        else:
            fp64 = 1 if hb.dtype == torch.float64 else 0
            pb = hb._params(st["f"], st["f_u"], st["f_w"])
            pd = hd._params(st["f"], st["f_u"], st["f_w"])

            def raw_step():
                lib.mnt_k5_half(ctypes.byref(pb), 0, fp64, stream)
                lib.mnt_k5_half(ctypes.byref(pd), 1, fp64, stream)

        raw = events_ms(raw_step, nrep)
        wrap = events_ms(wrapper_step, nrep)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(nrep):
            wrapper_step()
        host = (time.perf_counter() - t0) / nrep * 1e3
        torch.cuda.synchronize()
        rows = xs_rows(plan, build_xs(plan, nrep + 3, sim._t))
        step, it = make_step(plan), iter(rows)
        whole = events_ms(lambda: step(st, next(it)), nrep)
        b_ms, b_by = CS.bound(fused.step_cost(plan))
        print(f"{label} (storage {plan.storage_shape}) [{a.root}"
              f"{f', ch {a.ch}' if a.ch else ''}]: K5 "
              f"launches alone {alone:.4f} ms/step ({per_step} launches a "
              f"step; the two half-step launches {halves:.4f}); back to back from argument blocks built beforehand "
              f"{raw:.4f} (the two halves); the wrapper's calls {wrap:.4f} "
              f"(host clock {host:.4f} ms per step enqueued); the whole "
              f"use_pallas step with the DTFT update {whole:.4f}; bound "
              f"{b_ms:.4f} ms ({b_by}){geo} ({card})", flush=True)
        for name, vlib in vlibs:
            out = []
            for use in (lib, vlib, lib):
                fused._lib = lambda use=use: use
                hb._key = hd._key = None
                s1 = CS.clone_state(st)
                f, fu, fw = hb(s1["f"], s1["f_u"], s1["f_w"], row)
                hd(f, fu, fw, row)
                s2 = CS.clone_state(st)          # alive while timed
                blocks = raw_blocks(fused, (hb, hd), s2, row)

                def raw_v():
                    for h, B in blocks:
                        use.mnt_k5_half(ctypes.byref(B), h.is_d, h.fp64,
                                        stream)
                out.append((s1, events_ms(raw_v, nrep), blocks[0][1]))
            fused._lib = saved
            hb._key = hd._key = None
            same = all(torch.equal(out[1][0][k][c], t)
                       for k in ("f", "f_u", "f_w")
                       for c, t in out[0][0][k].items())
            B = out[1][2]
            print(f"{label} [{a.root}] variant {name}: back to back "
                  f"{out[1][1]:.4f} ms/step (default build before / after "
                  f"{out[0][1]:.4f} / {out[2][1]:.4f}); one step bit for bit "
                  f"with the default build: {same}; tile {vlib.mnt_tile}, "
                  f"chunk {B.ch} planes, {B.nch * B.nty * B.ntz} blocks "
                  f"({card})", flush=True)
            if not same:
                raise AssertionError(f"variant {name} disagrees")
        del sim, st
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
