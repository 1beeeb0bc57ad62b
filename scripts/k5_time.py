#!/usr/bin/env python3
"""Where K5's step time goes on one GPU: the kernel against the wrapper's
host work, at chip_smoke.py's phase 9 shapes.

    python3 scripts/k5_time.py

Scenes (both with use_pallas, from the state after a 9-step warm-up): the
255^3 vacuum uPML cell and the 96^3 linear monitored cell.  For each it
prints ms per step of
  * the two half-step launches alone: CUDA events recorded just around each
    ctypes launch, summed (the device time of K5);
  * the same launches from one prebuilt parameter block per half, launched
    back to back (kernel time when the host never holds the device back);
  * the wrapper's two calls (`HalfStepKernel.__call__`: state checks, the
    ctypes parameter block, the launch), CUDA events around the loop, and
    the host's clock per call without a synchronise (what enqueuing costs);
  * the whole use_pallas step with the source fix-up and the DTFT update
    (`make_step`), CUDA events around the loop;
and ptxas's report on the kernels (csrc/fused.cu with the port's nvcc
flags), and the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def ptxas_report(build) -> str:
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    out = os.path.join(build.BUILD_DIR, "ptxas_report_k5.so")
    res = subprocess.run(
        [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", build.CSRC,
         "-o", out, os.path.join(build.CSRC, "fused.cu")],
        capture_output=True, text=True, check=True)
    os.remove(out)
    keep = ("Compiling entry", "stack frame", "Used")
    return "\n".join(ln.strip() for ln in res.stderr.splitlines()
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


def main() -> int:
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
    print(f"ptxas:\n{ptxas_report(_build)}", flush=True)
    lib = fused._lib()
    for label, n, kw in (("255^3 vacuum", 255, dict(flux=False, ball=False)),
                         ("96^3 linear monitored", 96,
                          dict(linear=True, decimation=5))):
        sim, _ = CS.flagship_sim(mp, n, 16.0, "cuda", use_pallas=True,
                                 use_fused=False, **kw)
        sim.run(until=9 * sim.dt)
        plan, st = sim.plan, CS.clone_state(sim.fields_state)
        ker = fused.kernels_of(plan)
        hb, hd = ker["b"], ker["d"]
        nrep = 20

        def wrapper_step():
            f, fu, fw = hb(st["f"], st["f_u"], st["f_w"])
            hd(f, fu, fw)

        events = []

        class Timed:
            def __getattr__(self, name):
                return getattr(lib, name)

            def mnt_k5_half(self, *args):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                rc = lib.mnt_k5_half(*args)
                ev[1].record()
                events.append(ev)
                return rc

        saved, fused._lib = fused._lib, Timed
        try:
            wrapper_step()
            torch.cuda.synchronize()
            events.clear()
            for _ in range(nrep):
                wrapper_step()
            torch.cuda.synchronize()
            alone = sum(a.elapsed_time(b) for a, b in events) / nrep
        finally:
            fused._lib = saved
        pb, pd = hb._params(st["f"], st["f_u"], st["f_w"]), \
            hd._params(st["f"], st["f_u"], st["f_w"])
        stream = torch.cuda.current_stream().cuda_stream

        def raw_step():
            lib.mnt_k5_half(ctypes.byref(pb), 0, 0, stream)
            lib.mnt_k5_half(ctypes.byref(pd), 1, 0, stream)

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
        print(f"{label} (storage {plan.storage_shape}): K5 launches alone "
              f"{alone:.4f} ms/step; back to back from prebuilt parameter "
              f"blocks {raw:.4f}; the wrapper's two calls {wrap:.4f} "
              f"(host clock {host:.4f} ms per step enqueued); the whole "
              f"use_pallas step with fix-up and DTFT update {whole:.4f}; "
              f"bound {b_ms:.4f} ms ({b_by}) ({card})", flush=True)
        del sim, st
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
