#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (meep_nl_tpu_torch) on one GPU.

    python3 chip_smoke.py

Every call runs every phase; a failing phase exits non-zero, and no phase
falls back to the CPU or to a plain version:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every kernel source in meep_nl_tpu_torch/csrc with nvcc, all
     sources started together;
  3. K1 against its plain version on the card: the flagship material plan
     (eps=4 ball, Lorentz pole, chi2 Newton-Raphson) at 64^3 with uPML and a
     vacuum uPML plan, 20 steps from a seeded random state, fp32 max
     relative error <= 1e-5 (relative to the field maximum: the curl sums
     and the 3x3 Newton solve round in another order than the plain
     version's elementwise ops);
  4. the main path: Simulation.run of the flagship ball at 128^3 (cell
     8x8x8 at resolution 16) with PML on every face, a Gaussian Ez point
     source and a flux plane, 600 steps, every step through K1 (checked by
     the launch counter); then the same scene at 16^3 on the card against
     the port on the CPU (fluxes and Ez to 1e-4 of their maximum);
  5. vacuum uPML at 255^3 through Simulation.run, 48 steps, every step
     through K1 (checked by the launch counter): K1 and the plain version
     timed with CUDA synchronisation fences.
The last lines: the card line, the kernel table as one JSON object, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
K1_REPLACES = "meep_nl_tpu/ops/pallas/fdtd3d.py:554"


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def build_all():
    """One nvcc per csrc/*.cu source, all started together."""
    from meep_nl_tpu_torch.ops import _build
    names = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                   if f.endswith(".cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        list(ex.map(_build.build, names))
    return names, time.perf_counter() - t0


def flagship_sim(mp, n_cells, res, device, flux=True, ball=True,
                 pml=1.0):
    """The flagship scene: an eps=4 ball (radius a quarter of the cell)
    with a Lorentz pole and full-tensor chi2 (the NR solve), uPML on every
    face, a Gaussian Ez point source off the ball and an x-normal flux
    plane (the JAX package's bench.py material configuration)."""
    L = n_cells / res
    geometry = []
    if ball:
        med = mp.Medium(epsilon=4.0, chi2=0.05, chi2_full_tensor=True,
                        E_susceptibilities=[mp.LorentzianSusceptibility(
                            frequency=2.0, gamma=0.05, sigma=0.2)])
        geometry = [mp.Sphere(radius=L / 4, material=med)]
    sim = mp.Simulation(
        cell_size=mp.Vector3(L, L, L), resolution=res, geometry=geometry,
        sources=[mp.Source(mp.GaussianSource(frequency=1.0, fwidth=0.5),
                           component=mp.Ez,
                           center=mp.Vector3(-0.35 * L, 0.01 * L, 0))],
        boundary_layers=[mp.PML(pml)], eps_averaging=False, device=device)
    fl = None
    if flux:
        fl = sim.add_flux(1.0, 0.4, 3, mp.FluxRegion(
            center=mp.Vector3(0.35 * L, 0, 0),
            size=mp.Vector3(0, 0.4 * L, 0.4 * L)))
    sim.init_sim()
    return sim, fl


def random_state(plan, seed, device, scale=1e-2):
    """A seeded random state (fields masked) in the eager layout."""
    import torch
    from meep_nl_tpu_torch.stepper import step as S
    gen = torch.Generator().manual_seed(seed)
    st = S.init_state(plan)

    def rnd(t):
        return (scale * torch.randn(t.shape, generator=gen,
                                    dtype=t.dtype)).to(device)

    st["f"] = {c: S._apply_mask(plan, plan.coefs, c, rnd(t))
               for c, t in st["f"].items()}
    st["f_u"] = {c: rnd(t) for c, t in st["f_u"].items()}
    st["f_w"] = {c: rnd(t) for c, t in st["f_w"].items()}
    st["pol"] = [{k: {c: rnd(t) for c, t in e[k].items()}
                  for k in ("p", "pp")} for e in st["pol"]]
    return st


def clone_state(st):
    return {"f": {c: t.clone() for c, t in st["f"].items()},
            "f_u": {c: t.clone() for c, t in st["f_u"].items()},
            "f_cond": {}, "f_w": {c: t.clone() for c, t in st["f_w"].items()},
            "pol": [{k: {c: t.clone() for c, t in e[k].items()}
                     for k in ("p", "pp")} for e in st["pol"]],
            "dft": {c: t.clone() for c, t in st["dft"].items()},
            "t": st["t"]}


def state_error(a, b):
    """(max abs error, max abs error / max |b|) over every field array."""
    import torch
    err = 0.0
    scale = 0.0
    for key in ("f", "f_u", "f_w"):
        for c in b[key]:
            err = max(err, float((a[key][c] - b[key][c]).abs().max()))
            scale = max(scale, float(b[key][c].abs().max()))
    for ea, eb in zip(a["pol"], b["pol"]):
        for k in ("p", "pp"):
            for c in eb[k]:
                err = max(err, float((ea[k][c] - eb[k][c]).abs().max()))
    if not all(bool(torch.isfinite(t).all()) for t in b["f"].values()):
        raise AssertionError("non-finite reference fields")
    return err, err / max(scale, 1e-30)


def compare_k1(plan, nsteps, seed, device):
    """K1 against step_ref from one random state; returns (abs, rel,
    K1's launches)."""
    from meep_nl_tpu_torch.ops import fdtd3d
    from meep_nl_tpu_torch.stepper.step import build_xs, xs_rows
    plan.slab_opt = True
    ker = fdtd3d.Fdtd3dKernel(plan)
    ref = fdtd3d.step_ref(plan)
    st0 = random_state(plan, seed, device)
    rows = xs_rows(plan, build_xs(plan, nsteps, 0))
    sk, sr = clone_state(st0), clone_state(st0)
    for i in range(nsteps):
        sk = ker.step(sk, rows[i])
        sr = ref(sr, rows[i])
    return state_error(sk, sr) + (ker.launches,)


def time_steps(fn, state, rows, nwarm=3):
    """ms per call of state = fn(state, row), CUDA-event timed."""
    import torch
    for i in range(nwarm):
        state = fn(state, rows[i])
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for i in range(nwarm, len(rows)):
        state = fn(state, rows[i])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (len(rows) - nwarm), state


def launch_breakdown(ker, state, row, reps=20):
    """ms of each of K1's launches in one step (CUDA events over `reps`
    repeats of the same launch; the state's values stop mattering)."""
    import torch
    from meep_nl_tpu_torch.ops import fdtd3d
    lib = fdtd3d._lib()
    pb, pd = ker._params("b", state), ker._params("d", state)
    parts = {"b_curl+h": lambda: ker._launch(lib, pb, fdtd3d.MODE_BH),
             "d_curl": lambda: ker._launch(lib, pd, fdtd3d.MODE_D),
             "d_sources": lambda: ker._sources(lib, "d", state, row),
             "e_from_d+pol": lambda: ker._launch(lib, pd, fdtd3d.MODE_E)}
    out = {}
    for name, fn in parts.items():
        fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out[name] = round(start.elapsed_time(end) / reps, 4)
    return out


def bound(plan):
    from meep_nl_tpu_torch.ops import fdtd3d
    cost = fdtd3d.step_cost(plan)
    t_bytes = cost["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = cost["ops"] / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import meep_nl_tpu_torch as mp
    from meep_nl_tpu_torch.ops import fdtd3d
    from meep_nl_tpu_torch.ops import hybrid as HY
    from meep_nl_tpu_torch.stepper.step import build_xs, xs_rows

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    k1 = {"name": "fdtd3d_k1", "route": "cuda",
          "source": "meep_nl_tpu_torch/csrc/fdtd3d.cu",
          "replaces": K1_REPLACES, "launches": None, "max_abs_err": None,
          "ms": None, "plain_ms": None, "bound_ms": None, "bound_by": None,
          "library_ms": None}

    names, secs = build_all()
    print(f"[2] built {names} in {secs:.1f} s", flush=True)

    for label, ball in (("flagship", True), ("vacuum", False)):
        sim, _ = flagship_sim(mp, 64, 8.0, dev, flux=False, ball=ball)
        err, rel, launches = compare_k1(sim.plan, 20, 7, dev)
        print(f"[3] K1 vs plain, {label} 64^3 x 20 steps: max abs "
              f"{err:.3e}, max rel {rel:.3e}, launches {launches}",
              flush=True)
        if not rel <= 1e-5:
            raise AssertionError(f"K1 disagrees with its plain version "
                                 f"({label}): rel {rel:.3e} > 1e-5")

    res, n = 16.0, 128
    sim, fl = flagship_sim(mp, n, res, dev)
    plan = sim.plan
    nsteps = 600
    ker = HY._get_kernel(plan)
    torch.cuda.synchronize()
    sim.routes.clear()
    ker.launches = 0
    t0 = time.perf_counter()
    sim.run(until=nsteps * sim.dt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ker.launches
    if dict(sim.routes) != {"hybrid": 1} \
            or launches != nsteps * ker.launches_per_step:
        raise AssertionError(
            f"main path left K1: routes {dict(sim.routes)}, launches "
            f"{launches} != {nsteps} x {ker.launches_per_step}")
    ez = sim.get_array(mp.Ez)
    flux = sim.get_fluxes(fl)
    import numpy as np
    if not (np.all(np.isfinite(ez)) and np.all(np.isfinite(flux))
            and np.any(flux != 0)):
        raise AssertionError(f"main path output not finite/non-zero: "
                             f"flux {flux}")
    cells = n ** 3
    print(f"[4] main path 128^3 flagship: {nsteps} steps in {wall:.3f} s "
          f"= {nsteps / wall:.1f} steps/s, "
          f"{cells * nsteps / wall / 1e9:.3f} GCells/s ({card}); "
          f"launches {launches} = {nsteps} x {ker.launches_per_step}; "
          f"flux {flux.tolist()}", flush=True)
    k1["launches"] = launches
    # the kernel against its plain version at the main path's shapes,
    # from the main path's end state (these launches are not counted)
    rows = xs_rows(plan, build_xs(plan, 13, sim._t))
    st = sim.fields_state
    sk, sr = clone_state(st), clone_state(st)
    ref = fdtd3d.step_ref(plan)
    for i in range(5):
        sk = ker.step(sk, rows[i])
        sr = ref(sr, rows[i])
    err, rel = state_error(sk, sr)
    print(f"[4] K1 vs plain at 128^3 from the main path state, 5 "
          f"steps: max abs {err:.3e}, max rel {rel:.3e}", flush=True)
    if not rel <= 1e-5:
        raise AssertionError(f"K1 disagrees at 128^3: rel {rel:.3e}")
    k1["max_abs_err"] = err
    k1["ms"], _ = time_steps(ker.step, clone_state(st), rows)
    k1["plain_ms"], _ = time_steps(ref, clone_state(st), rows)
    k1["bound_ms"], k1["bound_by"] = bound(plan)
    print(f"[4] K1 {k1['ms']:.4f} ms/step, plain {k1['plain_ms']:.4f} "
          f"ms/step, bound {k1['bound_ms']:.4f} ms ({k1['bound_by']}) "
          f"at 128^3 flagship ({card})", flush=True)
    print(f"[4] K1 launches at 128^3 flagship, ms each: "
          f"{launch_breakdown(ker, clone_state(st), rows[0])}; "
          f"main path wall per step {wall / nsteps * 1e3:.4f} ms "
          f"({card})", flush=True)

    # the same scene, small, on the card and on the CPU
    out = {}
    for d in ("cuda", "cpu"):
        s2, f2 = flagship_sim(mp, 16, 8.0, d, pml=0.25)
        s2.run(until=200 * s2.dt)
        out[d] = (s2.get_fluxes(f2), s2.get_array(mp.Ez))
    for i, what in enumerate(("flux", "ez")):
        a, b = out["cuda"][i], out["cpu"][i]
        rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        print(f"[4] 16^3 scene, card vs CPU {what}: max rel {rel:.3e}",
              flush=True)
        if not rel <= 1e-4:
            raise AssertionError(f"16^3 scene: card and CPU {what} "
                                 f"differ by {rel:.3e}")

    res, n = 16.0, 255
    sim, _ = flagship_sim(mp, n, res, dev, flux=False, ball=False)
    plan = sim.plan
    sim.run(until=8 * sim.dt)                       # warm-up + build
    nsteps = 48
    ker = HY._get_kernel(plan)
    torch.cuda.synchronize()
    sim.routes.clear()
    ker.launches = 0
    t0 = time.perf_counter()
    sim.run(until=nsteps * sim.dt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ker.launches
    if dict(sim.routes) != {"hybrid": 1} \
            or launches != nsteps * ker.launches_per_step:
        raise AssertionError(
            f"255^3 run left K1: routes {dict(sim.routes)}, launches "
            f"{launches} != {nsteps} x {ker.launches_per_step}")
    rows = xs_rows(plan, build_xs(plan, 11, sim._t))
    k_ms, _ = time_steps(ker.step, clone_state(sim.fields_state), rows)
    p_ms, _ = time_steps(fdtd3d.step_ref(plan),
                         clone_state(sim.fields_state), rows)
    b_ms, b_by = bound(plan)
    cells = n ** 3
    print(f"[5] vacuum uPML 255^3 Simulation.run: {nsteps} steps "
          f"({launches} K1 launches) {wall / nsteps * 1e3:.4f} ms/step = "
          f"{cells * nsteps / wall / 1e9:.3f} GCells/s; K1 "
          f"{k_ms:.4f} ms/step = {cells / k_ms / 1e6:.3f} GCells/s; "
          f"plain {p_ms:.4f} ms/step = {cells / p_ms / 1e6:.3f} "
          f"GCells/s; bound {b_ms:.4f} ms ({b_by}) ({card})",
          flush=True)

    print(card)
    print(json.dumps({"kernels": [k1]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
