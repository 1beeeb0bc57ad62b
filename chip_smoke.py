#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (meep_nl_tpu_torch) on one GPU.

    python3 chip_smoke.py

Every call runs every phase; a failing phase exits non-zero, and no phase
falls back to the CPU or to a plain version:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every kernel source in meep_nl_tpu_torch/csrc with nvcc, all
     sources started together;
  3. the kernels against their plain versions on the card, from a seeded
     random state at 64^3, on the flagship material plan (eps=4 ball,
     Lorentz pole, chi2 Newton-Raphson) and a vacuum uPML plan: K1 over 20
     steps; K2 at depth 2 and depth 3 with capture planes on the flux
     plane's x-planes over 6 calls, state and every captured plane.  fp32
     max error <= 1e-5 of the field maximum (the kernels are built without
     FMA contraction and in the plain version's operation order, so in
     practice they agree bit for bit);
  4. the main path: Simulation.run of the flagship ball at 128^3 (cell
     8x8x8 at resolution 16) with PML on every face, a Gaussian Ez point
     source and a flux plane, 602 steps.  Every step samples the DTFT, so
     the hybrid driver takes its capture route: 200 calls of K2's capture
     variant at depth 3 and a tail of 2 K1 steps, checked by the launch
     counters; nothing runs a plain version.  Then K1 and K2 against their
     plain versions from the main path's end state, their times, and the
     same scene forced through the K1-only route; then the same scene at
     16^3 on the card against the port on the CPU (fluxes and Ez to 1e-4
     of their maximum);
  5. a linear monitored scene (the ball without chi2 and pole) at 96^3, DTFT
     decimation 5: every cycle is one depth-3 and one depth-2 K2 call,
     checked by the counters, and its fluxes equal the K1-only route's to
     1e-4; K2 at depth 2 and 3 (this plan's variant without the nonlinear
     branches, no capture planes) and K1 against their plain versions from
     that run's end state;
  6. vacuum uPML at 255^3 through Simulation.run, 50 steps without a
     monitor: the fully fused route, 16 depth-3 K2 calls and 2 K1 steps
     (counters); K2 and K1 against their plain versions from that run's end
     state; K1, K2 and the plain version timed with CUDA events.
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
K2_REPLACES = "meep_nl_tpu/ops/pallas/fdtd3d_t2.py:182"


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
                 pml=1.0, linear=False, decimation=0):
    """The flagship scene: an eps=4 ball (radius a quarter of the cell)
    with a Lorentz pole and full-tensor chi2 (the NR solve), uPML on every
    face, a Gaussian Ez point source off the ball and an x-normal flux
    plane (the JAX package's bench.py material configuration).  `linear`
    keeps the eps=4 ball and drops its pole and chi2; `decimation` is the
    flux monitor's DTFT decimation factor (0: automatic)."""
    L = n_cells / res
    geometry = []
    if ball:
        med = mp.Medium(epsilon=4.0) if linear else mp.Medium(
            epsilon=4.0, chi2=0.05, chi2_full_tensor=True,
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
            size=mp.Vector3(0, 0.4 * L, 0.4 * L)),
            decimation_factor=decimation)
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


def compare_k1_from(plan, ker, st0, t0, nsteps=5):
    """K1 (the kernel object `ker` of a driven path) against step_ref over
    `nsteps` steps from state st0 at step t0; returns (abs, rel)."""
    from meep_nl_tpu_torch.ops import fdtd3d
    from meep_nl_tpu_torch.stepper.step import build_xs, xs_rows
    ref = fdtd3d.step_ref(plan)
    rows = xs_rows(plan, build_xs(plan, nsteps, t0))
    sk, sr = clone_state(st0), clone_state(st0)
    for i in range(nsteps):
        sk = ker.step(sk, rows[i])
        sr = ref(sr, rows[i])
    return state_error(sk, sr)


def flux_planes(plan):
    """[(comp, x)] of the x-planes the plan's flux monitors read."""
    from meep_nl_tpu_torch.ops import hybrid
    meta = hybrid._dft_plane_meta(plan)
    if meta is None:
        raise AssertionError("the scene's monitors have no plane form")
    return sorted({(m[0], x) for m in meta for x in range(m[1], m[2])})


def compare_k2(plan, depth, ncall, st0, t0, cap_planes):
    """K2 (depth steps per call, with the capture planes `cap_planes`, or
    None for the variant without) against steps_ref from state st0;
    returns (abs, rel, the captures' max abs error, K2's launches, the
    kernel)."""
    from meep_nl_tpu_torch.ops import fdtd3d_t2
    from meep_nl_tpu_torch.stepper.step import build_xs, xs_rows
    plan.slab_opt = True
    ker = fdtd3d_t2.Fdtd3dT2Kernel(plan, depth=depth, cap_planes=cap_planes)
    ref = fdtd3d_t2.steps_ref(plan, depth, cap_planes)
    rows = xs_rows(plan, build_xs(plan, ncall * depth, t0))
    sk, sr = clone_state(st0), clone_state(st0)
    cap_err = 0.0
    for c in range(ncall):
        xc = rows[c * depth:(c + 1) * depth]
        sk, ck = ker.capture_step(sk, xc)
        sr, cr = ref(sr, xc)
        if set(ck) != set(cr) or bool(cr) != bool(cap_planes):
            raise AssertionError(f"K2 captures {sorted(ck)} != {sorted(cr)}")
        cap_err = max([cap_err] + [float((ck[k] - cr[k]).abs().max())
                                   for k in cr])
    err, rel = state_error(sk, sr)
    return err, rel, cap_err, ker.launches, ker


def time_steps(fn, state, rows, per=1, nwarm=3):
    """ms per call of state = fn(state, row) (per == 1) or
    fn(state, rows of one call) (per > 1), CUDA-event timed."""
    import torch

    def call(state, c):
        return fn(state, rows[c] if per == 1 else rows[c * per:(c + 1) * per])

    ncall = len(rows) // per
    for c in range(nwarm):
        state = call(state, c)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for c in range(nwarm, ncall):
        state = call(state, c)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (ncall - nwarm), state


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


def bound(cost):
    """(ms, what bounds it) of a step_cost dict on the H100's peaks."""
    t_bytes = cost["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = cost["ops"] / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def path_kernels(plan):
    """{label: kernel object} of every kernel object the hybrid driver has
    made for this plan so far (their counters say which route ran)."""
    ker = plan._t2_kernel
    out = {"k1": ker._k1}
    if hasattr(ker, "launches"):
        out["k2_d2"] = ker
    if ker.k3 is not None:
        out["k2_d3"] = ker.k3
    for (depth, _), capker in plan.__dict__.get("_cap_kernels", {}).items():
        out[f"k2_cap_d{depth}"] = capker
    return out


def timed_run(sim, nsteps):
    """sim.run for nsteps with every kernel counter of the plan set to 0
    just before; returns (wall seconds, {label: launches}) read just
    after, and fails if a stretch left the hybrid route or a plain version
    ran."""
    import torch
    kers = path_kernels(sim.plan)
    for k in kers.values():
        k.launches = k.plain_steps = 0
    sim.routes.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(until=nsteps * sim.dt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kers = path_kernels(sim.plan)
    if dict(sim.routes) != {"hybrid": 1}:
        raise AssertionError(f"run left the hybrid route: "
                             f"{dict(sim.routes)}")
    plain = {n: k.plain_steps for n, k in kers.items()}
    if any(plain.values()):
        raise AssertionError(f"a plain version ran on the card: {plain}")
    return wall, {n: k.launches for n, k in kers.items()}


def expect(launches, want, what):
    want = {k: v for k, v in want.items() if v or k in launches}
    got = {k: v for k, v in launches.items() if v or k in want}
    if got != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")


def force_k1_route(sim):
    """Make the hybrid driver take its K1-only route for this plan (the
    route of a plan that K2 declines)."""
    from meep_nl_tpu_torch.ops import fdtd3d_t2
    from meep_nl_tpu_torch.ops import hybrid
    sim.plan._t2_kernel = hybrid._K1Adapter(fdtd3d_t2.k1_of(sim.plan))


def rel_diff(a, b):
    import numpy as np
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import numpy as np
    import meep_nl_tpu_torch as mp
    from meep_nl_tpu_torch.ops import fdtd3d, fdtd3d_t2
    from meep_nl_tpu_torch.ops import hybrid as HY
    from meep_nl_tpu_torch.stepper.step import build_xs, xs_rows

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    blank = {"launches": None, "max_abs_err": None, "ms": None,
             "plain_ms": None, "bound_ms": None, "bound_by": None,
             "library_ms": None}
    k1 = {"name": "fdtd3d_k1", "route": "cuda",
          "source": "meep_nl_tpu_torch/csrc/fdtd3d.cu",
          "replaces": K1_REPLACES, **blank}
    k2 = {"name": "fdtd3d_t2_k2", "route": "cuda",
          "source": "meep_nl_tpu_torch/csrc/fdtd3d_t2.cu",
          "replaces": K2_REPLACES, **blank}

    names, secs = build_all()
    grids = {f"{'fp64' if f else 'fp32'}{' nonlinear' if nl else ''}":
             fdtd3d_t2._lib().mnt_k2_max_blocks(f, nl)
             for f in (0, 1) for nl in (0, 1)}
    print(f"[2] built {names} in {secs:.1f} s; K2's largest co-resident "
          f"grids (blocks of 256 threads): {grids}", flush=True)

    # ---- 3: the kernels against their plain versions at 64^3 -------------
    for label, ball in (("flagship", True), ("vacuum", False)):
        sim, _ = flagship_sim(mp, 64, 8.0, dev, ball=ball)
        plan = sim.plan
        err, rel, launches = compare_k1(plan, 20, 7, dev)
        print(f"[3] K1 vs plain, {label} 64^3 x 20 steps: max abs "
              f"{err:.3e}, max rel {rel:.3e}, launches {launches}",
              flush=True)
        if not rel <= 1e-5:
            raise AssertionError(f"K1 disagrees with its plain version "
                                 f"({label}): rel {rel:.3e} > 1e-5")
        caps = flux_planes(plan)
        for depth in (2, 3):
            # t0 near the source's peak, so the source rows matter
            err, rel, cerr, launches, ker = compare_k2(
                plan, depth, 6, random_state(plan, 7, dev), 150, caps)
            print(f"[3] K2 depth {depth} vs plain, {label} 64^3 x 6 calls, "
                  f"{len(ker.captures)} capture planes: state max abs "
                  f"{err:.3e}, max rel {rel:.3e}; captures max abs "
                  f"{cerr:.3e}; launches {launches}; bx "
                  f"{ker._cuda['bx']}, ring {ker._cuda['R']} planes",
                  flush=True)
            scale = err / max(rel, 1e-30) if rel else 1.0
            if not (rel <= 1e-5 and cerr <= 1e-5 * scale and launches == 6):
                raise AssertionError(
                    f"K2 depth {depth} disagrees with its plain version "
                    f"({label}): rel {rel:.3e}, captures {cerr:.3e}")

    # ---- 4: the main path, flagship 128^3 -------------------------------
    res, n = 16.0, 128
    cells = n ** 3
    sim, fl = flagship_sim(mp, n, res, dev)
    plan = sim.plan
    sim.run(until=12 * sim.dt)                      # warm-up: ring, tables
    nsteps = 602
    wall, launches = timed_run(sim, nsteps)
    kers = path_kernels(plan)
    depth = kers["k2_cap_d3"].depth
    ncall, tail = nsteps // depth, nsteps % depth
    expect(launches, {"k2_cap_d3": ncall, "k1": tail * 4, "k2_d2": 0,
                      "k2_d3": 0}, "128^3 flagship main path")
    ez = sim.get_array(mp.Ez)
    flux = sim.get_fluxes(fl)
    if not (np.all(np.isfinite(ez)) and np.all(np.isfinite(flux))
            and np.any(flux != 0)):
        raise AssertionError(f"main path output not finite/non-zero: "
                             f"flux {flux}")
    print(f"[4] main path 128^3 flagship: {nsteps} steps in {wall:.3f} s "
          f"= {wall / nsteps * 1e3:.4f} ms/step, "
          f"{cells * nsteps / wall / 1e9:.3f} GCells/s ({card}); capture "
          f"route: {ncall} K2 depth-{depth} capture calls + {tail} K1 "
          f"steps, launches {launches}; flux {flux.tolist()}", flush=True)
    k1["launches"] = launches["k1"]
    k2["launches"] = launches["k2_cap_d3"]
    # the kernels against their plain versions at the main path's shapes,
    # from the main path's end state (these launches are not counted)
    st = sim.fields_state
    t_end = sim._t
    ker1 = kers["k1"]
    rows = xs_rows(plan, build_xs(plan, 13, t_end))
    ref = fdtd3d.step_ref(plan)
    err, rel = compare_k1_from(plan, ker1, st, t_end)
    print(f"[4] K1 vs plain at 128^3 from the main path state, 5 "
          f"steps: max abs {err:.3e}, max rel {rel:.3e}", flush=True)
    if not rel <= 1e-5:
        raise AssertionError(f"K1 disagrees at 128^3: rel {rel:.3e}")
    k1["max_abs_err"] = err
    caps = flux_planes(plan)
    k2["max_abs_err"] = 0.0
    for d in (2, 3):
        err, rel, cerr, _, _ = compare_k2(plan, d, 2, st, t_end, caps)
        print(f"[4] K2 depth {d} vs plain at 128^3 from the main path "
              f"state, 2 calls: state max abs {err:.3e}, max rel "
              f"{rel:.3e}; captures max abs {cerr:.3e}", flush=True)
        scale = err / max(rel, 1e-30) if rel else 1.0
        if not (rel <= 1e-5 and cerr <= 1e-5 * scale):
            raise AssertionError(f"K2 depth {d} disagrees at 128^3: rel "
                                 f"{rel:.3e}, captures {cerr:.3e}")
        k2["max_abs_err"] = max(k2["max_abs_err"], err, cerr)
    k1["ms"], _ = time_steps(ker1.step, clone_state(st), rows)
    k1["plain_ms"], _ = time_steps(ref, clone_state(st), rows)
    k1["bound_ms"], k1["bound_by"] = bound(fdtd3d.step_cost(plan))
    print(f"[4] K1 {k1['ms']:.4f} ms/step, plain {k1['plain_ms']:.4f} "
          f"ms/step, bound {k1['bound_ms']:.4f} ms ({k1['bound_by']}) "
          f"at 128^3 flagship ({card})", flush=True)
    print(f"[4] K1 launches at 128^3 flagship, ms each: "
          f"{launch_breakdown(ker1, clone_state(st), rows[0])} ({card})",
          flush=True)
    rows = xs_rows(plan, build_xs(plan, 36, t_end))
    capker = kers["k2_cap_d3"]
    for label, ker in (("depth 3 + captures", capker),
                       ("depth 2", kers["k2_d2"])):
        d = ker.depth
        ms, _ = time_steps(ker.step, clone_state(st), rows, per=d)
        b_ms, b_by = bound(fdtd3d_t2.step_cost(plan, d, len(ker.captures)))
        print(f"[4] K2 {label}: {ms:.4f} ms/call = {ms / d:.4f} ms/step; "
              f"bound {b_ms:.4f} ms/call ({b_by}); bx {ker._cuda['bx']}, "
              f"ring {ker._cuda['R']} planes, {ker._cuda['args'].nwave} "
              f"wavefront steps x {ker._cuda['args'].nphase} phases, "
              f"{ker._cuda['blocks']} blocks wanted at 128^3 flagship "
              f"({card})", flush=True)
        if ker is capker:
            k2["ms"], k2["bound_ms"], k2["bound_by"] = ms, b_ms, b_by
    plain = fdtd3d_t2.steps_ref(plan, 3, capker.cap_planes)
    k2["plain_ms"], _ = time_steps(lambda s_, r_: plain(s_, r_)[0],
                                   clone_state(st), rows, per=3)
    print(f"[4] K2 depth 3 plain version: {k2['plain_ms']:.4f} ms/call "
          f"({card})", flush=True)
    # the same scene through the K1-only route
    sim1, fl1 = flagship_sim(mp, n, res, dev)
    force_k1_route(sim1)
    sim1.run(until=12 * sim1.dt)
    wall1, launches1 = timed_run(sim1, nsteps)
    expect(launches1, {"k1": nsteps * 4}, "128^3 flagship K1 route")
    fdiff = rel_diff(sim1.get_fluxes(fl1), flux)
    print(f"[4] the same run through the K1-only route: "
          f"{wall1 / nsteps * 1e3:.4f} ms/step, "
          f"{cells * nsteps / wall1 / 1e9:.3f} GCells/s, launches "
          f"{launches1}; fluxes differ from the K2 route by {fdiff:.3e} "
          f"({card})", flush=True)
    if not fdiff <= 1e-4:
        raise AssertionError(f"K2 and K1 routes' fluxes differ: {fdiff:.3e}")
    del sim, sim1, st

    # the same scene, small, on the card and on the CPU
    out = {}
    for d in ("cuda", "cpu"):
        s2, f2 = flagship_sim(mp, 16, 8.0, d, pml=0.25)
        s2.run(until=200 * s2.dt)
        out[d] = (s2.get_fluxes(f2), s2.get_array(mp.Ez))
    for i, what in enumerate(("flux", "ez")):
        rel = rel_diff(out["cuda"][i], out["cpu"][i])
        print(f"[4] 16^3 scene, card vs CPU {what}: max rel {rel:.3e}",
              flush=True)
        if not rel <= 1e-4:
            raise AssertionError(f"16^3 scene: card and CPU {what} "
                                 f"differ by {rel:.3e}")

    # ---- 5: a linear monitored scene, the 3/2/1-step cycle mix ----------
    n, nsteps, dec = 96, 300, 5
    fluxes = {}
    for route in ("k2", "k1"):
        sim, fl = flagship_sim(mp, n, res, dev, linear=True, decimation=dec)
        if route == "k1":
            force_k1_route(sim)
        sim.run(until=10 * sim.dt)                  # warm-up, whole cycles
        wall, launches = timed_run(sim, nsteps)
        ncyc = nsteps // dec
        n3, npair, rem = HY.decompose(dec, route == "k2")
        if route == "k2":
            expect(launches, {"k2_d3": ncyc * n3, "k2_d2": ncyc * npair,
                              "k1": ncyc * rem * 4}, "96^3 linear K2 route")
        else:
            expect(launches, {"k1": nsteps * 4}, "96^3 linear K1 route")
        fluxes[route] = sim.get_fluxes(fl)
        if route == "k2":
            # the kernels of this path against their plain versions at its
            # shapes, from its end state (these launches are not counted)
            plan, st, t_end = sim.plan, sim.fields_state, sim._t
            for d in (3, 2):
                err, rel, _, _, _ = compare_k2(plan, d, 2, st, t_end, None)
                print(f"[5] K2 depth {d} vs plain at {n}^3 linear from the "
                      f"run's state, 2 calls: max abs {err:.3e}, max rel "
                      f"{rel:.3e}", flush=True)
                if not rel <= 1e-5:
                    raise AssertionError(f"K2 depth {d} disagrees at {n}^3 "
                                         f"linear: rel {rel:.3e}")
                k2["max_abs_err"] = max(k2["max_abs_err"], err)
            err, rel = compare_k1_from(plan, path_kernels(plan)["k1"], st,
                                       t_end)
            print(f"[5] K1 vs plain at {n}^3 linear from the run's state, 5 "
                  f"steps: max abs {err:.3e}, max rel {rel:.3e}", flush=True)
            if not rel <= 1e-5:
                raise AssertionError(f"K1 disagrees at {n}^3 linear: rel "
                                     f"{rel:.3e}")
            k1["max_abs_err"] = max(k1["max_abs_err"], err)
            del st
        print(f"[5] linear monitored {n}^3, decimation {dec}, {nsteps} "
              f"steps, {route} route ({n3} x 3 + {npair} x 2 + {rem} x 1 "
              f"per cycle): {wall / nsteps * 1e3:.4f} ms/step, launches "
              f"{launches}; flux {fluxes[route].tolist()} ({card})",
              flush=True)
    fdiff = rel_diff(fluxes["k2"], fluxes["k1"])
    print(f"[5] fluxes, K2 route vs K1 route: max rel {fdiff:.3e}",
          flush=True)
    if not (fdiff <= 1e-4 and np.any(fluxes["k2"] != 0)):
        raise AssertionError(f"linear scene: routes differ by {fdiff:.3e}")
    del sim

    # ---- 6: vacuum uPML 255^3, the fully fused route --------------------
    n = 255
    cells = n ** 3
    sim, _ = flagship_sim(mp, n, res, dev, flux=False, ball=False)
    plan = sim.plan
    sim.run(until=9 * sim.dt)                       # warm-up
    nsteps = 50
    wall, launches = timed_run(sim, nsteps)
    expect(launches, {"k2_d3": nsteps // 3, "k1": (nsteps % 3) * 4,
                      "k2_d2": 0}, "255^3 vacuum fused route")
    kers = path_kernels(plan)
    st = sim.fields_state
    rows = xs_rows(plan, build_xs(plan, 24, sim._t))
    print(f"[6] vacuum uPML 255^3 Simulation.run: {nsteps} steps, "
          f"launches {launches}: {wall / nsteps * 1e3:.4f} ms/step = "
          f"{cells * nsteps / wall / 1e9:.3f} GCells/s ({card})",
          flush=True)
    for d, ker in ((3, kers["k2_d3"]), (2, kers["k2_d2"])):
        err, rel, _, _, _ = compare_k2(plan, d, 1, st, sim._t,
                                       [("ez", n // 2), ("hy", n // 2)])
        if not rel <= 1e-5:
            raise AssertionError(f"K2 depth {d} disagrees at 255^3: "
                                 f"rel {rel:.3e}")
        k2["max_abs_err"] = max(k2["max_abs_err"], err)
        ms, _ = time_steps(ker.step, clone_state(st), rows, per=d)
        b_ms, b_by = bound(fdtd3d_t2.step_cost(plan, d))
        print(f"[6] K2 depth {d} at 255^3: max abs err {err:.3e}; "
              f"{ms:.4f} ms/call = {ms / d:.4f} ms/step = "
              f"{cells * d / ms / 1e6:.3f} GCells/s; bound {b_ms:.4f} "
              f"ms/call ({b_by}); bx {ker._cuda['bx']}, ring "
              f"{ker._cuda['R']} planes ({card})", flush=True)
    err1, rel = compare_k1_from(plan, kers["k1"], st, sim._t)
    if not rel <= 1e-5:
        raise AssertionError(f"K1 disagrees at 255^3: rel {rel:.3e}")
    k1["max_abs_err"] = max(k1["max_abs_err"], err1)
    k_ms, _ = time_steps(kers["k1"].step, clone_state(st), rows[:11])
    p_ms, _ = time_steps(fdtd3d.step_ref(plan), clone_state(st), rows[:11])
    b_ms, b_by = bound(fdtd3d.step_cost(plan))
    print(f"[6] K1 at 255^3: max abs err {err1:.3e} over 5 steps; "
          f"{k_ms:.4f} ms/step = "
          f"{cells / k_ms / 1e6:.3f} GCells/s; plain {p_ms:.4f} ms/step; "
          f"bound {b_ms:.4f} ms ({b_by}); launches, ms each: "
          f"{launch_breakdown(kers['k1'], clone_state(st), rows[0])} "
          f"({card})", flush=True)

    print(card)
    print(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
