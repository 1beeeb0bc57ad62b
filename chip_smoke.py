#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (meep_nl_tpu_torch) on one GPU.

    python3 chip_smoke.py

Every call runs every phase; a failing phase exits non-zero, and no phase
falls back to the CPU or to a plain version:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every kernel source in meep_nl_tpu_torch/csrc with nvcc, all
     sources started together, and print ptxas's report on K1's, K2's,
     K3/K4's and K5's kernels (registers, stack, spills);
  3. the kernels against their plain versions on the card, from a seeded
     random state at 64^3, on the flagship material plan (eps=4 ball,
     Lorentz pole, chi2 Newton-Raphson) and a vacuum uPML plan: K1 over 20
     steps; K2 at depth 2 and depth 3 with capture planes on the flux
     plane's x-planes over 6 calls, state and every captured plane; K5
     (both half-step launches, each adding its family's sources) over 20
     steps with the source near its peak, on vacuum uPML plans in fp32 and
     fp64, an eps=4 ball padded to (8, 8, 128), and an eps=4, mu=2 ball
     with Ez and Hz current sources on the card tile's seams and chunk
     edges, repeated within a source, shared by two sources and on dead
     E/H planes, in fp32 and fp64.  K1, K2 and K5 in fp32 must agree bit
     for bit (max abs 0.0; 3 launches a step, 1 a call; 2 for K5), K5 in
     fp64 to 1e-12 of the field maximum.  Then a
     3x3x3 cell with nine current sources through Simulation.run on the
     hybrid route (the resident one declined), against the eager stepper;
  4. the main path: Simulation.run of the flagship ball at 128^3 (cell
     8x8x8 at resolution 16) with PML on every face, a Gaussian Ez point
     source and a flux plane, 602 steps.  Every step samples the DTFT, so
     the hybrid driver takes its capture route: 200 calls of K2's capture
     variant at depth 3 and a tail of 2 K1 steps, checked by the launch
     counters; nothing runs a plain version.  Then K1 and K2 against their
     plain versions from the main path's end state (bit for bit), their
     times (K2's per call beside K1's launches times the depth and the
     bound), and the same scene forced through the K1-only route; then the
     same scene at
     16^3 on the card against the port on the CPU (fluxes and Ez to 1e-4
     of their maximum);
  5. a linear monitored scene (the ball without chi2 and pole) at 96^3, DTFT
     decimation 5: every cycle is one depth-3 and one depth-2 K2 call,
     checked by the counters, and its fluxes equal the K1-only route's to
     1e-4; K2 at depth 2 and 3 (this plan's variant without the nonlinear
     item class, no capture planes) and K1 against their plain versions
     from that run's end state, bit for bit;
  6. vacuum uPML at 255^3 through Simulation.run, 50 steps without a
     monitor: the fully fused route, 16 depth-3 K2 calls and 2 K1 steps
     (counters); K2 and K1 against their plain versions from that run's end
     state, bit for bit; K1, K2 and the plain version timed with CUDA
     events;
  7. the resident path in 2D: the JAX package's bench.py::run_resident
     scene (767^2 at resolution 16, an eps=12 disk, a Gaussian Ez point
     source, PML 1) through Simulation.run, 1000 steps without a monitor,
     then again with an x-normal flux line of 3 frequencies: every stretch
     on the resident route, one K3 launch per stretch of at most 1024
     steps, no plain step (counters); K3 against its plain version from
     each run's end state over 20 steps (and, with the flux line, from a
     seeded random state), the DTFT accumulators to 1e-5 of their own
     maximum; K3, its plain version and the
     step_cost bound timed and reported as ms/step and GCells/s;
  8. the ring-resonator tutorial (Meep's python/examples/ring.py, without
     its mirror symmetry) at resolution 10: run(after_sources(Harminv(Ez,
     (r + 0.1, 0), 0.15, 0.1)), until_after_sources=300), then the same
     scene with until_after_sources=stop_when_fields_decayed(50, Ez,
     (r + 0.1, 0), 1e-3): every stretch through K4 (counters); K4 against
     its plain version from the end state (series and state); the modes and
     the decay run's stop step on the card against the same runs of the
     port on the CPU;
  9. the use_pallas route: Simulation(use_pallas=True, use_fused=False) at
     phase 6's 255^3 vacuum scene, 50 steps without a monitor (every
     stretch "half_step", 2 K5 launches per step, 0 fix-up launches, no
     plain step), K5 against its plain version from the end state (bit for
     bit); K5's launches alone from argument blocks built beforehand, the
     wrapper's two calls, the whole use_pallas step and the plain version
     timed beside the step_cost bound, with the launch geometry; then
     phase 5's 96^3 linear monitored scene, the same, and its fluxes must
     equal those of the plain stepper (use_fused=False), whose full-grid
     PML chains K5 follows, to 1e-4 (their difference from phase 5's K2
     route, whose slab-local chains see the scene's source inside the
     x-PML slab otherwise, is printed);
 10. the fused probed route: the 128^3 flagship without its flux plane,
     run(after_sources(Harminv(Ez, (0.3, 0.2, 0.1), 1, 1)),
     until_after_sources=50): every probed stretch through fused_probed_run
     (K4 declines the doubled state), 3 K1 launches per step, no plain
     step; the modes, the wall ms/step and K1's share of it; then 100 steps
     of fused_probed_run against the eager stepper's probe series from the
     end state, series and state bit for bit;
 11. the DFT monitor family: the 128^3 flagship (phase 4's scene) with
     add_dft_fields(Ez) on the z-normal plane through the ball, add_energy
     on a box around it, add_near2far on the closed box, add_force on an
     x-normal plane and add_ldos beside its flux plane, 602 steps on the
     hybrid route (the full-state cycle, one K1 step a cycle: the energy
     monitor reads D and B), its ms/step beside phase 4's; then the
     following scenes, which a process of its own also runs on the CPU
     from the script's start (cpu_twins, at a lowered priority): Meep's
     bend-flux tutorial
     (python/examples/bend-flux.py, 16x32 at resolution 10, an eps=12
     guide, 21 frequencies), the straight guide to
     until_after_sources=250 and its reflection data (get_flux_data), then
     the bend with load_minus_flux_data to until_after_sources=350, both on
     the resident route (K3, counters), T, R and 1 - T - R printed, K3
     against its plain version from the bend's end state; phase 8's ring
     with add_ldos(0.15, 0.1, 50) to until_after_sources=300, no probe,
     through K3 with its complex-weight DTFT (counters), K3 against its
     plain version from the end state bit for bit (state and
     accumulators), the LDOS's largest peak within one frequency bin of a
     mode that phase 8's Harminv found; the monitored flagship at 16^3 on
     the resident route.  The bend's T and R (to
     1e-4 of max |T|), the ring's LDOS and every output of the 16^3 scene
     (to 1e-4 of its own maximum) must equal the CPU's;
 12. Mirror symmetry: K1 (20 steps) and K2 (depth 2 and 3 with the flux
     plane's capture planes, 6 calls) bit for bit against their plain
     versions at 64^3 on the flagship material folded on y and z (node
     mirrors, an Ex source on both planes) and on y alone; the main path
     folded to a quarter cell (phase 4's scene with its source on the
     planes, Mirror(Y) and Mirror(Z, phase=-1): 128x64x64 cells, storage
     136x65x65), 602 steps on the capture route (200 K2 capture calls and
     2 K1 steps, counters, no eager stretch), its ms/step beside phase
     4's, K1 and K2 against their plain versions from its end state and
     its 16^3 twin (K3) against the same run on the CPU; the same scene
     linear at 128^3 folded and full, fluxes and unfolded Ez to 1e-4;
     Meep's ring.py as published (Mirror(Y), 161x81): Harminv and the
     decay stop through K4 (counters), K4 bit for bit from the end state,
     the series and the strong modes against phase 8's full ring printed
     (that cell is not exactly y-symmetric, ring_sim), the stop step
     against the CPU's; the ring with radii 1e-9 larger (exactly
     y-symmetric) folded and full through K4, series and strong modes to
     1e-4; K3 bit for bit on phase 7's 767^2
     with Mirror(Y) (odd: a magnetic wall) and its flux line, on a 768^2
     disk folded on x and y (node mirrors) and on the 16^3 flagship
     folded on y (the direct schedule);
 13. Rotate2 / Rotate4 and 1D cells: bench.py::run_resident's disk at
     768^2 (its source moved into the retained quadrant, a flux line
     there) folded by Rotate2("z") (384x768 cells) and Rotate4("z", phase
     -1) (384x384) and, unfolded, carrying the source's C2 / C4 images:
     1000 steps each through K3 (counters; the folds on the direct
     schedule's variant with the rotational ghosts), K3 bit for bit from
     each run's end state and a seeded random one (K4 too on the folds,
     with a probe folded from the dropped part), ms/step and GCells/s
     of each cell's own cells, fluxes and unfolded Ez of the folds against
     the full cells (1e-6 and 3e-6 of their maximum; Ez 5e-6 for Rotate4,
     whose full cell is C4-symmetric only to fp32 round-off: the same
     comparison in fp64 on the eager stepper must read 1e-12); Meep's
     ring.py with
     Rotate2("z") at phases +1 and -1: Harminv through K4 (counters, K4 bit
     for bit from the end state, the Q > 50 modes against the same run on
     the CPU to 1e-4), the decay stop at the CPU's step; the 16^3 linear
     flagship (no chi2: a rotation refuses it) folded by Rotate2 and
     Rotate4 through K3 against its plain version and the CPU; the 128^3
     linear flagship folded by Rotate4 (64x64x128 cells, square x-y
     storage 65x65x129: its doubled state fits the resident budget, so
     K3's direct schedule takes it, as the reference's resident kernel
     would) and by Rotate2 (64x128x128, above the budget: the eager
     stepper, since K1, K2 and K5 decline rotations as the reference's
     do), 60 steps each after 6 of warm-up, timed (K3 also by CUDA
     events, and bit for bit from the run's end state and a seeded random
     one), unfolded Ez against the full cell on the hybrid route (3e-6);
     and a 1D cell: thg_amplitude's Kerr scene (resolution 40, f0 = 1/3,
     chi3) in a cell of 100 (4000 cells) on the eager stepper, the DTFT of
     Ex at f0 and 3 f0 and the flux against the CPU (1e-4 of each
     frequency's own magnitude), the third harmonic doubling with chi3
     (5 %);
 14. Bloch-periodic cells with real phases (k_point): Meep's
     binary_grating.py at its published size (resolution 60, 510x600,
     PML on x, k_point=Vector3(), without its Mirror(Y): a mirror on a
     wrapped axis is refused), the substrate-only normalization run
     (until_after_sources=100) and the grating run (300) through K3's
     direct schedule with the wrap (counters, K3 bit for bit from the
     grating's end state and a seeded random state), the transmittance of
     its 21 frequencies, the same two runs at resolution 12 against the
     CPU (each frequency to 1e-4 of its own magnitude), and K3 on the
     grating timed beside the same cell without the wrap on tiles;
     holey-wvg-bands.py at the band edges (resolution 20, 1x12,
     Mirror(Y, phase=-1), PML on y): run_k_points(300, [Vector3(0),
     Vector3(0.5)]) through K4 at phase +1 and -1 (counters, K4 bit for
     bit from each end state and a seeded random state, the modes with
     Q > 20 against the CPU's to 1e-4); phase 4's 128^3 flagship made x-periodic (PML on y and z,
     k_x = 0 and the zone edge 1/16: phase -1), after 12 steps of
     warm-up 60 steps without the flux plane (the ghost ring: K2 at depth
     3 on the extended plan, counters) and 602 with it (K1's x wrap every
     step, the full-state cycle), each against the eager stepper on the
     card with the same slab-local PML chains (state on the live planes,
     fluxes: 1e-6), K2 on the extended plan and K1's x wrap bit for bit
     against their plain versions from the end states, timed; its 16^3
     form (K3's wrap) against the CPU (1e-4);
 15. complex fields on the card, in real-pair storage (the CPU runs of
     this phase in a second process of their own, --cpu-twins15):
     holey-wvg-bands.py as published, run_k_points(300,
     interpolate(19, [Vector3(0), Vector3(0.5)])): 21 k points, the 19
     interior ones (complex phases) through K4's pair layout (counters),
     the band edges through its real wrap; at k_x = 0.1, 0.25 and 0.4 the
     Q > 20 modes against the CPU's native complex run to 1e-4 of each
     frequency; K4's pair layout bit for bit against its plain version
     from the end state and a seeded random state, timed.  The oblique
     binary grating (binary_grating_oblique.py's setup at 10 degrees:
     k_point=Vector3(0, fcen sin 10), the line source's amp_func
     exp(2 pi i k.r)) at 510x600: the normalization and grating runs
     through K3's pair layout (counters), the transmittance of its 21
     frequencies from the flux line, the same runs at resolution 12
     against the CPU (1e-4 of each frequency), K3's pair layout bit for
     bit from the end state and a seeded random state, timed.  Phase 14's
     128^3 x-periodic flagship without its chi2 (pair fields refuse it;
     the Lorentz pole stays) at k_x = 0.23: 60 steps without the flux
     plane (the pair ghost ring: K2 at depth 3 on both channels) and 602
     with it (K1's pair wrap every step), each after 12 steps of warm-up
     and against the eager pair stepper on the card (live planes and
     fluxes to 1e-6); K2 on the pair ring (each channel) and K1's pair
     wrap bit for bit against their plain versions from the end states
     and seeded random states, timed.
 16. monitored x-periodic cells two steps a call, then BFAST: phase 5's
     linear flagship (the eps=4 ball without chi2 and pole) at 128^3 made
     x-periodic (PML on y and z, k_x = 0 and the zone edge 1/16) with its
     flux plane at DTFT decimation WRAP_DEC, 602 steps after 12 of
     warm-up: the hybrid driver's PeriodicXT2Kernel (K2's x-wrap variant,
     2 calls and 1 K1 step a cycle of 5, counters), fluxes and the live
     planes against the eager stepper on the card with the same slab
     chains (1e-6), K2's x wrap bit for bit against its plain version from
     the end state and a seeded random state, its ms/call beside twice K1's
     x wrap and the bound, the run's ms/step beside the same cell forced
     onto K1's x wrap; Meep's refl_angular_bfast as published (cell
     0.1x0.1x10 at resolution 20, BFAST scaled k (0.5, 0, 0), Courant
     (1 - 0.5) / sqrt(3)): the normalization run (until=60) and the
     interface run (until=100) through K3's PAIR_BFAST variant (counters),
     R(f) at its 5 frequencies beside Fresnel's p-pol, the same runs at
     resolution 10 against the port on the CPU (native complex, the eager
     stepper, in the --cpu-twins15 process: each frequency to 1e-4), a
     probed stretch of the cell through K4, K3 and K4 with BFAST bit for
     bit from the end state and a seeded random state, and K3 with BFAST
     timed beside the same cell without BFAST (real fields, K3's wrap).
The last lines: the card line, the kernel table as one JSON object, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
K1_REPLACES = "meep_nl_tpu/ops/pallas/fdtd3d.py:554"
K2_REPLACES = "meep_nl_tpu/ops/pallas/fdtd3d_t2.py:182"
K3_REPLACES = "meep_nl_tpu/ops/pallas/resident.py:223"
K4_REPLACES = "meep_nl_tpu/ops/pallas/resident.py:289"
K5_REPLACES = "meep_nl_tpu/ops/pallas/fused.py:71"
#: K1's launches per step on every plan (csrc/fdtd3d.cu: B, D, E)
K1_LAUNCHES = 3


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def ptxas(build, name) -> str:
    """ptxas's report on csrc/<name>.cu's kernels (registers, shared
    memory, spills), from a build with the port's flags and -Xptxas -v."""
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    out = os.path.join(build.BUILD_DIR, f"ptxas_{name}_{os.getpid()}.so")
    res = subprocess.run(
        [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", build.CSRC,
         "-o", out, os.path.join(build.CSRC, f"{name}.cu")],
        capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed:\n{res.stderr}")
    os.remove(out)
    keep = ("Compiling entry", "stack frame", "Used")
    return "\n".join("    " + ln.strip() for ln in res.stderr.splitlines()
                     if any(k in ln for k in keep))


def build_all():
    """One nvcc per csrc/*.cu source and one for each of K1's, K2's, K3/K4's
    and K5's ptxas reports, all started together; returns (names,
    seconds, {source: report})."""
    from meep_nl_tpu_torch.ops import _build
    names = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                   if f.endswith(".cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names) + 4) as ex:
        reports = {n: ex.submit(ptxas, _build, n)
                   for n in ("fdtd3d", "fdtd3d_t2", "fused", "resident")}
        list(ex.map(_build.build, names))
        reports = {n: r.result() for n, r in reports.items()}
    return names, time.perf_counter() - t0, reports


def flagship_sim(mp, n_cells, res, device, flux=True, ball=True,
                 pml=1.0, linear=False, decimation=0, monitors=False,
                 src_comp=None, src_y=0.01, kx=None, chi2=True, **sim_kw):
    """The flagship scene: an eps=4 ball (radius a quarter of the cell)
    with a Lorentz pole and full-tensor chi2 (the NR solve), uPML on every
    face, a Gaussian Ez point source off the ball and an x-normal flux
    plane (the JAX package's bench.py material configuration).  `linear`
    keeps the eps=4 ball and drops its pole and chi2; `decimation` is the
    flux monitor's DTFT decimation factor (0: automatic); `monitors` adds
    the DFT monitor family (`monitor_family`) and returns its handles, the
    flux plane's under "flux", in place of the flux handle; `src_comp`
    (default Ez) and `src_y` (y over the cell side) move the source;
    `kx` makes the cell Bloch-periodic along x (k_point=Vector3(kx), the
    PML on y and z only); `chi2` False drops the chi2 and keeps the pole;
    `sim_kw` goes to Simulation (use_pallas, use_fused, symmetries)."""
    L = n_cells / res
    geometry = []
    if ball:
        pole = [mp.LorentzianSusceptibility(frequency=2.0, gamma=0.05,
                                            sigma=0.2)]
        med = mp.Medium(epsilon=4.0) if linear else mp.Medium(
            epsilon=4.0, chi2=0.05, chi2_full_tensor=True,
            E_susceptibilities=pole) if chi2 else mp.Medium(
            epsilon=4.0, E_susceptibilities=pole)
        geometry = [mp.Sphere(radius=L / 4, material=med)]
    sim = mp.Simulation(
        cell_size=mp.Vector3(L, L, L), resolution=res, geometry=geometry,
        sources=[mp.Source(mp.GaussianSource(frequency=1.0, fwidth=0.5),
                           component=src_comp or mp.Ez,
                           center=mp.Vector3(-0.35 * L, src_y * L, 0))],
        boundary_layers=[mp.PML(pml)] if kx is None else
        [mp.PML(pml, direction=mp.Y), mp.PML(pml, direction=mp.Z)],
        k_point=None if kx is None else mp.Vector3(kx),
        eps_averaging=False, device=device, **sim_kw)
    fl = None
    if flux:
        fl = sim.add_flux(1.0, 0.4, 3, mp.FluxRegion(
            center=mp.Vector3(0.35 * L, 0, 0),
            size=mp.Vector3(0, 0.4 * L, 0.4 * L)),
            decimation_factor=decimation)
    if monitors:
        fl = {"flux": fl, **monitor_family(mp, sim, L)}
    sim.init_sim()
    return sim, fl


def monitor_family(mp, sim, L):
    """Beside the flagship's flux plane (cell side L, the ball of radius
    L / 4 at the centre), 3 frequencies each: add_dft_fields of Ez on the
    z-normal plane through the ball, add_energy on a box around the ball,
    add_near2far on the closed 6-face box around it, add_force (x) on an
    x-normal plane, add_ldos at the source."""
    h = 0.275 * L
    faces = []
    for ax in range(3):
        for sgn in (1, -1):
            c, sz = [0.0] * 3, [2 * h] * 3
            c[ax], sz[ax] = sgn * h, 0.0
            faces.append(mp.Near2FarRegion(center=mp.Vector3(*c),
                                           size=mp.Vector3(*sz), weight=sgn))
    return {
        "dftf": sim.add_dft_fields([mp.Ez], 1.0, 0.4, 3, center=mp.Vector3(),
                                   size=mp.Vector3(L, L, 0)),
        "energy": sim.add_energy(1.0, 0.4, 3, mp.EnergyRegion(
            center=mp.Vector3(), size=mp.Vector3(2 * h, 2 * h, 2 * h))),
        "n2f": sim.add_near2far(1.0, 0.4, 3, *faces),
        "force": sim.add_force(1.0, 0.4, 3, mp.ForceRegion(
            center=mp.Vector3(0.3 * L, 0, 0),
            size=mp.Vector3(0, 0.4 * L, 0.4 * L), direction=mp.X)),
        "ldos": sim.add_ldos(1.0, 0.4, 3)}


def monitor_outputs(mp, sim, mon):
    """Every output of the monitor family: the dft array, the energies,
    the forces, the LDOS and the far fields at the 4 points of a
    get_farfields grid 10 units out along x."""
    return {"flux": sim.get_fluxes(mon["flux"]),
            "dft Ez": sim.get_dft_array(mon["dftf"], mp.Ez),
            "electric energy": sim.get_electric_energy(mon["energy"]),
            "magnetic energy": sim.get_magnetic_energy(mon["energy"]),
            "total energy": sim.get_total_energy(mon["energy"]),
            "force": sim.get_forces(mon["force"]),
            "ldos": sim.get_ldos(mon["ldos"]),
            "far fields": sim.get_farfields(
                mon["n2f"], 1, center=mp.Vector3(10, 0, 0),
                size=mp.Vector3(0, 1, 1))}


#: Meep's bend-flux tutorial (python/examples/bend-flux.py, the JAX
#: package's examples/bend_flux.py): cell, padding, guide width, PML,
#: resolution, and its 21 frequencies
BEND = dict(sx=16, sy=32, pad=4, w=1.0, dpml=1.0, res=10, fcen=0.15,
            df=0.1, nfreq=21)


def bend_sim(mp, bend, device):
    """The tutorial's straight guide (bend False) or its 90-degree bend: an
    eps=12 guide of width 1, an Ez line source across it, the reflection
    flux line beside the source and the transmission line at the far end
    of the guide."""
    b = BEND
    sx, sy, pad, w, dpml = b["sx"], b["sy"], b["pad"], b["w"], b["dpml"]
    xcen = 0.5 * (sx - w - 2 * pad)
    ycen = -0.5 * (sy - w - 2 * pad)
    eps12 = mp.Medium(epsilon=12)
    geometry = ([mp.Block(mp.Vector3(sx - pad, w, mp.inf),
                          center=mp.Vector3(-0.5 * pad, ycen), material=eps12),
                 mp.Block(mp.Vector3(w, sy - pad, mp.inf),
                          center=mp.Vector3(xcen, 0.5 * pad), material=eps12)]
                if bend else
                [mp.Block(mp.Vector3(mp.inf, w, mp.inf),
                          center=mp.Vector3(0, ycen), material=eps12)])
    sim = mp.Simulation(
        cell_size=mp.Vector3(sx, sy), resolution=b["res"], geometry=geometry,
        sources=[mp.Source(mp.GaussianSource(b["fcen"], fwidth=b["df"]),
                           component=mp.Ez,
                           center=mp.Vector3(-0.5 * sx + dpml, ycen),
                           size=mp.Vector3(0, w))],
        boundary_layers=[mp.PML(dpml)], device=device)
    fl = (b["fcen"], b["df"], b["nfreq"])
    refl = sim.add_flux(*fl, mp.FluxRegion(
        center=mp.Vector3(-0.5 * sx + dpml + 0.5, ycen),
        size=mp.Vector3(0, 2 * w)))
    tran = sim.add_flux(*fl, mp.FluxRegion(
        center=mp.Vector3(xcen, 0.5 * sy - dpml - 0.5),
        size=mp.Vector3(2 * w, 0)) if bend else mp.FluxRegion(
        center=mp.Vector3(0.5 * sx - dpml, ycen), size=mp.Vector3(0, 2 * w)))
    sim.init_sim()
    return sim, refl, tran


def bend_flux(mp, device, run=None):
    """The tutorial's recipe: the straight guide to until_after_sources=250
    and its reflection data, then the bend, with that data subtracted
    (load_minus_flux_data), to until_after_sources=350.  Returns (T, R,
    the two simulations); `run(sim, **kw)` runs a simulation (default
    sim.run)."""
    import numpy as np
    run = run or (lambda sim, **kw: sim.run(**kw))
    sim0, refl0, tran0 = bend_sim(mp, False, device)
    run(sim0, until_after_sources=250)
    straight = np.array(sim0.get_fluxes(tran0))
    data = sim0.get_flux_data(refl0)
    sim1, refl1, tran1 = bend_sim(mp, True, device)
    sim1.load_minus_flux_data(refl1, data)
    run(sim1, until_after_sources=350)
    return (np.array(sim1.get_fluxes(tran1)) / straight,
            -np.array(sim1.get_fluxes(refl1)) / straight, (sim0, sim1))


def ring_ldos_sim(mp, device):
    """Phase 8's ring with add_ldos(0.15, 0.1, 50) and no probe."""
    sim = ring_sim(mp, 10, device)
    ldos = sim.add_ldos(0.15, 0.1, 50)
    sim.init_sim()
    return sim, ldos


def cpu_twins(path) -> int:
    """Phase 11's runs on the CPU (the port's plain versions), saved to
    `path` (.npz): the bend-flux T and R, the ring's LDOS, the 16^3
    monitored flagship's outputs.  chip_smoke.py runs this in a process of
    its own (--cpu-twins PATH) from its start, while the card works."""
    import numpy as np
    import torch
    import meep_nl_tpu_torch as mp
    os.nice(10)                  # the card's host work comes first
    torch.set_num_threads(4)
    out = {}
    out["T"], out["R"], _ = bend_flux(mp, "cpu")
    sim, ldos = ring_ldos_sim(mp, "cpu")
    sim.run(until_after_sources=300)
    out["ldos"] = sim.get_ldos(ldos)
    sim, mon = flagship_sim(mp, 16, 8.0, "cpu", pml=0.25, monitors=True)
    sim.run(until=200 * sim.dt)
    for k, v in monitor_outputs(mp, sim, mon).items():
        out[f"16:{k}"] = v
    # phase 12's twins: the folded flagship at 16^3, the folded ring's
    # decay stop
    sim, fl = flagship_sim(mp, 16, 8.0, "cpu", pml=0.25, src_y=0.0,
                           symmetries=fold_main(mp))
    sim.run(until=200 * sim.dt)
    out["m16:flux"], out["m16:ez"] = sim.get_fluxes(fl), sim.get_array(mp.Ez)
    sim = ring_sim(mp, 10, "cpu", symmetries=[mp.Mirror(mp.Y)])
    sim.run(until_after_sources=ring_decay(mp))
    out["ring_m_stop"] = sim._t
    # phase 13's twins: the 1D third-harmonic scene, the ring folded by
    # Rotate2 (Harminv at phases +1 and -1, the decay stop), the 16^3
    # linear flagship folded by Rotate2 and Rotate4
    out["thg_amp"], out["thg_flux"], sim, _ = thg_run(mp, "cpu",
                                                      THG["chi3"])
    out["thg_steps"] = sim._t
    for phase in (1, -1):
        sim = ring_sim(mp, 10, "cpu", symmetries=[mp.Rotate2(mp.Z, phase)])
        h = mp.Harminv(mp.Ez, mp.Vector3(1.1), 0.15, 0.1)
        sim.run(mp.after_sources(h), until_after_sources=300)
        out[f"ring_r2{phase}_modes"] = np.array(
            [(m.freq, m.Q, m.amp) for m in h.modes]).reshape(-1, 3)
    sim = ring_sim(mp, 10, "cpu", symmetries=[mp.Rotate2(mp.Z)])
    sim.run(until_after_sources=ring_decay(mp))
    out["ring_r2_stop"] = sim._t
    for kind in ("rot2", "rot4"):
        sim, fl = rot_flagship(mp, 16, 8.0, "cpu", kind, True, pml=0.25)
        sim.run(until=200 * sim.dt)
        out[f"{kind}16:flux"] = sim.get_fluxes(fl)
        out[f"{kind}16:ez"] = sim.get_array(mp.Ez)
    # phase 14's twins: the grating at resolution GRATING_TWIN_RES, the
    # holey waveguide's band edges, the 16^3 flagship x-periodic at the
    # zone edge
    out["grating_T"], _ = grating_T(mp, GRATING_TWIN_RES, "cpu")
    for i, k in enumerate(HOLEY_K):
        freqs = holey_sim(mp, "cpu").run_k_points(300, [mp.Vector3(k)])[0]
        out[f"holey{i}"] = np.array(freqs, np.complex128)
    sim, fl = flagship_sim(mp, 16, 8.0, "cpu", pml=0.25, kx=0.25)
    sim.run(until=200 * sim.dt)
    out["p16:flux"], out["p16:ez"] = sim.get_fluxes(fl), sim.get_array(mp.Ez)
    np.savez(path, **out)
    return 0


def cpu_twins15(path) -> int:
    """Phase 15's runs on the CPU (native complex fields, the eager
    stepper), saved to `path` (.npz): holey-wvg-bands.py's modes at
    HOLEY_CHECK_K, the oblique grating's transmittance at resolution
    GRATING_TWIN_RES, refl_angular_bfast's R(f) at BFAST_TWIN_RES (phase
    16).  chip_smoke.py runs this in a second process
    (--cpu-twins15 PATH) from its start."""
    import numpy as np
    import torch
    import meep_nl_tpu_torch as mp
    os.nice(10)
    torch.set_num_threads(3)
    out = {}
    for k in HOLEY_CHECK_K:
        freqs = holey_sim(mp, "cpu").run_k_points(300, [mp.Vector3(k)])[0]
        out[f"holey{k}"] = np.array(freqs, np.complex128)
    out["oblique_T"], _ = grating_T(mp, GRATING_TWIN_RES, "cpu",
                                    oblique=True)
    out["bfast_R"], _ = bfast_R(mp, BFAST_TWIN_RES, "cpu")
    np.savez(path, **out)
    return 0


#: Meep's binary_grating.py (python/examples/binary_grating.py): PML,
#: substrate, padding, period, height and duty cycle of the grating, the
#: wavelengths 0.4-0.6 (their frequency band), 21 frequencies; the
#: resolutions of the card's run (the tutorial's) and of the CPU twin
GRATING = dict(dpml=1.0, dsub=3.0, dpad=3.0, gp=10.0, gh=0.5, gdc=0.5,
               wvl=(0.4, 0.6), nfreq=21)
GRATING_RES, GRATING_TWIN_RES = 60, 12
#: holey-wvg-bands.py's band edges (phase 14); its path of 21 k points and
#: the interior ones held against the CPU (phase 15)
HOLEY_K = (0.0, 0.5)
HOLEY_PATH_N = 19
HOLEY_CHECK_K = (0.1, 0.25, 0.4)
#: phase 16's DTFT decimation of the x-periodic linear flagship's flux plane
#: (a cycle of 5 steps: 2 calls of K2's x wrap and 1 K1 step)
WRAP_DEC = 5
#: refl_angular_bfast.py (examples/): sin of the angle, the glass index, the
#: source's centre and width, the frequencies, the published resolution
#: and that of the CPU twin
BFAST = dict(S=0.5, n2=1.5, fcen=1.0, df=0.5, nf=5)
BFAST_RES, BFAST_TWIN_RES = 20, 10
#: the angle of incidence of phase 15's oblique grating (degrees) and the
#: k_x of its 128^3 pair scene
OBLIQUE_DEG = 10.0
PAIR_KX = 0.23


def grating_sim(mp, res, device, grating, wrap=True, oblique=False):
    """binary_grating.py's 8.5 x 10 cell at resolution `res`: PML on x
    only, k_point=Vector3() (periodic in y, phase +1; `wrap` False: no
    k_point, metal y walls), a Gaussian Ez line source over the period in
    the substrate, the 21-frequency flux line over the period in the air;
    without `grating` the normalization run's homogeneous glass (n =
    1.5), with it the substrate and the grating's teeth in air.  The
    tutorial's Mirror(Y) is left out: the reference refuses a mirror on a
    wrapped axis (simulation.py:566-585).  `oblique`: binary_grating_
    oblique.py's setup at OBLIQUE_DEG, k_point=Vector3(0, fcen sin theta)
    and the line source's amp_func exp(2 pi i k.r) (complex fields)."""
    import cmath
    import math
    g = GRATING
    sx = 2 * g["dpml"] + g["dsub"] + g["gh"] + g["dpad"]
    sy = g["gp"]
    fmin, fmax = 1 / g["wvl"][1], 1 / g["wvl"][0]
    fcen, df = 0.5 * (fmin + fmax), fmax - fmin
    glass = mp.Medium(index=1.5)
    geometry = [
        mp.Block(material=glass,
                 size=mp.Vector3(g["dpml"] + g["dsub"], mp.inf, mp.inf),
                 center=mp.Vector3(-0.5 * sx + 0.5 * (g["dpml"] + g["dsub"]))),
        mp.Block(material=glass,
                 size=mp.Vector3(g["gh"], g["gdc"] * g["gp"], mp.inf),
                 center=mp.Vector3(-0.5 * sx + g["dpml"] + g["dsub"]
                                   + 0.5 * g["gh"]))] if grating else []
    k = mp.Vector3() if wrap else None
    amp_func = None
    if oblique:
        ky = fcen * math.sin(math.radians(OBLIQUE_DEG))
        k = mp.Vector3(0, ky)

        def amp_func(r):
            return cmath.exp(2j * math.pi * ky * r.y)
    sim = mp.Simulation(
        resolution=res, cell_size=mp.Vector3(sx, sy),
        boundary_layers=[mp.PML(g["dpml"], direction=mp.X)],
        geometry=geometry, k_point=k,
        default_material=mp.Medium() if grating else glass,
        sources=[mp.Source(mp.GaussianSource(fcen, fwidth=df), mp.Ez,
                           center=mp.Vector3(-0.5 * sx + g["dpml"]
                                             + 0.5 * g["dsub"]),
                           size=mp.Vector3(0, sy), amp_func=amp_func)],
        device=device)
    fl = sim.add_flux(fcen, df, g["nfreq"], mp.FluxRegion(
        center=mp.Vector3(0.5 * sx - g["dpml"] - 0.5 * g["dpad"]),
        size=mp.Vector3(0, sy)))
    sim.init_sim()
    return sim, fl


def grating_T(mp, res, device, run=None, oblique=False):
    """binary_grating.py's two runs: the substrate-only normalization
    (until_after_sources=100), then the grating (until_after_sources=300);
    returns (the transmittance per frequency, the two (simulation, flux)
    pairs); `run(sim, **kw)` runs a simulation (default sim.run)."""
    import numpy as np
    run = run or (lambda sim, **kw: sim.run(**kw))
    s0, f0 = grating_sim(mp, res, device, False, oblique=oblique)
    run(s0, until_after_sources=100)
    s1, f1 = grating_sim(mp, res, device, True, oblique=oblique)
    run(s1, until_after_sources=300)
    return (np.array(s1.get_fluxes(f1)) / np.array(s0.get_fluxes(f0)),
            ((s0, f0), (s1, f1)))


def bfast_sim(mp, res, device, interface, bfast=True):
    """Meep's refl_angular_bfast.py as published: a 0.1 x 0.1 x 10 cell
    (Bloch-periodic across x and y at k = 0), PML 1 on z, glass (n = 1.5)
    filling z > 0 when `interface`, an Ex plane source at z = -3 (Gaussian,
    f 1, width 0.5), the reflection flux plane at z = -2 (5 frequencies),
    BFAST with scaled k (0.5, 0, 0) at Courant (1 - 0.5) / sqrt(3);
    `bfast` False drops BFAST (real fields)."""
    import numpy as np
    b = BFAST
    geom = [mp.Block(center=mp.Vector3(0, 0, 2.5),
                     size=mp.Vector3(mp.inf, mp.inf, 5.0),
                     material=mp.Medium(epsilon=b["n2"] ** 2))] \
        if interface else []
    sim = mp.Simulation(
        cell_size=mp.Vector3(0.1, 0.1, 10), resolution=res,
        Courant=(1 - b["S"]) / np.sqrt(3), geometry=geom,
        sources=[mp.Source(mp.GaussianSource(frequency=b["fcen"],
                                             fwidth=b["df"]),
                           component=mp.Ex, center=mp.Vector3(0, 0, -3.0),
                           size=mp.Vector3(0.1, 0.1, 0))],
        boundary_layers=[mp.PML(1.0, direction=mp.Z)],
        k_point=mp.Vector3(0, 0, 0),
        bfast_scaled_k=mp.Vector3(b["S"], 0, 0) if bfast else None,
        eps_averaging=False, device=device)
    refl = sim.add_flux(b["fcen"], b["df"], b["nf"], mp.FluxRegion(
        center=mp.Vector3(0, 0, -2.0), size=mp.Vector3(0.1, 0.1, 0)))
    sim.init_sim()
    return sim, refl


def bfast_R(mp, res, device, run=None):
    """refl_angular_bfast's two runs: the normalization run to until=60,
    then the interface run with its flux data subtracted to until=100
    (`run(sim, until=...)`: sim.run by default); returns (R(f), the two
    simulations)."""
    import numpy as np
    run = run or (lambda sim, **kw: sim.run(**kw))
    s0, r0 = bfast_sim(mp, res, device, False)
    run(s0, until=60)
    inc = np.asarray(s0.get_fluxes(r0))
    s1, r1 = bfast_sim(mp, res, device, True)
    s1.load_minus_flux_data(r1, s0.get_flux_data(r0))
    run(s1, until=100)
    return -np.asarray(s1.get_fluxes(r1)) / inc, (s0, s1)


def fresnel_p(f):
    """|r_p|^2 of the air-glass interface at the scene's fixed angle."""
    import numpy as np
    b = BFAST
    w = 2 * np.pi * np.asarray(f)
    kz1 = np.sqrt(w ** 2 - (b["S"] * w) ** 2)
    kz2 = np.sqrt((b["n2"] * w) ** 2 - (b["S"] * w) ** 2)
    rp = (b["n2"] ** 2 * kz1 - kz2) / (b["n2"] ** 2 * kz1 + kz2)
    return np.abs(rp) ** 2


def holey_sim(mp, device):
    """Meep's holey-wvg-bands.py (python/examples/holey-wvg-bands.py): a
    1 x 12 cell at resolution 20, an eps=13 guide of width 1.2 with a hole
    of radius 0.36, an Hz Gaussian source (0.25, fwidth 1.5) at
    (0.1234, 0), Mirror(Y, phase=-1), PML 1 on y."""
    return mp.Simulation(
        cell_size=mp.Vector3(1, 12), resolution=20,
        geometry=[mp.Block(mp.Vector3(mp.inf, 1.2, mp.inf),
                           material=mp.Medium(epsilon=13)),
                  mp.Cylinder(0.36)],
        sources=[mp.Source(mp.GaussianSource(0.25, fwidth=1.5), mp.Hz,
                           center=mp.Vector3(0.1234))],
        symmetries=[mp.Mirror(mp.Y, phase=-1)],
        boundary_layers=[mp.PML(1, direction=mp.Y)], device=device)


def fold_main(mp):
    """Phase 12's symmetries of the flagship: a node mirror on y (phase
    +1, 128 cells: the plane on whole sites) and a metal wall on z (phase
    -1): a quarter cell."""
    return [mp.Mirror(mp.Y), mp.Mirror(mp.Z, phase=-1)]


def ring_decay(mp):
    """Phase 8's decay stop of the ring."""
    return mp.stop_when_fields_decayed(50, mp.Ez, mp.Vector3(1.1), 1e-3)


def resident_sim(mp, n, device, flux=False, **sim_kw):
    """bench.py::run_resident's scene through the public API: an
    (n / 16)^2 cell at resolution 16 (n^2 cells), an eps=12 disk of radius
    n / 96 at the centre, a Gaussian Ez point source (f 1, fwidth 0.5) at
    x = -n / 48, PML 1 on every side; `flux` adds an x-normal flux line of 3
    frequencies at x = +n / 48; `sim_kw` goes to Simulation
    (symmetries)."""
    res = 16.0
    L = n / res
    sim = mp.Simulation(
        cell_size=mp.Vector3(L, L), resolution=res,
        geometry=[mp.Cylinder(radius=L / 6,
                              material=mp.Medium(epsilon=12))],
        sources=[mp.Source(mp.GaussianSource(frequency=1.0, fwidth=0.5),
                           component=mp.Ez,
                           center=mp.Vector3(-L / 3, 0))],
        boundary_layers=[mp.PML(1.0)], device=device, **sim_kw)
    fl = None
    if flux:
        fl = sim.add_flux(1.0, 0.4, 3, mp.FluxRegion(
            center=mp.Vector3(L / 3, 0), size=mp.Vector3(0, L / 2)))
    sim.init_sim()
    return sim, fl


def ring_sim(mp, res, device, nudge=0.0, **sim_kw):
    """Meep's ring-resonator tutorial (python/examples/ring.py), without
    its Mirror(Y) unless `sim_kw` declares it (symmetries): n = 3.4, w = 1,
    r = 1, pad = 4, dpml = 2 (a 16 x 16 cell), an Ez Gaussian source
    (0.15, fwidth 0.1) at (r + 0.1, 0).  `nudge` grows both radii: at
    resolution 10 the outer surface r + w = 2 passes exactly through 8 of
    the Ez sites (such as (1.6, +-1.2)), whose smoothed eps then depends on
    how their coordinates round (6.87 at y = -1.2, 5.69 at +1.2), so the
    published full cell is not exactly y-symmetric; 1e-9 makes it so."""
    n, w, r, pad, dpml = 3.4, 1, 1, 4, 2
    sxy = 2 * (r + w + pad + dpml)
    return mp.Simulation(
        cell_size=mp.Vector3(sxy, sxy), resolution=res,
        geometry=[mp.Cylinder(radius=r + w + nudge,
                              material=mp.Medium(index=n)),
                  mp.Cylinder(radius=r + nudge)],
        sources=[mp.Source(mp.GaussianSource(0.15, fwidth=0.1), mp.Ez,
                           center=mp.Vector3(r + 0.1))],
        boundary_layers=[mp.PML(dpml)], device=device, **sim_kw)


def schedule_text(ker, nsteps, probed):
    """K3/K4's schedule of a stretch of nsteps: tiles, T, blocks, shared
    memory per block, passes and grid barriers; or the direct schedule's
    blocks and grid barriers a step."""
    d = ker.describe(nsteps, probed)
    if d["direct"]:
        why = {2: "a rotational fold's ghosts",
               3: "the Bloch wrap's reads"}.get(
            d["direct"], "tiles would give no temporal reuse")
        return (f"direct schedule ({why}): "
                f"the whole grid in place, {d['blocks']} blocks, T 1, "
                f"{d['barriers'][0]}-{d['barriers'][1]} grid barriers a "
                f"step, {d['passes']} steps per {nsteps}-step stretch")
    tile = "x".join(str(v) for v in d["t"][:len(ker.shape)])
    return (f"tiles {tile} ({d['ntile']}), T {d['T']}, {d['blocks']} "
            f"blocks of {d['smem']} B shared memory (+ static), "
            f"{d['passes']} passes = {d['barriers']} grid barriers per "
            f"{nsteps}-step stretch")


def compare_resident(ker, st0, t0, nsteps, probes=()):
    """K3 (K4 with probes) against resident_ref over nsteps from state st0
    at step t0 (these launches are not counted); returns (abs, rel, the
    DTFT accumulators' max abs error relative to their own maximum, the
    series' max abs error).  Fails if the plan has DTFT monitors and no
    step of the window samples them."""
    import numpy as np
    from meep_nl_tpu_torch.ops import resident as R
    from meep_nl_tpu_torch.stepper.step import build_xs
    plan = ker.plan
    xs = build_xs(plan, nsteps, t0)
    if plan.dfts and not any(np.any(xs[f"dft{mi}:ph_re"] != 0)
                             for mi in range(len(plan.dfts))):
        raise AssertionError(f"no DTFT sample step in steps {t0}.."
                             f"{t0 + nsteps - 1}")
    counts = (ker.launches, ker.probed_launches)
    sk, yk = ker._run(clone_state(st0), nsteps, t0, probes)
    sr, yr = R.resident_ref(plan)(clone_state(st0), nsteps, t0, probes)
    ker.launches, ker.probed_launches = counts
    err, rel = state_error(sk, sr)
    drel = 0.0
    for c, t in sr["dft"].items():
        scale = float(t.abs().max())
        if not scale > 0:
            raise AssertionError(f"DTFT accumulator {c} is zero")
        derr = float((sk["dft"][c] - t).abs().max())
        err = max(err, derr)
        drel = max(drel, derr / scale)
    serr = max([0.0] + [float((yk[k] - yr[k]).abs().max()) for k in yr])
    return err, rel, drel, serr


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
    if "f_bfast" in st:
        st["f_bfast"] = {c: rnd(t) for c, t in st["f_bfast"].items()}
    st["pol"] = [{k: {c: rnd(t) for c, t in e[k].items()}
                  for k in ("p", "pp")} for e in st["pol"]]
    return st


def clone_state(st):
    out = {"f": {c: t.clone() for c, t in st["f"].items()},
           "f_u": {c: t.clone() for c, t in st["f_u"].items()},
           "f_cond": {}, "f_w": {c: t.clone() for c, t in st["f_w"].items()},
           "pol": [{k: {c: t.clone() for c, t in e[k].items()}
                    for k in ("p", "pp")} for e in st["pol"]],
           "dft": {c: t.clone() for c, t in st["dft"].items()},
           "t": st["t"]}
    if "f_bfast" in st:
        out["f_bfast"] = {c: t.clone() for c, t in st["f_bfast"].items()}
    return out


def state_error(a, b):
    """(max abs error, max abs error / max |b|) over every field array."""
    import torch
    err = 0.0
    scale = 0.0
    for key in ("f", "f_u", "f_w", "f_bfast"):
        for c in b.get(key, {}):
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
    None for the variant without) against steps_ref from state st0 (the
    kernel's output is a new state: st0 is not touched); returns (abs,
    rel, the captures' max abs error, K2's launches, the kernel)."""
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


def k2_items(ker):
    """K2's launch geometry, as text: its items (the nonlinear ones), the
    x-planes of a chunk, the shared memory of the two item classes."""
    cu = ker._cuda
    smem = [f"{lay[0] * ker.dtype.itemsize / 1024:.1f}" if lay else "-"
            for lay in cu["lays"]]
    return (f"{cu['nitems']} items ({cu['nl_items']} nonlinear), x-chunk "
            f"{cu['ch']}, shared memory {smem[0]} / {smem[1]} KiB (linear "
            f"/ nonlinear items), linear blocks an SM {1 + cu['pair']}")


def nine_source_sim(mp, device, **kw):
    """A 3x3x3 cell at resolution 8 with PML 0.5 and nine Gaussian Ez point
    sources (more than the first K2 port's argument block took), on no
    lattice plane; `kw` goes to Simulation (use_fused).  The card tests and
    the CPU tests build the same scene from here."""
    spots = [(-0.8 + 0.2 * i, 0.1 * (i % 3) - 0.1, 0.07 * i - 0.3)
             for i in range(9)]
    sim = mp.Simulation(
        cell_size=mp.Vector3(3, 3, 3), resolution=8,
        sources=[mp.Source(mp.GaussianSource(1.0, fwidth=0.5),
                           component=mp.Ez, center=mp.Vector3(*at))
                 for at in spots],
        boundary_layers=[mp.PML(0.5)], device=device, **kw)
    sim.init_sim()
    return sim


def phase_nine_sources(mp, dev):
    """Phase 3's last check: a 3x3x3 cell at resolution 8 with nine current
    sources (more than the first K2 port took) through Simulation.run on
    the hybrid route (the resident route declined), against the eager
    stepper on the card, fields to 1e-5 of their maximum."""
    import numpy as np
    from meep_nl_tpu_torch.ops import resident
    sims = {}
    budget = resident.VMEM_BUDGET
    resident.VMEM_BUDGET = 0
    try:
        for fused in (True, False):
            sim = nine_source_sim(mp, dev, use_fused=fused)
            sim.run(until=2.0)
            sims[fused] = sim
    finally:
        resident.VMEM_BUDGET = budget
    sim = sims[True]
    ker = sim.plan._t2_kernel
    launches = ker.launches + (ker.k3.launches if ker.k3 else 0)
    want = sims[False].get_array(mp.Ez)
    rel = rel_diff(sim.get_array(mp.Ez), want)
    print(f"[3] nine current sources, 3x3x3 at resolution 8: routes "
          f"{dict(sim.routes)}, K2 launches {launches}; Ez against the eager "
          f"stepper: max rel {rel:.3e}", flush=True)
    if not (dict(sim.routes) == {"hybrid": 1} and launches > 0
            and rel <= 1e-5 and np.abs(want).max() > 0):
        raise AssertionError(f"the nine-source scene failed: routes "
                             f"{dict(sim.routes)}, launches {launches}, "
                             f"rel {rel:.3e}")


def ring_plain(ring):
    """The plain version of `ring.step` (a ghost ring, ops/periodicx.py):
    the refresh, then K2's plain version on each channel's extended plan,
    channel 1 reading the swapped waveform rows."""
    from meep_nl_tpu_torch.ops import fdtd3d_t2
    plains = [fdtd3d_t2.steps_ref(p, ring.depth) for p in ring.ext_plans]

    def call(states, rows):
        states = ring._refresh(states)
        return [f(s, r)[0] for f, s, r in
                zip(plains, states, (rows, ring._rows_im(rows)))]
    return call


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
    """{launch: (ms, its byte floor in ms, dynamic shared memory in KiB)}
    of each of K1's launches in one step, and of the step's launches back to
    back ("step"; the floor is then step_cost's bound), CUDA events over
    `reps` repeats from argument blocks built once (no host work between
    launches; the state's values stop mattering); a launch's floor is
    `launch_cost` at the HBM rate."""
    import torch
    from meep_nl_tpu_torch.ops import fdtd3d
    lib = fdtd3d._lib()
    floors = fdtd3d.launch_cost(ker.plan)
    fp64 = 1 if ker.dtype == torch.float64 else 0
    args = ker.launch_args(state, row)
    out = {}
    for name, kind, A in args + [("step", None, None)]:
        def fn():
            for _, k, a in (args if kind is None else [(name, kind, A)]):
                ker._launch(lib, a, k)
        fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        if kind is None:
            out[name] = (start.elapsed_time(end) / reps,
                         bound(fdtd3d.step_cost(ker.plan))[0],
                         max(v[2] for v in out.values()))
        else:
            out[name] = (start.elapsed_time(end) / reps,
                         floors[name[0]] / HBM_BYTES_PER_S * 1e3,
                         lib.mnt_k1_smem(ctypes.byref(A), kind, fp64) / 1024)
    return out


def breakdown_text(parts):
    """launch_breakdown's dict as text: each launch's ms beside its byte
    floor, the share of the floor it reaches, its shared memory."""
    return "; ".join(f"{k} {ms:.4f} ms (floor {fl:.4f} ms, {fl / ms:.0%} "
                     f"of it; {kib:.1f} KiB shared)"
                     for k, (ms, fl, kib) in parts.items())


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


def rel_each(a, b):
    """The largest of |a - b| / |b| taken element by element."""
    import numpy as np
    b = np.asarray(b)
    return float((np.abs(np.asarray(a) - b)
                  / np.maximum(np.abs(b), 1e-30)).max())


def resident_run_counted(sim, *step_funcs, nsteps=None, **run_kw):
    """sim.run with the resident kernel's counters set to 0 just before;
    returns (wall seconds, K3 launches, K4 launches), read just after.
    Fails if a stretch left the resident route or a plain step ran."""
    import torch
    ker = sim.plan._resident_kernel
    ker.launches = ker.probed_launches = ker.plain_steps = 0
    sim.routes.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if nsteps is not None:
        sim.run(*step_funcs, until=nsteps * sim.dt)
    else:
        sim.run(*step_funcs, **run_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if set(sim.routes) != {"resident"} or ker.plain_steps:
        raise AssertionError(f"run left the resident route: routes "
                             f"{dict(sim.routes)}, plain steps "
                             f"{ker.plain_steps}")
    return wall, ker.launches, ker.probed_launches


def time_resident(fn, st0, nsteps, reps=3):
    """(kernel, call): ms per step of the K3/K4 launches alone (CUDA events
    recorded just around the launch call, after the wrapper's host work
    and uploads; None when fn launches nothing) and of the whole call
    fn(state, nsteps), best of reps calls after one warm-up, each from a
    copy of st0."""
    import torch
    from meep_nl_tpu_torch.ops import resident as R
    lib, events = R._lib(), []

    class Timed:
        def __getattr__(self, name):
            return getattr(lib, name)

        def mnt_k3_launch(self, *args):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            rc = lib.mnt_k3_launch(*args)
            ev[1].record()
            events.append(ev)
            return rc

    saved, R._lib = R._lib, Timed
    try:
        fn(clone_state(st0), nsteps)
        best_k = best_c = None
        for _ in range(reps):
            st = clone_state(st0)
            events.clear()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            fn(st, nsteps)
            end.record()
            torch.cuda.synchronize()
            call = start.elapsed_time(end) / nsteps
            best_c = call if best_c is None else min(best_c, call)
            if events:
                k = sum(a.elapsed_time(b) for a, b in events) / nsteps
                best_k = k if best_k is None else min(best_k, k)
    finally:
        R._lib = saved
    return best_k, best_c


def phase_resident(mp, dev, card, blank):
    """Phases 7 and 8: the resident path (K3, K4); returns their kernel
    table entries, the ring's Harminv modes and its series on the card."""
    import numpy as np
    from meep_nl_tpu_torch.ops import resident as R
    k3 = {"name": "resident_k3", "route": "cuda",
          "source": "meep_nl_tpu_torch/csrc/resident.cu",
          "replaces": K3_REPLACES, **blank}
    k4 = {"name": "resident_k4", "route": "cuda",
          "source": "meep_nl_tpu_torch/csrc/resident.cu",
          "replaces": K4_REPLACES, **blank}
    k3["launches"] = k4["launches"] = 0
    k3["max_abs_err"] = k4["max_abs_err"] = 0.0
    # ---- 7: bench.py::run_resident's scene, 767^2 ----------------------
    n, nsteps = 767, 1000
    cells = n * n
    for flux in (False, True):
        sim, fl = resident_sim(mp, n, dev, flux)
        plan = sim.plan
        sim.run(until=24 * sim.dt)                  # warm-up: tables
        wall, launches, probed = resident_run_counted(sim, nsteps=nsteps)
        want = -(-nsteps // 1024)
        if (launches, probed, dict(sim.routes)) != (want, 0,
                                                    {"resident": want}):
            raise AssertionError(f"767^2 run: K3 launches {launches}, K4 "
                                 f"{probed}, routes {dict(sim.routes)}")
        k3["launches"] += launches
        ez = sim.get_array(mp.Ez)
        flux_v = sim.get_fluxes(fl) if flux else np.zeros(1)
        if not (np.all(np.isfinite(ez)) and np.any(ez != 0)
                and np.all(np.isfinite(flux_v))
                and (not flux or np.any(flux_v != 0))):
            raise AssertionError(f"767^2 run: output not finite/non-zero: "
                                 f"flux {flux_v}")
        label = "flux line" if flux else "no monitor"
        print(f"[7] resident 767^2, {label}: Simulation.run {nsteps} steps "
              f"in {wall:.3f} s = {wall / nsteps * 1e3:.4f} ms/step = "
              f"{cells * nsteps / wall / 1e9:.3f} GCells/s; K3 launches "
              f"{launches}, routes {dict(sim.routes)}"
              + (f"; flux {flux_v.tolist()}" if flux else "") + f" ({card})",
              flush=True)
        ker = plan._resident_kernel
        print(f"[7] K3 at 767^2 ({label}): {schedule_text(ker, 1000, False)}",
              flush=True)
        st, t_end = sim.fields_state, sim._t
        starts = [("the run's state", st)]
        if flux:
            # the pulse has not reached the flux line by t_end: a seeded
            # random state puts the DTFT's inputs at every region site
            starts.append(("a random state", random_state(plan, 11, dev)))
        for what, st0 in starts:
            err, rel, drel, _ = compare_resident(ker, st0, t_end, 20)
            print(f"[7] K3 vs plain at 767^2 ({label}) from {what}, 20 "
                  f"steps: max abs {err:.3e}, max rel {rel:.3e}"
                  + (f"; DTFT max rel {drel:.3e}" if flux else ""),
                  flush=True)
            if not (rel <= 1e-5 and drel <= 1e-5):
                raise AssertionError(f"K3 disagrees at 767^2 from {what}: "
                                     f"rel {rel:.3e}, DTFT {drel:.3e}")
            k3["max_abs_err"] = max(k3["max_abs_err"], err)
        ms, call_ms = time_resident(
            lambda s_, n_: ker._run(s_, n_, t_end, ()), st, nsteps)
        ker.launches = launches
        ref = R.resident_ref(plan)
        _, plain_ms = time_resident(lambda s_, n_: ref(s_, n_, t_end), st,
                                    20, reps=1)
        cost = R.step_cost(plan, nsteps)
        b_ms, b_by = bound({"bytes": cost["bytes"] / nsteps,
                            "ops": cost["ops"] / nsteps})
        stream_ms = cost["stream_bytes"] / HBM_BYTES_PER_S * 1e3
        print(f"[7] K3 at 767^2 ({label}): {ms:.4f} ms/step = "
              f"{cells / ms / 1e6:.3f} GCells/s over {nsteps}-step launches "
              f"(the wrapper's call, host work included: {call_ms:.4f} "
              f"ms/step); plain {plain_ms:.4f} ms/step; bound {b_ms:.5f} "
              f"ms/step "
              f"({b_by}; state in and out once per launch), a per-step "
              f"stream of state and coefficients {stream_ms:.4f} ms/step "
              f"({cost['stream_bytes'] / 2 ** 20:.1f} MiB) ({card})",
              flush=True)
        if flux:
            k3.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        del sim, st

    # ---- 8: the ring resonator, Harminv and a decay stop -----------------
    r, res = 1.0, 10
    out = {}
    for d in (dev, "cpu"):
        sim = ring_sim(mp, res, d)
        h = mp.Harminv(mp.Ez, mp.Vector3(r + 0.1), 0.15, 0.1)
        if d == "cpu":                         # the plain version
            sim.run(mp.after_sources(h), until_after_sources=300)
            out[d] = (sim, h)
            continue
        sim.init_sim()
        R._kernel(sim.plan)                   # made before the counted run
        wall, launches, probed = resident_run_counted(
            sim, mp.after_sources(h), until_after_sources=300)
        out[d] = (sim, h)
    sim, h = out[dev]
    want = -(-sim._t // 1024)
    if (launches, probed, dict(sim.routes)) != (0, want,
                                                {"resident": want}):
        raise AssertionError(f"ring Harminv run: K3 launches {launches}, K4 "
                             f"{probed}, routes {dict(sim.routes)}")
    k4["launches"] += probed
    cells = int(np.prod(sim.plan.storage_shape))
    print(f"[8] ring resolution {res} ({sim.plan.storage_shape}), "
          f"after_sources(Harminv), until_after_sources=300: {sim._t} steps "
          f"in {wall:.3f} s = {wall / sim._t * 1e3:.4f} ms/step; K4 launches "
          f"{probed}, routes {dict(sim.routes)} ({card})", flush=True)
    h_modes = list(h.modes)
    ser = {d: np.asarray(out[d][1].data) for d in out}
    srel = rel_diff(ser[dev], ser["cpu"])
    amax = max(m.amp for m in h.modes)
    print("[8] modes on the card (freq, Q, amp): " + ", ".join(
        f"({m.freq:.8f}, {m.Q:.1f}, {m.amp:.3e})" for m in h.modes),
        flush=True)
    print("[8] modes on the CPU  (freq, Q, amp): " + ", ".join(
        f"({m.freq:.8f}, {m.Q:.1f}, {m.amp:.3e})" for m in out["cpu"][1].modes),
        flush=True)
    worst = 0.0
    for m in h.modes:
        if m.amp > 1e-3 * amax:
            f = min((x.freq for x in out["cpu"][1].modes),
                    key=lambda v: abs(v - m.freq))
            worst = max(worst, abs(f - m.freq) / abs(m.freq))
    print(f"[8] Harminv series, card vs CPU: max rel {srel:.3e}; mode "
          f"frequencies (amplitude above 1e-3 of the largest): max rel "
          f"{worst:.3e}", flush=True)
    if not (srel <= 1e-4 and worst <= 1e-4 and len(h.modes) > 0):
        raise AssertionError(f"ring modes differ between card and CPU: "
                             f"series {srel:.3e}, frequencies {worst:.3e}")
    ker = sim.plan._resident_kernel
    print(f"[8] K4 at the ring: {schedule_text(ker, 1024, True)}",
          flush=True)
    st, t_end = sim.fields_state, sim._t
    probe = [sim._point_probe("hm0", mp.Ez, mp.Vector3(r + 0.1))]
    err, rel, _, serr = compare_resident(ker, st, t_end, 20, probe)
    print(f"[8] K4 vs plain at the ring's end state, 20 steps: state max abs "
          f"{err:.3e}, max rel {rel:.3e}; series max abs {serr:.3e}",
          flush=True)
    if not (rel <= 1e-5 and serr <= 1e-5 * max(np.abs(ser[dev]).max(),
                                               1e-30)):
        raise AssertionError(f"K4 disagrees: rel {rel:.3e}, series "
                             f"{serr:.3e}")
    k4["max_abs_err"] = max(err, serr)
    ms, call_ms = time_resident(
        lambda s_, n_: ker._run(s_, n_, t_end, probe), st, 1024)
    ref = R.resident_ref(sim.plan)
    _, plain_ms = time_resident(lambda s_, n_: ref(s_, n_, t_end, probe), st,
                                20, reps=1)
    cost = R.step_cost(sim.plan, 1024)
    b_ms, b_by = bound({"bytes": cost["bytes"] / 1024,
                        "ops": cost["ops"] / 1024})
    print(f"[8] K4 at the ring ({cells} cells): {ms:.4f} ms/step over "
          f"1024-step launches (the wrapper's call: {call_ms:.4f} ms/step); "
          f"plain {plain_ms:.4f} ms/step; bound "
          f"{b_ms:.5f} ms/step ({b_by}) ({card})", flush=True)
    k4.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    del out, sim, st

    stop_at = {}
    for d in (dev, "cpu"):
        sim = ring_sim(mp, res, d)
        stop = mp.stop_when_fields_decayed(50, mp.Ez, mp.Vector3(r + 0.1),
                                           1e-3)
        if d == "cpu":                         # the plain version
            sim.run(until_after_sources=stop)
            stop_at[d] = sim._t
            continue
        sim.init_sim()
        R._kernel(sim.plan)
        wall, launches, probed = resident_run_counted(
            sim, until_after_sources=stop)
        if launches or probed != sim.routes["resident"] or probed < 2:
            raise AssertionError(f"decay run: K3 launches {launches}, K4 "
                                 f"{probed}, routes {dict(sim.routes)}")
        k4["launches"] += probed
        ez = sim.get_array(mp.Ez)
        if not np.all(np.isfinite(ez)):
            raise AssertionError("decay run: fields not finite")
        stop_at[d] = sim._t
        print(f"[8] ring with until_after_sources=stop_when_fields_decayed("
              f"50, Ez, (1.1, 0), 1e-3): stopped at t = "
              f"{sim.meep_time():.1f} after {sim._t} steps in {wall:.3f} s "
              f"= {wall / sim._t * 1e3:.4f} ms/step; K4 launches {probed} "
              f"(one per 50-unit block), routes {dict(sim.routes)} ({card})",
              flush=True)
    print(f"[8] decay stop step, card {stop_at[dev]}, the same run on the "
          f"CPU {stop_at['cpu']}", flush=True)
    if stop_at[dev] != stop_at["cpu"]:
        raise AssertionError(f"decay run stops at step {stop_at[dev]} on the "
                             f"card, {stop_at['cpu']} on the CPU")
    return k3, k4, h_modes, ser[dev]


def start_cpu_twins15(tmp):
    """cpu_twins15 in a process of its own beside start_cpu_twins' (no
    card, lower priority); phase 15 reads its results.  Returns (the
    process, the .npz path)."""
    path = os.path.join(tmp, "cpu_twins15.npz")
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-twins15", path],
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    return child, path


def start_cpu_twins():
    """cpu_twins in a process of its own (no card; it lowers its own
    priority): it runs from the start of main() and phases 11-13 read its
    results.  Returns (the process, the .npz path, its directory)."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    path = os.path.join(tmp, "cpu_twins.npz")
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-twins", path],
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    return child, path, tmp


def phase_monitors(mp, dev, card, modes, main_ms, k1, k3, twins):
    """Phase 11: the DFT monitor family on the card (flux normalization,
    dft fields, energy, force, LDOS, near2far), each scene beside the same
    runs of the port on the CPU, which `twins` (start_cpu_twins) made.
    `modes`: phase 8's Harminv modes of the ring; `main_ms`: phase 4's
    ms/step.  Adds the phase's launches to the K1 and K3 table entries."""
    import numpy as np
    import torch
    from meep_nl_tpu_torch.ops import hybrid as HY
    from meep_nl_tpu_torch.ops import resident as R
    # ---- the monitored flagship 128^3 on the hybrid route ---------------
    n, res, nsteps = 128, 16.0, 602
    sim, mon = flagship_sim(mp, n, res, dev, monitors=True)
    plan = sim.plan
    sim.run(until=12 * sim.dt)                  # warm-up
    HY.hybrid_routes(plan).clear()
    wall, launches = timed_run(sim, nsteps)
    expect(launches, {"k1": nsteps * K1_LAUNCHES, "k2_d2": 0, "k2_d3": 0},
           "128^3 monitored flagship")
    k1["launches"] += launches["k1"]
    hroutes = dict(HY.hybrid_routes(plan))
    if hroutes != {"full_state": 1}:
        raise AssertionError(f"monitored flagship: hybrid routes "
                             f"{hroutes}")
    out = monitor_outputs(mp, sim, mon)
    bad = [k for k, v in out.items()
           if not (np.all(np.isfinite(v)) and np.any(v != 0))]
    if bad:
        raise AssertionError(f"monitored flagship outputs not finite or "
                             f"zero: {bad}")
    ms = wall / nsteps * 1e3
    print(f"[11] monitored flagship 128^3 ({len(plan.dfts)} DTFT "
          f"accumulators: flux, dft fields, energy with D and B, force, "
          f"LDOS, near2far): {nsteps} steps in {wall:.3f} s = "
          f"{ms:.4f} ms/step against phase 4's unmonitored "
          f"{main_ms:.4f}; routes {dict(sim.routes)}, hybrid route "
          f"{hroutes} (the full-state cycle, one K1 step each: the "
          f"energy monitor reads D and B, which K2 does not capture), "
          f"launches {launches} ({card})", flush=True)
    print(f"[11] monitored flagship: force {out['force'].tolist()}, "
          f"total energy {out['total energy'].tolist()}, LDOS "
          f"{out['ldos'].tolist()}", flush=True)
    del sim, plan, mon
    torch.cuda.empty_cache()

    child, path, _ = twins
    runs = []

    def counted(sim, **kw):
        """sim.run on the resident route, K3's launches counted."""
        sim.init_sim()
        R._kernel(sim.plan)
        wall, launches, probed = resident_run_counted(sim, **kw)
        if probed or launches != sim.routes["resident"] or not launches:
            raise AssertionError(f"K3 launches {launches}, K4 {probed}, "
                                 f"routes {dict(sim.routes)}")
        k3["launches"] += launches
        runs.append((sim, wall, launches))

    # ---- the bend-flux tutorial: T and R on the resident route ---------
    T, Rf, (_, sim1) = bend_flux(mp, dev, counted)
    b = BEND
    freqs = np.linspace(b["fcen"] - b["df"] / 2, b["fcen"] + b["df"] / 2,
                        b["nfreq"])
    for what, (sim, wall, launches) in zip(("straight", "bend"), runs):
        print(f"[11] bend flux, {what} guide ({sim.plan.storage_shape}):"
              f" {sim._t} steps in {wall:.3f} s = "
              f"{wall / sim._t * 1e3:.4f} ms/step, K3 launches "
              f"{launches}, routes {dict(sim.routes)} ({card})",
              flush=True)
    print("[11] bend flux: f, T, R, 1 - T - R", flush=True)
    for i in (4, 8, 10, 12, 16):
        print(f"[11]   {freqs[i]:.3f}  {T[i]:.4f}  {Rf[i]:.4f}  "
              f"{1 - T[i] - Rf[i]:.4f}", flush=True)
    # 44 steps hold two sample steps of the decimated flux monitors
    err, rel, drel, _ = compare_resident(
        sim1.plan._resident_kernel, sim1.fields_state, sim1._t, 44)
    print(f"[11] K3 vs plain at the bend's end state, 44 steps: max abs "
          f"{err:.3e}, max rel {rel:.3e}; DTFT max rel {drel:.3e}",
          flush=True)
    if not (rel <= 1e-5 and drel <= 1e-5):
        raise AssertionError(f"K3 disagrees at the bend: {rel:.3e}, "
                             f"DTFT {drel:.3e}")
    k3["max_abs_err"] = max(k3["max_abs_err"], err)
    del sim, sim1
    runs.clear()

    # ---- the ring's LDOS: K3 with the complex-weight DTFT --------------
    sim, ldos = ring_ldos_sim(mp, dev)
    if not any(k.endswith(":wre") for k in sim.plan.coefs):
        raise AssertionError("the LDOS monitor has no complex weights")
    counted(sim, until_after_sources=300)
    _, wall, launches = runs.pop()
    ker = sim.plan._resident_kernel
    L = sim.get_ldos(ldos)
    lf = np.asarray(ldos.freqs)
    peak = float(lf[int(np.argmax(L))])
    near = min((m.freq for m in modes), key=lambda f: abs(f - peak))
    print(f"[11] ring LDOS ({sim.plan.storage_shape}, add_ldos(0.15, "
          f"0.1, 50), until_after_sources=300): {sim._t} steps in "
          f"{wall:.3f} s = {wall / sim._t * 1e3:.4f} ms/step, K3 "
          f"launches {launches}, routes {dict(sim.routes)} ({card}); "
          f"largest peak at f = {peak:.5f}, the nearest Harminv mode "
          f"of phase 8 at {near:.5f}", flush=True)
    if not (np.all(np.isfinite(L))
            and abs(peak - near) <= lf[1] - lf[0] + 1e-12):
        raise AssertionError(f"ring LDOS peak {peak} not within a bin "
                             f"of a mode ({near})")
    st, t_end = sim.fields_state, sim._t
    err, _, drel, _ = compare_resident(ker, st, t_end, 20)
    print(f"[11] K3 vs plain at the ring's end state (complex-weight "
          f"DTFT), 20 steps: state and accumulators max abs {err:.3e}"
          f" (accumulators max rel {drel:.3e})", flush=True)
    if not err == 0.0:
        raise AssertionError(f"K3 with complex weights is not bit for "
                             f"bit: max abs {err:.3e}")
    ms, call_ms = time_resident(
        lambda s_, n_: ker._run(s_, n_, t_end, ()), st, 1024)
    cost = R.step_cost(sim.plan, 1024)
    b_ms, b_by = bound({"bytes": cost["bytes"] / 1024,
                        "ops": cost["ops"] / 1024})
    print(f"[11] K3 at the ring with the LDOS monitor: {ms:.4f} ms/step "
          f"over 1024-step launches (the wrapper's call: {call_ms:.4f} "
          f"ms/step); bound {b_ms:.5f} ms/step ({b_by}) ({card})",
          flush=True)
    del sim, st, ker

    # ---- its 16^3 twin on the card, against the CPU --------------------
    sim, mon = flagship_sim(mp, 16, 8.0, dev, pml=0.25, monitors=True)
    counted(sim, until=200 * sim.dt)
    got = monitor_outputs(mp, sim, mon)
    rc = child.wait(timeout=900)
    if rc != 0:
        raise AssertionError(f"the CPU runs failed (exit code {rc})")
    with np.load(path) as z:
        want = {k: z[k] for k in z.files}
    worst = {k: float(np.abs(v - want[f"16:{k}"]).max()
                      / max(np.abs(want[f"16:{k}"]).max(), 1e-30))
             for k, v in got.items()}
    print(f"[11] 16^3 monitored twin ({sim.plan.storage_shape}, 200 "
          f"steps, K3 launches {runs[-1][2]}), card vs CPU, max abs "
          f"error over each output's max: " + ", ".join(
              f"{k} {v:.3e}" for k, v in worst.items()), flush=True)
    if not all(v <= 1e-4 for v in worst.values()):
        raise AssertionError(f"16^3 monitors: card and CPU differ "
                             f"{worst}")
    tmax = float(np.abs(want["T"]).max())
    dT = float(np.abs(T - want["T"]).max()) / tmax
    dR = float(np.abs(Rf - want["R"]).max()) / tmax
    dL = float(np.abs(L - want["ldos"]).max()
               / np.abs(want["ldos"]).max())
    print(f"[11] card vs CPU: bend T max abs {dT:.3e} and R {dR:.3e} of "
          f"max |T|; ring LDOS {dL:.3e} of its max", flush=True)
    if not (dT <= 1e-4 and dR <= 1e-4 and dL <= 1e-4):
        raise AssertionError(f"card and CPU differ: T {dT:.3e}, R "
                             f"{dR:.3e}, LDOS {dL:.3e}")


#: per family a site of k5_plan's seam sources on a dead plane of its E/H
#: component
K5_DEAD_SITES = {"ez": (0, 20, 20), "hz": (20, 20, 0)}


def k5_seam_sites():
    """Sites on both sides of the first and second y seams and the first z
    seam of the loaded library's y-z tile, on chunk edges (a chunk is one
    plane at 64^3), the second one listed twice."""
    from meep_nl_tpu_torch.ops import fused
    ty, tz = fused._lib().mnt_tile
    return [(20, ty - 1, tz - 1), (20, ty, tz), (21, ty, tz - 1),
            (21, ty - 1, tz), (30, 2 * ty - 1, tz - 1), (30, 2 * ty, tz),
            (20, ty, tz)]


def k5_plan(mp, n, device, dtype, ball, pad, seams=False):
    """A 3D plan for K5 from numpy inputs: an (n / 8)^3 cell at resolution
    8, PML 1 on every face, a Gaussian Ez point source (f 1, fwidth 0.5) at
    (-0.35 L, 0.01 L, 0), with `ball` chi1inv 0.25 (eps 4) inside a sphere
    of radius L / 4, the storage padded to multiples of `pad`; use_pallas.
    `seams`: also mu = 2 in the ball, and per family (Ez, Hz) a current
    source with seeded complex amplitudes on `k5_seam_sites` and the
    family's dead site, and a second one (another frequency) on two of
    those sites."""
    import numpy as np
    from meep_nl_tpu_torch.stepper import plan as P
    res, L = 8.0, n / 8.0
    gv = mp.GridVolume.create("3d", [L, L, L], res)
    chi1inv = {}
    comps = ("ex", "ey", "ez") if ball else ()
    for c in comps + (("hx", "hy", "hz") if seams else ()):
        xx, yy, zz = np.meshgrid(*[gv.comp_coords(c, a) - L / 2
                                   for a in range(3)], indexing="ij")
        chi1inv[c] = {c[1]: np.where(
            xx * xx + yy * yy + zz * zz < (L / 4) ** 2, 0.25, 1.0)}
    pts = gv.interp_weights("ez", [-0.35 * L + L / 2, 0.01 * L + L / 2,
                                   L / 2])
    srcs = [P.SrcVolSpec("ez", np.array([p for p, w in pts], np.int32),
                         np.array([w * res ** 3 for p, w in pts],
                                  np.complex128),
                         mp.GaussianSource(frequency=1.0, fwidth=0.5))]
    rng = np.random.default_rng(11)
    seam = k5_seam_sites() if seams else []
    for comp in ("ez", "hz") if seams else ():
        for sites, freq in ((seam + [K5_DEAD_SITES[comp]], 1.0),
                            (seam[1:5:3], 0.8)):
            amps = 50.0 * (rng.standard_normal(len(sites))
                           + 1j * rng.standard_normal(len(sites)))
            srcs.append(P.SrcVolSpec(
                comp, np.array(sites, np.int32), amps,
                mp.GaussianSource(frequency=freq, fwidth=0.5)))
    plan = P.compile_plan(gv, P.MaterialSpec(chi1inv=chi1inv),
                          pmls=[P.PMLSpec(d, 1.0) for d in "xyz"],
                          sources=srcs, pad_to_multiple=pad, dtype=dtype,
                          device=device)
    plan.use_pallas = True
    return plan


def k5_counts(plan):
    """{label: (CUDA launches, plain calls)} of the plan's K5 objects."""
    ker = plan.__dict__.get("_fused_kernels", {})
    return {k: (v.launches, v.plain_steps) for k, v in ker.items()
            if v is not None}


def k5_reset(plan):
    from meep_nl_tpu_torch.ops import fused
    for v in fused.kernels_of(plan).values():
        if v is not None:
            v.launches = v.plain_steps = 0


def compare_k5(plan, st0, t0, nsteps):
    """The K5 step (both half-step launches, each with its sources) against
    its plain version (half_step_ref and the fix-ups' scatter-adds) over
    nsteps from state st0 at step t0; the launches are not counted.  Fails
    if no step of the window injects a current; returns (max abs error,
    relative)."""
    import numpy as np
    from meep_nl_tpu_torch.ops import fused
    from meep_nl_tpu_torch.stepper.step import build_xs, make_step, xs_rows
    xs = build_xs(plan, nsteps, t0)
    if not any(np.any(v != 0) for k, v in xs.items() if ":cur_" in k):
        raise AssertionError(f"no source current in steps {t0}..")
    rows = xs_rows(plan, xs)
    before = k5_counts(plan)
    step, ref = make_step(plan, dft=False), fused.step_ref(plan)
    sk, sr = clone_state(st0), clone_state(st0)
    for row in rows:
        sr = ref(sr, row)
        sk = step(sk, row)
    got = k5_counts(plan)
    launched = {k: got[k][0] - before.get(k, (0, 0))[0] for k in got}
    if launched["b"] != nsteps or launched["d"] != nsteps or any(
            got[k][1] != before.get(k, (0, 0))[1] for k in got):
        raise AssertionError(f"K5 comparison did not run the kernels: "
                             f"{launched}")
    for k, v in plan._fused_kernels.items():
        if v is not None:
            v.launches, v.plain_steps = before.get(k, (0, 0))
    return state_error(sk, sr)


def k5_ok(plan, err, rel):
    """K5's agreement with its plain version: bit for bit in fp32, 1e-12
    relative in fp64."""
    import numpy as np
    return err == 0.0 if plan.dtype == np.float32 else rel <= 1e-12


def phase_k5_compare(mp, dev):
    """Phase 3 (K5): K5 against its plain version at 64^3 from a seeded
    random state, 20 steps with the source near its peak, bit for bit in
    fp32 (1e-12 in fp64); returns the max abs error."""
    import numpy as np
    worst = 0.0
    seams = ("eps=4 and mu=2 ball, Ez and Hz sources on tile seams and "
             "chunk edges, repeated, shared and on dead planes")
    for label, dtype, ball, pad, seam in (
            ("vacuum uPML fp32", np.float32, False, (8, 1, 1), False),
            ("vacuum uPML fp64", np.float64, False, (8, 1, 1), False),
            ("eps=4 ball, padded (8, 8, 128)", np.float32, True,
             (8, 8, 128), False),
            (seams + ", fp32", np.float32, True, (1, 1, 1), True),
            (seams + ", fp64", np.float64, True, (1, 1, 1), True)):
        plan = k5_plan(mp, 64, dev, dtype, ball, pad, seams=seam)
        err, rel = compare_k5(plan, random_state(plan, 7, dev), 150, 20)
        print(f"[3] K5 vs plain, {label} (storage {plan.storage_shape}, "
              f"{len(plan.sources)} sources) x 20 steps: max abs {err:.3e}, "
              f"max rel {rel:.3e}", flush=True)
        if not k5_ok(plan, err, rel):
            raise AssertionError(f"K5 disagrees with its plain version "
                                 f"({label}): max abs {err:.3e}, rel "
                                 f"{rel:.3e}")
        worst = max(worst, err)
    return worst


def k5_run_counted(sim, nsteps):
    """sim.run for nsteps with the K5 counters set to 0 just before;
    returns (wall seconds, K5 launches of the two halves, fix-up launches
    (0: each half's launch adds its sources)), read just after.  Fails unless every stretch was a "half_step" stretch
    and no plain version ran."""
    import torch
    k5_reset(sim.plan)
    sim.routes.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(until=nsteps * sim.dt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = k5_counts(sim.plan)
    if set(sim.routes) != {"half_step"} or any(p for _, p in counts.values()):
        raise AssertionError(f"use_pallas run left the K5 route: routes "
                             f"{dict(sim.routes)}, counts {counts}")
    fix = sum(counts[k][0] for k in ("fix_b", "fix_d") if k in counts)
    return wall, counts["b"][0] + counts["d"][0], fix


def k5_launch_times(plan, st, row, reps=20):
    """({"b", "d", "step": ms}, geometry text): K5's launches alone, each
    half's launch and the step's two back to back, CUDA events over `reps`
    repeats from argument blocks built beforehand for state `st` with the
    sources of `row` (no host work between launches; the state's values
    stop mattering)."""
    import torch
    from meep_nl_tpu_torch.ops import fused
    lib = fused._lib()
    ker = fused.kernels_of(plan)
    blocks = []
    f, fu, fw = st["f"], st["f_u"], st["f_w"]
    for h in (ker["b"], ker["d"]):
        A, (f, fu, fw) = h.launch_args(f, fu, fw, row)
        B = fused._K5Args()
        ctypes.pointer(B)[0] = A
        blocks.append((h, B))
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name, which in (("b", blocks[:1]), ("d", blocks[1:]),
                        ("step", blocks)):
        def fn():
            for h, B in which:
                rc = lib.mnt_k5_half(ctypes.byref(B), h.is_d, h.fp64, stream)
                if rc != 0:
                    raise RuntimeError(f"K5 launch failed: cudaError {rc}")
        fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out[name] = start.elapsed_time(end) / reps
    h, B = blocks[0]
    geo = (f"tile {lib.mnt_tile}, chunk {B.ch} planes, "
           f"{B.nch * B.nty * B.ntz} blocks, "
           f"{lib.mnt_k5_smem(ctypes.byref(B), h.fp64) / 1024:.1f} KiB "
           f"dynamic shared memory")
    return out, geo


def k5_times(plan, st, t_end, card, label, cells):
    """Phase 9's timing of K5 from the run's state: its launches alone
    (k5_launch_times), the wrapper's two calls (with the step's sources),
    the whole use_pallas step and the plain version, CUDA events; prints
    them beside the bound (GCells/s of `cells`, the scene's true cells)
    and returns (launches-alone ms, plain ms)."""
    from meep_nl_tpu_torch.ops import fused
    from meep_nl_tpu_torch.stepper.step import build_xs, make_step, xs_rows
    ker = fused.kernels_of(plan)
    rows = xs_rows(plan, build_xs(plan, 13, t_end))
    counts = k5_counts(plan)

    def wrapper(s_, row):
        f, fu, fw = ker["b"](s_["f"], s_["f_u"], s_["f_w"], row)
        f, fu, fw = ker["d"](f, fu, fw, row)
        return {**s_, "f": f, "f_u": fu, "f_w": fw}

    alone, geo = k5_launch_times(plan, clone_state(st), rows[0])
    wrap_ms, _ = time_steps(wrapper, clone_state(st), rows)
    step_ms, _ = time_steps(make_step(plan), clone_state(st), rows)
    plain_ms, _ = time_steps(fused.step_ref(plan), clone_state(st), rows[:6])
    for k, v in ker.items():
        if v is not None:
            v.launches, v.plain_steps = counts[k]
    cost = fused.step_cost(plan)
    b_ms, b_by = bound(cost)
    print(f"[9] K5 at {label} (storage {plan.storage_shape}): launches alone "
          f"from argument blocks built beforehand {alone['step']:.4f} "
          f"ms/step = {cells / alone['step'] / 1e6:.3f} GCells/s (B half "
          f"{alone['b']:.4f}, D half {alone['d']:.4f}); the wrapper's two "
          f"calls {wrap_ms:.4f} ms/step; the whole use_pallas step "
          f"{step_ms:.4f} ms/step; plain version {plain_ms:.4f} ms/step; "
          f"bound {b_ms:.4f} ms ({b_by}, {cost['bytes'] / 1e9:.3f} GB per "
          f"step; {b_ms / alone['step']:.0%} of it); {geo} "
          f"({card})", flush=True)
    return alone["step"], plain_ms


def phase_use_pallas(mp, dev, card, fluxes96, k5):
    """Phase 9: Simulation(use_pallas=True, use_fused=False) at 255^3
    vacuum (50 steps, no monitor) and at the 96^3 linear monitored scene
    (its fluxes against the plain stepper's, beside phase 5's K2 route's
    `fluxes96`); fills the K5 entry."""
    import numpy as np
    import torch
    from meep_nl_tpu_torch.ops import fused
    n, res, nsteps = 255, 16.0, 50
    cells = n ** 3
    sim, _ = flagship_sim(mp, n, res, dev, flux=False, ball=False,
                          use_pallas=True, use_fused=False)
    plan = sim.plan
    sim.run(until=9 * sim.dt)                       # warm-up
    wall, launches, fix = k5_run_counted(sim, nsteps)
    if (launches, fix, dict(sim.routes)) != (2 * nsteps, 0,
                                             {"half_step": 1}):
        raise AssertionError(f"255^3 use_pallas run: K5 launches {launches}, "
                             f"fix-up {fix}, routes {dict(sim.routes)}")
    k5["launches"] = launches
    ez = sim.get_array(mp.Ez)
    if not (np.all(np.isfinite(ez)) and np.any(ez != 0)):
        raise AssertionError("255^3 use_pallas run: Ez not finite/non-zero")
    print(f"[9] vacuum uPML 255^3 Simulation(use_pallas=True, use_fused="
          f"False).run: {nsteps} steps in {wall:.3f} s = "
          f"{wall / nsteps * 1e3:.4f} ms/step = "
          f"{cells * nsteps / wall / 1e9:.3f} GCells/s; K5 launches "
          f"{launches} (2 a step), fix-up launches {fix}, routes "
          f"{dict(sim.routes)} ({card})", flush=True)
    st, t_end = sim.fields_state, sim._t
    err, rel = compare_k5(plan, st, t_end, 5)
    print(f"[9] K5 vs plain at 255^3 from the run's state, 5 steps: max abs "
          f"{err:.3e}, max rel {rel:.3e}", flush=True)
    if not k5_ok(plan, err, rel):
        raise AssertionError(f"K5 disagrees at 255^3: max abs {err:.3e}")
    k5["max_abs_err"] = max(k5["max_abs_err"], err)
    k5["ms"], k5["plain_ms"] = k5_times(plan, st, t_end, card, "255^3",
                                        cells)
    k5["bound_ms"], k5["bound_by"] = bound(fused.step_cost(plan))
    del sim, st

    n, nsteps, dec = 96, 300, 5
    sim, fl = flagship_sim(mp, n, res, dev, linear=True, decimation=dec,
                           use_pallas=True, use_fused=False)
    sim.run(until=10 * sim.dt)                      # as phase 5
    wall, launches, fix = k5_run_counted(sim, nsteps)
    if (launches, fix) != (2 * nsteps, 0):
        raise AssertionError(f"96^3 use_pallas run: K5 launches {launches}, "
                             f"fix-up {fix}")
    k5["launches"] += launches
    flux = sim.get_fluxes(fl)
    # the same scene through the plain stepper with the full-grid chains,
    # which the K5 route follows; this scene's source (x = -2.1) lies in
    # the x-PML slab, where the K2 route's slab-local chains give other
    # fields, in the reference too (ROADMAP C)
    ref, fl_ref = flagship_sim(mp, n, res, dev, linear=True, decimation=dec,
                               use_fused=False)
    ref.run(until=10 * ref.dt)
    ref.run(until=nsteps * ref.dt)
    if dict(ref.routes) != {"eager": 2}:
        raise AssertionError(f"96^3 reference run: routes {dict(ref.routes)}")
    fdiff = rel_diff(flux, ref.get_fluxes(fl_ref))
    k2diff = rel_diff(flux, fluxes96)
    print(f"[9] linear monitored 96^3, decimation {dec}, use_pallas: "
          f"{nsteps} steps, {wall / nsteps * 1e3:.4f} ms/step, K5 launches "
          f"{launches}, fix-up {fix}, routes {dict(sim.routes)}; flux "
          f"{flux.tolist()}; against the plain stepper's full-grid chains: "
          f"max rel {fdiff:.3e}; against phase 5's K2 cycle route "
          f"(slab-local chains, the source inside the x-PML slab): max rel "
          f"{k2diff:.3e} ({card})", flush=True)
    if not (fdiff <= 1e-4 and np.any(flux != 0)):
        raise AssertionError(f"96^3 use_pallas fluxes differ from the plain "
                             f"stepper's by {fdiff:.3e}")
    del ref
    plan, st, t_end = sim.plan, sim.fields_state, sim._t
    err, rel = compare_k5(plan, st, t_end, 5)
    k5["max_abs_err"] = max(k5["max_abs_err"], err)
    print(f"[9] K5 vs plain at 96^3 linear from the run's state, 5 steps: "
          f"max abs {err:.3e}, max rel {rel:.3e}", flush=True)
    if not k5_ok(plan, err, rel):
        raise AssertionError(f"K5 disagrees at 96^3: max abs {err:.3e}")
    k5_times(plan, st, t_end, card, "96^3 linear monitored", n ** 3)
    del sim, st
    torch.cuda.empty_cache()


def phase_fused_probed(mp, dev, card):
    """Phase 10: the 128^3 flagship without its flux plane, run(after_
    sources(Harminv(Ez, (0.3, 0.2, 0.1), 1, 1)), until_after_sources=50):
    every probed stretch through fused_probed_run (K4 declines the doubled
    state); then 100 steps of fused_probed_run against the eager stepper
    from the end state.  Returns K1's launches in the run."""
    import numpy as np
    import torch
    from meep_nl_tpu_torch.ops import hybrid as HY
    from meep_nl_tpu_torch.ops import resident as R
    from meep_nl_tpu_torch.stepper import step as S
    from meep_nl_tpu_torch.stepper.step import build_xs, xs_rows
    sim, _ = flagship_sim(mp, 128, 16.0, dev, flux=False)
    plan = sim.plan
    if R.resident_supported(plan):
        raise AssertionError("the resident route would take the 128^3 scene")
    k1 = HY._get_kernel(plan)._k1            # made before the counted run
    pt = mp.Vector3(0.3, 0.2, 0.1)
    h = mp.Harminv(mp.Ez, pt, 1.0, 1.0)
    k1.launches = k1.plain_steps = 0
    sim.routes.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(mp.after_sources(h), until_after_sources=50)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    nsteps = sim._t
    if set(sim.routes) != {"fused_probed"} or k1.plain_steps \
            or k1.launches != K1_LAUNCHES * nsteps:
        raise AssertionError(f"128^3 Harminv run: routes {dict(sim.routes)}, "
                             f"K1 launches {k1.launches}, plain "
                             f"{k1.plain_steps}")
    launches = k1.launches
    data = np.asarray(h.data)
    if not (np.all(np.isfinite(data)) and np.any(data != 0)
            and len(h.modes) > 0):
        raise AssertionError(f"128^3 Harminv run: series or modes empty "
                             f"({len(h.modes)} modes)")
    st, t_end = sim.fields_state, sim._t
    rows = xs_rows(plan, build_xs(plan, 23, t_end))
    k1_ms, _ = time_steps(k1.step, clone_state(st), rows)
    dev_ms = launch_breakdown(k1, clone_state(st), rows[0])["step"][0]
    k1.launches, k1.plain_steps = launches, 0
    print(f"[10] flagship 128^3 (no flux plane), run(after_sources(Harminv("
          f"Ez, (0.3, 0.2, 0.1), 1, 1)), until_after_sources=50): {nsteps} "
          f"steps in {wall:.3f} s = {wall / nsteps * 1e3:.4f} ms/step; routes "
          f"{dict(sim.routes)}, K1 launches {launches}; K1 {k1_ms:.4f} "
          f"ms/step = {k1_ms / (wall / nsteps * 1e3) * 100:.1f} % of the wall "
          f"(its three launches back to back, no host work between them: "
          f"{dev_ms:.4f} ms/step) ({card})", flush=True)
    print("[10] modes (freq, Q, amp): " + ", ".join(
        f"({m.freq:.8f}, {m.Q:.1f}, {m.amp:.3e})" for m in h.modes),
        flush=True)
    probe = [sim._point_probe("hm0", mp.Ez, pt)]
    sk, yk = HY.fused_probed_run(plan, clone_state(st), 100, t_end, probe)
    sr, yr = S.run(plan, clone_state(st), 100, t0=t_end, probes=probe)
    serr = float((yk["hm0"] - yr["hm0"]).abs().max())
    scale = float(yr["hm0"].abs().max())
    err, rel = state_error(sk, sr)
    k1.launches, k1.plain_steps = launches, 0
    print(f"[10] fused_probed_run vs the eager stepper, 100 steps from the "
          f"end state: series max abs {serr:.3e} (max {scale:.3e}), state "
          f"max abs {err:.3e}, max rel {rel:.3e}", flush=True)
    if not (scale > 0 and serr == 0.0 and err == 0.0):
        raise AssertionError(f"fused_probed_run is not bit for bit with the "
                             f"eager stepper: series {serr:.3e}, state "
                             f"{err:.3e}")
    del sim, st, sk, sr
    torch.cuda.empty_cache()
    return launches, max(err, serr)


def resident_counted_check(sim, what, card, k3, nsteps, tag="12"):
    """Phases 12's and 13's (`tag`) K3 runs: sim.run for nsteps on the
    resident route (K3 launches counted into the table entry k3), then K3
    against its plain version over 20 steps from the run's end state and
    from a seeded random state, state and accumulators bit for bit.
    Returns (the kernel object, the run's wall seconds)."""
    sim.init_sim()
    from meep_nl_tpu_torch.ops import resident as R
    R._kernel(sim.plan)
    wall, launches, probed = resident_run_counted(sim, nsteps=nsteps)
    if probed or launches != sim.routes["resident"] or not launches:
        raise AssertionError(f"{what}: K3 launches {launches}, K4 {probed}, "
                             f"routes {dict(sim.routes)}")
    k3["launches"] += launches
    ker = sim.plan._resident_kernel
    folds = f"rot2 {sim.plan.rot2}" if sim.plan.rot2 else \
        f"rot4 {sim.plan.rot4}" if sim.plan.rot4 else \
        f"node mirrors {sim.plan.mirror_node}"
    print(f"[{tag}] {what} ({sim.plan.storage_shape}, {folds}): "
          f"{nsteps} steps in {wall:.3f} s = "
          f"{wall / nsteps * 1e3:.4f} ms/step, K3 launches {launches}, "
          f"routes {dict(sim.routes)}; {schedule_text(ker, nsteps, False)} "
          f"({card})", flush=True)
    for label, st0 in (("the run's state", sim.fields_state),
                       ("a random state", random_state(sim.plan, 17,
                                                       sim.plan.device))):
        err, rel, drel, _ = compare_resident(ker, st0, sim._t, 20)
        print(f"[{tag}] K3 vs plain, {what}, from {label}, 20 steps: state "
              f"and accumulators max abs {err:.3e} (DTFT max rel "
              f"{drel:.3e})", flush=True)
        if not err == 0.0:
            raise AssertionError(f"K3 is not bit for bit ({what}, from "
                                 f"{label}): max abs {err:.3e}")
    return ker, wall


def phase_mirror(mp, dev, card, main_ms, ring8, kers, twins):
    """Phase 12: Mirror symmetry.  `main_ms`: phase 4's ms/step; `ring8`:
    phase 8's ring series and modes on the card; `kers`: the K1-K4 table
    entries, to which the phase adds its launches; `twins`: the CPU runs
    (start_cpu_twins), which phase 11 has waited for."""
    import numpy as np
    import torch
    from meep_nl_tpu_torch.ops import hybrid as HY
    from meep_nl_tpu_torch.ops import resident as R
    from meep_nl_tpu_torch.stepper.step import build_xs, xs_rows
    k1, k2, k3, k4 = kers
    # ---- 12.1: K1 and K2 on folded plans at 64^3 ------------------------
    for label, syms, mn in (
            ("y and z", [mp.Mirror(mp.Y), mp.Mirror(mp.Z)],
             ((1, "y", 1), (2, "z", 1))),
            ("y", [mp.Mirror(mp.Y)], ((1, "y", 1),))):
        sim, _ = flagship_sim(mp, 64, 8.0, dev, src_comp=mp.Ex, src_y=0.0,
                              symmetries=syms)
        plan = sim.plan
        if plan.mirror_node != mn:
            raise AssertionError(f"64^3 fold on {label}: node mirrors "
                                 f"{plan.mirror_node}")
        err, rel, launches = compare_k1(plan, 20, 7, dev)
        print(f"[12] K1 vs plain, flagship 64^3 folded on {label} "
              f"({plan.storage_shape}) x 20 steps: max abs {err:.3e}, "
              f"launches {launches}", flush=True)
        if not (err == 0.0 and launches == 20 * K1_LAUNCHES):
            raise AssertionError(f"K1 is not bit for bit on the fold "
                                 f"({label}): max abs {err:.3e}")
        caps = flux_planes(plan)
        for depth in (2, 3):
            err, rel, cerr, launches, ker = compare_k2(
                plan, depth, 6, random_state(plan, 7, dev), 150, caps)
            print(f"[12] K2 depth {depth} vs plain, 64^3 folded on {label}"
                  f" x 6 calls, {len(ker.captures)} capture planes: state "
                  f"max abs {err:.3e}, captures max abs {cerr:.3e}; "
                  f"launches {launches}; {k2_items(ker)}", flush=True)
            if not (err == 0.0 and cerr == 0.0
                    and launches == 6 * ker.launches_per_call):
                raise AssertionError(f"K2 depth {depth} is not bit for bit "
                                     f"on the fold ({label}): {err:.3e}, "
                                     f"captures {cerr:.3e}")
        del sim, plan

    # ---- 12.2: the main path, folded to a quarter cell ------------------
    n, res, nsteps = 128, 16.0, 602
    sim, fl = flagship_sim(mp, n, res, dev, src_y=0.0,
                           symmetries=fold_main(mp))
    plan = sim.plan
    if tuple(plan.storage_shape) != (136, 65, 65):
        raise AssertionError(f"folded storage {plan.storage_shape}")
    sim.run(until=12 * sim.dt)                      # warm-up
    HY.hybrid_routes(plan).clear()
    wall, launches = timed_run(sim, nsteps)
    kp = path_kernels(plan)
    k2_per = kp["k2_cap_d3"].launches_per_call
    expect(launches, {"k2_cap_d3": nsteps // 3 * k2_per,
                      "k1": nsteps % 3 * K1_LAUNCHES, "k2_d2": 0,
                      "k2_d3": 0}, "folded 128^3 flagship")
    if dict(HY.hybrid_routes(plan)) != {"capture": 1}:
        raise AssertionError(f"folded flagship: hybrid routes "
                             f"{dict(HY.hybrid_routes(plan))}")
    k1["launches"] += launches["k1"]
    k2["launches"] += launches["k2_cap_d3"]
    flux, ez = sim.get_fluxes(fl), sim.get_array(mp.Ez)
    if not (np.all(np.isfinite(ez)) and np.all(np.isfinite(flux))
            and np.any(flux != 0)):
        raise AssertionError(f"folded main path: flux {flux}")
    cells = int(np.prod(sim.gv.num))
    ms = wall / nsteps * 1e3
    print(f"[12] main path folded (Mirror(Y), Mirror(Z, phase=-1): "
          f"{sim.gv.num} cells, storage {plan.storage_shape}): {nsteps} "
          f"steps in {wall:.3f} s = {ms:.4f} ms/step against phase 4's "
          f"full cell {main_ms:.4f} ms/step; {cells * nsteps / wall / 1e9:.3f}"
          f" GCells/s of the folded cell's {cells} cells; capture route: "
          f"{nsteps // 3} K2 capture calls ({k2_per} launches each) + "
          f"{nsteps % 3} K1 steps, launches {launches}; flux "
          f"{flux.tolist()} ({card})", flush=True)
    st, t_end = sim.fields_state, sim._t
    err, rel = compare_k1_from(plan, kp["k1"], st, t_end)
    print(f"[12] K1 vs plain on the folded 128^3 from its end state, 5 "
          f"steps: max abs {err:.3e}", flush=True)
    if not err == 0.0:
        raise AssertionError(f"K1 is not bit for bit on the folded 128^3: "
                             f"{err:.3e}")
    caps = flux_planes(plan)
    for d in (2, 3):
        err, rel, cerr, _, ker = compare_k2(plan, d, 2, st, t_end, caps)
        print(f"[12] K2 depth {d} vs plain on the folded 128^3 from its end "
              f"state, 2 calls: state max abs {err:.3e}, captures "
              f"{cerr:.3e}; {k2_items(ker)}", flush=True)
        if not (err == 0.0 and cerr == 0.0):
            raise AssertionError(f"K2 depth {d} is not bit for bit on the "
                                 f"folded 128^3: {err:.3e}, {cerr:.3e}")
    rows = xs_rows(plan, build_xs(plan, 36, t_end))
    ms2, _ = time_steps(kp["k2_cap_d3"].step, clone_state(st), rows, per=3)
    ms1, _ = time_steps(kp["k1"].step, clone_state(st), rows[:11])
    print(f"[12] on the folded 128^3: K2 depth 3 + captures {ms2:.4f} "
          f"ms/call = {ms2 / 3:.4f} ms/step, K1 {ms1:.4f} ms/step ({card})",
          flush=True)
    del sim, st, kp
    torch.cuda.empty_cache()
    # its 16^3 twin, on the card (resident route) and on the CPU (twins)
    sim, fl = flagship_sim(mp, 16, 8.0, dev, pml=0.25, src_y=0.0,
                           symmetries=fold_main(mp))
    resident_counted_check(sim, "folded 16^3 flagship twin", card, k3, 200)
    child, path, _ = twins
    if child.wait(timeout=900) != 0:
        raise AssertionError("the CPU runs failed")
    with np.load(path) as z:
        want = {k: z[k] for k in z.files}
    dflux = rel_diff(sim.get_fluxes(fl), want["m16:flux"])
    dez = rel_diff(sim.get_array(mp.Ez), want["m16:ez"])
    print(f"[12] folded 16^3 twin, card vs CPU: flux max rel {dflux:.3e}, "
          f"unfolded Ez {dez:.3e}", flush=True)
    if not (dflux <= 1e-4 and dez <= 1e-4):
        raise AssertionError(f"folded 16^3: card and CPU differ: flux "
                             f"{dflux:.3e}, Ez {dez:.3e}")
    del sim

    # ---- 12.3: physics on the card, folded against the full cell -------
    out = {}
    for label, syms in (("full", []), ("folded", fold_main(mp))):
        sim, fl = flagship_sim(mp, n, res, dev, src_y=0.0, linear=True,
                               symmetries=syms)
        sim.run(until=nsteps * sim.dt)
        if set(sim.routes) != {"hybrid"}:
            raise AssertionError(f"linear {label}: routes {dict(sim.routes)}")
        L = n / res
        out[label] = (sim.get_fluxes(fl), sim.get_array(
            mp.Ez, center=mp.Vector3(), size=mp.Vector3(L, L, L)))
        del sim
        torch.cuda.empty_cache()
    dflux = rel_diff(out["folded"][0], out["full"][0])
    dez = rel_diff(out["folded"][1], out["full"][1])
    print(f"[12] linear 128^3, {nsteps} steps, folded (quarter cell) vs full "
          f"cell: fluxes max rel {dflux:.3e} ({out['full'][0].tolist()}), "
          f"unfolded Ez max abs over max {dez:.3e}", flush=True)
    if not (dflux <= 1e-4 and dez <= 1e-4
            and out["folded"][1].shape == out["full"][1].shape):
        raise AssertionError(f"folded and full cells differ: flux "
                             f"{dflux:.3e}, Ez {dez:.3e}")
    del out

    # ---- 12.4: Meep's ring.py as published, Mirror(Y) ------------------
    def ring_harminv(nudge, syms):
        sim = ring_sim(mp, 10, dev, nudge, symmetries=syms)
        h = mp.Harminv(mp.Ez, mp.Vector3(1.1), 0.15, 0.1)
        sim.init_sim()
        R._kernel(sim.plan)
        wall, launches, probed = resident_run_counted(
            sim, mp.after_sources(h), until_after_sources=300)
        if launches or probed != sim.routes["resident"] or not probed:
            raise AssertionError(f"ring: K3 {launches}, K4 {probed}, "
                                 f"routes {dict(sim.routes)}")
        k4["launches"] += probed
        return sim, h, wall, probed

    def against(ser, modes, series0, modes0):
        """(series max rel, strong modes' frequencies max rel) of a run
        against another."""
        srel = rel_diff(ser, series0) if ser.shape == series0.shape \
            else np.inf
        amax = max(m.amp for m in modes0)
        worst = 0.0
        for m in modes0:
            if m.amp > 1e-3 * amax:
                f = min((x.freq for x in modes), key=lambda v: abs(v - m.freq))
                worst = max(worst, abs(f - m.freq) / abs(m.freq))
        return srel, worst

    series8, modes8 = ring8
    sim, h, wall, probed = ring_harminv(0.0, [mp.Mirror(mp.Y)])
    srel, worst = against(np.asarray(h.data), h.modes, series8, modes8)
    print(f"[12] ring.py with Mirror(Y) ({sim.plan.storage_shape}): "
          f"{sim._t} steps in {wall:.3f} s = {wall / sim._t * 1e3:.4f} "
          f"ms/step, K4 launches {probed}, routes {dict(sim.routes)} "
          f"({card}); against phase 8's full cell (not exactly y-symmetric "
          f"at 8 eps sites on the outer surface, ring_sim): Harminv series "
          f"max rel {srel:.3e}, strong modes' frequencies max rel "
          f"{worst:.3e}", flush=True)
    print("[12] modes (freq, Q, amp): " + ", ".join(
        f"({m.freq:.8f}, {m.Q:.1f}, {m.amp:.3e})" for m in h.modes),
        flush=True)
    # the fold against the full cell where the full cell is exactly
    # y-symmetric: the radii 1e-9 larger, both through K4
    runs = {}
    for label, syms in (("full", []), ("folded", [mp.Mirror(mp.Y)])):
        s_, h_, _, _ = ring_harminv(1e-9, syms)
        runs[label] = (np.asarray(h_.data), h_.modes)
        del s_
    srel_n, worst_n = against(*runs["folded"], *runs["full"])
    print(f"[12] the ring with radii + 1e-9 (exactly y-symmetric), folded "
          f"against full, both through K4: Harminv series max rel "
          f"{srel_n:.3e}, strong modes' frequencies max rel {worst_n:.3e}",
          flush=True)
    if not (srel_n <= 1e-4 and worst_n <= 1e-4):
        raise AssertionError(f"folded ring differs from the full cell: "
                             f"series {srel_n:.3e}, modes {worst_n:.3e}")
    ker = sim.plan._resident_kernel
    st, t_end = sim.fields_state, sim._t
    probe = [sim._point_probe("hm0", mp.Ez, mp.Vector3(1.1))]
    err, _, _, serr = compare_resident(ker, st, t_end, 20, probe)
    print(f"[12] K4 vs plain at the folded ring's end state, 20 steps: "
          f"state max abs {err:.3e}, series max abs {serr:.3e}", flush=True)
    if not (err == 0.0 and serr == 0.0):
        raise AssertionError(f"K4 is not bit for bit on the folded ring: "
                             f"{err:.3e}, series {serr:.3e}")
    ms, call_ms = time_resident(
        lambda s_, n_: ker._run(s_, n_, t_end, probe), st, 1024)
    print(f"[12] K4 at the folded ring: {ms:.4f} ms/step over 1024-step "
          f"launches (the wrapper's call: {call_ms:.4f} ms/step); "
          f"{schedule_text(ker, 1024, True)} ({card})", flush=True)
    del sim, st
    sim = ring_sim(mp, 10, dev, symmetries=[mp.Mirror(mp.Y)])
    sim.init_sim()
    R._kernel(sim.plan)
    wall, launches, probed = resident_run_counted(
        sim, until_after_sources=ring_decay(mp))
    if launches or probed != sim.routes["resident"] or probed < 2:
        raise AssertionError(f"folded ring decay: K3 {launches}, K4 "
                             f"{probed}, routes {dict(sim.routes)}")
    k4["launches"] += probed
    print(f"[12] folded ring, stop_when_fields_decayed: stopped after "
          f"{sim._t} steps in {wall:.3f} s = {wall / sim._t * 1e3:.4f} "
          f"ms/step, K4 launches {probed}; the CPU twin stopped after "
          f"{int(want['ring_m_stop'])} ({card})", flush=True)
    if sim._t != int(want["ring_m_stop"]):
        raise AssertionError(f"folded ring decay stops at {sim._t} on the "
                             f"card, {int(want['ring_m_stop'])} on the CPU")
    del sim

    # ---- 12.5: K3 on folded 2D and 3D plans ----------------------------
    sim, fl = resident_sim(mp, 767, dev, flux=True,
                           symmetries=[mp.Mirror(mp.Y)])
    if sim.plan.mirror_node or sim._boundaries != {("y", "low"):
                                                   "magnetic"}:
        raise AssertionError("767^2 with Mirror(Y) is not the magnetic wall")
    sim.run(until=24 * sim.dt)                       # warm-up: tables
    ker, _ = resident_counted_check(
        sim, "767^2 disk, Mirror(Y) (magnetic wall), flux line", card,
        k3, 1000)
    kms, call_ms = time_resident(
        lambda s_, n_: ker._run(s_, n_, sim._t, ()), sim.fields_state, 1000)
    flux = sim.get_fluxes(fl)
    print(f"[12] K3 at the folded 767^2 ({sim.gv.num}): {kms:.4f} ms/step "
          f"over 1000-step launches (the wrapper's call: {call_ms:.4f}); "
          f"flux {flux.tolist()} ({card})", flush=True)
    if not np.all(np.isfinite(flux)):
        raise AssertionError(f"folded 767^2: flux {flux}")
    del sim, ker
    sim, _ = resident_sim(mp, 768, dev, flux=True,
                          symmetries=[mp.Mirror(mp.X), mp.Mirror(mp.Y)])
    if sim.plan.mirror_node != ((0, "x", 1), (1, "y", 1)):
        raise AssertionError(f"x and y fold: {sim.plan.mirror_node}")
    resident_counted_check(sim, "768^2 disk folded on x and y (node "
                           "mirrors), flux line", card, k3, 200)
    del sim
    sim, _ = flagship_sim(mp, 16, 8.0, dev, pml=0.25,
                          symmetries=[mp.Mirror(mp.Y)])
    ker, _ = resident_counted_check(
        sim, "16^3 flagship folded on y (node mirror)", card, k3, 200)
    if not ker.schedule[1]["direct"]:
        raise AssertionError("the folded 16^3 flagship left the direct "
                             "schedule")
    del sim, ker
    torch.cuda.empty_cache()


#: phase 13's 1D scene: thg_amplitude's Kerr medium and source
#: (tests/test_nonlinear.py; Meep's python/tests/test_3rd_harm_1d.py) in a
#: cell lengthened from 12 to 100 (4000 cells at resolution 40)
THG = dict(length=100.0, res=40.0, f0=1.0 / 3.0, chi3=1e-3, pml=2.0)


def thg_sim(mp, device, chi3):
    """The 1D third-harmonic scene through the public Simulation: a cell
    size along z only (a 1D cell), PML 2, an Ex Gaussian pump (f0 = 1/3,
    fwidth f0 / 20) at z = -4 in a chi3 medium, the DTFT of Ex at z = 4 at
    f0 and 3 f0 (add_dft_fields at a point) and a flux point there."""
    f0 = THG["f0"]
    src = mp.GaussianSource(f0, fwidth=f0 / 20)
    sim = mp.Simulation(
        cell_size=mp.Vector3(0, 0, THG["length"]), resolution=THG["res"],
        default_material=mp.Medium(chi3=chi3),
        sources=[mp.Source(src, mp.Ex, center=mp.Vector3(0, 0, -4))],
        boundary_layers=[mp.PML(THG["pml"])], device=device)
    h = {"dft": sim.add_dft_fields([mp.Ex], 2 * f0, 2 * f0, 2,
                                   center=mp.Vector3(0, 0, 4),
                                   size=mp.Vector3()),
         "flux": sim.add_flux(2 * f0, 2 * f0, 2,
                              mp.FluxRegion(center=mp.Vector3(0, 0, 4)))}
    return sim, h, src.last_time() + 20


def thg_run(mp, device, chi3):
    """thg_sim run to 20 after the pump: (|DTFT of Ex| at f0 and 3 f0,
    the fluxes, the simulation, its wall seconds)."""
    import numpy as np
    import torch
    sim, h, until = thg_sim(mp, device, chi3)
    sim.init_sim()
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(until=until)
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    amp = np.abs(sim.get_dft_array(h["dft"], mp.Ex).reshape(-1, 2).sum(0))
    return amp, np.asarray(sim.get_fluxes(h["flux"])), sim, wall


def rot_sym(mp, kind, phase):
    return (mp.Rotate2 if kind == "rot2" else mp.Rotate4)(mp.Z, phase=phase)


def rot_images(kind, phase, p):
    """The point p = (x, y, ...) and its C2 (kind "rot2") or C4 images
    about z, with phase^k (an Ez source's amplitude)."""
    x, y, rest = p[0], p[1], tuple(p[2:])
    pts = [(x, y), (-x, -y)] if kind == "rot2" else \
        [(x, y), (-y, x), (-x, -y), (y, -x)]
    return [((px, py) + rest, float(phase) ** k)
            for k, (px, py) in enumerate(pts)]


def rot_disk_sim(mp, n, device, kind, phase, folded, **sim_kw):
    """bench.py::run_resident's scene (resident_sim) at an even count n,
    the disk's radius 1e-9 larger (at n = 768 the surface passes exactly
    through sites, whose smoothed eps would round differently on the two
    sides), its Ez source moved into the retained quadrant off the fold
    planes, (L / 3, L / 24), and a flux line in the quadrant; folded by
    Rotate2 / Rotate4("z", phase), or the full cell carrying the source's
    C2 or C4 images with phase^k."""
    res = 16.0
    L = n / res
    imgs = rot_images(kind, phase, (L / 3, L / 24))
    sim = mp.Simulation(
        cell_size=mp.Vector3(L, L), resolution=res,
        geometry=[mp.Cylinder(radius=L / 6 + 1e-9,
                              material=mp.Medium(epsilon=12))],
        sources=[mp.Source(mp.GaussianSource(frequency=1.0, fwidth=0.5),
                           component=mp.Ez, center=mp.Vector3(*c),
                           amplitude=a)
                 for c, a in (imgs[:1] if folded else imgs)],
        boundary_layers=[mp.PML(1.0)], device=device,
        symmetries=[rot_sym(mp, kind, phase)] if folded else [], **sim_kw)
    fl = sim.add_flux(1.0, 0.4, 3, mp.FluxRegion(
        center=mp.Vector3(0.4 * L, L / 6), size=mp.Vector3(0, L / 4)))
    sim.init_sim()
    return sim, fl


def rot_flagship(mp, n, res, device, kind, folded, pml=1.0):
    """The linear flagship (the eps=4 ball without its pole and chi2: a
    rotation refuses chi2/chi3) with its Ez source at (0.15, 0.1, 0.02) L
    in the retained quadrant and an x-normal flux plane in it (x = 0.3 L,
    y from 0.1 L to 0.4 L); folded by Rotate2 / Rotate4("z"), or the full
    cell carrying the source's C2 or C4 images."""
    L = n / res
    imgs = rot_images(kind, 1, (0.15 * L, 0.1 * L, 0.02 * L))
    sim = mp.Simulation(
        cell_size=mp.Vector3(L, L, L), resolution=res,
        geometry=[mp.Sphere(radius=L / 4, material=mp.Medium(epsilon=4.0))],
        sources=[mp.Source(mp.GaussianSource(frequency=1.0, fwidth=0.5),
                           component=mp.Ez, center=mp.Vector3(*c),
                           amplitude=a)
                 for c, a in (imgs[:1] if folded else imgs)],
        boundary_layers=[mp.PML(pml)], eps_averaging=False, device=device,
        symmetries=[rot_sym(mp, kind, 1)] if folded else [])
    fl = sim.add_flux(1.0, 0.4, 3, mp.FluxRegion(
        center=mp.Vector3(0.3 * L, 0.25 * L, 0),
        size=mp.Vector3(0, 0.3 * L, 0.4 * L)))
    sim.init_sim()
    return sim, fl


def rot4_fp64(mp, n, dev, phase, nsteps, card):
    """The n^2 disk folded by Rotate4 against its full cell in fp64 (the
    eager stepper: K3 is fp32 only), nsteps steps.  A C4 turn swaps the
    roles of the x and y PML chains, so in fp32 the full cell is
    C4-symmetric only to round-off, which grows with the steps (the fp32
    gate of 13.1 is 5e-6 at 1024 steps, not 3e-6); in fp64 the same
    comparison must read round-off of fp64 (gate 1e-12), which shows that
    the fp32 difference is round-off and not a fault of the fold."""
    import numpy as np
    out = {}
    for folded in (False, True):
        sim, fl = rot_disk_sim(mp, n, dev, "rot4", phase, folded,
                               dtype=np.float64)
        sim.run(until=nsteps * sim.dt)
        if set(sim.routes) != {"eager"}:
            raise AssertionError(f"fp64 {n}^2 rot4: routes {dict(sim.routes)}")
        out[folded] = (np.asarray(sim.get_fluxes(fl)), sim.get_array(mp.Ez))
        del sim
    dflux = rel_diff(out[True][0], out[False][0])
    dez = rel_diff(out[True][1], out[False][1])
    print(f"[13] {n}^2 rot4 phase {phase} in fp64 (eager), folded vs full "
          f"cell ({nsteps} steps): fluxes max rel {dflux:.3e}, unfolded Ez "
          f"max abs over max {dez:.3e} ({card})", flush=True)
    if not (dflux <= 1e-12 and dez <= 1e-12):
        raise AssertionError(f"fp64 {n}^2 rot4: folded and full cells "
                             f"differ: flux {dflux:.3e}, Ez {dez:.3e}")


def phase_rotate(mp, dev, card, kers, twins):
    """Phase 13: Rotate2 / Rotate4 folds and 1D cells.  `kers`: the K3 and
    K4 table entries, to which the phase adds its launches; `twins`: the
    CPU runs (start_cpu_twins), which phase 11 has waited for."""
    import numpy as np
    import torch
    from meep_nl_tpu_torch.ops import hybrid as HY
    from meep_nl_tpu_torch.ops import resident as R
    k3, k4 = kers
    # ---- 13.1: the 768^2 disk folded by Rotate2 and Rotate4 ------------
    n, nsteps = 768, 1000
    for kind, phase in (("rot2", 1), ("rot4", -1)):
        out = {}
        for folded in (False, True):
            sim, fl = rot_disk_sim(mp, n, dev, kind, phase, folded)
            what = (f"768^2 disk, {kind} phase {phase}, "
                    f"{'folded' if folded else 'full cell, its images'}")
            sim.run(until=24 * sim.dt)               # warm-up: tables
            ker, wall = resident_counted_check(sim, what, card, k3, nsteps,
                                               tag="13")
            if folded and ker.schedule[1]["direct"] != 2:
                raise AssertionError(f"{what}: schedule {ker.schedule[1]}")
            if folded:
                # K4 on the fold too: a probe in the dropped part (folded
                # onto the wedge), from the run's end state
                probe = [sim._point_probe("p", mp.Ez, mp.Vector3(
                    -n / 80, n / 70))]
                err, _, _, serr = compare_resident(ker, sim.fields_state,
                                                   sim._t, 20, probe)
                print(f"[13] K4 vs plain, {what}, a probe at "
                      f"{probe[0].indices.tolist()}, 20 steps: state max abs "
                      f"{err:.3e}, series max abs {serr:.3e}", flush=True)
                if not (err == 0.0 and serr == 0.0):
                    raise AssertionError(f"K4 is not bit for bit ({what}): "
                                         f"{err:.3e}, series {serr:.3e}")
            kms, call_ms = time_resident(
                lambda s_, n_: ker._run(s_, n_, sim._t, ()),
                sim.fields_state, nsteps)
            cells = int(np.prod(sim.gv.num))
            print(f"[13] K3 at the {what} ({sim.gv.num} cells): {kms:.4f} "
                  f"ms/step = {cells / kms / 1e6:.3f} GCells/s of its own "
                  f"cells (the wrapper's call {call_ms:.4f}; Simulation.run "
                  f"{wall / nsteps * 1e3:.4f} ms/step); bound "
                  f"{bound(R.step_cost(sim.plan, nsteps))[0] / nsteps:.6f} "
                  f"ms/step; {schedule_text(ker, nsteps, False)} ({card})",
                  flush=True)
            out[folded] = (sim.get_fluxes(fl), sim.get_array(mp.Ez))
            del sim, ker
        dflux = rel_diff(out[True][0], out[False][0])
        dez = rel_diff(out[True][1], out[False][1])
        print(f"[13] 768^2 {kind} phase {phase}, folded vs full cell "
              f"({nsteps + 24} steps): fluxes max rel {dflux:.3e} "
              f"({out[False][0].tolist()}), unfolded Ez max abs over max "
              f"{dez:.3e}", flush=True)
        if not (dflux <= 1e-6 and dez <= (5e-6 if kind == "rot4" else 3e-6)
                and out[True][1].shape == out[False][1].shape):
            raise AssertionError(f"768^2 {kind}: folded and full cells "
                                 f"differ: flux {dflux:.3e}, Ez {dez:.3e}")
        if kind == "rot4":
            rot4_fp64(mp, n, dev, phase, nsteps + 24, card)
    torch.cuda.empty_cache()

    # ---- 13.2: Meep's ring with Rotate2 at phases +1 and -1 (K4) -------
    child, path, _ = twins
    if child.wait(timeout=900) != 0:
        raise AssertionError("the CPU runs failed")
    with np.load(path) as z:
        want = {k: z[k] for k in z.files}
    for phase in (1, -1):
        sim = ring_sim(mp, 10, dev, symmetries=[mp.Rotate2(mp.Z, phase)])
        h = mp.Harminv(mp.Ez, mp.Vector3(1.1), 0.15, 0.1)
        sim.init_sim()
        R._kernel(sim.plan)
        wall, launches, probed = resident_run_counted(
            sim, mp.after_sources(h), until_after_sources=300)
        if launches or probed != sim.routes["resident"] or not probed:
            raise AssertionError(f"ring rot2 {phase}: K3 {launches}, K4 "
                                 f"{probed}, routes {dict(sim.routes)}")
        k4["launches"] += probed
        ker = sim.plan._resident_kernel
        modes = np.array([(m.freq, m.Q, m.amp) for m in h.modes])
        cpu = want[f"ring_r2{phase}_modes"]
        worst = 0.0
        for f, q, a in cpu:
            if q > 50:
                g = min(modes[:, 0], key=lambda v: abs(v - f))
                worst = max(worst, abs(g - f) / abs(f))
        sched = schedule_text(ker, 1024, True)
        print(f"[13] ring.py with Rotate2(z, phase={phase}) "
              f"({sim.plan.storage_shape}): {sim._t} steps in {wall:.3f} s "
              f"= {wall / sim._t * 1e3:.4f} ms/step, K4 launches {probed}, "
              f"routes {dict(sim.routes)}; Q > 50 modes against the CPU: "
              f"frequencies max rel {worst:.3e}; {sched} ({card})",
              flush=True)
        print("[13] modes (freq, Q, amp): " + ", ".join(
            f"({m.freq:.8f}, {m.Q:.1f}, {m.amp:.3e})" for m in h.modes),
            flush=True)
        if not (worst <= 1e-4 and np.any(cpu[:, 1] > 50)):
            raise AssertionError(f"ring rot2 {phase}: modes differ from the "
                                 f"CPU's by {worst:.3e}")
        st, t_end = sim.fields_state, sim._t
        probe = [sim._point_probe("hm0", mp.Ez, mp.Vector3(1.1))]
        err, _, _, serr = compare_resident(ker, st, t_end, 20, probe)
        print(f"[13] K4 vs plain at the Rotate2({phase}) ring's end state, 20"
              f" steps: state max abs {err:.3e}, series max abs {serr:.3e}",
              flush=True)
        if not (err == 0.0 and serr == 0.0):
            raise AssertionError(f"K4 is not bit for bit on the Rotate2 "
                                 f"ring: {err:.3e}, series {serr:.3e}")
        ms, call_ms = time_resident(
            lambda s_, n_: ker._run(s_, n_, t_end, probe), st, 1024)
        print(f"[13] K4 at the Rotate2({phase}) ring: {ms:.4f} ms/step over "
              f"1024-step launches (the wrapper's call: {call_ms:.4f}); "
              f"bound {bound(R.step_cost(sim.plan, 1024))[0] / 1024:.6f} "
              f"ms/step ({card})", flush=True)
        del sim, st
    sim = ring_sim(mp, 10, dev, symmetries=[mp.Rotate2(mp.Z)])
    sim.init_sim()
    R._kernel(sim.plan)
    wall, launches, probed = resident_run_counted(
        sim, until_after_sources=ring_decay(mp))
    if launches or probed != sim.routes["resident"] or probed < 2:
        raise AssertionError(f"rot2 ring decay: K3 {launches}, K4 {probed}"
                             f", routes {dict(sim.routes)}")
    k4["launches"] += probed
    print(f"[13] Rotate2 ring, stop_when_fields_decayed: stopped after "
          f"{sim._t} steps in {wall:.3f} s = {wall / sim._t * 1e3:.4f} "
          f"ms/step, K4 launches {probed}; the CPU twin stopped after "
          f"{int(want['ring_r2_stop'])} ({card})", flush=True)
    if sim._t != int(want["ring_r2_stop"]):
        raise AssertionError(f"Rotate2 ring decay stops at {sim._t} on the "
                             f"card, {int(want['ring_r2_stop'])} on the CPU")
    del sim

    # ---- 13.3: the 16^3 linear flagship folded (K3 in 3D) ---------------
    for kind in ("rot2", "rot4"):
        sim, fl = rot_flagship(mp, 16, 8.0, dev, kind, True, pml=0.25)
        ker, _ = resident_counted_check(
            sim, f"16^3 linear flagship, {kind}", card, k3, 200, tag="13")
        if ker.schedule[1]["direct"] != 2:
            raise AssertionError(f"16^3 {kind}: schedule {ker.schedule[1]}")
        dflux = rel_diff(sim.get_fluxes(fl), want[f"{kind}16:flux"])
        dez = rel_diff(sim.get_array(mp.Ez), want[f"{kind}16:ez"])
        print(f"[13] 16^3 {kind}, card vs CPU: flux max rel {dflux:.3e}, "
              f"unfolded Ez {dez:.3e}", flush=True)
        if not (dflux <= 1e-4 and dez <= 1e-4):
            raise AssertionError(f"16^3 {kind}: card and CPU differ: flux "
                                 f"{dflux:.3e}, Ez {dez:.3e}")
        del sim, ker

    # ---- 13.4: 128^3 linear flagship folded: K3, or the eager stepper ---
    n, res, nwarm, nsteps = 128, 16.0, 6, 60
    for kind, route in (("rot4", "resident"), ("rot2", "eager")):
        ez, ms = {}, {}
        for folded in (True, False):
            sim, fl = rot_flagship(mp, n, res, dev, kind, folded)
            sim.run(until=nwarm * sim.dt)        # warm-up: builds, tables
            what = f"128^3 linear flagship, {kind}"
            if not folded:
                wall, _ = timed_run(sim, nsteps)
            elif route == "resident":
                ker, wall = resident_counted_check(sim, what, card, k3,
                                                   nsteps, tag="13")
                if ker.schedule[1]["direct"] != 2:
                    raise AssertionError(f"{what}: schedule "
                                         f"{ker.schedule[1]}")
                kms, call_ms = time_resident(
                    lambda s_, n_: ker._run(s_, n_, sim._t, ()),
                    sim.fields_state, nsteps)
                print(f"[13] K3 at the {what} ({sim.gv.num} cells): "
                      f"{kms:.4f} ms/step (the wrapper's call {call_ms:.4f}; "
                      f"Simulation.run {wall / nsteps * 1e3:.4f}); bound "
                      f"{bound(R.step_cost(sim.plan, nsteps))[0] / nsteps:.6f}"
                      f" ms/step; {schedule_text(ker, nsteps, False)} "
                      f"({card})", flush=True)
                del ker
            else:
                sim.routes.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sim.run(until=nsteps * sim.dt)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if set(sim.routes) != {route}:
                    raise AssertionError(f"{what}: routes {dict(sim.routes)}")
            ms[folded] = wall / nsteps * 1e3
            if folded:
                plan = sim.plan
                shape = plan.storage_shape or plan.gv.shape
                cells = int(np.prod(sim.gv.num))
                print(f"[13] {what} ({sim.gv.num} cells, storage "
                      f"{tuple(shape)}, doubled state "
                      f"{2 * R._state_bytes(plan) / 2 ** 20:.1f} MiB against "
                      f"the resident budget {R.VMEM_BUDGET / 2 ** 20:.0f}): "
                      f"routes {dict(sim.routes)}; hybrid applicable "
                      f"{HY.hybrid_applicable(plan)}", flush=True)
            L = n / res
            ez[folded] = sim.get_array(mp.Ez, center=mp.Vector3(),
                                       size=mp.Vector3(L, L, L))
            del sim
            torch.cuda.empty_cache()
        dez = rel_diff(ez[True], ez[False])
        print(f"[13] 128^3 {kind}, {nsteps} steps after {nwarm} of warm-up: "
              f"{route} route {ms[True]:.4f} ms/step = "
              f"{cells / ms[True] / 1e6:.3f} GCells/s of its {cells} cells; "
              f"the full cell on the hybrid route {ms[False]:.4f} ms/step; "
              f"unfolded Ez against the full cell max abs over max "
              f"{dez:.3e} ({card})", flush=True)
        if not (dez <= 3e-6 and ez[True].shape == ez[False].shape):
            raise AssertionError(f"128^3 {kind}: folded and full cells "
                                 f"differ by {dez:.3e}")
        del ez

    # ---- 13.5: a 1D cell, third-harmonic generation (eager) ------------
    amps = {}
    for chi3 in (THG["chi3"], 2 * THG["chi3"]):
        amp, flux, sim, wall = thg_run(mp, dev, chi3)
        amps[chi3] = amp
        if dict(sim.routes).keys() != {"eager"}:
            raise AssertionError(f"1D: routes {dict(sim.routes)}")
        print(f"[13] 1D Kerr third harmonic ({sim.gv.shape[0]} sites, "
              f"chi3 {chi3}): {sim._t} steps in {wall:.3f} s = "
              f"{wall / sim._t * 1e3:.4f} ms/step, routes "
              f"{dict(sim.routes)}; |DTFT Ex| at f0, 3 f0 {amp.tolist()}, "
              f"flux {flux.tolist()} ({card})", flush=True)
        if chi3 == THG["chi3"]:
            if sim._t != int(want["thg_steps"]):
                raise AssertionError("1D: the card ran another step count")
            # each frequency against its own magnitude: the 3 f0 harmonic
            # is ~1e-3 of the pump
            damp = rel_each(amp, want["thg_amp"])
            dflux = rel_each(flux, want["thg_flux"])
            print(f"[13] 1D, card vs CPU, at f0 and 3 f0 each against its "
                  f"own magnitude: |DTFT| max rel {damp:.3e}, flux max rel "
                  f"{dflux:.3e}", flush=True)
            if not (damp <= 1e-4 and dflux <= 1e-4):
                raise AssertionError(f"1D: card and CPU differ: {damp:.3e},"
                                     f" flux {dflux:.3e}")
        del sim
    a1, a2 = amps[THG["chi3"]], amps[2 * THG["chi3"]]
    ratio = a2[1] / a1[1]
    print(f"[13] 1D third harmonic with chi3 doubled: x {ratio:.4f} (pump "
          f"x {a2[0] / a1[0]:.6f})", flush=True)
    if not (abs(ratio - 2.0) <= 0.1 and abs(a2[0] / a1[0] - 1) <= 1e-3):
        raise AssertionError(f"1D: the third harmonic scales by {ratio:.4f}")


def _entry(name, source, replaces, blank):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, **blank, "launches": 0,
            "max_abs_err": 0.0}


def _live_error(a, b, n):
    """(max abs, max abs over the field maximum) of two states on the
    live x-planes [0, n) of every array."""
    err = scale = 0.0
    for key in ("f", "f_u", "f_w"):
        for c, t in b[key].items():
            err = max(err, float((a[key][c][:n] - t[:n]).abs().max()))
            if key == "f":
                scale = max(scale, float(t[:n].abs().max()))
    for pa, pb in zip(a["pol"], b["pol"]):
        for k in ("p", "pp"):
            for c, t in pb[k].items():
                err = max(err, float((pa[k][c][:n] - t[:n]).abs().max()))
    return err, err / max(scale, 1e-30)


def phase_periodic(mp, dev, card, main_ms, blank, twins):
    """Phase 14: Bloch-periodic cells with real phases.  `main_ms`: phase
    4's ms/step; `twins`: the CPU runs (start_cpu_twins), which phase 11
    has waited for.  Returns the kernel table entries of K1's x wrap, K2
    on the ghost ring's extended plan and K3/K4's wrap variant."""
    import numpy as np
    import torch
    from meep_nl_tpu_torch.ops import fdtd3d, fdtd3d_t2
    from meep_nl_tpu_torch.ops import hybrid as HY
    from meep_nl_tpu_torch.ops import periodicx as PX
    from meep_nl_tpu_torch.ops import resident as R
    from meep_nl_tpu_torch.stepper.step import build_xs, xs_rows
    k1x = _entry("fdtd3d_k1_xwrap", "meep_nl_tpu_torch/csrc/fdtd3d.cu",
                 K1_REPLACES, blank)
    k2g = _entry("fdtd3d_t2_k2_ghost_ring",
                 "meep_nl_tpu_torch/csrc/fdtd3d_t2.cu", K2_REPLACES, blank)
    k3w = _entry("resident_k3_wrap", "meep_nl_tpu_torch/csrc/resident.cu",
                 K3_REPLACES, blank)
    k4w = _entry("resident_k4_wrap", "meep_nl_tpu_torch/csrc/resident.cu",
                 K4_REPLACES, blank)
    with np.load(twins[1]) as z:
        want = {k: z[k] for k in z.files}

    # ---- 14.1: binary_grating.py at its published size (K3) -------------
    def counted(sim, **kw):
        R._kernel(sim.plan)
        wall, launches, probed = resident_run_counted(sim, **kw)
        ker = sim.plan._resident_kernel
        if probed or launches != sim.routes["resident"] or not launches \
                or ker.schedule[1]["direct"] != R.DIRECT_WRAP:
            raise AssertionError(f"grating run: K3 launches {launches}, K4 "
                                 f"{probed}, routes {dict(sim.routes)}, "
                                 f"schedule {ker.schedule[1]}")
        k3w["launches"] += launches
        print(f"[14] grating at resolution {sim.resolution:.0f} "
              f"({sim.plan.storage_shape}, periodic {sim.plan.periodic}): "
              f"{kw}, {sim._t} steps in {wall:.3f} s = "
              f"{wall / sim._t * 1e3:.4f} ms/step = "
              f"{np.prod(sim.gv.num) * sim._t / wall / 1e9:.3f} GCells/s; "
              f"K3 launches {launches}, routes {dict(sim.routes)} ({card})",
              flush=True)

    T, runs = {}, {}
    for res in (GRATING_RES, GRATING_TWIN_RES):
        T[res], runs[res] = grating_T(mp, res, dev, counted)
        if not (np.all(np.isfinite(T[res])) and np.all(T[res] > 0)):
            raise AssertionError(f"grating T at {res}: {T[res]}")
    print(f"[14] grating transmittance at resolution {GRATING_RES} (21 "
          f"frequencies, wavelengths 0.4-0.6): {T[GRATING_RES].tolist()}",
          flush=True)
    d = rel_each(T[GRATING_TWIN_RES], want["grating_T"])
    print(f"[14] grating at resolution {GRATING_TWIN_RES}, card vs CPU: "
          f"transmittance max rel (each frequency against its own "
          f"magnitude) {d:.3e}; resolution {GRATING_RES} against "
          f"{GRATING_TWIN_RES}: {rel_each(T[GRATING_RES], want['grating_T']):.3e}",
          flush=True)
    if not d <= 1e-4:
        raise AssertionError(f"grating T: card and CPU differ by {d:.3e}")
    # K3 on the published grating, from its run's end state and a seeded
    # random state (48 steps: the window holds DTFT sample steps of the
    # decimated monitor), bit for bit; timed, beside tiles
    (s0, _), (s1, _) = runs[GRATING_RES]
    ker = s1.plan._resident_kernel
    for label, st0 in (("the run's state", s1.fields_state),
                       ("a random state", random_state(s1.plan, 23, dev))):
        err, rel, drel, _ = compare_resident(ker, st0, s1._t, 48)
        print(f"[14] K3 vs plain, grating, from {label}, 48 steps: state "
              f"and accumulators max abs {err:.3e} (DTFT max rel "
              f"{drel:.3e})", flush=True)
        if not err == 0.0:
            raise AssertionError(f"K3's wrap is not bit for bit (grating, "
                                 f"from {label}): {err:.3e}")
        k3w["max_abs_err"] = max(k3w["max_abs_err"], err)
    nsteps, st, t_end = 1000, s1.fields_state, s1._t
    ms, call_ms = time_resident(
        lambda s_, n_: ker._run(s_, n_, t_end, ()), st, nsteps)
    ref = R.resident_ref(s1.plan)
    _, plain_ms = time_resident(lambda s_, n_: ref(s_, n_, t_end), st, 20,
                                reps=1)
    cost = R.step_cost(s1.plan, nsteps)
    b_ms, b_by = bound({"bytes": cost["bytes"] / nsteps,
                        "ops": cost["ops"] / nsteps})
    k3w.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    sn, _ = grating_sim(mp, GRATING_RES, dev, True, wrap=False)
    sn.run(until=24 * sn.dt)
    kn = sn.plan._resident_kernel
    ms_t, _ = time_resident(
        lambda s_, n_: kn._run(s_, n_, sn._t, ()), sn.fields_state, nsteps)
    cells = int(np.prod(s1.gv.num))
    print(f"[14] K3 at the grating ({cells} cells): {ms:.4f} ms/step = "
          f"{cells / ms / 1e6:.3f} GCells/s ({schedule_text(ker, nsteps, False)}"
          f"); the wrapper's call {call_ms:.4f}; plain {plain_ms:.4f} "
          f"ms/step; bound {b_ms:.5f} ms/step ({b_by}); the same cell "
          f"without the wrap (metal y walls): {ms_t:.4f} ms/step "
          f"({schedule_text(kn, nsteps, False)}) ({card})", flush=True)
    del s0, s1, sn, st, ker, kn, runs
    torch.cuda.empty_cache()

    # ---- 14.2: holey-wvg-bands.py at the band edges (K4) -----------------
    sim = holey_sim(mp, dev)
    for i, k in enumerate(HOLEY_K):
        sim.routes.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        freqs = sim.run_k_points(300, [mp.Vector3(k)])[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ker = sim.plan._resident_kernel
        if dict(sim.routes) != {"resident": ker.probed_launches} \
                or ker.launches or ker.plain_steps \
                or not ker.probed_launches \
                or ker.schedule[1]["direct"] != R.DIRECT_WRAP:
            raise AssertionError(f"holey k {k}: routes {dict(sim.routes)}, "
                                 f"K3 {ker.launches}, K4 "
                                 f"{ker.probed_launches}, plain "
                                 f"{ker.plain_steps}")
        k4w["launches"] += ker.probed_launches
        phase = sim.plan.bloch_phase[0]
        cpu = want[f"holey{i}"]
        worst, good = 0.0, [f for f in freqs
                            if abs(f.real) > 40 * abs(f.imag)]
        for f in good:
            near = cpu[np.argmin(np.abs(cpu - f))]
            worst = max(worst, abs(near - f) / abs(f))
        print(f"[14] holey waveguide, k_x = {k} (phase {phase}, "
              f"{sim.plan.storage_shape}): run_k_points(300) {sim._t} steps "
              f"in {wall:.3f} s = {wall / sim._t * 1e3:.4f} ms/step; K4 "
              f"launches {ker.probed_launches}, routes {dict(sim.routes)}; "
              f"modes (Q > 20) {[f'{f.real:.6f}' for f in good]}, against "
              f"the CPU's max rel {worst:.3e} ({card})", flush=True)
        if not (good and worst <= 1e-4):
            raise AssertionError(f"holey k {k}: modes differ from the CPU's "
                                 f"by {worst:.3e} ({len(good)} modes)")
        probe = [sim._point_probe("hm0", mp.Hz, mp.Vector3(0.1234))]
        st, t_end = sim.fields_state, sim._t
        for label, st0 in (("the end state", st),
                           ("a random state",
                            random_state(sim.plan, 29 + i, dev))):
            err, rel, _, serr = compare_resident(ker, st0, t_end, 20, probe)
            print(f"[14] K4 vs plain, holey k_x = {k}, from {label}, 20 "
                  f"steps: state max abs {err:.3e}, series max abs "
                  f"{serr:.3e}", flush=True)
            if not (err == 0.0 and serr == 0.0):
                raise AssertionError(f"K4's wrap is not bit for bit (holey "
                                     f"k {k}, from {label}): {err:.3e}, "
                                     f"series {serr:.3e}")
            k4w["max_abs_err"] = max(k4w["max_abs_err"], err, serr)
    ms, call_ms = time_resident(
        lambda s_, n_: ker._run(s_, n_, t_end, probe), st, 1024)
    ref = R.resident_ref(sim.plan)
    _, plain_ms = time_resident(lambda s_, n_: ref(s_, n_, t_end, probe), st,
                                20, reps=1)
    cost = R.step_cost(sim.plan, 1024)
    b_ms, b_by = bound({"bytes": cost["bytes"] / 1024,
                        "ops": cost["ops"] / 1024})
    k4w.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    print(f"[14] K4 at the holey waveguide: {ms:.4f} ms/step "
          f"({schedule_text(ker, 1024, True)}); the wrapper's call "
          f"{call_ms:.4f}; plain {plain_ms:.4f}; bound {b_ms:.6f} ms/step "
          f"({b_by}) ({card})", flush=True)
    del sim, st, ker

    # ---- 14.3: the 128^3 flagship made x-periodic -----------------------
    res, n = 16.0, 128
    for kx in (0.0, 1 / 16):
        nsteps = 60
        # without the flux plane: the ghost ring (K2 on the extended plan)
        sim, _ = flagship_sim(mp, n, res, dev, flux=False, kx=kx)
        plan = sim.plan
        sim.run(until=12 * sim.dt)                  # warm-up: builds
        ring = plan._t2_kernel
        if not (isinstance(ring, PX.PeriodicGhostT2Kernel) and ring.k3):
            raise AssertionError(f"128^3 x-periodic: kernel {ring}")
        kers = [ring.ker, ring.k3.ker, ring.ker._k1]
        for k in kers:
            k.launches = k.plain_steps = 0
        sim.routes.clear()
        HY.hybrid_routes(plan).clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(until=nsteps * sim.dt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k3_per = ring.k3.ker.launches_per_call
        got = [k.launches for k in kers]
        if dict(sim.routes) != {"hybrid": 1} \
                or dict(HY.hybrid_routes(plan)) != {"no_sample": 1} \
                or got != [0, nsteps // 3 * k3_per, 0] \
                or any(k.plain_steps for k in kers):
            raise AssertionError(f"128^3 x-periodic ghost ring: routes "
                                 f"{dict(sim.routes)}, "
                                 f"{dict(HY.hybrid_routes(plan))}, "
                                 f"launches {got}")
        k2g["launches"] += got[1]
        phase = plan.bloch_phase[0]
        ext = ring.ext_plan.storage_shape
        print(f"[14] 128^3 flagship x-periodic (phase {phase}), no monitor: "
              f"{nsteps} steps in {wall:.3f} s = {wall / nsteps * 1e3:.4f} "
              f"ms/step (phase 4's capture route {main_ms:.4f}); the ghost "
              f"ring, extended storage {ext}: {got[1]} K2 launches at depth "
              f"3 ({k3_per} a call), routes {dict(sim.routes)} ({card})",
              flush=True)
        # the stepper with the hybrid route's slab-local PML chains
        se, _ = flagship_sim(mp, n, res, dev, flux=False, kx=kx,
                             use_fused=False)
        se.plan.slab_opt = True
        se.run(until=(nsteps + 12) * se.dt)
        err, rel = _live_error(sim.fields_state, se.fields_state,
                               plan.gv.num[0])
        print(f"[14] ghost ring vs the eager stepper on the card after "
              f"{nsteps + 12} steps (phase {phase}): live planes max abs "
              f"{err:.3e}, over the field maximum {rel:.3e} (gate 1e-6)",
              flush=True)
        if not rel <= 1e-6:
            raise AssertionError(f"ghost ring differs from the stepper: "
                                 f"{rel:.3e}")
        # K2 on the extended plan against its plain version, timed
        st = ring._refresh(ring.from_full(sim.fields_state))[0]
        for d, rk in ((2, ring), (3, ring.k3)):
            err, rel, _, _, _ = compare_k2(ring.ext_plan, d, 2, st, sim._t,
                                           None)
            print(f"[14] K2 depth {d} vs plain on the extended plan "
                  f"(phase {phase}), 2 calls from the run's state: max abs "
                  f"{err:.3e}", flush=True)
            if not err == 0.0:
                raise AssertionError(f"K2 on the extended plan is not bit "
                                     f"for bit: {err:.3e}")
            k2g["max_abs_err"] = max(k2g["max_abs_err"], err)
        rows = xs_rows(ring.ext_plan, build_xs(ring.ext_plan, 36, sim._t))
        ms, _ = time_steps(ring.k3.step, [clone_state(st)], rows, per=3)
        if kx:
            p_ms, _ = time_steps(ring_plain(ring.k3), [clone_state(st)],
                                 rows[:12], per=3)
            b_ms, b_by = bound(fdtd3d_t2.step_cost(ring.ext_plan, 3))
            k2g.update(ms=ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
            print(f"[14] K2 depth 3 on the extended plan, its refresh "
                  f"included: {ms:.4f} ms/call = {ms / 3:.4f} ms/step; plain "
                  f"(the refresh and K2's plain version) {p_ms:.4f} ms/call; bound {b_ms:.4f} ms/call ({b_by}) "
                  f"({card})", flush=True)
        del sim, se, st, ring, kers
        # with phase 4's flux plane, phase 4's 602 steps (the pulse
        # reaches the plane): K1's x wrap every step
        nsteps = 602
        sim, fl = flagship_sim(mp, n, res, dev, kx=kx)
        plan = sim.plan
        sim.run(until=12 * sim.dt)
        k1 = plan._t2_kernel._k1
        if not isinstance(k1, PX.PeriodicXKernel):
            raise AssertionError(f"128^3 x-periodic monitored: K1 {k1}")
        k1.launches = k1.plain_steps = 0
        sim.routes.clear()
        HY.hybrid_routes(plan).clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(until=nsteps * sim.dt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if dict(sim.routes) != {"hybrid": 1} \
                or dict(HY.hybrid_routes(plan)) != {"full_state": 1} \
                or k1.launches != nsteps * K1_LAUNCHES or k1.plain_steps:
            raise AssertionError(f"128^3 x-periodic monitored: routes "
                                 f"{dict(sim.routes)}, "
                                 f"{dict(HY.hybrid_routes(plan))}, K1 "
                                 f"launches {k1.launches}")
        k1x["launches"] += k1.launches
        flux = sim.get_fluxes(fl)
        se, fe = flagship_sim(mp, n, res, dev, kx=kx, use_fused=False)
        se.plan.slab_opt = True
        se.run(until=(nsteps + 12) * se.dt)
        fd = rel_diff(flux, se.get_fluxes(fe))
        err, rel = _live_error(sim.fields_state, se.fields_state,
                               plan.gv.num[0])
        print(f"[14] 128^3 flagship x-periodic (phase {phase}) with the flux "
              f"plane: {nsteps} steps in {wall:.3f} s = "
              f"{wall / nsteps * 1e3:.4f} ms/step (phase 4's {main_ms:.4f}); "
              f"K1's x wrap every step (the full-state cycle), launches "
              f"{k1.launches}; against the eager stepper on the card: "
              f"fluxes max rel {fd:.3e}, live planes max abs {err:.3e} "
              f"(over the maximum {rel:.3e}; gates 1e-6); flux "
              f"{flux.tolist()} ({card})", flush=True)
        if not (fd <= 1e-6 and rel <= 1e-6 and np.abs(flux).max() > 1e-8):
            raise AssertionError(f"K1's x wrap differs from the stepper: "
                                 f"fluxes {fd:.3e}, state {rel:.3e}")
        st, t_end = sim.fields_state, sim._t
        err, rel = compare_k1_from(plan, k1, st, t_end)
        print(f"[14] K1's x wrap vs plain (phase {phase}), 5 steps from the "
              f"run's state: max abs {err:.3e}", flush=True)
        if not err == 0.0:
            raise AssertionError(f"K1's x wrap is not bit for bit: "
                                 f"{err:.3e}")
        k1x["max_abs_err"] = max(k1x["max_abs_err"], err)
        if kx:
            rows = xs_rows(plan, build_xs(plan, 13, t_end))
            k1x["ms"], _ = time_steps(k1.step, clone_state(st), rows)
            k1x["plain_ms"], _ = time_steps(fdtd3d.step_ref(plan),
                                            clone_state(st), rows)
            k1x["bound_ms"], k1x["bound_by"] = bound(fdtd3d.step_cost(plan))
            print(f"[14] K1's x wrap at 128^3: {k1x['ms']:.4f} ms/step, "
                  f"plain {k1x['plain_ms']:.4f}, bound "
                  f"{k1x['bound_ms']:.4f} ms ({k1x['bound_by']}) ({card})",
                  flush=True)
        del sim, se, st
        torch.cuda.empty_cache()

    # ---- 14.4: the 16^3 form on the resident route (K3's wrap) ----------
    s2, f2 = flagship_sim(mp, 16, 8.0, dev, pml=0.25, kx=0.25)
    ker, _ = resident_counted_check(s2, "16^3 flagship x-periodic, zone "
                                    "edge", card, k3w, 200, tag="14")
    if ker.schedule[1]["direct"] != R.DIRECT_WRAP:
        raise AssertionError(f"16^3 x-periodic: schedule {ker.schedule[1]}")
    for what, got, ref_ in (("flux", s2.get_fluxes(f2), want["p16:flux"]),
                            ("ez", s2.get_array(mp.Ez), want["p16:ez"])):
        d = rel_diff(got, ref_)
        print(f"[14] 16^3 x-periodic, card vs CPU {what}: max rel {d:.3e}",
              flush=True)
        if not d <= 1e-4:
            raise AssertionError(f"16^3 x-periodic {what}: {d:.3e}")
    return [k1x, k2g, k3w, k4w]


def _pair_live_error(a, b, n):
    """_live_error of two real-pair states: (max abs, over the field
    maximum) on the live x-planes [0, n) of both channels."""
    err = scale = 0.0
    for key in ("f", "f_u", "f_w"):
        for c, t in b[key].items():
            err = max(err, float((a[key][c][:, :n] - t[:, :n]).abs().max()))
            if key == "f":
                scale = max(scale, float(t[:, :n].abs().max()))
    for pa, pb in zip(a["pol"], b["pol"]):
        for k in ("p", "pp"):
            for c, t in pb[k].items():
                err = max(err, float((pa[k][c][:, :n] - t[:, :n])
                                     .abs().max()))
    return err, err / max(scale, 1e-30)


def _modes_against(got, cpu):
    """(the card's Q > 20 modes, the largest relative distance of one of
    them to the nearest of the CPU's)."""
    import numpy as np
    good = [f for f in got if abs(f.real) > 40 * abs(f.imag)]
    worst = 0.0
    for f in good:
        near = cpu[np.argmin(np.abs(cpu - f))]
        worst = max(worst, abs(near - f) / abs(f))
    return good, worst


def phase_complex(mp, dev, card, main_ms, blank, twins15):
    """Phase 15: complex fields in real-pair storage.  `main_ms`: phase
    4's ms/step; `twins15`: (process, .npz path) of cpu_twins15.  Returns
    the kernel table entries of K1's pair wrap, K2 on the pair ghost ring
    and K3/K4's pair layout."""
    import numpy as np
    import torch
    from meep_nl_tpu_torch.ops import fdtd3d, fdtd3d_t2
    from meep_nl_tpu_torch.ops import hybrid as HY
    from meep_nl_tpu_torch.ops import periodicx as PX
    from meep_nl_tpu_torch.ops import resident as R
    from meep_nl_tpu_torch.stepper.step import build_xs, xs_rows
    k1p = _entry("fdtd3d_k1_pair_wrap", "meep_nl_tpu_torch/csrc/fdtd3d.cu",
                 K1_REPLACES, blank)
    k2p = _entry("fdtd3d_t2_k2_pair_ghost_ring",
                 "meep_nl_tpu_torch/csrc/fdtd3d_t2.cu", K2_REPLACES, blank)
    k3p = _entry("resident_k3_pair", "meep_nl_tpu_torch/csrc/resident.cu",
                 K3_REPLACES, blank)
    k4p = _entry("resident_k4_pair", "meep_nl_tpu_torch/csrc/resident.cu",
                 K4_REPLACES, blank)
    child, path = twins15
    rc = child.wait()
    if rc != 0:
        raise AssertionError(f"phase 15's CPU runs exited with {rc}")
    with np.load(path) as z:
        want = {k: z[k] for k in z.files}

    # ---- 15.1: holey-wvg-bands.py's band diagram (K4's pair layout) ------
    sim = holey_sim(mp, dev)
    kpts = mp.interpolate(HOLEY_PATH_N, [mp.Vector3(0), mp.Vector3(0.5)])
    got, npair, walls, keep = {}, 0, [], None
    for k in kpts:
        sim.routes.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        freqs = sim.run_k_points(300, [k])[0]
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        plan = sim.plan
        ker = plan._resident_kernel
        pair = plan.real_pair and plan.complex_fields
        direct = R.DIRECT_PAIR if pair else R.DIRECT_WRAP
        if dict(sim.routes) != {"resident": ker.probed_launches} \
                or ker.launches or ker.plain_steps \
                or not ker.probed_launches \
                or ker.schedule[1]["direct"] != direct:
            raise AssertionError(f"holey k {k.x}: routes "
                                 f"{dict(sim.routes)}, K3 {ker.launches}, "
                                 f"K4 {ker.probed_launches}, plain "
                                 f"{ker.plain_steps}, schedule "
                                 f"{ker.schedule[1]}")
        if pair:
            k4p["launches"] += ker.probed_launches
            npair += 1
        got[round(k.x, 9)] = freqs
        good, _ = _modes_against(freqs, np.array(freqs))
        print(f"[15] holey k_x = {k.x:.4f} (phase "
              f"{complex(plan.bloch_phase[0]):.4f}, "
              f"{'pair' if pair else 'real'}): {sim._t} steps in "
              f"{walls[-1]:.3f} s, K4 launches {ker.probed_launches}; "
              f"modes (Q > 20) {[round(f.real, 6) for f in good]}",
              flush=True)
        if abs(k.x - 0.25) < 1e-9:
            keep = (plan, ker, sim.fields_state, sim._t)
    if npair != len(kpts) - 2:
        raise AssertionError(f"holey: {npair} of {len(kpts)} k points on "
                             f"the pair layout")
    print(f"[15] holey-wvg-bands.py, 21 k points: {sum(walls):.3f} s "
          f"({card})", flush=True)
    for k in HOLEY_CHECK_K:
        good, worst = _modes_against(got[round(k, 9)], want[f"holey{k}"])
        print(f"[15] holey k_x = {k}: card (pair, K4) vs CPU (native "
              f"complex): {len(good)} modes with Q > 20, max rel "
              f"{worst:.3e}", flush=True)
        if not (good and worst <= 1e-4):
            raise AssertionError(f"holey k {k}: modes differ from the CPU's "
                                 f"by {worst:.3e} ({len(good)} modes)")
    plan, ker, st, t_end = keep
    probe = [sim._point_probe("hm0", mp.Hz, mp.Vector3(0.1234))]
    for label, st0 in (("the end state", st),
                       ("a random state", random_state(plan, 41, dev))):
        err, rel, _, serr = compare_resident(ker, st0, t_end, 20, probe)
        print(f"[15] K4 pair vs plain, holey k_x = 0.25, from {label}, 20 "
              f"steps: state max abs {err:.3e}, series max abs {serr:.3e}",
              flush=True)
        if not (err == 0.0 and serr == 0.0):
            raise AssertionError(f"K4's pair layout is not bit for bit "
                                 f"(from {label}): {err:.3e}, series "
                                 f"{serr:.3e}")
        k4p["max_abs_err"] = max(k4p["max_abs_err"], err, serr)
    ms, call_ms = time_resident(
        lambda s_, n_: ker._run(s_, n_, t_end, probe), st, 1024)
    ref = R.resident_ref(plan)
    _, plain_ms = time_resident(lambda s_, n_: ref(s_, n_, t_end, probe), st,
                                20, reps=1)
    cost = R.step_cost(plan, 1024)
    b_ms, b_by = bound({"bytes": cost["bytes"] / 1024,
                        "ops": cost["ops"] / 1024})
    k4p.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    print(f"[15] K4 pair at the holey waveguide (k_x = 0.25): {ms:.4f} "
          f"ms/step ({schedule_text(ker, 1024, True)}); the wrapper's call "
          f"{call_ms:.4f}; plain {plain_ms:.4f}; bound {b_ms:.6f} ms/step "
          f"({b_by}) ({card})", flush=True)
    del sim, st, ker, keep, plan

    # ---- 15.2: the oblique binary grating (K3's pair layout) ------------
    def counted(sim, **kw):
        R._kernel(sim.plan)
        wall, launches, probed = resident_run_counted(sim, **kw)
        ker = sim.plan._resident_kernel
        if probed or launches != sim.routes["resident"] or not launches \
                or ker.schedule[1]["direct"] != R.DIRECT_PAIR:
            raise AssertionError(f"oblique grating: K3 launches {launches}, "
                                 f"K4 {probed}, routes {dict(sim.routes)}, "
                                 f"schedule {ker.schedule[1]}")
        k3p["launches"] += launches
        print(f"[15] oblique grating at resolution {sim.resolution:.0f} "
              f"({sim.plan.storage_shape}, phases "
              f"{[complex(p) for p in sim.plan.bloch_phase]}): {kw}, "
              f"{sim._t} steps in {wall:.3f} s = "
              f"{wall / sim._t * 1e3:.4f} ms/step; K3 launches {launches} "
              f"({card})", flush=True)

    T, runs = {}, {}
    for res in (GRATING_RES, GRATING_TWIN_RES):
        T[res], runs[res] = grating_T(mp, res, dev, counted, oblique=True)
        if not (np.all(np.isfinite(T[res])) and T[res].max() > 0):
            raise AssertionError(f"oblique grating T at {res}: {T[res]}")
    print(f"[15] oblique grating ({OBLIQUE_DEG} degrees) transmittance at "
          f"resolution {GRATING_RES}: {T[GRATING_RES].tolist()}", flush=True)
    d = rel_each(T[GRATING_TWIN_RES], want["oblique_T"])
    print(f"[15] oblique grating at resolution {GRATING_TWIN_RES}, card "
          f"(pair, K3) vs CPU (native complex): max rel {d:.3e}", flush=True)
    if not d <= 1e-4:
        raise AssertionError(f"oblique grating T: card and CPU differ by "
                             f"{d:.3e}")
    (s0, _), (s1, _) = runs[GRATING_RES]
    ker = s1.plan._resident_kernel
    for label, st0 in (("the run's state", s1.fields_state),
                       ("a random state", random_state(s1.plan, 43, dev))):
        err, rel, drel, _ = compare_resident(ker, st0, s1._t, 48)
        print(f"[15] K3 pair vs plain, oblique grating, from {label}, 48 "
              f"steps: state and accumulators max abs {err:.3e} (DTFT max "
              f"rel {drel:.3e})", flush=True)
        if not err == 0.0:
            raise AssertionError(f"K3's pair layout is not bit for bit "
                                 f"(from {label}): {err:.3e}")
        k3p["max_abs_err"] = max(k3p["max_abs_err"], err)
    nsteps, st, t_end = 1000, s1.fields_state, s1._t
    ms, call_ms = time_resident(
        lambda s_, n_: ker._run(s_, n_, t_end, ()), st, nsteps)
    ref = R.resident_ref(s1.plan)
    _, plain_ms = time_resident(lambda s_, n_: ref(s_, n_, t_end), st, 20,
                                reps=1)
    cost = R.step_cost(s1.plan, nsteps)
    b_ms, b_by = bound({"bytes": cost["bytes"] / nsteps,
                        "ops": cost["ops"] / nsteps})
    k3p.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    cells = int(np.prod(s1.gv.num))
    print(f"[15] K3 pair at the oblique grating ({cells} cells): {ms:.4f} "
          f"ms/step = {cells / ms / 1e6:.3f} GCells/s "
          f"({schedule_text(ker, nsteps, False)}); the wrapper's call "
          f"{call_ms:.4f}; plain {plain_ms:.4f}; bound {b_ms:.5f} ms/step "
          f"({b_by}) ({card})", flush=True)
    del s0, s1, st, ker, runs
    torch.cuda.empty_cache()

    # ---- 15.3: the 128^3 flagship, k_x = PAIR_KX ------------------------
    res, n, kx = 16.0, 128, PAIR_KX
    nsteps = 60
    sim, _ = flagship_sim(mp, n, res, dev, flux=False, kx=kx, chi2=False)
    plan = sim.plan
    if not (plan.real_pair and isinstance(plan.bloch_phase[0], complex)):
        raise AssertionError(f"128^3 k_x {kx}: not a real pair")
    sim.run(until=12 * sim.dt)                  # warm-up: builds
    ring = plan._t2_kernel
    if not (isinstance(ring, PX.PeriodicGhostT2Kernel) and ring.pair
            and ring.k3):
        raise AssertionError(f"128^3 pair: kernel {ring}")
    kers = ring.kers + ring.k3.kers + [k._k1 for k in ring.kers]
    for k in kers:
        k.launches = k.plain_steps = 0
    sim.routes.clear()
    HY.hybrid_routes(plan).clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(until=nsteps * sim.dt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per = ring.k3.kers[0].launches_per_call
    launches = [k.launches for k in kers]
    if dict(sim.routes) != {"hybrid": 1} \
            or dict(HY.hybrid_routes(plan)) != {"no_sample": 1} \
            or launches != [0, 0] + [nsteps // 3 * per] * 2 + [0, 0] \
            or any(k.plain_steps for k in kers):
        raise AssertionError(f"128^3 pair ghost ring: routes "
                             f"{dict(sim.routes)}, "
                             f"{dict(HY.hybrid_routes(plan))}, launches "
                             f"{launches}")
    k2p["launches"] += sum(launches)
    phase = complex(plan.bloch_phase[0])
    print(f"[15] 128^3 flagship without chi2, k_x = {kx} (phase "
          f"{phase:.4f}), no monitor: {nsteps} steps in {wall:.3f} s = "
          f"{wall / nsteps * 1e3:.4f} ms/step (phase 4's {main_ms:.4f}); the "
          f"pair ghost ring, extended storage "
          f"{ring.ext_plans[0].storage_shape}: {sum(launches)} K2 launches "
          f"at depth 3 ({per} a call and channel), routes "
          f"{dict(sim.routes)} ({card})", flush=True)
    se, _ = flagship_sim(mp, n, res, dev, flux=False, kx=kx, chi2=False,
                         use_fused=False)
    se.plan.slab_opt = True
    se.run(until=(nsteps + 12) * se.dt)
    err, rel = _pair_live_error(sim.fields_state, se.fields_state,
                                plan.gv.num[0])
    print(f"[15] pair ghost ring vs the eager pair stepper on the card after "
          f"{nsteps + 12} steps: live planes max abs {err:.3e}, over the "
          f"field maximum {rel:.3e} (gate 1e-6)", flush=True)
    if not rel <= 1e-6:
        raise AssertionError(f"pair ghost ring differs from the stepper: "
                             f"{rel:.3e}")
    states = ring._refresh(ring.from_full(sim.fields_state))
    for label, chans in (("the run's state", states),
                         ("a random state",
                          [random_state(ring.ext_plans[0], 47 + c, dev)
                           for c in (0, 1)])):
        for c in (0, 1):
            for d, rk in ((2, ring), (3, ring.k3)):
                err, _, _, _, _ = compare_k2(rk.ext_plans[c], d, 2, chans[c],
                                             sim._t, None)
                print(f"[15] K2 depth {d} vs plain on the pair ring, "
                      f"channel {c}, from {label}, 2 calls: max abs "
                      f"{err:.3e}", flush=True)
                if not err == 0.0:
                    raise AssertionError(f"K2 on the pair ring is not bit "
                                         f"for bit: {err:.3e}")
                k2p["max_abs_err"] = max(k2p["max_abs_err"], err)
    ext = ring.ext_plans[0]
    rows = xs_rows(ext, build_xs(ext, 36, sim._t))

    def ring_call(sts, r_):
        return ring.k3.step(sts, r_)

    ms, _ = time_steps(ring_call, [clone_state(x) for x in states], rows,
                       per=3)
    # the plain version of the same call: the refresh, then K2's plain
    # version on each channel (channel 1's rows swapped)
    p_ms, _ = time_steps(ring_plain(ring.k3),
                         [clone_state(x) for x in states], rows[:12], per=3)
    b_ms, b_by = bound(fdtd3d_t2.step_cost(ext, 3))
    # both channels: twice one channel's bound
    k2p.update(ms=ms, plain_ms=p_ms, bound_ms=2 * b_ms, bound_by=b_by)
    print(f"[15] K2 depth 3 on the pair ring, both channels and the refresh: "
          f"{ms:.4f} ms/call = {ms / 3:.4f} ms/step; plain (the refresh and "
          f"K2's plain version on both channels) {p_ms:.4f} ms/call; bound "
          f"{2 * b_ms:.4f} ms/call ({b_by}) ({card})", flush=True)
    del sim, se, states, ring, kers
    torch.cuda.empty_cache()
    # with the flux plane, 602 steps: K1's pair wrap every step
    nsteps = 602
    sim, fl = flagship_sim(mp, n, res, dev, kx=kx, chi2=False)
    plan = sim.plan
    sim.run(until=12 * sim.dt)
    k1 = plan._t2_kernel._k1
    if not isinstance(k1, PX.PairPeriodicXKernel):
        raise AssertionError(f"128^3 pair monitored: K1 {k1}")
    k1.launches = k1.plain_steps = 0
    sim.routes.clear()
    HY.hybrid_routes(plan).clear()
    # without chi2 the monitor decimates: the cycles' steps run K1, the
    # stretch's prefix and suffix the eager step
    prefix, d, ncyc, suffix = HY.cycle_structure(plan, sim._t, nsteps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(until=nsteps * sim.dt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if dict(sim.routes) != {"hybrid": 1} \
            or dict(HY.hybrid_routes(plan)) != {"full_state": 1} \
            or k1.launches != ncyc * d * K1_LAUNCHES or k1.plain_steps:
        raise AssertionError(f"128^3 pair monitored: routes "
                             f"{dict(sim.routes)}, "
                             f"{dict(HY.hybrid_routes(plan))}, K1 launches "
                             f"{k1.launches}")
    k1p["launches"] += k1.launches
    flux = sim.get_fluxes(fl)
    se, fe = flagship_sim(mp, n, res, dev, kx=kx, chi2=False,
                          use_fused=False)
    se.plan.slab_opt = True
    se.run(until=(nsteps + 12) * se.dt)
    fd = rel_diff(flux, se.get_fluxes(fe))
    err, rel = _pair_live_error(sim.fields_state, se.fields_state,
                                plan.gv.num[0])
    print(f"[15] 128^3 k_x = {kx} with the flux plane: {nsteps} steps in "
          f"{wall:.3f} s = {wall / nsteps * 1e3:.4f} ms/step; K1's pair wrap "
          f"every step of {ncyc} cycles of {d} (the full-state cycle; "
          f"{prefix} + {suffix} eager), launches {k1.launches}; "
          f"against the eager pair stepper on the card: fluxes max rel "
          f"{fd:.3e}, live planes max abs {err:.3e} (over the maximum "
          f"{rel:.3e}; gates 1e-6); flux {np.asarray(flux).tolist()} "
          f"({card})", flush=True)
    if not (fd <= 1e-6 and rel <= 1e-6 and np.abs(flux).max() > 1e-8):
        raise AssertionError(f"K1's pair wrap differs from the stepper: "
                             f"fluxes {fd:.3e}, state {rel:.3e}")
    st, t_end = sim.fields_state, sim._t
    for label, st0 in (("the run's state", st),
                       ("a random state", random_state(plan, 53, dev))):
        err, rel = compare_k1_from(plan, k1, st0, t_end)
        print(f"[15] K1's pair wrap vs plain, from {label}, 5 steps: max "
              f"abs {err:.3e}", flush=True)
        if not err == 0.0:
            raise AssertionError(f"K1's pair wrap is not bit for bit: "
                                 f"{err:.3e}")
        k1p["max_abs_err"] = max(k1p["max_abs_err"], err)
    rows = xs_rows(plan, build_xs(plan, 13, t_end))
    k1p["ms"], _ = time_steps(k1.step, clone_state(st), rows)
    k1p["plain_ms"], _ = time_steps(fdtd3d.step_ref(plan), clone_state(st),
                                    rows)
    k1p["bound_ms"], k1p["bound_by"] = bound(fdtd3d.step_cost(plan))
    print(f"[15] K1's pair wrap at 128^3: {k1p['ms']:.4f} ms/step, plain "
          f"{k1p['plain_ms']:.4f}, bound {k1p['bound_ms']:.4f} ms "
          f"({k1p['bound_by']}) ({card})", flush=True)
    del sim, se, st
    torch.cuda.empty_cache()
    return [k1p, k2p, k3p, k4p]


def compare_k2w(plan, st0, t0, ncall):
    """K2's x wrap (a PeriodicXT2Kernel of its own: these launches are not
    counted on the path's object) against steps_ref over `ncall` calls
    from state st0 at step t0; returns (abs, rel) over every plane, the
    dead ones too."""
    from meep_nl_tpu_torch.ops import fdtd3d_t2
    from meep_nl_tpu_torch.ops import periodicx as PX
    from meep_nl_tpu_torch.stepper.step import build_xs, xs_rows
    ker = PX.PeriodicXT2Kernel(plan)
    ref = fdtd3d_t2.steps_ref(plan, 2)
    rows = xs_rows(plan, build_xs(plan, 2 * ncall, t0))
    sk, sr = clone_state(st0), clone_state(st0)
    for c in range(ncall):
        xc = rows[2 * c:2 * c + 2]
        sk = ker.step(sk, xc)
        sr, _ = ref(sr, xc)
    if ker.launches != ncall or ker.plain_steps:
        raise AssertionError(f"K2's x wrap: launches {ker.launches}")
    return state_error(sk, sr)


def phase_wrap_bfast(mp, dev, card, blank, twins15):
    """Phase 16: monitored x-periodic cells two steps a call (K2's x wrap
    behind PeriodicXT2Kernel), then BFAST (K3/K4's PAIR_BFAST variant).
    `twins15`: (process, .npz path) of cpu_twins15, which phase 15 has
    waited for.  Returns the kernel table entries of K2's x wrap and K3
    and K4 with BFAST."""
    import numpy as np
    import torch
    from meep_nl_tpu_torch.ops import fdtd3d, fdtd3d_t2
    from meep_nl_tpu_torch.ops import hybrid as HY
    from meep_nl_tpu_torch.ops import periodicx as PX
    from meep_nl_tpu_torch.ops import resident as R
    from meep_nl_tpu_torch.stepper.step import build_xs, xs_rows
    k2w = _entry("fdtd3d_t2_k2_xwrap", "meep_nl_tpu_torch/csrc/fdtd3d_t2.cu",
                 K2_REPLACES, blank)
    k3b = _entry("resident_k3_bfast", "meep_nl_tpu_torch/csrc/resident.cu",
                 K3_REPLACES, blank)
    k4b = _entry("resident_k4_bfast", "meep_nl_tpu_torch/csrc/resident.cu",
                 K4_REPLACES, blank)
    with np.load(twins15[1]) as z:
        want = {k: z[k] for k in z.files}

    # ---- 16.1: the linear flagship x-periodic with its flux plane -------
    res, n, nsteps = 16.0, 128, 602
    for kx in (0.0, 1 / 16):
        sim, fl = flagship_sim(mp, n, res, dev, linear=True, kx=kx,
                               decimation=WRAP_DEC)
        plan = sim.plan
        sim.run(until=12 * sim.dt)                  # warm-up: builds
        ker = plan._t2_kernel
        if not (isinstance(ker, PX.PeriodicXT2Kernel) and ker.k3 is None):
            raise AssertionError(f"128^3 linear x-periodic monitored: "
                                 f"kernel {ker}")
        k1 = ker._k1
        for k in (ker, k1):
            k.launches = k.plain_steps = 0
        sim.routes.clear()
        HY.hybrid_routes(plan).clear()
        prefix, d, ncyc, suffix = HY.cycle_structure(plan, sim._t, nsteps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(until=nsteps * sim.dt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want_k2 = ncyc * (d // 2) * ker.launches_per_call
        want_k1 = ncyc * (d % 2) * K1_LAUNCHES
        if dict(sim.routes) != {"hybrid": 1} \
                or dict(HY.hybrid_routes(plan)) != {"full_state": 1} \
                or d < 3 or ker.launches != want_k2 \
                or k1.launches != want_k1 or ker.plain_steps \
                or k1.plain_steps:
            raise AssertionError(f"128^3 linear x-periodic monitored: "
                                 f"routes {dict(sim.routes)}, "
                                 f"{dict(HY.hybrid_routes(plan))}, cycle "
                                 f"{d}, K2 launches {ker.launches} (want "
                                 f"{want_k2}), K1 {k1.launches} (want "
                                 f"{want_k1})")
        k2w["launches"] += ker.launches
        phase = plan.bloch_phase[0]
        flux = sim.get_fluxes(fl)
        se, fe = flagship_sim(mp, n, res, dev, linear=True, kx=kx,
                              decimation=WRAP_DEC, use_fused=False)
        se.plan.slab_opt = True
        se.run(until=(nsteps + 12) * se.dt)
        fd = rel_diff(flux, se.get_fluxes(fe))
        err, rel = _live_error(sim.fields_state, se.fields_state,
                               plan.gv.num[0])
        print(f"[16] 128^3 linear flagship x-periodic (phase {phase}) with "
              f"the flux plane at DTFT decimation {d}: {nsteps} steps in "
              f"{wall:.3f} s = {wall / nsteps * 1e3:.4f} ms/step; "
              f"PeriodicXT2Kernel: {ncyc} cycles of {d} steps ({d // 2} K2 "
              f"x-wrap calls and {d % 2} K1 step a cycle; {prefix} + "
              f"{suffix} eager), K2 launches {ker.launches}, K1 "
              f"{k1.launches}, routes {dict(sim.routes)}; against the eager "
              f"stepper on the card: fluxes max rel {fd:.3e}, live planes "
              f"max abs {err:.3e} (over the maximum {rel:.3e}; gates 1e-6); "
              f"flux {np.asarray(flux).tolist()} ({card})", flush=True)
        if not (fd <= 1e-6 and rel <= 1e-6 and np.abs(flux).max() > 1e-8):
            raise AssertionError(f"K2's x wrap route differs from the "
                                 f"stepper: fluxes {fd:.3e}, state "
                                 f"{rel:.3e}")
        st, t_end = sim.fields_state, sim._t
        for label, st0 in (("the run's state", st),
                           ("a random state",
                            random_state(plan, 59, dev))):
            err, rel = compare_k2w(plan, st0, t_end, 3)
            print(f"[16] K2's x wrap vs plain (phase {phase}), from "
                  f"{label}, 3 calls: max abs {err:.3e}", flush=True)
            if not err == 0.0:
                raise AssertionError(f"K2's x wrap is not bit for bit: "
                                     f"{err:.3e}")
            k2w["max_abs_err"] = max(k2w["max_abs_err"], err)
        rows = xs_rows(plan, build_xs(plan, 24, t_end))
        ms, _ = time_steps(ker.step, clone_state(st), rows, per=2)
        k1_ms, _ = time_steps(k1.step, clone_state(st), rows)
        ref = fdtd3d_t2.steps_ref(plan, 2)
        p_ms, _ = time_steps(lambda s_, r_: ref(s_, r_)[0], clone_state(st),
                             rows[:10], per=2)
        b_ms, b_by = bound(fdtd3d_t2.step_cost(plan, 2))
        if kx:
            k2w.update(ms=ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
        del se, st
        # the same cell forced onto K1's x wrap (one K1 step a step)
        sf, _ = flagship_sim(mp, n, res, dev, linear=True, kx=kx,
                             decimation=WRAP_DEC)
        force_k1_route(sf)
        sf.run(until=12 * sf.dt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sf.run(until=nsteps * sf.dt)
        torch.cuda.synchronize()
        f_wall = time.perf_counter() - t0
        print(f"[16] K2's x wrap at 128^3 (phase {phase}): {ms:.4f} ms/call "
              f"= {ms / 2:.4f} ms/step; K1's x wrap {k1_ms:.4f} ms/step (x 2 "
              f"= {2 * k1_ms:.4f}); plain {p_ms:.4f} ms/call; bound "
              f"{b_ms:.4f} ms/call ({b_by}); {k2_items(ker)}; the whole run "
              f"{wall / nsteps * 1e3:.4f} ms/step against "
              f"{f_wall / nsteps * 1e3:.4f} forced onto K1's x wrap "
              f"({card})", flush=True)
        del sim, sf
        torch.cuda.empty_cache()

    # ---- 16.2: refl_angular_bfast.py as published (K3 and K4, BFAST) ----
    def counted(sim, **kw):
        R._kernel(sim.plan)
        wall, launches, probed = resident_run_counted(sim, **kw)
        ker = sim.plan._resident_kernel
        if probed or launches != sim.routes["resident"] or not launches \
                or ker.schedule[1]["direct"] != R.DIRECT_PAIR_BFAST:
            raise AssertionError(f"BFAST run: K3 launches {launches}, K4 "
                                 f"{probed}, routes {dict(sim.routes)}, "
                                 f"schedule {ker.schedule[1]}")
        k3b["launches"] += launches
        print(f"[16] refl_angular_bfast at resolution {sim.resolution:.0f} "
              f"({sim.plan.storage_shape}, periodic {sim.plan.periodic}, "
              f"real pair {sim.plan.real_pair}): {kw}, {sim._t} steps in "
              f"{wall:.3f} s = {wall / sim._t * 1e3:.4f} ms/step; K3 "
              f"launches {launches}, routes {dict(sim.routes)} ({card})",
              flush=True)

    Rf, sims = bfast_R(mp, BFAST_RES, dev, counted)
    freqs = np.linspace(BFAST["fcen"] - BFAST["df"] / 2,
                        BFAST["fcen"] + BFAST["df"] / 2, BFAST["nf"])
    print(f"[16] refl_angular_bfast R(f) at 30 degrees, resolution "
          f"{BFAST_RES}: " + "; ".join(
              f"f {f:.3f}: R {r:.5f} (Fresnel p-pol {fr:.5f})"
              for f, r, fr in zip(freqs, Rf, fresnel_p(freqs))),
          flush=True)
    if not (np.all(np.isfinite(Rf)) and np.all(Rf > 0)):
        raise AssertionError(f"BFAST R(f): {Rf}")
    R10, _ = bfast_R(mp, BFAST_TWIN_RES, dev, counted)
    d = rel_each(R10, want["bfast_R"])
    print(f"[16] refl_angular_bfast at resolution {BFAST_TWIN_RES}, card "
          f"(K3 on the real pair) vs CPU (native complex, the eager "
          f"stepper): R(f) max rel (each frequency against its own) "
          f"{d:.3e} (gate 1e-4); card {R10.tolist()}", flush=True)
    if not d <= 1e-4:
        raise AssertionError(f"BFAST R(f): card and CPU differ by {d:.3e}")
    s1 = sims[1]
    ker = s1.plan._resident_kernel
    # a probed stretch of the cell: K4 with BFAST
    ker.launches = ker.probed_launches = ker.plain_steps = 0
    s1.routes.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s1.run(mp.FieldProbe(mp.Ex, mp.Vector3(0, 0, -2.5)),
           until=600 * s1.dt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if dict(s1.routes) != {"resident": ker.probed_launches} \
            or ker.launches or ker.plain_steps or not ker.probed_launches:
        raise AssertionError(f"BFAST probed: routes {dict(s1.routes)}, K3 "
                             f"{ker.launches}, K4 {ker.probed_launches}")
    k4b["launches"] += ker.probed_launches
    print(f"[16] refl_angular_bfast probed (FieldProbe(Ex)), 600 steps: "
          f"{wall:.3f} s, K4 launches {ker.probed_launches}, routes "
          f"{dict(s1.routes)} ({card})", flush=True)
    probe = [s1._point_probe("pb", mp.Ex, mp.Vector3(0, 0, -2.5))]
    st, t_end = s1.fields_state, s1._t
    for label, st0 in (("the end state", st),
                       ("a random state", random_state(s1.plan, 61, dev))):
        for what, prb, entry in (("K3", (), k3b), ("K4", probe, k4b)):
            err, rel, drel, serr = compare_resident(ker, st0, t_end, 48, prb)
            print(f"[16] {what} with BFAST vs plain, from {label}, 48 "
                  f"steps: state, F and accumulators max abs {err:.3e}, "
                  f"series max abs {serr:.3e}", flush=True)
            if not (err == 0.0 and serr == 0.0):
                raise AssertionError(f"{what} with BFAST is not bit for bit "
                                     f"(from {label}): {err:.3e}, series "
                                     f"{serr:.3e}")
            entry["max_abs_err"] = max(entry["max_abs_err"], err, serr)
    nsteps = 1000
    ref = R.resident_ref(s1.plan)
    for what, prb, entry in (("K3", (), k3b), ("K4", probe, k4b)):
        ms, call_ms = time_resident(
            lambda s_, n_: ker._run(s_, n_, t_end, prb), st, nsteps)
        _, plain_ms = time_resident(
            lambda s_, n_: ref(s_, n_, t_end, prb), st, 20, reps=1)
        cost = R.step_cost(s1.plan, nsteps)
        b_ms, b_by = bound({"bytes": cost["bytes"] / nsteps,
                            "ops": cost["ops"] / nsteps})
        entry.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"[16] {what} with BFAST at refl_angular_bfast "
              f"({s1.plan.storage_shape}): {ms:.4f} ms/step "
              f"({schedule_text(ker, nsteps, bool(prb))}); the wrapper's "
              f"call {call_ms:.4f}; plain {plain_ms:.4f}; bound {b_ms:.6f} "
              f"ms/step ({b_by}) ({card})", flush=True)
    sn, _ = bfast_sim(mp, BFAST_RES, dev, True, bfast=False)
    sn.run(until=24 * sn.dt)
    kn = sn.plan._resident_kernel
    ms_n, _ = time_resident(
        lambda s_, n_: kn._run(s_, n_, sn._t, ()), sn.fields_state, nsteps)
    print(f"[16] the same cell without BFAST (real fields, "
          f"{sn.plan.storage_shape}): K3 {ms_n:.4f} ms/step "
          f"({schedule_text(kn, nsteps, False)}) against {k3b['ms']:.4f} "
          f"with BFAST ({card})", flush=True)
    del sims, s1, sn, st, ker, kn
    torch.cuda.empty_cache()
    return [k2w, k3b, k4b]


def main() -> int:
    import shutil
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    twins = start_cpu_twins()
    child, _, tmp = twins
    twins15 = start_cpu_twins15(tmp)
    try:
        return run_phases(twins, twins15)
    finally:
        for c in (child, twins15[0]):
            if c.poll() is None:
                c.kill()
                c.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def run_phases(twins, twins15) -> int:
    """Phases 1-16 (the module docstring); `twins`, `twins15`: the CPU
    runs (start_cpu_twins, start_cpu_twins15)."""
    import numpy as np
    import torch
    import meep_nl_tpu_torch as mp
    from meep_nl_tpu_torch.ops import fdtd3d, fdtd3d_t2
    from meep_nl_tpu_torch.ops import hybrid as HY
    from meep_nl_tpu_torch.stepper.step import build_xs, xs_rows

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    t_start = time.perf_counter()
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
    k5 = {"name": "fused_k5", "route": "cuda",
          "source": "meep_nl_tpu_torch/csrc/fused.cu",
          "replaces": K5_REPLACES, **blank}

    names, secs, reports = build_all()
    lib2 = fdtd3d_t2._lib()
    smem = (ctypes.c_int * 3)()
    if lib2.mnt_k2_smem(smem) != 0:
        raise RuntimeError("K2: the card's shared memory is unknown")
    print(f"[2] built {names} in {secs:.1f} s; K2: {lib2.mnt_nthr} threads "
          f"a block, tiles up to {lib2.mnt_tile}; shared memory: "
          f"{smem[0]} bytes a block at most, {smem[1]} an SM", flush=True)
    for name, what in (("fdtd3d", "K1"), ("fdtd3d_t2", "K2"),
                       ("resident", "K3/K4"), ("fused", "K5")):
        print(f"[2] nvcc -Xptxas -v, csrc/{name}.cu ({what}):\n"
              f"{reports[name]}", flush=True)

    # ---- 3: the kernels against their plain versions at 64^3 -------------
    for label, ball in (("flagship", True), ("vacuum", False)):
        sim, _ = flagship_sim(mp, 64, 8.0, dev, ball=ball)
        plan = sim.plan
        err, rel, launches = compare_k1(plan, 20, 7, dev)
        print(f"[3] K1 vs plain, {label} 64^3 x 20 steps: max abs "
              f"{err:.3e}, max rel {rel:.3e}, launches {launches}",
              flush=True)
        if not (err == 0.0 and launches == 20 * K1_LAUNCHES):
            raise AssertionError(f"K1 is not bit for bit with its plain "
                                 f"version ({label}): max abs {err:.3e}, "
                                 f"launches {launches}")
        caps = flux_planes(plan)
        for depth in (2, 3):
            # t0 near the source's peak, so the source rows matter
            err, rel, cerr, launches, ker = compare_k2(
                plan, depth, 6, random_state(plan, 7, dev), 150, caps)
            print(f"[3] K2 depth {depth} vs plain, {label} 64^3 x 6 calls, "
                  f"{len(ker.captures)} capture planes: state max abs "
                  f"{err:.3e}, max rel {rel:.3e}; captures max abs "
                  f"{cerr:.3e}; launches {launches}; {k2_items(ker)}",
                  flush=True)
            if not (err == 0.0 and cerr == 0.0
                    and launches == 6 * ker.launches_per_call):
                raise AssertionError(
                    f"K2 depth {depth} is not bit for bit with its plain "
                    f"version ({label}): max abs {err:.3e}, captures "
                    f"{cerr:.3e}, launches {launches}")
    phase_nine_sources(mp, dev)
    k5["max_abs_err"] = phase_k5_compare(mp, dev)

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
    # a call of a plan with a nonlinear box is two launches (its nonlinear
    # items, then its linear ones)
    k2_per = kers["k2_cap_d3"].launches_per_call
    expect(launches, {"k2_cap_d3": ncall * k2_per, "k1": tail * K1_LAUNCHES,
                      "k2_d2": 0,
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
          f"route: {ncall} K2 depth-{depth} capture calls ({k2_per} "
          f"launches each) + {tail} K1 steps, launches {launches}; flux "
          f"{flux.tolist()}", flush=True)
    k1["launches"] = launches["k1"]
    k2["launches"] = launches["k2_cap_d3"]
    main_ms = wall / nsteps * 1e3
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
    if not err == 0.0:
        raise AssertionError(f"K1 is not bit for bit at 128^3: max abs "
                             f"{err:.3e}")
    k1["max_abs_err"] = err
    caps = flux_planes(plan)
    k2["max_abs_err"] = 0.0
    for d in (2, 3):
        err, rel, cerr, _, _ = compare_k2(plan, d, 2, st, t_end, caps)
        print(f"[4] K2 depth {d} vs plain at 128^3 from the main path "
              f"state, 2 calls: state max abs {err:.3e}, max rel "
              f"{rel:.3e}; captures max abs {cerr:.3e}", flush=True)
        if not (err == 0.0 and cerr == 0.0):
            raise AssertionError(f"K2 depth {d} is not bit for bit at "
                                 f"128^3: max abs {err:.3e}, captures "
                                 f"{cerr:.3e}")
        k2["max_abs_err"] = max(k2["max_abs_err"], err, cerr)
    k1["ms"], _ = time_steps(ker1.step, clone_state(st), rows)
    k1["plain_ms"], _ = time_steps(ref, clone_state(st), rows)
    k1["bound_ms"], k1["bound_by"] = bound(fdtd3d.step_cost(plan))
    print(f"[4] K1 {k1['ms']:.4f} ms/step, plain {k1['plain_ms']:.4f} "
          f"ms/step, bound {k1['bound_ms']:.4f} ms ({k1['bound_by']}) "
          f"at 128^3 flagship ({card})", flush=True)
    parts = launch_breakdown(ker1, clone_state(st), rows[0])
    print(f"[4] K1 launches at 128^3 flagship: {breakdown_text(parts)}"
          f" ({card})", flush=True)
    rows = xs_rows(plan, build_xs(plan, 36, t_end))
    capker = kers["k2_cap_d3"]
    for label, ker in (("depth 3 + captures", capker),
                       ("depth 2", kers["k2_d2"])):
        d = ker.depth
        ms, _ = time_steps(ker.step, clone_state(st), rows, per=d)
        b_ms, b_by = bound(fdtd3d_t2.step_cost(plan, d, len(ker.captures)))
        print(f"[4] K2 {label}: {ms:.4f} ms/call = {ms / d:.4f} ms/step; "
              f"K1's launches x {d} {parts['step'][0] * d:.4f} ms; bound "
              f"{b_ms:.4f} ms/call ({b_by}); {k2_items(ker)} at 128^3 "
              f"flagship ({card})", flush=True)
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
    expect(launches1, {"k1": nsteps * K1_LAUNCHES},
           "128^3 flagship K1 route")
    fdiff = rel_diff(sim1.get_fluxes(fl1), flux)
    print(f"[4] the same run through the K1-only route: "
          f"{wall1 / nsteps * 1e3:.4f} ms/step, "
          f"{cells * nsteps / wall1 / 1e9:.3f} GCells/s, launches "
          f"{launches1}; fluxes differ from the K2 route by {fdiff:.3e} "
          f"({card})", flush=True)
    if not fdiff <= 1e-4:
        raise AssertionError(f"K2 and K1 routes' fluxes differ: {fdiff:.3e}")
    del sim, sim1, st

    # the same scene, small, on the card and on the CPU: both take the
    # resident route (K3 in 3D on the card, its plain version on the CPU)
    out = {}
    for d in ("cuda", "cpu"):
        s2, f2 = flagship_sim(mp, 16, 8.0, d, pml=0.25)
        s2.run(until=200 * s2.dt)
        out[d] = (s2.get_fluxes(f2), s2.get_array(mp.Ez))
        rk = s2.plan._resident_kernel
        if dict(s2.routes) != {"resident": 1} or (
                (rk.launches, rk.plain_steps) != (1, 0) if d == "cuda"
                else (rk.launches, rk.plain_steps) != (0, 200)):
            raise AssertionError(f"16^3 scene on {d}: routes "
                                 f"{dict(s2.routes)}, K3 launches "
                                 f"{rk.launches}, plain {rk.plain_steps}")
        if d == "cuda":
            print(f"[4] 16^3 scene ({s2.plan.storage_shape}) on the resident "
                  f"route: {schedule_text(rk, 200, False)}", flush=True)
            # K3 in 3D against its plain version, from the run's state and
            # from a seeded random one (every site's chi2 partner sums on)
            for what, st0 in (("the run's state", s2.fields_state),
                              ("a random state",
                               random_state(s2.plan, 13, d))):
                err, rel, drel, _ = compare_resident(rk, st0, s2._t, 20)
                print(f"[4] K3 vs plain at 16^3 from {what}, 20 steps: max "
                      f"abs {err:.3e}, max rel {rel:.3e}; DTFT max rel "
                      f"{drel:.3e}", flush=True)
                if not (rel <= 1e-5 and drel <= 1e-5):
                    raise AssertionError(f"K3 disagrees at 16^3 from {what}:"
                                         f" rel {rel:.3e}, DTFT {drel:.3e}")
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
            kp = path_kernels(sim.plan)
            expect(launches,
                   {"k2_d3": ncyc * n3 * kp["k2_d3"].launches_per_call,
                    "k2_d2": ncyc * npair * kp["k2_d2"].launches_per_call,
                    "k1": ncyc * rem * K1_LAUNCHES},
                   "96^3 linear K2 route")
        else:
            expect(launches, {"k1": nsteps * K1_LAUNCHES},
                   "96^3 linear K1 route")
        fluxes[route] = sim.get_fluxes(fl)
        if route == "k2":
            # the kernels of this path against their plain versions at its
            # shapes, from its end state (these launches are not counted)
            plan, st, t_end = sim.plan, sim.fields_state, sim._t
            for d in (3, 2):
                err, rel, _, _, ker = compare_k2(plan, d, 2, st, t_end,
                                                 None)
                print(f"[5] K2 depth {d} vs plain at {n}^3 linear from the "
                      f"run's state, 2 calls: max abs {err:.3e}, max rel "
                      f"{rel:.3e}; {k2_items(ker)}", flush=True)
                if not err == 0.0:
                    raise AssertionError(f"K2 depth {d} is not bit for bit "
                                         f"at {n}^3 linear: max abs "
                                         f"{err:.3e}")
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
    torch.cuda.empty_cache()

    # ---- 6: vacuum uPML 255^3, the fully fused route --------------------
    n = 255
    cells = n ** 3
    sim, _ = flagship_sim(mp, n, res, dev, flux=False, ball=False)
    plan = sim.plan
    sim.run(until=9 * sim.dt)                       # warm-up
    nsteps = 50
    wall, launches = timed_run(sim, nsteps)
    kers = path_kernels(plan)
    expect(launches, {"k2_d3": nsteps // 3 * kers["k2_d3"].launches_per_call,
                      "k1": (nsteps % 3) * K1_LAUNCHES,
                      "k2_d2": 0}, "255^3 vacuum fused route")
    st = sim.fields_state
    rows = xs_rows(plan, build_xs(plan, 24, sim._t))
    print(f"[6] vacuum uPML 255^3 Simulation.run: {nsteps} steps, "
          f"launches {launches}: {wall / nsteps * 1e3:.4f} ms/step = "
          f"{cells * nsteps / wall / 1e9:.3f} GCells/s ({card})",
          flush=True)
    parts = launch_breakdown(kers["k1"], clone_state(st), rows[0])
    for d, ker in ((3, kers["k2_d3"]), (2, kers["k2_d2"])):
        err, rel, cerr, _, _ = compare_k2(plan, d, 1, st, sim._t,
                                          [("ez", n // 2), ("hy", n // 2)])
        if not (err == 0.0 and cerr == 0.0):
            raise AssertionError(f"K2 depth {d} is not bit for bit at "
                                 f"255^3: max abs {err:.3e}, captures "
                                 f"{cerr:.3e}")
        k2["max_abs_err"] = max(k2["max_abs_err"], err, cerr)
        ms, _ = time_steps(ker.step, clone_state(st), rows, per=d)
        b_ms, b_by = bound(fdtd3d_t2.step_cost(plan, d))
        print(f"[6] K2 depth {d} at 255^3: max abs err {err:.3e} (captures "
              f"{cerr:.3e}); {ms:.4f} ms/call = {ms / d:.4f} ms/step = "
              f"{cells * d / ms / 1e6:.3f} GCells/s; K1's launches x {d} "
              f"{parts['step'][0] * d:.4f} ms; bound {b_ms:.4f} ms/call "
              f"({b_by}); {k2_items(ker)} ({card})", flush=True)
    err1, rel = compare_k1_from(plan, kers["k1"], st, sim._t)
    if not rel <= 1e-5:
        raise AssertionError(f"K1 disagrees at 255^3: rel {rel:.3e}")
    k1["max_abs_err"] = max(k1["max_abs_err"], err1)
    k_ms, _ = time_steps(kers["k1"].step, clone_state(st), rows[:11])
    parts = breakdown_text(parts)
    p_ms, _ = time_steps(fdtd3d.step_ref(plan), clone_state(st), rows[:11])
    b_ms, b_by = bound(fdtd3d.step_cost(plan))
    print(f"[6] K1 at 255^3: max abs err {err1:.3e} over 5 steps; "
          f"{k_ms:.4f} ms/step = "
          f"{cells / k_ms / 1e6:.3f} GCells/s; plain {p_ms:.4f} ms/step; "
          f"bound {b_ms:.4f} ms ({b_by}); launches: {parts} ({card})",
          flush=True)

    del sim, st
    k3, k4, modes, ring_series = phase_resident(mp, dev, card, blank)
    phase_use_pallas(mp, dev, card, fluxes["k2"], k5)
    launches, err = phase_fused_probed(mp, dev, card)
    k1["launches"] += launches
    k1["max_abs_err"] = max(k1["max_abs_err"], err)
    phase_monitors(mp, dev, card, modes, main_ms, k1, k3, twins)
    phase_mirror(mp, dev, card, main_ms, (ring_series, modes),
                 (k1, k2, k3, k4), twins)
    phase_rotate(mp, dev, card, (k3, k4), twins)
    wrap = phase_periodic(mp, dev, card, main_ms, blank, twins)
    pair = phase_complex(mp, dev, card, main_ms, blank, twins15)
    wrap2 = phase_wrap_bfast(mp, dev, card, blank, twins15)
    print(f"[16] phases 1-16 took {time.perf_counter() - t_start:.1f} s",
          flush=True)

    print(card)
    print(json.dumps({"kernels": [k1, k2, k3, k4, k5] + wrap + pair
                      + wrap2}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cpu-twins"] and len(sys.argv) == 3:
        sys.exit(cpu_twins(sys.argv[2]))
    if sys.argv[1:2] == ["--cpu-twins15"] and len(sys.argv) == 3:
        sys.exit(cpu_twins15(sys.argv[2]))
    sys.exit(main())
