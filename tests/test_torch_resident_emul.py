"""K3/K4's CUDA source on the CPU: csrc/resident.cu compiled by the host's
C++ compiler against the stand-in headers of tests/cuda_stub and run
through the real wrapper (`ResidentKernel._run_cuda`), one host thread per
block and one thread per block's threads, against the plain version
`resident_ref`.

This executes the kernel's own code -- the tiles and their staged boxes,
the passes of T steps and the grid barrier between them (the stub's
blocks take turns in a chosen order: forward, reversed, shuffled), the two
state sets, the fused and split E/H sub-updates, the per-tile source
lists, the P/PP roles of odd and even steps across pass and chunk seams,
the DTFT with its centred average, the probe products and sums -- through
the wrapper's argument block.  Both sides round alike (no FMA
contraction), so they agree bit for bit.  The tile cases force small tiles
(at least two per axis, T not dividing the stretch) with a source, probe
points and the flux line on tile seams.  One thread per block hides every
race inside a block; the parallel kernel is held against the plain version
on the card by test_torch_resident_gpu.py and chip_smoke.py.
`test_boxes_keep_every_read_valid` replays the schedule's boxes
(resident.boxes, tiling) on version counters.  Skips where there is no
g++."""

import ctypes
import itertools
import os
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

import meep_nl_tpu_torch as mp
from meep_nl_tpu_torch.ops import _build
from meep_nl_tpu_torch.ops import resident as R
from meep_nl_tpu_torch.stepper import step as TS

torch.set_num_threads(2)
STUB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_stub")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    out = str(tmp_path_factory.mktemp("k3") / "libk3_host.so")
    subprocess.run(
        ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-pthread", "-Wno-unknown-pragmas", "-I", STUB, "-I", _build.CSRC,
         "-x", "c++",
         os.path.join(_build.CSRC, "resident.cu"), "-o", out], check=True)
    return R.bind(ctypes.CDLL(out))


def scene(kind, device="cpu", res=10):
    """tm: 2D TM, eps=12 cylinder, PML, Ez point source, flux line; disp:
    2D Lorentz + chi2-NR block; te: 2D TE with an Hz point source and an Ex
    line source on a chi2-NR cylinder (E reads neighbours: split phases);
    flag-tm / flag-te: the flagship material (eps=4, a Lorentz pole,
    full-tensor chi2) on a cylinder, TM or TE; tm-many: tm with 25 more
    flux lines (52 DTFT monitors); 3d: a 24^3 eps=8 ball with a flux
    plane; nl3d: the flagship material on a ball in a 16x15x15 grid (its 42
    staged arrays fit tiles only at T = 1); poles3d: a ball with 4 E and 4
    H Lorentz poles in that grid (99 staged arrays, more than
    MAXSLOT); ldos / ldos-te: tm / te with the DFT monitors of the LDOS
    (complex weights, uncentred), energy (D/B beside E/H) and dft fields
    kinds; te-lin: te without its chi2 (a rotation declines chi2/chi3).
    A suffix "+x", "+xy", ... declares a phase +1 Mirror on each axis
    named: every cell count here is even, so each is a node mirror (the
    fold ghost in the D curl), the cell halved there.  A suffix "@r2" or
    "@r4" (phase -1 with a trailing "-") declares Rotate2("z") or
    Rotate4("z") (the C2 / C4 ghosts, the direct schedule): the cell is
    made square for Rotate4, the flux line moved into the retained
    quadrant and the line source dropped (an in-plane source outside the
    quadrant is refused).  A suffix "~y", "~xy-", ... makes the axes named
    Bloch-periodic through k_point (phase +1, or -1 at the zone edge with
    a trailing "-"; the direct schedule's WRAP variant): the PML stays on
    the other axes, and a second flux monitor spans the periodic axes
    (its centred average reads across the wrap).  A trailing "*" asks for
    complex fields in real-pair storage (the PAIR variant): with "~", k =
    0.13 / the cell along the axes named (a complex phase), without, the
    cell keeps its PML and takes force_complex_fields.  bf: BFAST
    (bfast_scaled_k (0.5, 0, 0), refl_angular_bfast's setup cut down): a
    0.25 x 0.25 x 3 cell at resolution 8 (two sites across each periodic
    axis, k = 0 on x and y), PML on z, glass on the upper half, an Ex plane
    source and a z-normal flux plane; bf-pml: BFAST (0.3, 0.2, 0) in a
    1 x 1 x 2 cell with PML on every face and an eps=4 ball (no wrap; both
    of a curl's terms, the decay of both chains).  Both are complex, so
    they take the PAIR_BFAST variant (written with the trailing "*").
    cyl*, kz*: `cyl_scene`'s cylindrical and special_kz cells (the CYL
    variants)."""
    if kind.startswith(("cyl", "kz")):
        return cyl_scene(kind, device)
    if kind.startswith(AX_KINDS):
        return ax_scene(kind, device)
    pair = kind.endswith("*")
    kind = kind.rstrip("*")
    kind, _, per = kind.partition("~")
    per_axes = per.rstrip("-")
    kind, _, rot = kind.partition("@")
    kind, _, mirrors = kind.partition("+")
    src = [mp.Source(mp.GaussianSource(0.5, fwidth=0.2), mp.Ez,
                     center=mp.Vector3(-2, 0.1))]
    geom = [mp.Cylinder(radius=1.0, material=mp.Medium(epsilon=12))]
    cell, flux_size = mp.Vector3(6, 5), mp.Vector3(0, 1.5)
    if kind.startswith("flag"):
        geom = [mp.Cylinder(radius=1.2, material=mp.Medium(
            epsilon=4.0, chi2=0.05, chi2_full_tensor=True,
            E_susceptibilities=[mp.LorentzianSusceptibility(
                frequency=2.0, gamma=0.05, sigma=0.2)]))]
        if kind == "flag-te":
            src = [mp.Source(mp.GaussianSource(0.5, fwidth=0.2), mp.Ey,
                             center=mp.Vector3(-2, 0.1))]
    elif kind == "disp":
        geom = [mp.Block(size=mp.Vector3(2, 2, mp.inf), material=mp.Medium(
            epsilon=3, chi2=0.2, chi2_full_tensor=True,
            E_susceptibilities=[mp.LorentzianSusceptibility(
                frequency=1.1, gamma=0.1, sigma=0.4)]))]
    elif kind in ("te", "ldos-te", "te-lin"):
        geom = [mp.Cylinder(radius=1.0, material=mp.Medium(
            epsilon=4, chi2=0.1, chi2_full_tensor=True)
            if kind != "te-lin" else mp.Medium(epsilon=4))]
        src = [mp.Source(mp.GaussianSource(0.5, fwidth=0.2), mp.Hz,
                         center=mp.Vector3(-2, 0.3)),
               mp.Source(mp.GaussianSource(0.6, fwidth=0.2), mp.Ex,
                         center=mp.Vector3(-2, 0.3), size=mp.Vector3(0, 1))]
    elif kind == "3d":
        geom = [mp.Sphere(radius=0.7, material=mp.Medium(epsilon=8))]
        src = [mp.Source(mp.GaussianSource(0.8, fwidth=0.3), mp.Ez,
                         center=mp.Vector3(-0.6, 0, 0))]
        cell, res, flux_size = mp.Vector3(3, 3, 3), 8, mp.Vector3(0, 1, 1)
    elif kind in ("nl3d", "poles3d"):
        def poles(n, f0):
            return [mp.LorentzianSusceptibility(
                frequency=f0 + 0.3 * i, gamma=0.1, sigma=0.2 / (i + 1))
                for i in range(n)]
        mat = mp.Medium(epsilon=4.0, chi2=0.05, chi2_full_tensor=True,
                        E_susceptibilities=poles(1, 2.0)) \
            if kind == "nl3d" else \
            mp.Medium(epsilon=3.0, E_susceptibilities=poles(4, 1.1),
                      H_susceptibilities=poles(4, 1.3))
        geom = [mp.Sphere(radius=0.5, material=mat)]
        src = [mp.Source(mp.GaussianSource(0.8, fwidth=0.3), mp.Ez,
                         center=mp.Vector3(-0.45, 0.05, 0))]
        cell, res, flux_size = mp.Vector3(2, 2, 2), 7, mp.Vector3(0, 1, 1)
    pml = 0.5 if kind in ("nl3d", "poles3d") else 0.8
    syms = [mp.Mirror(d) for d in mirrors]
    flux_y = 0.0
    if rot:
        syms = [(mp.Rotate4 if rot.startswith("r4") else mp.Rotate2)(
            "z", phase=-1 if rot.endswith("-") else 1)]
        if rot.startswith("r4"):
            cell = mp.Vector3(cell.x, cell.x, cell.z)
        src = [s for s in src if s.size is None]
        flux_y = 0.8
    axes = "xyz" if cell.z else "xy"
    layers, k = [mp.PML(pml)], None
    bfast = None
    if kind.startswith("bf"):
        src = [mp.Source(mp.GaussianSource(0.8, fwidth=0.4), mp.Ex,
                         center=mp.Vector3(0, 0, -0.5),
                         size=mp.Vector3(0.25, 0.25, 0))]
        if kind == "bf":
            cell, res, flux_size = mp.Vector3(0.25, 0.25, 3), 8, \
                mp.Vector3(0.25, 0.25, 0)
            geom = [mp.Block(center=mp.Vector3(0, 0, 0.75),
                             size=mp.Vector3(mp.inf, mp.inf, 1.5),
                             material=mp.Medium(epsilon=2.25))]
            layers, k = [mp.PML(0.5, direction=mp.Z)], mp.Vector3()
            bfast = mp.Vector3(0.5, 0, 0)
        else:
            cell, res, flux_size = mp.Vector3(1, 1, 2), 8, mp.Vector3(0.5,
                                                                    0.5, 0)
            geom = [mp.Sphere(radius=0.3, material=mp.Medium(epsilon=4))]
            layers, bfast = [mp.PML(0.25)], mp.Vector3(0.3, 0.2, 0)
        axes = "xyz"
    if per:
        layers = [mp.PML(pml, direction=d) for d in axes
                  if d not in per_axes]
        edge = per.endswith("-")
        kw = 0.13 if pair else 0.5 if edge else 0.0
        k = mp.Vector3(*[kw / getattr(cell, d) if d in per_axes else 0.0
                         for d in "xyz"])
    kw = {}
    if bfast is not None:
        kw = {"bfast_scaled_k": bfast,
              "Courant": (1 - max(abs(v) for v in bfast)) / np.sqrt(3)}
    sim = mp.Simulation(cell_size=cell, resolution=res, geometry=geom,
                        sources=src, boundary_layers=layers,
                        device=device, symmetries=syms, k_point=k,
                        force_complex_fields=pair, **kw)
    sim.add_flux(0.5, 0.2, 3, mp.FluxRegion(
        center=mp.Vector3(0.4 if pml == 0.5 else 0.9, flux_y, 0)
        if bfast is None else mp.Vector3(0, 0, -0.3), size=flux_size))
    if per:
        normal = ([d for d in axes if d not in per_axes] + ["y"])[0]
        sim.add_flux(0.5, 0.2, 2, mp.FluxRegion(
            center=mp.Vector3(**{normal: 0.3}),
            size=mp.Vector3(**{d: 0 if d == normal else getattr(cell, d)
                               for d in axes})))
    if kind.startswith("ldos"):
        # a complex amplitude: the weights conj(amplitude) have both parts
        for s in sim.sources:
            s.amplitude = 0.8 - 0.6j
        sim.add_ldos(0.5, 0.2, 3)
        sim.add_energy(0.5, 0.2, 2, mp.EnergyRegion(
            center=mp.Vector3(0.2, 0), size=mp.Vector3(1.3, 1.1)))
        sim.add_dft_fields([COMP.get(kind, "ez")], 0.5, 0.2, 2,
                           center=mp.Vector3(-0.3, 0.2),
                           size=mp.Vector3(1.5, 0.8))
    if kind == "tm-many":
        for i in range(25):
            sim.add_flux(0.5, 0.2, 2, mp.FluxRegion(
                center=mp.Vector3(-1.8 + 0.15 * i, 0), size=flux_size))
    old = os.environ.get("MNT_REAL_PAIR")
    os.environ["MNT_REAL_PAIR"] = "1"
    try:
        sim.init_sim()
    finally:
        if old is None:
            del os.environ["MNT_REAL_PAIR"]
        else:
            os.environ["MNT_REAL_PAIR"] = old
    assert sim.plan.real_pair == pair and sim.plan.complex_fields == pair
    return sim.plan


def cyl_scene(kind, device="cpu"):
    """The CYL variants' scenes.  cylM (M = 0, 1, -1, 3; m != 0 needs the
    trailing "*", the real pair): an (r, z) cell 1.6 x 2.4 at resolution
    10 with PML 0.5 on the high r side and both z sides (so the z PML
    meets the axis in two corners), an eps=4 ring (0.5 < r < 0.9), a point
    source on the axis (Ez, m = 0) or off it (Er at r = 0.6, m != 0), an
    r-normal and a z-normal flux line (the 2 pi r measure in their
    weights) and an energy box reaching the axis.  kz*: special_kz's
    vacuum-dispersion cell (1 x 1 at resolution 16, Courant 0.25, k =
    (0.2, 0, 0.3): Bloch-periodic on both axes, a complex phase on x) with
    a flux line across it; kz-pml*: a 3 x 2 cell at resolution 10 with PML
    0.5 on every side, an eps=4 cylinder and k = (0, 0, 0.4)."""
    pair = kind.endswith("*")
    kind = kind.rstrip("*")
    if kind.startswith("cyl"):
        m = int(kind[3:])
        src = mp.Source(mp.GaussianSource(0.8, fwidth=0.4),
                        mp.Ez if m == 0 else mp.Er,
                        center=mp.Vector3(0.0 if m == 0 else 0.6, 0, 0.1))
        sim = mp.Simulation(
            cell_size=mp.Vector3(1.6, 0, 2.4), resolution=10,
            dimensions=mp.CYLINDRICAL, m=m, sources=[src],
            geometry=[mp.Block(center=mp.Vector3(0.7, 0, 0),
                               size=mp.Vector3(0.4, mp.inf, mp.inf),
                               material=mp.Medium(epsilon=4))],
            boundary_layers=[mp.PML(0.5)], device=device,
            force_complex_fields=pair and m == 0)
        sim.add_flux(0.8, 0.4, 3, mp.FluxRegion(
            center=mp.Vector3(0.9, 0, 0), size=mp.Vector3(0, 0, 1.2)))
        sim.add_flux(0.8, 0.4, 2, mp.FluxRegion(
            center=mp.Vector3(0.45, 0, 0.5), size=mp.Vector3(0.9, 0, 0)))
        sim.add_energy(0.8, 0.4, 2, mp.EnergyRegion(
            center=mp.Vector3(0.3, 0, -0.2), size=mp.Vector3(0.6, 0, 0.4)))
    else:
        pml = kind == "kz-pml"
        sim = mp.Simulation(
            cell_size=mp.Vector3(3, 2) if pml else mp.Vector3(1, 1),
            resolution=10 if pml else 16, Courant=0.25,
            geometry=[mp.Cylinder(radius=0.5, material=mp.Medium(
                epsilon=4))] if pml else [],
            sources=[mp.Source(mp.GaussianSource(0.36, fwidth=0.25), mp.Ex,
                               center=mp.Vector3(0.1, -0.17))],
            boundary_layers=[mp.PML(0.5)] if pml else [],
            k_point=mp.Vector3(0, 0, 0.4) if pml
            else mp.Vector3(0.2, 0, 0.3), device=device)
        sim.add_flux(0.36, 0.25, 3, mp.FluxRegion(
            center=mp.Vector3(0.2, 0), size=mp.Vector3(0, 0.8)),
            decimation_factor=1)
    old = os.environ.get("MNT_REAL_PAIR")
    os.environ["MNT_REAL_PAIR"] = "1"
    try:
        sim.init_sim()
    finally:
        if old is None:
            del os.environ["MNT_REAL_PAIR"]
        else:
            os.environ["MNT_REAL_PAIR"] = old
    assert sim.plan.real_pair == pair and sim.plan.complex_fields == pair
    return sim.plan


#: the anisotropic modes' scenes (`ax_scene`)
AX_KINDS = ("aniso", "tensor", "asig", "gyro")


def ax_scene(kind, device="cpu"):
    """The OFFDIAG and GYRO modes' scenes, 2D cells 6 x 5 at resolution 10
    with PML 0.8 (3D: 2 x 2 x 2 at resolution 7, PML 0.5), sources and a
    flux line as `scene`'s.  aniso: TE (an Hz point and an Ex line source)
    on a block of a uniaxial crystal rotated 30 degrees about z (xy
    off-diagonal rows); aniso-pole: that block with a Lorentz pole (fused
    into E's update, its P in the partner's D - P that E reads at its
    neighbours); tensor: TE on an eps=4 cylinder with
    subpixel_tensor; asig: that cylinder with a Lorentz pole whose sigma
    has off-diagonal rows (added to the rasterized MaterialSpec: no medium
    makes one), whose new P holds only where its diagonal sigma is
    nonzero; gyro-h: TM (Ez) on a cylinder of a saturated gyrotropic
    H-family pole biased along z (every component live); gyro-e: TE on
    the rotated block with E-family gyrotropic Lorentzian and Drude poles
    (tilted biases) beside a plain Lorentz pole; gyro3d: a ball of a
    crystal rotated about (1, 1, 1) (all three off-diagonal entries) with
    a saturated H pole and a gyrotropic Lorentzian E pole."""
    te = [mp.Source(mp.GaussianSource(0.5, fwidth=0.2), mp.Hz,
                    center=mp.Vector3(-2, 0.3)),
          mp.Source(mp.GaussianSource(0.6, fwidth=0.2), mp.Ex,
                    center=mp.Vector3(-2, 0.3), size=mp.Vector3(0, 1))]
    src = te
    cell, res, pml, flux = mp.Vector3(6, 5), 10, 0.8, mp.Vector3(0, 1.5)
    rotated = mp.Medium(epsilon_diag=mp.Vector3(2.0, 5.0, 3.0)).rotate(
        mp.Vector3(0, 0, 1), np.pi / 6)
    block = mp.Vector3(2, 2, mp.inf)
    kw = {}
    if kind == "aniso":
        geom = [mp.Block(size=block, material=rotated)]
    elif kind == "aniso-pole":
        rotated.E_susceptibilities = [mp.LorentzianSusceptibility(
            frequency=1.3, gamma=0.1, sigma=0.6)]
        geom = [mp.Block(size=block, material=rotated)]
    elif kind in ("tensor", "asig"):
        geom = [mp.Cylinder(radius=1.0, material=mp.Medium(epsilon=4))]
        kw = {"subpixel_tensor": kind == "tensor"}
    elif kind == "gyro-h":
        geom = [mp.Cylinder(radius=1.0, material=mp.Medium(
            epsilon=6, H_susceptibilities=[
                mp.GyrotropicSaturatedSusceptibility(
                    frequency=0.9, gamma=0.05, sigma=0.8, alpha=0.05,
                    bias=mp.Vector3(0, 0, 1))]))]
        src = [mp.Source(mp.GaussianSource(0.5, fwidth=0.2), mp.Ez,
                         center=mp.Vector3(-2, 0.1))]
    elif kind == "gyro-e":
        rotated.E_susceptibilities = [
            mp.GyrotropicLorentzianSusceptibility(
                frequency=1.2, gamma=0.1, sigma=0.5,
                bias=mp.Vector3(0.1, 0.2, 0.6)),
            mp.LorentzianSusceptibility(frequency=1.5, gamma=0.1,
                                        sigma=0.2),
            mp.GyrotropicDrudeSusceptibility(
                frequency=0.8, gamma=0.2, sigma=0.3,
                bias=mp.Vector3(0, 0, 0.5))]
        geom = [mp.Block(size=block, material=rotated)]
    else:                                  # gyro3d
        mat = mp.Medium(
            epsilon_diag=mp.Vector3(2.0, 4.0, 3.0), H_susceptibilities=[
                mp.GyrotropicSaturatedSusceptibility(
                    frequency=0.9, gamma=0.05, sigma=0.6, alpha=0.05,
                    bias=mp.Vector3(1, 1, 1))], E_susceptibilities=[
                mp.GyrotropicLorentzianSusceptibility(
                    frequency=1.2, gamma=0.1, sigma=0.3,
                    bias=mp.Vector3(0, 0.3, 0.4))]).rotate(
                        mp.Vector3(1, 1, 1), 0.5)
        geom = [mp.Sphere(radius=0.5, material=mat)]
        src = [mp.Source(mp.GaussianSource(0.8, fwidth=0.3), mp.Ez,
                         center=mp.Vector3(-0.45, 0.05, 0))]
        cell, res, pml, flux = mp.Vector3(2, 2, 2), 7, 0.5, \
            mp.Vector3(0, 1, 1)
    sim = mp.Simulation(cell_size=cell, resolution=res, geometry=geom,
                        sources=src, boundary_layers=[mp.PML(pml)],
                        device=device, **kw)
    sim.add_flux(0.5, 0.2, 3, mp.FluxRegion(
        center=mp.Vector3(0.4 if pml == 0.5 else 0.9, 0, 0), size=flux))
    if kind != "asig":
        sim.init_sim()
        return sim.plan
    from meep_nl_tpu_torch.models import scene as SC
    raster = SC.rasterize

    def with_offdiag_sigma(*args, **kw):
        mat = raster(*args, **kw)
        inside = (mat.chi1inv["ex"]["x"] < 0.5).astype(float)
        mat.pols.append(mp.PolSpec(
            field_type="e", omega0=1.1, gamma=0.1,
            sigma={("ex", "x"): 0.4 * inside, ("ex", "y"): 0.15 * inside,
                   ("ey", "y"): 0.4 * inside,
                   ("ey", "x"): -0.1 * inside}))
        return mat

    SC.rasterize = with_offdiag_sigma
    try:
        sim.init_sim()
    finally:
        SC.rasterize = raster
    return sim.plan


#: the component each scene's probes read (else ez)
COMP = {"te": "hz", "flag-te": "ey", "ldos-te": "hz", "te-lin": "hz",
        "cyl1": "er", "cyl-1": "hp", "cyl3": "ez", "kz": "hy",
        "kz-pml": "ez", "aniso": "hz", "aniso-pole": "hz",
        "tensor": "hz", "asig": "ey",
        "gyro-e": "ey", "gyro-h": "hx"}


def base_kind(kind):
    """A scene's kind without its symmetries', periodic axes' and pair
    suffixes."""
    return kind.rstrip("*").partition("~")[0].partition("@")[0] \
        .partition("+")[0]


def random_state(plan, seed):
    rng = np.random.default_rng(seed)
    st = TS.init_state(plan)

    def rnd(t):
        return torch.from_numpy(1e-2 * rng.standard_normal(
            tuple(t.shape)).astype(np.float32)).to(t.device)

    st["f"] = {c: TS._apply_mask(plan, plan.coefs, c, rnd(t))
               for c, t in st["f"].items()}
    for key in ("f_u", "f_w", "f_bfast"):
        if key in st:
            st[key] = {c: rnd(t) for c, t in st[key].items()}
    st["pol"] = [{k: {c: rnd(t) for c, t in e[k].items()}
                  for k in ("p", "pp")} for e in st["pol"]]
    return st


def _own(self, st):
    """The wrapper's check, on host tensors: private copies of the state."""
    return {**st, **{k: {c: t.clone() for c, t in st[k].items()}
                     for k in ("f", "f_u", "f_w", "f_bfast") if k in st},
            "pol": [{k: {c: t.clone() for c, t in e[k].items()}
                     for k in ("p", "pp")} for e in st["pol"]]}


#: case -> (scene, probed, steps, MAX_CHUNK, schedule): schedule None
#: takes the wrapper's choice, else (tile, T, blocks, block order: 0
#: forward, 1 reversed, else a seeded shuffle), tile None for the direct
#: schedule (nl3d and poles3d take it by themselves)
CASES = {"tm-k3": ("tm", False, 13, 8192, None),
         "tm-k4": ("tm", True, 13, 8192, None),
         "many-k4": ("tm-many", True, 7, 8192, None),
         "disp-k4-seams": ("disp", True, 13, 5, None),
         "flag-te-k4": ("flag-te", True, 13, 8192, None),
         "te-k3-seams": ("te", False, 13, 5, None),
         "3d-k3": ("3d", False, 9, 8192, None),
         "3d-k4-seams": ("3d", True, 9, 4, None),
         "tm-k4-tiles": ("tm", True, 13, 8192, ((13, 13, 1), 3, 3, 0)),
         "tm-k4-tiles-reversed": ("tm", True, 13, 8192,
                                  ((13, 13, 1), 3, 4, 1)),
         "tm-k3-tiles-seams": ("tm", False, 13, 5, ((13, 13, 1), 3, 5, 7)),
         "disp-k4-tiles": ("disp", True, 13, 5, ((13, 13, 1), 4, 2, 1)),
         "te-k3-tiles": ("te", False, 13, 5, ((10, 14, 1), 2, 3, 1)),
         "flag-te-k4-tiles": ("flag-te", True, 13, 8192,
                              ((10, 14, 1), 3, 4, 0)),
         "3d-k4-tiles": ("3d", True, 9, 4, ((8, 6, 6), 2, 3, 1)),
         "nl3d-k3-direct": ("nl3d", False, 9, 8192, (None, 1, 3, 1)),
         "nl3d-k4-direct-seams": ("nl3d", True, 9, 4, (None, 1, 4, 7)),
         "poles3d-k3-direct-seams": ("poles3d", False, 7, 3, (None, 1, 2, 0)),
         "disp-k3-direct-seams": ("disp", False, 13, 5, (None, 1, 4, 7)),
         "te-k4-direct": ("te", True, 13, 8192, (None, 1, 3, 1)),
         # complex (LDOS) weights, D/B and uncentred monitors
         "ldos-k3": ("ldos", False, 13, 8192, None),
         "ldos-k4-tiles-seams": ("ldos", True, 13, 5, ((13, 13, 1), 3, 3, 7)),
         "ldos-te-k4": ("ldos-te", True, 13, 8192, None),
         "ldos-te-k3-direct-seams": ("ldos-te", False, 13, 5,
                                     (None, 1, 4, 7)),
         # node mirrors: the fold ghost below the planes of x and y (2D),
         # of x and z (3D) and of y on the direct schedule
         "mirror-xy-tm-k4": ("tm+xy", True, 13, 8192, None),
         "mirror-y-tm-k3-tiles-seams": ("tm+y", False, 13, 5,
                                        ((10, 5, 1), 3, 4, 7)),
         "mirror-xz-3d-k4-seams": ("3d+xz", True, 9, 4, None),
         "mirror-y-nl3d-k3-direct": ("nl3d+y", False, 9, 8192,
                                     (None, 1, 3, 1)),
         # rotational folds: the C2 / C4 ghosts on the direct schedule
         # (TM and TE, phase +1 and -1, 2D and 3D), with the wrapper's
         # choice and with several blocks in shuffled order
         "rot2-tm-k3": ("tm@r2", False, 13, 8192, None),
         "rot2-te-k4-seams": ("te-lin@r2-", True, 13, 5, (None, 1, 3, 7)),
         "rot4-tm-k4": ("tm@r4", True, 13, 8192, (None, 1, 4, 1)),
         "rot4-te-k3-seams": ("te-lin@r4-", False, 13, 5, None),
         "rot4-3d-k4": ("3d@r4", True, 9, 8192, (None, 1, 3, 7)),
         "rot2-3d-k3-seams": ("3d@r2-", False, 9, 4, None),
         # Bloch-periodic plans: the wrap reads of both curls and of the
         # centred DTFT on the direct schedule's WRAP variant, at phase +1
         # and -1, beside a node mirror, in 2D and 3D, with chi2
         "wrap-y-tm-k3": ("tm~y", False, 13, 8192, None),
         "wrap-y-tm-k4-seams": ("tm~y-", True, 13, 5, (None, 1, 3, 7)),
         "wrap-xy-te-k4": ("te~xy-", True, 13, 8192, None),
         "wrap-y-mirror-x-tm-k3": ("tm+x~y-", False, 13, 8192,
                                   (None, 1, 4, 1)),
         "wrap-x-3d-k4-seams": ("3d~x-", True, 9, 4, None),
         "wrap-x-nl3d-k3": ("nl3d~x", False, 9, 8192, None),
         # complex fields as a real pair: the PAIR variant, both curls and
         # the centred DTFT reading across a wrap with a complex phase (2D
         # on one and two axes, 3D), the channels' sources, complex probe
         # weights, LDOS weights on complex fields, and a pair without a
         # wrap (force_complex_fields)
         "pair-y-tm-k3": ("tm~y*", False, 13, 8192, None),
         "pair-y-tm-k4-seams": ("tm~y*", True, 13, 5, (None, 1, 3, 7)),
         "pair-xy-te-k4": ("te-lin~xy*", True, 13, 8192, None),
         "pair-x-3d-k4-seams": ("3d~x*", True, 9, 4, (None, 1, 4, 1)),
         "pair-y-ldos-k3-seams": ("ldos~y*", False, 13, 5, None),
         "pair-tm-k4": ("tm*", True, 13, 8192, None),
         # BFAST on the PAIR_BFAST variant: the flip-flop term after each
         # curl, across a wrap of two sites (refl_angular_bfast's cell) and
         # without a wrap, with the PML chains' decay and the W chain's
         "bfast-k3": ("bf*", False, 13, 8192, None),
         "bfast-k4-seams": ("bf*", True, 13, 5, (None, 1, 3, 7)),
         "bfast-pml-k3-seams": ("bf-pml*", False, 9, 4, (None, 1, 4, 1)),
         "bfast-pml-k4": ("bf-pml*", True, 9, 8192, None),
         # cylindrical cells and special_kz on the CYL variants: m = 0 on
         # real fields (the z PML at the axis), a complex m = 0, m = 1, -1
         # and 3 on the pair (the phi term, the |m| = 1 axis ring), beta
         # across a complex wrap and beta with PML
         "cyl0-k3": ("cyl0", False, 13, 8192, None),
         "cyl0-k4-seams": ("cyl0", True, 13, 5, (None, 1, 3, 7)),
         "cyl0-pair-k3": ("cyl0*", False, 13, 8192, None),
         "cyl1-k3-seams": ("cyl1*", False, 13, 5, (None, 1, 4, 1)),
         "cyl-1-k4": ("cyl-1*", True, 13, 8192, None),
         "cyl3-k4-seams": ("cyl3*", True, 13, 5, (None, 1, 3, 7)),
         "kz-k4": ("kz*", True, 13, 8192, None),
         "kz-pml-k3-seams": ("kz-pml*", False, 13, 5, (None, 1, 4, 1)),
         # the anisotropic modes: OFFDIAG (a rotated crystal, with a
         # Lorentz pole, tensor subpixel averaging) on tiles cut through the
         # material and on the
         # direct schedule; GYRO (off-diagonal sigma, gyrotropic poles of
         # both families, fused and separate poles side by side, 3D with
         # every off-diagonal entry) on the direct schedule, its only one
         "aniso-k3-tiles-seams": ("aniso", False, 13, 5,
                                  ((10, 14, 1), 2, 4, 7)),
         "aniso-k4-direct": ("aniso", True, 13, 8192, (None, 1, 3, 1)),
         "aniso-pole-k3-tiles-seams": ("aniso-pole", False, 13, 5,
                                       ((10, 14, 1), 3, 4, 7)),
         "tensor-k4-tiles": ("tensor", True, 13, 8192,
                             ((10, 14, 1), 3, 4, 1)),
         "asig-k4-direct-seams": ("asig", True, 13, 5, (None, 1, 4, 7)),
         "gyro-h-k3-direct-seams": ("gyro-h", False, 13, 5,
                                    (None, 1, 3, 7)),
         "gyro-e-k4-direct": ("gyro-e", True, 13, 8192, (None, 1, 4, 1)),
         "gyro3d-k4-direct-seams": ("gyro3d", True, 9, 4,
                                    (None, 1, 4, 1)),
         "gyro3d-k3-direct": ("gyro3d", False, 9, 8192, (None, 1, 3, 7))}


def h100_schedule(ker, host_lib):
    """The schedule the wrapper takes on an H100 (its 132 SMs), kept by
    the kernel object for its launches on the host build."""
    host_lib.stub_set_sms(132)
    try:
        return ker._tiling(host_lib)
    finally:
        host_lib.stub_set_sms(1)


def force(monkeypatch, tile, T):
    """Make ResidentKernel take tiling `tile`, T (tiling()'s `force`), or
    the direct schedule when tile is None."""
    orig = R.tiling

    def forced(*args, **kw):
        return None if tile is None else orig(*args, **kw, force=(tile, T))

    monkeypatch.setattr(R, "tiling", forced)


def _straddles(lo, hi, t):
    """Whether the sites lo..hi (inclusive) lie in more than one tile of
    extent t along an axis."""
    return lo // t != hi // t


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_source_matches_plain_on_the_host(case, host_lib,
                                                 monkeypatch):
    kind, probed, nsteps, chunk, sched = CASES[case]
    monkeypatch.setattr(R, "_lib", lambda: host_lib)
    monkeypatch.setattr(R, "MAX_CHUNK", chunk)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(R.ResidentKernel, "_check", _own)
    plan = scene(kind)
    rotational, periodic = "@" in kind, "~" in kind
    pair = kind.endswith("*")
    kind = base_kind(kind)
    st0 = random_state(plan, 4)
    comp = COMP.get(kind, "ez")
    is3d = plan.gv.ndim == 3
    pt = [10, 10] + ([10] if is3d else [])
    if kind.startswith("bf"):              # two sites across x and y
        pt = [1, 1, 9]
    if sched is not None and sched[0] is not None:
        # probe points across an x seam
        pt = [sched[0][0], sched[0][1] + 1] + ([5] if is3d else [])
    probes = [TS.ProbeSpec("p0", comp, np.array([[pt[0] - 1] + pt[1:],
                                                 pt]),
                           np.array([0.6 + 0.2j, 0.4]) if pair
                           else np.array([0.6, 0.4])),
              TS.ProbeSpec("p1", comp, np.array([pt]), np.array([1.0]))] \
        if probed else []
    if kind == "tm-many":                  # tables of any length
        assert len(plan.dfts) > 50
        probes += [TS.ProbeSpec(f"q{i}", "ez" if i % 2 else "hy",
                                np.array([[10 + i, 12], [10 + i, 13]]),
                                np.array([0.25, 0.75])) for i in range(20)]
    ker = R.ResidentKernel(plan)
    if sched is None:                      # the H100's choice, one block
        h100_schedule(ker, host_lib)
    else:
        tile, T, blocks, order = sched
        force(monkeypatch, tile, T)
        host_lib.stub_set_sms(blocks)
        host_lib.stub_set_block_order(order)
    t0 = 5                                 # the sources are on
    try:
        sk, yk = ker._run_cuda(st0, nsteps, t0, probes)
    finally:
        host_lib.stub_set_sms(1)
        host_lib.stub_set_block_order(0)
    sr, yr = R.resident_ref(plan)(st0, nsteps, t0, probes)
    nlaunch = -(-nsteps // chunk)
    assert (ker.probed_launches, ker.launches) == \
        ((nlaunch, 0) if probed else (0, nlaunch))
    assert int(sk["t"]) == int(sr["t"]) == nsteps
    tl = ker.schedule[1]
    cyl = kind.startswith(("cyl", "kz"))
    assert tl["direct"] == (7 if cyl and pair else 6 if cyl
                            else 5 if kind.startswith("bf") else 4 if pair
                            else 2 if rotational else 3
                            if periodic else (
                                kind in ("nl3d", "poles3d")
                                or (sched is not None and sched[0] is None)))
    if sched is not None and tl["direct"]:
        assert tl["T"] == 1 and tl["ntile"] == 1
    elif sched is not None:
        assert tl["t"] == tile and tl["T"] == T
        assert all(n >= 2 for n, S in zip(tl["nt"], ker.shape) if S > 1)
        lens = [chunk] * (nsteps // chunk) + [nsteps % chunk]
        assert any(n % T for n in lens)   # a pass shorter than T
        # a source site, the flux region and the probe p0 cross tile seams
        rp = ker.rplan
        src = np.argwhere(rp.coefs["src0:dense_re"].numpy() != 0)
        lo, hi = rp.dfts[0].region[0], rp.dfts[0].region[1]
        assert any(_straddles(src[:, ax].min() - 1, src[:, ax].max(), t)
                   for ax, t in enumerate(tile[:src.shape[1]]))
        assert _straddles(lo[0], lo[1], tile[0]) \
            or _straddles(hi[0], hi[1] - 1, tile[1])
        assert _straddles(pt[0] - 1, pt[0], tile[0])
    for key in ("f", "f_u", "f_w", "dft", "f_bfast"):
        for c, t in sr.get(key, {}).items():
            assert torch.equal(sk[key][c], t), f"{key}[{c}]"
            assert key != "dft" or float(t.abs().max()) > 0
    for pk, pr in zip(sk["pol"], sr["pol"]):
        for k in ("p", "pp"):
            for c, t in pr[k].items():
                assert torch.equal(pk[k][c], t), f"pol {k}[{c}]"
    assert set(yk) == set(yr) == {p.name for p in probes}
    for k, t in yr.items():
        assert t.shape == ((nsteps, 2) if pair else (nsteps,))
        assert torch.equal(yk[k], t), k
    assert float((sr["f"][comp] - st0["f"][comp]).abs().max()) > 0


def test_launch_refuses_a_variant_that_does_not_match(host_lib,
                                                      monkeypatch):
    """The launch checks that the variant matches the plan: a cylindrical
    plan's table on another variant, a plain plan with a CYL variant or a
    table, and a GYRO plan on tiles (its variant is built on the direct
    schedule only) are refused before anything runs."""
    monkeypatch.setattr(R, "_lib", lambda: host_lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(R.ResidentKernel, "_check", _own)
    plan = ax_scene("gyro-h")
    ker = R.ResidentKernel(plan)
    paths, _, _, coef, vecs, _ = ker._layout()
    ker.schedule = ("host", R.tiling(
        ker.shape + (1,), len(paths) + len(coef), len(paths), 1, (0, 0, 0),
        6, 10 ** 9, 1, force=((13, 13, 1), 2), nvec=len(vecs)))
    with pytest.raises(RuntimeError, match="occupancy"):
        ker._run_cuda(random_state(plan, 4), 3, 5, ())
    force(monkeypatch, None, 1)
    for kind, variant, table in (("cyl0", R.DIRECT, False),
                                 ("cyl1*", R.DIRECT_PAIR, False),
                                 ("tm", R.DIRECT_CYL, False),
                                 ("tm", R.DIRECT, True)):
        plan = scene(kind)
        ker = R.ResidentKernel(plan)
        with monkeypatch.context() as m:
            m.setattr(R, "direct_variant", lambda p, v=variant: v)
            if table:
                ker._layout()
                ker._cyl_dev = torch.zeros(16, dtype=torch.uint8)
            with pytest.raises(RuntimeError, match="launch failed"):
                ker._run_cuda(random_state(plan, 4), 3, 5, ())


# ---------------------------------------------------------------------------
# the schedule's boxes and the shared-memory rule
# ---------------------------------------------------------------------------


def _replay(shape, tl, Tp, nl_partners):
    """Run each tile's pass of Tp steps on version counters per field class
    (B, H, D, E, P; grid (S0, S1), stencil reach as the step's): each
    sub-update computes its box (resident.boxes) from the versions its
    reads need; every site it computes must read valid versions, and the
    interior grown by e above must hold version Tp at the end."""
    S = np.array(shape[:2])
    for tile in range(tl["ntile"]):
        st = R.boxes(tl, shape, tile, Tp, 0)["staged"]
        o = np.array(st[0][:2])
        n = np.array(st[1][:2]) - o
        ver = {k: np.zeros(tuple(n), np.int64) for k in "BHDEP"}

        def at(k, i, j, r):
            """version of k at grid site (i, j), r if off the grid (the
            zero boundary is exact), -1 if outside the staged box."""
            if not (0 <= i < S[0] and 0 <= j < S[1]):
                return r
            li, lj = i - o[0], j - o[1]
            if not (0 <= li < n[0] and 0 <= lj < n[1]):
                return -1
            return ver[k][li, lj]

        def update(k, box, reads, r):
            new = ver[k].copy()
            for i in range(box[0][0], box[1][0]):
                for j in range(box[0][1], box[1][1]):
                    for (src, di, dj, want) in reads:
                        got = at(src, i + di, j + dj, want)
                        assert got == want, (tile, k, i, j, src, di, dj, r)
                    new[i - o[0], j - o[1]] = r + 1
            ver[k] = new

        for r in range(Tp):
            bx = R.boxes(tl, shape, tile, Tp, r)
            update("B", bx["b"], [("B", 0, 0, r), ("E", 0, 0, r),
                                  ("E", 1, 0, r), ("E", 0, 1, r)], r)
            update("H", bx["b"], [("B", 0, 0, r + 1), ("H", 0, 0, r)], r)
            update("D", bx["d"], [("D", 0, 0, r), ("H", 0, 0, r + 1),
                                  ("H", -1, 0, r + 1), ("H", 0, -1, r + 1)],
                   r)
            # E's neighbour reads of D - P: the chi2 partners' sums and the
            # off-diagonal rows' averages (the partner at the site, one
            # site back along the partner's axis, and both one site along
            # E's own axis)
            near = [(0, 0)] + ([(1, 0), (0, 1), (-1, 0), (0, -1), (1, -1),
                                (-1, 1)] if nl_partners else [])
            update("E", bx["e"], [("D", a, b, r + 1) for a, b in near]
                   + [("P", a, b, r) for a, b in near] + [("E", 0, 0, r)], r)
            update("P", bx["e"], [("E", 0, 0, r + 1), ("P", 0, 0, r)], r)
        lo, hi = bx["interior"]
        for k in "BHDEP":
            for i in range(lo[0], min(S[0], hi[0] + tl["e"][0])):
                for j in range(lo[1], min(S[1], hi[1] + tl["e"][1])):
                    assert at(k, i, j, Tp) == Tp, (tile, k, i, j)


BOX_E = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0)]
BOX_CASES = [(c, e) for c in (1, 2) for e in BOX_E]


@pytest.mark.parametrize(
    "c,e", BOX_CASES,
    ids=[f"{c}-e{BOX_E.index(e)}" for c, e in BOX_CASES])
def test_boxes_keep_every_read_valid(c, e):
    """The staged box's halo (T c below, T c + e above) and the
    sub-updates' boxes give every computed site valid reads and leave the
    interior (grown by e above) valid after the pass, for full and shorter
    passes, tiles on the grid's edges and inside, linear (c = 1) steps and
    steps whose E reads its neighbours' D - P (c = 2: chi2 partners, the
    OFFDIAG mode's off-diagonal rows), with and without the centred
    DTFT's extra sites e; and tiling() sizes the staged box so."""
    shape = (23, 17, 1)
    tl = R.tiling(shape, 4, 3, c, e, 6, 10 ** 9, 4, force=((7, 6, 1), 3))
    assert tl["nt"] == (4, 3, 1) and tl["ntile"] == 12
    g = [min(S, t + 2 * 3 * c + ei) for S, t, ei in zip(shape, tl["t"], e)]
    assert tl["vol"] == int(np.prod(g)) and tl["smem"] == 16 * tl["vol"]
    for Tp in (3, 1):
        _replay(shape, tl, Tp, c == 2)


def test_tiling_fits_shared_memory():
    """tiling() keeps the staged slots within the budget (the H100's
    SMEM_H100 less the kernel's static shared memory), takes T >= 2 at the
    ring (161^2) and at 767^2, finds nothing where not even the smallest
    tile fits, and refuses a forced tiling that does not fit."""
    budget = R.SMEM_H100 - R.STATIC_SMEM
    for shape, nslot, e in (((161, 161, 1), 11, (0, 0, 0)),
                            ((767, 767, 1), 11, (0, 0, 0)),
                            ((767, 767, 1), 11, (1, 0, 0))):
        tl = R.tiling(shape, nslot, 10, 1, e, 6, budget, 132)
        assert tl["smem"] == 4 * nslot * tl["vol"] <= budget
        assert tl["T"] >= 2 and tl["ntile"] >= 2
    # the flagship material in 3D: chi2 partner sums, a pole, 42 slots
    tl = R.tiling((20, 20, 20), 42, 30, 2, (1, 1, 1), 12, budget, 132)
    assert tl["smem"] <= budget
    # with 3 more E poles and an H pole, 78 slots: not even a 4^3 tile at
    # T = 1 fits (the wrapper then takes the direct schedule)
    assert R.tiling((20, 20, 20), 78, 60, 2, (1, 1, 1), 12, budget,
                    132) is None
    with pytest.raises(ValueError):
        R.tiling((767, 767, 1), 11, 10, 1, (0, 0, 0), 6, budget, 132,
                 force=((128, 128, 1), 8))


def _tiling_by_loop(shape, nslot, nstate, c, e, nloops, budget, sms, nvec):
    """tiling()'s choice by nested loops over T and the tile extents: the
    first of the least modelled costs among the tilings that fit."""
    sizes = [sorted({min(S, v) for v in R.TILE_SIZES} | {S}) for S in shape]
    best = None
    for T in range(1, R.TMAX + 1):
        for t in itertools.product(*sizes):
            g = [min(S, ti + 2 * T * c + ei) for S, ti, ei in zip(shape, t, e)]
            vol = g[0] * g[1] * g[2]
            if 4 * (nslot * vol + nvec * max(g)) > budget:
                continue
            ntile = int(np.prod([-(-S // ti) for S, ti in zip(shape, t)]))
            cost = R.step_us(T, ntile, vol, t[0] * t[1] * t[2], nslot, nstate,
                             nloops, sms)
            if best is None or cost < best[0]:
                best = (cost, t, T)
    return best and (best[1], best[2])


def test_tiling_matches_the_loop():
    """tiling() searches every (T, tile) at once; it takes what the nested
    loops take, or None where nothing fits, on seeded random plans."""
    rng = np.random.default_rng(3)
    budget = R.SMEM_H100 - R.STATIC_SMEM
    for _ in range(24):
        nd = int(rng.integers(2, 4))
        shape = tuple(int(v) for v in rng.integers(
            3, 140 if nd == 2 else 40, nd)) + (1,) * (3 - nd)
        e = tuple(int(rng.integers(0, 2)) if S > 1 else 0 for S in shape)
        args = (shape, int(rng.integers(3, 100)), 3, int(rng.integers(1, 3)),
                e, int(rng.integers(2, 13)), budget,
                int(rng.choice([1, 7, 132])))
        nvec = int(rng.integers(0, 90))
        tl = R.tiling(*args, nvec=nvec)
        want = _tiling_by_loop(*args, nvec)
        assert (tl and (tl["t"], tl["T"])) == want, args


@pytest.mark.parametrize("kind", ["tm", "te", "flag-te", "3d", "nl3d",
                                  "poles3d"])
def test_plans_stage_what_their_step_reads(kind, host_lib, monkeypatch):
    """The wrapper's layout: every state array of step.init_state is a
    slot, the per-site coefficients follow, every per-axis vector is staged
    once; the schedule: tiles that fit the stub's H100 figures at T >= 2,
    or the direct schedule exactly where tiles give no temporal reuse
    (nl3d: T = 1 only; poles3d: more than MAXSLOT arrays); c is 2
    exactly where E reads its neighbours."""
    monkeypatch.setattr(R, "_lib", lambda: host_lib)
    plan = scene(kind)
    ker = R.ResidentKernel(plan)
    paths, pb, pd, coef, vecs, table = ker._layout()
    st = TS.init_state(plan)
    assert {p for p in paths} == (
        {("f", c) for c in st["f"]} | {("f_u", c) for c in st["f_u"]}
        | {("f_w", c) for c in st["f_w"]}
        | {("pol", i, k, c) for i, e in enumerate(st["pol"])
           for k in ("p", "pp") for c in e[k]})
    N = int(np.prod(ker.shape))
    ptrs = [t.data_ptr() for t in coef]
    assert len(ptrs) == len(set(ptrs)) and all(t.numel() == N for t in coef)
    # every per-axis vector once, with its axis and its length there
    shape = ker.shape + (1,) * (3 - len(ker.shape))
    keys = [(t.data_ptr(), ax) for t, ax in vecs]
    assert len(keys) == len(set(keys))
    assert all(t.numel() == shape[ax] for t, ax in vecs)
    assert table.tolist() == [list(k) for k in keys]
    nslot = len(paths) + len(coef)
    assert (nslot > R.MAXSLOT) == (kind == "poles3d")
    tl = h100_schedule(ker, host_lib)
    assert tl["c"] == {"te": 2, "flag-te": 2, "nl3d": 2}.get(kind, 1)
    if kind in ("nl3d", "poles3d"):
        assert tl == R.direct_tiling(shape, tl["c"], tl["e"])
        assert tl["direct"] and tl["smem"] == 0 and tl["vol"] == N
        if kind == "nl3d":               # tiles would fit only at T = 1
            t1 = R.tiling(shape, nslot, len(paths), 2, tl["e"], 6,
                          R.SMEM_H100 - R.STATIC_SMEM, 132, nvec=len(vecs))
            assert t1 is not None and t1["T"] == 1
        return
    assert not tl["direct"] and tl["T"] >= 2
    assert tl["smem"] == 4 * (nslot * tl["vol"] + len(vecs) * tl["gvec"])
    assert tl["smem"] <= R.SMEM_H100 - R.STATIC_SMEM


@pytest.mark.parametrize("kind,c,mode", [("aniso", 2, R.AX_OFFDIAG),
                                         ("gyro-h", 1, R.AX_GYRO),
                                         ("gyro-e", 2, R.AX_GYRO)])
def test_anisotropic_schedules(kind, c, mode, host_lib, monkeypatch):
    """The OFFDIAG and GYRO modes' schedules on the stub's H100 figures: c
    is 1 plus a site where E reads its neighbours' D - P; an OFFDIAG plan
    takes tiling()'s tiles with T >= 2, a GYRO plan the direct schedule
    (the only one its variant is built for)."""
    monkeypatch.setattr(R, "_lib", lambda: host_lib)
    plan = scene(kind)
    assert R.ax_mode(plan) == mode
    tl = h100_schedule(R.ResidentKernel(plan), host_lib)
    assert tl["c"] == c
    if mode == R.AX_GYRO:
        assert tl["direct"] == R.DIRECT and tl["T"] == 1
    else:
        assert not tl["direct"] and tl["T"] >= 2
