#!/usr/bin/env python3
"""One-way transport of chip_smoke.py's gyromagnetic waveguide (phase 18)
on a small cell, in the port and in the JAX package, the reference, on
the CPU.

    JAX_PLATFORMS=cpu python3 scripts/oneway_witness.py [--nx 16] [--res 10]

Builds chip_smoke.oneway_sim at nx x nx/2 lattice constants and resolution
res in both packages, with the pole biased along +z, along -z and without
it (the control), runs each to t = 250 and prints, per run, the flux
frequencies and forward (+x) / backward flux ratios of both packages and
their largest relative difference; then the ratio at the frequency nearest
chip_smoke.ONEWAY_EDGE for each bias.  The port runs on its resident route
(the plain version on the CPU).  Needs both packages; the port itself
imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import chip_smoke as CS  # noqa: E402


def ratios(mp, nx, res, bias, device):
    """(flux frequencies, forward / backward ratios, wall seconds)."""
    t = time.perf_counter()
    sim, fl = CS.oneway_sim(mp, nx, nx // 2, res, device, bias=bias)
    sim.run(until=250.0)
    right, left = (np.asarray(sim.get_fluxes(f)) for f in fl)
    return (np.asarray(mp.get_flux_freqs(fl[0])), right / -left,
            time.perf_counter() - t)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=16)
    ap.add_argument("--res", type=int, default=10)
    args = ap.parse_args()
    import meep_nl_tpu as ref
    import meep_nl_tpu_torch as port
    edge = {}
    for bias in (1.0, -1.0, 0.0):
        f, want, tw = ratios(ref, args.nx, args.res, bias, None)
        _, got, tg = ratios(port, args.nx, args.res, bias, "cpu")
        diff = float(np.max(np.abs(got - want) / np.abs(want)))
        k = int(np.argmin(np.abs(f - CS.ONEWAY_EDGE)))
        edge[bias] = (f[k], want[k], got[k])
        print(f"{args.nx} x {args.nx // 2} a, resolution {args.res}, bias "
              f"{bias:+.0f} z: flux at {f.round(4).tolist()}; forward (+x) "
              f"/ backward, JAX package {want.tolist()}, port "
              f"{got.tolist()}; largest relative difference {diff:.3e} "
              f"({tw:.1f} s and {tg:.1f} s on the CPU)", flush=True)
    for bias, (f, want, got) in edge.items():
        print(f"at {f:.4f}, bias {bias:+.0f} z: forward / backward {want:.6g} "
              f"(JAX package), {got:.6g} (port)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
