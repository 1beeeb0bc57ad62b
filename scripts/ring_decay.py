#!/usr/bin/env python3
"""Why the ring resonator's field-decay stop comes when it does.

    python3 scripts/ring_decay.py [--device cuda|cpu]

Runs chip_smoke.py's ring-resonator scene at resolution 10 (Meep's
python/examples/ring.py without its mirror symmetry) through the port with
a Harminv collector on Ez at (r + 0.1, 0) from t = 0 and
until_after_sources=
stop_when_fields_decayed(50, Ez, (r + 0.1, 0), 1e-3), then prints the stop,
the peak of |Ez| there, every 50-unit window's max |Ez| with its |Ez|^2
ratio to the peak (the quantity the stop condition tests), and the modes
Harminv finds in the series after the sources, each with its amplitude
extrapolated to the stop.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as CS  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    import numpy as np
    import meep_nl_tpu_torch as mp
    from meep_nl_tpu_torch.analysis.harminv import harminv

    r = 1.0
    sim = CS.ring_sim(mp, 10, a.device)
    h = mp.Harminv(mp.Ez, mp.Vector3(r + 0.1), 0.15, 0.1)
    stop = mp.stop_when_fields_decayed(50, mp.Ez, mp.Vector3(r + 0.1), 1e-3)
    sim.run(h, until_after_sources=stop)
    x, dt = np.asarray(h.data), sim.dt
    last = max(s.src.last_time() for s in sim.sources)
    peak = float(np.abs(x).max())
    print(f"stopped at t = {sim.meep_time()} after {sim._t} steps; sources "
          f"end at t = {last}; peak |Ez| {peak:.4e} at t = "
          f"{np.argmax(np.abs(x)) * dt:.2f}")
    nb = int(round(50 / dt))
    for i in range(0, len(x), nb):
        w = float(np.abs(x[i:i + nb]).max())
        print(f"window to t = {min(i + nb, len(x)) * dt:.0f}: max |Ez| "
              f"{w:.4e}, |Ez|^2 / peak^2 {(w / peak) ** 2:.3e}")
    since = sim.meep_time() - last
    for m in harminv(x[int(round(last / dt)):], dt, 0.1, 0.2):
        print(f"mode f {m.freq:.5f} Q {m.Q:.1f}: amplitude {m.amp:.3e} "
              f"after the sources, "
              f"{m.amp * np.exp(-np.pi * m.freq * since / m.Q):.3e} at the "
              f"stop")
    return 0


if __name__ == "__main__":
    sys.exit(main())
