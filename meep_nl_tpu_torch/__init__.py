"""meep_nl_tpu_torch: the PyTorch + CUDA port of meep_nl_tpu.

The JAX package ``meep_nl_tpu`` is the reference; this package reads like
it (``import meep_nl_tpu_torch as mp``) and imports nothing of it.  Entry
points run on CUDA unless the caller passes ``device="cpu"``.
"""

from .core import grid
from .core.grid import GridVolume
from .stepper.plan import (MaterialSpec, PolSpec, PMLSpec, SrcVolSpec,
                           DftSpec, compile_plan)
from .stepper.step import init_state, make_step, build_xs, run
from .models.source import (GaussianSource, ContinuousSource, CustomSource,
                            Source, SourceTime)
from .models.geom import (Vector3, Medium, Sphere, Block, GeometricObject,
                          LorentzianSusceptibility, DrudeSusceptibility,
                          vacuum, air)
from .models.simulation import (Simulation, PML, FluxRegion, get_fluxes,
                                Ex, Ey, Ez, Hx, Hy, Hz, Dx, Dy, Dz,
                                Bx, By, Bz, X, Y, Z, ALL)

inf = float("inf")

__version__ = "0.1.0"
