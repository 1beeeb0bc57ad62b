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
from .models.geom import (Vector3, Medium, Sphere, Cylinder, Block,
                          GeometricObject, LorentzianSusceptibility,
                          DrudeSusceptibility, interpolate, vacuum, air)
from .models.run_control import (FieldProbe, after_sources, at_every,
                                 at_beginning, at_end, during_sources,
                                 stop_when_fields_decayed)
from .analysis.harminv import Harminv, Mode, harminv
from .models.simulation import (Simulation, PML, FluxRegion, ForceRegion,
                                EnergyRegion, FieldsRegion, Near2FarRegion,
                                get_fluxes, get_forces, get_electric_energy,
                                get_magnetic_energy, get_total_energy,
                                get_flux_freqs, get_force_freqs,
                                get_energy_freqs, get_ldos_freqs,
                                get_near2far_freqs,
                                Ex, Ey, Ez, Hx, Hy, Hz, Dx, Dy, Dz,
                                Bx, By, Bz, X, Y, Z, ALL, Low, High,
                                Metallic, Magnetic, Symmetry, Identity,
                                Mirror, Rotate2, Rotate4)

inf = float("inf")

__version__ = "0.1.0"
