"""Column (1-D) sea-ice physics in eager PyTorch.

Counterpart of ``nextsimdg_tpu.physics``: each module registers in the
port's registry (``nextsimdg_tpu_torch.modules``) under the reference's
names, in the JAX package's order, so the defaults are the first
registered: ``LinearFreezing``/``UnescoFreezing``,
``SMUIceAlbedo``/``SMU2IceAlbedo``/``CCSMIceAlbedo``,
``BasicIceOceanHeatFlux``, ``ThermoIce0``/``ThermoWinton``,
``HiblerConcentration`` and ``NextsimPhysics`` (``Nextsim::IPhysics1d``).
``NextsimPhysics()`` may take its sub-modules and parameters as constructor
arguments; its ``configure()``, which the engine calls, or else its first
use resolves the others from the registry and the config keys. The JAX package computes the
physics in XLA, not in a Pallas kernel, so there is no CUDA kernel here.
"""

from . import freezing  # noqa: F401 - registers the freezing-point modules
from . import albedo  # noqa: F401 - registers the albedo modules
from . import ice_ocean_heat_flux  # noqa: F401
from . import thermo_ice0  # noqa: F401
from . import thermo_winton  # noqa: F401
from . import concentration  # noqa: F401
from .nextsim_physics import NextsimPhysics  # noqa: F401 (registers IPhysics1d)

__all__ = ["NextsimPhysics"]
