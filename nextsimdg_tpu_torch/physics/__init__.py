"""Column (1-D) sea-ice physics in eager PyTorch.

Counterpart of ``nextsimdg_tpu.physics`` for the default module chain
(``LinearFreezing``, ``SMUIceAlbedo``, ``BasicIceOceanHeatFlux``,
``ThermoIce0``, ``HiblerConcentration``), plus ``UnescoFreezing`` and
``CCSMIceAlbedo``, which the reference golden cases select. The port has
no module registry yet: ``NextsimPhysics`` takes its sub-modules and
parameters as constructor arguments. The JAX package computes the physics
in XLA, not in a Pallas kernel, so there is no CUDA kernel here.
"""

from .nextsim_physics import NextsimPhysics

__all__ = ["NextsimPhysics"]
