"""Sea-ice dynamical core in PyTorch: dG1 transport + CG1 mEVP rheology.

The port of ``nextsimdg_tpu.dynamics`` for the main path (uniform, closed
meshes). It imports no JAX and registers nothing anywhere.
"""

from .dgbasis import DGBasis, dg_basis
from .mesh import RectMesh
from .mevp import DynamicsForcing, MEVPParams, MEVPSolver, VelocityState
from .transport import DGTransport, QuadVelocity

__all__ = [
    "DGBasis",
    "DGTransport",
    "DynamicsForcing",
    "MEVPParams",
    "MEVPSolver",
    "QuadVelocity",
    "RectMesh",
    "VelocityState",
    "dg_basis",
]
