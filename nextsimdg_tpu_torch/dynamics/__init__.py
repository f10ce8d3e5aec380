"""Sea-ice dynamical core in PyTorch: dG1 transport + CG1 mEVP rheology.

The port of ``nextsimdg_tpu.dynamics`` for the main path (closed uniform,
graded and spherical meshes, with coastlines). It imports no JAX and
registers nothing anywhere.
"""

from .dgbasis import DGBasis, dg_basis
from .landmask import synthetic_coastline
from .mesh import RectMesh, SphericalMesh
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
    "SphericalMesh",
    "VelocityState",
    "dg_basis",
    "synthetic_coastline",
]
