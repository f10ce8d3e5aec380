"""Sea-ice dynamical core in PyTorch: dG0/dG1/dG2 transport, CG1 and CG2/dG1 mEVP.

The port of ``nextsimdg_tpu.dynamics`` for uniform, graded and spherical
meshes, each axis closed or periodic, with coastlines.
It imports no JAX.

The momentum solver is a module of the port's registry
(``nextsimdg_tpu_torch.modules``), under the reference's names: the
interface ``Nextsim::IDynamics`` with ``Nextsim::MEVPDynamics`` (the CG1
solver, the default: registered first), ``Nextsim::FreeDrift`` (no internal
stress) and ``Nextsim::MEVPHighOrder`` (the CG2/dG1 solver). The registered
instance is the solver class, which ``CoupledModel`` instantiates.
"""

from ..modules import ModuleRegistry as _ModuleRegistry
from .dgbasis import DGBasis, dg_basis
from .freedrift import FreeDriftSolver
from .landmask import synthetic_coastline
from .mesh import RectMesh, SphericalMesh
from .mevp import DynamicsForcing, MEVPParams, MEVPSolver, VelocityState
from .mevp_ho import HODynamicsForcing, HOField, HOVelocityState, MEVPSolverHO
from .transport import DGTransport, QuadVelocity

_loader = _ModuleRegistry.get_loader()
_loader.register("Nextsim::IDynamics", "Nextsim::MEVPDynamics", lambda: MEVPSolver)
_loader.register("Nextsim::IDynamics", "Nextsim::FreeDrift", lambda: FreeDriftSolver)
_loader.register("Nextsim::IDynamics", "Nextsim::MEVPHighOrder", lambda: MEVPSolverHO)

__all__ = [
    "DGBasis",
    "DGTransport",
    "DynamicsForcing",
    "FreeDriftSolver",
    "HODynamicsForcing",
    "HOField",
    "HOVelocityState",
    "MEVPParams",
    "MEVPSolver",
    "MEVPSolverHO",
    "QuadVelocity",
    "RectMesh",
    "SphericalMesh",
    "VelocityState",
    "dg_basis",
    "synthetic_coastline",
]
