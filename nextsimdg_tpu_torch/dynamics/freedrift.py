"""Free-drift momentum solver (no internal ice stress).

Counterpart of ``nextsimdg_tpu.dynamics.freedrift``: the wind and ocean
drag balance plus Coriolis, solved per node by fixed-point iterations of
the implicit drag, with no stress state. It is the second implementation
of ``Nextsim::IDynamics`` (``Nextsim::FreeDrift``).

It is plain PyTorch on every device: the JAX package has no kernel for it
either. ``CoupledModel`` runs it as the momentum part of the dynamics
phase, before the phase's CFL count and transport kernels
(``kernels.coupled_cuda.free_drift_subcycles``).
"""

from __future__ import annotations

import torch

from .mesh import RectMesh
from .mevp import DynamicsForcing, MEVPParams, MEVPSolver, VelocityState, cell_to_node


class FreeDriftSolver:
    """Free drift on a ``RectMesh`` or ``SphericalMesh``, closed or periodic.

    ``backend`` and ``block_halo`` are accepted for the interface of the
    other solvers and unused; ``spmd`` is a rank's exchange axes on a rank
    grid, over which the node averages exchange.
    """

    def __init__(
        self, mesh: RectMesh, params: MEVPParams = MEVPParams(), backend: str = "auto",
        spmd=(None, None), block_halo="auto",
    ) -> None:
        self.mesh = mesh
        self.params = params
        self.spmd = tuple(spmd)

    def step(
        self, state: VelocityState, h, a, forcing: DynamicsForcing, mask,
        dt: float, n_subcycles: int = 1,
    ) -> VelocityState:
        """One step: ``n_subcycles`` (at least 1) fixed-point iterations of
        the drag balance from the old velocity; the stresses come out zero.
        ``a`` is not read (the interface's)."""
        p = self.params
        px, py = self.mesh.periodic_x, self.mesh.periodic_y
        m_node = p.rho_ice * cell_to_node(h, px, py, self.spmd)
        ice_node = m_node > p.min_ice_mass
        m_safe = torch.clamp(m_node, min=p.min_ice_mass)
        active = mask * ice_node.to(h.dtype)

        wind_speed = torch.sqrt(forcing.u_atm ** 2 + forcing.v_atm ** 2)
        tau_au = p.rho_atm * p.cd_atm * wind_speed * forcing.u_atm
        tau_av = p.rho_atm * p.cd_atm * wind_speed * forcing.v_atm
        dt_m = torch.div(m_safe.new_full((), dt), m_safe)

        u, v = state.u, state.v
        for _ in range(max(1, n_subcycles)):
            rel_u = forcing.u_ocean - u
            rel_v = forcing.v_ocean - v
            c_w = p.rho_ocean * p.cd_ocean * torch.sqrt(rel_u ** 2 + rel_v ** 2)
            cor_u = p.f_coriolis * (v - forcing.v_ocean) if p.use_coriolis else 0.0
            cor_v = -p.f_coriolis * (u - forcing.u_ocean) if p.use_coriolis else 0.0
            u_new = (state.u + dt_m * (tau_au + c_w * forcing.u_ocean) + dt * cor_u) / (1.0 + dt_m * c_w)
            v_new = (state.v + dt_m * (tau_av + c_w * forcing.v_ocean) + dt * cor_v) / (1.0 + dt_m * c_w)
            u, v = u_new * active, v_new * active
        return VelocityState(u=u, v=v, s11=state.s11 * 0, s22=state.s22 * 0, s12=state.s12 * 0)

    def boundary_mask(self, *, device, dtype):
        """The CG1 solver's no-slip mask (``MEVPSolver.boundary_mask``)."""
        return MEVPSolver(self.mesh, self.params, spmd=self.spmd).boundary_mask(device=device, dtype=dtype)
