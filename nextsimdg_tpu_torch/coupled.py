"""The coupled sea-ice model's dynamics step: mEVP + dG1 transport.

Counterpart of ``nextsimdg_tpu.coupled`` for the dynamics-only step
(``do_thermo=False``) on a uniform, closed mesh. Per outer timestep:

1. the per-step mEVP constants from the current cell means (h, A);
2. one dynamics phase (``dynamics.kernels.coupled_cuda.fused_dynamics``):
   N mEVP subcycles, CG1 -> quadrature sampling, the CFL substep count k
   and k limited SSP-RK dG1 steps of the stacked (hice, cice, hsnow);
3. bounds: 0 <= A <= 1, h >= 0 on the cell means.

The momentum solver is always the CG1 ``MEVPSolver``, built directly: the
port has no module registry yet, so free drift and the high-order solver
cannot be selected. Column physics, land masks, device meshes and the TVB
limiter are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .dynamics.kernels.coupled_cuda import fused_dynamics
from .dynamics.mesh import RectMesh
from .dynamics.mevp import DynamicsForcing, MEVPParams, MEVPSolver, VelocityState
from .dynamics.transport import DGTransport


@dataclass(frozen=True)
class CoupledState:
    """Full prognostic state of the coupled model."""

    hice: torch.Tensor  #: DG coefficients of effective ice thickness (K, nx, ny)
    cice: torch.Tensor  #: DG coefficients of concentration (K, nx, ny)
    hsnow: torch.Tensor  #: DG coefficients of effective snow thickness (K, nx, ny)
    sst: torch.Tensor  #: (nx, ny)
    sss: torch.Tensor  #: (nx, ny)
    tice: torch.Tensor  #: (nlayers, nx, ny)
    velocity: VelocityState
    new_ice: torch.Tensor  #: carried physics state (nx, ny)

    @property
    def n_dg_dofs(self) -> int:
        return self.hice.shape[0]


class CoupledModel:
    def __init__(
        self,
        mesh: RectMesh,
        degree: int = 1,
        mevp_params: MEVPParams = MEVPParams(),
        n_subcycles: int = 100,
        spmd=(None, None),
        ocean_mask=None,
        transport_substeps: int = 1,
        auto_substeps: bool = True,
        tvb_m: float = None,
    ) -> None:
        """``transport_substeps``: advect with k sub-steps of dt/k; with
        ``auto_substeps`` (default) k is chosen per step from the advective
        CFL number of the post-mEVP velocity and ``transport_substeps`` is
        its floor."""
        if any(axis is not None for axis in spmd):
            raise NotImplementedError("device meshes (spmd) are not ported yet")
        if ocean_mask is not None:
            raise NotImplementedError("land masks are not ported yet")
        if tvb_m is not None:
            raise NotImplementedError("the TVB slope limiter is not ported yet")
        self.mesh = mesh
        self.transport = DGTransport(mesh, degree=degree)
        self.mevp = MEVPSolver(mesh, mevp_params)
        self.n_subcycles = int(n_subcycles)
        self.transport_substeps = max(1, int(transport_substeps))
        self.auto_substeps = bool(auto_substeps)

    # -- state construction --------------------------------------------------
    def initial_state(
        self, hice0=0.0, cice0=0.0, hsnow0=0.0, sst0=-1.8, sss0=32.0,
        tice0=-1.0, nlayers: int = 1, *, device, dtype,
    ) -> CoupledState:
        nx, ny = self.mesh.nx, self.mesh.ny
        k = self.transport.basis.n_dofs

        def dg(value):
            coeffs = torch.zeros((k, nx, ny), device=device, dtype=dtype)
            coeffs[0] = value
            return coeffs

        full = lambda shape, value: torch.full(shape, value, device=device, dtype=dtype)
        return CoupledState(
            hice=dg(hice0),
            cice=dg(cice0),
            hsnow=dg(hsnow0),
            sst=full((nx, ny), sst0),
            sss=full((nx, ny), sss0),
            tice=full((nlayers, nx, ny), tice0),
            velocity=VelocityState.zeros(nx, ny, device=device, dtype=dtype),
            new_ice=torch.zeros((nx, ny), device=device, dtype=dtype),
        )

    def node_mask(self, *, device, dtype):
        """1 on active CG1 nodes, 0 on the no-slip walls."""
        return self.mevp.boundary_mask(device=device, dtype=dtype)

    # -- one coupled timestep ------------------------------------------------
    def step_dynamics(
        self, state: CoupledState, dyn_forcing: DynamicsForcing, dt: float,
        phase=fused_dynamics,
    ) -> CoupledState:
        """mEVP + transport + bounds. ``phase`` runs the dynamics phase;
        passing ``coupled_cuda.fused_dynamics_reference`` runs the plain
        PyTorch path on any device, for comparison with the kernels."""
        hice, cice, hsnow = state.hice, state.cice, state.hsnow
        velocity = state.velocity
        mask = self.node_mask(device=hice.device, dtype=hice.dtype)
        consts = self.mevp.step_consts(
            velocity, hice[0], torch.clamp(cice[0], 0.0, 1.0),
            dyn_forcing, mask, dt,
        )
        tracers = torch.stack([hice, cice, hsnow], dim=1)
        carry0 = (velocity.u, velocity.v, velocity.s11, velocity.s22, velocity.s12)
        final, tracers = phase(self, carry0, tracers, consts, dt, self.n_subcycles)
        velocity = VelocityState(
            u=final[0], v=final[1], s11=final[2], s22=final[3], s12=final[4],
        )
        hice, cice, hsnow = tracers[:, 0], tracers[:, 1], tracers[:, 2]
        return dataclasses.replace(
            state,
            hice=_clamp_dg(hice, 0.0, None),
            cice=_clamp_dg(cice, 0.0, 1.0),
            hsnow=_clamp_dg(hsnow, 0.0, None),
            velocity=velocity,
        )

    def step(
        self,
        state: CoupledState,
        phys_forcing,
        dyn_forcing: DynamicsForcing,
        dt: float,
        do_dynamics: bool = True,
        do_thermo: bool = True,
    ) -> CoupledState:
        if do_thermo:
            raise NotImplementedError(
                "the column physics is not ported yet: call with do_thermo=False"
            )
        if do_dynamics:
            state = self.step_dynamics(state, dyn_forcing, dt)
        return state

    def run(
        self,
        state: CoupledState,
        phys_forcing,
        dyn_forcing: DynamicsForcing,
        dt: float,
        n_steps: int,
        do_dynamics: bool = True,
        do_thermo: bool = True,
    ) -> CoupledState:
        """n_steps coupled steps."""
        for _ in range(n_steps):
            state = self.step(state, phys_forcing, dyn_forcing, dt, do_dynamics, do_thermo)
        return state


def _clamp_dg(coeffs, lo, hi):
    """Clamp the cell mean; zero higher moments where the mean was clamped."""
    mean = coeffs[0]
    clamped = torch.clamp(mean, min=lo, max=hi)
    at_bound = clamped != mean
    rest = torch.where(at_bound[None], 0.0, coeffs[1:])
    return torch.cat([clamped[None], rest], dim=0)


def _rescale_dg(coeffs, new_mean):
    """Replace the mean, scaling higher moments by new/old (shape-preserving)."""
    old_mean = coeffs[0]
    nonzero = old_mean != 0
    ratio = torch.where(nonzero, new_mean / torch.where(nonzero, old_mean, 1.0), 0.0)
    return torch.cat([new_mean[None], coeffs[1:] * ratio[None]], dim=0)
