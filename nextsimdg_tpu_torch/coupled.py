"""The coupled sea-ice model: mEVP dynamics + DG transport + column physics.

Counterpart of ``nextsimdg_tpu.coupled`` on a uniform, graded or spherical
mesh, each axis closed or periodic, with an optional coastline
(``ocean_mask``) and the optional TVB slope limiter (``tvb_m``). Per outer
timestep:

1. the per-step mEVP constants from the current cell means (h, A), with
   the metric planes on a non-uniform mesh and the coastal nodes pinned
   (``node_mask``);
2. one dynamics phase (``dynamics.kernels.coupled_cuda.dynamics_phase``):
   N mEVP subcycles, CG1 -> quadrature sampling, the CFL substep count k
   and k limited SSP-RK DG steps (dG0, dG1 or dG2: ``degree``; each stage
   limited by TVB, with ``tvb_m``, then positivity) of the stacked
   (hice, cice, hsnow), with
   impermeable coastline faces (``face_masks``);
3. bounds: 0 <= A <= 1, h >= 0 on the cell means;
4. with ``do_thermo``, the column physics (``physics.NextsimPhysics``) on
   the cell means, land elements kept as they were, the higher DG moments
   rescaled to keep their shape.

On a CUDA card the dynamics phase runs one of the kernel schedules chosen
by ``mevp_backend`` and ``transport_backend`` (see
``CoupledModel.__init__``); CPU tensors always run the plain PyTorch
versions.

The momentum solver comes from the module registry, as in the JAX package:
``Nextsim::IDynamics`` is ``Nextsim::MEVPDynamics`` (the CG1 ``MEVPSolver``,
the default), ``Nextsim::FreeDrift`` (``FreeDriftSolver``: no internal
stress, its momentum step plain PyTorch on every device, then the usual
CFL count and transport) or ``Nextsim::MEVPHighOrder`` (the CG2/dG1
``MEVPSolverHO``, on uniform, graded or spherical meshes, each axis closed
or periodic),
selected with
``modules.get_loader().set_implementation(...)`` before the model is built
(and ``reset()`` after). With the HO solver the velocity state is an
``HOVelocityState``, the forcing is interpolated to the CG2 nodes, the node
mask gets its per-plane form and the transport advects with the CG2
velocity sampled at the quadrature points.

On a rank grid (``spmd``, built by ``parallel.shardmap``) the model holds
one rank's block (of a uniform mesh, or a ``LocalMeshView`` of a graded or
spherical one, each axis closed or a ring), runs in that rank's thread and
exchanges halos with the other ranks (``parallel.exchange``): the mEVP on
the blocked or rdma schedule in any momentum form, the HO solver on the
blocked or rdma schedule, or free drift; the transport on the widened block,
with TVB too (staged on a graded or spherical mesh: psi widened by one ring
a stage, the halo forms of dg1_rk_stage and dg1_limit on a card); the
physics per block.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .dynamics.kernels import fused_dynamics_cuda, mevp_single_cuda
from .dynamics.freedrift import FreeDriftSolver
from .dynamics.kernels.coupled_cuda import dynamics_phase, sm_count
from .dynamics.mesh import RectMesh, block_mesh
from .dynamics.mevp import SPMD_BACKENDS, DynamicsForcing, MEVPParams, VelocityState
from .dynamics.mevp_ho import (
    MEVP_BACKENDS, HODynamicsForcing, HOField, HOVelocityState, MEVPSolverHO,
)
from .dynamics.stencil import shift_m
from .dynamics.transport import DGTransport, face_masks_from_land
from .modules import get_loader
from .physics.nextsim_physics import NextsimPhysics
from .state import Forcing, PrognosticState, safe_div

TRANSPORT_BACKENDS = ("auto", "xla", "tiled")
#: Element count from which ``"auto"`` runs the tiled kernels on the card
#: (mevp_tiled + transport_tiled) instead of K1's schedule. Re-derived on
#: the H100 from chip_smoke.py's timings of both schedules' dynamics step:
#: the tiled one was faster at every size measured, 64^2 to 1024^2, so the
#: threshold is the smallest of them; below it nothing was measured and
#: K1's schedule stays. See PERF.md.
TILED_MIN_ELEMENTS = 64 * 64
#: Element count from which ``"auto"`` runs mevp_tiled instead of the
#: single-launch mevp_single on a graded or spherical mesh. Derived on the
#: H100 from ``benchmarks.mevp_large --thresholds``, run in turns with the
#: single-launch kernel it replaced (parent, new, new, parent): with its tiles
#: resident in shared memory mevp_single ran the spherical dynamics step
#: (100 subcycles) faster than mevp_tiled at every size swept, 128^2 to
#: 1024^2 (512^2: 1.95, 1.90 against 2.45, 2.31 ms; 1024^2: 3.91, 3.84
#: against 4.24, 4.01 ms), where the kernel it replaced tied at 512^2 and
#: lost 2x at 1024^2. 1024^2 is the largest square grid it holds on the
#: H100's 132 SMs (``mevp_single_cuda.largest_square``), so "auto" takes it
#: up to there, where the card holds the grid (``mevp_schedule``). See
#: PERF.md.
SINGLE_MAX_ELEMENTS = 1024 * 1024 + 1
#: Element count below which ``"auto"`` runs the whole dynamics phase as one
#: ``fused_dynamics`` launch on a uniform mesh, where the card holds the grid
#: and the kernel the model's form (``fused_dynamics_cuda.holds_model``).
#: Derived on the H100 from chip_smoke.py's phase ``check_fused``, which
#: times the fused, tiled and K1 split schedules' dynamics step in turns at
#: 64^2, 128^2, 256^2 and 528^2, the largest square the kernel holds on the
#: H100's 132 SMs: fused was the fastest at every size (256^2: 1.99 ms a
#: step against the tiled 2.74 and K1's split 4.67; 528^2: 1.63 against
#: 2.73 and 4.75), so "auto" takes it up to 528^2; beyond, nothing was
#: measured and the card does not hold the grid anyway. See PERF.md.
FUSED_MAX_ELEMENTS = 529 * 529


@dataclass(frozen=True)
class CoupledState:
    """Full prognostic state of the coupled model."""

    hice: torch.Tensor  #: DG coefficients of effective ice thickness (K, nx, ny)
    cice: torch.Tensor  #: DG coefficients of concentration (K, nx, ny)
    hsnow: torch.Tensor  #: DG coefficients of effective snow thickness (K, nx, ny)
    sst: torch.Tensor  #: (nx, ny)
    sss: torch.Tensor  #: (nx, ny)
    tice: torch.Tensor  #: (nlayers, nx, ny)
    velocity: VelocityState  #: or an HOVelocityState with the HO solver
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
        physics: NextsimPhysics = None,
        spmd=(None, None),
        ocean_mask=None,
        mevp_backend: str = "auto",
        mevp_block_halo="auto",
        transport_substeps: int = 1,
        auto_substeps: bool = True,
        tvb_m: float = None,
        transport_backend: str = "auto",
    ) -> None:
        """``degree``: the DG degree of the tracers (0, 1 or 2: 1, 3 or 6
        coefficients each), advected with rk1, rk2 or rk3.
        ``transport_substeps``: advect with k sub-steps of dt/k; with
        ``auto_substeps`` (default) k is chosen per step from the advective
        CFL number of the post-mEVP velocity and ``transport_substeps`` is
        its floor. ``physics``: the column physics (default: the reference
        chain with its default parameters).

        ``ocean_mask``: optional (nx, ny) element mask (1 = ocean,
        0 = land): coastline faces become impermeable, coastal nodes
        no-slip, and the column physics leaves land elements as they are.

        The kernel schedule of the dynamics phase on a CUDA card (CPU
        tensors always run the plain versions):

        * ``mevp_backend``: ``"pallas"``, the counterpart of the JAX value
          that selects its single-call kernels: on a uniform mesh
          ``fused_dynamics`` (the whole phase in one launch, k on the card)
          where the card holds the grid (every form of a uniform CG1 model:
          periodic axes, A-weighted stresses, adaptive alpha, dG0-dG2, TVB,
          a coastline), else K1's split schedule (two launches per subcycle, then one
          ``dg1_rk_stage`` per RK stage); ``transport_backend`` does not
          apply, as in the JAX fused path; on a graded or spherical mesh
          ``mevp_single`` (all N subcycles in one launch);
          ``"pallas-tiled"``, the counterpart of the JAX tiled kernel:
          ``mevp_tiled``, H subcycles per launch; ``"auto"``: on a uniform
          mesh ``fused_dynamics`` below ``FUSED_MAX_ELEMENTS`` where it
          holds, else the tiled schedule from ``TILED_MIN_ELEMENTS``
          elements and K1's below, on a non-uniform one ``mevp_tiled`` from
          ``SINGLE_MAX_ELEMENTS`` and ``mevp_single`` below.
        * ``transport_backend`` (except with K1's schedule): ``"xla"``, the
          counterpart of the JAX staged path: one ``dg1_rk_stage`` per RK
          stage; ``"tiled"``, the counterpart of the JAX tiled kernel:
          ``transport_tiled``, whole substeps per launch; ``"auto"``: tiled
          from ``TILED_MIN_ELEMENTS`` elements (every scheme: rk1, rk2 and
          rk3), staged below. With ``tvb_m`` on a graded or spherical mesh
          (a per-element TVB tolerance) the transport is staged: ``"auto"``
          takes ``"xla"`` and ``"tiled"`` raises.

        ``tvb_m``: the TVB constant M of the minmod slope limiter, applied
        to the linear moments before the positivity limiter at every RK
        stage (``DGTransport.limit_slopes``; 0: pure TVD; None: off). On
        the card the staged transport runs it as one more launch a stage
        (``coupled_cuda.dg1_limit``), transport_tiled in its window.

        With the HO solver selected, ``mevp_backend`` goes to
        ``MEVPSolverHO``: ``"pallas"`` runs ho_single, ``"pallas-tiled"``
        ho_tiled, ``"auto"`` ho_single below
        ``mevp_ho.HO_SINGLE_MAX_ELEMENTS`` and ho_tiled from there; the
        transport is ``transport_tiled`` on the CG2 samples at every size,
        except with ``tvb_m`` on a graded or spherical mesh (``"xla"``: the
        staged ``dg1_rk_stage`` in its ``qv`` form).

        ``spmd``: on a rank grid, this rank's ``parallel.exchange.RankExchange``
        (``parallel.shardmap.build_sharded_coupled_model`` builds one model
        per rank), with ``mesh`` the rank's block and ``ocean_mask`` the
        global mask. ``mevp_backend`` is then one of
        ``mevp.SPMD_BACKENDS``: ``"blocked"`` (and ``"auto"``), ``"rdma"``
        (the CG1 and the HO solver) or ``"xla"``, with ``mevp_block_halo``
        ghost cells per exchange (``mevp.block_halo_of``: "auto" is
        ``mevp.BLOCK_HALO``, at most half the block); with the HO solver
        the transport advects with the CG2 samples on the widened block;
        ``transport_backend`` ``"tiled"`` (and ``"auto"``: the widened block
        on transport_tiled) or ``"xla"``. The transport's ``"xla"``, and
        ``"auto"`` where the block has no spmd tiled transport (a block too
        small for one substep's ghost cells, and TVB on a graded or
        spherical mesh, as on one domain), is the staged route with width-1
        exchanges (``coupled_cuda.spmd_staged_transport``: on a card the
        halo forms of dg1_rk_stage and dg1_limit); the mEVP's ``"xla"``,
        its width-1 schedule, exchanges strips before each half of every
        subcycle (``coupled_cuda.spmd_xla_subcycles``: on a card the halo
        forms of mevp_stress and mevp_velocity, or with the HO solver
        ho_stress and ho_velocity).
        """
        self.exchange = None if isinstance(spmd, tuple) else spmd
        if self.exchange is None and any(axis is not None for axis in spmd):
            raise NotImplementedError(
                "spmd takes a rank's parallel.exchange.RankExchange (device-mesh "
                f"axis names are the JAX package's), got {spmd!r}"
            )
        self.spmd = (None, None) if self.exchange is None else self.exchange.axes
        backends = SPMD_BACKENDS if self.exchange is not None else MEVP_BACKENDS
        if mevp_backend not in backends:
            raise ValueError(f"mevp_backend must be one of {backends}, got {mevp_backend!r}")
        if transport_backend not in TRANSPORT_BACKENDS:
            raise ValueError(
                f"transport_backend must be one of {TRANSPORT_BACKENDS}, "
                f"got {transport_backend!r}"
            )
        self.mesh = mesh
        solver_cls = get_loader().get_implementation("Nextsim::IDynamics")
        self.ocean_mask = None
        if ocean_mask is not None:
            self.ocean_mask = np.asarray(ocean_mask, dtype=np.float64)
            expected = (mesh.nx, mesh.ny)
            if self.exchange is not None:
                expected = (mesh.nx * self.exchange.shape[0], mesh.ny * self.exchange.shape[1])
            if self.ocean_mask.shape != expected:
                raise ValueError(
                    f"ocean_mask has shape {self.ocean_mask.shape}, expected {expected}"
                )
        self._masks = {}
        self._widened_transport = {}
        self._widened_metric = {}
        self.transport = DGTransport(mesh, degree=degree, spmd=self.spmd, tvb_m=tvb_m)
        if self.exchange is not None:
            self.mevp = solver_cls(
                mesh, mevp_params, backend=mevp_backend, spmd=self.spmd,
                block_halo=mevp_block_halo,
            )
        elif issubclass(solver_cls, MEVPSolverHO):
            self.mevp = solver_cls(mesh, mevp_params, backend=mevp_backend)
        else:
            self.mevp = solver_cls(mesh, mevp_params)
        self.n_subcycles = int(n_subcycles)
        self.transport_substeps = max(1, int(transport_substeps))
        self.auto_substeps = bool(auto_substeps)
        self.mevp_backend = mevp_backend
        self.transport_backend = transport_backend
        if transport_backend == "tiled" and not self._tiled_transport_runs():
            raise NotImplementedError(
                "transport_tiled takes the TVB tolerance as one number: TVB on a graded or "
                "spherical mesh runs the staged transport (transport_backend 'xla' or 'auto')"
            )
        self.physics = NextsimPhysics() if physics is None else physics

    def _tiled_transport_runs(self) -> bool:
        """Whether transport_tiled runs this model's transport: not with the
        TVB limiter on a graded or spherical mesh, whose tolerance M dx^2 is
        a per-element plane (the JAX package's rule too)."""
        return self.mesh.uniform or not self.transport.limits_slopes

    @property
    def is_high_order(self) -> bool:
        """Whether the momentum solver is the CG2/dG1 ``MEVPSolverHO``."""
        return isinstance(self.mevp, MEVPSolverHO)

    @property
    def is_free_drift(self) -> bool:
        """Whether the momentum solver is ``FreeDriftSolver``."""
        return isinstance(self.mevp, FreeDriftSolver)

    # -- kernel schedule -----------------------------------------------------
    def mevp_schedule(self, sms: int = None) -> str:
        """``"fused"`` (fused_dynamics: the whole phase in one launch),
        ``"pallas"`` (K1's split schedule), ``"single"`` (mevp_single) or
        ``"pallas-tiled"`` (mevp_tiled); with the HO solver ``"single"``
        (ho_single) or ``"tiled"`` (ho_tiled); with free drift
        ``"free-drift"`` (its plain step); on a rank grid the exchange
        schedule, ``"blocked"``, ``"rdma"`` or ``"xla"``.

        ``sms``: the streaming multiprocessors of the card the step runs on
        (None where there is none to ask, as on the CPU, whose plain path
        ignores the schedule). "auto" takes a single-launch kernel only
        where its tiles all fit on them (``holds``) and the tiled one
        otherwise, as the JAX package asks ``pallas_supported`` first; an
        explicit ``"pallas"`` on a non-uniform grid the card does not hold
        raises in the kernel's wrapper. On a uniform mesh ``"pallas"`` and
        "auto" (below ``FUSED_MAX_ELEMENTS``) take ``"fused"`` only with
        ``sms`` given and where the kernel holds the grid and the form
        (``fused_dynamics_cuda.holds_model``), as JAX's "pallas" takes
        ``fused_dynamics_pallas`` wherever ``pallas_supported``; elsewhere,
        and with ``sms=None``, K1's split schedule or the tiled one."""
        if self.is_high_order:
            return self.mevp.schedule(sms)
        if self.is_free_drift:
            return "free-drift"
        if self.exchange is not None:
            return self.mevp.schedule()
        backend = self.mevp_backend
        mesh = self.mesh
        if (
            mesh.uniform and sms is not None
            and (backend == "pallas" or (backend == "auto" and mesh.n_elements < FUSED_MAX_ELEMENTS))
            and fused_dynamics_cuda.holds_model(self, sms)
        ):
            return "fused"
        if backend == "auto" and mesh.uniform:
            backend = "pallas-tiled" if mesh.n_elements >= TILED_MIN_ELEMENTS else "pallas"
        elif backend == "auto":
            single = mesh.n_elements < SINGLE_MAX_ELEMENTS and (
                sms is None
                or mevp_single_cuda.holds(mesh.nx, mesh.ny, sms, (mesh.periodic_x, mesh.periodic_y))
            )
            backend = "pallas" if single else "pallas-tiled"
        if backend == "pallas" and not mesh.uniform:
            return "single"
        return backend

    def schedule(self, device) -> tuple:
        """(``mevp_schedule``, ``transport_schedule``) of a step on
        ``device``: on a CUDA card for its streaming multiprocessors (what
        the step runs there), elsewhere with none to ask."""
        device = torch.device(device)
        sms = sm_count(device) if device.type == "cuda" else None
        return self.mevp_schedule(sms), self.transport_schedule(sms)

    def transport_schedule(self, sms: int = None) -> str:
        """``"xla"`` (one dg1_rk_stage per stage; on a rank grid the staged
        route with width-1 exchanges, the halo forms of dg1_rk_stage and
        dg1_limit on a card; with the ``"fused"`` and K1's schedules, the
        whole-phase schedules, where the transport backend does not apply)
        or ``"tiled"``. ``sms`` as ``mevp_schedule``'s."""
        if self.exchange is not None:
            from .dynamics.kernels.transport_tiled_cuda import transport_tiled_spmd_config

            if self.transport_backend == "xla":
                return "xla"
            if transport_tiled_spmd_config(self) is not None:
                return "tiled"
            if self.transport_backend == "tiled":
                raise NotImplementedError(
                    f"no spmd tiled transport for {self.transport.scheme} on a "
                    f"{self.mesh.nx} x {self.mesh.ny} block"
                )
            return "xla"
        if self.is_high_order:
            # transport_tiled on the CG2 samples at every size and scheme,
            # where it runs this transport (not TVB on a non-uniform mesh).
            if self.transport_backend != "auto":
                return self.transport_backend
            return "tiled" if self._tiled_transport_runs() else "xla"
        if self.mevp_schedule(sms) in ("pallas", "fused"):
            return "xla"
        if self.transport_backend != "auto":
            return self.transport_backend
        if not self._tiled_transport_runs():
            return "xla"
        return "tiled" if self.mesh.n_elements >= TILED_MIN_ELEMENTS else "xla"

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
        velocity_cls = HOVelocityState if self.is_high_order else VelocityState
        return CoupledState(
            hice=dg(hice0),
            cice=dg(cice0),
            hsnow=dg(hsnow0),
            sst=full((nx, ny), sst0),
            sss=full((nx, ny), sss0),
            tice=full((nlayers, nx, ny), tice0),
            velocity=velocity_cls.zeros(nx, ny, device=device, dtype=dtype),
            new_ice=torch.zeros((nx, ny), device=device, dtype=dtype),
        )

    def widened_transport(self, halo: int) -> DGTransport:
        """The transport operator, without an exchange, of this rank's block
        widened by ``halo`` cells on every side (built once per halo): a
        closed block (its strips are the exchange's, round the ring on a
        periodic axis) of the block's widths, or a ``MetricShim`` whose
        metric is ``widened_metric``; with the model's TVB constant."""
        if halo not in self._widened_transport:
            mesh = self.mesh
            widened = block_mesh(mesh.nx + 2 * halo, mesh.ny + 2 * halo, mesh)
            self._widened_transport[halo] = DGTransport(
                widened, self.transport.basis.degree, self.transport.scheme,
                tvb_m=self.transport.tvb_m,
            )
        return self._widened_transport[halo]

    def widened_metric(self, halo: int, *, device, dtype):
        """The transport's metric planes (``DGTransport.metric_planes``) of
        this rank's block widened by ``halo`` cells, or None on a uniform
        mesh: the global mesh's there (a ``LocalMeshView``'s
        ``window_metric``), round a ring, and 0 beyond a closed wall, where
        the JAX package's exchange brings zero strips (inert: every use is
        a multiply). Built once per (halo, device, dtype)."""
        mesh = self.mesh
        if mesh.uniform:
            return None
        key = (halo, torch.device(device), dtype)
        if key not in self._widened_metric:
            m, inside = mesh.window_metric(halo, device=device, dtype=dtype)
            zero = torch.zeros((), device=device, dtype=dtype)
            self._widened_metric[key] = {
                "inv_dx": torch.where(inside, 1.0 / m["dx"], zero),
                "inv_dy": torch.where(inside, 1.0 / m["dy"], zero),
                "face_x": m["face_x"],
                "face_y": m["face_y"],
                "inv_area": torch.where(inside, 1.0 / m["area"], zero),
            }
        return self._widened_metric[key]

    def _local_ocean_mask(self):
        """This block's part of the ocean mask: on a rank grid the model
        holds the global mask and each rank slices its block by its grid
        coordinates."""
        if self.exchange is None:
            return self.ocean_mask
        (ix, iy), nx, ny = self.exchange.coords, self.mesh.nx, self.mesh.ny
        return self.ocean_mask[ix * nx: (ix + 1) * nx, iy * ny: (iy + 1) * ny]

    def _static_masks(self, device, dtype) -> dict:
        """The node mask and the coastline face masks, built once per
        (device, dtype): the JAX package rebuilds the same values in every
        step. On a rank grid the first step builds them, every rank at the
        same point of its program (the shifts exchange halos)."""
        key = (torch.device(device), dtype)
        if key not in self._masks:
            mask = self.mevp.boundary_mask(device=device, dtype=dtype)
            faces = is_ocean = None
            if self.ocean_mask is not None:
                ax_x, ax_y = self.spmd
                px, py = self.mesh.periodic_x, self.mesh.periodic_y
                ocean = torch.as_tensor(self._local_ocean_mask(), device=device).to(dtype)
                o_x = shift_m(ocean, 0, px, ax_x)
                o_y = shift_m(ocean, 1, py, ax_y)
                o_xy = shift_m(o_x, 1, py, ax_y)
                if self.is_high_order:
                    # A CG2 node is no-slip unless every element it touches
                    # is ocean: a vertex touches 4, an edge midpoint 2, a
                    # centre its own.
                    mask = HOField(
                        v=mask.v * ocean * o_x * o_y * o_xy, b=mask.b * ocean * o_y,
                        l=mask.l * ocean * o_x, c=mask.c * ocean,
                    )
                else:
                    # CG1 node (i, j): no-slip unless all 4 adjacent
                    # elements are ocean.
                    mask = mask * ocean * o_x * o_y * o_xy
                faces = face_masks_from_land(ocean, px, py, spmd=self.spmd)
                is_ocean = ocean == 1.0
            self._masks[key] = {"node": mask, "faces": faces, "ocean": is_ocean}
        return self._masks[key]

    def node_mask(self, *, device, dtype):
        """1 on active CG1 nodes, 0 on the no-slip walls and on every node
        that touches land; with the HO solver the same per CG2 plane, as an
        ``HOField``."""
        return self._static_masks(device, dtype)["node"]

    def face_masks(self, *, device, dtype):
        """(face_x, face_y): 1 on faces between two ocean elements, 0 on
        coastline faces; None without an ocean mask."""
        return self._static_masks(device, dtype)["faces"]

    # -- one coupled timestep ------------------------------------------------
    def step_dynamics(
        self, state: CoupledState, dyn_forcing: DynamicsForcing, dt: float,
        phase=None,
    ) -> CoupledState:
        """mEVP + transport + bounds. ``phase`` runs the dynamics phase
        (default: ``coupled_cuda.dynamics_phase`` on this model's kernel
        schedule); passing ``coupled_cuda.fused_dynamics_reference`` runs the
        plain PyTorch path on any device, for comparison with the kernels.
        With the HO solver the forcing (vertex planes) is interpolated to
        the CG2 nodes first."""
        hice, cice, hsnow = state.hice, state.cice, state.hsnow
        velocity = state.velocity
        if self.is_high_order:
            dyn_forcing = HODynamicsForcing.from_vertex_forcing(
                dyn_forcing, self.mesh.periodic_x, self.mesh.periodic_y, self.spmd
            )
        mask = self.node_mask(device=hice.device, dtype=hice.dtype)
        if self.is_free_drift:  # no per-step consts: the phase gets the step's inputs
            consts = dict(h=hice[0], a=torch.clamp(cice[0], 0.0, 1.0), forcing=dyn_forcing, mask=mask)
        else:
            consts = self.mevp.step_consts(
                velocity, hice[0], torch.clamp(cice[0], 0.0, 1.0),
                dyn_forcing, mask, dt,
            )
        tracers = torch.stack([hice, cice, hsnow], dim=1)
        carry0 = (velocity.u, velocity.v, velocity.s11, velocity.s22, velocity.s12)
        if phase is None:
            mevp, transport = self.schedule(hice.device)
            phase = functools.partial(dynamics_phase, mevp=mevp, transport=transport)
        faces = self.face_masks(device=hice.device, dtype=hice.dtype)
        final, tracers = phase(self, carry0, tracers, consts, dt, self.n_subcycles, faces)
        velocity_cls = HOVelocityState if self.is_high_order else VelocityState
        velocity = velocity_cls(*final)
        hice, cice, hsnow = tracers[:, 0], tracers[:, 1], tracers[:, 2]
        return dataclasses.replace(
            state,
            hice=_clamp_dg(hice, 0.0, None),
            cice=_clamp_dg(cice, 0.0, 1.0),
            hsnow=_clamp_dg(hsnow, 0.0, None),
            velocity=velocity,
        )

    def step_thermo(self, state: CoupledState, phys_forcing: Forcing, dt: float) -> CoupledState:
        """Column physics on the cell means; the higher DG moments are
        rescaled by new/old mean, so the sub-element shape is kept. With an
        ocean mask, land elements keep every field as it was (there is no
        ocean under them, so no new ice either)."""
        if not isinstance(phys_forcing, Forcing):
            raise ValueError(
                f"the column physics needs a state.Forcing, got {type(phys_forcing).__name__}"
            )
        hice, cice, hsnow = state.hice, state.cice, state.hsnow
        prog = PrognosticState(
            hice=hice[0], cice=cice[0], hsnow=hsnow[0],
            sst=state.sst, sss=state.sss, tice=state.tice,
        )
        updated, diags = self.physics.step(prog, phys_forcing, state.new_ice, dt)
        new_ice = diags.new_ice
        if self.ocean_mask is not None:
            ocean = self._static_masks(hice.device, hice.dtype)["ocean"]
            keep = lambda new, old: torch.where(ocean, new, old)
            updated = dataclasses.replace(
                updated,
                hice=keep(updated.hice, prog.hice),
                cice=keep(updated.cice, prog.cice),
                hsnow=keep(updated.hsnow, prog.hsnow),
                sst=keep(updated.sst, prog.sst),
                sss=keep(updated.sss, prog.sss),
                tice=torch.where(ocean[None], updated.tice, prog.tice),
            )
            new_ice = keep(new_ice, state.new_ice)
        return dataclasses.replace(
            state,
            hice=_rescale_dg(hice, updated.hice),
            cice=_rescale_dg(cice, updated.cice),
            hsnow=_rescale_dg(hsnow, updated.hsnow),
            sst=updated.sst,
            sss=updated.sss,
            tice=updated.tice,
            new_ice=new_ice,
        )

    def step(
        self,
        state: CoupledState,
        phys_forcing: Forcing,
        dyn_forcing: DynamicsForcing,
        dt: float,
        do_dynamics: bool = True,
        do_thermo: bool = True,
    ) -> CoupledState:
        if do_dynamics:
            state = self.step_dynamics(state, dyn_forcing, dt)
        if do_thermo:
            state = self.step_thermo(state, phys_forcing, dt)
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
    ratio = safe_div(new_mean, coeffs[0])
    return torch.cat([new_mean[None], coeffs[1:] * ratio[None]], dim=0)
