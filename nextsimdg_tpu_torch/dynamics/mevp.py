"""mEVP (modified elastic-viscous-plastic) momentum and rheology solver.

Counterpart of ``nextsimdg_tpu.dynamics.mevp`` for the CG1 solver on a
uniform, graded or spherical mesh, each axis closed or periodic, in eager
PyTorch:

* velocity (u, v) on CG1 nodes, stresses (s11, s22, s12) per element, all
  (nx, ny) in the owned layout of ``dynamics.stencil``;
* per subcycle: strain rates from bilinear velocity gradients -> VP stress
  with ellipse ratio e and replacement pressure -> alpha-relaxation of the
  stress -> weak-form stress divergence assembled to nodes -> beta-relaxed
  velocity update with semi-implicit ocean drag and explicit Coriolis;
* Dirichlet (no-slip) walls on closed axes and ice-free nodes held at
  rest; a periodic axis wraps every neighbour shift.

On a graded or spherical mesh the geometry rides five extra per-step const
planes (``inv_dx``, ``inv_dy``, ``half_dx``, ``half_dy``, ``inv_w``), the
metric forms of the strain rates and the stress divergence read them, and
the 7 uniform consts become 12, as in the JAX package.

Two momentum forms of ``MEVPParams`` change the subcycle, as in the JAX
package: ``a_weighted_stress`` scales both surface stresses by the lumped
nodal concentration (one more const plane, ``a_node``, and the nodes below
``a_dyn_min`` held at rest) and ``adaptive_alpha`` gives every element and
node its own alpha = beta (the aEVP stabilisation), at the price of the
shared divide: two divides and a square root more a subcycle.

The expression order is the JAX package's, operation for operation, so
that the two agree to rounding at float64. Scalars stay Python floats, so
a float32 state never promotes.

The subcycle is split in two halves, ``stress_update`` (per element) and
``velocity_update`` (per node): they are the plain versions of the two CUDA
kernels in ``dynamics.kernels.coupled_cuda``.

On a rank grid (``nextsimdg_tpu_torch.parallel``) the solver holds one
rank's block (a uniform ``RectMesh``, or a ``LocalMeshView`` of a graded or
spherical mesh) and its ``spmd`` exchange axes, which are rings on the
periodic axes, and runs the N subcycles on one of the JAX package's
exchange schedules (``MEVPSolver.schedule``): ``"blocked"`` widens the
block by h ghost cells once per h subcycles (``mevp_tiled`` on the widened
block on a card), ``"rdma"`` runs the overlapped round of K7
(``kernels.mevp_rdma_cuda``), ``"xla"`` exchanges width-1 strips before
each half of every subcycle (on a card the halo forms of K1's two halves,
``kernels.coupled_cuda.spmd_xla_subcycles``). On a view the metric rides
the const planes through every schedule, widened with the others (on
"xla" the strips of half_dx and half_dy), as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .mesh import RectMesh, block_mesh, device_metric_planes
from .stencil import halo_widen, is_global_edge, shift_m, shift_p


@dataclass(frozen=True)
class MEVPParams:
    """Physical + numerical parameters (VP rheology and mEVP relaxation).

    Field for field the JAX package's ``MEVPParams``: ``a_weighted_stress``
    scales the wind and ocean stresses by the nodal concentration A and
    holds nodes with A below ``a_dyn_min`` at rest; ``adaptive_alpha`` sets
    alpha = beta = max(``alpha_min``, ``c_stab`` sqrt(zeta dt / (m A))) per
    node and subcycle in place of the fixed ``alpha`` and ``beta``.
    """

    rho_ice: float = 917.0  #: ice density [kg m-3]
    rho_atm: float = 1.225  #: air density [kg m-3]
    rho_ocean: float = 1026.0  #: ocean water density [kg m-3]
    cd_atm: float = 1.2e-3  #: air drag coefficient
    cd_ocean: float = 5.5e-3  #: water drag coefficient
    p_star: float = 27500.0  #: ice strength [N m-2]
    ellipse: float = 2.0  #: ellipse aspect ratio e
    c_compaction: float = 20.0  #: strength compaction constant C
    delta_min: float = 2e-9  #: minimum Delta [s-1]
    alpha: float = 1500.0  #: mEVP stress relaxation
    beta: float = 1500.0  #: mEVP velocity relaxation
    f_coriolis: float = 1.46e-4  #: Coriolis parameter [s-1]
    use_coriolis: bool = True
    min_ice_mass: float = 1.0  #: [kg m-2] below which nodes are held at rest
    a_weighted_stress: bool = False
    a_dyn_min: float = 5e-2
    adaptive_alpha: bool = False
    alpha_min: float = 150.0
    c_stab: float = 6.2832


@dataclass(frozen=True)
class VelocityState:
    """CG1 velocity at owned nodes + element stresses, each (nx, ny)."""

    u: torch.Tensor  #: x velocity at owned nodes [m s-1]
    v: torch.Tensor  #: y velocity at owned nodes
    s11: torch.Tensor  #: stress components per element
    s22: torch.Tensor
    s12: torch.Tensor

    @classmethod
    def zeros(cls, nx: int, ny: int, *, device, dtype) -> "VelocityState":
        z = lambda: torch.zeros((nx, ny), device=device, dtype=dtype)
        return cls(u=z(), v=z(), s11=z(), s22=z(), s12=z())


@dataclass(frozen=True)
class DynamicsForcing:
    """Wind and ocean-current forcing at owned CG nodes, each (nx, ny)."""

    u_atm: torch.Tensor
    v_atm: torch.Tensor
    u_ocean: torch.Tensor
    v_ocean: torch.Tensor


#: The per-step const planes of every mesh, and the metric planes that a
#: graded or spherical mesh adds to them.
UNIFORM_CONSTS = ("strength", "dt_m", "active", "b_u", "b_v", "u_ocean", "v_ocean")
METRIC_CONSTS = ("inv_dx", "inv_dy", "half_dx", "half_dy", "inv_w")
#: Every const plane in the kernels' order (MevpConsts in
#: csrc/mevp_body.cuh): the uniform ones, the metric ones, and the nodal
#: concentration of the A-weighted form.
MEVP_CONSTS = UNIFORM_CONSTS + METRIC_CONSTS + ("a_node",)


def const_names(weighted: bool, uniform: bool) -> tuple:
    """The const planes that ``step_consts`` returns on a uniform or a
    graded/spherical mesh, with or without ``a_weighted_stress``, in the
    kernels' order."""
    return tuple(
        name for name in MEVP_CONSTS
        if (name not in METRIC_CONSTS or not uniform) and (name != "a_node" or weighted)
    )


def _div(c: float, t: torch.Tensor) -> torch.Tensor:
    """c / t as a true division (``float / tensor`` is reciprocal * c)."""
    return torch.div(t.new_full((), c), t)


def cell_to_node(cell, periodic_x: bool = False, periodic_y: bool = False, spmd=(None, None)):
    """Average the 4 adjacent element values to each owned node.

    Lumped-mass CG1 projection. Closed boundaries zero-fill the missing
    neighbours (those nodes are Dirichlet-masked anyway). ``spmd``: the
    rank's (x, y) exchange axes on a rank grid.
    """
    cm_x = shift_m(cell, 0, periodic_x, spmd[0])
    cm_y = shift_m(cell, 1, periodic_y, spmd[1])
    cm_xy = shift_m(cm_x, 1, periodic_y, spmd[1])
    return 0.25 * (cell + cm_x + cm_y + cm_xy)


#: mEVP schedules of a rank grid; "auto" is "blocked", as in the JAX package.
SPMD_BACKENDS = ("auto", "blocked", "rdma", "xla")
#: Ghost width h of the blocked and rdma schedules (subcycles per exchange),
#: the JAX package's default; chip_smoke.py times 4, 8 and 16 at config 5's
#: blocks (PERF.md).
BLOCK_HALO = 16


def block_halo_of(block_halo, mesh: RectMesh, on_grid: bool) -> int:
    """The ghost width h of a solver on ``mesh`` (a rank's block): "auto" is
    ``BLOCK_HALO``, at most half the block (the rdma round's limit); on a
    rank grid h must lie in [1, min(nx, ny)] (the exchange strips are slices
    of the block). The CG1 and HO solvers both take it from here."""
    if block_halo == "auto":
        block_halo = max(1, min(BLOCK_HALO, mesh.nx // 2, mesh.ny // 2))
    block_halo = int(block_halo)
    if on_grid and not 1 <= block_halo <= min(mesh.nx, mesh.ny):
        raise ValueError(
            f"block_halo {block_halo} must lie in [1, {min(mesh.nx, mesh.ny)}] "
            "(the exchange strips are slices of the block)"
        )
    return block_halo


class MEVPSolver:
    """The CG1 mEVP solver on a ``RectMesh`` or ``SphericalMesh``, each axis
    closed or periodic.

    ``spmd``: on a rank grid, this rank's (x, y) ``AxisExchange`` pair
    (``RankExchange.axes``) and its block as ``mesh`` (a ``RectMesh``, or a
    ``LocalMeshView`` of a graded or spherical mesh);
    ``backend`` (one of ``SPMD_BACKENDS``) and ``block_halo`` (ghost cells
    per exchange; "auto": ``BLOCK_HALO``, at most half the block) then pick
    the exchange schedule. Without a rank grid the kernel schedule is chosen by
    ``CoupledModel`` and ``backend`` must stay "auto".
    """

    def __init__(
        self, mesh: RectMesh, params: MEVPParams = MEVPParams(), backend: str = "auto",
        spmd=(None, None), block_halo="auto",
    ) -> None:
        self.spmd = tuple(spmd)
        on_grid = any(axis is not None for axis in self.spmd)
        if backend not in (SPMD_BACKENDS if on_grid else ("auto",)):
            raise ValueError(
                f"backend {backend!r}: a rank grid takes one of {SPMD_BACKENDS}, "
                "a single domain only 'auto' (CoupledModel picks its kernels)"
            )
        self.mesh = mesh
        self.params = params
        self.backend = backend
        self.block_halo = block_halo_of(block_halo, mesh, on_grid)
        self._metric = {}

    @property
    def on_rank_grid(self) -> bool:
        return any(axis is not None for axis in self.spmd)

    def local(self) -> "MEVPSolver":
        """This solver on the same block without an exchange (the inner
        solver of the exchange schedules): on a uniform block its mesh, on a
        view a ``MetricShim`` (the metric rides the consts), each with the
        global periodic axes, which the rdma round wraps where an axis is
        not split over ranks."""
        mesh = self.mesh
        return type(self)(
            block_mesh(mesh.nx, mesh.ny, mesh, (mesh.periodic_x, mesh.periodic_y)), self.params
        )

    def schedule(self) -> str:
        """The exchange schedule on a rank grid: "blocked", "rdma" or "xla"."""
        if not self.on_rank_grid:
            raise ValueError("only a solver on a rank grid has an exchange schedule")
        return "blocked" if self.backend == "auto" else self.backend

    def metric_planes(self, *, device, dtype):
        """None when uniform; else dict(area, node_area, inv_w, inv_dx,
        inv_dy, half_dx, half_dy) of (nx, ny) planes, built once per
        (device, dtype): the JAX package rebuilds the same values in every
        step. On a ``LocalMeshView`` the node areas read the area one cell
        before the block, sliced from the global mesh (0 beyond a closed
        wall, wrapped on a ring) where the JAX package exchanges it: the
        same values, so the planes are the single domain's slices."""
        if self.mesh.uniform:
            return None
        key = (torch.device(device), dtype)
        if key not in self._metric:
            px, py = self.mesh.periodic_x, self.mesh.periodic_y
            m = device_metric_planes(self.mesh, device=device, dtype=dtype)
            if self.mesh.is_local_view:
                area = self.mesh.window_metric(1, 0, device=device, dtype=dtype)[0]["area"]
                node_area = 0.25 * (area[1:, 1:] + area[:-1, 1:] + area[1:, :-1] + area[:-1, :-1])
            else:
                node_area = cell_to_node(m["area"], px, py)
            self._metric[key] = {
                "area": m["area"],
                "node_area": node_area,
                "inv_w": 1.0 / node_area,
                "inv_dx": 1.0 / m["dx"],
                "inv_dy": 1.0 / m["dy"],
                "half_dx": 0.5 * m["dx"],
                "half_dy": 0.5 * m["dy"],
            }
        return self._metric[key]

    # -- per-element strain rates from CG1 velocity --------------------------
    def strain_rates(self, u, v, metric=None):
        """(e11, e22, e12) at element centres from bilinear gradients.

        Element (i, j) reads owned nodes (i, j), (i+1, j), (i, j+1),
        (i+1, j+1); the +1 shifts supply the implicit wall zeros.
        ``metric``: (inv_dx, inv_dy) per-element planes of a non-uniform
        mesh.
        """
        px, py = self.mesh.periodic_x, self.mesh.periodic_y
        ax_x, ax_y = self.spmd
        u00, v00 = u, v
        u10, v10 = shift_p(u, 0, px, ax_x), shift_p(v, 0, px, ax_x)
        u01, v01 = shift_p(u, 1, py, ax_y), shift_p(v, 1, py, ax_y)
        u11 = shift_p(u10, 1, py, ax_y)
        v11 = shift_p(v10, 1, py, ax_y)
        if metric is not None:
            inv_dx, inv_dy = metric
            du_dx = 0.5 * ((u10 - u00) + (u11 - u01)) * inv_dx
            dv_dy = 0.5 * ((v01 - v00) + (v11 - v10)) * inv_dy
            du_dy = 0.5 * ((u01 - u00) + (u11 - u10)) * inv_dy
            dv_dx = 0.5 * ((v10 - v00) + (v11 - v01)) * inv_dx
            return du_dx, dv_dy, 0.5 * (du_dy + dv_dx)
        dx, dy = self.mesh.dx, self.mesh.dy
        du_dx = 0.5 * ((u10 - u00) + (u11 - u01)) / dx
        dv_dy = 0.5 * ((v01 - v00) + (v11 - v10)) / dy
        du_dy = 0.5 * ((u01 - u00) + (u11 - u10)) / dy
        dv_dx = 0.5 * ((v10 - v00) + (v11 - v01)) / dx
        return du_dx, dv_dy, 0.5 * (du_dy + dv_dx)

    # -- weak-form divergence of element-constant stress to nodes ------------
    def stress_divergence(self, s11, s22, s12, metric=None):
        """Nodal forces (Fu, Fv) = -int sigma : grad(phi), per unit length.

        Node (i, j) reads elements (i-1, j-1), (i-1, j), (i, j-1), (i, j).
        The factoring is the JAX package's 13-shift form: s12 feeds both
        components through one set of three shifts, and the single-component
        scatters go through the partial sum t = cell + shift (bit-identical
        to the signed 2x2 gather). ``metric``: (half_dx, half_dy)
        per-element planes of a non-uniform mesh; each element is then
        weighted by its own half face length before the corner gather.
        """
        px, py = self.mesh.periodic_x, self.mesh.periodic_y
        ax_x, ax_y = self.spmd
        if metric is not None:
            half_dx, half_dy = metric

            def corners(w):
                wm_x = shift_m(w, 0, px, ax_x)
                return wm_x, shift_m(w, 1, py, ax_y), shift_m(wm_x, 1, py, ax_y)

            def scatter_x_m(cell):
                w = cell * half_dy
                wm_x, wm_y, wm_xy = corners(w)
                return (wm_y + w) - (wm_xy + wm_x)

            def scatter_y_m(cell):
                w = cell * half_dx
                wm_x, wm_y, wm_xy = corners(w)
                return (wm_x + w) - (wm_xy + wm_y)

            fu = scatter_x_m(s11) + scatter_y_m(s12)
            fv = scatter_x_m(s12) + scatter_y_m(s22)
            return fu, fv
        dx, dy = self.mesh.dx, self.mesh.dy

        def shifts(cell):
            cm_x = shift_m(cell, 0, px, ax_x)
            cm_y = shift_m(cell, 1, py, ax_y)
            cm_xy = shift_m(cm_x, 1, py, ax_y)
            return cm_x, cm_y, cm_xy

        def scatter_x(cell, sh=None):
            if sh is None:
                t = cell + shift_m(cell, 1, py, ax_y)
                return 0.5 * dy * (t - shift_m(t, 0, px, ax_x))
            cm_x, cm_y, cm_xy = sh
            return 0.5 * dy * ((cm_y + cell) - (cm_xy + cm_x))

        def scatter_y(cell, sh=None):
            if sh is None:
                t = cell + shift_m(cell, 0, px, ax_x)
                return 0.5 * dx * (t - shift_m(t, 1, py, ax_y))
            cm_x, cm_y, cm_xy = sh
            return 0.5 * dx * ((cm_x + cell) - (cm_xy + cm_y))

        sh12 = shifts(s12)
        fu = scatter_x(s11) + scatter_y(s12, sh12)
        fv = scatter_x(s12, sh12) + scatter_y(s22)
        return fu, fv

    # -- one outer timestep: N mEVP subcycles --------------------------------
    def step(
        self, state: VelocityState, h, a, forcing: DynamicsForcing, mask,
        dt: float, n_subcycles: int = 100,
    ) -> VelocityState:
        consts = self.step_consts(state, h, a, forcing, mask, dt)
        carry = (state.u, state.v, state.s11, state.s22, state.s12)
        if self.on_rank_grid:
            carry = self.spmd_subcycles(carry, consts, dt, n_subcycles)
        else:
            for _ in range(n_subcycles):
                carry = self.subcycle_body(carry, consts, dt)
        u, v, s11, s22, s12 = carry
        return VelocityState(u=u, v=v, s11=s11, s22=s22, s12=s12)

    def step_consts(self, state: VelocityState, h, a, forcing, mask, dt: float):
        """The per-step constant planes: ice strength, dt/m, the active
        (mask * ice) factor, the constant numerator terms b_u/b_v =
        u_n + (dt/m) tau_a, and the ocean currents; on a non-uniform mesh
        also the five metric planes inv_w, inv_dx, inv_dy, half_dx and
        half_dy (12 in all); with ``a_weighted_stress`` also ``a_node``,
        the lumped nodal concentration clipped to [0, 1], which weighs the
        wind stress here (b_u, b_v) and the ocean drag in every subcycle,
        and whose nodes below ``a_dyn_min`` are held at rest (``active``).
        The names are
        ``const_names(params.a_weighted_stress, mesh.uniform)``."""
        p = self.params
        px, py = self.mesh.periodic_x, self.mesh.periodic_y

        # Element ice strength P = P* h exp(-C (1-A)).
        strength = p.p_star * h * torch.exp(-p.c_compaction * (1.0 - a))

        # Lumped nodal ice mass per unit area [kg m-2] (area-weighted over
        # the adjacent elements), clamped.
        metric = self.metric_planes(device=h.device, dtype=h.dtype)
        if metric is None:
            cell_area = torch.full_like(h, self.mesh.cell_area)
            node_area = cell_to_node(cell_area, px, py, self.spmd)
        else:
            cell_area, node_area = metric["area"], metric["node_area"]
        m_node = p.rho_ice * cell_to_node(h * cell_area, px, py, self.spmd) / node_area
        ice_node = m_node > p.min_ice_mass
        m_safe = torch.clamp(m_node, min=p.min_ice_mass)

        # Wind stress is constant over the subcycles.
        speed_atm = torch.hypot(forcing.u_atm, forcing.v_atm)
        tau_au = p.rho_atm * p.cd_atm * speed_atm * forcing.u_atm
        tau_av = p.rho_atm * p.cd_atm * speed_atm * forcing.v_atm

        active = mask * ice_node.to(h.dtype)
        dt_m = _div(dt, m_safe)
        wind_u, wind_v = dt_m * tau_au, dt_m * tau_av
        if p.a_weighted_stress:
            # The lumped nodal concentration (area-weighted as m_node),
            # clipped to [0, 1]; nodes below a_dyn_min are held at rest.
            a_node = torch.clamp(
                cell_to_node(a * cell_area, px, py, self.spmd) / node_area, 0.0, 1.0
            )
            active = active * (a_node >= p.a_dyn_min).to(h.dtype)
            wind_u, wind_v = dt_m * a_node * tau_au, dt_m * a_node * tau_av
        consts = dict(
            strength=strength,
            dt_m=dt_m,
            active=active,
            b_u=state.u + wind_u,
            b_v=state.v + wind_v,
            u_ocean=forcing.u_ocean,
            v_ocean=forcing.v_ocean,
        )
        if metric is not None:
            consts.update({name: metric[name] for name in METRIC_CONSTS})
        if p.a_weighted_stress:
            consts["a_node"] = a_node
        return consts

    def stress_update(self, carry, consts):
        """First half of a subcycle, per element: strain, Delta, the shared
        rheology/drag divide and the alpha-relaxed stress.

        Returns (s11, s22, s12, c_w, inv_drag) and, with ``adaptive_alpha``,
        the per-node beta last: the node planes (index (i, j) of the shared
        divide) that ``velocity_update`` takes after ``consts``. With
        ``a_node`` among the consts (``a_weighted_stress``) c_w is the
        A-weighted drag coefficient. The adaptive form gives up the shared
        divide: alpha depends on zeta, so 1/(Delta + Delta_min) and the drag
        denominator are two divides, and alpha = beta a square root.
        """
        p = self.params
        e2 = p.ellipse * p.ellipse
        u, v, s11, s22, s12 = carry
        strength = consts["strength"]
        dt_m = consts["dt_m"]
        active = consts["active"]

        graded = "inv_dx" in consts
        e11, e22, e12 = self.strain_rates(
            u, v, metric=(consts["inv_dx"], consts["inv_dy"]) if graded else None
        )
        delta = torch.sqrt(
            (e11 * e11 + e22 * e22) * (1.0 + 1.0 / e2)
            + 2.0 * e11 * e22 * (1.0 - 1.0 / e2)
            + 4.0 / e2 * e12 * e12
        )
        rel_u = consts["u_ocean"] - u
        rel_v = consts["v_ocean"] - v
        c_w = p.rho_ocean * p.cd_ocean * torch.sqrt(rel_u * rel_u + rel_v * rel_v)
        if "a_node" in consts:
            c_w = c_w * consts["a_node"]  # the A-weighted ocean stress
        denom_rheo = delta + p.delta_min
        if p.adaptive_alpha:
            # Element (i, j)'s zeta and node (i, j)'s dt_m share an index,
            # as the shared divide's two denominators do.
            inv_denom = 1.0 / denom_rheo
            zeta = 0.5 * strength * inv_denom
            inv_area = consts["inv_w"] if graded else 1.0 / (self.mesh.dx * self.mesh.dy)
            alpha = torch.clamp(p.c_stab * torch.sqrt(zeta * dt_m * inv_area), min=p.alpha_min)
            beta = alpha
            inv_drag = active / (1.0 + beta + dt_m * c_w)
            inv_alpha = 1.0 / alpha
        else:
            # The rheology denominator (Delta + Delta_min, element (i, j))
            # and the drag denominator (1 + beta + dt_m c_w, node (i, j))
            # share ONE division: 1/a = (1/(a b)) b.
            denom_drag = 1.0 + p.beta + dt_m * c_w
            inv_both = 1.0 / (denom_rheo * denom_drag)
            inv_denom = inv_both * denom_drag
            inv_drag = active * (inv_both * denom_rheo)
            zeta = 0.5 * strength * inv_denom
            inv_alpha = 1.0 / p.alpha
        eta = zeta * (1.0 / e2)
        p_rep = strength * delta * inv_denom

        div = e11 + e22
        s11_vp = 2.0 * eta * e11 + (zeta - eta) * div - 0.5 * p_rep
        s22_vp = 2.0 * eta * e22 + (zeta - eta) * div - 0.5 * p_rep
        s12_vp = 2.0 * eta * e12
        s11 = s11 + (s11_vp - s11) * inv_alpha
        s22 = s22 + (s22_vp - s22) * inv_alpha
        s12 = s12 + (s12_vp - s12) * inv_alpha
        if p.adaptive_alpha:
            return s11, s22, s12, c_w, inv_drag, beta
        return s11, s22, s12, c_w, inv_drag

    def velocity_update(self, carry, consts, c_w, inv_drag, dt: float, beta=None):
        """Second half of a subcycle, per node: stress divergence and the
        beta-relaxed velocity update with semi-implicit ocean drag (the
        Dirichlet mask is folded into ``inv_drag``). ``beta``: the per-node
        plane that ``stress_update`` returns with ``adaptive_alpha``, None
        for the fixed ``params.beta``. Returns (u, v)."""
        p = self.params
        if (beta is not None) != p.adaptive_alpha:
            raise ValueError(
                "velocity_update takes the per-node beta of stress_update exactly when "
                f"adaptive_alpha is on (adaptive_alpha={p.adaptive_alpha})"
            )
        beta = p.beta if beta is None else beta
        u, v, s11, s22, s12 = carry
        u_ocean, v_ocean = consts["u_ocean"], consts["v_ocean"]
        graded = "inv_dx" in consts
        fu, fv = self.stress_divergence(
            s11, s22, s12, metric=(consts["half_dx"], consts["half_dy"]) if graded else None
        )
        inv_w = consts["inv_w"] if graded else 1.0 / (self.mesh.dx * self.mesh.dy)
        fu = fu * inv_w
        fv = fv * inv_w
        cor_u = p.f_coriolis * (v - v_ocean) if p.use_coriolis else 0.0
        cor_v = -p.f_coriolis * (u - u_ocean) if p.use_coriolis else 0.0
        u_new = (
            beta * u + consts["b_u"]
            + consts["dt_m"] * (fu + c_w * u_ocean) + dt * cor_u
        ) * inv_drag
        v_new = (
            beta * v + consts["b_v"]
            + consts["dt_m"] * (fv + c_w * v_ocean) + dt * cor_v
        ) * inv_drag
        return u_new, v_new

    def subcycle_body(self, carry, consts, dt: float):
        """One mEVP subcycle: ``carry`` is (u, v, s11, s22, s12)."""
        s11, s22, s12, *nodes = self.stress_update(carry, consts)
        u, v = carry[0], carry[1]
        u_new, v_new = self.velocity_update((u, v, s11, s22, s12), consts, *nodes[:2], dt, *nodes[2:])
        return (u_new, v_new, s11, s22, s12)

    def boundary_mask(self, *, device, dtype):
        """1 on interior owned nodes, 0 on the no-slip walls i = 0, j = 0 of
        the closed axes (the i = nx / j = ny nodes are implicit and always
        zero there); a periodic axis has no wall. On a rank grid only the
        block that owns the global first row (column) pins its row 0
        (column 0): the mask rides ``inv_drag``, so pinning an interior rank
        boundary would freeze the velocity there."""
        mask = torch.ones((self.mesh.nx, self.mesh.ny), device=device, dtype=dtype)
        if not self.mesh.periodic_x and is_global_edge("first", self.spmd[0]):
            mask[0, :] = 0.0
        if not self.mesh.periodic_y and is_global_edge("first", self.spmd[1]):
            mask[:, 0] = 0.0
        return mask

    # -- the exchange schedules of a rank grid --------------------------------
    def spmd_subcycles(self, carry, consts, dt: float, n_subcycles: int):
        """(u, v, s11, s22, s12) after N subcycles on this rank's block, on
        the solver's exchange schedule (``schedule``). CPU tensors run the
        plain subcycle inside each schedule; CUDA tensors the kernels.
        ``"xla"`` exchanges width-1 strips before each half of every
        subcycle and runs the halves' halo forms
        (``kernels.coupled_cuda.spmd_xla_subcycles``: on a card the halo
        forms of mevp_stress and mevp_velocity, on the CPU their plain
        versions)."""
        from .kernels.coupled_cuda import spmd_xla_subcycles

        schedule = self.schedule()
        if schedule == "blocked":
            return self._blocked_subcycles(carry, consts, dt, n_subcycles)
        if schedule == "rdma":
            return self._rdma_subcycles(carry, consts, dt, n_subcycles)
        return spmd_xla_subcycles(self, tuple(carry), consts, dt, n_subcycles)

    def _blocked_subcycles(self, carry, consts, dt: float, n_subcycles: int):
        """Ghost-zone ("temporally blocked") exchange: widen the 7 consts by h
        ghost cells once per step and the 5 state planes once per round (one
        strip pair per axis each), run min(h, remaining) subcycles on the
        widened block with closed shifts (global walls arrive as zero strips),
        keep the interior. Each subcycle spoils one ghost ring, so the
        interior equals the per-subcycle exchange exactly.

        The widened block runs ``mevp_tiled`` on a card (the inner engine on
        a uniform mesh: the single-device rule, ``coupled.TILED_MIN_ELEMENTS``,
        takes it from 64^2 up, below every rank block of config 5; K4 is not
        needed here) and the plain subcycle on the CPU. On a view its mesh is
        a ``MetricShim``: the metric consts widen with the others (zeros
        beyond a closed wall are inert: every use is a multiply). On a ring
        the strips wrap round the ranks and the widened block stays closed.
        """
        from .kernels.mevp_tiled_cuda import mevp_subcycles_tiled

        h = self.block_halo
        nx, ny = self.mesh.nx, self.mesh.ny
        ax_x, ax_y = self.spmd

        def widen(f):  # stacked planes: one strip pair per axis for all
            f = halo_widen(f, h, 1, self.mesh.periodic_x, ax_x)
            return halo_widen(f, h, 2, self.mesh.periodic_y, ax_y)

        local = MEVPSolver(block_mesh(nx + 2 * h, ny + 2 * h, self.mesh), self.params)
        consts_w = dict(zip(consts, widen(torch.stack(list(consts.values())))))
        state = torch.stack(list(carry))
        remaining = n_subcycles
        while remaining > 0:
            n_sub = min(h, remaining)
            remaining -= n_sub
            padded = mevp_subcycles_tiled(local, tuple(widen(state)), consts_w, dt, n_sub)
            state = torch.stack(padded)[:, h: h + nx, h: h + ny]
        return tuple(state.contiguous())

    def _rdma_subcycles(self, carry, consts, dt: float, n_subcycles: int):
        """Ghost-zone rounds whose strips travel while the interior computes
        (``kernels.mevp_rdma_cuda.mevp_round_rdma``, K7). The consts are
        widened once per step along the split axes (7 planes per 100
        subcycles: not worth hiding); every round's 5 state strips ride the
        exchange behind the interior pass, corners via the x-then-extended-y
        exchange. An axis with one rank is not split: its walls are the
        block's own zero edges, or on a periodic axis the round wraps along
        it (``mevp_tiled``'s periodic form for the interior, the bands'
        wrap along the band)."""
        from .kernels.mevp_rdma_cuda import mevp_round_rdma

        h = self.block_halo
        axes, consts_w = self.rdma_round_inputs(consts)
        local = self.local()
        remaining = n_subcycles
        carry = tuple(carry)
        while remaining > 0:
            n_sub = min(h, remaining)
            remaining -= n_sub
            carry = mevp_round_rdma(local, carry, consts, consts_w, dt, n_sub, h, axes)
        return carry

    def rdma_round_inputs(self, consts):
        """(axes, consts_w) of the rdma rounds of a step: the (x, y)
        exchange of each axis split over ranks (None for an axis of one
        rank), and the consts widened by h along the split axes (round the
        ring of a periodic axis)."""
        h = self.block_halo
        axes = tuple(ax if ax is not None and ax.size > 1 else None for ax in self.spmd)
        periodic = (self.mesh.periodic_x, self.mesh.periodic_y)
        stacked = torch.stack(list(consts.values()))
        for axis, exchange in enumerate(axes):
            if exchange is not None:
                stacked = halo_widen(stacked, h, axis + 1, periodic[axis], exchange)
        return axes, dict(zip(consts, stacked))
