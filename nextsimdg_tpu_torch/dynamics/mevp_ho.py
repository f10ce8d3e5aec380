"""Higher-order mEVP: CG2 velocity + dG1 stress (the neXtSIM_DG core).

Counterpart of ``nextsimdg_tpu.dynamics.mevp_ho`` on a uniform, graded or
spherical mesh, each axis closed or periodic, in eager PyTorch. Velocity is biquadratic CG2, strain and stress dG1 (3
coefficients per component); the VP law is evaluated at the 2x2 Gauss
points and projected back.

Owned-plane layout: a CG2 scalar field is four (nx, ny) planes (vertex,
bottom-mid, left-mid, centre; see ``cg2basis``), and every per-element
node gather or scatter is a static table contraction plus shifts.

The subcycle is split in two halves, ``stress_update`` (per element: the
9-node gather, strain, the VP law at the Gauss points, projection,
relaxation) and ``velocity_update`` (per node plane: the divergence
scatter, drag and the beta update). They are the plain versions of the two
phases of the CUDA kernels ``ho_single`` and ``ho_tiled``, which run the
same float32 operations in the same order. The expression order is the
JAX package's, operation for operation, so that the two agree to rounding
at float64.

With ``MEVPParams(a_weighted_stress=True)`` the lumped nodal concentration
of each CG2 plane (``a_{k}``, four more const planes) weights the wind and
the ocean drag, and nodes below ``a_dyn_min`` are pinned, as in the JAX
package. On a periodic axis every shift wraps and no node is a wall.

On a graded or spherical mesh the element widths are per-element planes
(``mesh.device_metric_planes``): ``step_consts`` adds ``dx``, ``dy`` and
their reciprocals ``inv_dx``, ``inv_dy`` (four more const planes, as the
JAX package passes them to its kernels) and weights the lumped masses by
the element areas; the strain multiplies by the reciprocals, and the
divergence weights each element's contribution by its own widths before
the scatter. ``adaptive_alpha`` raises ``NotImplementedError``, as in the
JAX package.

On a rank grid (``nextsimdg_tpu_torch.parallel``) the solver holds one
rank's block (a uniform ``RectMesh``, or a ``LocalMeshView`` of a graded or
spherical mesh) and its ``spmd`` exchange axes: every shift of the node
machinery goes through the exchange, only the global first row and column
of a closed axis are walls, and the N subcycles run on the exchange
schedule of ``MEVPSolverHO.schedule``: ``"blocked"`` widens the 17 state
planes by h ghost cells once per h subcycles and runs the single-device
kernels (ho_single or ho_tiled, by the single-device rule) on the widened
block; ``"rdma"`` runs K7's overlapped round on the 17 planes
(``kernels.mevp_rdma_cuda``: the strips travel while the interior pass runs
on the rank's own block, then the edge bands are re-run and patched);
``"xla"`` exchanges width-1 strips before each half of every subcycle and
runs the subcycle's two halves as grid-wide kernels (``ho_stress`` and
``ho_velocity``, built from K5's bodies; their plain versions on the CPU).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .cg2basis import LOCAL_NODE_SOURCE, PLANES, _lagrange_1d, cg2_sampling_table, cg2_tables
from .mesh import RectMesh, block_mesh, device_metric_planes
from .mevp import SPMD_BACKENDS, MEVPParams, MEVPSolver, _div, block_halo_of
from .stencil import halo_widen, is_global_edge, shift_m, shift_p
from .transport import QuadVelocity, apply_table

#: The per-plane const names; with "strength" the 29 planes of step_consts.
HO_PLANE_CONSTS = ("dt_m", "active", "b_u", "b_v", "inv_w", "u_ocean", "v_ocean")
HO_CONSTS = ("strength",) + tuple(f"{name}_{k}" for name in HO_PLANE_CONSTS for k in PLANES)
#: The 33 planes of the A-weighted form: the 29, then a_{k} of each plane.
HO_WEIGHTED_CONSTS = HO_CONSTS + tuple(f"a_{k}" for k in PLANES)
#: The element widths of a graded or spherical mesh, four more planes.
HO_METRIC_CONSTS = ("dx", "dy", "inv_dx", "inv_dy")
#: Every const plane that a kernel takes, in the kernels' order (HoConsts of
#: csrc/ho_body.cuh): 37, of which a form reads 29, 33 or all.
HO_KERNEL_CONSTS = HO_WEIGHTED_CONSTS + HO_METRIC_CONSTS

MEVP_BACKENDS = ("auto", "pallas", "pallas-tiled")
#: Element count from which ``backend="auto"`` runs ho_tiled instead of the
#: single-launch ho_single on the card. Derived on the H100 (700 W) from
#: chip_smoke.py's timings of the two on 100 HO subcycles: ho_single was
#: faster at 128^2 (0.61 against 1.42 ms) and 256^2 (0.81 against 1.41 ms;
#: ho_tiled's 32^2 tiles leave most SMs idle there); at 512^2 the two tied
#: (3.07 against 2.94 ms; the dynamics step 10.9 against 11.4 ms, within
#: the run-to-run spread); at 1024^2 ho_tiled was faster (11.3 against
#: 12.7 ms: ho_single's 46 planes stream from HBM once they outgrow the
#: 50 MB L2). So the tie goes to ho_tiled. Below it "auto" still takes
#: ho_tiled where the card does not hold the grid (``MEVPSolverHO.schedule``).
#: See PERF.md.
HO_SINGLE_MAX_ELEMENTS = 512 * 512


@dataclass(frozen=True)
class HOField:
    """One CG2 scalar field in owned planes, each (nx, ny)."""

    v: torch.Tensor  #: vertex nodes (i, j)
    b: torch.Tensor  #: bottom edge midpoints (i+1/2, j)
    l: torch.Tensor  #: left edge midpoints (i, j+1/2)
    c: torch.Tensor  #: centres (i+1/2, j+1/2)

    def planes(self):
        return (self.v, self.b, self.l, self.c)

    @classmethod
    def zeros(cls, nx: int, ny: int, *, device, dtype) -> "HOField":
        z = lambda: torch.zeros((nx, ny), device=device, dtype=dtype)
        return cls(v=z(), b=z(), l=z(), c=z())

    @classmethod
    def from_function(cls, mesh: RectMesh, fn, *, device, dtype) -> "HOField":
        """Sample an analytic field fn(x, y) at the owned node coordinates."""
        xn, yn = mesh.node_coords()
        xv, yv = xn[:-1, :-1], yn[:-1, :-1]
        xm = 0.5 * (xn[:-1, :-1] + xn[1:, :-1])
        ym = 0.5 * (yn[:-1, :-1] + yn[:-1, 1:])
        coords = {"v": (xv, yv), "b": (xm, yv), "l": (xv, ym), "c": (xm, ym)}
        return cls(**{
            name: torch.tensor(
                np.broadcast_to(fn(x, y), (mesh.nx, mesh.ny)).copy(), device=device, dtype=dtype
            )
            for name, (x, y) in coords.items()
        })

    @classmethod
    def from_vertex_field(
        cls, vertex, periodic_x: bool = False, periodic_y: bool = False, spmd=(None, None),
    ) -> "HOField":
        """Mid and centre planes interpolated from a vertex (CG1) field; on
        a periodic axis the node beyond the last is the first; ``spmd``: a
        rank's (x, y) exchange axes, through which the shifts go."""
        vx = shift_p(vertex, 0, periodic_x, spmd[0])
        vy = shift_p(vertex, 1, periodic_y, spmd[1])
        vxy = shift_p(vx, 1, periodic_y, spmd[1])
        return cls(
            v=vertex, b=0.5 * (vertex + vx), l=0.5 * (vertex + vy),
            c=0.25 * (vertex + vx + vy + vxy),
        )


@dataclass(frozen=True)
class HOVelocityState:
    """CG2 velocity and dG1 stress coefficients, each stress (3, nx, ny)."""

    u: HOField
    v: HOField
    s11: torch.Tensor
    s22: torch.Tensor
    s12: torch.Tensor

    @classmethod
    def zeros(cls, nx: int, ny: int, *, device, dtype) -> "HOVelocityState":
        z = lambda: torch.zeros((3, nx, ny), device=device, dtype=dtype)
        return cls(
            u=HOField.zeros(nx, ny, device=device, dtype=dtype),
            v=HOField.zeros(nx, ny, device=device, dtype=dtype),
            s11=z(), s22=z(), s12=z(),
        )


@dataclass(frozen=True)
class HODynamicsForcing:
    """Wind and ocean forcing as CG2 fields."""

    u_atm: HOField
    v_atm: HOField
    u_ocean: HOField
    v_ocean: HOField

    @classmethod
    def from_vertex_forcing(
        cls, forcing, periodic_x: bool = False, periodic_y: bool = False, spmd=(None, None),
    ) -> "HODynamicsForcing":
        """The CG2 forcing of a CG1 ``DynamicsForcing`` (vertex planes) on a
        mesh with these periodic axes (on a rank grid: the rank's block and
        exchange axes ``spmd``)."""
        return cls(**{
            name: HOField.from_vertex_field(getattr(forcing, name), periodic_x, periodic_y, spmd)
            for name in ("u_atm", "v_atm", "u_ocean", "v_ocean")
        })


def gather_local(field: HOField, periodic_x: bool = False, periodic_y: bool = False, spmd=(None, None)):
    """The 9 local node values of every element, (9, nx, ny), n = 3a + b;
    beyond the last node of a closed axis a zero, of a periodic one the
    first; on a rank grid (``spmd``: the rank's exchange axes) the
    neighbour rank's."""
    planes = {"v": field.v, "b": field.b, "l": field.l, "c": field.c}
    out = []
    for n in range(9):
        plane, sx, sy = LOCAL_NODE_SOURCE[divmod(n, 3)]
        arr = planes[plane]
        if sx:
            arr = shift_p(arr, 0, periodic_x, spmd[0])
        if sy:
            arr = shift_p(arr, 1, periodic_y, spmd[1])
        out.append(arr)
    return torch.stack(out)


def scatter_local(contribs, periodic_x: bool = False, periodic_y: bool = False, spmd=(None, None)) -> HOField:
    """Accumulate (9, nx, ny) per-element local-node contributions onto the
    owned planes, in ascending n (the adjoint of ``gather_local`` on the
    same axes and exchange)."""
    planes = dict.fromkeys(PLANES)
    for n in range(9):
        plane, sx, sy = LOCAL_NODE_SOURCE[divmod(n, 3)]
        arr = contribs[n]
        if sx:
            arr = shift_m(arr, 0, periodic_x, spmd[0])
        if sy:
            arr = shift_m(arr, 1, periodic_y, spmd[1])
        planes[plane] = arr if planes[plane] is None else planes[plane] + arr
    return HOField(**planes)


def ho_velocity_to_quad(mesh: RectMesh, basis, u: HOField, v: HOField, spmd=(None, None)) -> QuadVelocity:
    """Sample a CG2 velocity at the transport's quadrature points (exact):
    the 9-node interpolation at the volume points, the quadratic trace
    through a face's 3 nodes on the faces (single-valued across elements).
    On a periodic axis the nodes beyond the last are the first; on a rank
    grid (``spmd``) the neighbour rank's."""
    px, py = mesh.periodic_x, mesh.periodic_y
    ax, ay = spmd
    u_loc, v_loc = gather_local(u, px, py, spmd), gather_local(v, px, py, spmd)
    n_vol = cg2_sampling_table(basis.degree)
    vx_vol = apply_table(n_vol, u_loc)
    vy_vol = apply_table(n_vol, v_loc)
    # The quadratic trace weights of each face point, as Python floats.
    weights = [[float(_lagrange_1d(i, s)) for i in range(3)] for s in basis.s_edge]
    # Left face (x = 0): nodes v(i, j), l(i, j), v(i, j+1), quadratic in s.
    u_v_up = shift_p(u.v, 1, py, ay)
    vn_x = torch.stack([w0 * u.v + w1 * u.l + w2 * u_v_up for w0, w1, w2 in weights])
    # Bottom face (y = 0): nodes v(i, j), b(i, j), v(i+1, j).
    v_v_right = shift_p(v.v, 0, px, ax)
    vn_y = torch.stack([w0 * v.v + w1 * v.b + w2 * v_v_right for w0, w1, w2 in weights])
    return QuadVelocity(vx_vol=vx_vol, vy_vol=vy_vol, vn_x=vn_x, vn_y=vn_y)


class MEVPSolverHO:
    """The higher-order mEVP solver on a uniform, graded or spherical
    ``RectMesh``, each axis closed or periodic, with or without
    ``a_weighted_stress``.

    ``backend`` picks the kernel on a CUDA card (CPU tensors always run the
    plain version): ``"pallas"`` ho_single (all N subcycles in one
    cooperative launch, the JAX K5's counterpart), ``"pallas-tiled"``
    ho_tiled (ghost-zone tiles, H subcycles per launch, K6's), ``"auto"``
    ho_single below ``HO_SINGLE_MAX_ELEMENTS`` and ho_tiled from there.

    ``spmd``: on a rank grid, this rank's (x, y) ``AxisExchange`` pair and
    its block as ``mesh``; ``backend`` is then the exchange schedule (one
    of ``mevp.SPMD_BACKENDS``: "auto" is "blocked") and ``block_halo`` its
    ghost width (``mevp.block_halo_of``, the CG1 solver's rule: "auto" is
    ``mevp.BLOCK_HALO``).
    """

    def __init__(
        self, mesh: RectMesh, params: MEVPParams = MEVPParams(), backend: str = "auto",
        spmd=(None, None), block_halo="auto",
    ) -> None:
        if params.adaptive_alpha:
            # As in the JAX package: no element-level alpha is designed for
            # the dG1 stress at Gauss points.
            raise NotImplementedError("adaptive_alpha is implemented for the CG1 solver only")
        self.spmd = tuple(spmd)
        on_grid = any(axis is not None for axis in self.spmd)
        backends = SPMD_BACKENDS if on_grid else MEVP_BACKENDS
        if backend not in backends:
            raise ValueError(f"backend must be one of {backends}, got {backend!r}")
        self.mesh = mesh
        self.params = params
        self.backend = backend
        self.block_halo = block_halo_of(block_halo, mesh, on_grid)
        self.tables = cg2_tables()
        t = self.tables
        # Gauss-point projection table with the weights and the inverse dG1
        # mass folded in, as the JAX package folds it.
        self.proj = (t.phi_dg1 * t.w_vol[None, :]) * (1.0 / np.array([1.0, 1 / 12, 1 / 12]))[:, None]
        self._metric = {}

    @property
    def on_rank_grid(self) -> bool:
        return any(axis is not None for axis in self.spmd)

    def schedule(self, sms: int = None) -> str:
        """``"single"`` (ho_single) or ``"tiled"`` (ho_tiled): the kernel
        this solver runs on a CUDA card of ``sms`` streaming multiprocessors
        (None: not known). "auto" takes ho_single below
        ``HO_SINGLE_MAX_ELEMENTS`` where its tiles all fit on the card
        (``ho_single_cuda.holds``), else ho_tiled. On a rank grid the
        exchange schedule, "blocked", "rdma" or "xla"."""
        if self.on_rank_grid:
            return "blocked" if self.backend == "auto" else self.backend
        backend = self.backend
        if backend == "auto":
            single = self.mesh.n_elements < HO_SINGLE_MAX_ELEMENTS
            if single and sms is not None:
                from .kernels.ho_single_cuda import holds

                # The state decides (a form's consts are read from global
                # memory where they do not fit beside it).
                single = holds(self.mesh.nx, self.mesh.ny, sms, (self.mesh.periodic_x, self.mesh.periodic_y))
            backend = "pallas" if single else "pallas-tiled"
        return "single" if backend == "pallas" else "tiled"

    #: This solver on the same block without an exchange, the inner solver
    #: of the rdma round (the CG1 solver's rule).
    local = MEVPSolver.local

    # -- plane <-> local-node machinery, on the mesh's axes and exchange ----
    def gather_local(self, field: HOField):
        return gather_local(field, self.mesh.periodic_x, self.mesh.periodic_y, self.spmd)

    def scatter_local(self, contribs) -> HOField:
        return scatter_local(contribs, self.mesh.periodic_x, self.mesh.periodic_y, self.spmd)

    def const_names(self) -> tuple:
        """The const planes of ``step_consts``, in the kernels' order:
        ``HO_CONSTS``, with ``a_weighted_stress`` the four a_{k}
        (``HO_WEIGHTED_CONSTS``), on a graded or spherical mesh the four
        ``HO_METRIC_CONSTS`` last."""
        names = HO_WEIGHTED_CONSTS if self.params.a_weighted_stress else HO_CONSTS
        return names if self.mesh.uniform else names + HO_METRIC_CONSTS

    def metric_planes(self, *, device, dtype):
        """None when uniform; else dict(dx, dy, inv_dx, inv_dy, area) of
        (nx, ny) planes on ``device``, made once per (device, dtype)."""
        if self.mesh.uniform:
            return None
        key = (torch.device(device), dtype)
        if key not in self._metric:
            m = device_metric_planes(self.mesh, device=device, dtype=dtype)
            self._metric[key] = {
                "dx": m["dx"], "dy": m["dy"], "inv_dx": 1.0 / m["dx"], "inv_dy": 1.0 / m["dy"],
                "area": m["area"],
            }
        return self._metric[key]

    # -- strain: CG2 velocity -> dG1 coefficients ----------------------------
    def strain_rates(self, u: HOField, v: HOField, metric=None):
        """(e11, e22, e12) as (3, nx, ny) dG1 coefficients; ``metric``: the
        (inv_dx, inv_dy) planes of a graded or spherical mesh, broadcast
        over the dof axis (each element's own widths; by default its
        ``metric_planes``)."""
        t = self.tables
        u_loc, v_loc = self.gather_local(u), self.gather_local(v)
        if metric is None and not self.mesh.uniform:
            m = self.metric_planes(device=u.v.device, dtype=u.v.dtype)
            metric = (m["inv_dx"][None], m["inv_dy"][None])
        if metric is not None:
            inv_dx, inv_dy = metric
            du_dx = apply_table(t.grad_x_to_dg1.T, u_loc) * inv_dx
            du_dy = apply_table(t.grad_y_to_dg1.T, u_loc) * inv_dy
            dv_dx = apply_table(t.grad_x_to_dg1.T, v_loc) * inv_dx
            dv_dy = apply_table(t.grad_y_to_dg1.T, v_loc) * inv_dy
            return du_dx, dv_dy, 0.5 * (du_dy + dv_dx)
        dx, dy = self.mesh.dx, self.mesh.dy
        du_dx = apply_table(t.grad_x_to_dg1.T, u_loc) / dx
        du_dy = apply_table(t.grad_y_to_dg1.T, u_loc) / dy
        dv_dx = apply_table(t.grad_x_to_dg1.T, v_loc) / dx
        dv_dy = apply_table(t.grad_y_to_dg1.T, v_loc) / dy
        return du_dx, dv_dy, 0.5 * (du_dy + dv_dx)

    # -- weak-form stress divergence -> CG2 nodal forces ---------------------
    def stress_divergence(self, s11, s22, s12, metric=None):
        """The raw nodal force integrals (Fu, Fv) as HOFields (stress x
        length; the 1/W normalisation is the velocity update's). ``metric``:
        the (dx, dy) planes of a graded or spherical mesh (by default its
        ``metric_planes``); each element's contribution is weighted by its
        own widths before the scatter."""
        t = self.tables
        if metric is None and not self.mesh.uniform:
            m = self.metric_planes(device=s11.device, dtype=s11.dtype)
            metric = (m["dx"], m["dy"])
        dx, dy = (self.mesh.dx, self.mesh.dy) if metric is None else metric
        fu_loc = -(apply_table(t.div_x, s11) * dy + apply_table(t.div_y, s12) * dx)
        fv_loc = -(apply_table(t.div_x, s12) * dy + apply_table(t.div_y, s22) * dx)
        return self.scatter_local(fu_loc), self.scatter_local(fv_loc)

    def node_weights(self, *, device, dtype, area=None) -> HOField:
        """W_n = int phi_n dA accumulated per owned node; ``area``: the
        element areas (default: the uniform mesh's cell area everywhere,
        a graded or spherical mesh's area plane)."""
        if area is None and not self.mesh.uniform:
            area = self.metric_planes(device=device, dtype=dtype)["area"]
        if area is None:
            area = torch.full((self.mesh.nx, self.mesh.ny), self.mesh.cell_area, device=device, dtype=dtype)
        lumped = self.tables.lumped_mass
        return self.scatter_local(torch.stack([float(lumped[n]) * area for n in range(9)]))

    def node_thickness(self, h, area=None) -> HOField:
        """Lumped-mass-weighted thickness at the nodes: sum(h W) / sum(W);
        ``area`` as for ``node_weights``."""
        lumped = self.tables.lumped_mass
        if area is None and not self.mesh.uniform:
            area = self.metric_planes(device=h.device, dtype=h.dtype)["area"]
        scale = self.mesh.cell_area if area is None else area
        num = self.scatter_local(torch.stack([float(lumped[n]) * scale * h for n in range(9)]))
        den = self.node_weights(device=h.device, dtype=h.dtype, area=area)
        return HOField(v=num.v / den.v, b=num.b / den.b, l=num.l / den.l, c=num.c / den.c)

    def boundary_mask(self, *, device, dtype) -> HOField:
        """Per-plane no-slip masks (1 interior, 0 wall): on a closed x axis
        the vertex and left mid nodes of row i = 0, on a closed y axis the
        vertex and bottom mid nodes of column j = 0 sit on the walls; a
        periodic axis has none. On a rank grid only the block that owns the
        global first row (column) pins it, as in ``MEVPSolver``."""
        ax_x, ax_y = self.spmd
        masks = {}
        for name in PLANES:
            mask = torch.ones((self.mesh.nx, self.mesh.ny), device=device, dtype=dtype)
            if not self.mesh.periodic_x and name in ("v", "l") and is_global_edge("first", ax_x):
                mask[0, :] = 0.0
            if not self.mesh.periodic_y and name in ("v", "b") and is_global_edge("first", ax_y):
                mask[:, 0] = 0.0
            masks[name] = mask
        return HOField(**masks)

    # -- the mEVP iteration --------------------------------------------------
    def step_consts(self, state: HOVelocityState, h, a, forcing: HODynamicsForcing, mask: HOField, dt: float):
        """The 29 per-step constant planes: element ice strength, and per CG2
        plane k dt/m, the active (mask * has-ice) factor, the constant
        velocity numerators b = u_n + (dt/m) tau_a, the reciprocal lumped
        weights and the ocean currents. With ``a_weighted_stress`` also
        a_{k}, the lumped nodal concentration clipped to [0, 1] (33
        planes): it weights the wind here and the ocean drag in
        ``velocity_update``, and nodes below ``a_dyn_min`` are held at
        rest through the active factor. On a graded or spherical mesh also
        the element widths dx, dy and their reciprocals (``const_names``),
        and the lumped masses take the element areas."""
        p = self.params
        consts = {"strength": p.p_star * h * torch.exp(-p.c_compaction * (1.0 - a))}
        metric = self.metric_planes(device=h.device, dtype=h.dtype)
        area = None
        if metric is not None:
            consts.update({name: metric[name] for name in HO_METRIC_CONSTS})
            area = metric["area"]
        h_node = self.node_thickness(h, area)
        weights = self.node_weights(device=h.device, dtype=h.dtype, area=area)
        a_node = self.node_thickness(a, area) if p.a_weighted_stress else None
        for k in PLANES:
            m = p.rho_ice * getattr(h_node, k)
            dm = _div(dt, torch.clamp(m, min=p.min_ice_mass))
            ua, va = getattr(forcing.u_atm, k), getattr(forcing.v_atm, k)
            wind = p.rho_atm * p.cd_atm * torch.sqrt(ua * ua + va * va)
            active = getattr(mask, k) * (m > p.min_ice_mass).to(h.dtype)
            dm_wind = dm
            if a_node is not None:
                ak = torch.clamp(getattr(a_node, k), 0.0, 1.0)
                active = active * (ak >= p.a_dyn_min).to(h.dtype)
                dm_wind = dm * ak
                consts[f"a_{k}"] = ak
            consts[f"dt_m_{k}"] = dm
            consts[f"active_{k}"] = active
            consts[f"b_u_{k}"] = getattr(state.u, k) + dm_wind * wind * ua
            consts[f"b_v_{k}"] = getattr(state.v, k) + dm_wind * wind * va
            consts[f"inv_w_{k}"] = 1.0 / getattr(weights, k)
            consts[f"u_ocean_{k}"] = getattr(forcing.u_ocean, k)
            consts[f"v_ocean_{k}"] = getattr(forcing.v_ocean, k)
        return consts

    def stress_update(self, carry, consts):
        """First half of a subcycle, per element: strain, the VP law at the
        Gauss points, projection to dG1 and alpha relaxation. Returns the
        new (s11, s22, s12)."""
        p = self.params
        t = self.tables
        e2 = p.ellipse * p.ellipse
        u, v, s11, s22, s12 = carry
        strength = consts["strength"]
        metric = (consts["inv_dx"][None], consts["inv_dy"][None]) if "inv_dx" in consts else None
        e11, e22, e12 = self.strain_rates(u, v, metric)

        phi_at_q = t.phi_dg1  # (3, NQ)
        e11_q = apply_table(phi_at_q, e11)
        e22_q = apply_table(phi_at_q, e22)
        e12_q = apply_table(phi_at_q, e12)
        delta_q = torch.sqrt(
            (e11_q * e11_q + e22_q * e22_q) * (1.0 + 1.0 / e2)
            + 2.0 * e11_q * e22_q * (1.0 - 1.0 / e2)
            + 4.0 / e2 * e12_q * e12_q
        )
        inv_denom = 1.0 / (delta_q + p.delta_min)
        zeta_q = 0.5 * strength[None] * inv_denom
        eta_q = zeta_q * (1.0 / e2)
        p_rep_q = strength[None] * delta_q * inv_denom
        div_q = e11_q + e22_q
        s11_vp_q = 2.0 * eta_q * e11_q + (zeta_q - eta_q) * div_q - 0.5 * p_rep_q
        s22_vp_q = 2.0 * eta_q * e22_q + (zeta_q - eta_q) * div_q - 0.5 * p_rep_q
        s12_vp_q = 2.0 * eta_q * e12_q

        s11_vp = apply_table(self.proj.T, s11_vp_q)
        s22_vp = apply_table(self.proj.T, s22_vp_q)
        s12_vp = apply_table(self.proj.T, s12_vp_q)

        inv_alpha = 1.0 / p.alpha
        s11 = s11 + (s11_vp - s11) * inv_alpha
        s22 = s22 + (s22_vp - s22) * inv_alpha
        s12 = s12 + (s12_vp - s12) * inv_alpha
        return s11, s22, s12

    def velocity_update(self, carry, consts, dt: float):
        """Second half of a subcycle, per node plane: the divergence of the
        new stresses, then the beta-relaxed update with semi-implicit ocean
        drag (one c_w and one shared reciprocal per plane; with the a_{k}
        consts the drag weighted by the nodal concentration). Returns the
        new (u, v) HOFields."""
        p = self.params
        u, v, s11, s22, s12 = carry
        metric = (consts["dx"], consts["dy"]) if "dx" in consts else None
        fu_raw, fv_raw = self.stress_divergence(s11, s22, s12, metric)
        new_u, new_v = {}, {}
        for k in PLANES:
            uk, vk = getattr(u, k), getattr(v, k)
            uo, vo = consts[f"u_ocean_{k}"], consts[f"v_ocean_{k}"]
            rel_u = uo - uk
            rel_v = vo - vk
            c_w = p.rho_ocean * p.cd_ocean * torch.sqrt(rel_u * rel_u + rel_v * rel_v)
            if f"a_{k}" in consts:  # A-weighted ocean stress: tau_w = A c_w (v_w - v)
                c_w = c_w * consts[f"a_{k}"]
            cor_u = p.f_coriolis * (vk - vo) if p.use_coriolis else 0.0
            cor_v = -p.f_coriolis * (uk - uo) if p.use_coriolis else 0.0
            dm = consts[f"dt_m_{k}"]
            inv_w = consts[f"inv_w_{k}"]
            inv_drag = consts[f"active_{k}"] / (1.0 + p.beta + dm * c_w)
            new_u[k] = (
                p.beta * uk + consts[f"b_u_{k}"]
                + dm * (getattr(fu_raw, k) * inv_w + c_w * uo) + dt * cor_u
            ) * inv_drag
            new_v[k] = (
                p.beta * vk + consts[f"b_v_{k}"]
                + dm * (getattr(fv_raw, k) * inv_w + c_w * vo) + dt * cor_v
            ) * inv_drag
        return HOField(**new_u), HOField(**new_v)

    def subcycle_body(self, carry, consts, dt: float):
        """One HO mEVP subcycle; ``carry`` is (u, v, s11, s22, s12)."""
        s11, s22, s12 = self.stress_update(carry, consts)
        u, v = self.velocity_update((carry[0], carry[1], s11, s22, s12), consts, dt)
        return (u, v, s11, s22, s12)

    def subcycles(self, carry, consts, dt: float, n_subcycles: int):
        """The carry after N subcycles: the kernel of ``schedule()`` for the
        card the carry lies on, the plain version on the CPU."""
        from .kernels.coupled_cuda import sm_count
        from .kernels.ho_single_cuda import ho_subcycles_single
        from .kernels.ho_tiled_cuda import ho_subcycles_tiled

        device = carry[0].v.device
        sms = sm_count(device) if device.type == "cuda" else None
        run = ho_subcycles_single if self.schedule(sms) == "single" else ho_subcycles_tiled
        return run(self, carry, consts, dt, n_subcycles)

    def step(
        self, state: HOVelocityState, h, a, forcing: HODynamicsForcing, mask: HOField,
        dt: float, n_subcycles: int = 100,
    ) -> HOVelocityState:
        consts = self.step_consts(state, h, a, forcing, mask, dt)
        carry = (state.u, state.v, state.s11, state.s22, state.s12)
        run = self.spmd_subcycles if self.on_rank_grid else self.subcycles
        return HOVelocityState(*run(carry, consts, dt, n_subcycles))

    # -- the exchange schedules of a rank grid --------------------------------
    def spmd_subcycles(self, carry, consts, dt: float, n_subcycles: int):
        """The HO carry after N subcycles on this rank's block, on the
        solver's exchange schedule (``schedule``): the kernels on a card and
        their plain versions on the CPU. "xla" exchanges width-1 strips
        before each half of every subcycle and runs the two HO half kernels
        (``kernels.coupled_cuda.spmd_xla_ho_subcycles``)."""
        from .kernels.coupled_cuda import spmd_xla_ho_subcycles

        schedule = self.schedule()
        if schedule == "blocked":
            return self._blocked_subcycles(carry, consts, dt, n_subcycles)
        if schedule == "rdma":
            return self._rdma_subcycles(carry, consts, dt, n_subcycles)
        return spmd_xla_ho_subcycles(self, tuple(carry), consts, dt, n_subcycles)

    def _blocked_subcycles(self, carry, consts, dt: float, n_subcycles: int):
        """Ghost-zone ("temporally blocked") exchange, the HO counterpart of
        ``MEVPSolver._blocked_subcycles``: widen the consts by h ghost cells
        once per step and the 17 state planes once per round (one strip
        pair per axis each), run min(h, remaining) subcycles on the widened
        block with closed shifts, keep the interior. Each subcycle's gather
        (+1 shifts) and scatter (-1 shifts) spoil one ghost ring, so the
        interior equals the per-subcycle exchange exactly; beyond a global
        wall the strips are zeros (no strength, no mass, no mask), and on a
        ring they wrap round the ranks.

        The widened block runs the single-device rule (``schedule(sms)`` of
        a solver on ``block_mesh`` of the widened shape: ho_single where
        the card holds it below ``HO_SINGLE_MAX_ELEMENTS``, else ho_tiled)
        on a card, the plain subcycle on the CPU. On a view its mesh is a
        ``MetricShim``: the four width planes widen with the other consts
        (zeros beyond a closed wall are inert: the HO bodies only multiply
        by them)."""
        from .kernels.coupled_cuda import ho_flatten, ho_unflatten

        h = self.block_halo
        nx, ny = self.mesh.nx, self.mesh.ny
        ax_x, ax_y = self.spmd

        def widen(f):  # stacked planes: one strip pair per axis for all
            f = halo_widen(f, h, 1, self.mesh.periodic_x, ax_x)
            return halo_widen(f, h, 2, self.mesh.periodic_y, ax_y)

        local = MEVPSolverHO(block_mesh(nx + 2 * h, ny + 2 * h, self.mesh), self.params)
        consts_w = dict(zip(consts, widen(torch.stack(list(consts.values())))))
        state = ho_flatten(carry)
        remaining = n_subcycles
        while remaining > 0:
            n_sub = min(h, remaining)
            remaining -= n_sub
            padded = local.subcycles(ho_unflatten(widen(state)), consts_w, dt, n_sub)
            state = ho_flatten(padded)[:, h: h + nx, h: h + ny]
        return ho_unflatten(state.contiguous())

    def _rdma_subcycles(self, carry, consts, dt: float, n_subcycles: int):
        """Ghost-zone rounds whose 17 state strips travel while the
        interior computes (``kernels.mevp_rdma_cuda.mevp_round_rdma`` on
        the HO solver, K7's 17-plane round), the twin of
        ``MEVPSolver._rdma_subcycles``: the 29-37 consts are widened once a
        step along the split axes (``rdma_round_inputs``), the state is
        flattened once a step (``coupled_cuda.ho_flatten``) and each round
        runs rdma_stage, the interior pass (the single-device rule on the
        rank's own block), and rdma_band's HO form on the x bands and then
        the y bands. An axis with one rank is not split: its walls are the
        block's own zero edges, or on a periodic axis the round wraps along
        it (the interior pass's periodic form, the other axis's bands wrap
        along the band). Each subcycle's gather (+1 shifts) and scatter (-1
        shifts) spoil one ring, as CG1's do, so the patched block equals
        the blocked schedule's and the single domain's exactly."""
        from .kernels.coupled_cuda import ho_flatten, ho_unflatten
        from .kernels.mevp_rdma_cuda import mevp_round_rdma

        h = self.block_halo
        axes, consts_w = self.rdma_round_inputs(consts)
        local = self.local()
        state = ho_flatten(carry)
        remaining = n_subcycles
        while remaining > 0:
            n_sub = min(h, remaining)
            remaining -= n_sub
            state = mevp_round_rdma(local, state, consts, consts_w, dt, n_sub, h, axes)
        return ho_unflatten(state)

    #: (axes, consts_w) of the rdma rounds of a step: the CG1 solver's rule
    #: (the split axes' exchanges, the consts widened by h along them).
    rdma_round_inputs = MEVPSolver.rdma_round_inputs


def ho_subcycles_reference(solver: MEVPSolverHO, carry, consts, dt: float, n_subcycles: int):
    """N x ``solver.subcycle_body``: the plain version of the HO kernels."""
    carry = tuple(carry)
    for _ in range(n_subcycles):
        carry = solver.subcycle_body(carry, consts, dt)
    return carry
