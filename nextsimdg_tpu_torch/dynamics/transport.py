"""Discontinuous-Galerkin tracer transport (dG0, dG1, dG2).

Counterpart of ``nextsimdg_tpu.dynamics.transport``. Solves
d(psi)/dt + div(v psi) = 0 per tracer with upwind edge fluxes and SSP-RK
time stepping (rk1, rk2, rk3; by default the one matched to the degree);
the semi-discrete RHS is

    dpsi_k/dt = M_k^-1 [ V_k  -  E_k ]
    V_k = sum_q w_q [ (vx_q/dx) dphi_k/dxi + (vy_q/dy) dphi_k/deta ] psi(x_q)
    E_k = (1/dx) (phi_k|_{x=1} . G_{i+1/2} - phi_k|_{x=0} . G_{i-1/2}) + (y)

with ``G`` the upwinded normal-flux integrals on shared faces. Tracer
coefficients are (K, ..., nx, ny) tensors; extra middle dims batch several
tracers through one pass. Every contraction over the tiny dof and
quadrature dims is an unrolled sum of scalar-weighted planes in ascending
order with zero entries skipped, as in the JAX package, so that float64
results agree to rounding. The CUDA transport kernels in
``dynamics.kernels.coupled_cuda`` take their table entries from this
module's ``DGTransport``, at every degree.

On a graded or spherical mesh the widths become per-element planes: the
volume term multiplies by ``inv_dx``/``inv_dy``, each owned face flux is
weighted by its face length before the neighbour shift (``face_x``,
``face_y``, so both sides of a face exchange the same amount) and the
edge terms divide by the element area (``inv_area``).

A limited step applies the positivity limiter after every stage, and with
``tvb_m`` the TVB minmod slope limiter before it (``limit_slopes``). A
periodic axis wraps every neighbour shift and has no wall face.

On a rank grid (``nextsimdg_tpu_torch.parallel``) the operator holds one
rank's block (a uniform ``RectMesh`` or a ``LocalMeshView``, whose metric
planes are slices of the global ones) and its ``spmd`` exchange axes,
rings on the periodic axes: the neighbour shifts exchange width-1 halos,
only the block that owns the global first row (column) closes its wall
face, and the TVB limiter reads its neighbours' means through the exchange
and takes its zero-gradient walls only at the global walls. The coupled
step advects with ``transport_tiled`` on a widened block instead
(``kernels.transport_tiled_cuda.transport_substeps_tiled_spmd``), or on
the staged route (``kernels.coupled_cuda.spmd_staged_transport``: the halo
forms of the stage and the limiter, psi widened by one ring a stage).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .dgbasis import DGBasis, dg_basis
from .mesh import RectMesh, device_metric_planes
from .stencil import is_global_edge, shift_m, shift_p


def apply_table(table, arr):
    """Contract a tiny static (K, Q) table with (K, ...) -> (Q, ...).

    Unrolled into scalar-weighted adds in ascending k, zero entries
    skipped and unit entries unmultiplied: never a small matmul.
    """
    table = np.asarray(table)
    n_in, n_out = table.shape
    outs = []
    for q in range(n_out):
        acc = None
        for k in range(n_in):
            c = float(table[k, q])
            if c == 0.0:
                continue
            term = arr[k] if c == 1.0 else c * arr[k]
            acc = term if acc is None else acc + term
        outs.append(acc if acc is not None else torch.zeros_like(arr[0]))
    return torch.stack(outs)


def face_masks_from_land(
    ocean_mask, periodic_x: bool = False, periodic_y: bool = False, spmd=(None, None),
):
    """Impermeable-face masks from an element ocean mask (1 = ocean, 0 = land).

    A face carries flux only if both adjacent elements are ocean. Returns
    (face_x, face_y), each (nx, ny) in the owned-edge layout, multiplying
    the upwind fluxes. ``spmd``: the rank's (x, y) exchange axes on a rank
    grid (``ocean_mask`` is then the rank's block).
    """
    left = shift_m(ocean_mask, 0, periodic_x, spmd[0])
    below = shift_m(ocean_mask, 1, periodic_y, spmd[1])
    return ocean_mask * left, ocean_mask * below


@dataclass(frozen=True)
class QuadVelocity:
    """Velocity sampled at DG quadrature points, owned-edge layout.

    vx_vol/vy_vol: (NQ, nx, ny) at volume points; vn_x: (NE, nx, ny) normal
    (+x) velocity at the LEFT face of element i; vn_y: (NE, nx, ny) normal
    (+y) velocity at the BOTTOM face. The right and top domain faces are
    implicit walls.
    """

    vx_vol: torch.Tensor
    vy_vol: torch.Tensor
    vn_x: torch.Tensor
    vn_y: torch.Tensor


def sample_velocity(mesh: RectMesh, basis: DGBasis, fn: Callable, *, device, dtype) -> QuadVelocity:
    """An analytic velocity ``fn(x, y) -> (vx, vy)`` (numpy, float64)
    sampled at the quadrature points, then cast to ``dtype`` on ``device``."""
    xv, yv = mesh.volume_quad_coords(basis.xq_vol, basis.yq_vol)
    vx_vol, vy_vol = fn(xv, yv)
    vnx, _ = fn(*mesh.edge_x_coords(basis.s_edge))
    _, vny = fn(*mesh.edge_y_coords(basis.s_edge))
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)
    return QuadVelocity(
        vx_vol=as_t(vx_vol),
        vy_vol=as_t(vy_vol),
        # The owned left (bottom) faces; the domain's last face is a wall.
        vn_x=as_t(np.moveaxis(vnx[: mesh.nx], 2, 0)),
        vn_y=as_t(np.moveaxis(vny[:, : mesh.ny], 2, 0)),
    )


def sampling_weights(basis: DGBasis):
    """Python-float weights of the CG1 -> quadrature sampling.

    Per volume point, the bilinear weights of the element's nodes (i, j),
    (i+1, j), (i, j+1), (i+1, j+1); per edge point, (1 - s, s) along a face.
    """
    xq = [float(x) for x in basis.xq_vol]
    yq = [float(y) for y in basis.yq_vol]
    vol = [
        ((1 - x) * (1 - y), x * (1 - y), (1 - x) * y, x * y)
        for x, y in zip(xq, yq)
    ]
    edge = [(1 - float(s), float(s)) for s in basis.s_edge]
    return vol, edge


def velocity_from_cg(mesh: RectMesh, basis: DGBasis, u, v, spmd=(None, None)) -> QuadVelocity:
    """Sample a CG1 nodal velocity (owned-node layout) at the quadrature
    points: bilinear within each element, single-valued on shared faces.
    ``spmd``: the rank's (x, y) exchange axes on a rank grid (the +1 nodes
    beyond the block are the neighbour ranks')."""
    px, py = mesh.periodic_x, mesh.periodic_y
    ax_x, ax_y = spmd
    w_vol, w_edge = sampling_weights(basis)

    def bilinear(f):
        f00 = f
        f10 = shift_p(f, 0, px, ax_x)
        f01 = shift_p(f, 1, py, ax_y)
        f11 = shift_p(f10, 1, py, ax_y)
        return torch.stack([
            f00 * w[0] + f10 * w[1] + f01 * w[2] + f11 * w[3] for w in w_vol
        ])

    vx_vol = bilinear(u)
    vy_vol = bilinear(v)
    # Left face of element i: linear in y between nodes (i, j) and (i, j+1).
    u_up = shift_p(u, 1, py, ax_y)
    v_right = shift_p(v, 0, px, ax_x)
    vn_x = torch.stack([u * w[0] + u_up * w[1] for w in w_edge])
    vn_y = torch.stack([v * w[0] + v_right * w[1] for w in w_edge])
    return QuadVelocity(vx_vol=vx_vol, vy_vol=vy_vol, vn_x=vn_x, vn_y=vn_y)


def max_speeds(qv: QuadVelocity):
    """(max |vx|, max |vy|) over all quadrature points, as 0-d tensors."""
    speed_x = torch.maximum(qv.vx_vol.abs().max(), qv.vn_x.abs().max())
    speed_y = torch.maximum(qv.vy_vol.abs().max(), qv.vn_y.abs().max())
    return speed_x, speed_y


def substeps_from_speeds(
    speed_x, speed_y, dt: float, mesh: RectMesh, degree: int,
    k_floor: int = 1, k_max: int = 64,
):
    """The CFL substep count (0-d int32 tensor) from the two max speeds.

    ``cfl_substeps`` and the CUDA path both end here, so that the same max
    speeds give the same k. The speeds are held against the smallest
    element widths: on a spherical mesh the poleward rows are the
    thinnest. On a rank grid those of the global mesh, so that every rank
    agrees on k, and with the single domain.
    """
    # Cockburn & Shu's RKDG bound 1/(2p+1), with a 15% safety margin.
    c_stab = 0.85 / (2 * degree + 1)
    geo = mesh.global_mesh if mesh.is_local_view else mesh
    dx_min = float(np.min(np.asarray(geo.dx)))
    dy_min = float(np.min(np.asarray(geo.dy)))
    nu = (speed_x / dx_min + speed_y / dy_min) * dt
    k = torch.ceil(nu / c_stab).to(torch.int32)
    return torch.clamp(torch.clamp(k, min=k_floor), 1, k_max)


def cfl_substeps(
    qv: QuadVelocity, dt: float, mesh: RectMesh, degree: int,
    k_floor: int = 1, k_max: int = 64,
):
    """Transport substep count k = ceil(nu / C), clipped to [k_floor, k_max],
    with nu = (max|vx|/min dx + max|vy|/min dy) dt the advective CFL
    number."""
    speed_x, speed_y = max_speeds(qv)
    return substeps_from_speeds(speed_x, speed_y, dt, mesh, degree, k_floor, k_max)


#: The SSP-RK scheme matched to each DG degree.
DEFAULT_SCHEME = {0: "rk1", 1: "rk2", 2: "rk3"}


class DGTransport:
    """The transport operator for one mesh (uniform, graded or spherical;
    closed or periodic axes) and DG degree (0, 1 or 2). ``tvb_m``: the TVB
    constant M of the slope limiter (None: positivity only). ``spmd``: on a
    rank grid, the rank's (x, y) exchange axes, with its block as ``mesh``
    (a ``RectMesh`` or a ``LocalMeshView``)."""

    def __init__(
        self, mesh: RectMesh, degree: int = 1, scheme: str = None, spmd=(None, None),
        tvb_m: float = None,
    ) -> None:
        self.spmd = tuple(spmd)
        self.mesh = mesh
        self.tvb_m = None if tvb_m is None else float(tvb_m)
        self._metric = {}
        self._tvb_tol = {}
        self.basis = dg_basis(degree)
        self.scheme = scheme or DEFAULT_SCHEME[degree]
        if self.scheme not in ("rk1", "rk2", "rk3"):
            raise ValueError(f"unknown scheme {self.scheme}")
        b = self.basis
        self._psi_vol = b.psi_vol
        # Quadrature weights folded into the gradient tables.
        self._wgx_vol = b.w_vol[None, :] * b.dpsi_dx_vol
        self._wgy_vol = b.w_vol[None, :] * b.dpsi_dy_vol
        self._psi_x0 = b.psi_x0
        self._psi_x1 = b.psi_x1
        self._psi_y0 = b.psi_y0
        self._psi_y1 = b.psi_y1
        # Edge weights folded into the face-assembly tables.
        self._wa_x0 = b.psi_x0 * b.w_edge[None, :]
        self._wa_x1 = b.psi_x1 * b.w_edge[None, :]
        self._wa_y0 = b.psi_y0 * b.w_edge[None, :]
        self._wa_y1 = b.psi_y1 * b.w_edge[None, :]
        self._inv_mass = b.inv_mass_diag
        # The limiter's evaluation points: the volume points, then each
        # face's (left, right, bottom, top).
        self._limit_table = np.concatenate(
            [b.psi_vol, b.psi_x0, b.psi_x1, b.psi_y0, b.psi_y1], axis=1
        )

    def metric_planes(self, *, device, dtype):
        """None when uniform; else dict(inv_dx, inv_dy, face_x, face_y,
        inv_area) of (nx, ny) planes, built once per (device, dtype): the
        inverse element widths of the volume term, the owned-face lengths of
        the fluxes and the inverse areas of the edge terms."""
        if self.mesh.uniform:
            return None
        key = (torch.device(device), dtype)
        if key not in self._metric:
            m = device_metric_planes(self.mesh, device=device, dtype=dtype)
            self._metric[key] = {
                "inv_dx": 1.0 / m["dx"],
                "inv_dy": 1.0 / m["dy"],
                "face_x": m["face_x"],
                "face_y": m["face_y"],
                "inv_area": 1.0 / m["area"],
            }
        return self._metric[key]

    # -- semi-discrete RHS ---------------------------------------------------
    def rhs(self, psi, vel: QuadVelocity, face_masks=None, metric=None):
        """d(psi)/dt for coefficients psi (K, ..., nx, ny).

        ``face_masks``: optional (face_x, face_y) planes multiplying the
        upwind fluxes (coastlines). ``metric``: the per-element planes of
        ``metric_planes`` (taken from this operator when not given).
        """
        mesh = self.mesh
        if metric is None:
            metric = self.metric_planes(device=psi.device, dtype=psi.dtype)
        extra = psi.ndim - 3
        expand = (slice(None),) + (None,) * extra
        vx_vol = vel.vx_vol[expand]
        vy_vol = vel.vy_vol[expand]
        vn_x = vel.vn_x[expand]
        vn_y = vel.vn_y[expand]
        x_axis, y_axis = psi.ndim - 2, psi.ndim - 1

        # Volume term, streamed over the quadrature points.
        inv_dx = 1.0 / mesh.dx if metric is None else metric["inv_dx"]
        inv_dy = 1.0 / mesh.dy if metric is None else metric["inv_dy"]
        psi_tab = np.asarray(self._psi_vol)
        wgx_t = np.asarray(self._wgx_vol.T)  # (NQ, K)
        wgy_t = np.asarray(self._wgy_vol.T)
        n_dofs, n_q = psi_tab.shape
        acc_x = [None] * n_dofs
        acc_y = [None] * n_dofs
        for q in range(n_q):
            pq = None
            for k in range(n_dofs):
                c = float(psi_tab[k, q])
                if c == 0.0:
                    continue
                term = psi[k] if c == 1.0 else c * psi[k]
                pq = term if pq is None else pq + term
            fx = vx_vol[q] * pq
            fy = vy_vol[q] * pq
            for k in range(n_dofs):
                cx = float(wgx_t[q, k])
                if cx != 0.0:
                    t = fx if cx == 1.0 else cx * fx
                    acc_x[k] = t if acc_x[k] is None else acc_x[k] + t
                cy = float(wgy_t[q, k])
                if cy != 0.0:
                    t = fy if cy == 1.0 else cy * fy
                    acc_y[k] = t if acc_y[k] is None else acc_y[k] + t
        zero = psi.new_zeros(psi.shape[1:])
        gx = torch.stack([a if a is not None else zero for a in acc_x])
        gy = torch.stack([a if a is not None else zero for a in acc_y])
        volume = gx * inv_dx + gy * inv_dy

        # Upwind edge fluxes, x-direction (owned left-face edges).
        px, py = mesh.periodic_x, mesh.periodic_y
        ax_x, ax_y = self.spmd
        tr_x1 = apply_table(self._psi_x1, psi)  # right-face traces
        tr_x0 = apply_table(self._psi_x0, psi)  # left-face traces
        left_of_edge = shift_m(tr_x1, x_axis, px, ax_x)
        g_x = vn_x * torch.where(vn_x >= 0, left_of_edge, tr_x0)
        if not px and is_global_edge("first", ax_x):
            # Closed domain: the global i = 0 face is an impermeable wall
            # (g_x is a fresh tensor, so zeroing it in place is safe).
            g_x.narrow(x_axis, 0, 1).zero_()
        if face_masks is not None:
            g_x = g_x * face_masks[0]
        if metric is not None:
            # The owned face's length before the shift: both sides of a
            # shared face integrate the same length * flux (conservative).
            g_x = g_x * metric["face_x"]
        g_right = shift_p(g_x, x_axis, px, ax_x)
        edge_x = (
            apply_table(self._wa_x1.T, g_right) - apply_table(self._wa_x0.T, g_x)
        )
        edge_x = edge_x / mesh.dx if metric is None else edge_x * metric["inv_area"]

        # Upwind edge fluxes, y-direction (owned bottom-face edges).
        tr_y1 = apply_table(self._psi_y1, psi)  # top-face traces
        tr_y0 = apply_table(self._psi_y0, psi)  # bottom
        below = shift_m(tr_y1, y_axis, py, ax_y)
        g_y = vn_y * torch.where(vn_y >= 0, below, tr_y0)
        if not py and is_global_edge("first", ax_y):
            g_y.narrow(y_axis, 0, 1).zero_()
        if face_masks is not None:
            g_y = g_y * face_masks[1]
        if metric is not None:
            g_y = g_y * metric["face_y"]
        g_top = shift_p(g_y, y_axis, py, ax_y)
        edge_y = (
            apply_table(self._wa_y1.T, g_top) - apply_table(self._wa_y0.T, g_y)
        )
        edge_y = edge_y / mesh.dy if metric is None else edge_y * metric["inv_area"]

        rhs = volume - edge_x - edge_y
        inv_mass = self._inv_mass
        return torch.stack([float(inv_mass[k]) * rhs[k] for k in range(len(inv_mass))])

    # -- positivity limiting (Zhang & Shu) -----------------------------------
    def limit_positivity(self, psi):
        """Scale the higher moments so the polynomial stays >= 0.

        The deviation from the (conserved) mean is shrunk by
        theta = min(1, mean / (mean - min)) where the minimum is negative.
        dG0 has no higher moment (a no-op). dG1: a linear polynomial's
        minimum over the element is at a corner, mean - (|s1| + |s2|)/2.
        dG2: the minimum over the volume points and every face's points,
        streamed point by point (each value an ascending-k sum).
        """
        n_dofs = self.basis.n_dofs
        if n_dofs == 1:
            return psi
        mean = psi[0]
        if n_dofs == 3:
            mins = mean - 0.5 * (torch.abs(psi[1]) + torch.abs(psi[2]))
        else:
            mins = None
            for q in range(self._limit_table.shape[1]):
                value = None
                for k in range(n_dofs):
                    c = float(self._limit_table[k, q])
                    if c == 0.0:
                        continue
                    term = psi[k] if c == 1.0 else c * psi[k]
                    value = term if value is None else value + term
                mins = value if mins is None else torch.minimum(mins, value)
        deficit = mean - mins
        theta = torch.where(
            mins < 0.0,
            torch.clamp(mean / torch.where(deficit > 0, deficit, 1.0), 0.0, 1.0),
            1.0,
        )
        return torch.cat([mean[None], psi[1:] * theta[None]], dim=0)

    # -- TVB slope limiting (Cockburn & Shu) ----------------------------------
    @property
    def limits_slopes(self) -> bool:
        """Whether ``limit_slopes`` acts: ``tvb_m`` set and a degree with
        slopes (dG1, dG2)."""
        return self.tvb_m is not None and self.basis.n_dofs > 1

    def tvb_tolerances(self, *, device, dtype):
        """(tol_x, tol_y) = (M dx^2, M dy^2), evaluated left to right as
        ``tvb_m * dx * dx``: Python floats on a uniform mesh, else (nx, ny)
        planes of ``dtype`` on ``device`` (built once per (device, dtype, M);
        the per-element widths of a graded or spherical mesh cast to
        ``dtype`` first, as the JAX package does; on a ``LocalMeshView`` its
        slices of the global widths)."""
        mesh = self.mesh
        if mesh.uniform:
            return self.tvb_m * mesh.dx * mesh.dx, self.tvb_m * mesh.dy * mesh.dy
        key = (torch.device(device), dtype, self.tvb_m)
        if key not in self._tvb_tol:
            shape = (mesh.nx, mesh.ny)
            if mesh.is_local_view:
                widths = (mesh.block_of(mesh.global_mesh.dx), mesh.block_of(mesh.global_mesh.dy))
            else:
                widths = (mesh.dx, mesh.dy)

            def plane(width):
                if isinstance(width, float):
                    return torch.full(shape, self.tvb_m * width * width, device=device, dtype=dtype)
                w = torch.as_tensor(np.asarray(width), device=device).to(dtype)
                return (self.tvb_m * w * w).expand(shape).contiguous()

            self._tvb_tol[key] = tuple(plane(width) for width in widths)
        return self._tvb_tol[key]

    def limit_slopes(self, psi, wall_masks=None):
        """TVB minmod slope limiter on the linear moments (dG1, dG2).

        Each linear moment is compared with the forward and backward
        cell-mean differences, ``psi1' = minmod(psi1, mean_{i+1} - mean_i,
        mean_i - mean_{i-1})``, except where ``|psi1| <= M dx^2`` (the TVB
        tolerance, ``tvb_m`` = M; 0 is pure TVD). At dG2, where a linear
        moment was cut (by more than 1e-12), the element's quadratic moments
        are zeroed. Cell means are never touched. Closed walls take
        zero-gradient ghost means; periodic axes wrap. dG0 and
        ``tvb_m=None``: a no-op. ``wall_masks``: optional (fwd_x, bwd_x,
        fwd_y, bwd_y) planes, 1.0 where the forward or backward mean
        difference is zeroed, in place of the walls of the mesh (the spmd
        tiled transport passes them for a widened block, whose global walls
        sit inside it). On a rank grid the neighbours' means come through
        the exchange, and only the blocks at a global wall zero it.
        """
        if not self.limits_slopes:
            return psi
        mesh = self.mesh
        ax_x, ax_y = self.spmd
        mean = psi[0]
        x_axis, y_axis = mean.ndim - 2, mean.ndim - 1

        def deltas(axis, periodic, exchange, masks):
            d_fwd = shift_p(mean, axis, periodic, exchange) - mean
            d_bwd = mean - shift_m(mean, axis, periodic, exchange)
            if masks is not None:
                d_fwd = torch.where(masks[0] == 1.0, 0.0, d_fwd)
                d_bwd = torch.where(masks[1] == 1.0, 0.0, d_bwd)
            elif not periodic:
                # Zero-gradient ghosts at the global walls (the zero-filled
                # shifts would otherwise make a -mean jump there).
                n = mean.shape[axis]
                d_fwd = d_fwd.clone()
                d_bwd = d_bwd.clone()
                if is_global_edge("last", exchange):
                    d_fwd.narrow(axis, n - 1, 1).zero_()
                if is_global_edge("first", exchange):
                    d_bwd.narrow(axis, 0, 1).zero_()
            return d_fwd, d_bwd

        dpx, dmx = deltas(x_axis, mesh.periodic_x, ax_x, None if wall_masks is None else wall_masks[:2])
        dpy, dmy = deltas(y_axis, mesh.periodic_y, ax_y, None if wall_masks is None else wall_masks[2:])
        return self.limit_slopes_by(psi, (dpx, dmx, dpy, dmy))

    def limit_slopes_by(self, psi, deltas):
        """``limit_slopes`` with the mean differences given: ``deltas`` is
        (fwd_x, bwd_x, fwd_y, bwd_y), each mean's forward and backward
        difference along each axis, already zeroed at the walls (the halo
        form's plain version takes them from a block widened by one ring)."""
        if not self.limits_slopes:
            return psi
        dpx, dmx, dpy, dmy = deltas
        mean = psi[0]

        def minmod3(a, b, c):
            same = (torch.sign(a) == torch.sign(b)) & (torch.sign(a) == torch.sign(c))
            smallest = torch.minimum(torch.abs(a), torch.minimum(torch.abs(b), torch.abs(c)))
            return torch.where(same, torch.sign(a) * smallest, 0.0)

        tol_x, tol_y = self.tvb_tolerances(device=psi.device, dtype=psi.dtype)
        s1 = torch.where(torch.abs(psi[1]) <= tol_x, psi[1], minmod3(psi[1], dpx, dmx))
        s2 = torch.where(torch.abs(psi[2]) <= tol_y, psi[2], minmod3(psi[2], dpy, dmy))
        if self.basis.n_dofs == 3:
            return torch.stack([mean, s1, s2])
        eps = torch.tensor(1e-12, dtype=psi.dtype, device=psi.device)
        cut = (torch.abs(s1 - psi[1]) > eps) | (torch.abs(s2 - psi[2]) > eps)
        keep = torch.where(cut, 0.0, 1.0).to(psi.dtype)
        return torch.stack([mean, s1, s2, psi[3] * keep, psi[4] * keep, psi[5] * keep])

    def limit(self, psi):
        """The limiter of a limited stage: ``limit_positivity`` after
        ``limit_slopes`` (the latter a no-op without ``tvb_m``)."""
        return self.limit_positivity(self.limit_slopes(psi))

    # -- SSP-RK time stepping ------------------------------------------------
    def step(
        self, psi, vel: QuadVelocity, dt: float, limit: bool = False, face_masks=None,
        metric=None, wall_masks=None,
    ):
        """One SSP-RK step; ``limit`` applies the limiters after every RK
        stage (SSP keeps the limited property through the convex
        combinations): with ``tvb_m`` the TVB slope limiter, then the
        positivity limiter. ``metric``: the metric planes in place of this
        operator's (a widened block's); ``wall_masks``: the TVB wall-delta
        masks of ``limit_slopes``."""
        if limit and wall_masks is not None:
            lim = lambda p: self.limit_positivity(self.limit_slopes(p, wall_masks))
        else:
            lim = self.limit if limit else (lambda p: p)
        rhs = lambda p: self.rhs(p, vel, face_masks, metric)
        if self.scheme == "rk1":
            return lim(psi + dt * rhs(psi))
        if self.scheme == "rk2":
            psi1 = lim(psi + dt * rhs(psi))
            return lim(0.5 * psi + 0.5 * (psi1 + dt * rhs(psi1)))
        psi1 = lim(psi + dt * rhs(psi))
        psi2 = lim(0.75 * psi + 0.25 * (psi1 + dt * rhs(psi1)))
        return lim(psi / 3.0 + 2.0 / 3.0 * (psi2 + dt * rhs(psi2)))

    def run(self, psi, vel: QuadVelocity, dt: float, n_steps: int):
        """n_steps unlimited SSP-RK steps (``step`` with ``limit=False``).
        CPU tensors run ``step``; CUDA tensors the kernels, one
        ``dg1_rk_stage`` launch per RK stage and tracer
        (``kernels.coupled_cuda.transport_run``)."""
        from .kernels.coupled_cuda import transport_run

        return transport_run(self, psi, vel, dt, n_steps)

    # -- setup helpers -------------------------------------------------------
    def project(self, fn: Callable, *, device, dtype):
        """L2-project an analytic field ``fn(x, y)`` (numpy, float64) onto
        (K, nx, ny) DG coefficients. The projection lives in reference
        coordinates, so the element metric cancels."""
        b = self.basis
        x, y = self.mesh.volume_quad_coords(b.xq_vol, b.yq_vol)
        values = np.broadcast_to(fn(x, y), (len(b.w_vol), self.mesh.nx, self.mesh.ny))
        coeffs = np.einsum("q,kq,qxy->kxy", b.w_vol, b.psi_vol, values)
        coeffs = coeffs / b.mass_diag[:, None, None]
        return torch.as_tensor(coeffs, device=device).to(dtype)

    def total_mass(self, psi):
        """Integral of the tracer over the domain (cell means x areas)."""
        area = np.asarray(self.mesh.cell_area, dtype=np.float64)
        area = torch.as_tensor(area, device=psi.device).to(psi.dtype)
        return torch.sum(psi[0] * area)
