"""Structured meshes for the dynamical core: uniform, graded and spherical.

Counterpart of ``nextsimdg_tpu.dynamics.mesh``:

* uniform rectangles (one ``dx`` by one ``dy``);
* tensor-graded rectangles (``dx`` per column, ``dy`` per row);
* regular lon-lat windows on the sphere (:class:`SphericalMesh`), whose
  zonal widths shrink with cos(latitude).

The solvers read only the metric interface: ``dx``/``dy`` for in-element
gradients, ``face_len_x``/``face_len_y`` for shared-face flux lengths and
``cell_area``. On a non-uniform mesh they take these as full (nx, ny)
planes on the device (``device_metric_planes``). Each axis is closed
(no-flux / no-slip walls) or periodic (``periodic_x``, ``periodic_y``: the
last element's neighbour is the first, node nx is node 0); a lon-lat
window that spans 360 degrees of longitude is periodic in x.

On a rank grid a graded or spherical mesh is held by each rank as a
:class:`LocalMeshView` of its block: the global mesh, the grid's shape and
the rank's coordinates, whose metric planes are slices of the global ones.
"""

from __future__ import annotations

import numpy as np
import torch


def _as_spacing(value, count: int) -> np.ndarray:
    arr = np.asarray(value, dtype=np.float64).reshape(-1)
    if arr.size == 1:
        arr = np.full(count, float(arr[0]))
    if arr.size != count:
        raise ValueError(f"spacing has {arr.size} entries, expected {count}")
    return arr


class RectMesh:
    """nx x ny elements, ``dx`` per column and ``dy`` per row (scalars
    broadcast); ``periodic_x``/``periodic_y`` wrap an axis around, else its
    two sides are closed walls."""

    #: Whether this is one rank's ``LocalMeshView`` of a global mesh.
    is_local_view = False

    def __init__(
        self, nx: int, ny: int, dx, dy,
        x0: float = 0.0, y0: float = 0.0,
        periodic_x: bool = False, periodic_y: bool = False,
    ) -> None:
        self.nx = int(nx)
        self.ny = int(ny)
        if self.nx < 1 or self.ny < 1:
            raise ValueError(f"mesh needs at least one element, got {nx} x {ny}")
        self._dx = _as_spacing(dx, self.nx)
        self._dy = _as_spacing(dy, self.ny)
        self.uniform = bool(
            np.all(self._dx == self._dx[0]) and np.all(self._dy == self._dy[0])
        )
        self.x0 = float(x0)
        self.y0 = float(y0)
        self.periodic_x = bool(periodic_x)
        self.periodic_y = bool(periodic_y)

    # -- metric interface (scalars when uniform, broadcastable arrays else) --
    @property
    def dx(self):
        """Scalar width when uniform; (nx, 1) per-column widths otherwise."""
        return float(self._dx[0]) if self.uniform else self._dx[:, None]

    @property
    def dy(self):
        return float(self._dy[0]) if self.uniform else self._dy[None, :]

    @property
    def cell_area(self):
        """Element areas: scalar (uniform) or broadcastable to (nx, ny)."""
        if self.uniform:
            return float(self._dx[0] * self._dy[0])
        return self._dx[:, None] * self._dy[None, :]

    @property
    def face_len_x(self):
        """Length of the left (owned) face of element (i, j)."""
        return float(self._dy[0]) if self.uniform else self._dy[None, :]

    @property
    def face_len_y(self):
        """Length of the bottom (owned) face of element (i, j)."""
        return float(self._dx[0]) if self.uniform else self._dx[:, None]

    def metric_factors(self) -> dict:
        """(col (nx,), row (ny,)) float64 factor pairs of each metric plane:
        ``dx``/``dy`` (element widths), ``area``, ``face_x``/``face_y``
        (owned-face lengths); each plane is col[:, None] * row[None, :]."""
        ones_x = np.ones(self.nx)
        ones_y = np.ones(self.ny)
        return {
            "dx": (self._dx, ones_y),
            "dy": (ones_x, self._dy),
            "area": (self._dx, self._dy),
            "face_x": (ones_x, self._dy),
            "face_y": (self._dx, ones_y),
        }

    @property
    def _xn(self) -> np.ndarray:
        return self.x0 + np.concatenate([[0.0], np.cumsum(self._dx)])

    @property
    def _yn(self) -> np.ndarray:
        return self.y0 + np.concatenate([[0.0], np.cumsum(self._dy)])

    def node_coords(self):
        """(x, y) arrays of CG1 node coordinates, each (nx+1, ny+1)."""
        return np.meshgrid(self._xn, self._yn, indexing="ij")

    def edge_x_coords(self, s_edge):
        """Coordinates of the x-face (vertical edge) quadrature points:
        each (nx+1, ny, NE), ``s_edge`` the points along a face."""
        xn, yn = self._xn, self._yn
        ey = yn[:-1][:, None] + s_edge[None, :] * self._dy[:, None]
        x = np.broadcast_to(xn[:, None, None], (self.nx + 1, self.ny, len(s_edge)))
        y = np.broadcast_to(ey[None, :, :], (self.nx + 1, self.ny, len(s_edge)))
        return x, y

    def edge_y_coords(self, s_edge):
        """Coordinates of the y-face (horizontal edge) quadrature points:
        each (nx, ny+1, NE)."""
        xn, yn = self._xn, self._yn
        ex = xn[:-1][:, None] + s_edge[None, :] * self._dx[:, None]
        x = np.broadcast_to(ex[:, None, :], (self.nx, self.ny + 1, len(s_edge)))
        y = np.broadcast_to(yn[None, :, None], (self.nx, self.ny + 1, len(s_edge)))
        return x, y

    def volume_quad_coords(self, xq_vol, yq_vol):
        """Coordinates of the volume quadrature points (reference
        coordinates ``xq_vol``, ``yq_vol``): each (NQ, nx, ny)."""
        xn, yn = self._xn, self._yn
        x = xn[:-1][None, :, None] + xq_vol[:, None, None] * self._dx[None, :, None]
        y = yn[:-1][None, None, :] + yq_vol[:, None, None] * self._dy[None, None, :]
        x = np.broadcast_to(x, (len(xq_vol), self.nx, self.ny))
        y = np.broadcast_to(y, (len(yq_vol), self.nx, self.ny))
        return x, y

    @property
    def n_elements(self) -> int:
        return self.nx * self.ny


def device_metric_planes(mesh: RectMesh, *, device, dtype) -> dict:
    """dict(dx, dy, area, face_x, face_y) of (nx, ny) planes on ``device``:
    the outer products of the 1-D factors of ``mesh.metric_factors()``,
    each factor cast to ``dtype`` before the multiply (as the JAX package
    does, so that float64 planes agree bit for bit)."""
    out = {}
    for name, (col, row) in mesh.metric_factors().items():
        c = torch.as_tensor(col, device=device).to(dtype)
        r = torch.as_tensor(row, device=device).to(dtype)
        out[name] = c[:, None] * r[None, :]
    return out


#: mean Earth radius [m], as used by ERA5/CF tooling.
EARTH_RADIUS = 6.371e6


class SphericalMesh(RectMesh):
    """Regular lon-lat mesh on the sphere: i ~ longitude, j ~ latitude.

    In-element gradients use the element-centre widths
    ``dx = R cos(phi_c) dlambda`` and ``dy = R dphi``; the zonal (bottom)
    face of row j has its own latitude's length ``R cos(phi_j) dlambda``;
    element areas are the exact zone areas
    ``R^2 dlambda (sin(phi_{j+1}) - sin(phi_j))``. Curvature terms are
    neglected, as in the JAX package.
    """

    def __init__(
        self, nx: int, ny: int, lon0: float, lon1: float,
        lat0: float, lat1: float, radius: float = EARTH_RADIUS,
        periodic_x: bool = False,
    ) -> None:
        if not (-90.0 < lat0 < 90.0 and -90.0 < lat1 < 90.0):
            raise ValueError("latitudes must be strictly inside (-90, 90)")
        lam0, lam1 = np.radians(lon0), np.radians(lon1)
        phi0, phi1 = np.radians(lat0), np.radians(lat1)
        self.radius = float(radius)
        self.dlam = (lam1 - lam0) / nx
        self.dphi = (phi1 - phi0) / ny
        self.lam0 = lam0
        self.phi0 = phi0
        super().__init__(
            nx, ny, dx=radius * self.dlam, dy=radius * self.dphi,
            x0=radius * lam0, y0=radius * phi0, periodic_x=periodic_x,
        )
        self.uniform = False  # per-latitude metric
        phi_nodes = phi0 + np.arange(ny + 1) * self.dphi
        phi_centers = phi0 + (np.arange(ny) + 0.5) * self.dphi
        self._cos_node = np.cos(phi_nodes)  # (ny + 1,)
        self._cos_center = np.cos(phi_centers)  # (ny,)
        self._zone_area = radius * radius * self.dlam * np.diff(np.sin(phi_nodes))

    @property
    def dx(self):
        """Element-centre zonal width R cos(phi_c) dlambda: (1, ny)."""
        return (self.radius * self.dlam) * self._cos_center[None, :]

    @property
    def dy(self):
        """Meridional spacing R dphi (latitude-independent)."""
        return float(self.radius * self.dphi)

    @property
    def cell_area(self):
        """Exact spherical zone areas: (1, ny)."""
        return self._zone_area[None, :]

    @property
    def face_len_x(self):
        """Meridional (left) faces all have length R dphi."""
        return float(self.radius * self.dphi)

    @property
    def face_len_y(self):
        """Zonal (bottom) face of row j: R cos(phi_j) dlambda, (1, ny)."""
        return (self.radius * self.dlam) * self._cos_node[None, :-1]

    def metric_factors(self) -> dict:
        """The spherical metric as (col, row) factors: the metric depends on
        latitude only, so every column factor is ones."""
        ones_x = np.ones(self.nx)
        ones_y = np.ones(self.ny)
        return {
            "dx": (ones_x, (self.radius * self.dlam) * self._cos_center),
            "dy": (ones_x, (self.radius * self.dphi) * ones_y),
            "area": (ones_x, self._zone_area),
            "face_x": (ones_x, (self.radius * self.dphi) * ones_y),
            "face_y": (ones_x, (self.radius * self.dlam) * self._cos_node[:-1]),
        }

    def lonlat_centers(self):
        """(lat, lon) element-centre arrays in degrees (numpy), each (nx, ny)."""
        lons = np.degrees(self.lam0 + (np.arange(self.nx) + 0.5) * self.dlam)
        lats = np.degrees(self.phi0 + (np.arange(self.ny) + 0.5) * self.dphi)
        lat2d = np.broadcast_to(lats[None, :], (self.nx, self.ny))
        lon2d = np.broadcast_to(lons[:, None], (self.nx, self.ny))
        return lat2d, lon2d


class LocalMeshView(RectMesh):
    """One rank's (nx // px, ny // py) block of a graded or spherical global
    mesh on a rank grid.

    Counterpart of the JAX package's ``LocalMeshView``. Under ``shard_map``
    one program serves every device, so there the view slices the global
    metric factors by ``lax.axis_index`` at trace time; here each rank
    builds a model of its own, so the view is concrete: it holds the global
    mesh, the grid's shape (px, py) and the rank's coordinates (ix, iy).
    ``metric_factors`` are the global 1-D factors sliced to the block, so
    ``device_metric_planes`` of the view are bit-identical slices of the
    global planes (each factor is cast before the product, as there), and
    ``window_metric`` gives the same planes over the block widened by ghost
    cells. The static metric accessors (``dx``, ``cell_area``, ...) raise, as
    the JAX package's do: a solver reading them would take one number or
    one global array for a block's metric. Shape and topology (``nx``,
    ``ny``, ``periodic_x``, ``periodic_y``) are the block's.
    """

    is_local_view = True

    def __init__(self, global_mesh: RectMesh, px: int, py: int, coords) -> None:
        if global_mesh.uniform:
            raise ValueError("a uniform global mesh splits into plain RectMesh blocks")
        if global_mesh.nx % px or global_mesh.ny % py:
            raise ValueError(
                f"grid {global_mesh.nx}x{global_mesh.ny} not divisible by rank grid {px}x{py}"
            )
        ix, iy = (int(c) for c in coords)
        if not (0 <= ix < px and 0 <= iy < py):
            raise ValueError(f"rank coordinates {coords} outside a {px} x {py} grid")
        super().__init__(
            global_mesh.nx // px, global_mesh.ny // py, 1.0, 1.0,
            periodic_x=global_mesh.periodic_x, periodic_y=global_mesh.periodic_y,
        )
        self.uniform = False
        self.global_mesh = global_mesh
        self.px, self.py = int(px), int(py)
        self.coords = (ix, iy)

    def _no_static_metric(self, name: str):
        raise TypeError(
            f"LocalMeshView.{name} would be one number or global array for a rank's block; "
            "use metric_factors(), device_metric_planes(view) or the global_mesh"
        )

    @property
    def dx(self):
        self._no_static_metric("dx")

    @property
    def dy(self):
        self._no_static_metric("dy")

    @property
    def cell_area(self):
        self._no_static_metric("cell_area")

    @property
    def face_len_x(self):
        self._no_static_metric("face_len_x")

    @property
    def face_len_y(self):
        self._no_static_metric("face_len_y")

    def node_coords(self):
        self._no_static_metric("node_coords")

    def edge_x_coords(self, s_edge):
        self._no_static_metric("edge_x_coords")

    def edge_y_coords(self, s_edge):
        self._no_static_metric("edge_y_coords")

    def volume_quad_coords(self, xq_vol, yq_vol):
        self._no_static_metric("volume_quad_coords")

    def _window(self, axis: int, lo: int, hi: int):
        """(global indices, inside) of the block's cells [-lo, n + hi) along
        ``axis``: wrapped on a periodic axis; beyond a closed wall the index
        is clipped and ``inside`` False."""
        n, n_global = (self.nx, self.global_mesh.nx) if axis == 0 else (self.ny, self.global_mesh.ny)
        periodic = self.periodic_x if axis == 0 else self.periodic_y
        idx = self.coords[axis] * n + np.arange(-lo, n + hi)
        if periodic:
            return idx % n_global, np.ones(idx.shape, dtype=bool)
        inside = (idx >= 0) & (idx < n_global)
        return np.clip(idx, 0, n_global - 1), inside

    def block_of(self, value):
        """This block of a global static metric value: a float stays a
        float, an array broadcastable to the global (nx, ny) is sliced to
        the block's (nx, ny)."""
        if isinstance(value, float):
            return value
        g, (ix, iy) = self.global_mesh, self.coords
        full = np.broadcast_to(np.asarray(value), (g.nx, g.ny))
        return full[ix * self.nx: (ix + 1) * self.nx, iy * self.ny: (iy + 1) * self.ny].copy()

    def metric_factors(self) -> dict:
        """The global mesh's (col, row) factors sliced to this block."""
        (cols, _), (rows, _) = self._window(0, 0, 0), self._window(1, 0, 0)
        return {
            name: (col[cols], row[rows])
            for name, (col, row) in self.global_mesh.metric_factors().items()
        }

    def window_metric(self, lo: int, hi: int = None, *, device, dtype):
        """(planes, inside) over the block widened by ``lo`` cells before and
        ``hi`` (default ``lo``) after it on both axes: dict(dx, dy, area,
        face_x, face_y) of the global mesh's cells there, each the product
        of its factors cast to ``dtype`` (bit-identical to the global
        planes), wrapped round a periodic axis; and ``inside``, a bool plane
        that is False beyond a closed global wall, where every plane is 0
        (the zero strips of an exchange at a wall)."""
        hi = lo if hi is None else hi
        (cols, in_x), (rows, in_y) = self._window(0, lo, hi), self._window(1, lo, hi)
        inside = torch.as_tensor(in_x[:, None] & in_y[None, :], device=device)
        as_t = lambda a: torch.as_tensor(a, device=device).to(dtype)
        planes = {}
        for name, (col, row) in self.global_mesh.metric_factors().items():
            c = as_t(np.where(in_x, col[cols], 0.0))
            r = as_t(np.where(in_y, row[rows], 0.0))
            planes[name] = c[:, None] * r[None, :]
        return planes, inside


class MetricShim(RectMesh):
    """An (nx, ny) block whose metric is not a mesh's own: the inner
    engine's mesh of a rank block of a graded or spherical mesh (the block
    widened by ghost cells, or an rdma round's bands). The geometry rides
    the solvers' metric planes instead: the mEVP's metric consts, widened
    with the state, and the transport's planes passed to it explicitly (the
    JAX package's unit shim mesh, whose metric is never read). It counts as
    non-uniform, so that the kernels take the metric forms, and its static
    metric and ``metric_factors`` raise."""

    def __init__(self, nx: int, ny: int, periodic_x: bool = False, periodic_y: bool = False) -> None:
        super().__init__(nx, ny, 1.0, 1.0, periodic_x=periodic_x, periodic_y=periodic_y)
        self.uniform = False

    def _no_metric(self, name: str):
        raise TypeError(f"MetricShim.{name}: a shim's metric rides the solvers' metric planes")

    @property
    def dx(self):
        self._no_metric("dx")

    @property
    def dy(self):
        self._no_metric("dy")

    @property
    def cell_area(self):
        self._no_metric("cell_area")

    @property
    def face_len_x(self):
        self._no_metric("face_len_x")

    @property
    def face_len_y(self):
        self._no_metric("face_len_y")

    def metric_factors(self) -> dict:
        self._no_metric("metric_factors")


def block_mesh(nx: int, ny: int, like: RectMesh, periodic=(False, False)) -> RectMesh:
    """The mesh of an (nx, ny) block that an inner engine runs in place of
    ``like``'s (a rank block widened by ghost cells, an rdma round's bands),
    with the periodic axes ``periodic``: a uniform one of ``like``'s widths,
    or a ``MetricShim`` where ``like`` is graded or spherical."""
    px, py = (bool(p) for p in periodic)
    if like.uniform:
        return RectMesh(nx, ny, like.dx, like.dy, periodic_x=px, periodic_y=py)
    return MetricShim(nx, ny, periodic_x=px, periodic_y=py)
