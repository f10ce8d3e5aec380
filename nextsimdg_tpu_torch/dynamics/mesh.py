"""Structured mesh for the dynamical core: the uniform, closed rectangle.

Counterpart of ``nextsimdg_tpu.dynamics.mesh.RectMesh`` restricted to what
the main path uses: nx x ny elements of one width ``dx`` by one height
``dy``, with closed (no-flux / no-slip) walls on every side. Graded,
spherical and periodic meshes are not ported yet; the constructor rejects
them instead of running them wrongly.
"""

from __future__ import annotations

import numpy as np


class RectMesh:
    """nx x ny uniform elements of size dx x dy, closed on all four sides."""

    uniform = True

    def __init__(
        self, nx: int, ny: int, dx, dy,
        x0: float = 0.0, y0: float = 0.0,
        periodic_x: bool = False, periodic_y: bool = False,
    ) -> None:
        if periodic_x or periodic_y:
            raise NotImplementedError("periodic meshes are not ported yet")
        dx_arr = np.asarray(dx, dtype=np.float64).reshape(-1)
        dy_arr = np.asarray(dy, dtype=np.float64).reshape(-1)
        if np.any(dx_arr != dx_arr[0]) or np.any(dy_arr != dy_arr[0]):
            raise NotImplementedError("graded meshes are not ported yet")
        self.nx = int(nx)
        self.ny = int(ny)
        if self.nx < 1 or self.ny < 1:
            raise ValueError(f"mesh needs at least one element, got {nx} x {ny}")
        self.dx = float(dx_arr[0])
        self.dy = float(dy_arr[0])
        self.x0 = float(x0)
        self.y0 = float(y0)
        self.periodic_x = False
        self.periodic_y = False

    @property
    def cell_area(self) -> float:
        return self.dx * self.dy

    @property
    def n_elements(self) -> int:
        return self.nx * self.ny
