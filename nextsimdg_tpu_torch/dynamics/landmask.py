"""Land/ocean element masks for pan-Arctic-style domains.

Counterpart of ``nextsimdg_tpu.dynamics.landmask`` (numpy, copied so that
the port imports nothing of the JAX package): an (nx, ny) element mask
with 1 = ocean, 0 = land. The coupled model turns it into impermeable
coastline faces (``transport.face_masks_from_land``) and no-slip coastal
velocity nodes (``CoupledModel.node_mask``).
"""

from __future__ import annotations

import numpy as np


def synthetic_coastline(nx: int, ny: int = None, seed: int = 7) -> np.ndarray:
    """A pan-Arctic-style ocean mask: wavy coasts + islands, ~85% ocean.

    Deterministic for a given (nx, ny, seed), and equal to the JAX
    package's mask of the same arguments.
    """
    ny = nx if ny is None else ny
    ocean = np.ones((nx, ny))
    j = np.arange(ny)
    coast = (0.06 * nx * (1.0 + 0.5 * np.sin(2 * np.pi * j / max(ny / 3, 1)))).astype(int)
    for col in range(ny):
        ocean[: coast[col], col] = 0.0  # western coastline
    ocean[:, : max(ny // 32, 1)] = 0.0  # southern shelf
    rng = np.random.default_rng(seed)
    m = min(nx, ny)
    for _ in range(max(4, m // 256)):  # islands
        ci = rng.integers(nx // 4, 3 * nx // 4)
        cj = rng.integers(ny // 4, 3 * ny // 4)
        r = rng.integers(max(m // 64, 1), max(m // 24, 2))
        ii, jj = np.ogrid[:nx, :ny]
        ocean[(ii - ci) ** 2 + (jj - cj) ** 2 < r * r] = 0.0
    return ocean


def load_ocean_mask(spec: str, nx: int, ny: int) -> np.ndarray:
    """An (nx, ny) mask from ``spec``: ``synthetic`` generates
    :func:`synthetic_coastline`; anything else is a path to a ``.npy``
    array of shape (nx, ny) with 1 = ocean, 0 = land."""
    if spec == "synthetic":
        return synthetic_coastline(nx, ny)
    mask = np.load(spec)
    if mask.shape != (nx, ny):
        raise ValueError(f"land mask {spec} has shape {mask.shape}, expected ({nx}, {ny})")
    return np.asarray(mask, dtype=np.float64)
