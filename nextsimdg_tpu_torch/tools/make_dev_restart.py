"""Generate the canonical development restart file.

Counterpart of ``nextsimdg_tpu.tools.make_dev_restart`` (the reference's
``run/dev_res.py``): a 10x10 devgrid restart with cice=0.5, hice=0.1,
hsnow=0, sss=32, sst=-1, tice=-1 (1 layer). ``seeded_rect_fields`` makes a
rectgrid restart of any size from a numpy seed, for runs at a realistic
size.

Usage: ``python -m nextsimdg_tpu_torch.tools.make_dev_restart [path]``
"""

from __future__ import annotations

import sys

import numpy as np

from ..io.restart import RestartFields, write_restart_fields


def dev_restart_fields(nx: int = 10, ny: int = 10) -> RestartFields:
    """The development restart's fields, in memory."""
    full = lambda v: np.full((nx, ny), v, dtype=np.float64)
    return RestartFields(
        structure_type="devgrid",
        cice=full(0.5), hice=full(0.1), hsnow=full(0.0), sss=full(32.0), sst=full(-1.0),
        tice=np.full((nx, ny, 1), -1.0, dtype=np.float64),
    )


def seeded_rect_fields(nx: int, ny: int, nlayers: int = 1, seed: int = 0) -> RestartFields:
    """A rectgrid restart drawn from ``seed``: cice in [0, 1] (a tenth of
    the columns ice-free), true ice thickness in [0, 3] m and true snow
    depth in [0, 0.5] m (so effective hice in [0, 3] m and hsnow in
    [0, 0.5] m), sss 32, sst within 0.05 degC of its linear freezing point
    (-1.76), the surface temperature in [-30, -0.1] degC and the deeper
    layers on a line from it towards the freezing point."""
    rng = np.random.default_rng(seed)
    shape = (nx, ny)
    cice = np.where(rng.uniform(size=shape) < 0.1, 0.0, rng.uniform(0.0, 1.0, shape))
    ice = cice > 0.0
    t_surf = rng.uniform(-30.0, -0.1, shape)
    t_freeze = -0.055 * 32.0
    depth = np.arange(nlayers) / nlayers
    tice = np.minimum(t_surf[..., None] + (t_freeze - t_surf[..., None]) * depth, -0.1)
    return RestartFields(
        structure_type="rectgrid",
        cice=cice,
        hice=cice * rng.uniform(0.0, 3.0, shape),
        hsnow=cice * rng.uniform(0.0, 0.5, shape),
        sss=np.full(shape, 32.0),
        sst=t_freeze + rng.uniform(-0.05, 0.05, shape),
        tice=tice,
    )


def make_dev_restart(path: str = "dev1.res.nc", nx: int = 10, ny: int = 10) -> None:
    write_restart_fields(path, dev_restart_fields(nx, ny))


if __name__ == "__main__":
    make_dev_restart(sys.argv[1] if len(sys.argv) > 1 else "dev1.res.nc")
