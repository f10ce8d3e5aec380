"""Time-dependent forcing from files.

The port's copy of ``nextsimdg_tpu.io.forcing_file``: an HDF5 forcing
archive with a time axis and per-field (time, nx, ny) series, read into a
provider that interpolates linearly in time (optionally periodic,
climatology-style) and returns the model's forcing trees on a device.

Schema (HDF5): group ``forcing`` with dataset ``time`` (seconds, ascending)
and any subset of the field names in THERMO_FIELDS / DYNAMICS_FIELDS, each
(T, nx, ny) float64; missing fields fall back to the reference's dummy
constants. h5py is imported by the two functions that open a file
(``write_forcing_archive``, ``read_forcing_archive``), so the module imports
without it.

The provider computes what the JAX package's computes (its ``_interp``):
the time clamped to the archive's range or wrapped (periodic), the record
``searchsorted(time, t, side="right") - 1``, the last record taken as is,
the weight ``(t - t_i) / span`` (0 where the span is not positive), the
blend ``(1 - w) * a + w * b`` in float64, then rounded to ``dtype``. Index
and weight are worked out on the host; only the two bracketing records live
on the device, in float64, copied there when the bracket changes (a step
forward keeps the old upper record as the new lower one and copies one
record). On a card each copy goes from a pinned staging buffer,
asynchronously; a staging buffer is refilled only after its last copy has
completed. The blend runs on the device as two float64 multiplies and an
add, separate operations in the JAX package's order, so the result is
bit-identical to the host's. Dummy planes are made once.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..state import Forcing

THERMO_FIELDS = ("tair", "dew2m", "pair", "sw_in", "lw_in", "mld", "snowfall", "wind")
DYNAMICS_FIELDS = ("u_atm", "v_atm", "u_ocean", "v_ocean")

#: Reference dummy values (DummyExternalData.hpp:22-34) as fallbacks.
DUMMY_VALUES = {
    "tair": -1.0, "dew2m": -4.0, "pair": 1e5, "sw_in": 0.0, "lw_in": 311.0,
    "mld": 10.0, "snowfall": 0.0, "wind": 0.0,
    "u_atm": 0.0, "v_atm": 0.0, "u_ocean": 0.0, "v_ocean": 0.0,
}


def write_forcing_archive(path: str, time, fields: Dict[str, np.ndarray]) -> None:
    """Write a forcing archive: time (T,), each field (T, nx, ny)."""
    import h5py

    time = np.asarray(time, dtype=np.float64)
    with h5py.File(path, "w") as handle:
        group = handle.create_group("forcing")
        group.create_dataset("time", data=time)
        for name, series in fields.items():
            series = np.asarray(series, dtype=np.float64)
            if series.shape[0] != time.shape[0]:
                raise ValueError(f"field {name!r} has {series.shape[0]} steps, time has {time.shape[0]}")
            group.create_dataset(name, data=series)


def read_forcing_archive(path: str) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """The archive's time axis (float64) and its series by field name, as
    stored."""
    import h5py

    with h5py.File(path, "r") as handle:
        group = handle["forcing"]
        time = np.asarray(group["time"], dtype=np.float64)
        fields = {name: np.asarray(group[name]) for name in group if name != "time"}
    return time, fields


class ForcingProvider:
    """Linear-in-time interpolation of a forcing archive, on ``device``.

    ``periodic=True`` wraps the time axis (climatology); otherwise times are
    clamped to the archive's range. The series are held in float64, the
    schema's type.
    """

    def __init__(
        self, path: str, periodic: bool = False, dtype=torch.float32, device="cuda",
    ) -> None:
        self.dtype = dtype
        self.device = torch.device(device)
        self.periodic = periodic
        self.time, fields = read_forcing_archive(path)
        if len(self.time) < 1:
            raise ValueError("forcing archive has no time steps")
        self.fields = {name: np.asarray(series, dtype=np.float64) for name, series in fields.items()}
        shapes = {f.shape[1:] for f in self.fields.values()}
        if len(shapes) > 1:
            raise ValueError(f"inconsistent field shapes: {shapes}")
        self.shape = shapes.pop() if shapes else None
        self.t0 = float(self.time[0])
        self.t1 = float(self.time[-1])
        self.names = tuple(self.fields)
        #: record index -> its fields stacked (F, *shape) in float64 on the
        #: device: at most the two bracketing records.
        self._records: Dict[int, torch.Tensor] = {}
        #: pinned staging buffers and the event of each one's last copy.
        self._staging = []
        self._next_staging = 0
        self._dummies: Dict[Tuple[str, int, int], torch.Tensor] = {}
        self._planes_key = None
        self._planes: Dict[str, torch.Tensor] = {}

    # -- the host's part: where t falls -------------------------------------
    def bracket(self, t: float) -> Tuple[int, Optional[float]]:
        """The record index and the weight of the next record at time t; the
        weight is None where the record is taken as is (the last one)."""
        if self.periodic and self.t1 > self.t0:
            t = self.t0 + (t - self.t0) % (self.t1 - self.t0)
        t = min(max(t, self.t0), self.t1)
        idx = int(np.searchsorted(self.time, t, side="right") - 1)
        idx = min(max(idx, 0), len(self.time) - 1)
        if idx == len(self.time) - 1:
            return idx, None
        span = self.time[idx + 1] - self.time[idx]
        return idx, (t - self.time[idx]) / span if span > 0 else 0.0

    # -- the device's part ---------------------------------------------------
    def _fill(self, k: int, dst: torch.Tensor) -> None:
        """Record k's fields into the host tensor ``dst`` (PyTorch's copy,
        spread over its threads)."""
        for i, name in enumerate(self.names):
            dst[i].copy_(torch.from_numpy(self.fields[name][k]))

    def _stage(self, k: int, dst: torch.Tensor) -> None:
        """Record k's fields into ``dst`` (F, *shape) on the device."""
        if self.device.type != "cuda":
            self._fill(k, dst)
            return
        if len(self._staging) < 2:
            host = torch.empty(dst.shape, dtype=torch.float64, pin_memory=True)
            self._staging.append([host, None])
        slot = self._staging[self._next_staging % len(self._staging)]
        self._next_staging += 1
        host, event = slot
        if event is not None:
            event.synchronize()  # its last copy has left the buffer
        self._fill(k, host)
        dst.copy_(host, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record()

    def _load(self, wanted: Tuple[int, ...]) -> None:
        """Hold exactly the records ``wanted`` on the device, copying only
        those not held; a record let go lends its memory to a new one."""
        free = [self._records.pop(k) for k in list(self._records) if k not in wanted]
        for k in wanted:
            if k not in self._records:
                dst = free.pop() if free else torch.empty(
                    (len(self.names), *self.shape), dtype=torch.float64, device=self.device)
                self._stage(k, dst)
                self._records[k] = dst

    def _archive_planes(self, t: float) -> Dict[str, torch.Tensor]:
        """The archive's fields at time t, rounded to ``dtype`` on the device
        (one blend of every field; reused for a second call at the same t)."""
        if not self.names:
            return {}
        if self._planes_key == t:
            return self._planes
        idx, w = self.bracket(t)
        if w is None:
            self._load((idx,))
            # A copy even in float64: the record's memory is lent to
            # another record later.
            out = self._records[idx].to(self.dtype, copy=True)
        else:
            self._load((idx, idx + 1))
            blend = self._records[idx] * (1.0 - w)
            blend += self._records[idx + 1] * w
            out = blend.to(self.dtype)
        self._planes_key, self._planes = t, dict(zip(self.names, out.unbind(0)))
        return self._planes

    def _field(self, planes: dict, name: str, nx: int, ny: int) -> torch.Tensor:
        plane = planes.get(name)
        if plane is None:
            key = (name, nx, ny)
            if key not in self._dummies:
                self._dummies[key] = torch.full(
                    (nx, ny), DUMMY_VALUES[name], dtype=self.dtype, device=self.device)
            return self._dummies[key]
        if plane.shape != (nx, ny):
            plane = torch.broadcast_to(plane, (nx, ny)).contiguous()
        return plane

    def thermo_forcing(self, t: float, nx: int, ny: int) -> Forcing:
        planes = self._archive_planes(t)
        return Forcing(**{name: self._field(planes, name, nx, ny) for name in THERMO_FIELDS})

    def dynamics_forcing(self, t: float, nx: int, ny: int):
        from ..dynamics.mevp import DynamicsForcing

        planes = self._archive_planes(t)
        return DynamicsForcing(**{name: self._field(planes, name, nx, ny) for name in DYNAMICS_FIELDS})
