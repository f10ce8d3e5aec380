"""ERA5 / CF-convention netCDF forcing reader.

The port's copy of ``nextsimdg_tpu.io.era5``: real-data forcing from ERA5
reanalysis files as distributed by the Copernicus CDS (netCDF4/HDF5 files
with ``time``/``latitude``/``longitude`` axes and CF-packed variables,
``scale_factor``/``add_offset``/``_FillValue``, named by ECMWF short names:
t2m, d2m, msl, ssrd, strd, sf, u10, v10).

Layering: ERA5 file -> (decode CF packing, convert units, regrid to the
model mesh) -> the forcing-archive schema of :mod:`.forcing_file` ->
``ForcingProvider`` -> model. The decode and regrid run once, before the
run, in numpy and scipy on the host, as in the JAX package; the in-loop
path is the archive's provider.

Reading goes through one function, ``read_era5_variables`` (every dataset
of the file's root with its attributes), which alone imports h5py; the
archive is written by ``forcing_file.write_forcing_archive``.

Unit conversions applied (ERA5 -> model):

======  ==================================  =========================
short   ERA5 meaning / unit                 model field / unit
======  ==================================  =========================
t2m     2 m temperature [K]                 tair [deg C]
d2m     2 m dewpoint [K]                    dew2m [deg C]
msl     mean sea-level pressure [Pa]        pair [Pa]
sp      surface pressure [Pa]               pair [Pa] (fallback)
ssrd    SW down, accumulated [J m-2]        sw_in [W m-2] (/accum dt)
strd    LW down, accumulated [J m-2]        lw_in [W m-2] (/accum dt)
sf      snowfall, accumulated [m w.e.]      snowfall [kg m-2 s-1]
u10     10 m wind u [m s-1]                 u_atm [m s-1]
v10     10 m wind v [m s-1]                 v_atm [m s-1]
(u10,v10)                                   wind = hypot(u10, v10)
======  ==================================  =========================

ERA5 has no mixed-layer depth or ocean currents; those fall back to the
dummy constants (or an ocean archive merged by the caller).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from . import forcing_file
from .forcing_file import DUMMY_VALUES

__all__ = [
    "ERA5Dataset",
    "era5_to_archive",
    "read_era5_variables",
    "regrid_bilinear",
    "lonlat_box",
]

_KELVIN = 273.15

#: candidate names for each coordinate axis (CDS has changed conventions).
_TIME_NAMES = ("time", "valid_time")
_LAT_NAMES = ("latitude", "lat")
_LON_NAMES = ("longitude", "lon")

#: ERA5 short name -> model field (instantaneous fields).
_INSTANT_MAP = {
    "t2m": ("tair", lambda x: x - _KELVIN),
    "d2m": ("dew2m", lambda x: x - _KELVIN),
    "msl": ("pair", lambda x: x),
    "sp": ("pair", lambda x: x),
    "u10": ("u_atm", lambda x: x),
    "v10": ("v_atm", lambda x: x),
}

#: ERA5 short name -> model field for step-accumulated quantities; the
#: converter receives (values, accumulation seconds).
_ACCUM_MAP = {
    "ssrd": ("sw_in", lambda x, dt: x / dt),
    "strd": ("lw_in", lambda x, dt: x / dt),
    "sf": ("snowfall", lambda x, dt: x * 1000.0 / dt),  # m w.e. -> kg m-2 s-1
}


def read_era5_variables(path: str) -> Dict[str, Tuple[np.ndarray, dict]]:
    """Every dataset at the root of the file: name -> (its raw values as
    stored, its attributes), in the file's order."""
    import h5py

    with h5py.File(path, "r") as handle:
        return {
            name: (np.asarray(node), dict(node.attrs.items()))
            for name, node in handle.items()
            if isinstance(node, h5py.Dataset)
        }


def _decode_time(values: np.ndarray, units: Optional[str]) -> np.ndarray:
    """CF time -> seconds since the first record (model-relative seconds)."""
    values = np.asarray(values, dtype=np.float64)
    if not units:
        return values - values[0]
    match = re.match(r"\s*(\w+)\s+since\s+", units)
    scale = {
        "seconds": 1.0, "second": 1.0,
        "minutes": 60.0, "minute": 60.0,
        "hours": 3600.0, "hour": 3600.0,
        "days": 86400.0, "day": 86400.0,
    }.get(match.group(1).lower() if match else "seconds", 1.0)
    seconds = values * scale
    return seconds - seconds[0]


def _unpack(raw: np.ndarray, attrs: dict) -> np.ndarray:
    """Apply CF packing attributes: x = raw*scale_factor + add_offset;
    _FillValue/missing_value -> NaN."""
    out = raw.astype(np.float64)
    for miss_key in ("_FillValue", "missing_value"):
        if miss_key in attrs:
            miss = np.asarray(attrs[miss_key]).ravel()
            if miss.size:
                out[raw == miss[0]] = np.nan
    scale = float(np.asarray(attrs.get("scale_factor", 1.0)).ravel()[0])
    offset = float(np.asarray(attrs.get("add_offset", 0.0)).ravel()[0])
    if scale != 1.0 or offset != 0.0:
        nan_mask = np.isnan(out)
        out = out * scale + offset
        out[nan_mask] = np.nan
    return out


def _attr_str(attrs: dict, key: str) -> Optional[str]:
    value = attrs.get(key)
    if value is None:
        return None
    if isinstance(value, bytes):
        return value.decode("utf-8", "replace")
    if isinstance(value, np.ndarray) and value.dtype.kind in "SU":
        value = value.ravel()[0]
        return value.decode() if isinstance(value, bytes) else str(value)
    return str(value)


class ERA5Dataset:
    """An ERA5 (CF netCDF4/HDF5) file, decoded to physical units.

    Attributes: ``time`` (seconds from the first record), ``lats``
    (descending or ascending, as stored), ``lons``, and ``fields``: a dict
    of model-field name -> (T, nlat, nlon) float64 arrays in model units.
    """

    def __init__(self, path: str) -> None:
        variables = read_era5_variables(path)
        time_name = self._find(variables, _TIME_NAMES, "time")
        lat_name = self._find(variables, _LAT_NAMES, "latitude")
        lon_name = self._find(variables, _LON_NAMES, "longitude")
        raw_time, time_attrs = variables[time_name]
        self.time = _decode_time(raw_time, _attr_str(time_attrs, "units"))
        self.lats = np.asarray(variables[lat_name][0], dtype=np.float64)
        self.lons = np.asarray(variables[lon_name][0], dtype=np.float64)

        # Accumulation window: ERA5 accumulations are over the archive step
        # (1 h for hourly data).
        accum_dt = float(np.median(np.diff(self.time))) if len(self.time) > 1 else 3600.0

        coord_names = {time_name, lat_name, lon_name, "expver", "number"}
        self.fields: Dict[str, np.ndarray] = {}
        for name, (raw, attrs) in variables.items():
            if name in coord_names or raw.ndim < 3:
                continue
            data = _unpack(raw, attrs)
            # Tolerate an ensemble/expver axis of size 1: (T, 1, Y, X).
            while data.ndim > 3 and data.shape[1] == 1:
                data = data[:, 0]
            if data.ndim != 3:
                continue
            if name in _INSTANT_MAP:
                field, conv = _INSTANT_MAP[name]
                self.fields[field] = conv(data)
            elif name in _ACCUM_MAP:
                field, conv = _ACCUM_MAP[name]
                self.fields[field] = conv(data, accum_dt)
        if "u_atm" in self.fields and "v_atm" in self.fields:
            self.fields["wind"] = np.hypot(self.fields["u_atm"], self.fields["v_atm"])

    @staticmethod
    def _find(variables: dict, names: Sequence[str], what: str) -> str:
        for name in names:
            if name in variables:
                return name
        raise ValueError(f"no {what} coordinate in ERA5 file (tried {names})")


def regrid_bilinear(
    field: np.ndarray,
    src_lats: np.ndarray,
    src_lons: np.ndarray,
    dst_lats: np.ndarray,
    dst_lons: np.ndarray,
) -> np.ndarray:
    """Bilinear regrid of (..., nlat, nlon) onto target (nx, ny) points.

    Handles descending ERA5 latitude axes and replaces NaNs (masked cells)
    with nearest valid values before interpolating. Longitudes are used as
    given: the caller keeps source and target on the same branch (e.g. both
    in [0, 360)).
    """
    from scipy.interpolate import RegularGridInterpolator

    field = np.asarray(field, dtype=np.float64)
    lats = np.asarray(src_lats, dtype=np.float64)
    lons = np.asarray(src_lons, dtype=np.float64)
    if lats[0] > lats[-1]:  # ERA5 stores north -> south
        lats = lats[::-1]
        field = field[..., ::-1, :]

    leading = field.shape[:-2]
    flat = field.reshape((-1,) + field.shape[-2:])
    pts = np.stack(
        [np.asarray(dst_lats, np.float64).ravel(), np.asarray(dst_lons, np.float64).ravel()], axis=-1
    )
    out = np.empty((flat.shape[0], pts.shape[0]))
    for k, plane in enumerate(flat):
        if np.isnan(plane).any():
            plane = _fill_nans(plane)
        interp = RegularGridInterpolator((lats, lons), plane, bounds_error=False, fill_value=None)
        out[k] = interp(pts)
    return out.reshape(leading + np.asarray(dst_lats).shape)


def _fill_nans(plane: np.ndarray) -> np.ndarray:
    """Nearest-neighbour fill of NaNs (land-masked source cells)."""
    from scipy.ndimage import distance_transform_edt

    mask = np.isnan(plane)
    if not mask.any():
        return plane
    idx = distance_transform_edt(mask, return_indices=True, return_distances=False)
    return plane[tuple(idx)]


def lonlat_box(nx: int, ny: int, lat0: float, lat1: float, lon0: float, lon1: float):
    """Cell-centre (nx, ny) lat/lon arrays for a regular lon-lat box mesh
    (x ~ longitude, y ~ latitude)."""
    lons = lon0 + (np.arange(nx) + 0.5) * (lon1 - lon0) / nx
    lats = lat0 + (np.arange(ny) + 0.5) * (lat1 - lat0) / ny
    lon2d = np.broadcast_to(lons[:, None], (nx, ny))
    lat2d = np.broadcast_to(lats[None, :], (nx, ny))
    return lat2d, lon2d


def era5_to_archive(
    era5_path: str,
    archive_path: str,
    dst_lats: np.ndarray,
    dst_lons: np.ndarray,
    extra_fields: Optional[Dict[str, np.ndarray]] = None,
    mld: Optional[float] = None,
) -> Dict[str, np.ndarray]:
    """Convert an ERA5 file to a model forcing archive on the given mesh.

    ``dst_lats``/``dst_lons``: (nx, ny) cell-centre coordinates.
    ``extra_fields``: already-regridded (T, nx, ny) series to merge (e.g.
    ocean currents from another source). ``mld``: constant mixed-layer depth
    to bake in (defaults to the dummy value). Returns the written field dict.
    """
    ds = ERA5Dataset(era5_path)
    nx, ny = np.asarray(dst_lats).shape
    out: Dict[str, np.ndarray] = {}
    for name, series in ds.fields.items():
        out[name] = regrid_bilinear(series, ds.lats, ds.lons, dst_lats, dst_lons)
    t_steps = len(ds.time)
    out["mld"] = np.full((t_steps, nx, ny), DUMMY_VALUES["mld"] if mld is None else float(mld))
    if extra_fields:
        for name, series in extra_fields.items():
            series = np.asarray(series, dtype=np.float64)
            if series.shape != (t_steps, nx, ny):
                raise ValueError(
                    f"extra field {name!r} has shape {series.shape}, want {(t_steps, nx, ny)}"
                )
            out[name] = series
    forcing_file.write_forcing_archive(archive_path, ds.time, out)
    return out
