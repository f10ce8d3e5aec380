"""netCDF-4 restart file I/O on h5py.

The port's copy of ``nextsimdg_tpu.io.restart``, with the same on-disk
schema, so that a file written by either package reads identically in the
other (``core/src/DevGridIO.cpp:35-39,149-201``; generator ``run/dev_res.py``):

* group ``structure`` with string attribute ``type`` (e.g. ``"devgrid"``);
* group ``data`` with netCDF dimensions ``x``, ``y``, ``nLayers`` and
  float64 variables ``hice, cice, hsnow, sst, sss`` on ``(x, y)`` plus
  ``tice`` on ``(x, y, nLayers)``.

netCDF-4 files are HDF5 files: the writer emits the netCDF-4 conventions
directly with h5py (dimension-scale datasets carrying
``CLASS=DIMENSION_SCALE``, the phony-dimension ``NAME`` string,
``_Netcdf4Dimid`` ids, and variables with attached scales and
``_Netcdf4Coordinates``). ``netcdf_c`` reads them back through the system
libnetcdf.

h5py is imported by the functions that open a file, not with the module, so
the package imports where h5py is not installed; there only
``RestartFields`` (in-memory restarts) is usable.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

STRUCTURE_NODE = "structure"
DATA_NODE = "data"
TYPE_ATTR = "type"

#: 2-D prognostic variables, in the reference's write order
#: (std::map iteration order over {cice,hice,hsnow,sss,sst} is alphabetical).
VAR_NAMES_2D = ("cice", "hice", "hsnow", "sss", "sst")
TICE_NAME = "tice"

_PHONY_DIM_PREFIX = "This is a netCDF dimension but not a netCDF variable."


def _phony_dim_name(size: int) -> str:
    # netCDF-c formats the hidden dimension NAME with the size right-aligned
    # in a 10-character field (matches the shipped dev1.res.nc).
    return f"{_PHONY_DIM_PREFIX}{size:10d}"


@dataclass
class RestartFields:
    """Raw restart contents as numpy arrays with file layout (x, y[, layer])."""

    structure_type: str
    hice: np.ndarray
    cice: np.ndarray
    hsnow: np.ndarray
    sst: np.ndarray
    sss: np.ndarray
    tice: np.ndarray  # (x, y, nLayers)

    @property
    def nx(self) -> int:
        return self.hice.shape[0]

    @property
    def ny(self) -> int:
        return self.hice.shape[1]

    @property
    def n_ice_layers(self) -> int:
        return self.tice.shape[2]


def _decode_attr(value) -> str:
    if isinstance(value, bytes):
        return value.decode("utf-8")
    if isinstance(value, np.ndarray) and value.dtype.kind in "SO":
        return value.item().decode("utf-8")
    return str(value)


def read_structure_type(path: str) -> str:
    """Read ``/structure@type`` (cf. ``StructureFactory.cpp:46-55``)."""
    import h5py

    with h5py.File(path, "r") as handle:
        return _decode_attr(handle[STRUCTURE_NODE].attrs[TYPE_ATTR])


def read_restart(path: str) -> RestartFields:
    """Read a restart file into numpy arrays (cf. ``DevGridIO::init``)."""
    import h5py

    with h5py.File(path, "r") as handle:
        structure_type = _decode_attr(handle[STRUCTURE_NODE].attrs[TYPE_ATTR])
        data = handle[DATA_NODE]
        fields = {name: np.asarray(data[name], dtype=np.float64) for name in VAR_NAMES_2D}
        tice = np.asarray(data[TICE_NAME], dtype=np.float64)
    return RestartFields(structure_type=structure_type, tice=tice, **fields)


def write_restart(
    path: str,
    structure_type: str,
    fields: Dict[str, np.ndarray],
    tice: np.ndarray,
) -> None:
    """Write a restart file (cf. ``DevGridIO::dump``).

    ``fields`` maps each 2-D variable name to an (nx, ny) array; ``tice`` is
    (nx, ny, nLayers).
    """
    import h5py

    nx, ny = np.asarray(fields["hice"]).shape
    nlayers = int(tice.shape[2])

    with h5py.File(path, "w") as handle:
        handle.attrs.create(
            "_NCProperties", np.bytes_("version=2,netcdf=4.8.1,hdf5=1.12.1")
        )
        meta = handle.create_group(STRUCTURE_NODE)
        meta.attrs.create(TYPE_ATTR, np.bytes_(structure_type))

        data = handle.create_group(DATA_NODE)
        dims = {}
        for dim_id, (name, size) in enumerate((("x", nx), ("y", ny), ("nLayers", nlayers))):
            dim = data.create_dataset(name, shape=(size,), dtype=">f4")
            dim.make_scale(_phony_dim_name(size))
            dim.attrs.create("_Netcdf4Dimid", np.int32(dim_id))
            dims[name] = dim

        def add_var(name: str, array: np.ndarray, dim_names: Sequence[str]) -> None:
            var = data.create_dataset(name, data=np.asarray(array, dtype=np.float64))
            for axis, dim_name in enumerate(dim_names):
                var.dims[axis].attach_scale(dims[dim_name])
            var.attrs.create(
                "_Netcdf4Coordinates",
                np.array([("x", "y", "nLayers").index(d) for d in dim_names], dtype=np.int32),
            )

        for name in VAR_NAMES_2D:
            add_var(name, fields[name], ("x", "y"))
        add_var(TICE_NAME, tice, ("x", "y", "nLayers"))


def write_restart_fields(path: str, fields: RestartFields) -> None:
    """Write an in-memory restart (``write_restart`` of its arrays)."""
    write_restart(
        path, fields.structure_type, {name: getattr(fields, name) for name in VAR_NAMES_2D},
        fields.tice,
    )
