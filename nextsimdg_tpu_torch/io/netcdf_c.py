"""ctypes reader over the system netCDF C library (libnetcdf.so).

The port's copy of ``nextsimdg_tpu.io.netcdf_c``. The restart writer
(``io.restart``) emits netCDF-4 by writing the HDF5 dimension-scale
conventions through h5py; this module opens the files through the real
``libnetcdf``, the library the C++ reference reads restarts with
(``core/src/DevGridIO.cpp:101-138``), so a restart that reads back
identically here is readable by the reference.

Only the read surface the interop checks need is bound (open, group,
attribute, dimension and variable inquiry, double reads), each function
with its C signature. The library is loaded at the first call, and
``available()`` says whether it could be.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Dict, List, Optional

import numpy as np

NC_NOWRITE = 0
NC_GLOBAL = -1
NC_MAX_NAME = 256

_lib: Optional[ctypes.CDLL] = None

_INT, _STR = ctypes.c_int, ctypes.c_char_p
_INT_P, _SIZE_P = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_size_t)
#: The C signatures of the bound functions (all return an int status).
_SIGNATURES = {
    "nc_open": [_STR, _INT, _INT_P],
    "nc_close": [_INT],
    "nc_inq_grp_ncid": [_INT, _STR, _INT_P],
    "nc_inq_grps": [_INT, _INT_P, _INT_P],
    "nc_inq_grpname": [_INT, _STR],
    "nc_inq_attlen": [_INT, _INT, _STR, _SIZE_P],
    "nc_get_att_text": [_INT, _INT, _STR, _STR],
    "nc_inq_dimids": [_INT, _INT_P, _INT_P, _INT],
    "nc_inq_dim": [_INT, _INT, _STR, _SIZE_P],
    "nc_inq_varids": [_INT, _INT_P, _INT_P],
    "nc_inq_varname": [_INT, _INT, _STR],
    "nc_inq_varid": [_INT, _STR, _INT_P],
    "nc_inq_varndims": [_INT, _INT, _INT_P],
    "nc_inq_vardimid": [_INT, _INT, _INT_P],
    "nc_inq_dimlen": [_INT, _INT, _SIZE_P],
    "nc_get_var_double": [_INT, _INT, ctypes.POINTER(ctypes.c_double)],
}


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    for candidate in (
        ctypes.util.find_library("netcdf"),
        "libnetcdf.so.19",
        "libnetcdf.so",
    ):
        if not candidate:
            continue
        try:
            _lib = ctypes.CDLL(candidate)
            break
        except OSError:
            continue
    if _lib is not None:
        for name, argtypes in _SIGNATURES.items():
            function = getattr(_lib, name)
            function.argtypes = argtypes
            function.restype = ctypes.c_int
        _lib.nc_strerror.argtypes = [ctypes.c_int]
        _lib.nc_strerror.restype = ctypes.c_char_p
    return _lib


def available() -> bool:
    """Whether a system libnetcdf could be loaded."""
    return _load() is not None


class NetCDFError(RuntimeError):
    pass


def _check(status: int) -> None:
    if status != 0:
        message = _load().nc_strerror(status).decode()
        raise NetCDFError(f"netCDF error {status}: {message}")


class NetCDFReader:
    """Read-only netCDF-4 file access through libnetcdf."""

    def __init__(self, path: str) -> None:
        lib = _load()
        if lib is None:
            raise NetCDFError("no system libnetcdf available")
        self._lib = lib
        ncid = ctypes.c_int()
        _check(lib.nc_open(path.encode(), NC_NOWRITE, ctypes.byref(ncid)))
        self._ncid = ncid.value
        self._open = True

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        if self._open:
            _check(self._lib.nc_close(self._ncid))
            self._open = False

    def __enter__(self) -> "NetCDFReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- groups ---------------------------------------------------------------
    def group_id(self, name: str, parent: Optional[int] = None) -> int:
        grpid = ctypes.c_int()
        _check(
            self._lib.nc_inq_grp_ncid(
                self._ncid if parent is None else parent,
                name.encode(),
                ctypes.byref(grpid),
            )
        )
        return grpid.value

    def group_names(self, parent: Optional[int] = None) -> List[str]:
        parent = self._ncid if parent is None else parent
        count = ctypes.c_int()
        _check(self._lib.nc_inq_grps(parent, ctypes.byref(count), None))
        ids = (ctypes.c_int * count.value)()
        _check(self._lib.nc_inq_grps(parent, ctypes.byref(count), ids))
        names = []
        for grpid in ids:
            buf = ctypes.create_string_buffer(NC_MAX_NAME + 1)
            _check(self._lib.nc_inq_grpname(grpid, buf))
            names.append(buf.value.decode())
        return names

    # -- attributes -----------------------------------------------------------
    def get_att_text(self, grpid: int, name: str, varid: int = NC_GLOBAL) -> str:
        length = ctypes.c_size_t()
        _check(
            self._lib.nc_inq_attlen(
                grpid, varid, name.encode(), ctypes.byref(length)
            )
        )
        buf = ctypes.create_string_buffer(length.value + 1)
        _check(self._lib.nc_get_att_text(grpid, varid, name.encode(), buf))
        return buf.raw[: length.value].decode()

    # -- dimensions & variables -------------------------------------------------
    def dims(self, grpid: int) -> Dict[str, int]:
        count = ctypes.c_int()
        _check(self._lib.nc_inq_dimids(grpid, ctypes.byref(count), None, 0))
        ids = (ctypes.c_int * count.value)()
        _check(self._lib.nc_inq_dimids(grpid, ctypes.byref(count), ids, 0))
        out: Dict[str, int] = {}
        for dimid in ids:
            buf = ctypes.create_string_buffer(NC_MAX_NAME + 1)
            length = ctypes.c_size_t()
            _check(
                self._lib.nc_inq_dim(grpid, dimid, buf, ctypes.byref(length))
            )
            out[buf.value.decode()] = length.value
        return out

    def var_names(self, grpid: int) -> List[str]:
        count = ctypes.c_int()
        _check(self._lib.nc_inq_varids(grpid, ctypes.byref(count), None))
        ids = (ctypes.c_int * count.value)()
        _check(self._lib.nc_inq_varids(grpid, ctypes.byref(count), ids))
        names = []
        for varid in ids:
            buf = ctypes.create_string_buffer(NC_MAX_NAME + 1)
            _check(self._lib.nc_inq_varname(grpid, varid, buf))
            names.append(buf.value.decode())
        return names

    def var_shape(self, grpid: int, name: str) -> tuple:
        varid = ctypes.c_int()
        _check(
            self._lib.nc_inq_varid(grpid, name.encode(), ctypes.byref(varid))
        )
        ndims = ctypes.c_int()
        _check(
            self._lib.nc_inq_varndims(grpid, varid, ctypes.byref(ndims))
        )
        dimids = (ctypes.c_int * ndims.value)()
        _check(self._lib.nc_inq_vardimid(grpid, varid, dimids))
        shape = []
        for dimid in dimids:
            length = ctypes.c_size_t()
            _check(
                self._lib.nc_inq_dimlen(grpid, dimid, ctypes.byref(length))
            )
            shape.append(length.value)
        return tuple(shape)

    def get_var_double(self, grpid: int, name: str) -> np.ndarray:
        """Read a whole variable as float64 (netCDF converts on read)."""
        varid = ctypes.c_int()
        _check(
            self._lib.nc_inq_varid(grpid, name.encode(), ctypes.byref(varid))
        )
        shape = self.var_shape(grpid, name)
        out = np.empty(shape, dtype=np.float64)
        _check(
            self._lib.nc_get_var_double(
                grpid, varid,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            )
        )
        return out


def read_restart_via_libnetcdf(path: str):
    """Read a restart through libnetcdf into ``restart.RestartFields``.

    The exact counterpart of ``restart.read_restart`` (h5py), so the two
    readers can be diffed file-for-file.
    """
    from .restart import DATA_NODE, STRUCTURE_NODE, TYPE_ATTR, VAR_NAMES_2D
    from .restart import TICE_NAME, RestartFields

    with NetCDFReader(path) as nc:
        structure = nc.group_id(STRUCTURE_NODE.strip("/"))
        stype = nc.get_att_text(structure, TYPE_ATTR)
        data = nc.group_id(DATA_NODE.strip("/"))
        fields = {name: nc.get_var_double(data, name) for name in VAR_NAMES_2D}
        tice = nc.get_var_double(data, TICE_NAME)
    return RestartFields(structure_type=stype, tice=tice, **fields)
