"""ctypes binding of the native asynchronous forcing engine.

The port's copy of ``nextsimdg_tpu.io.forcing_pipeline``: a background C++
thread (``native/forcing_engine.cpp``, the JAX package's engine, unchanged)
fills a ring of buffers with each step's forcing fields, so making the
forcing overlaps with the card's work. See the source's header comment for
the modes and the buffer layout.

The library is built from that source at first use, into the port's build
directory (``build/nextsimdg_tpu_torch/``, beside the CUDA kernels), under
a name that carries a digest of the source, the compiler flags and the
instruction set that ``-march=native`` selects on this host; a build
writes a file of its own and renames it into place, so concurrent builds
(processes or threads) never load a half-written library. A failed build
or load raises; there is no Python generator in its place.

Usage::

    pipe = ForcingPipeline.cyclone(nx, ny, dx, dy, vmax_atm=30.0, ...)
    for _ in range(n_steps):
        fields = pipe.next_fields()       # dict of (nx, ny) float64 arrays
        ...copy to the card...
    pipe.close()
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import numpy as np

from ..dynamics.kernels.coupled_cuda import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "forcing_engine.cpp"
#: native/Makefile's flags, less its warnings.
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared", "-pthread")

#: mode-1 field order (matches forcing_engine.cpp fill()).
CYCLONE_FIELDS = ("u_atm", "v_atm", "u_ocean", "v_ocean")

_lib = None
# Threads of one process build and load once.
_lock = threading.RLock()


def _compiler() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("no C++ compiler: the forcing engine needs g++ to build")
    return found


@functools.lru_cache(maxsize=None)
def _target(cxx: str) -> str:
    """The compiler's predefined macros under -march=native: they name the
    instruction set that this host's build uses."""
    return subprocess.run(
        [cxx, "-march=native", "-dM", "-E", "-x", "c++", os.devnull],
        capture_output=True, text=True, check=True,
    ).stdout


def library_path() -> Path:
    """Where the engine of the current source, flags and host instruction
    set is built (a library built for another host is not reused)."""
    cxx = _compiler()
    digest = hashlib.sha256(" ".join((cxx,) + CXX_FLAGS).encode())
    digest.update("\n".join(sorted(_target(cxx).splitlines())).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libforcing_engine_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the engine unless the library of this source exists."""
    with _lock:
        path = library_path()
        if path.exists():
            return path
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        done = subprocess.run(
            [_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True,
        )
        if done.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building the forcing engine failed:\n{done.stdout}{done.stderr}")
        os.replace(tmp, path)
        return path


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.fe_create.restype = ctypes.c_void_p
        lib.fe_create.argtypes = [ctypes.c_int64] * 4
        lib.fe_start_constant.restype = None
        lib.fe_start_constant.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
        lib.fe_start_cyclone.restype = None
        lib.fe_start_cyclone.argtypes = [ctypes.c_void_p] + [ctypes.c_double] * 9
        lib.fe_start_file.restype = ctypes.c_int
        lib.fe_start_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.fe_acquire.restype = ctypes.c_int
        lib.fe_acquire.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        for name in ("fe_release", "fe_stop", "fe_destroy"):
            getattr(lib, name).restype = None
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class ForcingPipeline:
    def __init__(self, nx: int, ny: int, field_names, n_buffers: int = 3) -> None:
        self._lib = _load()
        self._nx, self._ny = nx, ny
        self._field_names = tuple(field_names)
        self._handle = self._lib.fe_create(nx, ny, len(self._field_names), n_buffers)
        self._open = True
        self._held = False

    # -- constructors --------------------------------------------------------
    @classmethod
    def constant(cls, nx: int, ny: int, values: Dict[str, float], n_buffers: int = 3):
        pipe = cls(nx, ny, list(values), n_buffers)
        arr = (ctypes.c_double * len(values))(*values.values())
        pipe._lib.fe_start_constant(pipe._handle, arr)
        return pipe

    @classmethod
    def cyclone(
        cls, nx: int, ny: int, dx: float, dy: float, *,
        vmax_atm: float = 30.0, r0: float = 100e3, period: float = 4 * 86400.0,
        vmax_ocean: float = 0.1, dt: float = 600.0, n_buffers: int = 3,
    ):
        """The moving-cyclone benchmark forcing (CG node fields)."""
        pipe = cls(nx, ny, CYCLONE_FIELDS, n_buffers)
        pipe._lib.fe_start_cyclone(
            pipe._handle, dx, dy, nx * dx, ny * dy, vmax_atm, r0, period, vmax_ocean, dt,
        )
        return pipe

    @classmethod
    def from_file(cls, path: str, field_names, loop: bool = False, n_buffers: int = 3):
        """Stream per-step forcing records from a binary NXFT file
        (``write_forcing_file``); the producer thread reads ``n_buffers``
        records ahead of the model."""
        nx, ny, n_fields, _ = read_forcing_file_header(path)
        if n_fields != len(tuple(field_names)):
            raise ValueError(f"file has {n_fields} fields, caller named {len(tuple(field_names))}")
        pipe = cls(nx, ny, field_names, n_buffers)
        rc = pipe._lib.fe_start_file(pipe._handle, path.encode(), int(loop))
        if rc != 0:
            raise ValueError(f"bad forcing file {path!r} (code {rc})")
        return pipe

    # -- consumption ---------------------------------------------------------
    def next_fields(self) -> Dict[str, np.ndarray]:
        """Block until the next step's fields are ready; return copies
        (float64, (nx, ny)) and the step under ``"_step"``. The engine's
        buffer is recycled at the next call, keeping the producer
        ``n_buffers`` steps ahead."""
        if self._held:
            self._lib.fe_release(self._handle)
            self._held = False
        data = ctypes.POINTER(ctypes.c_double)()
        step = ctypes.c_int64()
        if not self._lib.fe_acquire(self._handle, ctypes.byref(data), ctypes.byref(step)):
            raise RuntimeError("forcing engine stopped")
        plane = self._nx * self._ny
        n = len(self._field_names)
        raw = np.ctypeslib.as_array(data, shape=(n * plane,))
        self._held = True
        out = {
            name: raw[f * plane: (f + 1) * plane].reshape(self._nx, self._ny).copy()
            for f, name in enumerate(self._field_names)
        }
        out["_step"] = int(step.value)
        return out

    def close(self) -> None:
        if self._open:
            self._lib.fe_stop(self._handle)
            self._lib.fe_destroy(self._handle)
            self._open = False

    def __enter__(self) -> "ForcingPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass


_NXFT_MAGIC = 0x4E584654


def write_forcing_file(path: str, steps) -> None:
    """Write a binary NXFT forcing file.

    ``steps``: per-step dicts or sequences of (nx, ny) arrays, all of one
    shape and field count. Format: a header of 5 int64 (magic 'NXFT', nx,
    ny, n_fields, n_steps), then the float64 planes in order.
    """
    steps = list(steps)
    first = steps[0]
    arrays0 = list(first.values()) if isinstance(first, dict) else list(first)
    nx, ny = arrays0[0].shape
    n_fields = len(arrays0)
    with open(path, "wb") as handle:
        np.asarray([_NXFT_MAGIC, nx, ny, n_fields, len(steps)], dtype=np.int64).tofile(handle)
        for step in steps:
            arrays = list(step.values()) if isinstance(step, dict) else list(step)
            for arr in arrays:
                np.asarray(arr, dtype=np.float64).reshape(nx, ny).tofile(handle)


def read_forcing_file_header(path: str):
    """(nx, ny, n_fields, n_steps) of an NXFT file."""
    header = np.fromfile(path, dtype=np.int64, count=5)
    if len(header) != 5 or header[0] != _NXFT_MAGIC:
        raise ValueError(f"not an NXFT forcing file: {path!r}")
    return int(header[1]), int(header[2]), int(header[3]), int(header[4])
