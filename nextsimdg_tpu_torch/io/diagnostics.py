"""Periodic diagnostic field output.

The port's copy of ``nextsimdg_tpu.io.diagnostics``, with the same file
layout: an HDF5 file with a ``time`` dataset and one dataset per field,
each of shape (n_times, nx, ny) at the field's own dtype, the time axis
unlimited; a write appends one time slice. The writer takes host arrays
(numpy, or anything ``np.asarray`` converts); the coupled CLI fetches the
fields from the card before it writes. h5py is imported when a file is
opened, so the package imports where it is not installed.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

DEFAULT_FIELDS = ("hice", "cice", "hsnow", "sst", "sss")


class DiagnosticWriter:
    def __init__(self, path: str, field_names: Sequence[str] = DEFAULT_FIELDS) -> None:
        self.path = path
        self.field_names = tuple(field_names)
        self._file = None

    def _ensure_open(self, arrays):
        if self._file is None:
            import h5py

            self._file = h5py.File(self.path, "w")
            self._file.create_dataset("time", shape=(0,), maxshape=(None,), dtype="f8")
            for name in self.field_names:
                arr = arrays[name]
                self._file.create_dataset(
                    name, shape=(0, *arr.shape), maxshape=(None, *arr.shape),
                    dtype=arr.dtype, chunks=(1, *arr.shape),
                )
        return self._file

    def write(self, time: float, fields) -> None:
        """Append one time slice; ``fields`` maps name -> (nx, ny) array."""
        arrays = {name: np.asarray(fields[name]) for name in self.field_names}
        handle = self._ensure_open(arrays)
        n = handle["time"].shape[0]
        handle["time"].resize((n + 1,))
        handle["time"][n] = time
        for name, arr in arrays.items():
            ds = handle[name]
            ds.resize((n + 1, *arr.shape))
            ds[n] = arr
        handle.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "DiagnosticWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_diagnostics(path: str) -> dict:
    """A diagnostics file as {name: array}, ``time`` included."""
    import h5py

    with h5py.File(path, "r") as handle:
        return {key: np.asarray(handle[key]) for key in handle}
