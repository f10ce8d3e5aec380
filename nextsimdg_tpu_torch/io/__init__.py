"""Restart I/O (h5py, imported when a file is opened)."""

from .restart import (
    RestartFields, read_restart, read_structure_type, write_restart, write_restart_fields,
)

__all__ = [
    "RestartFields", "read_restart", "write_restart", "write_restart_fields", "read_structure_type",
]
