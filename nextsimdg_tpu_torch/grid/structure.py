"""Abstract model structure.

Counterpart of ``nextsimdg_tpu.grid.structure`` (``IStructure``,
``core/src/modules/include/IStructure.hpp:32-137``): a structure owns the
structure-of-arrays ``PrognosticState`` and ``Forcing`` tensors of its grid
and their restart I/O, and matches its structure name case-insensitively.

The JAX structure takes its dtype from ``jax_enable_x64``; the port's takes
the ``device`` and ``dtype`` of its tensors from the caller, with no
default, as ``state.zeros_prognostic`` and ``state.dummy_forcing`` do.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..io.restart import RestartFields, read_restart, write_restart_fields
from ..state import Forcing, PrognosticState


def prognostic_from_restart(fields: RestartFields, *, device, dtype) -> PrognosticState:
    """The prognostic state of a restart's arrays (file layout x, y[, layer];
    in memory the layer axis leads)."""
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return PrognosticState(
        hice=as_t(fields.hice),
        cice=as_t(fields.cice),
        hsnow=as_t(fields.hsnow),
        sst=as_t(fields.sst),
        sss=as_t(fields.sss),
        tice=as_t(np.moveaxis(fields.tice, 2, 0)).contiguous(),
    )


def restart_from_prognostic(prog: PrognosticState, structure_type: str) -> RestartFields:
    """The float64 restart arrays of a prognostic state, fetched to the host
    in one copy."""
    planes = (prog.hice, prog.cice, prog.hsnow, prog.sst, prog.sss)
    flat = torch.cat([p.reshape(-1) for p in (*planes, prog.tice)])
    host = flat.to("cpu", torch.float64).numpy()
    n = prog.hice.numel()
    fields = {
        name: host[i * n:(i + 1) * n].reshape(prog.hice.shape)
        for i, name in enumerate(("hice", "cice", "hsnow", "sst", "sss"))
    }
    tice = host[5 * n:].reshape(prog.tice.shape)
    return RestartFields(structure_type=structure_type, tice=np.moveaxis(tice, 0, 2), **fields)


class IStructure:
    """Base class: grid geometry + model state + restart I/O."""

    #: Structure name written to / matched against ``/structure@type``.
    structure_name: str = ""

    def __init__(self, *, device, dtype) -> None:
        self.device = torch.device(device)
        self.dtype = dtype
        self.prognostic: Optional[PrognosticState] = None
        self.forcing: Optional[Forcing] = None

    # -- naming (IStructure.hpp:55-58) --------------------------------------
    @classmethod
    def handles_structure_name(cls, name: str) -> bool:
        """Case-insensitive match against this structure's name."""
        return name.lower() == cls.structure_name.lower()

    # -- geometry ------------------------------------------------------------
    @property
    def nx(self) -> int:
        raise NotImplementedError

    @property
    def ny(self) -> int:
        raise NotImplementedError

    def n_ice_layers(self) -> int:
        raise NotImplementedError

    # -- restart I/O ---------------------------------------------------------
    def init(self, file_path: str) -> None:
        """Initialise state; from the restart file if a path is given."""
        if file_path:
            self.load_restart(read_restart(file_path))
        else:
            self.init_empty()

    def init_empty(self) -> None:
        raise NotImplementedError

    def load_restart(self, fields: RestartFields) -> None:
        """Populate the prognostic state from restart arrays."""
        self.prognostic = prognostic_from_restart(fields, device=self.device, dtype=self.dtype)

    def restart_fields(self) -> RestartFields:
        """The prognostic state as float64 restart arrays, fetched to the
        host in one copy."""
        return restart_from_prognostic(self.prognostic, self.structure_name)

    def dump(self, file_path: str) -> None:
        """Write the prognostic state as a restart file."""
        write_restart_fields(file_path, self.restart_fields())
