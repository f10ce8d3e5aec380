"""Configurable rectangular grid.

Counterpart of ``nextsimdg_tpu.grid.rectgrid``: DevGrid generalised to an
arbitrary nx x ny x nlayers rectangular grid, structure name
``"rectgrid"``, registered as ``Nextsim::IStructure`` ->
``Nextsim::RectGrid``. The grid shape comes from the restart file when
loading, or from the config keys ``rectgrid.{nx,ny,nlayers}`` when created
empty.
"""

from __future__ import annotations

from ..config import Configured
from ..io.restart import RestartFields
from ..modules import register_implementation
from ..state import zeros_prognostic
from .structure import IStructure


@register_implementation("Nextsim::IStructure", "Nextsim::RectGrid")
class RectGrid(IStructure, Configured):
    structure_name = "rectgrid"

    def __init__(self, nx: int = 0, ny: int = 0, nlayers: int = 1, *, device, dtype) -> None:
        super().__init__(device=device, dtype=dtype)
        self._nx = nx
        self._ny = ny
        self._nlayers = nlayers

    def configure(self) -> None:
        self._nx = int(Configured.get_configuration("rectgrid.nx", self._nx or 128))
        self._ny = int(Configured.get_configuration("rectgrid.ny", self._ny or 128))
        self._nlayers = int(Configured.get_configuration("rectgrid.nlayers", self._nlayers or 1))

    @property
    def nx(self) -> int:
        return self._nx

    @property
    def ny(self) -> int:
        return self._ny

    def n_ice_layers(self) -> int:
        return self._nlayers

    def load_restart(self, fields: RestartFields) -> None:
        self._nx = fields.nx
        self._ny = fields.ny
        self._nlayers = fields.n_ice_layers
        super().load_restart(fields)

    def init_empty(self) -> None:
        if not (self._nx and self._ny):
            self.configure()
        self.prognostic = zeros_prognostic(
            self._nx, self._ny, self._nlayers, device=self.device, dtype=self.dtype
        )
