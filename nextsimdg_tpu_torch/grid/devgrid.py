"""The development 10x10 grid.

Counterpart of ``nextsimdg_tpu.grid.devgrid`` (``DevGrid``,
``core/src/modules/DevGrid.cpp``): fixed 10x10 elements, one ice layer,
structure name ``"devgrid"``, registered as ``Nextsim::IStructure`` ->
``Nextsim::DevGrid``.
"""

from __future__ import annotations

from ..modules import register_implementation
from ..state import zeros_prognostic
from .structure import IStructure


@register_implementation("Nextsim::IStructure", "Nextsim::DevGrid")
class DevGrid(IStructure):
    structure_name = "devgrid"

    NX = 10  #: DevGrid.cpp:20
    N_ICE_LAYERS = 1  #: DevGrid.hpp:49

    @property
    def nx(self) -> int:
        return self.NX

    @property
    def ny(self) -> int:
        return self.NX

    def n_ice_layers(self) -> int:
        return self.N_ICE_LAYERS

    def init_empty(self) -> None:
        self.prognostic = zeros_prognostic(
            self.nx, self.ny, self.N_ICE_LAYERS, device=self.device, dtype=self.dtype
        )
