"""Ice-ocean heat flux.

Counterpart of ``nextsimdg_tpu.physics.ice_ocean_heat_flux``
(``BasicIceOceanHeatFlux``): relaxation of the mixed layer to the freezing
point over one timestep.
"""

from __future__ import annotations

from ..modules import register_implementation

INTERFACE = "Nextsim::IIceOceanHeatFlux"


@register_implementation(INTERFACE, "Nextsim::BasicIceOceanHeatFlux")
class BasicIceOceanHeatFlux:
    def flux(self, sst, freezing_point, mixed_layer_bulk_heat_capacity, dt):
        """Qio = (SST - T_freeze) * (mld rho cp) / dt [W m-2]."""
        return (sst - freezing_point) * mixed_layer_bulk_heat_capacity / dt
