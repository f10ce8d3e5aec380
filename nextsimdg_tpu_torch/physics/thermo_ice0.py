"""Semtner zero-layer slab thermodynamics, masked-tensor form.

Counterpart of ``nextsimdg_tpu.physics.thermo_ice0`` (``ThermoIce0``,
``ThermoIce0.cpp:34-133``) as straight-line tensor arithmetic: the zero-ice
early return becomes a final select, the flooding and full-melt branches
become masks. The first implementation of ``Nextsim::IThermodynamics``.
``k_s`` and ``do_flooding`` are constructor arguments and the config keys
``thermoice0.{ks,flooding}`` (``configure``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import Configured
from ..constants import Ice, Water
from ..modules import register_implementation
from ..state import safe_div

INTERFACE = "Nextsim::IThermodynamics"

#: Freezing point of sea ice [degC]: -mu * s_ice (ThermoIce0.cpp:38).
FREEZING_POINT_ICE = -Water.mu * Ice.s


@dataclass(frozen=True)
class SlabUpdate:
    """Outputs of the slab calculation."""

    hi_true: torch.Tensor  #: updated true ice thickness [m]
    hs_true: torch.Tensor  #: updated true snow thickness [m]
    t_surf: torch.Tensor  #: updated ice surface temperature [degC]
    q_io: torch.Tensor  #: ice-ocean heat flux incl. full-melt latent heat
    h_ice_from_snow: torch.Tensor  #: ice formed by flooded snow [m]
    #: Interior layer temperatures (multi-layer schemes; None for 0-layer).
    t_layers: tuple = None


@register_implementation(INTERFACE, "Nextsim::ThermoIce0")
class ThermoIce0(Configured):
    def __init__(self, k_s: float = 0.3096, do_flooding: bool = True) -> None:
        self.k_s = k_s
        self.do_flooding = do_flooding

    def configure(self) -> None:
        self.k_s = Configured.get_configuration("thermoice0.ks", 0.3096)
        self.do_flooding = Configured.get_configuration("thermoice0.flooding", True)

    def calculate(
        self, *, hice, cice, hi_true, hs_true, tice0, t_bot, q_ia, dq_dt, q_io,
        subl, snowfall, dt, min_thickness,
        **_unused,  # multi-layer args (tice1, tice2) of other schemes
    ) -> SlabUpdate:
        bulk_lh_snow = Water.Lf * Ice.rho_snow
        bulk_lh_ice = Water.Lf * Ice.rho

        no_ice = (hice == 0.0) | (cice == 0.0)

        # Conduction through the combined ice+snow slab (ThermoIce0.cpp:57-63).
        slab_den = self.k_s * hi_true + Ice.kappa * hs_true
        k_l_slab = safe_div(torch.full_like(hi_true, self.k_s * Ice.kappa), slab_den)
        q_conduction = k_l_slab * (t_bot - tice0)
        remaining_flux = q_conduction - q_ia
        t_surf = tice0 + remaining_flux / (k_l_slab + dq_dt)

        # Clamp to the melting point of ice or snow (:66-68).
        melting_limit = torch.where(
            hs_true > 0.0, 0.0, torch.full_like(t_surf, FREEZING_POINT_ICE)
        )
        t_surf = torch.minimum(melting_limit, t_surf)

        # Top melt: snow melts first, excess flux melts ice (:71-81).
        snow_melt_rate = torch.clamp(-remaining_flux, max=0.0) / bulk_lh_snow
        snow_subl_rate = subl / Ice.rho_snow
        hs_new = hs_true + (snow_melt_rate - snow_subl_rate) * dt
        excess_ice_melt = torch.clamp(hs_new, max=0.0) * bulk_lh_snow / bulk_lh_ice
        hs_new = torch.clamp(hs_new, min=0.0)
        hs_new = hs_new + snowfall * dt / Ice.rho_snow

        # Bottom growth/melt from conduction minus ocean heat (:84-88).
        ice_bottom_change = (q_conduction - q_io) * dt / bulk_lh_ice
        hi_new = hi_true + excess_ice_melt + ice_bottom_change

        # Snow-ice conversion by flooding (:94-106).
        draught = (hi_new * Ice.rho + hs_new * Ice.rho_snow) / Water.rho_ocean
        flood = (draught > hi_new) & self.do_flooding
        new_ice_from_snow = torch.where(flood, draught - hi_new, 0.0)
        hi_new = torch.where(flood, draught, hi_new)
        hs_new = hs_new - new_ice_from_snow * Ice.rho / Ice.rho_snow
        h_ice_from_snow = new_ice_from_snow

        # Full melt below the minimum thickness (:108-132): all remaining
        # latent heat goes to the ocean and the state zeroes out.
        full_melt = hi_new < min_thickness
        delta_q_io = (hi_new * bulk_lh_ice + hs_new * bulk_lh_snow) / dt
        q_io_new = torch.where(full_melt, q_io + delta_q_io, q_io)
        h_ice_from_snow = torch.where(full_melt, 0.0, h_ice_from_snow)
        hi_new = torch.where(full_melt, 0.0, hi_new)
        hs_new = torch.where(full_melt, 0.0, hs_new)
        t_surf = torch.where(full_melt, FREEZING_POINT_ICE, t_surf)

        # Zero-ice early return (:45-51): thickness/temperature reset, and the
        # flux/flooding updates of the main path do not happen.
        return SlabUpdate(
            hi_true=torch.where(no_ice, 0.0, hi_new),
            hs_true=torch.where(no_ice, 0.0, hs_new),
            t_surf=torch.where(no_ice, FREEZING_POINT_ICE, t_surf),
            q_io=torch.where(no_ice, q_io, q_io_new),
            h_ice_from_snow=torch.where(no_ice, 0.0, h_ice_from_snow),
        )
