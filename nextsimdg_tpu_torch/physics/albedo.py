"""Ice/snow surface albedo.

Counterpart of ``nextsimdg_tpu.physics.albedo`` (interface
``Nextsim::IIceAlbedo``; ``SMUIceAlbedo.cpp``, ``SMU2IceAlbedo.cpp``,
``CCSMIceAlbedo.cpp``), registered in the reference's order, SMU the
default. ``CCSMIceAlbedo``'s two base albedos are constructor arguments and
the config keys ``CCSMIceAlbedo.{iceAlbedo,snowAlbedo}`` (``configure``).
"""

from __future__ import annotations

import torch

from ..config import Configured
from ..modules import register_implementation

INTERFACE = "Nextsim::IIceAlbedo"

_SMU_ICE_ALBEDO = 0.64
_SMU_SNOW_ALBEDO = 0.85


def _bare_ice(snow_thickness, i0):
    """The SMU bare-ice albedo with the I0 term, as a plane of the snow
    plane's dtype (i0 is a float)."""
    return torch.full_like(snow_thickness, _SMU_ICE_ALBEDO + 0.4 * (1.0 - _SMU_ICE_ALBEDO) * i0)


@register_implementation(INTERFACE, "Nextsim::SMUIceAlbedo")
class SMUIceAlbedo:
    """Semtner 76 / Maykut & Untersteiner 71 constant albedos with I0 term."""

    def albedo(self, temperature, snow_thickness, i0):
        return torch.where(snow_thickness > 0.0, _SMU_SNOW_ALBEDO, _bare_ice(snow_thickness, i0))


@register_implementation(INTERFACE, "Nextsim::SMU2IceAlbedo")
class SMU2IceAlbedo:
    """SMU with a linear snow-depth ramp over 0.2 m."""

    def albedo(self, temperature, snow_thickness, i0):
        ramp = torch.clamp(
            _SMU_ICE_ALBEDO + (_SMU_SNOW_ALBEDO - _SMU_ICE_ALBEDO) * snow_thickness / 0.2,
            max=_SMU_SNOW_ALBEDO,
        )
        return torch.where(snow_thickness > 0.0, ramp, _bare_ice(snow_thickness, i0))


@register_implementation(INTERFACE, "Nextsim::CCSMIceAlbedo")
class CCSMIceAlbedo(Configured):
    """CCSM3 scheme: temperature decay above -1 degC, snow-fraction blend."""

    ICE_ALBEDO0 = 0.538
    SNOW_ALBEDO0 = 0.8256

    def __init__(self, ice_albedo: float = ICE_ALBEDO0, snow_albedo: float = SNOW_ALBEDO0):
        self.ice_albedo = ice_albedo
        self.snow_albedo = snow_albedo

    def configure(self) -> None:
        """Read ``CCSMIceAlbedo.{iceAlbedo,snowAlbedo}`` (``CCSMIceAlbedo.cpp:38-42``)."""
        self.ice_albedo = Configured.get_configuration("CCSMIceAlbedo.iceAlbedo", self.ICE_ALBEDO0)
        self.snow_albedo = Configured.get_configuration("CCSMIceAlbedo.snowAlbedo", self.SNOW_ALBEDO0)

    def albedo(self, temperature, snow_thickness, i0):
        t_limit = -1.0
        ice_albedo_t = self.ice_albedo - torch.clamp(0.075 * (temperature - t_limit), min=0.0)
        snow_albedo_t = self.snow_albedo - torch.clamp(0.124 * (temperature - t_limit), min=0.0)
        snow_cover = snow_thickness / (snow_thickness + 0.02)
        return snow_cover * snow_albedo_t + (1.0 - snow_cover) * ice_albedo_t
