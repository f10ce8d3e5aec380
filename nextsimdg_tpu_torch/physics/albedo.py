"""Ice/snow surface albedo.

Counterpart of ``nextsimdg_tpu.physics.albedo`` (interface
``Nextsim::IIceAlbedo``): ``SMUIceAlbedo``, the default, and
``CCSMIceAlbedo``, whose two base albedos are constructor arguments here
(config keys ``CCSMIceAlbedo.{iceAlbedo,snowAlbedo}`` in the reference).
"""

from __future__ import annotations

import torch

_SMU_ICE_ALBEDO = 0.64
_SMU_SNOW_ALBEDO = 0.85


class SMUIceAlbedo:
    """Semtner 76 / Maykut & Untersteiner 71 constant albedos with I0 term."""

    def albedo(self, temperature, snow_thickness, i0):
        bare_ice = _SMU_ICE_ALBEDO + 0.4 * (1.0 - _SMU_ICE_ALBEDO) * i0
        # i0 is a float, so both branches are scalars: the result takes the
        # dtype of the snow plane.
        return torch.where(
            snow_thickness > 0.0, _SMU_SNOW_ALBEDO, torch.full_like(snow_thickness, bare_ice)
        )


class CCSMIceAlbedo:
    """CCSM3 scheme: temperature decay above -1 degC, snow-fraction blend."""

    ICE_ALBEDO0 = 0.538
    SNOW_ALBEDO0 = 0.8256

    def __init__(self, ice_albedo: float = ICE_ALBEDO0, snow_albedo: float = SNOW_ALBEDO0):
        self.ice_albedo = ice_albedo
        self.snow_albedo = snow_albedo

    def albedo(self, temperature, snow_thickness, i0):
        t_limit = -1.0
        ice_albedo_t = self.ice_albedo - torch.clamp(0.075 * (temperature - t_limit), min=0.0)
        snow_albedo_t = self.snow_albedo - torch.clamp(0.124 * (temperature - t_limit), min=0.0)
        snow_cover = snow_thickness / (snow_thickness + 0.02)
        return snow_cover * snow_albedo_t + (1.0 - snow_cover) * ice_albedo_t
