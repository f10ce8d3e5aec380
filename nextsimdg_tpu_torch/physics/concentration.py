"""Ice concentration evolution.

Counterpart of ``nextsimdg_tpu.physics.concentration``
(``HiblerConcentration``): Hibler '79 freeze (dc = newIce/h0) and melt
(dc = dh c phiM / h_true when thinning and c < 1), the only implementation
of ``Nextsim::IConcentrationModel``. ``h0`` and ``phi_m`` are constructor
arguments and the config keys ``Hibler.{h0,phiM}`` (``configure``).
"""

from __future__ import annotations

import torch

from ..config import Configured
from ..modules import register_implementation
from ..state import safe_div

INTERFACE = "Nextsim::IConcentrationModel"


@register_implementation(INTERFACE, "Nextsim::HiblerConcentration")
class HiblerConcentration(Configured):
    def __init__(self, h0: float = 0.25, phi_m: float = 0.5) -> None:
        self.h0 = h0
        self.phi_m = phi_m

    def configure(self) -> None:
        self.h0 = Configured.get_configuration("Hibler.h0", 0.25)
        self.phi_m = Configured.get_configuration("Hibler.phiM", 0.5)

    def freeze(self, new_ice):
        """dc from new-ice volume spread at thickness h0."""
        return new_ice * (1.0 / self.h0)

    def melt(self, cice, hi_true, hi_true_updated):
        """dc from lateral melt; zero where concentration is already >= 1."""
        del_hi = hi_true_updated - hi_true
        dc = safe_div(del_hi * cice * self.phi_m, hi_true)
        return torch.where(cice >= 1.0, 0.0, dc)
