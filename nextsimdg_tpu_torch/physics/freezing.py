"""Seawater freezing point.

Counterpart of ``nextsimdg_tpu.physics.freezing`` (interface
``Nextsim::IFreezingPoint``): ``LinearFreezing``, the default, and
``UnescoFreezing``, registered in the reference's order.
"""

from __future__ import annotations

import torch

from ..constants import Water
from ..modules import register_implementation

INTERFACE = "Nextsim::IFreezingPoint"


@register_implementation(INTERFACE, "Nextsim::LinearFreezing")
class LinearFreezing:
    """T_f = -mu * S (mu > 0, so the freezing point is below zero) [degC]."""

    def __call__(self, sss):
        return -Water.mu * sss


@register_implementation(INTERFACE, "Nextsim::UnescoFreezing")
class UnescoFreezing:
    """Fofonoff & Millard (UNESCO tech. papers 44, 1983) polynomial [degC]."""

    A0 = -0.0575
    A1 = +1.710523e-3
    A2 = -2.154996e-4
    B = -7.53e-4

    def __call__(self, sss):
        p0 = 0.0  # zero hydrostatic pressure
        return sss * (self.A0 + self.A1 * torch.sqrt(sss) + self.A2 * sss) + self.B * p0
