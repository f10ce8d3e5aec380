"""Specific humidity over water, sea water and ice.

Counterpart of ``nextsimdg_tpu.physics.humidity``
(``NextsimPhysics::SpecificHumidity``/``SpecificHumidityIce``): saturation
vapour pressure with salinity correction, enhancement factor, specific
humidity and its analytic temperature derivative over ice.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

#: Ratio of gas constants (dry air / water vapour), the 0.62197 of the reference.
ALPHA = 0.62197
BETA = 1.0 - ALPHA


@dataclass(frozen=True)
class HumidityCoefficients:
    a: float
    b: float
    c: float
    d: float
    big_a: float
    big_b: float
    big_c: float

    def est(self, temperature, salinity):
        """Saturation vapour pressure factor with salinity correction."""
        sal_factor = 1.0 - 5.37e-4 * salinity
        return (
            self.a
            * torch.exp((self.b - temperature / self.d) * temperature / (temperature + self.c))
            * sal_factor
        )

    def f(self, temperature, pressure_pa):
        """Enhancement factor (pressure in Pa, converted to mbar)."""
        pressure_mb = pressure_pa * 0.01
        return 1.0 + self.big_a + pressure_mb * (
            self.big_b + self.big_c * temperature * temperature
        )

    def specific_humidity(self, temperature, pressure, salinity=0.0):
        est = self.est(temperature, salinity)
        f = self.f(temperature, pressure)
        return ALPHA * f * est / (pressure - BETA * f * est)

    def dq_dt(self, temperature, pressure):
        """Analytic d(specific humidity)/dT at zero salinity."""
        df_dt = 2.0 * self.big_c * self.big_b * temperature
        numerator = self.b * self.c * self.d - temperature * (2.0 * self.c + temperature)
        denominator = self.d * (self.c + temperature) ** 2
        est = self.est(temperature, 0.0)
        f = self.f(temperature, pressure)
        dest_dt = numerator / denominator * est
        numerator2 = ALPHA * pressure * (f * dest_dt + est * df_dt)
        denominator2 = (pressure - BETA * est * f) ** 2
        return numerator2 / denominator2


#: Coefficients over (sea) water (NextsimPhysics.cpp:313).
WATER = HumidityCoefficients(6.1121e2, 18.729, 257.87, 227.3, 7.2e-4, 3.20e-6, 5.9e-10)
#: Coefficients over ice (NextsimPhysics.cpp:336).
ICE = HumidityCoefficients(6.1115e2, 23.036, 279.82, 333.7, 2.2e-4, 3.83e-6, 6.4e-10)


def spec_hum_water(temperature, pressure, salinity=0.0):
    return WATER.specific_humidity(temperature, pressure, salinity)


def spec_hum_ice(temperature, pressure):
    return ICE.specific_humidity(temperature, pressure, 0.0)


def dq_dt_ice(temperature, pressure):
    return ICE.dq_dt(temperature, pressure)
