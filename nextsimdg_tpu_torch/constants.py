"""Physical constants and unit helpers.

A copy of ``nextsimdg_tpu/constants.py`` (the reference constant namespaces
of ``core/src/include/constants.hpp:11-144``): ``PhysicalConstants``,
``Ice``, ``Air``, ``Vapour``, ``Water`` and the unit-conversion helpers.
The port keeps its own copy because it imports nothing of the JAX package.

All values are plain Python floats, so a float32 tensor never promotes.
"""

from __future__ import annotations


class PhysicalConstants:
    """General physical constants of the Earth and universe."""

    #: Standard acceleration due to gravity at the Earth's poles [m s-2]
    #: (WGS 84 ellipsoidal gravity formula at 90 deg latitude).
    g = 9.8321849378
    #: Stefan-Boltzmann constant [W m-2 K-4].
    sigma = 5.670374419e-8
    #: Von Karman constant [1].
    von_karman = 0.4
    #: Rotation rate of the Earth [rad s-1].
    omega = 7.2921158e-5
    #: Triple point temperature of pure water [K].
    Tt = 273.16
    #: Ratio of circumference to radius (2*pi).
    tau = 6.28318530717958647652


class Ice:
    """Properties of water ice around 0 degC and 101.3 kPa."""

    #: Specific heat capacity at constant pressure of water ice [J kg-1 K-1].
    cp = 2100.0
    #: Thermal emissivity of smooth ice [0..1].
    epsilon = 0.996
    #: Heat conductivity of ice [W m-1 K-1].
    kappa = 2.0334
    #: Latent heat of fusion of ice/water [J kg-1].
    Lf = 333.55e3
    #: Density of ice [kg m-3] (NEMO-LIM value).
    rho = 917.0
    #: Density of snow [kg m-3] (NEMO-LIM value).
    rho_snow = 330.0
    #: Salinity of sea ice [g kg-1].
    s = 5.0
    #: Melting point of pure ice [K].
    Tm = 273.15


class Air:
    """Properties of dry air around 0 degC and 101.3 kPa."""

    #: Specific heat capacity at constant pressure of dry air [J kg-1 K-1].
    cp = 1004.64
    #: Specific gas constant for dry air [J kg-1 K-1].
    Ra = 287.058
    #: Density of dry air at IUPAC STP [kg m-3].
    rho = 1.2754


class Vapour:
    """Properties of water vapour."""

    #: Specific heat capacity at constant pressure of water vapour [J kg-1 K-1].
    cp = 1860.0
    #: Latent heat of vaporization at 0 degC [J kg-1].
    Lv0 = 2500.79e3
    #: Specific gas constant for water vapour [J kg-1 K-1].
    Ra = 461.5


class Water:
    """Properties of liquid water."""

    #: Specific heat capacity at constant pressure of water [J kg-1 K-1].
    cp = 4186.84
    #: Latent heat of fusion of water/ice [J kg-1].
    Lf = Ice.Lf
    #: Latent heat of vaporization at 0 degC [J kg-1].
    Lv0 = Vapour.Lv0
    #: Salinity / freezing-point-depression proportionality [K psu-1].
    mu = 0.055
    #: Density of fresh water at 4 degC [kg m-3].
    rho = 1000.0
    #: Typical density of ocean water [kg m-3].
    rho_ocean = 1025.0
    #: Freezing point of pure water [K].
    Tf = Ice.Tm
    #: Freezing point of typical ocean water [degC].
    Tf_ocean = -1.8


def kelvin(celsius_value):
    """Convert a temperature from degC to K."""
    return celsius_value + Water.Tf


def celsius(kelvin_value):
    """Convert a temperature from K to degC."""
    return kelvin_value - Water.Tf


def degrees(radians_value):
    """Convert an angle from radians to degrees."""
    return radians_value * 360.0 / PhysicalConstants.tau


def radians(degrees_value):
    """Convert an angle from degrees to radians."""
    return degrees_value * PhysicalConstants.tau / 360.0


def mbar(pascals_value):
    """Convert a pressure from Pa to mbar."""
    return pascals_value / 100.0


def pascals(mbar_value):
    """Convert a pressure from mbar to Pa."""
    return mbar_value * 100.0
