"""Model state of the column physics, as tensors.

Counterpart of ``nextsimdg_tpu.state``: one tensor per field over the whole
grid (structure of arrays). 2-D fields are ``(nx, ny)``; layered fields are
``(nlayers, nx, ny)`` with the layer dim leading.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .constants import Water


@dataclass(frozen=True)
class PrognosticState:
    """Fields carried across timesteps (cf. ``PrognosticData.hpp:89-96``).

    ``hice`` and ``hsnow`` are *effective* (cell-mean) thicknesses; the
    per-ice-area "true" thicknesses are derived.
    """

    hice: torch.Tensor  #: effective ice thickness [m], (nx, ny)
    cice: torch.Tensor  #: ice concentration [1], (nx, ny)
    hsnow: torch.Tensor  #: effective snow thickness [m], (nx, ny)
    sst: torch.Tensor  #: sea surface temperature [degC], (nx, ny)
    sss: torch.Tensor  #: sea surface salinity [psu], (nx, ny)
    tice: torch.Tensor  #: ice temperatures [degC], (nlayers, nx, ny)

    @property
    def n_ice_layers(self) -> int:
        return self.tice.shape[0]

    @property
    def shape(self):
        return tuple(self.hice.shape)

    def ice_true_thickness(self) -> torch.Tensor:
        """True ice thickness: hice/cice, zero where there is no ice."""
        return safe_div(self.hice, self.cice)

    def snow_true_thickness(self) -> torch.Tensor:
        """True snow thickness over the ice-covered fraction."""
        return safe_div(self.hsnow, self.cice)


@dataclass(frozen=True)
class Forcing:
    """External forcing per element (cf. ``ExternalData.hpp:22-76``);
    ``wind`` is the 10 m wind speed."""

    tair: torch.Tensor  #: 2 m air temperature [degC]
    dew2m: torch.Tensor  #: 2 m dew point temperature [degC]
    pair: torch.Tensor  #: sea level air pressure [Pa]
    sw_in: torch.Tensor  #: incoming shortwave flux [W m-2]
    lw_in: torch.Tensor  #: incoming longwave flux [W m-2]
    mld: torch.Tensor  #: ocean mixed layer depth [m]
    snowfall: torch.Tensor  #: snowfall rate [kg m-2 s-1]
    wind: torch.Tensor  #: wind speed [m s-1]

    def mixed_layer_bulk_heat_capacity(self) -> torch.Tensor:
        """Areal mixed-layer heat capacity mld*rho_ocean*cp [J K-1 m-2]."""
        return self.mld * Water.rho_ocean * Water.cp


@dataclass(frozen=True)
class PhysicsDiagnostics:
    """Per-step physics fluxes and rates. Only ``new_ice`` is carried
    across steps (the reference overwrites ``m_newice`` only in the
    freezing branch)."""

    evap: torch.Tensor  #: open-water evaporation rate [kg m-2 s-1]
    subl: torch.Tensor  #: sublimation rate [kg m-2 s-1]
    q_ow: torch.Tensor  #: net open-water heat flux [W m-2]
    q_ia: torch.Tensor  #: net ice-atmosphere heat flux [W m-2]
    q_io: torch.Tensor  #: ice-ocean heat flux [W m-2]
    dq_dt: torch.Tensor  #: d(q_ia)/d(T_surf) [W m-2 K-1]
    drag_pressure: torch.Tensor  #: wind drag pressure [Pa]
    new_ice: torch.Tensor  #: new-ice volume formed from supercooling [m]
    h_ice_from_snow: torch.Tensor  #: ice formed by flooded snow [m]


class PrognosticBuilder:
    """Fluent builder for prognostic states: each setter takes a scalar
    (broadcast over the grid) or a full array; ``build()`` assembles the
    :class:`PrognosticState`. The caller names the device and dtype."""

    def __init__(self, nx: int, ny: int, nlayers: int = 1, *, device, dtype):
        self._nx, self._ny, self._nlayers = nx, ny, nlayers
        self._dtype, self._device = dtype, device
        self._fields = {"hice": 0.0, "cice": 0.0, "hsnow": 0.0, "sst": 0.0, "sss": 0.0}
        self._tice = 0.0

    def hice(self, value):
        self._fields["hice"] = value
        return self

    def cice(self, value):
        self._fields["cice"] = value
        return self

    def hsnow(self, value):
        self._fields["hsnow"] = value
        return self

    def sst(self, value):
        self._fields["sst"] = value
        return self

    def sss(self, value):
        self._fields["sss"] = value
        return self

    def tice(self, value):
        """Ice temperatures: scalar, (nlayers,) or (nlayers, nx, ny)."""
        self._tice = value
        return self

    def _tensor(self, value):
        return torch.as_tensor(value, dtype=self._dtype, device=self._device)

    def build(self) -> PrognosticState:
        shape = (self._nx, self._ny)
        to_field = lambda v: self._tensor(v).expand(shape).clone()
        tice = self._tensor(self._tice)
        if tice.ndim == 0:
            tice = tice.expand((self._nlayers, *shape))
        elif tice.ndim == 1:
            tice = tice[:, None, None].expand((tice.shape[0], *shape))
        return PrognosticState(
            hice=to_field(self._fields["hice"]),
            cice=to_field(self._fields["cice"]),
            hsnow=to_field(self._fields["hsnow"]),
            sst=to_field(self._fields["sst"]),
            sss=to_field(self._fields["sss"]),
            tice=tice.clone(),
        )


def safe_div(num, den):
    """num/den where den != 0, else 0."""
    nonzero = den != 0
    return torch.where(nonzero, num / torch.where(nonzero, den, 1.0), 0.0)


def zeros_prognostic(nx: int, ny: int, nlayers: int = 1, *, device, dtype):
    """An all-zero prognostic state of the given grid size."""
    f2 = lambda: torch.zeros((nx, ny), dtype=dtype, device=device)
    return PrognosticState(
        hice=f2(), cice=f2(), hsnow=f2(), sst=f2(), sss=f2(),
        tice=torch.zeros((nlayers, nx, ny), dtype=dtype, device=device),
    )


def dummy_forcing(nx: int, ny: int, *, device, dtype) -> Forcing:
    """The reference's constant placeholder forcing
    (``DummyExternalData.hpp:22-34``): Tair=-1 C, dew=-4 C, P=1e5 Pa,
    SW=0 (night), LW=311 W m-2, MLD=10 m, no snowfall, calm wind."""
    full = lambda v: torch.full((nx, ny), v, dtype=dtype, device=device)
    return Forcing(
        tair=full(-1.0), dew2m=full(-4.0), pair=full(1e5),
        sw_in=full(0.0), lw_in=full(311.0), mld=full(10.0),
        snowfall=full(0.0), wind=full(0.0),
    )
