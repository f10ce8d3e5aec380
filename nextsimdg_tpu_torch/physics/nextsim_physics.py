"""The column-physics orchestrator.

Counterpart of ``nextsimdg_tpu.physics.nextsim_physics`` (``NextsimPhysics``,
``NextsimPhysics.cpp``): ``update_derived_data`` mirrors the ``IPhysics1d``
template method, ``calculate`` composes the flux and mass updates in the
reference order with the per-element branches as masks.

Registered as ``Nextsim::IPhysics1d`` -> ``Nextsim::NextsimPhysics``. The
five sub-modules and the seven parameters may be given to the constructor.
Those not given are resolved as the JAX version resolves them: the
sub-modules from the process-wide registry (each configured), the
parameters from the ``nextsim_thermo.*`` config keys with the reference
defaults, by ``configure()``, which the engine calls
(``runtime.ModelStep.init``), or else on first use (the first ``calculate``,
or the first read of a sub-module). So a ``CoupledModel``'s default physics
runs the modules that the registry selects when it first steps. Until then
the parameters read the reference values. Given ones always win.

The only cross-step physics memory is ``new_ice``: the reference keeps
``m_newice`` per element and overwrites it only in the supercooling branch,
so callers thread it through ``PhysicsDiagnostics.new_ice``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..config import Configured, try_configure
from ..constants import Air, Ice, PhysicalConstants, Vapour, Water, kelvin
from ..modules import ModuleRegistry, register_implementation
from ..state import Forcing, PhysicsDiagnostics, PrognosticState, safe_div
# The sub-modules register themselves: the registry resolves them by name.
from . import albedo, concentration, freezing, ice_ocean_heat_flux  # noqa: F401
from . import thermo_ice0, thermo_winton  # noqa: F401
from .humidity import dq_dt_ice, spec_hum_ice, spec_hum_water

INTERFACE = "Nextsim::IPhysics1d"


def stefan_boltzmann(temperature_c):
    """Upward longwave of an ice surface: eps * sigma * T^4 (T in degC)."""
    return Ice.epsilon * PhysicalConstants.sigma * kelvin(temperature_c) ** 4


def latent_heat_water(temperature):
    """Latent heat of vaporization polynomial (Horner form) [J kg-1]."""
    return Water.Lv0 + temperature * (
        -2.36418e3 + temperature * (1.58927 + temperature * (-6.14342e-2))
    )


def latent_heat_ice(temperature):
    """Latent heat of sublimation polynomial [J kg-1]."""
    return Water.Lv0 + Water.Lf - 240.0 + temperature * (-290.0 + temperature * (-4.0))


def drag_ocean_m(wind_speed):
    """Gill (1982) / Smith (1980) ocean momentum drag coefficient."""
    return 1e-3 * torch.clamp(0.61 + 0.063 * wind_speed, 1.0, 2.0)


@dataclass(frozen=True)
class DerivedData:
    """Outputs of updateDerivedData (cf. PhysicsData's derived members)."""

    sphum_air: Any
    sphum_water: Any
    sphum_ice: Any
    rho_air: Any
    cp_wet_air: Any
    hi_true: Any  #: true ice thickness of the prognostic state
    hs_true: Any  #: true snow thickness of the prognostic state


#: The sub-modules: attribute name -> interface, in the order the JAX
#: version's ``configure()`` resolves them.
_MODULES = {
    "ice_ocean_heat_flux": "Nextsim::IIceOceanHeatFlux",
    "ice_albedo": "Nextsim::IIceAlbedo",
    "thermo": "Nextsim::IThermodynamics",
    "concentration": "Nextsim::IConcentrationModel",
    "freezing_point": "Nextsim::IFreezingPoint",  # bound by PrognosticData::configure
}
#: The parameters: attribute name -> (config key, reference value).
_PARAMETERS = {
    "drag_ocean_q": ("nextsim_thermo.drag_ocean_q", 1.5e-3),
    "drag_ocean_t": ("nextsim_thermo.drag_ocean_t", 0.83e-3),
    "drag_ice_t": ("nextsim_thermo.drag_ice_t", 1.3e-3),
    "ocean_albedo": ("nextsim_thermo.albedoW", 0.07),
    "i0": ("nextsim_thermo.I_0", 0.17),
    "min_conc": ("nextsim_thermo.min_conc", 1e-12),
    "min_thick": ("nextsim_thermo.min_thick", 0.01),
}


@register_implementation(INTERFACE, "Nextsim::NextsimPhysics")
class NextsimPhysics(Configured):
    def __init__(
        self,
        *,
        ice_ocean_heat_flux=None,
        ice_albedo=None,
        thermo=None,
        concentration=None,
        freezing_point=None,
        drag_ocean_q: float = None,
        drag_ocean_t: float = None,
        drag_ice_t: float = None,
        ocean_albedo: float = None,
        i0: float = None,
        min_conc: float = None,
        min_thick: float = None,
    ) -> None:
        """Sub-modules and parameters given here are kept; those left None
        are resolved from the registry and the ``nextsim_thermo.*`` keys
        (``drag_ocean_q``, ``drag_ocean_t``, ``drag_ice_t``, ``albedoW``,
        ``I_0``, ``min_conc``, ``min_thick``) on first use. Until then a
        parameter left None reads its reference value."""
        given = dict(
            ice_ocean_heat_flux=ice_ocean_heat_flux, ice_albedo=ice_albedo, thermo=thermo,
            concentration=concentration, freezing_point=freezing_point,
        )
        self._modules = dict(given)
        self._given_modules = {name for name, module in given.items() if module is not None}
        values = dict(
            drag_ocean_q=drag_ocean_q, drag_ocean_t=drag_ocean_t, drag_ice_t=drag_ice_t,
            ocean_albedo=ocean_albedo, i0=i0, min_conc=min_conc, min_thick=min_thick,
        )
        self._given_parameters = {name for name, value in values.items() if value is not None}
        for name, (_, default) in _PARAMETERS.items():
            setattr(self, name, default if values[name] is None else values[name])
        self._resolved = False

    # -- configuration (NextsimPhysics.cpp:60-83) ----------------------------
    def configure(self) -> None:
        """The registry's selected sub-modules, each configured, and the
        ``nextsim_thermo.*`` keys with the reference defaults, for those not
        given to the constructor."""
        loader = ModuleRegistry.get_loader()
        for name, interface in _MODULES.items():
            if name not in self._given_modules:
                self._modules[name] = loader.get_implementation(interface)
                try_configure(self._modules[name])
        for name, (key, default) in _PARAMETERS.items():
            if name not in self._given_parameters:
                setattr(self, name, Configured.get_configuration(key, default))
        self._resolved = True

    def _resolve(self) -> None:
        """``configure()`` on first use, where nobody called it (the JAX
        version's ``_modules_resolved``)."""
        if not self._resolved:
            self.configure()

    def _module(self, name: str):
        if self._modules[name] is None:
            self._resolve()
        return self._modules[name]

    ice_ocean_heat_flux = property(lambda self: self._module("ice_ocean_heat_flux"))
    ice_albedo = property(lambda self: self._module("ice_albedo"))
    thermo = property(lambda self: self._module("thermo"))
    concentration = property(lambda self: self._module("concentration"))
    freezing_point = property(lambda self: self._module("freezing_point"))

    # -- derived data (IPhysics1d.hpp:33-45) ---------------------------------
    def update_derived_data(self, prog: PrognosticState, forcing: Forcing) -> DerivedData:
        sphum_air = spec_hum_water(forcing.dew2m, forcing.pair)
        sphum_water = spec_hum_water(prog.sst, forcing.pair, prog.sss)
        sphum_ice = spec_hum_ice(prog.tice[0], forcing.pair)
        ra_wet = Air.Ra / (1.0 - sphum_air * (1.0 - Vapour.Ra / Air.Ra))
        rho_air = forcing.pair / (ra_wet * kelvin(forcing.tair))
        cp_wet_air = Air.cp + sphum_air * Vapour.cp
        return DerivedData(
            sphum_air=sphum_air,
            sphum_water=sphum_water,
            sphum_ice=sphum_ice,
            rho_air=rho_air,
            cp_wet_air=cp_wet_air,
            hi_true=prog.ice_true_thickness(),
            hs_true=prog.snow_true_thickness(),
        )

    # -- the physics step ----------------------------------------------------
    def calculate(
        self, prog: PrognosticState, forcing: Forcing, derived: DerivedData,
        new_ice_prev, dt: float,
    ):
        """One column-physics update (NextsimPhysics::calculate order).

        Returns ``(updated_prognostic, diagnostics)``.
        """
        self._resolve()
        tice0 = prog.tice[0]
        wind = forcing.wind
        rho_air = derived.rho_air

        # massFluxOpenWater (:133-137)
        evap = self.drag_ocean_q * rho_air * wind * (derived.sphum_water - derived.sphum_air)

        # momentumFluxOpenWater (:139-142)
        drag_pressure = rho_air * drag_ocean_m(wind)

        # heatFluxOpenWater (:144-162)
        q_lh_ow = evap * latent_heat_water(prog.sst)
        q_sh_ow = (
            self.drag_ocean_t * rho_air * derived.cp_wet_air * wind * (prog.sst - forcing.tair)
        )
        q_sw_ow = -forcing.sw_in * (1.0 - self.ocean_albedo)
        q_lw_ow = stefan_boltzmann(prog.sst) - forcing.lw_in
        q_ow = q_lh_ow + q_sh_ow + q_lw_ow + q_sw_ow

        # massFluxIceAtmosphere (:164-168)
        subl = self.drag_ice_t * rho_air * wind * (derived.sphum_ice - derived.sphum_air)

        # heatFluxIceAtmosphere (:170-198)
        q_lh_i = subl * latent_heat_ice(tice0)
        dmdot_dt = self.drag_ice_t * rho_air * wind * dq_dt_ice(tice0, forcing.pair)
        dq_lh_dt = latent_heat_ice(tice0) * dmdot_dt
        q_sh_i = self.drag_ice_t * rho_air * derived.cp_wet_air * wind * (tice0 - forcing.tair)
        dq_sh_dt = self.drag_ice_t * rho_air * derived.cp_wet_air * wind
        snow_true_for_albedo = safe_div(prog.hsnow, prog.cice)
        albedo_value = self.ice_albedo.albedo(tice0, snow_true_for_albedo, self.i0)
        q_sw_i = -forcing.sw_in * (1.0 - self.i0) * (1.0 - albedo_value)
        q_lw_i = stefan_boltzmann(tice0) - forcing.lw_in
        dq_lw_dt = 4.0 / kelvin(tice0) * stefan_boltzmann(tice0)
        q_ia = q_lh_i + q_sh_i + q_lw_i + q_sw_i
        dq_dt = dq_lh_dt + dq_sh_dt + dq_lw_dt

        # heatFluxIceOcean (:222-226), before the mass flux, which uses it.
        t_freeze = self.freezing_point(prog.sss)
        mlbhc = forcing.mixed_layer_bulk_heat_capacity()
        q_io = self.ice_ocean_heat_flux.flux(prog.sst, t_freeze, mlbhc, dt)

        # massFluxIceOcean (:200-220): thermodynamics ...
        layer_kwargs = {}
        if prog.tice.shape[0] >= 3:
            # Multi-layer schemes: tice = [Ts, T1, T2].
            layer_kwargs = dict(tice1=prog.tice[1], tice2=prog.tice[2])
        slab = self.thermo.calculate(
            hice=prog.hice,
            cice=prog.cice,
            hi_true=derived.hi_true,
            hs_true=derived.hs_true,
            tice0=tice0,
            t_bot=t_freeze,
            q_ia=q_ia,
            dq_dt=dq_dt,
            q_io=q_io,
            subl=subl,
            snowfall=forcing.snowfall,
            dt=dt,
            min_thickness=self.min_thick,
            **layer_kwargs,
        )
        q_io = slab.q_io
        hi_new = slab.hi_true
        hs_new = slab.hs_true

        # ... newIceFormation (:228-254) ...
        cooling_flux = q_ow
        delta_tml = -cooling_flux / mlbhc * dt
        t1 = prog.sst + delta_tml
        freezes = t1 < t_freeze
        sensible_flux = safe_div((t_freeze - prog.sst) * cooling_flux, delta_tml)
        latent_flux = cooling_flux - sensible_flux
        q_ow = torch.where(freezes, sensible_flux, q_ow)
        new_ice = torch.where(
            freezes,
            latent_flux * dt * (1.0 - prog.cice) / (Ice.Lf * Ice.rho),
            new_ice_prev,
        )

        # ... lateralGrowth (:262-289) ...
        del_c = self.concentration.freeze(new_ice)
        melting = hi_new < derived.hi_true
        del_c = del_c + torch.where(
            melting,
            self.concentration.melt(prog.cice, derived.hi_true, hi_new),
            0.0,
        )
        conc_new = prog.cice + del_c
        apply_volume = conc_new >= self.min_conc
        # updateThickness: thick += (deltaV - thick*deltaC)/(oldConc + deltaC)
        hi_new = torch.where(
            apply_volume,
            hi_new + safe_div(new_ice - hi_new * del_c, prog.cice + del_c),
            hi_new,
        )
        shrinking = del_c < 0.0
        q_ow = torch.where(
            apply_volume & shrinking,
            q_ow - del_c * hs_new * Water.Lf * Ice.rho_snow / dt,
            q_ow,
        )
        hs_new = torch.where(
            apply_volume & ~shrinking,
            hs_new + safe_div(-hs_new * del_c, prog.cice + del_c),
            hs_new,
        )

        # ... minimum concentration/thickness clamp (:211-219).
        kill = (conc_new < self.min_conc) | (hi_new < self.min_thick)
        q_ow = torch.where(
            kill,
            q_ow + conc_new * Water.Lf * (hi_new * Ice.rho + hs_new * Ice.rho_snow) / dt,
            q_ow,
        )
        conc_new = torch.where(kill, 0.0, conc_new)
        hi_new = torch.where(kill, 0.0, hi_new)
        hs_new = torch.where(kill, 0.0, hs_new)

        # Commit (PrognosticData::updateAndIntegrate): effective thickness =
        # true thickness * concentration; ice temperature layer 0 is the slab
        # surface temperature. For multi-layer schemes the interior layers
        # come from the thermodynamics module; for the 0-layer scheme deeper
        # layers take the PhysicsData init value 0.
        if slab.t_layers is not None and prog.tice.shape[0] >= 1 + len(slab.t_layers):
            layers = [slab.t_surf, *slab.t_layers]
            layers += [torch.zeros_like(slab.t_surf)] * (prog.tice.shape[0] - len(layers))
            tice_new = torch.stack(layers)
        else:
            tice_new = torch.zeros_like(prog.tice)
            tice_new[0] = slab.t_surf
        updated = PrognosticState(
            hice=hi_new * conc_new,
            cice=conc_new,
            hsnow=hs_new * conc_new,
            sst=prog.sst,
            sss=prog.sss,
            tice=tice_new,
        )
        diagnostics = PhysicsDiagnostics(
            evap=evap,
            subl=subl,
            q_ow=q_ow,
            q_ia=q_ia,
            q_io=q_io,
            dq_dt=dq_dt,
            drag_pressure=drag_pressure,
            new_ice=new_ice,
            h_ice_from_snow=slab.h_ice_from_snow,
        )
        return updated, diagnostics

    def step(self, prog: PrognosticState, forcing: Forcing, new_ice_prev, dt: float):
        """update_derived_data + calculate: one full physics timestep."""
        derived = self.update_derived_data(prog, forcing)
        return self.calculate(prog, forcing, derived, new_ice_prev, dt)
