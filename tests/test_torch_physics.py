"""The port's column physics against the JAX package.

Float64 on the CPU. Each module runs on the same (16, 16) inputs drawn from
a numpy seed, chosen so that every branch is taken somewhere on the grid:
freezing and new-ice formation, melting, the minimum concentration and
thickness kill, flooding, full melt and cells without ice. Tolerance: 1e-12
of each plane's max |value| (XLA and PyTorch may differ by an ulp in exp
and pow). The reference golden cases of ``tests/test_physics_golden.py``
run through the port at the same 1e-4 relative contract. ThermoWinton,
``SMU2IceAlbedo``, the registry's defaults and the physics config keys run
through both packages' registries and Configurators (both reset around every
test).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsimdg_tpu.config import Configurator, ConfiguredModule
from nextsimdg_tpu.constants import PhysicalConstants
from nextsimdg_tpu.modules import ModuleRegistry
from nextsimdg_tpu.physics import albedo as jax_albedo
from nextsimdg_tpu.physics import concentration as jax_concentration
from nextsimdg_tpu.physics import freezing as jax_freezing
from nextsimdg_tpu.physics import humidity as jax_humidity
from nextsimdg_tpu.physics import ice_ocean_heat_flux as jax_heat_flux
from nextsimdg_tpu.physics import thermo_ice0 as jax_thermo_ice0
from nextsimdg_tpu.physics.nextsim_physics import NextsimPhysics as JaxNextsimPhysics
from nextsimdg_tpu.state import Forcing as JaxForcing
from nextsimdg_tpu.state import PrognosticBuilder as JaxPrognosticBuilder
from nextsimdg_tpu.state import PrognosticState as JaxPrognosticState
from nextsimdg_tpu.state import dummy_forcing as jax_dummy_forcing
from nextsimdg_tpu.state import safe_div as jax_safe_div
from nextsimdg_tpu.state import zeros_prognostic as jax_zeros_prognostic
from nextsimdg_tpu.physics import thermo_winton as jax_thermo_winton
from nextsimdg_tpu_torch import constants
from nextsimdg_tpu_torch import modules as port_modules
from nextsimdg_tpu_torch import state as port_state
from nextsimdg_tpu_torch.config import Configurator as PortConfigurator
from nextsimdg_tpu_torch.config import ConfiguredModule as PortConfiguredModule
from nextsimdg_tpu_torch.physics import albedo, concentration, freezing, humidity
from nextsimdg_tpu_torch.physics import ice_ocean_heat_flux, thermo_ice0, thermo_winton
from nextsimdg_tpu_torch.physics.nextsim_physics import NextsimPhysics

torch.set_num_threads(1)

N = 16
RTOL = 1e-12
PROG = ("hice", "cice", "hsnow", "sst", "sss", "tice")
FORCING = ("tair", "dew2m", "pair", "sw_in", "lw_in", "mld", "snowfall", "wind")
#: The port's constructors take the device and dtype from the caller; the
#: JAX package's default here is float64 on the CPU.
CPU64 = {"device": "cpu", "dtype": torch.float64}


@pytest.fixture(autouse=True)
def clean_port_config():
    """The port's Configurator and registry selections, reset around each
    test (the JAX package's are reset by ``conftest.py``)."""
    PortConfigurator.clear()
    port_modules.get_loader().reset()
    yield
    PortConfigurator.clear()
    port_modules.get_loader().reset()


def close(got, ref, rtol=RTOL, name=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = float(np.max(np.abs(ref))) if ref.size else 0.0
    np.testing.assert_allclose(got, ref, rtol=0.0, atol=rtol * scale, err_msg=name)


def close_dataclass(got, ref, rtol=RTOL):
    for field in dataclasses.fields(ref):
        value = getattr(ref, field.name)
        if value is not None:
            close(getattr(got, field.name), value, rtol, field.name)


def grid_inputs(seed=0, nlayers=1):
    """Prognostic state and forcing as numpy leaves, every branch somewhere."""
    rng = np.random.default_rng(seed)
    shape = (N, N)
    kind = rng.integers(0, 6, shape)  # 0 no ice, 1 thin, 2 normal, 3 flooded, 4 cold, 5 warm
    cice = np.where(kind == 0, 0.0, rng.uniform(0.05, 1.0, shape))
    cice = np.where(rng.uniform(size=shape) < 0.1, 1.0, cice)
    h_true = np.where(kind == 1, rng.uniform(0.001, 0.02, shape), rng.uniform(0.1, 2.5, shape))
    s_true = np.where(kind == 3, 1.5 * h_true, rng.uniform(0.0, 0.3, shape))
    s_true = np.where(rng.uniform(size=shape) < 0.25, 0.0, s_true)
    hice = np.where(kind == 0, 0.0, h_true * cice)
    hsnow = np.where(kind == 0, 0.0, s_true * cice)
    cold = (kind == 4) | (rng.uniform(size=shape) < 0.3)
    warm = kind == 5
    tair = np.where(cold, rng.uniform(-35.0, -10.0, shape), rng.uniform(-8.0, 4.0, shape))
    tair = np.where(warm, rng.uniform(2.0, 10.0, shape), tair)
    prog = dict(
        hice=hice, cice=cice, hsnow=hsnow,
        sst=np.where(cold, rng.uniform(-1.9, -1.7, shape), rng.uniform(-1.8, 2.0, shape)),
        sss=rng.uniform(28.0, 35.0, shape),
        tice=rng.uniform(-20.0, -0.5, (nlayers, *shape)),
    )
    forcing = dict(
        tair=tair, dew2m=tair - rng.uniform(0.0, 3.0, shape),
        pair=rng.uniform(9.8e4, 1.03e5, shape),
        sw_in=np.where(cold, 0.0, rng.uniform(0.0, 400.0, shape)),
        lw_in=rng.uniform(180.0, 340.0, shape), mld=rng.uniform(5.0, 50.0, shape),
        snowfall=np.where(rng.uniform(size=shape) < 0.5, 0.0, rng.uniform(0.0, 2e-3, shape)),
        wind=rng.uniform(0.0, 20.0, shape),
    )
    return prog, forcing, rng.uniform(0.0, 1e-3, shape)


def port_pair(prog, forcing):
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    return (
        port_state.PrognosticState(**{k: t(prog[k]) for k in PROG}),
        port_state.Forcing(**{k: t(forcing[k]) for k in FORCING}),
    )


def jax_pair(prog, forcing):
    j = lambda a: jnp.asarray(a, dtype=jnp.float64)
    return (
        JaxPrognosticState(**{k: j(prog[k]) for k in PROG}),
        JaxForcing(**{k: j(forcing[k]) for k in FORCING}),
    )


def jax_physics(module_config: str = ""):
    """The JAX orchestrator with the registry's default chain (or the one
    a ``[Modules]`` stream selects), configured."""
    ModuleRegistry.get_loader().reset()
    if module_config:
        Configurator.add_stream(module_config)
        ModuleRegistry.get_loader().set_all_defaults()
        ConfiguredModule.parse_configurator()
    phys = JaxNextsimPhysics()
    phys.configure()
    return phys


def test_constants_are_the_reference_values():
    from nextsimdg_tpu import constants as ref

    for cls in ("PhysicalConstants", "Ice", "Air", "Vapour", "Water"):
        mine, theirs = getattr(constants, cls), getattr(ref, cls)
        names = [n for n in vars(theirs) if not n.startswith("_")]
        assert names and all(getattr(mine, n) == getattr(theirs, n) for n in names), cls
    for fn in ("kelvin", "celsius", "degrees", "radians", "mbar", "pascals"):
        assert getattr(constants, fn)(12.5) == getattr(ref, fn)(12.5)


def test_state_helpers_match():
    rng = np.random.default_rng(3)
    num, den = rng.normal(size=(N, N)), rng.normal(size=(N, N))
    den[::3] = 0.0
    got = port_state.safe_div(torch.tensor(num), torch.tensor(den))
    assert np.array_equal(got.numpy(), np.asarray(jax_safe_div(jnp.asarray(num), jnp.asarray(den))))
    close_dataclass(port_state.zeros_prognostic(4, 5, 2, **CPU64), jax_zeros_prognostic(4, 5, 2), 0.0)
    close_dataclass(port_state.dummy_forcing(4, 5, **CPU64), jax_dummy_forcing(4, 5), 0.0)
    tice = rng.uniform(-5.0, 0.0, (3, 4, 5))
    for t in (-3.0, [-1.0, -2.0, -3.0], tice):
        build = lambda b: b.hice(0.5).cice(0.8).hsnow(0.1).sst(-1.7).sss(33.0).tice(t).build()
        got = build(port_state.PrognosticBuilder(4, 5, nlayers=3, **CPU64))
        ref = build(JaxPrognosticBuilder(4, 5, nlayers=3))
        close_dataclass(got, ref, 0.0)
    prog, forcing, _ = grid_inputs()
    p, f = port_pair(prog, forcing)
    jp, jf = jax_pair(prog, forcing)
    close(p.ice_true_thickness(), jp.ice_true_thickness())
    close(p.snow_true_thickness(), jp.snow_true_thickness())
    close(f.mixed_layer_bulk_heat_capacity(), jf.mixed_layer_bulk_heat_capacity())
    assert p.n_ice_layers == jp.n_ice_layers and p.shape == tuple(jp.shape)


@pytest.mark.parametrize("build", [
    lambda **kw: port_state.PrognosticBuilder(4, 5, **kw),
    lambda **kw: port_state.zeros_prognostic(4, 5, **kw),
    lambda **kw: port_state.dummy_forcing(4, 5, **kw),
])
def test_state_constructors_take_the_device_from_the_caller(build):
    """No CPU default: the caller names the device and the dtype, as
    ``CoupledModel.initial_state`` asks."""
    for missing in ({}, {"dtype": torch.float32}, {"device": "cpu"}):
        with pytest.raises(TypeError, match="keyword-only"):
            build(**missing)
    made = build(device="cpu", dtype=torch.float32)
    if isinstance(made, port_state.PrognosticBuilder):
        made = made.build()
    assert all(
        getattr(made, f.name).dtype == torch.float32 and getattr(made, f.name).device.type == "cpu"
        for f in dataclasses.fields(made)
    )


def test_humidity_matches():
    prog, forcing, _ = grid_inputs()
    t = lambda a: torch.tensor(a)
    for temp in (forcing["dew2m"], prog["sst"], prog["tice"][0]):
        close(humidity.spec_hum_water(t(temp), t(forcing["pair"]), t(prog["sss"])),
              jax_humidity.spec_hum_water(temp, forcing["pair"], prog["sss"]))
        close(humidity.spec_hum_ice(t(temp), t(forcing["pair"])),
              jax_humidity.spec_hum_ice(temp, forcing["pair"]))
        close(humidity.dq_dt_ice(t(temp), t(forcing["pair"])),
              jax_humidity.dq_dt_ice(temp, forcing["pair"]))


@pytest.mark.parametrize("name", ["LinearFreezing", "UnescoFreezing"])
def test_freezing_point_matches(name):
    sss = np.random.default_rng(4).uniform(0.0, 40.0, (N, N))
    close(getattr(freezing, name)()(torch.tensor(sss)), getattr(jax_freezing, name)()(jnp.asarray(sss)))


@pytest.mark.parametrize("name", ["SMUIceAlbedo", "CCSMIceAlbedo", "SMU2IceAlbedo"])
def test_albedo_matches(name):
    rng = np.random.default_rng(5)
    temp = rng.uniform(-10.0, 1.0, (N, N))
    snow = np.where(rng.uniform(size=(N, N)) < 0.3, 0.0, rng.uniform(0.0, 0.5, (N, N)))
    got = getattr(albedo, name)().albedo(torch.tensor(temp), torch.tensor(snow), 0.17)
    ref = getattr(jax_albedo, name)().albedo(jnp.asarray(temp), jnp.asarray(snow), 0.17)
    assert got.dtype == torch.float64
    close(got, ref)
    custom = albedo.CCSMIceAlbedo(ice_albedo=0.63, snow_albedo=0.88)
    jcustom = jax_albedo.CCSMIceAlbedo()
    jcustom.ice_albedo, jcustom.snow_albedo = 0.63, 0.88
    close(custom.albedo(torch.tensor(temp), torch.tensor(snow), 0.17),
          jcustom.albedo(jnp.asarray(temp), jnp.asarray(snow), 0.17))


def test_heat_flux_and_concentration_match():
    prog, forcing, new_ice = grid_inputs()
    p, f = port_pair(prog, forcing)
    jp, jf = jax_pair(prog, forcing)
    tf = -0.055 * prog["sss"]
    close(ice_ocean_heat_flux.BasicIceOceanHeatFlux().flux(
              p.sst, torch.tensor(tf), f.mixed_layer_bulk_heat_capacity(), 600.0),
          jax_heat_flux.BasicIceOceanHeatFlux().flux(
              jp.sst, jnp.asarray(tf), jf.mixed_layer_bulk_heat_capacity(), 600.0))
    conc, jconc = concentration.HiblerConcentration(), jax_concentration.HiblerConcentration()
    close(conc.freeze(torch.tensor(new_ice)), jconc.freeze(jnp.asarray(new_ice)))
    h_true = p.ice_true_thickness()
    h_new = h_true * torch.tensor(np.random.default_rng(6).uniform(0.5, 1.5, (N, N)))
    close(conc.melt(p.cice, h_true, h_new),
          jconc.melt(jp.cice, jnp.asarray(h_true.numpy()), jnp.asarray(h_new.numpy())))


def slab_inputs(prog, forcing, seed=7):
    rng = np.random.default_rng(seed)
    p, _ = port_pair(prog, forcing)
    kw = dict(
        hice=prog["hice"], cice=prog["cice"],
        hi_true=p.ice_true_thickness().numpy(), hs_true=p.snow_true_thickness().numpy(),
        tice0=prog["tice"][0], t_bot=-0.055 * prog["sss"],
        q_ia=rng.normal(0.0, 150.0, (N, N)), dq_dt=rng.uniform(5.0, 30.0, (N, N)),
        q_io=rng.normal(0.0, 50.0, (N, N)), subl=rng.normal(0.0, 1e-5, (N, N)),
        snowfall=forcing["snowfall"],
    )
    return kw


@pytest.mark.parametrize("flooding", [True, False])
def test_thermo_ice0_matches_on_every_branch(flooding):
    prog, forcing, _ = grid_inputs()
    kw = slab_inputs(prog, forcing)
    port = thermo_ice0.ThermoIce0(do_flooding=flooding)
    ref_mod = jax_thermo_ice0.ThermoIce0()
    ref_mod.do_flooding = flooding
    got = port.calculate(**{k: torch.tensor(v) for k, v in kw.items()}, dt=600.0, min_thickness=0.01)
    ref = ref_mod.calculate(**{k: jnp.asarray(v) for k, v in kw.items()}, dt=600.0, min_thickness=0.01)
    close_dataclass(got, ref)
    no_ice = (kw["hice"] == 0.0) | (kw["cice"] == 0.0)
    assert no_ice.any() and (~no_ice).any()
    full_melt = ~no_ice & (got.hi_true.numpy() == 0.0)
    assert full_melt.any()
    assert (got.h_ice_from_snow.numpy() > 0).any() == flooding


def physics_inputs(seed=0, nlayers=1):
    prog, forcing, new_ice = grid_inputs(seed, nlayers)
    return port_pair(prog, forcing), jax_pair(prog, forcing), new_ice


@pytest.mark.parametrize("chain", ["default", "unesco-ccsm"])
@pytest.mark.parametrize("nlayers", [1, 3])
def test_nextsim_physics_step_matches_on_every_branch(chain, nlayers):
    module_config = ""
    port = NextsimPhysics()
    if chain != "default":
        module_config = (
            "[Modules]\n"
            "Nextsim::IFreezingPoint = Nextsim::UnescoFreezing\n"
            "Nextsim::IIceAlbedo = Nextsim::CCSMIceAlbedo\n"
        )
        port = NextsimPhysics(
            freezing_point=freezing.UnescoFreezing(), ice_albedo=albedo.CCSMIceAlbedo()
        )
    ref_phys = jax_physics(module_config)
    (p, f), (jp, jf), new_ice = physics_inputs(nlayers=nlayers)
    for dt in (600.0, 86400.0):
        derived = port.update_derived_data(p, f)
        close_dataclass(derived, ref_phys.update_derived_data(jp, jf))
        got, got_diags = port.step(p, f, torch.tensor(new_ice), dt)
        ref, ref_diags = ref_phys.step(jp, jf, jnp.asarray(new_ice), dt)
        close_dataclass(got, ref)
        close_dataclass(got_diags, ref_diags)

    # Every branch ran somewhere on the grid.
    got, diags = port.step(p, f, torch.tensor(new_ice), 600.0)
    had_ice = (p.hice > 0) & (p.cice > 0)
    assert bool((~had_ice).any())
    freezes = diags.new_ice != torch.tensor(new_ice)
    assert bool(freezes.any()) and bool((~freezes).any())
    assert bool((had_ice & (got.cice == 0)).any())  # killed or fully melted
    assert bool((had_ice & (got.hice < p.hice) & (got.cice > 0)).any())  # melting
    assert bool((diags.h_ice_from_snow > 0).any())  # flooding


def test_physics_parameters_are_the_reference_defaults():
    port, ref = NextsimPhysics(), jax_physics()
    for name in ("drag_ocean_q", "drag_ocean_t", "drag_ice_t", "ocean_albedo", "i0",
                 "min_conc", "min_thick"):
        assert getattr(port, name) == getattr(ref, name), name
    assert type(port.freezing_point).__name__ == type(ref._freezing_point).__name__
    assert type(port.ice_albedo).__name__ == type(ref._ice_albedo).__name__
    assert type(port.thermo).__name__ == type(ref._thermo).__name__
    assert type(port.concentration).__name__ == type(ref._concentration).__name__
    assert type(port.ice_ocean_heat_flux).__name__ == type(ref._ice_ocean_heat_flux).__name__
    assert port.thermo.k_s == ref._thermo.k_s
    (p, f), (jp, jf), new_ice = physics_inputs(seed=2)
    tuned = NextsimPhysics(i0=0.18, min_conc=2e-12, min_thick=0.02)
    Configurator.add_stream("[nextsim_thermo]\nmin_conc = 2e-12\nmin_thick = 0.02\nI_0 = 0.18\n")
    ref = jax_physics()
    got, _ = tuned.step(p, f, torch.tensor(new_ice), 600.0)
    close_dataclass(got, ref.step(jp, jf, jnp.asarray(new_ice), 600.0)[0])


# -- the reference golden values (tests/test_physics_golden.py) ----------------
def approx(value, rel=1e-4):
    return pytest.approx(value, rel=rel)


def make_state(hice, cice, hsnow, sst, sss, tice):
    arr = lambda v: torch.full((1, 1), float(v), dtype=torch.float64)
    tice_arr = torch.tensor(tice, dtype=torch.float64).reshape(-1, 1, 1)
    return port_state.PrognosticState(
        hice=arr(hice), cice=arr(cice), hsnow=arr(hsnow), sst=arr(sst), sss=arr(sss), tice=tice_arr,
    )


def make_forcing(tair, tdew, pair, sw=0.0, lw=0.0, mld=10.0, snowfall=0.0, wind=0.0):
    arr = lambda v: torch.full((1, 1), float(v), dtype=torch.float64)
    return port_state.Forcing(
        tair=arr(tair), dew2m=arr(tdew), pair=arr(pair), sw_in=arr(sw),
        lw_in=arr(lw), mld=arr(mld), snowfall=arr(snowfall), wind=arr(wind),
    )


def golden_physics():
    """[Modules] UnescoFreezing + CCSMIceAlbedo(0.63, 0.88), the golden config."""
    return NextsimPhysics(
        freezing_point=freezing.UnescoFreezing(),
        ice_albedo=albedo.CCSMIceAlbedo(ice_albedo=0.63, snow_albedo=0.88),
    )


def scalar(x):
    return float(x.reshape(()))


def test_golden_update_derived_data():
    prog = make_state(hice=0.1, cice=0.5, hsnow=0.0, sst=-1, sss=32, tice=[-2, -2, -2])
    derived = NextsimPhysics().update_derived_data(prog, make_forcing(tair=-3, tdew=0.1, pair=1e5))
    assert scalar(derived.rho_air) == approx(1.29253)
    assert scalar(derived.sphum_air) == approx(0.00385326)
    assert scalar(derived.sphum_water) == approx(0.00349446)
    assert scalar(derived.sphum_ice) == approx(0.00323958)
    assert scalar(derived.cp_wet_air) == approx(1011.81)


def test_golden_new_ice_formation():
    phys = NextsimPhysics(freezing_point=freezing.UnescoFreezing())
    prog = make_state(hice=0.1, cice=0.5, hsnow=0.0, sst=-1.5, sss=32, tice=[-2, -2, -2])
    forcing = make_forcing(tair=-3, tdew=0.1, pair=100000, sw=0, lw=0, mld=10)
    _, diags = phys.step(prog, forcing, torch.zeros((1, 1), dtype=torch.float64), dt=86400.0)
    sb_corr = PhysicalConstants.sigma / 5.67e-8
    assert scalar(diags.new_ice) == approx(0.0258236 * sb_corr)


def test_golden_drag_pressure():
    prog = make_state(hice=0.1, cice=0.5, hsnow=0.0, sst=-1.5, sss=32, tice=[-1, -1, -1])
    for wind, expected in ((1.5, 0.00126936), (8.0, 0.00141407), (23.0, 0.00253872)):
        forcing = make_forcing(tair=2, tdew=1.5, pair=100000, mld=10, wind=wind)
        _, diags = NextsimPhysics().step(prog, forcing, torch.zeros((1, 1), dtype=torch.float64), 86400.0)
        assert scalar(diags.drag_pressure) == approx(expected), wind


def test_golden_melting_conditions():
    prog = make_state(hice=0.1, cice=0.5, hsnow=0.01, sst=-1, sss=32, tice=[-1, -1, -1])
    forcing = make_forcing(tair=3, tdew=2, pair=100000, sw=50, lw=330, mld=10, snowfall=0, wind=5)
    updated, diags = golden_physics().step(prog, forcing, torch.zeros((1, 1), dtype=torch.float64), 600.0)
    conc = scalar(updated.cice)
    assert scalar(updated.hice) / conc == approx(0.12846)
    assert scalar(updated.hsnow) / conc == approx(0.01957732)
    assert conc == approx(0.368269)
    assert scalar(updated.tice[0]) == pytest.approx(0.0, abs=1e-12)
    assert scalar(diags.new_ice) == 0.0
    assert scalar(diags.q_ia) == approx(-84.6156, rel=1e-2)
    assert scalar(diags.q_io) == approx(53717.8, rel=1e-2)
    assert scalar(diags.subl) == approx(-7.3858e-06)
    assert scalar(diags.dq_dt) == approx(19.7013, rel=1e-2)
    assert scalar(diags.h_ice_from_snow) == pytest.approx(0.0, abs=1e-12)


def test_golden_freezing_conditions():
    prog = make_state(hice=0.1, cice=0.5, hsnow=0.01, sst=-1.75, sss=32, tice=[-9, -9])
    forcing = make_forcing(
        tair=-12, tdew=-12, pair=100000, sw=0, lw=265, mld=10, snowfall=1e-3, wind=5
    )
    updated, diags = golden_physics().step(prog, forcing, torch.zeros((1, 1), dtype=torch.float64), 600.0)
    conc = scalar(updated.cice)
    assert scalar(updated.hice) / conc == approx(0.199998)
    assert scalar(updated.hsnow) / conc == approx(0.02179357)
    assert conc == approx(0.5002)
    assert scalar(updated.tice[0]) == approx(-8.90443)
    assert scalar(diags.new_ice) == approx(6.79707e-5, rel=1e-2)
    assert scalar(diags.q_ia) == approx(42.2955, rel=1e-2)
    assert scalar(diags.q_io) == approx(73.9465, rel=1e-2)
    assert scalar(diags.subl) == approx(2.15132e-06)
    assert scalar(diags.dq_dt) == approx(16.7615, rel=1e-2)
    assert scalar(diags.h_ice_from_snow) == pytest.approx(0.0, abs=1e-12)


# -- the registry, the config keys and ThermoWinton -----------------------------
def configured_pair(stream: str = ""):
    """NextsimPhysics of both packages, configured from the same stream
    through their own registries and Configurators."""
    ref = jax_physics(stream)
    PortConfigurator.add_stream(stream)
    port_modules.get_loader().set_all_defaults()
    PortConfiguredModule.parse_configurator()
    port = NextsimPhysics()
    port.configure()
    return port, ref


def test_the_registry_holds_the_reference_modules_in_order():
    port_loader, jax_loader = port_modules.get_loader(), ModuleRegistry.get_loader()
    physics_interfaces = [
        "Nextsim::IFreezingPoint", "Nextsim::IIceAlbedo", "Nextsim::IIceOceanHeatFlux",
        "Nextsim::IThermodynamics", "Nextsim::IConcentrationModel", "Nextsim::IPhysics1d",
    ]
    for interface in physics_interfaces:
        assert port_loader.list_implementations(interface) == jax_loader.list_implementations(interface)
    assert port_loader.list_implementations("Nextsim::IIceAlbedo") == [
        "Nextsim::SMUIceAlbedo", "Nextsim::SMU2IceAlbedo", "Nextsim::CCSMIceAlbedo",
    ]
    assert port_loader.list_implementations("Nextsim::IThermodynamics") == [
        "Nextsim::ThermoIce0", "Nextsim::ThermoWinton",
    ]
    port, ref = configured_pair()
    for mine, theirs in (
        (port.freezing_point, ref._freezing_point), (port.ice_albedo, ref._ice_albedo),
        (port.thermo, ref._thermo), (port.concentration, ref._concentration),
        (port.ice_ocean_heat_flux, ref._ice_ocean_heat_flux),
    ):
        assert type(mine).__name__ == type(theirs).__name__
    assert type(port_loader.get_implementation("Nextsim::IPhysics1d")) is NextsimPhysics


#: Every physics config key with a value other than its default.
PHYSICS_KEYS = (
    "[nextsim_thermo]\ndrag_ocean_q = 1.6e-3\ndrag_ocean_t = 0.9e-3\ndrag_ice_t = 1.2e-3\n"
    "albedoW = 0.08\nI_0 = 0.2\nmin_conc = 2e-12\nmin_thick = 0.02\n"
    "[thermoice0]\nks = 0.35\n[Hibler]\nh0 = 0.3\nphiM = 0.45\n"
    "[CCSMIceAlbedo]\niceAlbedo = 0.6\nsnowAlbedo = 0.86\n"
    "[thermowinton]\nks = 0.33\n"
)


@pytest.mark.parametrize("modules", [
    "",
    "[Modules]\nNextsim::IIceAlbedo = Nextsim::CCSMIceAlbedo\n"
    "Nextsim::IFreezingPoint = Nextsim::UnescoFreezing\n",
    "[Modules]\nNextsim::IIceAlbedo = Nextsim::SMU2IceAlbedo\n"
    "Nextsim::IThermodynamics = Nextsim::ThermoWinton\n",
], ids=["default", "unesco-ccsm", "smu2-winton"])
def test_the_config_keys_reach_the_same_physics(modules):
    port, ref = configured_pair(modules + PHYSICS_KEYS)
    for name in ("drag_ocean_q", "drag_ocean_t", "drag_ice_t", "ocean_albedo", "i0",
                 "min_conc", "min_thick"):
        assert getattr(port, name) == getattr(ref, name) != getattr(NextsimPhysics(), name), name
    assert (port.concentration.h0, port.concentration.phi_m) == (0.3, 0.45)
    k = {"ThermoIce0": ("k_s", 0.35), "ThermoWinton": ("k_snow", 0.33)}[type(port.thermo).__name__]
    assert getattr(port.thermo, k[0]) == getattr(ref._thermo, k[0]) == k[1]
    if isinstance(port.ice_albedo, albedo.CCSMIceAlbedo):
        assert (port.ice_albedo.ice_albedo, port.ice_albedo.snow_albedo) == (0.6, 0.86)
    nlayers = 3 if "Winton" in modules else 1
    (p, f), (jp, jf), new_ice = physics_inputs(seed=4, nlayers=nlayers)
    got, got_diags = port.step(p, f, torch.tensor(new_ice), 600.0)
    want, want_diags = ref.step(jp, jf, jnp.asarray(new_ice), 600.0)
    close_dataclass(got, want)
    close_dataclass(got_diags, want_diags)


def test_flooding_disabled_by_config():
    """The twin of ``test_physics_branches.py::test_flooding_disabled_by_config``."""
    prog = make_state(hice=0.2, cice=0.5, hsnow=0.8, sst=-1.7, sss=32, tice=[-5.0])
    forcing = make_forcing(tair=-5, tdew=-6, pair=1e5, lw=300, mld=10, wind=0)
    port, _ = configured_pair()
    _, diags = port.step(prog, forcing, torch.zeros((1, 1), dtype=torch.float64), 600.0)
    assert scalar(diags.h_ice_from_snow) > 0.0  # floods by default
    Configurator.clear()
    PortConfigurator.clear()
    port, ref = configured_pair("[thermoice0]\nflooding = false\n")
    assert port.thermo.do_flooding is False and ref._thermo.do_flooding is False
    updated, diags = port.step(prog, forcing, torch.zeros((1, 1), dtype=torch.float64), 600.0)
    assert scalar(diags.h_ice_from_snow) == 0.0
    jp = JaxPrognosticState(**{k: jnp.asarray(getattr(prog, k).numpy()) for k in PROG})
    jf = JaxForcing(**{k: jnp.asarray(getattr(forcing, k).numpy()) for k in FORCING})
    close_dataclass(updated, ref.step(jp, jf, jnp.zeros((1, 1)), 600.0)[0])


@pytest.mark.parametrize("flooding", [True, False])
def test_thermo_winton_matches_on_every_branch(flooding):
    """Seeded columns in both regimes (growth under cold skies, surface and
    bottom melt under warm ones, full melt, no ice, flooding)."""
    prog, forcing, _ = grid_inputs(seed=1, nlayers=3)
    kw = slab_inputs(prog, forcing, seed=9)
    kw.update(tice1=prog["tice"][1], tice2=prog["tice"][2])
    port = thermo_winton.ThermoWinton()
    ref_mod = jax_thermo_winton.ThermoWinton()
    port.do_flooding = ref_mod.do_flooding = flooding
    for dt in (600.0, 86400.0):
        got = port.calculate(**{k: torch.tensor(v) for k, v in kw.items()}, dt=dt, min_thickness=0.01)
        ref = ref_mod.calculate(**{k: jnp.asarray(v) for k, v in kw.items()}, dt=dt, min_thickness=0.01)
        close_dataclass(got, ref)
        for mine, theirs in zip(got.t_layers, ref.t_layers):
            close(mine, theirs)
        close(port.last_f_atm, ref_mod.last_f_atm)
        assert all(bool(torch.isfinite(t).all()) for t in (got.hi_true, got.t_surf, *got.t_layers))
    got = port.calculate(**{k: torch.tensor(v) for k, v in kw.items()}, dt=600.0, min_thickness=0.01)
    had_ice = (kw["hice"] != 0.0) & (kw["cice"] != 0.0)
    grew = had_ice & (got.hi_true.numpy() > kw["hi_true"])
    melted = had_ice & (got.hi_true.numpy() < kw["hi_true"])
    assert grew.any() and melted.any() and (~had_ice).any()
    assert (had_ice & (got.hi_true.numpy() == 0.0)).any()  # full melt
    assert (got.t_surf.numpy()[had_ice] == 0.0).any()  # surface clamped under snow
    assert (got.h_ice_from_snow.numpy() > 0).any() == flooding


@pytest.mark.parametrize("regime", ["freezing", "melting"])
def test_thermo_winton_energy_budget(regime):
    """``tests/test_thermo_winton.py``'s budget: the total enthalpy changes by
    dt (applied atmospheric flux + consumed ocean flux) to near round-off, in
    the port as in the JAX package."""
    case = {
        "freezing": dict(hi=1.0, hs=0.1, t1=-5.0, t2=-2.5, tice0=-8.0, q_ia=60.0, dq_dt=18.0, q_io=3.0),
        "melting": dict(hi=1.0, hs=0.05, t1=-2.0, t2=-1.5, tice0=-0.5, q_ia=-150.0, dq_dt=12.0, q_io=20.0),
    }[regime]
    dt = 3600.0
    inputs = dict(
        hice=case["hi"] * 0.9, cice=0.9, hi_true=case["hi"], hs_true=case["hs"], tice0=case["tice0"],
        t_bot=-1.8, q_ia=case["q_ia"], dq_dt=case["dq_dt"], q_io=case["q_io"], subl=0.0,
        snowfall=0.0, tice1=case["t1"], tice2=case["t2"],
    )
    port = thermo_winton.ThermoWinton()
    out = port.calculate(
        **{k: torch.full((1, 1), float(v), dtype=torch.float64) for k, v in inputs.items()},
        dt=dt, min_thickness=0.01,
    )
    ref_mod = jax_thermo_winton.ThermoWinton()
    ref = ref_mod.calculate(
        **{k: jnp.full((1, 1), float(v), dtype=jnp.float64) for k, v in inputs.items()},
        dt=dt, min_thickness=0.01,
    )
    close_dataclass(out, ref)
    t = lambda v: torch.tensor(float(v), dtype=torch.float64)
    e0 = float(thermo_winton.total_enthalpy(t(case["hi"]), t(case["hs"]), t(case["t1"]), t(case["t2"])))
    e1 = float(thermo_winton.total_enthalpy(out.hi_true, out.hs_true, *out.t_layers)[0, 0])
    q_back = float(out.q_io[0, 0]) - case["q_io"]
    residual = e1 - e0 - dt * (float(port.last_f_atm[0, 0]) + case["q_io"]) + q_back * dt
    assert abs(residual) < 1e-9 * abs(e0), residual
    e0_ref = float(jax_thermo_winton.total_enthalpy(case["hi"], case["hs"], case["t1"], case["t2"]))
    assert e0 == pytest.approx(e0_ref, rel=1e-15)
    if regime == "freezing":
        assert float(out.hi_true[0, 0]) > 1.0
        assert float(out.t_layers[0][0, 0]) < float(out.t_layers[1][0, 0]) < 0.0
    else:
        assert float(out.hs_true[0, 0]) < 0.05
        assert float(out.t_surf[0, 0]) == pytest.approx(0.0, abs=1e-9)
