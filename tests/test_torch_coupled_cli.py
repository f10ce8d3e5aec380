"""The port's coupled CLI (``nextsimdg_tpu_torch.runtime.coupled_main``) on
one device: the twins of ``tests/test_coupled_main.py``'s single-device
cases (constant, cyclone, archive and ERA5 forcing, the module selections,
the coastline from a .npy file, the pan-Arctic stack, the periodic_x
override, adaptive alpha) and of ``tests/test_parity_extras.py:42`` (the
engine's checkpoint cadence), and what the port does of its own: the
parallel modes it does not take raise naming their reason, and without a
card and without ``--cpu`` the CLI returns 2. The CLI runs on the CPU (``--cpu``); the port's
Configurator and registry are reset around every test.
"""

import glob
import os
import shutil

import numpy as np
import pytest
import torch

from nextsimdg_tpu_torch.config import Configurator
from nextsimdg_tpu_torch.dynamics.landmask import synthetic_coastline
from nextsimdg_tpu_torch.io.coupled_restart import load_coupled_state, load_time
from nextsimdg_tpu_torch.io.diagnostics import read_diagnostics
from nextsimdg_tpu_torch.modules import get_loader
from nextsimdg_tpu_torch.runtime.coupled_main import run_coupled

torch.set_num_threads(1)

CPU32 = {"device": "cpu", "dtype": torch.float32}


@pytest.fixture(autouse=True)
def clean_port():
    Configurator.clear()
    get_loader().reset()
    yield
    Configurator.clear()
    get_loader().reset()


def fresh() -> None:
    """Reset the port's Configurator and registry between two runs."""
    Configurator.clear()
    get_loader().reset()


def write_cfg(tmp_path, forcing="constant", extra="", name="run.cfg"):
    """The JAX CLI tests' config (tests/test_coupled_main.py:14): 16 x 16,
    3 steps of 600 s, 10 subcycles, diagnostics every step, checkpoints
    every 2."""
    cfg = tmp_path / name
    cfg.write_text(
        "[model]\n"
        "start = 0\nstop = 1800\ntime_step = 600\n"
        "diagnostics_file = diag.h5\ndiagnostics_period = 1\n"
        "checkpoint_period = 2\ncheckpoint_pattern = chk.{step}.chk\n"
        "[dynamics]\n"
        "nx = 16\nny = 16\ndx = 32000.0\ndy = 32000.0\n"
        "degree = 1\nsubcycles = 10\nthermo = true\n"
        f"forcing = {forcing}\nwind = 10.0\n" + extra
    )
    return str(cfg)


def run(*args) -> int:
    """The port's CLI on the CPU."""
    return run_coupled(["prog", *args, "--cpu"])


#: The test archive's fields: (low, high) of each one's uniform values.
ARCHIVE_RANGES = {
    "tair": (-25.0, -5.0), "dew2m": (-27.0, -7.0), "pair": (9.9e4, 1.01e5), "sw_in": (0.0, 60.0),
    "lw_in": (180.0, 280.0), "mld": (8.0, 15.0), "snowfall": (0.0, 2e-4), "wind": (2.0, 12.0),
    "u_atm": (2.0, 12.0), "v_atm": (-4.0, 4.0), "u_ocean": (-0.05, 0.05), "v_ocean": (-0.05, 0.05),
}


def write_archive(path, nx=16, ny=16, times=(0.0, 450.0, 1350.0, 2000.0), seed=0) -> dict:
    """A forcing archive of all twelve fields, random in time and space over
    records that bracket a 3-step run of 600 s (the steps and the dt/2
    replay's half steps fall between records); returns its fields."""
    from nextsimdg_tpu_torch.io.forcing_file import write_forcing_archive

    rng = np.random.default_rng(seed)
    fields = {n: rng.uniform(lo, hi, size=(len(times), nx, ny)) for n, (lo, hi) in ARCHIVE_RANGES.items()}
    write_forcing_archive(str(path), np.asarray(times), fields)
    return fields


def test_coupled_cli_constant_forcing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = write_cfg(tmp_path)
    assert run("--config-file", cfg) == 0
    assert os.path.exists("coupled_restart.chk")
    assert load_time("coupled_restart.chk") == 1800.0
    assert os.path.exists("chk.2.chk")
    diag = read_diagnostics("diag.h5")
    assert diag["time"].tolist() == [600.0, 1200.0, 1800.0]
    assert np.all(np.isfinite(diag["hice"]))
    # Resume from the final checkpoint.
    state = load_coupled_state("coupled_restart.chk", **CPU32)
    assert state.hice.shape == (3, 16, 16)


def test_coupled_cli_applies_module_selections(tmp_path, monkeypatch):
    """[Modules] sections select the dynamics solver through the CLI."""
    monkeypatch.chdir(tmp_path)
    cfg = write_cfg(tmp_path, extra="[Modules]\nNextsim::IDynamics = Nextsim::FreeDrift\n")
    assert run("--config-file", cfg) == 0
    state = load_coupled_state("coupled_restart.chk", **CPU32)
    # Free drift carries no internal stress.
    assert float(state.velocity.s11.abs().max()) == 0.0
    assert float(state.velocity.u.abs().max()) > 0.0


def test_coupled_cli_cyclone_forcing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = write_cfg(tmp_path, forcing="cyclone")
    assert run("--config-file", cfg) == 0
    state = load_coupled_state("coupled_restart.chk", **CPU32)
    # The cyclone set the ice in motion.
    assert float(state.velocity.u.abs().max()) > 0


def test_coupled_cli_land_mask_from_npy(tmp_path, monkeypatch):
    """dynamics.land_mask = <path.npy> loads a user-provided mask."""
    monkeypatch.chdir(tmp_path)
    mask = np.ones((16, 16))
    mask[:4, :] = 0.0
    np.save(tmp_path / "mask.npy", mask)
    cfg = write_cfg(tmp_path, extra=f"land_mask = {tmp_path / 'mask.npy'}\n")
    assert run("--config-file", cfg) == 0
    state = load_coupled_state("coupled_restart.chk", **CPU32)
    assert torch.all(state.hice[0][:4, :] == 0.0)
    assert torch.all(state.velocity.u[:4, :] == 0.0)


def test_coupled_cli_spherical_coastline_winton(tmp_path, monkeypatch):
    """The pan-Arctic stack on constant forcing: the lon-lat mesh, the
    synthetic coastline and Winton's 3 layers (the template,
    tests/test_coupled_main.py:112, forces it from ERA5: that twin is
    test_coupled_cli_pan_arctic_config)."""
    monkeypatch.chdir(tmp_path)
    cfg = write_cfg(tmp_path, extra=(
        "geometry = spherical\nlat0 = 71.0\nlat1 = 79.0\nlon0 = 11.0\nlon1 = 31.0\n"
        "land_mask = synthetic\n[model]\nnlayers = 3\n"
        "[Modules]\nNextsim::IThermodynamics = Nextsim::ThermoWinton\n"
    ))
    assert run("--config-file", cfg) == 0
    state = load_coupled_state("coupled_restart.chk", **CPU32)
    assert state.tice.shape == (3, 16, 16)
    for leaf in (state.hice, state.cice, state.tice, state.velocity.u):
        assert torch.all(torch.isfinite(leaf))
    land = torch.from_numpy(synthetic_coastline(16) == 0.0)
    assert land.any()
    assert torch.all(state.hice[0][land] == 0.0)
    assert torch.all(state.velocity.u[land] == 0.0)
    assert float(state.velocity.u.abs().max()) > 0.0


def test_coupled_cli_periodic_x_override(tmp_path, monkeypatch):
    """dynamics.periodic_x = false unwraps a full ring (the explicit
    override beats the 360-degree auto rule): walls change the flow."""
    monkeypatch.chdir(tmp_path)
    ring = "geometry = spherical\nlat0 = 60.0\nlat1 = 75.0\nlon0 = 0.0\nlon1 = 360.0\n"
    assert run("--config-file", write_cfg(tmp_path, extra=ring)) == 0
    shutil.move("coupled_restart.chk", "wrapped.chk")
    fresh()
    assert run("--config-file", write_cfg(tmp_path, extra=ring + "periodic_x = false\n")) == 0
    a = load_coupled_state("wrapped.chk", **CPU32)
    b = load_coupled_state("coupled_restart.chk", **CPU32)
    # Closed x walls pin u = 0 on the seam; the wrapped ring does not.
    assert not torch.allclose(a.velocity.u, b.velocity.u)


def test_coupled_cli_adaptive_alpha(tmp_path, monkeypatch):
    """dynamics.adaptive_alpha switches the CG1 solver to aEVP-style
    per-node relaxation; the run completes finite and differs from the
    fixed-alpha run."""
    monkeypatch.chdir(tmp_path)
    assert run("--config-file", write_cfg(tmp_path)) == 0
    shutil.move("coupled_restart.chk", "fixed.chk")
    fresh()
    assert run("--config-file", write_cfg(tmp_path, extra="adaptive_alpha = true\n")) == 0
    ua = load_coupled_state("fixed.chk", **CPU32).velocity.u
    ub = load_coupled_state("coupled_restart.chk", **CPU32).velocity.u
    assert torch.all(torch.isfinite(ub))
    assert not torch.allclose(ua, ub)
    assert float(ub.abs().max()) < 1.0


def test_checkpoint_cadence(tmp_path, monkeypatch):
    """The engine's checkpoint cadence (tests/test_parity_extras.py:42):
    dev1 for 6 steps with a checkpoint every 2 writes chk.{2,4,6}.nc and
    the final restart.nc."""
    from nextsimdg_tpu_torch.runtime.main import main
    from nextsimdg_tpu_torch.tools.make_dev_restart import make_dev_restart

    monkeypatch.chdir(tmp_path)
    make_dev_restart("dev1.res.nc")
    (tmp_path / "run.cfg").write_text(
        "[model]\ninit_file = dev1.res.nc\nstart = 0\nstop = 6\ntime_step = 1\n"
        "checkpoint_period = 2\ncheckpoint_pattern = chk.{step}.nc\n"
    )
    assert main(["nextsim", "--config-file", "run.cfg", "--cpu"]) == 0
    assert sorted(glob.glob("chk.*.nc")) == ["chk.2.nc", "chk.4.nc", "chk.6.nc"]
    assert os.path.exists("restart.nc")


# -- what the port does of its own ----------------------------------------------
@pytest.mark.parametrize("extra, error, words", [
    ("[parallel]\nmode = gspmd\n", ValueError, "mode = shardmap"),
    ("[parallel]\nmode = pjit\n", ValueError, "unknown parallel.mode"),
], ids=["gspmd", "unknown-mode"])
def test_unported_parallel_modes_raise(tmp_path, monkeypatch, extra, error, words):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(error, match=words):
        run("--config-file", write_cfg(tmp_path, extra=extra))
    assert not os.path.exists("coupled_restart.chk")


ERA5_BOX = "lat0 = 71.0\nlat1 = 79.0\nlon0 = 11.0\nlon1 = 31.0\n"


@pytest.mark.parametrize("forcing", ["archive:forcing.h5", "era5:era5.nc"])
def test_file_forcings_raise_naming_part_2(tmp_path, monkeypatch, forcing):
    """The file forcings (ROADMAP M8b part 2; they raised until it was
    ported, hence the name) run on the Cartesian box and finish with a
    checkpoint: the twin of tests/test_coupled_main.py:58 (era5:, regridded
    onto the lat0..lat1, lon0..lon1 box) and the same with an archive."""
    from tests.test_era5 import _write_era5

    monkeypatch.chdir(tmp_path)
    if forcing.startswith("era5:"):
        _write_era5(str(tmp_path / "era5.nc"))
    else:
        write_archive(tmp_path / "forcing.h5")
    assert run("--config-file", write_cfg(tmp_path, forcing=forcing, extra=ERA5_BOX)) == 0
    assert os.path.exists("era5_forcing.h5") == forcing.startswith("era5:")
    assert load_time("coupled_restart.chk") == 1800.0
    state = load_coupled_state("coupled_restart.chk", **CPU32)
    for leaf in (state.hice, state.cice, state.sst):
        assert torch.all(torch.isfinite(leaf))
    # The files' winds (u10 ~ 5 m/s; the archive's u_atm 2-12) set the ice drifting.
    assert float(state.velocity.u.abs().max()) > 0.0
    assert len(read_diagnostics("diag.h5")["time"]) == 3


def test_coupled_cli_spherical_geometry_with_era5(tmp_path, monkeypatch):
    """geometry = spherical: the lon-lat metric mesh; ERA5 regrids onto its
    own element centres (tests/test_coupled_main.py:79)."""
    from tests.test_era5 import _write_era5

    monkeypatch.chdir(tmp_path)
    _write_era5(str(tmp_path / "era5.nc"))
    cfg = write_cfg(tmp_path, forcing="era5:era5.nc", extra="geometry = spherical\n" + ERA5_BOX)
    assert run("--config-file", cfg) == 0
    state = load_coupled_state("coupled_restart.chk", **CPU32)
    for leaf in (state.hice, state.cice, state.velocity.u):
        assert torch.all(torch.isfinite(leaf))
    assert float(state.velocity.u.abs().max()) > 0.0


def test_coupled_cli_pan_arctic_config(tmp_path, monkeypatch):
    """The pan-Arctic stack from ERA5 (tests/test_coupled_main.py:112): the
    lon-lat mesh, the synthetic coastline, ERA5 forcing and Winton's 3
    layers; land stays ice-free and no-slip."""
    from tests.test_era5 import _write_era5

    monkeypatch.chdir(tmp_path)
    _write_era5(str(tmp_path / "era5.nc"))
    cfg = write_cfg(tmp_path, forcing="era5:era5.nc", extra=(
        "geometry = spherical\n" + ERA5_BOX + "land_mask = synthetic\n[model]\nnlayers = 3\n"
        "[Modules]\nNextsim::IThermodynamics = Nextsim::ThermoWinton\n"
    ))
    assert run("--config-file", cfg) == 0
    state = load_coupled_state("coupled_restart.chk", **CPU32)
    assert state.tice.shape == (3, 16, 16)
    for leaf in (state.hice, state.cice, state.tice, state.velocity.u):
        assert torch.all(torch.isfinite(leaf))
    land = torch.from_numpy(synthetic_coastline(16) == 0.0)
    assert land.any()
    assert torch.all(state.hice[0][land] == 0.0)
    assert torch.all(state.velocity.u[land] == 0.0)
    assert float(state.velocity.u.abs().max()) > 0.0


def test_bad_on_nonfinite_raises_when_the_config_is_read(tmp_path, monkeypatch):
    """With health off (health_period = 0) a wrong on_nonfinite still
    raises, before any step (the JAX package's CLI accepts it there)."""
    monkeypatch.chdir(tmp_path)
    cfg = write_cfg(tmp_path, extra="[model]\nhealth_period = 0\non_nonfinite = carry-on\n")
    with pytest.raises(ValueError, match="on_nonfinite"):
        run("--config-file", cfg)
    assert not os.path.exists("coupled_restart.chk")


def test_without_a_card_the_cli_returns_2(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run_coupled(["prog", "--config-file", write_cfg(tmp_path)]) == 2
    assert not os.path.exists("coupled_restart.chk")
