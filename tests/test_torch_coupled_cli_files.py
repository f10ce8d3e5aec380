"""The port's coupled CLI on file forcing against the JAX package's CLI on
the same config and the same files.

Both CLIs run at float32 on the CPU, 3 steps of 10 subcycles on 16 x 16
(the JAX one as its tests run it, with ``blocked-interpret`` on the rank
grid, whose port counterpart is ``blocked``): ``archive:`` on the Cartesian
box with CG1 (an archive of all twelve fields, random in time and space,
whose records bracket the steps), ``era5:`` on the pan-Arctic stack (the HO
solver on the spherical lon-lat window with the synthetic coastline and
Winton's 3 layers; ``tests/test_coupled_main.py:112`` with the HO solver),
both again through ``[parallel]`` on 2 x 2 ranks, and ``retry-halved``
health with the archive, the second full step poisoned in both packages,
so that the dt/2 replay reads the archive at 600, 900 and 1200 s. Every leaf
of the final checkpoint (and of the diagnostics rows) must agree to the
tolerances of ``tests/test_torch_coupled_cli_parity.py``: ``TOL`` of its
plane's max, ``TOL_HO`` with the HO solver.

Also: at float64 the port CLI's final state on an archive, with the dt/2
replay, equals a direct loop of ``CoupledModel.step`` fed the same
provider's forcing at the same times, exactly.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from nextsimdg_tpu.coupled import CoupledModel as JaxCoupledModel
from nextsimdg_tpu.io.coupled_restart import load_coupled_state as jax_load
from nextsimdg_tpu.io.diagnostics import read_diagnostics as jax_read_diagnostics
from nextsimdg_tpu_torch.coupled import CoupledModel
from nextsimdg_tpu_torch.dynamics import MEVPParams, RectMesh
from nextsimdg_tpu_torch.interop import coupled_state_to_numpy
from nextsimdg_tpu_torch.io.coupled_restart import load_coupled_state
from nextsimdg_tpu_torch.io.diagnostics import read_diagnostics
from nextsimdg_tpu_torch.io.forcing_file import ForcingProvider
from tests.test_era5 import _write_era5
from tests.test_torch_coupled_cli import CPU32, clean_port, fresh, run, write_archive, write_cfg  # noqa: F401
from tests.test_torch_coupled_cli_parity import TOL, TOL_HO, leaves, run_jax

torch.set_num_threads(1)

PAN_ARCTIC = (
    "geometry = spherical\nlat0 = 71.0\nlat1 = 79.0\nlon0 = 11.0\nlon1 = 31.0\nland_mask = synthetic\n"
    "[model]\nnlayers = 3\n"
    "[Modules]\nNextsim::IThermodynamics = Nextsim::ThermoWinton\nNextsim::IDynamics = Nextsim::MEVPHighOrder\n"
)
GRID = "[parallel]\nmode = shardmap\nmesh_shape = 2x2\nmevp_backend = {}\nmevp_block_halo = 4\n"
HEALTH = "[model]\nhealth_period = 1\non_nonfinite = retry-halved\n"
#: name: (forcing, the config's tail, ``{}`` the rank grid's mEVP backend;
#: high order)
CONFIGS = {
    "archive_cartesian": ("archive:forcing.h5", "", False),
    "era5_pan_arctic": ("era5:era5.nc", PAN_ARCTIC, True),
    "archive_cartesian_2x2": ("archive:forcing.h5", GRID, False),
    "era5_pan_arctic_2x2": ("era5:era5.nc", PAN_ARCTIC + GRID, True),
}


def write_files(tmp_path) -> None:
    write_archive(tmp_path / "forcing.h5")
    _write_era5(str(tmp_path / "era5.nc"))


def assert_close(got: dict, want: dict, tol: float) -> None:
    assert got.keys() == want.keys()
    for leaf, ref in want.items():
        assert got[leaf].dtype == ref.dtype == np.float32, leaf
        scale = float(np.abs(ref).max()) or 1.0
        err = float(np.abs(got[leaf] - ref).max())
        assert err <= tol * scale, f"{leaf}: {err:.3e} > {tol:g} x {scale:.3e}"


def compare_runs(tol: float) -> None:
    """The port's coupled_restart.chk and diag.h5 against the JAX CLI's
    (jax.chk, jax_diag.h5)."""
    want = dict(leaves(coupled_state_to_numpy(jax_load("jax.chk"))))
    got = dict(leaves(coupled_state_to_numpy(load_coupled_state("coupled_restart.chk", **CPU32))))
    assert_close(got, want, tol)
    got, want = read_diagnostics("diag.h5"), jax_read_diagnostics("jax_diag.h5")
    assert got["time"].tolist() == want["time"].tolist() == [600.0, 1200.0, 1800.0]
    assert_close({k: v for k, v in got.items() if k != "time"}, {k: v for k, v in want.items() if k != "time"}, tol)


def run_both(tmp_path, monkeypatch, forcing: str, tail: str) -> None:
    """The JAX CLI, then the port's, on the same config and files."""
    monkeypatch.chdir(tmp_path)
    write_files(tmp_path)
    run_jax(write_cfg(tmp_path, forcing, tail.format("blocked-interpret"), name="jax.cfg"))
    shutil.move("coupled_restart.chk", "jax.chk")
    shutil.move("diag.h5", "jax_diag.h5")
    fresh()
    assert run("--config-file", write_cfg(tmp_path, forcing, tail.format("blocked"))) == 0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_cli_on_files_matches_the_jax_cli(tmp_path, monkeypatch, name):
    forcing, tail, high_order = CONFIGS[name]
    run_both(tmp_path, monkeypatch, forcing, tail)
    compare_runs(TOL_HO if high_order else TOL)


def poison_second_full_step(monkeypatch, cls, nan, full_dt=600.0) -> dict:
    """cls.step poisoned on its second call at the full dt; counts calls."""
    original = cls.step
    calls = {"full": 0, "half": 0}

    def step(self, state, phys, dyn, dt, **kw):
        out = original(self, state, phys, dyn, dt, **kw)
        calls["full" if dt == full_dt else "half"] += 1
        if dt == full_dt and calls["full"] == 2:
            out = dataclasses.replace(out, hice=out.hice * nan)
        return out

    monkeypatch.setattr(cls, "step", step)
    return calls


def test_health_retry_halved_on_an_archive_matches_the_jax_cli(tmp_path, monkeypatch):
    """The second full step blows up in both packages; each replays it as
    two half steps that read the archive at 600 and 900 s."""
    jax_calls = poison_second_full_step(monkeypatch, JaxCoupledModel, jnp.nan)
    port_calls = poison_second_full_step(monkeypatch, CoupledModel, float("nan"))
    run_both(tmp_path, monkeypatch, "archive:forcing.h5", HEALTH)
    assert jax_calls == port_calls == {"full": 3, "half": 2}
    compare_runs(TOL)


def test_cli_on_an_archive_equals_a_direct_loop(tmp_path, monkeypatch):
    """float64, health retry-halved with the second full step poisoned: the
    CLI's final state equals CoupledModel.step at 600, 300, 300, 600 s fed
    the provider's physics and dynamics forcing at 0, 600, 900 and 1200 s."""
    monkeypatch.chdir(tmp_path)
    write_archive(tmp_path / "forcing.h5")
    calls = poison_second_full_step(monkeypatch, CoupledModel, float("nan"))
    assert run("--config-file", write_cfg(tmp_path, "archive:forcing.h5", HEALTH), "--float64") == 0
    assert calls == {"full": 3, "half": 2}
    got = load_coupled_state("coupled_restart.chk", device="cpu", dtype=torch.float64)
    monkeypatch.undo()

    cpu64 = {"device": "cpu", "dtype": torch.float64}
    model = CoupledModel(RectMesh(16, 16, 32000.0, 32000.0), degree=1, mevp_params=MEVPParams(), n_subcycles=10)
    state = model.initial_state(hice0=1.0, cice0=0.9, hsnow0=0.05, nlayers=1, **cpu64)
    provider = ForcingProvider(str(tmp_path / "forcing.h5"), **cpu64)
    for t, dt in ((0.0, 600.0), (600.0, 300.0), (900.0, 300.0), (1200.0, 600.0)):
        phys, dyn = provider.thermo_forcing(t, 16, 16), provider.dynamics_forcing(t, 16, 16)
        state = model.step(state, phys, dyn, dt)
    want = dict(leaves(coupled_state_to_numpy(state)))
    for leaf, value in leaves(coupled_state_to_numpy(got)):
        np.testing.assert_array_equal(value, want[leaf], err_msg=leaf)
