"""The port's coupled CLI against the JAX package's on the same config.

Both CLIs run at float32 on the CPU (the JAX one as its tests run it, with
``blocked-interpret`` on the rank grid, whose port counterpart is
``blocked``), 3 steps of 10 subcycles on 16 x 16; every leaf of the final
checkpoint must agree to ``TOL`` of its plane's max (``TOL_HO`` with the
HO solver). Measured on the CPU: at most 7.4e-6 on the CG1 configs (the
stresses), 1.6e-5 with the HO solver (its stresses): single-ulp
differences (CPU PyTorch multiplies a float32 tensor by a Python scalar in
double) that the mEVP's pseudo-time iteration amplifies. The tracers
agree to ~2e-10, tice and new_ice to ~1e-7.

Also: the CLI's run loop adds nothing (at float64 the port CLI's final state
equals a direct loop of ``CoupledModel.step`` on the same fields, cyclone
forcing included, exactly), and a JAX checkpoint resumes the port CLI
through ``model.init_file``.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from nextsimdg_tpu.config import Configurator as JaxConfigurator
from nextsimdg_tpu.io.coupled_restart import load_coupled_state as jax_load
from nextsimdg_tpu.modules import ModuleRegistry as JaxRegistry
from nextsimdg_tpu.runtime.coupled_main import run_coupled as jax_run
from nextsimdg_tpu_torch.coupled import CoupledModel
from nextsimdg_tpu_torch.dynamics import MEVPParams, RectMesh
from nextsimdg_tpu_torch.interop import coupled_state_to_numpy
from nextsimdg_tpu_torch.io.coupled_restart import load_coupled_state
from nextsimdg_tpu_torch.io.forcing_pipeline import ForcingPipeline
from nextsimdg_tpu_torch.runtime.coupled_main import PHYSICS_FORCING, cyclone_forcing
from nextsimdg_tpu_torch.state import Forcing
from tests.test_torch_coupled_cli import CPU32, clean_port, fresh, run, write_cfg  # noqa: F401

torch.set_num_threads(1)

TOL = 2e-5
TOL_HO = 5e-5

SHARDMAP = "[parallel]\nmode = shardmap\nmesh_shape = 4x2\nmevp_backend = {}\nmevp_block_halo = 4\n"
#: name: (forcing, the config's tail; ``{}`` is the rank grid's mEVP backend)
CONFIGS = {
    "constant": ("constant", ""),
    "cyclone": ("cyclone", ""),
    "spherical_land_mask": ("constant", (
        "geometry = spherical\nlat0 = 71.0\nlat1 = 79.0\nlon0 = 11.0\nlon1 = 31.0\n"
        "land_mask = synthetic\n"
    )),
    "high_order": ("constant", "[Modules]\nNextsim::IDynamics = Nextsim::MEVPHighOrder\n"),
    "shardmap_4x2": ("constant", SHARDMAP),
}


def leaves(d: dict, prefix=""):
    for key, value in d.items():
        if isinstance(value, dict):
            yield from leaves(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(value)


def run_jax(cfg: str) -> None:
    JaxConfigurator.clear()
    JaxRegistry.get_loader().reset()
    try:
        assert jax_run(["prog", "--config-file", cfg]) == 0
    finally:
        JaxConfigurator.clear()
        JaxRegistry.get_loader().reset()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_cli_matches_the_jax_cli(tmp_path, monkeypatch, name):
    monkeypatch.chdir(tmp_path)
    forcing, tail = CONFIGS[name]
    run_jax(write_cfg(tmp_path, forcing, tail.format("blocked-interpret"), name="jax.cfg"))
    shutil.move("coupled_restart.chk", "jax.chk")
    shutil.move("diag.h5", "jax_diag.h5")
    fresh()
    assert run("--config-file", write_cfg(tmp_path, forcing, tail.format("blocked"))) == 0
    want = dict(leaves(coupled_state_to_numpy(jax_load("jax.chk"))))
    got = dict(leaves(coupled_state_to_numpy(load_coupled_state("coupled_restart.chk", **CPU32))))
    assert got.keys() == want.keys()
    tol = TOL_HO if name == "high_order" else TOL
    for leaf, ref in want.items():
        assert got[leaf].dtype == ref.dtype == np.float32, leaf
        scale = float(np.abs(ref).max()) or 1.0
        err = float(np.abs(got[leaf] - ref).max())
        assert err <= tol * scale, f"{leaf}: {err:.3e} > {tol:g} x {scale:.3e}"


def test_cli_equals_a_direct_step_loop(tmp_path, monkeypatch):
    """float64, cyclone forcing, a coastline: the CLI's final state equals
    a loop of CoupledModel.step on the same fields exactly."""
    monkeypatch.chdir(tmp_path)
    mask = np.ones((16, 16))
    mask[:3, 5:9] = 0.0
    np.save(tmp_path / "mask.npy", mask)
    cfg = write_cfg(tmp_path, "cyclone", f"land_mask = {tmp_path / 'mask.npy'}\n")
    assert run("--config-file", cfg, "--float64") == 0
    got = load_coupled_state("coupled_restart.chk", device="cpu", dtype=torch.float64)

    fresh()
    cpu64 = {"device": "cpu", "dtype": torch.float64}
    model = CoupledModel(
        RectMesh(16, 16, 32000.0, 32000.0), degree=1, mevp_params=MEVPParams(), n_subcycles=10,
        ocean_mask=mask,
    )
    state = model.initial_state(hice0=1.0, cice0=0.9, hsnow0=0.05, nlayers=1, **cpu64)
    m = torch.from_numpy(mask)
    state = dataclasses.replace(state, hice=state.hice * m, cice=state.cice * m, hsnow=state.hsnow * m)
    full = lambda v: torch.full((16, 16), v, **cpu64)  # noqa: E731
    phys = Forcing(**{k: full(v) for k, v in PHYSICS_FORCING.items()}, wind=full(10.0))
    with ForcingPipeline.cyclone(16, 16, 32000.0, 32000.0, vmax_atm=10.0, r0=16 * 32000.0 / 5, dt=600.0) as pipe:
        for _ in range(3):
            state = model.step(state, phys, cyclone_forcing(pipe.next_fields(), **cpu64), 600.0)
    want = dict(leaves(coupled_state_to_numpy(state)))
    for leaf, value in leaves(coupled_state_to_numpy(got)):
        np.testing.assert_array_equal(value, want[leaf], err_msg=leaf)


def test_a_jax_checkpoint_resumes_the_port_cli(tmp_path, monkeypatch):
    """The state crosses between the packages: the JAX CLI runs 0 -> 1200 s
    and checkpoints; the port CLI resumes from that file through
    model.init_file and finishes at 1800 s next to the JAX CLI's own
    uninterrupted run (TOL of each plane's max)."""
    monkeypatch.chdir(tmp_path)
    run_jax(write_cfg(tmp_path, name="jax.cfg"))
    shutil.move("coupled_restart.chk", "jax_full.chk")
    (tmp_path / "resume.cfg").write_text(
        "[model]\nstart = 1200\nstop = 1800\ntime_step = 600\ninit_file = chk.2.chk\n"
        "[dynamics]\nnx = 16\nny = 16\ndx = 32000.0\ndy = 32000.0\n"
        "degree = 1\nsubcycles = 10\nthermo = true\nforcing = constant\nwind = 10.0\n"
    )
    fresh()
    assert run("--config-file", str(tmp_path / "resume.cfg")) == 0
    want = dict(leaves(coupled_state_to_numpy(jax_load("jax_full.chk"))))
    got = dict(leaves(coupled_state_to_numpy(load_coupled_state("coupled_restart.chk", **CPU32))))
    for leaf, ref in want.items():
        scale = float(np.abs(ref).max()) or 1.0
        assert float(np.abs(got[leaf] - ref).max()) <= TOL * scale, leaf
