"""The port's coupled CLI with ``[parallel] mode = shardmap`` on the rank
grid (``parallel.RankGrid``, ranks as CPU threads): the twins of
``tests/test_coupled_main.py:162`` (shardmap matches single, on 4 x 2 ranks),
``:195`` (the checkpoint and resume round trip inside shardmap) and ``:267``
(the full ring on shardmap), both on 2 x 2 ranks to keep the file short, ``tests/test_mesh_shape.py:72`` (mesh_shape unset) and
``tests/test_health.py:131`` (the health abort on a 4 x 2 grid); and the
CLI's run loop adds nothing: at float64 the CLI's final state equals a loop of
``ShardedCoupledModel.__call__`` exactly, with the cyclone forcing.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from nextsimdg_tpu_torch.coupled import CoupledModel
from nextsimdg_tpu_torch.dynamics import DynamicsForcing, MEVPParams, RectMesh
from nextsimdg_tpu_torch.interop import coupled_state_to_numpy
from nextsimdg_tpu_torch.io.coupled_restart import load_coupled_state, load_time
from nextsimdg_tpu_torch.io.forcing_pipeline import ForcingPipeline
from nextsimdg_tpu_torch.parallel import RankGrid, ShardedCoupledModel, build_sharded_coupled_model
from nextsimdg_tpu_torch.runtime.coupled_main import PHYSICS_FORCING, cyclone_forcing
from nextsimdg_tpu_torch.runtime.health import NonFiniteStateError
from nextsimdg_tpu_torch.state import Forcing
from tests.test_torch_coupled_cli import CPU32, clean_port, fresh, run, write_cfg  # noqa: F401

torch.set_num_threads(1)

PARALLEL = "[parallel]\nmode = shardmap\nmesh_shape = 4x2\nmevp_backend = blocked\nmevp_block_halo = 4\n"
PARALLEL_2X2 = PARALLEL.replace("4x2", "2x2")


def leaves(state) -> list:
    def walk(d):
        for v in d.values():
            yield from walk(v) if isinstance(v, dict) else (v,)

    return list(walk(coupled_state_to_numpy(state)))


def test_coupled_cli_shardmap_matches_single(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert run("--config-file", write_cfg(tmp_path, extra="[parallel]\nmode = single\n")) == 0
    shutil.move("coupled_restart.chk", "single.chk")
    fresh()
    assert run("--config-file", write_cfg(tmp_path, extra=PARALLEL)) == 0
    a = load_coupled_state("single.chk", **CPU32)
    b = load_coupled_state("coupled_restart.chk", **CPU32)
    for x, y in zip(leaves(a), leaves(b)):
        np.testing.assert_allclose(x, y, rtol=2e-5, atol=1e-7)


def test_coupled_cli_shardmap_checkpoint_resume_roundtrip(tmp_path, monkeypatch):
    """Checkpoint, stop, resume inside mode = shardmap: the resumed run
    reproduces an uninterrupted one, and the checkpoint is one file of
    global arrays."""
    monkeypatch.chdir(tmp_path)
    body = (
        "[dynamics]\nnx = 16\nny = 16\ndx = 32000.0\ndy = 32000.0\n"
        "degree = 1\nsubcycles = 10\nthermo = true\nforcing = constant\nwind = 10.0\n" + PARALLEL_2X2
    )
    (tmp_path / "long.cfg").write_text(
        "[model]\nstart = 0\nstop = 3000\ntime_step = 600\n"
        "diagnostics_file = diag_long.h5\ndiagnostics_period = 5\ncheckpoint_period = 0\n" + body
    )
    assert run("--config-file", str(tmp_path / "long.cfg")) == 0
    shutil.move("coupled_restart.chk", "uninterrupted.chk")

    # Interrupted: 0 -> 1800 with a checkpoint every 2 steps; chk.2.chk
    # (t = 1200) survives.
    fresh()
    assert run("--config-file", write_cfg(tmp_path, extra=PARALLEL_2X2)) == 0
    chk_files = sorted(f for f in os.listdir(".") if ".chk" in f)
    assert chk_files == ["chk.2.chk", "coupled_restart.chk", "uninterrupted.chk"], chk_files
    assert load_coupled_state("chk.2.chk", **CPU32).hice.shape == (3, 16, 16)

    (tmp_path / "resume.cfg").write_text(
        "[model]\nstart = 1200\nstop = 3000\ntime_step = 600\ninit_file = chk.2.chk\n"
        "diagnostics_file = diag_res.h5\ndiagnostics_period = 5\ncheckpoint_period = 0\n" + body
    )
    fresh()
    assert run("--config-file", str(tmp_path / "resume.cfg")) == 0
    a = load_coupled_state("uninterrupted.chk", **CPU32)
    b = load_coupled_state("coupled_restart.chk", **CPU32)
    for x, y in zip(leaves(a), leaves(b)):
        np.testing.assert_array_equal(x, y)


def test_coupled_cli_full_ring_auto_periodic(tmp_path, monkeypatch):
    """A 360-degree spherical span wraps in longitude by itself, and the
    ring runs on the rank grid."""
    monkeypatch.chdir(tmp_path)
    cfg = write_cfg(tmp_path, extra=(
        "geometry = spherical\nlat0 = 60.0\nlat1 = 75.0\nlon0 = 0.0\nlon1 = 360.0\n" + PARALLEL_2X2
    ))
    assert run("--config-file", cfg) == 0
    state = load_coupled_state("coupled_restart.chk", **CPU32)
    for leaf in (state.hice, state.cice, state.velocity.u):
        assert torch.all(torch.isfinite(leaf))
    assert float(state.velocity.u.abs().max()) > 0.0


def test_coupled_cli_shardmap_auto_shape_matches_single(tmp_path, monkeypatch):
    """mode = shardmap with no mesh_shape takes pick_mesh_shape of the
    devices (one, on the CPU) and reproduces the single-device run."""
    monkeypatch.chdir(tmp_path)
    assert run("--config-file", write_cfg(tmp_path, extra="[parallel]\nmode = single\n")) == 0
    shutil.move("coupled_restart.chk", "single.chk")
    fresh()
    built = []
    original = build_sharded_coupled_model

    def recorded(mesh, grid, **kwargs):
        built.append(grid.shape)
        return original(mesh, grid, **kwargs)

    monkeypatch.setattr("nextsimdg_tpu_torch.parallel.shardmap.build_sharded_coupled_model", recorded)
    cfg = write_cfg(tmp_path, extra="[parallel]\nmode = shardmap\nmevp_backend = blocked\nmevp_block_halo = 4\n")
    assert run("--config-file", cfg) == 0
    assert built == [(1, 1)]
    a = load_coupled_state("single.chk", **CPU32)
    b = load_coupled_state("coupled_restart.chk", **CPU32)
    for x, y in zip(leaves(a), leaves(b)):
        np.testing.assert_allclose(x, y, rtol=2e-5, atol=1e-7)


def test_shardmap_indivisible_grid_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = write_cfg(tmp_path, extra="[parallel]\nmode = shardmap\nmesh_shape = 3x2\n")
    with pytest.raises(ValueError, match="not divisible"):
        run("--config-file", cfg)


def test_health_abort_in_shardmap_mode(tmp_path, monkeypatch):
    """The probe runs over the 4 x 2 grid's resident blocks, and the
    post-mortem path still writes one global checkpoint of the last
    healthy state."""
    monkeypatch.chdir(tmp_path)
    cfg = write_cfg(tmp_path, extra=PARALLEL)
    (tmp_path / "health.cfg").write_text("[model]\nhealth_period = 1\n")
    original = ShardedCoupledModel.run_blocks
    calls = {"n": 0}

    def poisoned(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        calls["n"] += 1
        if calls["n"] == 2:  # blow up on the second model step
            out = [dataclasses.replace(b, hice=b.hice * float("nan")) for b in out]
        return out

    monkeypatch.setattr(ShardedCoupledModel, "run_blocks", poisoned)
    with pytest.raises(NonFiniteStateError):
        run("--config-file", cfg, "--config-file", str(tmp_path / "health.cfg"))
    assert os.path.exists("coupled_failed.post_mortem.chk")
    good = load_coupled_state("coupled_restart.chk", **CPU32)
    assert good.hice.shape == (3, 16, 16)  # global arrays, one file
    assert torch.all(torch.isfinite(good.hice))
    assert load_time("coupled_restart.chk") == 600.0


def test_cli_on_the_grid_equals_a_loop_of_the_global_step(tmp_path, monkeypatch):
    """float64, cyclone forcing on a 2 x 2 grid: the CLI's final state
    equals a loop of ShardedCoupledModel.__call__ on the same fields
    exactly (the resident blocks change nothing)."""
    monkeypatch.chdir(tmp_path)
    assert run("--config-file", write_cfg(tmp_path, forcing="cyclone", extra=PARALLEL_2X2), "--float64") == 0
    got = load_coupled_state("coupled_restart.chk", device="cpu", dtype=torch.float64)

    fresh()
    cpu64 = {"device": "cpu", "dtype": torch.float64}
    mesh = RectMesh(16, 16, 32000.0, 32000.0)
    kwargs = dict(degree=1, mevp_params=MEVPParams(), n_subcycles=10)
    model = CoupledModel(mesh, **kwargs)
    _, sharded = build_sharded_coupled_model(
        mesh, RankGrid(2, 2, "cpu"), mevp_backend="blocked", mevp_block_halo=4, **kwargs
    )
    state = model.initial_state(hice0=1.0, cice0=0.9, hsnow0=0.05, nlayers=1, **cpu64)
    full = lambda v: torch.full((16, 16), v, **cpu64)  # noqa: E731
    phys = Forcing(**{k: full(v) for k, v in PHYSICS_FORCING.items()}, wind=full(10.0))
    with ForcingPipeline.cyclone(
        16, 16, 32000.0, 32000.0, vmax_atm=10.0, r0=16 * 32000.0 / 5, dt=600.0,
    ) as pipe:
        for _ in range(3):
            dyn = cyclone_forcing(pipe.next_fields(), **cpu64)
            assert isinstance(dyn, DynamicsForcing)
            state = sharded(state, phys, dyn, 600.0)
    for x, y in zip(leaves(got), leaves(state)):
        np.testing.assert_array_equal(x, y)
