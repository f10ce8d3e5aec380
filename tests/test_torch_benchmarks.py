"""The port's battery (``nextsimdg_tpu_torch.benchmarks.run_benchmarks``) and
``mevp_large`` at tiny sizes on the CPU: every config and schedule runs and
reports, the names are the JAX battery's, and without a card the command
lines refuse to measure."""

import importlib.util
import inspect
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from nextsimdg_tpu_torch import modules
from nextsimdg_tpu_torch.benchmarks import mevp_large, run_benchmarks

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TINY = {"n": 16, "n_subcycles": 2, "chunk": 1}


def _tiny(fn) -> dict:
    params = inspect.signature(fn).parameters
    return {k: v for k, v in TINY.items() if k in params}


@pytest.mark.parametrize("name", list(run_benchmarks.CONFIGS))
def test_each_config_runs_and_reports(name):
    result = run_benchmarks.run_config(name, "cpu", **_tiny(run_benchmarks.CONFIGS[name]))
    assert {"metric", "value", "unit", "config", "device"} <= set(result)
    assert result["config"] == name and result["device"] == {"platform": "cpu"}
    assert result["value"] > 0 and result["chunk"] == 1
    # The HO configs select the solver in the registry and reset it.
    assert modules.get_loader().selected_name("Nextsim::IDynamics") == "Nextsim::MEVPDynamics"


def test_multihost_runs_on_a_rank_grid():
    result = run_benchmarks.run_config("multihost_16m", "cpu", ranks=(2, 2), **TINY)
    assert "2x2 rank grid" in result["metric"] and result["value"] > 0


def test_config_names_are_the_jax_battery_names():
    spec = importlib.util.spec_from_file_location(
        "jax_benchmarks_run_benchmarks", REPO / "benchmarks" / "run_benchmarks.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert set(run_benchmarks.CONFIGS) <= set(module.CONFIGS)


@pytest.mark.parametrize("backend", list(mevp_large.SCHEDULES))
def test_mevp_large_runs_each_schedule(backend):
    assert mevp_large.bench(16, backend, n_sub=2, outer=1, reps=1, device="cpu") > 0


def test_mevp_large_tile_configuration_is_for_tiled_schedules_only():
    assert mevp_large.bench(16, "pallas-tiled", n_sub=2, outer=1, device="cpu", tile=8, halo=2) > 0
    with pytest.raises(ValueError, match="tile"):
        mevp_large.bench(16, "single", n_sub=2, outer=1, device="cpu", tile=8)


def test_entry_points_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_benchmarks.run_config("box")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mevp_large.bench(16, "plain")
    for module in ("run_benchmarks", "mevp_large"):
        done = subprocess.run(
            [sys.executable, "-m", f"nextsimdg_tpu_torch.benchmarks.{module}"],
            cwd=REPO, capture_output=True, text=True, timeout=300,
        )
        assert done.returncode != 0 and not done.stdout
    done = subprocess.run(
        [sys.executable, "-m", "nextsimdg_tpu_torch.benchmarks.run_benchmarks", "advection"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert done.returncode == 2 and "unknown" in done.stderr
