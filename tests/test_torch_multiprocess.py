"""The rank grid across real processes: the port against the JAX package.

The twin of ``tests/test_multiprocess.py``. These tests spawn separate
Python processes (``nextsimdg_tpu_torch.parallel.multiprocess.launch``),
join them with ``torch.distributed`` over gloo (a ``file://`` rendezvous in
the run's directory), spread a 2 x 2 (or 2 x 4) rank grid over them, step
the coupled model at float64 on the CPU, gather the result to process 0
and hold it against the port's single domain and in-process grid (exactly)
and against JAX's single-device ``CoupledModel.step`` on the same inputs,
run here (1e-8 of each plane's max, as ``tests/test_torch_parallel.py``
holds JAX's XLA mEVP). Also: the health probe over processes, the gathered
checkpoint written once, and that a failing worker, a hung exchange and the
``gspmd`` path end as errors.
"""

import json
import time

import numpy as np
import pytest
import torch

from nextsimdg_tpu.parallel.multiprocess import _build_problem as jax_build_problem
from nextsimdg_tpu_torch import interop
from nextsimdg_tpu_torch.parallel.multiprocess import launch, load_saved_state

torch.set_num_threads(1)

PATHS = ("blocked", "shardmap", "blocked-ring")
N, STEPS, N_SUBCYCLES = 16, 2, 10
#: Seconds a worker waits for another rank or process.
WAIT = "60"


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    """2 processes x 2 ranks on the three paths; (verdicts, saved states)."""
    out = tmp_path_factory.mktemp("mp2")
    saved = out / "states"
    saved.mkdir()
    results = launch(
        2, 2, paths=PATHS, n=N, steps=STEPS, n_subcycles=N_SUBCYCLES, device="cpu", out_dir=str(out),
        timeout=300, worker_args=("--save-dir", str(saved), "--timeout", WAIT),
    )
    return results, saved


def test_two_process_run_matches_the_single_domain_and_the_thread_grid(two_processes):
    """2 processes x 2 ranks: blocked, the width-1 schedule, and the
    config-5 topology (the 360-degree ring, whose wrap crosses processes)."""
    results, _ = two_processes
    assert len(results) == 2
    for r in results:
        assert r["ok"], r
        assert (r["process_count"], r["local_devices"], r["global_devices"]) == (2, 2, 4)
        assert (r["backend"], r["host_staged"], r["dtype"]) == ("gloo", False, "torch.float64")
        for path in PATHS:
            entry = r["paths"][path]
            assert entry["mesh"] == "2x2"
            # Every process got the same answers of the probe: the healthy
            # state passes, and one NaN in the last process fails it.
            assert entry["finite_probe"] is True
            assert entry["finite_probe_detects"] is True
    paths = results[0]["paths"]
    assert paths["shardmap"]["schedule"] == ["xla", "xla"]
    assert paths["blocked"]["schedule"][0] == paths["blocked-ring"]["schedule"][0] == "blocked"
    for path in PATHS:
        assert paths[path]["single_max_abs_error"] == 0.0
        assert paths[path]["threads_max_abs_error"] == 0.0
        # Gathered, written once by process 0 and read back bit for bit.
        assert paths[path]["checkpoint"] == "gathered-written-once-roundtripped"
        assert paths[path]["checkpoint_max_abs_error"] == 0.0
        assert "checkpoint" not in results[1]["paths"][path]


@pytest.mark.parametrize("path", PATHS)
def test_two_process_run_matches_jax_single_device_step(two_processes, path):
    import jax.numpy as jnp

    _, saved = two_processes
    got = load_saved_state(saved / f"{path}.npz")
    _, model, state, pf, df = jax_build_problem(N, N, N_SUBCYCLES, jnp.float64, spherical_ring=path.endswith("-ring"))
    for _ in range(STEPS):
        state = model.step(state, pf, df, dt=600.0)
    ref = interop.coupled_state_to_numpy(state)
    flat = {**{k: v for k, v in ref.items() if k != "velocity"},
            **{f"velocity/{k}": v for k, v in ref["velocity"].items()}}
    assert sorted(flat) == sorted(got)
    for name, r in flat.items():
        r = np.asarray(r)
        scale = float(np.max(np.abs(r)))
        np.testing.assert_allclose(got[name], r, rtol=1e-8, atol=1e-8 * scale, err_msg=name)
    assert np.all(np.isfinite(got["velocity/u"])) and float(np.max(np.abs(got["velocity/u"]))) > 0.0


def test_four_process_run_matches_the_single_domain():
    """4 processes x 2 ranks = a 2 x 4 grid, both axes crossing processes."""
    results = launch(4, 2, paths=("blocked",), n=N, steps=STEPS, n_subcycles=N_SUBCYCLES, device="cpu",
                     timeout=300, worker_args=("--timeout", WAIT))
    assert len(results) == 4
    for r in results:
        assert r["ok"], r
        assert (r["process_count"], r["global_devices"]) == (4, 8)
        assert r["paths"]["blocked"]["mesh"] == "2x4"
        assert r["paths"]["blocked"]["finite_probe_detects"] is True
    entry = results[0]["paths"]["blocked"]
    assert entry["single_max_abs_error"] == 0.0 and entry["threads_max_abs_error"] == 0.0


def test_gspmd_path_raises():
    with pytest.raises(RuntimeError, match="ValueError: gspmd"):
        launch(2, 2, paths=("gspmd",), device="cpu", timeout=120, worker_args=("--timeout", WAIT))


def test_a_failing_worker_makes_launch_raise():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="injected failure"):
        launch(2, 2, paths=("blocked",), device="cpu", timeout=120,
               worker_args=("--timeout", WAIT, "--inject", "raise", "--inject-process", "1"))
    # The failure stops every process at once (the others' connections
    # close), well before any wait's limit.
    assert time.perf_counter() - t0 < 40.0


def test_a_hung_exchange_times_out_as_an_error():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="TimeoutError"):
        launch(2, 2, paths=("blocked",), device="cpu", timeout=120,
               worker_args=("--timeout", "3", "--inject", "hang", "--inject-process", "1"))
    assert time.perf_counter() - t0 < 60.0



def test_cuda_without_a_card_raises(monkeypatch, tmp_path):
    """No fallback to the CPU: the launcher refuses before it spawns, and a
    worker asked for the card reports the error without joining a group."""
    from nextsimdg_tpu_torch.parallel import distributed, multiprocess

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        launch(2, 2, device="cuda")
    joined = []
    monkeypatch.setattr(distributed, "initialize", lambda *a, **k: joined.append(a))
    out = tmp_path / "proc0.json"
    rc = multiprocess.worker_main([
        "--coordinator", f"file://{tmp_path / 'rdv'}", "--num-processes", "2", "--process-id", "0",
        "--out", str(out), "--device", "cuda",
    ])
    result = json.loads(out.read_text())
    assert rc == 1 and not result["ok"] and "no CUDA card" in result["error"]
    assert joined == []
