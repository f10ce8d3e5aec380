"""The port's scaling harness at tiny sizes on the CPU: the twin of
``tests/test_benchmarks.py``'s scaling tests (``:11``, ``:31``). The
communication budget is the JAX harness's arithmetic, number for number."""

import os
import sys

import pytest
import torch

from nextsimdg_tpu_torch.benchmarks import scaling

torch.set_num_threads(1)


def test_scaling_harness_runs_on_1_and_2_ranks():
    t1, sel1 = scaling.run_once(["cpu"], local_n=8, chunk=1)
    t2, sel2 = scaling.run_once(["cpu"] * 2, local_n=8, chunk=1)
    assert t1 > 0 and t2 > 0
    # Path-selection telemetry: every cell reports its schedules.
    assert set(sel1) == {"mevp", "transport"}
    assert sel1["mevp"].startswith("blocked/h=")
    assert sel2["transport"] in ("xla", "tiled")


@pytest.mark.parametrize("local_n", [8, 64, 2048])
def test_comm_budget_is_the_jax_harness_arithmetic(local_n):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "benchmarks"))
    try:
        import scaling as jax_scaling
    finally:
        sys.path.pop(0)
    assert scaling.comm_budget(local_n) == jax_scaling.comm_budget(local_n)
    assert scaling.comm_budget(local_n, 120, 8) == jax_scaling.comm_budget(local_n, 120, 8)


def test_scaling_harness_explicit_paths():
    """The shardmap, blocked and rdma paths run and report finite
    throughput; the budget orders blocked below per-subcycle traffic."""
    budget = scaling.comm_budget(64)
    assert budget["blocked"]["messages"] < budget["shardmap"]["messages"]
    assert budget["blocked"]["bytes"] < budget["shardmap"]["bytes"]
    assert budget["rdma"]["bytes"] == budget["blocked"]["bytes"]
    for path in ("shardmap", "blocked", "rdma"):
        t, selected = scaling.run_once(["cpu"] * 2, local_n=8, chunk=1, path=path)
        assert t > 0
        if path == "shardmap":
            assert selected == {"mevp": "xla", "transport": "xla"}
        else:
            assert selected["mevp"] == f"{path}/h=4"


def test_scaling_process_leg():
    lines = scaling.run_multiprocess(2, 1, n=16, device="cpu", timeout=300)
    assert [(line["processes"], line["path"]) for line in lines] == [
        (1, "blocked"), (1, "shardmap"), (2, "blocked"), (2, "shardmap")
    ]
    for line in lines:
        assert line["single_max_abs_error"] == 0.0 and line["threads_max_abs_error"] == 0.0
        assert line["elements_per_s"] > 0 and len(line["ms_per_step"]) == 3
