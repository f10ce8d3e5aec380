"""``nextsimdg_tpu_torch.utils.profiling`` on the CPU: ``device_trace``
writes a Chrome trace into its directory that names the ``annotate``d
region and the port's operations inside it (here a coupled step at 8 x 8),
also when the block raises, and asks for no CUDA activity without a card.
"""

import json

import pytest
import torch

from nextsimdg_tpu_torch.coupled import CoupledModel
from nextsimdg_tpu_torch.dynamics import DynamicsForcing, MEVPParams, RectMesh
from nextsimdg_tpu_torch.runtime.coupled_main import PHYSICS_FORCING
from nextsimdg_tpu_torch.state import Forcing
from nextsimdg_tpu_torch.utils.profiling import annotate, device_trace

torch.set_num_threads(1)


def trace_events(log_dir) -> list:
    (path,) = list(log_dir.glob("trace_*.json"))
    return json.loads(path.read_text())["traceEvents"]


def test_device_trace_names_the_annotation_and_the_step(tmp_path):
    model = CoupledModel(RectMesh(8, 8, 4000.0, 4000.0), degree=1, mevp_params=MEVPParams(), n_subcycles=2)
    cpu = {"device": "cpu", "dtype": torch.float32}
    state = model.initial_state(hice0=1.0, cice0=0.9, hsnow0=0.05, nlayers=1, **cpu)
    full = lambda v: torch.full((8, 8), v, **cpu)  # noqa: E731
    phys = Forcing(**{k: full(v) for k, v in PHYSICS_FORCING.items()}, wind=full(5.0))
    dyn = DynamicsForcing(u_atm=full(5.0), v_atm=full(1.0), u_ocean=full(0.0), v_ocean=full(0.0))
    with device_trace(str(tmp_path / "trace")) as prof:
        with annotate("nextsim-step"):
            out = model.step(state, phys, dyn, 600.0)
    assert torch.all(torch.isfinite(out.hice))
    assert torch.profiler.ProfilerActivity.CUDA not in prof.activities
    names = {event.get("name") for event in trace_events(tmp_path / "trace")}
    assert "nextsim-step" in names
    assert {"aten::mul", "aten::add"} <= names


def test_device_trace_is_written_when_the_block_raises(tmp_path):
    with pytest.raises(RuntimeError, match="boom"):
        with device_trace(str(tmp_path), device="cpu"):
            with annotate("failing-region"):
                torch.ones(4).sum()
                raise RuntimeError("boom")
    assert "failing-region" in {event.get("name") for event in trace_events(tmp_path)}
