"""Failure detection and the dt/2 replay (``nextsimdg_tpu_torch.runtime.health``):
the twins of ``tests/test_health.py`` (its shardmap case, ``:131``, is in
``tests/test_torch_coupled_cli_grid.py``) and of the CLI's health cases
(``tests/test_coupled_main.py:313``, ``:357``), and what the port does
differently: the monitor keeps a clone of the healthy state, so a step
that writes into its input cannot poison a replay, and a cadence write at
a step the period does not probe is probed first.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from nextsimdg_tpu_torch.coupled import CoupledModel
from nextsimdg_tpu_torch.io.coupled_restart import load_coupled_state, load_time
from nextsimdg_tpu_torch.io.diagnostics import read_diagnostics
from nextsimdg_tpu_torch.runtime.health import HealthMonitor, NonFiniteStateError, finite_probe
from tests.test_torch_coupled_cli import CPU32, clean_port, run, write_cfg  # noqa: F401

torch.set_num_threads(1)


@dataclasses.dataclass
class ToyState:
    a: torch.Tensor
    b: torch.Tensor


def make_state(bad=False):
    a = torch.ones((4, 4))
    b = torch.zeros((4, 4))
    if bad:
        b[2, 2] = float("nan")
    return ToyState(a, b)


def test_finite_probe_detects_nan_and_inf():
    assert finite_probe(make_state())
    assert not finite_probe(make_state(bad=True))
    inf = torch.ones(3)
    inf[0] = float("inf")
    assert not finite_probe(ToyState(inf, torch.zeros(3)))
    # Non-tensor leaves (static metadata) are ignored, empty is fine.
    assert finite_probe({"meta": "name", "x": torch.ones(2)})
    assert finite_probe({})
    # A list of rank blocks is one state; integer tensors hold no NaN.
    assert not finite_probe([make_state(), make_state(bad=True)])
    assert finite_probe([make_state(), {"n": torch.arange(3)}])


def test_monitor_records_good_and_probes_on_period():
    mon = HealthMonitor(period=2, mode="abort")
    mon.record_good(0, 0.0, make_state())
    assert mon.after_step(1, 600.0, make_state()) == "ok"  # not due
    assert not mon.due(1)
    assert mon.due(2)
    assert mon.after_step(2, 1200.0, make_state()) == "ok"
    assert mon.last_good[0] == 2


def test_monitor_abort_mode_raises_with_last_good():
    mon = HealthMonitor(period=1, mode="abort")
    mon.record_good(0, 0.0, make_state())
    mon.after_step(1, 600.0, make_state())
    with pytest.raises(NonFiniteStateError) as err:
        mon.after_step(2, 1200.0, make_state(bad=True))
    assert err.value.step == 2
    assert err.value.last_good[0] == 1
    assert finite_probe(err.value.last_good[2])


def test_monitor_retry_halved_schedules_replay_then_recovers():
    mon = HealthMonitor(period=2, mode="retry-halved")
    good = make_state()
    mon.record_good(0, 0.0, good)
    assert mon.after_step(1, 600.0, good) == "ok"
    assert mon.after_step(2, 1200.0, make_state(bad=True)) == "rollback"
    step, t, state = mon.rollback_target()
    assert (step, t) == (0, 0.0)
    # The template holds the snapshot itself (`state is good`); the port's
    # is a clone of the recorded values.
    assert state is not good
    assert torch.equal(state.a, good.a) and torch.equal(state.b, good.b)
    # Replay the 2-step segment as 4 half-steps; healthy at segment end.
    assert mon.recovering
    assert mon.after_step(0, 300.0, good) == "ok"
    assert mon.after_step(0, 600.0, good) == "ok"
    assert mon.after_step(1, 900.0, good) == "ok"
    assert mon.recovering
    assert mon.after_step(2, 1200.0, good) == "ok"  # segment-end probe
    assert not mon.recovering
    assert mon.last_good[0] == 2
    # The retry re-arms after a successful recovery.
    assert mon.after_step(4, 2400.0, make_state(bad=True)) == "rollback"


def test_monitor_retry_halved_aborts_when_replay_fails_too():
    mon = HealthMonitor(period=1, mode="retry-halved")
    mon.record_good(0, 0.0, make_state())
    assert mon.after_step(1, 600.0, make_state(bad=True)) == "rollback"
    assert mon.after_step(0, 300.0, make_state(bad=True)) == "ok"  # mid-segment
    with pytest.raises(NonFiniteStateError):
        mon.after_step(1, 600.0, make_state(bad=True))  # segment-end probe


def test_monitor_disabled_when_period_zero():
    mon = HealthMonitor(period=0)
    assert mon.after_step(5, 0.0, make_state(bad=True)) == "ok"
    assert not mon.due(5)


def test_monitor_rejects_unknown_mode():
    with pytest.raises(ValueError):
        HealthMonitor(period=1, mode="carry-on")


def test_finite_probe_is_cheap_scalar_fetch():
    """One reduction; only a bool comes back."""
    big = ToyState(torch.ones((256, 256)), torch.ones((256, 256)))
    out = finite_probe(big)
    assert isinstance(out, bool) and out
    b = big.b.clone()
    b[100, 200] = float("inf")
    assert not finite_probe(ToyState(big.a, b))


# -- what the port does differently --------------------------------------------
def test_snapshot_survives_a_step_that_writes_into_its_input():
    """The monitor's snapshot is a clone: writing into the recorded state
    (as an in-place schedule writes into its carries) does not reach it,
    and each rollback hands out the recorded values, also after the last
    handed-out copy was written into."""
    mon = HealthMonitor(period=1, mode="retry-halved")
    state = make_state()
    mon.record_good(0, 0.0, state)
    state.a.fill_(float("nan"))  # the next step writes into its input
    assert mon.after_step(1, 600.0, state) == "rollback"
    _, _, restored = mon.rollback_target()
    assert torch.equal(restored.a, torch.ones((4, 4)))
    restored.a.fill_(float("nan"))
    _, _, again = mon.rollback_target()
    assert torch.equal(again.a, torch.ones((4, 4)))


def test_cli_replay_starts_from_the_recorded_values(tmp_path, monkeypatch):
    """A step that poisons its own input after stepping, and whose second
    full step blows up: the replay starts from the recorded step-1 state,
    which the step wrote into, and recovers. Had the monitor kept a
    reference, as the JAX package's does, the replay would start from NaN
    and abort."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "health.cfg").write_text("[model]\nhealth_period = 1\non_nonfinite = retry-halved\n")
    original = CoupledModel.step
    counts = {"full": 0, "half": 0}

    def clobbering_step(self, state, phys, dyn, dt, **kw):
        out = original(self, state, phys, dyn, dt, **kw)
        state.hice.fill_(float("nan"))  # writes into its input
        if dt == 600.0:
            counts["full"] += 1
            if counts["full"] == 2:
                out = dataclasses.replace(out, hice=out.hice * float("nan"))
        else:
            counts["half"] += 1
        return out

    monkeypatch.setattr(CoupledModel, "step", clobbering_step)
    assert run("--config-file", write_cfg(tmp_path), "--config-file", str(tmp_path / "health.cfg")) == 0
    assert counts == {"full": 3, "half": 2}
    diag = read_diagnostics("diag.h5")
    assert diag["time"].tolist() == [600.0, 1200.0, 1800.0]
    assert np.all(np.isfinite(diag["hice"]))
    assert torch.all(torch.isfinite(load_coupled_state("coupled_restart.chk", **CPU32).hice))


def test_cadence_writes_between_probes_hold_probed_states(tmp_path, monkeypatch):
    """health_period = 4, checkpoints and diagnostics every 3 steps, a NaN
    at step 5 in retry-halved mode: step 6's checkpoint and row are due
    before the period's next probe, so the CLI probes there first, rolls
    back to step 4 and writes them from the replay. Every checkpoint and
    every row is finite (the JAX package's CLI writes step 6's unprobed NaN)."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "run.cfg").write_text(
        "[model]\nstart = 0\nstop = 4800\ntime_step = 600\n"
        "diagnostics_file = diag.h5\ndiagnostics_period = 3\n"
        "checkpoint_period = 3\ncheckpoint_pattern = chk.{step}.chk\n"
        "health_period = 4\non_nonfinite = retry-halved\n"
        "[dynamics]\nnx = 16\nny = 16\ndx = 32000.0\ndy = 32000.0\n"
        "degree = 1\nsubcycles = 10\nthermo = true\nforcing = constant\nwind = 10.0\n"
    )
    original = CoupledModel.step
    counts = {"full": 0, "half": 0}

    def unstable_step(self, state, phys, dyn, dt, **kw):
        out = original(self, state, phys, dyn, dt, **kw)
        if dt == 600.0:
            counts["full"] += 1
            if counts["full"] == 5:
                out = dataclasses.replace(out, hice=out.hice * float("nan"))
        else:
            counts["half"] += 1
        return out

    monkeypatch.setattr(CoupledModel, "step", unstable_step)
    assert run("--config-file", str(tmp_path / "run.cfg")) == 0
    # Steps 5 and 6 replayed from step 4 as four half steps.
    assert counts == {"full": 8, "half": 4}
    for name in ("chk.3.chk", "chk.6.chk", "coupled_restart.chk"):
        state = load_coupled_state(name, **CPU32)
        for leaf in (state.hice, state.cice, state.velocity.u):
            assert torch.all(torch.isfinite(leaf)), name
    diag = read_diagnostics("diag.h5")
    assert diag["time"].tolist() == [1800.0, 3600.0]
    for name in ("hice", "cice", "hsnow", "sst", "sss"):
        assert np.all(np.isfinite(diag[name])), name


# -- the CLI's health cases ----------------------------------------------------
def test_coupled_cli_health_abort_writes_post_mortem(tmp_path, monkeypatch):
    """A NaN blowup mid-run aborts loudly, leaving a poisoned post-mortem
    checkpoint and a resumable last-good coupled_restart.chk."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "health.cfg").write_text("[model]\nhealth_period = 1\n")
    original = CoupledModel.step
    calls = {"n": 0}

    def poisoned_step(self, state, phys, dyn, dt, **kw):
        out = original(self, state, phys, dyn, dt, **kw)
        calls["n"] += 1
        if calls["n"] == 2:
            out = dataclasses.replace(out, hice=out.hice * float("nan"))
        return out

    monkeypatch.setattr(CoupledModel, "step", poisoned_step)
    with pytest.raises(NonFiniteStateError):
        run("--config-file", write_cfg(tmp_path), "--config-file", str(tmp_path / "health.cfg"))
    assert os.path.exists("coupled_failed.post_mortem.chk")
    bad = load_coupled_state("coupled_failed.post_mortem.chk", **CPU32)
    assert not torch.all(torch.isfinite(bad.hice))
    good = load_coupled_state("coupled_restart.chk", **CPU32)
    assert torch.all(torch.isfinite(good.hice))
    assert load_time("coupled_restart.chk") == 600.0


def test_coupled_cli_health_retry_halved_recovers(tmp_path, monkeypatch):
    """retry-halved: a transient instability at full dt is replayed at
    dt/2 and the run completes with an unbroken diagnostic series."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "health.cfg").write_text("[model]\nhealth_period = 1\non_nonfinite = retry-halved\n")
    original = CoupledModel.step
    counts = {"full": 0, "half": 0}

    def transiently_unstable_step(self, state, phys, dyn, dt, **kw):
        out = original(self, state, phys, dyn, dt, **kw)
        if dt == 600.0:
            counts["full"] += 1
            if counts["full"] == 2:
                out = dataclasses.replace(out, hice=out.hice * float("nan"))
        else:
            assert dt == 300.0
            counts["half"] += 1
        return out

    monkeypatch.setattr(CoupledModel, "step", transiently_unstable_step)
    assert run("--config-file", write_cfg(tmp_path), "--config-file", str(tmp_path / "health.cfg")) == 0
    assert counts["half"] == 2
    assert counts["full"] == 3
    diag = read_diagnostics("diag.h5")
    assert diag["time"].tolist() == [600.0, 1200.0, 1800.0]
    assert np.all(np.isfinite(diag["hice"]))
    assert os.path.exists("chk.2.chk")
    assert load_time("coupled_restart.chk") == 1800.0
