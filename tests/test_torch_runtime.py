"""The port's runtime (``nextsimdg_tpu_torch.runtime``) against the JAX
package's: the twin of ``tests/test_runtime.py``.

The dev1 run (BASELINE config 1) and 5 steps of a seeded 16 x 24 rectgrid
restart (ThermoIce0 on 1 layer, ThermoWinton on 3, checkpoints every 2 steps)
go through the JAX package's ``main()`` and the port's (CPU, float64) on the
same restart file; every restart field must agree to 1e-12 of its plane's
max. Also the Iterator, ``run_steps_scanned`` against the host loop, the
restart written when a run fails, the timers, and the entry point's refusal
to run without a card unless the CPU is asked for. Both packages'
Configurators and registries are reset around every test.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from nextsimdg_tpu.io import read_restart as jax_read_restart
from nextsimdg_tpu.runtime.main import main as jax_main
from nextsimdg_tpu_torch.config import Configurator, ConfiguredModule
from nextsimdg_tpu_torch.io import read_restart, write_restart_fields
from nextsimdg_tpu_torch.modules import get_loader
from nextsimdg_tpu_torch.runtime import Iterant, Iterator, Model
from nextsimdg_tpu_torch.runtime.main import main
from nextsimdg_tpu_torch.tools.make_dev_restart import (
    dev_restart_fields, make_dev_restart, seeded_rect_fields,
)
from nextsimdg_tpu_torch.utils import Chrono, ScopedTimer, Timer, main_timer

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FIELDS = ("hice", "cice", "hsnow", "sst", "sss", "tice")
CPU64 = {"device": "cpu", "dtype": torch.float64}
DEV1_CFG = "[model]\ninit_file = dev1.res.nc\nstart = 0\nstop = {stop}\ntime_step = 1\n"


@pytest.fixture(autouse=True)
def clean_port():
    Configurator.clear()
    get_loader().reset()
    yield
    Configurator.clear()
    get_loader().reset()


class Counterant(Iterant):
    """Counts start/iterate/stop calls (Iterator_test.cpp:16-65)."""

    def __init__(self):
        self.count = 0
        self.start_count = 0
        self.stop_count = 0

    def start(self, start_time):
        self.start_count += 1

    def iterate(self, dt):
        self.count += 1

    def stop(self, stop_time):
        self.stop_count += 1


@pytest.mark.parametrize("set_times, count", [
    (lambda it: it.set_start_stop_step(0, 5, 1), 5),
    (lambda it: it.parse_and_set(start="10", stop="100", duration="3", step="1"), 3),
    (lambda it: it.parse_and_set(start="0", stop="4", duration="", step="2"), 2),
    (lambda it: it.set_start_duration_step(100, 1800, 600), 3),
], ids=["start-stop-step", "duration-overrides-stop", "stop-without-duration", "duration"])
def test_iterator_runs_exact_step_count(set_times, count):
    counterant = Counterant()
    iterator = Iterator(counterant)
    set_times(iterator)
    iterator.run()
    assert (counterant.count, counterant.start_count, counterant.stop_count) == (count, 1, 1)


def test_simple_iterant_logs_its_lifecycle(capsys):
    """The port's SimpleIterant prints what the JAX package's does."""
    from nextsimdg_tpu.runtime.iterator import Iterator as JaxIterator
    from nextsimdg_tpu.runtime.simple_iterant import SimpleIterant as JaxSimpleIterant
    from nextsimdg_tpu_torch.runtime.simple_iterant import SimpleIterant

    for iterator, iterant in ((JaxIterator, JaxSimpleIterant), (Iterator, SimpleIterant)):
        it = iterator(iterant())
        it.iterant.init()
        it.set_start_stop_step(0, 3, 1)
        it.run()
    out = capsys.readouterr().out.splitlines()
    assert out[:len(out) // 2] == out[len(out) // 2:]
    assert out[:5] == [
        "SimpleIterant::init", "SimpleIterant::start at 0", *["SimpleIterant::iterate for 1"] * 3,
    ]


def same_restart(got, ref, rtol=1e-12):
    assert got.structure_type == ref.structure_type
    for name in FIELDS:
        a, b = getattr(got, name), getattr(ref, name)
        assert a.shape == b.shape, name
        scale = float(np.max(np.abs(b)))
        np.testing.assert_allclose(a, b, rtol=0.0, atol=rtol * scale, err_msg=name)


def run_both(tmp_path, monkeypatch, cfg_text, restart_file, write):
    """The same config and restart through the JAX package's main() and the
    port's (CPU, float64), each in a directory of its own; returns the two
    directories."""
    dirs = []
    for name, run in (("jax", lambda cfg: jax_main(["nextsim", "--config-file", cfg])),
                      ("port", lambda cfg: main(["nextsim", "--config-file", cfg], **CPU64))):
        work = tmp_path / name
        work.mkdir()
        monkeypatch.chdir(work)
        write(restart_file)
        (work / "run.cfg").write_text(cfg_text)
        assert run(str(work / "run.cfg")) == 0
        assert (work / "restart.nc").exists()
        dirs.append(work)
    return dirs


def test_dev1_end_to_end_matches_jax(tmp_path, monkeypatch):
    """The canonical dev1 run (run/dev1.cfg: 1 step of 1 s, dummy forcing)."""
    jax_dir, port_dir = run_both(
        tmp_path, monkeypatch, (REPO / "run" / "dev1.cfg").read_text(), "dev1.res.nc",
        make_dev_restart,
    )
    fields = read_restart(str(port_dir / "restart.nc"))
    same_restart(fields, jax_read_restart(str(jax_dir / "restart.nc")))
    assert fields.structure_type == "devgrid" and (fields.nx, fields.ny) == (10, 10)
    for name in ("hice", "cice", "hsnow", "sst", "sss"):
        arr = getattr(fields, name)
        assert np.allclose(arr, arr.flat[0]), name
    assert np.allclose(fields.sst, -1.0) and np.allclose(fields.sss, 32.0)
    # The JAX package's regression anchors (tests/test_runtime.py).
    assert np.allclose(fields.cice, 0.36670813, rtol=1e-6)
    assert np.allclose(fields.hice, 0.04668325, rtol=1e-6)
    assert np.allclose(fields.tice, -1.4445018, rtol=1e-6)


@pytest.mark.parametrize("thermo, nlayers", [
    ("Nextsim::ThermoIce0", 1), ("Nextsim::ThermoWinton", 3),
], ids=["ThermoIce0", "ThermoWinton"])
def test_rectgrid_run_matches_jax(tmp_path, monkeypatch, thermo, nlayers):
    """5 steps of 600 s on a seeded 16 x 24 restart, checkpoints at 2 and 4."""
    cfg = (
        "[model]\ninit_file = rect.nc\nstart = 0\nstop = 3000\ntime_step = 600\n"
        "checkpoint_period = 2\n"
        f"[Modules]\nNextsim::IThermodynamics = {thermo}\n"
    )
    fields = seeded_rect_fields(16, 24, nlayers, seed=3)
    jax_dir, port_dir = run_both(
        tmp_path, monkeypatch, cfg, "rect.nc", lambda path: write_restart_fields(path, fields)
    )
    assert sorted(p.name for p in port_dir.glob("checkpoint.*.nc")) == [
        "checkpoint.2.nc", "checkpoint.4.nc",
    ]
    for name in ("checkpoint.2.nc", "checkpoint.4.nc", "restart.nc"):
        got = read_restart(str(port_dir / name))
        same_restart(got, jax_read_restart(str(jax_dir / name)))
        assert got.n_ice_layers == nlayers
    final = read_restart(str(port_dir / "restart.nc"))
    assert not np.array_equal(final.hice, fields.hice)  # the physics ran
    np.testing.assert_array_equal(final.sst, fields.sst)


def configured_model(stop, fields=None, **placement):
    Configurator.clear()
    Configurator.add_stream(DEV1_CFG.format(stop=stop))
    get_loader().set_all_defaults()
    ConfiguredModule.parse_configurator()
    model = Model(**(placement or CPU64))
    model.configure(fields)
    return model


def test_scanned_multi_step_matches_host_loop(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    make_dev_restart("dev1.res.nc")
    host = configured_model(5)
    host.iterator.run()
    scanned = configured_model(5)
    scanned.model_step.run_steps_scanned(5, 1.0)
    assert host.model_step.step_count == 5
    for name in FIELDS:
        assert torch.equal(getattr(host.structure.prognostic, name),
                           getattr(scanned.structure.prognostic, name)), name
    assert torch.equal(host.model_step.new_ice, scanned.model_step.new_ice)


def test_in_memory_restart_configures_the_same_model(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    make_dev_restart("dev1.res.nc")
    from_file, from_fields = configured_model(1), configured_model(1, dev_restart_fields())
    for model in (from_file, from_fields):
        model.iterator.run()
    for name in FIELDS:
        assert torch.equal(getattr(from_file.structure.prognostic, name),
                           getattr(from_fields.structure.prognostic, name)), name
    assert from_fields.structure.prognostic.hice.dtype == torch.float64


def test_restart_written_even_when_run_fails(tmp_path, monkeypatch):
    """Model.run mirrors the reference destructor: restart write on failure."""
    monkeypatch.chdir(tmp_path)
    make_dev_restart("dev1.res.nc")
    model = configured_model(1)

    def boom(dt):
        raise RuntimeError("simulated step failure")

    model.model_step.iterate = boom
    with pytest.raises(RuntimeError, match="simulated"):
        model.run()
    assert os.path.exists("restart.nc")
    same_restart(read_restart("restart.nc"), read_restart("dev1.res.nc"), rtol=0.0)


def test_a_forcing_file_is_refused_until_m8b(tmp_path, monkeypatch):
    """model.forcing_file (refused until ROADMAP M8b part 2 ported it, hence
    the name) gives the ModelStep a provider on the model's device and
    dtype, which sets the structure's forcing at each step's time: the
    archive's tair at t = 0, 1, 2 of a ramp, the dummies elsewhere."""
    from nextsimdg_tpu_torch.io.forcing_file import write_forcing_archive

    monkeypatch.chdir(tmp_path)
    make_dev_restart("dev1.res.nc")
    write_forcing_archive("forcing.nc", [0.0, 4.0], {"tair": np.stack([np.full((10, 10), v) for v in (-20.0, -12.0)])})
    Configurator.add_stream(DEV1_CFG.format(stop=3) + "forcing_file = forcing.nc\n")
    model = Model(**CPU64)
    model.configure()
    provider = model.model_step.forcing_provider
    assert provider.device == torch.device("cpu") and provider.dtype == torch.float64
    seen = []
    step = model.model_step.step_fn

    def recorded():
        inner = step()

        def record(prog, forcing, new_ice, dt):
            seen.append((float(forcing.tair[0, 0]), float(forcing.lw_in[0, 0])))
            return inner(prog, forcing, new_ice, dt)

        return record

    model.model_step.step_fn = recorded
    model.run()
    assert seen == [(-20.0, 311.0), (-18.0, 311.0), (-16.0, 311.0)]
    assert os.path.exists("restart.nc")


def test_chrono_and_timer():
    chrono = Chrono()
    chrono.start()
    time.sleep(0.01)
    chrono.stop()
    assert chrono.wall_time() >= 0.01
    assert chrono.ticks == 1
    chrono.extra_ticks(2)
    chrono.extra_wall_time(1.0)
    assert chrono.ticks == 3 and chrono.wall_time() >= 1.01

    timer = Timer("test")
    timer.tick("a")
    timer.tick("b")
    time.sleep(0.005)
    timer.tock("b")
    timer.tock("a")
    report = timer.report()
    assert "a:" in report and "b:" in report
    assert "activations" in report


def test_scoped_timer_substitute():
    timer = Timer("scoped")
    ScopedTimer.set_timer_address(timer)
    try:
        with ScopedTimer("phase1") as scoped:
            scoped.substitute("phase2")
    finally:
        ScopedTimer.set_timer_address(main_timer)
    report = timer.report()
    assert "phase1" in report and "phase2" in report


def test_main_refuses_to_run_without_a_card(tmp_path, monkeypatch, capsys):
    """No card and no request for the CPU: a non-zero exit and a message,
    before any file is read."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "dev1.cfg").write_text(DEV1_CFG.format(stop=1))
    assert main(["nextsim", "--config-file", "dev1.cfg"]) != 0
    assert "--cpu" in capsys.readouterr().err
    assert main(["nextsim", "--config-file", "dev1.cfg"], device="cuda:0", dtype=torch.float64) != 0
    assert not (tmp_path / "restart.nc").exists()


def test_the_module_entry_point_with_the_cpu_switch(tmp_path, monkeypatch):
    """``python -m nextsimdg_tpu_torch``: without a card it exits non-zero
    unless ``--cpu`` is given; with ``--cpu --float64`` it writes the dev1
    restart that the JAX package's own run writes."""
    monkeypatch.chdir(tmp_path)
    make_dev_restart("dev1.res.nc")
    env = {**os.environ, "PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": ""}
    cfg = str(REPO / "run" / "dev1.cfg")
    command = [sys.executable, "-m", "nextsimdg_tpu_torch", "--config-file", cfg]
    refused = subprocess.run(command, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert refused.returncode != 0 and "--cpu" in refused.stderr
    assert not (tmp_path / "restart.nc").exists()
    done = subprocess.run(
        [*command, "--cpu", "--float64"], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert done.returncode == 0, done.stderr
    assert "time-loop" in done.stderr  # the Timer report
    port = read_restart("restart.nc")
    os.rename("restart.nc", "port.nc")
    assert jax_main(["nextsim", "--config-file", cfg]) == 0
    same_restart(port, jax_read_restart("restart.nc"))


def test_chip_smoke_engine_phase_rehearses_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``chip_smoke.check_engine`` at 16^2 on the CPU (its CUDA events and
    synchronise stubbed): dev1 through main() against the anchors, the
    rectgrid runs through main() with their restart files and checkpoints,
    compared with the CPU runs, and timed."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, "chip_smoke", smoke)  # its dataclasses look their module up
    spec.loader.exec_module(smoke)

    class Event:
        def __init__(self, enable_timing):
            self.t = None

        def record(self):
            self.t = time.perf_counter()

        def elapsed_time(self, end):
            return (end.t - self.t) * 1e3

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(smoke, "N4", 16)
    monkeypatch.chdir(tmp_path)
    smoke.check_engine(torch.device("cpu"), "card, 700 W")
    out = capsys.readouterr().out
    assert "h5py installed" in out and "not exercised" not in out
    assert out.count("engine dev1 on the card") == 3 and "FAIL" not in out
    for name in ("ThermoIce0", "ThermoWinton"):
        assert f"rectgrid {name}: checkpoints ['checkpoint.10.nc', 'checkpoint.20.nc']" in out
        assert f"rectgrid {name}: restart file write" in out
        assert out.count(f"rectgrid {name} ") == 6  # a check line a plane
    assert list(tmp_path.iterdir()) == []  # the runs stay in their temporary directories
