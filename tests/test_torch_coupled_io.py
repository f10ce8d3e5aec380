"""The port's coupled I/O against the JAX package's: the twins of
``tests/test_diagnostics_checkpoint.py`` and ``tests/test_forcing_pipeline.py``;
checkpoints cross-load between the packages bit for bit (CG1 and HO, both
ways); the native forcing engine's fields equal the JAX pipeline's bit for
bit (the same C++ source) and a forcing file written by either reads in
the other; the engine's build is keyed by its source and runs once under
concurrent calls.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsimdg_tpu.coupled import CoupledState as JaxCoupledState
from nextsimdg_tpu.dynamics.mevp import VelocityState as JaxVelocityState
from nextsimdg_tpu.dynamics.mevp_ho import HOField as JaxHOField
from nextsimdg_tpu.dynamics.mevp_ho import HOVelocityState as JaxHOVelocityState
from nextsimdg_tpu.io import coupled_restart as jax_restart
from nextsimdg_tpu.io import forcing_pipeline as jax_pipeline
from nextsimdg_tpu_torch.coupled import CoupledModel
from nextsimdg_tpu_torch.dynamics import DynamicsForcing, RectMesh
from nextsimdg_tpu_torch.interop import coupled_state_from_numpy, coupled_state_to_numpy
from nextsimdg_tpu_torch.io import forcing_pipeline as fp
from nextsimdg_tpu_torch.io.coupled_restart import (
    fetch_coupled_state, load_coupled_state, load_time, save_coupled_state,
)
from nextsimdg_tpu_torch.io.diagnostics import DiagnosticWriter, read_diagnostics
from nextsimdg_tpu_torch.io.forcing_pipeline import ForcingPipeline, write_forcing_file
from nextsimdg_tpu_torch.modules import get_loader
from nextsimdg_tpu_torch.state import Forcing

torch.set_num_threads(1)

CPU64 = {"device": "cpu", "dtype": torch.float64}


def flat(d: dict, prefix=""):
    for key, value in d.items():
        if isinstance(value, dict):
            yield from flat(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(value)


def assert_trees_equal(a: dict, b: dict) -> None:
    """Leaf by leaf, bit for bit, dtype included."""
    fa, fb = dict(flat(a)), dict(flat(b))
    assert fa.keys() == fb.keys()
    for name in fa:
        assert fa[name].dtype == fb[name].dtype, name
        np.testing.assert_array_equal(fa[name], fb[name], err_msg=name)


# -- diagnostics and checkpoints ------------------------------------------------
def test_diagnostic_writer_appends_time_slices(tmp_path):
    path = str(tmp_path / "diag.h5")
    with DiagnosticWriter(path, ("hice", "cice")) as writer:
        for step in range(3):
            writer.write(600.0 * step, {
                "hice": np.full((4, 4), 0.1 * (step + 1)), "cice": np.full((4, 4), 0.5),
            })
    data = read_diagnostics(path)
    assert data["time"].tolist() == [0.0, 600.0, 1200.0]
    assert data["hice"].shape == (3, 4, 4)
    np.testing.assert_allclose(data["hice"][2], 0.3)


def build_model(n=8, n_sub=10):
    """tests/test_coupled.py's build_model, on the port (CPU, float64)."""
    mesh = RectMesh(n, n, 512e3 / n, 512e3 / n)
    model = CoupledModel(mesh, degree=1, n_subcycles=n_sub)
    state = model.initial_state(hice0=1.0, cice0=0.9, hsnow0=0.05, sst0=-1.6, sss0=32.0, **CPU64)
    full = lambda v: torch.full((n, n), v, **CPU64)  # noqa: E731
    phys = Forcing(
        tair=full(-10.0), dew2m=full(-12.0), pair=full(1e5), sw_in=full(10.0),
        lw_in=full(250.0), mld=full(10.0), snowfall=full(1e-4), wind=full(8.0),
    )
    dyn = DynamicsForcing(u_atm=full(8.0), v_atm=full(2.0), u_ocean=full(0.02), v_ocean=full(0.0))
    return model, state, phys, dyn


@pytest.mark.parametrize("solver", ["Nextsim::MEVPDynamics", "Nextsim::MEVPHighOrder"], ids=["cg1", "ho"])
def test_coupled_checkpoint_roundtrip_and_resume(tmp_path, solver):
    """A stepped state checkpoints and resumes: the restored state equals
    the saved one, and continuing from it equals an uninterrupted run."""
    get_loader().set_implementation("Nextsim::IDynamics", solver)
    try:
        model, state, pf, df = build_model()
    finally:
        get_loader().reset()
    state1 = model.step(state, pf, df, dt=600.0)
    path = str(tmp_path / "coupled.chk")
    save_coupled_state(path, state1, time=600.0)
    assert load_time(path) == 600.0
    restored = load_coupled_state(path, **CPU64)
    assert type(restored.velocity) is type(state1.velocity)
    assert_trees_equal(coupled_state_to_numpy(restored), coupled_state_to_numpy(state1))
    direct = coupled_state_to_numpy(model.step(state1, pf, df, dt=600.0))
    resumed = coupled_state_to_numpy(model.step(restored, pf, df, dt=600.0))
    assert_trees_equal(direct, resumed)


def seeded_host_state(high_order: bool, dtype, n=8, seed=0) -> dict:
    """A state's numpy leaves (interop layout) of seeded values."""
    rng = np.random.default_rng(seed)
    r = lambda *shape: rng.standard_normal(shape).astype(dtype)  # noqa: E731
    velocity = {"s11": r(3, n, n), "s22": r(3, n, n), "s12": r(3, n, n)} if high_order else {
        "s11": r(n, n), "s22": r(n, n), "s12": r(n, n)}
    for comp in ("u", "v"):
        velocity[comp] = {p: r(n, n) for p in "vblc"} if high_order else r(n, n)
    return {
        "hice": r(3, n, n), "cice": r(3, n, n), "hsnow": r(3, n, n), "sst": r(n, n), "sss": r(n, n),
        "tice": r(3, n, n), "new_ice": r(n, n), "velocity": velocity,
    }


def jax_state(d: dict, dtype):
    a = lambda x: jnp.asarray(x, dtype)  # noqa: E731
    v = d["velocity"]
    if isinstance(v["u"], dict):
        field = lambda c: JaxHOField(**{p: a(v[c][p]) for p in "vblc"})  # noqa: E731
        velocity = JaxHOVelocityState(u=field("u"), v=field("v"), s11=a(v["s11"]), s22=a(v["s22"]), s12=a(v["s12"]))
    else:
        velocity = JaxVelocityState(**{k: a(v[k]) for k in ("u", "v", "s11", "s22", "s12")})
    return JaxCoupledState(
        velocity=velocity, **{k: a(d[k]) for k in ("hice", "cice", "hsnow", "sst", "sss", "tice", "new_ice")}
    )


CROSS = [(ho, dt) for ho in (False, True) for dt in (np.float32, np.float64)]


@pytest.mark.parametrize("high_order, dtype", CROSS, ids=["cg1-f32", "cg1-f64", "ho-f32", "ho-f64"])
def test_port_checkpoint_loads_in_the_jax_package(tmp_path, high_order, dtype):
    host = seeded_host_state(high_order, dtype)
    state = coupled_state_from_numpy(host, device="cpu", dtype=torch.from_numpy(host["sst"]).dtype)
    path = str(tmp_path / "port.chk")
    save_coupled_state(path, state, time=1200.0)
    loaded = jax_restart.load_coupled_state(path, dtype=jnp.dtype(dtype))
    assert jax_restart.load_time(path) == 1200.0
    assert isinstance(loaded.velocity, JaxHOVelocityState if high_order else JaxVelocityState)
    assert_trees_equal(coupled_state_to_numpy(loaded), host)


@pytest.mark.parametrize("high_order, dtype", CROSS, ids=["cg1-f32", "cg1-f64", "ho-f32", "ho-f64"])
def test_jax_checkpoint_loads_in_the_port(tmp_path, high_order, dtype):
    host = seeded_host_state(high_order, dtype, seed=1)
    path = str(tmp_path / "jax.chk")
    jax_restart.save_coupled_state(path, jax_state(host, jnp.dtype(dtype)), time=1800.0)
    tdtype = torch.from_numpy(host["sst"]).dtype
    loaded = load_coupled_state(path, device="cpu", dtype=tdtype)
    assert load_time(path) == 1800.0
    assert_trees_equal(coupled_state_to_numpy(loaded), host)
    # The fetch is a copy, in one piece: writing into the state later does
    # not reach it.
    fetched = fetch_coupled_state(loaded)
    loaded.hice.fill_(0.0)
    assert_trees_equal(fetched, host)


# -- the forcing pipeline --------------------------------------------------------
def test_constant_mode_produces_requested_values():
    with ForcingPipeline.constant(8, 8, {"tair": -1.0, "lw_in": 311.0, "mld": 10.0}) as pipe:
        for expected_step in range(3):
            fields = pipe.next_fields()
            assert fields["_step"] == expected_step
            np.testing.assert_allclose(fields["tair"], -1.0)
            np.testing.assert_allclose(fields["lw_in"], 311.0)
            np.testing.assert_allclose(fields["mld"], 10.0)


def test_cyclone_mode_vortex_moves_and_is_bounded():
    vmax = 30.0
    with ForcingPipeline.cyclone(
        32, 32, 16e3, 16e3, vmax_atm=vmax, r0=100e3, period=4 * 86400.0, vmax_ocean=0.1, dt=6 * 3600.0,
    ) as pipe:
        f0 = pipe.next_fields()
        speeds0 = np.hypot(f0["u_atm"], f0["v_atm"])
        assert 0.5 * vmax < speeds0.max() <= 1.01 * vmax
        assert np.all(np.isfinite(speeds0))
        eye0 = np.unravel_index(np.argmax(speeds0), speeds0.shape)
        for _ in range(4):
            f1 = pipe.next_fields()
        speeds1 = np.hypot(f1["u_atm"], f1["v_atm"])
        assert eye0 != np.unravel_index(np.argmax(speeds1), speeds1.shape)
        np.testing.assert_allclose(f1["u_ocean"], f0["u_ocean"])
        assert np.max(np.abs(f0["u_ocean"])) <= 0.1 + 1e-12


def test_file_mode_round_trip(tmp_path):
    path = str(tmp_path / "forcing.nxft")
    steps = [{"u": np.full((6, 4), float(s)), "v": np.full((6, 4), 10.0 + s)} for s in range(5)]
    write_forcing_file(path, steps)
    with ForcingPipeline.from_file(path, ("u", "v")) as pipe:
        for s in range(5):
            fields = pipe.next_fields()
            assert fields["_step"] == s
            np.testing.assert_allclose(fields["u"], float(s))
            np.testing.assert_allclose(fields["v"], 10.0 + s)
        # Past the end (no loop): the last record repeats.
        np.testing.assert_allclose(pipe.next_fields()["u"], 4.0)


def test_file_mode_loops(tmp_path):
    path = str(tmp_path / "loop.nxft")
    write_forcing_file(path, [{"a": np.full((4, 4), float(s))} for s in range(3)])
    with ForcingPipeline.from_file(path, ("a",), loop=True) as pipe:
        values = [float(pipe.next_fields()["a"][0, 0]) for _ in range(7)]
    assert values == [0.0, 1.0, 2.0, 0.0, 1.0, 2.0, 0.0]


def test_file_mode_rejects_bad_files(tmp_path):
    bad = tmp_path / "bad.nxft"
    bad.write_bytes(b"not a forcing file at all, padding padding")
    with pytest.raises(ValueError):
        ForcingPipeline.from_file(str(bad), ("a",))


def test_producer_runs_ahead_of_consumer():
    with ForcingPipeline.constant(4, 4, {"a": 1.0}, n_buffers=4) as pipe:
        steps = [pipe.next_fields()["_step"] for _ in range(10)]
    assert steps == list(range(10))


def test_pipeline_fields_equal_the_jax_pipelines():
    """The same C++ source, the same parameters: the same fields, bit for
    bit, step by step."""
    pairs = [
        (fp.ForcingPipeline.constant(12, 10, {"a": -1.5, "b": 311.25}),
         jax_pipeline.ForcingPipeline.constant(12, 10, {"a": -1.5, "b": 311.25})),
        (fp.ForcingPipeline.cyclone(24, 20, 16e3, 12e3, vmax_atm=30.0, r0=90e3, dt=3 * 3600.0),
         jax_pipeline.ForcingPipeline.cyclone(24, 20, 16e3, 12e3, vmax_atm=30.0, r0=90e3, dt=3 * 3600.0)),
    ]
    for port, ref in pairs:
        with port, ref:
            for _ in range(4):
                got, want = port.next_fields(), ref.next_fields()
                assert got.keys() == want.keys()
                for name in want:
                    np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_forcing_files_cross_read(tmp_path):
    steps = [{"u": np.random.default_rng(s).standard_normal((5, 3))} for s in range(3)]
    for writer, reader in ((write_forcing_file, jax_pipeline.ForcingPipeline),
                           (jax_pipeline.write_forcing_file, ForcingPipeline)):
        path = str(tmp_path / f"{writer.__module__}.nxft")
        writer(path, steps)
        with reader.from_file(path, ("u",)) as pipe:
            for step in steps:
                np.testing.assert_array_equal(pipe.next_fields()["u"], step["u"])


def test_engine_build_is_keyed_by_its_source_and_runs_once(tmp_path, monkeypatch):
    """Six threads ask for the library at once: one compile, one path. A
    changed source gets a library of its own."""
    monkeypatch.setattr(fp, "BUILD_DIR", tmp_path)
    compiles = []
    real_run = fp.subprocess.run

    def counted(cmd, *args, **kwargs):
        if "-o" in cmd:
            compiles.append(cmd)
        return real_run(cmd, *args, **kwargs)

    monkeypatch.setattr(fp.subprocess, "run", counted)
    paths = []
    threads = [threading.Thread(target=lambda: paths.append(fp.build())) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(compiles) == 1 and len(set(paths)) == 1 and paths[0].exists()
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].name]  # no temporary left

    source = tmp_path / "forcing_engine.cpp"
    source.write_text(fp.SOURCE.read_text() + "\n// another revision\n")
    monkeypatch.setattr(fp, "SOURCE", source)
    assert fp.library_path() != paths[0]
    assert fp.build() == fp.library_path() and len(compiles) == 2


def test_host_copies_measure_only_on_a_card(monkeypatch, capsys):
    """The host copies' measurement (benchmarks.host_copies) refuses to run
    without a CUDA card, and prints nothing that could pass for a result."""
    from nextsimdg_tpu_torch.benchmarks import host_copies

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert host_copies.main([]) == 1
    assert "[host_copies]" not in capsys.readouterr().out
