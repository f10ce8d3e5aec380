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
from nextsimdg_tpu_torch.benchmarks import common, mevp_large, run_benchmarks
from nextsimdg_tpu_torch.dynamics.kernels import mevp_rdma_cuda as rdma_cuda

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TINY = {"n": 16, "n_subcycles": 2, "chunk": 1}


def _tiny(fn) -> dict:
    params = inspect.signature(fn).parameters
    tiny = {k: v for k, v in TINY.items() if k in params}
    halo = getattr(fn, "keywords", {}).get("halo")
    if isinstance(halo, int):  # a fixed ghost width needs 2 x 2 blocks at least as wide
        tiny["n"] = 2 * halo
    return tiny


@pytest.mark.parametrize("name", list(run_benchmarks.CONFIGS))
def test_each_config_runs_and_reports(name):
    result = run_benchmarks.run_config(name, "cpu", **_tiny(run_benchmarks.CONFIGS[name]))
    assert {"metric", "value", "unit", "config", "device"} <= set(result)
    assert result["config"] == name and result["device"] == {"platform": "cpu"}
    assert result["value"] > 0 and result["chunk"] == 1
    # The HO configs select the solver in the registry and reset it.
    assert modules.get_loader().selected_name("Nextsim::IDynamics") == "Nextsim::MEVPDynamics"


@pytest.mark.parametrize("name", ["coupled_1m_spherical_spmd", "ho_ablate_uniform_spmd"])
def test_spmd_configs_run_on_the_rdma_schedule(name):
    """``--mevp-backend rdma``: the ``*_spmd`` configs, CG1 and HO, run their
    mEVP on K7's round and say so in their metric."""
    result = run_benchmarks.run_config(name, "cpu", mevp_backend="rdma", **TINY)
    assert "rdma h=4" in result["metric"] and result["value"] > 0  # 8^2 blocks: h = 4
    assert name in run_benchmarks.SPMD_CONFIGS and "multihost_16m" not in run_benchmarks.SPMD_CONFIGS


def test_multihost_runs_on_a_rank_grid():
    result = run_benchmarks.run_config("multihost_16m", "cpu", ranks=(2, 2), **TINY)
    assert "2x2 rank grid" in result["metric"] and result["value"] > 0


@pytest.mark.parametrize("degree", [1, 2])
def test_advection_matches_the_jax_config_at_16(degree):
    """BASELINE config 2 at 16^2 for 5 steps at float64: the port's set-up
    and ``DGTransport.run`` against the JAX battery's (its
    ``bench_advection`` builds the same mesh, velocity and start, then runs
    ``tr.step`` in a scan), to 1e-10 of the plane's max; the rate on the CPU
    has the JAX metric's name."""
    import jax.numpy as jnp
    import numpy as np

    from nextsimdg_tpu.dynamics import DGTransport, RectMesh
    from nextsimdg_tpu.dynamics.transport import sample_velocity

    n = 16
    tr, vel, psi, dt = run_benchmarks.advection_setup(n, degree, "cpu", torch.float64)
    got = tr.run(psi, vel, dt, 5)
    mesh = RectMesh(nx=n, ny=n, dx=1.0 / n, dy=1.0 / n)
    jtr = DGTransport(mesh, degree=degree)
    jvel = sample_velocity(
        mesh, jtr.basis, lambda x, y: (-2 * np.pi * (y - 0.5), 2 * np.pi * (x - 0.5)),
        dtype=jnp.float64,
    )
    jpsi = jtr.project(lambda x, y: np.exp(-((x - 0.5) ** 2 + (y - 0.7) ** 2) / 0.01), dtype=jnp.float64)
    assert dt == 0.2 / (n * 2 * np.pi)
    assert np.array_equal(psi.numpy(), np.asarray(jpsi))
    for _ in range(5):
        jpsi = jtr.step(jpsi, jvel, dt)
    ref = np.asarray(jpsi)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=1e-10 * scale)
    result = run_benchmarks.run_config("advection", "cpu", n=n, degree=degree, chunk=2)
    assert result["metric"] == f"DG advection element updates/s (dG{degree}, {n}x{n}, f32)"
    assert result["value"] > 0 and result["chunk"] == 2


@pytest.mark.parametrize("name", ["box_adaptive", "coupled_1m_aweighted"])
def test_the_momentum_form_configs_report_the_jax_metric(name):
    """The battery's adaptive-alpha box and A-weighted config 4 run at 16^2
    on the CPU and name their metric as the JAX functions do
    (``bench_box_adaptive``, ``bench_coupled_1m(a_weighted=True)``); the
    coupled one adds the port's mEVP schedule, as its ``coupled_1m`` does."""
    result = run_benchmarks.run_config(name, "cpu", **TINY)
    n = TINY["n"]
    if name == "box_adaptive":
        expected = f"adaptive-alpha mEVP box element updates/s ({n}x{n}, 2 subcycles, f32)"
    else:
        expected = (
            f"coupled thermo+dynamics element updates/s ({n}x{n} = {n * n / 1e6:.2g}M elements, "
            "A-weighted, pallas, f32)"
        )
    assert result["metric"] == expected and result["value"] > 0


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


def test_mevp_tiled_sweep_runs_each_mesh_and_configuration():
    configs = ((8, 2, 64), (16, 4, 256))
    out = mevp_large.sweep_mevp_tiled("cpu", sizes=(16,), configs=configs, n_sub=2)
    assert set(out) == {(mesh, 16, c) for mesh in ("uniform", "spherical") for c in configs}
    assert all(ms > 0 for ms in out.values())


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
    assert "ho_coupled_1m_periodic" in run_benchmarks.CONFIGS
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_benchmarks.run_config("ho_coupled_1m_periodic")
    done = subprocess.run(
        [sys.executable, "-m", "nextsimdg_tpu_torch.benchmarks.run_benchmarks", "ho_coupled_1m_periodic"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert done.returncode != 0 and not done.stdout and "no CUDA device" in done.stderr
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_benchmarks.run_config("advection")


def test_transport_tiled_and_ho_single_sweeps_run_each_launch():
    """The sweep of transport_tiled's launches and the times per call of
    transport_tiled, ho_single, mevp_single, mevp_tiled, dg1_sample_cfl
    dg1_rk_stage (in each form), rdma_stage and rdma_band run on the CPU (the plain versions), one
    entry per launch and per kernel and size; so does the headline step."""
    out = mevp_large.sweep_transport_tiled("cpu", sizes=(16,))
    assert len(out) == len(mevp_large.transport_tiled_configs())
    out = mevp_large.kernel_times(
        "cpu", transport_sizes=(16,), ho_sizes=(16, 24), n_sub=2, single_sizes=((16, False), (24, True)),
        tiled_sizes=((24, True),), cfl_shapes=((16, 0, False), (16, 0, True), (16, 4, False)),
        stage_sizes=((16, False, "blend"), (16, False, "first"), (16, True, "blend"), (16, False, "qv")),
        rdma_sizes=(16,), rdma_halo=2,
    )
    assert sorted(out) == [
        ("dg1_rk_stage", (16, False, "blend")), ("dg1_rk_stage", (16, False, "first")),
        ("dg1_rk_stage", (16, False, "qv")), ("dg1_rk_stage", (16, True, "blend")),
        ("dg1_sample_cfl", (16, 0, False)), ("dg1_sample_cfl", (16, 0, True)),
        ("dg1_sample_cfl", (16, 4, False)), ("ho_single", 16), ("ho_single", 24), ("mevp_single", 16), ("mevp_single", 24), ("mevp_tiled", 24),
        ("rdma_band", (16, 0)), ("rdma_band", (16, 1)), ("rdma_stage", 16), ("transport_tiled", 16),
    ]
    assert all(dev == ms > 0 for dev, ms in out.values())
    assert all(ms > 0 for ms in mevp_large.headline_step("cpu", n=16))


def test_ho_rdma_band_sweep_runs_each_configuration_that_fits():
    """The sweep of rdma_band's HO form runs on the CPU (the plain version,
    one call each) for every configuration that the kernel takes at each
    ghost width, on both band axes, and drops the others (a window no
    wider than its 2h-cell ring, more blocks across than the band has
    cells); the host's launch takes the ``HO_BANDS`` row of its ghost width
    and band length: an L2-const one where the staged consts do not fit
    (h = 64)."""
    configs = (rdma_cuda.HoBandConfig(2, 2, 16, 64), rdma_cuda.HoBandConfig(1, 1, 40, 64),
               rdma_cuda.HoBandConfig(1, 1, 6, 64), rdma_cuda.HoBandConfig(1, 8, 8, 64))
    out = mevp_large.sweep_rdma_band("cpu", (16,), (2, 4), configs, rdma_cuda.HO_PLANES)
    # seg 6 in a one-block window: 6 > 2 n_sub only at h = 2; 8 blocks across only at h = 4 (12 cells).
    expected = {(16, h, axis, c) for h in (2, 4) for axis in (0, 1) for c in configs
                if c.along * c.seg > 2 * h and c.across <= 3 * h and (c.across - 1) * c.rows(h) < 3 * h}
    assert set(out) == expected and all(ms > 0 for ms in out.values())
    for axis in (0, 1):
        for h in (8, 16, 32, 64):
            for n in (512, 2048):
                along = rdma_cuda.band_shape(axis, h, n, n, h)[1 - axis]
                config = rdma_cuda.launch_config(axis, rdma_cuda.HO_PLANES, h, along)
                assert config == next(c for h_max, a_min, c in rdma_cuda.HO_BANDS if h <= h_max and along >= a_min)
                assert h <= 32 or not config.staged


def test_mevp_single_sweep_runs_each_variant():
    """mevp_single's sweep of the resident const planes and the tile shape
    runs on the CPU (the plain version) and leaves the module as it was."""
    tiling = mevp_large.mevp_single_cuda.tiling
    cases = ((24, None, None), (24, 0, (8, 6)), (16, 2, None))
    out = mevp_large.sweep_mevp_single("cpu", cases=cases, n_sub=2)
    assert set(out) == set(cases) and all(ms > 0 for ms in out.values())
    assert mevp_large.mevp_single_cuda.tiling is tiling


def test_build_report_matches_closed_instances_to_the_parent():
    """The SASS comparison takes a closed instance (its trailing false
    template arguments removed) to the parent's kernel of that name, and
    counts equal opcode sequences (operands ignored)."""
    from nextsimdg_tpu_torch.benchmarks import build_report

    sass = lambda name, ops: f"        Function : {name}\n" + "".join(
        f"        /*{i:04x}*/                   {op} R1, R2 ;\n" for i, op in enumerate(ops)
    )
    parent = build_report.opcodes(
        sass("_ZN3nst17mevp_tiled_kernelILb0ELi80ELi0EEEvPKf", ["LDG.E", "FADD", "EXIT"])
        + sass("_ZN3nst22transport_tiled_kernelILi1ELb0ELb0ELi4EEEvNS_18", ["LDS", "EXIT"])
    )
    new = build_report.opcodes(
        sass("_ZN3nst17mevp_tiled_kernelILb0ELi80ELi0ELb0EEEvPKfi", ["LDG.E", "FADD", "EXIT"])
        + sass("_ZN3nst17mevp_tiled_kernelILb0ELi80ELi0ELb1EEEvPKfi", ["LDG.E", "IMAD", "EXIT"])
        + sass("_ZN3nst22transport_tiled_kernelILi1ELb0ELb0ELi4ELb0ELb0EEEvNS_18", ["LDS", "NOP", "EXIT"])
    )
    assert parent["_ZN3nst17mevp_tiled_kernelILb0ELi80ELi0EEEvPKf"] == ["LDG.E", "FADD", "EXIT"]
    same, differ = build_report.compare(parent, new)
    assert same == 1 and len(differ) == 1 and "transport_tiled" in differ[0]


def test_profiled_ms_many_gives_each_probe_the_events_of_its_window():
    """One profiler session for many probes: a probe's ms come from the
    events that start inside its own range (host events here: there is no
    card), and a probe whose calls never run its kernel gets None."""
    a = torch.randn(64, 64)
    out = common.profiled_ms_many({
        "add": (lambda: a + a, "aten::add"), "mm": (lambda: a @ a, "aten::mm"),
        "none": (lambda: a + a, "aten::mm"),
    }, n=3, device=False)
    assert out["add"] > 0 and out["mm"] > 0 and out["none"] is None
