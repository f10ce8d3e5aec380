"""The port's forcing archive (``nextsimdg_tpu_torch.io.forcing_file``)
against the JAX package's: the twins of ``tests/test_forcing_file.py``,
the provider's planes against JAX's ``ForcingProvider`` on the same archive
at the same times (thermo and dynamics fields, clamped and periodic,
float32 and float64: expected difference exactly 0), the dummy fallbacks,
archives written by either package read by the other, the provider's
record bookkeeping, and the engine's ``model.forcing_file`` run against
JAX ``main()`` on the same restart and archive (1e-12 of each plane's max,
the engine parity of ``tests/test_torch_runtime.py``). Everything runs on
the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from nextsimdg_tpu.io import forcing_file as jax_ff
from nextsimdg_tpu.io import read_restart as jax_read_restart
from nextsimdg_tpu_torch.io import read_restart, write_restart_fields
from nextsimdg_tpu_torch.io import forcing_file as ff
from nextsimdg_tpu_torch.io.forcing_file import (
    DUMMY_VALUES, DYNAMICS_FIELDS, THERMO_FIELDS, ForcingProvider, read_forcing_archive,
    write_forcing_archive,
)
from nextsimdg_tpu_torch.tools.make_dev_restart import make_dev_restart, seeded_rect_fields
from tests.test_torch_runtime import clean_port, run_both, same_restart  # noqa: F401

torch.set_num_threads(1)

CPU = {"device": "cpu"}
DTYPES = {"float32": (torch.float32, jnp.float32), "float64": (torch.float64, jnp.float64)}
#: Irregular record times, and times at a record, between records, below
#: and above the range, at its ends, and (periodic) across the wrap.
TIMES = np.array([0.0, 3600.0, 5400.0, 10800.0, 21600.0])
PROBES = (0.0, 3600.0, 1234.5, 4000.25, 10799.9, 21600.0, -100.0, 1e9, 25000.0, 43200.0 + 7.5, -3000.0)


def make_archive(path, nx=4, ny=4):
    """tests/test_forcing_file.py:12's archive."""
    time = np.array([0.0, 3600.0, 7200.0])
    tair = np.stack([np.full((nx, ny), v) for v in (-10.0, -5.0, 0.0)])
    wind = np.stack([np.full((nx, ny), v) for v in (2.0, 6.0, 10.0)])
    u_atm = np.stack([np.full((nx, ny), v) for v in (1.0, 2.0, 3.0)])
    write_forcing_archive(path, time, {"tair": tair, "wind": wind, "u_atm": u_atm})


def seeded_fields(names, nt, nx, ny, seed):
    """Physically sized random series for ``names``, (nt, nx, ny) float64."""
    rng = np.random.default_rng(seed)
    ranges = {
        "tair": (-30.0, -5.0), "dew2m": (-32.0, -7.0), "pair": (9.8e4, 1.02e5), "sw_in": (0.0, 100.0),
        "lw_in": (150.0, 300.0), "mld": (5.0, 20.0), "snowfall": (0.0, 1e-4), "wind": (0.0, 12.0),
        "u_atm": (-10.0, 10.0), "v_atm": (-10.0, 10.0), "u_ocean": (-0.1, 0.1), "v_ocean": (-0.1, 0.1),
    }
    return {n: rng.uniform(*ranges[n], size=(nt, nx, ny)) for n in names}


def provider_pair(path, periodic, dtype):
    port_dtype, jax_dtype = DTYPES[dtype]
    return (ForcingProvider(path, periodic=periodic, dtype=port_dtype, **CPU),
            jax_ff.ForcingProvider(path, periodic=periodic, dtype=jax_dtype))


def assert_same_planes(got, want, names, port_dtype):
    for name in names:
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.dtype == port_dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


# -- the twins of tests/test_forcing_file.py -----------------------------------
def test_linear_time_interpolation(tmp_path):
    path = str(tmp_path / "forcing.h5")
    make_archive(path)
    provider = ForcingProvider(path, **CPU)
    f = provider.thermo_forcing(1800.0, 4, 4)  # halfway between -10 and -5
    torch.testing.assert_close(f.tair, torch.full((4, 4), -7.5))
    torch.testing.assert_close(f.wind, torch.full((4, 4), 4.0))
    # Fields absent from the archive use the reference dummy values.
    torch.testing.assert_close(f.lw_in, torch.full((4, 4), 311.0))
    torch.testing.assert_close(f.mld, torch.full((4, 4), 10.0))


def test_clamping_and_periodic_wrap(tmp_path):
    path = str(tmp_path / "forcing.h5")
    make_archive(path)
    clamped = ForcingProvider(path, **CPU)
    assert torch.all(clamped.thermo_forcing(-100.0, 4, 4).tair == -10.0)
    assert torch.all(clamped.thermo_forcing(1e9, 4, 4).tair == 0.0)
    periodic = ForcingProvider(path, periodic=True, **CPU)
    # t = 9000 wraps to 1800 over the [0, 7200] cycle.
    assert torch.all(periodic.thermo_forcing(9000.0, 4, 4).tair == -7.5)


def test_dynamics_forcing_fields(tmp_path):
    path = str(tmp_path / "forcing.h5")
    make_archive(path)
    df = ForcingProvider(path, **CPU).dynamics_forcing(3600.0, 4, 4)
    assert torch.all(df.u_atm == 2.0)
    assert torch.all(df.v_atm == 0.0)  # dummy fallback


def test_model_with_forcing_archive(tmp_path, monkeypatch):
    """The engine consumes the archive (replacing the dummy forcing), and its
    final restart equals JAX main()'s on the same restart and archive."""

    def write(restart):
        make_dev_restart(restart)
        # Cold, windy, clear-sky: strongly cools the ice surface (the dummy
        # forcing is calm with LW = 311, which barely cools).
        const = lambda v: np.stack([np.full((10, 10), v)] * 2)  # noqa: E731
        write_forcing_archive("forcing.h5", np.array([0.0, 2.0]),
                              {"tair": const(-20.0), "wind": const(5.0), "lw_in": const(150.0)})

    cfg = "[model]\ninit_file = dev1.res.nc\nstart = 0\nstop = 2\ntime_step = 1\nforcing_file = forcing.h5\n"
    jax_dir, port_dir = run_both(tmp_path, monkeypatch, cfg, "dev1.res.nc", write)
    fields = read_restart(str(port_dir / "restart.nc"))
    assert np.all(fields.tice < -2.0)
    same_restart(fields, jax_read_restart(str(jax_dir / "restart.nc")))


# -- the provider against JAX's ------------------------------------------------
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("periodic", [False, True], ids=["clamped", "periodic"])
def test_provider_planes_equal_jax(tmp_path, periodic, dtype):
    """Nine of the twelve fields in the archive (mld, snowfall and v_ocean
    fall back to the dummies), random in time and space: every plane at
    every probe time equals JAX's bit for bit."""
    names = [n for n in THERMO_FIELDS + DYNAMICS_FIELDS if n not in ("mld", "snowfall", "v_ocean")]
    path = str(tmp_path / "forcing.h5")
    write_forcing_archive(path, TIMES, seeded_fields(names, len(TIMES), 6, 5, seed=1))
    port, ref = provider_pair(path, periodic, dtype)
    port_dtype = DTYPES[dtype][0]
    for t in PROBES:
        assert_same_planes(port.thermo_forcing(t, 6, 5), ref.thermo_forcing(t, 6, 5), THERMO_FIELDS, port_dtype)
        assert_same_planes(port.dynamics_forcing(t, 6, 5), ref.dynamics_forcing(t, 6, 5), DYNAMICS_FIELDS,
                           port_dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dummy_fallbacks_equal_jax(tmp_path, dtype):
    """An archive with a time axis and no field: every plane is its dummy
    constant, as in JAX; a one-record archive's planes are that record at
    every time (the last record taken as is)."""
    empty = str(tmp_path / "empty.h5")
    write_forcing_archive(empty, [0.0, 60.0], {})
    port, ref = provider_pair(empty, False, dtype)
    for t in (0.0, 30.0, 1e6):
        assert_same_planes(port.thermo_forcing(t, 3, 4), ref.thermo_forcing(t, 3, 4), THERMO_FIELDS,
                           DTYPES[dtype][0])
        assert_same_planes(port.dynamics_forcing(t, 3, 4), ref.dynamics_forcing(t, 3, 4), DYNAMICS_FIELDS,
                           DTYPES[dtype][0])
    for name in THERMO_FIELDS:
        assert torch.all(getattr(port.thermo_forcing(0.0, 3, 4), name) == DUMMY_VALUES[name]), name
    single = str(tmp_path / "single.h5")
    write_forcing_archive(single, [100.0], seeded_fields(("tair", "u_ocean"), 1, 3, 4, seed=2))
    for periodic in (False, True):
        port, ref = provider_pair(single, periodic, dtype)
        for t in (-5.0, 100.0, 7e5):
            assert_same_planes(port.thermo_forcing(t, 3, 4), ref.thermo_forcing(t, 3, 4), THERMO_FIELDS,
                               DTYPES[dtype][0])
            assert_same_planes(port.dynamics_forcing(t, 3, 4), ref.dynamics_forcing(t, 3, 4),
                               DYNAMICS_FIELDS, DTYPES[dtype][0])


def test_archives_cross_between_the_packages(tmp_path):
    """An archive written by either package reads the same in the other:
    time axis, series, and the providers' planes."""
    fields = seeded_fields(("tair", "wind", "u_atm", "v_ocean"), 3, 5, 4, seed=3)
    time = np.array([0.0, 600.0, 1800.0])
    for writer, tag in ((write_forcing_archive, "port"), (jax_ff.write_forcing_archive, "jax")):
        path = str(tmp_path / f"{tag}.h5")
        writer(path, time, fields)
        got_time, got = read_forcing_archive(path)
        np.testing.assert_array_equal(got_time, time)
        assert got.keys() == fields.keys()
        for name, series in fields.items():
            np.testing.assert_array_equal(got[name], series, err_msg=name)
        port, ref = provider_pair(path, False, "float32")
        for t in (0.0, 450.0, 1000.0, 1800.0):
            assert_same_planes(port.thermo_forcing(t, 5, 4), ref.thermo_forcing(t, 5, 4), THERMO_FIELDS,
                               torch.float32)
            assert_same_planes(port.dynamics_forcing(t, 5, 4), ref.dynamics_forcing(t, 5, 4),
                               DYNAMICS_FIELDS, torch.float32)
    with pytest.raises(ValueError, match="steps"):
        write_forcing_archive(str(tmp_path / "bad.h5"), time, {"tair": fields["tair"][:2]})


def test_records_move_only_when_the_bracket_does(tmp_path, monkeypatch):
    """A step forward inside a bracket copies nothing; entering the next
    interval copies one record (the old upper one becomes the lower); a
    rewind (a dt/2 replay) copies what it needs. Planes handed out earlier
    keep their values after their records' memory is reused, float64
    included."""
    path = str(tmp_path / "forcing.h5")
    fields = seeded_fields(("tair", "u_atm"), len(TIMES), 4, 3, seed=4)
    write_forcing_archive(path, TIMES, fields)
    staged = []
    real = ff.ForcingProvider._stage
    monkeypatch.setattr(ff.ForcingProvider, "_stage",
                        lambda self, k, dst: (staged.append(k), real(self, k, dst)))
    provider = ForcingProvider(path, dtype=torch.float64, **CPU)
    fresh = lambda t: ForcingProvider(path, dtype=torch.float64, **CPU).thermo_forcing(t, 4, 3)  # noqa: E731
    kept = {}
    for t, copies in ((0.0, [0, 1]), (600.0, []), (3000.0, []), (3600.0, [2]), (4200.0, []),
                      (6000.0, [3]), (1800.0, [0, 1]), (21600.0, [4]), (1e9, [])):
        staged.clear()
        kept[t] = provider.thermo_forcing(t, 4, 3).tair.clone(), provider.thermo_forcing(t, 4, 3).tair
        assert staged == copies, (t, staged)
        assert len(provider._records) <= 2
    for t, (copy, handed) in kept.items():
        assert torch.equal(handed, copy), t
        assert torch.equal(handed, fresh(t).tair), t
    # The same time twice shares one blend: dynamics after thermo copies nothing.
    staged.clear()
    provider.thermo_forcing(700.0, 4, 3)
    provider.dynamics_forcing(700.0, 4, 3)
    assert staged == [0, 1]


def test_bad_archives_raise(tmp_path):
    path = str(tmp_path / "shapes.h5")
    write_forcing_archive(path, [0.0, 1.0], {"tair": np.zeros((2, 3, 3)), "wind": np.zeros((2, 4, 3))})
    with pytest.raises(ValueError, match="inconsistent field shapes"):
        ForcingProvider(path, **CPU)
    path = str(tmp_path / "no_time.h5")
    write_forcing_archive(path, np.zeros(0), {})
    with pytest.raises(ValueError, match="no time steps"):
        ForcingProvider(path, **CPU)


def test_engine_run_with_a_varying_archive_matches_jax(tmp_path, monkeypatch):
    """5 steps of 600 s on a seeded 16 x 24 restart with all eight thermo
    fields varying in time and space over three records (the steps fall
    between records, on one, and beyond the last): the port's final restart
    and checkpoints equal JAX main()'s to 1e-12 of each plane's max."""
    rect = seeded_rect_fields(16, 24, 1, seed=5)
    series = seeded_fields(THERMO_FIELDS, 3, 16, 24, seed=6)

    def write(restart):
        write_restart_fields(restart, rect)
        write_forcing_archive("forcing.h5", [0.0, 900.0, 2400.0], series)

    cfg = ("[model]\ninit_file = rect.nc\nstart = 0\nstop = 3000\ntime_step = 600\ncheckpoint_period = 2\n"
           "forcing_file = forcing.h5\n")
    jax_dir, port_dir = run_both(tmp_path, monkeypatch, cfg, "rect.nc", write)
    for name in ("checkpoint.2.nc", "checkpoint.4.nc", "restart.nc"):
        same_restart(read_restart(str(port_dir / name)), jax_read_restart(str(jax_dir / name)))
    assert not np.array_equal(read_restart(str(port_dir / "restart.nc")).hice, rect.hice)
