"""The port's ERA5 reader (``nextsimdg_tpu_torch.io.era5``) against the JAX
package's: the twins of ``tests/test_era5.py`` (on its synthetic CDS-style
file, ``_write_era5``), and ``ERA5Dataset``'s decoded fields,
``regrid_bilinear``, ``_fill_nans``, ``lonlat_box`` and the archive that
``era5_to_archive`` writes compared with JAX's (expected 0; both are the
same numpy and scipy calls), and ``SphericalMesh.lonlat_centers`` with
JAX's (0).
"""

import numpy as np
import pytest
import torch

from nextsimdg_tpu.dynamics.mesh import SphericalMesh as JaxSphericalMesh
from nextsimdg_tpu.io import era5 as jax_era5
from nextsimdg_tpu.io import forcing_file as jax_ff
from nextsimdg_tpu_torch.dynamics.mesh import SphericalMesh
from nextsimdg_tpu_torch.io import era5
from nextsimdg_tpu_torch.io.era5 import ERA5Dataset, era5_to_archive, lonlat_box, regrid_bilinear
from nextsimdg_tpu_torch.io.forcing_file import ForcingProvider, read_forcing_archive
from tests.test_era5 import LATS, LONS, NT, _write_era5

torch.set_num_threads(1)

CPU = {"device": "cpu"}


# -- the twins of tests/test_era5.py -------------------------------------------
def test_era5_decode_units_and_packing(tmp_path):
    path = str(tmp_path / "era5.nc")
    truth = _write_era5(path)
    ds = ERA5Dataset(path)
    # time: hours since -> seconds relative to the first record.
    np.testing.assert_allclose(ds.time, 3600.0 * np.arange(NT))
    # t2m: unpack + K -> degC (packing quantizes at 1e-3).
    np.testing.assert_allclose(ds.fields["tair"], truth["t2m"] - 273.15, atol=1e-3)
    # accumulated SW: J m-2 over the 1 h step -> W m-2.
    np.testing.assert_allclose(ds.fields["sw_in"][2], 52.0)
    # snowfall: m w.e./h -> kg m-2 s-1.
    np.testing.assert_allclose(ds.fields["snowfall"], 1e-4, rtol=1e-12)
    # wind speed derived from the components.
    np.testing.assert_allclose(ds.fields["wind"], np.hypot(truth["u10"], truth["v10"]), atol=1e-3)


def test_regrid_bilinear_exact_for_linear_fields():
    lat2, lon2 = np.meshgrid(LATS, LONS, indexing="ij")
    field = 2.0 * lat2 + 3.0 * lon2  # bilinear regrid is exact on linears
    dst_lats, dst_lons = lonlat_box(6, 5, 71.0, 79.0, 11.0, 31.0)
    out = regrid_bilinear(field, LATS, LONS, dst_lats, dst_lons)
    np.testing.assert_allclose(out, 2.0 * dst_lats + 3.0 * dst_lons, rtol=1e-12)


def test_regrid_fills_masked_cells(tmp_path):
    path = str(tmp_path / "era5_masked.nc")
    _write_era5(path, mask_cell=(4, 6))
    ds = ERA5Dataset(path)
    assert np.isnan(ds.fields["tair"][0, 4, 6])  # fill -> NaN on decode
    dst_lats, dst_lons = lonlat_box(8, 8, 71.0, 79.0, 11.0, 31.0)
    out = regrid_bilinear(ds.fields["tair"], ds.lats, ds.lons, dst_lats, dst_lons)
    assert np.all(np.isfinite(out))  # nearest fill before interpolating


def test_era5_to_archive_feeds_forcing_provider(tmp_path):
    era5_path = str(tmp_path / "era5.nc")
    archive_path = str(tmp_path / "forcing.h5")
    _write_era5(era5_path)
    nx, ny = 6, 5
    dst_lats, dst_lons = lonlat_box(nx, ny, 71.0, 79.0, 11.0, 31.0)
    ocean = np.full((NT, nx, ny), 0.05)
    era5_to_archive(era5_path, archive_path, dst_lats, dst_lons, extra_fields={"u_ocean": ocean}, mld=15.0)

    provider = ForcingProvider(archive_path, dtype=torch.float64, **CPU)
    forcing = provider.thermo_forcing(1800.0, nx, ny)  # halfway step 0 -> 1
    assert forcing.tair.shape == (nx, ny)
    expected = (
        250.0 + 0.05  # half a time step
        + 0.2 * (dst_lats[2, 3] - 70.0) + 0.05 * (dst_lons[2, 3] - 10.0)
        - 273.15
    )
    np.testing.assert_allclose(float(forcing.tair[2, 3]), expected, atol=2e-3)
    np.testing.assert_allclose(float(forcing.mld[0, 0]), 15.0)
    dyn = provider.dynamics_forcing(0.0, nx, ny)
    assert torch.all(dyn.u_ocean == 0.05)
    # A mismatched extra field is rejected.
    with pytest.raises(ValueError):
        era5_to_archive(era5_path, archive_path, dst_lats, dst_lons, extra_fields={"u_ocean": ocean[:, :2]})


# -- against the JAX package ---------------------------------------------------
@pytest.mark.parametrize("mask_cell", [None, (4, 6)], ids=["clean", "masked"])
def test_dataset_equals_jax(tmp_path, mask_cell):
    path = str(tmp_path / "era5.nc")
    _write_era5(path, mask_cell=mask_cell)
    got, want = ERA5Dataset(path), jax_era5.ERA5Dataset(path)
    for name in ("time", "lats", "lons"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert list(got.fields) == list(want.fields)
    for name, values in want.fields.items():
        np.testing.assert_array_equal(got.fields[name], values, err_msg=name)


def test_raw_reader_keeps_values_and_attributes(tmp_path):
    """read_era5_variables: every root dataset as stored, with its CF
    attributes (the one place that opens the file)."""
    path = str(tmp_path / "era5.nc")
    _write_era5(path)
    variables = era5.read_era5_variables(path)
    assert sorted(variables) == ["latitude", "longitude", "sf", "ssrd", "t2m", "time", "u10", "v10"]
    raw, attrs = variables["t2m"]
    assert raw.dtype == np.int16 and raw.shape == (NT, len(LATS), len(LONS))
    assert float(attrs["scale_factor"]) == 1e-3 and int(attrs["_FillValue"]) == -32767
    assert era5._attr_str(variables["time"][1], "units").startswith("hours since 1900")


@pytest.mark.parametrize("spherical", [False, True], ids=["box", "spherical"])
def test_regrid_and_fill_equal_jax(tmp_path, spherical):
    """Every decoded field of the masked file regridded onto a box's or a
    spherical mesh's centres; the nearest fill of a plane with NaNs."""
    path = str(tmp_path / "era5.nc")
    _write_era5(path, mask_cell=(2, 3))
    ds = jax_era5.ERA5Dataset(path)
    if spherical:
        dst = SphericalMesh(12, 10, 11.0, 31.0, 71.0, 79.0).lonlat_centers()
    else:
        dst = lonlat_box(12, 10, 71.0, 79.0, 11.0, 31.0)
    for name, series in ds.fields.items():
        np.testing.assert_array_equal(regrid_bilinear(series, ds.lats, ds.lons, *dst),
                                      jax_era5.regrid_bilinear(series, ds.lats, ds.lons, *dst), err_msg=name)
    plane = np.random.default_rng(0).standard_normal((7, 9))
    plane[[0, 3, 6], [8, 4, 0]] = np.nan
    np.testing.assert_array_equal(era5._fill_nans(plane), jax_era5._fill_nans(plane))
    assert np.all(np.isfinite(era5._fill_nans(plane)))
    np.testing.assert_array_equal(np.stack(lonlat_box(7, 3, 60.0, 85.0, -40.0, 40.0)),
                                  np.stack(jax_era5.lonlat_box(7, 3, 60.0, 85.0, -40.0, 40.0)))


def test_era5_archives_equal_jax(tmp_path):
    """era5_to_archive of both packages on the same file and mesh writes the
    same archive."""
    era5_path = str(tmp_path / "era5.nc")
    _write_era5(era5_path)
    dst = lonlat_box(6, 5, 71.0, 79.0, 11.0, 31.0)
    era5_to_archive(era5_path, str(tmp_path / "port.h5"), *dst, mld=12.0)
    jax_era5.era5_to_archive(era5_path, str(tmp_path / "jax.h5"), *dst, mld=12.0)
    got_time, got = read_forcing_archive(str(tmp_path / "port.h5"))
    want_time, want = read_forcing_archive(str(tmp_path / "jax.h5"))
    np.testing.assert_array_equal(got_time, want_time)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    ref = jax_ff.ForcingProvider(str(tmp_path / "jax.h5"))
    port = ForcingProvider(str(tmp_path / "port.h5"), **CPU)
    np.testing.assert_array_equal(port.thermo_forcing(5000.0, 6, 5).tair.numpy(),
                                  np.asarray(ref.thermo_forcing(5000.0, 6, 5).tair))


@pytest.mark.parametrize("extent", [
    (16, 16, -40.0, 40.0, 55.0, 85.0), (7, 5, 11.0, 31.0, 71.0, 79.0), (24, 8, 0.0, 360.0, 60.0, 75.0),
], ids=["arctic", "box", "ring"])
def test_lonlat_centers_equal_jax(extent):
    nx, ny, lon0, lon1, lat0, lat1 = extent
    periodic = lon1 - lon0 == 360.0
    got = SphericalMesh(nx, ny, lon0, lon1, lat0, lat1, periodic_x=periodic).lonlat_centers()
    want = JaxSphericalMesh(nx, ny, lon0, lon1, lat0, lat1, periodic_x=periodic).lonlat_centers()
    for a, b in zip(got, want):
        assert a.shape == (nx, ny)
        np.testing.assert_array_equal(a, np.asarray(b))
