"""The port's restart I/O and structures (``nextsimdg_tpu_torch.io``,
``nextsimdg_tpu_torch.grid``) against the JAX package's.

Twins of ``tests/test_restart_io.py`` and ``tests/test_netcdf_interop.py``:
a file written by either package reads identically in the other, the two
writers' HDF5 trees and attributes are equal, the structures round-trip the
reference's probe value and dispatch on ``/structure@type``, and (where the
system libnetcdf loads) the port's files are real netCDF-4 read through it.
The port's structures take the device and dtype from the caller: here the
CPU, float64. The port's Configurator and registry are reset around every
test.
"""

import h5py
import numpy as np
import pytest
import torch

from nextsimdg_tpu.config import Configurator as JaxConfigurator
from nextsimdg_tpu.grid import DevGrid as JaxDevGrid
from nextsimdg_tpu.grid import StructureFactory as JaxStructureFactory
from nextsimdg_tpu.io import restart as jax_restart
from nextsimdg_tpu.io.netcdf_c import read_restart_via_libnetcdf as jax_read_via_libnetcdf
from nextsimdg_tpu.tools.make_dev_restart import make_dev_restart as jax_make_dev_restart
from nextsimdg_tpu_torch.config import Configurator
from nextsimdg_tpu_torch.grid import DevGrid, RectGrid, StructureFactory
from nextsimdg_tpu_torch.io import netcdf_c, restart
from nextsimdg_tpu_torch.modules import get_loader
from nextsimdg_tpu_torch.state import PrognosticState
from nextsimdg_tpu_torch.tools.make_dev_restart import dev_restart_fields, make_dev_restart

torch.set_num_threads(1)

CPU64 = {"device": "cpu", "dtype": torch.float64}
FIELDS = ("hice", "cice", "hsnow", "sst", "sss", "tice")


@pytest.fixture(autouse=True)
def clean_port():
    Configurator.clear()
    get_loader().reset()
    yield
    Configurator.clear()
    get_loader().reset()


def seeded_fields(nx=12, ny=9, nlayers=3, seed=7):
    rng = np.random.default_rng(seed)
    return {name: rng.random((nx, ny)) for name in restart.VAR_NAMES_2D}, rng.random((nx, ny, nlayers))


def same_fields(a, b):
    assert a.structure_type == b.structure_type
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


@pytest.mark.parametrize("writer, reader", [
    (restart.write_restart, jax_restart.read_restart),
    (jax_restart.write_restart, restart.read_restart),
], ids=["port-to-jax", "jax-to-port"])
def test_a_file_of_either_package_reads_identically_in_the_other(tmp_path, writer, reader):
    fields, tice = seeded_fields()
    path = str(tmp_path / "r.nc")
    writer(path, "rectgrid", fields, tice)
    got = reader(path)
    assert got.structure_type == "rectgrid" and got.n_ice_layers == 3
    for name in restart.VAR_NAMES_2D:
        np.testing.assert_array_equal(getattr(got, name), fields[name], err_msg=name)
    np.testing.assert_array_equal(got.tice, tice)
    same_fields(restart.read_restart(path), jax_restart.read_restart(path))
    assert restart.read_structure_type(path) == jax_restart.read_structure_type(path)


def hdf5_tree(path):
    """{object name: (kind, dtype, shape, {attribute: comparable value})}:
    object references compare by the names they point at."""
    tree = {}
    with h5py.File(path, "r") as handle:
        def attrs(obj):
            out = {}
            for key, value in obj.attrs.items():
                if isinstance(value, np.ndarray) and value.dtype == object:  # DIMENSION_LIST
                    value = [[str(handle[ref].name) for ref in np.ravel(refs)] for refs in np.ravel(value)]
                elif isinstance(value, np.ndarray) and value.dtype.names:  # REFERENCE_LIST
                    value = [(str(handle[row[0]].name), int(row[1])) for row in value]
                elif isinstance(value, np.ndarray):
                    value = (value.dtype.str, value.tolist())
                out[key] = value
            return out

        tree["/"] = ("group", None, None, attrs(handle))

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                tree[name] = ("dataset", obj.dtype.str, obj.shape, attrs(obj))
            else:
                tree[name] = ("group", None, None, attrs(obj))

        handle.visititems(visit)
    return tree


def test_the_two_writers_write_the_same_hdf5_tree(tmp_path):
    fields, tice = seeded_fields()
    mine, theirs = str(tmp_path / "port.nc"), str(tmp_path / "jax.nc")
    restart.write_restart(mine, "devgrid", fields, tice)
    jax_restart.write_restart(theirs, "devgrid", fields, tice)
    tree = hdf5_tree(mine)
    assert tree == hdf5_tree(theirs)
    assert set(tree) == {"/", "structure", "data"} | {f"data/{n}" for n in ("x", "y", "nLayers", *FIELDS)}
    assert all(tree[f"data/{n}"][1] == "<f8" for n in FIELDS)


def fill_synthetic(grid):
    """The reference test's 1 + 0.01 j + 0.0001 i pattern
    (``DevGrid_test.cpp:30-44``), as in ``tests/test_restart_io.py``."""
    nx, ny = grid.nx, grid.ny
    k = np.arange(nx * ny)
    frac = ((k // ny) * 0.01 + (k % ny) * 0.0001).reshape(nx, ny)
    as_t = lambda a: torch.tensor(a, dtype=grid.dtype)
    grid.prognostic = PrognosticState(
        hice=as_t(1 + frac), cice=as_t(2 + frac), sst=as_t(3 + frac), sss=as_t(4 + frac),
        hsnow=as_t(5 + frac), tice=as_t(-(1 + frac)[None, :, :]),
    )


def test_devgrid_round_trip_probe(tmp_path):
    path = str(tmp_path / "DevGrid_test.nc")
    grid = DevGrid(**CPU64)
    grid.init("")
    fill_synthetic(grid)
    grid.dump(path)

    grid2 = DevGrid(**CPU64)
    grid2.init("")
    target = 7 * DevGrid.NX + 3
    xi, yi = target // grid2.ny, target % grid2.ny
    assert float(grid2.prognostic.hice[xi, yi]) == 0.0
    grid2.init(path)
    assert float(grid2.prognostic.hice[xi, yi]) == 1.0703
    assert -2.0 < float(grid2.prognostic.tice[0, xi, yi]) < -1.0

    # The JAX structure reads the port's dump to the same state.
    jax_grid = JaxStructureFactory.generate_from_file(path)
    assert isinstance(jax_grid, JaxDevGrid)
    for name in FIELDS:
        np.testing.assert_array_equal(
            getattr(grid2.prognostic, name).numpy(), np.asarray(getattr(jax_grid.prognostic, name))
        )


def test_structure_factory_from_file_and_fields(tmp_path):
    path = str(tmp_path / "fact.nc")
    make_dev_restart(path)
    structure = StructureFactory.generate_from_file(path, **CPU64)
    assert isinstance(structure, DevGrid) and structure.prognostic.hice.dtype == torch.float64
    from_fields = StructureFactory.generate_from_fields(dev_restart_fields(), **CPU64)
    for name in FIELDS:
        assert torch.equal(getattr(structure.prognostic, name), getattr(from_fields.prognostic, name))
    same_fields(structure.restart_fields(), restart.read_restart(path))


@pytest.mark.parametrize("name, cls", [
    ("devgrid", DevGrid), ("DevGrid", DevGrid), ("DEVGRID", DevGrid),
    ("rectgrid", RectGrid), ("RectGrid", RectGrid),
])
def test_structure_factory_by_name_and_case(name, cls):
    structure = StructureFactory.generate(name, device="cpu", dtype=torch.float32)
    assert type(structure) is cls
    assert structure.device == torch.device("cpu") and structure.dtype == torch.float32
    assert type(JaxStructureFactory.generate(name)).__name__ == cls.__name__


def test_structure_factory_unknown_name_and_no_default_device():
    with pytest.raises(ValueError):
        StructureFactory.generate("no_such_structure", **CPU64)
    with pytest.raises(ValueError):
        JaxStructureFactory.generate("no_such_structure")
    with pytest.raises(TypeError):
        StructureFactory.generate("devgrid")
    with pytest.raises(TypeError):
        DevGrid()


def test_structures_register_in_the_reference_order():
    assert get_loader().list_implementations("Nextsim::IStructure") == [
        "Nextsim::DevGrid", "Nextsim::RectGrid",
    ]


def test_rectgrid_configurable_and_round_trip(tmp_path):
    Configurator.add_stream("[rectgrid]\nnx = 4\nny = 6\nnlayers = 2\n")
    JaxConfigurator.add_stream("[rectgrid]\nnx = 4\nny = 6\nnlayers = 2\n")
    grid = RectGrid(**CPU64)
    grid.configure()
    grid.init("")
    assert grid.prognostic.hice.shape == (4, 6)
    assert grid.prognostic.tice.shape == (2, 4, 6)
    path = str(tmp_path / "rect.nc")
    grid.dump(path)
    assert restart.read_structure_type(path) == "rectgrid"
    grid2 = StructureFactory.generate_from_file(path, **CPU64)
    assert isinstance(grid2, RectGrid)
    assert grid2.nx == 4 and grid2.ny == 6 and grid2.n_ice_layers() == 2

    from nextsimdg_tpu.grid import RectGrid as JaxRectGrid

    jax_grid = JaxRectGrid()
    jax_grid.configure()
    jax_grid.init("")
    jax_path = str(tmp_path / "jax_rect.nc")
    jax_grid.dump(jax_path)
    assert hdf5_tree(jax_path) == hdf5_tree(path)


def test_the_dev_restart_of_both_packages_is_the_same_file(tmp_path):
    mine, theirs = str(tmp_path / "port.nc"), str(tmp_path / "jax.nc")
    make_dev_restart(mine)
    jax_make_dev_restart(theirs)
    same_fields(restart.read_restart(mine), jax_restart.read_restart(theirs))
    assert hdf5_tree(mine) == hdf5_tree(theirs)


@pytest.fixture
def libnetcdf():
    if not netcdf_c.available():
        pytest.skip("no system libnetcdf")


def test_written_restart_round_trips_through_libnetcdf(tmp_path, libnetcdf):
    """The port's writer emits valid netCDF-4: libnetcdf opens it, sees the
    reference schema, and reads every value back bit-exactly, as the JAX
    package's libnetcdf reader does."""
    fields, tice = seeded_fields()
    path = str(tmp_path / "written.nc")
    restart.write_restart(path, "devgrid", fields, tice)
    with netcdf_c.NetCDFReader(path) as nc:
        assert set(nc.group_names()) == {"structure", "data"}
        assert nc.get_att_text(nc.group_id("structure"), "type") == "devgrid"
        data = nc.group_id("data")
        assert nc.dims(data) == {"x": 12, "y": 9, "nLayers": 3}
        assert set(nc.var_names(data)) >= set(restart.VAR_NAMES_2D) | {"tice"}
        assert nc.var_shape(data, "tice") == (12, 9, 3)
    got = netcdf_c.read_restart_via_libnetcdf(path)
    for name in restart.VAR_NAMES_2D:
        np.testing.assert_array_equal(getattr(got, name), fields[name], err_msg=name)
    np.testing.assert_array_equal(got.tice, tice)
    same_fields(got, jax_read_via_libnetcdf(path))


def test_model_written_restart_is_real_netcdf(tmp_path, libnetcdf):
    init = str(tmp_path / "init.nc")
    make_dev_restart(init)
    grid = StructureFactory.generate_from_file(init, device="cpu", dtype=torch.float32)
    out = str(tmp_path / "restart.nc")
    grid.dump(out)
    same_fields(netcdf_c.read_restart_via_libnetcdf(out), restart.read_restart(out))


def test_interop_carries_a_restart_into_both_packages(tmp_path):
    """``interop.prognostic_from_restart`` gives the port the state that the
    JAX structure loads from the same file, and ``restart_from_prognostic``
    gives back the file's arrays."""
    from nextsimdg_tpu_torch import interop

    fields, tice = seeded_fields(nlayers=3)
    path = str(tmp_path / "r.nc")
    restart.write_restart(path, "rectgrid", fields, tice)
    loaded = restart.read_restart(path)
    prog = interop.prognostic_from_restart(loaded, **CPU64)
    assert prog.tice.shape == (3, 12, 9)
    ref = interop.prognostic_state_to_numpy(JaxStructureFactory.generate_from_file(path).prognostic)
    for name, value in interop.prognostic_state_to_numpy(prog).items():
        np.testing.assert_array_equal(value, ref[name], err_msg=name)
    same_fields(interop.restart_from_prognostic(prog, "rectgrid"), loaded)
