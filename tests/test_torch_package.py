"""Packaging of the port: no JAX, the kernel build and binding contract, the
CPU dispatch of the kernel wrappers, and chip_smoke.py's refusal to run
without a GPU."""

import itertools
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nextsimdg_tpu_torch.coupled import CoupledModel
from nextsimdg_tpu_torch.dynamics import RectMesh
from nextsimdg_tpu_torch.dynamics.kernels import coupled_cuda as cc
from nextsimdg_tpu_torch.dynamics.kernels import ho_single_cuda as hs
from nextsimdg_tpu_torch.dynamics.kernels import ho_tiled_cuda as ht
from nextsimdg_tpu_torch.dynamics.kernels import mevp_rdma_cuda as rdma
from nextsimdg_tpu_torch.dynamics.kernels import mevp_single_cuda as ms
from nextsimdg_tpu_torch.dynamics.kernels import mevp_tiled_cuda as mt
from nextsimdg_tpu_torch.dynamics.kernels import transport_tiled_cuda as tt
from nextsimdg_tpu_torch.dynamics.mevp import DynamicsForcing, VelocityState, const_names
from nextsimdg_tpu_torch.dynamics import mevp_ho
from nextsimdg_tpu_torch.dynamics.dgbasis import DG_DOFS, dg_basis
from nextsimdg_tpu_torch.dynamics.mevp_ho import MEVPSolverHO

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "nextsimdg_tpu_torch"


def test_port_imports_without_jax_or_triton():
    code = (
        "import sys\n"
        "import nextsimdg_tpu_torch, nextsimdg_tpu_torch.coupled, nextsimdg_tpu_torch.interop\n"
        "import nextsimdg_tpu_torch.constants, nextsimdg_tpu_torch.state\n"
        "import nextsimdg_tpu_torch.physics.nextsim_physics, nextsimdg_tpu_torch.physics.humidity\n"
        "import nextsimdg_tpu_torch.physics.freezing, nextsimdg_tpu_torch.physics.albedo\n"
        "import nextsimdg_tpu_torch.physics.ice_ocean_heat_flux\n"
        "import nextsimdg_tpu_torch.physics.concentration, nextsimdg_tpu_torch.physics.thermo_ice0\n"
        "import nextsimdg_tpu_torch.dynamics.kernels.coupled_cuda\n"
        "import nextsimdg_tpu_torch.dynamics.kernels.mevp_tiled_cuda\n"
        "import nextsimdg_tpu_torch.dynamics.kernels.transport_tiled_cuda\n"
        "import nextsimdg_tpu_torch.dynamics.kernels.mevp_single_cuda\n"
        "import nextsimdg_tpu_torch.dynamics.kernels.ho_single_cuda\n"
        "import nextsimdg_tpu_torch.dynamics.kernels.ho_tiled_cuda\n"
        "import nextsimdg_tpu_torch.dynamics.landmask, nextsimdg_tpu_torch.dynamics.mesh\n"
        "import nextsimdg_tpu_torch.dynamics.cg2basis, nextsimdg_tpu_torch.dynamics.mevp_ho\n"
        "import nextsimdg_tpu_torch.modules\n"
        "import nextsimdg_tpu_torch.benchmarks.roofline, nextsimdg_tpu_torch.benchmarks.common\n"
        "import nextsimdg_tpu_torch.benchmarks.run_benchmarks, nextsimdg_tpu_torch.benchmarks.mevp_large\n"
        "import nextsimdg_tpu_torch.physics.thermo_winton\n"
        "import nextsimdg_tpu_torch.config, nextsimdg_tpu_torch.config.configurator\n"
        "import nextsimdg_tpu_torch.config.configured, nextsimdg_tpu_torch.config.configured_module\n"
        "import nextsimdg_tpu_torch.config.command_line, nextsimdg_tpu_torch.config.enum_map\n"
        "import nextsimdg_tpu_torch.utils, nextsimdg_tpu_torch.utils.chrono\n"
        "import nextsimdg_tpu_torch.utils.timer, nextsimdg_tpu_torch.utils.logged\n"
        "import nextsimdg_tpu_torch.io, nextsimdg_tpu_torch.io.restart, nextsimdg_tpu_torch.io.netcdf_c\n"
        "import nextsimdg_tpu_torch.grid, nextsimdg_tpu_torch.grid.structure\n"
        "import nextsimdg_tpu_torch.grid.devgrid, nextsimdg_tpu_torch.grid.rectgrid\n"
        "import nextsimdg_tpu_torch.grid.factory\n"
        "import nextsimdg_tpu_torch.runtime, nextsimdg_tpu_torch.runtime.iterator\n"
        "import nextsimdg_tpu_torch.runtime.simple_iterant, nextsimdg_tpu_torch.runtime.model_step\n"
        "import nextsimdg_tpu_torch.runtime.model, nextsimdg_tpu_torch.runtime.main\n"
        "import nextsimdg_tpu_torch.tools.make_dev_restart\n"
        "import nextsimdg_tpu_torch.io.coupled_restart, nextsimdg_tpu_torch.io.diagnostics\n"
        "import nextsimdg_tpu_torch.io.forcing_pipeline, nextsimdg_tpu_torch.benchmarks.host_copies\n"
        "import nextsimdg_tpu_torch.runtime.health, nextsimdg_tpu_torch.runtime.coupled_main\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'triton', 'nextsimdg_tpu')]\n"
        "assert not bad, bad\n"
        "# Restart files need h5py, which the card machine may lack: the\n"
        "# package imports without it.\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == 'h5py']\n"
        "assert not bad, bad\n"
    )
    done = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert done.returncode == 0, done.stderr


def test_port_sources_never_name_jax():
    pattern = re.compile(r"^\s*(import jax|from jax|import nextsimdg_tpu\b|from nextsimdg_tpu\b)", re.M)
    offenders = [
        str(path) for path in PACKAGE.rglob("*.py") if pattern.search(path.read_text())
    ]
    assert offenders == []


HO_DIMS = {"kHoCoeffs": 3, "kHoNodes": 9, "kHoGauss": 4, "kHoPlanes": 4}


def _dg_dims(degree: int) -> dict:
    """The sizes of DgShape<degree> in csrc/dg1_body.cuh, from the basis."""
    b = dg_basis(degree)
    return {"kDofs": b.n_dofs, "kVol": len(b.w_vol), "kEdge": len(b.s_edge)}


def _struct_floats(source: str, name: str, dims=HO_DIMS) -> int:
    """Floats declared in a plain-float C struct, arrays included (``dims``:
    the sizes that its array bounds name)."""
    body = re.search(rf"struct {name} {{(.*?)\n}};", source, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    count = 0
    for decl in re.findall(r"float\s+([^;]+);", body):
        for item in decl.split(","):
            size = 1
            for dim in re.findall(r"\[(\w+)\]", item):
                size *= int(dims.get(dim, dim))
            count += size
    return count


def _struct_pointers(source: str, name: str, dims=HO_DIMS) -> int:
    """Pointers declared in a plain struct of ``const float*``, arrays included."""
    body = re.search(rf"struct {name} {{(.*?)\n}};", source, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    count = 0
    for decl in re.findall(r"const float\*\s*([^;]+);", body):
        for item in decl.split(","):
            size = 1
            for dim in re.findall(r"\[(\w+)\]", item):
                size *= int(dims.get(dim, dim))
            count += size
    return count


def test_host_packing_matches_the_c_structs():
    model = CoupledModel(RectMesh(8, 8, 2000.0, 2000.0))
    mevp_src = (cc.CSRC / "mevp_body.cuh").read_text()
    transport_src = (cc.CSRC / "dg1_body.cuh").read_text()
    ho_src = (cc.CSRC / "ho_body.cuh").read_text()
    assert len(cc._mevp_scalars(model.mevp, 600.0)) == _struct_floats(mevp_src, "MevpScalars")
    for degree in (0, 1, 2):
        transport = CoupledModel(RectMesh(8, 8, 2000.0, 2000.0), degree=degree).transport
        dims = _dg_dims(degree)
        assert len(cc._dg1_tables(transport)) == _struct_floats(transport_src, "DgTables", dims)
        assert cc._dg1_tables(transport).degree == degree
        assert _struct_pointers(transport_src, "DgQvPlanes", dims) == sum(cc._qv_planes(degree).values())
    assert [sum(cc._qv_planes(d).values()) for d in (0, 1, 2)] == [12, 12, 24]
    ho = MEVPSolverHO(model.mesh)
    assert len(cc._ho_scalars(ho, 600.0)) == _struct_floats(ho_src, "HoScalars")
    assert len(cc._ho_tables(ho)) == _struct_floats(ho_src, "HoTables")
    assert _struct_pointers(ho_src, "HoConsts") == len(mevp_ho.HO_KERNEL_CONSTS) == 37
    assert len(mevp_ho.HO_WEIGHTED_CONSTS) == 33
    assert len(mevp_ho.HO_CONSTS) == 29


REPLACED = {
    "mevp.cu": "coupled_pallas.py::fused_dynamics_pallas",
    "transport.cu": "coupled_pallas.py::fused_dynamics_pallas",
    "transport_tvb.cu": "coupled_pallas.py::fused_dynamics_pallas",
    "transport_periodic.cu": "coupled_pallas.py::fused_dynamics_pallas",
    "transport_periodic_qv.cu": "coupled_pallas.py::fused_dynamics_pallas",
    "transport_periodic_qv_metric.cu": "coupled_pallas.py::fused_dynamics_pallas",
    "transport_tiled_qv.cu": "transport_tiled.py::transport_substeps_tiled",
    "transport_tiled_qv_metric.cu": "transport_tiled.py::transport_substeps_tiled",
    "transport_tiled_tvb.cu": "transport_tiled.py::transport_substeps_tiled",
    "ho_single_forms.cu": "mevp_ho_pallas.py::ho_subcycles_pallas",
    "ho_single_metric.cu": "mevp_ho_pallas.py::ho_subcycles_pallas",
    "ho_tiled_forms.cu": "mevp_ho_tiled.py::ho_subcycles_tiled",
    "ho_tiled_metric.cu": "mevp_ho_tiled.py::ho_subcycles_tiled",
    "transport_tiled_forms.cu": "transport_tiled.py::transport_substeps_tiled",
    "mevp_tiled_periodic.cu": "mevp_tiled.py::mevp_subcycles_tiled",
    "mevp_single_periodic.cu": "mevp_pallas.py::mevp_subcycles_pallas",
    "mevp_single_periodic_adaptive.cu": "mevp_pallas.py::mevp_subcycles_pallas",
    "mevp_tiled.cu": "mevp_tiled.py::mevp_subcycles_tiled",
    "transport_tiled.cu": "transport_tiled.py::transport_substeps_tiled",
    "mevp_single.cu": "mevp_pallas.py::mevp_subcycles_pallas",
    "mevp_single_adaptive.cu": "mevp_pallas.py::mevp_subcycles_pallas",
    "ho_single.cu": "mevp_ho_pallas.py::ho_subcycles_pallas",
    "ho_tiled.cu": "mevp_ho_tiled.py::ho_subcycles_tiled",
    "mevp_rdma.cu": "mevp_rdma.py::mevp_round_rdma",
    "mevp_rdma_forms.cu": "mevp_rdma.py::mevp_round_rdma",
    "mevp_rdma_metric.cu": "mevp_rdma.py::mevp_round_rdma",
    "mevp_rdma_ho.cu": "mevp_rdma.py::mevp_round_rdma",
    "mevp_rdma_ho_forms.cu": "mevp_rdma.py::mevp_round_rdma",
    "mevp_rdma_ho_metric.cu": "mevp_rdma.py::mevp_round_rdma",
    "mevp_rdma_ho_l2.cu": "mevp_rdma.py::mevp_round_rdma",
    "transport_tiled_spmd.cu": "transport_tiled.py::transport_substeps_tiled",
    "transport_tiled_spmd_qv.cu": "transport_tiled.py::transport_substeps_tiled_spmd",
    "transport_spmd.cu": "coupled_pallas.py::fused_dynamics_pallas",
    "transport_spmd_qv.cu": "coupled_pallas.py::fused_dynamics_pallas",
    "transport_tvb_spmd.cu": "coupled_pallas.py::fused_dynamics_pallas",
    "mevp_spmd.cu": "coupled_pallas.py::fused_dynamics_pallas",
    "mevp_spmd_forms.cu": "coupled_pallas.py::fused_dynamics_pallas",
    "ho_halves_spmd.cu": "mevp_ho_pallas.py::ho_subcycles_pallas",
    "ho_halves_spmd_forms.cu": "mevp_ho_pallas.py::ho_subcycles_pallas",
    "roofline.cu": "roofline.py::measure_vpu_peak",
}


def test_build_contract():
    assert cc.CSRC == PACKAGE / "csrc"
    assert {p.name for p in cc.CSRC.glob("*.cu")} == set(REPLACED)
    for source in cc.CSRC.glob("*.cu"):
        assert REPLACED[source.name] in source.read_text()
    flags = " ".join(cc.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "--fmad=false" in flags
    assert cc.LINK_FLAGS == ("-shared",)
    path = cc.library_path()
    assert path.parent == REPO / "build" / "nextsimdg_tpu_torch"
    assert path == cc.library_path()  # keyed on the sources, deterministic
    assert "build/" in (REPO / ".gitignore").read_text().split()


def _inputs(n=8):
    rng = np.random.default_rng(0)
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    model = CoupledModel(RectMesh(n, n, 2000.0, 2000.0), n_subcycles=3)
    carry = tuple(t(rng.normal(0.0, s, (n, n))) for s in (0.5, 0.5, 1e3, 1e3, 1e3))
    forcing = DynamicsForcing(*(t(rng.normal(m, 1.0, (n, n))) for m in (8.0, 2.0, 0.0, 0.0)))
    mask = model.node_mask(device="cpu", dtype=torch.float32)
    h, a = t(rng.uniform(0.5, 2.0, (n, n))), t(rng.uniform(0.5, 1.0, (n, n)))
    consts = model.mevp.step_consts(VelocityState(*carry), h, a, forcing, mask, 600.0)
    psi = t(rng.uniform(0.0, 1.0, (3, 3, n, n)))
    return model, carry, consts, psi


def test_wrappers_run_the_plain_version_for_cpu_tensors():
    model, carry, consts, psi = _inputs()
    cc.reset_launches()
    got = cc.mevp_stress(model.mevp, carry, consts)
    for g, r in zip(got, model.mevp.stress_update(carry, consts)):
        assert torch.equal(g, r)
    c_w, inv_drag = got[3], got[4]
    got = cc.mevp_velocity(model.mevp, carry, consts, c_w, inv_drag, 600.0)
    ref = model.mevp.velocity_update(carry, consts, c_w, inv_drag, 600.0)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    speeds = cc.dg1_sample_cfl(model.transport, carry[0], carry[1])
    assert torch.equal(speeds, cc.dg1_sample_cfl_reference(model.transport, carry[0], carry[1]))
    ones = torch.ones_like(carry[0])
    args = (model.transport, psi, psi, carry[0], carry[1], ones, ones, 0.5, 0.5, 60.0)
    assert torch.equal(cc.dg1_rk_stage(*args), cc.dg1_rk_stage_reference(*args))
    assert all(count == 0 for count in cc.launches.values())


def test_tiled_wrappers_run_the_plain_version_for_cpu_tensors():
    model, carry, consts, psi = _inputs()
    cc.reset_launches()
    got = mt.mevp_subcycles_tiled(model.mevp, carry, consts, 600.0, 3)
    ref = carry
    for _ in range(3):
        ref = model.mevp.subcycle_body(ref, consts, 600.0)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert all(torch.equal(g, r) for g, r in zip(cc.mevp_subcycles(model.mevp, carry, consts, 600.0, 3), ref))
    ones = torch.ones_like(carry[0])
    args = (model.transport, psi, carry[0] * 0.01, carry[1] * 0.01, 60.0, 2, (ones, ones))
    got = tt.transport_substeps_tiled(*args)
    assert torch.equal(got, cc.transport_substeps(*args))
    assert torch.equal(got, tt.transport_substeps_tiled_reference(*args))
    assert all(count == 0 for count in cc.launches.values())
    meta = tuple(c.to("meta") for c in carry)
    with pytest.raises(ValueError, match="not supported"):
        mt.mevp_subcycles_tiled(model.mevp, meta, consts, 600.0, 3)
    with pytest.raises(ValueError, match="not supported"):
        tt.transport_substeps_tiled(model.transport, psi.to("meta"), *meta[:2], 60.0, 1)


def test_rdma_round_sources_run_the_plain_version_for_cpu_tensors():
    """rdma_stage takes the plain version for CPU tensors; the round's
    pointer arrays are built and checked once per set of ghosts, and a
    missing or malformed ghost pair raises."""
    model, carry, _, _ = _inputs()
    h, (nx, ny) = 2, carry[0].shape
    src = rdma.RoundSources(own=carry, h=h, split=(True, True))
    cc.reset_launches()
    assert torch.equal(rdma.rdma_stage(src, 0), torch.stack([
        torch.stack([c[:h] for c in carry]), torch.stack([c[nx - h:] for c in carry])
    ]))
    with pytest.raises(ValueError, match="not been received"):
        src.c_args(need_gx=True, need_gy=False)
    ptrs, dims = src.c_args(need_gx=False, need_gy=False)
    # The dims carry the plane count last (5; the HO round's 17).
    assert src.c_args(need_gx=False, need_gy=False)[0] is ptrs and list(dims) == [nx, ny, h, h, h, 5]
    assert list(ptrs)[:5] == [c.data_ptr() for c in carry] and list(ptrs)[5:] == [None] * 4
    ghosts = torch.arange(5 * h * ny, dtype=torch.float32).reshape(5, h, ny)
    negative = -ghosts
    src.gx = (ghosts, negative)
    with_gx, _ = src.c_args(need_gx=True, need_gy=False)
    assert with_gx is not ptrs and list(with_gx)[5:7] == [ghosts.data_ptr(), negative.data_ptr()]
    assert src.c_args(need_gx=True, need_gy=False)[0] is with_gx
    ext = torch.cat([ghosts, torch.stack(carry), negative], dim=1)
    assert torch.equal(rdma.rdma_stage(src, 1), torch.stack([ext[:, :, :h], ext[:, :, -h:]]))
    assert torch.equal(rdma.rdma_stage(src, 1), rdma.rdma_stage_reference(src, 1))
    assert all(count == 0 for count in cc.launches.values())
    src.gy = (ghosts, ghosts)  # (5, h, ny), not (5, nx + 2h, h)
    with pytest.raises(ValueError, match="shape"):
        src.c_args(need_gx=True, need_gy=True)
    double = rdma.RoundSources(own=tuple(c.double() for c in carry), h=h, split=(True, True))
    with pytest.raises(TypeError, match="float32"):
        double.c_args(need_gx=False, need_gy=False)


def test_launch_counts_are_per_kernel_and_reset():
    """The launch counts hold one entry per kernel of the library, and a
    reset clears every one of them."""
    assert tuple(cc.launches) == cc.KERNELS
    cc.launches["rdma_stage"] += 3
    cc.launches["mevp_tiled"] += 1
    cc.reset_launches()
    assert tuple(cc.launches) == cc.KERNELS and sum(cc.launches.values()) == 0


def test_launch_configurations_fit_a_block():
    """The default tiles fit the 227 KB of shared memory of a block for
    every halo the host picks."""
    limit = 232448
    # mevp_tiled: a window of the 5 state planes for the launch configuration
    # the host picks at every size (a launch of n_sub <= halo subcycles keeps
    # the window of halo). The large uniform grids' runs two blocks an SM, by
    # shared memory (228 KB an SM, 1 KB of it reserved per block) and by
    # threads (2048 an SM); the other one block of 1024 threads.
    per_sm, reserved = 233472, 1024
    for n, metric in itertools.product((8, 256, 1024, 1448, 2048, 2080, 4096), (False, True)):
        tile, halo, threads = mt.launch_config(n, n, metric)
        large = not metric and n * n >= mt.LARGE_MIN_ELEMENTS
        assert (tile, halo, threads) == (mt.LARGE if large else mt.SMALL)
        assert mt.shared_bytes(tile, halo) == 5 * (tile + 2 * halo) ** 2 * 4 <= limit
        assert threads <= 1024 and 1 <= mt.cells_per_thread(tile, halo, threads) <= mt.MAX_CELLS
    tile, halo, threads = mt.LARGE
    assert 2 * (mt.shared_bytes(tile, halo) + reserved) <= per_sm and 2 * threads <= 2048
    assert mt.launch_config(2048, 2048) == mt.LARGE and mt.launch_config(1024, 1024) == mt.SMALL
    assert mt.launch_config(4096, 4096, metric=True) == mt.SMALL
    assert mt.cells_per_thread(64, 8, 1024) == 7 and mt.cells_per_thread(8, 3, 512) == 1
    assert mt.cells_per_thread(56, 8, 256) > mt.MAX_CELLS  # refused by the kernel
    assert mt.cells_per_thread(200, 8, 128) == 0  # fewer threads than a window row
    # transport_tiled: two window buffers and the scratch buffer at the tile
    # the host picks for the halo.
    for k in range(1, 10):
        for stages in (1, 2, 3):
            halo = tt.halo_for(k, stages)
            assert (halo - 1) // stages == min(k, tt.K_MAX)
            config = tt.launch_config(halo, stages=stages)
            assert tt.shared_bytes(config.tile, halo, 3, config.buffers, stages=stages) <= limit
    assert tt.SHIPPED.threads <= tt.MAX_THREADS == 768
    # ho_tiled: 17 planes of a block's sub-window and its one-cell apron; a
    # sub-window of 56 fits.
    for n in (8, 256, 512, 1000, 1024, 2048, 4096):
        config = ht.launch_config(n, n)
        assert config.shared_bytes() <= limit and config.threads <= ht.MAX_THREADS
    L = ht.LaunchConfig
    assert L(1, 1, 56, 8, 512).shared_bytes() <= limit < L(1, 1, 57, 8, 512).shared_bytes()
    assert L(2, 2, 48, 8, 512).shared_bytes() == 17 * 50 * 50 * 4


def test_ho_tiled_launch_config_fits_a_block_and_pads_the_grid():
    """The shipped launch (one window a block, at every size) and the 2 x 2
    clusters fit a block's 227 KB, their interiors and redundancy follow
    from the window, and the grid is a whole number of clusters that covers
    ragged and square grids; shapes the kernel does not take raise."""
    limit = 232448
    config = ht.launch_config(1024, 1024)
    assert config == ht.SHIPPED and config.shared_bytes() <= limit
    for n in (8, 256, 512, 513, 2048, 4096):
        assert ht.launch_config(n, n) == ht.SHIPPED
    assert ht.SHIPPED.rows * ht.SHIPPED.cols == 1 and ht.CLUSTER_2X2.rows * ht.CLUSTER_2X2.cols == 4
    assert ht.CLUSTER_2X2.halo == ht.SHIPPED.halo == ht.HALO
    for config in (ht.SHIPPED, ht.CLUSTER_2X2):
        assert config.shared_bytes() <= limit
        assert config.rows * config.cols <= ht.MAX_CLUSTER_BLOCKS and config.threads <= ht.MAX_THREADS
        assert config.interior == (config.rows * config.sub - 2 * config.halo, config.cols * config.sub - 2 * config.halo)
        for nx, ny in ((1000, 968), (1024, 1024), (37, 29)):
            ca, cb = config.clusters(nx, ny)
            gx, gy = config.grid(nx, ny)
            assert gx % config.cols == 0 and gy % config.rows == 0
            assert (gx // config.cols, gy // config.rows) == (cb, ca)
            assert (ca - 1) * config.interior[0] < nx <= ca * config.interior[0]
            assert (cb - 1) * config.interior[1] < ny <= cb * config.interior[1]
    assert ht.SHIPPED.clusters(1024, 1024) == (32, 32)  # 32^2 interiors
    L = ht.LaunchConfig
    assert L(2, 2, 48, 8, 512).clusters(1024, 1024) == (13, 13)  # 80^2 interiors
    assert L(2, 2, 48, 8, 512).grid(1000, 968) == (26, 26)
    # The window's ring, averaged over the subcycles of a launch.
    assert L(1, 1, 48, 8, 512).redundancy() == pytest.approx(1.583, abs=1e-3)
    assert L(2, 2, 48, 8, 512).redundancy() == pytest.approx(1.213, abs=1e-3)
    assert L(4, 4, 48, 8, 512).redundancy() < L(2, 4, 48, 8, 512).redundancy() < L(2, 2, 48, 8, 512).redundancy()
    for bad in (L(4, 8, 16, 4, 256), L(1, 1, 16, 8, 256), L(2, 2, 48, 8, 1024), L(0, 2, 48, 8, 512)):
        with pytest.raises(ValueError, match="launch configuration"):
            bad.check()


RAGGED = (1000, 968)  # chip_smoke.py's ragged grid


@pytest.mark.parametrize("shape", [(1024, 1024), RAGGED, (40, 70), (2064, 2064)])
def test_transport_tiled_persistent_walk_visits_every_tile_once(shape):
    """The persistent blocks' walk (block b takes tiles b, b + G, ...) visits
    every tile of the grid exactly once, for grids of whole waves and of a
    partial last wave, a ragged grid, one with ny % 4 != 0 and config 5's
    widened rank block; the per-tile launch has one block a tile."""
    nx, ny = shape
    for config in (tt.SHIPPED, tt.TWO_BLOCKS, tt.ONE_BUFFER, tt.PER_TILE):
        tiles = -(-nx // config.tile) * -(-ny // config.tile)
        for blocks in ({132, 264, 7, tiles, tiles + 5} if config.persistent else {tiles}):
            walk = tt.tile_walk(tiles, blocks)
            assert len(walk) == min(blocks, tiles)
            visited = sorted(t for block in walk for t in block)
            assert visited == list(range(tiles))
            sizes = {len(block) for block in walk}
            assert max(sizes) - min(sizes) <= 1  # 1024 tiles on 132 blocks: 7 or 8 each
    assert tt.copy_form(70, torch.zeros(4)) == "scalar"
    assert tt.copy_form(72, torch.zeros(4), None) == "vector"
    assert tt.copy_form(72, torch.zeros(5)[1:]) == "scalar"  # a base off 16 bytes


@pytest.mark.parametrize("degree", [0, 1, 2])
@pytest.mark.parametrize("qv", [False, True])
@pytest.mark.parametrize("stages", [1, 2, 3])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_transport_tiled_launch_fits_for_every_halo(k, stages, qv, degree):
    """The launch the host picks for each halo that halo_for gives, at each
    degree and scheme, fits a block's shared memory: at its full tile with
    a window of all 3 tracers where that fits (two window buffers where
    they fit, else one), else with a window of one tracer at the widest
    tile that fits; at most 384 threads at dG2; from 2048^2 elements two
    blocks an SM of one buffer where they fit at tile 30. Window rows hold
    the window from up to 3 cells in (the 16-byte boundary before it) in a
    multiple of 16 bytes."""
    limit, per_sm, reserved = 232448, 233472, 1024
    n_dofs = DG_DOFS[degree]
    halo = tt.halo_for(k, stages)
    group = tt.window_tracers(halo, qv, 3, 0, n_dofs, stages)
    config = tt.launch_config(halo, qv, group, 0, n_dofs, stages)
    size = lambda tile, buffers: tt.shared_bytes(tile, halo, group, buffers, qv, n_dofs, stages)
    assert config.threads == min(tt.SHIPPED.threads, tt.max_threads(n_dofs))
    assert config.threads <= (384 if degree == 2 else 768) and size(config.tile, config.buffers) <= limit
    if config.tile == tt.SHIPPED.tile and config.buffers == 1:  # two do not fit
        assert size(tt.SHIPPED.tile, 2) > limit
    all_three = tt.shared_bytes(tt.SHIPPED.tile, halo, 3, 1, qv, n_dofs, stages) <= limit
    assert group == (3 if all_three else 1)
    if config.tile < tt.SHIPPED.tile:  # one tracer a window, the widest tile that fits
        assert group == 1 and config.buffers == 1 and size(config.tile + 1, 1) > limit
    assert degree < 2 or stages < 3 or group == 1  # dG2 with rk3: a tracer a window
    w = config.tile + 2 * halo
    pitch = -(-(w + 3) // 4) * 4
    assert pitch * 4 % 16 == 0 and pitch >= w + 3
    large = tt.launch_config(halo, qv, group, 2064 * 2064, n_dofs, stages)
    if large.tile == tt.TWO_BLOCKS.tile and large.buffers == 1 and large.threads <= 384:
        assert 2 * (size(large.tile, 1) + reserved) <= per_sm
    else:
        assert large == config and 2 * (size(30, 1) + reserved) > per_sm
    assert tt.launch_config(halo, qv, group, 2048 * 2048 - 1, n_dofs, stages) == config
    assert tt.launch_config(tt.halo_for(1, 2), qv) == tt.SHIPPED
    assert tt.launch_config(tt.halo_for(1, 2), qv, 3, 4096 * 4096) == tt.TWO_BLOCKS
    assert 2 * tt.TWO_BLOCKS.threads <= tt.MAX_THREADS


@pytest.mark.parametrize("shape", [(256, 256), (512, 512), (40, 72), (37, 29), (600, 600), (1, 1)])
def test_ho_single_tiling_covers_the_grid_and_fits(shape):
    """ho_single's tiles: at most one a SM (132 on the H100), covering the
    grid with no empty tile, the state and apron within a block's shared
    memory (and the consts where consts_shared), threads for the tile up to
    512; each tile's neighbour table is symmetric (b reads a after the
    velocity half exactly when a reads b after the stress half)."""
    limit, sms = 232448, 132
    nx, ny = shape
    config = hs.tiling(nx, ny, sms)
    (tr, tc), (ti, tj) = config.tile, config.tiles
    assert config.n_tiles <= sms
    assert (ti - 1) * tr < nx <= ti * tr and (tj - 1) * tc < ny <= tj * tc
    assert config.shared_bytes() <= limit
    assert hs.shared_bytes(config.tile, False) == 17 * (tr + 2) * (tc + 2) * 4
    assert config.consts_shared == (hs.shared_bytes(config.tile, True) <= limit)
    assert 32 <= config.threads <= hs.MAX_THREADS and config.threads % 32 == 0
    for b in range(config.n_tiles):
        for a in hs.neighbours(config.tiles, b, 1):
            assert b in hs.neighbours(config.tiles, a, -1)
        for a in hs.neighbours(config.tiles, b, -1):
            assert b in hs.neighbours(config.tiles, a, 1)
    if shape == (256, 256):
        assert config.tile == (16, 32) and config.n_tiles == 128 and config.consts_shared
        assert config.threads == 512
    if shape == (512, 512):
        assert config.tile[0] * config.tile[1] <= 2048 and not config.consts_shared


def test_ho_single_refuses_a_grid_it_cannot_hold():
    """A grid whose tiles outnumber the SMs, or whose state does not fit the
    SMs' shared memory at one tile each, raises before any launch, on the
    host; the largest square grid held on 132 SMs is above 512^2 and below
    650^2."""
    with pytest.raises(ValueError, match="resident"):
        hs.tiling(40, 72, 132, (4, 4))
    with pytest.raises(ValueError, match="shared memory"):
        hs.tiling(700, 700, 132)
    held = [n for n in range(500, 700, 10) if hs.holds(n, n, 132)]
    assert held and 512 < max(held) < 650 and held == list(range(500, max(held) + 1, 10))
    assert max(held) <= hs.largest_square(132) < max(held) + 10


#: Const planes that fit beside mevp_single's state in a block's shared
#: memory, as mevp_single_cuda documents them: all 13 (the metric set and
#: a_node) up to 512^2, the first two of RESIDENT_ORDER (half_dx, half_dy)
#: at 1000 x 968, half_dx alone at 1024^2.
MEVP_SINGLE_ROOM = {(128, 128): 13, (256, 256): 13, (512, 512): 13, (1000, 968): 2, (1024, 1024): 1}


@pytest.mark.parametrize("shape", list(MEVP_SINGLE_ROOM))
def test_mevp_single_tiling_covers_the_grid_and_fits(shape):
    """mevp_single's tiles on 132 SMs: at most one a SM, covering the grid
    with no empty tile, at most 8 tile rows a thread of up to 1024, the
    state and the resident const planes (each with its apron) within a
    block's shared memory, and the const planes resident in RESIDENT_ORDER
    (the uniform set of 7 or the metric set of 12, with a_node 8 or 13 in
    the A-weighted form): all of them where they fit, else the most of
    PARTIAL_COUNTS that fit."""
    limit, sms = 232448, 132
    nx, ny = shape
    config = ms.tiling(nx, ny, sms)
    (tr, tc), (ti, tj) = config.tile, config.tiles
    assert config.n_tiles <= sms
    assert (ti - 1) * tr < nx <= ti * tr and (tj - 1) * tc < ny <= tj * tc
    assert 32 <= config.threads <= 1024 and config.threads % 32 == 0
    rows = config.threads // tc
    assert rows >= 1 and -(-tr // rows) <= 8
    assert config.room == MEVP_SINGLE_ROOM[shape]
    for metric, weighted, n_consts in ((False, False, 7), (True, False, 12), (False, True, 8), (True, True, 13)):
        resident = config.resident(metric, weighted)
        partial = max(c for c in ms.PARTIAL_COUNTS if c <= config.room)
        assert len(resident) == (n_consts if config.room >= n_consts else partial)
        names = const_names(weighted, not metric)
        assert len(names) == n_consts
        assert list(resident) == [n for n in ms.RESIDENT_ORDER if n in names][:len(resident)]
        assert config.shared_bytes(metric, weighted) == (5 + len(resident)) * (tr + 2) * (tc + 2) * 4 <= limit
        assert len(resident) == n_consts or ms.shared_bytes(config.tile, len(resident) + 1) > limit
    if shape == (256, 256):
        assert config.tile == (16, 32) and config.n_tiles == 128 and config.threads == 512
    if shape == (1024, 1024):
        assert config.tile == (64, 128) and config.threads == 1024 and config.resident(True) == ("half_dx",)


def test_mevp_single_refuses_a_grid_it_cannot_hold():
    """A forced tile that outnumbers the SMs, and a grid above the largest
    square mevp_single holds on 132 SMs (1024^2: a tile of 8 rows a thread
    of 1024), raise before any launch, on the host; the grids the paths
    send it are held."""
    with pytest.raises(ValueError, match="resident"):
        ms.tiling(40, 72, 132, (4, 4))
    with pytest.raises(ValueError, match="threads"):
        ms.tiling(1024, 1024, 132, (16, 2048))
    n = ms.largest_square(132)
    assert n == 1024
    with pytest.raises(ValueError, match="shared memory"):
        ms.tiling(n + 1, n + 1, 132)
    assert all(ms.holds(*shape, 132) for shape in ((128, 128), (512, 512), (1000, 968), (1024, 1024)))


def test_dg1_sample_cfl_reference_of_a_widened_block():
    """The plain version of dg1_sample_cfl's halo form (a rank's own
    elements inside its velocity widened by H) on a block widened by zeros
    equals the plain version on the block alone, whose +1 nodes are walls;
    and with nonzero ghosts it reads the ghost row and column."""
    rng = np.random.default_rng(3)
    model = CoupledModel(RectMesh(12, 20, 2000.0, 2000.0))
    u, v = (torch.tensor(rng.normal(0.0, 0.3, (12, 20)), dtype=torch.float32) for _ in range(2))
    halo = 4
    wide = lambda f: torch.nn.functional.pad(f, (halo, halo, halo, halo))
    plain = cc.dg1_sample_cfl_reference(model.transport, u, v)
    assert torch.equal(cc.dg1_sample_cfl_reference(model.transport, wide(u), wide(v), halo=halo), plain)
    ghosts = wide(u)
    ghosts[halo + 12, halo:halo + 21] = 50.0  # the block's +1 node row
    assert cc.dg1_sample_cfl_reference(model.transport, ghosts, wide(v), halo=halo)[0] > plain[0]


def test_rdma_band_launch_config_at_config5():
    """rdma_band's launch at config 5's 2048^2 rank blocks, h = 16: the x
    bands (48 x 2048) and the y bands (2080 x 48) each take more blocks a
    pair than the 132 SMs (64-66 before the cone's redesign), in clusters
    of at most 16 along the band, few enough a block (shared memory,
    threads) that they are all resident at once; each thread owns at most
    4 cells."""
    h, n = 16, 2048
    for axis, along in ((0, n), (1, n + 2 * h)):
        assert rdma.band_shape(axis, h, n, n, h)[1 - axis] == along
        config = rdma.launch_config(axis)
        config.check(axis, h, h)
        blocks = 2 * config.cluster * config.clusters(along, h)
        assert 132 <= blocks and config.cluster <= rdma.MAX_CLUSTER_BLOCKS
        per_sm = min(233472 // (config.shared_bytes(h, axis) + 1024), 2048 // config.threads)
        assert blocks <= 132 * per_sm  # one wave
        # The 256-thread launch bound asks for three blocks an SM: one wave too.
        assert rdma.launch_bound(config.threads) == 256 and blocks <= 132 * 3
        assert config.shared_bytes(h, axis) == 5 * (3 * h + axis) * (config.seg + 2) * 4
        assert 1 <= config.cells_per_thread(h) <= rdma.MAX_CELLS
        # The clusters' interiors tile the band and no cluster is idle.
        inner = config.cluster * config.seg - 2 * h
        assert (config.clusters(along, h) - 1) * inner < along <= config.clusters(along, h) * inner
    assert rdma.launch_config(0).clusters(2048, 16) == rdma.launch_config(1).clusters(2080, 16) == 10
    assert rdma.launch_bound(32) == rdma.launch_bound(256) == 256
    assert rdma.launch_bound(257) == rdma.launch_bound(1024) == 1024
    # The cone the kernel takes, built once per band shape.
    first = rdma._cone_array(0, h, h, n, n, h)
    assert rdma._cone_array(0, h, h, n, n, h) is first and list(first)[:8] == list(rdma.band_cone(0, h, h, n, n, h)[0])
    with pytest.raises(ValueError, match="launch configuration"):
        rdma.BandConfig(1, 16, 256).check(0, 16, 16)  # no interior left along the band
    with pytest.raises(ValueError, match="launch configuration"):
        rdma.BandConfig(8, 32, 32).check(1, 16, 16)  # fewer threads than the band is wide


def _dependency_cone(axis, h, n_sub, nx, ny, hx):
    """Per subcycle, (element mask, node mask) of the band cells that the
    patch depends on, by walking the stencil backwards from the patch."""
    rows, cols = rdma.band_shape(axis, h, nx, ny, hx)
    need_n = np.zeros((rows, cols), bool)
    if axis == 0:
        need_n[h:2 * h, :] = True
    else:
        need_n[hx:hx + nx, h:2 * h] = True
    need_e = np.zeros_like(need_n)
    cones = []
    for _ in range(n_sub):
        # The velocity phase at node (i, j) reads elements i-1..i, j-1..j
        # (its own c_w and inv_drag among them): element (i, j) is read by
        # nodes i..i+1, j..j+1; the stress phase reads its own stress.
        e = need_n.copy()
        e[:-1, :] |= need_n[1:, :]
        e[:, :-1] |= need_n[:, 1:]
        e[:-1, :-1] |= need_n[1:, 1:]
        need_e = e | need_e
        cones.append((need_e.copy(), need_n.copy()))
        # The stress phase at element (i, j) reads nodes i..i+1, j..j+1; the
        # velocity phase reads its node's own velocity.
        n_ = need_e.copy()
        n_[1:, :] |= need_e[:-1, :]
        n_[:, 1:] |= need_e[:, :-1]
        n_[1:, 1:] |= need_e[:-1, :-1]
        need_n = n_ | need_n
    return cones[::-1]


@pytest.mark.parametrize("h", [4, 8, 16])
@pytest.mark.parametrize("axis", [0, 1])
def test_rdma_band_cone_is_the_patch_dependency_cone(h, axis):
    """The cone that the host passes to rdma_band covers exactly the cells
    the patch depends on, subcycle by subcycle, for every n_sub <= h; its
    node count is what chip_smoke.rdma_band_work counts as the bound."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("chip_smoke", smoke)  # its dataclasses look their module up
    spec.loader.exec_module(smoke)
    nx, ny = 2 * h + 5, 2 * h + 3
    rows, cols = rdma.band_shape(axis, h, nx, ny, h)
    box = lambda r0, r1, c0, c1: np.pad(np.ones((r1 - r0, c1 - c0), bool), ((r0, rows - r1), (c0, cols - c1)))
    for n_sub in range(1, h + 1):
        cone = rdma.band_cone(axis, h, n_sub, nx, ny, h)
        assert len(cone) == n_sub
        for sub, (ranges, (need_e, need_n)) in enumerate(zip(cone, _dependency_cone(axis, h, n_sub, nx, ny, h))):
            assert np.array_equal(box(*ranges[:4]), need_e), (n_sub, sub)
            assert np.array_equal(box(*ranges[4:]), need_n), (n_sub, sub)
            # The kernel's region holds the band across: elements below its
            # last row or column, nodes above its first.
            e_hi, n_lo = (ranges[1], ranges[4]) if axis == 0 else (ranges[3], ranges[6])
            assert e_hi <= 3 * h - 1 and n_lo >= 1
        _, ops = smoke.rdma_band_work(axis, h, n_sub, nx, ny, h)
        nodes = sum((r1 - r0) * (c1 - c0) for r0, r1, c0, c1 in (c[4:] for c in cone))
        assert nodes == ops / (2 * (smoke.OPS["stress"] + smoke.OPS["velocity"]))


def test_build_compiles_each_source_at_once_then_links(tmp_path, monkeypatch):
    """build() starts one compiler per source together, links once, and
    keys the library on the sources and flags."""
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {calls}\n"
        "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && touch \"$2\"; shift; done\n"
        "echo 'ptxas info : Used 1 registers'\n"
    )
    nvcc.chmod(0o755)
    monkeypatch.setattr(cc, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cc, "BUILD_DIR", tmp_path / "build")
    path = cc.build()
    assert path.exists() and path == cc.library_path()
    lines = calls.read_text().splitlines()
    compiles = [line for line in lines if " -c " in f" {line} "]
    assert len(compiles) == len(REPLACED) and len(lines) == len(REPLACED) + 1
    assert all("--fmad=false" in line for line in compiles)
    objects = [arg for arg in lines[-1].split() if arg.endswith(".o")]
    assert "-shared" in lines[-1].split() and len(objects) == len(REPLACED)
    assert path.with_suffix(".log").read_text().count("Used 1 registers") == len(REPLACED) + 1
    # The objects are removed; the library and its log stay.
    assert {p.name for p in (tmp_path / "build").iterdir()} == {
        path.name, path.with_suffix(".log").name
    }
    assert cc.build() == path and len(calls.read_text().splitlines()) == len(lines)


def test_wrappers_refuse_devices_without_a_path():
    model, carry, consts, psi = _inputs()
    meta = tuple(c.to("meta") for c in carry)
    with pytest.raises(ValueError, match="not supported"):
        cc.mevp_stress(model.mevp, meta, consts)
    with pytest.raises(ValueError, match="not supported"):
        cc.dg1_sample_cfl(model.transport, meta[0], meta[1])


def test_checks_reject_what_the_kernels_do_not_take():
    plane = torch.zeros(4, 6)
    cc._check((4, 6), plane.device, ok=plane)
    with pytest.raises(TypeError, match="float32"):
        cc._check((4, 6), plane.device, x=plane.double())
    with pytest.raises(ValueError, match="shape"):
        cc._check((4, 5), plane.device, x=plane)
    with pytest.raises(ValueError, match="contiguous"):
        cc._check((6, 4), plane.device, x=plane.t())
    with pytest.raises(ValueError, match="expected"):
        cc._check((4, 6), torch.device("meta"), x=plane)
    model, carry, consts, _ = _inputs()
    with pytest.raises(NotImplementedError, match="consts"):
        cc._check_mevp(model.mevp, carry, {**consts, "a_node": carry[0]})


def test_chip_smoke_fails_without_a_gpu_and_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    done = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert done.returncode != 0 and '"ok"' not in done.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    done = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)},
    )
    assert done.returncode != 0 and '"ok"' not in done.stdout
