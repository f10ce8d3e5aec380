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
from nextsimdg_tpu_torch.dynamics.kernels import ho_tiled_cuda as ht
from nextsimdg_tpu_torch.dynamics.kernels import mevp_rdma_cuda as rdma
from nextsimdg_tpu_torch.dynamics.kernels import mevp_tiled_cuda as mt
from nextsimdg_tpu_torch.dynamics.kernels import transport_tiled_cuda as tt
from nextsimdg_tpu_torch.dynamics.mevp import DynamicsForcing, VelocityState
from nextsimdg_tpu_torch.dynamics import mevp_ho
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
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'triton', 'nextsimdg_tpu')]\n"
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


def _struct_floats(source: str, name: str) -> int:
    """Floats declared in a plain-float C struct, arrays included."""
    body = re.search(rf"struct {name} {{(.*?)\n}};", source, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    count = 0
    for decl in re.findall(r"float\s+([^;]+);", body):
        for item in decl.split(","):
            size = 1
            for dim in re.findall(r"\[(\w+)\]", item):
                size *= int({
                    "kDofs": 3, "kVol": 4, "kEdge": 2, "kHoCoeffs": 3, "kHoNodes": 9,
                    "kHoGauss": 4,
                }.get(dim, dim))
            count += size
    return count


def _struct_pointers(source: str, name: str) -> int:
    """Pointers declared in a plain struct of ``const float*``, arrays included."""
    body = re.search(rf"struct {name} {{(.*?)\n}};", source, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    count = 0
    for decl in re.findall(r"const float\*\s*([^;]+);", body):
        for item in decl.split(","):
            size = 1
            for dim in re.findall(r"\[(\w+)\]", item):
                size *= int({"kHoPlanes": 4, "kVol": 4, "kEdge": 2}.get(dim, dim))
            count += size
    return count


def test_host_packing_matches_the_c_structs():
    model = CoupledModel(RectMesh(8, 8, 2000.0, 2000.0))
    mevp_src = (cc.CSRC / "mevp_body.cuh").read_text()
    transport_src = (cc.CSRC / "dg1_body.cuh").read_text()
    ho_src = (cc.CSRC / "ho_body.cuh").read_text()
    assert len(cc._mevp_scalars(model.mevp, 600.0)) == _struct_floats(mevp_src, "MevpScalars")
    assert len(cc._dg1_tables(model.transport)) == _struct_floats(transport_src, "Dg1Tables")
    ho = MEVPSolverHO(model.mesh)
    assert len(cc._ho_scalars(ho, 600.0)) == _struct_floats(ho_src, "HoScalars")
    assert len(cc._ho_tables(ho)) == _struct_floats(ho_src, "HoTables")
    assert _struct_pointers(ho_src, "HoConsts") == len(mevp_ho.HO_CONSTS) == 29
    qv_src = (cc.CSRC / "transport_tiled.cu").read_text()
    assert _struct_pointers(qv_src, "Dg1QvPlanes") == sum(tt._QV_PLANES.values()) == 12


REPLACED = {
    "mevp.cu": "coupled_pallas.py::fused_dynamics_pallas",
    "transport.cu": "coupled_pallas.py::fused_dynamics_pallas",
    "mevp_tiled.cu": "mevp_tiled.py::mevp_subcycles_tiled",
    "transport_tiled.cu": "transport_tiled.py::transport_substeps_tiled",
    "mevp_single.cu": "mevp_pallas.py::mevp_subcycles_pallas",
    "ho_single.cu": "mevp_ho_pallas.py::ho_subcycles_pallas",
    "ho_tiled.cu": "mevp_ho_tiled.py::ho_subcycles_tiled",
    "mevp_rdma.cu": "mevp_rdma.py::mevp_round_rdma",
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
    assert src.c_args(need_gx=False, need_gy=False)[0] is ptrs and list(dims) == [nx, ny, h, h, h]
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
    for k in range(1, 10):
        for stages in (1, 2):
            halo = tt.halo_for(k, stages)
            assert (halo - 1) // stages == min(k, tt.K_MAX)
            assert tt.shared_bytes(tt.TILE, halo) <= limit
    assert tt.THREADS <= 768
    # ho_tiled: 17 window planes; a window of T + 2H <= 58 fits.
    assert ht.shared_bytes() <= limit and ht.THREADS <= 512
    assert ht.shared_bytes(26, 16) <= limit < ht.shared_bytes(27, 16)
    for tile, halo in ((32, 8), (48, 4), (40, 8), (24, 12)):
        assert ht.shared_bytes(tile, halo) <= limit


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
