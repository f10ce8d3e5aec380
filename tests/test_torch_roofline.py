"""The port's roofline twin (``nextsimdg_tpu_torch.benchmarks.roofline``)
against the JAX package's ``benchmarks/roofline.py``: the op census of the
subcycle bodies, the chain's plain version, the bytes per element and
subcycle, the attainable arithmetic, and the command line's refusal to
measure without a card. The chain kernel itself runs only on a card
(``tests/test_torch_kernels.py``)."""

import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the JAX census below runs on the CPU)
import numpy as np
import pytest
import torch

from nextsimdg_tpu_torch.benchmarks import roofline
from nextsimdg_tpu_torch.dynamics.kernels import coupled_cuda as cc
from nextsimdg_tpu_torch.dynamics.kernels import ho_tiled_cuda, mevp_tiled_cuda
from nextsimdg_tpu_torch.dynamics.stencil import shift_m

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _jax_roofline():
    """The JAX package's benchmarks/roofline.py, imported by path."""
    spec = importlib.util.spec_from_file_location(
        "jax_benchmarks_roofline", REPO / "benchmarks" / "roofline.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("body, n", [("cg1", 32), ("ho", 16)])
def test_census_matches_the_jax_census(body, n):
    """Costly ops per name equal (a reciprocal is a divide), shifts in all
    and per axis equal, cheap ops within 1% (the port's bodies spell a few
    constants as one more multiply: 114 / 113 and 857 / 853)."""
    port = getattr(roofline, f"census_{body}")(n)
    ref = getattr(_jax_roofline(), f"census_{body}")(n)
    assert not [k for k in port if k.startswith("other:")]
    costly = lambda c: {k: v for k, v in c.items() if k.startswith("costly")}
    assert costly(port) == costly(ref)
    for key in ("shift", "shift:axis0", "shift:axis1"):
        assert port.get(key, 0.0) == ref.get(key, 0.0)
    assert abs(port["cheap"] - ref["cheap"]) <= 0.01 * ref["cheap"]


def _numpy_chain(a, b, link, links):
    """The chain in float64 numpy, with the tile-local neighbours written
    out: zero on each TILE's first row (shift0) or column (shift1)."""
    rows, cols = roofline.TILE
    x = b.copy()
    for _ in range(links):
        if link in ("fma", "mul_add"):
            x = a * x + b
        elif link == "fma_imm":
            x = a * x + roofline.CHAIN_IMM
        elif link == "div":
            x = b / (x + a)
        elif link == "sqrt":
            x = np.sqrt(x + a)
        else:
            nb = np.zeros_like(x)
            if link == "shift0":
                nb[1:] = x[:-1]
                nb[::rows] = 0.0
            else:
                nb[:, 1:] = x[:, :-1]
                nb[:, ::cols] = 0.0
            x = a * nb + b
    return x


@pytest.mark.parametrize("link", roofline.LINKS)
def test_chain_reference_matches_a_float64_numpy_chain(link):
    rng = np.random.default_rng(1)
    a, b = rng.uniform(0.5, 0.9999, (64, 48)), rng.uniform(-1e-3, 1e-3, (64, 48))
    got = roofline.chain_reference(torch.tensor(a), torch.tensor(b), link, 10, 16)
    ref = _numpy_chain(a, b, link, 160)
    assert float(np.abs(got.numpy() - ref).max()) <= 1e-12 * float(np.abs(ref).max())


@pytest.mark.parametrize("shape", [(64, 64), (70, 45)])
@pytest.mark.parametrize("axis", [0, 1])
def test_shift_links_apply_shift_m_to_each_tile(shape, axis):
    """The plain shift is stencil.shift_m applied to each tile on its own,
    the ragged edge tiles included."""
    x = torch.tensor(np.random.default_rng(2).normal(size=shape))
    rows, cols = roofline.TILE
    expected = torch.empty_like(x)
    for i in range(0, shape[0], rows):
        for j in range(0, shape[1], cols):
            tile = x[i:i + rows, j:j + cols]
            expected[i:i + rows, j:j + cols] = shift_m(tile, axis, periodic=False)
    assert torch.equal(roofline._tile_shift(x, axis), expected)


def test_chain_tile_and_links_match_the_source():
    source = (cc.CSRC / "roofline.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", source).group(1))
    assert roofline.TILE == (const("kChainThreadsY") * const("kPerThread"), const("kChainThreadsX"))
    enum = re.search(r"enum ChainLink \{(.*?)\};", source).group(1)
    names = [re.match(r"\s*k(\w+) = (\d+)", item).groups() for item in enum.split(",")]
    assert [int(v) for _, v in names] == list(range(len(roofline.LINKS)))
    assert [n.lower() for n, _ in names] == [link.replace("_", "") for link in roofline.LINKS]
    imm = re.search(r"constexpr float kChainImm = ([0-9.e+-]+)f;", source).group(1)
    assert roofline.CHAIN_IMM == float(np.float32(imm))


def test_chain_runs_the_plain_version_for_cpu_tensors():
    a, b = torch.full((8, 8), 0.9), torch.full((8, 8), 0.01)
    cc.reset_launches()
    for link in roofline.LINKS:
        assert torch.equal(roofline.chain(a, b, link, 2), roofline.chain_reference(a, b, link, 2))
    assert cc.launches["chain"] == 0
    with pytest.raises(ValueError, match="not supported"):
        roofline.chain(a.to("meta"), b.to("meta"), "fma", 1)


def test_kernel_bytes_follow_the_tile_constants():
    got = roofline.kernel_bytes_per_element_subcycle()
    T1, H1, _ = mevp_tiled_cuda.launch_config(2048, 2048)
    assert (T1, H1) == mevp_tiled_cuda.LARGE[:2]
    assert got["tiled_cg1_2048"] == pytest.approx((12 * ((T1 + 2 * H1) / T1) ** 2 + 5) * 4 / H1)
    T, H = ho_tiled_cuda.TILE, ho_tiled_cuda.HALO
    assert got["tiled_ho_1024"] == pytest.approx((17 * ((T + 2 * H) / T) ** 2 + 17) * 4 / H + 116)
    assert got["fused_cg1_256"] == 116.0
    assert got["_configs"]["tiled_cg1_2048"] == {"tile": T1, "halo": H1}
    assert got["_configs"]["tiled_ho_1024"] == {"tile": 32, "halo": 8}


def test_attainable_ps_by_hand():
    census = {
        "cheap": 100.0, "costly": 4.0, "costly:div": 2.0, "costly:sqrt": 1.0, "costly:exp": 1.0,
        "shift": 7.0, "shift:axis0": 3.0, "shift:axis1": 4.0,
    }
    weights = {
        "div_ops": 10.0, "sqrt_ops": 8.0, "shift_axis0_ops": 5.0, "shift_axis1_ops": 6.0,
        "mul_add_chain_ops_per_s": 1e13, "fma_chain_ops_per_s": 2e13,
    }
    # 100 + 2 x 10 + 8 + 10 (exp at the div weight) + 3 x 5 + 4 x 6 = 177
    # ops at 0.1 ps each.
    assert roofline.attainable_ps(census, weights) == {
        "equiv_ops": 177.0, "attainable_ps_per_el_sub": 17.7, "approximated_at_div_weight": ["exp"],
    }
    plain = {k: v for k, v in census.items() if k != "costly:exp"}
    assert "approximated_at_div_weight" not in roofline.attainable_ps(plain, weights)


@pytest.mark.parametrize("measure", [
    "measure_vpu_peak", "measure_op_weights", "measure_shift_packing", "measure_hbm_peak",
    "measure_kernels",
])
def test_measurements_refuse_the_cpu(measure):
    with pytest.raises(ValueError, match="CUDA card"):
        getattr(roofline, measure)("cpu")


def test_command_line_cpu_form_and_refusal():
    run = lambda *args: subprocess.run(
        [sys.executable, "-m", "nextsimdg_tpu_torch.benchmarks.roofline", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    done = run("--cpu")
    assert done.returncode == 0, done.stderr
    result = json.loads(done.stdout)
    assert "device" not in result and "fp32_fma_chain_ops_per_s" not in result
    assert result["census_cg1_per_element_subcycle"]["shift"] == 13.0
    assert result["bytes_per_element_subcycle"]["fused_cg1_256"] == 116.0
    assert run("--bogus").returncode != 0
    if not torch.cuda.is_available():
        done = run()
        assert done.returncode != 0 and not done.stdout
