"""Roofline accounting for the port's mEVP subcycle kernels on a CUDA card.

The twin of ``benchmarks/roofline.py``, function by function. The ceilings
are measured on the card that runs the kernels:

* float32 issue ceilings: a dependent chain held in registers, the
  ``chain`` kernel (``csrc/roofline.cu``, the counterpart of the TPU kernel
  ``measure_vpu_peak``), in its ``fma`` form (one fused multiply-add per
  link, three register operands), its ``fma_imm`` form (the addend an
  immediate: the FFMA issue ceiling) and its ``mul_add`` form (a separate
  multiply and add, as every port kernel issues them under
  ``--fmad=false``);
* HBM ceiling: a streaming in-place add over a 256 MiB tensor;
* op weights: the cost of a divide, a square root and a neighbour read
  through shared memory, in census ops, from the same chain;

and the work per element and subcycle is censused from the port's plain
subcycle bodies (``MEVPSolver.subcycle_body``, ``MEVPSolverHO.subcycle_body``),
classed as the JAX package classes its jaxpr primitives. Bytes per element
and subcycle come from the port's own tile configurations. The data
sheet's peaks stay the yardstick of ``chip_smoke.py``'s ``bound_ms``; the
measured ones give its ``measured_bound_ms`` beside it.

Usage (from the repository root)::

    python -m nextsimdg_tpu_torch.benchmarks.roofline [--kernels] [--pack-ab] [--cpu]

It prints one JSON object. ``--kernels`` adds the achieved time per element
and subcycle of ``mevp_single``, ``mevp_tiled`` and ``ho_tiled``;
``--pack-ab`` the shift-packing comparison. ``--cpu`` prints the census
and the bytes only; without it a machine with no card exits non-zero.
"""

from __future__ import annotations

import json
import math
import sys
from collections import Counter

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..dynamics.kernels import coupled_cuda as cc
from ..dynamics.stencil import shift_m
from .common import best_ms, card, require_cuda

KERNEL = "chain"
#: The chain's links, in csrc/roofline.cu's ChainLink order.
LINKS = ("fma", "mul_add", "div", "sqrt", "shift0", "shift1", "fma_imm")
#: The fma_imm link's addend, csrc/roofline.cu's kChainImm (1e-6 in float32).
CHAIN_IMM = float(np.float32(1e-6))
UNROLLS = (16, 64)
#: One block's tile (rows, columns) of csrc/roofline.cu: the shift links
#: read their neighbour within it and a zero at its first row or column.
TILE = (32, 32)
#: measure_vpu_peak's plane and calls: (unroll, iterations), the TPU
#: kernel's 16 x 100,000 and its XLA variant's 64 x 40,000.
PEAK_N = 512
PEAK_CALLS = ((16, 100_000), (64, 40_000))

# The census classes: aten op names, mapped onto the JAX package's jaxpr
# primitive sets (CHEAP, COSTLY, SHIFT, IGNORE of benchmarks/roofline.py).
CHEAP = {
    "add", "sub", "rsub", "mul", "neg", "where", "maximum", "minimum", "abs", "sign",
    "ge", "gt", "le", "lt", "eq", "ne", "logical_and", "logical_or", "logical_not",
    "logical_xor",
}
#: aten name -> the JAX primitive it counts as (1 / x is a divide there).
COSTLY = {
    "div": "div", "reciprocal": "div", "sqrt": "sqrt", "rsqrt": "rsqrt", "exp": "exp",
    "log": "log", "pow": "pow",
}
SHIFT = {"cat", "stack"}  # JAX lowers jnp.stack to a concatenate too
IGNORE = {
    "slice", "select", "new_zeros", "unsqueeze", "squeeze", "view", "reshape", "expand",
    "clone", "copy", "alias", "detach", "_to_copy", "lift_fresh", "t", "permute",
    "zeros_like", "full_like", "empty_like", "zeros", "full", "empty", "ones_like",
}


# -- the chain kernel (K8's counterpart) and its plain version -----------------
def _tile_shift(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``shift_m(x, axis, periodic=False)`` within each TILE of the plane,
    through a reshape: the -1 neighbour, zero at every tile's first row
    (axis 0) or column (axis 1). A ragged edge is padded, then cut off."""
    nx, ny = x.shape
    rows, cols = TILE
    padded = torch.nn.functional.pad(x, (0, -ny % cols, 0, -nx % rows))
    px, py = padded.shape
    tiles = padded.reshape(px // rows, rows, py // cols, cols)
    shifted = shift_m(tiles, 1 if axis == 0 else 3, periodic=False)
    return shifted.reshape(px, py)[:nx, :ny]


_PLAIN_LINKS = {
    # a * x + b rounds twice in PyTorch; the kernel's fma form rounds once.
    "fma": lambda x, a, b: a * x + b,
    "mul_add": lambda x, a, b: a * x + b,
    "div": lambda x, a, b: b / (x + a),
    "sqrt": lambda x, a, b: torch.sqrt(x + a),
    "shift0": lambda x, a, b: a * _tile_shift(x, 0) + b,
    "shift1": lambda x, a, b: a * _tile_shift(x, 1) + b,
    "fma_imm": lambda x, a, b: a * x + CHAIN_IMM,
}


def chain_reference(a: torch.Tensor, b: torch.Tensor, link: str, iters: int, unroll: int = 16):
    """The chain in plain PyTorch: from x = b, ``iters x unroll`` links of
    ``link`` (see ``csrc/roofline.cu``), one tensor operation at a time."""
    step = _PLAIN_LINKS[link]
    x = b.clone()
    for _ in range(iters * unroll):
        x = step(x, a, b)
    return x


def chain(a: torch.Tensor, b: torch.Tensor, link: str, iters: int, unroll: int = 16):
    """x after ``iters x unroll`` links of ``link`` from x = b, per element
    of the (nx, ny) planes ``a`` and ``b``.

    CPU tensors run ``chain_reference``; CUDA tensors (float32, contiguous,
    2-D) launch the ``chain`` kernel on the current stream. Raises for
    anything else.
    """
    if cc._on_cpu(a):
        return chain_reference(a, b, link, iters, unroll)
    if link not in LINKS or unroll not in UNROLLS or iters < 0:
        raise ValueError(
            f"chain takes a link of {LINKS}, an unroll of {UNROLLS} and iters >= 0; "
            f"got {link!r}, {unroll}, {iters}"
        )
    if a.dim() != 2:
        raise ValueError(f"chain takes (nx, ny) planes, got shape {tuple(a.shape)}")
    cc._check(a.shape, a.device, a=a, b=b)
    out = torch.empty_like(a)
    nx, ny = a.shape
    cc._launch(
        KERNEL, a.data_ptr(), b.data_ptr(), out.data_ptr(), nx, ny, LINKS.index(link), unroll,
        iters, a.device.index, cc._stream(a.device),
    )
    return out


# -- the op census ---------------------------------------------------------------
class _Census(TorchDispatchMode):
    """Counts the aten ops that run under it, per element of their outputs."""

    def __init__(self):
        super().__init__()
        self.counts = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__.rstrip("_")
        outputs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        size = sum(t.numel() for t in outputs)
        if name == "pow" and isinstance(args[1], int):
            name = "mul"  # x ** k lowers to multiplies, JAX's integer_pow
        if name in CHEAP:
            self.counts["cheap"] += size
        elif name in COSTLY:
            self.counts["costly"] += size
            self.counts[f"costly:{COSTLY[name]}"] += size
        elif name in SHIFT:
            # Which plane axis the join crosses: the last dim of the output
            # is axis 1 (the contiguous one), any other axis 0.
            ndim = outputs[0].dim()
            dim = (args[1] if len(args) > 1 else kwargs.get("dim", 0)) % ndim
            self.counts["shift"] += size
            self.counts[f"shift:{'axis1' if dim == ndim - 1 else 'axis0'}"] += size
        elif name not in IGNORE:
            self.counts[f"other:{name}"] += size
        return out


def _census(fn, n_elements: int) -> dict:
    """Counts of the aten ops of ``fn()`` per element, classed as the JAX
    package's jaxpr census classes its primitives."""
    with torch.no_grad(), _Census() as census:
        fn()
    return {k: v / n_elements for k, v in census.counts.items()}


def census_cg1(n: int = 256) -> dict:
    """Work per element of one CG1 ``MEVPSolver.subcycle_body`` at n^2,
    float32 on the CPU (no kernel runs, no autograd op is counted)."""
    from ..dynamics.mesh import RectMesh
    from ..dynamics.mevp import DynamicsForcing, MEVPParams, MEVPSolver, VelocityState

    solver = MEVPSolver(RectMesh(n, n, dx=4e3, dy=4e3), MEVPParams())
    kw = {"device": "cpu", "dtype": torch.float32}
    full = lambda v: torch.full((n, n), v, **kw)
    state = VelocityState.zeros(n, n, **kw)
    df = DynamicsForcing(u_atm=full(6.0), v_atm=full(2.0), u_ocean=full(0.02), v_ocean=full(0.0))
    with torch.no_grad():
        consts = solver.step_consts(state, full(1.2), full(0.95), df, solver.boundary_mask(**kw), 600.0)
    carry = (state.u, state.v, state.s11, state.s22, state.s12)
    return _census(lambda: solver.subcycle_body(carry, consts, 600.0), n * n)


def census_ho(n: int = 128) -> dict:
    """Work per element of one HO ``MEVPSolverHO.subcycle_body`` at n^2.

    Of its ~111 shifts per element, 87 are ``torch.stack``s of gathered or
    scattered planes, not neighbour reads: the JAX package's census counts
    its stacks (concatenates) the same way, and the two are kept equal."""
    from ..dynamics.mesh import RectMesh
    from ..dynamics.mevp import MEVPParams
    from ..dynamics.mevp_ho import HODynamicsForcing, HOField, HOVelocityState, MEVPSolverHO

    solver = MEVPSolverHO(RectMesh(n, n, dx=4e3, dy=4e3), MEVPParams())
    kw = {"device": "cpu", "dtype": torch.float32}
    full = lambda v: torch.full((n, n), v, **kw)
    const = lambda v: HOField(v=full(v), b=full(v), l=full(v), c=full(v))
    state = HOVelocityState.zeros(n, n, **kw)
    df = HODynamicsForcing(u_atm=const(6.0), v_atm=const(2.0), u_ocean=const(0.02), v_ocean=const(0.0))
    with torch.no_grad():
        consts = solver.step_consts(state, full(1.2), full(0.95), df, solver.boundary_mask(**kw), 600.0)
    carry = (state.u, state.v, state.s11, state.s22, state.s12)
    return _census(lambda: solver.subcycle_body(carry, consts, 600.0), n * n)


# -- the ceilings on the card -----------------------------------------------------
def _planes(device, n: int = PEAK_N):
    """The TPU probe's constant planes a = 0.9999, b = 1e-6: the chains
    converge to x = b / (1 - a) = 0.01 and the like, far from denormals."""
    full = lambda v: torch.full((n, n), v, device=device, dtype=torch.float32)
    return full(0.9999), full(1e-6)


def measure_vpu_peak(device="cuda") -> dict:
    """Attainable float32 op/s: the ``chain`` kernel, 2 ops per link.

    The ``fma`` form at 512^2, unroll 16 and 100,000 iterations (the TPU
    kernel's call), and at unroll 64 and 40,000 iterations (the port's twin
    of the XLA variant); best of 5 after a warm-up each, on CUDA events;
    the larger rate is the fused ceiling of the TPU kernel's function. The
    same with the ``fma_imm`` form (its addend an immediate: one register
    read fewer per FFMA) gives the card's FFMA issue ceiling, and with the
    ``mul_add`` form the port's own (its kernels issue a separate multiply
    and add). Returns the three rates and each call's best ms.
    """
    device = require_cuda(device)
    a, b = _planes(device)
    result, ms = {}, {}
    for link in ("fma", "fma_imm", "mul_add"):
        rates = []
        for unroll, iters in PEAK_CALLS:
            ms[f"{link}/{unroll}"] = best_ms(lambda: chain(a, b, link, iters, unroll))
            rates.append(2.0 * unroll * iters * PEAK_N * PEAK_N / (ms[f"{link}/{unroll}"] * 1e-3))
        result[f"fp32_{link}_chain_ops_per_s"] = max(rates)
    result["ms"] = ms
    return result


def _seconds_per_link(link: str, a, b, target_ms: float = 50.0, unroll: int = 16) -> float:
    """Seconds per link and element of the chain, from calls of at least
    ``target_ms`` (the iteration count scaled from a short probe)."""
    probe = 1000
    ms = best_ms(lambda: chain(a, b, link, probe, unroll), reps=1)
    iters = max(probe, math.ceil(probe * 1.2 * target_ms / ms))
    ms = best_ms(lambda: chain(a, b, link, iters, unroll))
    return ms * 1e-3 / (iters * unroll * a.numel())


def measure_op_weights(device="cuda") -> dict:
    """The cost of a divide, a square root and a neighbour read, in census
    ops: the chain time minus its baseline links, in single-op units.

    The unit is one float32 instruction as the port's kernels issue it,
    t_op = (mul_add link) / 2: every port kernel is built with
    ``--fmad=false``, so a census op (an add, a multiply) is one
    instruction. Chains at 512^2, unroll 16, each call at least 50 ms:

    * ``fma``      x = fma(a, x, b)           (the fused ceiling, reported)
    * ``mul_add``  x = a*x + b                (2 ops: the baseline)
    * ``shift0``   x = a*nb0(x) + b           (2 ops + a row neighbour read)
    * ``shift1``   x = a*nb1(x) + b           (2 ops + a column neighbour read)
    * ``div``      x = b / (x + a)            (1 op + a divide)
    * ``sqrt``     x = sqrt(x + a)            (1 op + a square root)

    The shift links read their neighbour through shared memory with a
    block barrier per link, as the tiled kernels' windows do.
    """
    device = require_cuda(device)
    a, b = _planes(device)
    links = ("fma", "mul_add", "shift0", "shift1", "div", "sqrt")
    t = {link: _seconds_per_link(link, a, b) for link in links}
    t_op = t["mul_add"] / 2.0
    g3 = lambda v: float(f"{v:.3g}")
    return {
        "fma_chain_ops_per_s": float(f"{2.0 / t['fma']:.4g}"),
        "mul_add_chain_ops_per_s": float(f"{2.0 / t['mul_add']:.4g}"),
        "shift_axis0_ops": g3((t["shift0"] - t["mul_add"]) / t_op),
        "shift_axis1_ops": g3((t["shift1"] - t["mul_add"]) / t_op),
        "div_ops": g3((t["div"] - t_op) / t_op),
        "sqrt_ops": g3((t["sqrt"] - t_op) / t_op),
    }


def measure_shift_packing(device="cuda") -> dict:
    """Is the cost of a shift in eager PyTorch per launch or per element?
    (``--pack-ab``)

    Two (n, n) planes shifted the same way per link (``stencil.shift_m``,
    then a*x + b), against one shift of the stacked (2, n, n) pair. Each
    op is its own launch here, so equal times per link say the cost is per
    element, and a packed time near half says it is per launch: the
    host-issue question of the port's glue (ROADMAP L3, L5).
    """
    device = require_cuda(device)
    n, unroll, iters = PEAK_N, 16, 64
    a = torch.full((n, n), 0.9999, device=device)
    a2 = torch.full((2, n, n), 0.9999, device=device)

    def two_planes(x):
        u, v = x
        return (a * shift_m(u, 0, periodic=False) + 1e-6, a * shift_m(v, 0, periodic=False) + 1e-6)

    def packed(x):
        return a2 * shift_m(x, 1, periodic=False) + 1e-6

    def seconds_per_link(link, x0):
        def run():
            x = x0
            for _ in range(iters * unroll):
                x = link(x)
            return x

        return best_ms(run) * 1e-3 / (iters * unroll)

    t_two = seconds_per_link(two_planes, (torch.ones(n, n, device=device),) * 2)
    t_pack = seconds_per_link(packed, torch.ones(2, n, n, device=device))
    return {
        "two_plane_shifts_ns_per_link": float(f"{t_two * 1e9:.4g}"),
        "packed_stack_shift_ns_per_link": float(f"{t_pack * 1e9:.4g}"),
        "packed_over_two": float(f"{t_pack / t_two:.3g}"),
    }


def measure_hbm_peak(device="cuda") -> float:
    """Attainable HBM bandwidth (bytes/s): ``x.add_(1.0)`` 64 times on an
    8192^2 float32 tensor (256 MiB, five times the L2), one read and one
    write of each element per pass; best of 5 after a warm-up."""
    device = require_cuda(device)
    n, reps = 8192, 64
    x = torch.ones((n, n), device=device, dtype=torch.float32)

    def run():
        for _ in range(reps):
            x.add_(1.0)

    return 2.0 * reps * n * n * 4 / (best_ms(run) * 1e-3)


def kernel_bytes_per_element_subcycle() -> dict:
    """Bytes per element and subcycle of each kernel at its path's size,
    from the port's own tile configurations (float32, 4 bytes a value).

    * ``mevp_single`` at 256^2 (K4's counterpart, the JAX ``fused_cg1_256``
      key): the grid-wide passes of each subcycle read and write the planes
      through L2, not once per call: the stress pass reads 10 planes and
      writes 5, the velocity pass reads 12 and writes 2 (csrc/mevp.cu),
      (10 + 5 + 12 + 2) x 4 = 116 bytes.
    * ``mevp_tiled`` at 2048^2 (T and H of ``mevp_tiled_cuda.launch_config``):
      a launch of H subcycles reads the 5 state and 7 const planes over the
      (T + 2H)^2 window of each T^2 tile and writes the 5 state planes of the
      tile: ((5 + 7) (T + 2H)^2 / T^2 + 5) x 4 / H.
    * ``ho_tiled`` at 1024^2 (``ho_tiled_cuda.launch_config``: one window of
      (wa, wb) cells a cluster, its (ta, tb) interior written back, H
      subcycles a launch): the 17 state planes over the window in and over
      the interior out once per launch, and the 29 const planes read from
      L2 every subcycle (the interior's; the ring work reads more):
      (17 wa wb / (ta tb) + 17) x 4 / H + 29 x 4.
    """
    from ..dynamics.kernels import ho_tiled_cuda, mevp_tiled_cuda

    out = {"fused_cg1_256": (10 + 5 + 12 + 2) * 4.0}
    T_cg1, H_cg1, _ = mevp_tiled_cuda.launch_config(2048, 2048)
    out["tiled_cg1_2048"] = ((5 + 7) * (T_cg1 + 2 * H_cg1) ** 2 / T_cg1**2 + 5) * 4 / H_cg1
    ho = ho_tiled_cuda.launch_config(1024, 1024)
    (wa, wb), (ta, tb) = ho.window, ho.interior
    out["tiled_ho_1024"] = (17 * wa * wb / (ta * tb) + 17) * 4 / ho.halo + 29 * 4
    out["_configs"] = {
        "fused_cg1_256": "mevp_single, all subcycles in one launch",
        "tiled_cg1_2048": {"tile": T_cg1, "halo": H_cg1},
        "tiled_ho_1024": {"cluster": [ho.rows, ho.cols], "sub": ho.sub, "halo": ho.halo},
    }
    return out


def measure_kernels(device="cuda") -> dict:
    """Achieved picoseconds per element and subcycle of the three mEVP
    kernels: ``step_consts`` and 100 subcycles per step, back to back over a
    chunk of steps, best of 3 (CUDA events). Each key's kernel is read from
    ``coupled_cuda.launches`` of one step."""
    from ..dynamics.kernels import ho_tiled_cuda, mevp_single_cuda, mevp_tiled_cuda
    from ..dynamics.mesh import RectMesh
    from ..dynamics.mevp import DynamicsForcing, MEVPParams, MEVPSolver, VelocityState
    from ..dynamics.mevp_ho import HODynamicsForcing, HOField, HOVelocityState, MEVPSolverHO

    device = require_cuda(device)
    kw = {"device": device, "dtype": torch.float32}
    results, kernels = {}, {}

    def case(key, n, solver, state, df, run, chunk):
        h, a = (torch.full((n, n), v, **kw) for v in (1.2, 0.95))
        mask = solver.boundary_mask(**kw)
        carry = (state.u, state.v, state.s11, state.s22, state.s12)

        def step():
            consts = solver.step_consts(state, h, a, df, mask, 600.0)
            return run(solver, carry, consts, 600.0, 100)

        cc.reset_launches()
        step()
        torch.cuda.synchronize()
        kernels[key] = sorted(name for name, count in cc.launches.items() if count)

        def chunked():
            for _ in range(chunk):
                step()

        ms = best_ms(chunked, reps=3) / chunk
        results[f"{key}_ps_per_el_sub"] = round(ms * 1e9 / 100.0 / (n * n), 2)

    for key, n, run, chunk in (
        ("fused_cg1_256", 256, mevp_single_cuda.mevp_subcycles_single, 64),
        ("tiled_cg1_2048", 2048, mevp_tiled_cuda.mevp_subcycles_tiled, 8),
    ):
        full = lambda v, n=n: torch.full((n, n), v, **kw)
        df = DynamicsForcing(u_atm=full(6.0), v_atm=full(2.0), u_ocean=full(0.02), v_ocean=full(0.0))
        solver = MEVPSolver(RectMesh(n, n, dx=4e3, dy=4e3), MEVPParams())
        case(key, n, solver, VelocityState.zeros(n, n, **kw), df, run, chunk)

    n = 1024
    full = lambda v: torch.full((n, n), v, **kw)
    const = lambda v: HOField(v=full(v), b=full(v), l=full(v), c=full(v))
    df = HODynamicsForcing(u_atm=const(6.0), v_atm=const(2.0), u_ocean=const(0.02), v_ocean=const(0.0))
    solver = MEVPSolverHO(RectMesh(n, n, dx=4e3, dy=4e3), MEVPParams())
    case("tiled_ho_1024", n, solver, HOVelocityState.zeros(n, n, **kw), df,
         ho_tiled_cuda.ho_subcycles_tiled, 8)
    results["kernels"] = kernels
    return results


def attainable_ps(census: dict, weights: dict) -> dict:
    """Lower-bound time per element and subcycle from MEASURED weights.

    ``census`` as ``census_cg1``/``census_ho`` give it, ``weights`` as
    ``measure_op_weights``: each cheap op costs one op, each costly one its
    weight, each shift its axis's weight, at the port's op rate (the
    ``mul_add`` chain's). Only div and sqrt/rsqrt have measured weights;
    any other costly op (exp, log, pow) is charged at the div weight AND
    listed in ``approximated_at_div_weight``.
    """
    equiv = census.get("cheap", 0.0)
    approximated = []
    for prim, count in census.items():
        if not prim.startswith("costly:"):
            continue
        name = prim.split(":", 1)[1]
        if name in ("sqrt", "rsqrt"):
            weight = weights["sqrt_ops"]
        else:
            weight = weights["div_ops"]
            if name != "div":
                approximated.append(name)
        equiv += count * weight
    equiv += census.get("shift:axis0", 0.0) * weights["shift_axis0_ops"]
    equiv += census.get("shift:axis1", 0.0) * weights["shift_axis1_ops"]
    t_op_ps = 1e12 / weights["mul_add_chain_ops_per_s"]
    out = {"equiv_ops": round(equiv, 1), "attainable_ps_per_el_sub": round(equiv * t_op_ps, 1)}
    if approximated:
        out["approximated_at_div_weight"] = sorted(approximated)
    return out


FLAGS = ("--kernels", "--pack-ab", "--cpu")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    unknown = [arg for arg in argv if arg not in FLAGS]
    if unknown:
        print(f"roofline: unknown arguments {unknown}; takes {FLAGS}", file=sys.stderr)
        return 2
    cg1, ho = census_cg1(), census_ho()
    result = {
        "census_cg1_per_element_subcycle": {k: round(v, 2) for k, v in sorted(cg1.items())},
        "census_ho_per_element_subcycle": {k: round(v, 2) for k, v in sorted(ho.items())},
        "bytes_per_element_subcycle": {
            k: (round(v, 2) if isinstance(v, float) else v)
            for k, v in kernel_bytes_per_element_subcycle().items()
        },
    }
    if "--cpu" not in argv:
        if not torch.cuda.is_available():
            print(
                "roofline: no CUDA device; the ceilings are measured only on a GPU "
                "(--cpu prints the census and bytes)", file=sys.stderr,
            )
            return 1
        device = torch.device("cuda", 0)
        result["device"] = card(device)
        peaks = measure_vpu_peak(device)
        for link in ("fma", "fma_imm", "mul_add"):
            key = f"fp32_{link}_chain_ops_per_s"
            result[key] = float(f"{peaks[key]:.4g}")
        result["chain_ms"] = {k: round(v, 4) for k, v in peaks["ms"].items()}
        result["hbm_bytes_per_s"] = float(f"{measure_hbm_peak(device):.4g}")
        weights = measure_op_weights(device)
        result["measured_op_weights"] = weights
        result["attainable_from_measured_weights"] = {
            "fused_cg1": attainable_ps(cg1, weights),
            "tiled_ho": attainable_ps(ho, weights),
        }
        if "--pack-ab" in argv:
            result["shift_packing_ab"] = measure_shift_packing(device)
        if "--kernels" in argv:
            result["achieved"] = measure_kernels(device)
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
