"""k limited SSP-RK DG substeps (dG0, dG1, dG2) by ghost-zone tiles: the
``transport_tiled`` CUDA kernel.

Counterpart of ``nextsimdg_tpu/dynamics/kernels/transport_tiled.py``, whose
``transport_substeps_tiled`` runs up to ``K_CAP`` substeps per round on
halo'd blocks in VMEM, re-sampling the velocity per block. Here
(``csrc/transport_tiled.cu``) as many blocks as the card holds at once each
walk a fixed stride of tiles: for each tile the block has the
(tile + 2 halo)^2 window of u, v and the coefficients of a group of the
tracers in shared memory (all of them at dG0 and dG1, one at dG2:
``window_tracers``), samples the quadrature velocity there, runs up to
``K_CAP = (halo - 1) // stages`` substeps and writes back its tile, while
the window of its next tile is already being copied into a second buffer
(cp.async, 16 bytes a copy where ny is a multiple of 4, else 4); from
2048^2 two blocks an SM of one buffer each instead, and at the widest
halos one block of one buffer (``launch_config``). One launch per round,
``ceil(k / K_CAP)`` rounds, ping-ponging between two buffers. The host
knows k (``dynamics_phase`` reads it back once), so it sizes the halo to
k: ``stages * min(k, K_MAX) + 1``, and the launch to the halo.

Plain version: ``velocity_from_cg`` and k x ``DGTransport.step(limit=True)``
(``transport_substeps_tiled_reference``). The kernel runs the element body
of ``dg1_rk_stage``, so it also equals k substeps of that schedule bit for
bit. rk1, rk2 and rk3 run (rk3, dG2's default, with a second scratch
buffer: its third stage needs the step's base after the second has
written its output).
On a graded or spherical mesh it reads the transport's 5 metric planes
from global memory, beside the coastline face masks.

The HO path passes ``qv``, the quadrature velocity that
``ho_velocity_to_quad`` sampled from the CG2 velocity (at dG1 4 + 4 volume
and 2 + 2 face planes, at dG2 9 + 9 and 3 + 3), instead of (u, v): the kernel reads those planes
from global memory and skips its own sampling, as the JAX kernel takes them
as constant planes.

With the TVB limiter (``DGTransport(tvb_m=...)``, dG1 and dG2 on a uniform
mesh) the kernel's TVB form limits each stage in its window, which costs a
second ring a stage: ``K_CAP = (halo - 1) // (2 stages)``, and where the
widest halo would shrink the tile (dG2 with rk3) fewer substeps a launch
(``tvb_halo``). On a periodic axis a window beyond the domain is loaded from
the opposite side.

On a rank grid, ``transport_substeps_tiled_spmd`` (the counterpart of the
JAX ``transport_substeps_tiled_spmd``) runs the same kernel on each rank's
block widened by H ghost cells: one strip pair per axis (round the ring of
a periodic axis) buys (H - 1) // rings substeps, after which the interior
is kept. On a rank block of a graded or spherical mesh the widened block's
metric planes are passed to the kernel explicitly (``metric``: slices of
the global mesh's, zero beyond a closed wall), its own mesh being a
``MetricShim``. With TVB (uniform meshes) the global walls sit H rows
inside the widened block: the kernel's rank grid form takes their indices
(``walls``), the plain version the JAX package's wall-delta mask planes.
The HO solver's rank passes its quadrature samples (``qv``), whose four
families are widened by H once, as the JAX wrapper widens them: each
sample of a ghost element is the neighbour rank's own (zero beyond a
closed wall), so the widened samples equal the single domain's there; with
TVB the samples and the walls together (``csrc/transport_tiled_spmd_qv.cu``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, replace
from functools import lru_cache

import torch

from ..dgbasis import DG_DOFS
from ..stencil import halo_widen, is_global_edge
from ..transport import DGTransport, QuadVelocity
from . import coupled_cuda as cc

KERNEL = "transport_tiled"

#: Most substeps per launch; more run in further launches.
K_MAX = 3
#: Dynamic shared memory a block may take on the H100, and an SM holds
#: (1 KB of it reserved per block).
SHARED_LIMIT, SM_SHARED = 232448, 233472
#: Most threads a block (the stage body's ~80 registers at one block of
#: 768 an SM); at dG2 (6 dofs) the larger body takes at most 384.
MAX_THREADS = 768
MAX_THREADS_DG2 = 384
COPIES = ("auto", "vector", "scalar")


@dataclass(frozen=True)
class LaunchConfig:
    """A launch of transport_tiled: tiles of ``tile`` elements a side,
    ``threads`` a block, ``buffers`` input buffers a block (2: the next
    tile's window loads while this one computes), and ``persistent``: as
    many blocks as the card holds at once, each walking the tiles (else a
    block per tile, which loads, computes and stores one tile in turn: the
    sequence the persistent blocks were measured against)."""

    tile: int
    threads: int
    buffers: int
    persistent: bool = True


#: The shipped launches, chosen on the H100 by ``benchmarks.mevp_large
#: --tiles=transport_tiled`` (PERF.md), each where it fits at its full
#: tile (a narrower tile's ring costs more than the overlap gains): from
#: ``TWO_BLOCKS_MIN_ELEMENTS``, one buffer and windows small enough for two
#: blocks an SM, so that one block's barriers and load overlap the other's
#: compute; else persistent blocks of 768 threads, one an SM, with two
#: window buffers each; else (the widest halos) with one.
TWO_BLOCKS = LaunchConfig(30, 384, 1)
TWO_BLOCKS_MIN_ELEMENTS = 2048 * 2048
SHIPPED = LaunchConfig(32, 768, 2)
ONE_BUFFER = LaunchConfig(32, 768, 1)
#: A block per tile, one buffer: load, compute and store in turn (the
#: measurement's yardstick).
PER_TILE = LaunchConfig(32, 768, 1, persistent=False)

#: The RK stages of each scheme: (a, b) of lim(a base + b (psi + dt rhs)).
_STAGES = cc._RK_STAGES


def max_threads(n_dofs: int = 3) -> int:
    """Most threads a block at this many dofs (csrc/transport_tiled.cu)."""
    return MAX_THREADS_DG2 if n_dofs == DG_DOFS[2] else MAX_THREADS




#: The plain version: k x DGTransport.step(limit=True).
transport_substeps_tiled_reference = cc.transport_substeps_reference


def halo_for(k: int, stages: int) -> int:
    """The halo that fits min(k, K_MAX) substeps in one launch of
    ``stages`` rings a substep."""
    return stages * min(max(k, 1), K_MAX) + 1


def rings_per_substep(transport: DGTransport) -> int:
    """The window rings one substep spoils: one a stage, two with the TVB
    limiter (its neighbours' means after the stage), as the JAX kernel's
    ``_rings_per_substep``."""
    return len(_STAGES[transport.scheme]) * (2 if transport.limits_slopes else 1)


def tvb_halo(k: int, rings: int, qv: bool, n_tracers: int, elements: int, n_dofs: int,
             stages: int) -> int:
    """The TVB form's halo: for the most substeps up to min(k, K_MAX) whose
    launch still takes a shipped base's full tile (at dG2 with rk3, one),
    else for one substep."""
    for n in range(min(max(k, 1), K_MAX), 1, -1):
        halo = rings * n + 1
        group = window_tracers(halo, qv, n_tracers, elements, n_dofs, stages)
        if _full_launch(halo, qv, group, elements, n_dofs, stages) is not None:
            return halo
    return rings + 1


def _round_128(floats: int) -> int:
    return -(-floats // 32) * 32


def shared_bytes(
    tile: int, halo: int, n_tracers: int = 3, buffers: int = 2, qv: bool = False,
    n_dofs: int = 3, stages: int = 2,
) -> int:
    """Dynamic shared memory of one block (TransportLayout of
    csrc/transport_tiled.cu) whose window holds ``n_tracers`` tracers of
    ``n_dofs`` coefficients: ``buffers`` input buffers of the coefficient
    window and, but for the ``qv`` form, u and v, each part 128-byte
    aligned, with rows of the window's cells from up to 3 cells in (the
    16-byte boundary before its first column) padded to a multiple of 4;
    and a scratch buffer of the coefficients (two for 3 ``stages``)."""
    w = tile + 2 * halo
    plane = w * (-(-(w + 3) // 4) * 4)
    coeffs = _round_128(n_dofs * n_tracers * plane)
    buffer = coeffs + (0 if qv else 2 * _round_128(plane))
    return (buffers * buffer + (2 if stages == 3 else 1) * coeffs) * 4


@lru_cache(maxsize=64)
def fitted(
    base: LaunchConfig, halo: int, qv: bool = False, n_tracers: int = 3, n_dofs: int = 3,
    stages: int = 2,
):
    """``base`` with the widest tile up to its own whose block fits the
    shared memory at this halo (two blocks an SM where ``base`` has 384
    threads or fewer), and at most ``max_threads(n_dofs)`` threads, or
    None."""
    per_sm = 2 if base.threads <= MAX_THREADS // 2 else 1
    limit = min(SHARED_LIMIT, SM_SHARED // per_sm - 1024)
    threads = min(base.threads, max_threads(n_dofs))
    for tile in range(base.tile, 0, -1):
        if shared_bytes(tile, halo, n_tracers, base.buffers, qv, n_dofs, stages) <= limit:
            return replace(base, tile=tile, threads=threads)
    return None


def _full_launch(halo, qv, n_tracers, elements, n_dofs, stages):
    """The first shipped base that fits at its full tile, or None."""
    bases = ((TWO_BLOCKS,) if elements >= TWO_BLOCKS_MIN_ELEMENTS else ()) + (SHIPPED, ONE_BUFFER)
    for base in bases:
        config = fitted(base, halo, qv, n_tracers, n_dofs, stages)
        if config is not None and config.tile == base.tile:
            return config
    return None


@lru_cache(maxsize=64)
def launch_config(
    halo: int, qv: bool = False, n_tracers: int = 3, elements: int = 0, n_dofs: int = 3,
    stages: int = 2,
) -> LaunchConfig:
    """The shipped launch for a grid of ``elements`` at this halo, for
    windows of ``n_tracers`` tracers of ``n_dofs`` coefficients and a
    scheme of ``stages`` stages: the first base that fits at its full tile,
    else ``ONE_BUFFER`` at a narrower one."""
    config = _full_launch(halo, qv, n_tracers, elements, n_dofs, stages)
    if config is not None:
        return config
    config = fitted(ONE_BUFFER, halo, qv, n_tracers, n_dofs, stages)
    if config is None:
        raise ValueError(f"transport_tiled: no tile fits at halo {halo}")
    return config


def window_tracers(
    halo: int, qv: bool = False, n_tracers: int = 3, elements: int = 0, n_dofs: int = 3,
    stages: int = 2,
) -> int:
    """Tracers in a block's window: all of them where such a window fits at
    a shipped base's full tile (dG0, and dG1 but at rk3's widest halos),
    else one, whose window fits a wider tile (dG2: 6 planes a tracer), at
    the cost of sampling the velocity once a tracer."""
    full = _full_launch(halo, qv, n_tracers, elements, n_dofs, stages)
    return n_tracers if full is not None else 1


def copy_form(ny: int, *tensors) -> str:
    """"vector" (16-byte copies) where rows of ny cells keep every 4th cell
    16-byte aligned (ny a multiple of 4, aligned bases), else "scalar"."""
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors if t is not None)
    return "vector" if ny % 4 == 0 and aligned else "scalar"


@lru_cache(maxsize=256)
def blocks_per_sm(device, config: LaunchConfig, halo: int, qv: bool = False, metric: bool = False,
                  copy: str = "vector", n_tracers: int = 3, degree: int = 1,
                  stages: int = 2, tvb: int = 0) -> int:
    """Blocks of ``config`` that one SM of the card holds at once at this
    halo (windows of ``n_tracers`` tracers at ``degree``, a scheme of
    ``stages`` stages; ``tvb``: 0 without TVB, 1 its form, 2 its rank grid
    form): a persistent launch runs that many times the SMs (cached: the
    query costs the host more than a launch)."""
    device = torch.device(device)
    n_bytes = shared_bytes(
        config.tile, halo, n_tracers, config.buffers, qv, DG_DOFS[degree], stages
    )
    count = cc._library().nst_transport_tiled_blocks_per_sm(
        degree, int(metric), int(qv), int(copy == "vector"), int(tvb), config.threads, n_bytes,
        device.index or 0,
    )
    if count < 0:
        raise RuntimeError(f"transport_tiled: CUDA error {-count}")
    return count


def wall_masks(walls, shape, like):
    """The (fwd_x, bwd_x, fwd_y, bwd_y) wall-delta planes of
    ``DGTransport.limit_slopes`` from the wall indices of the kernel's rank
    grid form: 1.0 on the row (x) or column (y) given, 0 elsewhere and
    everywhere for -1."""
    planes = []
    for axis, index in zip((0, 0, 1, 1), walls):
        plane = like.new_zeros(shape)
        if index >= 0:
            plane.narrow(axis, index, 1).fill_(1.0)
        planes.append(plane)
    return tuple(planes)


def tile_walk(n_tiles: int, blocks: int) -> list:
    """The tiles each of ``blocks`` persistent blocks computes, in order:
    block b takes b, b + blocks, b + 2 blocks, ... (the kernel's walk)."""
    return [list(range(b, n_tiles, blocks)) for b in range(min(blocks, n_tiles))]


def transport_substeps_tiled(
    transport: DGTransport, tracers, u, v, dt_sub: float, k: int, face_masks=None,
    tile: int = None, halo: int = None, threads: int = None, qv: QuadVelocity = None,
    config: LaunchConfig = None, copy: str = "auto", compute: bool = True, group: int = None,
    metric: dict = None, walls=None,
):
    """The tracers after k limited substeps of ``dt_sub``.

    CPU tensors run the plain version; CUDA tensors (float32, contiguous)
    run ``transport_tiled``. The velocity is the CG1 (u, v), or the
    precomputed quadrature velocity ``qv`` (u and v are then not read).
    With the transport's TVB limiter (a uniform mesh) its TVB form, two
    window rings a stage (``rings_per_substep``, ``tvb_halo``); a periodic
    axis wraps the window loads.
    ``face_masks``: optional (face_x, face_y), ones without a coastline.
    The launch: ``config`` (default ``launch_config(halo)``), its tile and
    threads overridden by ``tile`` and ``threads``; ``copy``: how windows
    reach shared memory ("auto": ``copy_form``); ``group``: tracers in a
    block's window (default ``window_tracers``; a divisor of T).
    ``compute=False`` only loads and stores the windows (the phase
    measurement: the result is then the input). ``metric``: the metric
    planes (``DGTransport.metric_planes``' names) in place of the
    transport's, for a mesh whose metric is not its own (a widened rank
    block). ``walls``: with the TVB limiter, the rank grid form's global
    walls inside the domain, (fwd_x, bwd_x, fwd_y, bwd_y) row and column
    indices, -1 for none, in place of the domain's edges (a closed launch;
    the plain version takes them as ``wall_masks`` planes). The inputs are
    not modified.
    """
    nx, ny = transport.mesh.nx, transport.mesh.ny
    if walls is not None and not transport.limits_slopes:
        raise ValueError("TVB walls are given to a transport without the TVB limiter")
    if cc._on_cpu(tracers):
        masks = None if walls is None else wall_masks(walls, (nx, ny), tracers[0, 0])
        return transport_substeps_tiled_reference(
            transport, tracers, u, v, dt_sub, k, face_masks, qv=qv, metric=metric,
            wall_masks=masks,
        )
    if copy not in COPIES:
        raise ValueError(f"copy must be one of {COPIES}, not {copy!r}")
    stages = _STAGES[transport.scheme]
    n_stages = len(stages)
    # a[0..2], then b[0..2] (unused stages: 0).
    pad = lambda xs: xs + [0.0] * (3 - len(xs))
    weights = cc._floats(pad([a for a, _ in stages]) + pad([b for _, b in stages]))
    degree, n_dofs = transport.basis.degree, transport.basis.n_dofs
    device = tracers.device
    n_tracers = tracers.shape[1]
    cc._check((n_dofs, n_tracers, nx, ny), device, tracers=tracers)
    if qv is None:
        cc._check((nx, ny), device, u=u, v=v)
        u_ptr, v_ptr, qv_ptrs = u.data_ptr(), v.data_ptr(), None
    else:
        u, v = None, None
        u_ptr, v_ptr, qv_ptrs = None, None, cc._dg1_qv(qv, (nx, ny), device, degree)
    face_x, face_y = cc._face_planes(tracers[0, 0], face_masks, (nx, ny))
    tvb = transport.limits_slopes
    if tvb and not transport.mesh.uniform:
        raise NotImplementedError(
            "transport_tiled's TVB form takes one tolerance an axis (a uniform mesh); TVB on a "
            "graded or spherical mesh runs the staged transport"
        )
    rings = rings_per_substep(transport)
    if halo is None:
        halo = (
            tvb_halo(k, rings, qv is not None, n_tracers, nx * ny, n_dofs, n_stages)
            if tvb else halo_for(k, rings)
        )
    k_cap = (halo - 1) // rings
    mesh = transport.mesh
    if (mesh.periodic_x and halo > nx) or (mesh.periodic_y and halo > ny):
        raise ValueError(f"halo {halo} is wider than a periodic axis of the {nx} x {ny} grid")
    wrap = cc.wrap_bits(mesh)
    if walls is not None and (wrap or len(walls) != 4):
        raise ValueError("the TVB walls are four indices of a closed launch")
    tolerances = cc._floats(transport.tvb_tolerances(device="cpu", dtype=torch.float32)) if tvb else None
    wall_array = None if walls is None else (ctypes.c_int * 4)(*map(int, walls))
    if group is None:
        group = window_tracers(halo, qv is not None, n_tracers, nx * ny, n_dofs, n_stages)
    if group < 1 or n_tracers % group:
        raise ValueError(f"a window of {group} tracers does not divide {n_tracers}")
    config = config or launch_config(halo, qv is not None, group, nx * ny, n_dofs, n_stages)
    if tile or threads:
        config = replace(config, tile=tile or config.tile, threads=threads or config.threads)
    if config.tile < 1 or k_cap < 1:
        raise ValueError(f"tile {config.tile} / halo {halo} leaves no substep per launch")
    tables = cc._dg1_tables(transport)
    if metric is not None:
        cc._check((nx, ny), device, **{f"metric {name}": metric[name] for name in cc._DG1_METRIC})
    metric = cc._dg1_metric(transport, device, metric)
    stream = cc._stream(device)
    src = tracers
    buffers = [torch.empty_like(tracers) for _ in range(2)]
    items = -(-nx // config.tile) * -(-ny // config.tile) * (n_tracers // group)
    done = 0
    while done < k:
        n_sub = min(k_cap, k - done)
        dst = buffers[0] if src is not buffers[0] else buffers[1]
        form = copy_form(ny, src, u, v) if copy == "auto" else copy
        blocks = items
        if config.persistent:
            per_sm = blocks_per_sm(
                device, config, halo, qv is not None, metric is not None, form, group, degree,
                n_stages, 2 if walls is not None else int(tvb),
            )
            blocks = min(items, per_sm * cc.sm_count(device))
        cc._launch(
            KERNEL, src.data_ptr(), dst.data_ptr(), u_ptr, v_ptr, face_x.data_ptr(),
            face_y.data_ptr(), metric, qv_ptrs, nx, ny, n_tracers, group, degree, config.tile,
            halo, n_sub, n_stages, config.threads, config.buffers, int(form == "vector"), blocks,
            int(compute), wrap, None if tolerances is None else ctypes.addressof(tolerances),
            None if wall_array is None else ctypes.addressof(wall_array),
            ctypes.addressof(weights), dt_sub, ctypes.addressof(tables), device.index, stream,
        )
        src = dst
        done += n_sub
    return src


def transport_tiled_spmd_config(model):
    """(H, k_cap) of the spmd wrapper on ``model``'s rank block, or None.

    The exchange's ghost width H buys k_cap = (H - 1) // rings substeps on
    the widened block: each substep spoils ``rings_per_substep`` rings of
    it (a ring a stage, two with TVB), and the velocity sampled at its edge
    spoils one more, once. With k rarely above the K_MAX = 3 substeps of
    one transport_tiled launch, the first H from 8 up that gives k_cap >=
    K_MAX serves one launch per exchange (rk2: 8, rk3 or rk2 with TVB: 16);
    the strips are slices of the block, so H may not exceed it, and a
    smaller block takes the largest H that still gives k_cap >= 1 (None
    where none does, and for TVB on a graded or spherical mesh, whose
    tolerance planes transport_tiled does not take: that runs staged).
    """
    tr, mesh = model.transport, model.mesh
    if tr.limits_slopes and not mesh.uniform:
        return None
    rings = rings_per_substep(tr)
    limit = min(mesh.nx, mesh.ny)
    for H in (8, 16, 24, 32):
        if (H - 1) // rings >= K_MAX and H <= limit:
            return H, (H - 1) // rings
    H = limit
    return (H, (H - 1) // rings) if H >= rings + 1 else None


def _widen(model, f, H: int):
    """``f``'s last two axes widened by H ghost cells from the rank's
    neighbours: one strip pair per axis, round the ring of a periodic
    axis."""
    ax_x, ax_y = model.spmd
    f = halo_widen(f, H, f.ndim - 2, model.mesh.periodic_x, ax_x)
    return halo_widen(f, H, f.ndim - 1, model.mesh.periodic_y, ax_y)


def spmd_walls(model, H: int):
    """The TVB walls of the rank's block widened by H, as the kernel's rank
    grid form takes them: (fwd_x, bwd_x, fwd_y, bwd_y), the widened block's
    row (column) of the global last and first wall of each closed axis that
    this block owns, -1 for none (the JAX package's wall-delta masks)."""
    mesh = model.mesh
    out = []
    for n, periodic, exchange in ((mesh.nx, mesh.periodic_x, model.spmd[0]),
                                  (mesh.ny, mesh.periodic_y, model.spmd[1])):
        last = not periodic and is_global_edge("last", exchange)
        first = not periodic and is_global_edge("first", exchange)
        out += [H + n - 1 if last else -1, H if first else -1]
    return tuple(out)


def spmd_halo(model) -> int:
    """The spmd wrapper's exchange width H on ``model``'s rank block
    (``transport_tiled_spmd_config``); raises where there is none."""
    config = transport_tiled_spmd_config(model)
    if config is None:
        raise NotImplementedError(
            f"no spmd tiled transport for {model.transport.scheme} on a "
            f"{model.mesh.nx} x {model.mesh.ny} block"
        )
    return config[0]


def widen_velocity(model, u, v, H: int = None):
    """(2, nx + 2H, ny + 2H): the rank's (u, v) widened by H, by default the
    spmd wrapper's (``spmd_halo``). The dynamics phase samples the CFL
    speeds from it and passes it on to ``transport_substeps_tiled_spmd``."""
    return _widen(model, torch.stack([u, v]), spmd_halo(model) if H is None else H)


def transport_substeps_tiled_spmd(
    model, tracers, velocity_w, dt_sub: float, k: int, face_masks=None, qv: QuadVelocity = None,
):
    """The rank's tracers after k limited substeps (``model``: the rank's
    ``CoupledModel``; ``tracers`` (K, T, nx, ny) and ``face_masks`` its
    block's; ``velocity_w`` its (u, v) widened by H, from
    ``widen_velocity``, which fixes H; or, with the HO solver, None and
    ``qv`` the block's quadrature samples, which are widened here by the H
    of ``transport_tiled_spmd_config``). Per exchange round: widen the
    tracers by H ghost cells (one strip pair per axis), run up to
    k_cap = (H - 1) // stages substeps on the widened block with
    ``transport_substeps_tiled`` (transport_tiled on a card, the plain
    version on the CPU), keep the interior. The face masks are widened
    once. The global walls: the wall-face zeroing of the first block is
    baked into the face masks before they are widened, and beyond a global
    wall the strips are zeros (no velocity, no face), so no flux crosses
    it, as on one domain. On a periodic axis the strips come round the
    ring and no face is a wall. On a rank block of a graded or spherical
    mesh the widened metric planes (``CoupledModel.widened_metric``) go to
    the kernel; with TVB its walls (``spmd_walls``).
    """
    mesh, tr = model.mesh, model.transport
    ax_x, ax_y = model.spmd
    nx, ny = mesh.nx, mesh.ny
    if (velocity_w is None) == (qv is None):
        raise ValueError("the spmd transport takes the widened (u, v) or the samples qv, one of them")
    if qv is None:
        H = (velocity_w.shape[-2] - nx) // 2
        u_w, v_w, qv_w = velocity_w[0], velocity_w[1], None
    else:
        H = spmd_halo(model)
        u_w = v_w = None
        qv_w = QuadVelocity(*(_widen(model, getattr(qv, f), H) for f in ("vx_vol", "vy_vol", "vn_x", "vn_y")))
    k_cap = (H - 1) // rings_per_substep(tr)
    fits = qv is not None or tuple(velocity_w.shape) == (2, nx + 2 * H, ny + 2 * H)
    if not fits or k_cap < 1 or H > min(nx, ny):
        raise ValueError(f"an exchange width of {H} does not fit a {nx} x {ny} block for {tr.scheme}")

    ones = torch.ones_like(tracers[0, 0])
    fx, fy = (ones, ones) if face_masks is None else face_masks
    fx, fy = fx.clone(), fy.clone()
    if not mesh.periodic_x and is_global_edge("first", ax_x):
        fx[0, :] = 0.0
    if not mesh.periodic_y and is_global_edge("first", ax_y):
        fy[:, 0] = 0.0
    faces_w = _widen(model, torch.stack([fx, fy]), H)
    local = model.widened_transport(H)
    metric = model.widened_metric(H, device=tracers.device, dtype=tracers.dtype)
    walls = spmd_walls(model, H) if tr.limits_slopes else None
    done = 0
    while done < k:
        n_sub = min(k_cap, k - done)
        padded = transport_substeps_tiled(
            local, _widen(model, tracers, H), u_w, v_w, dt_sub, n_sub,
            (faces_w[0], faces_w[1]), qv=qv_w, metric=metric, walls=walls,
        )
        tracers = padded[:, :, H: H + nx, H: H + ny]
        done += n_sub
    return tracers.contiguous()
