"""N higher-order mEVP subcycles in one launch: the ``ho_single`` CUDA kernel.

Counterpart of ``nextsimdg_tpu/dynamics/kernels/mevp_ho_pallas.py``, whose
``ho_subcycles_pallas`` runs all N HO subcycles in one call with the 17
state planes (4 + 4 CG2 velocity, 3 x 3 dG1 stress coefficients) and the
29 const planes resident in VMEM. Here (``csrc/ho_single.cu``) one
cooperative launch runs all N subcycles with the grid cut into at most one
tile a streaming multiprocessor: each block keeps its tile's 17 state
planes (and, where they fit, its 29 const planes) in shared memory for the
whole launch, and after each half of a subcycle swaps only the tile's edge
with the three neighbours that read it, through a global exchange buffer of
words that carry the half that wrote them: a block waits on the words it
reads and on nothing else (a swap after grid.sync() measured slower, as did
two or four smaller tiles an SM; PERF.md).

In the A-weighted form the four a_{k} planes join the consts (33), and on
a graded or spherical mesh the four element widths dx, dy, inv_dx and
inv_dy (33, or 37 with both; a force reads each neighbour element's
widths, a neighbour tile's from global memory); on a periodic axis the
tiles divide the axis exactly and form a ring (``tiling(...,
periodic=)``), the apron beyond the last tile being the first tile's edge.
The form (``coupled_cuda.kernel_form``) selects a template instance of the
kernel. At 256^2 the 37 const planes still fit beside the state (128 tiles
of 16 x 32: 41,616 B of state and 75,776 B of consts a block); at 512^2
and above no form's consts do, and they are read from global memory.

The tiles must all be resident at once, so a grid whose 17 state planes
do not fit the card's shared memory at one tile an SM (about 640^2 on the
H100) is refused, as the TPU kernel refuses grids beyond VMEM
(``ho_pallas_supported``); the "auto" schedule sends grids from
``mevp_ho.HO_SINGLE_MAX_ELEMENTS`` = 512^2 to ``ho_tiled``.

Plain version: N x ``MEVPSolverHO.subcycle_body``
(``ho_single_reference``). The kernel runs the element and node bodies of
``ho_tiled``, so the two schedules agree bit for bit.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import torch

from ..mevp_ho import MEVPSolverHO, ho_subcycles_reference
from . import coupled_cuda as cc
from .coupled_cuda import sm_count

KERNEL = "ho_single"

#: The plain version: N x MEVPSolverHO.subcycle_body.
ho_single_reference = ho_subcycles_reference

#: Most threads an SM (one element or node index each per half: the
#: bodies keep 128 registers at 512).
MAX_THREADS = 512
#: Dynamic shared memory a block may take on the H100, and an SM holds
#: (1 KB of it reserved per block).
SHARED_LIMIT, SM_SHARED = 232448, 233472
STATE_PLANES, CONST_PLANES = 17, 29


def const_planes(weighted: bool, metric: bool = False) -> int:
    """The const planes of a form: 29, the four a_{k} with
    ``a_weighted_stress`` and the four widths on a graded or spherical
    mesh (``metric``)."""
    return CONST_PLANES + 4 * bool(weighted) + 4 * bool(metric)


@dataclass(frozen=True)
class Tiling:
    """TR x TC tiles (``tile``), ``tiles`` = (along i, along j) of them,
    one block of ``threads`` threads each; ``consts_shared``: the
    ``n_consts`` const planes of the form (29, 33 A-weighted or metric, 37
    both) fit beside the state in shared memory."""

    tile: tuple
    tiles: tuple
    threads: int
    consts_shared: bool
    n_consts: int = CONST_PLANES

    @property
    def n_tiles(self) -> int:
        return self.tiles[0] * self.tiles[1]

    def shared_bytes(self) -> int:
        return shared_bytes(self.tile, self.consts_shared, self.n_consts)


def shared_bytes(tile, consts_shared: bool, n_consts: int = CONST_PLANES) -> int:
    """Dynamic shared memory of one block: the 17 state planes of a TR x TC
    tile with a one-cell apron, and its ``n_consts`` const planes where they
    are kept there."""
    tr, tc = tile
    state = STATE_PLANES * (tr + 2) * (tc + 2) * 4
    return state + (n_consts * tr * tc * 4 if consts_shared else 0)


def neighbours(tiles, b: int, direction: int) -> list:
    """The tiles that tile ``b`` of a (tiles_i, tiles_j) grid reads after a
    half: +i, +j and +i+j (direction 1, after the velocity half) or -i, -j
    and -i-j (-1, after the stress half), those inside the grid."""
    tiles_i, tiles_j = tiles
    ti, tj = divmod(b, tiles_j)
    out = []
    for di, dj in ((direction, 0), (0, direction), (direction, direction)):
        i, j = ti + di, tj + dj
        if 0 <= i < tiles_i and 0 <= j < tiles_j:
            out.append(i * tiles_j + j)
    return out


def _exact_rows(nx: int, tr: int):
    """The smallest divisor of nx from tr up (tiles that cut a periodic
    axis exactly), or None."""
    return next((d for d in range(tr, nx + 1) if nx % d == 0), None)


@lru_cache(maxsize=64)
def tiling(
    nx: int, ny: int, sms: int, tile=None, periodic=(False, False), weighted: bool = False,
    metric: bool = False,
) -> Tiling:
    """The tiles of an nx x ny grid on a card of ``sms`` SMs: at most one
    an SM, the smallest area (then the shortest edge, then the widest rows)
    unless ``tile`` = (TR, TC) is given; up to 512 threads a block. A
    periodic axis (``periodic`` = (x, y)) takes only tiles that divide it
    exactly: its tiles form a ring whose last edge is the first tile's.
    ``weighted`` (the A-weighted form) and ``metric`` (a graded or
    spherical mesh) give the form's const planes (``const_planes``), which
    decide whether the consts fit in shared memory. Raises ValueError where the state of a
    tile does not fit a block's shared memory or the tiles outnumber the
    SMs: such a grid cannot be resident."""
    slots, limit = sms, SHARED_LIMIT
    px, py = periodic
    if tile is None:
        best = None
        for tc in range(1, ny + 1):
            tiles_j = -(-ny // tc)
            if tiles_j > slots or (tc > 1 and -(-ny // (tc - 1)) == tiles_j):
                continue  # too many columns, or a narrower tile gives as many
            if py and ny % tc:
                continue
            tr = -(-nx // (slots // tiles_j))
            if px:
                tr = _exact_rows(nx, tr)
            if tr is None or shared_bytes((tr, tc), False) > limit:
                continue
            key = (tr * tc, tr + tc, -tc)
            if best is None or key < best[0]:
                best = (key, (tr, tc))
        if best is None:
            raise ValueError(
                f"ho_single: the {nx} x {ny} grid's state does not fit the shared memory of "
                f"{sms} SMs at one tile an SM (at most {limit} B a tile); ho_tiled runs it"
            )
        tile = best[1]
    tr, tc = tile
    if tr < 1 or tc < 1:
        raise ValueError(f"ho_single: tile {tile} is empty")
    if (px and nx % tr) or (py and ny % tc):
        raise ValueError(
            f"ho_single: a {tr} x {tc} tile does not divide the periodic axes of the "
            f"{nx} x {ny} grid"
        )
    tiles = (-(-nx // tr), -(-ny // tc))
    if tiles[0] * tiles[1] > slots:
        raise ValueError(
            f"ho_single: {tiles[0]} x {tiles[1]} tiles of {tr} x {tc} on a {nx} x {ny} grid "
            f"outnumber the {slots} blocks that {sms} SMs hold: the tiles could not all be resident"
        )
    if shared_bytes(tile, False) > limit:
        raise ValueError(
            f"ho_single: the {nx} x {ny} grid's state does not fit the shared memory of "
            f"{sms} SMs ({shared_bytes(tile, False)} B for a {tr} x {tc} tile, at most "
            f"{limit}); ho_tiled runs it"
        )
    threads = min(MAX_THREADS, -(-tr * tc // 32) * 32)
    n_consts = const_planes(weighted, metric)
    return Tiling(tile, tiles, threads, shared_bytes(tile, True, n_consts) <= limit, n_consts)


def holds(nx: int, ny: int, sms: int, periodic=(False, False)) -> bool:
    """Whether ``tiling`` takes an nx x ny grid with these periodic axes on
    ``sms`` SMs."""
    try:
        tiling(nx, ny, sms, periodic=tuple(periodic))
    except ValueError:
        return False
    return True


def largest_square(sms: int) -> int:
    """The side of the largest square grid ho_single holds on ``sms`` SMs."""
    lo, hi = 1, 4096  # holds(lo) and not holds(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if holds(mid, mid, sms) else (lo, mid)
    return lo


def max_blocks(device, config: Tiling, form: int = 0) -> int:
    """The most blocks of ``config``'s shape that can be resident at once:
    the most tiles a launch of it takes (the instance of ``form``,
    ``coupled_cuda.kernel_form``)."""
    device = torch.device(device)
    count = cc._library().nst_ho_single_max_blocks(
        int(config.consts_shared), form, config.threads, config.shared_bytes(), device.index or 0,
    )
    if count <= 0:
        raise RuntimeError(f"ho_single: no resident blocks (CUDA error {-count})")
    return count


def exchange(config: Tiling, device) -> torch.Tensor:
    """The exchange buffer of a launch: (tiles, 17, TR + TC) 64-bit words,
    zero (no half has written them)."""
    return torch.zeros((config.n_tiles, STATE_PLANES, sum(config.tile)), device=device, dtype=torch.int64)


def ho_subcycles_single(
    solver: MEVPSolverHO, carry, consts, dt: float, n_subcycles: int, tile=None,
):
    """(u, v, s11, s22, s12) after ``n_subcycles`` HO subcycles.

    CPU tensors run the plain version; CUDA tensors (float32, contiguous)
    run ``ho_single``: one cooperative launch of one block per tile
    (``tiling`` on the solver mesh's periodic axes and the solver's form;
    ``tile`` = (TR, TC) forces the tile shape), in place on a flat copy of
    the carry (``coupled_cuda.ho_flatten``), so the inputs are not
    modified; the solver's form (A-weighted, metric, periodic) selects the
    kernel's instance.
    Raises ValueError for a grid whose tiles cannot all be resident.
    """
    if cc._on_cpu(carry[0].v):
        return ho_single_reference(solver, carry, consts, dt, n_subcycles)
    cc._check_ho(solver, carry, consts)
    if n_subcycles < 0:
        raise ValueError(f"n_subcycles must be >= 0, got {n_subcycles}")
    state = cc.ho_flatten(carry)
    if n_subcycles == 0:
        return cc.ho_unflatten(state)
    _, nx, ny = state.shape
    device = state.device
    mesh = solver.mesh
    config = tiling(
        nx, ny, sm_count(device), None if tile is None else tuple(tile),
        (mesh.periodic_x, mesh.periodic_y), solver.params.a_weighted_stress, not mesh.uniform,
    )
    scalars, tables = cc._ho_scalars(solver, dt), cc._ho_tables(solver)
    words = exchange(config, device)
    const_ptrs = cc._ho_consts(consts)
    cc._launch(
        KERNEL, state.data_ptr(), const_ptrs, words.data_ptr(),
        nx, ny, n_subcycles, *config.tile, *config.tiles, config.threads,
        int(config.consts_shared), cc.kernel_form(solver), ctypes.addressof(scalars),
        ctypes.addressof(tables), device.index, cc._stream(device),
    )
    return cc.ho_unflatten(state)
