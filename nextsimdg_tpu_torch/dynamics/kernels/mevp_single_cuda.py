"""N CG1 mEVP subcycles in one launch: the ``mevp_single`` CUDA kernel.

Counterpart of ``nextsimdg_tpu/dynamics/kernels/mevp_pallas.py``, whose
``mevp_subcycles_pallas`` runs all N subcycles in one call with the whole
grid resident in VMEM, over the 5 state planes and the solver's const set
(7 planes on a uniform mesh, 12 with the metric planes of a graded or
spherical one). Here (``csrc/mevp_single.cu``) one cooperative launch runs
all N subcycles with the grid cut into at most one tile a streaming
multiprocessor: each block keeps its tile's 5 state planes, and as many
const planes as fit beside them (``RESIDENT_ORDER``), in shared memory for
the whole launch, and after each half of a subcycle swaps only the tile's
edge with the three neighbours that read it, through a global exchange
buffer of words that carry the half that wrote them (``csrc/tile_exchange.cuh``,
shared with ``ho_single``): a block waits on the words it reads and on
nothing else. Each thread owns up to 8 cells of the tile for the whole
launch and keeps their c_w and inv_drag in registers.

The tiles must all be resident at once, so a grid that the card's SMs do
not hold at one tile each (a tile of at most 8 cells a thread of 1024,
whose state fits a block's shared memory: 1024^2 on the H100) is
refused, as the TPU kernel refuses grids beyond VMEM
(``pallas_supported``); the "auto" schedule sends non-uniform grids from
``coupled.SINGLE_MAX_ELEMENTS`` to ``mevp_tiled``.

Plain version: N x ``MEVPSolver.subcycle_body`` (``mevp_single_reference``).
The kernel runs the element and node bodies of ``mevp_stress``/``mevp_velocity``
of ``coupled_cuda``, so it equals N subcycles of that schedule, and of
``mevp_tiled``, bit for bit. The solver's momentum form
(``coupled_cuda.mevp_form``) selects the template instance: the A-weighted
form reads the ``a_node`` plane (last in ``RESIDENT_ORDER``, so it is
resident where every plane fits), the adaptive form keeps each cell's beta
in registers. The thirteenth plane changes no tiling (``holds``): the tiles
hold the 5 state planes, and a const plane that does not fit beside them
is read from L2.

On a periodic axis the tiles form a ring (``csrc/tile_exchange.cuh``): the
last tile's neighbour after it is the first, so its apron comes from the
opposite side; ``tiling`` then takes only tiles that divide that axis.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import torch

from ..mevp import MEVP_CONSTS, MEVPSolver, const_names
from . import coupled_cuda as cc
from .coupled_cuda import sm_count
from .ho_single_cuda import SHARED_LIMIT

KERNEL = "mevp_single"

#: The plain version: N x MEVPSolver.subcycle_body.
mevp_single_reference = cc.mevp_subcycles_reference

#: Threads a block, and tile rows a thread owns, at most (one block an SM:
#: 64 registers a thread at 1024).
MAX_THREADS, MAX_CELLS = 1024, 8
STATE_PLANES = 5
#: The const planes a tile keeps in shared memory where there is room for
#: them beside the state, in this order (the rest are read from L2; the
#: order of resident_rank in csrc/mevp_single.cu): the velocity half reads
#: half_dx and half_dy at four elements each, dt_m and the ocean current are
#: read by both halves, the others (a_node of the A-weighted form last) once
#: a subcycle.
RESIDENT_ORDER = (
    "half_dx", "half_dy", "dt_m", "u_ocean", "v_ocean", "strength", "active", "b_u", "b_v",
    "inv_dx", "inv_dy", "inv_w", "a_node",
)
#: How many of the first const planes of that order the kernel can keep in
#: shared memory, short of all of them (one kernel each, compiled).
PARTIAL_COUNTS = (0, 1, 2)
#: The kernel's const-plane order (MevpConsts of csrc/mevp_body.cuh).
CONST_ORDER = MEVP_CONSTS


@dataclass(frozen=True)
class Tiling:
    """TR x TC tiles (``tile``), ``tiles`` = (along i, along j) of them,
    one block of ``threads`` threads each (``threads / TC`` tile rows at a
    time, at most 8 rows a thread); ``room``: how many const planes fit
    beside the state in a block's shared memory (at most the 13 of a
    non-uniform mesh in the A-weighted form)."""

    tile: tuple
    tiles: tuple
    threads: int
    room: int

    @property
    def n_tiles(self) -> int:
        return self.tiles[0] * self.tiles[1]

    def resident(self, metric: bool, weighted: bool = False) -> tuple:
        """The const planes kept in shared memory: the first of
        ``RESIDENT_ORDER`` among the const set of the mesh and form (with
        ``weighted``, a_node too), all of them where ``room`` allows, else
        the most of ``PARTIAL_COUNTS`` that fit."""
        consts = const_names(weighted, not metric)
        names = [n for n in RESIDENT_ORDER if n in consts]
        if self.room >= len(names):
            return tuple(names)
        return tuple(names[: max(c for c in PARTIAL_COUNTS if c <= self.room)])

    def shared_bytes(self, metric: bool, weighted: bool = False) -> int:
        return shared_bytes(self.tile, len(self.resident(metric, weighted)))



def shared_bytes(tile, n_consts: int = 0) -> int:
    """Dynamic shared memory of one block: the 5 state planes and
    ``n_consts`` const planes of a TR x TC tile, each with a one-cell apron."""
    tr, tc = tile
    return (STATE_PLANES + n_consts) * (tr + 2) * (tc + 2) * 4


def threads_for(tile):
    """The threads of a block for a TR x TC tile: as many whole tile rows
    of TC threads as fit 1024 (and the tile has), in warps; None where a
    thread would own more than 8 rows or a row is wider than 1024."""
    tr, tc = tile
    if tc > MAX_THREADS:
        return None
    rows = min(tr, MAX_THREADS // tc)
    if -(-tr // rows) > MAX_CELLS:
        return None
    return -(-rows * tc // 32) * 32


def _fits(tile) -> bool:
    return threads_for(tile) is not None and shared_bytes(tile) <= SHARED_LIMIT


def _exact_rows(nx: int, tr: int):
    """The smallest divisor of nx from tr up (tiles that cut a periodic
    axis exactly), or None."""
    return next((d for d in range(tr, nx + 1) if nx % d == 0), None)


@lru_cache(maxsize=64)
def tiling(nx: int, ny: int, sms: int, tile=None, periodic=(False, False)) -> Tiling:
    """The tiles of an nx x ny grid on a card of ``sms`` SMs: at most one
    an SM, the smallest area (then the shortest edge, then the widest rows)
    unless ``tile`` = (TR, TC) is given. A periodic axis (``periodic`` =
    (x, y)) takes only tiles that divide it exactly: its tiles form a ring
    whose last edge is the first tile's. Raises ValueError where the tiles
    outnumber the SMs, or a tile needs more than 8 cells a thread of 1024 or
    more shared memory than a block has for its 5 state planes: such a grid
    cannot be resident."""
    px, py = periodic
    if tile is None:
        best = None
        for tc in range(1, ny + 1):
            tiles_j = -(-ny // tc)
            if tiles_j > sms or (tc > 1 and -(-ny // (tc - 1)) == tiles_j):
                continue  # too many columns, or a narrower tile gives as many
            if py and ny % tc:
                continue
            tr = -(-nx // (sms // tiles_j))
            if px:
                tr = _exact_rows(nx, tr)
            if tr is None or not _fits((tr, tc)):
                continue
            key = (tr * tc, tr + tc, -tc)
            if best is None or key < best[0]:
                best = (key, (tr, tc))
        if best is None:
            raise ValueError(
                f"mevp_single: the {nx} x {ny} grid does not fit the shared memory and threads of "
                f"{sms} SMs at one tile an SM (at most {MAX_CELLS} cells a thread of {MAX_THREADS}, "
                f"{SHARED_LIMIT} B a tile); mevp_tiled runs it"
            )
        tile = best[1]
    tr, tc = tile
    if tr < 1 or tc < 1:
        raise ValueError(f"mevp_single: tile {tile} is empty")
    if (px and nx % tr) or (py and ny % tc):
        raise ValueError(
            f"mevp_single: a {tr} x {tc} tile does not divide the periodic axes of the "
            f"{nx} x {ny} grid"
        )
    tiles = (-(-nx // tr), -(-ny // tc))
    if tiles[0] * tiles[1] > sms:
        raise ValueError(
            f"mevp_single: {tiles[0]} x {tiles[1]} tiles of {tr} x {tc} on a {nx} x {ny} grid "
            f"outnumber the {sms} blocks that {sms} SMs hold: the tiles could not all be resident"
        )
    if not _fits(tile):
        raise ValueError(
            f"mevp_single: a {tr} x {tc} tile does not fit the shared memory and threads of a "
            f"block ({shared_bytes(tile)} B of state, at most {SHARED_LIMIT}; at most {MAX_CELLS} "
            f"cells a thread of {MAX_THREADS}); mevp_tiled runs the {nx} x {ny} grid"
        )
    state = shared_bytes(tile)
    room = min(len(CONST_ORDER), (SHARED_LIMIT - state) // (shared_bytes(tile, 1) - state))
    return Tiling(tile, tiles, threads_for(tile), room)


def holds(nx: int, ny: int, sms: int, periodic=(False, False)) -> bool:
    """Whether ``tiling`` takes an nx x ny grid on ``sms`` SMs (with the
    periodic axes ``periodic`` = (x, y))."""
    try:
        tiling(nx, ny, sms, periodic=tuple(periodic))
    except ValueError:
        return False
    return True


def largest_square(sms: int) -> int:
    """The side of the largest square grid mevp_single holds on ``sms`` SMs."""
    lo, hi = 1, 4096  # holds(lo) and not holds(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if holds(mid, mid, sms) else (lo, mid)
    return lo


def max_blocks(device, config: Tiling, metric: bool, form: int = 0) -> int:
    """The most blocks of ``config``'s shape in a momentum form that can be
    resident at once: the most tiles a launch of it takes."""
    device = torch.device(device)
    weighted = bool(form & cc.FORM_WEIGHTED)
    count = cc._library().nst_mevp_single_max_blocks(
        int(metric), form, *config.tile, len(config.resident(metric, weighted)), config.threads,
        device.index or 0,
    )
    if count <= 0:
        raise RuntimeError(f"mevp_single: no resident blocks (CUDA error {-count})")
    return count


def exchange(config: Tiling, device) -> torch.Tensor:
    """The exchange buffer of a launch: (tiles, 5, TR + TC) 64-bit words,
    zero (no half has written them)."""
    return torch.zeros((config.n_tiles, STATE_PLANES, sum(config.tile)), device=device, dtype=torch.int64)


def _slots(resident: tuple):
    """Each const plane's shared-memory plane (kernel order), -1 for none."""
    return (ctypes.c_int * len(CONST_ORDER))(
        *(resident.index(name) if name in resident else -1 for name in CONST_ORDER)
    )


def mevp_subcycles_single(
    solver: MEVPSolver, carry, consts, dt: float, n_subcycles: int, tile=None,
):
    """(u, v, s11, s22, s12) after ``n_subcycles`` subcycles.

    CPU tensors run the plain version; CUDA tensors (float32, contiguous)
    run ``mevp_single``: one cooperative launch of one block per tile
    (``tiling``; ``tile`` = (TR, TC) forces the tile shape), in place on
    copies of the inputs, which are not modified. Raises ValueError for a
    grid whose tiles cannot all be resident.
    """
    if cc._on_cpu(carry[0]):
        return mevp_single_reference(solver, carry, consts, dt, n_subcycles)
    cc._check_mevp(solver, carry, consts)
    if n_subcycles < 0:
        raise ValueError(f"n_subcycles must be >= 0, got {n_subcycles}")
    planes = tuple(t.clone() for t in carry)
    if n_subcycles == 0:
        return planes
    u = planes[0]
    nx, ny = u.shape
    device = u.device
    mesh = solver.mesh
    config = tiling(
        nx, ny, sm_count(device), None if tile is None else tuple(tile),
        (mesh.periodic_x, mesh.periodic_y),
    )
    slots = _slots(config.resident(not solver.mesh.uniform, solver.params.a_weighted_stress))
    scalars = cc._mevp_scalars(solver, dt)
    words = exchange(config, device)
    cc._launch(
        KERNEL, *(t.data_ptr() for t in planes), words.data_ptr(), cc._mevp_consts(consts),
        nx, ny, n_subcycles, *config.tile, *config.tiles, config.threads,
        cc.kernel_form(solver), slots, ctypes.addressof(scalars), device.index,
        cc._stream(device),
    )
    return planes
