"""One overlapped halo round of CG1 mEVP on a rank block: ``rdma_stage`` and
``rdma_band``, the CUDA kernels of K7.

Counterpart of ``nextsimdg_tpu/dynamics/kernels/mevp_rdma.py``, whose
``mevp_round_rdma`` runs one ghost-zone round of n_sub <= h subcycles in a
single TPU kernel that sends its strips to the neighbour chips by remote
DMA while it computes. Here the round (``mevp_round_rdma``) is, on the
rank's compute stream:

1. ``rdma_stage`` packs the x send strips (the rank's first and last h
   rows; the y strips when x is not split) and ``start`` hands them to the
   exchange, whose copies run on the receivers' copy streams;
2. the interior pass: ``mevp_tiled`` on the rank's own block with zero
   ghosts and the unwidened consts of the step, into fresh planes (so the
   pre-round planes stay intact for the bands);
3. ``wait`` for the x ghosts (zeros at a closed global wall); ``rdma_stage``
   packs the y strips extended by them (they carry the corners) and
   ``start`` sends them;
4. ``rdma_band`` re-runs the n_sub subcycles on the two x bands
   [ghost h | own 2h] x ny and patches the own rows [0, h) and
   [nx - h, nx);
5. ``wait`` for the y ghosts, then ``rdma_band`` on the two y bands
   (nx + 2h) x [ghost h | own 2h] patches the own columns, corners last.

Each subcycle spoils one ring, so the round needs n_sub <= h and, on each
split axis, a block of at least 2h cells. The plain version,
``mevp_round_rdma_reference``, runs the same steps with the plain subcycle
(``rdma_stage_reference``, ``rdma_band_reference``); the kernels run the
bodies and the window loop of ``mevp_tiled``, so a round equals the
blocked exchange's round and the single-device step bit for bit.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import torch

from ..mevp import UNIFORM_CONSTS, MEVPSolver
from . import coupled_cuda as cc
from .mevp_tiled_cuda import mevp_subcycles_tiled

#: Band tile along the long axis and threads per block of rdma_band.
TILE = 64
THREADS = 512
#: Shared memory a block may use on the H100 (227 KB).
MAX_SHARED_BYTES = 232448


@dataclass
class RoundSources:
    """What the bands of a round read, in the coordinates of the rank's
    widened block: the pre-round planes, and the ghosts received so far.

    On CUDA the kernels take the sources as a C array of pointers and one of
    dims (``c_args``), built once per set of ghosts and checked once: the
    own planes when the round's first kernel launches, each ghost pair when
    the first kernel after its ``wait`` launches. ``stream``: the stream the
    round's kernels launch on (the rank's compute stream, fetched once per
    round), or None for the caller's current stream at each launch."""

    own: tuple  #: the 5 pre-round (nx, ny) planes u, v, s11, s22, s12
    h: int  #: ghost width
    split: tuple  #: (x, y): whether each axis is split over ranks
    gx: tuple = None  #: (lo, hi) x ghosts, each (5, h, ny)
    gy: tuple = None  #: (lo, hi) y ghosts, each (5, nx + 2hx, h)
    stream: int = None
    _built: tuple = field(default=None, init=False, repr=False, compare=False)

    @property
    def hx(self) -> int:
        return self.h if self.split[0] else 0

    @property
    def hy(self) -> int:
        return self.h if self.split[1] else 0

    def c_args(self, need_gx: bool, need_gy: bool):
        """(pointer array, dims array) of RdmaSources in csrc/mevp_rdma.cu,
        from the cache while the ghosts are the same objects; raises where
        a needed ghost pair has not been received or a source is not what
        the kernels take."""
        for need, ghosts, name in ((need_gx, self.gx, "x"), (need_gy, self.gy, "y")):
            if need and ghosts is None:
                raise ValueError(f"the {name} ghosts of the round have not been received")
        built = self._built
        if built is not None and built[0] is self.gx and built[1] is self.gy:
            return built[2], built[3]
        nx, ny = self.own[0].shape
        device = self.own[0].device
        if built is None:
            cc._check((nx, ny), device, **dict(zip(("u", "v", "s11", "s22", "s12"), self.own)))
        for ghosts, name, shape in (
            (self.gx, "x", (5, self.h, ny)), (self.gy, "y", (5, nx + 2 * self.hx, self.h)),
        ):
            if ghosts is not None:
                cc._check(shape, device, **{f"g{name}_lo": ghosts[0], f"g{name}_hi": ghosts[1]})
        gx = self.gx if self.gx is not None else (None, None)
        gy = self.gy if self.gy is not None else (None, None)
        ptrs = cc._pointers([*self.own, *gx, *gy])
        dims = (ctypes.c_int * 5)(nx, ny, self.h, self.hx, self.hy)
        self._built = (self.gx, self.gy, ptrs, dims)
        return ptrs, dims

    def launch_stream(self) -> int:
        return self.stream if self.stream is not None else cc._stream(self.own[0].device)


def _x_extended(src: RoundSources) -> torch.Tensor:
    """(5, nx + 2hx, ny): the pre-round state with the x ghosts above and
    below it."""
    state = torch.stack(src.own)
    if src.gx is None:
        return state
    return torch.cat([src.gx[0], state, src.gx[1]], dim=1)


def rdma_stage_reference(src: RoundSources, axis: int) -> torch.Tensor:
    """The send strips of ``axis`` as a (2, 5, ., .) tensor (lo, hi): x, the
    first and last h rows; y, the first and last h columns of the state
    extended by the x ghosts."""
    h = src.h
    if axis == 0:
        state = torch.stack(src.own)
        return torch.stack([state[:, :h], state[:, -h:]])
    ext = _x_extended(src)
    return torch.stack([ext[:, :, :h], ext[:, :, -h:]])


def _band_consts(consts_w: dict, rows: slice, cols: slice) -> dict:
    return {name: plane[rows, cols] for name, plane in consts_w.items()}


def rdma_band_reference(solver, src: RoundSources, axis: int, consts_w: dict, dt, n_sub, state):
    """n_sub plain subcycles (``solver`` without an exchange) on the two
    bands of ``axis``; patches their rows (x) or columns (y) into the 5
    planes of ``state`` in place and returns it."""
    h, hx, hy = src.h, src.hx, src.hy
    own = torch.stack(src.own)
    nx, ny = own.shape[1:]
    run = lambda planes, consts: cc.mevp_subcycles_reference(solver, tuple(planes), consts, dt, n_sub)
    if axis == 0:
        lo = run(torch.cat([src.gx[0], own[:, : 2 * h]], dim=1),
                 _band_consts(consts_w, slice(0, 3 * h), slice(hy, hy + ny)))
        hi = run(torch.cat([own[:, nx - 2 * h:], src.gx[1]], dim=1),
                 _band_consts(consts_w, slice(nx - h, nx + 2 * h), slice(hy, hy + ny)))
        for k in range(5):
            state[k][:h] = lo[k][h: 2 * h]
            state[k][nx - h:] = hi[k][h: 2 * h]
        return state
    ext = _x_extended(src)
    lo = run(torch.cat([src.gy[0], ext[:, :, : 2 * h]], dim=2),
             _band_consts(consts_w, slice(None), slice(0, 3 * h)))
    hi = run(torch.cat([ext[:, :, ny - 2 * h:], src.gy[1]], dim=2),
             _band_consts(consts_w, slice(None), slice(ny - h, ny + 2 * h)))
    for k in range(5):
        state[k][:, :h] = lo[k][hx: hx + nx, h: 2 * h]
        state[k][:, ny - h:] = hi[k][hx: hx + nx, h: 2 * h]
    return state


def shared_bytes(rows: int, cols: int, axis: int, tile: int, n_sub: int) -> int:
    """Dynamic shared memory of one rdma_band block: 7 planes of its window
    (tiles of ``tile`` + 2 n_sub along the band, the band's 3h cells and
    one of padding on either side across it)."""
    along = tile + 2 * n_sub
    across = (rows if axis == 0 else cols) + 2
    return 7 * along * across * 4


def rdma_stage(src: RoundSources, axis: int) -> torch.Tensor:
    """The send strips of ``axis`` (see ``rdma_stage_reference``), in one
    launch on CUDA tensors; CPU tensors run the plain version."""
    own = src.own[0]
    if cc._on_cpu(own):
        return rdma_stage_reference(src, axis)
    if not src.split[axis]:
        raise ValueError(f"axis {axis} is not split over ranks: it has no strips to send")
    # The y strips of a grid split along x carry the x ghosts.
    ptrs, dims = src.c_args(need_gx=axis == 1 and src.split[0], need_gy=False)
    nx, ny = own.shape
    h = src.h
    shape = (2, 5, h, ny) if axis == 0 else (2, 5, nx + 2 * src.hx, h)
    out = torch.empty(shape, device=own.device, dtype=torch.float32)
    cc._launch("rdma_stage", ptrs, dims, axis, out.data_ptr(), own.device.index, src.launch_stream())
    return out


def rdma_band(solver: MEVPSolver, src: RoundSources, axis: int, consts_w: dict, dt, n_sub, state):
    """n_sub subcycles on the two bands of ``axis`` and their patches into
    ``state`` (5 planes, in place; returned), in one launch on CUDA tensors;
    CPU tensors run the plain version. ``consts_w``: the 7 uniform consts
    widened by h on each split axis."""
    if cc._on_cpu(src.own[0]):
        return rdma_band_reference(solver, src, axis, consts_w, dt, n_sub, state)
    if tuple(sorted(consts_w)) != tuple(sorted(UNIFORM_CONSTS)) or not solver.mesh.uniform:
        raise NotImplementedError("rdma_band takes the 7 consts of a uniform mesh")
    if not src.split[axis]:
        raise ValueError(f"axis {axis} is not split over ranks: it has no bands")
    h = src.h
    nx, ny = src.own[0].shape
    if not 1 <= n_sub <= h or (nx if axis == 0 else ny) < 2 * h:
        raise ValueError(f"a round needs n_sub <= h = {h} and a block of at least 2h along axis {axis}")
    ptrs, dims = src.c_args(need_gx=src.split[0], need_gy=axis == 1)
    device = src.own[0].device
    cc._check((nx + 2 * src.hx, ny + 2 * src.hy), device, **consts_w)
    cc._check((nx, ny), device, **dict(zip(("u", "v", "s11", "s22", "s12"), state)))
    if {t.data_ptr() for t in state} & {t.data_ptr() for t in src.own}:
        raise ValueError("rdma_band reads the pre-round planes: state must not alias them")
    rows, cols = (3 * h, ny) if axis == 0 else (nx + 2 * src.hx, 3 * h)
    tile = TILE
    while shared_bytes(rows, cols, axis, tile, n_sub) > MAX_SHARED_BYTES and tile > 8:
        tile //= 2
    scalars = cc._mevp_scalars(solver, dt)  # alive until the call returns
    cc._launch(
        "rdma_band", ptrs, dims, axis, cc._mevp_consts(consts_w), tile, n_sub, THREADS,
        cc._pointers(state), ctypes.addressof(scalars), device.index, src.launch_stream(),
    )
    return state


def _round(solver, carry, consts, consts_w, dt, n_sub, h, axes, stage, band, interior, **sources):
    """The steps of the module docstring with the given primitives;
    ``sources``: the ``stream`` of the round's RoundSources."""
    ax_x, ax_y = axes
    src = RoundSources(own=tuple(carry), h=h, split=(ax_x is not None, ax_y is not None), **sources)
    if ax_x is not None:
        send = stage(src, 0)
        x_handle = ax_x.start(send[0], send[1])
    elif ax_y is not None:
        send = stage(src, 1)
        y_handle = ax_y.start(send[0], send[1])
    state = tuple(interior(solver, carry, consts, dt, n_sub))
    if ax_x is not None:
        src.gx = ax_x.wait(x_handle)
        if ax_y is not None:
            send = stage(src, 1)
            y_handle = ax_y.start(send[0], send[1])
        state = band(solver, src, 0, consts_w, dt, n_sub, state)
    if ax_y is not None:
        src.gy = ax_y.wait(y_handle)
        state = band(solver, src, 1, consts_w, dt, n_sub, state)
    return state


def _check_round(carry, consts_w, n_sub, h, axes) -> None:
    nx, ny = carry[0].shape
    if not 1 <= n_sub <= h:
        raise ValueError(f"a round runs 1 to h = {h} subcycles, not {n_sub}")
    for axis, (exchange, n) in enumerate(zip(axes, (nx, ny))):
        if exchange is not None and n < 2 * h:
            raise ValueError(f"the block ({n} cells along axis {axis}) must be at least 2h = {2 * h}")
    shape = (nx + 2 * h * (axes[0] is not None), ny + 2 * h * (axes[1] is not None))
    for name, plane in consts_w.items():
        if tuple(plane.shape) != shape:
            raise ValueError(f"widened const {name} has shape {tuple(plane.shape)}, expected {shape}")


def mevp_round_rdma_reference(solver: MEVPSolver, carry, consts, consts_w, dt, n_sub, h, axes):
    """One round on the plain subcycle, on any device. ``solver``: the
    rank's solver without an exchange (``MEVPSolver.local()``); ``consts``:
    the step's consts; ``consts_w``: the same widened by h on each split
    axis; ``axes``: the (x, y) ``AxisExchange`` of each split axis, None for
    an axis that is not split. Returns the 5 planes after the round."""
    _check_round(carry, consts_w, n_sub, h, axes)
    return _round(
        solver, carry, consts, consts_w, dt, n_sub, h, axes,
        rdma_stage_reference, rdma_band_reference, cc.mevp_subcycles_reference,
    )


def mevp_round_rdma(solver: MEVPSolver, carry, consts, consts_w, dt, n_sub, h, axes):
    """One round (arguments as ``mevp_round_rdma_reference``): on CUDA
    tensors rdma_stage, mevp_tiled and rdma_band on the rank's compute
    stream, the strips on the exchange's copy streams; CPU tensors run the
    plain version."""
    if cc._on_cpu(carry[0]):
        return mevp_round_rdma_reference(solver, carry, consts, consts_w, dt, n_sub, h, axes)
    _check_round(carry, consts_w, n_sub, h, axes)
    return _round(
        solver, carry, consts, consts_w, dt, n_sub, h, axes,
        rdma_stage, rdma_band, mevp_subcycles_tiled, stream=cc._stream(carry[0].device),
    )
