"""One overlapped halo round of mEVP on a rank block: ``rdma_stage`` and
``rdma_band``, the CUDA kernels of K7, for the CG1 solver (5 state planes)
and the HO (CG2/dG1) solver (17).

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
split axis, a block of at least 2h cells.

Every form of the JAX round runs: the 7 uniform consts or the 12 of a rank
block of a graded or spherical mesh (a ``LocalMeshView``: the metric planes
widen with the other consts and the kernels read them by offset), a_node
besides in the A-weighted form, and the adaptive body (the momentum forms
select template instances, ``coupled_cuda.mevp_form``). On a periodic axis
split over ranks the ring is the exchange's (the ghosts come from the
wrapped neighbour, and nothing is zeroed); on a periodic axis of one rank
the round wraps along it: the interior pass is ``mevp_tiled``'s periodic
form and the bands of the other axis wrap along the band
(``phase_solvers``). ``rdma_band`` computes only the
patch's cone (``band_cone``, which the host passes to the kernel), by
clusters of blocks along the band (``launch_config``). The plain version,
``mevp_round_rdma_reference``, runs the same steps with the plain subcycle
on the whole bands (``rdma_stage_reference``, ``rdma_band_reference``);
the kernels run the bodies of ``mevp_tiled`` with its arguments, so a
round equals the blocked exchange's round and the single-device step bit
for bit.

The HO round (a ``MEVPSolverHO``, K7's 17-plane instantiation) is the same
round on the 17 planes of ``coupled_cuda.ho_flatten``, as one (17, nx, ny)
tensor: ``rdma_stage`` packs 17-plane strips, the interior pass is the
single-device rule of the HO solver on the rank's own block (ho_tiled, or
ho_single below ``mevp_ho.HO_SINGLE_MAX_ELEMENTS`` where the card holds
it), and ``rdma_band``'s HO form (``csrc/mevp_rdma_ho.cu``) runs the HO
bodies of ho_tiled on the same cone in its own launch configuration
(``HoBandConfig``, ``launch_config(axis, HO_PLANES, h, along)``): clusters
split along and across the band, the 29-37 widened HO consts staged in
shared memory once a launch. Its plain version runs
``ho_subcycles_reference`` on the whole bands.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import weakref
from dataclasses import dataclass, field

import torch

from ..mesh import block_mesh
from ..mevp import MEVPSolver, const_names
from ..mevp_ho import MEVPSolverHO, ho_subcycles_reference
from . import coupled_cuda as cc
from .mevp_tiled_cuda import mevp_subcycles_tiled

#: Shared memory a block may use on the H100 (227 KB).
MAX_SHARED_BYTES = 232448
#: Subcycles an rdma_band launch may run, cells a thread of it may own, and
#: blocks a cluster may have (kRdmaMaxSub, kRdmaMaxCells and
#: kRdmaMaxClusterBlocks in csrc/mevp_rdma.cu).
MAX_SUB = 64
MAX_CELLS = 4
MAX_CLUSTER_BLOCKS = 16
#: The launch bounds of rdma_band's two builds (kRdmaBandThreads,
#: kRdmaMaxThreads): blocks of up to 256 threads run the first.
LAUNCH_BOUNDS = (256, 1024)
#: The state planes of a CG1 round and of an HO round (kRdmaPlanes,
#: kRdmaHoPlanes), the HO band's launch bounds with staged and with L2
#: consts (kRdmaHoThreads, kRdmaHoL2Threads in csrc/mevp_rdma_ho.cuh) and
#: the most const planes an HO form stages (ho_const_planes: the metric
#: A-weighted form's 37).
CG1_PLANES, HO_PLANES = 5, 17
HO_MAX_THREADS, HO_L2_MAX_THREADS = 384, 256
HO_MAX_CONSTS = 37


def launch_bound(threads: int) -> int:
    """The launch bound of the rdma_band build that blocks of ``threads``
    threads run."""
    return next(b for b in LAUNCH_BOUNDS if threads <= b)


def band_shape(axis: int, h: int, nx: int, ny: int, hx: int) -> tuple:
    """(rows, cols) of a band of ``axis`` on an (nx, ny) rank block: x
    bands 3h x ny, y bands (nx + 2hx) x 3h."""
    return (3 * h, ny) if axis == 0 else (nx + 2 * hx, 3 * h)


def band_cone(axis: int, h: int, n_sub: int, nx: int, ny: int, hx: int, wrap: bool = False) -> list:
    """The patch's cone, per subcycle of an rdma_band launch, in band
    coordinates: (element rows lo, hi, element columns lo, hi, node rows
    lo, hi, node columns lo, hi), each [lo, hi) clipped to the band; with
    ``wrap`` (the band wraps along its length) not clipped along it.

    The patch is a band's h middle rows (x) or columns (y), over the own
    columns (x) or rows (y). After subcycle ``sub`` come r = n_sub - 1 - sub
    more, so it needs the nodes of the patch widened by r on either side,
    and the elements that they and its own velocity phase read: widened by
    r + 1 before and r after (a node reads the elements at -1 and 0, an
    element the nodes at 0 and +1)."""
    rows, cols = band_shape(axis, h, nx, ny, hx)
    (pr0, prn), (pc0, pcn) = ((h, h), (0, ny)) if axis == 0 else ((hx, nx), (h, h))
    clip = lambda lo, hi, n: (max(lo, 0), min(hi, n))
    keep = lambda lo, hi, n: (lo, hi)
    clip_rows = keep if wrap and axis == 1 else clip  # y bands run along the rows
    clip_cols = keep if wrap and axis == 0 else clip
    cone = []
    for sub in range(n_sub):
        r = n_sub - 1 - sub
        cone.append(
            clip_rows(pr0 - r - 1, pr0 + prn + r, rows) + clip_cols(pc0 - r - 1, pc0 + pcn + r, cols)
            + clip_rows(pr0 - r, pr0 + prn + r, rows) + clip_cols(pc0 - r, pc0 + pcn + r, cols)
        )
    return cone


@functools.lru_cache(maxsize=64)
def _cone_array(axis: int, h: int, n_sub: int, nx: int, ny: int, hx: int, wrap: bool = False):
    """``band_cone`` as the kernel takes it (n_sub x 8 C ints), built once
    per band shape: every round of a step launches the same ones."""
    cone = band_cone(axis, h, n_sub, nx, ny, hx, wrap)
    return (ctypes.c_int * (8 * n_sub))(*(x for sub in cone for x in sub))


@dataclass(frozen=True)
class BandConfig:
    """rdma_band's launch (the CG1 form): clusters of ``cluster`` blocks of
    ``threads`` threads along a band, each block ``seg`` cells along it."""

    cluster: int
    seg: int
    threads: int

    def shared_bytes(self, h: int, axis: int = 0) -> int:
        """Dynamic shared memory of one block: the 5 state planes of its
        seg x 3h cells and its apron along the band (the y bands' rows
        padded by a cell)."""
        return CG1_PLANES * (3 * h + axis) * (self.seg + 2) * 4

    def clusters(self, along: int, n_sub: int) -> int:
        """Clusters a band of ``along`` cells takes: each writes the
        cluster x seg - 2 n_sub cells of its window's interior."""
        return -(-along // (self.cluster * self.seg - 2 * n_sub))

    def cells_per_thread(self, h: int) -> int:
        """Cells each thread owns: one position along the band, every
        threads // seg-th of the band's 3h cells across it; 0 where a block
        has fewer threads than positions."""
        stride = self.threads // self.seg
        return -(-3 * h // stride) if stride else 0

    def check(self, axis: int, h: int, n_sub: int) -> None:
        """Raises where the kernel does not take this configuration: a
        thread owns at most ``MAX_CELLS`` cells."""
        if not (
            1 <= self.cells_per_thread(h) <= MAX_CELLS and self.threads <= LAUNCH_BOUNDS[-1]
            and 1 <= self.cluster <= MAX_CLUSTER_BLOCKS and 32 <= self.threads and 1 <= self.seg
            and self.cluster * self.seg > 2 * n_sub
            and self.shared_bytes(h, axis) <= MAX_SHARED_BYTES
        ):
            raise ValueError(f"rdma_band takes no launch configuration {self} at h = {h}, n_sub = {n_sub}")


@dataclass(frozen=True)
class HoBandConfig:
    """rdma_band's HO launch (``csrc/mevp_rdma_ho.cu``): clusters of
    ``along`` x ``across`` blocks of ``threads`` threads, each block ``seg``
    cells along the band and ``rows(h)`` across it (the band's 3h cells
    split over ``across`` blocks), with a one-cell apron on every side; a
    phase runs the block's cells of the patch's cone in one flat loop. With
    ``staged`` the form's 29-37 const planes are copied into shared memory
    once a launch beside the 17 state planes (blocks of up to 384 threads,
    two an SM), else read from L2 (up to 256 threads, three an SM)."""

    along: int
    across: int
    seg: int
    threads: int
    staged: bool = True

    @property
    def cluster(self) -> int:
        """Blocks a cluster."""
        return self.along * self.across

    def rows(self, h: int) -> int:
        """Cells across the band that one block holds."""
        return -(-3 * h // self.across)

    def shared_bytes(self, h: int, axis: int = 0, n_consts: int = HO_MAX_CONSTS) -> int:
        """Dynamic shared memory of one block (either axis): the 17 state
        planes and, staged, the ``n_consts`` const planes of its rows x seg
        cells and their apron (rdma_band_ho_shared_bytes)."""
        planes = HO_PLANES + (n_consts if self.staged else 0)
        return planes * (self.rows(h) + 2) * (self.seg + 2) * 4

    def clusters(self, along: int, n_sub: int) -> int:
        """Clusters a band of ``along`` cells takes: each writes the
        along x seg - 2 n_sub cells of its window's interior."""
        return -(-along // (self.along * self.seg - 2 * n_sub))

    def cells_per_thread(self, h: int) -> int:
        """Cells a thread computes in a phase, at most (the first
        subcycle's, whose cone spans the band across)."""
        return -(-self.rows(h) * self.seg // self.threads)

    def check(self, axis: int, h: int, n_sub: int, n_consts: int = HO_MAX_CONSTS) -> None:
        """Raises where the kernel does not take this configuration at ghost
        width h for a form of ``n_consts`` const planes (the largest by
        default): rdma_band_ho_valid's limits and the card's shared memory."""
        across, rows = 3 * h, self.rows(h)
        bound = HO_MAX_THREADS if self.staged else HO_L2_MAX_THREADS
        if not (
            1 <= self.along and 1 <= self.across <= across and self.cluster <= MAX_CLUSTER_BLOCKS
            and (self.across - 1) * rows < across and 1 <= self.seg <= 1000
            and 32 <= self.threads <= bound and self.threads % 32 == 0
            and self.along * self.seg > 2 * n_sub
            and self.shared_bytes(h, axis, n_consts) <= MAX_SHARED_BYTES
        ):
            raise ValueError(
                f"rdma_band's HO form takes no launch configuration {self} at h = {h}, n_sub = {n_sub}"
            )


#: rdma_band's launch, chosen on the H100 by ``benchmarks.mevp_large
#: --tiles=rdma_band`` at config 5's 2048^2 blocks, h = 16, on the x bands
#: (3h rows along ny columns) and the y bands (nx + 2h rows along, 3h
#: columns) (PERF.md): clusters of 16 blocks of 16 cells along the band, so
#: a pair of bands takes 320 blocks, all resident at once on every SM
#: (the 256-thread launch bound asks for three blocks an SM). One-block
#: tiles of 64 cells (one wave of 128-130 blocks) measured the same within
#: 4% on either axis.
BANDS = BandConfig(16, 16, 256)


#: The HO form's launch configurations: (largest h, fewest cells along the
#: band, configuration), the first row that a band matches. Chosen on the
#: H100 by ``benchmarks.mevp_large --tiles=rdma_band_ho`` on the HO configs'
#: 512^2 and 2048^2 rank blocks at h = 16 and 32 and on 512^2 at h = 64,
#: both axes (PERF.md): at h = 16 the 512^2 blocks' bands stage
#: their consts in clusters of 8 x 2 blocks of 14 x 24 cells, a thread a
#: cell, two blocks an SM (0.091-0.092 ms a pair of bands); the 2048^2
#: blocks' keep the band's first shape (16 x 1 blocks of 16 x 48 cells)
#: with L2 consts, three blocks an SM (every
#: staged shape ran 26-47% slower: its shared memory holds fewer cells an
#: SM); above h = 16 the staged consts cost more than they save, and above
#: h = 32 they do not fit.
HO_BANDS = (
    (16, 1024, HoBandConfig(16, 1, 16, 256, staged=False)),
    (16, 0, HoBandConfig(8, 2, 14, 384)),
    (32, 1024, HoBandConfig(16, 1, 12, 256, staged=False)),
    (32, 0, HoBandConfig(8, 2, 20, 256, staged=False)),
    (MAX_SUB, 0, HoBandConfig(16, 1, 12, 256, staged=False)),
)


def launch_config(axis: int, planes: int = CG1_PLANES, h: int = None, along: int = 0):
    """The launch configuration that the host picks for the bands of
    ``axis``: the CG1 form's ``BANDS`` (the same for both axes: the sweep
    found neither axis better off with another); the HO form's (``planes``
    17) the first row of ``HO_BANDS`` that holds ghost width h and a band
    ``along`` cells long (raises where it does not fit h)."""
    if planes == CG1_PLANES:
        return BANDS
    config = next(c for h_max, along_min, c in HO_BANDS if h <= h_max and along >= along_min)
    config.check(axis, h, h)
    return config


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

    own: tuple  #: the P pre-round (nx, ny) planes: u, v, s11, s22, s12, or the HO round's 17
    h: int  #: ghost width
    split: tuple  #: (x, y): whether each axis is split over ranks
    gx: tuple = None  #: (lo, hi) x ghosts, each (P, h, ny)
    gy: tuple = None  #: (lo, hi) y ghosts, each (P, nx + 2hx, h)
    stream: int = None
    _built: tuple = field(default=None, init=False, repr=False, compare=False)

    @property
    def planes(self) -> int:
        return len(self.own)

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
        p = self.planes
        if p not in (CG1_PLANES, HO_PLANES):
            raise ValueError(f"a round moves {CG1_PLANES} (CG1) or {HO_PLANES} (HO) state planes, not {p}")
        if built is None:
            names = ("u", "v", "s11", "s22", "s12") if p == CG1_PLANES else (f"plane {k}" for k in range(p))
            cc._check((nx, ny), device, **dict(zip(names, self.own)))
        for ghosts, name, shape in (
            (self.gx, "x", (p, self.h, ny)), (self.gy, "y", (p, nx + 2 * self.hx, self.h)),
        ):
            if ghosts is not None:
                cc._check(shape, device, **{f"g{name}_lo": ghosts[0], f"g{name}_hi": ghosts[1]})
        gx = self.gx if self.gx is not None else (None, None)
        gy = self.gy if self.gy is not None else (None, None)
        ptrs = cc._pointers([*self.own, *gx, *gy])
        dims = (ctypes.c_int * 6)(nx, ny, self.h, self.hx, self.hy, p)
        self._built = (self.gx, self.gy, ptrs, dims)
        return ptrs, dims

    def launch_stream(self) -> int:
        return self.stream if self.stream is not None else cc._stream(self.own[0].device)


def _x_extended(src: RoundSources) -> torch.Tensor:
    """(P, nx + 2hx, ny): the pre-round state with the x ghosts above and
    below it."""
    state = torch.stack(src.own)
    if src.gx is None:
        return state
    return torch.cat([src.gx[0], state, src.gx[1]], dim=1)


def rdma_stage_reference(src: RoundSources, axis: int) -> torch.Tensor:
    """The send strips of ``axis`` as a (2, P, ., .) tensor (lo, hi): x, the
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


def subcycles_reference(solver, planes, consts, dt, n_sub):
    """n_sub plain subcycles of ``solver`` on stacked state planes: the 5
    of a CG1 solver (``coupled_cuda.mevp_subcycles_reference``, a tuple of
    planes) or the 17 of an HO solver (``ho_subcycles_reference``, one
    (17, ., .) tensor in ``coupled_cuda.ho_flatten``'s order)."""
    if isinstance(solver, MEVPSolverHO):
        return cc.ho_flatten(ho_subcycles_reference(solver, cc.ho_unflatten(planes), consts, dt, n_sub))
    return cc.mevp_subcycles_reference(solver, tuple(planes), consts, dt, n_sub)


def rdma_band_reference(solver, src: RoundSources, axis: int, consts_w: dict, dt, n_sub, state):
    """n_sub plain subcycles (``solver`` without an exchange: the band
    solver of ``phase_solvers``, periodic along the band where it wraps) on
    the two bands of ``axis``; patches their rows (x) or columns (y) into
    the P planes of ``state`` in place and returns it."""
    h, hx, hy = src.h, src.hx, src.hy
    own = torch.stack(src.own)
    nx, ny = own.shape[1:]
    run = lambda planes, consts: subcycles_reference(solver, planes, consts, dt, n_sub)
    if axis == 0:
        lo = run(torch.cat([src.gx[0], own[:, : 2 * h]], dim=1),
                 _band_consts(consts_w, slice(0, 3 * h), slice(hy, hy + ny)))
        hi = run(torch.cat([own[:, nx - 2 * h:], src.gx[1]], dim=1),
                 _band_consts(consts_w, slice(nx - h, nx + 2 * h), slice(hy, hy + ny)))
        for k in range(src.planes):
            state[k][:h] = lo[k][h: 2 * h]
            state[k][nx - h:] = hi[k][h: 2 * h]
        return state
    ext = _x_extended(src)
    lo = run(torch.cat([src.gy[0], ext[:, :, : 2 * h]], dim=2),
             _band_consts(consts_w, slice(None), slice(0, 3 * h)))
    hi = run(torch.cat([ext[:, :, ny - 2 * h:], src.gy[1]], dim=2),
             _band_consts(consts_w, slice(None), slice(ny - h, ny + 2 * h)))
    for k in range(src.planes):
        state[k][:, :h] = lo[k][hx: hx + nx, h: 2 * h]
        state[k][:, ny - h:] = hi[k][hx: hx + nx, h: 2 * h]
    return state


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
    p = src.planes
    shape = (2, p, h, ny) if axis == 0 else (2, p, nx + 2 * src.hx, h)
    out = torch.empty(shape, device=own.device, dtype=torch.float32)
    cc._launch("rdma_stage", ptrs, dims, axis, out.data_ptr(), own.device.index, src.launch_stream())
    return out


def rdma_band(solver, src: RoundSources, axis: int, consts_w: dict, dt, n_sub, state, config=None):
    """n_sub subcycles on the two bands of ``axis`` and their patches into
    ``state`` (in place; returned), in one launch on CUDA tensors (the
    patch's cone only, in ``config`` or ``launch_config``'s: a
    ``BandConfig`` for a CG1 solver, a ``HoBandConfig`` for an HO one); CPU
    tensors run the plain version. ``solver``: the band solver of ``phase_solvers``
    (its momentum form, its mesh's metric form and its periodic axis along
    the band select the instance): a ``MEVPSolver``, whose ``state`` is 5
    planes, or a ``MEVPSolverHO``, whose ``state`` is one (17, nx, ny)
    tensor (the HO form, ``csrc/mevp_rdma_ho.cu``); ``consts_w``: its
    consts (``mevp.const_names``, ``MEVPSolverHO.const_names``) widened by
    h on each split axis."""
    if cc._on_cpu(src.own[0]):
        return rdma_band_reference(solver, src, axis, consts_w, dt, n_sub, state)
    ho = isinstance(solver, MEVPSolverHO)
    mesh = solver.mesh
    planes = HO_PLANES if ho else CG1_PLANES
    if not ho:
        _check_const_names(const_names(solver.params.a_weighted_stress, mesh.uniform), consts_w)
    if src.planes != planes:
        raise ValueError(f"this solver's round moves {planes} state planes, not {src.planes}")
    if not src.split[axis]:
        raise ValueError(f"axis {axis} is not split over ranks: it has no bands")
    wrap = mesh.periodic_y if axis == 0 else mesh.periodic_x
    if (mesh.periodic_x if axis == 0 else mesh.periodic_y) or (wrap and src.split[1 - axis]):
        raise ValueError(
            "a band wraps only along an axis not split over ranks, and never across itself"
        )
    h = src.h
    nx, ny = src.own[0].shape
    if not 1 <= n_sub <= min(h, MAX_SUB) or (nx if axis == 0 else ny) < 2 * h:
        raise ValueError(f"a round needs n_sub <= h = {h} and a block of at least 2h along axis {axis}")
    along = band_shape(axis, h, nx, ny, src.hx)[1 - axis]
    config = launch_config(axis, planes, h, along) if config is None else config
    if ho != isinstance(config, HoBandConfig):
        raise ValueError(f"rdma_band's {'HO' if ho else 'CG1'} form takes no {type(config).__name__}")
    if ho:
        config.check(axis, h, n_sub, len(consts_w))
    else:
        config.check(axis, h, n_sub)
    form = cc.kernel_form(solver)
    if not ho and (form or not mesh.uniform) and config.threads > LAUNCH_BOUNDS[0]:
        raise ValueError(
            f"rdma_band's forms are built for blocks of at most {LAUNCH_BOUNDS[0]} threads, "
            f"not {config.threads}"
        )
    ptrs, dims = src.c_args(need_gx=src.split[0], need_gy=axis == 1)
    device = src.own[0].device
    wide = (nx + 2 * src.hx, ny + 2 * src.hy)
    cone = _cone_array(axis, h, n_sub, nx, ny, src.hx, wrap)
    if ho:  # the host arrays stay alive until the call returns
        consts = _ho_band_consts(solver, consts_w, wide, device)
        cc._check((HO_PLANES, nx, ny), device, state=state)
        lo, plane = state.data_ptr(), nx * ny * 4
        if any(p < lo + HO_PLANES * plane and p + plane > lo for p in ptrs[:HO_PLANES]):
            raise ValueError("rdma_band reads the pre-round planes: state must not alias them")
        scalars, tables = cc._ho_scalars(solver, dt), cc._ho_tables(solver)
        cc._launch(
            "rdma_band", ptrs, dims, axis, consts, config.along, config.across, config.seg, config.threads,
            int(config.staged), config.clusters(along, n_sub), cone, n_sub, lo, ctypes.addressof(scalars),
            ctypes.addressof(tables), form, device.index, src.launch_stream(), entry="rdma_band_ho",
        )
        return state
    cc._check(wide, device, **consts_w)
    cc._check((nx, ny), device, **dict(zip(("u", "v", "s11", "s22", "s12"), state)))
    if {t.data_ptr() for t in state} & {t.data_ptr() for t in src.own}:
        raise ValueError("rdma_band reads the pre-round planes: state must not alias them")
    scalars = cc._mevp_scalars(solver, dt)
    cc._launch(
        "rdma_band", ptrs, dims, axis, cc._mevp_consts(consts_w), config.cluster, config.seg, config.threads,
        config.clusters(along, n_sub), cone, n_sub, cc._pointers(state), ctypes.addressof(scalars),
        int(not mesh.uniform), form, device.index, src.launch_stream(),
    )
    return state


def _check_const_names(expected, consts_w: dict) -> None:
    if tuple(sorted(consts_w)) != tuple(sorted(expected)):
        raise NotImplementedError(
            f"rdma_band takes the consts {tuple(sorted(expected))} for this solver, "
            f"got {tuple(sorted(consts_w))}"
        )


class _LastHoConsts(threading.local):
    """A rank thread's last widened HO consts: the dict's identity and its
    shape and device, weak references to its planes, and their HoConsts
    pointer array. A step's rounds launch their bands with one dict, so
    each rank checks and packs its consts once a step."""

    key = None
    refs = ()
    ptrs = None


_LAST_HO_CONSTS = _LastHoConsts()


def _ho_band_consts(solver: MEVPSolverHO, consts_w: dict, shape: tuple, device):
    """The HoConsts pointer array of ``consts_w``, the solver's const set
    widened to ``shape`` on ``device``: checked and packed once per dict
    (the same planes, by identity), then from the thread's last entry."""
    last = _LAST_HO_CONSTS
    expected = solver.const_names()
    key = (id(consts_w), shape, device, expected)
    values = tuple(consts_w.values())
    if last.key == key and len(last.refs) == len(values) and all(r() is v for r, v in zip(last.refs, values)):
        return last.ptrs
    _check_const_names(expected, consts_w)
    cc._check(shape, device, **consts_w)
    last.key, last.refs, last.ptrs = key, tuple(weakref.ref(v) for v in values), cc._ho_consts(consts_w)
    return last.ptrs


def max_clusters(device, axis: int, h: int, config, planes: int = CG1_PLANES, form: int = 0) -> int:
    """Clusters of ``config`` that the card holds at once for the bands of
    ``axis`` at ghost width h (``cudaOccupancyMaxActiveClusters``; 0 where
    none fits), of the CG1 form (a ``BandConfig``) or (``planes`` 17, a
    ``HoBandConfig``) the HO form of ``form`` (kHoWeighted, kHoMetric)."""
    device = torch.device(device)
    lib = cc._library()
    if planes == CG1_PLANES:
        clusters = lib.nst_rdma_band_max_clusters(
            axis, 3 * h, config.cluster, config.seg, config.threads, device.index or 0)
    else:
        clusters = lib.nst_rdma_band_ho_max_clusters(
            axis, 3 * h, config.along, config.across, config.seg, config.threads, form, int(config.staged),
            device.index or 0)
    if clusters < 0:
        raise RuntimeError(f"rdma_band occupancy: CUDA error {-1 - clusters}")
    return clusters


def phase_solvers(solver, split) -> tuple:
    """(interior, x bands, y bands): ``solver`` (the rank's ``MEVPSolver``
    or ``MEVPSolverHO`` without an exchange, its mesh the block's with the
    global periodic axes) on the
    periodic axes of each phase of a round whose axes ``split`` (x, y) are
    split over ranks. A split axis is closed in every phase (its ring is
    the exchange's); an axis of one rank that is periodic wraps in the
    interior pass and along the bands of the other axis; a band never
    wraps across itself."""
    mesh = solver.mesh
    wx, wy = mesh.periodic_x and not split[0], mesh.periodic_y and not split[1]

    def on(periodic):
        if periodic == (mesh.periodic_x, mesh.periodic_y):
            return solver
        return type(solver)(block_mesh(mesh.nx, mesh.ny, mesh, periodic), solver.params)

    return on((wx, wy)), on((False, wy)), on((wx, False))


def _round(solver, carry, consts, consts_w, dt, n_sub, h, axes, stage, band, interior, **sources):
    """The steps of the module docstring with the given primitives;
    ``sources``: the ``stream`` of the round's RoundSources."""
    ax_x, ax_y = axes
    src = RoundSources(own=tuple(carry), h=h, split=(ax_x is not None, ax_y is not None), **sources)
    solver, x_bands, y_bands = phase_solvers(solver, src.split)
    if ax_x is not None:
        send = stage(src, 0)
        x_handle = ax_x.start(send[0], send[1])
    elif ax_y is not None:
        send = stage(src, 1)
        y_handle = ax_y.start(send[0], send[1])
    state = interior(solver, carry, consts, dt, n_sub)
    if ax_x is not None:
        src.gx = ax_x.wait(x_handle)
        if ax_y is not None:
            send = stage(src, 1)
            y_handle = ax_y.start(send[0], send[1])
        state = band(x_bands, src, 0, consts_w, dt, n_sub, state)
    if ax_y is not None:
        src.gy = ax_y.wait(y_handle)
        state = band(y_bands, src, 1, consts_w, dt, n_sub, state)
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


def ho_interior(solver: MEVPSolverHO, carry, consts, dt, n_sub) -> torch.Tensor:
    """The HO round's interior pass on the (17, nx, ny) state: the HO
    solver's single-device rule (``MEVPSolverHO.subcycles``: ho_tiled, or
    ho_single below ``HO_SINGLE_MAX_ELEMENTS`` where the card holds the
    block; the plain subcycle on the CPU), into a fresh tensor."""
    return cc.ho_flatten(solver.subcycles(cc.ho_unflatten(carry), consts, dt, n_sub))


def mevp_round_rdma_reference(solver, carry, consts, consts_w, dt, n_sub, h, axes):
    """One round on the plain subcycle, on any device. ``solver``: the
    rank's solver without an exchange (``MEVPSolver.local()`` or
    ``MEVPSolverHO.local()``: the global periodic axes, which
    ``phase_solvers`` applies); ``carry``: the 5 CG1 planes, or the HO
    solver's (17, nx, ny) tensor (``coupled_cuda.ho_flatten``); ``consts``:
    the step's consts; ``consts_w``: the same widened by h on each split
    axis; ``axes``: the (x, y) ``AxisExchange`` of each split axis, None for
    an axis that is not split. Returns the planes after the round, as
    ``carry`` holds them."""
    _check_round(carry, consts_w, n_sub, h, axes)
    return _round(
        solver, carry, consts, consts_w, dt, n_sub, h, axes,
        rdma_stage_reference, rdma_band_reference, subcycles_reference,
    )


def mevp_round_rdma(solver, carry, consts, consts_w, dt, n_sub, h, axes):
    """One round (arguments as ``mevp_round_rdma_reference``): on CUDA
    tensors rdma_stage, the interior pass (mevp_tiled; for the HO solver
    ``ho_interior``) and rdma_band on the rank's compute stream, the strips
    on the exchange's copy streams; CPU tensors run the plain version."""
    if cc._on_cpu(carry[0]):
        return mevp_round_rdma_reference(solver, carry, consts, consts_w, dt, n_sub, h, axes)
    _check_round(carry, consts_w, n_sub, h, axes)
    interior = ho_interior if isinstance(solver, MEVPSolverHO) else mevp_subcycles_tiled
    return _round(
        solver, carry, consts, consts_w, dt, n_sub, h, axes,
        rdma_stage, rdma_band, interior, stream=cc._stream(carry[0].device),
    )
