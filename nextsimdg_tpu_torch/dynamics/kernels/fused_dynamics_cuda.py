"""The whole CG1 dynamics phase in one launch: the ``fused_dynamics`` CUDA kernel.

Counterpart of ``nextsimdg_tpu/dynamics/kernels/coupled_pallas.py``, whose
``fused_dynamics_pallas`` runs N mEVP subcycles, the CG1 -> quadrature
velocity sampling, the CFL substep count k and k limited SSP-RK dG
substeps in one TPU kernel, k computed inside it from the resident final
velocity. Here (``csrc/fused_dynamics.cu``) one cooperative launch does the
same with the grid cut into at most one tile a streaming multiprocessor, as
``mevp_single`` does (``mevp_single_cuda``): each block keeps its tile's 5
state planes, the const planes where they fit, two (rk3: three) buffers of
the 3K tracer planes and the face masks in shared memory for the whole
launch, and passes its edges to its neighbours in tagged words. Every block
reduces the same max speeds and computes the same k, so the substeps need
no host: the phase makes no host sync (``coupled_cuda._k_of_speeds`` copies
the speeds to the host on the split schedules).

Forms (``Form``, ``form_of``): every form of a uniform ``RectMesh`` with the
CG1 ``MEVPSolver`` that the TPU kernel runs (``fused_dynamics_supported``):
each axis closed or periodic, fixed or adaptive alpha, the stresses
A-weighted or not, dG0, dG1 or dG2 with any scheme (rk1, rk2, rk3), the TVB
limiter, face masks or none, ``auto_substeps`` on or off. The headline's
form (closed, fixed alpha, unweighted, dG1 rk2, no TVB) has instances of
its own; the others share ``fused_dynamics_forms_kernel`` (csrc/fused_dynamics.cuh).
A graded or spherical mesh, a rank grid, the HO solver and free drift take
the other schedules (``form_refusal`` says why), and a grid whose tiles
cannot all be resident is refused (``tiling``).

Plain version: ``coupled_cuda.fused_dynamics_reference`` (N x
``subcycle_body``, ``velocity_from_cg``, ``cfl_substeps``, k x
``DGTransport.step``). The kernel runs the bodies of ``mevp_single`` and of
``transport_tiled`` (``dg1_stage_cell``), which equal K1's ``mevp_stress``,
``mevp_velocity`` and ``dg1_rk_stage`` bit for bit, and its speeds equal
``dg1_sample_cfl``'s, so it equals K1's split schedule exactly.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..mevp import UNIFORM_CONSTS
from . import coupled_cuda as cc
from .coupled_cuda import sm_count
from .ho_single_cuda import SHARED_LIMIT
from .mevp_single_cuda import _exact_rows

KERNEL = "fused_dynamics"

#: The plain version.
fused_dynamics_reference = cc.fused_dynamics_reference

#: Threads a block (one block an SM, 128 registers a thread), and tile rows
#: a thread owns, at most; dG2's larger stage body takes at most
#: ``DG2_MAX_THREADS`` (255 registers a thread: csrc/fused_dynamics.cuh
#: FusedShape).
MAX_THREADS, MAX_CELLS = 512, 8
DG2_MAX_THREADS = 256
STATE_PLANES = 5
MASK_PLANES = 2
TRACERS = 3
#: The kernel's static shared memory (the block's reductions), with room.
STATIC_BYTES = 1024
#: The CFL count's ceiling (``substeps_from_speeds``' k_max).
K_MAX = 64


@dataclass(frozen=True)
class Form:
    """What of a dynamics phase the kernel's instance and its shared memory
    depend on: the DG ``degree``, the scheme's RK ``stages`` (rk1-rk3), the
    TVB limiter, the momentum form (``adaptive`` alpha, ``weighted``
    stresses) and the ``periodic`` axes (x, y). ``HEADLINE`` (closed, fixed
    alpha, unweighted, dG1 rk2, no TVB) has instances of its own
    (``fused_dynamics_kernel``); every other form runs
    ``fused_dynamics_forms_kernel``."""

    degree: int = 1
    stages: int = 2
    tvb: bool = False
    adaptive: bool = False
    weighted: bool = False
    periodic: tuple = (False, False)

    @property
    def headline(self) -> bool:
        return self == HEADLINE

    @property
    def planes(self) -> int:
        """A tracer buffer's planes: K coefficients x 3 tracers."""
        return (1, 3, 6)[self.degree] * TRACERS

    @property
    def tracer_planes(self) -> int:
        """The tracer buffers' planes: two, three for rk3."""
        return (3 if self.stages == 3 else 2) * self.planes

    @property
    def const_planes(self) -> int:
        """The const planes resident where they all fit: the 7 uniform ones,
        and a_node in the other forms (ones where the stresses are not
        A-weighted)."""
        return len(UNIFORM_CONSTS) + (0 if self.headline else 1)

    @property
    def max_threads(self) -> int:
        return DG2_MAX_THREADS if self.degree == 2 else MAX_THREADS

    @property
    def l2_consts(self) -> bool:
        """Whether the consts may be read from L2 where they do not fit: not
        at dG2, whose tiles keep them resident (instances reading them from
        L2 would hold 325^2 where these hold 300^2, for twice dG2's build)."""
        return self.degree != 2

    @property
    def masks_always(self) -> bool:
        """Whether the instance reads the face masks with or without a
        coastline (planes of ones without one): every form but the
        headline's."""
        return not self.headline

    def c_form(self):
        """The kernel's form argument (FusedForm of csrc/fused_dynamics.cu):
        degree, TVB, the momentum form's bits, the periodic axes' bits, the
        stages."""
        mevp = cc.FORM_WEIGHTED * self.weighted + cc.FORM_ADAPTIVE * self.adaptive
        wrap = cc.WRAP_X * bool(self.periodic[0]) + cc.WRAP_Y * bool(self.periodic[1])
        return (ctypes.c_int * 5)(self.degree, int(self.tvb), mevp, wrap, self.stages)


HEADLINE = Form()


def form_of(model) -> Form:
    """The ``Form`` of a uniform CG1 model's dynamics phase."""
    params, transport, mesh = model.mevp.params, model.transport, model.mesh
    return Form(
        degree=transport.basis.degree, stages=len(cc._RK_STAGES[transport.scheme]),
        tvb=transport.limits_slopes, adaptive=bool(params.adaptive_alpha),
        weighted=bool(params.a_weighted_stress), periodic=(bool(mesh.periodic_x), bool(mesh.periodic_y)),
    )


@dataclass(frozen=True)
class Tiling:
    """TR x TC tiles (``tile``), ``tiles`` = (along i, along j) of them,
    one block of ``threads`` threads each; ``resident``: the const planes
    kept in shared memory (all of the form's, or 0: read from L2);
    ``masked``: the coastline form (two face-mask planes); ``form``: the
    kernel's ``Form``."""

    tile: tuple
    tiles: tuple
    threads: int
    resident: int
    masked: bool
    form: Form = HEADLINE

    @property
    def n_tiles(self) -> int:
        return self.tiles[0] * self.tiles[1]

    @property
    def shared_bytes(self) -> int:
        return shared_bytes(self.tile, self.resident, self.masked, self.form)

    @property
    def exchange_words(self) -> int:
        """The exchange buffer's 64-bit words: per tile 5 mEVP edges of TR +
        TC, two slots (a stage's parity) of the 3K tracer planes' four edges,
        and the pair of speeds."""
        edge = sum(self.tile)
        return self.n_tiles * (STATE_PLANES * edge + 2 * self.form.planes * 2 * edge + 2)


def shared_bytes(tile, n_consts: int = 0, masked: bool = True, form: Form = HEADLINE) -> int:
    """Dynamic shared memory of one block: the 5 state planes, ``n_consts``
    const planes, the form's tracer buffers and (``masked``) 2 face masks of
    a TR x TC tile, each with a one-cell apron."""
    tr, tc = tile
    planes = STATE_PLANES + n_consts + form.tracer_planes + (MASK_PLANES if masked else 0)
    return planes * (tr + 2) * (tc + 2) * 4


def threads_for(tile, max_threads: int = MAX_THREADS):
    """The threads of a block for a TR x TC tile: as many whole tile rows
    of TC threads as fit ``max_threads`` (and the tile has), in warps; None
    where a thread would own more than 8 rows or a row is wider than that."""
    tr, tc = tile
    if tc > max_threads:
        return None
    rows = min(tr, max_threads // tc)
    if -(-tr // rows) > MAX_CELLS:
        return None
    return -(-rows * tc // 32) * 32


def _fits(tile, masked: bool, form: Form) -> bool:
    consts = 0 if form.l2_consts else form.const_planes
    return (
        threads_for(tile, form.max_threads) is not None
        and shared_bytes(tile, consts, masked, form) <= SHARED_LIMIT - STATIC_BYTES
    )


@lru_cache(maxsize=256)
def tiling(nx: int, ny: int, sms: int, masked: bool = True, form: Form = HEADLINE) -> Tiling:
    """The tiles of an nx x ny grid on a card of ``sms`` SMs for a ``form``:
    at most one an SM, the smallest area (then the shortest edge, then the
    widest rows), as ``mevp_single_cuda.tiling`` picks them, and on a
    periodic axis only tiles that divide it (their ring's last edge is the
    first tile's); the form's consts resident where they all fit beside the
    state and the tracers (at dG2 only such tiles). Every form but the
    headline's takes the masks' planes with or without a coastline. Raises
    ValueError where no tile of at most 8 cells a thread fits a block's
    shared memory with the state and tracers (and the masks): the grid
    cannot be resident."""
    masked = masked or form.masks_always
    px, py = form.periodic
    best = None
    for tc in range(1, ny + 1):
        tiles_j = -(-ny // tc)
        if tiles_j > sms or (tc > 1 and -(-ny // (tc - 1)) == tiles_j) or (py and ny % tc):
            continue  # too many columns, a narrower tile gives as many, or a ragged ring
        tr = -(-nx // (sms // tiles_j))
        if px:
            tr = _exact_rows(nx, tr)
        if tr is None or not _fits((tr, tc), masked, form):
            continue
        key = (tr * tc, tr + tc, -tc)
        if best is None or key < best[0]:
            best = (key, (tr, tc))
    if best is None:
        raise ValueError(
            f"fused_dynamics: the {nx} x {ny} grid does not fit the shared memory and threads of "
            f"{sms} SMs at one tile an SM (at most {MAX_CELLS} cells a thread of {form.max_threads}, "
            f"{SHARED_LIMIT - STATIC_BYTES} B a tile for the state and the tracers of {form})"
        )
    tile = best[1]
    tiles = (-(-nx // tile[0]), -(-ny // tile[1]))
    plane = (tile[0] + 2) * (tile[1] + 2) * 4
    room = SHARED_LIMIT - STATIC_BYTES - shared_bytes(tile, 0, masked, form)
    resident = form.const_planes if room >= form.const_planes * plane else 0
    return Tiling(tile, tiles, threads_for(tile, form.max_threads), resident, masked, form)


@lru_cache(maxsize=256)
def holds(nx: int, ny: int, sms: int, masked: bool = True, form: Form = HEADLINE) -> bool:
    """Whether ``tiling`` takes an nx x ny grid on ``sms`` SMs (cached: the
    schedule asks it every step)."""
    try:
        tiling(nx, ny, sms, masked, form)
    except ValueError:
        return False
    return True


def largest_square(sms: int, masked: bool = True, form: Form = HEADLINE) -> int:
    """The side of the largest square grid fused_dynamics holds on ``sms``
    SMs in ``form`` (on a periodic axis the largest side its tiles divide,
    below which smaller sides may still be refused)."""
    lo, hi = 1, 4096  # holds(lo) and not holds(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if holds(mid, mid, sms, masked, form) else (lo, mid)
    return lo


def form_refusal(model):
    """Why the kernel does not run ``model``'s dynamics phase (a string),
    or None where it does: what the TPU kernel refuses too
    (``fused_dynamics_supported``), a rank grid, the HO solver, free drift
    and a graded or spherical mesh. Every other form has an instance."""
    if model.exchange is not None:
        return "a rank grid runs the exchange schedules"
    if model.is_high_order:
        return "the HO solver runs ho_single or ho_tiled"
    if model.is_free_drift:
        return "free drift runs its plain step"
    if not model.mesh.uniform:
        return "a graded or spherical mesh runs mevp_single or mevp_tiled"
    return None


def holds_model(model, sms: int) -> bool:
    """Whether the kernel runs ``model``'s dynamics phase on a card of
    ``sms`` SMs: its form (``form_refusal``) and its grid (``holds``)."""
    if form_refusal(model) is not None:
        return False
    mesh = model.mesh
    return holds(mesh.nx, mesh.ny, sms, model.ocean_mask is not None, form_of(model))


def cfl_floats(dt: float, mesh, degree: int = 1):
    """(dt, min dx, min dy, c_stab) rounded to float32, as PyTorch on the
    CPU rounds a Python scalar that ``substeps_from_speeds`` divides or
    multiplies a float32 tensor by."""
    c_stab = 0.85 / (2 * degree + 1)
    dx_min = float(np.min(np.asarray(mesh.dx)))
    dy_min = float(np.min(np.asarray(mesh.dy)))
    return tuple(np.float32(x) for x in (dt, dx_min, dy_min, c_stab))


def substeps_plain(speed_x, speed_y, dt: float, mesh, degree: int = 1, k_floor: int = 1,
                   k_max: int = K_MAX):
    """The kernel's k arithmetic (``fused_substeps`` of
    csrc/fused_dynamics.cuh) in numpy, elementwise on float32 speeds: nu =
    (speed_x / dx + speed_y / dy) dt, k = ceil(nu / c_stab), each operation
    float32; the conversion to int32 gives INT_MIN for NaN and out of range
    (as x86 converts); then clamped to k_floor, to [1, k_max]. Returns an
    int32 array of the speeds' shape."""
    dt_f, dx_min, dy_min, c_stab = cfl_floats(dt, mesh, degree)
    sx = np.asarray(speed_x, dtype=np.float32)
    sy = np.asarray(speed_y, dtype=np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        nu = (sx / dx_min + sy / dy_min) * dt_f
        q = np.ceil(nu / c_stab)
        inside = (q >= np.float32(-2.0**31)) & (q < np.float32(2.0**31))
        k = np.where(inside, q, np.float32(-2.0**31)).astype(np.int64)
    return np.clip(np.maximum(k, k_floor), 1, k_max).astype(np.int32)


def ceil_boundary_speeds(dt: float, mesh, degree: int = 1, seed: int = 0, ulps: int = 4):
    """(n, 2) float32 (speed_x, speed_y) pairs that hold a k computation to
    the host's: for each k up to K_MAX + 6, speeds whose nu / c_stab lands
    within ``ulps`` float32 ulps of k (along x, along y and split between
    them), then 500 seeded pairs, zero, and speeds far beyond K_MAX."""
    c_stab = 0.85 / (2 * degree + 1)
    dx = float(np.min(np.asarray(mesh.dx)))
    pairs = []
    for k in range(1, K_MAX + 7):
        speed = np.float32(k * c_stab * dx / dt)
        for _ in range(ulps):
            speed = np.nextafter(speed, np.float32(0))
        for _ in range(2 * ulps + 1):
            half = np.float32(speed / 2)
            pairs += [(speed, 0.0), (0.0, speed), (half, np.float32(speed - half))]
            speed = np.nextafter(speed, np.float32(np.inf))
    rng = np.random.default_rng(seed)
    pairs += list(zip(rng.uniform(0.0, 2.0, 500), rng.uniform(0.0, 2.0, 500)))
    pairs += [(0.0, 0.0), (1e3, 0.0), (0.0, 3e4)]
    return np.asarray(pairs, dtype=np.float32)


def _plain_info(model, carry, dt: float) -> torch.Tensor:
    """(speed_x, speed_y, k) of the plain phase's final velocity."""
    from ..transport import max_speeds, velocity_from_cg

    qv = velocity_from_cg(model.mesh, model.transport.basis, carry[0], carry[1])
    speeds = torch.stack(max_speeds(qv))
    k = cc._substeps(model, qv, dt)
    return torch.cat([speeds, torch.tensor([k], dtype=speeds.dtype)])


#: A plane of ones a (device, shape): the a_node of the forms' kernel where
#: the stresses are not A-weighted (c_w * 1 is c_w), and its face masks
#: where there is no coastline (a flux times 1 is the flux).
_ONES = {}


def _ones(device, shape) -> torch.Tensor:
    key = (device, tuple(shape))
    if key not in _ONES:
        _ONES[key] = torch.ones(shape, device=device, dtype=torch.float32)
    return _ONES[key]


def _rk(transport, device):
    """The stages' blends a[3], b[3] (``coupled_cuda._RK_STAGES``, padded)
    and the TVB tolerances M dx^2, M dy^2 as float32 (0 without TVB): the
    kernel's rk argument."""
    stages = cc._RK_STAGES[transport.scheme]
    pad = ((0.0, 0.0),) * (3 - len(stages))
    a, b = zip(*(stages + pad))
    tol = transport.tvb_tolerances(device=device, dtype=torch.float32) if transport.limits_slopes else (0.0, 0.0)
    return cc._floats((*a, *b, *tol))


def fused_dynamics_single(model, carry, tracers, consts: dict, dt: float, n_subcycles: int,
                          face_masks=None):
    """((u, v, s11, s22, s12), tracers, info) after one dynamics phase;
    ``info``: (speed_x, speed_y, k) of the phase, for the checks (nothing
    on the step reads it).

    Raises ValueError for a model whose form the kernel does not run
    (``form_refusal``), on any device. CPU tensors then run the plain
    version (``fused_dynamics_reference``, and the info from its final
    velocity); CUDA tensors (float32, contiguous) one cooperative launch of
    ``fused_dynamics`` in the model's ``Form``, the state in place on copies
    of ``carry``, the tracers into a new tensor: no host sync. A grid whose
    tiles cannot all be resident raises ValueError (``tiling``)."""
    refusal = form_refusal(model)
    if refusal is not None:
        raise ValueError(f"fused_dynamics: {refusal}; the split schedules run it")
    if cc._on_cpu(tracers):
        final, out = fused_dynamics_reference(model, carry, tracers, consts, dt, n_subcycles, face_masks)
        return final, out, _plain_info(model, final, dt)
    if n_subcycles < 0:
        raise ValueError(f"n_subcycles must be >= 0, got {n_subcycles}")
    solver, transport, mesh = model.mevp, model.transport, model.mesh
    cc._check_mevp(solver, carry, consts)
    device, shape = tracers.device, (mesh.nx, mesh.ny)
    cc._check((transport.basis.n_dofs, TRACERS, *shape), device, tracers=tracers)
    if face_masks is not None:
        cc._check(shape, device, face_x=face_masks[0], face_y=face_masks[1])
    form = form_of(model)
    config = tiling(*shape, sm_count(device), face_masks is not None, form)
    if not form.headline and "a_node" not in consts:
        consts = {**consts, "a_node": _ones(device, shape)}
    if form.masks_always and face_masks is None:
        face_masks = (_ones(device, shape),) * 2
    planes = tuple(t.clone() for t in carry)
    out = torch.empty_like(tracers)
    info = torch.empty(3, device=device, dtype=torch.float32)
    words = torch.zeros(config.exchange_words, device=device, dtype=torch.int64)
    faces = (None, None) if face_masks is None else (face_masks[0].data_ptr(), face_masks[1].data_ptr())
    k_fixed = 0 if model.auto_substeps else model.transport_substeps
    cfl = cc._floats(cfl_floats(dt, mesh, transport.basis.degree))
    scalars, tables = cc._mevp_scalars(solver, dt), cc._dg1_tables(transport)
    c_form, rk = form.c_form(), _rk(transport, device)
    cc._launch(
        KERNEL, *(t.data_ptr() for t in planes), words.data_ptr(), cc._mevp_consts(consts),
        tracers.data_ptr(), out.data_ptr(), *faces, info.data_ptr(), *shape, n_subcycles,
        *config.tile, *config.tiles, config.threads, config.resident, float(dt), k_fixed,
        model.transport_substeps, K_MAX, ctypes.addressof(cfl), ctypes.addressof(scalars),
        ctypes.addressof(tables), ctypes.addressof(c_form), ctypes.addressof(rk), device.index,
        cc._stream(device),
    )
    return planes, out, info


def max_blocks(device, config: Tiling) -> int:
    """The most blocks of ``config``'s shape and form that can be resident
    at once."""
    device = torch.device(device)
    c_form = config.form.c_form()
    count = cc._library().nst_fused_dynamics_max_blocks(
        config.resident, int(config.masked), *config.tile, config.threads, ctypes.addressof(c_form),
        device.index or 0,
    )
    if count <= 0:
        raise RuntimeError(f"fused_dynamics: no resident blocks (CUDA error {-count})")
    return count


def shared_bytes_on_card(config: Tiling) -> int:
    """The kernel's own count of ``config``'s dynamic shared memory (the
    check of ``shared_bytes``)."""
    c_form = config.form.c_form()
    return cc._library().nst_fused_dynamics_shared_bytes(
        *config.tile, config.resident, int(config.masked), ctypes.addressof(c_form),
    )


def substeps_on_card(speeds: torch.Tensor, dt: float, mesh, degree: int = 1, k_floor: int = 1,
                     k_max: int = K_MAX) -> torch.Tensor:
    """k of each row of the (n, 2) float32 CUDA tensor ``speeds`` by the
    kernel's own device function (``fused_substeps``), as an int32 tensor:
    the check of ``substeps_plain`` and the host's k on the card."""
    speeds = speeds.contiguous()
    cc._check((speeds.shape[0], 2), speeds.device, speeds=speeds)
    k = torch.empty(speeds.shape[0], device=speeds.device, dtype=torch.int32)
    cfl = cc._floats(cfl_floats(dt, mesh, degree))
    err = cc._library().nst_fused_substeps(
        speeds.data_ptr(), k.data_ptr(), speeds.shape[0], float(dt), 0, k_floor, k_max,
        ctypes.addressof(cfl), speeds.device.index, cc._stream(speeds.device),
    )
    if err != 0:
        raise RuntimeError(f"fused_substeps: CUDA error {err}")
    return k
