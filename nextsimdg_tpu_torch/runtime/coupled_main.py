"""The command-line entry point of the coupled dynamics + thermodynamics model.

The port's counterpart of ``nextsimdg_tpu.runtime.coupled_main``, configured
from INI files and the command line with the same keys, defaults and
meaning:

    [model]
    start = 0
    stop = 86400
    time_step = 600
    nlayers = 1                     # ice temperature layers (3: Winton)
    init_file =                     # resume from a coupled checkpoint
    checkpoint_period = 0           # steps between coupled checkpoints
    checkpoint_pattern = coupled.{step}.chk
    diagnostics_file =              # optional HDF5 time-series output
    diagnostics_period = 0
    health_period = 0               # steps between NaN/Inf state probes
    on_nonfinite = abort            # abort | retry-halved (one dt/2
                                    # replay of the failed segment)

    [dynamics]
    nx = 256
    ny = 256
    dx = 2000.0
    dy = 2000.0
    degree = 1                      # DG degree: 0, 1 or 2
    subcycles = 100
    transport_substeps = 1          # advection sub-step floor per model step
    auto_substeps = true            # CFL-adaptive sub-step count (per step)
    tvb_m =                         # TVB slope limiter constant (unset: off)
    thermo = true
    forcing = constant              # constant | cyclone (native engine)
                                    # | archive:<forcing.h5> | era5:<era5.nc>
    era5_archive = era5_forcing.h5  # where era5: writes its regridded archive
    wind = 15.0                     # constant mode / cyclone vmax
    geometry = cartesian            # cartesian | spherical (lon-lat metric)
    lat0 = 70.0                     # spherical mesh extent / era5 box
    lat1 = 80.0
    lon0 = 0.0
    lon1 = 20.0
    periodic_x = auto               # auto | true | false; 'auto' wraps a
                                    # full 360-degree spherical ring
    land_mask =                     # '' | synthetic | <mask.npy> (1=ocean)
    a_weighted_stress = false       # A-weighted surface stresses
    a_dyn_min = 0.05
    adaptive_alpha = false          # aEVP-style per-node alpha (CG1 solver)
    alpha_min = 150.0
    c_stab = 6.2832

    [parallel]
    mode = auto                     # auto | single | shardmap
    mesh_shape =                    # e.g. 4x2 (default: pick_mesh_shape)
    mevp_backend = auto             # auto | blocked | rdma | xla
    mevp_block_halo = auto          # ghost width
    transport_backend = auto        # auto | tiled | xla

and ``[Modules]`` selections (``Nextsim::IDynamics = Nextsim::MEVPHighOrder``
for the CG2/dG1 solver, ``Nextsim::IThermodynamics =
Nextsim::ThermoWinton`` ...).

File forcing: ``archive:<file>`` runs from a forcing archive
(``io.forcing_file``), ``era5:<file>`` first decodes and regrids an ERA5
file onto the mesh's element centres (``mesh.lonlat_centers()`` on a
spherical mesh, else ``lonlat_box`` of lat0..lat1, lon0..lon1) into the
archive ``dynamics.era5_archive`` (``io.era5``). Both the physics and the
dynamics forcing are then the archive's, interpolated in time at the start
of every step (the half steps of a dt/2 replay included) by a
``ForcingProvider`` on the run's device; it keeps the two bracketing records
there and blends them on the device.

Run: ``python -m nextsimdg_tpu_torch.runtime.coupled_main --config-file
run/box.cfg``. The run is on the CUDA card in float32 unless ``--cpu`` or
``--float64`` say otherwise (or a caller passes ``device`` and ``dtype``);
without a card and without ``--cpu`` it returns 2. Every tensor of the run
lives on that device; the cyclone's fields are copied there once a step,
an archive's records when the step enters their interval.

``[parallel]`` maps onto the port's rank grid (``parallel.RankGrid``):
``single`` steps one ``CoupledModel``; ``shardmap`` splits the domain into
``mesh_shape`` rank blocks (``pick_mesh_shape`` of the CUDA devices, or of
1 with ``--cpu``, when unset), each rank a thread on its device (all on the
one device unless there is a card per rank), and steps the blocks in place
(``ShardedCoupledModel.run_blocks``); the state is gathered only for a
checkpoint, a diagnostics row, a post-mortem and the end. ``auto`` is
``single`` on one device and ``shardmap`` over several. The JAX package's
``gspmd`` (its auto-partitioned path) has no counterpart in the port and
raises ``ValueError``.

Failure detection (``runtime/health.py``): with ``health_period`` > 0 the
state is probed for NaN/Inf every that many steps. A failed probe either
aborts (writing ``coupled_failed.post_mortem.chk`` with the poisoned state
and ``coupled_restart.chk`` with the last healthy one) or, with
``on_nonfinite = retry-halved``, replays the failed segment once at dt/2
(not with the streaming cyclone forcing, which cannot rewind: there it
aborts; a forcing archive rewinds, so a file-forced run replays). The
monitor keeps a device-side clone of the last healthy state:
one more copy of the state in the card's memory (1.1 GB for an HO state at
16M elements in float32) and one device copy of it at every healthy probe
(about 0.7 ms of HBM time at that size on an H100). Unlike the JAX
package's CLI, a checkpoint or diagnostics row that falls due at a step
that was not just probed is probed first (a failed probe there acts as at
a probe step), so no cadence file ever holds an unprobed state, and
``on_nonfinite`` is validated when the config is read, whatever
``health_period`` is.

Checkpoints are fetched to host arrays on the main thread (one batched copy)
and written by one writer thread while stepping goes on; the final
``coupled_restart.chk`` is written at the end, also when the run fails. The
files need h5py.
"""

from __future__ import annotations

import dataclasses
import enum
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import torch

from ..config import CommandLineParser, Configurator, Configured, ConfiguredModule
from ..config.enum_map import EnumWrapper
from ..io import coupled_restart, diagnostics
from ..modules import get_loader
from ..utils.logged import Logged
from ..utils.timer import main_timer
from .health import ON_NONFINITE, HealthMonitor, NonFiniteStateError


class Geometry(enum.Enum):
    CARTESIAN = "cartesian"
    SPHERICAL = "spherical"


#: Config-text -> enum converter for ``dynamics.geometry`` (an unmapped
#: token raises, as EnumWrapper.hpp:58-112's validation_error).
_GEOMETRY = EnumWrapper(
    Geometry,
    {"cartesian": Geometry.CARTESIAN, "spherical": Geometry.SPHERICAL},
)

PARALLEL_MODES = ("auto", "single", "gspmd", "shardmap")
#: The diagnostics file's fields: each tracer's cell mean, sst and sss.
DIAGNOSTIC_FIELDS = ("hice", "cice", "hsnow", "sst", "sss")
#: The physics forcing of every run (the JAX CLI's constants).
PHYSICS_FORCING = {
    "tair": -10.0, "dew2m": -12.0, "pair": 1e5, "sw_in": 10.0, "lw_in": 250.0,
    "mld": 10.0, "snowfall": 1e-4,
}


def cyclone_forcing(fields: dict, *, device, dtype):
    """The ``DynamicsForcing`` of one step of the cyclone pipeline
    (``ForcingPipeline.next_fields``): the four float64 planes rounded to
    ``dtype`` into one host buffer, then one copy to ``device``. For a card
    the buffer is pinned and the copy asynchronous: a copy from pageable
    memory would hold the host until the card had finished the previous
    step."""
    from ..dynamics.mevp import DynamicsForcing
    from ..io.forcing_pipeline import CYCLONE_FIELDS

    device = torch.device(device)
    shape = (len(CYCLONE_FIELDS), *fields[CYCLONE_FIELDS[0]].shape)
    host = torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")
    view = host.numpy()
    for i, name in enumerate(CYCLONE_FIELDS):
        view[i] = fields[name]  # rounds to nearest, as astype does
    planes = host.to(device, non_blocking=True).unbind(0)
    return DynamicsForcing(**dict(zip(CYCLONE_FIELDS, planes)))


class _Domain:
    """The run's state on one device (a ``CoupledState``) or on a rank grid
    (its resident blocks, a list), and what the loop does with either."""

    def __init__(self, model, sharded, phys_forcing, do_thermo: bool, device) -> None:
        self.model = model
        self.sharded = sharded
        self.grid = None if sharded is None else sharded.grid
        self.device = device
        self.do_thermo = do_thermo
        self.phys = self.place(phys_forcing)
        self.dyn = None

    def place(self, tree):
        """A global tree as the loop holds it: itself, or its rank blocks."""
        return tree if self.grid is None else self.grid.split_tree(tree)

    def set_dynamics_forcing(self, dyn) -> None:
        self.dyn = self.place(dyn)

    def set_physics_forcing(self, phys) -> None:
        self.phys = self.place(phys)

    def step(self, state, dt: float):
        if self.grid is None:
            return self.model.step(state, self.phys, self.dyn, dt, do_thermo=self.do_thermo)
        return self.sharded.run_blocks(state, self.phys, self.dyn, dt, 1, do_thermo=self.do_thermo)

    def global_state(self, state):
        return state if self.grid is None else self.grid.gather_tree(state, device=self.device)

    def fetch(self, state) -> dict:
        """The global state as host numpy leaves (one batched copy)."""
        return coupled_restart.fetch_coupled_state(self.global_state(state))

    def diagnostic_fields(self, state) -> dict:
        """The diagnostics row's five planes on the host (one copy)."""

        def planes(s):
            return [s.hice[0], s.cice[0], s.hsnow[0], s.sst, s.sss]

        if self.grid is None:
            stacked = torch.stack(planes(state))
        else:
            per_rank = [planes(block) for block in state]
            stacked = torch.stack([
                self.grid.gather([p[i] for p in per_rank], device=self.device)
                for i in range(len(DIAGNOSTIC_FIELDS))
            ])
        return dict(zip(DIAGNOSTIC_FIELDS, stacked.cpu().numpy()))


def _parse_shape(raw: str):
    return tuple(int(s) for s in raw.lower().split("x")) if raw else None


@dataclasses.dataclass
class CoupledSetup:
    """What the registered config sets up for a run (``configure_coupled``):
    the cadences, the model (and on a rank grid the ``ShardedCoupledModel``),
    the initial global state on the run's device, the physics forcing, and
    the dynamics forcing (None with the cyclone, whose pipeline
    ``open_pipeline`` starts; with a forcing archive both are the
    ``provider``'s at ``start``, and the run refreshes them every step)."""

    start: float
    stop: float
    dt: float
    checkpoint_period: int
    checkpoint_pattern: str
    diag_file: str
    diag_period: int
    health_period: int
    on_nonfinite: str
    do_thermo: bool
    model: object
    sharded: object
    state: object
    phys_forcing: object
    dyn_forcing: object
    cyclone: Optional[dict]
    provider: object
    device: torch.device
    dtype: torch.dtype

    @property
    def n_steps(self) -> int:
        return int(round((self.stop - self.start) / self.dt)) if self.dt else 0

    def open_pipeline(self):
        """The cyclone's forcing pipeline, started; None with constant forcing."""
        if self.cyclone is None:
            return None
        from ..io.forcing_pipeline import ForcingPipeline

        return ForcingPipeline.cyclone(**self.cyclone)


def apply_config(argv: Sequence[str]) -> CommandLineParser:
    """Register ``argv``'s command line and config files with the port's
    Configurator, register every module, and apply the config's
    ``[Modules]`` selections (the caller clears both when done)."""
    Configurator.set_command_line(argv)
    cmd_line = CommandLineParser(argv)
    Configurator.add_files(cmd_line.get_config_file_names())
    from .. import dynamics, grid, physics  # noqa: F401  (their modules register)

    get_loader().set_all_defaults()
    ConfiguredModule.parse_configurator()
    return cmd_line


def configure_coupled(*, device, dtype) -> CoupledSetup:
    """A ``CoupledSetup`` from the registered config (``apply_config``), on
    ``device`` in ``dtype``."""
    from ..coupled import CoupledModel
    from ..dynamics import MEVPParams, RectMesh
    from ..dynamics.mevp import DynamicsForcing
    from ..parallel import RankGrid, pick_mesh_shape, shardmap
    from ..state import Forcing

    device = torch.device(device)
    get = Configured.get_configuration
    on_nonfinite = str(get("model.on_nonfinite", "abort"))
    # Validated whatever health_period is (the JAX package's CLI checks it only
    # when health is on: a typo surfaced only when a later run enabled it).
    if on_nonfinite not in ON_NONFINITE:
        raise ValueError(
            f"unknown model.on_nonfinite '{on_nonfinite}': one of {', '.join(ON_NONFINITE)}"
        )
    nx = int(get("dynamics.nx", 256))
    ny = int(get("dynamics.ny", 256))
    dx = float(get("dynamics.dx", 2000.0))
    dy = float(get("dynamics.dy", 2000.0))
    dt = float(get("model.time_step", 600.0))
    tvb_m_raw = get("dynamics.tvb_m", "")
    forcing_mode = get("dynamics.forcing", "constant")
    wind = float(get("dynamics.wind", 15.0))
    geometry = _GEOMETRY(get("dynamics.geometry", "cartesian"))
    lat0 = float(get("dynamics.lat0", 70.0))
    lat1 = float(get("dynamics.lat1", 80.0))
    lon0 = float(get("dynamics.lon0", 0.0))
    lon1 = float(get("dynamics.lon1", 20.0))
    land_mask_spec = get("dynamics.land_mask", "")
    init_file = get("model.init_file", "")

    # A 360-degree span is a ring: the wrap defaults on there, and
    # dynamics.periodic_x overrides either way.
    ring = abs((lon1 - lon0) - 360.0) < 1e-9
    periodic_raw = str(get("dynamics.periodic_x", "auto")).lower()
    if periodic_raw == "auto":
        periodic_x = ring and geometry is Geometry.SPHERICAL
    else:
        periodic_x = periodic_raw in ("1", "true", "yes", "on")
    if geometry is Geometry.SPHERICAL:
        from ..dynamics.mesh import SphericalMesh

        mesh = SphericalMesh(
            nx=nx, ny=ny, lon0=lon0, lon1=lon1, lat0=lat0, lat1=lat1, periodic_x=periodic_x,
        )
    else:
        mesh = RectMesh(nx=nx, ny=ny, dx=dx, dy=dy, periodic_x=periodic_x)
    ocean_mask = None
    if land_mask_spec:
        from ..dynamics.landmask import load_ocean_mask

        ocean_mask = load_ocean_mask(land_mask_spec, nx, ny)
    model_kwargs = dict(
        degree=int(get("dynamics.degree", 1)),
        mevp_params=MEVPParams(
            a_weighted_stress=bool(get("dynamics.a_weighted_stress", False)),
            a_dyn_min=float(get("dynamics.a_dyn_min", 5e-2)),
            adaptive_alpha=bool(get("dynamics.adaptive_alpha", False)),
            alpha_min=float(get("dynamics.alpha_min", 150.0)),
            c_stab=float(get("dynamics.c_stab", 6.2832)),
        ),
        n_subcycles=int(get("dynamics.subcycles", 100)),
        transport_substeps=int(get("dynamics.transport_substeps", 1)),
        auto_substeps=bool(get("dynamics.auto_substeps", True)),
        tvb_m=float(tvb_m_raw) if str(tvb_m_raw) != "" else None,
        ocean_mask=ocean_mask,
    )
    model = CoupledModel(mesh, **model_kwargs)

    par_mode = str(get("parallel.mode", "auto"))
    if par_mode not in PARALLEL_MODES:
        raise ValueError(f"unknown parallel.mode '{par_mode}'")
    if par_mode == "gspmd":
        raise ValueError(
            "parallel.mode = gspmd is the JAX package's auto-partitioned path, which the port "
            "does not have: its multi-device form is parallel.mode = shardmap"
        )
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    if par_mode == "auto":
        par_mode = "shardmap" if n_dev > 1 else "single"
    sharded = None
    if par_mode == "shardmap":
        shape = _parse_shape(str(get("parallel.mesh_shape", ""))) or pick_mesh_shape(n_dev, nx, ny)
        # A card per rank where there are as many; else every rank on the
        # one device (ranks are threads).
        devices = (
            [torch.device("cuda", i) for i in range(n_dev)]
            if device.type == "cuda" and n_dev > 1 and shape[0] * shape[1] == n_dev else device
        )
        halo_raw = str(get("parallel.mevp_block_halo", "auto"))
        _, sharded = shardmap.build_sharded_coupled_model(
            mesh, RankGrid(shape[0], shape[1], devices),
            mevp_backend=str(get("parallel.mevp_backend", "auto")),
            mevp_block_halo="auto" if halo_raw == "auto" else int(halo_raw),
            transport_backend=str(get("parallel.transport_backend", "auto")),
            **model_kwargs,
        )
        Logged.info(f"Rank grid {shape[0]}x{shape[1]} of {nx // shape[0]}x{ny // shape[1]} blocks")

    # The physics' modules and keys are resolved now, while the config's
    # selections are registered: the setup steps as configured whatever the
    # registry holds later.
    for m in [model] + ([] if sharded is None else sharded.models):
        m.physics.configure()

    if init_file:
        state = coupled_restart.load_coupled_state(init_file, device=device, dtype=dtype)
    else:
        state = model.initial_state(
            hice0=1.0, cice0=0.9, hsnow0=0.05, nlayers=int(get("model.nlayers", 1)),
            device=device, dtype=dtype,
        )
        if ocean_mask is not None:
            # Land elements start (and stay) ice-free.
            m = torch.as_tensor(ocean_mask, device=device, dtype=dtype)
            state = dataclasses.replace(
                state, hice=state.hice * m, cice=state.cice * m, hsnow=state.hsnow * m,
            )

    start = float(get("model.start", 0.0))
    full = lambda v: torch.full((nx, ny), v, device=device, dtype=dtype)  # noqa: E731
    cyclone = dyn_forcing = provider = None
    if forcing_mode.startswith(("era5:", "archive:")):
        from ..io.forcing_file import ForcingProvider

        kind, _, path = forcing_mode.partition(":")
        if kind == "era5":
            # Decode and regrid once onto the mesh's element centres, then
            # run from the resulting archive.
            from ..io.era5 import era5_to_archive, lonlat_box

            if geometry is Geometry.SPHERICAL:
                dst_lats, dst_lons = mesh.lonlat_centers()
            else:
                dst_lats, dst_lons = lonlat_box(nx, ny, lat0, lat1, lon0, lon1)
            archive = get("dynamics.era5_archive", "era5_forcing.h5")
            era5_to_archive(path, archive, dst_lats, dst_lons)
            path = archive
        provider = ForcingProvider(path, dtype=dtype, device=device)
        phys_forcing = provider.thermo_forcing(start, nx, ny)
        dyn_forcing = provider.dynamics_forcing(start, nx, ny)
    else:
        phys_forcing = Forcing(**{k: full(v) for k, v in PHYSICS_FORCING.items()}, wind=full(wind))
        if forcing_mode == "cyclone":
            cyclone = dict(
                nx=nx, ny=ny, dx=dx, dy=dy, vmax_atm=wind, r0=min(nx * dx, ny * dy) / 5,
                period=4 * 86400.0, vmax_ocean=0.1, dt=dt,
            )
        else:
            dyn_forcing = DynamicsForcing(
                u_atm=full(wind), v_atm=full(0.0), u_ocean=full(0.0), v_ocean=full(0.0),
            )
    return CoupledSetup(
        start=start, stop=float(get("model.stop", 0.0)), dt=dt,
        checkpoint_period=int(get("model.checkpoint_period", 0)),
        checkpoint_pattern=get("model.checkpoint_pattern", "coupled.{step}.chk"),
        diag_file=get("model.diagnostics_file", ""),
        diag_period=int(get("model.diagnostics_period", 0)),
        health_period=int(get("model.health_period", 0)), on_nonfinite=on_nonfinite,
        do_thermo=bool(get("dynamics.thermo", True)), model=model, sharded=sharded, state=state,
        phys_forcing=phys_forcing, dyn_forcing=dyn_forcing, cyclone=cyclone, provider=provider,
        device=device, dtype=dtype,
    )


def run_coupled(
    argv: Optional[Sequence[str]] = None, *, device="cuda", dtype=torch.float32
) -> int:
    argv = list(sys.argv if argv is None else argv)
    cmd_line = apply_config(argv)
    if cmd_line.help_requested:
        return 0
    if cmd_line.cpu_requested:
        device = "cpu"
    if cmd_line.float64_requested:
        dtype = torch.float64
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print(
            "nextsimdg_tpu_torch: no CUDA device; pass --cpu to run on the CPU", file=sys.stderr
        )
        return 2
    with main_timer.scope("configure"):
        setup = configure_coupled(device=device, dtype=dtype)
    _run(setup)
    print(main_timer.report(), file=sys.stderr)
    return 0


def _run(setup: CoupledSetup) -> None:
    """The time loop of a configured run: steps, health probes and the dt/2
    replay, the cadence writes, the post-mortem and the final checkpoint."""
    start, dt, n_steps = setup.start, setup.dt, setup.n_steps
    checkpoint_period, diag_period = setup.checkpoint_period, setup.diag_period
    device, dtype = setup.device, setup.dtype
    mesh = setup.model.mesh
    domain = _Domain(setup.model, setup.sharded, setup.phys_forcing, setup.do_thermo, device)
    state = domain.place(setup.state)
    if setup.dyn_forcing is not None:
        domain.set_dynamics_forcing(setup.dyn_forcing)
    pipeline, provider = setup.open_pipeline(), setup.provider
    nx, ny = mesh.nx, mesh.ny
    diag = (
        diagnostics.DiagnosticWriter(setup.diag_file) if setup.diag_file and diag_period else None
    )
    # One background writer: periodic checkpoints overlap with stepping (one
    # worker keeps the write order; the final checkpoint joins it). It gets
    # host arrays only: the fetch runs on this thread.
    ckpt_pool = ThreadPoolExecutor(max_workers=1)
    pending_ckpt = None
    Logged.info(f"Coupled run: {n_steps} steps of {dt} s on {mesh.nx}x{mesh.ny} on {device}")

    mon = None
    final_time = setup.stop
    if setup.health_period > 0:
        on_nonfinite = setup.on_nonfinite
        if on_nonfinite == "retry-halved" and pipeline is not None:
            # The cyclone pipeline streams one set of fields a call at a
            # fixed dt: a rollback cannot rewind it and half-steps would
            # desync its clock, so detection stays on and recovery aborts.
            Logged.warning(
                "health: retry-halved is unavailable with the streaming "
                "forcing pipeline; falling back to on_nonfinite=abort"
            )
            on_nonfinite = "abort"
        mon = HealthMonitor(setup.health_period, on_nonfinite)

    try:
        with main_timer.scope("run"):
            if mon is not None:
                mon.record_good(0, start, state)
            # step counts completed FULL-dt steps; during a halved-dt
            # recovery segment each iteration is a half step and `halves`
            # tracks the position inside the step.
            step = 0
            halves = 0
            while step < n_steps:
                recovering = mon is not None and mon.recovering
                dt_cur = dt / 2 if recovering else dt
                t_now = start + step * dt + halves * (dt / 2)
                if pipeline is not None:
                    with main_timer.scope("forcing"):
                        domain.set_dynamics_forcing(
                            cyclone_forcing(pipeline.next_fields(), device=device, dtype=dtype)
                        )
                elif provider is not None:
                    with main_timer.scope("forcing"):
                        domain.set_dynamics_forcing(provider.dynamics_forcing(t_now, nx, ny))
                        domain.set_physics_forcing(provider.thermo_forcing(t_now, nx, ny))
                with main_timer.scope("step"):
                    state = domain.step(state, dt_cur)
                if recovering:
                    halves += 1
                    if halves == 2:
                        halves = 0
                        step += 1
                else:
                    step += 1
                if mon is not None:
                    t_next = start + step * dt + halves * (dt / 2)
                    with main_timer.scope("health"):
                        action = mon.after_step(step, t_next, state)
                    if action == "rollback":
                        step, _t_rb, state = mon.rollback_target()
                        halves = 0
                        continue
                if halves or (mon is not None and mon.recovering):
                    continue  # inside a recovery segment: no cadence work
                t_step = start + step * dt
                ckpt_due = bool(checkpoint_period) and step % checkpoint_period == 0
                diag_due = diag is not None and step % diag_period == 0
                if (ckpt_due or diag_due) and mon is not None and mon.last_probe != step:
                    # A cadence file holds a probed state only.
                    with main_timer.scope("health"):
                        action = mon.probe_now(step, t_step, state)
                    if action == "rollback":
                        step, _t_rb, state = mon.rollback_target()
                        continue
                if ckpt_due:
                    with main_timer.scope("checkpoint"):
                        # Surfacing a previous failure here keeps the one
                        # writer's order and loud errors.
                        if pending_ckpt is not None:
                            pending_ckpt.result()
                        host = domain.fetch(state)
                        pending_ckpt = ckpt_pool.submit(
                            coupled_restart.save_coupled_state,
                            setup.checkpoint_pattern.format(step=step), host, t_step,
                        )
                if diag_due:
                    with main_timer.scope("diagnostics"):
                        diag.write(t_step, domain.diagnostic_fields(state))
    except NonFiniteStateError as err:
        # Post-mortem: the poisoned state for inspection, and (through the
        # finally block's coupled_restart.chk) the last GOOD state, so that
        # a resume starts from something usable.
        Logged.error(f"health: {err}")
        with main_timer.scope("post-mortem"):
            coupled_restart.save_coupled_state(
                "coupled_failed.post_mortem.chk", domain.fetch(state), err.t
            )
            if err.last_good is not None:
                good_step, final_time, state = err.last_good
                Logged.error(
                    "health: coupled_restart.chk will hold the last "
                    f"healthy state (step {good_step}, t={final_time})"
                )
        raise
    finally:
        if diag is not None:
            diag.close()
        if pipeline is not None:
            pipeline.close()
        with main_timer.scope("final-checkpoint"):
            if pending_ckpt is not None:
                # A failed periodic checkpoint (a disk blip) must not stop
                # the final restart write or mask the run loop's exception:
                # the state in memory is intact, and coupled_restart.chk is
                # what a resume needs.
                try:
                    pending_ckpt.result()
                except Exception as err:
                    Logged.error(f"periodic checkpoint failed: {err}")
            coupled_restart.save_coupled_state(
                "coupled_restart.chk", domain.fetch(state), time=final_time
            )
        ckpt_pool.shutdown(wait=True)


if __name__ == "__main__":
    sys.exit(run_coupled())
