"""Multi-process initialization: ``torch.distributed`` for the rank grid.

The port's counterpart of ``nextsimdg_tpu.parallel.distributed``. There
``jax.distributed.initialize`` joins the processes of a pod into one
runtime; here ``initialize`` joins them into the default
``torch.distributed`` process group, over which a ``RankGrid`` spreads its
ranks (``RankGrid(..., ranks_per_process=K)``,
``parallel.process_exchange``). Typical launch, one process per host or
card::

    from nextsimdg_tpu_torch.parallel import distributed
    distributed.initialize()    # from MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK
    grid = RankGrid(px, py, "cuda", ranks_per_process=1)

or with explicit coordinates (``coordinator_address`` "host:port", or a
``tcp://`` or ``file://`` URL; ``parallel.multiprocess.launch`` uses a
``file://`` rendezvous in its run directory).

The backend is chosen explicitly and reported (``backend()``,
``choose_backend``): gloo on the CPU; on CUDA nccl only where every process
on the node has a card of its own; otherwise gloo, whose strips the ring
stages through pinned host buffers (``host_staged``). A requested nccl with
too few cards raises; an NCCL init that fails raises and is never retried
on gloo.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

#: Seconds ``init_process_group`` (and every collective of the group) waits
#: before it gives up; the rank grid's waits keep their own timeout.
INIT_TIMEOUT = 300.0

#: The launcher's environment that the no-argument form reads.
ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")

#: Set after a successful initialize(): a group of one process cannot be
#: told from no group by its size, so idempotency needs its own flag.
_initialized = False
_backend = None
_ranks_per_process = 1


def choose_backend(device, local_processes: int, requested: Optional[str] = None) -> str:
    """The process group's backend for ranks on ``device`` with
    ``local_processes`` processes on this node: gloo on the CPU; on CUDA
    nccl where the node has a card for each of its processes, else gloo
    (host-staged strips). ``requested`` "nccl" with too few cards, or on
    the CPU, raises; "gloo" is always honoured."""
    if requested not in (None, "gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {requested!r}")
    device = torch.device(device)
    if device.type != "cuda":
        if requested == "nccl":
            raise ValueError("nccl runs ranks on CUDA devices only")
        return "gloo"
    if requested == "gloo":
        return "gloo"
    cards = torch.cuda.device_count()
    if cards >= local_processes:
        return "nccl"
    if requested == "nccl":
        raise RuntimeError(
            f"nccl needs a card for each of the node's {local_processes} processes; "
            f"this node has {cards} (NCCL puts no two ranks on one card): use gloo"
        )
    return "gloo"


def _init_method(coordinator_address: str) -> str:
    return coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cpu",
    ranks_per_process: int = 1,
    timeout: float = INIT_TIMEOUT,
) -> None:
    """Initialize the default process group (idempotent).

    With explicit coordinates (a configured launch) an init failure is an
    error: silently running alone would step 1/N of the domain. The
    no-argument form reads the launcher's environment (``ENV_KEYS``); where
    it is absent, or its init fails, the process runs alone. ``backend``:
    "gloo", "nccl" or None (``choose_backend`` for ``device``, the node's
    processes from ``LOCAL_WORLD_SIZE``, else all of them).
    ``ranks_per_process``: the rank-grid ranks each process holds (the
    device counts below).
    """
    global _initialized, _backend, _ranks_per_process
    if _initialized or dist.is_initialized():
        return
    explicit = any(arg is not None for arg in (coordinator_address, num_processes, process_id))
    if explicit:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError(
                "explicit coordinates need coordinator_address, num_processes and process_id, got "
                f"{coordinator_address=}, {num_processes=}, {process_id=}"
            )
        init_method, world, rank = _init_method(coordinator_address), int(num_processes), int(process_id)
    else:
        if not all(key in os.environ for key in ENV_KEYS):
            return  # no launcher: one process
        init_method, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    chosen = choose_backend(device, local, backend)
    try:
        dist.init_process_group(
            backend=chosen, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout),
        )
    except (RuntimeError, ValueError) as err:
        if explicit or chosen == "nccl":
            raise RuntimeError(
                f"torch.distributed init ({chosen}) failed for a configured multi-process launch "
                f"({coordinator_address=}, {num_processes=}, {process_id=}); refusing to degrade to "
                "single-host"
            ) from err
        return  # the environment named no reachable group: one process
    _initialized, _backend, _ranks_per_process = True, chosen, int(ranks_per_process)


def backend() -> Optional[str]:
    """The process group's backend, or None without one."""
    return _backend if dist.is_initialized() else None


def host_staged(device) -> bool:
    """Whether strips between processes go through pinned host buffers:
    gloo carrying ranks that live on a card."""
    return backend() == "gloo" and torch.device(device).type == "cuda"


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_multi_host() -> bool:
    return process_count() > 1


def local_device_count() -> int:
    """The rank-grid ranks this process holds."""
    return _ranks_per_process if _initialized else 1


def global_device_count() -> int:
    """The rank-grid ranks of all processes."""
    return local_device_count() * process_count()


def shutdown() -> None:
    """Destroy the process group this module initialized."""
    global _initialized, _backend, _ranks_per_process
    if _initialized and dist.is_initialized():
        dist.destroy_process_group()
    _initialized, _backend, _ranks_per_process = False, None, 1
