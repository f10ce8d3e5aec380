"""N higher-order mEVP subcycles by ghost-zone windows, one window per
thread-block cluster (of one block as shipped): the ``ho_tiled`` CUDA
kernel.

Counterpart of ``nextsimdg_tpu/dynamics/kernels/mevp_ho_tiled.py``, whose
``ho_subcycles_tiled`` runs halo_x HO subcycles per round on full-row
halo'd blocks of the 17 state and 29 const planes in VMEM. Here
(``csrc/ho_tiled.cu``) a cluster of ``rows`` x ``cols`` blocks holds one
window of the 17 state planes, each block a ``sub`` x ``sub`` sub-window of
it in its shared memory, reading its neighbours' edges through distributed
shared memory; the cluster runs up to ``halo`` subcycles on the window and
writes back its interior. The shipped launch (``launch_config``) is a
cluster of one block: one 48^2 window a block. One launch per round,
``ceil(N / halo)`` rounds, ping-ponging between two (17, nx, ny) buffers.
The 29 const planes are read from global memory. Cluster launches need a
card of compute capability 9.0 or newer; a launch the card refuses
(cluster shape, shared memory, non-portable cluster size) raises.

Plain version: N x ``MEVPSolverHO.subcycle_body``
(``ho_tiled_reference``). The kernel runs the element and node bodies of
``ho_single``, so the two schedules agree bit for bit.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..mevp_ho import MEVPSolverHO, ho_subcycles_reference
from . import coupled_cuda as cc

KERNEL = "ho_tiled"
#: Threads a block may have (the HO body's ~128 registers) and blocks a
#: cluster may have (the H100's non-portable limit; above 8 the kernel asks
#: for it).
MAX_THREADS = 512
MAX_CLUSTER_BLOCKS = 16


@dataclass(frozen=True)
class LaunchConfig:
    """A cluster of ``rows`` x ``cols`` blocks (along i and j) of
    ``threads`` threads, each holding a ``sub`` x ``sub`` sub-window of the
    cluster's window (and a one-cell apron, into which its neighbours push
    their edge cells); ``halo`` subcycles a launch."""

    rows: int
    cols: int
    sub: int
    halo: int
    threads: int

    @property
    def window(self) -> tuple:
        return (self.rows * self.sub, self.cols * self.sub)

    @property
    def interior(self) -> tuple:
        """The cells a cluster writes back, (rows, cols)."""
        return tuple(w - 2 * self.halo for w in self.window)

    def clusters(self, nx: int, ny: int) -> tuple:
        """Clusters along i and j that cover an (nx, ny) grid."""
        return tuple(-(-n // t) for n, t in zip((nx, ny), self.interior))

    def grid(self, nx: int, ny: int) -> tuple:
        """The launch's grid (x along j, y along i): a whole number of
        clusters, blocks beyond the domain included."""
        ca, cb = self.clusters(nx, ny)
        return (cb * self.cols, ca * self.rows)

    def shared_bytes(self) -> int:
        """Dynamic shared memory of one block: 17 planes of the sub-window
        and its apron."""
        return 17 * (self.sub + 2) ** 2 * 4

    def redundancy(self) -> float:
        """Elements a cluster computes over its ``halo`` subcycles, per
        element it writes back: the ring of spoiled cells, shrinking by one
        each subcycle."""
        (wa, wb), (ta, tb) = self.window, self.interior
        return sum((wa - 1 - 2 * s) * (wb - 1 - 2 * s) for s in range(self.halo)) / (self.halo * ta * tb)

    def check(self) -> None:
        """Raises where the kernel does not take this configuration."""
        ta, tb = self.interior
        if not (
            self.rows >= 1 and self.cols >= 1 and self.rows * self.cols <= MAX_CLUSTER_BLOCKS
            and self.sub >= 1 and self.halo >= 1 and ta >= 1 and tb >= 1
            and 32 <= self.threads <= MAX_THREADS
        ):
            raise ValueError(f"ho_tiled takes no launch configuration {self}")


#: The shipped configuration, chosen on the H100 by
#: ``benchmarks.mevp_large --tiles=ho_tiled`` at 512^2, 1024^2 and 2048^2
#: (PERF.md): one 48^2 window a block (a cluster of one block, whose
#: barriers are the block's), 8 subcycles a launch, 512 threads, at every
#: size. Clusters of 2 to 16 blocks save ring but measured slower than it
#: at every size swept: their barriers and edge pushes cost more than the
#: ring they save. CLUSTER_2X2, the best of them at 1024^2, stays for the
#: checks and the sweeps.
SHIPPED = LaunchConfig(1, 1, 48, 8, 512)
CLUSTER_2X2 = LaunchConfig(2, 2, 48, 8, 512)


def launch_config(nx: int, ny: int) -> LaunchConfig:
    """The launch configuration that the host picks for an (nx, ny) grid:
    ``SHIPPED`` at every size."""
    return SHIPPED


#: Subcycles a launch of the shipped configuration runs.
HALO = SHIPPED.halo

#: The plain version: N x MEVPSolverHO.subcycle_body.
ho_tiled_reference = ho_subcycles_reference


def max_clusters(device, config: LaunchConfig) -> int:
    """Clusters of ``config`` the card holds at once
    (``cudaOccupancyMaxActiveClusters``; 0 where none fits)."""
    device = torch.device(device)
    config.check()
    clusters = cc._library().nst_ho_tiled_max_clusters(
        config.rows, config.cols, config.sub, config.halo, config.threads, device.index or 0,
    )
    if clusters < 0:
        raise RuntimeError(f"ho_tiled occupancy: CUDA error {-1 - clusters}")
    return clusters


def ho_subcycles_tiled(
    solver: MEVPSolverHO, carry, consts, dt: float, n_subcycles: int, config: LaunchConfig = None,
):
    """(u, v, s11, s22, s12) after ``n_subcycles`` HO subcycles.

    CPU tensors run the plain version; CUDA tensors (float32, contiguous)
    run ``ho_tiled``, one launch per ``config.halo`` subcycles, in the
    launch configuration given or else ``launch_config``'s. The inputs are
    not modified.
    """
    if cc._on_cpu(carry[0].v):
        return ho_tiled_reference(solver, carry, consts, dt, n_subcycles)
    cc._check_ho(solver, carry, consts)
    src = cc.ho_flatten(carry)
    _, nx, ny = src.shape
    config = launch_config(nx, ny) if config is None else config
    config.check()
    clusters_a, clusters_b = config.clusters(nx, ny)
    scalars, tables = cc._ho_scalars(solver, dt), cc._ho_tables(solver)
    stream = cc._stream(src.device)
    const_ptrs = cc._ho_consts(consts)
    buffers = [src, torch.empty_like(src)]
    done = 0
    while done < n_subcycles:
        n_sub = min(config.halo, n_subcycles - done)
        dst = buffers[1] if src is buffers[0] else buffers[0]
        cc._launch(
            KERNEL, src.data_ptr(), dst.data_ptr(), const_ptrs, nx, ny, config.rows, config.cols,
            config.sub, config.halo, clusters_a, clusters_b, n_sub,
            config.threads, ctypes.addressof(scalars), ctypes.addressof(tables),
            src.device.index, stream,
        )
        src = dst
        done += n_sub
    return cc.ho_unflatten(src)
