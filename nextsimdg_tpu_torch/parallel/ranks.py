"""Rank grids: a P x Q decomposition of the (x, y) element dims of every field.

Counterpart of ``nextsimdg_tpu/parallel/sharding.py``. There a field is
sharded over a 2-D ``jax.sharding.Mesh`` of devices; here a ``RankGrid``
holds P x Q rank blocks in one process (``parallel.exchange``), each on
its device, several or all of them possibly on one card, or spreads them
over the processes of a ``torch.distributed`` group, a few ranks each
(``ranks_per_process``, ``parallel.process_exchange``). Every field keeps
its layout ``(..., nx, ny)``; rank (ix, iy) owns the block
``[ix * nx / P, (ix + 1) * nx / P) x [iy * ny / Q, (iy + 1) * ny / Q)``.
"""

from __future__ import annotations

import dataclasses

import torch

from .exchange import InProcessRing


def pick_mesh_shape(n_ranks: int, nx: int, ny: int):
    """(px, py) ranks for an (nx, ny) grid: the squarest factorization of
    ``n_ranks`` whose blocks divide the grid (the least halo perimeter),
    px <= py on a tie; the squarest factorization when none divides.

    The JAX package scores the factorizations with its TPU kernels' cost
    model (tile costs, VMEM tiers, lane bands); that calibration is the
    TPU's, so the port takes the squarest, which is that function's own
    fallback, until H100 measurements of other shapes exist (ROADMAP M10).
    """
    if n_ranks < 1:
        raise ValueError(f"need at least one rank, got {n_ranks}")
    shapes = [(px, n_ranks // px) for px in range(1, n_ranks + 1) if n_ranks % px == 0]
    dividing = [(px, py) for px, py in shapes if nx % px == 0 and ny % py == 0]
    return min(dividing or shapes, key=lambda shape: (abs(shape[0] - shape[1]), shape[0]))


class RankGrid:
    """P x Q rank blocks of one process, or of the processes of a group.

    ``devices``: one device for all ranks (a ``torch.device`` or a string),
    or one per rank in row-major order (rank = ix * py + iy). On CUDA each
    rank gets its own compute and copy streams (``parallel.exchange``).
    ``periodic``: (x, y), whether each axis is a ring of ranks (the last
    rank's +1 neighbour is the first); closed until set, and set once:
    ``build_sharded_coupled_model`` sets it to the global mesh's axes.

    ``ranks_per_process``: spread the grid over the processes of the
    initialized default ``torch.distributed`` group
    (``parallel.distributed.initialize``), process p holding ranks p K to
    p K + K - 1 (``parallel.process_exchange.ProcessRing``); ``devices``
    are then those of this process's ranks. ``ranks`` and the blocks of
    ``split`` are this process's; ``gather`` and ``gather_tree`` are
    collectives that hand process 0 the global value and the others None.
    """

    def __init__(self, px: int, py: int, devices, timeout: float = None,
                 ranks_per_process: int = None) -> None:
        if px < 1 or py < 1:
            raise ValueError(f"a rank grid needs at least 1 x 1 ranks, got {px} x {py}")
        n = px * py if ranks_per_process is None else int(ranks_per_process)
        if isinstance(devices, (str, torch.device)):
            devices = [devices] * n
        kwargs = {} if timeout is None else {"timeout": timeout}
        self.shape = (int(px), int(py))
        if ranks_per_process is None:
            self.ring = InProcessRing(self.shape, list(devices), **kwargs)
        else:
            from .process_exchange import ProcessRing

            self.ring = ProcessRing(self.shape, list(devices), ranks_per_process, **kwargs)
        self._axes_set = False

    @property
    def periodic(self) -> tuple:
        """(x, y): whether each axis is a ring of ranks."""
        return self.ring.periodic

    @periodic.setter
    def periodic(self, value) -> None:
        """Set once: the models built on the grid exchange through it, so
        other axes later raise ``ValueError``."""
        value = (bool(value[0]), bool(value[1]))
        if self._axes_set and value != self.ring.periodic:
            raise ValueError(
                f"the rank grid's axes are already periodic {self.ring.periodic}, not {value}: "
                "build a new grid for a mesh with other periodic axes"
            )
        self.ring.periodic = value
        self._axes_set = True

    @property
    def ranks(self):
        """Each rank's ``RankExchange``, in rank order."""
        return self.ring.ranks

    def local_shape(self, nx: int, ny: int):
        """The (nx, ny) of one rank's block; raises ``ValueError`` unless the
        grid divides the domain."""
        px, py = self.shape
        if nx % px or ny % py:
            raise ValueError(f"grid {nx}x{ny} not divisible by rank grid {px}x{py}")
        return nx // px, ny // py

    # -- fields ----------------------------------------------------------------
    def split(self, t: torch.Tensor):
        """The rank blocks of a global (..., nx, ny) tensor, each contiguous
        on its rank's device."""
        nx, ny = self.local_shape(t.shape[-2], t.shape[-1])
        return [
            t[..., ix * nx: (ix + 1) * nx, iy * ny: (iy + 1) * ny].to(rank.device).contiguous()
            for rank, (ix, iy) in ((r, r.coords) for r in self.ranks)
        ]

    def gather(self, blocks, device=None) -> torch.Tensor:
        """The global tensor of the rank blocks, on ``device`` (default: rank
        0's). Across processes a collective: process 0 gets the tensor, the
        others None."""
        if self.ring.spans_processes:
            blocks = self.ring.gather_blocks(blocks)
            if blocks is None:
                return None
        return self._assemble(blocks, device)

    def _assemble(self, blocks, device=None) -> torch.Tensor:
        device = self.ranks[0].device if device is None else torch.device(device)
        px, py = self.shape
        rows = [
            torch.cat([blocks[ix * py + iy].to(device) for iy in range(py)], dim=-1)
            for ix in range(px)
        ]
        return torch.cat(rows, dim=-2)

    def split_tree(self, tree):
        """``split`` of every tensor of a dataclass tree (a ``CoupledState``,
        a forcing): one tree per rank of this process. None stays None."""
        n = len(self.ranks)
        if tree is None:
            return [None] * n
        if isinstance(tree, torch.Tensor):
            return self.split(tree)
        fields = {f.name: self.split_tree(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
        return [
            dataclasses.replace(tree, **{name: parts[r] for name, parts in fields.items()})
            for r in range(n)
        ]

    def gather_tree(self, trees, device=None):
        """The inverse of ``split_tree``. Across processes one collective of
        every leaf at once: process 0 gets the tree, the others None."""
        if self.ring.spans_processes:
            trees = self.ring.gather_blocks(trees)
            if trees is None:
                return None
        return self._assemble_tree(trees, device)

    def _assemble_tree(self, trees, device=None):
        first = trees[0]
        if first is None:
            return None
        if isinstance(first, torch.Tensor):
            return self._assemble(trees, device)
        return dataclasses.replace(first, **{
            f.name: self._assemble_tree([getattr(t, f.name) for t in trees], device)
            for f in dataclasses.fields(first)
        })
