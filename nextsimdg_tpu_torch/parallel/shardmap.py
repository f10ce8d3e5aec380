"""The coupled model on a rank grid: the counterpart of ``jax.shard_map``.

Counterpart of ``nextsimdg_tpu/parallel/shardmap.py``, which builds the
model on the per-device local block and runs its step under
``jax.shard_map``, every neighbour access exchanging block edges over the
device mesh. Here ``build_sharded_coupled_model`` builds one
``CoupledModel`` per rank of a ``RankGrid`` on the rank's block, each with
its ``RankExchange``, and every step runs each rank's ordinary
``CoupledModel.step`` in its own thread (``exchange.run_ranks``): the
exchanges sit inside the model code that every rank runs, as under
``shard_map``.
"""

from __future__ import annotations

from ..coupled import CoupledModel
from ..dynamics.mesh import LocalMeshView, RectMesh
from .exchange import run_ranks
from .ranks import RankGrid


class ShardedCoupledModel:
    """The rank models of a grid and their steps.

    Calling it is the global-shaped step, exactly as the JAX package's
    ``sharded_step``: ``sharded(state, phys_forcing, dyn_forcing, dt,
    do_dynamics=True, do_thermo=True)`` takes and returns global-shaped
    state and forcing (split over the ranks and gathered back on the
    device of ``state``; on a grid across processes every process passes
    the global state and process 0 alone gets the result, the others
    None). ``run_blocks`` keeps the rank blocks resident between steps,
    for the timed path. On CUDA the ranks' streams start
    after the work already issued on the caller's stream and the caller's
    stream waits for them (``exchange.run_ranks``), so no call synchronises
    the host.
    """

    def __init__(self, grid: RankGrid, models) -> None:
        self.grid = grid
        self.models = list(models)

    def __call__(self, state, phys_forcing, dyn_forcing, dt: float,
                 do_dynamics: bool = True, do_thermo: bool = True):
        grid = self.grid
        blocks = self.run_blocks(
            grid.split_tree(state), grid.split_tree(phys_forcing), grid.split_tree(dyn_forcing),
            dt, 1, do_dynamics, do_thermo,
        )
        return grid.gather_tree(blocks, device=state.hice.device)

    def run_blocks(self, states, phys_forcings, dyn_forcings, dt: float, n_steps: int = 1,
                   do_dynamics: bool = True, do_thermo: bool = True):
        """``n_steps`` steps of every rank on its resident blocks (lists in
        rank order: on a grid across processes, the ranks of this process);
        returns the new state blocks. Each rank runs its steps in its own
        thread; on CUDA the caller's stream waits for them."""

        def ranks_steps(rank):
            model = self.models[rank.local]
            state = states[rank.local]
            for _ in range(n_steps):
                state = model.step(
                    state, phys_forcings[rank.local], dyn_forcings[rank.local], dt,
                    do_dynamics, do_thermo,
                )
            return state

        return run_ranks(self.grid.ring, ranks_steps)


def build_sharded_coupled_model(global_mesh: RectMesh, rank_grid: RankGrid, degree: int = 1,
                                **model_kwargs):
    """One ``CoupledModel`` per rank of ``rank_grid`` on its block of
    ``global_mesh``, and their step.

    Returns ``(model, sharded)``: the first rank's model of this process
    (its mesh is the local block; ``model.initial_state`` builds a block;
    ``sharded.models`` holds one a rank of this process) and the
    ``ShardedCoupledModel``, whose call is the global-shaped step.
    ``model_kwargs`` go to every rank's ``CoupledModel`` (``ocean_mask`` is
    the global mask). A uniform global mesh gives each rank a plain
    ``RectMesh`` block with the global periodic axes; a graded or spherical
    one a ``LocalMeshView`` per rank, as in the JAX package. The grid's
    axes become rings where the mesh's are periodic (the 360 degree
    lon-lat ring included); a grid already set to other axes raises
    ``ValueError``. With ``Nextsim::MEVPHighOrder`` selected in the
    registry every rank runs the HO solver on the blocked or rdma schedule
    (its state an ``HOVelocityState``, split and gathered plane by plane
    like any other). A grid that does not divide the mesh raises
    ``ValueError``.
    """
    nx, ny = rank_grid.local_shape(global_mesh.nx, global_mesh.ny)
    rank_grid.periodic = (global_mesh.periodic_x, global_mesh.periodic_y)
    px, py = rank_grid.shape

    def block(rank):
        if not global_mesh.uniform:
            return LocalMeshView(global_mesh, px, py, rank.coords)
        return RectMesh(
            nx, ny, global_mesh.dx, global_mesh.dy,
            periodic_x=global_mesh.periodic_x, periodic_y=global_mesh.periodic_y,
        )

    models = [
        CoupledModel(block(rank), degree=degree, spmd=rank, **model_kwargs)
        for rank in rank_grid.ranks
    ]
    return models[0], ShardedCoupledModel(rank_grid, models)
