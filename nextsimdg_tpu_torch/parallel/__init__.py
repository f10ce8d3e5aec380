"""Domain decomposition of the coupled model over a grid of rank blocks.

Counterpart of ``nextsimdg_tpu.parallel``'s explicit SPMD form
(``shard_map`` over a device mesh): a ``RankGrid`` of P x Q blocks
(``ranks``), held as threads of one process with their in-process halo
exchange and max reduction (``exchange``), or spread over the processes
of a ``torch.distributed`` group (``distributed``, ``process_exchange``;
``multiprocess`` launches and validates such runs), and the coupled model
on the grid (``shardmap``). The GSPMD auto-partition form has no PyTorch
counterpart.
"""

from . import distributed
from .exchange import RankAborted, RankExchange, run_ranks
from .multiprocess import launch
from .process_exchange import ProcessRing
from .ranks import RankGrid, pick_mesh_shape
from .shardmap import ShardedCoupledModel, build_sharded_coupled_model

__all__ = [
    "ProcessRing",
    "RankAborted",
    "RankExchange",
    "RankGrid",
    "ShardedCoupledModel",
    "build_sharded_coupled_model",
    "distributed",
    "launch",
    "pick_mesh_shape",
    "run_ranks",
]
