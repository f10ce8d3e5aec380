"""Domain decomposition of the coupled model over a grid of rank blocks.

Counterpart of ``nextsimdg_tpu.parallel``'s explicit SPMD form
(``shard_map`` over a device mesh): a ``RankGrid`` of P x Q blocks in one
process (``ranks``), their in-process halo exchange and max reduction
(``exchange``), and the coupled model on the grid (``shardmap``). The
GSPMD auto-partition form has no PyTorch counterpart; the multi-process
form over ``torch.distributed`` is ROADMAP M10b part 3.
"""

from .exchange import RankAborted, RankExchange, run_ranks
from .ranks import RankGrid, pick_mesh_shape
from .shardmap import ShardedCoupledModel, build_sharded_coupled_model

__all__ = [
    "RankAborted",
    "RankExchange",
    "RankGrid",
    "ShardedCoupledModel",
    "build_sharded_coupled_model",
    "pick_mesh_shape",
    "run_ranks",
]
