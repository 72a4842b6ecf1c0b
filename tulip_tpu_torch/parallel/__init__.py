"""Many processes: block-angular LPs with a distributed Schur complement
(counterpart of ``tulip_tpu/parallel``), over ``torch.distributed``
through :class:`Comm`."""

from .block_angular import (BlockAngularLPData, block_angular_to_dense,
                            make_block_angular, make_block_angular_share,
                            pad_scenarios, shard_scenarios)
from .comm import Comm, init_comm

__all__ = [
    "BlockAngularLPData",
    "make_block_angular",
    "make_block_angular_share",
    "block_angular_to_dense",
    "pad_scenarios",
    "shard_scenarios",
    "Comm",
    "init_comm",
]
