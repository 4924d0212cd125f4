"""Parallelism package of the port: the dp mesh over a torch.distributed
group (`mesh.py`), the bootstrap (`distributed.py`), the ZeRO-1 sharded
weight update (`zero1.py`), the sharding annotations (`api.py`), and flash
attention (`flash.py`, its forward a hand-written CUDA kernel).

Reference mapping (SURVEY.md §2.4):
  NCCL collectives      -> torch.distributed (NCCL on a card, gloo on the
                           host): ops/collective_ops.py, ParallelExecutor
  gen_nccl_id bootstrap -> distributed.py (init_process_group)
  kReduce strategy      -> zero1.py ZeRO-1 sharded weight update
                           (FLAGS_zero1 / BuildStrategy.Reduce)
Ring attention, pipeline parallelism, autoshard and the RPC runtime come
with ROADMAP queue 1 items 5 and 10.
"""

from . import api
from . import distributed
from . import flash
from . import mesh
from . import zero1
from .api import get_sharding, set_sharding, sharding_scope
from .flash import flash_attention
from .mesh import (MeshSpec, data_parallel_mesh, make_mesh, mesh_geometry,
                   mesh_scope)

__all__ = [
    "mesh", "distributed", "api", "flash", "zero1",
    "make_mesh", "data_parallel_mesh", "mesh_scope", "mesh_geometry",
    "MeshSpec", "set_sharding", "get_sharding", "sharding_scope",
    "flash_attention",
]
