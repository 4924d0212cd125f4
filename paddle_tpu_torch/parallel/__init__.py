"""Parallelism package of the port: the dp × mp mesh over a
torch.distributed group (`mesh.py`), the bootstrap (`distributed.py`), the
ZeRO-1 sharded weight update (`zero1.py`), the sharding annotations
(`api.py`), autoshard (`autoshard/`: the JAX package's propagation and plan
search, and the port's own partitioner, which lowers a plan to each
rank's program over the mp axis), the mp-sharded embedding
(`sharded_embedding.py`), flash
attention (`flash.py`, its forward a hand-written CUDA kernel), ring
attention over the mesh's sp axis (`ring.py`, each hop the flash kernel),
pipeline parallelism over its pp axis (`pipeline/`: partition, rewrite,
the 1F1B schedule and the host-driven PipelineRunner), and the control
plane: the elastic master (`master.py`: task leases, discovery,
membership and barriers, the compile service's blob store) and the
elastic controller (`elastic.py`: the dp group resized mid-job).

Reference mapping (SURVEY.md §2.4):
  NCCL collectives      -> torch.distributed (NCCL on a card, gloo on the
                           host): ops/collective_ops.py, ParallelExecutor
  gen_nccl_id bootstrap -> distributed.py (init_process_group)
  kReduce strategy      -> zero1.py ZeRO-1 sharded weight update
                           (FLAGS_zero1 / BuildStrategy.Reduce)
  gRPC send/recv        -> rpc.py (TCP variable transport) + ops/rpc_ops.py
  (absent in reference) -> ring.py sequence/context parallelism
  (absent in reference) -> pipeline/ inter-op pipeline parallelism over
                           the pp mesh axis (1F1B; NOT the input-feeder
                           shim in paddle_tpu_torch/pipeline.py)
  go/master + etcd      -> master.py (task-lease master, TTL'd registry,
                           membership epochs) + elastic.py (resize)
  (absent in reference) -> autoshard/ GSPMD-style propagation, lowered to
                           explicit mp collectives (lower.py)
"""

from . import api
from . import distributed
from . import flash
from . import mesh
from . import zero1
from . import rpc
from . import ring
from . import pipeline
from . import master
from . import elastic
from . import autoshard
from . import sharded_embedding
from .api import get_sharding, set_sharding, sharding_scope
from .flash import flash_attention
from .mesh import (MeshSpec, data_parallel_mesh, make_mesh, mesh_geometry,
                   mesh_scope)
from .ring import (ring_attention, ring_attention_sharded,
                   ring_flash_attention, ring_flash_attention_sharded)
from .sharded_embedding import shard_table, sharded_embedding_lookup
from .elastic import (ElasticController, ElasticConfig, ElasticError,
                      Resized, RescalePolicy, LinearRescale,
                      ConstantRescale)

__all__ = [
    "mesh", "distributed", "api", "flash", "zero1", "rpc", "ring",
    "pipeline", "elastic", "autoshard", "sharded_embedding",
    "make_mesh", "data_parallel_mesh", "mesh_scope", "mesh_geometry",
    "MeshSpec", "ElasticController", "ElasticConfig", "ElasticError",
    "Resized", "RescalePolicy", "LinearRescale", "ConstantRescale",
    "set_sharding", "get_sharding", "sharding_scope",
    "flash_attention",
    "ring_attention", "ring_attention_sharded",
    "ring_flash_attention", "ring_flash_attention_sharded",
    "shard_table", "sharded_embedding_lookup",
]
