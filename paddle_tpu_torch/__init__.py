"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The same Fluid-style surface as the JAX package (`import paddle_tpu_torch
as fluid`): Programs are built with `layers`, differentiated by
`append_backward`, updated by optimizer ops, and run by an op-by-op
Executor whose kernels are torch functions on one CUDA card (CPUPlace()
runs them on the host), or by ParallelExecutor, one process per card over
a torch.distributed group (data parallel, ZeRO-1). Ragged (LoD) batches are fed as LoDTensors or
bucketed SeqTensors (create_lod_tensor, create_bucketed_seq_tensor). The
fused optimizer-bucket updates and the flash-attention forward
(parallel.flash_attention) are hand-written CUDA kernels
(fusion/kernels.py, parallel/flash.py, csrc/). A trained program is
saved and loaded with `io` (the JAX package's directory format), folded
for inference by `InferenceTranspiler`, run by `Inferencer`, and served by
`serve.Server` from one captured CUDA graph per batch bucket.
"""

from . import flags
from . import unique_name
from . import core
from .core import framework
from .core.framework import (
    Program,
    Variable,
    Parameter,
    default_main_program,
    default_startup_program,
    program_guard,
    name_scope,
)
from .core.places import CPUPlace, CUDAPlace, TPUPlace
from .core.scope import Scope, global_scope, scope_guard
from .core.lod_tensor import (LoDTensor, create_bucketed_seq_tensor,
                              create_lod_tensor, create_random_int_lodtensor)
from . import ops  # registers every kernel
from . import initializer
from . import param_attr
from .param_attr import ParamAttr
from . import regularizer
from . import clip
from . import backward
from .backward import append_backward
from . import layers
from . import nets
from . import optimizer
from . import fusion
from . import parallel
from . import executor
from .executor import Executor
from . import parallel_executor
from .parallel_executor import (BuildStrategy, ExecutionStrategy,
                                ParallelExecutor)
from . import convert
from . import profiler
from . import monitor
from . import trace
from . import io
from .io import (
    save_vars,
    save_params,
    save_persistables,
    load_vars,
    load_params,
    load_persistables,
    save_inference_model,
    load_inference_model,
    save_checkpoint,
    load_checkpoint,
    clean_checkpoint,
)
from . import transpiler
from .transpiler import InferenceTranspiler
from . import trainer
from . import inferencer
from .inferencer import Inferencer
from . import amp
from . import serve

__version__ = "0.1.0"
