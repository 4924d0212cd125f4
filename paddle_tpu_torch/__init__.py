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
`serve.Server` from one captured CUDA graph per batch bucket. Input comes
from RecordIO files (`recordio`), readers (`reader`, `dataset`, `batch`,
`DataFeeder`, the reader layers) or a `DataPipe` (`datapipe`: sharded
sources, thread or process decode, batching, and pinned staging onto the
card on a side stream), which Executor.run takes as its feed. Every run
reports to the step monitor (`monitor`: phases, the step journal, MFU),
and, when asked, to the model-health ledger (`health`), the NaN/Inf
check, FLAGS_benchmark and a profiler session (`profiler`); `python -m
paddle_tpu_torch` reads their files. The high-level `Trainer` drives a
reader or a DataPipe with events, io-format checkpoints and, under a
`ResilienceConfig`, the fault-tolerant loop of `resilience` (async atomic
checkpoints in the JAX package's layout, retry, the NaN guard, the grace
save on SIGTERM, the hang watchdog, the chaos harness); `metrics` and
`evaluator` accumulate what a run fetches. When a step is prepared,
`analysis` verifies the program under FLAGS_verify and the compile
`cache` keeps it (an LRU under FLAGS_compile_cache_cap, a persistent
store under FLAGS_compile_cache_dir); `debugger` prints and draws
programs, and `concurrency` holds the CSP layers (channels, Go, Select).
`DistributeTranspiler` rewrites a program into a trainer's and parameter
servers' programs, which talk over `parallel.rpc`'s TCP runtime (sparse
gradients as `core.selected_rows.SelectedRows`, a distributed lookup
table as a pserver's `SparseTable`); `memory_optimize` and
`release_memory` reuse and free a program's dead vars.
"""

from . import flags
from . import unique_name
from . import core
from .core import framework
from .core.framework import (
    Program,
    Block,
    Operator,
    Variable,
    Parameter,
    default_main_program,
    default_startup_program,
    program_guard,
    switch_main_program,
    switch_startup_program,
    name_scope,
)
from .core.places import CPUPlace, CUDAPinnedPlace, CUDAPlace, TPUPlace
from .core.scope import Scope, global_scope, scope_guard
from .core.lod_tensor import (LoDTensor, create_bucketed_seq_tensor,
                              create_lod_tensor, create_random_int_lodtensor)
from . import ops  # registers every kernel
from . import initializer
from . import param_attr
from .param_attr import ParamAttr, WeightNormParamAttr
from . import regularizer
from . import clip
from . import backward
from .backward import append_backward, calc_gradient
from . import layers
from . import nets
from . import optimizer
from .optimizer import (
    SGD,
    ProximalGD,
    ProximalAdagrad,
    Momentum,
    Adagrad,
    Adam,
    Adamax,
    DecayedAdagrad,
    Adadelta,
    RMSProp,
    SGDOptimizer,
    MomentumOptimizer,
    AdagradOptimizer,
    AdamOptimizer,
    AdamaxOptimizer,
    DecayedAdagradOptimizer,
    AdadeltaOptimizer,
    RMSPropOptimizer,
    ModelAverage,
    Optimizer,
)
from . import fusion
from . import parallel
from . import executor
from .executor import Executor, FetchFuture, fetch_var
from . import parallel_executor
from .parallel_executor import (BuildStrategy, ExecutionStrategy,
                                ParallelExecutor)
from . import convert
from . import profiler
from . import monitor
from . import analysis
from . import cache
from . import debugger
from . import concurrency
from . import trace
from . import health
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
from .transpiler import (DistributeTranspiler, InferenceTranspiler,
                         memory_optimize, release_memory)
from . import metrics
from . import evaluator
from . import resilience
from .resilience import ResilienceConfig, ResilientRunner
from . import trainer
from .trainer import (BeginEpochEvent, BeginStepEvent, CheckpointConfig,
                      EndEpochEvent, EndStepEvent, Trainer)
from . import inferencer
from .inferencer import Inferencer
from . import amp
from . import serve
from . import recordio
from .data_feeder import DataFeeder
from . import reader
from . import dataset
from . import datapipe
from .datapipe import DataPipe, AsyncDeviceFeeder
from . import pipeline
from .pipeline import DeviceChunkFeeder
from .minibatch import batch

Tensor = LoDTensor

__version__ = "0.1.0"
