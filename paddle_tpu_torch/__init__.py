"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The same Fluid-style surface as the JAX package (`import paddle_tpu_torch
as fluid`): Programs are built with `layers`, differentiated by
`append_backward`, updated by optimizer ops, and run by an op-by-op
Executor whose kernels are torch functions on one CUDA card (CPUPlace()
runs them on the host). The fused optimizer-bucket updates and the
flash-attention forward (parallel.flash_attention) are hand-written CUDA
kernels (fusion/kernels.py, parallel/flash.py, csrc/).
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
from .core.lod_tensor import LoDTensor
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
from . import convert

__version__ = "0.1.0"
