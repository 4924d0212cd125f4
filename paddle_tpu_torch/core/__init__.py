"""Core IR + runtime for paddle_tpu_torch.

Reference parity map (paths into the reference Fluid tree):
  framework.proto / {program,block,op}_desc.h  -> core/framework.py (pure-python IR)
  framework/scope.h:39                         -> core/scope.py
  framework/operator.h, op_registry.h          -> core/registry.py
  framework/executor.cc:133                    -> core/executor_core.py (op by op)
  framework/lod_tensor.h:110                   -> core/lod_tensor.py
  platform/place.h                             -> core/places.py
"""

from . import dtypes
from . import places
from . import framework
from . import registry
from . import scope
from . import lod_tensor
from . import executor_core
