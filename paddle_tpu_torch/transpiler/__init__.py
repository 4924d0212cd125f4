"""Program transpilers (reference python/paddle/fluid/transpiler/): the
distribute transpiler with its placement policies, the inference
transpiler and the memory-optimization passes."""

from .distribute_transpiler import DistributeTranspiler
from .inference_transpiler import InferenceTranspiler
from .memory_optimization_transpiler import memory_optimize, release_memory
from .ps_dispatcher import HashName, RoundRobin

__all__ = [
    "DistributeTranspiler",
    "InferenceTranspiler",
    "memory_optimize",
    "release_memory",
    "HashName",
    "RoundRobin",
]
