"""Iteration-level (continuous) batching + multi-model serving.

scheduler.py  ContinuousServer: the step loop — admission into free
              slots, one warmed model step (a captured CUDA graph on a
              card) over the active slots, eviction on completion;
              weighted least-lag across N hosted models.
slots.py      SlotBank: device-resident per-request decode state at a
              fixed-capacity slot ladder.
interop.py    Opara-style inter-op parallelism: dispatch independent
              dataflow branches of an inference program concurrently,
              each on a CUDA stream of its own.

A port of the JAX package's paddle_tpu/serve/continuous.
"""

from .interop import InterOpRunner, independent_branches
from .scheduler import ContinuousConfig, ContinuousServer
from .slots import SlotBank

__all__ = ["ContinuousConfig", "ContinuousServer", "SlotBank",
           "InterOpRunner", "independent_branches"]
