"""Parallel and attention primitives of the port. So far: flash attention
(`flash.py`, its forward a hand-written CUDA kernel). The mesh, ring
attention and the collectives come with the distributed slice."""

from . import flash
from .flash import flash_attention

__all__ = ["flash", "flash_attention"]
