"""Reader creators + decorators (reference python/paddle/reader).

A reader is a zero-arg callable returning an iterable of samples; decorators
compose readers. Used by both the dataset package and training loops
(reference decorator.py:29-236).
"""

from .decorator import (
    map_readers, buffered, compose, chain, shuffle, firstn, xmap_readers,
    cache, to_datapipe,
)
from . import creator

__all__ = [
    "map_readers", "buffered", "compose", "chain", "shuffle", "firstn",
    "xmap_readers", "cache", "creator", "to_datapipe",
]
