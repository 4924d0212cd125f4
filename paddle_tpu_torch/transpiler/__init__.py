"""Program transpilers (reference python/paddle/fluid/transpiler/): the
InferenceTranspiler. The distribute and memory-optimization transpilers of
the JAX package are not ported yet."""

from .inference_transpiler import InferenceTranspiler

__all__ = ["InferenceTranspiler"]
