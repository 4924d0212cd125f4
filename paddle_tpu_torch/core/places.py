"""Device places.

Reference parity: paddle/fluid/platform/place.h:25-49 (CPUPlace /
CUDAPlace). In the port CUDAPlace(i) is the i-th local
CUDA card and CPUPlace the host; TPUPlace is kept as an alias of CUDAPlace
so scripts written against the JAX package run unchanged. The default
place is the card: asking for it where no CUDA device exists raises —
the port never drops to the CPU on its own.
"""

import torch


class Place:
    def __eq__(self, other):
        return type(self) is type(other) and getattr(
            self, "device_id", 0) == getattr(other, "device_id", 0)

    def __hash__(self):
        return hash((type(self).__name__, getattr(self, "device_id", 0)))

    def __repr__(self):
        return type(self).__name__ + "()"


class CPUPlace(Place):
    """Host CPU."""

    platform = "cpu"


class CUDAPlace(Place):
    """One local CUDA card (by device index)."""

    platform = "cuda"

    def __init__(self, device_id=0):
        self.device_id = device_id

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"


class CUDAPinnedPlace(CPUPlace):
    """Page-locked host memory: where the datapipe's feeder stages a chunk
    before its copy to the card (datapipe/feeder.py). Ops run on it as on
    CPUPlace()."""


# API-parity alias: scripts written for the JAX package say TPUPlace(0);
# in the port that is the accelerator, i.e. a CUDA card.
TPUPlace = CUDAPlace


def device_for(place):
    """Map a Place to a torch.device. A CUDAPlace on a machine without a
    usable CUDA device raises instead of falling back to the host."""
    if isinstance(place, CUDAPlace):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{place!r} needs a CUDA device, but torch.cuda.is_available() "
                f"is False; pass CPUPlace() to run on the host")
        if place.device_id >= torch.cuda.device_count():
            raise RuntimeError(
                f"{place!r}: only {torch.cuda.device_count()} CUDA "
                f"device(s) present")
        return torch.device("cuda", place.device_id)
    if isinstance(place, CPUPlace):
        return torch.device("cpu")
    raise TypeError(f"not a Place: {place!r}")


def place_to_str(place):
    """Serialize a Place for op attrs ('cpu', 'cuda:0')."""
    if isinstance(place, CUDAPlace):
        return f"cuda:{place.device_id}"
    return "cpu"


def place_from_str(s):
    """The Place of `place_to_str`'s string (the JAX package's 'tpu:0'
    names the card too)."""
    if s == "cpu" or not s:
        return CPUPlace()
    kind, _, idx = s.partition(":")
    if kind not in ("tpu", "cuda", "gpu"):
        raise ValueError(f"unknown place string {s!r}")
    return CUDAPlace(int(idx or 0))
