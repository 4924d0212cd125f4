"""Trainer support (reference python/paddle/fluid/trainer.py; the JAX
package's paddle_tpu/trainer.py). Only place selection is ported so far;
`Trainer` itself waits for its slice."""

from .core.places import CUDAPlace, device_for

__all__ = ["check_and_get_place"]


def check_and_get_place(place):
    """The place to run on: `place`, or the first CUDA card when it is
    None. The JAX package falls back to the CPU where it finds no
    accelerator; the port does not: with no card, None raises (through
    core.places.device_for), and only an explicit CPUPlace() runs on the
    host."""
    if place is None:
        place = CUDAPlace(0)
    device_for(place)
    return place
