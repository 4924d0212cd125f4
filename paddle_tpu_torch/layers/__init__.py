"""Layer library (reference python/paddle/fluid/layers/). The port carries
the four modules the training path builds with; control flow, detection and
the learning-rate schedulers wait for later slices."""

from . import ops
from .ops import *
from . import tensor
from .tensor import *
from . import nn
from .nn import *
from . import io
from .io import *

__all__ = (
    ops.__all__
    + tensor.__all__
    + nn.__all__
    + io.__all__
    + ["elementwise_binary_dispatch"]
)

from .ops import elementwise_binary_dispatch
