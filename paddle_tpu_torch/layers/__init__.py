"""Layer library (reference python/paddle/fluid/layers/). The port carries
the modules the training path builds with, the comparison and counter
helpers of control flow, and the learning-rate schedulers; the rest of
control flow and detection wait for later slices."""

from . import ops
from .ops import *
from . import tensor
from .tensor import *
from . import nn
from .nn import *
from . import control_flow
from .control_flow import *
from . import io
from .io import *
from . import learning_rate_scheduler
from .learning_rate_scheduler import *

__all__ = (
    ops.__all__
    + tensor.__all__
    + nn.__all__
    + control_flow.__all__
    + io.__all__
    + learning_rate_scheduler.__all__
    + ["elementwise_binary_dispatch"]
)

from .ops import elementwise_binary_dispatch
