"""Layer library (reference python/paddle/fluid/layers/). The port carries
the modules the training path builds with, control flow, `device`
(get_places), detection (SSD's head, loss and output, VOC mAP) and the
learning-rate schedulers."""

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
from . import device
from .device import *
from . import detection
from .detection import *
from . import learning_rate_scheduler
from .learning_rate_scheduler import *

__all__ = (
    ops.__all__
    + tensor.__all__
    + nn.__all__
    + control_flow.__all__
    + io.__all__
    + device.__all__
    + detection.__all__
    + learning_rate_scheduler.__all__
    + ["elementwise_binary_dispatch"]
)

from .ops import elementwise_binary_dispatch
