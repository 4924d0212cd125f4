"""Op kernels on torch. Importing this package registers every kernel
the port carries (the training slices: ResNet, SE-ResNeXt, VGG and the
MNIST conv net with Momentum or Adam, the MLP, and the fused bucket
updates)."""

from . import util
from . import tensor_ops
from . import math_ops
from . import activation_ops
from . import nn_ops
from . import metric_ops
from . import optimizer_ops
from . import fused_ops
