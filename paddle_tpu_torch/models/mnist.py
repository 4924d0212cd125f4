"""MNIST conv net (reference benchmark/fluid/models/mnist.py:35-94; the
JAX package's paddle_tpu/models/mnist.py).

Provenance: this module is a BENCHMARK WORKLOAD DEFINITION — the
layer sequence, filter counts, and depth configs intentionally match
the reference benchmark model so perf/convergence comparisons are
apples-to-apples; the implementation is written against this
framework's own API.
"""

import numpy as np

import paddle_tpu_torch as fluid

from . import input_path_missing


def cnn_model(data):
    conv_pool_1 = fluid.nets.simple_img_conv_pool(
        input=data, filter_size=5, num_filters=20, pool_size=2,
        pool_stride=2, act="relu")
    conv_pool_2 = fluid.nets.simple_img_conv_pool(
        input=conv_pool_1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act="relu")
    input_shape = conv_pool_2.shape
    param_shape = [int(np.prod(input_shape[1:]))] + [10]
    scale = (2.0 / (param_shape[0] ** 2 * 10)) ** 0.5
    predict = fluid.layers.fc(
        input=conv_pool_2, size=10, act="softmax",
        param_attr=fluid.ParamAttr(
            initializer=fluid.initializer.NormalInitializer(
                loc=0.0, scale=scale)))
    return predict


def get_model(args):
    """The benchmark/fluid contract (models/__init__.py): input "pixel"
    [1, 28, 28] float32, label "label" [1] int64, cnn_model,
    Adam(0.001, 0.9, 0.999); raises until the port has its input
    path."""
    raise input_path_missing("mnist")
