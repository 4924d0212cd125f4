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
    images = fluid.layers.data(name="pixel", shape=[1, 28, 28],
                               dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    predict = cnn_model(images)
    cost = fluid.layers.cross_entropy(input=predict, label=label)
    avg_cost = fluid.layers.mean(cost)
    batch_acc = fluid.layers.accuracy(input=predict, label=label)

    inference_program = fluid.default_main_program().clone(for_test=True)
    opt = fluid.optimizer.AdamOptimizer(
        learning_rate=0.001, beta1=0.9, beta2=0.999)

    def _wrap(r):
        def wrapped():
            for img, lbl in r():
                yield img.reshape(1, 28, 28), lbl
        return wrapped

    train_reader = fluid.batch(_wrap(fluid.dataset.mnist.train()),
                               batch_size=args.batch_size)
    test_reader = fluid.batch(_wrap(fluid.dataset.mnist.test()),
                              batch_size=args.batch_size)
    return avg_cost, inference_program, opt, train_reader, test_reader, \
        batch_acc
