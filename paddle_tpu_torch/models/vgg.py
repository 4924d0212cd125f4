"""VGG-16 with batch norm and dropout (reference
benchmark/fluid/models/vgg.py:25-104; the JAX package's
paddle_tpu/models/vgg.py).

Provenance: this module is a BENCHMARK WORKLOAD DEFINITION — the
layer sequence, filter counts, and depth configs intentionally match
the reference benchmark model so perf/convergence comparisons are
apples-to-apples; the implementation is written against this
framework's own API.
"""

import paddle_tpu_torch as fluid

from . import input_path_missing


def vgg16_bn_drop(input):
    def conv_block(input, num_filter, groups, dropouts):
        return fluid.nets.img_conv_group(
            input=input, pool_size=2, pool_stride=2,
            conv_num_filter=[num_filter] * groups, conv_filter_size=3,
            conv_act="relu", conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts, pool_type="max")

    conv1 = conv_block(input, 64, 2, [0.3, 0])
    conv2 = conv_block(conv1, 128, 2, [0.4, 0])
    conv3 = conv_block(conv2, 256, 3, [0.4, 0.4, 0])
    conv4 = conv_block(conv3, 512, 3, [0.4, 0.4, 0])
    conv5 = conv_block(conv4, 512, 3, [0.4, 0.4, 0])

    drop = fluid.layers.dropout(x=conv5, dropout_prob=0.5)
    fc1 = fluid.layers.fc(input=drop, size=512, act=None)
    bn = fluid.layers.batch_norm(input=fc1, act="relu")
    drop2 = fluid.layers.dropout(x=bn, dropout_prob=0.5)
    fc2 = fluid.layers.fc(input=drop2, size=512, act=None)
    return fc2


def get_model(args):
    """The benchmark/fluid contract (models/__init__.py): input "pixel"
    [3, 224, 224] float32 (flowers, 102 classes) or [3, 32, 32] (cifar10,
    10 classes), label "label" [1] int64, vgg16_bn_drop then
    fc(classdim, softmax), Adam(learning_rate, default 1e-3); raises until
    the port has its input path."""
    raise input_path_missing("vgg")
