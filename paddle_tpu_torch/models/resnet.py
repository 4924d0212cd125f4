"""ResNet for ImageNet-class (resnet_imagenet, depths 18-152) and CIFAR-10
(resnet_cifar10).

Reference parity: benchmark/fluid/models/resnet.py:40-116 (conv_bn blocks,
basic/bottleneck residuals, stage widths 64/128/256/512). TPU-first notes:
NCHW API surface is preserved (reference data_format), while conv kernels
lower to XLA convolutions that the TPU compiler lays out for the MXU;
batch-norm folds into the conv epilogue under XLA fusion.

Provenance: this module is a BENCHMARK WORKLOAD DEFINITION — the
layer sequence, filter counts, and depth configs intentionally match
the reference benchmark model so perf/convergence comparisons are
apples-to-apples; the implementation is written against this
framework's own API.
"""

import numpy as np

import paddle_tpu_torch as fluid



def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu",
                  layout="NCHW"):
    conv1 = fluid.layers.conv2d(
        input=input, filter_size=filter_size, num_filters=ch_out,
        stride=stride, padding=padding, act=None, bias_attr=False,
        data_format=layout)
    return fluid.layers.batch_norm(input=conv1, act=act, data_layout=layout)


def shortcut(input, ch_out, stride, layout="NCHW"):
    ch_in = input.shape[-1 if layout == "NHWC" else 1]
    if ch_in != ch_out:
        return conv_bn_layer(input, ch_out, 1, stride, 0, None,
                             layout=layout)
    return input


def basicblock(input, ch_out, stride, layout="NCHW"):
    short = shortcut(input, ch_out, stride, layout)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, layout=layout)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None, layout=layout)
    return fluid.layers.elementwise_add(x=short, y=conv2, act="relu")


def bottleneck(input, ch_out, stride, layout="NCHW"):
    short = shortcut(input, ch_out * 4, stride, layout)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, layout=layout)
    conv2 = conv_bn_layer(conv1, ch_out, 3, stride=1, padding=1,
                          layout=layout)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None,
                          layout=layout)
    return fluid.layers.elementwise_add(x=short, y=conv3, act="relu")


def layer_warp(block_func, input, ch_out, count, stride, layout="NCHW"):
    res_out = block_func(input, ch_out, stride, layout)
    for _ in range(1, count):
        res_out = block_func(res_out, ch_out, 1, layout)
    return res_out


def resnet_imagenet(input, class_dim, depth=50, layout="NCHW"):
    """layout="NHWC" (TPU extension): channels-last activations end to end
    — input must then be [N, H, W, C]; parameters are layout-independent
    (filters stay OIHW), so checkpoints transfer between layouts."""
    cfg = {
        18: ([2, 2, 2, 1], basicblock),
        34: ([3, 4, 6, 3], basicblock),
        50: ([3, 4, 6, 3], bottleneck),
        101: ([3, 4, 23, 3], bottleneck),
        152: ([3, 8, 36, 3], bottleneck),
    }
    stages, block_func = cfg[depth]
    conv1 = conv_bn_layer(input, ch_out=64, filter_size=7, stride=2,
                          padding=3, layout=layout)
    pool1 = fluid.layers.pool2d(
        input=conv1, pool_type="avg", pool_size=3, pool_stride=2,
        data_format=layout)
    res1 = layer_warp(block_func, pool1, 64, stages[0], 1, layout)
    res2 = layer_warp(block_func, res1, 128, stages[1], 2, layout)
    res3 = layer_warp(block_func, res2, 256, stages[2], 2, layout)
    res4 = layer_warp(block_func, res3, 512, stages[3], 2, layout)
    pool2 = fluid.layers.pool2d(
        input=res4, pool_size=7, pool_type="avg", pool_stride=1,
        global_pooling=True, data_format=layout)
    out = fluid.layers.fc(input=pool2, size=class_dim, act="softmax")
    return out


def resnet_cifar10(input, class_dim, depth=32):
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(
        input=input, ch_out=16, filter_size=3, stride=1, padding=1)
    res1 = layer_warp(basicblock, conv1, 16, n, 1)
    res2 = layer_warp(basicblock, res1, 32, n, 2)
    res3 = layer_warp(basicblock, res2, 64, n, 2)
    pool = fluid.layers.pool2d(
        input=res3, pool_size=8, pool_type="avg", pool_stride=1)
    out = fluid.layers.fc(input=pool, size=class_dim, act="softmax")
    return out


def get_model(args):
    """benchmark/fluid model contract: returns
    (avg_cost, inference_program, optimizer, train_reader, test_reader,
     batch_acc)."""
    if args.data_set == "cifar10":
        class_dim, dshape, model = 10, [3, 32, 32], resnet_cifar10
        train_r, test_r = fluid.dataset.cifar.train10(), \
            fluid.dataset.cifar.test10()
    else:
        class_dim, dshape, model = 102, [3, 224, 224], resnet_imagenet
        train_r, test_r = fluid.dataset.flowers.train(), \
            fluid.dataset.flowers.test()

    input = fluid.layers.data(name="data", shape=dshape, dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    predict = model(input, class_dim)
    cost = fluid.layers.cross_entropy(input=predict, label=label)
    avg_cost = fluid.layers.mean(cost)
    batch_acc = fluid.layers.accuracy(input=predict, label=label)

    inference_program = fluid.default_main_program().clone(for_test=True)
    optimizer = fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9)

    train_reader = fluid.batch(
        fluid.reader.shuffle(train_r, buf_size=5120),
        batch_size=args.batch_size)
    test_reader = fluid.batch(test_r, batch_size=args.batch_size)
    return avg_cost, inference_program, optimizer, train_reader, \
        test_reader, batch_acc
