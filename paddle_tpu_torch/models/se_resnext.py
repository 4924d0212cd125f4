"""SE-ResNeXt-50/101/152 (reference
python/paddle/fluid/tests/unittests/test_parallel_executor.py SE-ResNeXt
definition + BASELINE.json north star; the JAX package's
paddle_tpu/models/se_resnext.py).

Squeeze-and-excitation over grouped bottleneck blocks, in NCHW.
Cardinality is expressed with grouped conv2d; the SE gate is a global
pool -> fc (relu) -> fc (sigmoid) -> a per-channel scale
(elementwise_mul with axis=0). The head drops out 0.2 of the pooled
features before the classifier.
"""

import paddle_tpu_torch as fluid



def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None):
    conv = fluid.layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=stride, padding=(filter_size - 1) // 2, groups=groups,
        act=None, bias_attr=False)
    return fluid.layers.batch_norm(input=conv, act=act)


def squeeze_excitation(input, num_channels, reduction_ratio):
    pool = fluid.layers.pool2d(
        input=input, pool_type="avg", global_pooling=True)
    squeeze = fluid.layers.fc(
        input=pool, size=num_channels // reduction_ratio, act="relu")
    excitation = fluid.layers.fc(
        input=squeeze, size=num_channels, act="sigmoid")
    return fluid.layers.elementwise_mul(x=input, y=excitation, axis=0)


def shortcut(input, ch_out, stride):
    ch_in = input.shape[1]
    if ch_in != ch_out:
        return conv_bn_layer(input, ch_out, 1, stride)
    return input


def bottleneck_block(input, num_filters, stride, cardinality,
                     reduction_ratio):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu")
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride,
                          groups=cardinality, act="relu")
    conv2 = conv_bn_layer(conv1, num_filters * 2, 1, act=None)
    scale = squeeze_excitation(conv2, num_filters * 2, reduction_ratio)
    short = shortcut(input, num_filters * 2, stride)
    return fluid.layers.elementwise_add(x=short, y=scale, act="relu")


def se_resnext(input, class_dim, depth=50):
    cfg = {
        50: [3, 4, 6, 3],
        101: [3, 4, 23, 3],
        152: [3, 8, 36, 3],
    }
    depth_cfg = cfg[depth]
    cardinality = 32
    reduction_ratio = 16
    num_filters = [128, 256, 512, 1024]

    conv = conv_bn_layer(input, 64, 7, stride=2, act="relu")
    conv = fluid.layers.pool2d(
        input=conv, pool_size=3, pool_stride=2, pool_padding=1,
        pool_type="max")
    for block in range(len(depth_cfg)):
        for i in range(depth_cfg[block]):
            conv = bottleneck_block(
                conv, num_filters[block],
                2 if i == 0 and block != 0 else 1,
                cardinality, reduction_ratio)
    pool = fluid.layers.pool2d(
        input=conv, pool_type="avg", global_pooling=True)
    drop = fluid.layers.dropout(x=pool, dropout_prob=0.2)
    return fluid.layers.fc(input=drop, size=class_dim, act="softmax")


def get_model(args):
    class_dim = 102 if args.data_set != "cifar10" else 10
    dshape = [3, 224, 224] if args.data_set != "cifar10" else [3, 32, 32]
    input = fluid.layers.data(name="data", shape=dshape, dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    predict = se_resnext(input, class_dim)
    cost = fluid.layers.cross_entropy(input=predict, label=label)
    avg_cost = fluid.layers.mean(cost)
    batch_acc = fluid.layers.accuracy(input=predict, label=label)

    inference_program = fluid.default_main_program().clone(for_test=True)
    optimizer = fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9)

    if args.data_set == "cifar10":
        train_r, test_r = fluid.dataset.cifar.train10(), \
            fluid.dataset.cifar.test10()
    else:
        train_r, test_r = fluid.dataset.flowers.train(), \
            fluid.dataset.flowers.test()
    train_reader = fluid.batch(
        fluid.reader.shuffle(train_r, buf_size=5120),
        batch_size=args.batch_size)
    test_reader = fluid.batch(test_r, batch_size=args.batch_size)
    return avg_cost, inference_program, optimizer, train_reader, \
        test_reader, batch_acc
