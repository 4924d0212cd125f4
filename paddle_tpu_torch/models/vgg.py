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
    if args.data_set == "cifar10":
        classdim, data_shape = 10, [3, 32, 32]
        train_r, test_r = fluid.dataset.cifar.train10(), \
            fluid.dataset.cifar.test10()
    else:
        classdim, data_shape = 102, [3, 224, 224]
        train_r, test_r = fluid.dataset.flowers.train(), \
            fluid.dataset.flowers.test()

    images = fluid.layers.data(name="pixel", shape=data_shape,
                               dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    net = vgg16_bn_drop(images)
    predict = fluid.layers.fc(input=net, size=classdim, act="softmax")
    cost = fluid.layers.cross_entropy(input=predict, label=label)
    avg_cost = fluid.layers.mean(cost)
    batch_acc = fluid.layers.accuracy(input=predict, label=label)

    inference_program = fluid.default_main_program().clone(for_test=True)
    optimizer = fluid.optimizer.Adam(
        learning_rate=getattr(args, "learning_rate", 1e-3))

    train_reader = fluid.batch(
        fluid.reader.shuffle(train_r, buf_size=5120),
        batch_size=args.batch_size)
    test_reader = fluid.batch(test_r, batch_size=args.batch_size)
    return avg_cost, inference_program, optimizer, train_reader, \
        test_reader, batch_acc
