"""Composed network blocks (reference python/paddle/fluid/nets.py; the JAX
package's paddle_tpu/nets.py): the image helpers simple_img_conv_pool
and img_conv_group, which the MNIST conv net and VGG build from.
sequence_conv_pool, glu and scaled_dot_product_attention come with the
sequence slice of the port."""

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act, param_attr=None, pool_type="max",
                         use_cudnn=True, use_mkldnn=False):
    conv_out = layers.conv2d(
        input=input,
        num_filters=num_filters,
        filter_size=filter_size,
        param_attr=param_attr,
        act=act,
        use_cudnn=use_cudnn,
    )
    pool_out = layers.pool2d(
        input=conv_out,
        pool_size=pool_size,
        pool_type=pool_type,
        pool_stride=pool_stride,
        use_cudnn=use_cudnn,
    )
    return pool_out


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True,
                   use_mkldnn=False):
    """len(conv_num_filter) conv2d layers, each optionally followed by
    batch_norm (which then takes the activation) and dropout, then one
    pool2d. Every per-conv argument is one value or one per conv."""
    if not isinstance(conv_num_filter, (list, tuple)):
        raise TypeError("conv_num_filter must be a list or tuple, got "
                        f"{type(conv_num_filter).__name__}")

    def per_conv(obj):
        if not hasattr(obj, "__len__"):
            return [obj] * len(conv_num_filter)
        if len(obj) != len(conv_num_filter):
            raise ValueError(f"{len(obj)} values for "
                             f"{len(conv_num_filter)} convolutions")
        return list(obj)

    conv_padding = per_conv(conv_padding)
    conv_filter_size = per_conv(conv_filter_size)
    param_attr = per_conv(param_attr)
    conv_with_batchnorm = per_conv(conv_with_batchnorm)
    conv_batchnorm_drop_rate = per_conv(conv_batchnorm_drop_rate)

    tmp = input
    for i in range(len(conv_num_filter)):
        local_conv_act = conv_act
        if conv_with_batchnorm[i]:
            local_conv_act = None
        tmp = layers.conv2d(
            input=tmp,
            num_filters=conv_num_filter[i],
            filter_size=conv_filter_size[i],
            padding=conv_padding[i],
            param_attr=param_attr[i],
            act=local_conv_act,
            use_cudnn=use_cudnn,
        )
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate)

    pool_out = layers.pool2d(
        input=tmp, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, use_cudnn=use_cudnn,
    )
    return pool_out
