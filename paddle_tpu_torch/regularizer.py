"""Weight decay regularizers (reference python/paddle/fluid/regularizer.py).

append_regularization_ops adds the decay term onto each gradient before the
optimizer op consumes it.
"""

__all__ = ["append_regularization_ops", "L1Decay", "L2Decay",
           "L1DecayRegularizer", "L2DecayRegularizer"]


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        from . import unique_name

        decay = block.create_var(
            name=unique_name.generate(param.name + "_l2_decay"),
            shape=param.shape,
            dtype=param.dtype,
        )
        block.append_op(
            "scale",
            {"X": [param]},
            {"Out": [decay]},
            {"scale": self._regularization_coeff},
        )
        return decay

    def __str__(self):
        return f"L2Decay, regularization_coeff={self._regularization_coeff}"


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        from . import unique_name

        sign = block.create_var(
            name=unique_name.generate(param.name + "_sign"),
            shape=param.shape,
            dtype=param.dtype,
        )
        # sign(x) = x / |x|; use composition of registered ops
        absx = block.create_var(
            name=unique_name.generate(param.name + "_abs"),
            shape=param.shape,
            dtype=param.dtype,
        )
        block.append_op("abs", {"X": [param]}, {"Out": [absx]})
        eps = block.create_var(
            name=unique_name.generate(param.name + "_abs_eps"),
            shape=param.shape,
            dtype=param.dtype,
        )
        block.append_op("scale", {"X": [absx]}, {"Out": [eps]}, {"scale": 1.0, "bias": 1e-12})
        block.append_op("elementwise_div", {"X": [param], "Y": [eps]}, {"Out": [sign]})
        decay = block.create_var(
            name=unique_name.generate(param.name + "_l1_decay"),
            shape=param.shape,
            dtype=param.dtype,
        )
        block.append_op(
            "scale", {"X": [sign]}, {"Out": [decay]}, {"scale": self._regularization_coeff}
        )
        return decay

    def __str__(self):
        return f"L1Decay, regularization_coeff={self._regularization_coeff}"


def append_regularization_ops(parameters_and_grads, regularization=None):
    params_and_grads = []
    for param, grad in parameters_and_grads:
        regularization_term = None
        if param.regularizer is not None:
            regularization_term = param.regularizer(param, grad, grad.block)
        elif regularization is not None:
            regularization_term = regularization(param, grad, grad.block)
        if grad is None or regularization_term is None:
            params_and_grads.append((param, grad))
            continue
        block = grad.block
        new_grad = block.create_var(
            name=grad.name + "_regularized", shape=grad.shape, dtype=grad.dtype
        )
        block.append_op(
            "elementwise_add", {"X": [grad], "Y": [regularization_term]}, {"Out": [new_grad]}
        )
        params_and_grads.append((param, new_grad))
    return params_and_grads


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
