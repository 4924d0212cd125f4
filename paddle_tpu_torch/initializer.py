"""Parameter initializers — emit init ops into the startup program.

Reference parity: python/paddle/fluid/initializer.py (Constant, Uniform,
Normal, Xavier, MSRA, force_init_on_cpu).
"""

import contextlib
import math

__all__ = [
    "Constant", "Uniform", "Normal", "Xavier", "MSRA", "Bilinear",
    "force_init_on_cpu", "init_on_cpu",
    "ConstantInitializer", "UniformInitializer", "NormalInitializer",
    "XavierInitializer", "MSRAInitializer", "BilinearInitializer",
]

_force_init_on_cpu_ = False


def force_init_on_cpu():
    return _force_init_on_cpu_


@contextlib.contextmanager
def init_on_cpu():
    global _force_init_on_cpu_
    pre = _force_init_on_cpu_
    _force_init_on_cpu_ = True
    try:
        yield
    finally:
        _force_init_on_cpu_ = pre


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError

    @staticmethod
    def _fan_in_out(var):
        shape = var.shape
        if len(shape) < 2:
            return shape[0] if shape else 1, shape[0] if shape else 1
        receptive = 1
        for s in shape[2:]:
            receptive *= s
        return shape[1] * receptive, shape[0] * receptive


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self._value = value

    def __call__(self, var, block):
        return block.append_op(
            "fill_constant",
            {},
            {"Out": [var]},
            {"shape": list(var.shape), "value": float(self._value), "dtype": var.dtype},
        )


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self._low, self._high, self._seed = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            "uniform_random",
            {},
            {"Out": [var]},
            {
                "shape": list(var.shape),
                "min": float(self._low),
                "max": float(self._high),
                "seed": self._seed,
                "dtype": var.dtype,
            },
        )


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self._mean, self._std_dev, self._seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            "gaussian_random",
            {},
            {"Out": [var]},
            {
                "shape": list(var.shape),
                "mean": float(self._mean),
                "std": float(self._std_dev),
                "seed": self._seed,
                "dtype": var.dtype,
            },
        )


class XavierInitializer(Initializer):
    """reference initializer.py Xavier (Glorot & Bengio 2010)."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self._uniform = uniform
        self._fan_in = fan_in
        self._fan_out = fan_out
        self._seed = seed

    def __call__(self, var, block):
        f_in, f_out = self._fan_in_out(var)
        fan_in = f_in if self._fan_in is None else self._fan_in
        fan_out = f_out if self._fan_out is None else self._fan_out
        if self._uniform:
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            return UniformInitializer(-limit, limit, self._seed)(var, block)
        std = math.sqrt(2.0 / (fan_in + fan_out))
        return NormalInitializer(0.0, std, self._seed)(var, block)


class MSRAInitializer(Initializer):
    """reference initializer.py MSRA (He et al. 2015)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self._uniform = uniform
        self._fan_in = fan_in
        self._seed = seed

    def __call__(self, var, block):
        f_in, _ = self._fan_in_out(var)
        fan_in = f_in if self._fan_in is None else self._fan_in
        if self._uniform:
            limit = math.sqrt(6.0 / fan_in)
            return UniformInitializer(-limit, limit, self._seed)(var, block)
        std = math.sqrt(2.0 / fan_in)
        return NormalInitializer(0.0, std, self._seed)(var, block)


class BilinearInitializer(Initializer):
    """Bilinear upsampling filter init (for conv2d_transpose upsampling)."""

    def __call__(self, var, block):
        import numpy as np

        shape = var.shape
        if len(shape) != 4:
            raise ValueError("BilinearInitializer expects a 4-D filter")
        c_out, c_in, kh, kw = shape
        f = math.ceil(kw / 2.0)
        cgrid = (2 * f - 1 - f % 2) / (2.0 * f)
        weight = np.zeros(shape, dtype="float32")
        for i in range(kh):
            for j in range(kw):
                v = (1 - abs(i / f - cgrid)) * (1 - abs(j / f - cgrid))
                weight[:, :, i, j] = v
        return block.append_op(
            "assign_value",
            {},
            {"Out": [var]},
            {"shape": list(shape), "dtype": var.dtype, "values": weight},
        )


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer
