"""ctypes binding for the native training demo runtime (libpttrain.so).

Reference parity: paddle/fluid/train/demo/demo_trainer.cc — load a saved
ProgramDesc pair (startup + train), initialize parameters natively, run
training steps C++-only. `NativeTrainer` wraps that loop for tests and
host-side tooling; training on the card uses the Executor.
"""

import ctypes

import numpy as np

from .build import train_lib

__all__ = ["NativeTrainer"]

_DTYPES = {0: np.float32, 1: np.float64, 2: np.int32, 3: np.int64}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(train_lib())
        lib.ptt_create.restype = ctypes.c_void_p
        lib.ptt_create.argtypes = [ctypes.c_char_p]
        lib.ptt_last_error.restype = ctypes.c_char_p
        lib.ptt_init.argtypes = [ctypes.c_void_p]
        lib.ptt_step.restype = ctypes.c_int
        lib.ptt_step.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_float),
        ]
        lib.ptt_get_var.restype = ctypes.c_int
        lib.ptt_get_var.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.c_void_p),
        ]
        lib.ptt_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class NativeTrainer:
    """Train a save_train_model directory with the C++ runtime."""

    def __init__(self, model_dir):
        from .infer import reject_nhwc_program

        reject_nhwc_program(model_dir, "trainer")
        lib = _load()
        self._h = lib.ptt_create(str(model_dir).encode())
        if not self._h:
            raise RuntimeError(
                f"native trainer load failed: "
                f"{lib.ptt_last_error().decode()}")
        if lib.ptt_init(self._h) != 0:
            raise RuntimeError(
                f"native startup failed: {lib.ptt_last_error().decode()}")

    def step(self, feed):
        """feed: {name: ndarray} -> float loss (one fwd+bwd+update)."""
        lib = _load()
        names, dts, nds, dims, datas, keep = [], [], [], [], [], []
        for k, v in feed.items():
            arr = np.ascontiguousarray(v)
            keep.append(arr)
            names.append(k.encode())
            dts.append(_CODES[arr.dtype])
            nds.append(arr.ndim)
            dims.extend(arr.shape)
            datas.append(arr.ctypes.data_as(ctypes.c_void_p))
        n = len(names)
        loss = ctypes.c_float()
        rc = lib.ptt_step(
            self._h, n,
            (ctypes.c_char_p * n)(*names),
            (ctypes.c_int * n)(*dts),
            (ctypes.c_int * n)(*nds),
            (ctypes.c_int64 * len(dims))(*dims),
            (ctypes.c_void_p * n)(*datas),
            ctypes.byref(loss))
        if rc != 0:
            raise RuntimeError(
                f"native step failed: {lib.ptt_last_error().decode()}")
        return float(loss.value)

    def get_var(self, name):
        lib = _load()
        dt = ctypes.c_int()
        nd = ctypes.c_int()
        dims = ctypes.POINTER(ctypes.c_int64)()
        data = ctypes.c_void_p()
        rc = lib.ptt_get_var(self._h, name.encode(), ctypes.byref(dt),
                             ctypes.byref(nd), ctypes.byref(dims),
                             ctypes.byref(data))
        if rc != 0:
            raise RuntimeError(
                f"get_var failed: {lib.ptt_last_error().decode()}")
        shape = tuple(dims[i] for i in range(nd.value))
        npdt = _DTYPES[dt.value]
        count = int(np.prod(shape)) if shape else 1
        buf = (ctypes.c_char * (count * np.dtype(npdt).itemsize)).from_address(
            data.value)
        return np.frombuffer(buf, dtype=npdt).reshape(shape).copy()

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                _load().ptt_destroy(self._h)
        except Exception:
            pass
