"""ctypes binding for the native inference predictor (libptinfer.so).

Reference parity: paddle/contrib/inference/paddle_inference_api.h:1 — the
PaddlePredictor Run(inputs)->outputs surface, bound over the C ABI in
infer.cc. The native path serves save_inference_model directories with no
Python in the loop; it is the CPU deployment surface, while serving on the
card uses the Executor on the same saved model. The library is built from
this package's own copy of the JAX package's sources (native/build.py), and
either package's predictor serves either package's directories.
"""

import ctypes

import numpy as np

from .build import infer_lib

__all__ = ["NativePredictor"]

_DTYPES = {0: np.float32, 1: np.float64, 2: np.int32, 3: np.int64}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

_lib = None


def reject_nhwc_program(model_dir, what):
    """The C++ runtime's conv/pool kernels are NCHW-only (runtime.h):
    refuse NHWC programs loudly instead of computing garbage when a
    spatial dim happens to match the filter's channel count. Shared by
    NativePredictor and NativeTrainer."""
    import json
    import os

    # predictor dirs carry __model__ {"program": ...}; trainer dirs carry
    # __train__ {"main_program": ..., "startup_program": ...} (io.py
    # save_inference_model / save_train_model)
    programs = []
    for fname, keys in (("__model__", ("program",)),
                        ("__train__", ("main_program", "startup_program"))):
        path = os.path.join(str(model_dir), fname)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            desc = json.load(f)
        programs.extend(desc.get(k) for k in keys if desc.get(k))
    for prog in programs:
        for block in prog.get("blocks", []):
            for op in block.get("ops", []):
                attrs = op.get("attrs", {})
                if attrs.get("data_format") == "NHWC" or \
                        attrs.get("data_layout") == "NHWC":
                    raise RuntimeError(
                        f"native {what}: op {op.get('type')!r} uses NHWC "
                        f"data layout, which the C++ runtime does not "
                        f"implement (NCHW kernels only) — export the "
                        f"model with data_format='NCHW' (parameters are "
                        f"layout-independent)")


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(infer_lib())
        lib.pt_create.restype = ctypes.c_void_p
        lib.pt_create.argtypes = [ctypes.c_char_p]
        lib.pt_last_error.restype = ctypes.c_char_p
        lib.pt_feed_count.argtypes = [ctypes.c_void_p]
        lib.pt_feed_name.restype = ctypes.c_char_p
        lib.pt_feed_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.pt_fetch_count.argtypes = [ctypes.c_void_p]
        lib.pt_fetch_name.restype = ctypes.c_char_p
        lib.pt_fetch_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.pt_run.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_void_p),
        ]
        lib.pt_output.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.c_void_p),
        ]
        lib.pt_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class NativePredictor:
    """Load a save_inference_model dir; run(feeds) -> list of numpy arrays.

    feeds: {name: np.ndarray}; names must cover the model's feed list."""

    def __init__(self, model_dir):
        reject_nhwc_program(model_dir, "predictor")
        lib = _load()
        self._h = lib.pt_create(str(model_dir).encode())
        if not self._h:
            raise RuntimeError(
                f"native predictor load failed: "
                f"{lib.pt_last_error().decode()}")
        self.feed_names = [
            lib.pt_feed_name(self._h, i).decode()
            for i in range(lib.pt_feed_count(self._h))
        ]
        self.fetch_names = [
            lib.pt_fetch_name(self._h, i).decode()
            for i in range(lib.pt_fetch_count(self._h))
        ]

    def run(self, feeds):
        lib = _load()
        missing = set(self.feed_names) - set(feeds)
        if missing:
            raise ValueError(f"missing feeds: {sorted(missing)}")
        names, arrays = zip(*feeds.items()) if feeds else ((), ())
        arrays = [np.ascontiguousarray(a) for a in arrays]
        for a in arrays:
            if a.dtype not in _CODES:
                raise TypeError(f"unsupported feed dtype {a.dtype}")
        n = len(arrays)
        c_names = (ctypes.c_char_p * n)(*[s.encode() for s in names])
        c_dtypes = (ctypes.c_int * n)(*[_CODES[a.dtype] for a in arrays])
        c_ndims = (ctypes.c_int * n)(*[a.ndim for a in arrays])
        all_dims = [d for a in arrays for d in a.shape]
        c_dims = (ctypes.c_int64 * len(all_dims))(*all_dims)
        c_datas = (ctypes.c_void_p * n)(
            *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrays])
        rc = lib.pt_run(self._h, n, c_names, c_dtypes, c_ndims, c_dims,
                        c_datas)
        if rc != 0:
            raise RuntimeError(
                f"native predict failed: {lib.pt_last_error().decode()}")
        outs = []
        for i in range(len(self.fetch_names)):
            dtype = ctypes.c_int()
            ndim = ctypes.c_int()
            dims = ctypes.POINTER(ctypes.c_int64)()
            data = ctypes.c_void_p()
            rc = lib.pt_output(self._h, i, ctypes.byref(dtype),
                               ctypes.byref(ndim), ctypes.byref(dims),
                               ctypes.byref(data))
            if rc != 0:
                raise RuntimeError(lib.pt_last_error().decode())
            shape = tuple(dims[j] for j in range(ndim.value))
            np_dtype = _DTYPES[dtype.value]
            count = int(np.prod(shape)) if shape else 1
            buf = ctypes.cast(
                data, ctypes.POINTER(ctypes.c_char * (count * np_dtype().itemsize)))
            arr = np.frombuffer(buf.contents, dtype=np_dtype,
                                count=count).reshape(shape).copy()
            outs.append(arr)
        return outs

    def close(self):
        if getattr(self, "_h", None):
            _load().pt_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
