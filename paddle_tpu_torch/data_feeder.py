"""DataFeeder (reference python/paddle/fluid/data_feeder.py:70): converts
minibatch rows (numpy/lists) into feed dicts of LoDTensors, which
Executor.run takes (a ragged one becomes a SeqTensor on the device).

The JAX package's data_feeder.py: ragged (lod_level>0) slots are flattened
and their token capacity padded up to a power-of-two-ish bucket (`_bucket`)
so a step sees a small set of static shapes (the port prepares and
captures one step per shape), mirroring the role of the reference's LoD
while keeping shapes static.
"""

import numpy as np

from .core.framework import Variable, default_main_program
from .core import dtypes
from .core.lod_tensor import LoDTensor

__all__ = ["DataFeeder"]


def _np_dtype(dtype):
    """The numpy dtype a slot is packed in: the var's, or float32 for a
    bfloat16 var (numpy has none; the executor casts the feed on the
    device)."""
    name = dtypes.canonicalize(dtype)
    return np.dtype("float32" if name == "bfloat16" else name)


def _bucket(n):
    """Round token count up to a power-of-two-ish bucket (1.5x steps)."""
    if n <= 16:
        return 16
    b = 16
    while b < n:
        b = b * 2 if b * 1.5 < n else int(b * 1.5)
    return b


class DataToLoDTensorConverter:
    def __init__(self, place, lod_level, shape, dtype):
        self.place = place
        self.lod_level = lod_level
        self.shape = [s for s in shape]
        self.dtype = _np_dtype(dtype)
        self.data = []
        self.lod = [[] for _ in range(lod_level)]

    def feed(self, data):
        self._feed_impl_(data, self.lod, self.lod_level)

    def _feed_impl_(self, data, lod, lod_level):
        if lod_level == 0:
            self.data.append(data)
        else:
            lod[0].append(len(data))
            for each_data in data:
                self._feed_impl_(each_data, lod[1:], lod_level - 1)

    def done(self, pad_tokens=True):
        if self.lod_level == 0:
            arr = np.array(self.data, dtype=self.dtype)
            shape = [s for s in self.shape if s != -1 and s is not None]
            if arr.shape[1:] != tuple(shape) and int(np.prod(arr.shape[1:])) == int(np.prod(shape)):
                arr = arr.reshape([arr.shape[0]] + shape)
            return LoDTensor(arr)
        flat = []

        def _flatten(d, level):
            if level == 0:
                flat.append(d)
            else:
                for x in d:
                    _flatten(x, level - 1)

        for d in self.data:
            pass
        # self.data holds leaf rows already (appended at level 0)
        arr = np.array(self.data, dtype=self.dtype)
        if arr.ndim == 1:
            arr = arr.reshape(-1, 1)
        if pad_tokens:
            target = _bucket(arr.shape[0])
            if target > arr.shape[0]:
                pad = np.zeros((target - arr.shape[0],) + arr.shape[1:], dtype=arr.dtype)
                arr = np.concatenate([arr, pad], axis=0)
        # offsets from lengths, innermost level last
        lod_offsets = []
        for lengths in self.lod:
            offs = [0]
            for l in lengths:
                offs.append(offs[-1] + l)
            lod_offsets.append(offs)
        t = LoDTensor(arr, lod_offsets)
        return t


class DataFeeder:
    def __init__(self, feed_list, place, program=None):
        self.feed_dtypes = []
        self.feed_names = []
        self.feed_shapes = []
        self.feed_lod_level = []
        if program is None:
            program = default_main_program()
        for each_var in feed_list:
            if isinstance(each_var, str):
                each_var = program.global_block().var(each_var)
            if not isinstance(each_var, Variable):
                raise TypeError("Feed list should contain a list of variable")
            self.feed_dtypes.append(each_var.dtype)
            self.feed_names.append(each_var.name)
            shape = each_var.shape or ()
            self.feed_lod_level.append(each_var.lod_level)
            self.feed_shapes.append(shape)
        self.place = place

    def feed(self, iterable):
        converter = []
        for lod_level, shape, dtype in zip(
            self.feed_lod_level, self.feed_shapes, self.feed_dtypes
        ):
            converter.append(
                DataToLoDTensorConverter(
                    place=self.place, lod_level=lod_level, shape=shape, dtype=dtype
                )
            )
        for each_sample in iterable:
            assert len(each_sample) == len(converter), (
                "The number of fields in data (%s) does not match len(feed_list) (%s)"
                % (len(each_sample), len(converter))
            )
            for each_converter, each_slot in zip(converter, each_sample):
                each_converter.feed(each_slot)
        ret_dict = {}
        for each_name, each_converter in zip(self.feed_names, converter):
            ret_dict[each_name] = each_converter.done()
        return ret_dict

    def feed_parallel(self, iterable, num_places=None):
        """Split one batch across devices (reference data_feeder.py:121).

        With the mesh-based ParallelExecutor the split is done by sharding,
        so this simply yields per-device sub-batches for API parity."""
        if num_places is None:
            num_places = 1
        rows = list(iterable)
        chunk = (len(rows) + num_places - 1) // num_places
        for i in range(num_places):
            part = rows[i * chunk : (i + 1) * chunk]
            if part:
                yield self.feed(part)
