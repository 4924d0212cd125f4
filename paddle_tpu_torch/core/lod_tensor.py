"""LoDTensor: dense data + level-of-detail sequence offsets.

Reference parity: paddle/fluid/framework/lod_tensor.h:58,110 — `LoD` is a
list of offset vectors describing nested variable-length sequences laid out
flat along dim 0. The port's training slice carries no ragged data: a
LoDTensor without lod feeds as a dense tensor, and ragged feeds wait for
the sequence slice.
"""

import numpy as np


class LoDTensor:
    def __init__(self, data=None, lod=None):
        self._data = data  # np.ndarray or torch.Tensor
        self._lod = [list(map(int, lv)) for lv in (lod or [])]

    def set(self, array, place=None):
        self._data = np.asarray(array)

    def set_lod(self, lod):
        self._lod = [list(map(int, lv)) for lv in lod]

    def lod(self):
        return [list(lv) for lv in self._lod]

    def shape(self):
        return tuple(self._data.shape)

    def numpy(self):
        return np.asarray(self._data)

    def __repr__(self):
        shp = None if self._data is None else tuple(self._data.shape)
        return f"LoDTensor(shape={shp}, lod={self._lod})"
