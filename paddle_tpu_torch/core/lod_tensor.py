"""LoDTensor: dense data + level-of-detail sequence offsets.

Reference parity: paddle/fluid/framework/lod_tensor.h:58,110 — `LoD` is a
list of offset vectors describing nested variable-length sequences laid out
flat along dim 0.

Inside a step a ragged value is a registry.SeqTensor: the flat data and
int32 per-sequence lengths, both on the device, so every sequence op is a
static-shape computation over the token axis. The Executor turns a fed
LoDTensor with a LoD into one (and a fetched SeqTensor back into a
LoDTensor). `create_bucketed_seq_tensor` builds a SeqTensor directly, its
flat data tail-padded to a bucket multiple, so that batches of different
token totals share one shape and one captured step.
"""

import numpy as np
import torch

from .places import device_for
from .registry import SeqTensor


def _offsets_to_lengths(level):
    return [level[i + 1] - level[i] for i in range(len(level) - 1)]


def _lengths_to_offsets(lengths):
    out = [0]
    for n in lengths:
        out.append(out[-1] + n)
    return out


class LoDTensor:
    def __init__(self, data=None, lod=None):
        self._data = data  # np.ndarray or torch.Tensor
        self._lod = [list(map(int, lv)) for lv in (lod or [])]

    # -- reference API ------------------------------------------------------
    def set(self, array, place=None):
        self._data = np.asarray(array)

    def set_lod(self, lod):
        self._lod = [list(map(int, lv)) for lv in lod]

    def lod(self):
        return [list(lv) for lv in self._lod]

    def set_recursive_sequence_lengths(self, lengths):
        self._lod = [_lengths_to_offsets(lv) for lv in lengths]

    def recursive_sequence_lengths(self):
        return [_offsets_to_lengths(lv) for lv in self._lod]

    def has_valid_recursive_sequence_lengths(self):
        if not self._lod:
            return True
        n = self._data.shape[0] if self._data is not None else 0
        prev_len = None
        for i, level in enumerate(self._lod):
            if not level or level[0] != 0:
                return False
            if any(level[j] > level[j + 1] for j in range(len(level) - 1)):
                return False
            if prev_len is not None and level[-1] != prev_len:
                return False
            prev_len = len(level) - 1 if i + 1 < len(self._lod) else None
        return self._lod[-1][-1] == n

    def shape(self):
        return tuple(self._data.shape)

    @property
    def data(self):
        return self._data

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def numpy(self):
        if isinstance(self._data, torch.Tensor):
            return self._data.detach().cpu().numpy()
        return np.asarray(self._data)

    # -- sequence helpers ---------------------------------------------------
    def last_level_offsets(self):
        """Offsets of the finest level, or trivial [0, N] when lod is empty."""
        if self._lod:
            return list(self._lod[-1])
        n = self._data.shape[0] if self._data is not None else 0
        return [0, n]

    def num_sequences(self):
        return len(self.last_level_offsets()) - 1

    def __repr__(self):
        shp = None if self._data is None else tuple(self._data.shape)
        return f"LoDTensor(shape={shp}, lod={self._lod})"


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """reference python/paddle/fluid/lod_tensor.py create_lod_tensor: a
    host LoDTensor from an array (or a list of per-sequence lists, whose
    lengths it infers) and its per-level sequence lengths. `place` is
    accepted for API parity: the Executor moves the data when it is fed."""
    if isinstance(data, list):
        flattened = [item for seq in data for item in seq]
        lengths = [len(seq) for seq in data]
        arr = np.asarray(flattened)
        if arr.ndim == 1:
            arr = arr.reshape(-1, 1)
        t = LoDTensor(arr)
        t.set_recursive_sequence_lengths([lengths])
        return t
    t = LoDTensor(np.asarray(data))
    t.set_recursive_sequence_lengths(recursive_seq_lens)
    if not t.has_valid_recursive_sequence_lengths():
        raise ValueError("invalid lod lengths for data shape")
    return t


def create_bucketed_seq_tensor(seqs, bucket, place=None, dtype="int64",
                               pad_value=0):
    """Concatenate variable-length sequences and TAIL-PAD the flat data up
    to the next multiple of `bucket` tokens: a SeqTensor whose data shape
    is a bucket multiple, so batches padded to one bucket share one
    captured step and can ride Executor.run(iters=K), while its lengths
    stay exact (every lod-aware kernel classifies the tail rows as
    padding through SeqTensor.segment_ids()/token_mask()).

    seqs: the batch's per-sequence 1-D or 2-D arrays. bucket: pad the
    token total up to a multiple of this. place: where the tensors are
    built (None: the host; the Executor moves a host SeqTensor to its
    device when it is fed). The SeqTensor carries its lengths as numpy
    too (`host_lengths`), for the cap checks of the step."""
    arrs = [np.asarray(s, dtype=dtype) for s in seqs]
    arrs = [a.reshape(-1, 1) if a.ndim == 1 else a for a in arrs]
    lengths = np.asarray([a.shape[0] for a in arrs], np.int32)
    flat = np.concatenate(arrs, axis=0) if arrs else \
        np.zeros((0, 1), dtype=dtype)
    total = flat.shape[0]
    bucket = max(1, int(bucket))
    padded_total = -(-total // bucket) * bucket
    if padded_total > total:
        pad = np.full((padded_total - total,) + flat.shape[1:], pad_value,
                      dtype=flat.dtype)
        flat = np.concatenate([flat, pad], axis=0)
    device = device_for(place) if place is not None else torch.device("cpu")
    return SeqTensor(torch.from_numpy(flat).to(device),
                     torch.from_numpy(lengths).to(device), lengths)


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place, low,
                                high):
    """A LoDTensor of uniform int64 ids in [low, high] (numpy's global
    random state, as the reference)."""
    total = sum(recursive_seq_lens[-1])
    shape = [total] + list(base_shape)
    data = np.random.randint(low, high + 1, size=shape).astype("int64")
    return create_lod_tensor(data, recursive_seq_lens, place)
