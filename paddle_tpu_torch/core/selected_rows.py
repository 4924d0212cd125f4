"""SelectedRows: the sparse row-set tensor type.

Reference parity: paddle/fluid/framework/selected_rows.h:26 (rows_ +
value_ + height_) and its kernels (operators/math/selected_rows_functor.cc:
merge_add, scatter update paths); the JAX package's
paddle_tpu/core/selected_rows.py.

Two representations:

- `SelectedRows` — (rows, values, height) over torch tensors. `rows` may
  hold duplicates (as in the reference); consumers merge. Both tensors
  have static shapes a step (the batch's ids and their gradient rows), so
  a sparse gradient lives inside a captured CUDA graph like any tensor,
  and the update is one scatter instead of a dense [vocab, dim] gradient.

- `SparseTable` — the parameter server's auto-growing table (reference
  lookup_sparse_table_op.cc AutoGrownIndex + selected_rows.h Get/Set). It
  stays on the host, numpy-backed, keyed by raw id so a mod-sharded
  pserver never rebases indices. A row is initialized on first touch from
  a uniform draw seeded by its id, the JAX package's own draw, so the two
  packages' tables hold the same bits.
"""

import numpy as np
import torch

from .dtypes import to_host

__all__ = ["SelectedRows", "SparseTable", "merge_selected_rows"]


class SelectedRows:
    """rows: int [R]; values: [R, ...dim]; height: logical dim-0 size."""

    def __init__(self, rows, values, height):
        self.rows = rows
        self.values = values
        self.height = int(height)

    @property
    def dtype(self):
        return self.values.dtype

    def to_dense(self):
        """Scatter-add into a dense [height, ...dim] tensor (duplicates
        sum). index_put_ with accumulate=True adds each id's rows in order
        on the card too: the same bits at every run."""
        v = self.values
        dense = torch.zeros((self.height,) + tuple(v.shape[1:]),
                            dtype=v.dtype, device=v.device)
        dense.index_put_((self.rows.reshape(-1).long(),), v,
                         accumulate=True)
        return dense

    def __repr__(self):
        return (f"SelectedRows(rows={tuple(self.rows.shape)}, "
                f"values={tuple(self.values.shape)}, height={self.height})")


def merge_selected_rows(sr):
    """Host-side duplicate-row merge (reference math::scatter::MergeAdd):
    a SelectedRows of numpy rows and values, rows unique and sorted, each
    the sum of its duplicates in their order."""
    rows = to_host(sr.rows).reshape(-1)
    full = to_host(sr.values)
    values = full.reshape(rows.shape[0], -1)
    uniq, inv = np.unique(rows, return_inverse=True)
    merged = np.zeros((uniq.shape[0], values.shape[1]), values.dtype)
    np.add.at(merged, inv, values)
    merged = merged.reshape((uniq.shape[0],) + tuple(full.shape[1:]))
    return SelectedRows(uniq, merged, sr.height)


class SparseTable:
    """Auto-growing embedding table for the pserver path.

    reference lookup_sparse_table_op.cc (auto_grown gather with uniform
    init between min/max) + the distributed table's sgd update
    (distribute_transpiler.py _create_table_optimize_block).
    """

    def __init__(self, value_dim, height=None, dtype="float32",
                 init_low=-0.05, init_high=0.05, seed=0):
        self.value_dim = int(value_dim)
        self.height = height  # logical vocab size (None = unbounded)
        self.dtype = np.dtype(dtype)
        self.init_low = float(init_low)
        self.init_high = float(init_high)
        self.seed = int(seed)
        self._index = {}           # id -> row in _data[:_size]
        self._data = np.zeros((0, self.value_dim), self.dtype)
        self._size = 0             # rows in use (capacity grows geometrically)

    def __len__(self):
        return len(self._index)

    def rows(self):
        """Known ids, in insertion order."""
        return np.fromiter(self._index.keys(), dtype=np.int64,
                           count=len(self._index))

    def _init_row(self, id_):
        rng = np.random.RandomState((self.seed * 0x9E3779B1 + int(id_))
                                    & 0x7FFFFFFF)
        return rng.uniform(self.init_low, self.init_high,
                           self.value_dim).astype(self.dtype)

    def _grow(self, ids):
        # a repeated unseen id claims exactly one row, in first-seen order
        new = list(dict.fromkeys(i for i in ids if i not in self._index))
        if not new:
            return
        need = self._size + len(new)
        if need > self._data.shape[0]:
            # geometric growth: amortized O(rows) copying on the prefetch
            # path, which holds the server's lock
            cap = max(need, 2 * self._data.shape[0], 64)
            grown = np.zeros((cap, self.value_dim), self.dtype)
            grown[:self._size] = self._data[:self._size]
            self._data = grown
        for i in new:
            self._data[self._size] = self._init_row(i)
            self._index[int(i)] = self._size
            self._size += 1

    def gather(self, ids, auto_grow=True):
        """rows for `ids` [N] -> [N, value_dim]; unknown ids are initialized
        (auto_grow) or returned as zeros."""
        ids = to_host(ids).reshape(-1).astype(np.int64)
        if self.height is not None and ids.size and \
                (ids.min() < 0 or ids.max() >= self.height):
            raise IndexError(
                f"sparse-table id out of range [0, {self.height}): "
                f"{ids.min()}..{ids.max()}")
        if auto_grow:
            self._grow(ids.tolist())
            idx = np.fromiter((self._index[int(i)] for i in ids),
                              dtype=np.int64, count=ids.size)
            return self._data[idx]
        outv = np.zeros((ids.size, self.value_dim), self.dtype)
        for k, i in enumerate(ids):
            j = self._index.get(int(i))
            if j is not None:
                outv[k] = self._data[j]
        return outv

    def scatter_sub(self, rows, deltas):
        """param[rows] -= deltas (rows must be unique; grow-on-miss)."""
        rows = to_host(rows).reshape(-1).astype(np.int64)
        deltas = np.asarray(deltas, self.dtype).reshape(rows.size,
                                                        self.value_dim)
        self._grow(rows.tolist())
        idx = np.fromiter((self._index[int(i)] for i in rows),
                          dtype=np.int64, count=rows.size)
        np.subtract.at(self._data, idx, deltas)

    def sgd_update(self, grad, lr):
        """Apply one SGD step from a SelectedRows gradient."""
        m = merge_selected_rows(grad)
        self.scatter_sub(m.rows, np.asarray(m.values) * float(lr))

    def to_dense(self, height=None):
        """Dense [height, value_dim] snapshot. Rows never touched by a
        lookup or update are ZERO here, not their first-touch init."""
        height = height if height is not None else self.height
        if height is None:
            height = (max(self._index) + 1) if self._index else 0
        dense = np.zeros((int(height), self.value_dim), self.dtype)
        for i, j in self._index.items():
            if 0 <= i < height:
                dense[i] = self._data[j]
        return dense
