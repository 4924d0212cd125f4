"""Dataset cache/location helpers (reference python/paddle/dataset/common.py).

The reference downloads archives with md5 caching into ~/.cache/paddle/dataset.
This build runs with zero network egress: each dataset first looks for files
in the same cache layout (so real data dropped there is used), and otherwise
falls back to a DETERMINISTIC synthetic generator with the exact sample
schema of the real dataset. Training pipelines, shapes, dtypes and LoD
structure are identical either way; only the underlying bits differ.
"""

import hashlib
import os
import pickle

import numpy as np

DATA_HOME = os.path.expanduser(
    os.environ.get("PADDLE_TPU_DATA_HOME", "~/.cache/paddle/dataset"))

__all__ = ["DATA_HOME", "md5file", "cached_path", "split", "cluster_files_reader"]


def md5file(fname):
    hash_md5 = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            hash_md5.update(chunk)
    return hash_md5.hexdigest()


def cached_path(module, fname):
    """Path to a locally-provided dataset file, or None if absent."""
    p = os.path.join(DATA_HOME, module, fname)
    return p if os.path.exists(p) else None


def download(url, module, md5sum=None, save_name=None):
    """reference common.py:download — zero-egress build: only resolves files
    already present in DATA_HOME; raises otherwise."""
    fname = save_name or url.split("/")[-1]
    p = cached_path(module, fname)
    if p is None:
        raise IOError(
            f"dataset file {module}/{fname} not present under {DATA_HOME} "
            "and network egress is disabled; drop the file there or use the "
            "synthetic reader")
    return p


def split(reader, line_count, suffix="%05d.pickle", dumper=pickle.dump):
    """split a reader's samples into chunked pickle files
    (reference common.py:split)."""
    indx_f = 0
    batch = []
    outs = []

    def flush():
        nonlocal indx_f, batch
        if not batch:
            return
        out = suffix % indx_f
        with open(out, "wb") as f:
            dumper(batch, f)
        outs.append(out)
        batch = []
        indx_f += 1

    for sample in reader():
        batch.append(sample)
        if len(batch) == line_count:
            flush()
    flush()
    return outs


def cluster_files_reader(files_pattern, trainer_count, trainer_id,
                         loader=pickle.load):
    """reader over this trainer's shard of chunked files
    (reference common.py:cluster_files_reader)."""
    import glob

    def reader():
        flist = sorted(glob.glob(files_pattern))
        my = flist[trainer_id::trainer_count]
        for fn in my:
            with open(fn, "rb") as f:
                for sample in loader(f):
                    yield sample

    return reader


# ---------------------------------------------------------------------------
# synthetic fallback machinery
# ---------------------------------------------------------------------------
def synthetic_rng(name, split_name):
    """Deterministic per-(dataset, split) RNG."""
    seed = int.from_bytes(
        hashlib.md5(f"{name}:{split_name}".encode()).digest()[:4], "little")
    return np.random.RandomState(seed)
