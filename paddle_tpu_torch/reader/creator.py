"""Reader creators (reference python/paddle/reader/creator.py)."""

import numpy as np

__all__ = ["np_array", "text_file", "recordio"]


def np_array(x):
    """reader yielding rows of a numpy array."""

    def reader():
        for e in np.asarray(x):
            yield e

    return reader


def text_file(path):
    """reader yielding stripped lines of a text file."""

    def reader():
        with open(path) as f:
            for line in f:
                yield line.rstrip("\n")

    return reader


def recordio(paths, buf_size=100):
    """reader over recordio file(s) (reference creator.py:59); uses the
    native recordio scanner."""
    from ..recordio import Scanner

    if isinstance(paths, str):
        paths = paths.split(",")

    def reader():
        for p in paths:
            s = Scanner(p)
            for rec in s:
                yield rec

    return reader
