"""RecordIO Python surface over the native C++ library (the JAX package's
paddle_tpu/recordio.py, with its own copy of native/recordio.cc built at
first use by native/build.py): a file either package writes, the other
reads, byte for byte.

Reference parity: paddle/fluid/recordio/ (writer/scanner) +
python/paddle/fluid/recordio_writer.py (convert_reader_to_recordio_file).
Records are arbitrary byte strings; the fluid-style tensor convention
pickles a tuple of (numpy array, lod) per slot.

API parity only: the on-disk chunk layout (see native/recordio.cc) is NOT
the reference's container format, so files are not interchangeable with the
reference toolchain.
"""

import ctypes
import pickle

import numpy as np

__all__ = ["Writer", "Scanner", "convert_reader_to_recordio_file",
           "read_recordio_samples"]

_lib = None


def _load():
    global _lib
    if _lib is None:
        from .native.build import recordio_lib

        lib = ctypes.CDLL(recordio_lib())
        lib.rio_writer_open.restype = ctypes.c_void_p
        lib.rio_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                        ctypes.c_int]
        lib.rio_writer_write.restype = ctypes.c_int
        lib.rio_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_uint64]
        lib.rio_writer_flush.argtypes = [ctypes.c_void_p]
        lib.rio_writer_close.argtypes = [ctypes.c_void_p]
        lib.rio_scanner_open.restype = ctypes.c_void_p
        lib.rio_scanner_open.argtypes = [ctypes.c_char_p]
        lib.rio_scanner_next.restype = ctypes.c_int
        lib.rio_scanner_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
            ctypes.POINTER(ctypes.c_uint64)]
        lib.rio_scanner_next_batch.restype = ctypes.c_int
        lib.rio_scanner_next_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64))]
        lib.rio_scanner_skip.restype = ctypes.c_uint64
        lib.rio_scanner_skip.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.rio_scanner_reset.argtypes = [ctypes.c_void_p]
        lib.rio_scanner_close.argtypes = [ctypes.c_void_p]
        lib.rio_free.argtypes = [ctypes.POINTER(ctypes.c_char)]
        _lib = lib
    return _lib


class Writer:
    def __init__(self, path, compressor="zlib", max_num_records=1000):
        lib = _load()
        self._lib = lib
        self._h = lib.rio_writer_open(
            path.encode(), 1 if compressor == "zlib" else 0, max_num_records)
        if not self._h:
            raise IOError(f"cannot open {path} for append")

    def write(self, record: bytes):
        if self._lib.rio_writer_write(self._h, record, len(record)) != 0:
            raise IOError("recordio write failed")

    def flush(self):
        if self._lib.rio_writer_flush(self._h) != 0:
            raise IOError("recordio flush failed")

    def close(self):
        if self._h:
            self._lib.rio_writer_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Scanner:
    def __init__(self, path):
        lib = _load()
        self._lib = lib
        self._h = lib.rio_scanner_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open {path}")

    def __iter__(self):
        buf = ctypes.POINTER(ctypes.c_char)()
        ln = ctypes.c_uint64()
        while self._lib.rio_scanner_next(
                self._h, ctypes.byref(buf), ctypes.byref(ln)):
            data = ctypes.string_at(buf, ln.value)
            self._lib.rio_free(buf)
            yield data

    def read_batch(self, n):
        """Up to n records in ONE native call (one ctypes crossing + one
        allocation, vs per-record round-trips through __iter__). May return
        fewer than n at a chunk boundary; [] at end of stream."""
        buf = ctypes.POINTER(ctypes.c_char)()
        lens = ctypes.POINTER(ctypes.c_uint64)()
        got = self._lib.rio_scanner_next_batch(
            self._h, int(n), ctypes.byref(buf), ctypes.byref(lens))
        if got <= 0:
            return []
        try:
            base = ctypes.addressof(buf.contents)
            out, off = [], 0
            for i in range(got):
                ln = lens[i]
                out.append(ctypes.string_at(base + off, ln))
                off += ln
            return out
        finally:
            self._lib.rio_free(buf)
            self._lib.rio_free(
                ctypes.cast(lens, ctypes.POINTER(ctypes.c_char)))

    def skip(self, n):
        """Skip up to n records without copying them across the C boundary
        (fully-skipped chunks are fseek'd past undecoded — the sharded-read
        fast path). Returns the count actually skipped (< n only at end of
        stream)."""
        return int(self._lib.rio_scanner_skip(self._h, int(n)))

    def reset(self):
        self._lib.rio_scanner_reset(self._h)

    def close(self):
        if self._h:
            self._lib.rio_scanner_close(self._h)
            self._h = None


def convert_reader_to_recordio_file(filename, reader_creator, feeder=None,
                                    compressor="zlib", max_num_records=1000):
    """reference fluid/recordio_writer.py: serialize each sample (optionally
    through a DataFeeder) into one record. Returns record count.

    Record format (what the reader ops consume): a list of
    (numpy array, lod-or-None) slot tuples. With a feeder, slots follow
    feeder.feed_names order."""
    n = 0
    with Writer(filename, compressor, max_num_records) as w:
        for sample in reader_creator():
            if feeder is not None:
                fed = feeder.feed([sample])
                slots = []
                for name in feeder.feed_names:
                    t = fed[name]
                    lod = t.lod() if hasattr(t, "lod") and t.lod() else None
                    arr = np.asarray(t.numpy() if hasattr(t, "numpy") else t)
                    slots.append((arr, lod))
                sample = slots
            w.write(pickle.dumps(sample, protocol=4))
            n += 1
    return n


def read_recordio_samples(filename):
    """Iterate deserialized samples from a recordio file."""
    s = Scanner(filename)
    try:
        for rec in s:
            yield pickle.loads(rec)
    finally:
        s.close()
