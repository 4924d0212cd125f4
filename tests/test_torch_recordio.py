"""The port's RecordIO (paddle_tpu_torch/recordio.py over its own copy of
native/recordio.cc, built at first use into native/build/) against the JAX
package's: a file written by either package's Writer is byte-equal to the
other's, and each Scanner reads the other's file; the torn-chunk,
huge-header and convert_reader_to_recordio_file cases of
tests/test_recordio_readers.py, on the port.
"""

import os
import pickle
import struct

import numpy as np
import pytest

from paddle_tpu import recordio as jrecordio

from paddle_tpu_torch import recordio as trecordio
from paddle_tpu_torch.native import build as tbuild


def _records(n, seed=0):
    rs = np.random.RandomState(seed)
    return [pickle.dumps((rs.rand(int(rs.randint(1, 40))).astype(
        np.float32), i), protocol=4) for i in range(n)]


def _write(mod, path, records, compressor, per_chunk):
    with mod.Writer(str(path), compressor=compressor,
                    max_num_records=per_chunk) as w:
        for r in records:
            w.write(r)


def test_the_port_builds_its_own_library():
    """The library the port loads is its own build of its own source, not
    the JAX package's."""
    trecordio._load()
    lib = tbuild.recordio_lib()
    assert os.path.dirname(lib) == tbuild.BUILD_DIR
    assert os.path.dirname(os.path.dirname(lib)) == os.path.dirname(
        os.path.abspath(tbuild.__file__))
    with open(os.path.join(os.path.dirname(tbuild.__file__),
                           "recordio.cc")) as f:
        port_src = f.read()
    import paddle_tpu

    with open(os.path.join(os.path.dirname(paddle_tpu.__file__), "native",
                           "recordio.cc")) as f:
        assert f.read() == port_src


@pytest.mark.parametrize("compressor", ["none", "zlib"])
@pytest.mark.parametrize("per_chunk", [1, 7, 1000])
def test_files_are_byte_equal_and_each_reads_the_other(tmp_path, compressor,
                                                       per_chunk):
    records = _records(50)
    jpath, tpath = tmp_path / "j.rio", tmp_path / "t.rio"
    _write(jrecordio, jpath, records, compressor, per_chunk)
    _write(trecordio, tpath, records, compressor, per_chunk)
    assert tpath.read_bytes() == jpath.read_bytes()
    assert list(trecordio.Scanner(str(jpath))) == records
    assert list(jrecordio.Scanner(str(tpath))) == records


def test_read_batch_skip_and_reset_match_the_jax_scanner(tmp_path):
    records = _records(30, seed=1)
    path = tmp_path / "b.rio"
    _write(trecordio, path, records, "zlib", 8)
    got = {}
    for name, mod in (("jax", jrecordio), ("port", trecordio)):
        s = mod.Scanner(str(path))
        seen = [s.skip(5)]
        seen += [s.read_batch(4), s.read_batch(100)]
        s.reset()
        seen.append(s.read_batch(3))
        seen.append(s.skip(1000))
        seen.append(s.read_batch(2))
        s.close()
        got[name] = seen
    assert got["port"] == got["jax"]
    assert got["port"][0] == 5 and got["port"][-1] == []


def test_recordio_roundtrip(tmp_path):
    path = str(tmp_path / "data.rio")
    with trecordio.Writer(path) as w:
        for i in range(100):
            w.write(pickle.dumps(i))
    assert [pickle.loads(r) for r in trecordio.Scanner(path)] == \
        list(range(100))


def test_recordio_torn_chunk_tolerated(tmp_path):
    path = str(tmp_path / "torn.rio")
    with trecordio.Writer(path, max_num_records=10) as w:
        for i in range(100):
            w.write(pickle.dumps(i))
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[:-30])  # corrupt the tail chunk
    got = [pickle.loads(r) for r in trecordio.Scanner(path)]
    assert 0 < len(got) < 100
    assert got == list(range(len(got)))  # prefix intact
    assert got == [pickle.loads(r) for r in jrecordio.Scanner(path)]


def test_recordio_huge_stored_len_header(tmp_path):
    """A corrupt chunk header claiming a huge stored_len ends the scan
    cleanly, instead of aborting the process via bad_alloc across the C
    ABI."""
    path = str(tmp_path / "huge.rio")
    with trecordio.Writer(path, max_num_records=10) as w:
        for i in range(20):
            w.write(pickle.dumps(i))
    raw = bytearray(open(path, "rb").read())
    # chunk header: magic(4) n(4) codec(4) raw_len(8) stored_len(8) crc(4)
    stored1 = struct.unpack_from("<Q", raw, 20)[0]
    off2 = 32 + stored1
    assert raw[off2:off2 + 4] == b"RIOC"
    struct.pack_into("<Q", raw, off2 + 20, 1 << 62)
    with open(path, "wb") as f:
        f.write(raw)
    got = [pickle.loads(r) for r in trecordio.Scanner(path)]
    assert got == list(range(10))  # first chunk intact, scan ends cleanly


def test_convert_reader_to_recordio(tmp_path):
    path = str(tmp_path / "conv.rio")

    def reader():
        for i in range(10):
            yield [(np.full((3,), i, dtype="float32"), None)]

    assert trecordio.convert_reader_to_recordio_file(path, reader) == 10
    back = list(trecordio.read_recordio_samples(path))
    np.testing.assert_allclose(back[3][0][0], np.full((3,), 3))
    jpath = str(tmp_path / "jconv.rio")
    jrecordio.convert_reader_to_recordio_file(jpath, reader)
    assert open(path, "rb").read() == open(jpath, "rb").read()


def test_convert_through_a_data_feeder_matches_the_jax_package(tmp_path):
    """convert_reader_to_recordio_file with a DataFeeder: each package's
    feeder packs the samples, and the files are byte-equal."""
    import paddle_tpu as jfluid
    import paddle_tpu_torch as tfluid

    def reader():
        rs = np.random.RandomState(3)
        for i in range(6):
            yield rs.rand(4).astype(np.float32), int(i % 3)

    paths = {}
    for name, fluid in (("jax", jfluid), ("port", tfluid)):
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="int64")
            feeder = fluid.DataFeeder(feed_list=[x, y],
                                      place=fluid.CPUPlace(), program=main)
        paths[name] = str(tmp_path / f"{name}.rio")
        fluid.recordio.convert_reader_to_recordio_file(
            paths[name], reader, feeder=feeder)
    assert open(paths["port"], "rb").read() == \
        open(paths["jax"], "rb").read()
