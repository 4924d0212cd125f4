"""IO layers (reference python/paddle/fluid/layers/io.py): `data` and the
reader family (the JAX package's layers/io.py:140-314), whose ops
(ops/reader_ops.py) run on the host. ListenAndServ and Send/Recv wait for
the slice that ports the parameter server (ROADMAP queue 1 item 8)."""

from .. import unique_name
from ..core.framework import (VarType, default_main_program,
                              default_startup_program)
from ..layer_helper import LayerHelper

__all__ = [
    "data", "open_recordio_file", "open_files", "open_datapipe",
    "read_file", "shuffle", "batch", "double_buffer", "multi_pass",
    "random_data_generator",
]


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         type=VarType.LOD_TENSOR, stop_gradient=True):
    """reference layers/io.py:30."""
    helper = LayerHelper("data", name=name)
    shape = list(shape)
    for i in range(len(shape)):
        if shape[i] is None:
            shape[i] = -1
            append_batch_size = False
        elif shape[i] < 0:
            append_batch_size = False
    if append_batch_size:
        shape = [-1] + shape
    return helper.create_global_variable(
        name=name,
        shape=shape,
        dtype=dtype,
        type=type,
        stop_gradient=stop_gradient,
        lod_level=lod_level,
        is_data=True,
    )


# ---------------------------------------------------------------------------
# Readers-as-variables (reference layers/io.py:294+, operators/reader/)
# ---------------------------------------------------------------------------
def _create_reader_var(name, feed_shapes, dtypes_, lod_levels):
    main = default_main_program()
    var = main.global_block().create_var(name=name, type=VarType.READER, persistable=True)
    var._reader_meta = {
        "shapes": feed_shapes,
        "dtypes": dtypes_,
        "lod_levels": lod_levels,
    }
    return var


def open_recordio_file(filename, shapes, lod_levels, dtypes,
                       pass_num=1, for_parallel=False):
    """reference layers/io.py open_recordio_file — creates a file reader var."""
    helper = LayerHelper("open_recordio_file")
    name = unique_name.generate("recordio_reader")
    var = _create_reader_var(name, shapes, dtypes, lod_levels)
    startup = default_startup_program()
    startup.global_block().create_var(name=name, type=VarType.READER, persistable=True)
    startup.global_block().append_op(
        "create_recordio_file_reader",
        {},
        {"Out": [name]},
        {
            "filename": filename,
            "shapes": [list(s) for s in shapes],
            "dtypes": list(dtypes),
            "lod_levels": list(lod_levels),
            "pass_num": pass_num,
        },
    )
    return var


def open_files(filenames, shapes, lod_levels, dtypes, thread_num=1, buffer_size=None,
               pass_num=1, for_parallel=False):
    helper = LayerHelper("open_files")
    name = unique_name.generate("multi_file_reader")
    var = _create_reader_var(name, shapes, dtypes, lod_levels)
    startup = default_startup_program()
    startup.global_block().create_var(name=name, type=VarType.READER, persistable=True)
    startup.global_block().append_op(
        "open_files",
        {},
        {"Out": [name]},
        {
            "filenames": list(filenames),
            "shapes": [list(s) for s in shapes],
            "dtypes": list(dtypes),
            "lod_levels": list(lod_levels),
            "thread_num": thread_num,
            "pass_num": pass_num,
        },
    )
    return var


def open_datapipe(pipe, slot_names, shapes, dtypes, lod_levels=None):
    """Expose a datapipe.DataPipe as a reader VARIABLE, so read_file and
    the rest of the reader-op surface consume the prefetching pipeline.
    Each pipeline item (a {name: array} dict — usually pipe.batch() output)
    becomes one read, slots ordered by slot_names. The live pipe cannot be
    serialized into op attrs, so it is parked in a process-local registry
    and the creation op carries an integer token (programs using this op
    are not portable across processes)."""
    if lod_levels is None:
        lod_levels = [0] * len(slot_names)
    if not (len(slot_names) == len(shapes) == len(dtypes) == len(lod_levels)):
        raise ValueError(
            f"slot_names/shapes/dtypes/lod_levels lengths differ: "
            f"{len(slot_names)}/{len(shapes)}/{len(dtypes)}/"
            f"{len(lod_levels)}")
    from ..ops.reader_ops import register_datapipe

    helper = LayerHelper("open_datapipe")
    name = unique_name.generate("datapipe_reader")
    var = _create_reader_var(name, shapes, dtypes, lod_levels)
    startup = default_startup_program()
    startup.global_block().create_var(name=name, type=VarType.READER, persistable=True)
    startup.global_block().append_op(
        "create_datapipe_reader",
        {},
        {"Out": [name]},
        {
            "token": register_datapipe(pipe),
            "slot_names": list(slot_names),
            "shapes": [list(s) for s in shapes],
            "dtypes": list(dtypes),
            "lod_levels": list(lod_levels),
        },
    )
    return var


def _decorate_reader(op_type, reader, attrs=None):
    helper = LayerHelper(op_type)
    name = unique_name.generate(op_type)
    main = default_main_program()
    new_var = main.global_block().create_var(
        name=name, type=VarType.READER, persistable=True
    )
    new_var._reader_meta = getattr(reader, "_reader_meta", None)
    main.global_block().append_op(
        "create_" + op_type, {"UnderlyingReader": [reader]}, {"Out": [new_var]}, attrs or {}
    )
    return new_var


def shuffle(reader, buffer_size):
    return _decorate_reader("shuffle_reader", reader, {"buffer_size": buffer_size})


def batch(reader, batch_size):
    return _decorate_reader("batch_reader", reader, {"batch_size": batch_size})


def double_buffer(reader, place=None, name=None):
    """reference create_double_buffer_reader_op.cc:34 — a prefetch thread
    stages upcoming batches into DEVICE memory (from pinned memory on a
    side stream, off the compute path). `place` pins the staging device;
    default: the Executor's place at run time."""
    attrs = {}
    if place is not None:
        from ..core.places import place_to_str

        attrs["place"] = place_to_str(place)
    return _decorate_reader("double_buffer_reader", reader, attrs)


def multi_pass(reader, pass_num):
    """reference create_multi_pass_reader_op.cc — replay the underlying
    reader pass_num times (epoch loop as a reader decorator)."""
    return _decorate_reader("multi_pass_reader", reader,
                            {"pass_num": pass_num})


def random_data_generator(low, high, shapes, lod_levels, for_parallel=False):
    helper = LayerHelper("random_data_generator")
    name = unique_name.generate("random_reader")
    var = _create_reader_var(name, shapes, ["float32"] * len(shapes), lod_levels)
    startup = default_startup_program()
    startup.global_block().create_var(name=name, type=VarType.READER, persistable=True)
    startup.global_block().append_op(
        "create_random_data_generator",
        {},
        {"Out": [name]},
        {
            "low": low,
            "high": high,
            "shapes": [list(s) for s in shapes],
            "lod_levels": list(lod_levels),
        },
    )
    return var


def read_file(file_obj):
    """reference read_op: pop one batch from a reader variable."""
    helper = LayerHelper("read_file")
    meta = getattr(file_obj, "_reader_meta", None)
    outs = []
    if meta:
        for shape, dtype, lod in zip(meta["shapes"], meta["dtypes"], meta["lod_levels"]):
            outs.append(
                helper.create_tmp_variable(
                    dtype=dtype, shape=tuple(shape), lod_level=lod,
                    stop_gradient=True)
            )
    else:
        outs.append(
            helper.create_tmp_variable(dtype="float32", stop_gradient=True))
    helper.append_op("read", {"Reader": [file_obj]}, {"Out": outs})
    if len(outs) == 1:
        return outs[0]
    return outs
