"""Reader-as-variable ops: file readers + decorator readers + read (the
JAX package's ops/reader_ops.py, with the double buffer staging onto the
card from pinned memory on a side stream).

Reference parity: paddle/fluid/operators/reader/ (~1810 LoC):
create_recordio_file_reader_op.cc, open_files_op.cc,
create_shuffle_reader_op.cc, create_batch_reader_op.cc,
create_double_buffer_reader_op.cc:34-69 (prefetch thread + blocking queue),
create_multi_pass_reader_op.cc, create_random_data_generator_op.cc,
read_op.cc, reader framework framework/reader.h (ReaderBase /
DecoratedReader chain).

Readers are host objects living in the Scope, exactly like the reference's
Variables holding ReaderHolder. Samples are lists of (numpy array,
lod-or-None) per slot; `read` pops one batch into tensors on the step's
device (a SeqTensor for a LoD slot). Every op here is a host op
(core/executor_core.py READER_OPS): a program holding one runs on the
interpreter, never in a CUDA graph.
"""

import pickle
import random
import threading
from queue import Queue

import numpy as np
import torch

from ..core import dtypes
from ..core.places import device_for, place_from_str
from ..core.registry import register_op, SeqTensor
from .util import out


class ReaderBase:
    """reference framework/reader.h ReaderBase."""

    def read_next(self):
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError


class RecordIOFileReader(ReaderBase):
    def __init__(self, filename, pass_num=1):
        from .. import recordio

        self._scanner = recordio.Scanner(filename)
        self._pass_num = pass_num
        self._cur_pass = 0
        self._it = iter(self._scanner)

    def read_next(self):
        while True:
            rec = next(self._it, None)
            if rec is not None:
                return pickle.loads(rec)
            self._cur_pass += 1
            if self._cur_pass >= self._pass_num:
                return None
            self._scanner.reset()
            self._it = iter(self._scanner)

    def reset(self):
        self._cur_pass = 0
        self._scanner.reset()
        self._it = iter(self._scanner)


class MultiFileReader(ReaderBase):
    """open_files: round-robin over per-file readers (reference
    open_files_op.cc with thread_num prefetchers)."""

    def __init__(self, filenames, pass_num=1):
        self._files = list(filenames)
        self._pass_num = pass_num
        self.reset()

    def reset(self):
        self._readers = [RecordIOFileReader(f, self._pass_num)
                         for f in self._files]
        self._idx = 0

    def read_next(self):
        while self._readers:
            self._idx %= len(self._readers)
            sample = self._readers[self._idx].read_next()
            if sample is None:
                del self._readers[self._idx]
                continue
            self._idx += 1
            return sample
        return None


class RandomDataGenerator(ReaderBase):
    def __init__(self, low, high, shapes):
        self._low = low
        self._high = high
        self._shapes = shapes
        self._rs = np.random.RandomState(0)

    def read_next(self):
        return [(self._rs.uniform(self._low, self._high, s).astype(
            "float32"), None) for s in self._shapes]

    def reset(self):
        pass


class ShuffleReader(ReaderBase):
    def __init__(self, underlying, buffer_size):
        self._u = underlying
        self._n = buffer_size
        self._buf = []
        self._rng = random.Random(0)

    def read_next(self):
        if not self._buf:
            while len(self._buf) < self._n:
                s = self._u.read_next()
                if s is None:
                    break
                self._buf.append(s)
            self._rng.shuffle(self._buf)
        if not self._buf:
            return None
        return self._buf.pop()

    def reset(self):
        self._buf = []
        self._u.reset()


class BatchReader(ReaderBase):
    """stack batch_size samples per slot (reference
    create_batch_reader_op.cc)."""

    def __init__(self, underlying, batch_size):
        self._u = underlying
        self._bs = batch_size

    def read_next(self):
        samples = []
        for _ in range(self._bs):
            s = self._u.read_next()
            if s is None:
                break
            samples.append(s)
        if not samples:
            return None
        n_slots = len(samples[0])
        batched = []
        for i in range(n_slots):
            arrs = [s[i][0] for s in samples]
            lods = [s[i][1] for s in samples]
            if lods[0] is not None:
                # ragged: concat rows, lengths per sample
                lengths = [a.shape[0] for a in arrs]
                batched.append((np.concatenate(arrs, 0), [lengths]))
            else:
                batched.append((np.stack(arrs, 0), None))
        return batched

    def reset(self):
        self._u.reset()


class _Staged:
    """A dense slot copied to the card on the double buffer's stream: the
    device tensor, the event after its copy, and the pinned source (held
    until the copy is done)."""

    __slots__ = ("tensor", "event", "pinned")

    def __init__(self, tensor, event, pinned):
        self.tensor = tensor
        self.event = event
        self.pinned = pinned

    def take(self):
        """The device tensor, ordered after its copy on the current
        stream, which then owns it."""
        cur = torch.cuda.current_stream(self.tensor.device)
        cur.wait_event(self.event)
        self.tensor.record_stream(cur)
        return self.tensor


class DoubleBufferReader(ReaderBase):
    """prefetch thread + bounded queue + DEVICE staging (reference
    create_double_buffer_reader_op.cc:34-69: the reference's worker copies
    each buffered batch into a GPU tensor cache). Here the worker copies
    every dense slot into pinned memory and from there to the card on a
    side stream of its own, with an event the `read` op makes its stream
    wait on, so by the time the consumer pops a batch its tensors are on
    the card (or on their way) and the copy happened off the compute path.
    `device` is a torch.device; on the CPU a slot becomes a host tensor."""

    _END = object()

    def __init__(self, underlying, capacity=4, device=None):
        self._u = underlying
        self._cap = capacity
        self._dev = torch.device("cpu") if device is None \
            else torch.device(device)
        self._stream = torch.cuda.Stream(self._dev) \
            if self._dev.type == "cuda" else None
        self._start()

    def _stage(self, sample):
        staged = []
        for arr, lod in sample:
            if lod is None and hasattr(arr, "shape"):
                a = np.ascontiguousarray(arr)
                if self._stream is None:
                    arr = torch.from_numpy(a.copy())
                else:
                    pinned = torch.empty(a.shape, pin_memory=True,
                                         dtype=torch.from_numpy(
                                             a[:0].copy()).dtype)
                    pinned.numpy()[...] = a
                    with torch.cuda.stream(self._stream):
                        t = pinned.to(self._dev, non_blocking=True)
                        ev = torch.cuda.Event()
                        ev.record(self._stream)
                    arr = _Staged(t, ev, pinned)
            staged.append((arr, lod))
        return staged

    def _start(self):
        # queue + stop flag are captured per-generation: a stale worker that
        # outlives reset() keeps writing to ITS OWN queue and sees ITS OWN
        # stop flag, so it can never feed the new generation
        q = Queue(maxsize=self._cap)
        stop = threading.Event()
        u = self._u

        def work():
            if self._stream is not None:
                torch.cuda.set_device(self._dev)
            while not stop.is_set():
                try:
                    s = u.read_next()
                    item = self._END if s is None else self._stage(s)
                except BaseException as e:  # raised in the consumer
                    item, s = _Failed(e), None
                q.put(item)
                if s is None:
                    return

        self._q = q
        self._stop_evt = stop
        self._exhausted = False
        self._t = threading.Thread(target=work, daemon=True)
        self._t.start()

    def read_next(self):
        # Once EOF is seen, every further read returns None until reset()
        # (the reference keeps re-raising EOF until ReInit); without this a
        # second post-EOF read would block forever on the drained queue.
        if self._exhausted:
            return None
        s = self._q.get()
        if s is self._END:
            self._exhausted = True
            return None
        if isinstance(s, _Failed):
            self._exhausted = True
            raise s.error
        return s

    def reset(self):
        self._stop_evt.set()
        try:
            while True:
                self._q.get_nowait()
        except Exception:
            pass
        self._t.join(timeout=5)
        self._u.reset()
        self._start()


class _Failed:
    """The double buffer's worker failed: `error` is raised in read."""

    def __init__(self, error):
        self.error = error


class DataPipeReader(ReaderBase):
    """Bridge a datapipe.DataPipe into the reader-variable world: each
    read_next() pops one pipeline item (a {name: array} dict, typically a
    batch) and presents it as positional (array, lod) slots in slot_names
    order — so layers.read_file works unchanged on top of the prefetching
    pipeline."""

    def __init__(self, pipe, slot_names):
        self._pipe = pipe
        self._slots = list(slot_names)
        self._it = iter(pipe)

    def read_next(self):
        item = next(self._it, None)
        if item is None:
            return None
        try:
            return [(np.asarray(item[n]), None) for n in self._slots]
        except KeyError as e:
            raise KeyError(
                f"datapipe item is missing slot {e.args[0]!r}; it has "
                f"{sorted(item)}") from None

    def reset(self):
        close = getattr(self._it, "close", None)
        if close:
            close()
        self._it = iter(self._pipe)


# Live DataPipe objects cannot ride in op attrs (attrs must serialize);
# layers.io.open_datapipe parks the pipe here and the creation op carries
# only the integer token.
_datapipe_registry = {}


def register_datapipe(pipe):
    token = len(_datapipe_registry) + 1
    _datapipe_registry[token] = pipe
    return token


class MultiPassReader(ReaderBase):
    def __init__(self, underlying, pass_num):
        self._u = underlying
        self._pass_num = pass_num
        self._cur = 0

    def read_next(self):
        s = self._u.read_next()
        if s is not None:
            return s
        self._cur += 1
        if self._cur >= self._pass_num:
            return None
        self._u.reset()
        return self._u.read_next()

    def reset(self):
        self._cur = 0
        self._u.reset()


# ---------------------------------------------------------------------------
# op kernels (host side)
# ---------------------------------------------------------------------------
def _store_reader(ctx, make_reader):
    """Create-and-store, or reuse: re-running the program must NOT rebuild
    the reader chain (reference reader_op_registry.cc: creation ops are
    no-ops when Out already holds a reader)."""
    op = ctx.current_op
    name = op.output("Out")[0]
    existing = ctx.env.get(name)
    if existing is None and ctx.scope is not None:
        existing = ctx.scope.find_var(name)
    if isinstance(existing, ReaderBase):
        ctx.env[name] = existing
        return {}
    reader = make_reader()
    ctx.env[name] = reader
    if ctx.scope is not None:
        ctx.scope.var(name)
        ctx.scope.set_var(name, reader)
    return {}


@register_op("create_recordio_file_reader", lod_aware=True)
def create_recordio_file_reader_op(ctx, ins, attrs):
    return _store_reader(ctx, lambda: RecordIOFileReader(
        attrs["filename"], attrs.get("pass_num", 1)))


@register_op("open_files", lod_aware=True)
def open_files_op(ctx, ins, attrs):
    return _store_reader(ctx, lambda: MultiFileReader(
        attrs["filenames"], attrs.get("pass_num", 1)))


@register_op("create_random_data_generator", lod_aware=True)
def create_random_data_generator_op(ctx, ins, attrs):
    return _store_reader(ctx, lambda: RandomDataGenerator(
        attrs.get("low", 0.0), attrs.get("high", 1.0), attrs["shapes"]))


def _underlying(ctx, ins):
    r = ins["UnderlyingReader"][0]
    if r is None:
        name = ctx.current_op.input("UnderlyingReader")[0]
        r = ctx.scope.find_var(name) if ctx.scope else None
    return r


@register_op("create_shuffle_reader", lod_aware=True)
def create_shuffle_reader_op(ctx, ins, attrs):
    return _store_reader(ctx, lambda: ShuffleReader(
        _underlying(ctx, ins), attrs.get("buffer_size", 1024)))


@register_op("create_batch_reader", lod_aware=True)
def create_batch_reader_op(ctx, ins, attrs):
    return _store_reader(ctx, lambda: BatchReader(
        _underlying(ctx, ins), attrs.get("batch_size", 1)))


@register_op("create_double_buffer_reader", lod_aware=True)
def create_double_buffer_reader_op(ctx, ins, attrs):
    def make():
        # the op's place attr, else the executor's; a CUDA place without
        # a card raises (device_for)
        place = attrs.get("place", "")
        dev = device_for(place_from_str(place)) if place else ctx.device
        return DoubleBufferReader(_underlying(ctx, ins), device=dev)

    return _store_reader(ctx, make)


@register_op("create_datapipe_reader", lod_aware=True)
def create_datapipe_reader_op(ctx, ins, attrs):
    def make():
        pipe = _datapipe_registry.get(attrs["token"])
        if pipe is None:
            raise ValueError(
                f"datapipe token {attrs['token']} not registered (the "
                f"program outlived the process that built its pipe)")
        return DataPipeReader(pipe, attrs["slot_names"])

    return _store_reader(ctx, make)


@register_op("create_multi_pass_reader", lod_aware=True)
def create_multi_pass_reader_op(ctx, ins, attrs):
    return _store_reader(ctx, lambda: MultiPassReader(
        _underlying(ctx, ins), attrs.get("pass_num", 1)))


@register_op("read", lod_aware=True)
def read_op(ctx, ins, attrs):
    reader = ins["Reader"][0]
    if not isinstance(reader, ReaderBase):
        name = ctx.current_op.input("Reader")[0]
        reader = ctx.scope.find_var(name) if ctx.scope else None
    sample = reader.read_next()
    if sample is None:
        raise StopIteration("reader exhausted")
    vals = []
    block = ctx.current_op.block
    for name, (arr, lod) in zip(ctx.current_op.output("Out"), sample):
        var = block.vars.get(name)
        dtype = dtypes.to_torch(var.dtype) if var is not None \
            and var.dtype is not None else None
        if isinstance(arr, _Staged):
            t = arr.take()
        else:
            t = torch.from_numpy(np.array(arr, copy=True))
        t = t.to(device=ctx.device, dtype=dtype)
        if lod is not None:
            lengths = lod[-1] if isinstance(lod[0], (list, tuple)) else lod
            host = np.asarray(lengths, np.int32)
            vals.append(SeqTensor(t, torch.from_numpy(host.copy()).to(
                ctx.device), host))
        else:
            vals.append(t)
    return out(Out=vals)
