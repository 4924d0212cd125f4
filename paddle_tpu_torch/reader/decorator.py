"""Reader decorators (reference python/paddle/reader/decorator.py:29-236).

Same composition surface: map_readers, shuffle, chain, compose, buffered,
firstn, xmap_readers (parallel map over a thread pool), cache.
"""

import itertools
import random
import time
from queue import Queue
from threading import Thread

__all__ = [
    "map_readers", "buffered", "compose", "chain", "shuffle", "firstn",
    "xmap_readers", "cache", "to_datapipe",
]


def to_datapipe(reader, feed_names):
    """Adapt a legacy decorated reader (a creator yielding positional
    tuples) into a datapipe.DataPipe whose samples are {name: value} dicts
    keyed by feed_names — the migration bridge from the reader-decorator
    stack to the prefetching pipeline (.batch()/.prefetch_to_device() are
    then available on the result)."""
    from ..datapipe import DataPipe

    return DataPipe.from_reader(reader, feed_names=feed_names)


def map_readers(func, *readers):
    """reader of func(sample, sample, ...) zipped over readers
    (reference decorator.py:29)."""

    def reader():
        rs = [r() for r in readers]
        for e in zip(*rs):
            yield func(*e)

    return reader


def shuffle(reader, buf_size):
    """buffered shuffle (reference decorator.py:64)."""

    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            random.shuffle(buf)
            for b in buf:
                yield b

    return data_reader


def chain(*readers):
    """concatenate readers (reference decorator.py:91)."""

    def reader():
        rs = [r() for r in readers]
        for e in itertools.chain(*rs):
            yield e

    return reader


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, **kwargs):
    """(a,b), (c,) -> (a,b,c) zipped tuples (reference decorator.py:112)."""
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        if isinstance(x, tuple):
            return x
        return (x,)

    def reader():
        rs = [r() for r in readers]
        if check_alignment:
            # raise when lengths differ (reference decorator.py: izip_longest
            # + ComposeNotAligned when check_alignment=True)
            for outputs in itertools.zip_longest(*rs):
                if any(o is None for o in outputs):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned")
                yield sum(map(make_tuple, outputs), ())
        else:
            # silently truncate to the shortest reader
            for outputs in zip(*rs):
                yield sum(map(make_tuple, outputs), ())

    return reader


def buffered(reader, size):
    """prefetch into a bounded queue on a worker thread
    (reference decorator.py:160)."""

    class EndSignal:
        pass

    end = EndSignal()

    def read_worker(r, q):
        for d in r:
            q.put(d)
        q.put(end)

    def data_reader():
        r = reader()
        q = Queue(maxsize=size)
        t = Thread(target=read_worker, args=(r, q))
        t.daemon = True
        t.start()
        e = q.get()
        while e is not end:
            yield e
            e = q.get()

    return data_reader


def firstn(reader, n):
    """first n samples (reference decorator.py:191)."""

    def firstn_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item

    return firstn_reader


def cache(reader):
    """materialize once, replay from memory."""
    all_data = []
    filled = []

    def cache_reader():
        if not filled:
            all_data.extend(reader())
            filled.append(True)
        for d in all_data:
            yield d

    return cache_reader


class XmapEndSignal:
    pass


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """parallel map over a thread pool (reference decorator.py:205
    multiprocess/threaded xmap)."""
    end = XmapEndSignal()

    def read_worker(reader, in_queue):
        for i in reader():
            in_queue.put(i)
        in_queue.put(end)

    def order_read_worker(reader, in_queue):
        for order_id, sample in enumerate(reader()):
            in_queue.put((order_id, sample))
        in_queue.put(end)

    def handle_worker(in_queue, out_queue, mapper):
        sample = in_queue.get()
        while not isinstance(sample, XmapEndSignal):
            out_queue.put(mapper(sample))
            sample = in_queue.get()
        in_queue.put(end)
        out_queue.put(end)

    def order_handle_worker(in_queue, out_queue, mapper, out_order):
        ins = in_queue.get()
        while not isinstance(ins, XmapEndSignal):
            order_id, sample = ins
            result = mapper(sample)
            while order_id != out_order[0]:
                time.sleep(1e-4)
            out_queue.put(result)
            out_order[0] += 1
            ins = in_queue.get()
        in_queue.put(end)
        out_queue.put(end)

    def xreader():
        in_queue = Queue(buffer_size)
        out_queue = Queue(buffer_size)
        out_order = [0]
        target = order_read_worker if order else read_worker
        t = Thread(target=target, args=(reader, in_queue))
        t.daemon = True
        t.start()
        target = order_handle_worker if order else handle_worker
        args = (in_queue, out_queue, mapper, out_order) if order else (
            in_queue, out_queue, mapper)
        workers = []
        for i in range(process_num):
            worker = Thread(target=target, args=args)
            worker.daemon = True
            workers.append(worker)
        for w in workers:
            w.start()

        finish = 0
        sample = out_queue.get()
        while finish < process_num:
            if isinstance(sample, XmapEndSignal):
                finish += 1
            else:
                yield sample
            if finish < process_num:
                sample = out_queue.get()

    return xreader
