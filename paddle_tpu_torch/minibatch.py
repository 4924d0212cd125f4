"""paddle.batch equivalent (reference python/paddle/batch.py)."""

__all__ = ["batch"]


def batch(reader, batch_size, drop_last=False):
    """group a sample reader into a batch reader of sample lists."""

    def batch_reader():
        r = reader()
        b = []
        for instance in r:
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader
