"""Variable-transport RPC runtime: the gRPC-runtime equivalent.

Reference parity: paddle/fluid/operators/detail/ (grpc_client.h:164
AsyncSendVariable/AsyncGetVariable + batch/fetch barriers :136-160,
grpc_server.h:47 AsyncGRPCServer, protocol send_recv.proto:17
SendVariable/GetVariable) and listen_and_serv_op.cc's sync update loop;
the JAX package's paddle_tpu/parallel/rpc.py.

Transport: length-prefixed pickled messages over TCP sockets. The bytes
on the wire are the JAX package's: the magic b"PTRV", the payload's length
as 8 big-endian bytes, then the pickled (protocol 4) message tuple, whose
variables are dicts with the same keys (kind, data, dtype, shape, lod;
rows and height for SelectedRows). So a port client and a JAX server, or
the reverse, exchange every kind of variable. A tensor on a card crosses
as numpy after one device-to-host copy; bf16, which numpy lacks, widens
to float32 (exactly). A message is received into one preallocated
bytearray (`recv_into`), linear in its size.

The server mirrors RunSyncUpdate: collect grads from all trainers ->
barrier -> run the optimize blocks -> serve params until the fetch
barrier. `save_port` writes the bound port to a file (reference
listen_and_serv_op.cc SavePort), so a parent can find a forked pserver.
"""

import os
import pickle
import socket
import struct
import tempfile
import threading
import time
import traceback
import zlib

import numpy as np
import torch

from ..core.dtypes import to_host

__all__ = ["VariableClient", "VariableServer", "serialize_var",
           "deserialize_var", "RpcError", "dial", "dump_crc_blob",
           "load_crc_blob"]


def dial(endpoint, timeout):
    """Connect to a "host:port" endpoint, retrying a refused connect (a
    pserver still starting) until `timeout` seconds have passed; the
    returned socket is blocking: a sync-mode get waits for the slowest
    trainer's round."""
    host, port = endpoint.rsplit(":", 1)
    deadline = time.monotonic() + timeout
    while True:
        try:
            sock = socket.create_connection(
                (host, int(port)), timeout=max(deadline - time.monotonic(),
                                               0.01))
            break
        except ConnectionRefusedError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.05)
    sock.settimeout(None)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock


class RpcError(RuntimeError):
    """Typed failure from the variable server (reference PADDLE_ENFORCE on
    gRPC statuses)."""


def _check_ok(resp, what):
    if resp != ("ok",):
        detail = resp[1] if isinstance(resp, tuple) and len(resp) > 1 else resp
        raise RpcError(f"{what} failed: {detail}")


_MAGIC = b"PTRV"


def dump_crc_blob(path, obj):
    """Atomically persist `obj` as a CRC32-prefixed pickle (tmp + rename,
    both fsynced): the pserver checkpoint's framing, the JAX package's."""
    payload = pickle.dumps(obj, protocol=4)
    blob = zlib.crc32(payload).to_bytes(4, "big") + payload
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def load_crc_blob(path):
    with open(path, "rb") as f:
        blob = f.read()
    crc, payload = blob[:4], blob[4:]
    if zlib.crc32(payload).to_bytes(4, "big") != crc:
        raise IOError(f"corrupt snapshot/checkpoint {path!r}")
    return pickle.loads(payload)


def _send_msg(sock, obj):
    """Frame and send `obj`; returns the payload's bytes."""
    payload = pickle.dumps(obj, protocol=4)
    sock.sendall(_MAGIC + struct.pack(">Q", len(payload)))
    sock.sendall(payload)
    return len(payload)


def _recv_exact(sock, n):
    """n bytes from `sock`, received in place into one bytearray."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("peer closed")
        got += k
    return buf


def _recv_msg(sock):
    hdr = _recv_exact(sock, 12)
    if hdr[:4] != _MAGIC:
        raise ConnectionError("bad frame magic")
    (ln,) = struct.unpack(">Q", hdr[4:])
    return pickle.loads(_recv_exact(sock, ln))


def _dtype(name):
    """numpy dtype of a wire dtype name; "bfloat16" (what the JAX package
    sends for a bf16 array) reads as its raw 16 bits."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _array(data, name, shape):
    arr = np.frombuffer(data, dtype=_dtype(name)).reshape(shape)
    if name == "bfloat16":
        return torch.from_numpy(arr.copy()).view(torch.bfloat16).float() \
            .numpy()
    return arr.copy()


def serialize_var(value):
    """LoDTensor / SeqTensor / SelectedRows / tensor / numpy -> wire dict
    (send_recv.proto VariableMessage: dims, lod, serialized bytes; the
    SelectedRows kind carries rows + height like the reference's
    SelectedRows message)."""
    from ..core.lod_tensor import LoDTensor
    from ..core.registry import SeqTensor
    from ..core.selected_rows import SelectedRows

    if isinstance(value, SelectedRows):
        rows = to_host(value.rows).reshape(-1).astype(np.int64)
        vals = to_host(value.values)
        return {"kind": "selected_rows", "data": vals.tobytes(),
                "dtype": str(vals.dtype), "shape": vals.shape,
                "rows": rows.tobytes(), "height": value.height, "lod": []}
    if isinstance(value, SeqTensor):
        lengths = to_host(value.lengths).reshape(-1)
        offsets = np.concatenate([[0], np.cumsum(lengths)]).tolist()
        value = LoDTensor(to_host(value.data)[:offsets[-1]], [offsets])
    if isinstance(value, LoDTensor):
        arr = np.asarray(value.numpy())
        return {"kind": "lod_tensor", "data": arr.tobytes(),
                "dtype": str(arr.dtype), "shape": arr.shape,
                "lod": value.lod()}
    arr = to_host(value)
    return {"kind": "tensor", "data": arr.tobytes(),
            "dtype": str(arr.dtype), "shape": arr.shape, "lod": []}


def deserialize_var(msg):
    """wire dict -> numpy array, LoDTensor (a tensor with a LoD) or a
    SelectedRows of numpy rows and values."""
    from ..core.lod_tensor import LoDTensor
    from ..core.selected_rows import SelectedRows

    arr = _array(msg["data"], msg["dtype"], msg["shape"])
    if msg["kind"] == "selected_rows":
        rows = np.frombuffer(msg["rows"], dtype=np.int64)
        return SelectedRows(rows.copy(), arr, msg["height"])
    if msg["kind"] == "lod_tensor" and msg["lod"]:
        return LoDTensor(arr, msg["lod"])
    return arr


class VariableClient:
    """Per-endpoint connection (reference RPCClient, grpc_client.h:164)."""

    def __init__(self, endpoint, connect_timeout=60.0, timeout=None):
        """`timeout`: seconds a reply may take (None: no limit), past which
        a call raises (socket.timeout, an OSError)."""
        self._sock = dial(endpoint, connect_timeout)
        self._sock.settimeout(timeout)

    def send_var(self, name, value):
        """Send `value` as `name`; returns the message's payload bytes."""
        n = _send_msg(self._sock, ("send", name, serialize_var(value)))
        _check_ok(_recv_msg(self._sock), f"send_var({name})")
        return n

    def get_var(self, name):
        _send_msg(self._sock, ("get", name))
        resp = _recv_msg(self._sock)
        tag, payload = resp[0], resp[1]
        if tag == "err":
            raise RpcError(f"get_var({name}) failed: {payload}")
        return deserialize_var(payload)

    def prefetch(self, table_name, ids):
        """reference grpc_client.h AsyncPrefetchVariable: send lookup ids,
        receive the table rows (served by the pserver's prefetch block)."""
        ids = to_host(ids).reshape(-1).astype(np.int64)
        _send_msg(self._sock, ("prefetch", table_name, serialize_var(ids)))
        resp = _recv_msg(self._sock)
        if resp[0] == "err":
            raise RpcError(f"prefetch({table_name}) failed: {resp[1]}")
        return deserialize_var(resp[1])

    def batch_barrier(self):
        """reference BATCH_BARRIER_MESSAGE after grads sent."""
        _send_msg(self._sock, ("batch_barrier",))
        _check_ok(_recv_msg(self._sock), "batch_barrier")

    def fetch_barrier(self):
        """reference FETCH_BARRIER_MESSAGE after params fetched."""
        _send_msg(self._sock, ("fetch_barrier",))
        _check_ok(_recv_msg(self._sock), "fetch_barrier")

    def shutdown(self):
        """Ask the server to stop, and close."""
        try:
            _send_msg(self._sock, ("exit",))
        except OSError:
            pass
        self._sock.close()


class VariableServer:
    """Sync-update variable server (reference AsyncGRPCServer +
    listen_and_serv_op RunSyncLoop).

    on_round(recv_names) is invoked once all `num_trainers` batch barriers
    arrive; it should run the optimize blocks against the owning scope.
    Gets are served only between on_round's end and the fetch barriers
    (sync semantics), and before the first round. In async mode each received grad calls
    on_grad(name) at once; prefetches call on_prefetch(table, ids) at any
    time."""

    def __init__(self, bind="127.0.0.1:0", num_trainers=1, get_var=None,
                 put_var=None, on_round=None, sync_mode=True, on_grad=None,
                 on_prefetch=None):
        host, port = bind.rsplit(":", 1)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, int(port)))
        self._listener.listen(64)
        self.port = self._listener.getsockname()[1]
        self.num_trainers = num_trainers
        self.sync_mode = sync_mode
        self._get_var = get_var
        self._put_var = put_var
        self._on_round = on_round
        self._on_grad = on_grad
        self._on_prefetch = on_prefetch
        self._lock = threading.Condition()
        self._batch_count = 0
        self._fetch_count = 0
        # before its first round a sync server serves the params its
        # startup made, so a trainer can pull them before step 1 (the JAX
        # package's server holds every get until a round is done)
        self._round_done = True
        self._received = []
        self._stop = False
        self._threads = []

    def save_port(self, path=None):
        """Write the bound port to `path` (default: paddle.<pid>.port in
        the temp directory); returns the path."""
        path = path or os.path.join(tempfile.gettempdir(),
                                    f"paddle.{os.getpid()}.port")
        tmp = f"{path}.{self.port}.tmp"  # servers of one process race
        with open(tmp, "w") as f:
            f.write(str(self.port))
        os.replace(tmp, path)
        return path

    # ------------------------------------------------------------------
    def serve_forever(self):
        """Accept loop; one thread per connection (reference grpc_server
        thread pools). Returns after stop() (or a client's exit), its
        listener closed."""
        accept_thread = threading.Thread(target=self._accept_loop,
                                         daemon=True)
        accept_thread.start()
        try:
            with self._lock:
                while not self._stop:
                    self._lock.wait(0.1)
        finally:
            self.close()
            accept_thread.join(timeout=5)

    def close(self):
        """Stop, and close the listener: a client's connect is refused."""
        self.stop()
        self._listener.close()

    def start(self):
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def stop(self):
        with self._lock:
            self._stop = True
            self._lock.notify_all()

    def _accept_loop(self):
        self._listener.settimeout(0.2)
        while not self._stop:
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(None)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    # ------------------------------------------------------------------
    def _serve_conn(self, conn):
        try:
            while True:
                msg = _recv_msg(conn)
                op = msg[0]
                if op == "send":
                    _, name, payload = msg
                    value = deserialize_var(payload)
                    with self._lock:
                        self._received.append(name)
                    if self._put_var:
                        self._put_var(name, value)
                    if not self.sync_mode and self._on_grad:
                        # async update (reference async_update.md): this
                        # grad's optimize block runs at once
                        with self._lock:
                            self._on_grad(name)
                    _send_msg(conn, ("ok",))
                elif op == "batch_barrier":
                    self._handle_batch_barrier()
                    _send_msg(conn, ("ok",))
                elif op == "get":
                    _, name = msg
                    with self._lock:
                        while self.sync_mode and not self._round_done \
                                and not self._stop:
                            self._lock.wait(0.1)
                    try:
                        value = self._get_var(name)
                    except KeyError as e:
                        _send_msg(conn, ("err", str(e)))
                    else:
                        _send_msg(conn, ("var", serialize_var(value)))
                elif op == "prefetch":
                    # served at any time (reference prefetch runs outside
                    # the sync round: the table grows on first touch)
                    _, table_name, payload = msg
                    if self._on_prefetch is None:
                        _send_msg(conn, ("err", "no prefetch handler"))
                    else:
                        ids = deserialize_var(payload)
                        with self._lock:
                            rows = self._on_prefetch(table_name, ids)
                        _send_msg(conn, ("rows", serialize_var(rows)))
                elif op == "fetch_barrier":
                    self._handle_fetch_barrier()
                    _send_msg(conn, ("ok",))
                elif op == "exit":
                    self.stop()
                    return
        except (ConnectionError, EOFError, OSError):
            return
        except Exception as e:
            traceback.print_exc()
            try:
                _send_msg(conn, ("err", f"server error: {e!r}"))
            except OSError:
                pass
            return
        finally:
            conn.close()

    def _handle_batch_barrier(self):
        with self._lock:
            self._batch_count += 1
            if self._batch_count >= self.num_trainers:
                received, self._received = self._received, []
                self._batch_count = 0
                if self._on_round:
                    self._on_round(received)
                self._round_done = True
                self._lock.notify_all()
            else:
                while self._batch_count != 0 and not self._stop:
                    self._lock.wait(0.1)

    def _handle_fetch_barrier(self):
        with self._lock:
            self._fetch_count += 1
            if self._fetch_count >= self.num_trainers:
                self._fetch_count = 0
                if self.sync_mode:
                    self._round_done = False
                self._lock.notify_all()
            else:
                while self._fetch_count != 0 and not self._stop:
                    self._lock.wait(0.1)
