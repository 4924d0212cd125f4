"""Async atomic checkpointing: snapshot in the step gap, write off-thread.

Layout (the JAX package's, byte for byte; it shares the io.py
`checkpoint_<serial>/_SUCCESS` naming so io._get_latest_checkpoint_serial
sees both formats):

    <dir>/checkpoint_<serial>/
        state.npz       every checkpoint var (params + optimizer state),
                        host numpy, non-pickled; int64 vars as int32 and
                        float64 as float32, as the JAX package runs them
        manifest.json   step counter, var index, datapipe source position,
                        monitor step counter, caller extras, and the
                        port's own `torch_rng` (the program's random
                        stream), which the JAX package's restore ignores
        _SUCCESS        written INSIDE the temp dir; the dir only appears
                        under its final name via os.replace, so a reader
                        can never observe a half-written checkpoint

Write protocol: serialize + fsync every file into `checkpoint_<N>.tmp`,
fsync the temp dir, os.replace to the final name, fsync the parent —
rename-atomicity end to end (a crash at ANY point leaves either the
previous checkpoint set intact or a `.tmp` orphan that the LRU sweep
removes).

The card is never blocked by a write. save() enqueues, on the current
stream, one copy per var into a set of pinned host buffers that the
manager allocates once (`reserve`, which the training loop calls before
its first step) and reuses (the step gap's only cost), and
records an event after them; the next step, replayed on the same stream,
runs after the copies, so it cannot overwrite a tensor before it is read.
Only the background writer thread waits on that event, then serializes
and fsyncs. A save waits for the writer to finish with the buffers
before it refills them, which at a sane cadence it already has. On the
CPU the snapshot is a numpy copy.
"""

import json
import os
import queue
import threading
import time

import numpy as np
import torch

from .. import monitor

__all__ = ["CheckpointManager", "inspect_dir", "check_mesh_compat"]

MANIFEST_FILENAME = "manifest.json"
STATE_FILENAME = "state.npz"
FORMAT = "resilience-v1"
RNG_KEY = "torch_rng"


def _fsync_dir(path):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platforms without dir fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_fsync(path, data, mode="w"):
    with open(path, mode) as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def check_mesh_compat(ckpt_mesh, expect_mesh):
    """Refuse a restore whose mesh geometry conflicts with the target.

    The dp axis is layout-independent by contract (zero1 snapshots are
    canonical full layout, so a dp=8 checkpoint restores onto dp=4
    bitwise) and may differ freely. Every OTHER axis (mp/pp/sp) changes
    what the saved tensors MEAN — a silent mismatch is silent corruption
    — so any difference raises ValueError. Missing axes count as size 1;
    either side None skips the check (pre-mesh checkpoints stay
    restorable)."""
    if not ckpt_mesh or not expect_mesh:
        return
    from ..parallel.mesh import DP_AXIS

    axes = set(ckpt_mesh) | set(expect_mesh)
    for ax in sorted(axes):
        if ax == DP_AXIS:
            continue
        have = int(ckpt_mesh.get(ax, 1))
        want = int(expect_mesh.get(ax, 1))
        if have != want:
            raise ValueError(
                f"checkpoint mesh geometry conflict on axis {ax!r}: "
                f"checkpoint was saved with {ax}={have}, the target mesh "
                f"has {ax}={want}. Only the dp axis may change across a "
                f"restore (layout-independent contract); re-shard the "
                f"model or restore onto a mesh with matching {ax}.")


def _saved_mesh(manifest):
    """The geometry a checkpoint was saved on: its mesh section, with the
    pipeline section's stage count as pp where the mesh names none (the
    host-driven PipelineRunner runs every stage in one process, on no
    mesh)."""
    mesh = dict(manifest.get("mesh") or {})
    pinfo = manifest.get("pipeline")
    if pinfo and "pp" not in mesh:
        mesh["pp"] = int(pinfo.get("stages", 1))
    return mesh or None


def _storable(v):
    """A scope value as a dense tensor, or None where a checkpoint cannot
    hold it (ragged values, host objects)."""
    from ..core.lod_tensor import LoDTensor
    from ..core.registry import SeqTensor

    if isinstance(v, LoDTensor):
        if v.lod():
            return None  # ragged persistables don't round-trip through npz
        v = torch.from_numpy(np.asarray(v.numpy()))
    if isinstance(v, SeqTensor) or not isinstance(v, torch.Tensor):
        if isinstance(v, np.ndarray) and v.dtype != object:
            return torch.from_numpy(v)
        return None
    return v.detach()


def _saved_dtype(dtype):
    """The numpy dtype a var of `dtype` (torch or numpy) is written as:
    the JAX package's, 64-bit types narrowed."""
    from ..ops.io_ops import _NARROW

    if isinstance(dtype, torch.dtype):
        dtype = torch.empty(0, dtype=dtype).numpy().dtype
    dtype = np.dtype(dtype)
    return np.dtype(_NARROW.get(dtype, dtype))


class _Snapshot:
    """The host side of one save: {name: pinned tensor or ndarray}, and
    the CUDA event after the copies that fill them (None on the CPU)."""

    def __init__(self, arrays, event):
        self.arrays = arrays
        self.event = event

    def numpy(self):
        """{name: ndarray} as the checkpoint holds them: the saved dtypes,
        a ZeRO-1 accumulator in its canonical full layout. Waits for the
        copies; an array may be a view of a reused pinned buffer."""
        from ..parallel import zero1 as _zero1

        if self.event is not None:
            self.event.synchronize()
        out = {}
        for n, a in self.arrays.items():
            a = a.numpy() if isinstance(a, torch.Tensor) else a
            want = _saved_dtype(a.dtype)
            out[n] = a if a.dtype == want else a.astype(want)
        return _zero1.canonicalize_snapshot(out)[0]


class CheckpointManager:
    """Async atomic checkpoints of a scope's checkpoint vars.

    checkpoint_dir:       root directory (created on first save)
    max_num_checkpoints:  LRU retention (io._lru_delete semantics)
    async_write:          False = save() blocks until the rename lands
                          (tests, final checkpoint before exit)
    predicate:            var filter; default io._is_checkpoint_var
                          (persistables minus feed/fetch/reader/grads)
    """

    def __init__(self, checkpoint_dir, max_num_checkpoints=3,
                 async_write=True, predicate=None):
        self.checkpoint_dir = str(checkpoint_dir)
        self.max_num_checkpoints = int(max_num_checkpoints)
        self.async_write = bool(async_write)
        self._predicate = predicate
        # mesh geometry ({axis: size}) stamped into every manifest; None =
        # no mesh section (the port keeps no ambient mesh)
        self.mesh_axes = None
        self._serial = None        # last assigned serial
        self._pending = queue.Queue(maxsize=2)  # bounds host snapshots held
        self._writer = None
        self._write_error = [None]
        self._lock = threading.Lock()
        self._closed = False
        # the pinned host buffers a card's snapshot lands in, allocated at
        # the first save and reused: {name: tensor}; set while no write
        # reads them
        self._pinned = {}
        self._buffers_free = threading.Event()
        self._buffers_free.set()
        # CUDA events around the last snapshot's copies (step-gap cost)
        self._gap_events = None

    # ------------------------------------------------------------- internals
    def _pred(self):
        if self._predicate is not None:
            return self._predicate
        from .. import io as io_mod

        return io_mod._is_checkpoint_var

    def _ensure_writer(self):
        if self._writer is None or not self._writer.is_alive():
            self._writer = threading.Thread(
                target=self._writer_loop, daemon=True,
                name="resilience-ckpt-writer")
            self._writer.start()

    def _writer_loop(self):
        while True:
            job = self._pending.get()
            if job is None:
                return
            try:
                self._write_one(*job)
            except Exception as e:
                # surfaced to the caller on the next save()/wait()
                self._write_error[0] = e
            finally:
                self._pending.task_done()

    def _serial_dir(self, serial):
        from .. import io as io_mod

        return io_mod._get_serial_dir(serial, self.checkpoint_dir)

    def _next_serial(self):
        from .. import io as io_mod

        latest = io_mod._get_latest_checkpoint_serial(self.checkpoint_dir)
        with self._lock:
            nxt = max(latest, self._serial if self._serial is not None
                      else -1) + 1
            self._serial = nxt
        return nxt

    def _write_one(self, serial, snap, manifest):
        from .. import io as io_mod

        t0 = time.perf_counter()
        try:
            arrays = snap.numpy()
            final_dir = self._serial_dir(serial)
            tmp_dir = final_dir + ".tmp"
            if os.path.isdir(tmp_dir):
                import shutil

                shutil.rmtree(tmp_dir, ignore_errors=True)
            os.makedirs(tmp_dir)
            with open(os.path.join(tmp_dir, STATE_FILENAME), "wb") as f:
                np.savez(f, **arrays)
                f.flush()
                os.fsync(f.fileno())
        finally:
            self._buffers_free.set()
        _write_fsync(os.path.join(tmp_dir, MANIFEST_FILENAME),
                     json.dumps(manifest, indent=1, sort_keys=True))
        _write_fsync(os.path.join(tmp_dir,
                                  io_mod.SUCCESS_MARK_FILENAME),
                     time.ctime())
        _fsync_dir(tmp_dir)
        os.replace(tmp_dir, final_dir)  # the atomic commit point
        _fsync_dir(self.checkpoint_dir)
        io_mod._lru_delete(self.checkpoint_dir, self.max_num_checkpoints)
        ms = (time.perf_counter() - t0) * 1000.0
        reg = monitor.registry()
        reg.counter("checkpoints_saved_total",
                    help="atomic checkpoints committed").inc()
        reg.gauge("checkpoint_write_ms",
                  help="serialize+fsync+rename wall time of the last "
                       "checkpoint (background thread)").set(ms)
        reg.histogram("checkpoint_write_ms_hist",
                      help="checkpoint write time distribution").observe(ms)

    def _pinned_like(self, name, shape, dtype):
        buf = self._pinned.get(name)
        if buf is None or tuple(buf.shape) != tuple(shape) \
                or buf.dtype != dtype:
            buf = self._pinned[name] = torch.empty(
                shape, dtype=dtype, pin_memory=True)
        return buf

    def _tensors(self, scope, program):
        """(name, tensor) of every checkpoint var of `program` that `scope`
        holds as a dense tensor, sorted by name."""
        from ..core.framework import default_main_program
        from ..core.scope import global_scope

        scope = scope if scope is not None else global_scope()
        program = program if program is not None else default_main_program()
        pred = self._pred()
        for name in sorted({v.name for v in program.list_vars()
                            if pred(v)}):
            v = scope.find_var(name)
            t = _storable(v) if v is not None else None
            if t is not None:
                yield name, t

    def reserve(self, scope=None, program=None):
        """Allocate the pinned buffers a card's snapshot of `program`'s
        checkpoint vars lands in, ahead of the first save: pinning ~200 MB
        takes ~0.1 s of host time, which a save would otherwise spend in
        the step gap. A ZeRO-1 accumulator's buffer holds its [W, shard]
        array. A no-op on the CPU."""
        from ..parallel import zero1 as _zero1
        from ..parallel.autoshard import lower as _lower

        for name, t in self._tensors(scope, program):
            if t.device.type != "cuda":
                continue
            shape = tuple(t.shape)
            reg = _zero1.registered_entry(name)
            if reg is not None and reg[0].parts > 1 \
                    and shape == (1, reg[1].shard):
                shape = (reg[0].parts, reg[1].shard)
            local = _lower.local_entry(name)
            if local is not None and shape == local[3]:
                shape = local[2]
            self._pinned_like(name, shape, t.dtype)

    def _snapshot(self, scope, program):
        """The step-gap half of a save: every checkpoint var of `program`
        in `scope`, a ZeRO-1 accumulator's row gathered into the JAX
        package's [W, shard] array (parallel.zero1.saved_layout, a
        collective every rank calls, in one order), copied to the host."""
        from ..parallel import zero1 as _zero1
        from ..parallel.autoshard import lower as _lower

        self._buffers_free.wait()  # the writer is done with the buffers
        host, stream, events = {}, None, None
        try:
            for name, t in self._tensors(scope, program):
                t = _lower.full_value(name, _zero1.saved_layout(name, t))
                if t.device.type != "cuda":
                    host[name] = t.numpy().copy()
                    continue
                if stream is None:
                    stream = torch.cuda.current_stream(t.device)
                    events = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                    events[0].record(stream)
                    self._buffers_free.clear()
                buf = self._pinned_like(name, t.shape, t.dtype)
                buf.copy_(t, non_blocking=True)
                host[name] = buf
        except BaseException:
            if events is not None:
                stream.synchronize()
            self._buffers_free.set()
            raise
        if events is not None:
            events[1].record(stream)
        self._gap_events = events
        return _Snapshot(host, events[1] if events is not None else None)

    # ------------------------------------------------------------------- API
    def last_gap_ms(self):
        """Card milliseconds of the last save's snapshot copies (CUDA
        events around them; waits for them), or None on the CPU."""
        if self._gap_events is None:
            return None
        start, end = self._gap_events
        end.synchronize()
        return start.elapsed_time(end)

    def save(self, step, scope=None, program=None, pipe=None, extra=None,
             block=False, rng=None):
        """Snapshot now, commit in the background; returns the serial.

        step:  the caller's global step counter (manifest `step`)
        pipe:  a datapipe.DataPipe whose source position rides the
               manifest (checkpoint_state) so restore resumes mid-epoch
        extra: caller dict merged into the manifest (JSON-serializable)
        block: wait for the rename before returning (overrides
               async_write=True for this call)
        rng:   the program's random stream state (Executor.rng_state),
               the manifest's `torch_rng`
        """
        if self._closed:
            raise RuntimeError("CheckpointManager is closed")
        self._raise_pending_error()
        snap = self._snapshot(scope, program)
        # ZeRO-1 (parallel.zero1): optimizer accumulators live on-device in
        # [dp, shard] padded layout; checkpoints always store the canonical
        # full layout so a checkpoint restores bitwise onto ANY dp size —
        # including FLAGS_zero1=0. The shard layout rides the manifest for
        # `checkpoint inspect`. Only the shapes are read here; the writer
        # unpads the arrays (_Snapshot.numpy).
        from ..parallel import zero1 as _zero1

        zinfo, vars_ = {}, {}
        for n, a in snap.arrays.items():
            shape = tuple(a.shape)
            reg = _zero1.registered_entry(n)
            if reg is not None and shape == (reg[0].parts, reg[1].shard):
                plan, e = reg
                shape = tuple(e.shape)
                zinfo.setdefault(e.param, e.describe(plan.parts))
            vars_[n] = {"dtype": str(_saved_dtype(a.dtype)),
                        "shape": list(shape)}
        serial = self._next_serial()
        manifest = {
            "format": FORMAT,
            "serial": serial,
            "step": int(step),
            "ts": time.time(),
            "vars": vars_,
        }
        if zinfo:
            manifest["zero1"] = zinfo
        # Autoshard (parallel.autoshard): mp-sharded vars are gathered
        # whole by the snapshot (lower.full_value), so it is the canonical
        # full layout; the registered plan's digest + per-param specs ride
        # the manifest (mirroring the zero1 contract) so `checkpoint
        # inspect` shows the layout and restores stay layout-independent.
        from ..parallel import autoshard as _autoshard

        ainfo = _autoshard.manifest_section(snap.arrays)
        if ainfo:
            manifest["autoshard"] = ainfo
        # Pipeline parallelism (parallel.pipeline): stage count, pp axis,
        # microbatches, schedule. Purely descriptive — the snapshot holds
        # every stage's params in full layout — but `checkpoint inspect`
        # renders it, and restore refuses a pp-mismatched target
        # (`_saved_mesh`).
        from ..parallel import pipeline as _pipeline

        pinfo = _pipeline.manifest_section()
        if pinfo:
            manifest["pipeline"] = pinfo
        if self.mesh_axes:
            manifest["mesh"] = {str(a): int(s)
                                for a, s in self.mesh_axes.items()}
        if pipe is not None and hasattr(pipe, "checkpoint_state"):
            manifest["datapipe"] = pipe.checkpoint_state()
        if monitor.enabled():
            manifest["monitor"] = {"steps": monitor.steps_done()}
        if extra:
            manifest["extra"] = dict(extra)
        if rng is not None:
            manifest[RNG_KEY] = rng
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        if self.async_write and not block:
            self._ensure_writer()
            self._pending.put((serial, snap, manifest))
        else:
            self._write_one(serial, snap, manifest)
        return serial

    def _raise_pending_error(self):
        e, self._write_error[0] = self._write_error[0], None
        if e is not None:
            raise e

    def wait(self):
        """Block until every queued write has committed (or raise the
        background writer's failure)."""
        self._pending.join()
        self._raise_pending_error()

    def close(self):
        if self._closed:
            return
        self._closed = True
        if self._writer is not None and self._writer.is_alive():
            self._pending.put(None)
            self._writer.join(timeout=30.0)
        self._pinned.clear()
        self._raise_pending_error()

    # --------------------------------------------------------------- restore
    def latest_serial(self):
        from .. import io as io_mod

        return io_mod._get_latest_checkpoint_serial(self.checkpoint_dir)

    def restore(self, scope=None, program=None, place=None, serial=None,
                expect_mesh=None):
        """Load the latest (or given) checkpoint's vars into `scope` as
        tensors on `place`'s device (the card by default), each in its
        var's declared dtype when `program` is given (the JAX package
        writes int64 vars as int32); returns the manifest dict, or None
        when no successful checkpoint exists. Restoring a serial written
        by io.save_checkpoint (no manifest) raises — use
        io.load_checkpoint for the op-based format. expect_mesh ({axis:
        size}) refuses the restore on a non-dp geometry conflict
        (check_mesh_compat) BEFORE any var is touched. The scope's
        tensors are replaced: a captured step of the scope copies them
        into the tensors its graph reads at its next run
        (CapturedStep.sync_scope)."""
        from ..core import dtypes
        from ..core.places import CUDAPlace, device_for
        from ..core.scope import global_scope

        serial = self.latest_serial() if serial is None else int(serial)
        if serial < 0:
            return None
        cur_dir = self._serial_dir(serial)
        mpath = os.path.join(cur_dir, MANIFEST_FILENAME)
        if not os.path.isfile(mpath):
            raise ValueError(
                f"{cur_dir} is not a resilience checkpoint (no manifest); "
                f"io.load_checkpoint reads the op-based format")
        with open(mpath) as f:
            manifest = json.load(f)
        if expect_mesh is not None:
            check_mesh_compat(_saved_mesh(manifest), expect_mesh)
        scope = scope if scope is not None else global_scope()
        declared = None
        if program is not None:
            pred = self._pred()
            declared = {v.name: v.dtype for v in program.list_vars()
                        if pred(v)}
        device = device_for(place if place is not None else CUDAPlace(0))
        with np.load(os.path.join(cur_dir, STATE_FILENAME)) as data:
            for n in data.files:
                if declared is not None and n not in declared:
                    continue
                t = torch.from_numpy(np.array(data[n], copy=True))
                want = declared.get(n) if declared is not None else None
                if want is not None:
                    t = t.to(dtypes.to_torch(dtypes.canonicalize(want)))
                scope.var(n)
                scope.set_var(n, t.to(device))
        monitor.registry().counter(
            "checkpoint_restores_total",
            help="checkpoints restored into a scope").inc()
        if monitor.enabled() and "monitor" in manifest:
            monitor.restore_steps(manifest["monitor"].get("steps", 0))
        return manifest


def inspect_dir(checkpoint_dir, serial=None):
    """Checkpoint-directory summary for the CLI: serials found, which are
    committed (_SUCCESS), and the chosen serial's manifest / var files.
    Handles both the resilience format and io.save_checkpoint's."""
    from .. import io as io_mod

    out = {"checkpoint_dir": str(checkpoint_dir), "serials": [],
           "latest": -1}
    if not os.path.isdir(checkpoint_dir):
        out["error"] = "no such directory"
        return out
    for name in sorted(os.listdir(checkpoint_dir)):
        path = os.path.join(checkpoint_dir, name)
        if not os.path.isdir(path):
            continue
        entry = {"dir": name}
        if name.endswith(".tmp"):
            entry["status"] = "orphaned-tmp"
            out["serials"].append(entry)
            continue
        try:
            entry["serial"] = int(
                name.split(io_mod.CHECKPOINT_SEPARATOR)[-1])
        except ValueError:
            continue
        committed = os.path.isfile(
            os.path.join(path, io_mod.SUCCESS_MARK_FILENAME))
        entry["status"] = "committed" if committed else "incomplete"
        entry["bytes"] = sum(
            os.path.getsize(os.path.join(path, f))
            for f in os.listdir(path)
            if os.path.isfile(os.path.join(path, f)))
        out["serials"].append(entry)
    out["latest"] = io_mod._get_latest_checkpoint_serial(checkpoint_dir)
    pick = out["latest"] if serial is None else int(serial)
    if pick >= 0:
        cur = io_mod._get_serial_dir(pick, checkpoint_dir)
        mpath = os.path.join(cur, MANIFEST_FILENAME)
        if os.path.isfile(mpath):
            with open(mpath) as f:
                out["manifest"] = json.load(f)
        elif os.path.isdir(cur):
            out["files"] = sorted(
                f for f in os.listdir(cur)
                if f != io_mod.SUCCESS_MARK_FILENAME)
            out["format"] = "io-save-ops"
    return out
