"""paddle_tpu_torch.resilience against the JAX package's resilience.

The port's counterparts of tests/test_resilience.py (retry and its
classification, the NaN guard, the hang watchdog, preemption, atomic io
and CheckpointManager checkpoints, inspect_dir, the datapipe's position,
the chaos harness, and the Trainer killed and restored, retried, rolled
back) — the master, heartbeater and elastic tests are
tests/test_torch_master.py's and tests/test_torch_elastic.py's — and
what only the port needs:

- a program with dropout killed and restored ends bitwise equal to its
  uninterrupted run, through the datapipe loop, the reader loop and a
  rollback on the (recorded stand-in of the) captured graph: the
  checkpoint carries the program's random stream (`torch_rng`), which the
  JAX package folds from its step counter instead;
- a checkpoint written by the JAX package's CheckpointManager restores
  into the port bitwise, and the reverse; inspect_dir reports the same
  for either, apart from the manifest's `ts`;
- a ZeRO-1 ParallelExecutor at W = 2 gloo ranks checkpoints the
  canonical full layout (the JAX package's manifest `zero1` section), and
  the checkpoint restores bitwise at W = 1;
- a CUDA failure is never classified transient.
"""

import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import flags as jflags
from paddle_tpu.resilience import CheckpointManager as JCheckpointManager
from paddle_tpu.resilience import inspect_dir as jinspect_dir

import paddle_tpu_torch as fluid
from paddle_tpu_torch import flags, io as io_mod, monitor
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.datapipe import shm as tshm
from paddle_tpu_torch.parallel import zero1 as tzero1
from paddle_tpu_torch.resilience import (
    CheckpointManager, NanGuard, NanLossError, Preempted, ResilienceConfig,
    RetryPolicy, TransientError, chaos, inspect_dir, is_transient)
from paddle_tpu_torch.resilience import nan_guard, watchdog
from paddle_tpu_torch.resilience.preempt import PreemptionHandler

import torch_dp_worker as worker
from test_torch_step import recorded_graphs  # noqa: F401

DEADLINE_S = 5.0


@pytest.fixture(autouse=True)
def _fresh_port_state():
    """Fresh default programs, scope, unique names, flags and chaos in the
    port; flags reset in both packages after the test; the test fails if
    it leaks datapipe threads, processes or shared-memory segments."""
    import multiprocessing

    def leaks():
        return ({t for t in threading.enumerate()
                 if t.is_alive() and t.name.startswith("datapipe-")},
                {p for p in multiprocessing.active_children()
                 if p.name.startswith("datapipe-") and p.is_alive()},
                set(tshm.live_segments()))

    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    fluid.unique_name.switch()
    flags.reset()
    chaos.uninstall()
    watchdog.reset()
    tzero1.reset_registry()
    before = leaks()
    yield
    chaos.uninstall()
    flags.reset()
    jflags.reset()
    tzero1.reset_registry()
    deadline = time.time() + DEADLINE_S
    while True:
        leaked = tuple(now - was for now, was in zip(leaks(), before))
        if not any(leaked) or time.time() > deadline:
            break
        time.sleep(0.05)
    assert not any(leaked), f"leaked datapipe workers: {leaked}"


# -- retry/backoff ------------------------------------------------------


def test_retry_transient_retries_then_succeeds():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise TransientError("UNAVAILABLE: link flap")
        return "ok"

    p = RetryPolicy(max_attempts=5, sleep=lambda s: None)
    assert p.call(flaky) == "ok"
    assert len(calls) == 3 and p.last_attempts == 3


def test_retry_fatal_raises_immediately():
    calls = []

    def broken():
        calls.append(1)
        raise ValueError("shape mismatch")

    p = RetryPolicy(max_attempts=5, sleep=lambda s: None)
    with pytest.raises(ValueError):
        p.call(broken)
    assert len(calls) == 1  # programmer errors are never retried


def test_retry_exhaustion_raises_last_error():
    p = RetryPolicy(max_attempts=3, sleep=lambda s: None)
    calls = []

    def always():
        calls.append(1)
        raise TransientError(f"attempt {len(calls)}")

    with pytest.raises(TransientError, match="attempt 3"):
        p.call(always)
    assert len(calls) == 3


def test_retry_backoff_is_exponential_and_capped():
    p = RetryPolicy(max_attempts=9, base_delay_ms=100, max_delay_ms=1000,
                    jitter=0.0, sleep=lambda s: None)
    assert [p.delay_ms(a) for a in range(5)] == [100, 200, 400, 800, 1000]


def test_retry_jitter_draws_the_jax_packages_delays():
    """The same seed gives the same jittered delays in both packages."""
    from paddle_tpu.resilience import RetryPolicy as JRetryPolicy

    got = RetryPolicy(max_attempts=9, seed=3)
    want = JRetryPolicy(max_attempts=9, seed=3)
    assert [got.delay_ms(a) for a in range(6)] == \
        [want.delay_ms(a) for a in range(6)]


def test_is_transient_classification():
    assert is_transient(TransientError("x"))
    assert is_transient(ConnectionResetError("peer gone"))
    assert is_transient(TimeoutError())
    assert is_transient(RuntimeError("UNAVAILABLE: socket closed"))
    assert is_transient(RuntimeError("DEADLINE_EXCEEDED while waiting"))
    assert not is_transient(RuntimeError("RESOURCE_EXHAUSTED: out of HBM"))
    assert not is_transient(ValueError("bad shape"))
    assert not is_transient(KeyboardInterrupt())


def test_is_transient_socket_level_failures():
    import socket

    assert is_transient(ConnectionResetError("peer reset"))
    assert is_transient(BrokenPipeError("send on closed socket"))
    assert is_transient(ConnectionRefusedError("nothing listening"))
    assert is_transient(socket.timeout("recv timed out"))
    assert is_transient(ConnectionError("generic"))


@pytest.mark.parametrize("msg", [
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: unspecified launch failure (ABORTED)",
    "CUBLAS_STATUS_EXECUTION_FAILED when calling cublasGemmEx",
    "cuDNN error: CUDNN_STATUS_EXECUTION_FAILED",
    "NCCL error in ProcessGroupNCCL: unhandled system error, "
    "connection reset by peer",
    "CUDA error: device-side assert triggered"])
def test_cuda_failures_are_never_transient(msg):
    """A failure of the CUDA runtime or its libraries leaves the context
    (or the communicator) unusable: not retried, whatever transport
    marker its message also holds; nor is running out of card memory,
    the card's RESOURCE_EXHAUSTED."""
    assert not is_transient(RuntimeError(msg))
    assert not is_transient(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"))


def test_retry_deadline_ms_stops_mid_backoff():
    now = [0.0]
    slept = []

    def clock():
        return now[0]

    def sleep(s):
        slept.append(s)
        now[0] += s

    calls = []

    def always():
        calls.append(1)
        now[0] += 0.010
        raise TransientError(f"attempt {len(calls)}")

    p = RetryPolicy(max_attempts=10, base_delay_ms=80.0, jitter=0.0,
                    deadline_ms=100.0, clock=clock, sleep=sleep)
    with pytest.raises(TransientError, match="attempt 2"):
        p.call(always)
    assert len(calls) == 2 and p.last_attempts == 2
    assert slept == [0.08]


def test_retry_without_deadline_is_unchanged():
    p = RetryPolicy(max_attempts=3, sleep=lambda s: None)
    assert p.deadline_ms is None
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise TransientError("flap")
        return "ok"

    assert p.call(flaky) == "ok"
    with pytest.raises(ValueError):
        RetryPolicy(deadline_ms=0.0)


def test_retry_budget_deposits_and_spends():
    from paddle_tpu_torch.resilience import RetryBudget

    b = RetryBudget(ratio=0.5, burst=4)
    assert b.tokens == 4.0
    for _ in range(4):
        assert b.try_spend()
    assert not b.try_spend()
    for _ in range(3):
        b.on_request()
    assert b.tokens == 1.5
    assert b.try_spend() and not b.try_spend()
    for _ in range(100):
        b.on_request()
    assert b.tokens == 4.0


def test_the_flags_are_the_jax_packages():
    """The seven resilience flags with the JAX package's types and
    defaults."""
    names = ["resilience_max_attempts", "resilience_backoff_base_ms",
             "resilience_backoff_max_ms", "resilience_nan_policy",
             "resilience_health_policy", "step_deadline_ms",
             "hang_dump_dir", "debug_nans"]
    got, want = flags.all_flags(), jflags.all_flags()
    for n in names:
        assert got[n][:2] == want[n][:2], n


# -- NaN guard ----------------------------------------------------------


def test_scan_non_finite_walks_nested_metrics():
    bad = {"loss": np.float32("nan"),
           "aux": [np.ones(3, np.float32), np.array([1.0, np.inf])]}
    paths = nan_guard.scan_non_finite(bad)
    assert len(paths) == 2
    assert not nan_guard.scan_non_finite({"loss": np.float32(0.5)})
    assert not nan_guard.scan_non_finite({"step": 3, "tag": "x"})


def test_nan_guard_policies():
    bad = [np.float32("nan")]
    with flags.flag_guard(resilience_nan_policy="raise"):
        with pytest.raises(NanLossError):
            NanGuard().check(bad, step=7)
    with flags.flag_guard(resilience_nan_policy="skip"):
        assert NanGuard().check(bad, step=7) == "skip"
    with flags.flag_guard(resilience_nan_policy="restore"):
        assert NanGuard().check(bad, step=7) == "restore"
    with flags.flag_guard(resilience_nan_policy="bogus"):
        with pytest.raises(ValueError):
            NanGuard().check(bad)
    assert NanGuard().check([np.float32(1.0)]) == "ok"


# -- watchdog -----------------------------------------------------------


def test_watchdog_dumps_stacks_on_deadline(tmp_path):
    with flags.flag_guard(step_deadline_ms=50, hang_dump_dir=str(tmp_path)):
        token = watchdog.arm("unit")
        assert token is not None
        time.sleep(0.8)
        assert watchdog.disarm(token)
    dumps = list(tmp_path.glob("hang_unit_*.txt"))
    assert dumps, "no hang dump written"
    text = dumps[0].read_text()
    assert "MainThread" in text and "test_watchdog" in text


def test_watchdog_disabled_by_default():
    assert flags.get("step_deadline_ms") == 0
    assert watchdog.arm("noop") is None


def test_watchdog_dump_writes_the_profiler_timeline(tmp_path):
    """With a profiler session on, the dump also writes its merged chrome
    trace, as the JAX package does."""
    from paddle_tpu_torch import profiler

    profiler.start_profiler("CPU")
    try:
        with profiler.record_event("step"):
            pass
        with flags.flag_guard(hang_dump_dir=str(tmp_path)):
            path = watchdog.dump_stacks("manual")
    finally:
        profiler.stop_profiler(profile_path=str(tmp_path / "profile"))
        profiler.reset_profiler()
    assert os.path.basename(path) == "hang_manual_1.txt" or \
        path.endswith(".txt")
    traces = list(tmp_path.glob("hang_manual_*.trace.json"))
    assert traces
    assert "traceEvents" in json.loads(traces[0].read_text())


def test_executor_arms_the_watchdog_over_the_run(tmp_path):
    """A chaos delay (host side, before the dispatch, inside the armed
    run) past FLAGS_step_deadline_ms makes the executor's run dump; the
    same warm run without the delay does not."""
    main, startup, loss = _tiny_program()
    scope = _fresh_scope(startup)
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(main, feed=_tiny_feed(), fetch_list=[loss])  # warm
        with flags.flag_guard(step_deadline_ms=1000,
                              hang_dump_dir=str(tmp_path)):
            exe.run(main, feed=_tiny_feed(), fetch_list=[loss])
            assert not list(tmp_path.glob("hang_*"))
            monkey = chaos.install(chaos.ChaosMonkey([
                chaos.Fault("delay", at=0, delay_ms=2000.0)]))
            exe.run(main, feed=_tiny_feed(), fetch_list=[loss])
    assert [k for k, _, _ in monkey.injected] == ["delay"]
    assert len(list(tmp_path.glob("hang_executor_*.txt"))) == 1


# -- preemption ---------------------------------------------------------


def test_preemption_handler_defers_and_raises():
    with PreemptionHandler() as h:
        assert h.pending() is None
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.pending() == signal.SIGTERM
        with pytest.raises(Preempted) as ei:
            h.raise_preempted(checkpoint_serial=9)
        assert ei.value.checkpoint_serial == 9
        h.clear()
        assert h.pending() is None
    assert signal.getsignal(signal.SIGTERM) != h._handler


def _echo_pid(i):
    return os.getpid()


def test_decode_workers_do_not_inherit_the_preemption_handler():
    """A forked decode worker started under the handler still dies of the
    parent's terminate() (SIGTERM back to its default) and ignores
    SIGINT, which the parent defers to its step boundary."""
    import multiprocessing

    from paddle_tpu_torch.datapipe import ProcessPoolMap

    with PreemptionHandler() as h:
        m = ProcessPoolMap(range(4), _echo_pid, num_workers=1)
        it = iter(m)
        pid = next(it)
        proc, = [p for p in multiprocessing.active_children()
                 if p.pid == pid]
        os.kill(pid, signal.SIGINT)
        assert next(it) == pid  # alive after SIGINT
        os.kill(pid, signal.SIGTERM)
        proc.join(DEADLINE_S)
        assert proc.exitcode == -signal.SIGTERM
        m.close()
        assert h.pending() is None


# -- program/scope helpers ---------------------------------------------


def _tiny_program(package=fluid):
    main, startup = package.Program(), package.Program()
    with package.unique_name.guard(), package.program_guard(main, startup):
        x = package.layers.data(name="x", shape=[4], dtype="float32")
        y = package.layers.data(name="y", shape=[1], dtype="float32")
        pred = package.layers.fc(input=x, size=1,
                                 param_attr=package.ParamAttr(name="w"),
                                 bias_attr=package.ParamAttr(name="b"))
        loss = package.layers.mean(package.layers.square_error_cost(pred, y))
        package.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(
            loss, startup_program=startup)
    return main, startup, loss


def _tiny_feed(seed=0):
    rs = np.random.RandomState(seed)
    x = rs.rand(8, 4).astype("float32")
    return {"x": x, "y": x.sum(1, keepdims=True)}


def _fresh_scope(startup):
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CPUPlace()).run(startup)
    return scope


def _trained_scope(steps=3):
    main, startup, loss = _tiny_program()
    scope = _fresh_scope(startup)
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        for k in range(steps):
            exe.run(main, feed=_tiny_feed(k), fetch_list=[loss])
    return main, scope


def _state(scope, main):
    from paddle_tpu_torch import convert

    return convert.numpy_state(scope, main)


# -- io.save_checkpoint atomicity --------------------------------------


def test_io_save_checkpoint_atomic(tmp_path):
    main, startup, _ = _tiny_program()
    scope = _fresh_scope(startup)
    ckpt = str(tmp_path)
    with fluid.scope_guard(scope):
        io_mod.save_checkpoint(fluid.Executor(fluid.CPUPlace()), ckpt,
                               max_num_checkpoints=3, save_interval_secs=0,
                               main_program=main)
    assert sorted(os.listdir(ckpt)) == ["checkpoint_0"]
    assert os.path.isfile(os.path.join(ckpt, "checkpoint_0", "_SUCCESS"))


def test_io_latest_serial_skips_truncated_dir(tmp_path):
    main, startup, _ = _tiny_program()
    scope = _fresh_scope(startup)
    ckpt = str(tmp_path)
    with fluid.scope_guard(scope):
        io_mod.save_checkpoint(fluid.Executor(fluid.CPUPlace()), ckpt,
                               max_num_checkpoints=3, save_interval_secs=0,
                               main_program=main)
    truncated = os.path.join(ckpt, "checkpoint_5")
    os.makedirs(truncated)
    with open(os.path.join(truncated, "w"), "wb") as f:
        f.write(b"\x00" * 8)
    os.makedirs(os.path.join(ckpt, "checkpoint_3.tmp"))
    assert io_mod._get_latest_checkpoint_serial(ckpt) == 0


def test_io_lru_delete_ignores_debris_in_retention_count(tmp_path):
    main, startup, _ = _tiny_program()
    scope = _fresh_scope(startup)
    ckpt = str(tmp_path)
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        for _ in range(3):
            io_mod.save_checkpoint(exe, ckpt, max_num_checkpoints=10,
                                   save_interval_secs=0, main_program=main)
    os.makedirs(os.path.join(ckpt, "checkpoint_9"))
    stale_tmp = os.path.join(ckpt, "checkpoint_4.tmp")
    os.makedirs(stale_tmp)
    old = time.time() - 3600
    os.utime(stale_tmp, (old, old))
    os.makedirs(os.path.join(ckpt, "checkpoint_5.tmp"))
    io_mod._lru_delete(ckpt, max_num_checkpoints=2)
    assert sorted(os.listdir(ckpt)) == [
        "checkpoint_1", "checkpoint_2", "checkpoint_5.tmp"]


# -- CheckpointManager --------------------------------------------------


def test_checkpoint_manager_async_atomic_lru(tmp_path):
    main, startup, _ = _tiny_program()
    scope = _fresh_scope(startup)
    mgr = CheckpointManager(str(tmp_path), max_num_checkpoints=2)
    try:
        for step in (4, 8, 12):
            mgr.save(step, scope=scope, program=main,
                     extra={"epoch": step // 8})
        mgr.wait()
        dirs = sorted(d for d in os.listdir(str(tmp_path))
                      if not d.endswith(".tmp"))
        assert len(dirs) == 2
        for d in dirs:
            files = set(os.listdir(os.path.join(str(tmp_path), d)))
            assert {"_SUCCESS", "manifest.json", "state.npz"} <= files
        manifest = mgr.restore(scope=scope, program=main,
                               place=fluid.CPUPlace())
        assert manifest["step"] == 12
        assert manifest["format"] == "resilience-v1"
        assert manifest["extra"]["epoch"] == 1
        assert "w" in manifest["vars"] and "b" in manifest["vars"]
    finally:
        mgr.close()


def test_checkpoint_manager_restore_roundtrip_bitwise(tmp_path):
    main, scope = _trained_scope()
    want = _state(scope, main)
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    try:
        mgr.save(3, scope=scope, program=main)
        _, startup, _ = _tiny_program()
        other = _fresh_scope(startup)
        mgr.restore(scope=other, program=main, place=fluid.CPUPlace())
    finally:
        mgr.close()
    got = _state(other, main)
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
        assert got[n].dtype == want[n].dtype


def test_checkpoint_manager_empty_dir_restores_none(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    try:
        assert mgr.restore(place=fluid.CPUPlace()) is None
        assert mgr.latest_serial() < 0
    finally:
        mgr.close()


def test_checkpoint_restore_rejects_io_format(tmp_path):
    main, startup, _ = _tiny_program()
    scope = _fresh_scope(startup)
    with fluid.scope_guard(scope):
        io_mod.save_checkpoint(fluid.Executor(fluid.CPUPlace()),
                               str(tmp_path), save_interval_secs=0,
                               main_program=main)
    mgr = CheckpointManager(str(tmp_path))
    try:
        with pytest.raises(ValueError, match="manifest"):
            mgr.restore(scope=scope, program=main, place=fluid.CPUPlace())
    finally:
        mgr.close()


def test_checkpoint_restore_refuses_a_model_axis_conflict(tmp_path):
    main, scope = _trained_scope(1)
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.mesh_axes = {"dp": 2, "mp": 2}
    try:
        mgr.save(1, scope=scope, program=main)
        with pytest.raises(ValueError, match="axis 'mp'"):
            mgr.restore(scope=scope, program=main, place=fluid.CPUPlace(),
                        expect_mesh={"dp": 4, "mp": 1})
        assert mgr.restore(scope=scope, program=main,
                           place=fluid.CPUPlace(),
                           expect_mesh={"dp": 4, "mp": 2})["mesh"] == \
            {"dp": 2, "mp": 2}
    finally:
        mgr.close()


def test_inspect_dir_reports_commit_status(tmp_path):
    main, startup, _ = _tiny_program()
    scope = _fresh_scope(startup)
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    try:
        mgr.save(5, scope=scope, program=main)
    finally:
        mgr.close()
    os.makedirs(os.path.join(str(tmp_path), "checkpoint_7"))
    os.makedirs(os.path.join(str(tmp_path), "checkpoint_8.tmp"))
    report = inspect_dir(str(tmp_path))
    status = {e["dir"]: e["status"] for e in report["serials"]}
    assert status["checkpoint_0"] == "committed"
    assert status["checkpoint_7"] == "incomplete"
    assert status["checkpoint_8.tmp"] == "orphaned-tmp"
    assert report["latest"] == 0
    assert report["manifest"]["step"] == 5


# -- checkpoints across the two packages --------------------------------


def _jax_trained_scope(steps=3):
    main, startup, loss = _tiny_program(jfluid)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        for k in range(steps):
            exe.run(main, feed=_tiny_feed(k), fetch_list=[loss])
    return main, scope


def _jax_state(scope, main):
    return {v.name: np.asarray(scope.find_var(v.name))
            for v in main.list_vars()
            if v.persistable and scope.find_var(v.name) is not None
            and not v.name.endswith("@GRAD")}


def test_a_jax_checkpoint_restores_in_the_port_bitwise(tmp_path):
    jmain, jscope = _jax_trained_scope()
    want = _jax_state(jscope, jmain)
    mgr = JCheckpointManager(str(tmp_path), async_write=False)
    try:
        mgr.save(3, scope=jscope, program=jmain, extra={"epoch": 1})
    finally:
        mgr.close()
    main, startup, _ = _tiny_program()
    scope = _fresh_scope(startup)
    port = CheckpointManager(str(tmp_path))
    try:
        manifest = port.restore(scope=scope, program=main,
                                place=fluid.CPUPlace())
    finally:
        port.close()
    assert manifest["step"] == 3 and manifest["extra"] == {"epoch": 1}
    got = _state(scope, main)
    assert set(want) <= set(got)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_a_port_checkpoint_restores_in_the_jax_package_bitwise(tmp_path):
    main, scope = _trained_scope()
    want = _state(scope, main)
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    try:
        mgr.save(3, scope=scope, program=main, extra={"epoch": 1},
                 rng={"device": "cpu", "state": ""})
    finally:
        mgr.close()
    jmain, jstartup, _ = _tiny_program(jfluid)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jstartup)
    jmgr = JCheckpointManager(str(tmp_path))
    try:
        manifest = jmgr.restore(scope=jscope, program=jmain,
                                place=jfluid.CPUPlace())
    finally:
        jmgr.close()
    assert manifest["step"] == 3 and "torch_rng" in manifest
    got = _jax_state(jscope, jmain)
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_inspect_dir_reports_as_the_jax_package(tmp_path):
    """The same checkpoint written by each package's manager: the same
    inspect_dir report (serials, statuses, bytes, manifest) apart from the
    manifest's time stamp; and each package's inspect_dir reads the
    other's directory alike."""
    from paddle_tpu import monitor as jmonitor

    # the manifests' `monitor` section: each package's step count
    monitor.reset()
    jmonitor.reset()
    main, scope = _trained_scope()
    jmain, jscope = _jax_trained_scope()
    dirs = {}
    for name, mgr_cls, args in (
            ("port", CheckpointManager, (scope, main)),
            ("jax", JCheckpointManager, (jscope, jmain))):
        d = str(tmp_path / name)
        mgr = mgr_cls(d, async_write=False)
        try:
            mgr.save(4, scope=args[0], program=args[1], extra={"epoch": 0})
        finally:
            mgr.close()
        dirs[name] = d

    def report(fn, d):
        r = fn(d)
        r["checkpoint_dir"] = None
        # the time stamp, and its digits in manifest.json's size
        ts = r["manifest"].pop("ts")
        for e in r["serials"]:
            e["bytes"] -= len(json.dumps(ts))
        return r

    want = report(jinspect_dir, dirs["jax"])
    assert report(inspect_dir, dirs["port"]) == want
    assert report(inspect_dir, dirs["jax"]) == want
    assert report(jinspect_dir, dirs["port"]) == want


def test_a_zero1_checkpoint_at_two_ranks_restores_at_one(tmp_path):
    """Every rank of a ZeRO-1 ParallelExecutor at W = 2 (gloo) saves a
    checkpoint (the accumulators' rows gathered, a collective): its
    state.npz holds the canonical full layout and its manifest the JAX
    package's `zero1` section; restored into a single process (W = 1) it
    equals the ranks' full-layout state bitwise."""
    import test_torch_parallel as tp

    files = tp.write_inputs(str(tmp_path), [("mlp", "momentum")])
    ck = str(tmp_path / "ck")
    res = worker.launch(2, [tp.port_case(
        "ck", "mlp", "momentum", files[("mlp", "momentum")], zero1=True,
        checkpoint=ck)], str(tmp_path / "ranks"))["ck"]
    want = tp.state_of(res[0])
    for rank in (0, 1):
        report = inspect_dir(os.path.join(ck, str(rank)))
        manifest = report["manifest"]
        assert manifest["zero1"], manifest
        for n, meta in manifest["vars"].items():
            assert tuple(meta["shape"]) == want[n].shape, n
    main, _, _, _ = worker.build(fluid, "mlp", "momentum")
    for rank in (0, 1):
        scope = fluid.Scope()
        mgr = CheckpointManager(os.path.join(ck, str(rank)))
        try:
            mgr.restore(scope=scope, program=main, place=fluid.CPUPlace())
        finally:
            mgr.close()
        got = _state(scope, main)
        assert sorted(got) == sorted(want)
        for n in want:
            np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    # and the JAX package reads it as its own
    jmain, _, _, _ = worker.build(jfluid, "mlp", "momentum")
    jscope = jfluid.Scope()
    mgr = JCheckpointManager(os.path.join(ck, "0"))
    try:
        mgr.restore(scope=jscope, program=jmain, place=jfluid.CPUPlace())
    finally:
        mgr.close()
    for n in want:
        np.testing.assert_array_equal(np.asarray(jscope.find_var(n)),
                                      want[n], err_msg=n)


# -- datapipe position & teardown ---------------------------------------


def _range_pipe(n=40, batch=4, workers=0):
    def reader():
        for i in range(n):
            yield {"x": np.full(2, i, np.float32)}
    p = fluid.DataPipe.from_reader(reader)
    if workers:
        p = p.map(lambda s: s, num_workers=workers)
    return p.batch(batch)


def test_datapipe_checkpoint_state_counts_consumed_records():
    pipe = _range_pipe()
    it = iter(pipe)
    for _ in range(3):
        next(it)
    assert pipe.checkpoint_state()["records"] == 12
    pipe.close()


def test_datapipe_restore_resumes_at_first_unconsumed_record():
    pipe = _range_pipe()
    it = iter(pipe)
    for _ in range(3):
        next(it)
    state = pipe.checkpoint_state()
    pipe.close()
    resumed = _range_pipe()
    resumed.restore_state(state)
    flat = [i for b in resumed for i in b["x"][:, 0].astype(int).tolist()]
    assert flat == list(range(12, 40))


def test_datapipe_restore_with_parallel_map_stage():
    pipe = _range_pipe(workers=2)
    it = iter(pipe)
    for _ in range(2):
        next(it)
    state = pipe.checkpoint_state()
    pipe.close()
    resumed = _range_pipe(workers=2)
    resumed.restore_state(state)
    flat = [i for b in resumed for i in b["x"][:, 0].astype(int).tolist()]
    assert sorted(flat) == list(range(8, 40))


def test_datapipe_mid_stream_close_joins_workers():
    pipe = _range_pipe(n=400, workers=3)
    it = iter(pipe)
    next(it)
    pipe.close()
    deadline = time.time() + 3.0
    while time.time() < deadline:
        alive = [t for t in threading.enumerate()
                 if t.is_alive() and t.name.startswith("datapipe-")]
        if not alive:
            break
        time.sleep(0.05)
    assert not alive, f"workers leaked after close(): {alive}"


def _proc_ident(i):
    return i


def _proc_sample_passthrough(s):
    return s


def _proc_pipe(n=40, batch=4, workers=2):
    def reader():
        for i in range(n):
            yield {"x": np.full(2, i, np.float32)}
    return (fluid.DataPipe.from_reader(reader)
            .map(_proc_sample_passthrough, num_workers=workers,
                 processes=True)
            .batch(batch))


def test_datapipe_restore_with_process_pool_stage():
    pipe = _proc_pipe()
    it = iter(pipe)
    for _ in range(2):
        next(it)
    state = pipe.checkpoint_state()
    pipe.close()
    resumed = _proc_pipe()
    resumed.restore_state(state)
    flat = [i for b in resumed for i in b["x"][:, 0].astype(int).tolist()]
    assert sorted(flat) == list(range(8, 40))
    resumed.close()


def test_datapipe_restore_with_fused_process_stage():
    def make():
        def reader():
            for i in range(32):
                yield {"x": np.full(2, i, np.float32)}
        return (fluid.DataPipe.from_reader(reader)
                .map(_proc_sample_passthrough, num_workers=2,
                     processes=True)
                .prefetch_to_device(place=fluid.CPUPlace(), chunk=2,
                                    capacity=2))

    pipe = make()
    it = iter(pipe)
    for _ in range(3):
        next(it)
    state = pipe.checkpoint_state()
    pipe.close()
    assert state["records"] == 6, state
    resumed = make()
    resumed.restore_state(state)
    seen = []
    for ch in resumed:
        seen.extend(np.asarray(ch["x"])[:, 0].astype(int).tolist())
    assert sorted(seen) == list(range(6, 32))
    resumed.close()


# -- chaos harness ------------------------------------------------------


def test_chaos_delay_and_transient_injection():
    monkey = chaos.ChaosMonkey([
        chaos.Fault("delay", at=0, delay_ms=1.0),
        chaos.Fault("transient", at=1),
    ])
    chaos.install(monkey)
    chaos.on_run("executor")
    with pytest.raises(TransientError):
        chaos.on_run("executor")
    chaos.on_run("executor")
    assert [k for k, _n, _l in monkey.injected] == ["delay", "transient"]


def test_chaos_nan_poison_targets_first_float_leaf():
    monkey = chaos.ChaosMonkey([chaos.Fault("nan", at=2)])
    clean = [np.ones(2, np.float32)]
    assert monkey.poison(1, clean) is clean
    assert np.isfinite(clean[0]).all()
    poisoned = monkey.poison(2, [np.ones(2, np.float32)])
    assert np.isnan(poisoned[0]).any()


def test_chaos_replica_kill_sends_sigkill_to_self(monkeypatch):
    sent = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: sent.append(
        (pid, sig)))
    monkey = chaos.ChaosMonkey([chaos.Fault("replica_kill", at=1)])
    chaos.install(monkey)
    chaos.on_run("executor")
    assert sent == []
    chaos.on_run("executor")
    assert sent == [(os.getpid(), signal.SIGKILL)]
    assert [k for k, _n, _l in monkey.injected] == ["replica_kill"]


def test_chaos_replica_hang_sleeps_dead_but_connected():
    monkey = chaos.ChaosMonkey([
        chaos.Fault("replica_hang", at=0, delay_ms=30.0)])
    chaos.install(monkey)
    t0 = time.perf_counter()
    chaos.on_run("executor")
    assert time.perf_counter() - t0 >= 0.03
    assert chaos.Fault("replica_hang", at=0).delay_ms >= 600_000.0


def test_chaos_load_spike_window_product_and_module_hook():
    assert chaos.load_multiplier(99.0) == 1.0
    monkey = chaos.ChaosMonkey([
        chaos.Fault("load_spike", at=5.0, scale=4.0, duration_s=10.0),
        chaos.Fault("load_spike", at=12.0, scale=2.0, duration_s=10.0),
    ])
    chaos.install(monkey)
    try:
        assert chaos.load_multiplier(0.0) == 1.0
        assert chaos.load_multiplier(5.0) == 4.0
        assert chaos.load_multiplier(13.0) == 8.0
        assert chaos.load_multiplier(15.0) == 2.0
        assert chaos.load_multiplier(22.0) == 1.0
    finally:
        chaos.uninstall()
    assert chaos.load_multiplier(13.0) == 1.0
    assert [k for k, _n, _l in monkey.injected] == ["load_spike"] * 2
    f = chaos.Fault("load_spike", at=0)
    assert f.scale == 2.0 and f.duration_s == 5.0


@pytest.mark.parametrize("kind", ["worker_preempt", "worker_join"])
def test_elastic_faults_and_config_wait_for_the_elastic_controller(kind):
    """The elastic faults through a runner holding an ElasticController
    (both refused until the controller was ported; the name is kept):
    the session joins the membership; worker_preempt's SIGTERM at its
    step drains it (the member leaves) before Preempted is raised;
    worker_join spawns its command at its step and the member stays."""
    import sys

    from paddle_tpu_torch.parallel.elastic import (ElasticConfig,
                                                   ElasticController)
    from paddle_tpu_torch.parallel.master import MasterService
    from paddle_tpu_torch.resilience import ResilientRunner

    main, startup, _ = _tiny_program()
    svc = MasterService()
    ctl = ElasticController(ElasticConfig(
        svc, name="w0", ttl=30.0, heartbeat_interval=0.05,
        checkpoint_on_resize=False, restore_on_resize=False))
    argv = [sys.executable, "-c", "import sys; sys.exit(7)"]
    monkey = chaos.install(chaos.ChaosMonkey([chaos.Fault(kind, at=1,
                                                          argv=argv)]))
    runner = ResilientRunner(ResilienceConfig(elastic=ctl),
                             scope=_fresh_scope(startup), program=main,
                             place=fluid.CPUPlace())
    loss = [np.float32(0.5)]
    try:
        with runner.session():
            assert svc.elastic_membership()["members"] == {"w0": ""}
            runner.after_step(loss)
            assert not monkey.injected
            if kind == "worker_preempt":
                with pytest.raises(Preempted):
                    runner.after_step(loss)
                assert svc.elastic_membership()["members"] == {}
            else:
                runner.after_step(loss)
                assert len(monkey.spawned) == 1
                assert monkey.spawned[0].wait(timeout=30) == 7
                assert svc.elastic_membership()["members"] == {"w0": ""}
                assert ctl.resizes == 0
    finally:
        chaos.uninstall()
        svc.stop()
    assert [k for k, _n, _l in monkey.injected] == [kind]
    assert svc.elastic_membership()["members"] == {}  # stop() left


def test_chaos_health_faults_scale_the_recorded_stats(tmp_path):
    """loss_spike / grad_explode scale the loss and the grad norms that
    the health record holds (the port's health._chaos_scales, as in the
    JAX package), not the training math."""
    from paddle_tpu_torch import health

    main, startup, loss = _tiny_program()
    records, params = {}, {}
    for faulted in (False, True):
        health.reset()
        scope = _fresh_scope(startup)
        if faulted:
            chaos.install(chaos.ChaosMonkey([
                chaos.Fault("loss_spike", at=0, scale=10.0),
                chaos.Fault("grad_explode", at=0, scale=4.0)]))
        with fluid.scope_guard(scope), flags.flag_guard(
                health=True,
                health_ledger=str(tmp_path / f"{faulted}.jsonl")):
            fluid.Executor(fluid.CPUPlace()).run(
                main, feed=_tiny_feed(), fetch_list=[loss])
        chaos.uninstall()
        records[faulted] = health.last_record()
        params[faulted] = _state(scope, main)
    health.reset()
    plain, scaled = records[False], records[True]
    assert scaled["loss"] == pytest.approx(10.0 * plain["loss"], rel=1e-6)
    assert scaled["global_grad_norm"] == pytest.approx(
        4.0 * plain["global_grad_norm"], rel=1e-6)
    _assert_params_equal(params[True], params[False])


# -- process-pool decode under chaos ------------------------------------


def test_chaos_worker_kill_surfaces_datapipe_error():
    from paddle_tpu_torch.datapipe import DataPipeError, ProcessPoolMap

    chaos.install(chaos.ChaosMonkey([chaos.Fault("worker_kill", at=5)]))
    t0 = time.time()
    with pytest.raises(DataPipeError, match="died"):
        for _ in ProcessPoolMap(range(40), _proc_ident, num_workers=2):
            pass
    assert time.time() - t0 < 5.0


def test_chaos_worker_kill_restart_replays_lost_items():
    from paddle_tpu_torch.datapipe import ProcessPoolMap

    chaos.install(chaos.ChaosMonkey([chaos.Fault("worker_kill", at=5)]))
    with flags.flag_guard(datapipe_restart_workers=True, monitor=True):
        out = list(ProcessPoolMap(range(40), _proc_ident, num_workers=2))
    assert out == list(range(40))
    snap = monitor.registry().snapshot()
    assert any(k.startswith("datapipe_worker_restarts_total")
               for k in snap), snap


# -- end to end: trainer + chaos + restore ------------------------------


def _train_net(dropout=False):
    with fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = x
        if dropout:
            h = fluid.layers.fc(input=x, size=8, act="relu")
            h = fluid.layers.dropout(h, dropout_prob=0.5)
        pred = fluid.layers.fc(input=h, size=1,
                               param_attr=fluid.ParamAttr(name="w"),
                               bias_attr=fluid.ParamAttr(name="b"))
        return fluid.layers.mean(fluid.layers.square_error_cost(pred, y))


def _sgd():
    return fluid.optimizer.SGD(learning_rate=0.01)


def _train_pipe(n=64, batch=4, chunk=None):
    def reader():
        rng = np.random.RandomState(7)
        for _ in range(n):
            x = rng.rand(4).astype("float32")
            yield {"x": x, "y": x.sum(keepdims=True).astype("float32")}
    pipe = fluid.DataPipe.from_reader(reader).batch(batch)
    if chunk:
        pipe = pipe.prefetch_to_device(place=fluid.CPUPlace(), chunk=chunk)
    return pipe


def _batches():
    """The reader loop's 16 batches of 4 samples: a list of samples each,
    as a fluid train loop pulls them."""
    rng = np.random.RandomState(3)
    out = []
    for _ in range(16):
        batch = []
        for _ in range(4):
            x = rng.rand(4).astype("float32")
            batch.append((x, x.sum(keepdims=True).astype("float32")))
        out.append(batch)
    return out


def _batches_reader(orders=None):
    """A reader whose k-th pass yields the batches of orders[k] (indices;
    the last order repeats), every pass all 16 in order by default. A
    plain reader has no source position: a restored reader loop replays
    its interrupted epoch from the start, so the uninterrupted run it is
    held to reads that longer first pass."""
    batches = _batches()
    orders = orders or [range(16)]
    calls = [0]

    def reader():
        k = min(calls[0], len(orders) - 1)
        calls[0] += 1
        for i in orders[k]:
            yield batches[i]

    return reader


def _run_trainer(cfg, faults=None, epochs=2, dropout=False, loop="pipe",
                 chunk=None, events=None, orders=None):
    if faults:
        chaos.install(chaos.ChaosMonkey(faults))
    # a restored job is a fresh process: the optimizer's vars (the
    # learning rate, accumulators) get the names the killed one gave them
    fluid.unique_name.switch()
    t = fluid.Trainer(train_func=lambda: _train_net(dropout),
                      optimizer_func=_sgd, place=fluid.CPUPlace(),
                      resilience_config=cfg)
    handler = events if events is not None else (lambda e: None)
    try:
        if loop == "pipe":
            t.train(num_epochs=epochs, event_handler=handler,
                    reader=_train_pipe(chunk=chunk))
        else:
            t.train(num_epochs=epochs, event_handler=handler,
                    reader=_batches_reader(orders), feed_order=["x", "y"])
    finally:
        chaos.uninstall()
    return t


def _params(t):
    return _state(t.scope, t.train_program)


def _assert_params_equal(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


# what an uninterrupted reader-loop run reads to end where a run restored
# after a grace save at global step N ends: the first N batches, then the
# replayed epoch 0 and epoch 1
def _replayed(n):
    return [list(range(n)) + list(range(16)), range(16)]


@pytest.mark.parametrize("dropout", [False, True],
                         ids=["plain", "dropout"])
@pytest.mark.parametrize("loop", ["pipe", "reader"])
def test_kill_restore_bitwise_equal_params(tmp_path, loop, dropout):
    """Killed by a chaos SIGTERM after step 5 (grace save at global step
    6), restored in a fresh Trainer: the params equal an uninterrupted
    run's bitwise, with dropout too (the random stream rides the
    checkpoint). The datapipe loop resumes at the first unconsumed
    record; the reader loop replays its interrupted epoch, and the
    uninterrupted run it is held to reads the same batches."""
    baseline = _params(_run_trainer(
        None, dropout=dropout, loop=loop,
        orders=_replayed(6) if loop == "reader" else None))
    cfg = ResilienceConfig(checkpoint_dir=str(tmp_path),
                           checkpoint_interval=4)
    with pytest.raises(Preempted) as ei:
        _run_trainer(cfg, faults=[chaos.Fault("sigterm", at=5)],
                     dropout=dropout, loop=loop)
    assert ei.value.checkpoint_serial == 1
    report = inspect_dir(str(tmp_path))
    assert report["serials"]
    assert all(e["status"] == "committed" for e in report["serials"])
    assert report["manifest"]["step"] == 6
    restored = _run_trainer(ResilienceConfig(checkpoint_dir=str(tmp_path),
                                             checkpoint_interval=4),
                            dropout=dropout, loop=loop)
    _assert_params_equal(_params(restored), baseline)


def test_dropout_restore_needs_the_random_stream(tmp_path, monkeypatch):
    """Without the random stream put back, the restored dropout run draws
    other masks and ends elsewhere: the check above would catch a restore
    that dropped it."""
    baseline = _params(_run_trainer(None, dropout=True))
    cfg = ResilienceConfig(checkpoint_dir=str(tmp_path),
                           checkpoint_interval=4)
    with pytest.raises(Preempted):
        _run_trainer(cfg, faults=[chaos.Fault("sigterm", at=5)],
                     dropout=True)
    manifest = inspect_dir(str(tmp_path))["manifest"]
    assert manifest["torch_rng"]["device"] == "cpu"
    monkeypatch.setattr(fluid.Executor, "set_rng_state",
                        lambda self, program, state: None)
    restored = _run_trainer(ResilienceConfig(checkpoint_dir=str(tmp_path),
                                             checkpoint_interval=4),
                            dropout=True)
    assert not np.array_equal(_params(restored)["w"], baseline["w"])


@pytest.mark.parametrize("dropout", [False, True],
                         ids=["plain", "dropout"])
@pytest.mark.parametrize("loop", ["pipe", "reader"])
def test_transient_fault_is_retried_transparently(tmp_path, loop, dropout):
    baseline = _params(_run_trainer(None, dropout=dropout, loop=loop))
    cfg = ResilienceConfig(checkpoint_dir=str(tmp_path),
                           checkpoint_interval=4,
                           retry=RetryPolicy(max_attempts=4,
                                             sleep=lambda s: None))
    monkey = chaos.ChaosMonkey([chaos.Fault("transient", at=3, times=2)])
    chaos.install(monkey)
    fluid.unique_name.switch()
    t = fluid.Trainer(train_func=lambda: _train_net(dropout),
                      optimizer_func=_sgd, place=fluid.CPUPlace(),
                      resilience_config=cfg)
    try:
        if loop == "pipe":
            t.train(num_epochs=2, event_handler=lambda e: None,
                    reader=_train_pipe())
        else:
            t.train(num_epochs=2, event_handler=lambda e: None,
                    reader=_batches_reader(), feed_order=["x", "y"])
    finally:
        chaos.uninstall()
    assert [k for k, _n, _l in monkey.injected].count("transient") == 2
    _assert_params_equal(_params(t), baseline)


@pytest.mark.parametrize("dropout", [False, True],
                         ids=["plain", "dropout"])
@pytest.mark.parametrize("loop", ["pipe", "reader"])
def test_nan_restore_policy_rolls_back_and_recovers(tmp_path, loop,
                                                    dropout):
    """A chaos NaN at step 6 under nan_policy=restore rolls the scope,
    the pipe and the random stream back to the checkpoint of step 4: the
    pipe replays the same records and the run ends bitwise where the
    uninterrupted run ends; the reader loop restarts its epoch from the
    checkpoint's params, and is held to the run that reads those
    batches."""
    baseline = _params(_run_trainer(
        None, dropout=dropout, loop=loop,
        orders=_replayed(4) if loop == "reader" else None))
    with flags.flag_guard(resilience_nan_policy="restore"):
        cfg = ResilienceConfig(checkpoint_dir=str(tmp_path),
                               checkpoint_interval=4)
        t = _run_trainer(cfg, faults=[chaos.Fault("nan", at=6)],
                         dropout=dropout, loop=loop)
    _assert_params_equal(_params(t), baseline)
    assert t._resilience.global_step == (32 if loop == "pipe" else 36)


def test_rollback_on_the_captured_graph_replays_the_restored_state(
        tmp_path, recorded_graphs):  # noqa: F811
    """A nan_policy=restore rollback restores into the scope while the
    Executor keeps its captured step (the recorded stand-in of a CUDA
    graph, chunks of 2 steps): the replays start from the restored
    values and draw the restored random numbers, so the run ends bitwise
    where the interpreter's uninterrupted run ends."""
    with flags.flag_guard(cuda_graph=False):
        baseline = _params(_run_trainer(None, dropout=True, chunk=2))
    with flags.flag_guard(resilience_nan_policy="restore"):
        cfg = ResilienceConfig(checkpoint_dir=str(tmp_path),
                               checkpoint_interval=2)
        t = _run_trainer(cfg, faults=[chaos.Fault("nan", at=3)],
                         dropout=True, chunk=2)
    exe = t._resilience.executor
    assert exe.step_mode(t.train_program) == "graph"
    assert len(exe.captured_steps(t.train_program, t.scope)) == 1
    _assert_params_equal(_params(t), baseline)


def test_nan_skip_policy_continues(tmp_path):
    with flags.flag_guard(resilience_nan_policy="skip", monitor=True):
        cfg = ResilienceConfig(checkpoint_dir=str(tmp_path),
                               checkpoint_interval=0)
        t = _run_trainer(cfg, faults=[chaos.Fault("nan", at=2)], epochs=1)
    assert t is not None
    assert "nan_steps_total" in monitor.exposition()


def test_reader_path_preempt_and_restore(tmp_path):
    """The plain-reader loop (no datapipe): restore resumes params and the
    global step counter; the interrupted epoch replays from its start."""
    cfg = ResilienceConfig(checkpoint_dir=str(tmp_path),
                           checkpoint_interval=4)
    with pytest.raises(Preempted):
        _run_trainer(cfg, faults=[chaos.Fault("sigterm", at=6)],
                     loop="reader")
    mgr = CheckpointManager(str(tmp_path))
    try:
        manifest = mgr.restore(place=fluid.CPUPlace())
        assert manifest and manifest["step"] >= 4
    finally:
        mgr.close()
    t = _run_trainer(ResilienceConfig(checkpoint_dir=str(tmp_path),
                                      checkpoint_interval=4), loop="reader")
    # the grace save landed at step 7 (sigterm at step 6); the
    # interrupted epoch replays all 16 steps: 7 + 16 + 16
    assert t._resilience.global_step == 39


# -- monitor counters ---------------------------------------------------


def test_resilience_counters_reach_exposition(tmp_path):
    p = RetryPolicy(max_attempts=2, sleep=lambda s: None)
    with pytest.raises(TransientError):
        p.call(lambda: (_ for _ in ()).throw(TransientError("x")))
    main, startup, _ = _tiny_program()
    scope = _fresh_scope(startup)
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    try:
        mgr.save(1, scope=scope, program=main)
    finally:
        mgr.close()
    text = monitor.exposition()
    assert "resilience_retries_total" in text
    assert "checkpoint_write_ms" in text
    assert "checkpoints_saved_total" in text

