"""paddle_tpu_torch.parallel.elastic against the JAX package's elastic
tests (tests/test_elastic.py).

- the controller over an in-process master: a leave resizes (gauges,
  the resize's parts), the rescale policies and the warmup ramp,
  find_lr_var (the JAX package's name), a drained controller refuses to
  rejoin, and a pending flag the master's epoch does not confirm (a beat
  that raced the last resize) resizes nothing;
- the checkpoint's mesh geometry and its refusal (the JAX package's
  check_mesh_compat decisions), MeshSpec over a re-formed group (a mesh
  of the old group refuses to run), the chaos kinds, `elastic
  status|drain` printing the JAX CLI's text against one master;
- the Trainer re-entering its loop on Resized;
- a dp 4 -> 2 -> 4 trajectory: four gloo CPU rank processes
  (tests/torch_elastic_worker.py), two preempted after step 3, two
  joiners after step 7, against the JAX package's uninterrupted dp = 4
  ParallelExecutor on the conftest's CPU devices, from one start state
  (convert.load_numpy_state): rtol 1e-5, atol 1e-6 (the JAX test's
  bound), no step lost or repeated.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid

import paddle_tpu_torch as fluid
from paddle_tpu_torch import flags, monitor
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.parallel import distributed as tdist
from paddle_tpu_torch.parallel import mesh as tmesh
from paddle_tpu_torch.parallel.elastic import (
    ConstantRescale, ElasticConfig, ElasticController, ElasticError,
    LinearRescale, Resized, find_lr_var)
from paddle_tpu_torch.parallel.master import MasterService

import torch_elastic_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = fluid.CPUPlace()


@pytest.fixture(autouse=True)
def _fresh_port_state():
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    fluid.unique_name.switch()
    flags.reset()
    monitor.reset()
    yield
    flags.reset()
    monitor.reset()


def _svc(**kw):
    kw.setdefault("lease_timeout", 0.3)
    kw.setdefault("failure_max", 2)
    return MasterService(**kw)


def _wait_for(cond, timeout=15.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting: {what}"
        time.sleep(0.02)


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------
def test_controller_resize_on_leave_updates_gauges():
    svc = _svc()
    kw = dict(ttl=10.0, heartbeat_interval=0.05, start_world=2,
              barrier_timeout=5.0, resize_timeout=10.0,
              checkpoint_on_resize=False, restore_on_resize=False)
    c0 = ElasticController(ElasticConfig(svc, name="w0", **kw))
    c1 = ElasticController(ElasticConfig(svc, name="w1", **kw))
    t = threading.Thread(target=c1.start, daemon=True)
    t.start()
    c0.start()
    t.join(10.0)
    assert c0.world_size == 2 and {c0.rank, c1.rank} == {0, 1}
    before = monitor.registry().counter("elastic_resizes_total").value
    c1.drain()
    _wait_for(c0.resize_pending, 5.0, "the resize flag")
    with pytest.raises(Resized) as ei:
        c0.poll()
    assert ei.value.world_size == 1 and ei.value.old_world == 2
    assert c0.world_size == 1 and c0.rank == 0 and c0.resizes == 1
    reg = monitor.registry()
    assert reg.gauge("elastic_world_size").value == 1
    assert reg.gauge("elastic_epoch").value == c0.epoch
    assert reg.counter("elastic_resizes_total").value == before + 1
    assert reg.gauge("elastic_resize_duration_ms").value > 0
    parts = c0.last_resize
    assert set(parts) == {"barriers", "checkpoint", "adopt", "total"}
    assert parts["total"] >= parts["barriers"] >= 0
    assert c0.status()["last_resize"] == parts
    c0.stop()
    svc.stop()


def test_a_flag_the_epoch_does_not_confirm_resizes_nothing():
    """A beat that raced the last resize's own epoch update leaves the
    pending flag set: the poll asks the master, finds its epoch and
    membership current, clears the flag and does not resize."""
    svc = _svc()
    ctl = ElasticController(ElasticConfig(
        svc, name="w0", ttl=10.0, heartbeat_interval=10.0,
        checkpoint_on_resize=False, restore_on_resize=False))
    ctl.start()
    ctl._resize_pending.set()
    ctl.poll()
    assert ctl.resizes == 0 and not ctl.resize_pending()
    svc.elastic_join("w1", ttl=10.0)  # a real change does resize
    svc.elastic_leave("w1")
    ctl._resize_pending.set()
    with pytest.raises(Resized):
        ctl.poll()
    assert ctl.resizes == 1
    assert ctl.epoch == svc.elastic_membership()["epoch"]
    ctl.stop()
    svc.stop()


def test_rescale_policies_and_lr_var():
    class FakeRunner:
        checkpoint = None

        def __init__(self):
            self.scope = fluid.Scope()
            self.program = None

    r = FakeRunner()
    r.scope.set_var("learning_rate_0", torch.full([1], 0.1))
    assert LinearRescale().lr_scale(2, 4) == 2.0
    assert LinearRescale().batch_scale(4, 2) == 0.5
    assert ConstantRescale().lr_scale(2, 8) == 1.0
    svc = _svc()
    ctl = ElasticController(ElasticConfig(
        svc, name="w0", lr_var="learning_rate_0",
        policy=LinearRescale(warmup_steps=2)))
    ctl._capture_base_lr(r)
    assert ctl.base_lr == pytest.approx(0.1)
    ctl.base_world = 2
    lr_tensor = r.scope.find_var("learning_rate_0")

    def lr():
        return float(r.scope.find_var("learning_rate_0")[0])

    # growth 2 -> 4 with warmup: hold, then ramp to target over 2 polls
    ctl._apply_rescale(2, 4, r)
    assert lr() == pytest.approx(0.1)
    ctl.poll(r)
    assert lr() == pytest.approx(0.15)
    ctl.poll(r)
    assert lr() == pytest.approx(0.2)
    ctl.poll(r)  # ramp exhausted: stable
    assert lr() == pytest.approx(0.2)
    # shrink 4 -> 2: new lr applies immediately, no ramp
    ctl._apply_rescale(4, 2, r)
    assert lr() == pytest.approx(0.1)
    # in place: a captured step reading the scope's tensor sees it
    assert r.scope.find_var("learning_rate_0") is lr_tensor
    svc.stop()


def test_find_lr_var_names_the_jax_packages_var():
    names = []
    for pkg in (jfluid, fluid):
        pkg.unique_name.switch()
        main, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, start):
            x = pkg.layers.data(name="x", shape=[4], dtype="float32")
            loss = pkg.layers.mean(pkg.layers.fc(x, 2))
            pkg.optimizer.SGD(learning_rate=0.05).minimize(loss)
        names.append(find_lr_var(main))
    assert names[0] == names[1] and names[1].startswith("learning_rate")
    assert find_lr_var(None) is None
    scope = fluid.Scope()
    assert find_lr_var(main, scope) is None  # not materialized there


def test_drained_controller_refuses_to_rejoin():
    svc = _svc()
    ctl = ElasticController(ElasticConfig(
        svc, name="w0", ttl=10.0, heartbeat_interval=0.05,
        checkpoint_on_resize=False, restore_on_resize=False))
    ctl.start()
    assert svc.elastic_membership()["members"] == {"w0": ""}
    ctl.drain()
    assert svc.elastic_membership()["members"] == {}
    ctl._needs_rejoin = True
    with pytest.raises(ElasticError, match="refusing to rejoin"):
        ctl._barrier_until_released("resize")
    ctl._resize_pending.set()
    ctl.poll()
    assert svc.elastic_membership()["members"] == {}
    svc.stop()


# ---------------------------------------------------------------------------
# geometry, the group re-form, chaos, the CLI
# ---------------------------------------------------------------------------
def test_checkpoint_mesh_geometry_manifest_and_refusal(tmp_path):
    from paddle_tpu.resilience.checkpoint import \
        check_mesh_compat as jcheck
    from paddle_tpu_torch.resilience.checkpoint import (
        CheckpointManager, check_mesh_compat, inspect_dir)

    main, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, start):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        fluid.layers.fc(x, 2)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(CPU).run(start)
    cm = CheckpointManager(str(tmp_path), async_write=False)
    cm.mesh_axes = {"dp": 4, "pp": 2}
    cm.save(7, scope=scope, program=main)
    assert inspect_dir(str(tmp_path))["manifest"]["mesh"] == \
        {"dp": 4, "pp": 2}
    # a dp change is the layout-independent contract: allowed
    assert cm.restore(scope=scope, program=main, place=CPU,
                      expect_mesh={"dp": 2, "pp": 2})["step"] == 7
    with pytest.raises(ValueError, match="mesh geometry conflict.*pp"):
        cm.restore(scope=scope, program=main, place=CPU,
                   expect_mesh={"dp": 4, "pp": 4})
    # the JAX package's decisions, case by case
    for saved, want in ((None, {"dp": 2}), ({"dp": 8}, None),
                        ({"dp": 8}, {"dp": 2}), ({"dp": 4, "mp": 1},
                                                 {"dp": 2}),
                        ({"dp": 4, "pp": 2}, {"dp": 4}),
                        ({"dp": 4, "mp": 2}, {"dp": 2, "mp": 4})):
        outcome = []
        for check in (jcheck, check_mesh_compat):
            try:
                check(saved, want)
                outcome.append("ok")
            except ValueError:
                outcome.append("refused")
        assert outcome[0] == outcome[1], (saved, want)


def test_mesh_spec_reform(tmp_path):
    """MeshSpec over a group the controller re-forms: distributed.reform
    destroys the default group and makes a new one; a mesh of the old
    group is stale and refuses to run, a ParallelExecutor over it too,
    and the new mesh is live. Only the dp axis is elastic: the fixed axes
    (mp, pp) multiply the ranks a dp of one needs."""
    spec = tmesh.MeshSpec()
    assert spec.geometry(3) == {"dp": 3}
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmesh.MeshSpec(mp=2).build(1)
    assert tmesh.MeshSpec(mp=2).geometry(2) == {"dp": 2, "mp": 2}
    assert tmesh.MeshSpec(pp=2).geometry(2) == {"dp": 2, "pp": 2}
    tdist.initialize("file://" + str(tmp_path / "rdv0"), 1, 0)
    try:
        gen = tdist.generation()
        old = spec.build(1)
        old.check_live()
        assert tmesh.mesh_geometry(old) == {"dp": 1}
        with pytest.raises(ValueError, match="needs 2 ranks"):
            spec.build(2)
        main, start = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, start):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            loss = fluid.layers.mean(fluid.layers.fc(x, 2))
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        fluid.Executor(CPU).run(start)
        pe = fluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                    main_program=main)
        xs = np.ones((2, 4), np.float32)
        pe.run([loss], feed={"x": xs})
        store = torch.distributed.TCPStore("127.0.0.1", 0, 1, True)
        tdist.reform(store, 1, 0)
        assert tdist.generation() == gen + 1 and tdist.is_initialized()
        with pytest.raises(RuntimeError, match="re-formed"):
            old.check_live()
        with pytest.raises(RuntimeError, match="re-formed"):
            pe.run([loss], feed={"x": xs})
        new = spec.build(1)
        new.check_live()
        pe = fluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                    main_program=main)
        assert np.isfinite(pe.run([loss], feed={"x": xs})[0]).all()
    finally:
        torch.distributed.destroy_process_group()
    with pytest.raises(RuntimeError, match="destroyed or re-formed"):
        new.check_live()
    tmesh.make_mesh().check_live()  # no group: always live


def test_a_rendezvous_is_joined_only_under_its_own_epoch():
    """Rank 0 of an epoch publishes its store under that epoch; another
    rank looks up its own epoch's entry only, never an older one (here a
    dead address), and gives up with ElasticError."""
    from paddle_tpu_torch.parallel.elastic import RENDEZVOUS_KIND

    svc = _svc()
    ctl = ElasticController(ElasticConfig(svc, name="w1",
                                          barrier_timeout=0.3))
    try:
        svc.register(RENDEZVOUS_KIND, "4", "127.0.0.1:1", 30.0)
        with pytest.raises(ElasticError, match="no rendezvous for epoch 5"):
            ctl._rendezvous(5, 2, 1)
        store = ctl._rendezvous(5, 1, 0)  # rank 0 hosts and publishes
        assert svc.lookup(RENDEZVOUS_KIND)["5"] == \
            f"127.0.0.1:{store.port}"
        peer = ctl._rendezvous(5, 1, 1)  # and a rank finds it
        peer.set("k", "v")
        assert store.get("k") == b"v"
    finally:
        svc.stop()


def test_chaos_worker_preempt_and_join_kinds():
    from paddle_tpu_torch.resilience.chaos import ChaosMonkey, Fault
    from paddle_tpu_torch.resilience.preempt import PreemptionHandler

    monkey = ChaosMonkey([Fault("worker_preempt", at=3)])
    with PreemptionHandler() as h:
        monkey.on_step(2)
        assert h.pending() is None
        monkey.on_step(3)  # SIGTERM to self, captured by the handler
        assert h.pending() is not None
    assert ("worker_preempt", 3, None) in monkey.injected
    argv = [sys.executable, "-c", "import sys; sys.exit(7)"]
    monkey = ChaosMonkey([Fault("worker_join", at=1, argv=argv)])
    monkey.on_step(0)
    assert not monkey.spawned
    monkey.on_step(1)
    assert len(monkey.spawned) == 1
    assert monkey.spawned[0].wait(timeout=30) == 7
    monkey.on_step(1)  # fired cap: no second spawn
    assert len(monkey.spawned) == 1
    with pytest.raises(ValueError, match="argv"):
        Fault("worker_join", at=0)


def test_elastic_status_cli_prints_the_jax_clis_text(capsys):
    from paddle_tpu import cli as jcli
    from paddle_tpu_torch import cli

    svc = _svc()
    ep = f"127.0.0.1:{svc.serve()}"
    try:
        svc.elastic_join("w0", "host0:1", ttl=30.0)
        svc.elastic_join("w1", ttl=30.0)
        outs = []
        for main in (jcli.main, cli.main):
            assert main(["elastic", "status", "--master", ep]) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1]
        assert "world_size=2" in outs[1] and "w0" in outs[1]
        assert cli.main(["elastic", "drain", "w1", "--master", ep]) == 0
        assert "drained w1" in capsys.readouterr().out
        assert list(svc.elastic_membership()["members"]) == ["w0"]
        assert cli.main(["elastic", "status", "--master", ep,
                         "--json"]) == 0
        st = json.loads(capsys.readouterr().out)
        assert st["world_size"] == 1 and list(st["members"]) == ["w0"]
        assert cli.main(["elastic", "status", "--master", "127.0.0.1:1",
                         "--timeout", "0.2"]) == 1
    finally:
        svc.stop()


# ---------------------------------------------------------------------------
# the Trainer re-enters on Resized
# ---------------------------------------------------------------------------
def _run_helper(ctl, stop_evt):
    """A peer trainer reduced to its elastic protocol: join, then answer
    every barrier the fleet forms (no model of its own)."""
    try:
        ctl.start()
    except ElasticError:
        return
    while not stop_evt.is_set():
        try:
            ctl.poll()
        except Resized:
            pass
        except ElasticError:
            return
        time.sleep(0.005)


def test_trainer_reenters_its_loop_on_resized(tmp_path):
    """A Trainer under ResilienceConfig(elastic=...): a peer joins after
    step 1; at the next boundary the runner's poll resizes (rank 0 saves
    the resize point and adopts it) and the reader loop re-enters its
    epoch, as after a rollback — the global step continues from the
    resize point."""
    from paddle_tpu_torch.resilience import ResilienceConfig

    svc = _svc()
    ctl = ElasticController(ElasticConfig(
        svc, name="a0", ttl=10.0, heartbeat_interval=0.02,
        barrier_timeout=10.0, resize_timeout=20.0,
        policy=ConstantRescale()))
    helper = ElasticController(ElasticConfig(
        svc, name="b1", ttl=10.0, heartbeat_interval=0.02,
        barrier_timeout=10.0, resize_timeout=20.0,
        checkpoint_on_resize=False, restore_on_resize=False))
    stop = threading.Event()

    def train_func():
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        p = fluid.layers.fc(x, 1)
        return [fluid.layers.mean(fluid.layers.square_error_cost(p, y))]

    def reader():
        for s in range(4):
            b = worker.feed(s)
            yield [(b["x"][i], b["y"][i]) for i in range(8)]

    steps, th = [], []

    def handler(event):
        if isinstance(event, fluid.EndStepEvent):
            steps.append((event.epoch, event.step, ctl.world_size))
            if len(steps) == 2:
                th.append(threading.Thread(target=_run_helper,
                                           args=(helper, stop),
                                           daemon=True))
                th[0].start()
                _wait_for(ctl.resize_pending, 10.0, "the join")

    trainer = fluid.Trainer(
        train_func=train_func,
        optimizer_func=lambda: fluid.optimizer.SGD(learning_rate=0.1),
        place=CPU, resilience_config=ResilienceConfig(
            checkpoint_dir=str(tmp_path), async_checkpoints=False,
            handle_signals=False, restore_on_start=False, elastic=ctl))
    try:
        trainer.train(num_epochs=1, event_handler=handler, reader=reader,
                      feed_order=["x", "y"])
    finally:
        stop.set()
        helper.drain()
        for t in th:
            t.join(10.0)
        svc.stop()
    assert ctl.resizes == 1
    # steps 0 and 1 at world 1; step 2's boundary resizes (its end event
    # never comes) and the loop re-enters the epoch from its first batch
    # (a reader has no seekable position) at world 2; the runner's global
    # step continues from the resize point: 3 steps, then the 4 replayed
    assert steps == [(0, 0, 1), (0, 1, 1),
                     (0, 0, 2), (0, 1, 2), (0, 2, 2), (0, 3, 2)]
    assert trainer._resilience.global_step == 7


# ---------------------------------------------------------------------------
# dp 4 -> 2 -> 4 against the JAX package's uninterrupted dp = 4
# ---------------------------------------------------------------------------
STEPS = 12
DEADLINE_S = 150


def _jax_reference():
    import jax

    main, start, loss = worker.build(jfluid)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(start)
        init = {v.name: np.array(np.asarray(scope.find_var(v.name)))
                for v in main.list_vars()
                if v.persistable and scope.find_var(v.name) is not None}
        pe = jfluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                     main_program=main,
                                     devices=jax.devices()[:4])
        ref = []
        for s in range(STEPS):
            out, = pe.run([loss.name], feed=worker.feed(s))
            ref.append(float(np.asarray(out).reshape(())))
    return init, ref


def test_dp4_to_2_to_4_loss_trajectory_parity(tmp_path):
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 devices (conftest forces 8 on CPU)")
    init, ref = _jax_reference()
    np.savez(tmp_path / "init.npz", **init)
    svc = MasterService()
    ep = f"127.0.0.1:{svc.serve()}"
    out = tmp_path / "out"
    out.mkdir()
    spec = {"master": ep, "checkpoint_dir": str(tmp_path / "ckpt"),
            "out": str(out), "init": str(tmp_path / "init.npz"),
            "steps": STEPS, "start_world": 4,
            "preempt": {"w2": 3, "w3": 3},
            "join": {"w0": {"at": 7, "names": ["w2", "w3"]}},
            "deadline_s": DEADLINE_S}
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.path.join(REPO, "tests"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests",
                                      "torch_elastic_worker.py"),
         str(spec_path), name], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name in ("w0", "w1", "w2", "w3")]
    logs = []
    try:
        deadline = time.monotonic() + DEADLINE_S + 30
        for p in procs:
            logs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        svc.stop()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    res = {f.name[:-5]: json.loads(f.read_text())
           for f in out.glob("*.json")}
    assert sorted(res) == ["w0", "w1", "w2", "w2.joiner", "w3",
                           "w3.joiner"], sorted(res)
    for name in ("w0", "w1"):
        r = res[name]
        assert r["worlds"] == [2, 4] and r["resizes"] == 2, r
        assert r["order"] == list(range(STEPS)), r["order"]  # none lost
        got = [r["losses"][str(s)] for s in range(STEPS)]
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    for name in ("w2", "w3"):
        assert res[name]["left"] and res[name]["order"] == [0, 1, 2, 3]
        joined = res[f"{name}.joiner"]
        assert joined["first_step"] == 8 and joined["start_world"] == 4
        assert joined["order"] == list(range(8, STEPS))
        for s in joined["order"]:
            assert joined["losses"][str(s)] == \
                res["w0"]["losses"][str(s)]
