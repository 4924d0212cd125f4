"""The port's high-level Trainer against the JAX package's.

The same train_func and reader in both packages, the port's Trainer
started from the JAX trainer's initial state (convert.load_numpy_state):
the same events, losses within rtol 1e-4 (fp32), the same test()
averages, the same final parameters; the DataPipe loop likewise; the
ParallelExecutor switch (one rank) bitwise equal to the Executor; the
io-format CheckpointConfig path saving every step_interval steps and
restoring at construction, in either package; save_params feeding the
port's Inferencer (the reference's tests/test_highlevel_api.py:28) and
the JAX package's; save_inference_model; stop(); and the parameter-server
path refused until the distributed stack is ported.
"""

import os

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import flags as jflags

import paddle_tpu_torch as fluid
from paddle_tpu_torch import convert, flags
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope

RTOL = 1e-4
EPOCHS = 2
STEPS = 8


@pytest.fixture(autouse=True)
def _fresh_port_state():
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    fluid.unique_name.switch()
    flags.reset()
    yield
    flags.reset()
    jflags.reset()


def _infer_func(package):
    def infer():
        x = package.layers.data(name="x", shape=[6], dtype="float32")
        return package.layers.fc(input=x, size=1, act=None,
                                 param_attr=package.ParamAttr(name="w"),
                                 bias_attr=package.ParamAttr(name="b"))
    return infer


def _train_func(package, with_prediction=False):
    def train():
        y_predict = _infer_func(package)()
        y = package.layers.data(name="y", shape=[1], dtype="float32")
        loss = package.layers.mean(
            package.layers.square_error_cost(input=y_predict, label=y))
        return [loss, y_predict] if with_prediction else loss
    return train


def _momentum(package):
    return lambda: package.optimizer.Momentum(learning_rate=0.05,
                                              momentum=0.9)


W = np.random.RandomState(0).randn(6, 1).astype("float32")


def _reader(seed=1, steps=STEPS):
    def reader():
        rs = np.random.RandomState(seed)
        for _ in range(steps):
            x = rs.randn(16, 6).astype("float32")
            yield [(x[i], (x[i] @ W).astype("float32")) for i in range(16)]
    return reader


class _Events:
    def __init__(self, package):
        self.package = package
        self.counts = {}
        self.steps = []
        self.losses = []

    def __call__(self, event):
        name = type(event).__name__
        self.counts[name] = self.counts.get(name, 0) + 1
        if isinstance(event, self.package.EndStepEvent):
            self.steps.append((event.epoch, event.step))
            self.losses.append(np.asarray(event.metrics[0]).reshape(-1))


def _jax_trainer(**kw):
    jfluid.unique_name.switch()
    return jfluid.Trainer(train_func=_train_func(jfluid),
                          optimizer_func=_momentum(jfluid),
                          place=jfluid.CPUPlace(), **kw)


def _jax_state(trainer):
    return {v.name: np.asarray(trainer.scope.find_var(v.name))
            for v in trainer.train_program.list_vars()
            if v.persistable and trainer.scope.find_var(v.name) is not None}


def _port_trainer(init=None, **kw):
    fluid.unique_name.switch()
    t = fluid.Trainer(train_func=_train_func(fluid),
                      optimizer_func=_momentum(fluid),
                      place=fluid.CPUPlace(), **kw)
    if init is not None:
        convert.load_numpy_state(t.scope, t.train_program, init,
                                 fluid.CPUPlace())
    return t


def _port_state(trainer):
    return convert.numpy_state(trainer.scope, trainer.train_program)


def _trained_pair(reader_of=None):
    """Both trainers over the same reader, the port's from the JAX one's
    initial state: (jax trainer, its events, port trainer, its events)."""
    jt = _jax_trainer()
    init = _jax_state(jt)
    pt = _port_trainer(init)
    out = []
    for package, t in ((jfluid, jt), (fluid, pt)):
        events = _Events(package)
        reader = reader_of(package) if reader_of else _reader()
        if hasattr(reader, "next_feed"):
            t.train(num_epochs=EPOCHS, event_handler=events, reader=reader)
        else:
            t.train(num_epochs=EPOCHS, event_handler=events, reader=reader,
                    feed_order=["x", "y"])
        out += [t, events]
    return out


def _assert_close_states(got, want):
    assert set(want) <= set(got)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=RTOL, atol=1e-6,
                                   err_msg=n)


def test_trainer_matches_the_jax_trainer():
    """The reader loop: the same events in the same order, the losses and
    the final state within rtol 1e-4, the same test() averages."""
    jt, jev, pt, pev = _trained_pair()
    assert pev.counts == jev.counts == {
        "BeginEpochEvent": EPOCHS, "EndEpochEvent": EPOCHS,
        "BeginStepEvent": EPOCHS * STEPS, "EndStepEvent": EPOCHS * STEPS}
    assert pev.steps == jev.steps
    np.testing.assert_allclose(np.concatenate(pev.losses),
                               np.concatenate(jev.losses), rtol=RTOL)
    assert pev.losses[-1][0] < pev.losses[0][0]
    _assert_close_states(_port_state(pt), _jax_state(jt))
    want = jt.test(reader=_reader(seed=9, steps=4), feed_order=["x", "y"])
    got = pt.test(reader=_reader(seed=9, steps=4), feed_order=["x", "y"])
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_trainer_datapipe_loop_matches_the_jax_trainer():
    """The DataPipe loop (staged feed dicts, no DataFeeder): the same
    events, EndEpochEvent carrying the pipe's stats, the losses within
    rtol 1e-4."""
    def pipe(package):
        def samples():
            rs = np.random.RandomState(2)
            for _ in range(STEPS * 16):
                x = rs.randn(6).astype("float32")
                yield {"x": x, "y": (x @ W).astype("float32")}
        return package.DataPipe.from_reader(samples).batch(16)

    stats = []
    jt, jev, pt, pev = _trained_pair(pipe)
    assert pev.counts == jev.counts
    assert pev.steps == jev.steps
    np.testing.assert_allclose(np.concatenate(pev.losses),
                               np.concatenate(jev.losses), rtol=RTOL)
    _assert_close_states(_port_state(pt), _jax_state(jt))
    pt.train(num_epochs=1, event_handler=lambda e: stats.append(
        getattr(e, "datapipe_stats", None)), reader=pipe(fluid))
    assert stats[-1] is not None and "bottleneck_stage" in stats[-1]


def test_parallel_trainer_equals_the_executor_trainer():
    """parallel=True runs the reader loop through a ParallelExecutor (one
    rank: its collectives are identities), bitwise equal to the
    Executor's."""
    runs = {}
    for parallel in (False, True):
        t = _port_trainer(parallel=parallel)
        events = _Events(fluid)
        t.train(num_epochs=1, event_handler=events, reader=_reader(),
                feed_order=["x", "y"])
        runs[parallel] = (np.concatenate(events.losses), _port_state(t))
    np.testing.assert_array_equal(runs[True][0], runs[False][0])
    for n, v in runs[False][1].items():
        np.testing.assert_array_equal(runs[True][1][n], v, err_msg=n)


def test_checkpoint_config_round_trips_in_both_packages(tmp_path):
    """CheckpointConfig: the reader loop writes an io-format checkpoint
    every step_interval steps (checkpoint_<N>/ with _SUCCESS, LRU-kept),
    and a Trainer built with it loads the latest at construction — the
    port's own, and the JAX package's from the port's directory (the same
    files) and the reverse."""
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    jt = _jax_trainer()
    init = _jax_state(jt)
    pt = _port_trainer(init, checkpoint_config=fluid.CheckpointConfig(
        port_dir, max_num_checkpoints=2, step_interval=4))
    jt = _jax_trainer(checkpoint_config=jfluid.trainer.CheckpointConfig(
        jax_dir, max_num_checkpoints=2, step_interval=4))
    pt.train(num_epochs=1, event_handler=lambda e: None, reader=_reader(),
             feed_order=["x", "y"])
    jt.train(num_epochs=1, event_handler=lambda e: None, reader=_reader(),
             feed_order=["x", "y"])
    names = sorted(os.listdir(port_dir))
    assert names == ["checkpoint_0", "checkpoint_1"]  # steps 4 and 8
    assert sorted(os.listdir(jax_dir)) == names
    for d in names:
        assert os.path.isfile(os.path.join(port_dir, d, "_SUCCESS"))
        assert sorted(f for f in os.listdir(os.path.join(port_dir, d))
                      if f != "_SUCCESS") == sorted(
            f for f in os.listdir(os.path.join(jax_dir, d))
            if f != "_SUCCESS")
    trained = _port_state(pt)
    # the port's checkpoint into a fresh port Trainer and a JAX Trainer
    again = _port_trainer(checkpoint_config=fluid.CheckpointConfig(
        port_dir))
    for n in ("w", "b"):
        np.testing.assert_array_equal(_port_state(again)[n], trained[n])
    jagain = _jax_trainer(checkpoint_config=jfluid.trainer.CheckpointConfig(
        port_dir))
    for n in ("w", "b"):
        np.testing.assert_array_equal(_jax_state(jagain)[n], trained[n])
    # the JAX package's checkpoint into the port
    jtrained = _jax_state(jt)
    from_jax = _port_trainer(checkpoint_config=fluid.CheckpointConfig(
        jax_dir))
    for n in ("w", "b"):
        np.testing.assert_array_equal(_port_state(from_jax)[n], jtrained[n])


def test_save_params_feeds_the_inferencer(tmp_path):
    """tests/test_highlevel_api.py:28 on the port: 8 epochs of SGD, the
    saved params served by the port's Inferencer (which roughly
    reproduces the generator), and the JAX package's Inferencer on the
    same directory gives the same predictions."""
    rs = np.random.RandomState(0)

    def reader():
        for _ in range(8):
            x = rs.randn(16, 6).astype("float32")
            yield [(x[i], (x[i] @ W).astype("float32")) for i in range(16)]

    events = _Events(fluid)
    fluid.unique_name.switch()
    trainer = fluid.Trainer(
        train_func=_train_func(fluid),
        optimizer_func=lambda: fluid.optimizer.SGD(learning_rate=0.05),
        place=fluid.CPUPlace())
    trainer.train(num_epochs=8, event_handler=events, reader=reader,
                  feed_order=["x", "y"])
    assert events.counts["BeginEpochEvent"] == 8
    assert events.counts["EndStepEvent"] == 64
    assert events.losses[-1][0] < events.losses[0][0]
    params_dir = str(tmp_path / "params")
    trainer.save_params(params_dir)
    infer = fluid.Inferencer(infer_func=_infer_func(fluid),
                             param_path=params_dir, place=fluid.CPUPlace())
    xv = rs.randn(5, 6).astype("float32")
    out = infer.infer({"x": xv})
    got = np.asarray(out[0] if isinstance(out, (list, tuple)) else out)
    assert got.shape == (5, 1)
    np.testing.assert_allclose(got, xv @ W, atol=0.5)
    jinfer = jfluid.Inferencer(infer_func=_infer_func(jfluid),
                               param_path=params_dir,
                               place=jfluid.CPUPlace())
    jout = jinfer.infer({"x": xv})
    want = np.asarray(jout[0] if isinstance(jout, (list, tuple)) else jout)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_save_inference_model_loads_in_both_packages(tmp_path):
    """save_inference_model(dir, feeds, target indexes into train_func's
    outputs): the prediction's program, which both packages load and run
    alike."""
    fluid.unique_name.switch()
    t = fluid.Trainer(train_func=_train_func(fluid, with_prediction=True),
                      optimizer_func=_momentum(fluid),
                      place=fluid.CPUPlace())
    t.train(num_epochs=1, event_handler=lambda e: None, reader=_reader(),
            feed_order=["x", "y"])
    d = str(tmp_path / "model")
    t.save_inference_model(d, ["x"], [1])
    xv = np.random.RandomState(3).randn(4, 6).astype("float32")
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        prog, feeds, fetches = fluid.io.load_inference_model(d, exe)
        got, = exe.run(prog, feed={feeds[0]: xv}, fetch_list=fetches)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        prog, feeds, fetches = jfluid.io.load_inference_model(d, jexe)
        want, = jexe.run(prog, feed={feeds[0]: xv}, fetch_list=fetches)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


def test_stop_ends_the_loop():
    t = _port_trainer()
    seen = []

    def handler(event):
        if isinstance(event, fluid.EndStepEvent):
            seen.append(event.step)
            if len(seen) == 3:
                t.stop()

    t.train(num_epochs=2, event_handler=handler, reader=_reader(),
            feed_order=["x", "y"])
    assert seen == [0, 1, 2]


def test_fetch_metrics_off_fetches_nothing():
    t = _port_trainer()
    metrics = []

    def handler(event):
        if isinstance(event, fluid.BeginStepEvent):
            event.fetch_metrics = event.step % 2 == 0
        elif isinstance(event, fluid.EndStepEvent):
            metrics.append(len(event.metrics))

    t.train(num_epochs=1, event_handler=handler, reader=_reader(),
            feed_order=["x", "y"])
    assert metrics == [1, 0] * (STEPS // 2)


def test_the_parameter_server_role_waits_for_the_distributed_stack(
        monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINING_ROLE", "TRAINER")
    with pytest.raises(NotImplementedError, match="item 8"):
        _port_trainer()


def test_the_optimizer_must_be_an_optimizer():
    with pytest.raises(TypeError, match="Optimizer"):
        fluid.Trainer(train_func=_train_func(fluid),
                      optimizer_func=lambda: object(),
                      place=fluid.CPUPlace())
