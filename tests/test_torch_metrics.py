"""paddle_tpu_torch.metrics and .evaluator against the JAX package's.

metrics: every class (MetricBase's reset/get_config, CompositeMetric,
Accuracy, ChunkEvaluator, EditDistance, DetectionMAP, Auc) fed the same
numpy inputs in both packages gives the same values, exactly (host numpy,
the same arithmetic). evaluator: Accuracy, ChunkEvaluator and
EditDistance build the same program in both packages (desc_str), and two
batches run through it accumulate to the same eval() values; reset()
zeroes the states; DetectionMAP raises until the detection layers are
ported (ROADMAP queue 1 item 9).
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import evaluator as jevaluator
from paddle_tpu import metrics as jmetrics

import paddle_tpu_torch as fluid
from paddle_tpu_torch import evaluator, metrics
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope


@pytest.fixture(autouse=True)
def _fresh_port_state():
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    fluid.unique_name.switch()
    yield


# -- metrics ----------------------------------------------------------------


def _both(cls, *args, **kw):
    return getattr(metrics, cls)(*args, **kw), \
        getattr(jmetrics, cls)(*args, **kw)


def test_accuracy_metric():
    got, want = _both("Accuracy", name="acc")
    rs = np.random.RandomState(0)
    for _ in range(4):
        v, w = np.float32(rs.rand()), int(rs.randint(1, 9))
        got.update(v, w)
        want.update(v, w)
    assert got.eval() == want.eval()
    assert str(got) == "acc" and got.get_config() == want.get_config()
    got.reset()
    assert got.value == 0.0 and got.weight == 0.0
    with pytest.raises(ValueError):
        got.eval()
    with pytest.raises(ValueError):
        got.update("x", 1)


def test_chunk_evaluator_metric():
    got, want = _both("ChunkEvaluator")
    for counts in ((5, 6, 3), (np.array([4]), np.array([2]), np.array([2])),
                   (0, 1, 0)):
        got.update(*counts)
        want.update(*counts)
    assert got.eval() == want.eval()
    empty, jempty = _both("ChunkEvaluator")
    assert empty.eval() == jempty.eval() == (0.0, 0.0, 0.0)


def test_edit_distance_metric():
    got, want = _both("EditDistance")
    rs = np.random.RandomState(1)
    for _ in range(3):
        d = rs.randint(0, 3, (6, 1)).astype(np.float32)
        got.update(d, np.array([6]))
        want.update(d, np.array([6]))
    assert got.eval() == want.eval()
    assert got.instance_error == want.instance_error


def test_detection_map_metric():
    got, want = _both("DetectionMAP")
    for v in (0.5, np.array([0.25]), 0.75):
        got.update(v, 2)
        want.update(v, 2)
    assert got.eval() == want.eval()


def test_auc_metric():
    got, want = _both("Auc", name="auc", num_thresholds=50)
    rs = np.random.RandomState(2)
    for _ in range(3):
        labels = rs.randint(0, 2, 32)
        p = rs.rand(32)
        preds = np.stack([1 - p, p], axis=1)
        got.update(labels, preds)
        want.update(labels, preds)
    assert got.eval() == want.eval()
    for lst in ("tp_list", "fn_list", "tn_list", "fp_list"):
        np.testing.assert_array_equal(getattr(got, lst), getattr(want, lst))
    got.reset()
    assert not got.tp_list.any()


def test_composite_metric():
    got, want = _both("CompositeMetric")
    for m, pkg in ((got, metrics), (want, jmetrics)):
        m.add_metric(pkg.Accuracy())
        m.add_metric(pkg.DetectionMAP())
    for v in (0.5, 0.25):
        got.update(np.float32(v), 2)
        want.update(np.float32(v), 2)
    assert got.eval() == want.eval()
    with pytest.raises(ValueError):
        got.add_metric(object())


# -- evaluators -------------------------------------------------------------


def _build_accuracy(package, ev):
    main, startup = package.Program(), package.Program()
    with package.unique_name.guard(), package.program_guard(main, startup):
        x = package.layers.data(name="x", shape=[5], dtype="float32")
        label = package.layers.data(name="label", shape=[1], dtype="int64")
        probs = package.layers.softmax(x)
        acc = ev.Accuracy(input=probs, label=label, k=2)
    return main, startup, acc


def _run(package, main, startup, feeds, acc, fetch):
    exe = package.Executor(package.CPUPlace())
    exe.run(startup)
    outs = [exe.run(main, feed=f, fetch_list=fetch) for f in feeds]
    return exe, outs


def test_accuracy_evaluator():
    rs = np.random.RandomState(3)
    feeds = [{"x": rs.randn(8, 5).astype(np.float32),
              "label": rs.randint(0, 5, (8, 1)).astype(np.int64)}
             for _ in range(2)]
    res = {}
    for package, ev in ((jfluid, jevaluator), (fluid, evaluator)):
        main, startup, acc = _build_accuracy(package, ev)
        scope = package.Scope()
        with package.scope_guard(scope):
            exe, outs = _run(package, main, startup, feeds, acc,
                             acc.metrics)
            value = acc.eval(exe)
            states = [np.asarray(package.fetch_var(s.name))
                      for s in acc.states]
            acc.reset(exe)
            zeroed = [np.asarray(package.fetch_var(s.name))
                      for s in acc.states]
        res[package] = (main.desc_str(), outs, value, states, zeroed)
    (jdesc, jouts, jval, jstates, _), (desc, outs, val, states, zeroed) = \
        res[jfluid], res[fluid]
    assert desc == jdesc
    for o, jo in zip(outs, jouts):
        np.testing.assert_array_equal(np.asarray(o[0]), np.asarray(jo[0]))
    np.testing.assert_array_equal(val, jval)
    for s, js in zip(states, jstates):
        np.testing.assert_array_equal(s, js)
    assert states[0].reshape(-1)[0] == 16  # total over two batches
    assert all(not z.any() for z in zeroed)


def _lod(package, rows, lengths):
    return package.create_lod_tensor(
        np.asarray(rows, np.int64).reshape(-1, 1), [lengths],
        package.CPUPlace())


def test_chunk_evaluator():
    rs = np.random.RandomState(4)
    batches = []
    for _ in range(2):
        lengths = [5, 7, 4]
        n = sum(lengths)
        batches.append((rs.randint(0, 7, n), rs.randint(0, 7, n), lengths))
    res = {}
    for package, ev in ((jfluid, jevaluator), (fluid, evaluator)):
        main, startup = package.Program(), package.Program()
        with package.unique_name.guard(), \
                package.program_guard(main, startup):
            inf = package.layers.data(name="inf", shape=[1], dtype="int64",
                                      lod_level=1)
            lab = package.layers.data(name="lab", shape=[1], dtype="int64",
                                      lod_level=1)
            chunk = ev.ChunkEvaluator(input=inf, label=lab,
                                      chunk_scheme="IOB", num_chunk_types=3)
        scope = package.Scope()
        with package.scope_guard(scope):
            feeds = [{"inf": _lod(package, i, ln), "lab": _lod(package, l, ln)}
                     for i, l, ln in batches]
            exe, outs = _run(package, main, startup, feeds, chunk,
                             chunk.metrics)
            value = chunk.eval(exe)
        res[package] = (main.desc_str(), outs, value)
    assert res[fluid][0] == res[jfluid][0]
    for o, jo in zip(res[fluid][1], res[jfluid][1]):
        for a, b in zip(o, jo):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6)
    for a, b in zip(res[fluid][2], res[jfluid][2]):
        np.testing.assert_array_equal(a, b)


def test_edit_distance_evaluator():
    rs = np.random.RandomState(5)
    batches = []
    for _ in range(2):
        hl, rl = [3, 5, 2], [4, 5, 2]
        batches.append((rs.randint(1, 6, sum(hl)), hl,
                        rs.randint(1, 6, sum(rl)), rl))
    res = {}
    for package, ev in ((jfluid, jevaluator), (fluid, evaluator)):
        main, startup = package.Program(), package.Program()
        with package.unique_name.guard(), \
                package.program_guard(main, startup):
            hyp = package.layers.data(name="hyp", shape=[1], dtype="int64",
                                      lod_level=1)
            ref = package.layers.data(name="ref", shape=[1], dtype="int64",
                                      lod_level=1)
            dist = ev.EditDistance(input=hyp, label=ref)
        scope = package.Scope()
        with package.scope_guard(scope):
            feeds = [{"hyp": _lod(package, h, hl), "ref": _lod(package, r, rl)}
                     for h, hl, r, rl in batches]
            exe, outs = _run(package, main, startup, feeds, dist,
                             dist.metrics)
            value = dist.eval(exe)
        res[package] = (main.desc_str(), outs, value)
    assert res[fluid][0] == res[jfluid][0]
    for o, jo in zip(res[fluid][1], res[jfluid][1]):
        for a, b in zip(o, jo):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6)
    for a, b in zip(res[fluid][2], res[jfluid][2]):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_detection_map_evaluator_waits_for_the_detection_layers():
    with pytest.raises(NotImplementedError, match="item 9"):
        evaluator.DetectionMAP(None, None, None, class_num=3)
