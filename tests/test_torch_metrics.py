"""paddle_tpu_torch.metrics and .evaluator against the JAX package's.

metrics: every class (MetricBase's reset/get_config, CompositeMetric,
Accuracy, ChunkEvaluator, EditDistance, DetectionMAP, Auc) fed the same
numpy inputs in both packages gives the same values, exactly (host numpy,
the same arithmetic). evaluator: Accuracy, ChunkEvaluator and
EditDistance build the same program in both packages (desc_str), and two
batches run through it accumulate to the same eval() values; reset()
zeroes the states; DetectionMAP builds the same program and gives the
same current and accumulated mAPs over random batches, reset included.
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


def _dmap_batch(package, rs, n_images=3, classes=4):
    """Seeded detections and ground truths of `n_images` images, as LoD
    feeds: per image 1-4 boxes with labels, difficult flags, and 0-6
    detections near them (some of other classes)."""
    gtl, gtd, gtb, det, glen, dlen = [], [], [], [], [], []
    for _ in range(n_images):
        n = rs.randint(1, 5)
        glen.append(n)
        for _ in range(n):
            x0, y0 = rs.uniform(0, 0.6, 2)
            w, h = rs.uniform(0.1, 0.4, 2)
            box = [x0, y0, x0 + w, y0 + h]
            label = rs.randint(1, classes)
            gtl.append([label])
            gtd.append([float(rs.rand() < 0.2)])
            gtb.append(box)
            for _ in range(rs.randint(0, 3)):
                jitter = rs.uniform(-0.05, 0.05, 4)
                cls = label if rs.rand() < 0.8 else rs.randint(1, classes)
                det.append([cls, round(rs.rand(), 3)] + list(box + jitter))
        if len(det) == sum(dlen):  # the reference's no-detection row
            det.append([-1, 0, 0, 0, 0, 0])
        dlen.append(len(det) - sum(dlen))
    place = package.CPUPlace()

    def lod(rows, lens):
        return package.create_lod_tensor(np.asarray(rows, np.float32), [lens],
                                         place)

    return {"det": lod(det, dlen), "gtl": lod(gtl, glen),
            "gtd": lod(gtd, glen), "gtb": lod(gtb, glen)}


def test_detection_map_evaluator_waits_for_the_detection_layers():
    """The evaluator (its detection layers ported) builds the JAX
    package's program; three random batches, a reset and one more give
    the JAX package's current and accumulated mAPs."""
    res = {}
    for package, ev in ((jfluid, jevaluator), (fluid, evaluator)):
        main, startup = package.Program(), package.Program()
        with package.unique_name.guard(), \
                package.program_guard(main, startup):
            L = package.layers
            det = L.data(name="det", shape=[6], dtype="float32", lod_level=1)
            gtl = L.data(name="gtl", shape=[1], dtype="float32", lod_level=1)
            gtd = L.data(name="gtd", shape=[1], dtype="float32", lod_level=1)
            gtb = L.data(name="gtb", shape=[4], dtype="float32", lod_level=1)
            dmap = ev.DetectionMAP(det, gtl, gtb, gtd, class_num=4,
                                   overlap_threshold=0.5,
                                   evaluate_difficult=False,
                                   ap_version="11point")
            cur, accum = dmap.get_map_var()
        rs = np.random.RandomState(6)
        scope = package.Scope()
        with package.scope_guard(scope):
            exe = package.Executor(package.CPUPlace())
            exe.run(startup)
            dmap.reset(exe)
            vals = [exe.run(main, feed=_dmap_batch(package, rs),
                            fetch_list=[cur, accum]) for _ in range(3)]
            dmap.reset(exe)
            vals.append(exe.run(main, feed=_dmap_batch(package, rs),
                                fetch_list=[cur, accum]))
        res[package] = (main.desc_str(),
                        np.asarray(vals, np.float64).reshape(4, 2))
    assert res[fluid][0] == res[jfluid][0]
    np.testing.assert_array_equal(res[fluid][1], res[jfluid][1])
    got = res[fluid][1]
    assert got[0, 0] == got[0, 1] and got[3, 0] == got[3, 1]
    assert 0 < got[:, 0].max() and 0 <= got.min() and got.max() <= 1
