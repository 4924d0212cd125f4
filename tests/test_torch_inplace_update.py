"""What the Executor hands out now that the fused adam update writes the
scope's tensors in place (ops/fused_ops.py, fusion/kernels.py::adam_bucket_).

- A step of the README MLP with FLAGS_fuse on the CPU keeps every
  parameter and moment of the adam bucket in the scope tensor it started
  in, with the new values (the interpreter's write-back rebinds a name to
  the tensor it already holds).
- A fetched parameter, or a fetched alias of one, does not change under the
  caller at the next step: as a tensor (`return_numpy=False`) and as numpy
  on the CPU, where `.numpy()` shares the tensor's memory. The interpreter
  copies such a fetch (`executor_core.unshared`), and only such a fetch.
- `convert.numpy_state` is a snapshot, not a view of the scope.
- On a CUDA card (marked `cuda`, skipped elsewhere) the captured step
  updates the adam bucket in the scope's own tensors too, one kernel
  launch a step, bitwise equal to the interpreter.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.core import executor_core as tcore
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.fusion import kernels as fk


@pytest.fixture(autouse=True)
def _fresh_port_state():
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    tfluid.unique_name.switch()
    fk.reset_launch_counts()
    yield


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel and the graph run only "
                    "there")
    return torch.device("cuda", 0)


def _mlp():
    """The README MLP (784-32-10) with Adam, an alias of its first weight
    (a cast to its own dtype returns the tensor itself), and two seeded
    batches."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        img = tfluid.layers.data(name="img", shape=[784], dtype="float32")
        label = tfluid.layers.data(name="label", shape=[1], dtype="int64")
        hidden = tfluid.layers.fc(input=img, size=32, act="relu")
        probs = tfluid.layers.fc(input=hidden, size=10, act="softmax")
        loss = tfluid.layers.mean(
            tfluid.layers.cross_entropy(input=probs, label=label))
        tfluid.optimizer.AdamOptimizer(learning_rate=1e-2).minimize(loss)
        w = main.global_block().all_parameters()[0]
        w_alias = tfluid.layers.cast(w, "float32")
    rs = np.random.RandomState(11)
    batches = [{"img": rs.rand(8, 784).astype(np.float32),
                "label": rs.randint(0, 10, (8, 1)).astype(np.int64)}
               for _ in range(2)]
    return main, startup, loss, w, w_alias, batches


def _run(fetch_kind, return_numpy):
    """Step 1 fetching the weight (or its alias), step 2 fetching the loss;
    returns (step 1's fetch, its value right after step 1, the scope's
    weight after step 2)."""
    main, startup, loss, w, w_alias, batches = _mlp()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope), tflags.flag_guard(fuse=True):
        exe.run(startup)
        fetch = w if fetch_kind == "param" else w_alias
        (got,) = exe.run(main, feed=batches[0], fetch_list=[fetch],
                         return_numpy=return_numpy)
        snapshot = np.array(got, copy=True)
        exe.run(main, feed=batches[1], fetch_list=[loss])
        assert exe.step_mode(main) == "interpreter"
        now = scope.find_var(w.name).numpy().copy()
    return got, snapshot, now


@pytest.mark.parametrize("return_numpy", [False, True],
                         ids=["tensor", "numpy"])
@pytest.mark.parametrize("fetch_kind", ["param", "alias"])
def test_a_fetch_does_not_change_at_the_next_step(fetch_kind, return_numpy):
    got, snapshot, now = _run(fetch_kind, return_numpy)
    assert isinstance(got, np.ndarray) == return_numpy
    np.testing.assert_array_equal(np.asarray(got), snapshot)
    # the next step did move the weight: the copy is what kept it
    assert not np.array_equal(now.reshape(snapshot.shape), snapshot)
    assert fk.adam_bucket.launches == 0


def test_the_adam_bucket_is_updated_in_the_scope_tensors():
    main, startup, loss, w, _, batches = _mlp()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope), tflags.flag_guard(fuse=True):
        exe.run(startup)
        params = [p.name for p in main.global_block().all_parameters()]
        names = params + [n for n, v in main.global_block().vars.items()
                          if v.persistable and "moment" in n]
        held = {n: scope.find_var(n) for n in names}
        before = {n: t.clone() for n, t in held.items()}
        exe.run(main, feed=batches[0], fetch_list=[loss])
    assert len(held) == 12  # 2 weights, 2 biases and two moments of each
    for n, t in held.items():
        assert scope.find_var(n) is t, n
        assert not torch.equal(t, before[n]), n


def test_numpy_state_is_a_snapshot():
    main, startup, loss, w, _, batches = _mlp()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope), tflags.flag_guard(fuse=True):
        exe.run(startup)
        state = convert.numpy_state(scope, main)
        kept = {n: a.copy() for n, a in state.items()}
        exe.run(main, feed=batches[0], fetch_list=[loss])
    for n, a in state.items():
        np.testing.assert_array_equal(a, kept[n], err_msg=n)
    assert not np.array_equal(state[w.name], scope.find_var(w.name).numpy())


def test_unshared_copies_only_what_shares_the_state():
    state = [torch.arange(6.0), torch.zeros(3)]
    view, own = state[0].reshape(2, 3), torch.ones(2)
    got = tcore.unshared([view, own, state[1], None], state)
    assert got[1] is own and got[3] is None
    for g, f in zip(got[:3:2], (view, state[1])):
        assert g is not f and torch.equal(g, f)
        assert g.untyped_storage().data_ptr() != f.untyped_storage(
        ).data_ptr()


@pytest.mark.cuda
def test_the_captured_step_updates_adam_in_place_on_the_card(cuda_device):
    main, startup, loss, w, _, batches = _mlp()
    init_scope = tfluid.Scope()
    with tfluid.scope_guard(init_scope):
        tfluid.Executor(tfluid.CPUPlace()).run(startup)
    init = convert.numpy_state(init_scope, main)
    place = tfluid.CUDAPlace(cuda_device.index)
    runs = {}
    for graph in (False, True):
        fk.reset_launch_counts()
        scope = tfluid.Scope()
        convert.load_numpy_state(scope, main, init, place)
        exe = tfluid.Executor(place)
        held = scope.find_var(w.name)
        with tfluid.scope_guard(scope), \
                tflags.flag_guard(fuse=True, cuda_graph=graph):
            # warm-up, capture, then replays on the graph path
            losses = [exe.run(main, feed=b, fetch_list=[loss])[0]
                      for b in batches * 2]
            assert exe.step_mode(main) == ("graph" if graph
                                           else "interpreter")
        torch.cuda.synchronize()
        assert scope.find_var(w.name) is held
        assert fk.adam_bucket.launches == 4  # one bucket, four steps
        runs[graph] = (np.stack(losses), convert.numpy_state(scope, main))
    np.testing.assert_array_equal(runs[True][0], runs[False][0])
    for n, a in runs[False][1].items():
        np.testing.assert_array_equal(runs[True][1][n], a, err_msg=n)
    assert not np.array_equal(runs[True][1][w.name], init[w.name])
