"""The training services on the card (marked `cuda`, skipped without
one; this file imports no JAX: run it on the card with
`python -m pytest tests/test_torch_resilience_card.py -m cuda`).

- the program's random stream put back (Executor.set_rng_state) on the
  generator a captured CUDA graph registered: the next replays draw the
  same dropout masks again;
- a checkpoint snapshot, enqueued on the step's stream into pinned
  buffers, holds its step's state although steps are replayed right
  after it, and the buffers are reused by the next save;
- async_fetch futures read one call behind on the captured step hold
  their own call's values.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import convert
from paddle_tpu_torch.resilience import CheckpointManager, inspect_dir


def _state(scope, main):
    return convert.numpy_state(scope, main)


def _card_dropout_program():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[64], dtype="float32")
        h = fluid.layers.fc(input=x, size=256, act="relu")
        h = fluid.layers.dropout(h, dropout_prob=0.5)
        loss = fluid.layers.mean(fluid.layers.fc(input=h, size=1))
        fluid.optimizer.Momentum(learning_rate=0.01,
                                 momentum=0.9).minimize(loss)
    return main, startup, loss


def _card_feeds(n):
    rs = np.random.RandomState(11)
    return [{"x": rs.rand(32, 64).astype(np.float32)} for _ in range(n)]


@pytest.mark.cuda
def test_the_random_stream_restores_under_a_captured_graph():
    """On the card the program's generator is registered with its CUDA
    graph: putting its state back (Executor.set_rng_state) makes the next
    replays draw the same dropout masks again, bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    main, startup, loss = _card_dropout_program()
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    feeds = _card_feeds(4)
    with fluid.scope_guard(scope):
        exe.run(startup)
        for f in feeds[:2]:  # eager step, capture
            exe.run(main, feed=f, fetch_list=[loss])
        assert exe.step_mode(main) == "graph"
        state = _state(scope, main)
        rng = exe.rng_state(main)
        first = [exe.run(main, feed=f, fetch_list=[loss])[0]
                 for f in feeds[2:]]
        convert.load_numpy_state(scope, main, state, fluid.CUDAPlace(0))
        exe.set_rng_state(main, rng)
        again = [exe.run(main, feed=f, fetch_list=[loss])[0]
                 for f in feeds[2:]]
        assert len(exe.captured_steps(main, scope)) == 1
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_a_snapshot_is_ordered_before_the_next_replay(tmp_path):
    """A save enqueues its copies into pinned buffers on the run's stream
    and returns; steps replayed right after it cannot reach the snapshot:
    the checkpoint holds the state of the save's step. The buffers are
    reused by the next save."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    main, startup, loss = _card_dropout_program()
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    mgr = CheckpointManager(str(tmp_path), max_num_checkpoints=5)
    feeds = _card_feeds(8)
    want = []
    try:
        with fluid.scope_guard(scope):
            exe.run(startup)
            for k, f in enumerate(feeds):
                exe.run(main, feed=f, fetch_list=[loss],
                        return_numpy=False)
                if k in (3, 5):
                    torch.cuda.synchronize()
                    want.append(_state(scope, main))
                    mgr.save(k, scope=scope, program=main)
            mgr.wait()
        assert mgr.last_gap_ms() is not None
        assert all(t.is_pinned() for t in mgr._pinned.values())
        for serial, expect in zip(sorted(
                e["serial"] for e in inspect_dir(str(tmp_path))["serials"]),
                want):
            other = fluid.Scope()
            mgr.restore(scope=other, program=main,
                        place=fluid.CUDAPlace(0), serial=serial)
            got = _state(other, main)
            for n in expect:
                np.testing.assert_array_equal(got[n], expect[n], err_msg=n)
    finally:
        mgr.close()


@pytest.mark.cuda
def test_async_fetch_on_the_card_reads_each_calls_values():
    """Futures read one call behind on the captured step hold their own
    call's values, equal to a synchronous run's from the same state."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    main, startup, loss = _card_dropout_program()
    feeds = _card_feeds(5)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(scope):
        exe.run(startup)
        exe.run(main, feed=feeds[0], fetch_list=[loss])
        init, rng = _state(scope, main), exe.rng_state(main)
        sync = [exe.run(main, feed=f, fetch_list=[loss])[0] for f in feeds]
        convert.load_numpy_state(scope, main, init, fluid.CUDAPlace(0))
        exe.set_rng_state(main, rng)
        got, prev = [], None
        for f in feeds:
            futs = exe.run(main, feed=f, fetch_list=[loss], async_fetch=True)
            if prev is not None:
                got.append(prev[0].result())
            prev = futs
        got.append(prev[0].result())
    for g, s in zip(got, sync):
        np.testing.assert_array_equal(g, s)
