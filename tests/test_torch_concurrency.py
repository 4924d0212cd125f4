"""paddle_tpu_torch.concurrency and the CSP ops: the JAX package's cases
(tests/test_concurrency_tools.py) on both packages — channel semantics,
a Go block handing its result back over a channel, Select's receive and
default cases, a parked sender woken by close, a guard rolled back by an
exception — with the same desc_str() (Select's program aside: its attrs
hold a list of blocks, which neither package's desc_str serializes, so
its op list and sub-blocks are compared) and the same values. The card's
cases are tests/test_torch_compile_services_card.py's."""

import threading
import time

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import concurrency as jconcurrency

import paddle_tpu_torch as fluid
from paddle_tpu_torch import concurrency
from paddle_tpu_torch.concurrency import Channel
from paddle_tpu_torch.core import executor_core
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope

PACKAGES = {jfluid: jconcurrency, fluid: concurrency}


@pytest.fixture(autouse=True)
def _fresh_port_state():
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    fluid.unique_name.switch()
    yield


def test_channel_object_semantics():
    ch = Channel(capacity=2)
    ch.send(1)
    ch.send(2)
    assert ch.recv() == (1, True)
    assert ch.recv() == (2, True)
    ch.close()
    assert ch.recv() == (None, False)  # closed + drained
    with pytest.raises(RuntimeError):
        ch.send(3)

    ch0 = Channel(capacity=0)  # rendezvous: send waits for the receiver
    got = []
    t = threading.Thread(target=lambda: got.append(ch0.recv()), daemon=True)
    t.start()
    ch0.send("hello")
    t.join(5)
    assert got == [("hello", True)]


def test_close_wakes_parked_sender():
    for ch in (Channel(capacity=0), Channel(capacity=1)):
        if ch.capacity == 1:
            ch.send("fill")
        errors = []

        def sender():
            try:
                ch.send("parked")
                if ch.capacity == 0:
                    errors.append("rendezvous send returned without receiver")
            except RuntimeError:
                errors.append("closed")

        t = threading.Thread(target=sender, daemon=True)
        t.start()
        time.sleep(0.15)
        ch.close()
        t.join(5)
        assert not t.is_alive(), "sender leaked after close"
        assert errors == ["closed"], errors


def _go_roundtrip(pkg):
    csp = PACKAGES[pkg]
    ch = csp.make_channel(dtype="float32", capacity=1)
    x = pkg.layers.fill_constant(shape=[2], dtype="float32", value=3.0)
    with csp.Go():
        doubled = pkg.layers.scale(x, scale=2.0)
        csp.channel_send(ch, doubled)
    result = pkg.layers.fill_constant(shape=[2], dtype="float32", value=0.0)
    csp.channel_recv(ch, result)
    csp.channel_close(ch)
    return [result]


def _select(pkg, send_first):
    csp = PACKAGES[pkg]
    ch = csp.make_channel(dtype="float32", capacity=1)
    if send_first:
        x = pkg.layers.fill_constant(shape=[1], dtype="float32", value=7.0)
        csp.channel_send(ch, x)
    got = pkg.layers.fill_constant(shape=[1], dtype="float32", value=-1.0)
    flag = pkg.layers.fill_constant(shape=[1], dtype="float32", value=0.0)
    sel = csp.Select()
    with sel:
        with sel.case(csp.channel_recv, ch, got):
            pkg.layers.assign(pkg.layers.fill_constant(
                shape=[1], dtype="float32", value=1.0), flag)
        with sel.default():
            pkg.layers.assign(pkg.layers.fill_constant(
                shape=[1], dtype="float32", value=2.0), flag)
    return [got, flag]


CASES = {"go": _go_roundtrip,
         "select_recv": lambda pkg: _select(pkg, True),
         "select_default": lambda pkg: _select(pkg, False)}


def _build(pkg, case):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        fetch = CASES[case](pkg)
    return main, fetch


def _run(pkg, case, place=None):
    main, fetch = _build(pkg, case)
    exe = pkg.Executor(place or pkg.CPUPlace())
    return [np.asarray(v) for v in exe.run(main, fetch_list=fetch)]


def _ops(program):
    return [[(op.type, sorted(op.inputs.items()), sorted(op.outputs.items()))
             for op in b.ops] for b in program.blocks]


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_program_in_both_packages(case):
    jmain, _ = _build(jfluid, case)
    tmain, _ = _build(fluid, case)
    if case == "go":
        assert tmain.desc_str() == jmain.desc_str()
    else:
        with pytest.raises(TypeError):
            tmain.desc_str()
        assert _ops(tmain) == _ops(jmain)
        (sel,) = [op for op in tmain.global_block().ops
                  if op.type == "select"]
        (jsel,) = [op for op in jmain.global_block().ops
                   if op.type == "select"]
        assert sel.attrs["cases"] == jsel.attrs["cases"]
        assert [b.idx for b in sel.attrs["case_blocks"]] \
            == [b.idx for b in jsel.attrs["case_blocks"]]


@pytest.mark.parametrize("case,want", [
    ("go", [[6.0, 6.0]]), ("select_recv", [[7.0], [1.0]]),
    ("select_default", [[-1.0], [2.0]])])
def test_values_equal_the_jax_packages(case, want):
    got = _run(fluid, case)
    ref = _run(jfluid, case)
    for g, r, w in zip(got, ref, want):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, w)


def test_csp_programs_run_on_the_interpreter_uncached():
    main, fetch = _build(fluid, "go")
    assert executor_core.capture_blocker(main.global_block().ops).type \
        == "channel_create"
    exe = fluid.Executor(fluid.CPUPlace())
    for _ in range(2):
        out, = exe.run(main, fetch_list=fetch)
        np.testing.assert_array_equal(out, [6.0, 6.0])
    assert exe.step_mode(main) == "interpreter"
    assert exe.compile_cache_info()["entries"] == 0
    ops = {op.type for op in executor_core.dead_code_eliminate(
        main.global_block().ops, [])}
    assert {"channel_create", "go", "channel_recv",
            "channel_close"} <= ops  # side effects, kept without fetches


def test_registry_holds_the_six_csp_op_types():
    from paddle_tpu_torch.core import registry

    for t in ("channel_create", "channel_send", "channel_recv",
              "channel_close", "go", "select"):
        assert registry.get_op_def(t) is not None, t
        assert t in executor_core.HOST_OPS


def test_guard_exception_rolls_back_block():
    with fluid.program_guard(fluid.Program(), fluid.Program()):
        prog = fluid.default_main_program()
        with pytest.raises(ValueError):
            with concurrency.Go():
                raise ValueError("user error")
        assert prog.current_block().idx == 0
        v = fluid.layers.fill_constant(shape=[1], dtype="float32", value=1.0)
        assert any(v.name in op.output_arg_names()
                   for op in prog.global_block().ops)


# ---------------------------------------------------------------------------
# Go and Select with tensors in flight (the card's counterpart is
# tests/test_torch_compile_services_card.py)
# ---------------------------------------------------------------------------
def go_select_program(pkg, csp, n):
    """A Go block computes n [256, 256] products on its own stream and
    sends each through a buffered channel, then says "done" over a second
    one; the main block waits for "done", and n Selects with a default
    case receive the n values (the buffered sends have all landed, so each
    Select takes its receive case). Returns the n received vars."""
    ch = csp.make_channel(dtype="float32", capacity=n)
    done = csp.make_channel(dtype="float32", capacity=1)
    x = pkg.layers.fill_constant(shape=[256, 256], dtype="float32",
                                 value=0.5)
    with csp.Go():
        y = x
        for k in range(n):
            y = pkg.layers.matmul(y, x)
            csp.channel_send(ch, pkg.layers.scale(y, scale=float(k + 1)))
        csp.channel_send(done, x)
    flag = pkg.layers.fill_constant(shape=[256, 256], dtype="float32",
                                    value=0.0)
    csp.channel_recv(done, flag)
    outs = []
    for _ in range(n):
        got = pkg.layers.fill_constant(shape=[256, 256], dtype="float32",
                                       value=-1.0)
        sel = csp.Select()
        with sel:
            with sel.case(csp.channel_recv, ch, got):
                pass
            with sel.default():
                pass
        outs.append(got)
    return outs


def test_go_select_program_on_the_host_equals_the_jax_packages():
    got = []
    for pkg in (jfluid, fluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            outs = go_select_program(pkg, PACKAGES[pkg], 3)
        got.append([np.asarray(v) for v in pkg.Executor(
            pkg.CPUPlace()).run(main, fetch_list=outs)])
    for t, j in zip(*got):
        np.testing.assert_array_equal(t, j)
    assert got[1][0][0, 0] == 64.0 and got[1][2][0, 0] == 3.0 * 2 ** 20
