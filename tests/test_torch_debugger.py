"""paddle_tpu_torch.debugger: the program dump and the graphviz export are
the JAX package's (paddle_tpu/debugger.py), byte for byte, on the same
programs built by the same layer calls — a trainer with role-colored ops,
a While with its sub-block cluster, and a highlighted parameter."""

import pytest

import paddle_tpu as jfluid
from paddle_tpu import debugger as jdebugger

import paddle_tpu_torch as fluid
from paddle_tpu_torch import debugger
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope

PACKAGES = {jfluid: jdebugger, fluid: debugger}


@pytest.fixture(autouse=True)
def _fresh_port_state():
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    fluid.unique_name.switch()
    yield


def _trainer(pkg):
    x = pkg.layers.data(name="x", shape=[4], dtype="float32")
    label = pkg.layers.data(name="label", shape=[1], dtype="int64")
    probs = pkg.layers.fc(input=x, size=3, act="softmax",
                          param_attr=pkg.ParamAttr(name="W"))
    loss = pkg.layers.mean(pkg.layers.cross_entropy(input=probs,
                                                    label=label))
    pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)


def _while(pkg):
    i = pkg.layers.fill_constant(shape=[1], dtype="int64", value=0)
    limit = pkg.layers.fill_constant(shape=[1], dtype="int64", value=3)
    cond = pkg.layers.less_than(x=i, y=limit)
    w = pkg.layers.While(cond=cond)
    with w.block():
        pkg.layers.increment(x=i, value=1, in_place=True)
        pkg.layers.less_than(x=i, y=limit, cond=cond)


def _conv_bn(pkg):
    img = pkg.layers.data(name="img", shape=[3, 8, 8], dtype="float32")
    c = pkg.layers.conv2d(img, num_filters=4, filter_size=3)
    pkg.layers.batch_norm(c, act="relu", is_test=True)


BUILDERS = {"trainer": _trainer, "while": _while, "conv_bn": _conv_bn}


def _program(pkg, name):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        BUILDERS[name](pkg)
    return main


@pytest.mark.parametrize("show_backward,show_attrs",
                         [(True, True), (False, False), (True, False)])
@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_pprint_text_equals_the_jax_packages(name, show_backward,
                                             show_attrs):
    texts = [PACKAGES[pkg].pprint_program_codes(
        _program(pkg, name), show_backward=show_backward,
        show_attrs=show_attrs) for pkg in (jfluid, fluid)]
    assert texts[1] == texts[0]
    assert texts[1].startswith("# block 0 (parent -1)")


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_dot_files_equal_the_jax_packages(name, tmp_path):
    blocks, programs = [], []
    for tag, pkg in (("jax", jfluid), ("port", fluid)):
        prog = _program(pkg, name)
        dbg = PACKAGES[pkg]
        b = dbg.draw_block_graphviz(prog.global_block(), highlights=["W"],
                                    path=str(tmp_path / f"{tag}_b.dot"))
        p = dbg.draw_program_graphviz(prog, highlights=["x"],
                                      path=str(tmp_path / f"{tag}_p.dot"))
        blocks.append(open(b, "rb").read())
        programs.append(open(p, "rb").read())
    assert blocks[1] == blocks[0]
    assert programs[1] == programs[0]
    assert blocks[1].startswith(b"digraph G {")
    if name == "trainer":
        assert b'fillcolor="red"' in blocks[1]       # highlighted W
        assert b'fillcolor="#b19cd9"' in blocks[1]   # optimize role
        assert b'fillcolor="#ffb347"' in blocks[1]   # backward (loss grad)
        assert b"float32[4x3]" in blocks[1]          # typed var label
    if name == "while":
        assert b"cluster_1" in programs[1] and b"block 1" in programs[1]
