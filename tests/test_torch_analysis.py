"""paddle_tpu_torch.analysis: FLAGS_verify at both levels, held against the
JAX package's analysis (paddle_tpu/analysis) on the same programs.

The same layer calls build the same programs in both packages; `verify` at
`basic` and `full` gives the same list of (code, severity, block, op
index, var), except where the port's program or its semantics differ,
each listed in DIFFERENCES with its reason. The JAX package's mutation
cases (tests/test_analysis.py) run on both packages' programs and fire the
same codes, PTA001 to PTA034, the autoshard plan's PTA022/PTA023
included. `estimate_peak_hbm` gives the JAX package's
bytes on the same program. Then the port's own wiring: ensure_verified's
memo, the Executor refusing a broken program before any of its steps is
launched, the fused headline-style program verifying clean at `full`,
ParallelExecutor's measured live bytes within 2x of the estimate, and the
`check` CLI.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.models  # noqa: F401
from paddle_tpu import analysis as janalysis
from paddle_tpu import backward as jbackward

import paddle_tpu_torch as fluid
import paddle_tpu_torch.models  # noqa: F401
from paddle_tpu_torch import analysis, flags, monitor
from paddle_tpu_torch import backward as tbackward
from paddle_tpu_torch.analysis import ProgramVerificationError
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.core.framework import OP_ROLE_ATTR_NAME, OpRole

PACKAGES = {jfluid: (janalysis, jbackward), fluid: (analysis, tbackward)}


@pytest.fixture(autouse=True)
def _fresh_port_state():
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    fluid.unique_name.switch()
    flags.reset()
    analysis.reset()
    yield
    flags.reset()
    analysis.reset()


# ---------------------------------------------------------------------------
# program builders: fn(pkg, backward) -> (feed names, fetch names)
# ---------------------------------------------------------------------------
def _mlp(pkg, backward):
    x = pkg.layers.data(name="x", shape=[8], dtype="float32")
    y = pkg.layers.data(name="y", shape=[1], dtype="float32")
    h = pkg.layers.fc(x, size=16, act="relu")
    p = pkg.layers.fc(h, size=1)
    loss = pkg.layers.mean(pkg.layers.square_error_cost(p, y))
    pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return ["x", "y"], [loss.name]


def _conv(pkg, backward):
    img = pkg.layers.data(name="img", shape=[1, 28, 28], dtype="float32")
    lab = pkg.layers.data(name="lab", shape=[1], dtype="int64")
    c = pkg.layers.conv2d(img, num_filters=4, filter_size=3, act="tanh")
    p = pkg.layers.pool2d(c, pool_size=2, pool_type="max", pool_stride=2)
    f = pkg.layers.fc(p, size=10, act="softmax")
    loss = pkg.layers.mean(pkg.layers.cross_entropy(f, lab))
    pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return ["img", "lab"], [loss.name]


def _embedding(pkg, backward):
    ids = pkg.layers.data(name="ids", shape=[1], dtype="int64")
    y = pkg.layers.data(name="y", shape=[1], dtype="float32")
    emb = pkg.layers.embedding(ids, size=[32, 16])
    h = pkg.layers.fc(emb, size=32, act="relu")
    p = pkg.layers.fc(h, size=1)
    loss = pkg.layers.mean(pkg.layers.square_error_cost(p, y))
    pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return ["ids", "y"], [loss.name]


def _while_loop(pkg, backward):
    i = pkg.layers.fill_constant(shape=[1], dtype="int64", value=0)
    limit = pkg.layers.fill_constant(shape=[1], dtype="int64", value=5)
    acc = pkg.layers.fill_constant(shape=[1], dtype="float32", value=0.0)
    cond = pkg.layers.less_than(x=i, y=limit)
    w = pkg.layers.While(cond=cond)
    with w.block():
        new_acc = pkg.layers.elementwise_add(
            acc, pkg.layers.fill_constant(shape=[1], dtype="float32",
                                          value=2.0))
        pkg.layers.assign(new_acc, acc)
        pkg.layers.increment(x=i, value=1, in_place=True)
        pkg.layers.less_than(x=i, y=limit, cond=cond)
    return [], [acc.name]


def _batch_norm_net(pkg, backward):
    img = pkg.layers.data(name="img", shape=[3, 8, 8], dtype="float32")
    lab = pkg.layers.data(name="lab", shape=[1], dtype="int64")
    c = pkg.layers.conv2d(img, num_filters=4, filter_size=3)
    b = pkg.layers.batch_norm(c, act="relu")
    p = pkg.layers.fc(b, size=5, act="softmax")
    loss = pkg.layers.mean(pkg.layers.cross_entropy(p, lab))
    pkg.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    return ["img", "lab"], [loss.name]


def _resnet_cifar10(pkg, backward):
    img = pkg.layers.data(name="data", shape=[3, 32, 32], dtype="float32")
    lab = pkg.layers.data(name="label", shape=[1], dtype="int64")
    probs = pkg.models.resnet.resnet_cifar10(img, 10, depth=8)
    loss = pkg.layers.mean(pkg.layers.cross_entropy(probs, lab))
    pkg.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    return ["data", "label"], [loss.name]


def _piecewise(pkg, backward):
    x = pkg.layers.data(name="x", shape=[8], dtype="float32")
    y = pkg.layers.data(name="y", shape=[1], dtype="float32")
    p = pkg.layers.fc(x, size=1)
    loss = pkg.layers.mean(pkg.layers.square_error_cost(p, y))
    lr = pkg.layers.piecewise_decay([1, 3], [0.1, 0.01, 0.001])
    pkg.optimizer.Momentum(learning_rate=lr, momentum=0.9).minimize(loss)
    return ["x", "y"], [loss.name]


def _ifelse(pkg, backward):
    x = pkg.layers.data(name="x", shape=[4], dtype="float32")
    x.stop_gradient = False
    c = pkg.layers.data(name="c", shape=[1], dtype="float32")
    cond = pkg.layers.less_than(x=c, y=pkg.layers.fill_constant(
        shape=[1], dtype="float32", value=0.5))
    ie = pkg.layers.IfElse(cond)
    with ie.true_block():
        ie.output(pkg.layers.scale(ie.input(x), scale=2.0))
    with ie.false_block():
        ie.output(pkg.layers.scale(ie.input(x), scale=5.0))
    out = ie()[0]
    loss = pkg.layers.mean(out)
    grads = backward.calc_gradient(loss, [x])
    return ["x", "c"], [out.name, grads[0].name]


def _dynamic_rnn(pkg, backward):
    x = pkg.layers.data(name="x", shape=[1], lod_level=1, dtype="float32")
    w = pkg.layers.data(name="w", shape=[2, 3], append_batch_size=False,
                        dtype="float32")
    w.stop_gradient = False
    drnn = pkg.layers.DynamicRNN()
    with drnn.block():
        drnn.step_input(x)
        s = drnn.static_input(w)
        mem = drnn.memory(shape=[3], value=0.0)
        nh = pkg.layers.elementwise_add(mem, pkg.layers.reduce_mean(s, dim=0))
        drnn.update_memory(mem, nh)
        drnn.output(nh)
    loss = pkg.layers.mean(pkg.layers.sequence_pool(drnn(), "last"))
    grads = backward.calc_gradient(loss, [w])
    return ["x", "w"], [loss.name, grads[0].name]


def _build(pkg, builder):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        feeds, fetches = builder(pkg, PACKAGES[pkg][1])
    return main, feeds, fetches


def _zero1(pkg, parts=8):
    main, feeds, fetches = _build(pkg, _mlp)
    rewritten, plan = pkg.parallel.zero1.apply(main, parts)
    return rewritten, plan, feeds, fetches


def _diags(report):
    return sorted((d.code, str(d.severity), d.block_idx, d.op_idx, d.var)
                  for d in report.diagnostics)


def _both(builder, level, **kw):
    """(JAX package's diagnostics, the port's) on the program `builder`
    makes in each."""
    out = []
    for pkg in (jfluid, fluid):
        main, feeds, fetches = _build(pkg, builder)
        r = PACKAGES[pkg][0].verify(main, level=level, feed_names=feeds,
                                    fetch_names=fetches, **kw)
        out.append(_diags(r))
    return out


# The programs on which the port's verdict differs from the JAX
# package's, each with its reason: {builder: {level: (JAX-only, port-only)
# code multisets}}.
#  * batch_norm: the port's training-mode batch_norm_grad does not read
#    the running Mean/Variance (ops/nn_ops.py, tests/test_torch_imports.py),
#    so `full` finds no PTA031 write-after-read on them; the JAX package
#    flags every training program with batch norm, and the headline with
#    it (ROADMAP §3 item 4);
#  * piecewise_decay: the port's dataflow check reads a Switch's
#    conditional blocks writing the rate as one update chain, not a second
#    write (ROADMAP §3 item 11), so no PTA032;
#  * gradient accumulation: backward.py never declares the partial
#    gradients it sums (`x@GRAD@RENAME_0`); the JAX package's verifier
#    reports each write of one as PTA008 and so refuses every residual
#    network's training program, the headline among them; the port's
#    verifier takes them as declared (analysis/verifier.py);
#  * IfElse: the port splits the rows as the reference Fluid does (§3 item
#    10), so its program differs (split/merge ops in place of
#    logical_not/multiplex). The JAX package refuses it with PTA001 at its
#    conditional blocks' reads of their own outputs, PTA008 at its grads'
#    writes and, at `full`, PTA031 at those grads' reads; the port's
#    verifier takes what a control-flow op binds for its block as written
#    at the op (analysis/verifier.py::bound_names, ROADMAP §3 item 18) and
#    passes it. Its split/merge ops (no shape contract) add PTA005 where
#    the JAX package's unread logical_not grad gives PTA003;
#  * DynamicRNN: the JAX package refuses the block's read of its memory
#    (PTA001, never written by any op); the port's op binds it.
DIFFERENCES = {
    "batch_norm": {"basic": ([], []),
                   "full": (["PTA031"] * 2, [])},
    "resnet_cifar10": {"basic": (["PTA008"] * 3, []),
                       "full": (["PTA008"] * 3 + ["PTA031"] * 18, [])},
    "piecewise": {"basic": ([], []), "full": (["PTA032"], [])},
    "ifelse": {"basic": (["PTA001"] * 2 + ["PTA003"] + ["PTA008"] * 3,
                         ["PTA005"] * 2),
               "full": (["PTA001"] * 2 + ["PTA003"] + ["PTA008"] * 3
                        + ["PTA031"] * 2, ["PTA005"] * 2)},
    "dynamic_rnn": {"basic": (["PTA001"], []), "full": (["PTA001"], [])},
}

BUILDERS = {"mlp": _mlp, "conv": _conv, "embedding": _embedding,
            "while": _while_loop, "batch_norm": _batch_norm_net,
            "resnet_cifar10": _resnet_cifar10, "piecewise": _piecewise,
            "ifelse": _ifelse, "dynamic_rnn": _dynamic_rnn}


@pytest.mark.parametrize("level", ["basic", "full"])
@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_verify_gives_the_jax_packages_diagnostics(name, level):
    want, got = _both(BUILDERS[name], level)
    only_j = sorted(d[0] for d in set(want) - set(got))
    only_t = sorted(d[0] for d in set(got) - set(want))
    assert (only_j, only_t) == DIFFERENCES.get(name, {}).get(
        level, ([], [])), (set(want) ^ set(got))


@pytest.mark.parametrize("name", ["mlp", "conv", "embedding", "while",
                                  "batch_norm", "resnet_cifar10",
                                  "piecewise", "ifelse", "dynamic_rnn"])
def test_training_programs_verify_clean_in_the_port(name):
    """Every BUILDERS program verifies clean at `full` in the port, the
    IfElse and DynamicRNN programs among them (the names their ops bind
    for their blocks are written at the op; the JAX package refuses both,
    DIFFERENCES)."""
    main, feeds, fetches = _build(fluid, BUILDERS[name])
    r = analysis.verify(main, level="full", feed_names=feeds,
                        fetch_names=fetches)
    assert r.ok and r.rc == 0, [str(d) for d in r.errors()]
    assert r.summary["n_ops"] > 0


@pytest.mark.parametrize("level", ["basic", "full"])
@pytest.mark.parametrize("name", ["ifelse", "dynamic_rnn"])
def test_control_flow_programs_verify_clean_at_both_levels(name, level):
    main, feeds, fetches = _build(fluid, BUILDERS[name])
    r = analysis.verify(main, level=level, feed_names=feeds,
                        fetch_names=fetches)
    assert r.ok and r.rc == 0, [str(d) for d in r.errors()]


def _swap_block_ops(main):
    """DynamicRNN's step block with its two ops swapped: the add reads the
    mean before the op that writes it."""
    ops = main.blocks[1].ops
    ops[0], ops[1] = ops[1], ops[0]
    return "reduce_mean_0.tmp_0"


def _drop_branch_split(main):
    """IfElse's true block without its split: the branch reads a row set
    nothing writes, which its conditional_block no longer binds."""
    ops = main.blocks[1].ops
    del ops[next(i for i, op in enumerate(ops)
                 if op.type == "split_lod_tensor")]
    return "ifelse_0.tmp_0"


@pytest.mark.parametrize("name,mutate", [("dynamic_rnn", _swap_block_ops),
                                         ("ifelse", _drop_branch_split)])
def test_a_real_read_before_write_in_a_block_is_still_pta001(name, mutate):
    """What a control-flow op binds is written at the op; a name its block
    reads before any op writes it is still refused."""
    main, feeds, fetches = _build(fluid, BUILDERS[name])
    var = mutate(main)
    r = analysis.verify(main, level="basic", feed_names=feeds,
                        fetch_names=fetches)
    assert not r.ok
    assert ("PTA001", var) in {(d.code, d.var) for d in r.errors()}


def test_zero1_rewritten_program_verifies_as_the_jax_package():
    reports = []
    for pkg in (jfluid, fluid):
        rewritten, plan, feeds, fetches = _zero1(pkg)
        reports.append(PACKAGES[pkg][0].verify(
            rewritten, level="full", feed_names=feeds, fetch_names=fetches,
            mesh_axes={"dp": 8}, zplan=plan))
    assert reports[1].ok, [str(d) for d in reports[1].errors()]
    assert _diags(reports[0]) == _diags(reports[1])


def test_verify_rejects_unknown_level_and_an_autoshard_plan():
    """An unknown level raises; an autoshard plan verifies (PTA020-023 in
    scope) with the JAX package's diagnostics, and a reshard edge whose
    bytes the transition model does not reproduce is PTA023 in both."""
    main, feeds, fetches = _build(fluid, _mlp)
    with pytest.raises(ValueError, match="level"):
        analysis.verify(main, level="paranoid")
    reports = []
    for pkg in (jfluid, fluid):
        main, feeds, fetches = _build(pkg, _mlp)
        gb = main.global_block()
        pkg.parallel.set_sharding(gb.var("fc_0.w_0"), (None, "mp"))
        pkg.parallel.set_sharding(gb.var("fc_1.w_0"), ("pp", None))
        plan = pkg.parallel.autoshard.build_plan(
            main, {"dp": 2, "mp": 2, "pp": 2})
        reports.append(PACKAGES[pkg][0].verify(
            main, level="full", feed_names=feeds, fetch_names=fetches,
            mesh_axes={"dp": 2, "mp": 2, "pp": 2}, aplan=plan))
        if pkg is fluid:
            assert plan.is_total() and plan.sharded_names()
            assert reports[-1].ok, [str(d) for d in reports[-1].errors()]
            plan.reshard_edges.append({"var": "fc_0.w_0", "src": ("mp",),
                                       "dst": (), "op": "x", "bytes": 1})
            assert "PTA023" in analysis.verify(
                main, level="full", feed_names=feeds, fetch_names=fetches,
                mesh_axes={"dp": 2, "mp": 2, "pp": 2}, aplan=plan).codes()
    assert _diags(reports[0]) == _diags(reports[1])


# ---------------------------------------------------------------------------
# mutation cases (tests/test_analysis.py): fn(pkg, main) -> kwargs of verify
# on the mutated program; each fires its code in both packages
# ---------------------------------------------------------------------------
def _role(role):
    return {OP_ROLE_ATTR_NAME: int(role)}


def _deleted_producer(pkg, main):
    ops = main.global_block().ops
    del ops[next(i for i, op in enumerate(ops) if op.type == "mul")]


def _duplicate_output(pkg, main):
    op = next(op for op in main.global_block().ops if op.type == "mul")
    op.outputs["Out"] = [op.outputs["Out"][0], op.outputs["Out"][0]]


def _dangling_var(pkg, main):
    main.global_block().create_var(name="dangling_var", shape=[1],
                                   dtype="float32")


def _uncontracted_op(pkg, main):
    gb = main.global_block()
    gb.ops.append(type(gb.ops[0])(gb, "batch_norm_grad", {}, {}, {}))


def _bad_weight_shape(pkg, main):
    gb = main.global_block()
    w = next(n for n, v in gb.vars.items() if v.shape == (16, 1))
    gb.vars[w].shape = (999, 1)


def _unregistered_op(pkg, main):
    gb = main.global_block()
    gb.ops.append(type(gb.ops[0])(gb, "no_such_op", {}, {}, {}))


def _orphan_grad(pkg, main):
    gb = main.global_block()
    name = gb.ops[0].output_arg_names()[0]
    gb.ops.append(type(gb.ops[0])(gb, "softsign_grad", {"X": [name]}, {},
                                  {}))


def _undeclared_read(pkg, main):
    gb = main.global_block()
    op = next(op for op in gb.ops if op.type == "mul")
    op.inputs["X"] = ["never_declared"]


def _undeclared_write(pkg, main):
    op = next(op for op in main.global_block().ops if op.type == "mul")
    op.outputs["Out"] = ["never_declared_out"]


def _read_after_update(pkg, main):
    gb = main.global_block()
    w = next(n for n, v in gb.vars.items()
             if getattr(v, "persistable", False) and v.shape == (8, 16))
    gb.create_var(name="late_read", dtype="float32", shape=(8, 16))
    gb.append_op(type="scale", inputs={"X": [w]},
                 outputs={"Out": ["late_read"]},
                 attrs={"scale": 1.0, **_role(OpRole.Forward)})
    return {"extra_fetch": "late_read"}


def _write_after_read(pkg, main):
    gb = main.global_block()
    g = next(i for i, op in enumerate(gb.ops) if op.type == "relu_grad")
    name = gb.ops[g].inputs["X"][0]
    boundary = next(i for i, op in enumerate(gb.ops)
                    if int(op.attrs.get(OP_ROLE_ATTR_NAME, 0))
                    & int(OpRole.Backward))
    gb.append_op(type="scale", inputs={"X": [name]},
                 outputs={"Out": [name]},
                 attrs={"scale": 2.0, **_role(OpRole.Forward)})
    gb.ops.insert(boundary, gb.ops.pop())


def _nondivisible_shard(pkg, main):
    gb = main.global_block()
    w = next(n for n, v in gb.vars.items() if v.shape == (8, 16))
    pkg.parallel.set_sharding(gb.var(w), ("dp", None))
    return {"mesh_axes": {"dp": 3}}


def _unknown_mesh_axis(pkg, main):
    gb = main.global_block()
    w = next(n for n, v in gb.vars.items() if v.shape == (8, 16))
    pkg.parallel.set_sharding(gb.var(w), ("mp", None))
    return {"mesh_axes": {"dp": 8}}


def _cycle(pkg, main):
    gb = main.global_block()
    for nm in ("a_cyc", "b_cyc"):
        gb.create_var(name=nm, shape=[1], dtype="float32")
    attrs = {"scale": 1.0, **_role(OpRole.Forward)}
    gb.append_op(type="scale", inputs={"X": ["b_cyc"]},
                 outputs={"Out": ["a_cyc"]}, attrs=dict(attrs))
    gb.append_op(type="scale", inputs={"X": ["a_cyc"]},
                 outputs={"Out": ["b_cyc"]}, attrs=dict(attrs))


def _grad_reads_overwritten(pkg, main):
    gb = main.global_block()
    relu = next(op for op in gb.ops if op.type == "relu")
    name = relu.input_arg_names()[0]
    k = next(i for i, op in enumerate(gb.ops) if op.type == "relu_grad")
    gb.append_op(type="scale", inputs={"X": [name]},
                 outputs={"Out": [name]},
                 attrs={"scale": 2.0, **_role(OpRole.Forward)})
    gb.ops.insert(k, gb.ops.pop())


def _double_update(pkg, main):
    gb = main.global_block()
    pname = next(op for op in gb.ops if op.type == "sgd").input("Param")[0]
    gb.append_op(type="scale", inputs={"X": [pname]},
                 outputs={"Out": [pname]},
                 attrs={"scale": 1.0, **_role(OpRole.Optimize)})


MUTATIONS = {
    "PTA001": _deleted_producer, "PTA002": _duplicate_output,
    "PTA003": _dangling_var, "PTA004": _bad_weight_shape,
    "PTA005": _uncontracted_op, "PTA006": _unregistered_op,
    "PTA007": _orphan_grad, "PTA008": _undeclared_read,
    "PTA008-write": _undeclared_write,
    "PTA010": _read_after_update, "PTA011": _write_after_read,
    "PTA020": _unknown_mesh_axis, "PTA021": _nondivisible_shard,
    "PTA030": _cycle, "PTA031": _grad_reads_overwritten,
    "PTA032": _double_update,
}


@pytest.mark.parametrize("code", sorted(MUTATIONS))
def test_mutation_fires_its_code_in_both_packages(code):
    got = []
    for pkg in (jfluid, fluid):
        main, feeds, fetches = _build(pkg, _mlp)
        kw = MUTATIONS[code](pkg, main) or {}
        extra = kw.pop("extra_fetch", None)
        main._mutation += 1
        r = PACKAGES[pkg][0].verify(
            main, level="full", feed_names=feeds,
            fetch_names=fetches + ([extra] if extra else []), **kw)
        fired = code.split("-")[0]
        assert fired in r.codes(), (pkg.__name__, _diags(r))
        d = next(d for d in r.diagnostics if d.code == fired)
        if d.op_idx is not None:
            assert d.op_type
        got.append(_diags(r))
    assert got[0] == got[1]


def _reordered_gather(pkg, rewritten):
    ops = rewritten.global_block().ops
    gi = next(i for i, op in enumerate(ops) if op.type == "zero1_gather")
    ops.insert(0, ops.pop(gi))


def _gather_rewire(pkg, rewritten):
    gat = next(op for op in rewritten.global_block().ops
               if op.type == "zero1_gather")
    pupd = gat.input("X")[0]
    gat.rename_input(pupd, pupd.replace("@zero1_upd", "@zero1_shard"))


def _stale_shard_view(pkg, rewritten):
    gb = rewritten.global_block()
    pshard = next(n for n in gb.vars if n.endswith("@zero1_shard"))
    gb.create_var(name="stale_view_read", shape=[1], dtype="float32")
    gb.append_op(type="scale", inputs={"X": [pshard]},
                 outputs={"Out": ["stale_view_read"]},
                 attrs={"scale": 1.0, **_role(OpRole.Forward)})


def _plan_tamper(pkg, rewritten, plan):
    plan.entries[0].shard += 1


@pytest.mark.parametrize("code,mutate", [
    ("PTA012", _reordered_gather), ("PTA033", _gather_rewire),
    ("PTA034", _stale_shard_view), ("PTA021", None)],
    ids=["PTA012", "PTA033", "PTA034", "PTA021-plan"])
def test_zero1_mutation_fires_its_code_in_both_packages(code, mutate):
    got = []
    for pkg in (jfluid, fluid):
        rewritten, plan, feeds, fetches = _zero1(pkg)
        if mutate is None:
            _plan_tamper(pkg, rewritten, plan)
        else:
            mutate(pkg, rewritten)
        rewritten._mutation += 1
        r = PACKAGES[pkg][0].verify(
            rewritten, level="full", feed_names=feeds, fetch_names=fetches,
            mesh_axes={"dp": 8}, zplan=plan)
        assert code in r.codes() and r.rc == 1, (pkg.__name__, _diags(r))
        got.append(_diags(r))
    assert got[0] == got[1]


def test_collective_under_control_flow_is_pta013_in_both_packages():
    got = []
    for pkg in (jfluid, fluid):
        main, feeds, fetches = _build(pkg, _while_loop)
        wh = next(op for op in main.global_block().ops if op.type == "while")
        sub = next(v for v in wh.attrs.values()
                   if v.__class__.__name__ == "Block")
        name = next(n for op in sub.ops for n in op.input_arg_names() if n)
        sub.append_op(type="all_reduce", inputs={"X": [name]},
                      outputs={"Out": [name]}, attrs={})
        r = PACKAGES[pkg][0].verify(main, level="full", feed_names=feeds,
                                    fetch_names=fetches)
        assert "PTA013" in r.codes() and r.rc == 1
        got.append(_diags(r))
    assert got[0] == got[1]


def test_param_read_inside_while_body_after_update_is_pta010():
    def build(pkg, backward):
        feeds, fetches = _mlp(pkg, backward)
        gb = pkg.default_main_program().global_block()
        w = next(v for n, v in gb.vars.items()
                 if getattr(v, "persistable", False) and v.shape == (8, 16))
        i = pkg.layers.fill_constant(shape=[1], dtype="int64", value=0)
        limit = pkg.layers.fill_constant(shape=[1], dtype="int64", value=1)
        cond = pkg.layers.less_than(x=i, y=limit)
        wh = pkg.layers.While(cond=cond)
        with wh.block():
            pkg.layers.elementwise_add(w, w)
            pkg.layers.increment(x=i, value=1, in_place=True)
            pkg.layers.less_than(x=i, y=limit, cond=cond)
        return feeds, fetches

    want, got = _both(build, "full")
    assert want == got
    assert any(d[0] == "PTA010" and d[2] > 0 for d in got)


# ---------------------------------------------------------------------------
# peak-HBM estimate
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["mlp", "conv", "batch_norm",
                                  "resnet_cifar10", "while"])
@pytest.mark.parametrize("mesh", [None, {"dp": 8}], ids=["single", "dp8"])
def test_hbm_estimate_equals_the_jax_packages(name, mesh):
    est = []
    for pkg in (jfluid, fluid):
        main, feeds, fetches = _build(pkg, BUILDERS[name])
        est.append(PACKAGES[pkg][0].estimate_peak_hbm(
            main, mesh_axes=mesh, fetch_names=fetches))
    assert est[0] == est[1]
    assert est[1]["peak_bytes_per_replica"] > 0


def test_hbm_estimate_divides_sharded_vars():
    main, feeds, fetches = _build(fluid, _mlp)
    gb = main.global_block()
    w = next(n for n, v in gb.vars.items() if v.shape == (8, 16))
    base = analysis.estimate_peak_hbm(main, mesh_axes={"dp": 8},
                                      fetch_names=fetches)
    fluid.parallel.set_sharding(gb.var(w), ("dp", None))
    sharded = analysis.estimate_peak_hbm(main, mesh_axes={"dp": 8},
                                         fetch_names=fetches)
    assert base["param_bytes"] - sharded["param_bytes"] \
        == (8 * 16) * 4 - (8 * 16) * 4 // 8
    assert "TOTAL" in analysis.hbm.render_table(sharded)


def test_measured_live_bytes_counts_each_storage_once():
    a = torch.zeros(4, 8)
    assert analysis.measured_live_bytes([a, a[1:], np.zeros(3)]) \
        == 4 * 8 * 4 + 3 * 8


def test_hbm_estimate_within_2x_of_measured_under_parallel_executor():
    """FLAGS_verify=full sets both gauges on a ParallelExecutor's first
    run, and the static estimate lands within 2x of the measured bytes."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[32], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, size=64, act="relu")
        p = fluid.layers.fc(h, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(p, y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    monitor.reset()
    with flags.flag_guard(verify="full", monitor=True):
        fluid.Executor(fluid.CPUPlace()).run(startup)
        pe = fluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                    main_program=main)
        xs = np.random.RandomState(0).randn(64, 32).astype("float32")
        pe.run([loss], feed={"x": xs, "y": xs[:, :1] * 0.5})
    snap = monitor.registry().snapshot()
    est = next(v for k, v in snap.items()
               if k.startswith("analysis_peak_hbm_bytes_per_replica"))
    measured = snap["hbm_live_bytes_per_replica"]
    assert measured > 0 and est > 0
    assert est <= 2.0 * measured and measured <= 2.0 * est, (est, measured)


# ---------------------------------------------------------------------------
# executor wiring (FLAGS_verify)
# ---------------------------------------------------------------------------
def test_flags_verify_full_clean_run_and_broken_raise_before_launch(
        monkeypatch):
    main, feeds, fetches = _build(fluid, _mlp)
    startup = fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main.clone(),
                                                        startup):
        _mlp(fluid, tbackward)
    xs = np.random.RandomState(0).randn(4, 8).astype("float32")
    ys = np.zeros((4, 1), "float32")
    with flags.flag_guard(verify="full"):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        out, = exe.run(main, feed={"x": xs, "y": ys}, fetch_list=fetches)
        assert np.isfinite(out).all()
        broken = main.clone()
        ops = broken.global_block().ops
        del ops[next(i for i, op in enumerate(ops) if op.type == "mul")]
        broken._mutation += 1
        from paddle_tpu_torch.core import executor_core

        launched = []
        monkeypatch.setattr(executor_core, "run_ops",
                            lambda *a, **k: launched.append(a))
        with pytest.raises(ProgramVerificationError) as ei:
            exe.run(broken, feed={"x": xs, "y": ys}, fetch_list=fetches)
    assert "PTA001" in ei.value.report.codes()
    assert "PTA001" in str(ei.value)
    assert launched == []
    assert exe.compile_cache_info()["entries"] == 2  # startup and main


def test_flags_verify_full_passes_the_fused_momentum_program():
    """The headline's shape of program — convolutions, batch norm,
    Momentum bucketed by FLAGS_fuse — runs under FLAGS_verify=full: the
    fused program verifies clean (the JAX package would refuse it with
    PTA031, DIFFERENCES)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feeds, fetches = _resnet_cifar10(fluid, tbackward)
    rs = np.random.RandomState(0)
    feed = {"data": rs.rand(2, 3, 32, 32).astype(np.float32),
            "label": rs.randint(0, 10, (2, 1)).astype(np.int64)}
    with flags.flag_guard(verify="full", fuse=True):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        out, = exe.run(main, feed=feed, fetch_list=fetches)
        (run_prog, plan, _), = [v for k, v in exe._prepared.items()
                                if k[0] == id(main)]
    assert plan is not None and plan.buckets
    assert np.isfinite(out).all()
    assert analysis.verify(run_prog, level="full", feed_names=feeds,
                           fetch_names=fetches).ok


def test_ensure_verified_memoizes_per_program_config():
    main, feeds, fetches = _build(fluid, _mlp)
    with flags.flag_guard(verify="basic"):
        r1 = analysis.ensure_verified(main, feed_names=feeds,
                                      fetch_names=fetches)
        r2 = analysis.ensure_verified(main, feed_names=feeds,
                                      fetch_names=fetches)
        assert r1 is r2
        main._mutation += 1
        r3 = analysis.ensure_verified(main, feed_names=feeds,
                                      fetch_names=fetches)
        assert r3 is not r1
    assert analysis.ensure_verified(main) is None  # level off -> no-op


def test_ensure_verified_memo_is_capped_fifo():
    main, feeds, fetches = _build(fluid, _mlp)
    cap = analysis._MEMO_CAP
    with flags.flag_guard(verify="basic"):
        first = analysis.ensure_verified(main, feed_names=feeds,
                                         fetch_names=fetches)
        for k in range(cap):
            analysis.ensure_verified(main, feed_names=feeds,
                                     fetch_names=fetches[:0] + [str(k)])
        assert len(analysis._MEMO) == cap
        again = analysis.ensure_verified(main, feed_names=feeds,
                                         fetch_names=fetches)
    assert again is not first  # the oldest entry went first


# ---------------------------------------------------------------------------
# PTA031 pairs a grad op with the forward op it came from (ROADMAP §3 item
# 27): memory_optimize's reused names no longer read as hazards
# ---------------------------------------------------------------------------
def _pta031(main, feeds):
    from paddle_tpu_torch.analysis import dataflow
    from paddle_tpu_torch.analysis.diagnostics import Report

    report = Report(level="full", context="t")
    dataflow.check_hazards(main, report, feed_names=feeds)
    return [d for d in report.diagnostics if d.code == "PTA031"]


def test_pta031_holds_a_grad_op_to_its_own_forward_op():
    """Two relus read x before and after x is rewritten; the first one's
    grad reads the rewritten x. Paired by type and name, the grad's
    version is no later than the second relu's read and nothing fires;
    paired with its own forward op it is a hazard. A grad op with no
    recorded forward op keeps the pairing by name."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        gb = main.global_block()
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        for n in ("a", "b", "a@GRAD"):
            gb.create_var(name=n, shape=[-1, 4], dtype="float32")
        relu1 = gb.append_op(type="relu", inputs={"X": [x.name]},
                             outputs={"Out": ["a"]})
        gb.append_op(type="scale", inputs={"X": [x.name]},
                     outputs={"Out": [x.name]}, attrs={"scale": 2.0})
        gb.append_op(type="relu", inputs={"X": [x.name]},
                     outputs={"Out": ["b"]})
        grad = gb.append_op(
            type="relu_grad",
            inputs={"X": [x.name], "Out@GRAD": ["a@GRAD"]},
            outputs={"X@GRAD": ["x@GRAD"]}, attrs=_role(OpRole.Backward))
    assert _pta031(main, ["x", "a@GRAD"]) == []  # the pairing by name
    grad.fwd_op = relu1
    found = _pta031(main, ["x", "a@GRAD"])
    assert [(d.op_type, d.var) for d in found] == [("relu_grad", "x")]
    assert "consumed version 0" in found[0].message
    # a clone keeps the pairing
    assert [d.var for d in _pta031(main.clone(), ["x", "a@GRAD"])] == ["x"]


def test_pta031_pairs_by_name_when_the_forward_op_is_not_in_the_block():
    """x is rewritten between a relu's read and its grad's. Whether the
    grad op records no forward op, one of another program (a pipeline
    cell's grad ops do), or the relu itself, the hazard fires: the first
    two by the JAX package's pairing by (type, name)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        gb = main.global_block()
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        for n in ("a", "a@GRAD"):
            gb.create_var(name=n, shape=[-1, 4], dtype="float32")
        relu = gb.append_op(type="relu", inputs={"X": [x.name]},
                            outputs={"Out": ["a"]})
        gb.append_op(type="scale", inputs={"X": [x.name]},
                     outputs={"Out": [x.name]}, attrs={"scale": 2.0})
        grad = gb.append_op(
            type="relu_grad",
            inputs={"X": [x.name], "Out@GRAD": ["a@GRAD"]},
            outputs={"X@GRAD": ["x@GRAD"]}, attrs=_role(OpRole.Backward))
    elsewhere = main.clone().global_block().ops[0]
    assert elsewhere.type == "relu" and elsewhere not in gb.ops
    for fwd in (None, elsewhere, relu):
        grad.fwd_op = fwd
        found = _pta031(main, ["x", "a@GRAD"])
        assert [(d.op_type, d.var) for d in found] == [("relu_grad", "x")]


def test_backward_records_each_grad_ops_forward_op():
    main, _, _ = _build(fluid, _mlp)
    ops = main.global_block().ops
    grads = [op for op in ops if op.type.endswith("_grad")]
    assert grads and all(op.fwd_op in ops for op in grads)
    for op in grads:
        assert op.type == op.fwd_op.type + "_grad"
    assert all(op.fwd_op is None for op in ops
               if not op.type.endswith("_grad"))
    clone = main.clone()
    cops = clone.global_block().ops
    assert all(op.fwd_op in cops for op in cops if op.type.endswith("_grad"))


def _residual_conv(pkg):
    x = pkg.layers.data(name="x", shape=[3, 8, 8], dtype="float32")
    y = pkg.layers.data(name="y", shape=[1], dtype="int64")
    h = pkg.layers.conv2d(input=x, num_filters=4, filter_size=3, padding=1,
                          bias_attr=False)
    h = pkg.layers.batch_norm(input=h, act="relu")
    for _ in range(2):
        b = pkg.layers.conv2d(input=h, num_filters=4, filter_size=3,
                              padding=1, bias_attr=False)
        b = pkg.layers.batch_norm(input=b, act="relu")
        b = pkg.layers.conv2d(input=b, num_filters=4, filter_size=3,
                              padding=1, bias_attr=False)
        b = pkg.layers.batch_norm(input=b)
        h = pkg.layers.relu(pkg.layers.elementwise_add(h, b))
    h = pkg.layers.pool2d(input=h, pool_size=2, pool_type="avg",
                          global_pooling=True)
    p = pkg.layers.fc(input=h, size=4, act="softmax")
    loss = pkg.layers.mean(pkg.layers.cross_entropy(input=p, label=y))
    pkg.optimizer.Momentum(learning_rate=0.05, momentum=0.9).minimize(loss)
    return loss


def _residual_losses(optimize, fuse, steps=3):
    from paddle_tpu_torch import convert

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss = _residual_conv(fluid)
    renames = fluid.memory_optimize(main) if optimize else {}
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    torch.manual_seed(0)
    exe.run(startup, scope=scope)
    rs = np.random.RandomState(0)
    state = {n: rs.randn(*a.shape).astype(a.dtype) * 0.1 if a.ndim > 1
             else a for n, a in convert.numpy_state(scope, main).items()}
    convert.load_numpy_state(scope, main, state, fluid.CPUPlace())
    feeds = [{"x": rs.randn(8, 3, 8, 8).astype(np.float32),
              "y": rs.randint(0, 4, (8, 1)).astype(np.int64)}
             for _ in range(steps)]
    with flags.flag_guard(fuse=fuse):
        losses = [exe.run(main, feed=f, fetch_list=[loss],
                          scope=scope)[0].tobytes() for f in feeds]
    return losses, renames, main, exe


def test_a_memory_optimized_residual_net_fuses():
    """memory_optimize reuses names across a residual net's forward and
    backward; paired by (type, name) its grad ops read as PTA031 hazards
    and FLAGS_fuse refused the program. Paired by forward op none fires:
    the fused optimized program trains bitwise as the fused unoptimized
    one, which trains bitwise as the unfused."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _residual_conv(fluid)
    assert fluid.memory_optimize(main)
    assert _pta031(main, ["x", "y"]) == []
    for op in main.global_block().ops:  # the pairing by name still fires
        op.fwd_op = None
    assert _pta031(main, ["x", "y"])
    plain, _, _, _ = _residual_losses(False, True)
    got, renames, omain, _ = _residual_losses(True, True)
    assert renames and got == plain
    assert got == _residual_losses(False, False)[0]
    from paddle_tpu_torch import fusion

    _, plan = fusion.apply(omain, feed_names=["x", "y"],
                           fetch_names=[omain.global_block().ops[-1]
                                        .output_arg_names()[0]])
    assert plan is not None and plan.buckets
