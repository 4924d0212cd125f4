"""The op-coverage gate: every op type the port's program builders append
has a port kernel, or is on the list of types still missing.

The builders are the public functions of the port's `layers` modules,
`optimizer`, `clip`, `initializer`, `nets` and `regularizer`. An op type
reaches a program through a string: `append_op("matmul", ...)`, but also
`_reduce("reduce_sum", ...)` or the module-level `_unary_ops` list that
layers/ops.py makes functions from. So the walk takes every string
constant in those modules (docstrings aside) that names a forward op
type of the JAX package's registry — the reference's full set — and
holds it to the port's registry.

MISSING names each type still unported with the ROADMAP item that owns
it. The list may only shrink: a type on it that gains a kernel, or that
no builder appends any more, fails the gate until it is taken off.

Beside the gate, programs built by those layer functions (the ones that
used to stop at "No kernel registered") run in the port and give the
JAX package's outputs.
"""

import ast
import importlib
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.ops  # noqa: F401  (fills the JAX registry)
from paddle_tpu.core import registry as jreg

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core import scope as tscope

BUILDER_MODULES = [
    "paddle_tpu_torch.layers.ops", "paddle_tpu_torch.layers.tensor",
    "paddle_tpu_torch.layers.nn", "paddle_tpu_torch.layers.control_flow",
    "paddle_tpu_torch.layers.io",
    "paddle_tpu_torch.layers.learning_rate_scheduler",
    "paddle_tpu_torch.optimizer", "paddle_tpu_torch.clip",
    "paddle_tpu_torch.initializer", "paddle_tpu_torch.nets",
    "paddle_tpu_torch.regularizer",
]

_NN_REST = "ROADMAP queue 1 item 2 (d): the nn rest"
_LOSS_OPS = "ROADMAP queue 1 item 2 (e): loss_ops and the metric rest"
MISSING = {
    "layer_norm": _NN_REST, "conv2d_transpose": _NN_REST,
    "conv3d": _NN_REST, "lrn": _NN_REST, "maxout": _NN_REST,
    "bilinear_interp": _NN_REST, "row_conv": _NN_REST,
    "im2sequence": _NN_REST, "multiplex": _NN_REST,
    "random_crop": _NN_REST, "lod_reset": _NN_REST,
    "warpctc": _LOSS_OPS, "ctc_align": _LOSS_OPS,
    "linear_chain_crf": _LOSS_OPS, "crf_decoding": _LOSS_OPS,
    "nce": _LOSS_OPS, "hierarchical_sigmoid": _LOSS_OPS,
    "auc": _LOSS_OPS, "chunk_eval": _LOSS_OPS, "edit_distance": _LOSS_OPS,
    "beam_search": "ROADMAP queue 1 item 4: control flow and decoding",
    "beam_search_decode": "ROADMAP queue 1 item 4: control flow and decoding",
    "roi_pool": "ROADMAP queue 1 item 9: detection",
}

# the op types this slice registered (the tentpole's list)
SLICE = (
    ["reduce_sum", "reduce_mean", "reduce_max", "reduce_min", "reduce_prod",
     "matmul", "clip", "clip_by_norm", "cos_sim", "cumsum", "norm"]
    + ["split", "transpose", "pad", "crop", "gather", "scatter", "one_hot",
       "fill_constant_batch_size_like", "fill_zeros_like", "shape",
       "increment", "expand", "label_smooth", "reverse", "assign_value",
       "arg_max", "arg_min", "argsort", "isfinite"]
    + ["equal", "not_equal", "less_than", "less_equal", "greater_than",
       "greater_equal", "logical_and", "logical_or", "logical_xor",
       "logical_not"]
    + ["softmax_with_cross_entropy", "sigmoid_cross_entropy_with_logits",
       "square_error_cost", "squared_l2_norm", "squared_l2_distance",
       "smooth_l1_loss", "huber_loss", "hinge_loss", "rank_loss",
       "margin_rank_loss", "log_loss"]
    + ["adamax", "adagrad", "decayed_adagrad", "adadelta", "rmsprop", "ftrl",
       "proximal_gd", "proximal_adagrad"])


@pytest.fixture(autouse=True)
def _fresh_port_state():
    torch.set_num_threads(2)
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    tfluid.unique_name.switch()
    yield


def _reference_types():
    return {t for t, d in jreg._registry.items()
            if d.fn is not None and not t.endswith("_grad")}


def _appended_types():
    """{op type: {"module.function", ...}} over BUILDER_MODULES."""
    known = _reference_types()
    found = {}
    for name in BUILDER_MODULES:
        tree = ast.parse(inspect.getsource(importlib.import_module(name)))
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef,
                                  ast.ClassDef))
                and n.body and isinstance(n.body[0], ast.Expr)
                and isinstance(n.body[0].value, ast.Constant)}
        scopes = [(f"{name}.{n.name}", n) for n in ast.walk(tree)
                  if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
        owner = {}
        for label, node in scopes:  # innermost wins: walked outer first
            for sub in ast.walk(node):
                owner[id(sub)] = label
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and node.value in known \
                    and id(node) not in docs:
                found.setdefault(node.value, set()).add(
                    owner.get(id(node), f"{name}.<module>"))
    return found


def test_every_appended_op_type_has_a_port_kernel():
    unported = {t: sorted(where) for t, where in _appended_types().items()
                if treg.get_op_def(t) is None and t not in MISSING}
    assert not unported, unported


def test_the_missing_list_only_shrinks():
    """Each type on MISSING is still appended and still unported."""
    appended = _appended_types()
    for t in MISSING:
        assert t in appended, f"{t}: no builder appends it; drop it"
        assert treg.get_op_def(t) is None, f"{t}: ported; drop it"
    assert not set(MISSING) & set(SLICE)


def test_the_slice_is_registered():
    assert len(SLICE) == len(set(SLICE)) == 59
    for t in SLICE:
        assert treg.get_op_def(t) is not None, t
    assert len([t for t, d in treg._registry.items()
                if d.fn is not None]) >= 153


def test_an_unported_type_says_so():
    with pytest.raises(NotImplementedError,
                       match="not yet ported to paddle_tpu_torch"):
        treg.lookup("warpctc")


# ---------------------------------------------------------------------------
# programs the layer functions build, in both packages
# ---------------------------------------------------------------------------
def _net(fluid, case):
    """(feeds, fetch vars) of `case` built with `fluid`'s layers."""
    L = fluid.layers
    x = L.data(name="x", shape=[6], dtype="float32")
    lbl = L.data(name="lbl", shape=[1], dtype="int64")
    h = L.fc(input=x, size=4)
    if case == "reductions":
        outs = [L.reduce_sum(h, dim=[1]), L.reduce_mean(h),
                L.reduce_max(h, dim=1, keep_dim=True), L.reduce_min(h),
                L.reduce_prod(h, dim=0)]
        loss = L.mean(outs[0])
    elif case == "logical":
        a = L.less_than(h, L.fill_constant(shape=[1], dtype="float32",
                                           value=0.0))
        b = L.equal(L.argmax(h, axis=1), L.reshape(lbl, [-1]))
        outs = [L.logical_and(a, a), L.logical_or(a, a),
                L.logical_xor(a, a), L.logical_not(a), b]
        loss = L.mean(h)
    elif case == "matmul_transpose_split":
        t = L.transpose(L.reshape(h, [-1, 2, 2]), perm=[0, 2, 1])
        m = L.matmul(t, t, transpose_y=True)
        p, q = L.split(h, 2, dim=1)
        outs = [m, p, q, L.cumsum(h, axis=1), L.reverse(h, 1)]
        loss = L.mean(m) + L.mean(q)
    elif case == "losses":
        sxe = L.softmax_with_cross_entropy(h, lbl)
        sq = L.square_error_cost(L.reduce_sum(h, dim=[1], keep_dim=True),
                                 L.cast(lbl, "float32"))
        oh = L.one_hot(lbl, 4)
        outs = [sxe, sq, oh, L.sigmoid_cross_entropy_with_logits(h, oh)]
        loss = L.mean(sxe) + L.mean(sq)
    elif case == "nets":
        seq = L.reshape(L.fc(input=x, size=8), [-1, 2, 4])
        att = fluid.nets.scaled_dot_product_attention(seq, seq, seq,
                                                      num_heads=2)
        outs = [fluid.nets.glu(h), att]
        loss = L.mean(att)
    elif case == "assign":
        c = L.assign(np.arange(4, dtype=np.float32).reshape(1, 4))
        outs = [L.elementwise_add(h, c), L.label_smooth(L.one_hot(lbl, 4))]
        loss = L.mean(outs[0])
    return loss, outs


CLIPS = {
    "reductions": lambda f: f.clip.GradientClipByGlobalNorm(clip_norm=0.1),
    "logical": lambda f: f.clip.GradientClipByValue(max=0.01),
    "matmul_transpose_split": lambda f: f.clip.GradientClipByNorm(0.05),
    "losses": lambda f: f.clip.GradientClipByGlobalNorm(clip_norm=1.0),
    "nets": lambda f: f.clip.GradientClipByValue(max=0.05),
    "assign": lambda f: f.clip.GradientClipByNorm(0.5),
}
OPTS = {
    "reductions": lambda f: f.optimizer.RMSProp(learning_rate=0.01),
    "logical": lambda f: f.optimizer.Adagrad(learning_rate=0.1),
    "matmul_transpose_split": lambda f: f.optimizer.Adamax(
        learning_rate=0.05),
    "losses": lambda f: f.optimizer.Momentum(learning_rate=0.1,
                                             momentum=0.9),
    "nets": lambda f: f.optimizer.DecayedAdagrad(learning_rate=0.1),
    "assign": lambda f: f.optimizer.Ftrl(learning_rate=0.1),
}


def _build(fluid, case):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss, outs = _net(fluid, case)
        fluid.clip.set_gradient_clip(CLIPS[case](fluid))
        OPTS[case](fluid).minimize(loss)
    main.random_seed = startup.random_seed = 9
    return main, startup, [loss] + outs


def _feeds():
    rs = np.random.RandomState(8)
    return [{"x": rs.randn(5, 6).astype(np.float32),
             "lbl": rs.randint(0, 4, (5, 1)).astype(np.int64)}
            for _ in range(3)]


def _fetched(v):
    a = np.asarray(v)
    return a.astype(np.float64) if a.dtype.kind in "biuf" else a


@pytest.mark.parametrize("case", sorted(OPTS))
def test_layer_programs_run_as_in_the_jax_package(case):
    """3 steps, with a gradient clip and one of the new update rules:
    every fetched value within rtol 1e-4 of the JAX package's."""
    main, startup, fetch = _build(jfluid, case)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n))
                for n, v in main.global_block().vars.items()
                if v.persistable and scope.find_var(n) is not None}
        want = [exe.run(main, feed=f, fetch_list=fetch) for f in _feeds()]
    main, _, fetch = _build(tfluid, case)
    tscope_ = tfluid.Scope()
    convert.load_numpy_state(tscope_, main, init, tfluid.CPUPlace())
    with tfluid.scope_guard(tscope_):
        exe = tfluid.Executor(tfluid.CPUPlace())
        got = [exe.run(main, feed=f, fetch_list=fetch) for f in _feeds()]
    for g_step, w_step in zip(got, want):
        for g, w in zip(g_step, w_step):
            assert np.shape(g) == np.shape(w)
            np.testing.assert_allclose(_fetched(g), _fetched(w), rtol=1e-4,
                                       atol=1e-6)


def test_global_norm_clip_builds_the_norm_once_per_group():
    """GradientClipByGlobalNorm computes the group's norm and scale once
    (the reference clip.py's context cache); the JAX package builds them
    again for every parameter (set_gradient_clip's deep copies each keep
    their own cache), which its XLA step merges and the port would run.
    The clipped values stay the JAX package's (the programs above)."""
    counts = {}
    for name, fluid in (("jax", jfluid), ("port", tfluid)):
        main = _build(fluid, "losses")[0]
        ops = main.global_block().ops
        n_params = len(main.global_block().all_parameters())
        counts[name] = (sum(op.type == "sqrt" for op in ops),
                        sum(op.type == "elementwise_mul" for op in ops),
                        n_params)
    assert counts["port"] == (1, counts["port"][2], counts["port"][2])
    assert counts["jax"][0] == counts["jax"][2]
