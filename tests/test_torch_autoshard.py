"""The port's autoshard (parallel/autoshard: spec, plan, rules, propagate,
search) against the JAX package's, and the sharding annotations.

Each contract of tests/test_autoshard.py and tests/test_sharding_api.py
has a counterpart here: the same layer calls build the same program in
both packages, and the port's ShardingPlan must describe() exactly as the
JAX package's (specs, sources, conflicts, reshard edges, digest), on
those nets and on VGG-16's program at its published widths over
dp 2 × mp 2, before the contract's own assertions run on the port's
plan. The search takes the card's figures by default and the JAX
package's constants when given them, and then returns the JAX package's
result. The contracts that train (auto against manual seeds, the
checkpoint manifest, tensor-parallel training against the replicated
run) run as gloo ranks on the host at dp 1 × mp 2 (tests/
torch_tp_worker.py), fp32, losses within rtol 1e-4 / atol 1e-6 of the
JAX package's and of each other.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as jfluid
from paddle_tpu import analysis as janalysis
from paddle_tpu.cli import main as jcli_main
from paddle_tpu.parallel import autoshard as jautoshard

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import analysis as tanalysis
from paddle_tpu_torch.cli import main as tcli_main
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.parallel import autoshard as tautoshard
from paddle_tpu_torch.parallel import zero1 as tzero1
from paddle_tpu_torch.parallel.autoshard import lower as tlower
from paddle_tpu_torch.parallel.autoshard import search as tsearch
from paddle_tpu_torch.resilience import CheckpointManager

import torch_tp_worker as worker

MESH = {"dp": 4, "mp": 2}
AUTOSHARD = {jfluid: jautoshard, tfluid: tautoshard}
# the JAX package's search constants (paddle_tpu/parallel/autoshard/
# search.py): a TPU v4's peak and one ICI link
JAX_CONSTANTS = {"peak_flops": 275e12, "link_bytes_per_s": 9e10}


@pytest.fixture(autouse=True)
def _fresh_port_state():
    torch.set_num_threads(2)
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    tfluid.unique_name.switch()
    tzero1.reset_registry()
    tautoshard.reset_registry()
    tlower.reset_registry()
    yield
    tautoshard.reset_registry()
    tlower.reset_registry()


def _program(fluid, body):
    """(main, body's result) of `body(fluid)` built in fresh programs."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        got = body(fluid)
    return main, got


def _plans(body, mesh=MESH, **kw):
    """The port's plan of `body`'s program, after holding its describe()
    to the JAX package's; and body's result in the port."""
    out = []
    for fluid in (jfluid, tfluid):
        main, got = _program(fluid, body)
        out.append((AUTOSHARD[fluid].build_plan(main, mesh, **kw), got))
    (jplan, _), (tplan, got) = out
    assert tplan.describe() == jplan.describe()
    assert tplan.render() == jplan.render()
    return tplan, got


def _fc(w_spec, hidden=32):
    def body(fluid):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        h = fluid.layers.fc(input=x, size=hidden,
                            param_attr=fluid.ParamAttr(name="w1"))
        fluid.parallel.set_sharding(
            fluid.default_main_program().global_block().var("w1"), w_spec)
        return h.name
    return body


# ---------------------------------------------------------------------------
# per-rule contracts (tests/test_autoshard.py)
# ---------------------------------------------------------------------------
def test_matmul_col_sharded_propagates_to_output():
    plan, h = _plans(_fc((None, "mp")))
    assert plan.spec_of("w1") == (None, "mp")
    assert plan.spec_of(h) == ("dp", "mp")
    assert plan.is_total() and not plan.unresolved


def test_matmul_row_sharded_keeps_output_contracting_replicated():
    plan, h = _plans(_fc(("mp", None)))
    assert plan.spec_of("w1") == ("mp",)
    assert plan.spec_of(h) == ("dp",)
    assert plan.is_total()


def test_conv2d_filter_sharded_propagates_to_channel_dim():
    def body(fluid):
        img = fluid.layers.data(name="img", shape=[2, 8, 8],
                                dtype="float32")
        out = fluid.layers.conv2d(img, num_filters=4, filter_size=3,
                                  param_attr=fluid.ParamAttr(name="cw"))
        fluid.parallel.set_sharding(
            fluid.default_main_program().global_block().var("cw"),
            ("mp", None, None, None))
        return out.name

    plan, out = _plans(body)
    assert plan.spec_of(out) == ("dp", "mp")
    assert plan.is_total()


def test_reduce_drops_sharded_axis():
    def body(fluid):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        h = fluid.layers.fc(input=x, size=32,
                            param_attr=fluid.ParamAttr(name="w1"))
        r = fluid.layers.reduce_sum(h, dim=1)
        m = fluid.layers.mean(h)
        fluid.parallel.set_sharding(
            fluid.default_main_program().global_block().var("w1"),
            (None, "mp"))
        return h.name, r.name, m.name

    plan, (h, r, m) = _plans(body)
    assert plan.spec_of(h) == ("dp", "mp")
    assert plan.spec_of(r) == ("dp",)
    assert plan.spec_of(m) == ()


def test_reshape_round_trip_preserves_sharding():
    def body(fluid):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        h = fluid.layers.fc(input=x, size=32,
                            param_attr=fluid.ParamAttr(name="w1"))
        r = fluid.layers.reshape(h, shape=[-1, 4, 8], inplace=False)
        back = fluid.layers.reshape(r, shape=[-1, 32], inplace=False)
        fluid.parallel.set_sharding(
            fluid.default_main_program().global_block().var("w1"),
            (None, "mp"))
        return r.name, back.name

    plan, (r, back) = _plans(body)
    assert plan.spec_of(r) == ("dp", "mp")
    assert plan.spec_of(back) == ("dp", "mp")


def _two_branches(spec_a, spec_b):
    def body(fluid):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        a = fluid.layers.fc(input=x, size=32, bias_attr=False,
                            param_attr=fluid.ParamAttr(name="wa"))
        b = fluid.layers.fc(input=x, size=32, bias_attr=False,
                            param_attr=fluid.ParamAttr(name="wb"))
        s = fluid.layers.elementwise_add(a, b)
        gb = fluid.default_main_program().global_block()
        fluid.parallel.set_sharding(gb.var("wa"), spec_a)
        fluid.parallel.set_sharding(gb.var("wb"), spec_b)
        return s.name
    return body


def test_unannotated_operand_adopts_the_sharded_branch():
    plan, s = _plans(_two_branches((None, "mp"), ("mp", None)))
    assert plan.is_total() and not plan.unresolved
    assert plan.spec_of(s) == ("dp", "mp")
    assert not plan.conflicts


def test_conflict_resolved_by_cost_model_and_recorded():
    mesh3 = {"dp": 2, "mp": 2, "pp": 2}
    plan, s = _plans(_two_branches((None, "mp"), (None, "pp")), mesh=mesh3)
    assert plan.is_total() and not plan.unresolved
    assert plan.conflicts
    assert plan.spec_of(s) in (("dp", "mp"), ("dp", "pp"))
    c = plan.conflicts[0]
    assert c["var"] == s
    assert {tuple(c["kept"]), tuple(c["dropped"])} == \
        {("dp", "mp"), ("dp", "pp")}


def test_grads_and_optimizer_slots_follow_param_seed():
    def body(fluid):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=32, act="relu",
                            param_attr=fluid.ParamAttr(name="w1"))
        p = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=p, label=y))
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
        fluid.parallel.set_sharding(
            fluid.default_main_program().global_block().var("w1"),
            (None, "mp"))

    plan, _ = _plans(body)
    assert plan.is_total() and not plan.unresolved
    assert plan.spec_of("w1@GRAD") == (None, "mp")
    moments = [n for n in plan.specs if n.startswith("w1_moment")]
    assert moments
    for n in moments:
        assert plan.spec_of(n) == (None, "mp"), n


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------
def test_unknown_mesh_axis_rejected_at_plan_time():
    msgs = []
    for fluid in (jfluid, tfluid):
        main, _ = _program(fluid, _fc((None, "tp")))
        with pytest.raises(ValueError, match="not in the mesh") as ei:
            AUTOSHARD[fluid].build_plan(main, MESH)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert "w1" in msgs[1] and "tp" in msgs[1] and "mp" in msgs[1]


def test_unknown_mesh_axis_rejected_before_compile():
    """ParallelExecutor.run raises it before any step, with autoshard
    off, on the port's one-rank mesh with an mp axis of one."""
    rng = np.random.RandomState(0)

    def body(fluid):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        p = fluid.layers.fc(input=x, size=1,
                            param_attr=fluid.ParamAttr(name="w1"))
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=p, label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        fluid.parallel.set_sharding(
            fluid.default_main_program().global_block().var("w1"),
            ("bogus_axis", None))
        return loss

    main, loss = _program(tfluid, body)
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        pe = tfluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                     main_program=main,
                                     mesh_shape={"dp": 1, "mp": 1})
        with pytest.raises(ValueError, match="not in the mesh"):
            pe.run([loss], feed={"x": rng.randn(8, 16).astype(np.float32),
                                 "y": rng.randn(8, 1).astype(np.float32)})


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("src,dst", [((), ("mp",)), (("mp",), ()),
                                     (("dp",), ("mp",)), (("mp",), ("mp",)),
                                     ((None, "mp"), ("dp", None))])
def test_transition_bytes_model(src, dst):
    shape, dt = (64, 64), "float32"
    got = tautoshard.transition_bytes(shape, dt, src, dst, MESH)
    assert got == jautoshard.transition_bytes(shape, dt, src, dst, MESH)
    up = tautoshard.transition_bytes(shape, dt, ("mp",), (), MESH)
    assert up == pytest.approx(64 * 64 * 4 * (2 - 1) / 2)
    assert tautoshard.transition_bytes(shape, dt, (), ("mp",), MESH) == 0
    assert tautoshard.transition_bytes(shape, dt, ("dp",), ("mp",),
                                       MESH) > up


def test_plan_digest_is_stable_and_layout_sensitive():
    p1, _ = _plans(_fc((None, "mp")))
    p2, _ = _plans(_fc((None, "mp")))
    p3, _ = _plans(_fc(("mp", None)))
    assert p1.digest() == p2.digest()
    assert p1.digest() != p3.digest()


# ---------------------------------------------------------------------------
# the contracts that train: gloo ranks at dp 1 x mp 2
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("autoshard"))
    cases, files = [], {}
    for net, opt in (("mixed", "adam"), ("mlp", "sgd")):
        main, startup, _ = worker.build(jfluid, net, opt)
        scope = jfluid.Scope()
        with jfluid.scope_guard(scope):
            jfluid.Executor(jfluid.CPUPlace()).run(startup)
        init = {n: np.asarray(scope.find_var(n))
                for n, v in main.global_block().vars.items()
                if v.persistable and scope.find_var(n) is not None}
        files[net] = (os.path.join(tmp, f"init.{net}.npz"),
                      os.path.join(tmp, f"data.{net}.npz"))
        np.savez(files[net][0], **init)
        np.savez(files[net][1], **worker.batches(net, 4, 8))
    for auto in (True, False):
        cases.append({"kind": "pe", "name": f"mixed_{auto}", "net": "mixed",
                      "opt": "adam", "auto": auto, "reduce": False,
                      "init": files["mixed"][0], "data": files["mixed"][1],
                      "fetch_grads": []})
    cases.append({"kind": "pe", "name": "mlp_tp", "net": "mlp",
                  "opt": "sgd", "auto": False, "reduce": False,
                  "init": files["mlp"][0], "data": files["mlp"][1],
                  "fetch_grads": []})
    ckpt = os.path.join(tmp, "ck")
    cases.append({"kind": "pe", "name": "ckpt", "net": "mixed",
                  "opt": "adam", "auto": True, "reduce": False,
                  "init": files["mixed"][0], "data": files["mixed"][1],
                  "fetch_grads": [], "save": ckpt})
    got = worker.launch(2, {"dp": 1, "mp": 2}, cases,
                        os.path.join(tmp, "ranks"))
    return {"runs": got, "files": files, "ckpt": ckpt}


def test_e2e_autoshard_matches_manual_on_mixed_model(trained):
    """Seeds on the embedding table and the first fc weight only: the
    run with the plan registered (auto_sharding on) and the one without
    give the same losses, which fall; the plan is total and shards at
    least 4 vars."""
    got = trained["runs"]["mixed_True"][0]
    ref = trained["runs"]["mixed_False"][0]
    plan = json.loads(str(got["describe"]))
    assert plan["total"] and not plan["unresolved"]
    assert plan["n_sharded"] >= 4
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4,
                               atol=1e-5)
    assert got["losses"][-1] < got["losses"][0]


def test_checkpoint_manifest_records_autoshard_plan(trained):
    got = trained["runs"]["ckpt"][0]
    main, _, _ = worker.build(tfluid, "mixed", "adam")
    man = CheckpointManager(os.path.join(trained["ckpt"], "0"),
                            async_write=False).restore(
        scope=tfluid.Scope(), program=main, place=tfluid.CPUPlace())
    info = man.get("autoshard")
    assert info, man.keys()
    assert info["digest"] == str(got["digest"])
    assert info["layout"] == "full"
    assert info["mesh_axes"] == {"dp": 1, "mp": 2}
    assert list(info["params"]["emb_w"]) == ["mp"]
    assert tuple(man["vars"]["emb_w"]["shape"]) == (32, 16)


def test_tensor_parallel_training_matches_replicated(trained):
    """w1 column- and w2 row-sharded over mp: the JAX package's replicated
    executor's losses, and each rank holds its slice of w1
    (tests/test_sharding_api.py)."""
    main, _, loss = worker.build(jfluid, "mlp", "sgd", seeds=False)
    init = dict(np.load(trained["files"]["mlp"][0]))
    data = dict(np.load(trained["files"]["mlp"][1]))
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        for n, v in init.items():
            scope.set_var(n, jax.numpy.asarray(v))
        pe = jfluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                     main_program=main,
                                     devices=jax.devices()[:1])
        base = [float(np.asarray(pe.run([loss], feed={
            n: v[k] for n, v in data.items()})[0]).reshape(-1)[0])
            for k in range(4)]
    for got in trained["runs"]["mlp_tp"]:
        np.testing.assert_allclose(got["losses"], base, rtol=1e-4,
                                   atol=1e-6)
        assert tuple(got["shape/w1"]) == (16, 16)
        assert tuple(got["state/w1"].shape) == (16, 32)


# ---------------------------------------------------------------------------
# sub-blocks
# ---------------------------------------------------------------------------
def _while_body(fluid):
    x = fluid.layers.data(name="x", shape=[16], dtype="float32")
    i = fluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
    limit = fluid.layers.fill_constant(shape=[1], dtype="int64", value=3)
    cond = fluid.layers.less_than(x=i, y=limit)
    w = fluid.layers.While(cond=cond)
    with w.block():
        h = fluid.layers.fc(input=x, size=16,
                            param_attr=fluid.ParamAttr(name="w_loop"))
        fluid.layers.assign(h, x)
        fluid.layers.increment(x=i, value=1, in_place=True)
        fluid.layers.less_than(x=i, y=limit, cond=cond)
    main = fluid.default_main_program()
    fluid.parallel.set_sharding(main.global_block().var("w_loop"),
                                (None, "mp"))
    return next(v for op in main.global_block().ops
                for v in op.attrs.values()
                if hasattr(v, "ops") and hasattr(v, "vars"))


def test_while_body_reading_sharded_param_derives_layouts():
    plan, sub = _plans(_while_body)
    assert plan.spec_of("w_loop") == (None, "mp")
    mul_out = next(op.output_arg_names()[0] for op in sub.ops
                   if op.type == "mul")
    assert plan.spec_of(mul_out) == ("dp", "mp")
    for op in sub.ops:
        for n in op.output_arg_names():
            assert n in plan.specs, n
    assert plan.is_total()


def test_while_body_vars_shadowed_by_parent_keep_parent_spec():
    plan, _ = _plans(_while_body)
    assert plan.spec_of("x") == ("dp",)
    # the loop counter stays replicated: nothing shards a scalar
    counter = next(op.output_arg_names()[0] for op in _program(
        tfluid, _while_body)[0].global_block().ops
        if op.type == "fill_constant")
    assert plan.spec_of(counter) == ()


# ---------------------------------------------------------------------------
# plan search
# ---------------------------------------------------------------------------
def _search_net(fluid):
    ids = fluid.layers.data(name="ids", shape=[1], dtype="int64")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    emb = fluid.layers.embedding(
        ids, size=[64, 32], param_attr=fluid.ParamAttr(name="emb_w"))
    h = fluid.layers.fc(input=emb, size=64,
                        param_attr=fluid.ParamAttr(name="w1"))
    p = fluid.layers.fc(input=h, size=1)
    loss = fluid.layers.mean(
        fluid.layers.square_error_cost(input=p, label=y))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)


def test_enumerate_candidates_skips_batch_axis_and_invalid_dims():
    got = []
    for fluid in (jfluid, tfluid):
        main, _ = _program(fluid, _search_net)
        got.append(AUTOSHARD[fluid].enumerate_seed_candidates(
            main, MESH, min_bytes=1))
    assert got[0] == got[1]
    cands = got[1]
    assert "emb_w" in cands and "w1" in cands
    for specs in cands.values():
        assert () in specs
        for s in specs:
            assert "dp" not in s
    assert (None, "mp") in cands["emb_w"] and ("mp",) in cands["emb_w"]


def _searched(fluid, **kw):
    main, _ = _program(fluid, _search_net)
    fluid.parallel.set_sharding(main.global_block().var("emb_w"),
                                ("mp", None))
    return AUTOSHARD[fluid].search_plan(main, MESH, batch_size=16, **kw)


def test_search_plan_never_costs_more_than_manual_seeds():
    """With the JAX package's constants the port's search is the JAX
    package's, step for step; with its own (an H100's) it keeps the
    contract, and its chosen seeds are recorded."""
    want = _searched(jfluid).to_dict()
    assert _searched(tfluid, **JAX_CONSTANTS).to_dict() == want
    res = _searched(tfluid)
    assert res.evaluated > 1
    assert res.cost["score_s"] <= res.manual_cost["score_s"]
    assert res.plan.is_total() and not res.plan.unresolved
    d = res.to_dict()
    assert d["digest"] == res.plan.digest()
    assert d["seeds"] and "searched score" in res.render()


def test_plan_cost_models_sharded_compute_and_hbm_feasibility():
    costs = {}
    for fluid in (jfluid, tfluid):
        main, _ = _program(fluid, _search_net)
        a = AUTOSHARD[fluid]
        rep = a.build_plan(main, MESH, ignore_program_seeds=True)
        sh = a.build_plan(main, MESH, extra_seeds={"w1": (None, "mp")},
                          ignore_program_seeds=True)
        kw = JAX_CONSTANTS if fluid is tfluid else {}
        costs[fluid] = [a.plan_cost(main, p, batch_size=16, **kw)
                        for p in (rep, sh)] + [
            a.plan_cost(main, sh, batch_size=16, hbm_budget=1, **kw)]
    assert costs[tfluid] == costs[jfluid]
    main, _ = _program(tfluid, _search_net)
    rep = tautoshard.build_plan(main, MESH, ignore_program_seeds=True)
    sh = tautoshard.build_plan(main, MESH, extra_seeds={"w1": (None, "mp")},
                               ignore_program_seeds=True)
    c_rep = tautoshard.plan_cost(main, rep, batch_size=16)
    c_sh = tautoshard.plan_cost(main, sh, batch_size=16)
    assert c_sh["compute_s"] < c_rep["compute_s"]
    assert c_rep["feasible"] and c_sh["feasible"]
    tight = tautoshard.plan_cost(main, sh, batch_size=16, hbm_budget=1)
    assert not tight["feasible"] and tight["score_s"] > c_sh["score_s"] * 1e6


def test_the_search_carries_no_tpu_figure():
    """The defaults are one H100 SXM's data-sheet figures: monitor/mfu.py's
    dense bf16 peak and one direction of its NVLink."""
    from paddle_tpu_torch.monitor.mfu import CHIP_PEAK_TFLOPS

    assert tsearch.PEAK_FLOPS == CHIP_PEAK_TFLOPS["H100 80GB HBM3"] * 1e12
    assert tsearch.PEAK_FLOPS == pytest.approx(989.4e12)
    assert tsearch.LINK_BYTES_PER_S == 450e9
    assert not hasattr(tsearch, "ICI_BYTES_PER_S")


# ---------------------------------------------------------------------------
# the module's surface, the port's own op types, VGG-16's plan
# ---------------------------------------------------------------------------
def test_the_package_and_its_rules_are_the_jax_packages():
    assert sorted(tautoshard.__all__) == sorted(jautoshard.__all__)
    assert tautoshard.registered_ops() == jautoshard.registered_ops()
    from paddle_tpu_torch.parallel.autoshard import rules

    for t in ("split_lod_tensor", "merge_lod_tensor",
              "merge_lod_tensor_grad", "split_byref"):
        assert rules.rule_for(t) is None, t


def _vgg16(fluid):
    images = fluid.layers.data(name="pixel", shape=[3, 224, 224],
                               dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    models = jfluid.models if fluid is jfluid else tfluid.models
    net = models.vgg.vgg16_bn_drop(images)
    predict = fluid.layers.fc(input=net, size=102, act="softmax")
    loss = fluid.layers.mean(
        fluid.layers.cross_entropy(input=predict, label=label))
    fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    gb = fluid.default_main_program().global_block()
    fc1, fc2 = (next(op.input("Y")[0] for op in gb.ops
                     if op.type == "mul" and gb.var(op.input("Y")[0]).shape
                     == shape) for shape in ((25088, 512), (512, 512)))
    fluid.parallel.set_sharding(gb.var(fc1), (None, "mp"))
    fluid.parallel.set_sharding(gb.var(fc2), ("mp", None))
    return fc1, fc2


def test_vgg16_plan_at_dp2_mp2_is_the_jax_packages():
    """VGG-16 at its published widths with fc1's weight (None, mp) and
    fc2's (mp, None): the same plan as the JAX package's, total; fc1's
    output, its batch norm and dropout, and their grads and Adam moments
    are sharded over mp; fc2's output is whole."""
    import paddle_tpu.models.vgg  # noqa: F401
    import paddle_tpu_torch.models.vgg  # noqa: F401

    plan, (fc1, fc2) = _plans(_vgg16, mesh={"dp": 2, "mp": 2})
    assert plan.is_total() and not plan.unresolved
    assert plan.spec_of(fc1 + "@GRAD") == (None, "mp")
    assert plan.spec_of(fc2) == ("mp",)
    moments = [n for n in plan.specs if n.startswith(fc1 + "_moment")]
    assert len(moments) == 2
    assert all(plan.spec_of(n) == (None, "mp") for n in moments)
    bn = [n for n, s in plan.specs.items() if n.startswith("batch_norm_13")
          and s == ("mp",)]
    assert bn  # fc1's batch norm: its scale, bias and running stats


# ---------------------------------------------------------------------------
# plan checks (tests/test_analysis.py)
# ---------------------------------------------------------------------------
def test_autoshard_plan_validates_and_audits_edges():
    reports = []
    for fluid in (jfluid, tfluid):
        def body(fluid):
            ids = fluid.layers.data(name="ids", shape=[1], dtype="int64")
            y = fluid.layers.data(name="y", shape=[1], dtype="float32")
            emb = fluid.layers.embedding(ids, size=[32, 16])
            h = fluid.layers.fc(emb, size=32, act="relu")
            p = fluid.layers.fc(h, size=1)
            loss = fluid.layers.mean(fluid.layers.square_error_cost(p, y))
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
            return loss.name

        main, loss = _program(fluid, body)
        gb = main.global_block()
        embw = next(n for n, v in gb.vars.items()
                    if getattr(v, "persistable", False)
                    and v.shape == (32, 16))
        fluid.parallel.set_sharding(gb.var(embw), ("mp", None))
        plan = AUTOSHARD[fluid].build_plan(main, MESH)
        an = janalysis if fluid is jfluid else tanalysis
        kw = dict(level="full", feed_names=["ids", "y"], fetch_names=[loss],
                  mesh_axes=MESH)
        r = an.verify(main, aplan=plan, **kw)
        assert r.ok, [str(d) for d in r.errors()]
        assert "PTA023" not in r.codes()
        plan.reshard_edges.append({"var": embw, "src": ("mp",), "dst": (),
                                   "op": "x", "bytes": 12345})
        plan.unresolved.append(embw)
        r2 = an.verify(main, aplan=plan, **kw)
        reports.append(sorted((d.code, d.var) for d in r2.diagnostics))
    assert reports[0] == reports[1]
    assert ("PTA023", reports[1][-1][1]) in reports[1] or any(
        c == "PTA023" for c, _ in reports[1])
    assert any(c == "PTA022" for c, _ in reports[1])


# ---------------------------------------------------------------------------
# shard plan | search (the JAX CLI's output)
# ---------------------------------------------------------------------------
def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv", [
    ["shard", "plan", "--selftest", "--json"],
    ["shard", "plan", "--selftest"],
    ["shard", "plan", "--selftest", "--quiet", "--mesh", "dp=2,mp=4"],
    ["shard", "plan", "--selftest", "--json", "--seed", "fc_1.w_0=mp,None"],
    ["shard", "search", "--selftest", "--json"],
    ["shard", "search", "--selftest", "--quiet"],
    ["shard", "plan", "--selftest", "--mesh", "dp=x"],
    ["shard", "plan"]])
def test_shard_cli_gives_the_jax_commands_output(argv):
    """Each command and its exit code as the JAX CLI's; the search with
    the JAX command's constants (--peak-tflops 275 --link-gbps 90)."""
    extra = ["--peak-tflops", "275", "--link-gbps", "90"] \
        if argv[1] == "search" else []
    want = _cli(jcli_main, argv)
    got = _cli(tcli_main, argv + extra)
    assert got == want


def test_shard_search_cli_on_the_card_constants():
    rc, out, err = _cli(tcli_main, ["shard", "search", "--selftest",
                                    "--json"])
    assert rc == 0 and "selftest: OK" in err
    d = json.loads(out)
    assert d["seeds"] and d["cost"]["score_s"] <= \
        d["manual_cost"]["score_s"]


def test_shard_plan_cli_reads_a_model_dir(tmp_path):
    """`shard plan --model-dir` plans a save_inference_model directory,
    its seeds given with --seed."""
    main, _ = _program(tfluid, _search_net)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        for n, v in main.global_block().vars.items():
            if v.persistable and v.shape and all(d > 0 for d in v.shape):
                scope.set_var(n, torch.zeros(tuple(v.shape)))
        tfluid.io.save_inference_model(
            str(tmp_path), ["ids"],
            [main.global_block().var(n) for n in main.global_block().vars
             if n.startswith("fc_1.tmp_1")], exe, main_program=main)
    rc, out, _ = _cli(tcli_main, ["shard", "plan", "--model-dir",
                                  str(tmp_path), "--json", "--seed",
                                  "emb_w=mp,None"])
    assert rc == 0
    d = json.loads(out)
    assert d["total"] and d["specs"]["emb_w"] == ["mp"]


# ---------------------------------------------------------------------------
# the sharding annotations (tests/test_sharding_api.py)
# ---------------------------------------------------------------------------
def test_set_sharding_validation():
    main, w = _program(tfluid, lambda f: f.layers.fc(
        input=f.layers.data(name="x", shape=[4], dtype="float32"), size=2,
        param_attr=f.ParamAttr(name="W")))
    w = main.global_block().var("W")
    tfluid.parallel.set_sharding(w, (None, "mp"))
    assert tfluid.parallel.get_sharding(w) == (None, "mp")
    with pytest.raises(ValueError, match="longer than"):
        tfluid.parallel.set_sharding(w, (None, "mp", "dp"))
    with pytest.raises(TypeError):
        tfluid.parallel.set_sharding(w, (3,))
    with pytest.raises(TypeError):
        tfluid.parallel.set_sharding("W", (None,))


def test_mesh_shape_validation():
    main, loss = _program(tfluid, lambda f: f.layers.mean(f.layers.fc(
        input=f.layers.data(name="x", shape=[4], dtype="float32"), size=2)))
    with pytest.raises(ValueError, match="needs 15 ranks"):
        tfluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                main_program=main,
                                mesh_shape={"dp": 3, "mp": 5})


def test_bad_divisibility_raises():
    """hidden 30 over mp 4: the plan refuses it, in both packages, before
    any lowering or step."""
    msgs = []
    for fluid in (jfluid, tfluid):
        main, _ = _program(fluid, _fc((None, "mp"), hidden=30))
        with pytest.raises(ValueError, match="not divisible") as ei:
            AUTOSHARD[fluid].build_plan(main, {"dp": 2, "mp": 4})
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_set_sharding_accepts_bare_axis_and_partition_spec():
    from jax.sharding import PartitionSpec as P

    main, _ = _program(tfluid, lambda f: f.layers.fc(
        input=f.layers.data(name="x", shape=[4], dtype="float32"), size=2,
        param_attr=f.ParamAttr(name="W")))
    w = main.global_block().var("W")
    tfluid.parallel.set_sharding(w, "mp")
    assert tfluid.parallel.get_sharding(w) == ("mp",)
    tfluid.parallel.set_sharding(w, P(None, "mp"))  # iterated positionally
    assert tfluid.parallel.get_sharding(w) == (None, "mp")
    tfluid.parallel.set_sharding(w, P("dp"))
    assert tfluid.parallel.get_sharding(w) == ("dp",)
    with pytest.raises(TypeError):
        tfluid.parallel.set_sharding(w, P(("dp", "mp"), None))
    assert tautoshard.normalize_spec([("mp",), None]) == ("mp", None)


def _scoped(fluid):
    x = fluid.layers.data(name="x", shape=[16], dtype="float32")
    with fluid.parallel.sharding_scope((None, "mp")):
        h = fluid.layers.fc(input=x, size=32, act="relu",
                            param_attr=fluid.ParamAttr(name="w1"))
        fluid.layers.fc(input=h, size=8,
                        param_attr=fluid.ParamAttr(name="w2"))
        with fluid.parallel.sharding_scope(("mp", None)):
            fluid.layers.fc(input=h, size=32, bias_attr=False,
                            param_attr=fluid.ParamAttr(name="wi"))
    fluid.layers.fc(input=h, size=1, param_attr=fluid.ParamAttr(name="w3"))
    gb = fluid.default_main_program().global_block()
    return {n: fluid.parallel.get_sharding(v) for n, v in gb.vars.items()
            if getattr(v, "persistable", False)}


def test_sharding_scope_annotates_created_params():
    _, want = _program(jfluid, _scoped)
    _, got = _program(tfluid, _scoped)
    assert got == want
    assert got["w1"] == got["w2"] == (None, "mp")
    assert got["w3"] is None
    assert all(s is None for n, s in got.items() if ".w_" in n)


def test_sharding_scope_inner_wins_and_explicit_seed_survives():
    main, got = _program(tfluid, _scoped)
    assert got["wi"] == ("mp", None)
    tfluid.parallel.set_sharding(main.global_block().var("wi"), (None, "mp"))
    assert tfluid.parallel.get_sharding(
        main.global_block().var("wi")) == (None, "mp")
