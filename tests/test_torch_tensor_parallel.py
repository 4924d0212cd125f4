"""The port's tensor parallelism against the JAX package: ParallelExecutor
over a dp × mp mesh with set_sharding seeds, the lowering of the plan to
each rank's program (parallel/autoshard/lower.py), the sharded embedding
and checkpoints across meshes.

The multi-rank cases run as gloo ranks on the host (tests/
torch_tp_worker.py: each a process that imports only paddle_tpu_torch,
rendezvousing through a file in the test's tmp dir, all killed after 240
s) at dp 1 × mp 2 (2 ranks) and dp 2 × mp 2 (4 ranks), from the JAX
package's initial state carried over with convert.load_numpy_state, over
the same 3 global batches of 8 made by numpy from a seed. The JAX
package's ParallelExecutor runs the same program over the first D × M
devices of the conftest's 8-device CPU mesh with the same mesh_shape.
fp32 bounds: losses and gradients within rtol 1e-4 (atol 1e-6) of the
JAX package, with auto_sharding on and off and under
BuildStrategy.Reduce; the state within rtol 1e-4 / atol 1e-5 (Adam and
Momentum sum 3 steps of those gradients). The nets with dropout draw
from the port's random stream, which the JAX package does not share:
they are held to the port's own one-rank ParallelExecutor, within rtol
1e-5 / atol 1e-6 (the mp ranks sum a row-parallel product and a column-
parallel input gradient in two halves, which reorders the float sums).
Replicated state is bitwise equal across the ranks.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as jfluid
from paddle_tpu.parallel import autoshard as jautoshard
from paddle_tpu.parallel import zero1 as jzero1

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.parallel import autoshard as tautoshard
from paddle_tpu_torch.parallel import mesh as tmesh
from paddle_tpu_torch.parallel import zero1 as tzero1
from paddle_tpu_torch.parallel.autoshard import lower as tlower
from paddle_tpu_torch.resilience import CheckpointManager

import torch_tp_worker as worker

STEPS = 3
BATCH = 8
RTOL, ATOL = 1e-4, 1e-6
STATE_ATOL = 1e-5
MESHES = {"dp1mp2": {"dp": 1, "mp": 2}, "dp2mp2": {"dp": 2, "mp": 2}}

# (case name, net, optimizer, mesh, auto_sharding, Reduce): the cases held
# to the JAX package
JAX_CASES = [
    ("mlp_sgd_auto", "mlp", "sgd", "dp1mp2", True, False),
    ("mlp_adam_off", "mlp", "adam", "dp1mp2", False, False),
    ("mixed_adam_auto", "mixed", "adam", "dp1mp2", True, False),
    ("conv_momentum_auto", "conv_mp", "momentum", "dp1mp2", True, False),
    ("mlp_adam_auto", "mlp", "adam", "dp2mp2", True, False),
    ("mixed_adam_off", "mixed", "adam", "dp2mp2", False, False),
    ("mlp_adam_reduce", "mlp", "adam", "dp2mp2", True, True),
    ("conv_momentum_reduce", "conv_mp", "momentum", "dp2mp2", False, True),
    ("mixed_adam_reduce", "mixed", "adam", "dp2mp2", True, True),
]
# the dropout nets, held to the port's one-rank run. VGG's head trains
# with Momentum here: the biases before its batch norms get gradients of
# pure rounding (the normalisation removes them), which Adam scales up
# to steps of its learning rate, so two exact runs' biases part by
# ~lr; Adam is on the mlp with dropout and on the JAX cases.
DROPOUT_CASES = [
    ("vgg_head_auto", "vgg_head", "momentum", "dp1mp2", True, False),
    ("vgg_head_off", "vgg_head", "momentum", "dp1mp2", False, False),
    ("mlp_dropout_auto", "mlp_dropout", "adam", "dp2mp2", True, False),
    ("vgg_head_reduce", "vgg_head", "momentum", "dp2mp2", True, True),
]


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
    tzero1.reset_registry()
    tautoshard.reset_registry()
    tlower.reset_registry()


# ---------------------------------------------------------------------------
# the same cases on both sides
# ---------------------------------------------------------------------------
def jax_init(net, opt):
    """{name: array} of the JAX package's startup state for `net`."""
    main, startup, _ = worker.build(jfluid, net, opt)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    return {n: np.asarray(scope.find_var(n))
            for n, v in main.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}


def jax_pe(net, opt, mesh, auto, reduce):
    """The JAX package's ParallelExecutor over the first D × M devices:
    (losses, {seeded weight: [steps, ...] grads}, full-layout state)."""
    main, startup, loss = worker.build(jfluid, net, opt)
    data = worker.batches(net, STEPS, BATCH)
    grads = sorted(worker.SEEDS[net])
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
        bs = jfluid.BuildStrategy()
        bs.auto_sharding = auto
        if reduce:
            bs.reduce_strategy = jfluid.BuildStrategy.ReduceStrategy.Reduce
        pe = jfluid.ParallelExecutor(
            use_cuda=False, loss_name=loss.name, main_program=main,
            build_strategy=bs, mesh_shape=mesh,
            devices=jax.devices()[:mesh["dp"] * mesh["mp"]])
        losses, fetched = [], {g: [] for g in grads}
        for k in range(STEPS):
            outs = pe.run([loss] + [g + "@GRAD" for g in grads],
                          feed={n: v[k] for n, v in data.items()})
            losses.append(float(np.asarray(outs[0]).reshape(-1)[0]))
            for g, v in zip(grads, outs[1:]):
                fetched[g].append(np.asarray(v))
        snap = {n: np.asarray(scope.find_var(n))
                for n, v in main.global_block().vars.items()
                if v.persistable and scope.find_var(n) is not None}
    state, _ = jzero1.canonicalize_snapshot(snap)
    return (np.asarray(losses), {g: np.stack(v) for g, v in fetched.items()},
            state)


def port_one_rank(net, opt, init, data):
    """The port's ParallelExecutor without a group (one rank) from
    `init`: (losses, {seeded weight: grads}, state)."""
    main, _, loss = worker.build(tfluid, net, opt, seeds=False)
    grads = sorted(worker.SEEDS[net])
    scope = tfluid.Scope()
    convert.load_numpy_state(scope, main, init, tfluid.CPUPlace())
    with tfluid.scope_guard(scope):
        pe = tfluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                     main_program=main)
        losses, fetched = [], {g: [] for g in grads}
        for k in range(STEPS):
            outs = pe.run([loss] + [g + "@GRAD" for g in grads],
                          feed={n: v[k] for n, v in data.items()})
            losses.append(float(np.asarray(outs[0]).reshape(-1)[0]))
            for g, v in zip(grads, outs[1:]):
                fetched[g].append(np.asarray(v))
        state = convert.numpy_state(scope, main)
    return (np.asarray(losses), {g: np.stack(v) for g, v in fetched.items()},
            state)


def _files(tmp, net, opt):
    init = os.path.join(tmp, f"init.{net}.{opt}.npz")
    if not os.path.exists(init):
        np.savez(init, **jax_init(net, opt))
    data = os.path.join(tmp, f"data.{net}.npz")
    if not os.path.exists(data):
        np.savez(data, **worker.batches(net, STEPS, BATCH))
    return init, data


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every multi-rank case, one launch a mesh: {case name: [rank 0's
    results, ...]}, and the paths of the checkpoint the one-rank run
    saved (which the dp 1 × mp 2 ranks restore) and of the one the
    dp 2 × mp 2 ranks saved."""
    tmp = str(tmp_path_factory.mktemp("tp"))
    cases = {m: [] for m in MESHES}
    for name, net, opt, mesh, auto, reduce in JAX_CASES + DROPOUT_CASES:
        init, data = _files(tmp, net, opt)
        cases[mesh].append({
            "kind": "pe", "name": name, "net": net, "opt": opt,
            "auto": auto, "reduce": reduce, "init": init, "data": data,
            "fetch_grads": sorted(worker.SEEDS[net])})
    # checkpoints across meshes: a one-rank run saves, dp 1 x mp 2
    # restores and runs on; dp 2 x mp 2 saves, one rank restores
    init, data = _files(tmp, "mlp", "adam")
    one_dir = os.path.join(tmp, "ckpt_one_rank")
    main, _, loss = worker.build(tfluid, "mlp", "adam", seeds=False)
    scope = tfluid.Scope()
    convert.load_numpy_state(scope, main, dict(np.load(init)),
                             tfluid.CPUPlace())
    with tfluid.scope_guard(scope):
        pe = tfluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                     main_program=main)
        first = worker.batches("mlp", STEPS, BATCH, seed=5)
        for k in range(STEPS):
            pe.run([loss], feed={n: v[k] for n, v in first.items()})
    cm = CheckpointManager(one_dir, async_write=False)
    cm.save(STEPS, scope=scope, program=main, block=True)
    cm.close()
    cases["dp1mp2"].append({
        "kind": "pe", "name": "restore_one_rank", "net": "mlp",
        "opt": "adam", "auto": True, "reduce": False, "init": init,
        "data": data, "fetch_grads": [], "restore": one_dir})
    saved = os.path.join(tmp, "ckpt_dp2mp2")
    cases["dp2mp2"].append({
        "kind": "pe", "name": "save_dp2mp2", "net": "mlp", "opt": "adam",
        "auto": True, "reduce": True, "init": init, "data": data,
        "fetch_grads": [], "save": saved})
    # the fused update on the local shards against the unfused one
    init, data = _files(tmp, "mlp", "adam")
    for fuse in (True, False):
        cases["dp1mp2"].append({
            "kind": "pe", "name": f"mlp_fuse_{fuse}", "net": "mlp",
            "opt": "adam", "auto": True, "reduce": False, "init": init,
            "data": data, "fetch_grads": [], "fuse": fuse})
    # and under zero1, whose gathers move with the fused update, each
    # with the slice the lowering puts behind it
    init, data = _files(tmp, "vgg_head", "momentum")
    cases["dp2mp2"].append({
        "kind": "pe", "name": "vgg_head_reduce_fused", "net": "vgg_head",
        "opt": "momentum", "auto": True, "reduce": True, "init": init,
        "data": data, "fetch_grads": [], "fuse": True})
    for mesh in MESHES:
        cases[mesh].append({"kind": "embedding", "name": f"emb_{mesh}",
                            "seed": 3})
        cases[mesh].append({"kind": "shard_ops", "name": f"ops_{mesh}",
                            "seed": 4})
    got = {}
    for mesh, spec in MESHES.items():
        world = spec["dp"] * spec["mp"]
        got.update(worker.launch(world, spec, cases[mesh],
                                 os.path.join(tmp, mesh)))
    return {"runs": got, "one_rank_ckpt": one_dir, "saved": saved,
            "tmp": tmp}


@pytest.fixture(scope="module")
def jax_runs():
    return {name: jax_pe(net, opt, MESHES[mesh], auto, reduce)
            for name, net, opt, mesh, auto, reduce in JAX_CASES}


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", [c[0] for c in JAX_CASES])
def test_losses_and_grads_match_the_jax_parallel_executor(runs, jax_runs,
                                                          case):
    """Every rank's losses and the seeded weights' fetched gradients
    (whole, gathered over mp) match the JAX package's ParallelExecutor at
    the same mesh."""
    losses, grads, _ = jax_runs[case]
    for rank, got in enumerate(runs["runs"][case]):
        np.testing.assert_allclose(got["losses"], losses, rtol=RTOL,
                                   atol=ATOL, err_msg=f"rank {rank}")
        for g, want in grads.items():
            np.testing.assert_allclose(got[f"grad/{g}"], want, rtol=RTOL,
                                       atol=ATOL,
                                       err_msg=f"{g}@GRAD rank {rank}")


@pytest.mark.parametrize("case", [c[0] for c in JAX_CASES])
def test_state_matches_the_jax_parallel_executor(runs, jax_runs, case):
    """The full-layout state (gathered over mp, and over dp for zero1's
    rows) matches the JAX package's after the steps."""
    _, _, want = jax_runs[case]
    got = runs["runs"][case][0]
    for n, v in want.items():
        np.testing.assert_allclose(got[f"state/{n}"], v, rtol=RTOL,
                                   atol=STATE_ATOL, err_msg=n)


@pytest.mark.parametrize("case", [c[0] for c in JAX_CASES + DROPOUT_CASES])
def test_every_rank_holds_the_same_full_state(runs, case):
    """After the steps every rank's full-layout state is bitwise rank
    0's: the replicated state agrees across the mp ranks, and the
    gathered shards are one tensor."""
    ranks = runs["runs"][case]
    for got in ranks[1:]:
        for k, v in ranks[0].items():
            if k.startswith("state/"):
                np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("case", [c[0] for c in DROPOUT_CASES])
def test_dropout_nets_match_the_port_on_one_rank(runs, case):
    """The nets with dropout (VGG-16's head among them) give the one-rank
    ParallelExecutor's losses, gradients and state: every rank draws the
    whole mask from the stream the ranks share and keeps its slice."""
    net, opt = next((c[1], c[2]) for c in DROPOUT_CASES if c[0] == case)
    tmp = runs["tmp"]
    init = dict(np.load(os.path.join(tmp, f"init.{net}.{opt}.npz")))
    data = dict(np.load(os.path.join(tmp, f"data.{net}.npz")))
    losses, grads, state = port_one_rank(net, opt, init, data)
    for got in runs["runs"][case]:
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        for g, want in grads.items():
            np.testing.assert_allclose(got[f"grad/{g}"], want, rtol=1e-5,
                                       atol=1e-6, err_msg=g)
        for n, v in state.items():
            np.testing.assert_allclose(got[f"state/{n}"], v, rtol=1e-5,
                                       atol=1e-6, err_msg=n)


# ---------------------------------------------------------------------------
# the lowering
# ---------------------------------------------------------------------------
def test_each_rank_holds_its_local_shapes(runs):
    """A rank's scope holds its slice of every mp-sharded persistable:
    the column-sharded w1 [16, 32] as [16, 16], the row-sharded w2 [32, 4]
    as [16, 4], their Adam moments alike, fc1's bias [32] as [16], and the
    replicated bias of fc2 whole."""
    got = runs["runs"]["mlp_adam_off"][1]
    assert tuple(got["shape/w1"]) == (16, 16)
    assert tuple(got["shape/w2"]) == (16, 4)
    assert tuple(got["shape/w1_moment1_0"]) == (16, 16)
    assert tuple(got["shape/w2_moment2_0"]) == (16, 4)
    assert tuple(got["shape/fc_0.w_0"]) == (16,)
    assert tuple(got["shape/fc_1.w_0"]) == (4,)
    assert tuple(got["state/w1"].shape) == (16, 32)


def test_the_megatron_pair_lowers_to_local_products(runs):
    """The mlp's fc pair runs its muls on local tensors: fc2's row
    parallel product is followed by one all_reduce over mp in the
    forward, fc1's column parallel grad by one for the input's gradient
    (here none: x is a feed); relu, its grad and Adam run local; the
    softmax fc's ops are whole; nothing is gathered."""
    got = runs["runs"]["mlp_adam_off"][0]
    modes = json.loads(str(got["modes"]))
    for t in ("mul", "mul_grad", "relu", "relu_grad", "adam",
              "elementwise_add", "elementwise_add_grad"):
        assert modes[t]["generic"] == 0 and modes[t]["local"] >= 1, t
    assert "coll/all_gather" not in got
    n, nbytes = got["coll/all_reduce"]
    assert n == 1  # fc2's product
    ops = list(got["ops"])
    i = ops.index("mul", ops.index("mul") + 1)
    assert ops[i + 1] == "all_reduce"


def test_the_fused_update_runs_on_local_shards_bitwise(runs):
    """FLAGS_fuse on the lowered program: the fusion pass sees the local
    shapes (one Adam bucket of this rank's w1 [16, 16], fc1's bias [16],
    w2 [16, 4] and fc2's bias [4]: 340 elements, not the 660 of the whole
    params), and the fused update is bitwise the unfused one on every
    rank."""
    for fused, plain in zip(runs["runs"]["mlp_fuse_True"],
                            runs["runs"]["mlp_fuse_False"]):
        assert list(fused["bucket_numels"]) == [16 * 16 + 16 + 16 * 4 + 4]
        assert list(plain["bucket_numels"]) == []
        np.testing.assert_array_equal(fused["losses"], plain["losses"])
        for k, v in plain.items():
            if k.startswith("state/"):
                np.testing.assert_array_equal(fused[k], v, err_msg=k)


def test_the_fused_update_under_zero1_and_mp_is_the_unfused_one(runs):
    """dp 2 × mp 2 under Reduce with FLAGS_fuse: the zero1 members fuse
    into shard-row buckets (the gathers of mp-sharded params moving with
    their slices), bitwise the unfused run on every rank."""
    for fused, plain in zip(runs["runs"]["vgg_head_reduce_fused"],
                            runs["runs"]["vgg_head_reduce"]):
        assert len(fused["bucket_numels"]) >= 1
        np.testing.assert_array_equal(fused["losses"], plain["losses"])
        for k, v in plain.items():
            if k.startswith("state/"):
                np.testing.assert_array_equal(fused[k], v, err_msg=k)


def test_dropout_and_softmax_take_the_generic_lowering(runs):
    """dropout on mp-sharded activations gathers them, runs on the whole
    value and keeps each rank's slice of Out and Mask; its grad runs
    local."""
    got = runs["runs"]["vgg_head_auto"][0]
    modes = json.loads(str(got["modes"]))
    assert modes["dropout"]["generic"] == 1
    assert modes["dropout_grad"]["local"] == 1
    assert modes["batch_norm"]["local"] >= 1
    ops = list(got["ops"])
    assert "shard_gather" in ops and "shard_slice" in ops
    count, nbytes = got["coll/all_gather"]
    assert count >= 1 and nbytes > 0


def test_conv_and_batch_norm_run_on_the_sharded_channels(runs):
    """A Cout-sharded filter: conv2d and batch_norm run local; the
    input's gradient would be an all_reduce (here the input is a feed),
    the pool gathers the channels."""
    got = runs["runs"]["conv_momentum_auto"][0]
    modes = json.loads(str(got["modes"]))
    for t in ("conv2d", "batch_norm", "batch_norm_grad", "conv2d_grad"):
        assert modes[t]["local"] == 1 and modes[t]["generic"] == 0, t
    assert modes["pool2d"]["generic"] == 1
    assert tuple(got["shape/cw"]) == (4, 3, 3, 3)


def test_the_embedding_lowers_to_the_masked_local_gather(runs):
    """lookup_table on the row-sharded table runs as shard_lookup_table
    (a masked local gather and an all_reduce), its grad as the local
    scatter-add."""
    got = runs["runs"]["mixed_adam_auto"][0]
    ops = list(got["ops"])
    assert "shard_lookup_table" in ops and "shard_lookup_table_grad" in ops
    assert "lookup_table" not in ops


def test_autoshard_gauges_follow_auto_sharding(runs):
    """auto_sharding on sets the plan's gauges (0 unresolved vars); off,
    the port still lowers the plan but sets none."""
    on = runs["runs"]["mlp_sgd_auto"][0]
    off = runs["runs"]["mlp_adam_off"][0]
    assert float(on["gauge/autoshard_unresolved_vars"]) == 0.0
    assert float(on["gauge/autoshard_plan_sharded_vars"]) > 0
    assert "gauge/autoshard_plan_vars" not in off
    assert "digest" in off and "coll/all_reduce" in off


def test_the_plan_of_the_run_is_the_jax_packages(runs):
    """The plan ParallelExecutor built over the mixed net (dp 1 × mp 2,
    no zero1) is the one the JAX package builds over the same program."""
    got = runs["runs"]["mixed_adam_auto"][0]
    main, _, _ = worker.build(jfluid, "mixed", "adam")
    want = jautoshard.build_plan(main, MESHES["dp1mp2"]).describe()
    assert json.loads(str(got["describe"])) == json.loads(
        json.dumps(want, default=list))


def test_the_lowerings_ops_on_the_ranks(runs):
    """shard_gather, shard_slice and all_reduce over mp against numpy on
    every rank's inputs; the dp all_reduce sums over the dp ranks
    only."""
    for mesh, spec in MESHES.items():
        ranks = runs["runs"][f"ops_{mesh}"]
        for r, got in enumerate(ranks):
            dp_pos, mp_pos = divmod(r, spec["mp"])
            line = [ranks[dp_pos * spec["mp"] + m]["x"]
                    for m in range(spec["mp"])]
            np.testing.assert_array_equal(got["gather0"],
                                          np.concatenate(line, 0))
            np.testing.assert_array_equal(got["gather1"],
                                          np.concatenate(line, 1))
            np.testing.assert_array_equal(
                got["slice1"], got["x"][:, mp_pos * 2:(mp_pos + 1) * 2])
            np.testing.assert_allclose(got["all_reduce_mp"], sum(line),
                                       rtol=1e-6)
            col = [ranks[d * spec["mp"] + mp_pos]["x"]
                   for d in range(spec["dp"])]
            np.testing.assert_allclose(got["all_reduce_dp"], sum(col),
                                       rtol=1e-6)


# ---------------------------------------------------------------------------
# the sharded embedding
# ---------------------------------------------------------------------------
def _jax_embedding(seed, mp):
    import jax.numpy as jnp

    from paddle_tpu.parallel import (make_mesh, shard_table,
                                     sharded_embedding_lookup)

    rs = np.random.RandomState(seed)
    table = rs.randn(64, 16).astype(np.float32)
    ids = rs.randint(0, 64, size=(4, 7)).astype(np.int32)
    cot = rs.randn(4, 7, 16).astype(np.float32)
    mesh = make_mesh({"mp": mp}, devices=jax.devices()[:mp])
    sharded = shard_table(jnp.asarray(table), mesh, axis="mp")

    def f(tbl):
        return sharded_embedding_lookup(tbl, jnp.asarray(ids), mesh,
                                        axis="mp")

    rows, vjp = jax.vjp(f, sharded)
    grad, = vjp(jnp.asarray(cot))
    return table, ids, np.asarray(rows), np.asarray(grad)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_embedding_matches_the_jax_function(runs, mesh):
    """parallel.sharded_embedding_lookup over mp = 2: the rows are the
    JAX function's (and the dense lookup's) bitwise, and each rank's
    table gradient is its rows of the JAX function's gradient — the
    masked local scatter-add, no collective."""
    table, ids, rows, grad = _jax_embedding(3, 2)
    spec = MESHES[mesh]
    for r, got in enumerate(runs["runs"][f"emb_{mesh}"]):
        mp_pos = r % spec["mp"]
        np.testing.assert_array_equal(got["rows"], rows)
        np.testing.assert_array_equal(got["rows"], table[ids])
        np.testing.assert_array_equal(got["shard"],
                                      table[mp_pos * 32:(mp_pos + 1) * 32])
        np.testing.assert_allclose(got["shard_grad"],
                                   grad[mp_pos * 32:(mp_pos + 1) * 32],
                                   rtol=1e-6, atol=1e-6)


def test_shard_table_refuses_a_padded_vocab():
    m = tmesh.make_mesh()  # no group: mp of one
    t = torch.ones(8, 2)
    assert tfluid.parallel.shard_table(t, m) is t
    assert torch.equal(tfluid.parallel.sharded_embedding_lookup(
        t, torch.tensor([1, 7]), m), t[[1, 7]])

    class _Mesh:
        shape = {"dp": 1, "mp": 3}

        def axis(self, name):
            return None

    with pytest.raises(ValueError, match="not divisible by 3 shards"):
        tfluid.parallel.shard_table(t, _Mesh())


# ---------------------------------------------------------------------------
# checkpoints across meshes
# ---------------------------------------------------------------------------
def test_a_one_rank_checkpoint_restores_at_mp_2(runs):
    """A checkpoint a one-rank run wrote restores at dp 1 × mp 2: each
    rank keeps its slice, and the steps after it are the one-rank run's
    steps after it."""
    tmp = runs["tmp"]
    init = dict(np.load(os.path.join(tmp, "init.mlp.adam.npz")))
    data = dict(np.load(os.path.join(tmp, "data.mlp.npz")))
    main, _, loss = worker.build(tfluid, "mlp", "adam", seeds=False)
    scope = tfluid.Scope()
    convert.load_numpy_state(scope, main, init, tfluid.CPUPlace())
    CheckpointManager(runs["one_rank_ckpt"], async_write=False).restore(
        scope=scope, program=main, place=tfluid.CPUPlace())
    with tfluid.scope_guard(scope):
        pe = tfluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                     main_program=main)
        losses = [float(pe.run([loss], feed={n: v[k] for n, v in
                                             data.items()})[0][0])
                  for k in range(STEPS)]
        state = convert.numpy_state(scope, main)
    for got in runs["runs"]["restore_one_rank"]:
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        for n, v in state.items():
            np.testing.assert_allclose(got[f"state/{n}"], v, rtol=1e-5,
                                       atol=1e-7, err_msg=n)


def test_a_dp2_mp2_checkpoint_restores_on_one_rank(runs):
    """A checkpoint dp 2 × mp 2 wrote (zero1 over dp, the fc pair over
    mp) holds the canonical full layout: it restores on one rank bitwise
    the ranks' gathered state, and its manifest carries the plan."""
    want = runs["runs"]["save_dp2mp2"][0]
    main, _, _ = worker.build(tfluid, "mlp", "adam")
    for rank in range(4):
        scope = tfluid.Scope()
        man = CheckpointManager(os.path.join(runs["saved"], str(rank)),
                                async_write=False).restore(
            scope=scope, program=main, place=tfluid.CPUPlace())
        for n in main.global_block().vars:
            if f"state/{n}" in want and scope.find_var(n) is not None:
                np.testing.assert_array_equal(
                    scope.find_var(n).numpy(), want[f"state/{n}"],
                    err_msg=n)
        info = man["autoshard"]
        assert info["digest"] == str(want["digest"])
        assert info["layout"] == "full"
        assert info["mesh_axes"] == {"dp": 2, "mp": 2}
        assert info["params"]["w1"] == [None, "mp"]
        assert tuple(man["vars"]["w1"]["shape"]) == (16, 32)


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------
def _lowered(net, mesh, opt="adam"):
    main, _, _ = worker.build(tfluid, net, opt)
    plan = tautoshard.build_plan(main, mesh)
    return main, plan, tlower.lower(main, plan)


def test_lowering_writes_local_shapes_and_leaves_the_source_alone():
    main, plan, low = _lowered("mlp", {"dp": 1, "mp": 2})
    gb, lb = main.global_block(), low.program.global_block()
    assert low.program is not main
    assert gb.var("w1").shape == (16, 32) and lb.var("w1").shape == (16, 16)
    assert lb.var("w2").shape == (16, 4)
    assert lb.var("w1").sharding is None  # the desc holds the rank's
    assert low.local["w1"] == (1, (16, 32), (16, 16))
    assert low.describe()["collectives"]["all_reduce"]["count"] == 1


def test_lowering_at_one_rank_of_mp_is_the_identity():
    main, plan, low = _lowered("mlp", {"dp": 2, "mp": 1})
    assert low.program is main and not low.local and not low.collectives


def test_the_bytes_of_a_gather_are_the_plans_transition_bytes():
    """Each lowered gather moves what plan.transition_bytes says taking
    the var from its spec to the whole over mp: the reshard model's
    bytes."""
    main, plan, low = _lowered("vgg_head", {"dp": 2, "mp": 2})
    gathers = [c for c in low.collectives if c["kind"] == "all_gather"]
    assert gathers
    for c in gathers:
        spec = plan.spec_of(c["var"])
        whole = tuple(None if a == "mp" else a for a in spec)
        assert c["bytes"] == tautoshard.transition_bytes(
            plan.shapes[c["var"]], plan.dtypes[c["var"]], spec, whole,
            plan.mesh_axes) > 0


def test_lowering_refuses_other_axes_and_control_flow():
    main, _, _ = worker.build(tfluid, "mlp", "adam")
    plan = tautoshard.build_plan(main, {"dp": 1, "mp": 2, "sp": 2},
                                 extra_seeds={"w1": (None, "sp")},
                                 ignore_program_seeds=True)
    with pytest.raises(NotImplementedError, match="'sp'"):
        tlower.lower(main, plan)
    main = tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(
            main, tfluid.Program()):
        x = tfluid.layers.data(name="x", shape=[16], dtype="float32")
        i = tfluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
        limit = tfluid.layers.fill_constant(shape=[1], dtype="int64",
                                            value=3)
        cond = tfluid.layers.less_than(x=i, y=limit)
        w = tfluid.layers.While(cond=cond)
        with w.block():
            h = tfluid.layers.fc(input=x, size=16,
                                 param_attr=tfluid.ParamAttr(name="w_loop"))
            tfluid.layers.assign(h, x)
            tfluid.layers.increment(x=i, value=1, in_place=True)
            tfluid.layers.less_than(x=i, y=limit, cond=cond)
        tfluid.parallel.set_sharding(main.global_block().var("w_loop"),
                                     (None, "mp"))
    plan = tautoshard.build_plan(main, {"dp": 1, "mp": 2})
    with pytest.raises(NotImplementedError, match="sub-block"):
        tlower.lower(main, plan)


def test_the_mesh_lays_out_dp_outer_and_mp_inner():
    """Without a group a dp 1 × mp 2 mesh needs 2 ranks; MeshSpec(mp=2)
    builds the geometry {"dp": D, "mp": 2}."""
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmesh.make_mesh({"dp": 1, "mp": 2})
    spec = tmesh.MeshSpec(mp=2)
    assert spec.geometry(3) == {"dp": 3, "mp": 2}
    assert spec.fixed_size == 2 and spec.max_dp() == 0
