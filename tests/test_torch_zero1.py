"""ZeRO-1 in the port (parallel/zero1.py) against the JAX package's, and
against the port's own all-reduce path.

The plan, the rewrite and the layout conversions are pure and are held to
the JAX package's in this process. The sharded runs take W in {2, 4}
gloo ranks (tests/torch_dp_worker.py; see tests/test_torch_parallel.py
for the harness and its bounds): each rank holds its [1, shard] row of
every accumulator where the JAX package holds the [W, shard] array
sharded over W devices, and the state gathered back to the full layout
(convert.numpy_state) is compared with the JAX package's
canonicalize_snapshot. With FLAGS_fuse the sharded updates bucket along
the shard axis (`shard_rows`), the momentum buckets through the fused
kernel's plain twin, the adam buckets in place.
"""

import os

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as jfluid
from paddle_tpu.parallel import zero1 as jzero1

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.parallel import zero1 as tzero1

import test_torch_parallel as tp
import torch_dp_worker as worker
from test_torch_parallel import _fresh_port_state  # noqa: F401

NETS = [("mlp", "sgd"), ("conv_bn", "momentum"), ("mlp", "adam"),
        ("mlp", "momentum")]
ZERO1_CASES = {  # name: (net, opt, fuse, gss)
    "mlp_sgd_z": ("mlp", "sgd", False, None),
    "conv_bn_momentum_z": ("conv_bn", "momentum", True, None),
    "mlp_adam_z": ("mlp", "adam", True, None),
    "mlp_momentum_one_z": ("mlp", "momentum", True, tp.One),
}
STATE_ATOL = {"conv_bn_momentum_z": tp.STATE_ATOL["conv_bn_momentum"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("zero1"))
    files = tp.write_inputs(tmp, NETS)

    def cases(world):
        out = [tp.port_case(name, net, opt, files[(net, opt)], zero1=True,
                            fuse=fuse, gss="one" if gss is not None else "")
               for name, (net, opt, fuse, gss) in ZERO1_CASES.items()]
        out.append(tp.port_case("mlp_adam", "mlp", "adam",
                                files[("mlp", "adam")]))
        out.append(tp.port_case("mlp_sgd_z_iters", "mlp", "sgd",
                                files[("mlp", "sgd")], zero1=True,
                                iters=True))
        out.append(tp.port_case("mlp_sgd_reduce", "mlp", "sgd",
                                files[("mlp", "sgd")], zero1=None,
                                reduce_strategy=True))
        return out

    port = tp.launch_worlds(cases, tmp)
    jax_runs = {}
    for w in tp.WORLDS:
        for name, (net, opt, _, gss) in ZERO1_CASES.items():
            jax_runs[(name, w)] = tp.jax_pe(net, opt, w, zero1=True, gss=gss)
    return {"port": port, "jax": jax_runs}


# ---------------------------------------------------------------------------
# sharded runs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", tp.WORLDS)
@pytest.mark.parametrize("case", sorted(ZERO1_CASES))
def test_zero1_matches_the_jax_zero1_parallel_executor(runs, case, world):
    got = runs["port"][world][case][0]
    losses, state, _ = runs["jax"][(case, world)]
    np.testing.assert_allclose(got["losses"], losses, rtol=tp.RTOL,
                               atol=tp.ATOL)
    tp.assert_state_close(tp.state_of(got), state,
                          atol=STATE_ATOL.get(case, tp.ATOL))


@pytest.mark.parametrize("world", tp.WORLDS)
def test_zero1_equals_the_all_reduce_path_bitwise(runs, world):
    """On gloo the reduce-scatter is the all-reduce's sum and the sharded
    updates are the same elementwise arithmetic (the fused in-place adam
    bitwise equal to the adam op), so zero1 with FLAGS_fuse equals plain
    all-reduce data parallelism bitwise."""
    z = runs["port"][world]["mlp_adam_z"][0]
    a = runs["port"][world]["mlp_adam"][0]
    np.testing.assert_array_equal(z["losses"], a["losses"])
    for n, v in tp.state_of(a).items():
        np.testing.assert_array_equal(tp.state_of(z)[n], v, err_msg=n)


@pytest.mark.parametrize("world", tp.WORLDS)
def test_zero1_holds_one_row_of_each_accumulator(runs, world):
    """Each rank keeps its [1, ceil(numel/W)] row of every accumulator —
    the W-times memory cut — while numpy_state returns the full layout;
    the gradients are reduce-scattered, none all-reduced."""
    for case in ("mlp_adam_z", "conv_bn_momentum_z"):
        for rank, got in enumerate(runs["port"][world][case]):
            state = tp.state_of(got)
            accums = [n for n in state if "_moment" in n or "_velocity" in n]
            assert accums
            for n in accums:
                shard = -(-state[n].size // world)
                assert tuple(got[f"shape/{n}"]) == (1, shard), (n, rank)
            n_params = len([n for n in state if n.endswith(("w_0", "w_1"))])
            assert int(got["n_zero1_scatter"]) == 2 * n_params
            assert int(got["n_all_reduce"]) == 0


@pytest.mark.parametrize("world", tp.WORLDS)
def test_fused_zero1_buckets_take_the_shard_rows(runs, world):
    """FLAGS_fuse buckets the [1, shard] members along the shard axis."""
    for case in ("mlp_adam_z", "conv_bn_momentum_z"):
        got = runs["port"][world][case][0]
        assert len(got["bucket_members"]) >= 1
        assert list(got["bucket_shard_rows"]) == [1] * len(
            got["bucket_members"])


@pytest.mark.parametrize("world", tp.WORLDS)
def test_reduce_strategy_is_zero1(runs, world):
    """BuildStrategy.ReduceStrategy.Reduce (sharded_weight_update left at
    None) takes the zero1 path: the same run, bitwise."""
    got = runs["port"][world]["mlp_sgd_reduce"][0]
    want = runs["port"][world]["mlp_sgd_z"][0]
    assert int(got["n_zero1_scatter"]) == int(want["n_zero1_scatter"]) > 0
    np.testing.assert_array_equal(got["losses"], want["losses"])
    for n, v in tp.state_of(want).items():
        np.testing.assert_array_equal(tp.state_of(got)[n], v, err_msg=n)


@pytest.mark.parametrize("world", tp.WORLDS)
def test_zero1_iters_equals_single_runs_bitwise(runs, world):
    single = runs["port"][world]["mlp_sgd_z"][0]
    multi = runs["port"][world]["mlp_sgd_z_iters"][0]
    np.testing.assert_array_equal(multi["losses"], single["losses"])
    for n, v in tp.state_of(single).items():
        np.testing.assert_array_equal(tp.state_of(multi)[n], v, err_msg=n)


# ---------------------------------------------------------------------------
# the plan, the rewrite and the layout, against the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("numel,parts", [(1, 1), (7, 2), (221, 8), (64, 4),
                                         (3, 4)])
def test_layout_round_trip_is_exact_and_the_jax_packages(numel, parts):
    rs = np.random.RandomState(numel)
    full = rs.randn(numel).astype(np.float32).reshape(-1, 1)
    lay = tzero1.to_shard_layout(full, parts)
    np.testing.assert_array_equal(lay, jzero1.to_shard_layout(full, parts))
    back = tzero1.from_shard_layout(lay, numel, full.shape)
    np.testing.assert_array_equal(back, full)
    for r in range(parts):
        row = tzero1._rank_row(torch.from_numpy(full), parts, r)
        np.testing.assert_array_equal(row.numpy(), lay[r:r + 1])


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("net,opt", [("mlp", "adam"),
                                     ("conv_bn", "momentum")])
def test_plan_and_bytes_match_the_jax_package(net, opt, parts):
    jmain = worker.build(jfluid, net, opt)[0]
    tmain = worker.build(tfluid, net, opt)[0]
    jplan = jzero1.build_plan(jmain, parts)
    tplan = tzero1.build_plan(tmain, parts)
    assert tplan.describe() == jplan.describe()
    assert tplan.skipped == jplan.skipped
    for sharded in (False, True):
        assert tplan.optimizer_state_bytes(sharded) == \
            jplan.optimizer_state_bytes(sharded)
        assert tplan.collective_bytes(sharded) == \
            jplan.collective_bytes(sharded)


@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_rewrite_matches_the_jax_packages_but_holds_one_row(scale):
    """The same op sequence as the JAX package's rewrite; the rank-local
    vars are [1, shard] where the JAX package's are [parts, shard]; the
    raw gradients are reduce-scattered."""
    jprog, jplan = jzero1.apply(worker.build(jfluid, "mlp", "adam")[0], 4,
                                grad_scale=scale)
    tprog, tplan = tzero1.apply(worker.build(tfluid, "mlp", "adam")[0], 4,
                                grad_scale=scale)
    jops, tops = jprog.global_block().ops, tprog.global_block().ops
    assert [op.type for op in tops] == [op.type for op in jops]
    for jop, top in zip(jops, tops):
        assert top.inputs == jop.inputs and top.outputs == jop.outputs
    for e in tplan.entries:
        for _, _, name, _ in e.accums:
            assert tprog.global_block().vars[name].shape == (1, e.shard)
            assert jprog.global_block().vars[name].shape == (4, e.shard)
    scatters = [op for op in tops if op.type == "zero1_scatter"]
    assert [op.attrs.get("reduce", False) for op in scatters] == \
        [True, False] * len(tplan.entries)
    assert {op.attrs["scale"] for op in scatters[::2]} == {scale}


def test_a_regularized_gradient_is_not_reduce_scattered():
    """An optimizer that reads a gradient transformed after the backward
    pass (L2 decay) gets a plain slice: ParallelExecutor all-reduces the
    raw gradient before the decay is added, once."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        loss = tfluid.layers.mean(tfluid.layers.fc(input=x, size=2))
        tfluid.optimizer.SGD(
            learning_rate=0.1,
            regularization=tfluid.regularizer.L2Decay(1e-3)).minimize(loss)
    prog, plan = tzero1.apply(main, 2)
    scatters = [op for op in prog.global_block().ops
                if op.type == "zero1_scatter" and op.attrs.get("scale")]
    assert scatters and not any(op.attrs["reduce"] for op in scatters)
    from paddle_tpu_torch.parallel_executor import (_optimized_params,
                                                    insert_grad_all_reduce)
    reduced = insert_grad_all_reduce(prog, _optimized_params(main), set())
    targets = [op.inputs["X"][0] for op in reduced.global_block().ops
               if op.type == "all_reduce"]
    assert sorted(targets) == ["fc_0.w_0@GRAD", "fc_0.w_1@GRAD"]


def test_canonicalize_snapshot_matches_the_jax_package():
    for mod in (jzero1, tzero1):
        mod.reset_registry()
    jzero1.apply(worker.build(jfluid, "mlp", "adam")[0], 4)
    tzero1.apply(worker.build(tfluid, "mlp", "adam")[0], 4)
    rs = np.random.RandomState(0)
    snap = {"fc_0.w_0_moment1_0": rs.randn(4, 256).astype(np.float32),
            "fc_0.w_1_moment2_0": rs.randn(4, 8).astype(np.float32),
            "fc_0.w_0": rs.randn(32, 32).astype(np.float32)}
    want, jinfo = jzero1.canonicalize_snapshot(snap)
    got, tinfo = tzero1.canonicalize_snapshot(snap)
    assert tinfo == jinfo and set(got) == set(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n])
    jzero1.reset_registry()


def test_full_layout_state_round_trips_through_the_scope():
    """A loaded full-layout accumulator becomes the rank's row at the
    next zero1 step (ensure_scope_sharded), once."""
    import torch

    main = worker.build(tfluid, "mlp", "adam")[0]
    _, plan = tzero1.apply(main, 2)
    scope = tfluid.Scope()
    e = plan.entries[0]
    name = e.accums[0][2]
    full = np.arange(e.numel, dtype=np.float32).reshape(e.shape)
    scope.var(name)
    scope.set_var(name, torch.from_numpy(full.copy()))
    plan.ensure_scope_sharded(scope)
    row = scope.find_var(name).numpy()
    np.testing.assert_array_equal(row, tzero1.to_shard_layout(full, 2)[:1])
    plan.ensure_scope_sharded(scope)  # already converted: unchanged
    np.testing.assert_array_equal(scope.find_var(name).numpy(), row)


# ---------------------------------------------------------------------------
# fluid.io under zero1: the JAX package's directory, byte for byte
# ---------------------------------------------------------------------------
# optimizer: the inputs of its run. Byte-equality needs the same bits from
# both packages' updates. With dyadic inputs (multiples of 1/8) the
# `linear` net's gradients are sums of exact products, and momentum's
# update with powers of two is exact arithmetic. XLA on the CPU computes
# rmsprop's lr*g/sqrt(ms + eps) as lr*g*rsqrt(ms + eps) with an rsqrt
# that is not correctly rounded, so its run takes rho = 0 and eps = 0
# (ms = g²) and inputs whose every column sums to a power of two: rsqrt
# of a power of four is exact. `rmsprop` on uniform inputs holds the
# same layout to the fp32 bounds of the other tests.
SAVE_CASES = {"momentum_pow2": "dyadic", "rmsprop_pow2": "pow2_columns",
              "rmsprop": "uniform"}


def _save_inputs(tmp_dir, opt):
    """The init npz (the JAX package's startup state) and 5 global
    batches of SAVE_CASES[opt]'s inputs for the `linear` net."""
    os.makedirs(tmp_dir, exist_ok=True)
    init = os.path.join(tmp_dir, f"init.linear.{opt}.npz")
    data = os.path.join(tmp_dir, f"data.linear.{opt}.npz")
    np.savez(init, **tp.jax_init("linear", opt))
    rs = np.random.RandomState(5)
    shape = (tp.STEPS, tp.BATCH, 32)
    kind = SAVE_CASES[opt]
    if kind == "dyadic":
        x = np.round(rs.rand(*shape) * 8) / 8
    elif kind == "pow2_columns":
        x = np.zeros(shape)
        for s in range(tp.STEPS):
            x[s, rs.randint(0, tp.BATCH, 32), np.arange(32)] = \
                2.0 ** -rs.randint(0, 4, 32)
    else:
        x = rs.rand(*shape)
    y = rs.randint(0, worker.CLASSES, (tp.STEPS, tp.BATCH, 1))
    np.savez(data, x=x.astype(np.float32), y=y.astype(np.int64))
    return init, data


def _jax_pe_save(opt, world, data, dirname):
    """The JAX package's zero1 ParallelExecutor over `world` devices
    through the batches of `data`, then fluid.io.save_persistables."""
    main, startup, loss, _ = worker.build(jfluid, "linear", opt)
    batches = np.load(data)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        bs = jfluid.BuildStrategy()
        bs.sharded_weight_update = True
        pe = jfluid.ParallelExecutor(
            use_cuda=False, loss_name=loss.name, main_program=main,
            build_strategy=bs, devices=jax.devices()[:world])
        for x, y in zip(batches["x"], batches["y"]):
            pe.run([loss], feed={"img": x, "label": y})
        jfluid.io.save_persistables(exe, dirname, main)


def _assert_dirs_equal(got, want, exact):
    """The same files; byte for byte when `exact`, else the same shapes
    and dtypes, values within the fp32 bounds (tests/test_torch_parallel)."""
    names = sorted(os.listdir(want))
    assert sorted(os.listdir(got)) == names
    for n in names:
        if exact:
            with open(os.path.join(got, n), "rb") as f, \
                    open(os.path.join(want, n), "rb") as g:
                assert f.read() == g.read(), n
            continue
        a, b = (np.load(os.path.join(d, n)) for d in (got, want))
        assert (a.shape, a.dtype) == (b.shape, b.dtype), n
        np.testing.assert_allclose(a, b, rtol=tp.RTOL, atol=tp.ATOL,
                                   err_msg=n)


def _save_case(tmp_path, opt, world, cuda):
    init, data = _save_inputs(str(tmp_path), opt)
    save_dir = str(tmp_path / "port")
    got = worker.launch(world, [tp.port_case(
        "save", "linear", opt, (init, data), zero1=True, save=save_dir)],
        str(tmp_path / "ranks"), timeout=600 if cuda else 120,
        cuda=cuda)["save"]
    want = str(tmp_path / "jax")
    _jax_pe_save(opt, world, data, want)
    return got, save_dir, want


def _check_save(got, save_dir, want, world, exact):
    accums = [k[len("row/"):] for k in got[0] if k.startswith("row/")]
    assert accums
    for rank in range(world):
        # every rank wrote the JAX package's files: the [W, shard] arrays
        _assert_dirs_equal(os.path.join(save_dir, str(rank)), want, exact)
        # and the load gave the rank its own row back
        for n in accums:
            row = got[rank][f"row/{n}"]
            assert row.shape[0] == 1
            np.testing.assert_array_equal(got[rank][f"loaded/{n}"], row)
            full = np.load(os.path.join(save_dir, str(rank), n + ".npy"))
            assert full.shape == (world, row.shape[1])
            np.testing.assert_array_equal(full[rank:rank + 1], row)


@pytest.mark.parametrize("opt", sorted(SAVE_CASES))
def test_zero1_save_writes_the_jax_packages_directory(tmp_path, opt):
    """save_persistables under zero1 at W = 2 gloo ranks: each
    accumulator file is the whole [W, shard] array (the rows gathered
    over the ranks), and the directory is byte-equal to the JAX PE's
    from the same program, seed and steps (SAVE_CASES says when);
    load_persistables gives each rank its row back."""
    world = 2
    got, save_dir, want = _save_case(tmp_path, opt, world, cuda=False)
    _check_save(got, save_dir, want, world, SAVE_CASES[opt] != "uniform")


@pytest.mark.cuda
@pytest.mark.parametrize("opt", sorted(SAVE_CASES))
def test_zero1_save_over_nccl_writes_the_jax_packages_directory(tmp_path,
                                                                opt):
    """The same at W = 2 ranks on two cards over NCCL."""
    world = 2
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA cards")
    got, save_dir, want = _save_case(tmp_path, opt, world, cuda=True)
    _check_save(got, save_dir, want, world, SAVE_CASES[opt] != "uniform")


def test_a_loaded_shard_layout_becomes_the_ranks_row():
    """A [W, shard] array loaded before the plan existed becomes the
    rank's row at the next zero1 step (ensure_scope_sharded)."""
    main = worker.build(tfluid, "mlp", "adam")[0]
    _, plan = tzero1.apply(main, 2)
    e = plan.entries[0]
    name = e.accums[0][2]
    rows = np.arange(2 * e.shard, dtype=np.float32).reshape(2, e.shard)
    scope = tfluid.Scope()
    scope.var(name)
    scope.set_var(name, torch.from_numpy(rows.copy()))
    plan.ensure_scope_sharded(scope)
    np.testing.assert_array_equal(scope.find_var(name).numpy(), rows[:1])
