"""The port's data parallelism against the JAX package: the bootstrap, the
dp mesh, the sharding annotations and ParallelExecutor.

ParallelExecutor runs one process per rank. The multi-rank cases run W in
{2, 4} gloo ranks on the host (tests/torch_dp_worker.py: each a process
that imports only paddle_tpu_torch, rendezvousing through a file in the
test's tmp dir, all killed after 120 s), from the JAX package's initial
state carried over with convert.load_numpy_state, over the same 5 global
batches of 16 made by numpy from a seed. The JAX package's
ParallelExecutor runs the same program over the first W devices of the
conftest's 8-device CPU mesh. fp32 bounds: losses, parameters and
accumulators within rtol 1e-4 / atol 1e-6 of the JAX package (the two
sum over the batch in another order: each rank's partial sums, then
their sum); within rtol 1e-5 of the port's own Executor on the global
batch; bitwise where the arithmetic is the same (iters=K against K
single runs, the ranks against each other, one rank against the
Executor).

The in-process cases make a one-rank group (gloo on the host, NCCL on a
card for the tests marked `cuda`, which skip without one) and destroy it
after the test.
"""

import concurrent.futures
import os

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as jfluid
from paddle_tpu.parallel import api as japi
from paddle_tpu.parallel import distributed as jdist
from paddle_tpu.parallel import zero1 as jzero1

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.ops import collective_ops
from paddle_tpu_torch.parallel import api as tapi
from paddle_tpu_torch.parallel import distributed as tdist
from paddle_tpu_torch.parallel import mesh as tmesh
from paddle_tpu_torch.parallel import zero1 as tzero1

import torch_dp_worker as worker

STEPS = 5
BATCH = 16
RTOL, ATOL = 1e-4, 1e-6
# The batch-norm net's state is held to atol 1e-5: its velocities sum 5
# steps of gradients through the batch norm's backward, which cancels to
# ~1e-3 (and to pure rounding for the conv bias, which the normalisation
# removes), so their rounding error is absolute. The two packages' own
# Executors differ by up to 1.35e-5 on this net and these batches (fp32,
# on the CPU); their ParallelExecutors by up to 1.22e-6.
STATE_ATOL = {"conv_bn_momentum": 1e-5}
WORLDS = (2, 4)
One = jfluid.BuildStrategy.GradientScaleStrategy.One


@pytest.fixture(autouse=True)
def _fresh_port_state():
    torch.set_num_threads(2)
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    tfluid.unique_name.switch()
    tzero1.reset_registry()
    yield
    tzero1.reset_registry()


@pytest.fixture
def one_rank(tmp_path):
    """A gloo group of this process alone, destroyed after the test."""
    tdist.initialize("file://" + str(tmp_path / "rendezvous"), 1, 0)
    yield
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# the same cases on both sides
# ---------------------------------------------------------------------------
def batches(net, seed=11):
    rs = np.random.RandomState(seed)
    x = rs.rand(STEPS, BATCH, *worker.SHAPES[net]).astype(np.float32)
    y = rs.randint(0, worker.CLASSES, (STEPS, BATCH, 1)).astype(np.int64)
    return x, y


def jax_init(net, opt):
    """{name: array} of the JAX package's startup state for `net`."""
    main, startup, _, _ = worker.build(jfluid, net, opt)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    return {n: np.asarray(scope.find_var(n))
            for n, v in main.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}


def jax_pe(net, opt, world, zero1=False, gss=None, steps=STEPS):
    """The JAX package's ParallelExecutor over the first `world` devices:
    (losses, full-layout state, the last step's probs)."""
    main, startup, loss, probs = worker.build(jfluid, net, opt)
    xs, ys = batches(net)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
        bs = jfluid.BuildStrategy()
        bs.sharded_weight_update = zero1
        if gss is not None:
            bs.gradient_scale_strategy = gss
        pe = jfluid.ParallelExecutor(
            use_cuda=False, loss_name=loss.name, main_program=main,
            build_strategy=bs, devices=jax.devices()[:world])
        losses = []
        for x, y in list(zip(xs, ys))[:steps]:
            lv, pv = pe.run([loss, probs], feed={"img": x, "label": y})
            losses.append(float(np.asarray(lv).reshape(-1)[0]))
        snap = {n: np.asarray(scope.find_var(n))
                for n, v in main.global_block().vars.items()
                if v.persistable and scope.find_var(n) is not None}
    state, _ = jzero1.canonicalize_snapshot(snap)
    return np.asarray(losses, np.float32), state, np.asarray(pv)


def port_case(name, net, opt, files, **kw):
    case = {"kind": "pe", "name": name, "net": net, "opt": opt,
            "zero1": False, "fuse": False, "gss": "", "init": files[0],
            "data": files[1]}
    case.update(kw)
    return case


def write_inputs(tmp_dir, nets):
    """npz files of the JAX init state and the batches of each (net, opt):
    {(net, opt): (init path, data path)}."""
    os.makedirs(tmp_dir, exist_ok=True)
    files = {}
    for net, opt in nets:
        init = os.path.join(tmp_dir, f"init.{net}.{opt}.npz")
        data = os.path.join(tmp_dir, f"data.{net}.npz")
        np.savez(init, **jax_init(net, opt))
        x, y = batches(net)
        np.savez(data, x=x, y=y)
        files[(net, opt)] = (init, data)
    return files


def launch_worlds(cases_of, tmp_dir):
    """{world: launch results} for WORLDS, the worlds' ranks run at once."""
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futs = {w: pool.submit(worker.launch, w, cases_of(w),
                               os.path.join(tmp_dir, f"w{w}"))
                for w in WORLDS}
        return {w: f.result() for w, f in futs.items()}


def state_of(res):
    return {k[len("state/"):]: v for k, v in res.items()
            if k.startswith("state/")}


def assert_state_close(got, want, rtol=RTOL, atol=ATOL):
    assert set(got) == set(want)
    for n in sorted(want):
        np.testing.assert_allclose(got[n], want[n], rtol=rtol, atol=atol,
                                   err_msg=n)


NETS = [("mlp", "sgd"), ("conv_bn", "momentum"), ("mlp", "adam"),
        ("mlp", "momentum"), ("dropout", "sgd")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's multi-rank runs and the JAX package's, once per module."""
    tmp = str(tmp_path_factory.mktemp("dp"))
    files = write_inputs(tmp, NETS)

    def cases(world):
        return [
            port_case("mlp_sgd", "mlp", "sgd", files[("mlp", "sgd")],
                      fetch_batch=True),
            port_case("mlp_sgd_iters", "mlp", "sgd", files[("mlp", "sgd")],
                      iters=True),
            port_case("conv_bn_momentum", "conv_bn", "momentum",
                      files[("conv_bn", "momentum")], fuse=True),
            port_case("mlp_adam", "mlp", "adam", files[("mlp", "adam")]),
            port_case("mlp_momentum_one", "mlp", "momentum",
                      files[("mlp", "momentum")], gss="one"),
            port_case("dropout_sgd", "dropout", "sgd",
                      files[("dropout", "sgd")]),
        ]

    port = launch_worlds(cases, tmp)
    jax_runs = {}
    for w in WORLDS:
        for name, net, opt, gss in (
                ("mlp_sgd", "mlp", "sgd", None),
                ("conv_bn_momentum", "conv_bn", "momentum", None),
                ("mlp_adam", "mlp", "adam", None),
                ("mlp_momentum_one", "mlp", "momentum", One),
                ("mlp_momentum", "mlp", "momentum", None)):
            jax_runs[(name, w)] = jax_pe(net, opt, w, gss=gss)
    return {"port": port, "jax": jax_runs, "files": files}


# ---------------------------------------------------------------------------
# multi-rank against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["mlp_sgd", "conv_bn_momentum", "mlp_adam"])
def test_pe_matches_the_jax_parallel_executor(runs, case, world):
    """Losses, parameters and accumulators (velocities, moments, the batch
    norm's running statistics from the global batch's moments) after 5
    steps at W ranks against the JAX package's PE on W devices."""
    got = runs["port"][world][case][0]
    losses, state, _ = runs["jax"][(case, world)]
    np.testing.assert_allclose(got["losses"], losses, rtol=RTOL, atol=ATOL)
    assert_state_close(state_of(got), state, atol=STATE_ATOL.get(case, ATOL))


@pytest.mark.parametrize("world", WORLDS)
def test_gradient_scale_one_matches_jax(runs, world):
    """GradientScaleStrategy.One (sum semantics: W times the mean's
    gradient) against the JAX package's One, and away from
    CoeffNumDevice, so the scale is not dropped on both sides."""
    got = runs["port"][world]["mlp_momentum_one"][0]
    losses, state, _ = runs["jax"][("mlp_momentum_one", world)]
    np.testing.assert_allclose(got["losses"], losses, rtol=RTOL, atol=ATOL)
    assert_state_close(state_of(got), state)
    cnd, _, _ = runs["jax"][("mlp_momentum", world)]
    assert not np.allclose(got["losses"][1:], cnd[1:], rtol=1e-6, atol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_batch_leading_fetch_is_the_global_batch(runs, world):
    """A fetch whose var leads with the batch dim comes back as the global
    [B, ...], the ranks' rows in rank order, as the JAX package's does."""
    got = runs["port"][world]["mlp_sgd"][0]["probs"]
    _, _, want = runs["jax"][("mlp_sgd", world)]
    assert got.shape == want.shape == (BATCH, worker.CLASSES)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_holds_the_same_state(runs, world):
    """Replicated state stays replicated: every rank's losses and state
    are bitwise equal to rank 0's."""
    for case in ("mlp_sgd", "conv_bn_momentum", "mlp_adam"):
        ranks = runs["port"][world][case]
        for r in ranks[1:]:
            np.testing.assert_array_equal(r["losses"], ranks[0]["losses"])
            for n, v in state_of(ranks[0]).items():
                np.testing.assert_array_equal(state_of(r)[n], v, err_msg=n)


@pytest.mark.parametrize("world", WORLDS)
def test_iters_equals_single_runs_bitwise(runs, world):
    """iters=5 over the stacked global batches equals 5 single runs."""
    single = runs["port"][world]["mlp_sgd"][0]
    multi = runs["port"][world]["mlp_sgd_iters"][0]
    np.testing.assert_array_equal(multi["losses"], single["losses"])
    for n, v in state_of(single).items():
        np.testing.assert_array_equal(state_of(multi)[n], v, err_msg=n)


@pytest.mark.parametrize("world", WORLDS)
def test_pe_equals_the_executor_on_the_global_batch_with_dropout(runs, world):
    """W ranks draw the global batch's dropout mask and keep their rows:
    PE(W) equals the port's Executor over the whole batch."""
    got = runs["port"][world]["dropout_sgd"][0]
    init, data = runs["files"][("dropout", "sgd")]
    main, _, loss, _ = worker.build(tfluid, "dropout", "sgd")
    scope = tfluid.Scope()
    convert.load_numpy_state(scope, main, dict(np.load(init)),
                             tfluid.CPUPlace())
    d = np.load(data)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(scope):
        losses = [exe.run(main, feed={"img": x, "label": y},
                          fetch_list=[loss])[0].item()
                  for x, y in zip(d["x"], d["y"])]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    assert_state_close(state_of(got), convert.numpy_state(scope, main),
                       rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("world", WORLDS)
def test_one_all_reduce_per_parameter_gradient(runs, world):
    """The AllReduce path's program holds one all_reduce per parameter
    (the conv net: conv w/b, batch norm scale/bias, fc w/b)."""
    assert int(runs["port"][world]["conv_bn_momentum"][0][
        "n_all_reduce"]) == 6
    assert int(runs["port"][world]["mlp_adam"][0]["n_all_reduce"]) == 4


# ---------------------------------------------------------------------------
# one rank in this process
# ---------------------------------------------------------------------------
def _steps(pe_or_exe, main, loss, net, n=3):
    x, y = batches(net)
    if isinstance(pe_or_exe, tfluid.ParallelExecutor):
        return [pe_or_exe.run([loss], feed={"img": x[k], "label": y[k]})[0]
                for k in range(n)]
    return [pe_or_exe.run(main, feed={"img": x[k], "label": y[k]},
                          fetch_list=[loss])[0] for k in range(n)]


@pytest.mark.parametrize("net,opt", [("conv_bn", "momentum"),
                                     ("dropout", "sgd")])
def test_one_rank_equals_the_executor_bitwise(one_rank, net, opt):
    """A group of one: every collective is a one-rank sum, so PE equals
    the Executor bitwise (losses and every persistable; the fused update
    on, dropout drawn from the same stream)."""
    init = jax_init(net, opt)
    out = {}
    with tflags.flag_guard(fuse=True):
        for mode in ("exe", "pe"):
            main, _, loss, _ = worker.build(tfluid, net, opt)
            scope = tfluid.Scope()
            convert.load_numpy_state(scope, main, init, tfluid.CPUPlace())
            with tfluid.scope_guard(scope):
                if mode == "pe":
                    runner = tfluid.ParallelExecutor(
                        use_cuda=False, loss_name=loss.name, main_program=main)
                    assert runner.device_count == 1
                else:
                    runner = tfluid.Executor(tfluid.CPUPlace())
                out[mode] = (_steps(runner, main, loss, net),
                             convert.numpy_state(scope, main))
    np.testing.assert_array_equal(out["pe"][0], out["exe"][0])
    for n, v in out["exe"][1].items():
        np.testing.assert_array_equal(out["pe"][1][n], v, err_msg=n)


def test_feed_lists_and_bcast_params(one_rank):
    """A per-device feed list is the global batch concatenated; iters=K
    takes a list of K global-batch dicts as the [K, ...] stacks; after
    bcast_params every parameter holds rank 0's value."""
    x, y = batches("mlp")
    init = jax_init("mlp", "sgd")
    out = {}
    for mode in ("dict", "per_device", "iters_dict", "iters_list"):
        main, _, loss, _ = worker.build(tfluid, "mlp", "sgd")
        scope = tfluid.Scope()
        convert.load_numpy_state(scope, main, init, tfluid.CPUPlace())
        with tfluid.scope_guard(scope):
            pe = tfluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                         main_program=main)
            if mode == "dict":
                got = [pe.run([loss], feed={"img": x[k], "label": y[k]})[0]
                       for k in range(2)]
            elif mode == "per_device":
                got = [pe.run([loss], feed=[
                    {"img": x[k][:6], "label": y[k][:6]},
                    {"img": x[k][6:], "label": y[k][6:]}])[0]
                    for k in range(2)]
            elif mode == "iters_dict":
                got = pe.run([loss], feed={"img": x[:2], "label": y[:2]},
                             iters=2)[0]
            else:
                got = pe.run([loss], feed=[{"img": x[k], "label": y[k]}
                                           for k in range(2)], iters=2)[0]
            before = convert.numpy_state(scope, main)
            pe.bcast_params()
            after = convert.numpy_state(scope, main)
        for n, v in before.items():
            np.testing.assert_array_equal(after[n], v, err_msg=n)
        out[mode] = (np.asarray(got).reshape(-1), before)
    for mode in ("per_device", "iters_dict", "iters_list"):
        np.testing.assert_array_equal(out[mode][0], out["dict"][0])
        for n, v in out["dict"][1].items():
            np.testing.assert_array_equal(out[mode][1][n], v, err_msg=n)


def _mlp_pe(use_cuda=False, **kw):
    main, startup, loss, _ = worker.build(tfluid, "mlp", "sgd")
    tfluid.Executor(tfluid.CPUPlace()).run(startup)
    return tfluid.ParallelExecutor(use_cuda=use_cuda, loss_name=loss.name,
                                   main_program=main, **kw), loss


def test_indivisible_batch_raises(tmp_path):
    """The global batch must split evenly over the ranks (checked on the
    host before any step; one rank divides anything, so W=2 runs it)."""
    cases = [{"kind": "pe", "name": "odd", "net": "mlp", "opt": "sgd",
              "zero1": False, "fuse": False, "gss": "", "init": None,
              "data": None}]
    files = write_inputs(str(tmp_path), [("mlp", "sgd")])
    init, _ = files[("mlp", "sgd")]
    data = str(tmp_path / "odd.npz")
    x, y = batches("mlp")
    np.savez(data, x=x[:, :15], y=y[:, :15])
    cases[0].update(init=init, data=data)
    with pytest.raises(RuntimeError, match="global batch 15 is not "
                                           "divisible by the 2 ranks"):
        worker.launch(2, cases, str(tmp_path / "w2"))


def test_ragged_feeds_and_unported_paths_raise(one_rank, tmp_path):
    pe, loss = _mlp_pe()
    x, y = batches("mlp")
    lod = tfluid.create_lod_tensor(x[0], [[4, 12]], tfluid.CPUPlace())
    with pytest.raises(NotImplementedError, match="ragged feed"):
        pe.run([loss], feed={"img": lod, "label": y[0]})

    class Pipe:
        def next_feed(self):
            return {}

    with pytest.raises(NotImplementedError, match="DataPipe"):
        pe.run([loss], feed=Pipe())
    with tflags.flag_guard(overlap_plan=True), \
            pytest.raises(NotImplementedError, match="overlap schedule"):
        pe.run([loss], feed={"img": x[0], "label": y[0]})
    pe._build_strategy.auto_sharding = True
    with pytest.raises(NotImplementedError, match="autoshard"):
        pe.run([loss], feed={"img": x[0], "label": y[0]})
    pe._build_strategy.auto_sharding = None
    # the compile cache and the distributed compile service: a prepare
    # that misses its store asks the master, wins the single-flight
    # lease, prepares and publishes its plan (kind parallel_executor)
    from paddle_tpu_torch.cache import service
    from paddle_tpu_torch.parallel.master import MasterService

    assert pe.compile_cache_info()["l2"]["remote_hits"] == 0
    svc = MasterService()
    ep = f"127.0.0.1:{svc.serve()}"
    try:
        with tflags.flag_guard(compile_service=ep,
                               compile_cache_dir=str(tmp_path / "store")):
            pe.run([loss], feed={"img": x[0], "label": y[0]})
            info = pe.compile_cache_info()["l2"]
        stats = svc.compiled_stats()
    finally:
        service.reset()
        svc.stop()
    assert (info["remote_misses"], info["remote_hits"], info["puts"]) == \
        (1, 0, 1)
    assert (stats["leases"], stats["puts"], stats["entries"]) == (1, 1, 1)


def test_async_fetch_futures_equal_the_synchronous_fetches(one_rank):
    """run(async_fetch=True) on one rank (it raised NotImplementedError
    before the Executor's rest was ported): a FetchFuture a fetch, whose
    result() equals the synchronous run's fetch from the same state,
    bitwise, and whose value is the gathered tensor."""
    init = jax_init("mlp", "sgd")
    x, y = batches("mlp")
    got = {}
    for mode in ("sync", "async"):
        main, _, loss, probs = worker.build(tfluid, "mlp", "sgd")
        scope = tfluid.Scope()
        convert.load_numpy_state(scope, main, init, tfluid.CPUPlace())
        with tfluid.scope_guard(scope):
            pe = tfluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                         main_program=main)
            outs = [pe.run([loss, probs], feed={"img": x[k], "label": y[k]},
                           async_fetch=mode == "async") for k in range(3)]
        if mode == "async":
            futs = [f for o in outs for f in o]
            assert all(isinstance(f, tfluid.FetchFuture) and f.done()
                       for f in futs)
            assert all(isinstance(f.value, torch.Tensor) for f in futs)
            outs = [[f.result() for f in o] for o in outs]
        got[mode] = outs
    for a, s in zip(got["async"], got["sync"]):
        for u, v in zip(a, s):
            np.testing.assert_array_equal(u, v)


def test_mesh_axes_other_than_dp_raise(one_rank):
    with pytest.raises(NotImplementedError, match="item 6"):
        _mlp_pe(mesh_shape={"dp": 1, "mp": 2})
    with pytest.raises(ValueError, match="needs 2 ranks"):
        _mlp_pe(mesh_shape={"dp": 2})
    pe, _ = _mlp_pe(mesh_shape={"dp": 1, "mp": 1})
    assert pe.device_count == 1
    pe, _ = _mlp_pe(devices=[tfluid.CPUPlace()])  # one place a rank
    assert pe._exe.place == tfluid.CPUPlace()
    with pytest.raises(ValueError, match="one process drives one device"):
        _mlp_pe(devices=[tfluid.CPUPlace()] * 2)


def test_use_cuda_needs_a_card_or_an_nccl_group(one_rank):
    with pytest.raises(ValueError, match="backend is gloo"):
        _mlp_pe(use_cuda=True)


def test_use_cuda_without_a_group_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        _mlp_pe(use_cuda=True)


# ---------------------------------------------------------------------------
# bootstrap, mesh and annotations
# ---------------------------------------------------------------------------
def test_cluster_env_reads_the_jax_packages_variables():
    env = {"PADDLE_TRAINING_ROLE": "TRAINER", "PADDLE_TRAINER_ID": "3",
           "PADDLE_TRAINERS": "4", "PADDLE_COORDINATOR": "10.0.0.1:6170",
           "PADDLE_PSERVERS": "a:1,b:2", "PADDLE_CURRENT_ENDPOINT": "c:3",
           "FLAGS_selected_gpus": "1"}
    want, got = jdist.ClusterEnv(env), tdist.ClusterEnv(env)
    for k in ("training_role", "trainer_id", "num_trainers", "coordinator",
              "pserver_endpoints", "current_endpoint", "is_pserver"):
        assert getattr(got, k) == getattr(want, k), k
    assert got.selected_gpus == [1]
    assert tdist.ClusterEnv({}).selected_gpus is None


def test_initialize_makes_a_group_of_one(one_rank):
    assert tdist.is_initialized()
    assert torch.distributed.get_world_size() == 1
    tdist.initialize("file:///nonexistent", 2, 1)  # a second call: no-op
    m = tmesh.make_mesh()
    assert (m.size, m.rank, m.backend, m.shape) == (1, 0, "gloo", {"dp": 1})


def test_init_from_env_makes_the_group(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_COORDINATOR",
                       "file://" + str(tmp_path / "rendezvous"))
    monkeypatch.setenv("PADDLE_TRAINERS", "1")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.delenv("FLAGS_selected_gpus", raising=False)
    try:
        env = tdist.init_from_env()
        assert tdist.is_initialized() and env.num_trainers == 1
        assert torch.distributed.get_backend() == "gloo"
    finally:
        torch.distributed.destroy_process_group()


def test_mesh_without_a_group():
    m = tmesh.make_mesh()
    assert (m.distributed, m.size, m.rank, m.shape) == (False, 1, 0,
                                                        {"dp": 1})
    assert tmesh.mesh_geometry(m) == {"dp": 1}
    assert tmesh.mesh_geometry(None) is None
    with tmesh.mesh_scope(m) as mm:
        assert tmesh.current_mesh() is mm
    assert tmesh.current_mesh() is None
    spec = tmesh.MeshSpec(mp=1)
    assert spec.max_dp() == 1 and spec.geometry(1) == {"dp": 1, "mp": 1}
    assert spec.build(1).size == 1
    with pytest.raises(NotImplementedError):
        tmesh.MeshSpec(mp=2).build(1)
    with pytest.raises(NotImplementedError):
        tmesh.make_mesh((1, 2))
    with pytest.raises(ValueError):
        tmesh.data_parallel_mesh(2)
    with pytest.raises(ValueError, match="coordinator_address"):
        tdist.initialize(None, 1, 0)


@pytest.mark.parametrize("spec", ["mp", (None, "mp"), [("mp",), None],
                                  ("dp",)])
def test_sharding_annotations_match_the_jax_package(spec):
    assert tapi.normalize_spec(spec) == japi.normalize_spec(spec)
    outs = []
    for fluid, api in ((jfluid, japi), (tfluid, tapi)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            with api.sharding_scope(spec):
                fluid.layers.fc(input=x, size=6)
            w = main.global_block().var("fc_0.w_0")
            outs.append((api.get_sharding(w), api.get_sharding(
                main.global_block().var("fc_0.w_1"))))
            api.set_sharding(w, "dp")
            outs.append(api.get_sharding(w))
    assert outs[:2] == outs[2:]


def test_sharding_spec_errors():
    with pytest.raises(TypeError):
        tapi.normalize_spec(3)
    with pytest.raises(TypeError):
        tapi.normalize_spec([("dp", "mp")])
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
    with pytest.raises(ValueError, match="longer than"):
        tapi.set_sharding(x, (None, None, "dp"))
    with pytest.raises(TypeError):
        tapi.set_sharding("x", "dp")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def nccl_one_rank(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL runs only there")
    tdist.initialize("file://" + str(tmp_path / "rendezvous"), 1, 0,
                     local_device_ids=[0])
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = prev
    torch.distributed.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("world", WORLDS)
def test_nccl_ranks_match_the_jax_parallel_executor(tmp_path, world):
    """W ranks on W cards over NCCL (TF32 off, cuDNN deterministic), the
    captured step with its collectives inside, all-reduce and zero1 with
    the fused kernels: the same bounds against the JAX package's PE as
    the gloo ranks on the host."""
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA cards")
    files = write_inputs(str(tmp_path), [("mlp", "sgd"),
                                         ("conv_bn", "momentum"),
                                         ("mlp", "adam")])
    cases = {  # name: (net, opt, zero1)
        "mlp_sgd": ("mlp", "sgd", False),
        "conv_bn_momentum": ("conv_bn", "momentum", False),
        "conv_bn_momentum_z": ("conv_bn", "momentum", True),
        "mlp_adam_z": ("mlp", "adam", True)}
    got = worker.launch(
        world, [port_case(name, net, opt, files[(net, opt)], zero1=z,
                          fuse=True, fetch_batch=name == "mlp_sgd")
                for name, (net, opt, z) in cases.items()],
        str(tmp_path / "ranks"), timeout=600, cuda=True)
    for name, (net, opt, z) in cases.items():
        losses, state, probs = jax_pe(net, opt, world, zero1=z)
        res = got[name][0]
        np.testing.assert_allclose(res["losses"], losses, rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        atol = STATE_ATOL.get(name.removesuffix("_z"), ATOL)
        assert_state_close(state_of(res), state, atol=atol)
        if name == "mlp_sgd":
            np.testing.assert_allclose(res["probs"], probs, rtol=RTOL,
                                       atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("net,opt", [("conv_bn", "momentum"),
                                     ("dropout", "sgd")])
def test_one_rank_nccl_pe_equals_the_executor_on_the_card(nccl_one_rank,
                                                          net, opt):
    """A one-rank NCCL group on the card: PE runs its steps as one
    captured graph with the collectives inside (counted at every replay)
    and equals the Executor's captured step bitwise over 3 steps."""
    init = jax_init(net, opt)
    place = tfluid.CUDAPlace(0)
    out = {}
    with tflags.flag_guard(fuse=True):
        for mode in ("exe", "pe"):
            main, _, loss, _ = worker.build(tfluid, net, opt)
            scope = tfluid.Scope()
            convert.load_numpy_state(scope, main, init, place)
            with tfluid.scope_guard(scope):
                if mode == "pe":
                    runner = tfluid.ParallelExecutor(
                        use_cuda=True, loss_name=loss.name, main_program=main)
                    collective_ops.reset_launch_counts()
                else:
                    runner = tfluid.Executor(place)
                losses = _steps(runner, main, loss, net)
                mode_ran = (runner.step_mode() if mode == "pe"
                            else runner.step_mode(main))
                assert mode_ran == "graph"
                out[mode] = (losses, convert.numpy_state(scope, main))
                if mode == "pe":
                    assert collective_ops.launch.launches > 0
    np.testing.assert_array_equal(out["pe"][0], out["exe"][0])
    for n, v in out["exe"][1].items():
        np.testing.assert_array_equal(out["pe"][1][n], v, err_msg=n)
