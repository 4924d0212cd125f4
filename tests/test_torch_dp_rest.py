"""The rest of the port's data parallelism against the JAX package: dp x pp
through PipelineRunner(parallel_executor=), ragged feeds and DataPipe
feeds under ParallelExecutor.

Every multi-rank case runs on two gloo ranks on the host
(tests/torch_dp_worker.py; the harness and the fp32 bounds of
tests/test_torch_parallel.py: rtol 1e-4 / atol 1e-6, the batch-norm
net's state atol 1e-5).

- dp x pp: the MLP under SGD, Momentum and Adam in 2 stages x 2
  microbatches over dp 2 is held to the JAX package's PipelineRunner on
  one device over the same global microbatches (its
  `parallel_executor=` fails on the CPU mesh: ROADMAP §3 item 33, shown
  below), the batch-norm net to the port's own one-rank runner (the JAX
  package's pipeline refuses batch norm: §3 item 32); each pipelined run
  is bitwise its n_stages=1 run over the same ranks and microbatches,
  under zero1 and FLAGS_fuse too, and a batch-leading fetch comes back
  as the global microbatch.
- Ragged feeds: the stacked LSTM (vocabulary 50, width 16, max_len 12)
  and a token-level tagger whose loss is the mean over the real tokens
  of a ragged var (the ranks hold unequal token counts) with its edit
  distance, fed bucket-padded batches of 8 sequences, are held to the
  JAX package's ParallelExecutor over 2 devices: losses, fetches and
  state. iters=3 is bitwise three single runs. chunk_eval (a host op the
  JAX ParallelExecutor cannot trace) gives the one-rank Executor's
  counts.
- A DataPipe feed (chunks of 2 steps) is bitwise the same batches fed as
  dicts, and the run reports its feed_wait.
"""

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as jfluid
from paddle_tpu.parallel import pipeline as jpipe
from paddle_tpu.parallel.pipeline import PipelineRunner as JRunner

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch.core.registry import SeqTensor
from paddle_tpu_torch.parallel import pipeline as tpipe
from paddle_tpu_torch.parallel.pipeline import PipelineRunner

import test_torch_parallel as tp
import torch_dp_worker as worker
from test_torch_parallel import _fresh_port_state  # noqa: F401


@pytest.fixture(autouse=True)
def _no_active_pipeline():
    """A runner built here registers itself as the active pipeline, which
    a later checkpoint's manifest would record: clear it after each test,
    as tests/test_torch_pipeline_parallel.py does."""
    yield
    tpipe.reset_registry()
    jpipe.reset_registry()

PP_NETS = [("mlp", "sgd"), ("mlp", "momentum"), ("mlp", "adam"),
           ("conv_bn", "momentum")]
STAGES, MICRO = 2, 2
RAGGED_NETS = ("lstm", "token", "token_chunk")


def _pp_cases(files):
    cases = []
    for net, opt in PP_NETS:
        for stages in (STAGES, 1):
            for zero1 in (False, True):
                cases.append({
                    "kind": "pipeline",
                    "name": f"pp_{net}_{opt}_{stages}_{int(zero1)}",
                    "net": net, "opt": opt, "zero1": zero1, "fuse": True,
                    "init": files[(net, opt)][0],
                    "data": files[(net, opt)][1], "stages": stages,
                    "microbatches": MICRO,
                    "fetch_probs": net == "mlp" and opt == "sgd"})
    return cases


def _jax_ragged(net, data):
    """The JAX package's state and its ParallelExecutor over 2 devices on
    the ragged batches: (init state, [per-fetch arrays over the steps])."""
    main, startup, fetches = worker.build_ragged(jfluid, net)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
        init = {n: np.asarray(scope.find_var(n))
                for n, v in main.global_block().vars.items()
                if v.persistable and scope.find_var(n) is not None}
        if net == "token_chunk":
            return init, None, None
        pe = jfluid.ParallelExecutor(
            use_cuda=False, loss_name=fetches[0].name, main_program=main,
            devices=jax.devices()[:2])
        runs = [pe.run(fetches, feed=worker.ragged_feed(jfluid, net, data, k))
                for k in range(3)]
        state = {n: np.asarray(scope.find_var(n))
                 for n, v in main.global_block().vars.items()
                 if v.persistable and scope.find_var(n) is not None}
    n_dense = len(fetches) - (net != "lstm")
    outs = [np.stack([np.asarray(r[i]).reshape(-1) for r in runs])
            for i in range(n_dense)]
    if n_dense < len(fetches):
        outs.append(worker.ragged_fetch([r[n_dense] for r in runs]))
    return init, outs, state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dp_rest"))
    files = tp.write_inputs(tmp, PP_NETS)
    cases = _pp_cases(files)
    jax_ragged = {}
    for net in RAGGED_NETS:
        data = worker.ragged_batches(net)
        np.savez(f"{tmp}/ragged.{net}.npz", **data)
        init, outs, state = _jax_ragged(net, data)
        np.savez(f"{tmp}/ragged_init.{net}.npz", **init)
        jax_ragged[net] = (outs, state)
        for iters in (False, True):
            cases.append({"kind": "ragged", "name": f"ragged_{net}_{iters}",
                          "net": net, "data": f"{tmp}/ragged.{net}.npz",
                          "init": f"{tmp}/ragged_init.{net}.npz",
                          "iters": iters})
    f = files[("mlp", "momentum")]
    cases.append({"kind": "datapipe", "name": "datapipe", "net": "mlp",
                  "opt": "momentum", "init": f[0], "data": f[1],
                  "chunk": 2})
    port = worker.launch(2, cases, f"{tmp}/w2", timeout=240)
    return {"port": port, "files": files, "jax_ragged": jax_ragged,
            "tmp": tmp}


# ---------------------------------------------------------------------------
# dp x pp
# ---------------------------------------------------------------------------
def _jax_runner(net, opt):
    """The JAX package's PipelineRunner on one device over the global
    batches: (losses, state, the last step's probs fetch)."""
    main, startup, loss, probs = worker.build(jfluid, net, opt)
    xs, ys = tp.batches(net)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
        runner = JRunner(main, STAGES, loss_name=loss.name,
                         feed_names=["img", "label"], n_microbatches=MICRO,
                         fetch_names=[probs.name], scope=scope)
        reports = [runner.run({"img": x, "label": y})
                   for x, y in zip(xs, ys)]
        state = {n: np.asarray(scope.find_var(n))
                 for n, v in main.global_block().vars.items()
                 if v.persistable and scope.find_var(n) is not None}
    losses = np.concatenate([np.reshape(r["loss"], -1) for r in reports])
    return losses, state, reports[-1]["fetches"][probs.name]


def _port_runner(net, opt, files):
    """The port's PipelineRunner on one rank (the Executor, the CPU) over
    the global batches: (losses, state)."""
    main, _, loss, _ = worker.build(tfluid, net, opt)
    scope = tfluid.Scope()
    convert.load_numpy_state(scope, main, dict(np.load(files[0])),
                             tfluid.CPUPlace())
    data = np.load(files[1])
    with tfluid.scope_guard(scope):
        runner = PipelineRunner(main, STAGES, loss_name=loss.name,
                                feed_names=["img", "label"],
                                n_microbatches=MICRO, scope=scope,
                                place=tfluid.CPUPlace())
        losses = [runner.run({"img": x, "label": y})["loss"]
                  for x, y in zip(data["x"], data["y"])]
        state = convert.numpy_state(scope, main)
    return np.concatenate([np.reshape(v, -1) for v in losses]), state


@pytest.mark.parametrize("zero1", [0, 1], ids=["allreduce", "zero1"])
@pytest.mark.parametrize("net,opt", PP_NETS)
def test_dp_pp_is_bitwise_its_one_stage_run(runs, net, opt, zero1):
    for rank in range(2):
        piped = runs["port"][f"pp_{net}_{opt}_{STAGES}_{zero1}"][rank]
        one = runs["port"][f"pp_{net}_{opt}_1_{zero1}"][rank]
        np.testing.assert_array_equal(piped["losses"], one["losses"])
        for n, v in tp.state_of(one).items():
            np.testing.assert_array_equal(tp.state_of(piped)[n], v,
                                          err_msg=n)


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_dp_pp_matches_the_jax_runner(runs, opt):
    losses, state, probs = _jax_runner("mlp", opt)
    for zero1 in (0, 1):
        got = runs["port"][f"pp_mlp_{opt}_{STAGES}_{zero1}"][0]
        np.testing.assert_allclose(got["losses"], losses, rtol=tp.RTOL,
                                   atol=tp.ATOL)
        tp.assert_state_close(tp.state_of(got), state)
        if "probs" in got:
            # a batch-leading fetch: the global microbatch, every rank's
            # rows in rank order
            assert got["probs"].shape == probs.shape
            np.testing.assert_allclose(got["probs"], probs, rtol=tp.RTOL,
                                       atol=tp.ATOL)


def test_dp_pp_batch_norm_matches_the_one_rank_runner(runs):
    """Batch norm's moments are the global microbatch's over dp: the dp 2
    run is the port's one-rank runner on the global microbatches."""
    losses, state = _port_runner("conv_bn", "momentum",
                                 runs["files"][("conv_bn", "momentum")])
    for zero1 in (0, 1):
        got = runs["port"][f"pp_conv_bn_momentum_{STAGES}_{zero1}"][0]
        np.testing.assert_allclose(got["losses"], losses, rtol=tp.RTOL,
                                   atol=tp.ATOL)
        tp.assert_state_close(tp.state_of(got), state,
                              atol=tp.STATE_ATOL["conv_bn_momentum"])


def test_the_jax_runner_through_a_parallel_executor_fails():
    """§3 item 33: the JAX package's PipelineRunner(parallel_executor=)
    feeds every boundary value to a ParallelExecutor, which shards every
    feed's dim 0 over dp, a [1] one (the loss's gradient) included."""
    main, startup, loss, _ = worker.build(jfluid, "mlp", "sgd")
    xs, ys = tp.batches("mlp")
    pes = {}

    class PerCell:
        def get(self, sp):
            key = (sp.stage, sp.phase)
            if key not in pes:
                pes[key] = jfluid.ParallelExecutor(
                    use_cuda=False, main_program=sp.program,
                    devices=jax.devices()[:2])
            return pes[key]

    with jfluid.scope_guard(jfluid.Scope()):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
        runner = JRunner(main, STAGES, loss_name=loss.name,
                         feed_names=["img", "label"], n_microbatches=MICRO,
                         parallel_executor=PerCell())
        with pytest.raises(ValueError, match="divisible by 2"):
            runner.run({"img": xs[0], "label": ys[0]})


# ---------------------------------------------------------------------------
# ragged feeds
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("net", ["lstm", "token"])
def test_ragged_feeds_match_the_jax_parallel_executor(runs, net):
    outs, state = runs["jax_ragged"][net]
    ragged = outs[-1] if net != "lstm" else {}
    dense = outs[:-1] if net != "lstm" else outs
    for rank in range(2):
        got = runs["port"][f"ragged_{net}_False"][rank]
        for i, want in enumerate(dense):
            np.testing.assert_allclose(
                got[f"fetch{i}"].reshape(want.shape), want, rtol=tp.RTOL,
                atol=tp.ATOL, err_msg=f"fetch {i}")
        tp.assert_state_close(tp.state_of(got), state)
        # a ragged fetch comes back whole: every rank's sequences in rank
        # order (the argmax tags: integers, exact)
        for k, v in ragged.items():
            np.testing.assert_array_equal(got[k].reshape(v.shape), v,
                                          err_msg=k)


@pytest.mark.parametrize("net", RAGGED_NETS)
def test_ragged_iters_is_bitwise_single_runs(runs, net):
    for rank in range(2):
        one = runs["port"][f"ragged_{net}_False"][rank]
        many = runs["port"][f"ragged_{net}_True"][rank]
        np.testing.assert_array_equal(many["losses"], one["losses"])
        for k in one:
            if k.startswith(("offsets", "rows")):
                np.testing.assert_array_equal(many[k], one[k], err_msg=k)
        for n, v in tp.state_of(one).items():
            np.testing.assert_array_equal(tp.state_of(many)[n], v,
                                          err_msg=n)


def test_the_ranks_hold_unequal_token_counts():
    """The token net's case is the one the global mean is for: in every
    batch the two ranks' halves hold different token counts."""
    data = worker.ragged_batches("token")
    for k in range(3):
        lengths = data[f"lengths{k}"]
        half = len(lengths) // 2
        assert lengths[:half].sum() != lengths[half:].sum()


def test_chunk_eval_counts_are_the_global_batchs(runs):
    """chunk_eval under ParallelExecutor sums its counts over the ranks:
    the one-rank Executor's counts on the global batches; the loss and
    the edit distance's SequenceNum too."""
    tmp = runs["tmp"]
    main, _, fetches = worker.build_ragged(tfluid, "token_chunk")
    data = np.load(f"{tmp}/ragged.token_chunk.npz")
    scope = tfluid.Scope()
    convert.load_numpy_state(scope, main,
                             dict(np.load(f"{tmp}/ragged_init.token_chunk"
                                          f".npz")), tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(scope), tfluid.flags.flag_guard(fuse=True):
        ref = [exe.run(main, feed=worker.ragged_feed(tfluid, "token_chunk",
                                                      data, k),
                       fetch_list=fetches) for k in range(3)]
    got = runs["port"]["ragged_token_chunk_False"][0]
    for i in range(len(fetches) - 1):
        want = np.stack([np.asarray(r[i]).reshape(-1) for r in ref])
        if i in (0, 2):  # the loss and the mean distance: fp32 sums
            np.testing.assert_allclose(got[f"fetch{i}"].reshape(want.shape),
                                       want, rtol=1e-5)
        else:  # SequenceNum and the three chunk counts: exact
            np.testing.assert_array_equal(
                got[f"fetch{i}"].reshape(want.shape), want)
    assert np.all(got["fetch1"] == 8)  # the global batch's sequences


class _Rank:
    """A stand-in for a mesh: rank `rank` of `size`."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size


def _pe_at(rank, size):
    pe = tfluid.ParallelExecutor.__new__(tfluid.ParallelExecutor)
    pe._mesh = _Rank(rank, size)
    return pe


@pytest.mark.parametrize("as_torch", [False, True], ids=["numpy", "torch"])
def test_a_ranks_ragged_rows_keep_the_global_token_count(as_torch):
    """Rank r takes sequences [r*B/W, (r+1)*B/W) and their tokens, padded
    with zero rows to the global feed's token count (one shape a bucket);
    its host lengths ride along for the cap checks. A LoDTensor feed
    splits the same way; iters' stacked feeds step by step."""
    lengths = np.asarray([3, 1, 4, 2], np.int32)
    data = np.arange(16, dtype=np.int64).reshape(16, 1)  # 10 real + 6 pad
    seq = tfluid.create_bucketed_seq_tensor(
        [data[0:3, 0], data[3:4, 0], data[4:8, 0], data[8:10, 0]], 16)
    if not as_torch:
        seq = SeqTensor(seq.data.numpy(), seq.lengths.numpy(), lengths)
    for rank, (lo, hi) in enumerate([(0, 4), (4, 10)]):
        got = _pe_at(rank, 2)._local_feed({"w": seq}, 0)["w"]
        rows = np.asarray(got.data)
        assert rows.shape == (16, 1)
        np.testing.assert_array_equal(rows[:hi - lo, 0], np.arange(lo, hi))
        assert not rows[hi - lo:].any()
        np.testing.assert_array_equal(np.asarray(got.lengths),
                                      lengths[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(got.host_lengths,
                                      lengths[2 * rank:2 * rank + 2])
    lod = tfluid.create_lod_tensor(data[:10], [lengths.tolist()],
                                   tfluid.CPUPlace())
    got = _pe_at(1, 2)._local_feed({"w": lod}, 0)["w"]
    assert got.data.shape == (10, 1)
    np.testing.assert_array_equal(got.data[:6, 0], np.arange(4, 10))
    stacked = SeqTensor(np.stack([np.asarray(seq.data)] * 3),
                        np.stack([lengths] * 3), np.stack([lengths] * 3))
    got = _pe_at(1, 2)._local_feed({"w": stacked}, 1)["w"]
    assert got.data.shape == (3, 16, 1) and got.lengths.shape == (3, 2)
    with pytest.raises(ValueError, match="5 sequences are not divisible"):
        _pe_at(0, 2)._local_feed({"w": SeqTensor(
            data, np.ones(5, np.int32), np.ones(5, np.int32))}, 0)


# ---------------------------------------------------------------------------
# DataPipe feeds
# ---------------------------------------------------------------------------
def test_a_datapipe_feed_is_bitwise_the_same_batches_as_dicts(runs):
    for rank in range(2):
        got = runs["port"]["datapipe"][rank]
        assert got["pipe/losses"].shape == (4,)
        np.testing.assert_array_equal(got["pipe/losses"],
                                      got["dict/losses"])
        for k, v in got.items():
            if k.startswith("dict/state/"):
                np.testing.assert_array_equal(
                    got["pipe/state/" + k[len("dict/state/"):]], v,
                    err_msg=k)
        # the pull is the step's feed_wait phase, the pipe's stats ride
        # the step record
        assert float(got["pipe/feed_wait_ms"]) >= 0.0
        assert bool(got["pipe/has_datapipe_stats"])


def test_a_list_of_ragged_feeds_stacks_per_rank():
    """iters=K with a list of K ragged dicts: each dict is split alike and
    the rank's steps stack to one shape (the global bucket's token
    count)."""
    seqs = [np.arange(n) for n in (3, 1, 4, 2)]
    feeds = [{"w": tfluid.create_bucketed_seq_tensor(seqs, 16)}
             for _ in range(2)]
    local = [_pe_at(0, 2)._local_feed(f, 0) for f in feeds]
    assert all(tuple(f["w"].data.shape) == (16, 1) for f in local)
    assert isinstance(local[0]["w"].data, torch.Tensor)
