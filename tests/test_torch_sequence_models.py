"""The sequence family in the port against the JAX package, end to end:
the stacked-LSTM sentiment model and the seq2seq NMT (bi-LSTM encoder,
attention LSTM decoder), fed ragged batches through Executor.run.

- The port's network functions build the program the JAX package's
  get_model builds (the same Program.desc_str()), at full width.
- At a small size (the LSTM at vocabulary 50, width 16, max_len 12; the
  NMT at DICT 20, EMB 12, ENC/DEC 10, as tests/test_machine_translation.py)
  the JAX package's initial state is carried into the port with
  convert.load_numpy_state and the same 3 batches are fed, as LoDTensors
  or bucket-padded SeqTensors: per-step losses agree within rtol 1e-4
  (the repo's fp32 bound), the port under FLAGS_fuse=1 with Adam.
- The feed and fetch path: iters=K stacks ragged steps, and refuses what
  the JAX package refuses; a fetched ragged var is a LoDTensor; a batch
  over the decoder's cap raises on the host.
- The fetched-view repair: a view of a parameter fetched with the
  parameter, taken before its update, keeps the old value, as in the JAX
  package.
- `cuda`-marked twins (skipped without a card) hold the captured step
  bitwise equal to the interpreter.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.models import machine_translation as jmt
from paddle_tpu.models import stacked_dynamic_lstm as jsl

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.core import executor_core as tcore
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.fusion import kernels as fk
from paddle_tpu_torch.models import machine_translation as tmt
from paddle_tpu_torch.models import stacked_dynamic_lstm as tsl

STEPS = 3
LOSS_RTOL = 1e-4
# the small LSTM: vocabulary, width, loop bound
LSTM_VOCAB, LSTM_WIDTH, LSTM_MAX_LEN = 50, 16, 12
# the small NMT (tests/test_machine_translation.py's sizes)
NMT_DICT, NMT_EMB, NMT_HID = 20, 12, 10


@pytest.fixture(autouse=True)
def _fresh_port_state():
    torch.set_num_threads(2)
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    tfluid.unique_name.switch()
    fk.reset_launch_counts()
    yield


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the captured step runs only there")
    return torch.device("cuda", 0)


# ---------------------------------------------------------------------------
# the programs
# ---------------------------------------------------------------------------
def _jax_lstm_net(dict_dim, width, max_len):
    """The JAX get_model's layer calls (paddle_tpu/models/
    stacked_dynamic_lstm.py:24-41) at a given vocabulary and width."""
    fluid = jfluid
    data = fluid.layers.data(name="words", shape=[1], lod_level=1,
                             dtype="int64")
    sentence = fluid.layers.embedding(input=data, size=[dict_dim, width])
    sentence = fluid.layers.fc(input=sentence, size=width, act="tanh")
    proj = fluid.layers.fc(input=sentence, size=width * 4, bias_attr=False)
    hidden, _ = fluid.layers.dynamic_lstm(
        input=proj, size=width * 4, use_peepholes=False, max_len=max_len)
    last = fluid.layers.sequence_pool(hidden, "last")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    logit = fluid.layers.fc(input=last, size=2, act="softmax")
    loss = fluid.layers.mean(
        fluid.layers.cross_entropy(input=logit, label=label))
    fluid.layers.accuracy(input=logit, label=label)
    return loss


def _build(fluid, model, lr=1e-2, max_source_len=32, max_target_len=32):
    """(main, startup, loss) of the small `model` with Adam(lr)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        if model == "lstm":
            if fluid is jfluid:
                loss = _jax_lstm_net(LSTM_VOCAB, LSTM_WIDTH, LSTM_MAX_LEN)
            else:
                loss, _ = tsl.stacked_lstm_net(LSTM_VOCAB, LSTM_WIDTH,
                                               LSTM_WIDTH, LSTM_MAX_LEN)
        else:
            mt = jmt if fluid is jfluid else tmt
            loss, _ = mt.seq_to_seq_net(NMT_EMB, NMT_HID, NMT_HID, NMT_DICT,
                                        NMT_DICT, max_source_len,
                                        max_target_len)
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss


class _Args:
    batch_size = 4
    max_seq_len = 128
    learning_rate = 2e-4


@pytest.mark.parametrize("model", ["stacked_lstm", "nmt"])
def test_full_width_programs_match_get_model(model):
    """The JAX get_model's program and optimizer (the published widths:
    IMDB vocabulary 5148, 512-wide LSTM, max_len 128; WMT14 dictionary
    30000, 512 everywhere) against the port's network function."""
    jmain, jstart = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(jmain, jstart):
        out = (jsl if model == "stacked_lstm" else jmt).get_model(_Args())
        out[2].minimize(out[0])
    tmain, tstart = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(tmain, tstart):
        if model == "stacked_lstm":
            loss, _ = tsl.stacked_lstm_net(tsl.VOCAB_SIZE, max_len=128)
            tfluid.optimizer.Adam().minimize(loss)
        else:
            loss, _ = tmt.seq_to_seq_net(512, 512, 512, tmt.DICT_SIZE,
                                         tmt.DICT_SIZE)
            tfluid.optimizer.Adam(learning_rate=2e-4).minimize(loss)
    assert tstart.desc_str() == jstart.desc_str()
    assert tmain.desc_str() == jmain.desc_str()


@pytest.mark.parametrize("module", [tsl, tmt], ids=["stacked_lstm", "nmt"])
def test_get_model_names_the_missing_input_path(module):
    with pytest.raises(NotImplementedError, match="input-path slice"):
        module.get_model(_Args())


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------
def _batches(model, n=STEPS, batch=4, seed=3):
    """Per step {feed name: list of per-sequence id arrays, or an array}:
    review lengths 2..12 (the LSTM's max_len) and labels 0/1; source
    lengths 2..7, targets 2..7 with labels the target shifted by one."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if model == "lstm":
            out.append({
                "words": [rs.randint(0, LSTM_VOCAB, rs.randint(2, 13))
                          for _ in range(batch)],
                "label": rs.randint(0, 2, (batch, 1)).astype(np.int64)})
        else:
            src = [rs.randint(3, NMT_DICT, rs.randint(2, 8))
                   for _ in range(batch)]
            trg = [rs.randint(3, NMT_DICT, rs.randint(2, 8))
                   for _ in range(batch)]
            out.append({"source_sequence": src, "target_sequence": trg,
                        "label_sequence": [np.append(t[1:], 1) for t in trg]})
    return out


def _feed(fluid, batch, how, bucket=64):
    """A batch as feeds: ragged lists as LoDTensors ("lod") or SeqTensors
    tail-padded to a multiple of `bucket` tokens ("bucketed")."""
    feed = {}
    for name, v in batch.items():
        if not isinstance(v, list):
            feed[name] = v
        elif how == "lod":
            feed[name] = fluid.create_lod_tensor(
                np.concatenate(v).reshape(-1, 1).astype(np.int64),
                [[len(s) for s in v]], fluid.CPUPlace())
        else:
            feed[name] = fluid.create_bucketed_seq_tensor(v, bucket)
    return feed


def _persistables(program):
    return sorted(n for n, v in program.global_block().vars.items()
                  if v.persistable)


def _run_jax(model, batches, how):
    main, startup, loss = _build(jfluid, model)
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        exe.run(startup)
        scope = jfluid.global_scope()
        init = {n: np.asarray(scope.find_var(n)) for n in _persistables(main)}
        losses = [exe.run(main, feed=_feed(jfluid, b, how),
                          fetch_list=[loss])[0] for b in batches]
    return init, np.stack(losses).reshape(-1)


def _port_run(model, init, place, fuse=True):
    """(exe, main, loss, scope) of the small port model with `init` loaded
    on `place`."""
    main, _, loss = _build(tfluid, model)
    scope = tfluid.Scope()
    convert.load_numpy_state(scope, main, init, place)
    return tfluid.Executor(place), main, loss, scope


@pytest.mark.parametrize("how", ["lod", "bucketed"])
@pytest.mark.parametrize("model", ["lstm", "nmt"])
def test_training_tracks_jax(model, how):
    batches = _batches(model)
    init, jax_losses = _run_jax(model, batches, how)
    exe, main, loss, scope = _port_run(model, init, tfluid.CPUPlace())
    with tfluid.scope_guard(scope), tflags.flag_guard(fuse=True):
        losses = np.stack([exe.run(main, feed=_feed(tfluid, b, how),
                                   fetch_list=[loss])[0]
                           for b in batches]).reshape(-1)
        assert exe.step_mode(main) == "interpreter"
    plans = [p for _, p, _ in exe._prepared.values() if p is not None]
    assert "adam" in [b["opt"] for p in plans for b in p.buckets]
    assert np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL)


def test_iters_stacks_bucketed_steps_like_single_steps():
    """iters=3 over three bucketed steps of one shape runs the three steps
    the single calls run, bitwise; the fetch comes back [3, 1]."""
    batches = _batches("lstm")
    init, _ = _run_jax("lstm", batches[:1], "lod")
    out = {}
    for stacked in (False, True):
        exe, main, loss, scope = _port_run("lstm", init, tfluid.CPUPlace())
        feeds = [_feed(tfluid, b, "bucketed") for b in batches]
        with tfluid.scope_guard(scope), tflags.flag_guard(fuse=True):
            if stacked:
                out[stacked] = exe.run(main, feed=feeds, fetch_list=[loss],
                                       iters=STEPS)[0]
            else:
                out[stacked] = np.stack([exe.run(main, feed=f,
                                                 fetch_list=[loss])[0]
                                         for f in feeds])
    assert out[True].shape == (STEPS, 1)
    np.testing.assert_array_equal(out[True], out[False])


def test_iters_refuses_what_the_jax_package_refuses():
    batches = _batches("lstm")
    main, startup, loss = _build(tfluid, "lstm")
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        shapes = [_feed(tfluid, b, "bucketed", bucket=1) for b in batches]
        with pytest.raises(ValueError, match="ONE static shape per feed"):
            exe.run(main, feed=shapes, fetch_list=[loss], iters=STEPS)
        lod = _feed(tfluid, batches[0], "lod")
        with pytest.raises(ValueError, match="pre-stacked LoDTensor"):
            exe.run(main, feed=lod, fetch_list=[loss], iters=STEPS)
        mixed = [_feed(tfluid, b, "bucketed") for b in batches]
        mixed[1]["words"] = np.zeros((64, 1), np.int64)
        with pytest.raises(ValueError, match="mixes ragged and dense"):
            exe.run(main, feed=mixed, fetch_list=[loss], iters=STEPS)


def test_a_fetched_ragged_var_is_a_lod_tensor():
    """The LSTM's hidden states fetched from a bucket-padded batch: a
    LoDTensor with the batch's offsets, whose real rows equal the JAX
    package's."""
    batch = _batches("lstm", n=1)[0]
    init, _ = _run_jax("lstm", [batch], "bucketed")
    fetched = {}
    for fluid in (jfluid, tfluid):
        main, startup, loss = _build(fluid, "lstm")
        hidden = next(op for op in main.global_block().ops
                      if op.type == "lstm").output("Hidden")[0]
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        if fluid is jfluid:
            with fluid.scope_guard(scope):
                exe.run(startup)
                for n, a in init.items():
                    scope.set_var(n, a)
        else:
            convert.load_numpy_state(scope, main, init, fluid.CPUPlace())
        with fluid.scope_guard(scope):
            fetched[fluid] = exe.run(main, feed=_feed(fluid, batch,
                                                      "bucketed"),
                                     fetch_list=[hidden])[0]
    got, want = fetched[tfluid], fetched[jfluid]
    assert isinstance(got, tfluid.LoDTensor)
    lens = [len(s) for s in batch["words"]]
    assert got.lod() == want.lod() == [list(np.cumsum([0] + lens))]
    n = sum(lens)
    np.testing.assert_allclose(got.numpy()[:n], np.asarray(want.numpy())[:n],
                               rtol=LOSS_RTOL, atol=1e-6)


def test_a_batch_over_the_decoder_cap_raises_at_the_feed():
    """A target sequence of 8 tokens against max_target_len 7 (the other
    targets are 2..7 long): the port reads the fed lengths on the host
    and raises the JAX package's ValueError; the captured step's replays
    check the recorded caps (executor_core.check_caps) the same way."""
    batch = _batches("nmt", n=1)[0]
    batch["target_sequence"][0] = np.arange(3, 11)
    batch["label_sequence"][0] = np.append(np.arange(4, 11), 1)
    main, startup, loss = _build(tfluid, "nmt", max_target_len=7)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        for how in ("lod", "bucketed"):
            with pytest.raises(ValueError, match="target sequence of length "
                                                 "8 exceeds static cap 7"):
                exe.run(main, feed=_feed(tfluid, batch, how),
                        fetch_list=[loss])
    seq = treg.SeqTensor(torch.zeros(8, 1), torch.tensor([6, 2], dtype=torch.int32),
                         np.array([6, 2], np.int32))
    caps = {("t", 5, "target", "attention_lstm_decoder")}
    with pytest.raises(ValueError, match="exceeds static cap 5"):
        tcore.check_caps(caps, {"t": seq})
    tcore.check_caps({("t", 6, "target", "attention_lstm_decoder")},
                     {"t": seq})


# ---------------------------------------------------------------------------
# the fetched-view repair
# ---------------------------------------------------------------------------
def _view_program(fluid):
    """A small Adam MLP that fetches its first weight and a reshape of it
    (a torch view), the reshape taken before the update."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[8], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        hidden = fluid.layers.fc(input=img, size=6, act="relu")
        probs = fluid.layers.fc(input=hidden, size=3, act="softmax")
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=probs, label=label))
        w = main.global_block().all_parameters()[0]
        view = fluid.layers.reshape(w, [-1])
        fluid.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return main, startup, w, view


def _view_batch():
    rs = np.random.RandomState(4)
    return {"img": rs.rand(4, 8).astype(np.float32),
            "label": rs.randint(0, 3, (4, 1)).astype(np.int64)}


def _jax_view_fetch():
    main, startup, w, view = _view_program(jfluid)
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        exe.run(startup)
        scope = jfluid.global_scope()
        init = {n: np.asarray(scope.find_var(n)) for n in _persistables(main)}
        got = exe.run(main, feed=_view_batch(), fetch_list=[view, w])
    return init, w.name, got


def _port_view_fetch(init, place, graph):
    main, _, w, view = _view_program(tfluid)
    scope = tfluid.Scope()
    convert.load_numpy_state(scope, main, init, place)
    exe = tfluid.Executor(place)
    with tfluid.scope_guard(scope), \
            tflags.flag_guard(fuse=True, cuda_graph=graph):
        # the third step is the captured graph's first replay on a card
        for _ in range(3):
            got = exe.run(main, feed=_view_batch(), fetch_list=[view, w])
        assert exe.step_mode(main) == ("graph" if graph else "interpreter")
    return got


def test_a_view_fetched_before_its_update_keeps_the_old_value():
    """One step of fused Adam (in place) fetching reshape(w) and w: the
    view shows w before the step, w itself after it, as in the JAX
    package. Before the repair the port's view showed the updated w."""
    init, w_name, (jview, jw) = _jax_view_fetch()
    main, _, w, view = _view_program(tfluid)
    scope = tfluid.Scope()
    convert.load_numpy_state(scope, main, init, tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(scope), tflags.flag_guard(fuse=True):
        tview, tw = exe.run(main, feed=_view_batch(), fetch_list=[view, w])
    np.testing.assert_array_equal(jview, init[w_name].reshape(-1))
    np.testing.assert_array_equal(tview, init[w_name].reshape(-1))
    assert not np.array_equal(tw, init[w_name])
    np.testing.assert_allclose(tw, jw, rtol=LOSS_RTOL)


@pytest.mark.cuda
def test_a_view_fetched_before_its_update_on_the_captured_step(cuda_device):
    init, w_name, _ = _jax_view_fetch()
    place = tfluid.CUDAPlace(cuda_device.index)
    graph = _port_view_fetch(init, place, graph=True)
    interp = _port_view_fetch(init, place, graph=False)
    np.testing.assert_array_equal(graph[0], interp[0])
    np.testing.assert_array_equal(graph[1], interp[1])
    # step 3 fetched the view before its update: step 2's w, not step 3's
    assert not np.array_equal(graph[0], graph[1].reshape(-1))


# ---------------------------------------------------------------------------
# on a card: the captured step against the interpreter
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("model", ["lstm", "nmt"])
def test_graph_and_interpreter_are_bitwise_equal(cuda_device, model):
    batches = _batches(model)
    init, _ = _run_jax(model, batches[:1], "lod")
    place = tfluid.CUDAPlace(cuda_device.index)
    runs = {}
    for graph in (False, True):
        fk.reset_launch_counts()
        exe, main, loss, scope = _port_run(model, init, place)
        with tfluid.scope_guard(scope), \
                tflags.flag_guard(fuse=True, cuda_graph=graph):
            losses = [exe.run(main, feed=_feed(tfluid, b, "bucketed"),
                              fetch_list=[loss])[0] for b in batches]
            assert exe.step_mode(main) == ("graph" if graph
                                           else "interpreter")
        torch.cuda.synchronize()
        assert fk.adam_bucket.launches >= STEPS
        runs[graph] = (np.stack(losses), convert.numpy_state(scope, main))
    np.testing.assert_array_equal(runs[True][0], runs[False][0])
    for n, a in runs[False][1].items():
        np.testing.assert_array_equal(runs[True][1][n], a, err_msg=n)
