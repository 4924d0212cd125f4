"""The PaddlePaddle book's semantic-role-labelling model (chapter 07,
label_semantic_roles: db_lstm with a linear-chain CRF) built with the same
layer calls in both packages, at test size, trained in both from the JAX
package's startup state.

The network is the book's: six word-id slots share the non-trainable
`emb` table beside the predicate's (`vemb`) and the mark's embeddings;
a sum of fc(tanh) layers, then `depth` dynamic_lstm layers (relu
candidate, sigmoid gate and cell, reversed on odd layers; each layer's
(hidden, cell) pair feeds the next fc, as the book passes the pair);
feature_out is a sum of two fc(labels, tanh); linear_chain_crf on `crfw`
(learning rate 1e-3), mean, and crf_decoding on `crfw`; SGD on
exponential_decay(0.01, 100000, 0.5, staircase). chunk_eval (IOB) runs on
a test program (the net cloned for test before the optimizer), through
the interpreter. Here depth 2, hidden_dim 32, vocabularies 200 / 50 / 9;
chip_smoke.py phase `loss_ops` trains it at the book's widths on the card.

Checks: both programs' desc_str() equal; 5 SGD steps with losses within
rtol 1e-4 of the JAX package's, the decoded tags equal at every step; the
test program's chunk_eval outputs equal.
"""

import math

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope

WORD_V, PRED_V, LABELS = 200, 50, 9
WORD_DIM, MARK_DIM, HIDDEN, DEPTH = 32, 5, 32, 2
BATCH, STEPS = 4, 5
WORD_SLOTS = ["word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2"]
SLOTS = WORD_SLOTS + ["verb", "mark", "target"]


@pytest.fixture(autouse=True)
def _fresh_port_state():
    torch.set_num_threads(2)
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    tfluid.unique_name.switch()
    yield


def db_lstm(fluid, word_v, pred_v, label_v, word_dim, mark_dim, hidden_dim,
            depth):
    """The book's db_lstm: (feature_out, target)."""
    L = fluid.layers
    data = {n: L.data(name=n, shape=[1], dtype="int64", lod_level=1)
            for n in SLOTS}
    pred_emb = L.embedding(data["verb"], size=[pred_v, word_dim],
                           param_attr="vemb")
    mark_emb = L.embedding(data["mark"], size=[2, mark_dim])
    embs = [L.embedding(data[n], size=[word_v, word_dim],
                        param_attr=fluid.ParamAttr(name="emb",
                                                   trainable=False))
            for n in WORD_SLOTS] + [pred_emb, mark_emb]
    hidden_0 = L.sums(input=[L.fc(input=e, size=hidden_dim, act="tanh")
                             for e in embs])
    lstm_0 = L.dynamic_lstm(input=hidden_0, size=hidden_dim,
                            candidate_activation="relu",
                            gate_activation="sigmoid",
                            cell_activation="sigmoid")
    input_tmp = [hidden_0, lstm_0]
    for i in range(1, depth):
        mix_hidden = L.sums(input=[
            L.fc(input=input_tmp[0], size=hidden_dim, act="tanh"),
            L.fc(input=input_tmp[1], size=hidden_dim, act="tanh")])
        lstm = L.dynamic_lstm(input=mix_hidden, size=hidden_dim,
                              candidate_activation="relu",
                              gate_activation="sigmoid",
                              cell_activation="sigmoid",
                              is_reverse=(i % 2) == 1)
        input_tmp = [mix_hidden, lstm]
    feature_out = L.sums(input=[
        L.fc(input=input_tmp[0], size=label_v, act="tanh"),
        L.fc(input=input_tmp[1], size=label_v, act="tanh")])
    return feature_out, data["target"]


def build(fluid, label_v=LABELS, **widths):
    """(main, test program, startup, loss, decoded tags, chunk_eval's
    outputs in the test program)."""
    widths = dict(dict(word_v=WORD_V, pred_v=PRED_V, word_dim=WORD_DIM,
                       mark_dim=MARK_DIM, hidden_dim=HIDDEN, depth=DEPTH),
                  **widths)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feature_out, target = db_lstm(fluid, label_v=label_v, **widths)
        crf_cost = fluid.layers.linear_chain_crf(
            input=feature_out, label=target,
            param_attr=fluid.ParamAttr(name="crfw", learning_rate=1e-3))
        loss = fluid.layers.mean(crf_cost)
        decode = fluid.layers.crf_decoding(
            input=feature_out, param_attr=fluid.ParamAttr(name="crfw"))
        test = main.clone(for_test=True)
        with fluid.program_guard(test, startup):
            block = test.global_block()
            chunks = fluid.layers.chunk_eval(
                input=block.var(decode.name), label=block.var(target.name),
                chunk_scheme="IOB",
                num_chunk_types=int(math.ceil((label_v - 1) / 2.0)))
        fluid.optimizer.SGD(learning_rate=fluid.layers.exponential_decay(
            learning_rate=0.01, decay_steps=100000, decay_rate=0.5,
            staircase=True)).minimize(loss)
    main.random_seed = startup.random_seed = 7
    return main, test, startup, loss, decode, chunks


def sentences(rs, n, lo, hi, word_v=WORD_V, pred_v=PRED_V, label_v=LABELS):
    """n synthetic sentences of lo..hi tokens, as dataset/conll05.py makes
    them: random words, one marked predicate, the context windows around
    it, and labels that follow the signed distance to it. {slot: [n
    arrays]}."""
    out = {s: [] for s in SLOTS}
    for _ in range(n):
        t = int(rs.randint(lo, hi + 1))
        words = rs.randint(0, word_v, t)
        pos = int(rs.randint(t))
        for s, off in zip(WORD_SLOTS[1:], (-2, -1, 0, 1, 2)):
            out[s].append(np.full(t, words[min(max(pos + off, 0), t - 1)]))
        out["word"].append(words)
        out["verb"].append(np.full(t, rs.randint(pred_v)))
        mark = np.zeros(t, np.int64)
        mark[pos] = 1
        out["mark"].append(mark)
        dist = np.arange(t) - pos
        out["target"].append((np.abs(dist) * 2 + (dist < 0)) % label_v)
    return out


def feed(fluid, batch, place):
    lengths = [len(a) for a in batch["word"]]
    return {s: fluid.create_lod_tensor(
        np.concatenate(batch[s]).astype(np.int64).reshape(-1, 1), [lengths],
        place) for s in SLOTS}


def batches(seed=3, steps=STEPS + 1):
    rs = np.random.RandomState(seed)
    return [sentences(rs, BATCH, 3, 8) for _ in range(steps)]


def _jax_run():
    main, test, startup, loss, decode, chunks = build(jfluid)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n))
                for n, v in main.global_block().vars.items()
                if v.persistable and scope.find_var(n) is not None}
        bs = batches()
        steps = [exe.run(main, feed=feed(jfluid, b, jfluid.CPUPlace()),
                         fetch_list=[loss, decode], return_numpy=False)
                 for b in bs[:STEPS]]
        ev = exe.run(test, feed=feed(jfluid, bs[STEPS], jfluid.CPUPlace()),
                     fetch_list=list(chunks))
    return init, steps, ev


def test_the_programs_are_the_jax_packages():
    for i, (j, t) in enumerate(zip(build(jfluid)[:3], build(tfluid)[:3])):
        assert t.desc_str() == j.desc_str(), ("main", "test", "startup")[i]


def test_db_lstm_trains_as_in_the_jax_package():
    init, want, want_ev = _jax_run()
    main, test, _, loss, decode, chunks = build(tfluid)
    scope = tfluid.Scope()
    convert.load_numpy_state(scope, main, init, tfluid.CPUPlace())
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        bs = batches()
        got = [exe.run(main, feed=feed(tfluid, b, tfluid.CPUPlace()),
                       fetch_list=[loss, decode]) for b in bs[:STEPS]]
        ev = exe.run(test, feed=feed(tfluid, bs[STEPS], tfluid.CPUPlace()),
                     fetch_list=list(chunks))
        assert exe.step_mode(test) == "interpreter"
    losses = [float(np.asarray(g[0]).reshape(())) for g in got]
    np.testing.assert_allclose(
        losses, [float(np.asarray(w[0]).reshape(())) for w in want],
        rtol=1e-4)
    assert all(np.isfinite(losses))
    for g, w in zip(got, want):
        tags = np.asarray(g[1])
        np.testing.assert_array_equal(tags, np.asarray(w[1]))
        assert g[1].lod() == w[1].lod()
        assert tags.min() >= 0 and tags.max() < LABELS
    for g, w in zip(ev, want_ev):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_the_recurrence_runs_one_step_per_token_of_the_batch():
    """Without max_len the LSTMs and the CRF pad to the feed's token total,
    as the JAX package's do: the loop's trip count is the batch's tokens,
    not its longest sentence."""
    main = build(tfluid)[0]
    lstms = [op for op in main.global_block().ops if op.type == "lstm"]
    assert len(lstms) == DEPTH
    assert all(op.attrs["max_len"] == -1 for op in lstms)
    assert [op.attrs["is_reverse"] for op in lstms] == [
        i % 2 == 1 for i in range(DEPTH)]
    assert {op.attrs["candidate_activation"] for op in lstms} == {"relu"}
    assert {op.attrs["cell_activation"] for op in lstms} == {"sigmoid"}


@pytest.mark.cuda
def test_captured_steps_equal_the_interpreter_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    init = _jax_run()[0]
    runs = {}
    for graph in (True, False):
        main, _, _, loss, decode, _ = build(tfluid)
        scope = tfluid.Scope()
        place = tfluid.CUDAPlace(0)
        convert.load_numpy_state(scope, main, init, place)
        with tfluid.scope_guard(scope), \
                tfluid.flags.flag_guard(cuda_graph=graph):
            exe = tfluid.Executor(place)
            b = batches(steps=1)[0]
            runs[graph] = [exe.run(main, feed=feed(tfluid, b, place),
                                   fetch_list=[loss, decode])
                           for _ in range(3)]
            assert exe.step_mode(main) == ("graph" if graph
                                           else "interpreter")
        runs[graph].append(convert.numpy_state(scope, main))
    for g, i in zip(runs[True][:3], runs[False][:3]):
        np.testing.assert_array_equal(np.asarray(g[0]), np.asarray(i[0]))
        np.testing.assert_array_equal(np.asarray(g[1]), np.asarray(i[1]))
    for n, v in runs[False][3].items():
        np.testing.assert_array_equal(runs[True][3][n], v, err_msg=n)
