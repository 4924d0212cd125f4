"""Beam-search translation with the port's seq2seq NMT
(models/machine_translation.py::beam_decode) against the JAX package.

- K = 1: the port's decode, token for token, against an independent
  numpy re-implementation of the attention-LSTM step run greedily (the
  JAX package's tests/test_machine_translation.py check), on weights the
  port trained itself.
- K = 2: the JAX package trains the tiny net 2 steps; its state is
  carried into the port (convert.load_numpy_state) and both packages'
  beam_decode translate the same sources: the same sentences, and the
  scores within rtol 1e-5 (fp32).
- A second call on the same shapes reuses the first call's programs, so
  the executor prepares nothing new.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core.lod_tensor import LoDTensor as JLoDTensor
from paddle_tpu.models import machine_translation as jmt

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.core.lod_tensor import LoDTensor as TLoDTensor
from paddle_tpu_torch.models import machine_translation as tmt

DICT, EMB, ENC, DEC = 20, 12, 10, 10
START, END = 0, 1
SCORE_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_port_state():
    torch.set_num_threads(2)
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    tfluid.unique_name.switch()
    yield


def _batch(LoDTensor, rs, B, max_len=6):
    toks, offs = [], [0]
    for _ in range(B):
        n = rs.randint(2, max_len)
        toks.extend(rs.randint(2, DICT, n).tolist())
        offs.append(offs[-1] + n)
    return LoDTensor(np.asarray(toks, "int64")[:, None], [offs])


def _train(fluid, mt, LoDTensor, scope, steps=2):
    """The tiny net trained `steps` Adam steps in `scope`: (main, exe)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        avg_cost, _ = mt.seq_to_seq_net(EMB, ENC, DEC, DICT, DICT)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
    main.random_seed = startup.random_seed = 3
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        rs = np.random.RandomState(0)
        for _ in range(steps):
            src = _batch(LoDTensor, rs, 4)
            trg = _batch(LoDTensor, rs, 4)
            lbl = LoDTensor(np.roll(np.asarray(trg.numpy()), -1, axis=0),
                            trg.lod())
            exe.run(main, feed={"source_sequence": src,
                                "target_sequence": trg,
                                "label_sequence": lbl},
                    fetch_list=[avg_cost])
    return main, exe


def _numpy_greedy(scope, train_prog, src, max_len):
    """An independent decoder (numpy) for the K = 1 check; the encoder
    runs through the port."""
    gb = train_prog.global_block()
    dec_op = next(op for b in train_prog.blocks for op in b.ops
                  if op.type == "attention_lstm_decoder")
    W = {s: np.asarray(scope.find_var(dec_op.input(s)[0]))
         for s in ("WAttState", "WAttScore", "WStep", "BStep", "WOut",
                   "BOut")}
    table_n = next(op for op in gb.ops if op.type == "lookup_table"
                   and op.input("Ids")[0] == "target_sequence").input("W")[0]
    table = np.asarray(scope.find_var(table_n))
    exe = tfluid.Executor(tfluid.CPUPlace())
    evec, eproj, boot = exe.run(
        train_prog.clone(for_test=True), feed={"source_sequence": src},
        fetch_list=[dec_op.input("EncoderVec")[0],
                    dec_op.input("EncoderProj")[0],
                    dec_op.input("DecoderBoot")[0]], scope=scope)
    offs = evec.last_level_offsets()
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    sents = []
    for b in range(len(offs) - 1):
        ev = np.asarray(evec.numpy())[offs[b]:offs[b + 1]]
        ej = np.asarray(eproj.numpy())[offs[b]:offs[b + 1]]
        h = np.asarray(boot)[b]
        c = np.zeros_like(h)
        tok, sent = START, []
        for _ in range(max_len):
            sp = h @ W["WAttState"]
            cat = np.concatenate(
                [ej, np.tile(sp[None, :], (ej.shape[0], 1))], axis=1)
            sc = np.tanh(cat @ W["WAttScore"])[:, 0]
            w = np.exp(sc - sc.max())
            w /= w.sum()
            gates = np.concatenate([h, w @ ev, table[tok]]) @ W["WStep"] \
                + W["BStep"][0]
            i_g, f_g, c_g, o_g = np.split(gates, 4)
            c = sig(f_g) * c + sig(i_g) * np.tanh(c_g)
            h = sig(o_g) * np.tanh(c)
            tok = int(np.argmax(h @ W["WOut"] + W["BOut"][0]))
            sent.append(tok)
            if tok == END:
                break
        sents.append(sent)
    return sents


def test_greedy_beam_decode_matches_numpy():
    scope = tfluid.Scope()
    train_prog, exe = _train(tfluid, tmt, TLoDTensor, scope)
    src = _batch(TLoDTensor, np.random.RandomState(42), 3)
    sents, scores = tmt.beam_decode(exe, train_prog, src, beam_size=1,
                                    max_len=6, start_id=START, end_id=END,
                                    scope=scope)
    want = _numpy_greedy(scope, train_prog, src, max_len=6)
    assert len(sents) == 3
    for got, exp in zip(sents, want):
        assert got == exp, (got, exp)
    assert all(np.isfinite(s) for s in scores)


def test_beam_decode_matches_the_jax_package():
    """K = 2 over 2 sources on the JAX package's trained weights."""
    jscope = jfluid.Scope()
    jmain, jexe = _train(jfluid, jmt, JLoDTensor, jscope)
    rs = np.random.RandomState(7)
    toks = _batch(JLoDTensor, rs, 2)
    with jfluid.scope_guard(jscope):
        want = jmt.beam_decode(jexe, jmain, toks, beam_size=2, max_len=5,
                               start_id=START, end_id=END, scope=jscope)
        state = {n: np.asarray(jscope.find_var(n))
                 for n, v in jmain.global_block().vars.items()
                 if v.persistable and jscope.find_var(n) is not None}
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        avg_cost, _ = tmt.seq_to_seq_net(EMB, ENC, DEC, DICT, DICT)
        tfluid.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
    main.random_seed = startup.random_seed = 3
    assert main.desc_str() == jmain.desc_str()
    scope = tfluid.Scope()
    convert.load_numpy_state(scope, main, state, tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    src = TLoDTensor(np.asarray(toks.numpy()), toks.lod())
    got = tmt.beam_decode(exe, main, src, beam_size=2, max_len=5,
                          start_id=START, end_id=END, scope=scope)
    assert len(got[0]) == 4
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=SCORE_RTOL)
    # slot 0 of each source is its best beam
    for b in range(2):
        assert got[1][2 * b] >= got[1][2 * b + 1]

    # the second call on the same shapes reuses the first call's programs
    entries = exe.compile_cache_info()["entries"]
    again = tmt.beam_decode(exe, main, src, beam_size=2, max_len=5,
                            start_id=START, end_id=END, scope=scope)
    assert again == got
    assert exe.compile_cache_info()["entries"] == entries
