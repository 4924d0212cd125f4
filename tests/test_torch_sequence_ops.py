"""Op-level parity of the sequence family: each kernel of the port's
sequence slice against the JAX package's kernel, forward and gradient.

The same numpy inputs (np.random.RandomState) go through both kernels on
the CPU. A ragged input is a SeqTensor in each package (flat data and
int32 lengths), unpadded or bucket-padded (tail rows past sum(lengths),
as create_bucketed_seq_tensor makes them). Gradients come from each side's
`<op>_grad` kernel (jax.vjp there, torch.autograd here; lookup_table's is
explicit on both sides) with the same random cotangents.

Tolerance: the repo's fp32 bound, rtol 1e-4, with atol 1e-6 for the
forward and 1e-5 for gradients (values near zero, summed in other
orders); every comparison below uses FWD or GRAD.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core import executor_core as jcore
from paddle_tpu.core import registry as jreg

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import executor_core as tcore
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core import scope as tscope

FWD = dict(rtol=1e-4, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _fresh_port_state():
    torch.set_num_threads(2)
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    tfluid.unique_name.switch()
    yield


class Seq:
    """A ragged test input: numpy data [N, ...] and lengths [B]."""

    def __init__(self, data, lengths):
        self.data = data
        self.lengths = np.asarray(lengths, np.int32)


def _seq(rs, lengths, *feature, pad=0, ids=None):
    """A Seq of random f32 rows (or int ids below `ids`) for `lengths`,
    with `pad` padding rows after the real ones."""
    n = int(np.sum(lengths)) + pad
    if ids is not None:
        data = rs.randint(0, ids, (n,) + feature).astype(np.int64)
    else:
        data = rs.randn(n, *feature).astype(np.float32)
    return Seq(data, lengths)


def _to_jax(v):
    if isinstance(v, Seq):
        return jreg.SeqTensor(jnp.asarray(v.data), jnp.asarray(v.lengths))
    return None if v is None else jnp.asarray(v)


def _to_port(v):
    if isinstance(v, Seq):
        return treg.SeqTensor(torch.from_numpy(np.array(v.data)),
                              torch.from_numpy(np.array(v.lengths)))
    return None if v is None else torch.from_numpy(np.array(v))


def _from(v):
    """An output as (data, lengths or None) in numpy."""
    if isinstance(v, (jreg.SeqTensor, treg.SeqTensor)):
        return np.asarray(v.data), np.asarray(v.lengths)
    return (None if v is None else np.asarray(v)), None


def _run_jax(op_type, ins, attrs):
    outs = jreg.run_kernel(jreg.lookup(op_type), jcore.OpContext(),
                           {s: [_to_jax(v) for v in vs]
                            for s, vs in ins.items()}, dict(attrs))
    return {s: [_from(v) for v in vs] for s, vs in outs.items()}


def _run_port(op_type, ins, attrs):
    outs = treg.run_kernel(treg.lookup(op_type),
                           tcore.OpContext(tfluid.CPUPlace()),
                           {s: [_to_port(v) for v in vs]
                            for s, vs in ins.items()}, dict(attrs))
    return {s: [_from(v) for v in vs] for s, vs in outs.items()}


def _same(port, jax_, tol, what):
    (t, tl), (j, jl) = port, jax_
    if jl is not None:
        assert tl is not None, f"{what}: the port lost the lengths"
        np.testing.assert_array_equal(tl, jl, err_msg=what)
    if t is not None and j is not None:
        assert t.shape == j.shape, (what, t.shape, j.shape)
        np.testing.assert_allclose(t, j.astype(t.dtype), err_msg=what, **tol)


def _compare(op_type, ins, attrs, grad_slots=(), seed=0):
    """Forward outputs, then the `<op>_grad` kernel's input gradients for
    random cotangents of the outputs in `grad_slots` (ragged where the
    output is)."""
    jo, to = _run_jax(op_type, ins, attrs), _run_port(op_type, ins, attrs)
    for slot, vals in jo.items():
        for i, (j, t) in enumerate(zip(vals, to.get(slot, []))):
            _same(t, j, FWD, f"{op_type} {slot}[{i}]")
    if not grad_slots:
        return jo, to
    rs = np.random.RandomState(seed + 1)
    gins = dict(ins)
    for slot in grad_slots:
        gins[f"{slot}@GRAD"] = [
            Seq(rs.randn(*d.shape).astype(np.float32), lens)
            if lens is not None else rs.randn(*d.shape).astype(np.float32)
            for d, lens in jo[slot]]
    jg = _run_jax(op_type + "_grad", gins, attrs)
    tg = _run_port(op_type + "_grad", gins, attrs)

    def filled(outs):  # int inputs get no gradient on either side
        return {s for s, vs in outs.items()
                if any(d is not None for d, _ in vs)}

    assert filled(tg) == filled(jg), (filled(tg), filled(jg))
    for slot in filled(jg):
        for i, (j, t) in enumerate(zip(jg[slot], tg[slot])):
            _same(t, j, GRAD, f"{op_type}_grad {slot}[{i}]")
    return jo, to


LENGTHS = [3, 1, 5, 2]
# padding rows after the real ones: none, or a bucket's tail
PAD = dict(argnames="pad", argvalues=[0, 4],
           ids=["unpadded", "bucket_padded"])


# ---------------------------------------------------------------------------
# SeqTensor and mean (the LoD-aware repair)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(**PAD)
def test_seq_tensor_offsets_segments_and_mask(pad):
    x = _seq(np.random.RandomState(0), [3, 0, 4, 2], 2, pad=pad)
    j, t = _to_jax(x), _to_port(x)
    for name in ("offsets", "segment_ids", "token_mask"):
        got, want = getattr(t, name)(), np.asarray(getattr(j, name)())
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        if name != "token_mask":
            assert got.dtype == torch.int32, (name, got.dtype)


@pytest.mark.parametrize(**PAD)
def test_mean_counts_only_the_real_tokens(pad):
    """The port's `mean` over a bucket-padded SeqTensor averages its real
    tokens, as the JAX package's does; the padding rows (set far from the
    real ones here) do not count, so a mean over every row differs."""
    x = _seq(np.random.RandomState(1), LENGTHS, 3, pad=pad)
    x.data[sum(LENGTHS):] = 100.0
    jo, to = _compare("mean", {"X": [x]}, {}, grad_slots=("Out",))
    real = x.data[:sum(LENGTHS)].mean()
    np.testing.assert_allclose(to["Out"][0][0], [real], **FWD)
    if pad:
        assert abs(x.data.mean() - real) > 1.0


# ---------------------------------------------------------------------------
# lookup_table, concat, reshape
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("padding_idx", [-1, 3], ids=["no_pad", "pad_idx_3"])
@pytest.mark.parametrize("ids", ["dense", "ragged", "ragged_bucket_padded"])
def test_lookup_table(ids, padding_idx):
    """Ids drawn from 6 rows of a [6, 4] table, so rows repeat and the
    gradient adds several rows into one."""
    rs = np.random.RandomState(2)
    w = rs.randn(6, 4).astype(np.float32)
    if ids == "dense":
        x = rs.randint(0, 6, (9, 1)).astype(np.int64)
    else:
        x = _seq(rs, LENGTHS, 1, pad=3 if ids.endswith("padded") else 0,
                 ids=6)
    (x if ids == "dense" else x.data)[:2] = 3  # id 3 twice
    jo, to = _compare("lookup_table", {"W": [w], "Ids": [x]},
                      {"padding_idx": padding_idx, "is_sparse": False},
                      grad_slots=("Out",))
    flat = (x if ids == "dense" else x.data).reshape(-1)
    if padding_idx >= 0:
        assert not to["Out"][0][0][flat == padding_idx].any()


def test_lookup_table_grad_sparse_is_the_jax_packages():
    """The sparse gradient, which the port once refused (ROADMAP queue 1
    item 8), is now the JAX package's: a SelectedRows of the ids and the
    rows of Out@GRAD (a padding id's row zeroed), of W's height; its
    dense form is the dense gradient."""
    rs = np.random.RandomState(3)
    ins = {"W": [rs.randn(6, 4).astype(np.float32)],
           "Ids": [rs.randint(0, 6, (5, 1)).astype(np.int64)],
           "Out@GRAD": [rs.randn(5, 4).astype(np.float32)]}
    attrs = {"is_sparse": True, "padding_idx": int(ins["Ids"][0][1, 0])}
    j = jreg.run_kernel(jreg.lookup("lookup_table_grad"), jcore.OpContext(),
                        {s: [_to_jax(v) for v in vs]
                         for s, vs in ins.items()}, dict(attrs))["W@GRAD"][0]
    t = treg.run_kernel(treg.lookup("lookup_table_grad"),
                        tcore.OpContext(tfluid.CPUPlace()),
                        {s: [_to_port(v) for v in vs]
                         for s, vs in ins.items()}, dict(attrs))["W@GRAD"][0]
    assert t.height == j.height == 6
    np.testing.assert_array_equal(t.rows.numpy(), np.asarray(j.rows))
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    np.testing.assert_array_equal(t.to_dense().numpy(),
                                  np.asarray(j.to_dense()))


@pytest.mark.parametrize("axis", [0, 1])
def test_concat(axis):
    rs = np.random.RandomState(4)
    xs = [rs.randn(4, 3).astype(np.float32), rs.randn(4, 3).astype(np.float32)]
    _compare("concat", {"X": xs}, {"axis": axis}, grad_slots=("Out",))


def test_concat_keeps_the_lengths_of_ragged_inputs():
    rs = np.random.RandomState(5)
    xs = [_seq(rs, LENGTHS, 3, pad=2), _seq(rs, LENGTHS, 2, pad=2)]
    _compare("concat", {"X": xs}, {"axis": 1}, grad_slots=("Out",))


def test_reshape_copies_a_zero_dim_and_is_a_view():
    x = np.random.RandomState(6).randn(2, 3, 4).astype(np.float32)
    _compare("reshape", {"X": [x]}, {"shape": [0, -1]},
             grad_slots=("Out",))
    t = torch.from_numpy(x)
    o = treg.run_kernel(treg.lookup("reshape"),
                        tcore.OpContext(tfluid.CPUPlace()), {"X": [t]},
                        {"shape": [6, 4]})["Out"][0]
    assert o.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()


# ---------------------------------------------------------------------------
# sequence ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(**PAD)
@pytest.mark.parametrize("pooltype",
                         ["AVERAGE", "SUM", "SQRT", "MAX", "FIRST", "LAST"])
def test_sequence_pool(pooltype, pad):
    x = _seq(np.random.RandomState(7), [3, 0, 5, 2], 4, pad=pad)
    _compare("sequence_pool", {"X": [x]}, {"pooltype": pooltype},
             grad_slots=("Out",))


@pytest.mark.parametrize(**PAD)
def test_sequence_softmax(pad):
    x = _seq(np.random.RandomState(8), LENGTHS, 1, pad=pad)
    _compare("sequence_softmax", {"X": [x]}, {}, grad_slots=("Out",))


def test_sequence_expand():
    rs = np.random.RandomState(9)
    x = rs.randn(4, 3).astype(np.float32)
    y = _seq(rs, LENGTHS, 2, pad=2)
    _compare("sequence_expand", {"X": [x], "Y": [y]}, {},
             grad_slots=("Out",))


@pytest.mark.parametrize("axis", [0, 1])
def test_sequence_concat(axis):
    rs = np.random.RandomState(10)
    lens = ([LENGTHS] * 3 if axis == 1
            else [LENGTHS, [1, 2, 0, 3], [2, 2, 1, 1]])
    xs = [_seq(rs, n, 3) for n in lens]
    _compare("sequence_concat", {"X": xs}, {"axis": axis},
             grad_slots=("Out",))


@pytest.mark.parametrize(**PAD)
def test_sequence_conv(pad):
    rs = np.random.RandomState(11)
    x = _seq(rs, LENGTHS, 3, pad=pad)
    w = (rs.randn(9, 5) * 0.3).astype(np.float32)
    _compare("sequence_conv", {"X": [x], "Filter": [w]},
             {"contextLength": 3, "contextStart": -1},
             grad_slots=("Out",))


def test_sequence_reshape():
    x = _seq(np.random.RandomState(12), [2, 4, 2], 6)
    _compare("sequence_reshape", {"X": [x]}, {"new_dim": 3},
             grad_slots=("Out",))


def test_sequence_slice():
    rs = np.random.RandomState(13)
    x = _seq(rs, LENGTHS, 2, pad=2)
    offset = np.array([[1], [0], [2], [0]], np.int64)
    length = np.array([[2], [1], [3], [1]], np.int64)
    _compare("sequence_slice",
             {"X": [x], "Offset": [offset], "Length": [length]}, {},
             grad_slots=("Out",))


@pytest.mark.parametrize(**PAD)
def test_sequence_erase(pad):
    x = _seq(np.random.RandomState(14), LENGTHS, 1, pad=pad, ids=5)
    _compare("sequence_erase", {"X": [x]}, {"tokens": [1, 3]})


@pytest.mark.parametrize("padded_length", [-1, 4, 7])
def test_sequence_pad_and_unpad(padded_length):
    """Padding past a sequence's end is zero; a padded_length shorter than
    a sequence cuts it; unpad gathers the rows back."""
    rs = np.random.RandomState(15)
    x = _seq(rs, LENGTHS, 2, pad=3)
    jo, _ = _compare("sequence_pad", {"X": [x]},
                     {"padded_length": padded_length}, grad_slots=("Out",))
    padded = jo["Out"][0][0]
    _compare("sequence_unpad", {"X": [padded], "Length": [x.lengths]},
             {"ntokens": x.data.shape[0]}, grad_slots=("Out",))


# ---------------------------------------------------------------------------
# RNN ops
# ---------------------------------------------------------------------------
def _lstm_ins(rs, d, peep, pad, lengths=LENGTHS):
    return {"Input": [_seq(rs, lengths, 4 * d, pad=pad)],
            "Weight": [(rs.randn(d, 4 * d) * 0.4).astype(np.float32)],
            "Bias": [(rs.randn(1, (7 if peep else 4) * d) * 0.2)
                     .astype(np.float32)]}


@pytest.mark.parametrize("max_len", [-1, 5, 3], ids=["no_cap", "cap_5",
                                                     "cap_3_cuts"])
@pytest.mark.parametrize(**PAD)
@pytest.mark.parametrize("peep", [False, True], ids=["plain", "peepholes"])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward",
                                                        "reverse"])
def test_lstm(reverse, peep, pad, max_len):
    """dynamic_lstm: every sequence ends its own recurrence (lengths 3, 1,
    5, 2); a max_len of 3 cuts the 5-long one, in both packages alike."""
    ins = _lstm_ins(np.random.RandomState(16), 3, peep, pad)
    _compare("lstm", ins, {"use_peepholes": peep, "is_reverse": reverse,
                           "max_len": max_len},
             grad_slots=("Hidden", "Cell"))


def test_lstm_on_a_dense_batch_with_initial_state():
    rs = np.random.RandomState(17)
    d = 3
    ins = {"Input": [rs.randn(2, 4, 4 * d).astype(np.float32)],
           "Weight": [(rs.randn(d, 4 * d) * 0.4).astype(np.float32)],
           "Bias": [(rs.randn(1, 4 * d) * 0.2).astype(np.float32)],
           "H0": [rs.randn(2, d).astype(np.float32)],
           "C0": [rs.randn(2, d).astype(np.float32)]}
    _compare("lstm", ins, {"use_peepholes": False},
             grad_slots=("Hidden",))


@pytest.mark.parametrize(**PAD)
@pytest.mark.parametrize("reverse", [False, True], ids=["forward",
                                                        "reverse"])
def test_gru(reverse, pad):
    rs = np.random.RandomState(18)
    d = 3
    ins = {"Input": [_seq(rs, LENGTHS, 3 * d, pad=pad)],
           "Weight": [(rs.randn(d, 3 * d) * 0.4).astype(np.float32)],
           "Bias": [(rs.randn(1, 3 * d) * 0.2).astype(np.float32)]}
    _compare("gru", ins, {"is_reverse": reverse}, grad_slots=("Hidden",))


def test_lstm_unit():
    rs = np.random.RandomState(19)
    ins = {"X": [rs.randn(3, 8).astype(np.float32)],
           "C_prev": [rs.randn(3, 2).astype(np.float32)]}
    _compare("lstm_unit", ins, {"forget_bias": 0.5},
             grad_slots=("C", "H"))


@pytest.mark.parametrize("acts", [{}, {"gate_activation": 2,
                                       "activation": 3}],
                         ids=["default", "enum_tanh_relu"])
def test_gru_unit(acts):
    rs = np.random.RandomState(20)
    d = 3
    ins = {"Input": [rs.randn(2, 3 * d).astype(np.float32)],
           "HiddenPrev": [rs.randn(2, d).astype(np.float32)],
           "Weight": [(rs.randn(d, 3 * d) * 0.4).astype(np.float32)],
           "Bias": [(rs.randn(1, 3 * d) * 0.2).astype(np.float32)]}
    _compare("gru_unit", ins, acts, grad_slots=("Hidden",))


def _decoder_ins(rs, tgt_lengths, src_lengths, pad=0, E=3, He=4, D=2, V=5):
    def w(*shape):
        return (rs.randn(*shape) * 0.5).astype(np.float32)

    return {"TargetEmb": [_seq(rs, tgt_lengths, E, pad=pad)],
            "EncoderVec": [_seq(rs, src_lengths, He, pad=pad)],
            "EncoderProj": [_seq(rs, src_lengths, D, pad=pad)],
            "DecoderBoot": [w(len(tgt_lengths), D)],
            "WAttState": [w(D, D)], "WAttScore": [w(2 * D, 1)],
            "WStep": [w(D + He + E, 4 * D)], "BStep": [w(1, 4 * D)],
            "WOut": [w(D, V)], "BOut": [w(1, V)]}


@pytest.mark.parametrize("caps", [(-1, -1), (4, 5)],
                         ids=["token_capacity", "caps"])
@pytest.mark.parametrize(**PAD)
def test_attention_lstm_decoder(pad, caps):
    ins = _decoder_ins(np.random.RandomState(21), [2, 4, 1], [3, 5, 2],
                       pad=pad)
    _compare("attention_lstm_decoder", ins,
             {"max_target_len": caps[0], "max_source_len": caps[1]},
             grad_slots=("Out",))


@pytest.mark.parametrize("what", ["target", "source"])
def test_attention_lstm_decoder_refuses_a_sequence_over_its_cap(what):
    """A sequence longer than its static loop bound would be cut without a
    word: both packages raise the same ValueError instead (the port
    reading the lengths on the host, never on a card)."""
    ins = _decoder_ins(np.random.RandomState(22), [2, 6, 1], [3, 5, 2])
    attrs = {"max_target_len": 6 if what == "source" else 5,
             "max_source_len": 4 if what == "source" else 5}
    msg = f"{what} sequence of length {6 if what == 'target' else 5} " \
          f"exceeds static cap"
    with pytest.raises(ValueError, match=msg):
        _run_jax("attention_lstm_decoder", ins, attrs)
    with pytest.raises(ValueError, match=msg):
        _run_port("attention_lstm_decoder", ins, attrs)


def test_attention_lstm_step():
    rs = np.random.RandomState(23)
    N, Ts, E, He, D, V = 4, 3, 3, 4, 2, 5

    def w(*shape):
        return (rs.randn(*shape) * 0.5).astype(np.float32)

    mask = np.array([[1, 1, 1], [1, 1, 0], [1, 0, 0], [1, 1, 1]], np.float32)
    ins = {"PrevEmb": [w(N, E)], "PrevH": [w(N, D)], "PrevC": [w(N, D)],
           "EncoderVec": [w(N, Ts, He)], "EncoderProj": [w(N, Ts, D)],
           "SrcMask": [mask], "WAttState": [w(D, D)],
           "WAttScore": [w(2 * D, 1)], "WStep": [w(D + He + E, 4 * D)],
           "BStep": [w(1, 4 * D)], "WOut": [w(D, V)], "BOut": [w(1, V)]}
    _compare("attention_lstm_step", ins, {},
             grad_slots=("H", "C", "LogProbs"))
