"""RNN ops: LSTM/GRU cells and whole-sequence recurrences.

Reference parity: operators/lstm_op.cc (dynamic_lstm), gru_op.cc
(dynamic_gru), lstm_unit_op.cc, gru_unit_op.cc, operators/math/
lstm_compute + sequence2batch.h; the JAX package's
paddle_tpu/ops/rnn_ops.py, whose expressions, in their order, each kernel
here repeats. A ragged input is padded to [B, T, *]
(sequence_ops.seq_to_padded) and the recurrence is a Python loop over the
static trip count T, where the JAX package runs one lax.scan: under a
captured step the loop's launches become one CUDA graph. A sequence's
state is carried unchanged past its last token (the per-step mask), so a
batch of ragged lengths gives each sequence its own result.

Gate layout (the layers' spec): LSTM gates [i, f, c~, o] concatenated on
the last dim; GRU gates [u, r] and the candidate c.
"""

import torch

from ..core.registry import SeqTensor, register_op
from .sequence_ops import padded_to_seq, seq_to_padded
from .util import first, out

_ACT = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
}
# gru_unit takes its activations as the reference's enum as well
_ACT_ENUM = {0: "identity", 1: "sigmoid", 2: "tanh", 3: "relu"}


def _mm(a, b):
    """a @ b in a's dtype (a bf16 product accumulates in f32)."""
    return torch.matmul(a, b).to(a.dtype)


def _padded(x, attrs, cap_attr):
    """(x as [B, T, F], lengths [B]): a SeqTensor padded to T = the
    `cap_attr` attr, or to its token capacity when the attr is unset; a
    dense [B, T, F] input as it is, every sequence T long."""
    if isinstance(x, SeqTensor):
        T = attrs.get(cap_attr, -1)
        if T is None or T < 0:
            T = int(x.ntokens)
        return seq_to_padded(x, T), x.lengths
    return x, torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                         device=x.device)


def _step_masks(lengths, T, dtype):
    """[T] lists of [B, 1] masks (1 while step t is inside a sequence)
    and their complements, made once for every step of the loop."""
    t = torch.arange(T, device=lengths.device)[:, None]
    mask = (t < lengths[None, :]).to(dtype)[..., None]
    return mask.unbind(0), (1 - mask).unbind(0)


def _unpadded(padded, x, lengths):
    if isinstance(x, SeqTensor):
        return padded_to_seq(padded, lengths, x.ntokens)
    return padded


@register_op("lstm", lod_aware=True)
def lstm_op(ctx, ins, attrs):
    """dynamic_lstm: Input [N, 4D] ragged (x @ W_x already applied), Weight
    [D, 4D] recurrent, Bias [1, 4D] (with a [1, 3D] peephole tail under
    use_peepholes). Outputs Hidden and Cell, ragged [N, D]. The trip count
    is the `max_len` attr, or the input's token capacity without it; a
    sequence longer than max_len is cut at it, as in the JAX package."""
    x, w, bias = first(ins, "Input"), first(ins, "Weight"), first(ins, "Bias")
    h0, c0 = first(ins, "H0"), first(ins, "C0")
    use_peepholes = attrs.get("use_peepholes", False)
    gact = _ACT[attrs.get("gate_activation", "sigmoid")]
    cact = _ACT[attrs.get("cell_activation", "tanh")]
    hact = _ACT[attrs.get("candidate_activation", "tanh")]
    d = w.shape[0]
    xp, lengths = _padded(x, attrs, "max_len")
    B, T = xp.shape[0], xp.shape[1]

    gate_b = bias[:, :4 * d] if bias is not None else 0.0
    if use_peepholes and bias is not None:
        w_ic, w_fc, w_oc = (bias[:, k * d:(k + 1) * d] for k in (4, 5, 6))
    h = h0 if h0 is not None else xp.new_zeros((B, d))
    c = c0 if c0 is not None else xp.new_zeros((B, d))
    xs = xp.unbind(1)
    masks, keeps = _step_masks(lengths, T, xp.dtype)
    hs, cs = [None] * T, [None] * T
    order = range(T - 1, -1, -1) if attrs.get("is_reverse", False) \
        else range(T)
    for t in order:
        gates = xs[t] + _mm(h, w) + gate_b
        i_g, f_g, c_g, o_g = gates.chunk(4, dim=-1)
        if use_peepholes:
            i_g = i_g + w_ic * c
            f_g = f_g + w_fc * c
        i = gact(i_g)
        f = gact(f_g)
        c_new = f * c + i * cact(c_g)
        if use_peepholes:
            o_g = o_g + w_oc * c_new
        o = gact(o_g)
        h_new = o * hact(c_new)
        h = masks[t] * h_new + keeps[t] * h
        c = masks[t] * c_new + keeps[t] * c
        hs[t], cs[t] = h, c
    hidden, cell = torch.stack(hs, 1), torch.stack(cs, 1)  # [B, T, D]
    return out(Hidden=_unpadded(hidden, x, lengths),
               Cell=_unpadded(cell, x, lengths))


@register_op("gru", lod_aware=True)
def gru_op(ctx, ins, attrs):
    """dynamic_gru: Input [N, 3D] ragged (x projected), Weight [D, 3D]
    ([:, :2D] update and reset, [:, 2D:] candidate), Bias [1, 3D].
    h_t = u * h_prev + (1 - u) * c (reference gru_op.cc)."""
    x, w, bias = first(ins, "Input"), first(ins, "Weight"), first(ins, "Bias")
    h0 = first(ins, "H0")
    gact = _ACT[attrs.get("gate_activation", "sigmoid")]
    cact = _ACT[attrs.get("activation", "tanh")]
    d = w.shape[0]
    xp, lengths = _padded(x, attrs, "max_len")
    B, T = xp.shape[0], xp.shape[1]
    if bias is not None:
        xp = xp + bias
    w_ur, w_c = w[:, :2 * d], w[:, 2 * d:]
    h = h0 if h0 is not None else xp.new_zeros((B, d))
    xs = xp.unbind(1)
    masks, keeps = _step_masks(lengths, T, xp.dtype)
    hs = [None] * T
    order = range(T - 1, -1, -1) if attrs.get("is_reverse", False) \
        else range(T)
    for t in order:
        x_ur, x_c = xs[t][:, :2 * d], xs[t][:, 2 * d:]
        u, r = gact(x_ur + _mm(h, w_ur)).chunk(2, dim=-1)
        c = cact(x_c + _mm(r * h, w_c))
        h_new = u * h + (1 - u) * c
        h = masks[t] * h_new + keeps[t] * h
        hs[t] = h
    return out(Hidden=_unpadded(torch.stack(hs, 1), x, lengths))


@register_op("lstm_unit")
def lstm_unit_op(ctx, ins, attrs):
    """reference lstm_unit_op.cc: X = [B, 4D] pre-projected gates, C_prev."""
    x, c_prev = first(ins, "X"), first(ins, "C_prev")
    i_g, f_g, c_g, o_g = x.chunk(4, dim=-1)
    i = torch.sigmoid(i_g)
    f = torch.sigmoid(f_g + attrs.get("forget_bias", 0.0))
    c = f * c_prev + i * torch.tanh(c_g)
    h = torch.sigmoid(o_g) * torch.tanh(c)
    return out(C=c, H=h)


def _unit_act(attrs, name, default):
    """The activation an attr names, as a string or as the reference's enum
    (an unknown enum value means the default's)."""
    a = attrs.get(name, default)
    if isinstance(a, int):
        a = _ACT_ENUM.get(a, _ACT_ENUM[default])
    return _ACT[a]


@register_op("gru_unit")
def gru_unit_op(ctx, ins, attrs):
    """reference gru_unit_op.cc: one GRU step. Input = [B, 3D] (the x
    projection), HiddenPrev = [B, D], Weight = [D, 3D]."""
    x, h_prev = first(ins, "Input"), first(ins, "HiddenPrev")
    w, bias = first(ins, "Weight"), first(ins, "Bias")
    d = h_prev.shape[-1]
    gact = _unit_act(attrs, "gate_activation", 1)
    cact = _unit_act(attrs, "activation", 2)
    g = x + bias if bias is not None else x
    x_ur, x_c = g[:, :2 * d], g[:, 2 * d:]
    u, r = gact(x_ur + _mm(h_prev, w[:, :2 * d])).chunk(2, dim=-1)
    reset_h = r * h_prev
    c = cact(x_c + _mm(reset_h, w[:, 2 * d:]))
    h = u * h_prev + (1 - u) * c
    return out(Gate=torch.cat([u, r, c], dim=-1), ResetHiddenPrev=reset_h,
               Hidden=h)


def _attention(h, pp, ep, src_mask, w_att_state, w_att_score):
    """Content attention of the decoder state h [B, D] over the encoder
    states ep [B, Ts, He], scored against their projections pp [B, Ts, D];
    source positions past each sequence's end get no weight."""
    sp = _mm(h, w_att_state)  # [B, D]
    cat = torch.cat([pp, sp[:, None, :].expand(pp.shape)], dim=-1)
    scores = torch.tanh(torch.einsum("bsd,dk->bsk", cat, w_att_score))[..., 0]
    scores = torch.where(src_mask > 0, scores, -1e9)
    a = torch.softmax(scores, dim=-1) * src_mask
    a = a / torch.clamp_min(a.sum(-1, keepdim=True), 1e-9)
    return torch.einsum("bs,bsh->bh", a, ep)  # [B, He]


def _lstm_cell(dec_in, c_prev, w_step, b_step):
    gates = _mm(dec_in, w_step) + b_step
    i_g, f_g, c_g, o_g = gates.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i_g), torch.sigmoid(f_g), torch.sigmoid(o_g)
    c_new = f * c_prev + i * torch.tanh(c_g)
    return o * torch.tanh(c_new), c_new


@register_op("attention_lstm_decoder", lod_aware=True)
def attention_lstm_decoder_op(ctx, ins, attrs):
    """Teacher-forced LSTM decoder with content attention over the encoder
    states — the fused counterpart of the reference's DynamicRNN decoder
    (benchmark/fluid/models/machine_translation.py:104-152: per-step fc
    attention, sequence_expand/sequence_softmax and an lstm step).

    Inputs:
      TargetEmb   SeqTensor [Nt, E]   target word embeddings
      EncoderVec  SeqTensor [Ns, He]  encoder states
      EncoderProj SeqTensor [Ns, D]   encoder states projected for scoring
      DecoderBoot [B, D]              initial hidden state
      WAttState [D, D]; WAttScore [2D, 1]         attention parameters
      WStep [D+He+E, 4D]; BStep [1, 4D]           gate weights [i,f,c~,o]
      WOut [D, V]; BOut [1, V]                    output projection
    Output: Out SeqTensor [Nt, V], the softmax over the target vocabulary.
    The loop runs `max_target_len` steps over `max_source_len` source
    positions (or the token capacities without them); a fed sequence
    longer than its cap raises ValueError, checked on the host
    (OpContext.check_cap)."""
    temb, evec = first(ins, "TargetEmb"), first(ins, "EncoderVec")
    eproj, boot = first(ins, "EncoderProj"), first(ins, "DecoderBoot")
    w_att_state, w_att_score = first(ins, "WAttState"), first(ins, "WAttScore")
    w_step, b_step = first(ins, "WStep"), first(ins, "BStep")
    w_out, b_out = first(ins, "WOut"), first(ins, "BOut")
    d = boot.shape[-1]

    Tt, Ts = attrs.get("max_target_len", -1), attrs.get("max_source_len", -1)
    if Tt is None or Tt < 0:
        Tt = int(temb.ntokens)
    else:
        ctx.check_cap(temb.lengths, Tt, "target", "attention_lstm_decoder")
    if Ts is None or Ts < 0:
        Ts = int(evec.ntokens)
    else:
        ctx.check_cap(evec.lengths, Ts, "source", "attention_lstm_decoder")

    tp = seq_to_padded(temb, Tt)   # [B, Tt, E]
    ep = seq_to_padded(evec, Ts)   # [B, Ts, He]
    pp = seq_to_padded(eproj, Ts)  # [B, Ts, D]
    B = tp.shape[0]
    src_mask = (torch.arange(Ts, device=tp.device)[None, :]
                < evec.lengths[:, None]).to(tp.dtype)  # [B, Ts]
    masks, keeps = _step_masks(temb.lengths, Tt, tp.dtype)
    h, c = boot, tp.new_zeros((B, d))
    xs = tp.unbind(1)
    ps = []
    for t in range(Tt):
        context = _attention(h, pp, ep, src_mask, w_att_state, w_att_score)
        h_new, c_new = _lstm_cell(torch.cat([h, context, xs[t]], dim=-1), c,
                                  w_step, b_step)
        h = masks[t] * h_new + keeps[t] * h
        c = masks[t] * c_new + keeps[t] * c
        ps.append(torch.softmax(_mm(h, w_out) + b_out, dim=-1))
    pred = torch.stack(ps, 1)  # [B, Tt, V]
    return out(Out=padded_to_seq(pred, temb.lengths, temb.ntokens))


@register_op("attention_lstm_step", lod_aware=True)
def attention_lstm_step_op(ctx, ins, attrs):
    """ONE decoder step on dense beam rows, the inference counterpart of
    attention_lstm_decoder: PrevEmb [N, E], PrevH/PrevC [N, D], EncoderVec
    [N, Ts, He], EncoderProj [N, Ts, D], SrcMask [N, Ts] -> H, C,
    LogProbs [N, V], with N = B * beam_size rows (source-major)."""
    x = first(ins, "PrevEmb")
    h_prev, c_prev = first(ins, "PrevH"), first(ins, "PrevC")
    context = _attention(h_prev, first(ins, "EncoderProj"),
                         first(ins, "EncoderVec"), first(ins, "SrcMask"),
                         first(ins, "WAttState"), first(ins, "WAttScore"))
    h_new, c_new = _lstm_cell(torch.cat([h_prev, context, x], dim=-1), c_prev,
                              first(ins, "WStep"), first(ins, "BStep"))
    logits = _mm(h_new, first(ins, "WOut")) + first(ins, "BOut")
    return out(H=h_new, C=c_new,
               LogProbs=torch.log_softmax(logits, dim=-1))
