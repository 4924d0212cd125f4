"""Seq2seq NMT: a bidirectional LSTM encoder and an attention LSTM decoder
(reference benchmark/fluid/models/machine_translation.py:30-180; the JAX
package's paddle_tpu/models/machine_translation.py).

The encoder runs dynamic_lstm forward and reversed; the decoder's
per-step attention (the reference's DynamicRNN with sequence_expand and
sequence_softmax) is the fused attention_lstm_decoder op. Ragged batches
travel as SeqTensors (data + lengths), so every shape in the step is
static. `beam_decode` translates with a trained net: the host drives the
loop, and each step runs one attention_lstm_step program and one
beam_search program (ROADMAP queue 1 item 4). `greedy_step_program` is
the same decoder step closed over its own argmax and target-embedding
lookup, for greedy streams served by serve.continuous.ContinuousServer;
`greedy_feeds` encodes a source batch into one request feed a source.
"""

import weakref

import numpy as np
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.executor import as_numpy


# the synthetic WMT14 dictionary (paddle_tpu/dataset/wmt14.py DICT_SIZE)
DICT_SIZE = 30000


def bi_lstm_encoder(input_seq, gate_size):
    input_forward_proj = fluid.layers.fc(
        input=input_seq, size=gate_size * 4, act=None, bias_attr=False)
    forward, _ = fluid.layers.dynamic_lstm(
        input=input_forward_proj, size=gate_size * 4, use_peepholes=False)
    input_reversed_proj = fluid.layers.fc(
        input=input_seq, size=gate_size * 4, act=None, bias_attr=False)
    reversed_, _ = fluid.layers.dynamic_lstm(
        input=input_reversed_proj, size=gate_size * 4, is_reverse=True,
        use_peepholes=False)
    return forward, reversed_


def seq_to_seq_net(embedding_dim, encoder_size, decoder_size,
                   source_dict_dim, target_dict_dim,
                   max_source_len=32, max_target_len=32):
    """Feeds "source_sequence", "target_sequence" and "label_sequence"
    (int64 ids, lod_level 1). max_{source,target}_len are the decoder's
    static loop bounds, and they are enforced: a fed batch whose sequences
    exceed a cap raises ValueError (OpContext.check_cap) instead of being
    cut. The encoder's recurrences have no bound and run over the source
    batch's flat token count, as in the JAX package. Returns (avg_cost,
    prediction)."""
    src_word_idx = fluid.layers.data(
        name="source_sequence", shape=[1], dtype="int64", lod_level=1)
    src_embedding = fluid.layers.embedding(
        input=src_word_idx, size=[source_dict_dim, embedding_dim],
        dtype="float32")

    src_forward, src_reversed = bi_lstm_encoder(
        input_seq=src_embedding, gate_size=encoder_size)
    encoded_vector = fluid.layers.concat(
        input=[src_forward, src_reversed], axis=1)
    encoded_proj = fluid.layers.fc(
        input=encoded_vector, size=decoder_size, bias_attr=False)

    backward_first = fluid.layers.sequence_pool(
        input=src_reversed, pool_type="first")
    decoder_boot = fluid.layers.fc(
        input=backward_first, size=decoder_size, bias_attr=False, act="tanh")

    # decoder: teacher-forced LSTM over the target sequence, with content
    # attention over the encoder states at every step
    trg_word_idx = fluid.layers.data(
        name="target_sequence", shape=[1], dtype="int64", lod_level=1)
    trg_embedding = fluid.layers.embedding(
        input=trg_word_idx, size=[target_dict_dim, embedding_dim],
        dtype="float32")
    prediction = fluid.layers.attention_lstm_decoder(
        target_embedding=trg_embedding,
        encoder_vec=encoded_vector,
        encoder_proj=encoded_proj,
        decoder_boot=decoder_boot,
        decoder_size=decoder_size,
        target_dict_dim=target_dict_dim,
        max_target_len=max_target_len, max_source_len=max_source_len)

    label = fluid.layers.data(
        name="label_sequence", shape=[1], dtype="int64", lod_level=1)
    cost = fluid.layers.cross_entropy(input=prediction, label=label)
    avg_cost = fluid.layers.mean(cost)
    return avg_cost, prediction


# train program -> {key: a program beam_decode built for it}: a repeat
# call runs the same programs, so their prepared steps and captured
# graphs are reused
_PROGRAMS = weakref.WeakKeyDictionary()


def _cached(train_prog, key, build):
    progs = _PROGRAMS.setdefault(train_prog, {})
    key = (train_prog._mutation,) + key
    if key not in progs:
        progs[key] = build()
    return progs[key]


def _step_programs(train_prog, weight_names, BK, K, V, E, D, Ts, He,
                   end_id):
    """(the one-step decoder program, the beam-step program, the
    backtrack program and its fetch vars). The decoder program reads the
    loop invariants beam_evec, beam_eproj and beam_smask and the
    decoder's weights from the scope by name."""
    step_prog = fluid.Program()
    with fluid.program_guard(step_prog, fluid.Program()):
        pe = fluid.layers.data(name="prev_emb", shape=[E], dtype="float32")
        ph = fluid.layers.data(name="prev_h", shape=[D], dtype="float32")
        pc = fluid.layers.data(name="prev_c", shape=[D], dtype="float32")
        blk = step_prog.global_block()
        ev = blk.create_var(name="beam_evec", shape=[-1, Ts, He],
                            dtype="float32", persistable=True)
        ej = blk.create_var(name="beam_eproj", shape=[-1, Ts, D],
                            dtype="float32", persistable=True)
        sm = blk.create_var(name="beam_smask", shape=[-1, Ts],
                            dtype="float32", persistable=True)
        for n in weight_names.values():
            v = train_prog.global_block().vars[n]
            blk.create_var(name=n, shape=v.shape, dtype=v.dtype,
                           persistable=True)
        for n in ("step_h", "step_c", "step_logprobs"):
            blk.create_var(name=n, dtype="float32")
        blk.append_op(
            type="attention_lstm_step",
            inputs={"PrevEmb": [pe.name], "PrevH": [ph.name],
                    "PrevC": [pc.name], "EncoderVec": [ev.name],
                    "EncoderProj": [ej.name], "SrcMask": [sm.name],
                    **{s: [n] for s, n in weight_names.items()}},
            outputs={"H": ["step_h"], "C": ["step_c"],
                     "LogProbs": ["step_logprobs"]},
            attrs={})

    # ids omitted: the candidate id is the vocabulary column
    beam_prog = fluid.Program()
    with fluid.program_guard(beam_prog, fluid.Program()):
        pi = fluid.layers.data(name="pre_ids", shape=[1], dtype="int64")
        ps = fluid.layers.data(name="pre_scores", shape=[1],
                               dtype="float32")
        cs = fluid.layers.data(name="cand_scores", shape=[V],
                               dtype="float32")
        beam_fetch = fluid.layers.beam_search(
            pi, None, cs, beam_size=K, end_id=end_id, pre_scores=ps,
            return_parents=True)

    decode_prog = fluid.Program()
    with fluid.program_guard(decode_prog, fluid.Program()):
        iv = fluid.layers.data(name="ids", shape=[BK, 1], dtype="int64")
        sv = fluid.layers.data(name="sc", shape=[BK, 1], dtype="float32")
        pv = fluid.layers.data(name="par", shape=[BK, 1], dtype="int64")
        decode_fetch = fluid.layers.beam_search_decode(
            iv, sv, parents=pv, end_id=end_id)
    return step_prog, beam_prog, beam_fetch, decode_prog, decode_fetch


def _padded(lt, width=None):
    """A fetched ragged LoDTensor as ([B, Ts, ...] zero-padded, [B, Ts]
    mask), Ts = `width` (default: the longest sequence)."""
    data = np.asarray(lt.numpy())
    offs = lt.last_level_offsets()
    lens = [b - a for a, b in zip(offs, offs[1:])]
    width = max(lens) if width is None else int(width)
    if max(lens) > width:
        raise ValueError(f"a source of {max(lens)} tokens exceeds "
                         f"max_source_len {width}")
    o = np.zeros((len(lens), width) + data.shape[1:], data.dtype)
    m = np.zeros((len(lens), width), "float32")
    for i, (a, b) in enumerate(zip(offs, offs[1:])):
        o[i, : b - a] = data[a:b]
        m[i, : b - a] = 1.0
    return o, m


def _decoder_wiring(train_prog):
    """({slot: weight name} of the decoder op, the target embedding's
    table name): the op's own input names are the source of truth,
    whatever the layers named them."""
    dec_op = _decoder_op(train_prog)
    weight_names = {s: dec_op.input(s)[0] for s in (
        "WAttState", "WAttScore", "WStep", "BStep", "WOut", "BOut")}
    table_n = next(
        op for op in train_prog.global_block().ops
        if op.type == "lookup_table"
        and op.input("Ids")[0] == "target_sequence").input("W")[0]
    return weight_names, table_n


def _decoder_op(train_prog):
    return next(op for b in train_prog.blocks for op in b.ops
                if op.type == "attention_lstm_decoder")


def _encode(exe, train_prog, src_lod_tensor, scope, max_source_len=None):
    """The encoder once, through a clone(for_test=True): (evec [B, Ts,
    He], eproj [B, Ts, D], source mask [B, Ts], decoder boot [B, D]) as
    numpy, zero-padded to `max_source_len` (default: the longest
    source)."""
    dec_op = _decoder_op(train_prog)
    infer_prog = _cached(train_prog, ("infer",),
                         lambda: train_prog.clone(for_test=True))
    evec, eproj, boot = exe.run(
        infer_prog, feed={"source_sequence": src_lod_tensor},
        fetch_list=[dec_op.input("EncoderVec")[0],
                    dec_op.input("EncoderProj")[0],
                    dec_op.input("DecoderBoot")[0]], scope=scope)
    evec_p, src_mask = _padded(evec, max_source_len)
    eproj_p, _ = _padded(eproj, max_source_len)
    return evec_p, eproj_p, src_mask, np.asarray(boot)


def greedy_step_program(train_prog, max_source_len):
    """One greedy decode step of a trained seq_to_seq_net, for a
    ContinuousServer: (program, feed names, output fetches, state map).

    Feeds, one row a stream: "prev_emb" [E], "prev_h" and "prev_c" [D]
    (the recurrent state) and "enc_vec" [Ts, He], "enc_proj" [Ts, D],
    "src_mask" [Ts] (the stream's encoded source, zero-padded to
    Ts = max_source_len; static for the stream). The step runs
    attention_lstm_step, takes the arg_max of its log-probs as the token
    and looks the token up in the trained target embedding as the next
    "prev_emb". Outputs: the token [1] (int64) and the new h [D]; state:
    prev_emb <- the looked-up embedding, prev_h <- h, prev_c <- c. The
    weights are read from the scope by their training names."""
    weight_names, table_n = _decoder_wiring(train_prog)
    gb = train_prog.global_block()
    V, E = gb.vars[table_n].shape
    D = gb.vars[weight_names["WOut"]].shape[0]
    He = gb.vars[weight_names["WStep"]].shape[0] - D - E
    Ts = int(max_source_len)
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        pe = fluid.layers.data(name="prev_emb", shape=[E], dtype="float32")
        ph = fluid.layers.data(name="prev_h", shape=[D], dtype="float32")
        pc = fluid.layers.data(name="prev_c", shape=[D], dtype="float32")
        ev = fluid.layers.data(name="enc_vec", shape=[Ts, He],
                               dtype="float32")
        ej = fluid.layers.data(name="enc_proj", shape=[Ts, D],
                               dtype="float32")
        sm = fluid.layers.data(name="src_mask", shape=[Ts], dtype="float32")
        blk = prog.global_block()
        for n in list(weight_names.values()) + [table_n]:
            v = gb.vars[n]
            blk.create_var(name=n, shape=v.shape, dtype=v.dtype,
                           persistable=True)
        h = blk.create_var(name="greedy_h", shape=[-1, D], dtype="float32")
        c = blk.create_var(name="greedy_c", shape=[-1, D], dtype="float32")
        lp = blk.create_var(name="greedy_logprobs", shape=[-1, V],
                            dtype="float32")
        blk.append_op(
            type="attention_lstm_step",
            inputs={"PrevEmb": [pe.name], "PrevH": [ph.name],
                    "PrevC": [pc.name], "EncoderVec": [ev.name],
                    "EncoderProj": [ej.name], "SrcMask": [sm.name],
                    **{s: [n] for s, n in weight_names.items()}},
            outputs={"H": [h.name], "C": [c.name], "LogProbs": [lp.name]},
            attrs={})
        tok = blk.create_var(name="greedy_token", shape=[-1],
                             dtype="int64")
        blk.append_op(type="arg_max", inputs={"X": [lp.name]},
                      outputs={"Out": [tok.name]}, attrs={"axis": 1})
        ids = fluid.layers.reshape(tok, shape=[-1, 1])
        emb = blk.create_var(name="greedy_next_emb", shape=[-1, E],
                             dtype="float32")
        blk.append_op(type="lookup_table",
                      inputs={"W": [table_n], "Ids": [ids.name]},
                      outputs={"Out": [emb.name]},
                      attrs={"padding_idx": -1})
    feeds = ["prev_emb", "prev_h", "prev_c", "enc_vec", "enc_proj",
             "src_mask"]
    state = {"prev_emb": emb.name, "prev_h": h.name, "prev_c": c.name}
    return prog, feeds, [tok, h], state


def greedy_feeds(exe, train_prog, src_lod_tensor, max_source_len,
                 start_id=0, scope=None):
    """One greedy_step_program request feed per source of the batch: the
    encoder runs once for the batch, as beam_decode's does; each stream
    starts from the start token's embedding, the decoder boot as h and
    zeros as c."""
    scope = scope if scope is not None else fluid.global_scope()
    _, table_n = _decoder_wiring(train_prog)
    evec, eproj, mask, boot = _encode(exe, train_prog, src_lod_tensor,
                                      scope, max_source_len)
    table = as_numpy(scope.find_var(table_n))
    start = table[start_id].astype("float32")
    return [{"prev_emb": start, "prev_h": boot[i].astype("float32"),
             "prev_c": np.zeros_like(boot[i], dtype="float32"),
             "enc_vec": evec[i].astype("float32"),
             "enc_proj": eproj[i].astype("float32"),
             "src_mask": mask[i]} for i in range(len(boot))]


def beam_decode(exe, train_prog, src_lod_tensor, beam_size=4, max_len=16,
                start_id=0, end_id=1, scope=None):
    """Beam-search inference over a trained seq_to_seq_net (reference
    python/paddle/fluid/tests/book/test_machine_translation.py decode():
    a While loop of DynamicRNN step and beam_search ops; here, as in the
    JAX package, the host drives the loop).

    The encoder runs once, through a clone(for_test=True); its outputs
    go into the scope once as the loop invariants beam_evec, beam_eproj
    and beam_smask. Each step then runs the attention_lstm_step program
    (fetching its [B*K, V] log-probs), adds the beams' scores on the
    host and runs the beam_search program; the beams follow their
    parents' recurrent state; the loop stops when every beam has ended
    or after max_len steps, and one beam_search_decode run backtracks
    the sentences. The programs are built once per (train program,
    shapes) and reused by later calls.

    Returns (sentences, scores): per-beam token-id lists and accumulated
    log-prob floats, source-major, beam-minor."""
    scope = scope if scope is not None else fluid.global_scope()
    weight_names, table_n = _decoder_wiring(train_prog)

    evec_p, eproj_p, src_mask, boot = _encode(exe, train_prog,
                                              src_lod_tensor, scope)
    B, Ts, He = evec_p.shape
    D = boot.shape[-1]
    K = beam_size
    table = as_numpy(scope.find_var(table_n))
    V, E = table.shape
    step_prog, beam_prog, beam_fetch, decode_prog, decode_fetch = _cached(
        train_prog, (K, B, Ts, He, D, E, V, end_id),
        lambda: _step_programs(train_prog, weight_names, B * K, K, V, E, D,
                               Ts, He, end_id))

    def rep(a):
        return np.repeat(a, K, axis=0)

    for n, v in (("beam_evec", rep(evec_p)), ("beam_eproj", rep(eproj_p)),
                 ("beam_smask", rep(src_mask))):
        scope.var(n)
        scope.set_var(n, torch.from_numpy(v.astype("float32")).to(
            exe.device))

    pre_ids = np.full((B * K, 1), -1, dtype="int64")
    pre_ids[::K, 0] = start_id
    pre_scores = np.zeros((B * K, 1), dtype="float32")
    h = rep(boot).astype("float32")
    c = np.zeros((B * K, D), dtype="float32")
    step_ids, step_scores, step_parents = [], [], []
    for _ in range(max_len):
        emb = table[np.clip(pre_ids[:, 0], 0, V - 1)].astype("float32")
        lp, h_new, c_new = exe.run(
            step_prog, feed={"prev_emb": emb, "prev_h": h, "prev_c": c},
            fetch_list=["step_logprobs", "step_h", "step_c"], scope=scope)
        cand_scores = pre_scores + lp
        sel, sc, par = exe.run(
            beam_prog, feed={"pre_ids": pre_ids, "pre_scores": pre_scores,
                             "cand_scores": cand_scores},
            fetch_list=list(beam_fetch), scope=scope)
        par = par.astype("int64")
        step_ids.append(sel.astype("int64"))
        step_scores.append(sc)
        step_parents.append(par)
        # beams follow their parents' recurrent state
        h, c = h_new[par[:, 0]], c_new[par[:, 0]]
        pre_ids, pre_scores = step_ids[-1], sc
        if (pre_ids[:, 0] == end_id).all():
            break

    ids_lt, sc_lt = exe.run(
        decode_prog, feed={"ids": np.stack(step_ids),
                           "sc": np.stack(step_scores),
                           "par": np.stack(step_parents)},
        fetch_list=list(decode_fetch), scope=scope)
    offs = ids_lt.last_level_offsets()
    toks = np.asarray(ids_lt.numpy()).reshape(-1)
    scs = np.asarray(sc_lt.numpy()).reshape(-1)
    sentences, scores = [], []
    for a, b in zip(offs, offs[1:]):
        sentences.append(toks[a:b].tolist())
        scores.append(float(scs[b - 1]) if b > a else 0.0)
    return sentences, scores


def lodtensor_to_ndarray(lod_tensor):
    return np.asarray(lod_tensor.numpy()), lod_tensor.lod()


def get_model(args):
    embedding_dim = 512
    encoder_size = 512
    decoder_size = 512
    dict_size = 30000

    avg_cost, feeding_list = seq_to_seq_net(
        embedding_dim, encoder_size, decoder_size, dict_size, dict_size)

    inference_program = fluid.default_main_program().clone(for_test=True)
    optimizer = fluid.optimizer.Adam(
        learning_rate=getattr(args, "learning_rate", 2e-4))

    train_reader = fluid.batch(
        fluid.reader.shuffle(
            fluid.dataset.wmt14.train(dict_size), buf_size=1000),
        batch_size=args.batch_size)
    test_reader = fluid.batch(
        fluid.dataset.wmt14.test(dict_size), batch_size=args.batch_size)

    return avg_cost, inference_program, optimizer, train_reader, \
        test_reader, None
