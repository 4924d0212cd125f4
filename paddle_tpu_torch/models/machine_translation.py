"""Seq2seq NMT: a bidirectional LSTM encoder and an attention LSTM decoder
(reference benchmark/fluid/models/machine_translation.py:30-180; the JAX
package's paddle_tpu/models/machine_translation.py).

The encoder runs dynamic_lstm forward and reversed; the decoder's
per-step attention (the reference's DynamicRNN with sequence_expand and
sequence_softmax) is the fused attention_lstm_decoder op. Ragged batches
travel as SeqTensors (data + lengths), so every shape in the step is
static. Beam-search decoding (the JAX package's beam_decode) waits for
the port's beam_search ops and control flow (ROADMAP queue 1 item 7).
"""

import paddle_tpu_torch as fluid


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
