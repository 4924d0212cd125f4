"""Stacked LSTM for IMDB sentiment (reference
benchmark/fluid/models/stacked_dynamic_lstm.py:46-120; the JAX package's
paddle_tpu/models/stacked_dynamic_lstm.py).

The reference hand-builds the LSTM gates inside a DynamicRNN (one fc per
gate per step); this model, as the JAX package's, expresses the same
computation with the fused dynamic_lstm layer: one projection fc, then one
recurrence with all four gates in a single matmul a step, the layout of
the reference's own dynamic_lstm op. The words/sec metric is the same.
"""

import paddle_tpu_torch as fluid


LSTM_SIZE = 512
EMB_DIM = 512
# the synthetic IMDB vocabulary (paddle_tpu/dataset/imdb.py VOCAB_SIZE)
VOCAB_SIZE = 5148


def stacked_lstm_net(dict_dim, emb_dim=EMB_DIM, lstm_size=LSTM_SIZE,
                     max_len=None):
    """The program get_model builds: "words" (int64 ids, lod_level 1) ->
    embedding -> fc(tanh) -> fc(4 x lstm_size, no bias) ->
    dynamic_lstm(max_len) -> sequence_pool(last) -> fc(2, softmax);
    cross_entropy against "label", mean, accuracy. `max_len` is the
    recurrence's static trip count (fluid_benchmark's --max_seq_len);
    without it the loop runs over the batch's flat token count. Returns
    (loss, accuracy)."""
    data = fluid.layers.data(
        name="words", shape=[1], lod_level=1, dtype="int64")
    sentence = fluid.layers.embedding(input=data, size=[dict_dim, emb_dim])
    sentence = fluid.layers.fc(input=sentence, size=lstm_size, act="tanh")
    proj = fluid.layers.fc(input=sentence, size=lstm_size * 4,
                           bias_attr=False)
    hidden, _cell = fluid.layers.dynamic_lstm(
        input=proj, size=lstm_size * 4, use_peepholes=False, max_len=max_len)
    last = fluid.layers.sequence_pool(hidden, "last")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    logit = fluid.layers.fc(input=last, size=2, act="softmax")
    loss = fluid.layers.mean(
        fluid.layers.cross_entropy(input=logit, label=label))
    batch_acc = fluid.layers.accuracy(input=logit, label=label)
    return loss, batch_acc


def get_model(args):
    lstm_size = 512
    emb_dim = 512
    crop_size = 1500

    word_dict = fluid.dataset.imdb.word_dict()

    data = fluid.layers.data(
        name="words", shape=[1], lod_level=1, dtype="int64")
    sentence = fluid.layers.embedding(
        input=data, size=[len(word_dict), emb_dim])
    sentence = fluid.layers.fc(input=sentence, size=lstm_size, act="tanh")

    proj = fluid.layers.fc(input=sentence, size=lstm_size * 4,
                           bias_attr=False)
    hidden, _cell = fluid.layers.dynamic_lstm(
        input=proj, size=lstm_size * 4, use_peepholes=False,
        # static scan bound: without it the scan trip count defaults to
        # the batch's FLAT token total — fine for eager shapes, 10-20x
        # wasteful under bucketed feeding (benchmark --max_seq_len)
        max_len=getattr(args, "max_seq_len", None))

    last = fluid.layers.sequence_pool(hidden, "last")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    logit = fluid.layers.fc(input=last, size=2, act="softmax")
    loss = fluid.layers.mean(
        fluid.layers.cross_entropy(input=logit, label=label))
    batch_acc = fluid.layers.accuracy(input=logit, label=label)

    inference_program = fluid.default_main_program().clone(for_test=True)
    adam = fluid.optimizer.Adam()

    def crop_sentence(reader, crop_size):
        unk_value = word_dict["<unk>"]

        def __impl__():
            for item in reader():
                if len([x for x in item[0] if x != unk_value]) < crop_size:
                    yield item

        return __impl__

    train_reader = fluid.batch(
        fluid.reader.shuffle(
            crop_sentence(fluid.dataset.imdb.train(word_dict), crop_size),
            buf_size=25000),
        batch_size=args.batch_size)
    test_reader = fluid.batch(
        crop_sentence(fluid.dataset.imdb.test(word_dict), crop_size),
        batch_size=args.batch_size)

    return loss, inference_program, adam, train_reader, test_reader, batch_acc
