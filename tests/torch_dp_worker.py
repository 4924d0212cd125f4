"""One rank of a multi-process run of paddle_tpu_torch's data parallelism on
the host (gloo), and the nets the tests hold it to.

    python tests/torch_dp_worker.py SPEC.json RANK

SPEC.json holds {"world": W, "rendezvous": <path of a file that does not
exist yet>, "out": <dir>, "cuda": bool, "cases": [...]}. The rank joins a
W-rank group through `parallel.distributed.initialize("file://...")` —
gloo on the host, or with "cuda" NCCL on card `rank` (TF32 off, cuDNN
deterministic) — runs every case in order and writes
`<out>/<case name>.<rank>.npz`. A case is
  {"kind": "collectives", "name", "seed"}: every collective op on this
    rank's numpy-seeded inputs (`collective_inputs`), the all_reduce grads
    through its derived grad kernel included;
  {"kind": "pe", "name", "net", "opt", "zero1", "fuse", "gss", "data",
   "init", "iters", "fetch_batch", "reduce_strategy"}: the net of `build`
    (zero1 None and reduce_strategy: BuildStrategy.Reduce) from the
    state in the `init` npz, ParallelExecutor.run over the global batches
    of the `data` npz ("x" [steps, B, ...], "y" [steps, B, 1]) — one run
    a step, or one run of iters=steps — then the losses, the full-layout
    state (convert.numpy_state), each persistable's shape in the scope,
    the program's collective ops and fused buckets and, with
    fetch_batch, the last step's softmax output; with "save": <dir>,
    fluid.io.save_persistables into <dir>/<rank> and a load back
    (`_save_and_load`); with "monitor": <dir>, the steps journaled to
    `<dir>/<case name>.<rank>.jsonl` under FLAGS_monitor_replica_skew, and
    the skew gauge ("skew_gauge") and the ranks of the per-rank gauges
    ("replica_gauges") after them; with "async_fetch", every step's
    fetches come back as FetchFutures, read after the step; with
    "checkpoint": <dir>, a blocking
    resilience.CheckpointManager save into <dir>/<rank> after the steps
    (every rank takes part in the zero1 gathers); with "overlap": B,
    FLAGS_overlap_plan on with buckets of B bytes (the count of hoisted
    scatters and the op order of the rank's program come back); with
    "profile" (a card), one more step after the results are taken, under
    torch.profiler: the step mode, the NCCL reduce-scatter kernels' time
    and the part of it another stream's kernel ran beside (`_overlap`);
  {"kind": "pipeline", "name", "net", "opt", "zero1", "fuse", "data",
   "init", "stages", "microbatches"}: the net through
    parallel.pipeline.PipelineRunner(parallel_executor=) over the dp
    group, one step a global batch: the losses and the full-layout state
    (with "fetch_probs", the last step's softmax fetch too);
  {"kind": "ragged", "name", "net" ("lstm" or "token"), "data", "init",
   "iters"}: `build_ragged`'s net with Adam under FLAGS_fuse through
    ParallelExecutor, fed the `data` npz's ragged batches (`ragged_feed`,
    bucket-padded), one run a step or one run of iters=steps: the losses
    (and the token net's edit-distance and chunk fetches; its ragged
    fetch as each step's offsets and real rows, `ragged_fetch`) and the
    state;
  {"kind": "datapipe", "name", "net", "opt", "data", "init", "chunk"}:
    the net through ParallelExecutor fed by a seeded DataPipe of the
    `data` batches (iters = chunk a run), then from the same state the
    same batches fed as dicts: both runs' losses and states.
This module imports paddle_tpu_torch and nothing of the JAX package; the
tests import `build` and `collective_inputs` to make the same nets and
inputs on the JAX side, and `launch` to run the ranks.
"""

import faulthandler
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

OPTIMIZERS = {
    "sgd": lambda fluid: fluid.optimizer.SGD(learning_rate=0.05),
    "momentum": lambda fluid: fluid.optimizer.Momentum(learning_rate=0.05,
                                                       momentum=0.9),
    "adam": lambda fluid: fluid.optimizer.Adam(learning_rate=0.01),
    # powers of two: with the `linear` net's dyadic gradients every
    # product is exact, and the two packages' updates agree bit for bit
    "momentum_pow2": lambda fluid: fluid.optimizer.Momentum(
        learning_rate=0.125, momentum=0.5),
    "rmsprop_pow2": lambda fluid: fluid.optimizer.RMSProp(
        learning_rate=0.125, rho=0.0, epsilon=0.0, momentum=0.5),
    "rmsprop": lambda fluid: fluid.optimizer.RMSProp(learning_rate=0.01,
                                                     momentum=0.5),
}
SHAPES = {"mlp": [32], "conv_bn": [3, 8, 8], "dropout": [32],
          "linear": [32], "resnet50": [3, 32, 32]}
CLASSES = 4


def build(fluid, net, opt):
    """(main, startup, loss, probs) of `net` with optimizer `opt`, under a
    fresh unique_name.guard so both packages name every var alike:
      mlp     — tests/test_parallel.py's net: fc(32, relu), fc(4, softmax);
      conv_bn — conv2d(4, 3x3, pad 1), batch_norm(relu), 2x2 max pool,
                fc(4, softmax), and the accuracy op;
      dropout — fc(32, relu), dropout(0.5), fc(4, softmax);
      linear  — the mean of fc(4) (its gradients are the batch's mean
                input, whatever the parameters: exact for dyadic inputs;
                the label is fed and unused);
      resnet50 — the headline's network (models/resnet.py's
                resnet_imagenet, depth 50) on 32 x 32 inputs, 4 classes."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=SHAPES[net],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        if net == "linear":
            out = fluid.layers.fc(input=img, size=CLASSES)
            loss = fluid.layers.mean(out)
            OPTIMIZERS[opt](fluid).minimize(loss)
            main.random_seed = startup.random_seed = 7
            return main, startup, loss, out
        if net == "resnet50":
            resnet = __import__(fluid.__name__ + ".models.resnet",
                                fromlist=["resnet_imagenet"])
            probs = resnet.resnet_imagenet(img, CLASSES, depth=50)
            loss = fluid.layers.mean(
                fluid.layers.cross_entropy(input=probs, label=label))
            OPTIMIZERS[opt](fluid).minimize(loss)
            main.random_seed = startup.random_seed = 7
            return main, startup, loss, probs
        if net == "conv_bn":
            conv = fluid.layers.conv2d(img, 4, 3, padding=1)
            h = fluid.layers.pool2d(fluid.layers.batch_norm(conv, act="relu"),
                                    2, pool_stride=2)
        else:
            h = fluid.layers.fc(input=img, size=32, act="relu")
            if net == "dropout":
                h = fluid.layers.dropout(h, dropout_prob=0.5)
        probs = fluid.layers.fc(input=h, size=CLASSES, act="softmax")
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=probs, label=label))
        if net == "conv_bn":
            fluid.layers.accuracy(input=probs, label=label)
        OPTIMIZERS[opt](fluid).minimize(loss)
    main.random_seed = startup.random_seed = 7
    return main, startup, loss, probs


RAGGED_VOCAB, RAGGED_WIDTH, RAGGED_MAX_LEN, RAGGED_TAGS = 50, 16, 12, 5


def build_ragged(fluid, net):
    """(main, startup, fetches) of a ragged net with Adam(0.01):
      lstm  — the stacked LSTM (models/stacked_dynamic_lstm.py) at
              vocabulary 50, width 16, max_len 12: its loss is a dense
              mean over the sequences;
      token — a token-level tagger: embedding(16), fc(5 tags, softmax)
              and cross_entropy on every token, its loss the mean over a
              ragged var (the lod-aware mean, over the real tokens); the
              argmax tags' edit distance to the labels (its SequenceNum
              and the distances' mean) are fetched too, and the argmax
              tags, a ragged var, last;
      token_chunk — the token net with chunk_eval's three counts fetched
              too (a host op: the JAX package's ParallelExecutor cannot
              trace it, so this one is held to the port's Executor).
    "words" (and "tags") are ragged int64 feeds, "label" dense."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        words = fluid.layers.data(name="words", shape=[1], lod_level=1,
                                  dtype="int64")
        if net == "lstm":
            emb = fluid.layers.embedding(input=words, size=[RAGGED_VOCAB,
                                                            RAGGED_WIDTH])
            sentence = fluid.layers.fc(input=emb, size=RAGGED_WIDTH,
                                       act="tanh")
            proj = fluid.layers.fc(input=sentence, size=RAGGED_WIDTH * 4,
                                   bias_attr=False)
            hidden, _ = fluid.layers.dynamic_lstm(
                input=proj, size=RAGGED_WIDTH * 4, use_peepholes=False,
                max_len=RAGGED_MAX_LEN)
            last = fluid.layers.sequence_pool(hidden, "last")
            label = fluid.layers.data(name="label", shape=[1],
                                      dtype="int64")
            logit = fluid.layers.fc(input=last, size=2, act="softmax")
            loss = fluid.layers.mean(
                fluid.layers.cross_entropy(input=logit, label=label))
            fetches = [loss]
        else:
            tags = fluid.layers.data(name="tags", shape=[1], lod_level=1,
                                     dtype="int64")
            emb = fluid.layers.embedding(input=words, size=[RAGGED_VOCAB,
                                                            RAGGED_WIDTH])
            probs = fluid.layers.fc(input=emb, size=RAGGED_TAGS,
                                    act="softmax")
            loss = fluid.layers.mean(
                fluid.layers.cross_entropy(input=probs, label=tags))
            pred = fluid.layers.argmax(probs, axis=1)
            pred = fluid.layers.reshape(pred, [-1, 1])
            pred = fluid.layers.lod_reset(pred, y=tags)
            dist, seq_num = fluid.layers.edit_distance(pred, tags)
            fetches = [loss, seq_num, fluid.layers.mean(dist)]
            if net == "token_chunk":
                fetches += list(fluid.layers.chunk_eval(
                    input=pred, label=tags, chunk_scheme="IOB",
                    num_chunk_types=2)[3:])
            fetches.append(pred)
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    main.random_seed = startup.random_seed = 7
    return main, startup, fetches


def ragged_batches(net, steps=3, batch=8, seed=5):
    """`steps` global batches of `net`'s ragged feeds, as numpy: per
    step the flat ids, the sequence lengths (2..12 tokens) and the dense
    labels (the token net's tags in the ids' flat layout)."""
    rs = np.random.RandomState(seed)
    out = {}
    for k in range(steps):
        lengths = rs.randint(2, RAGGED_MAX_LEN + 1, batch).astype(np.int32)
        out[f"lengths{k}"] = lengths
        out[f"words{k}"] = rs.randint(0, RAGGED_VOCAB,
                                      (int(lengths.sum()), 1)).astype(np.int64)
        out[f"label{k}"] = rs.randint(0, 2, (batch, 1)).astype(np.int64)
        out[f"tags{k}"] = rs.randint(0, RAGGED_TAGS,
                                     (int(lengths.sum()), 1)).astype(np.int64)
    return out


def ragged_fetch(steps):
    """{"offsets<k>", "rows<k>"}: each step's fetched LoDTensor as its
    offsets and its real rows (the padding tail dropped)."""
    out = {}
    for k, t in enumerate(steps):
        offsets = np.asarray(t.lod()[-1])
        out[f"offsets{k}"] = offsets
        out[f"rows{k}"] = np.asarray(t)[:offsets[-1]]
    return out


def ragged_feed(fluid, net, data, k, bucket=64):
    """Step k's feed dict: the ragged feeds bucket-padded to a multiple of
    `bucket` tokens (create_bucketed_seq_tensor), the labels dense."""
    lengths = np.asarray(data[f"lengths{k}"])
    offs = np.concatenate([[0], np.cumsum(lengths)])

    def seqs(name):
        flat = np.asarray(data[f"{name}{k}"])
        return [flat[offs[i]:offs[i + 1], 0] for i in range(len(lengths))]

    feed = {"words": fluid.create_bucketed_seq_tensor(seqs("words"), bucket)}
    if net == "lstm":
        feed["label"] = np.asarray(data[f"label{k}"])
    else:
        feed["tags"] = fluid.create_bucketed_seq_tensor(seqs("tags"), bucket)
    return feed


def collective_inputs(seed, rank):
    """This rank's inputs to the collective ops: x [8, 3] (all_reduce,
    all_gather, broadcast; reduce_scatter over dim 0), the cotangent c of
    an all_reduce, and g [5, 3], which the zero1 ops lay out in rows."""
    rs = np.random.RandomState(seed * 100 + rank)
    return {"x": rs.randn(8, 3).astype(np.float32),
            "c": rs.randn(8, 3).astype(np.float32),
            "g": rs.randn(5, 3).astype(np.float32)}


def collective_cotangents(seed, rank, world):
    """This rank's cotangents of all_gather's [world, 8, 3], reduce_scatter's
    [8 / world, 3] and broadcast's [8, 3] outputs."""
    c = collective_inputs(seed, rank)["c"]
    return {"all_gather": np.stack([c * (s + 1) for s in range(world)]),
            "reduce_scatter": c[:8 // world], "broadcast": c}


def _collectives(case, mesh, cuda):
    import torch
    from paddle_tpu_torch import CPUPlace, CUDAPlace
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.core.executor_core import OpContext

    ctx = OpContext(CUDAPlace(mesh.rank) if cuda else CPUPlace(), dp=mesh)
    inp = {k: torch.from_numpy(v).to(ctx.device) for k, v in
           collective_inputs(case["seed"], mesh.rank).items()}

    def run(op_type, ins, **attrs):
        return registry.run_kernel(registry.lookup(op_type), ctx, ins, attrs)

    res = {}
    for red in ("sum", "mean", "max", "min"):
        res[f"all_reduce_{red}"] = run("all_reduce", {"X": [inp["x"]]},
                                       reduction=red)["Out"][0]
    for red in ("sum", "mean"):
        res[f"all_reduce_{red}_grad"] = run(
            "all_reduce_grad", {"X": [inp["x"]], "Out@GRAD": [inp["c"]]},
            reduction=red)["X@GRAD"][0]
    res["all_gather"] = run("all_gather", {"X": [inp["x"]]})["Out"][0]
    res["reduce_scatter"] = run("reduce_scatter",
                                {"X": [inp["x"]]})["Out"][0]
    res["broadcast"] = run("broadcast", {"X": [inp["x"]]},
                           root=mesh.size - 1)["Out"][0]
    # the grads of the other three, with cotangents shaped like their
    # outputs (collective_cotangents)
    cot = {k: torch.from_numpy(v).to(ctx.device) for k, v in
           collective_cotangents(case["seed"], mesh.rank, mesh.size).items()}
    for op_type, attrs in (("all_gather", {}), ("reduce_scatter", {}),
                           ("broadcast", {"root": mesh.size - 1})):
        res[f"{op_type}_grad"] = run(
            f"{op_type}_grad", {"X": [inp["x"]], "Out@GRAD": [cot[op_type]]},
            **attrs)["X@GRAD"][0]
    parts = mesh.size
    res["zero1_scatter_reduce"] = run(
        "zero1_scatter", {"X": [inp["g"]]}, parts=parts, reduce=True,
        scale=0.5)["Out"][0]
    res["zero1_scatter"] = run("zero1_scatter", {"X": [inp["g"]]},
                               parts=parts)["Out"][0]
    res["zero1_gather"] = run(
        "zero1_gather", {"X": [res["zero1_scatter"]]}, numel=15,
        shape=[5, 3])["Out"][0]
    return {k: v.cpu().numpy() for k, v in res.items()}


def _pe(case, mesh, cuda):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert, flags
    from paddle_tpu_torch.parallel import zero1

    zero1.reset_registry()
    place = fluid.CUDAPlace(mesh.rank) if cuda else fluid.CPUPlace()
    main, _, loss, probs = build(fluid, case["net"], case["opt"])
    init = dict(np.load(case["init"]))
    data = np.load(case["data"])
    xs, ys = data["x"], data["y"]
    scope = fluid.Scope()
    convert.load_numpy_state(scope, main, init, place)
    bs = fluid.BuildStrategy()
    bs.sharded_weight_update = case["zero1"]
    if case.get("reduce_strategy"):
        bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
    if case["gss"] == "one":
        bs.gradient_scale_strategy = \
            fluid.BuildStrategy.GradientScaleStrategy.One
    fetch = [loss, probs] if case.get("fetch_batch") else [loss]
    instruments = {}
    if case.get("monitor"):
        instruments = {"monitor_replica_skew": True, "monitor_journal":
                       os.path.join(case["monitor"],
                                    f"{case['name']}.{mesh.rank}.jsonl")}
    if case.get("overlap"):
        instruments["overlap_plan"] = True
        instruments["overlap_bucket_bytes"] = case["overlap"]
    with fluid.scope_guard(scope), \
            flags.flag_guard(fuse=case["fuse"], **instruments):
        pe = fluid.ParallelExecutor(use_cuda=cuda, loss_name=loss.name,
                                    main_program=main, build_strategy=bs)
        if case.get("iters"):
            outs = pe.run(fetch, feed={"img": xs, "label": ys},
                          iters=len(xs))
            losses = outs[0].reshape(-1)
        else:
            async_fetch = bool(case.get("async_fetch"))
            steps = [pe.run(fetch, feed={"img": x, "label": y},
                            async_fetch=async_fetch)
                     for x, y in zip(xs, ys)]
            if async_fetch:
                steps = [[f.result() for f in s] for s in steps]
            losses = np.concatenate([s[0].reshape(-1) for s in steps])
            outs = steps[-1]
        state = convert.numpy_state(scope, main)
        shapes = {n: tuple(scope.find_var(n).shape) for n in state}
        run_ops = [op.type for op in pe._last_program.global_block().ops]
        buckets = [b for _, plan, _ in pe._exe._prepared.values()
                   if plan is not None for b in plan.buckets]
    res = {"losses": losses, **{f"state/{n}": v for n, v in state.items()}}
    res.update({f"shape/{n}": np.asarray(s, np.int64)
                for n, s in shapes.items()})
    res["n_all_reduce"] = np.asarray(run_ops.count("all_reduce"))
    res["n_zero1_scatter"] = np.asarray(run_ops.count("zero1_scatter"))
    # the scatters the overlap schedule hoisted, and the run's op order
    res["n_overlap_async"] = np.asarray(sum(
        bool(op.attrs.get("overlap_async"))
        for op in pe._last_program.global_block().ops))
    res["op_order"] = np.asarray(run_ops)
    # the fused update buckets (FLAGS_fuse): members, and shard_rows (1
    # for a zero1 bucket of [1, shard] rows)
    res["bucket_members"] = np.asarray([b["n"] for b in buckets], np.int64)
    res["bucket_shard_rows"] = np.asarray([b["shard_rows"] for b in buckets],
                                          np.int64)
    res["step_mode"] = np.asarray(pe.step_mode())
    if case.get("fetch_batch"):
        res["probs"] = outs[1]
    if case.get("profile"):
        with fluid.scope_guard(scope), \
                flags.flag_guard(fuse=case["fuse"], **instruments):
            res.update(_overlap(lambda: pe.run(fetch, feed={
                "img": xs[0], "label": ys[0]}),
                f"{case['profile']}.{mesh.rank}"))
    if case.get("monitor"):
        from paddle_tpu_torch import monitor

        snap = monitor.registry().snapshot()
        res["skew_gauge"] = np.asarray(
            snap["replica_skew_max_over_median"])
        res["replica_gauges"] = np.asarray(sorted(
            int(k.split('"')[1]) for k in snap
            if k.startswith("replica_step_ms{")))
        monitor.reset()
    if case.get("save"):
        res.update(_save_and_load(fluid, place, scope, main,
                                  os.path.join(case["save"], str(mesh.rank))))
    if case.get("checkpoint"):
        from paddle_tpu_torch.resilience import CheckpointManager

        mgr = CheckpointManager(
            os.path.join(case["checkpoint"], str(mesh.rank)),
            async_write=False)
        try:
            mgr.save(len(xs), scope=scope, program=main)
        finally:
            mgr.close()
    return res


def _overlap(step, trace_path):
    """One `step` under torch.profiler (CUDA kernels), its chrome trace
    written to `trace_path`: the NCCL reduce-scatter kernels' count and
    microseconds, and the microseconds of them during which a kernel on
    another stream ran (the backward the hoisted scatters overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [(e["ts"], e["ts"] + e["dur"], e.get("args", {}).get("stream"),
                e["name"]) for e in events
               if e.get("cat") == "kernel" and "dur" in e]
    rs = [k for k in kernels if "ReduceScatter" in k[3]]
    other = [k for k in kernels if "nccl" not in k[3].lower()]
    overlapped = 0.0
    for a0, a1, stream, _ in rs:
        spans = sorted((max(a0, b0), min(a1, b1)) for b0, b1, s, _ in other
                       if s != stream and b0 < a1 and b1 > a0)
        covered, end = 0.0, a0
        for lo, hi in spans:
            lo = max(lo, end)
            if hi > lo:
                covered += hi - lo
                end = hi
        overlapped += covered
    return {"n_kernels": np.asarray(len(kernels)),
            "n_rs_kernels": np.asarray(len(rs)),
            "rs_us": np.asarray(sum(b - a for a, b, _, _ in rs)),
            "rs_overlapped_us": np.asarray(overlapped),
            "rs_streams": np.asarray(sorted({str(k[2]) for k in rs})),
            "other_streams": np.asarray(sorted({str(k[2]) for k in other}))}


def _pipeline(case, mesh, cuda):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert, flags
    from paddle_tpu_torch.parallel import zero1
    from paddle_tpu_torch.parallel.pipeline import PipelineRunner

    zero1.reset_registry()
    place = fluid.CUDAPlace(mesh.rank) if cuda else fluid.CPUPlace()
    main, _, loss, probs = build(fluid, case["net"], case["opt"])
    data = np.load(case["data"])
    scope = fluid.Scope()
    convert.load_numpy_state(scope, main, dict(np.load(case["init"])),
                             place)
    bs = fluid.BuildStrategy()
    bs.sharded_weight_update = case["zero1"]
    fetches = [probs.name] if case.get("fetch_probs") else None
    with fluid.scope_guard(scope), flags.flag_guard(fuse=case["fuse"]):
        pe = fluid.ParallelExecutor(use_cuda=cuda, loss_name=loss.name,
                                    main_program=main, build_strategy=bs)
        runner = PipelineRunner(
            main, case["stages"], loss_name=loss.name,
            feed_names=["img", "label"],
            n_microbatches=case["microbatches"], fetch_names=fetches,
            scope=scope, parallel_executor=pe)
        reports = [runner.run({"img": x, "label": y})
                   for x, y in zip(data["x"], data["y"])]
        state = convert.numpy_state(scope, main)
    res = {"losses": np.concatenate([np.reshape(r["loss"], -1)
                                     for r in reports])}
    if fetches:
        res["probs"] = reports[-1]["fetches"][probs.name]
    res.update({f"state/{n}": v for n, v in state.items()})
    return res


def _ragged(case, mesh, cuda):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert, flags

    place = fluid.CUDAPlace(mesh.rank) if cuda else fluid.CPUPlace()
    main, _, fetches = build_ragged(fluid, case["net"])
    data = np.load(case["data"])
    steps = len([k for k in data if k.startswith("lengths")])
    scope = fluid.Scope()
    convert.load_numpy_state(scope, main, dict(np.load(case["init"])),
                             place)
    feeds = [ragged_feed(fluid, case["net"], data, k) for k in range(steps)]
    n_dense = len(fetches) - (case["net"] != "lstm")
    with fluid.scope_guard(scope), flags.flag_guard(fuse=True):
        pe = fluid.ParallelExecutor(use_cuda=cuda, loss_name=fetches[0].name,
                                    main_program=main)
        if case.get("iters"):
            runs = pe.run(fetches, feed=feeds, iters=steps)
            outs = [np.asarray(o).reshape(steps, -1)
                    for o in runs[:n_dense]]
            ragged = runs[n_dense] if n_dense < len(fetches) else []
        else:
            runs = [pe.run(fetches, feed=f) for f in feeds]
            outs = [np.stack([np.asarray(r[i]).reshape(-1) for r in runs])
                    for i in range(n_dense)]
            ragged = [r[n_dense] for r in runs] \
                if n_dense < len(fetches) else []
        state = convert.numpy_state(scope, main)
    res = {f"fetch{i}": o for i, o in enumerate(outs)}
    res.update(ragged_fetch(ragged))
    res["losses"] = outs[0].reshape(-1)
    res.update({f"state/{n}": v for n, v in state.items()})
    return res


def _datapipe(case, mesh, cuda):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert, datapipe, flags, monitor

    place = fluid.CUDAPlace(mesh.rank) if cuda else fluid.CPUPlace()
    main, _, loss, _ = build(fluid, case["net"], case["opt"])
    init = dict(np.load(case["init"]))
    data = np.load(case["data"])
    xs, ys = data["x"], data["y"]
    k = case["chunk"]
    res = {}
    for how in ("pipe", "dict"):
        scope = fluid.Scope()
        convert.load_numpy_state(scope, main, init, place)
        with fluid.scope_guard(scope), \
                flags.flag_guard(fuse=True, monitor=True):
            pe = fluid.ParallelExecutor(use_cuda=cuda, loss_name=loss.name,
                                        main_program=main)
            if how == "pipe":
                samples = [{"img": x, "label": y} for bx, by in zip(xs, ys)
                           for x, y in zip(bx, by)]
                pipe = (datapipe.DataPipe.from_reader(lambda: iter(samples))
                        .batch(xs.shape[1])
                        .prefetch_to_device(place=place, chunk=k,
                                            capacity=2))
                outs = [pe.run([loss], feed=pipe)[0]
                        for _ in range(len(xs) // k)]
                pipe.close()
                last = monitor.last_step()
                res["pipe/feed_wait_ms"] = np.asarray(
                    last["phases_ms"].get("feed_wait", -1.0))
                res["pipe/has_datapipe_stats"] = np.asarray(
                    "datapipe" in last)
            else:
                outs = [pe.run([loss], feed={"img": xs[i:i + k],
                                             "label": ys[i:i + k]},
                               iters=k)[0]
                        for i in range(0, len(xs) - len(xs) % k, k)]
            res[f"{how}/losses"] = np.concatenate(
                [np.reshape(o, -1) for o in outs])
            res.update({f"{how}/state/{n}": v for n, v in
                        convert.numpy_state(scope, main).items()})
    return res


KINDS = {"collectives": "_collectives", "pe": "_pe",
         "pipeline": "_pipeline", "ragged": "_ragged",
         "datapipe": "_datapipe"}


def _save_and_load(fluid, place, scope, main, dirname):
    """fluid.io.save_persistables of `main` from `scope` into `dirname`
    (every rank takes part in the zero1 gathers), then
    fluid.io.load_persistables of it into a fresh scope: for each zero1
    accumulator, the row this rank held (`row/<name>`) and the one the
    load gave it (`loaded/<name>`)."""
    from paddle_tpu_torch.parallel import zero1

    exe = fluid.Executor(place)
    with fluid.scope_guard(scope):
        fluid.io.save_persistables(exe, dirname, main)
    fresh = fluid.Scope()
    with fluid.scope_guard(fresh):
        fluid.io.load_persistables(exe, dirname, main)
    res = {}
    for n in sorted(main.global_block().vars):
        if zero1.registered_entry(n) is not None:
            res[f"row/{n}"] = scope.find_var(n).cpu().numpy()
            res[f"loaded/{n}"] = fresh.find_var(n).cpu().numpy()
    return res


def launch(world, cases, tmp_dir, timeout=120, cuda=False):
    """Run `cases` on `world` ranks, one process each (on the host, or
    with `cuda` one card each), rendezvousing through a file in
    `tmp_dir`; returns {case name: [rank 0's results, ...]}. Every rank is
    killed once `timeout` seconds have passed (15 s before, a rank still
    running prints every thread's stack and exits), and a rank that fails
    or is killed fails the call with its output."""
    os.makedirs(tmp_dir, exist_ok=True)
    spec = {"world": world, "out": tmp_dir, "cases": cases, "cuda": cuda,
            "rendezvous": os.path.join(tmp_dir, f"rendezvous.{world}")}
    spec_path = os.path.join(tmp_dir, f"spec.{world}.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
               RANK_HANG_DUMP_S=str(max(timeout - 15, 5)))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), spec_path, str(r)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {world} exited "
                               f"{p.returncode}:\n{log}")
    return {c["name"]: [dict(np.load(os.path.join(
        tmp_dir, f"{c['name']}.{r}.npz"))) for r in range(world)]
        for c in cases}


def main(spec_path, rank):
    import torch

    torch.set_num_threads(1)
    if os.environ.get("RANK_HANG_DUMP_S"):
        # a rank that hangs prints every thread's stack and exits before
        # the launcher's kill
        faulthandler.dump_traceback_later(
            float(os.environ["RANK_HANG_DUMP_S"]), exit=True)
    from paddle_tpu_torch.parallel import distributed, mesh as pmesh

    with open(spec_path) as f:
        spec = json.load(f)
    cuda = spec["cuda"]
    if cuda:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    distributed.initialize("file://" + spec["rendezvous"], spec["world"],
                           rank, local_device_ids=[rank] if cuda else None)
    mesh = pmesh.make_mesh()
    for case in spec["cases"]:
        res = globals()[KINDS[case["kind"]]](case, mesh, cuda)
        np.savez(os.path.join(spec["out"], f"{case['name']}.{rank}.npz"),
                 **res)
    # the executors (and their captured graphs) go before the group
    gc.collect()
    distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
