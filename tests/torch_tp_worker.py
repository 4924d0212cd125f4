"""One rank of a multi-process run of paddle_tpu_torch's tensor
parallelism on the host (gloo), and the nets the tests hold it to.

    python tests/torch_tp_worker.py SPEC.json RANK

SPEC.json holds {"world": W, "mesh": {"dp": D, "mp": M}, "rendezvous":
<path of a file that does not exist yet>, "out": <dir>, "cuda": bool,
"cases": [...]}. The rank joins a W-rank gloo group through
`parallel.distributed.initialize("file://...")` — on the host, or with
"cuda" as a card rank on card 0 (ranks sharing the card; TF32 off), or
with "nccl" too an NCCL group of one card a rank (card = rank) —
runs every case in order and writes `<out>/<case name>.<rank>.npz`. A
case (with "amp": bf16 AMP on) is
  {"kind": "pe", "name", "net", "opt", "auto", "reduce", "data", "init",
   "fetch_grads", "fuse"}: the net of `build` with its set_sharding seeds,
    from the state in the `init` npz, ParallelExecutor(mesh_shape=mesh)
    over the global batches of the `data` npz (one run a step),
    BuildStrategy auto_sharding `auto`, with `reduce` BuildStrategy.Reduce
    and with `fuse` FLAGS_fuse (`bucket_numels`: the fused update
    buckets' element counts). Results:
    the losses, each step's fetched gradients of the seeded weights
    (`grad/<name>` [steps, ...], whole), the full-layout state
    (convert.numpy_state), each persistable's shape in the scope (the
    rank's), the lowered program's op types, its collectives by kind
    (`coll/<kind>`: [count, bytes]), the plan's digest and the
    autoshard gauges; with "restore": <dir>, the state restored from
    that checkpoint first (resilience.CheckpointManager); with "save":
    <dir>, a checkpoint of the state after the steps into <dir>/<rank>
    (every rank takes part in the gathers);
  {"kind": "embedding", "name", "seed", "table", "zipf"}:
    parallel.sharded_embedding_lookup of a [64, 16] table (numpy, from the
    seed; "table": [V, D]) at [4, 7] ids (or "zipf": that many ids drawn
    Zipf(1.7), and beside it F.embedding's rows and its gradient summed
    in f32, in the table's dtype), and the table's gradient for a seeded
    cotangent;
  {"kind": "shard_ops", "name", "seed"}: the lowering's ops (shard_gather,
    shard_slice, all_reduce over mp) on this rank's seeded inputs.
This module imports paddle_tpu_torch and nothing of the JAX package; the
tests import `build` to make the same nets on the JAX side, and `launch`
to run the ranks.
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
    "sgd": lambda fluid: fluid.optimizer.SGD(learning_rate=0.1),
    "adam": lambda fluid: fluid.optimizer.Adam(learning_rate=0.01),
    "momentum": lambda fluid: fluid.optimizer.Momentum(learning_rate=0.05,
                                                       momentum=0.9),
}
CLASSES = 4
# each net's feeds: name -> (shape of one sample, dtype, high for ints)
FEEDS = {
    "mlp": {"x": ([16], "float32", None), "label": ([1], "int64", CLASSES)},
    "mlp_dropout": {"x": ([16], "float32", None),
                    "label": ([1], "int64", CLASSES)},
    "mixed": {"ids": ([1], "int64", 32), "img": ([1, 8, 8], "float32", None),
              "y": ([1], "float32", None)},
    "conv_mp": {"img": ([3, 8, 8], "float32", None),
                "label": ([1], "int64", CLASSES)},
    "vgg_head": {"img": ([3, 8, 8], "float32", None),
                 "label": ([1], "int64", CLASSES)},
}
# the seeded weights of each net: name -> spec
SEEDS = {
    "mlp": {"w1": (None, "mp"), "w2": ("mp", None)},
    "mlp_dropout": {"w1": (None, "mp"), "w2": ("mp", None)},
    "mixed": {"emb_w": ("mp", None), "fc_w1": (None, "mp")},
    "conv_mp": {"cw": ("mp", None, None, None)},
    "vgg_head": {"fc1_w": (None, "mp"), "fc2_w": ("mp", None)},
}


def _mlp(fluid, L, dropout):
    x = L.data(name="x", shape=[16], dtype="float32")
    label = L.data(name="label", shape=[1], dtype="int64")
    h = L.fc(input=x, size=32, act="relu",
             param_attr=fluid.ParamAttr(name="w1"))
    if dropout:
        h = L.dropout(h, dropout_prob=0.5)
    probs = L.fc(input=h, size=CLASSES, act="softmax",
                 param_attr=fluid.ParamAttr(name="w2"))
    return L.mean(L.cross_entropy(input=probs, label=label))


def _mixed(fluid, L):
    """tests/test_autoshard.py's mixed net: an embedding branch and a conv
    branch merged through fc."""
    ids = L.data(name="ids", shape=[1], dtype="int64")
    img = L.data(name="img", shape=[1, 8, 8], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="float32")
    emb = L.embedding(ids, size=[32, 16],
                      param_attr=fluid.ParamAttr(name="emb_w"))
    conv = L.conv2d(img, num_filters=4, filter_size=3, act="relu")
    cflat = L.reshape(conv, shape=[-1, 4 * 6 * 6], inplace=False)
    cfeat = L.fc(input=cflat, size=16)
    h = L.fc(input=[emb, cfeat], size=32, act="relu",
             param_attr=fluid.ParamAttr(name="fc_w1"))
    p = L.fc(input=h, size=1)
    return L.mean(L.square_error_cost(input=p, label=y))


def _conv_mp(fluid, L):
    """A Cout-sharded conv: conv2d(8, 3x3, pad 1) on a filter seeded
    (mp, None, None, None), batch_norm(relu) over the sharded channels,
    a 2x2 max pool and fc(4, softmax)."""
    img = L.data(name="img", shape=[3, 8, 8], dtype="float32")
    label = L.data(name="label", shape=[1], dtype="int64")
    conv = L.conv2d(img, 8, 3, padding=1,
                    param_attr=fluid.ParamAttr(name="cw"))
    h = L.pool2d(L.batch_norm(conv, act="relu"), 2, pool_stride=2)
    probs = L.fc(input=h, size=CLASSES, act="softmax")
    return L.mean(L.cross_entropy(input=probs, label=label))


def _vgg_head(fluid, L):
    """VGG-16's layers at narrow widths (models/vgg.py): one conv block
    (two conv-bn-relu, dropout after the first, a 2x2 max pool), dropout,
    then its head — fc1 (weight seeded (None, mp)), batch norm (relu),
    dropout, fc2 (weight seeded (mp, None)) — and the softmax fc."""
    img = L.data(name="img", shape=[3, 8, 8], dtype="float32")
    label = L.data(name="label", shape=[1], dtype="int64")
    conv = fluid.nets.img_conv_group(
        input=img, pool_size=2, pool_stride=2, conv_num_filter=[8, 8],
        conv_filter_size=3, conv_act="relu", conv_with_batchnorm=True,
        conv_batchnorm_drop_rate=[0.3, 0], pool_type="max")
    drop = L.dropout(x=conv, dropout_prob=0.5)
    fc1 = L.fc(input=drop, size=32, act=None,
               param_attr=fluid.ParamAttr(name="fc1_w"))
    bn = L.batch_norm(input=fc1, act="relu")
    drop2 = L.dropout(x=bn, dropout_prob=0.5)
    fc2 = L.fc(input=drop2, size=32, act=None,
               param_attr=fluid.ParamAttr(name="fc2_w"))
    probs = L.fc(input=fc2, size=CLASSES, act="softmax")
    return L.mean(L.cross_entropy(input=probs, label=label))


def build(fluid, net, opt, seeds=True):
    """(main, startup, loss) of `net` with optimizer `opt` and, with
    `seeds`, its set_sharding seeds (SEEDS), under a fresh
    unique_name.guard so both packages name every var alike."""
    main, startup = fluid.Program(), fluid.Program()
    L = fluid.layers
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        if net in ("mlp", "mlp_dropout"):
            loss = _mlp(fluid, L, net == "mlp_dropout")
        elif net == "mixed":
            loss = _mixed(fluid, L)
        elif net == "conv_mp":
            loss = _conv_mp(fluid, L)
        else:
            loss = _vgg_head(fluid, L)
        OPTIMIZERS[opt](fluid).minimize(loss)
        if seeds:
            gb = main.global_block()
            for name, spec in SEEDS[net].items():
                fluid.parallel.set_sharding(gb.var(name), spec)
    main.random_seed = startup.random_seed = 7
    return main, startup, loss


def batches(net, steps, batch, seed=11):
    """{feed name: [steps, batch, ...]} drawn by numpy from `seed`."""
    rs = np.random.RandomState(seed)
    out = {}
    for name, (shape, dtype, high) in FEEDS[net].items():
        if high is not None:
            out[name] = rs.randint(0, high, (steps, batch, *shape)).astype(
                dtype)
        else:
            out[name] = rs.randn(steps, batch, *shape).astype(dtype)
    return out


def _place(fluid, case):
    return fluid.CUDAPlace(case.get("card", 0)) if case.get("cuda") \
        else fluid.CPUPlace()


def _pe(case, mesh, rank):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, convert, flags, monitor
    from paddle_tpu_torch.parallel import autoshard, zero1
    from paddle_tpu_torch.resilience import CheckpointManager

    zero1.reset_registry()
    autoshard.reset_registry()
    main, _, loss = build(fluid, case["net"], case["opt"])
    init = dict(np.load(case["init"]))
    data = dict(np.load(case["data"]))
    steps = next(iter(data.values())).shape[0]
    scope = fluid.Scope()
    place = _place(fluid, case)
    convert.load_numpy_state(scope, main, init, place)
    if case.get("restore"):
        cm = CheckpointManager(case["restore"], async_write=False)
        cm.restore(scope=scope, program=main, place=place)
        cm.close()
    bs = fluid.BuildStrategy()
    bs.auto_sharding = case["auto"]
    if case.get("reduce"):
        bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
    grads = [g for g in (case.get("fetch_grads") or [])]
    res = {}
    monitor.reset()
    if case.get("amp"):
        amp.enable("bfloat16")
    with fluid.scope_guard(scope), \
            flags.flag_guard(fuse=bool(case.get("fuse"))):
        pe = fluid.ParallelExecutor(use_cuda=bool(case.get("cuda")),
                                    loss_name=loss.name,
                                    main_program=main, build_strategy=bs,
                                    mesh_shape=case["mesh"])
        losses, fetched = [], {g: [] for g in grads}
        for k in range(steps):
            outs = pe.run([loss] + [g + "@GRAD" for g in grads],
                          feed={n: v[k] for n, v in data.items()},
                          return_numpy=False)
            outs = [o.float().cpu().numpy() for o in outs]
            losses.append(float(outs[0].reshape(-1)[0]))
            for g, v in zip(grads, outs[1:]):
                fetched[g].append(v)
        state = {n: v.astype(np.float32) if v.dtype.kind == "f" else v
                 for n, v in convert.numpy_state(scope, main).items()}
        res["adam_launches"] = np.asarray(_adam_launches())
        shapes = {n: tuple(scope.find_var(n).shape) for n in state}
        prep = next(iter(pe._rewrite_cache.values()))
        buckets = [b for _, plan, _ in pe._exe._prepared.values()
                   if plan is not None for b in plan.buckets]
        if case.get("save"):
            # every rank saves (the snapshot's gathers are collectives),
            # each into <save>/<rank>
            cm = CheckpointManager(os.path.join(case["save"], str(rank)),
                                   async_write=False)
            try:
                cm.save(steps, scope=scope, program=main, block=True)
            finally:
                cm.close()
    res["losses"] = np.asarray(losses)
    for g, vs in fetched.items():
        res[f"grad/{g}"] = np.stack(vs)
    res.update({f"state/{n}": v for n, v in state.items()})
    res.update({f"shape/{n}": np.asarray(s, np.int64)
                for n, s in shapes.items()})
    res["bucket_numels"] = np.asarray([b["numel"] for b in buckets],
                                      np.int64)
    res["step_mode"] = np.asarray(pe.step_mode())
    res["ops"] = np.asarray([op.type for op in
                             pe._last_program.global_block().ops])
    if prep.lowering is not None:
        for kind, (n, b) in prep.lowering.collective_counts().items():
            res[f"coll/{kind}"] = np.asarray([n, b], np.int64)
        res["modes"] = np.asarray(json.dumps(prep.lowering.modes))
    if prep.aplan is not None:
        res["digest"] = np.asarray(prep.aplan.digest())
        res["describe"] = np.asarray(json.dumps(prep.aplan.describe(),
                                                default=list))
    if case.get("amp"):
        amp.disable()
    snap = monitor.registry().snapshot()
    for k in ("autoshard_plan_vars", "autoshard_plan_sharded_vars",
              "autoshard_unresolved_vars", "autoshard_conflicts_resolved"):
        if k in snap:
            res[f"gauge/{k}"] = np.asarray(snap[k])
    return res


def _adam_launches():
    from paddle_tpu_torch.fusion import kernels as fk

    return fk.adam_bucket.launches


def _embedding(case, mesh, rank):
    """The table (f32, or with "cuda" bf16 on the card) and its ids and
    cotangent from the seed; with "zipf": ids drawn Zipf(1.7) and a
    cotangent of multiples of 1/8, and F.embedding's rows and gradient
    beside the sharded ones."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.parallel import (shard_table,
                                           sharded_embedding_lookup)

    rs = np.random.RandomState(case["seed"])
    vocab, width = case.get("table", (64, 16))
    dev = "cuda" if case.get("cuda") else "cpu"
    dtype = torch.bfloat16 if case.get("cuda") else torch.float32
    table = torch.from_numpy(rs.randn(vocab, width).astype(np.float32))
    if case.get("zipf"):
        ids = (rs.zipf(1.7, case["zipf"]) - 1) % vocab
        cot = rs.randint(-8, 9, (len(ids), width)).astype(np.float32) / 8
    else:
        ids = rs.randint(0, vocab, size=(4, 7)).astype(np.int32)
        cot = rs.randn(4, 7, width).astype(np.float32)
    table = table.to(dev, dtype)
    ids = torch.from_numpy(ids).to(dev)
    cot = torch.from_numpy(cot).to(dev, dtype)
    shard = shard_table(table, mesh).requires_grad_(True)
    rows = sharded_embedding_lookup(shard, ids, mesh)
    rows.backward(cot)
    out = {"rows": rows.detach().float().cpu().numpy(),
           "shard": shard.detach().float().cpu().numpy(),
           "shard_grad": shard.grad.float().cpu().numpy()}
    if case.get("zipf"):
        dense = table.clone().requires_grad_(True)
        want = F.embedding(ids, dense)
        exact = table.float().requires_grad_(True)
        F.embedding(ids, exact).backward(cot.float())
        out["dense_rows"] = want.detach().float().cpu().numpy()
        # the dense gradient summed in f32, in the table's dtype
        out["dense_grad"] = exact.grad.to(dtype).float().cpu().numpy()
    return out


def _shard_ops(case, mesh, rank):
    import torch

    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.core.executor_core import OpContext

    import paddle_tpu_torch as fluid

    ctx = OpContext(_place(fluid, case), dp=mesh)
    rs = np.random.RandomState(case["seed"] * 100 + rank)
    x = torch.from_numpy(rs.randn(3, 4).astype(np.float32)).to(ctx.device)

    def run(op_type, ins, **attrs):
        return registry.run_kernel(registry.lookup(op_type), ctx, ins,
                                   attrs)["Out"][0].cpu().numpy()

    return {"x": x.cpu().numpy(),
            "gather0": run("shard_gather", {"X": [x]}, axis_name="mp",
                           dim=0, parts=mesh.shape["mp"]),
            "gather1": run("shard_gather", {"X": [x]}, axis_name="mp",
                           dim=1, parts=mesh.shape["mp"]),
            "slice1": run("shard_slice", {"X": [x]}, axis_name="mp", dim=1,
                          parts=mesh.shape["mp"]),
            "all_reduce_mp": run("all_reduce", {"X": [x]}, axis_name="mp",
                                 reduction="sum"),
            "all_reduce_dp": run("all_reduce", {"X": [x]},
                                 reduction="sum")}


def launch(world, mesh, cases, tmp_dir, timeout=240, cuda=False,
           nccl=False):
    """Run `cases` on `world` gloo ranks laid out as `mesh`, one process
    each, rendezvousing through a file in `tmp_dir`; returns {case name:
    [rank 0's results, ...]}. Every rank is killed once `timeout` seconds
    have passed (15 s before, a rank still running prints every thread's
    stack and exits), and a rank that fails or is killed fails the call
    with its output. `nccl` (with `cuda`): an NCCL group, card = rank."""
    os.makedirs(tmp_dir, exist_ok=True)
    tag = "x".join(f"{a}{n}" for a, n in mesh.items())
    spec = {"world": world, "mesh": mesh, "out": tmp_dir, "cases": cases,
            "cuda": cuda, "nccl": nccl,
            "rendezvous": os.path.join(tmp_dir, f"rendezvous.{tag}")}
    spec_path = os.path.join(tmp_dir, f"spec.{tag}.json")
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
    cuda = spec.get("cuda", False)
    nccl = cuda and spec.get("nccl", False)
    card = rank if nccl else 0
    if cuda:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize("file://" + spec["rendezvous"], spec["world"],
                           rank, local_device_ids=[card] if cuda else None,
                           backend=None if nccl else "gloo")
    mesh = pmesh.make_mesh(spec["mesh"])
    kinds = {"pe": _pe, "embedding": _embedding, "shard_ops": _shard_ops}
    for case in spec["cases"]:
        case = dict(case, mesh=spec["mesh"], cuda=cuda, card=card)
        res = kinds[case["kind"]](case, mesh, rank)
        np.savez(os.path.join(spec["out"], f"{case['name']}.{rank}.npz"),
                 **res)
    # the executors (and their captured graphs) go before the group
    gc.collect()
    distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
