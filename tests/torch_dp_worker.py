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
    (`_save_and_load`).
This module imports paddle_tpu_torch and nothing of the JAX package; the
tests import `build` and `collective_inputs` to make the same nets and
inputs on the JAX side, and `launch` to run the ranks.
"""

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
          "linear": [32]}
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
                the label is fed and unused)."""
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
    with fluid.scope_guard(scope), flags.flag_guard(fuse=case["fuse"]):
        pe = fluid.ParallelExecutor(use_cuda=cuda, loss_name=loss.name,
                                    main_program=main, build_strategy=bs)
        if case.get("iters"):
            outs = pe.run(fetch, feed={"img": xs, "label": ys},
                          iters=len(xs))
            losses = outs[0].reshape(-1)
        else:
            steps = [pe.run(fetch, feed={"img": x, "label": y})
                     for x, y in zip(xs, ys)]
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
    # the fused update buckets (FLAGS_fuse): members, and shard_rows (1
    # for a zero1 bucket of [1, shard] rows)
    res["bucket_members"] = np.asarray([b["n"] for b in buckets], np.int64)
    res["bucket_shard_rows"] = np.asarray([b["shard_rows"] for b in buckets],
                                          np.int64)
    if case.get("fetch_batch"):
        res["probs"] = outs[1]
    if case.get("save"):
        res.update(_save_and_load(fluid, place, scope, main,
                                  os.path.join(case["save"], str(mesh.rank))))
    return res


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
    killed once `timeout` seconds have passed, and a rank that fails or is
    killed fails the call with its output."""
    os.makedirs(tmp_dir, exist_ok=True)
    spec = {"world": world, "out": tmp_dir, "cases": cases, "cuda": cuda,
            "rendezvous": os.path.join(tmp_dir, f"rendezvous.{world}")}
    spec_path = os.path.join(tmp_dir, f"spec.{world}.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
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
        res = (_collectives if case["kind"] == "collectives" else _pe)(
            case, mesh, cuda)
        np.savez(os.path.join(spec["out"], f"{case['name']}.{rank}.npz"),
                 **res)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
