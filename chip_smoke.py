"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure is an uncaught exception and a non-zero exit:
  1. device   — a CUDA card must be present; print its name and power limit
  2. build    — build the port's kernels from paddle_tpu_torch/csrc
  3. plan     — build the ResNet-50 and README MLP training programs and
                their fusion plans
  4. kernels  — each hand-written kernel, through its wrapper, against its
                plain torch twin on the card, bitwise, at n in {1, 17, 1029,
                4194307} and at every bucket size of both plans; then timed
                (CUDA events, median of 25) over the buckets one step of its
                path updates, beside the plain twin, PyTorch's closest fused
                optimizer call, the bytes bound and the card's
                device-to-device copy rate
  5. resnet   — ResNet-50, NHWC 224x224x3, 1000 classes, batch 32, fp32,
                Momentum(0.01, 0.9), FLAGS_fuse=1, through Executor.run: 5
                single steps on one seeded batch, then one iters=4 call; the
                momentum kernel's launch count must cover every bucket of
                every step; one more step traced on the card alone gives the
                device idle share, and one traced with host ops the top-10
                of device time (full table in chiprun_out/resnet50_profile.txt)
  6. adam     — the README MLP (784-200-10) with Adam 1e-3 and FLAGS_fuse=1,
                30 steps on y = argmax(x @ W); the adam kernel must run
  7. parity   — a small ResNet trained 2 steps on the card and on the host
                from the same weights must agree
Then one JSON line of per-kernel numbers, and as the last line
{"ok": true, "device": {...}}.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data-sheet rates (dense, full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

SEED = 20261016
BATCH = 32
SIZES = (1, 17, 1029, 4194307)
OUT_DIR = "chiprun_out"  # long reports (gitignored)


def log(msg):
    print(msg, flush=True)


def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False — this "
                 "script measures the port on a CUDA card and has no host "
                 "fallback")
    # fp32 means fp32: no TF32 in cuDNN convolutions or cuBLAS products
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; tf32 off")
    return smi


def phase_build():
    from paddle_tpu_torch import cuda_build
    from paddle_tpu_torch.fusion import kernels

    kernels._library()
    log(f"[build] fused_update.cu + fused_update_binding.cpp "
        f"(torch.utils.cpp_extension.load): "
        f"{cuda_build.BUILT['fused_update']:.2f} s")


def build_resnet50():
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import fusion
    from paddle_tpu_torch.models.resnet import resnet_imagenet

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="data", shape=[224, 224, 3],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(
            input=resnet_imagenet(img, 1000, depth=50, layout="NHWC"),
            label=label))
        fluid.optimizer.Momentum(learning_rate=0.01,
                                 momentum=0.9).minimize(loss)
    main.random_seed = startup.random_seed = SEED
    _, plan = fusion.apply(main, feed_names=["data", "label"],
                           fetch_names=[loss.name])
    buckets = [b for b in plan.buckets if b["opt"] == "momentum"]
    log(f"[plan] ResNet-50: {len(buckets)} fused momentum buckets of "
        f"{[b['n'] for b in buckets]} params, numel "
        f"{[b['numel'] for b in buckets]}; ops {plan.n_ops_before} -> "
        f"{plan.n_ops_after}")
    return main, startup, loss, buckets


def _time_ms(fn, reps=25):
    """Median of `reps` CUDA-event timings of fn(), after 3 warm-ups."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _lanes(n, k, gen):
    """k standard-normal f32 lanes of n on the card."""
    return [torch.randn(n, generator=gen, device="cuda") for _ in range(k)]


def _bitwise(name, got, want, err, what):
    for a, b in zip(got, want):
        err[name] = max(err[name], (a - b).abs().max().item())
        if not torch.equal(a, b):
            raise AssertionError(f"{name} {what}: kernel differs from the "
                                 f"plain twin")


def _step_lanes(numels, k, gen):
    """k lanes per bucket, one list of buckets per lane kind."""
    sets = [_lanes(n, k, gen) for n in numels]
    return [list(kind) for kind in zip(*sets)]


def phase_kernels(momentum_numels, adam_numels):
    """Each kernel against its plain twin at the fixed sizes and at every
    bucket size of the two paths' fusion plans, then each timed over the
    buckets one step of its path updates."""
    from paddle_tpu_torch.fusion import kernels as fk

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    lr = torch.full((), 0.01, device="cuda")
    lr_t = torch.full((), 3.3e-4, device="cuda")
    err = {"momentum_bucket": 0.0, "adam_bucket": 0.0}
    sizes = sorted(set(SIZES) | set(momentum_numels) | set(adam_numels))
    for n in sizes:
        p, g, v = _lanes(n, 3, gen)
        for nesterov in (False, True):
            _bitwise("momentum_bucket",
                     fk.momentum_bucket(p, g, v, lr, 0.9, nesterov),
                     fk.momentum_bucket_plain(p, g, v, lr, 0.9, nesterov),
                     err, f"n={n} nesterov={nesterov}")
        m1, m2 = g.clone(), v.abs()
        _bitwise("adam_bucket",
                 fk.adam_bucket(p, g, m1, m2, lr_t, 0.9, 0.999, 1e-8),
                 fk.adam_bucket_plain(p, g, m1, m2, lr_t, 0.9, 0.999, 1e-8),
                 err, f"n={n}")
    torch.cuda.synchronize()
    log(f"[kernels] bitwise equal to the plain twins at n in {sizes}")

    # the card's achieved copy rate: one 1 GiB device-to-device copy
    # reads and writes 2 GiB
    src = torch.empty(1 << 28, device="cuda")
    dst = torch.empty_like(src)
    copy_gb_per_s = 2 * src.numel() * 4 / (_time_ms(
        lambda: dst.copy_(src)) * 1e-3) / 1e9
    del src, dst
    log(f"[kernels] device-to-device copy: {copy_gb_per_s:.0f} GB/s")

    # times over one step's buckets: ResNet-50's momentum buckets, the
    # MLP's adam bucket
    ps, gs, vs = _step_lanes(momentum_numels, 3, gen)
    qs, hs, m1s, m2s = _step_lanes(adam_numels, 4, gen)
    m2s = [m.abs() for m in m2s]
    step = torch.ones((), device="cuda")
    rows = []
    for name, numels, bpe, fpe, kern, plain, lib in (
        ("momentum_bucket", momentum_numels, 20, 4,
         lambda: [fk.momentum_bucket(p, g, v, lr, 0.9, False)
                  for p, g, v in zip(ps, gs, vs)],
         lambda: [fk.momentum_bucket_plain(p, g, v, lr, 0.9, False)
                  for p, g, v in zip(ps, gs, vs)],
         lambda: torch._fused_sgd_(
             ps, gs, vs, weight_decay=0.0, momentum=0.9, lr=0.01,
             dampening=0.0, nesterov=False, maximize=False,
             is_first_step=False)),
        ("adam_bucket", adam_numels, 28, 12,
         lambda: [fk.adam_bucket(p, g, m1, m2, lr_t, 0.9, 0.999, 1e-8)
                  for p, g, m1, m2 in zip(qs, hs, m1s, m2s)],
         lambda: [fk.adam_bucket_plain(p, g, m1, m2, lr_t, 0.9, 0.999, 1e-8)
                  for p, g, m1, m2 in zip(qs, hs, m1s, m2s)],
         lambda: torch._fused_adam_(
             qs, hs, m1s, m2s, [], [step] * len(qs), lr=1e-3, beta1=0.9,
             beta2=0.999, weight_decay=0.0, eps=1e-8, amsgrad=False,
             maximize=False)),
    ):
        ms = _time_ms(kern)
        plain_ms = _time_ms(plain)
        # the library call updates its lists in place: time it last
        library_ms = _time_ms(lib)
        n = sum(numels)
        bytes_s, ops_s = bpe * n / HBM_BYTES_PER_S, fpe * n / FP32_FLOPS
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/fused_update.cu",
            "replaces": ("paddle_tpu/fusion/kernels.py:72"
                         if name == "momentum_bucket"
                         else "paddle_tpu/fusion/kernels.py:108"),
            "launches": None, "max_abs_err": err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_s, ops_s)
            * 1e3, "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "library_ms": library_ms, "numels": list(numels),
            "bytes": bpe * n, "gb_per_s": bpe * n / (ms * 1e-3) / 1e9,
            "copy_bound_ms": bpe * n / (copy_gb_per_s * 1e9) * 1e3,
        })
        r = rows[-1]
        log(f"[kernels] {name}, one step's {len(numels)} bucket(s) of "
            f"{list(numels)}: {ms:.4f} ms ({r['bytes'] / 1e6:.1f} MB, "
            f"{r['gb_per_s']:.0f} GB/s); plain {plain_ms:.4f} ms; torch "
            f"fused {library_ms:.4f} ms; bound {r['bound_ms']:.4f} ms (at "
            f"the copy rate {r['copy_bound_ms']:.4f} ms)")
    return rows


def phase_resnet(main, startup, loss, buckets, card):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.fusion import kernels as fk

    rs = np.random.RandomState(SEED)
    x = rs.rand(BATCH, 224, 224, 3).astype(np.float32)
    y = rs.randint(0, 1000, size=(BATCH, 1)).astype(np.int64)
    scope = fluid.Scope()
    exe = fluid.Executor()
    with fluid.scope_guard(scope), flags.flag_guard(fuse=True):
        exe.run(startup)
        torch.cuda.synchronize()
        fk.reset_launch_counts()
        losses, step_ms = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            (lv,) = exe.run(main, feed={"data": x, "label": y},
                            fetch_list=[loss])
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(lv.reshape(-1)[0]))
        t0 = time.perf_counter()
        (lk,) = exe.run(main, feed={"data": np.stack([x] * 4),
                                    "label": np.stack([y] * 4)},
                        fetch_list=[loss], iters=4)
        iters_ms = (time.perf_counter() - t0) * 1e3
        launches = fk.momentum_bucket.launches
        steps = 5 + 4
        log(f"[resnet] losses {losses} then iters=4 {lk.reshape(-1).tolist()}")
        if not (np.all(np.isfinite(losses)) and np.all(np.isfinite(lk))):
            raise AssertionError("non-finite ResNet-50 loss")
        if lk.shape != (4, 1):
            raise AssertionError(f"iters=4 fetch shape {lk.shape} != (4, 1)")
        if not losses[-1] < losses[0]:
            raise AssertionError(
                f"loss did not fall over 5 steps: {losses[0]} -> {losses[-1]}")
        if launches < len(buckets) * steps:
            raise AssertionError(
                f"momentum kernel launched {launches} times, expected >= "
                f"{len(buckets)} buckets x {steps} steps")
        off = [n for n in scope.local_var_names()
               if not scope.find_var(n).is_cuda]
        if off:
            raise AssertionError(f"persistable vars off the card: {off[:5]}")
        warm = statistics.median(step_ms[1:])
        log(f"[resnet] {card}: momentum_bucket launches {launches} "
            f"({len(buckets)} buckets x {steps} steps); step ms "
            f"{[round(t, 2) for t in step_ms]}; warm median {warm:.2f} ms = "
            f"{BATCH / warm * 1e3:.1f} img/s; iters=4 call "
            f"{iters_ms:.1f} ms = {4 * BATCH / iters_ms * 1e3:.1f} img/s; "
            f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        profile_step(exe, main, x, y, loss, warm)
    return launches


def _device_ms(prof):
    """Device time of a profiled region: its kernels, copies and sets (the
    aten rows of a CPU trace repeat their kernels' time)."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def profile_step(exe, main, x, y, loss, warm_ms):
    """Two more steps under torch.profiler. The first traces the card only,
    which adds little host time: its wall and device-busy time give the
    device idle share of one step. The second also records the host ops,
    for the top-10 table of device time by op and kernel."""
    from torch.profiler import ProfilerActivity, profile

    def run(activities):
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            exe.run(main, feed={"data": x, "label": y}, fetch_list=[loss])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        return prof, wall_ms

    prof, wall_ms = run([ProfilerActivity.CUDA])
    busy_ms = _device_ms(prof)
    log(f"[profile] step traced on the card only: wall {wall_ms:.2f} ms, "
        f"device busy {busy_ms:.2f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}, host time not covered by the card "
        f"{wall_ms - busy_ms:.2f} ms (untraced warm median {warm_ms:.2f} ms)")
    prof, wall_ms = run([ProfilerActivity.CPU, ProfilerActivity.CUDA])
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=10)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "resnet50_profile.txt"), "w") as f:
        f.write(table)
    log(f"[profile] step traced with host ops: wall {wall_ms:.2f} ms, device "
        f"busy {_device_ms(prof):.2f} ms; top 10 by device ms (calls):")
    for e in rows[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} "
            f"({e.count:5d})  {e.key[:70]}")


def build_mlp():
    """The README MLP (784-200-10) with Adam 1e-3, and its fusion plan."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import fusion

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[784], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        hidden = fluid.layers.fc(input=img, size=200, act="relu")
        probs = fluid.layers.fc(input=hidden, size=10, act="softmax")
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=probs, label=label))
        fluid.optimizer.AdamOptimizer(learning_rate=1e-3).minimize(loss)
    main.random_seed = startup.random_seed = SEED
    _, plan = fusion.apply(main, feed_names=["img", "label"],
                           fetch_names=[loss.name])
    buckets = [b for b in plan.buckets if b["opt"] == "adam"]
    log(f"[plan] MLP: {len(buckets)} fused adam bucket(s) of "
        f"{[b['n'] for b in buckets]} params, numel "
        f"{[b['numel'] for b in buckets]}")
    return main, startup, loss, buckets


def phase_adam(main, startup, loss, buckets):
    """30 fused Adam steps on y = argmax(x @ W): the loss must fall and
    the adam kernel must cover every bucket of every step."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.fusion import kernels as fk

    rs = np.random.RandomState(SEED)
    w_fixed = rs.randn(784, 10).astype(np.float32)
    x = rs.rand(128, 784).astype(np.float32)
    y = np.argmax(x @ w_fixed, axis=1).reshape(-1, 1).astype(np.int64)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(fluid.Scope()), flags.flag_guard(fuse=True):
        exe.run(startup)
        torch.cuda.synchronize()
        fk.reset_launch_counts()
        losses = [float(exe.run(main, feed={"img": x, "label": y},
                                fetch_list=[loss])[0].reshape(-1)[0])
                  for _ in range(30)]
        launches = fk.adam_bucket.launches
    log(f"[adam] loss {losses[0]:.4f} -> {losses[-1]:.4f}; adam_bucket "
        f"launches {launches}")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"adam MLP loss did not fall: {losses}")
    if launches < 30 * len(buckets):
        raise AssertionError(f"adam kernel launched {launches} times in 30 "
                             f"steps of {len(buckets)} bucket(s)")
    return launches


def phase_parity():
    """resnet_cifar10(depth=8), batch 4, 2 fused Momentum steps on the card
    and on the host from the same weights: losses within rtol 1e-4."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert, flags
    from paddle_tpu_torch.models.resnet import resnet_cifar10

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="data", shape=[3, 32, 32],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(
            input=resnet_cifar10(img, 10, depth=8), label=label))
        fluid.optimizer.Momentum(learning_rate=0.05,
                                 momentum=0.9).minimize(loss)
    main.random_seed = startup.random_seed = SEED
    rs = np.random.RandomState(SEED)
    x = rs.rand(4, 3, 32, 32).astype(np.float32)
    y = rs.randint(0, 10, size=(4, 1)).astype(np.int64)
    out = {}
    with flags.flag_guard(fuse=True):
        host_scope = fluid.Scope()
        host = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(host_scope):
            host.run(startup)
        init = convert.numpy_state(host_scope, main)
        for place in (fluid.CPUPlace(), fluid.CUDAPlace(0)):
            scope = fluid.Scope()
            convert.load_numpy_state(scope, main, init, place)
            exe = fluid.Executor(place)
            with fluid.scope_guard(scope):
                out[repr(place)] = [
                    float(exe.run(main, feed={"data": x, "label": y},
                                  fetch_list=[loss])[0].reshape(-1)[0])
                    for _ in range(2)]
    host_l, card_l = out["CPUPlace()"], out["CUDAPlace(0)"]
    log(f"[parity] resnet_cifar10(8) losses host {host_l} card {card_l}")
    np.testing.assert_allclose(card_l, host_l, rtol=1e-4)


def main():
    card_line = phase_device()
    card = torch.cuda.get_device_name(0)
    phase_build()
    resnet = build_resnet50()
    mlp = build_mlp()
    rows = phase_kernels([b["numel"] for b in resnet[3]],
                         [b["numel"] for b in mlp[3]])
    rows[0]["launches"] = phase_resnet(*resnet, card)
    rows[1]["launches"] = phase_adam(*mlp)
    phase_parity()
    log(card_line)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
