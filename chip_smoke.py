"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure is an uncaught exception and a non-zero exit:
  1. device   — a CUDA card must be present; print its name and power limit
  2. build    — build the port's kernels from paddle_tpu_torch/csrc, all
                in one torch.utils.cpp_extension.load extension; count the
                HGMMA and UTMALDG instructions in the SASS (cuobjdump) of
                both flash kernels, which must not be 0, and print the
                HGMMA forms (the f32 kernel's must be .TF32)
  3. plan     — build the ResNet-50, README MLP, SE-ResNeXt-50, VGG-16 and
                MNIST conv net training programs and their fusion plans
  4. kernels  — each hand-written kernel, through its wrapper, against its
                plain torch twin on the card, bitwise, at n in {1, 17, 1029,
                4194307} and at every bucket size of every plan (ResNet-50,
                SE-ResNeXt-50; the MLP, VGG-16, the MNIST conv net); then
                timed over the buckets one step of each path updates,
                beside the plain twin, PyTorch's closest fused optimizer
                call, the bytes bound and the card's device-to-device copy
                rate: from a CUDA
                graph of one step's launches over enough rotating copies of
                the buckets to exceed the L2 cache, replayed 100 times
                between one pair of events (no host time between launches),
                and, as before, one wrapper call between two events
                ("single_call_ms": the Python wrapper and one launch)
  5. resnet   — ResNet-50, NHWC 224x224x3, 1000 classes, batch 32, fp32,
                Momentum(0.01, 0.9), FLAGS_fuse=1, through Executor.run on
                the captured step (step_mode "graph"): 5 single steps on one
                seeded batch, then one iters=4 call; the momentum kernel's
                launch count must equal buckets x steps; one more step
                traced on the card alone gives the device idle share, and
                one traced with host ops the top-10 of device time (full
                table in chiprun_out/resnet50_profile.txt); then the same
                steps and traces through the interpreter (FLAGS_cuda_graph
                off), for the two paths side by side
  6. headline — bench.py's headline program built with the port: uint8
                NHWC 224x224x3 input cast and scaled on the card, int32
                labels, ResNet-50, Momentum(0.01, 0.9), FLAGS_fuse=1, bf16
                AMP (amp.enable("bfloat16")), batch 128, Executor.run(
                iters=40) over a seeded feed stack moved to the card once: 2
                warm calls, then 5 timed calls from the first dispatch to one
                scalar fetch (resnet50_train_images_per_sec), through the
                captured step; the same program through the interpreter (one
                warm and one timed iters=4 call); one replayed step and one
                interpreter step traced on the card alone (idle shares, the
                momentum kernel's rows); graph vs interpreter from the same
                state for 3 steps at batch 32 (cuDNN deterministic on both
                sides), bitwise; every persistable f32 after the AMP steps
  7. se_resnext50, vgg16 — the benchmark/fluid image configs as their
                get_model declares them (float32 NCHW 224x224, int64 labels,
                the accuracy op): SE-ResNeXt-50 (1000 classes, Momentum(0.01,
                0.9), dropout 0.2 before the classifier) and VGG-16
                (vgg16_bn_drop + fc(102, softmax), Adam(1e-3), ten dropout
                ops), each FLAGS_fuse=1 under bf16 AMP, batch 64,
                Executor.run(iters=10) over a seeded feed stack made on the
                card, 1 warm + 3 timed calls through the captured step,
                fetching the loss and the last dropout's mask: img/s, peak
                memory, launches = buckets x steps, every step's mask keeps
                1 - p within 0.01 and differs from the step before, f32
                master state; one replayed step traced (idle share, top-10
                in chiprun_out/); graph vs interpreter over 3 steps at batch
                32 bitwise, masks included (cuDNN deterministic)
  8. adam     — the README MLP (784-200-10, Adam 1e-3) and the MNIST conv
                net (cnn_model, Adam(1e-3, 0.9, 0.999)), FLAGS_fuse=1, batch
                128, 30 steps each on y = argmax(x @ W) through the
                captured step: the loss must fall and the adam kernel cover
                every bucket of every step
  9. parity   — a small ResNet trained 2 steps on the card and on the host
                from the same weights must agree, in fp32 and under bf16 AMP
 10. flash    — the flash-attention kernels (both wgmma fed by TMA; f32
                in 3xTF32 split products after its split prologue) against
                their plain torch version on the card, causal and not, at
                the CPU tests' shapes, the tiles' edges (129 q rows over
                257 keys at D=128), a zero-padded head dim (D=12), no keys,
                a ragged Sq=1000/Sk=1500 case and full width (B=1, H=32,
                S=4096, D=128: Llama-2-7B's heads over its context), the
                split prologue bitwise equal to its plain twin at each f32
                shape; f32 and bf16 [B, S, H, D] views read in place,
                bitwise equal to the contiguous answer; then
                paddle_tpu_torch.parallel.
                flash_attention forward and backward through autograd at
                full width, f32 against the same loss through the plain
                version and bf16; then each of the four full-width variants
                timed beside the plain version and torch's
                scaled_dot_product_attention, and the split prologue beside
                its plain twin
Then one JSON line of the paths' numbers, one of per-kernel numbers (launches
on every path that runs the kernel), and as the last line
{"ok": true, "device": {...}}.
"""

import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data-sheet rates (dense, full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
# the f32 flash kernel does each product as 3 TF32 products (3xTF32)
TF32_PRODUCTS = 3

# the L2 cache of one H100 (50 MB): timed buckets rotate over more
L2_BYTES = 50 * 2 ** 20
GRAPH_REPLAYS = 100
# bench.py's headline run: batch 128, iters=40 a call, 2 warm + 5 timed
HEADLINE_BATCH = 128
HEADLINE_K = 40
HEADLINE_WARM = 2
HEADLINE_CALLS = 5
# host vs card losses under bf16 AMP: five bf16 ulps (5 x 2^-8)
PARITY_AMP_RTOL = 2e-2
# SE-ResNeXt-50 and VGG-16 under bf16 AMP: batch 64, iters=10 a call,
# 1 warm + 3 timed calls; the README MLP and the MNIST conv net: batch
# 128, 30 single steps
IMAGE_BATCH = 64
IMAGE_K = 10
IMAGE_WARM = 1
IMAGE_CALLS = 3
ADAM_BATCH = 128
ADAM_STEPS = 30
# a fetched dropout mask keeps 1 - p of its elements within this: the
# smallest mask checked holds 64 x 512 elements, whose keep fraction's
# standard deviation at p = 0.5 is 2.8e-3
KEEP_TOL = 0.01

SEED = 20261016
BATCH = 32
SIZES = (1, 17, 1029, 4194307)
OUT_DIR = "chiprun_out"  # long reports (gitignored)

# flash attention (B, H, Sq, Sk, D): the CPU tests' shapes, the kernels'
# tile edges at D=128, a padded D, no keys, a ragged case, and full width
# last
FLASH_FULL = (1, 32, 4096, 4096, 128)
FLASH_SHAPES = ((2, 3, 64, 64, 32), (2, 3, 100, 100, 32), (1, 2, 96, 96, 16),
                (1, 2, 64, 64, 32), (1, 2, 24, 24, 8), (1, 2, 50, 50, 8),
                (1, 2, 40, 72, 16), (1, 1, 5, 5, 8), (1, 2, 129, 257, 128),
                (1, 2, 33, 47, 12), (1, 2, 7, 0, 8), (1, 4, 1000, 1500, 64),
                FLASH_FULL)
# Kernel against its plain version on the card. f32 and the gradients keep
# the JAX package's oracle tolerances (tests/test_flash_attention.py). bf16
# does not: the oracle's atol 3e-2 is about |out| itself at full width
# (rms 0.026 over 4096 keys), so a kernel that skipped a 64-key tile would
# pass it. Both sides round p and out to bf16, so they differ by about one
# bf16 ulp of out (at most 2^-7 of it); 2e-3 + 1.6e-2·|out| allows two.
# tests/test_torch_flash.py shows that this limit rejects a skipped tile.
FLASH_TOL = {torch.float32: {"atol": 2e-5, "rtol": 1e-4},
             torch.bfloat16: {"atol": 2e-3, "rtol": 1.6e-2}}
LSE_ATOL = 1e-4
GRAD_TOL = {"atol": 5e-5, "rtol": 1e-3}


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

    ext = cuda_build.kernels()
    names = [os.path.basename(p) for p in cuda_build.sources()]
    log(f"[build] {' + '.join(names)} (one torch.utils.cpp_extension.load): "
        f"{cuda_build.build_seconds:.2f} s")
    sass = {kernel: sass_counts(ext.__file__, kernel, ("HGMMA", "UTMALDG"))
            for kernel in ("flash_fwd_sm90_kernel", "flash_fwd_tf32_kernel")}
    if not any("TF32" in form
               for form in sass["flash_fwd_tf32_kernel"]["HGMMA_forms"]):
        raise AssertionError("flash_fwd_tf32_kernel: no TF32 HGMMA")
    return sass


def sass_counts(library, kernel, opcodes):
    """How many instructions of each opcode the SASS of `kernel` in the
    built `library` holds (cuobjdump -sass), the distinct HGMMA forms and
    its registers and stack (cuobjdump -res-usage); fails on a count of
    0."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    body = [f for f in sass.split("Function : ")[1:]
            if kernel in f.split(maxsplit=1)[0]]
    if len(body) != 1:
        raise AssertionError(f"{kernel}: {len(body)} functions in the SASS")

    def opcode(line):  # "/*0c80*/  @P0 HGMMA.64x128x16... ;  /* 0x... */"
        words = [w for w in line.partition("*/")[2].split()
                 if not w.startswith("@")]
        return words[0] if words else ""

    ops = [opcode(line) for line in body[0].splitlines()]
    counts = {op: sum(o.startswith(op) for o in ops) for op in opcodes}
    if not all(counts.values()):
        raise AssertionError(f"{kernel}: missing {opcodes} in its SASS")
    counts["HGMMA_forms"] = sorted({o for o in ops if o.startswith("HGMMA")})
    # registers and stack (spilled registers live on the stack)
    usage = subprocess.run([cuobjdump, "-res-usage", library],
                           capture_output=True, text=True, check=True).stdout
    usage = [f for f in usage.split("Function ")[1:]
             if kernel in f.split(":", 1)[0]]
    counts["resources"] = " ".join(
        re.findall(r"\b(?:REG|STACK):\d+", usage[0]) if usage else [])
    log(f"[build] {kernel} SASS: {counts}")
    return counts


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


def phase_kernels(paths):
    """Each kernel against its plain twin at the fixed sizes and at every
    bucket size of every path's fusion plan, then timed over the buckets
    one step of each path updates. `paths`: {kernel: {path: bucket
    numels}}, the row's own path first (ResNet-50's momentum buckets, the
    headline's; VGG-16's adam buckets, the adam kernel's largest)."""
    from paddle_tpu_torch.fusion import kernels as fk

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    lr = torch.full((), 0.01, device="cuda")
    lr_t = torch.full((), 3.3e-4, device="cuda")
    err = {"momentum_bucket": 0.0, "adam_bucket": 0.0}
    buckets = {name: sorted({n for numels in by_path.values() for n in numels})
               for name, by_path in paths.items()}
    sizes = sorted(set(SIZES) | set(buckets["momentum_bucket"])
                   | set(buckets["adam_bucket"]))
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
        del p, g, v, m1, m2
    torch.cuda.synchronize()
    log(f"[kernels] bitwise equal to the plain twins at n in {sizes} "
        f"(every bucket size: {buckets})")

    # the card's achieved copy rate: one 1 GiB device-to-device copy
    # reads and writes 2 GiB
    src = torch.empty(1 << 28, device="cuda")
    dst = torch.empty_like(src)
    copy_gb_per_s = 2 * src.numel() * 4 / (_time_ms(
        lambda: dst.copy_(src)) * 1e-3) / 1e9
    del src, dst
    log(f"[kernels] device-to-device copy: {copy_gb_per_s:.0f} GB/s")

    rows = []
    for name, by_path in paths.items():
        timed = {path: _time_buckets(name, numels, gen, lr, lr_t,
                                     copy_gb_per_s)
                 for path, numels in by_path.items()}
        own = timed[next(iter(by_path))]
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/fused_update.cu",
            "replaces": ("paddle_tpu/fusion/kernels.py:72"
                         if name == "momentum_bucket"
                         else "paddle_tpu/fusion/kernels.py:108"),
            "launches": None, "max_abs_err": err[name],
            **{k: own[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
            "timed_on": next(iter(by_path)), "paths": timed})
    return rows


def _time_buckets(name, numels, gen, lr, lr_t, copy_gb_per_s):
    """The kernel over one step's buckets `numels`, on rotating copies that
    together exceed the L2 cache (the step finds its buckets in HBM):
    back to back from a CUDA graph, beside its plain twin, PyTorch's
    closest fused optimizer call and the bytes bound; and one wrapper call
    between two events."""
    from paddle_tpu_torch.fusion import kernels as fk

    bpe, fpe = (20, 4) if name == "momentum_bucket" else (28, 12)
    n = sum(numels)
    sets = max(1, -(-2 * L2_BYTES // (bpe * n)))
    if name == "momentum_bucket":
        lanes = [_step_lanes(numels, 3, gen) for _ in range(sets)]

        def kern(lanes=lanes):
            return [fk.momentum_bucket(p, g, v, lr, 0.9, False)
                    for ps, gs, vs in lanes for p, g, v in zip(ps, gs, vs)]

        def plain(lanes=lanes):
            return [fk.momentum_bucket_plain(p, g, v, lr, 0.9, False)
                    for ps, gs, vs in lanes for p, g, v in zip(ps, gs, vs)]

        def lib(lanes=lanes):
            for ps, gs, vs in lanes:
                torch._fused_sgd_(
                    ps, gs, vs, weight_decay=0.0, momentum=0.9, lr=0.01,
                    dampening=0.0, nesterov=False, maximize=False,
                    is_first_step=False)
    else:
        lanes = []
        for _ in range(sets):
            qs, hs, m1s, m2s = _step_lanes(numels, 4, gen)
            lanes.append((qs, hs, m1s, [m.abs() for m in m2s]))
        step = torch.ones((), device="cuda")

        def kern(lanes=lanes):
            return [fk.adam_bucket(p, g, m1, m2, lr_t, 0.9, 0.999, 1e-8)
                    for qs, hs, m1s, m2s in lanes
                    for p, g, m1, m2 in zip(qs, hs, m1s, m2s)]

        def plain(lanes=lanes):
            return [fk.adam_bucket_plain(p, g, m1, m2, lr_t, 0.9, 0.999, 1e-8)
                    for qs, hs, m1s, m2s in lanes
                    for p, g, m1, m2 in zip(qs, hs, m1s, m2s)]

        def lib(lanes=lanes, step=step):
            for qs, hs, m1s, m2s in lanes:
                torch._fused_adam_(
                    qs, hs, m1s, m2s, [], [step] * len(qs), lr=1e-3,
                    beta1=0.9, beta2=0.999, weight_decay=0.0, eps=1e-8,
                    amsgrad=False, maximize=False)

    def first(fn):  # one step's buckets, one set
        return lambda: fn(lanes=lanes[:1])

    # back to back: a graph of `sets` steps' launches, replayed
    ms = _graph_ms(kern) / sets
    plain_ms = _graph_ms(plain) / sets
    # the library call updates its lists in place: time it last
    library_ms = _graph_ms(lib) / sets
    # one wrapper call between two events, as timed before
    single = {"single_call_ms": _time_ms(first(kern)),
              "single_call_plain_ms": _time_ms(first(plain)),
              "single_call_library_ms": _time_ms(first(lib))}
    bytes_s, ops_s = bpe * n / HBM_BYTES_PER_S, fpe * n / FP32_FLOPS
    r = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
         "bound_ms": max(bytes_s, ops_s) * 1e3,
         "bound_by": "bytes" if bytes_s >= ops_s else "operations",
         **single, "numels": list(numels), "rotating_sets": sets,
         "graph_replays": GRAPH_REPLAYS, "bytes": bpe * n,
         "gb_per_s": bpe * n / (ms * 1e-3) / 1e9,
         "copy_bound_ms": bpe * n / (copy_gb_per_s * 1e9) * 1e3}
    log(f"[kernels] {name}, one step's {len(numels)} bucket(s) of "
        f"{list(numels)}, back to back ({sets} rotating set(s) x "
        f"{GRAPH_REPLAYS} graph replays): {ms:.4f} ms "
        f"({r['bytes'] / 1e6:.1f} MB, {r['gb_per_s']:.0f} GB/s, "
        f"{r['bound_ms'] / ms:.3f} of the bound); plain {plain_ms:.4f} ms; "
        f"torch fused {library_ms:.4f} ms; bound {r['bound_ms']:.4f} ms (at "
        f"the copy rate {r['copy_bound_ms']:.4f} ms); one wrapper call "
        f"between two events {single['single_call_ms']:.4f} ms (plain "
        f"{single['single_call_plain_ms']:.4f}, torch fused "
        f"{single['single_call_library_ms']:.4f})")
    del lanes, kern, plain, lib
    return r


def _graph_ms(fn):
    """ms of one fn(), from a CUDA graph of one fn() replayed GRAPH_REPLAYS
    times between one pair of events: the launches run back to back, with
    no host time between them. Median of 5 such windows, after one eager
    call on a side stream and one replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(GRAPH_REPLAYS):
            graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / GRAPH_REPLAYS)
    del graph
    return statistics.median(times)


def phase_resnet(main, startup, loss, buckets, card):
    """ResNet-50 fp32 batch 32 through the captured step, then the same
    steps from the same weights through the interpreter. Returns the
    momentum kernel's launches on the captured path."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert, flags

    rs = np.random.RandomState(SEED)
    x = rs.rand(BATCH, 224, 224, 3).astype(np.float32)
    y = rs.randint(0, 1000, size=(BATCH, 1)).astype(np.int64)
    place = fluid.CUDAPlace(0)
    init_scope = fluid.Scope()
    with fluid.scope_guard(init_scope):
        fluid.Executor(place).run(startup)
    init = convert.numpy_state(init_scope, main)
    del init_scope
    launches = {}
    for mode in ("graph", "interpreter"):
        with flags.flag_guard(fuse=True, cuda_graph=mode == "graph"):
            scope = fluid.Scope()
            convert.load_numpy_state(scope, main, init, place)
            launches[mode] = _drive_resnet(main, loss, buckets, scope, x, y,
                                           mode, card)
        del scope
        _release()
    return launches["graph"]


def _release():
    """Free what a finished phase's executors and graphs held."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _drive_resnet(main, loss, buckets, scope, x, y, mode, card):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.fusion import kernels as fk

    exe = fluid.Executor()
    with fluid.scope_guard(scope):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
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
        torch.cuda.synchronize()
        launches = fk.momentum_bucket.launches
        steps = 5 + 4
        if exe.step_mode(main) != mode:
            raise AssertionError(f"ResNet-50 ran as {exe.step_mode(main)!r}, "
                                 f"not {mode!r}")
        log(f"[resnet] {mode}: losses {losses} then iters=4 "
            f"{lk.reshape(-1).tolist()}")
        if not (np.all(np.isfinite(losses)) and np.all(np.isfinite(lk))):
            raise AssertionError("non-finite ResNet-50 loss")
        if lk.shape != (4, 1):
            raise AssertionError(f"iters=4 fetch shape {lk.shape} != (4, 1)")
        if not losses[-1] < losses[0]:
            raise AssertionError(
                f"loss did not fall over 5 steps: {losses[0]} -> {losses[-1]}")
        if launches != len(buckets) * steps:
            raise AssertionError(
                f"momentum kernel launched {launches} times, expected "
                f"{len(buckets)} buckets x {steps} steps")
        off = [n for n in scope.local_var_names()
               if not scope.find_var(n).is_cuda]
        if off:
            raise AssertionError(f"persistable vars off the card: {off[:5]}")
        warm = statistics.median(step_ms[1:])
        log(f"[resnet] {mode} {card}: momentum_bucket launches {launches} "
            f"({len(buckets)} buckets x {steps} steps); step ms "
            f"{[round(t, 2) for t in step_ms]}; warm median {warm:.2f} ms = "
            f"{BATCH / warm * 1e3:.1f} img/s; iters=4 call "
            f"{iters_ms:.1f} ms = {4 * BATCH / iters_ms * 1e3:.1f} img/s; "
            f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        profile_step(exe, main, {"data": x, "label": y}, [loss], warm,
                     f"resnet50_{mode}")
    return launches


def _device_ms(prof):
    """Device time of a profiled region: its kernels, copies and sets (the
    aten rows of a CPU trace repeat their kernels' time)."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def trace_step(exe, main, feed, fetch, kernel="momentum_kernel"):
    """One step traced on the card only, which adds little host time:
    (wall ms, device busy ms, idle share, rows of `kernel`, device ms of
    the random draws: torch's distribution kernels, behind dropout's
    masks). `fetch` is the fetch list the step was prepared (and
    captured) with."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=fetch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = _device_ms(prof)
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sum(e.count for e in device if kernel in e.key)
    draw_ms = sum(e.self_device_time_total for e in device
                  if "distribution" in e.key) / 1e3
    return wall_ms, busy_ms, 1 - busy_ms / wall_ms, rows, draw_ms


def profile_step(exe, main, feed, fetch, warm_ms, name,
                 kernel="momentum_kernel"):
    """Two more steps under torch.profiler. The first traces the card only:
    its wall and device-busy time give the device idle share of one step
    (returned as trace_step returns them). The second also records the
    host ops, for the top-10 table of device time by op and kernel
    (chiprun_out/<name>_profile.txt)."""
    from torch.profiler import ProfilerActivity, profile

    card = trace_step(exe, main, feed, fetch, kernel)
    wall_ms, busy_ms, idle, rows, draw_ms = card
    log(f"[profile] {name}: step traced on the card only: wall "
        f"{wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, idle share "
        f"{idle:.3f}, host time not covered by the card "
        f"{wall_ms - busy_ms:.2f} ms (untraced warm median {warm_ms:.2f} "
        f"ms); {kernel} rows {rows}; random draws {draw_ms:.3f} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=fetch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    top = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=10)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"{name}_profile.txt"), "w") as f:
        f.write(table)
    log(f"[profile] {name}: step traced with host ops: wall {wall_ms:.2f} "
        f"ms, device busy {_device_ms(prof):.2f} ms; top 10 by device ms "
        f"(calls):")
    for e in top[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} "
            f"({e.count:5d})  {e.key[:70]}")
    return card


def build_headline():
    """bench.py's headline program (bench.py:105-124) built with the port:
    raw uint8 NHWC pixels cast and scaled on the card, int32 labels,
    ResNet-50, Momentum(0.01, 0.9); with its fusion plan's momentum
    buckets."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import fusion
    from paddle_tpu_torch.models.resnet import resnet_imagenet

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        raw = fluid.layers.data(name="data_u8", shape=[224, 224, 3],
                                dtype="uint8")
        img = fluid.layers.scale(fluid.layers.cast(raw, "float32"),
                                 scale=1.0 / 255.0)
        label = fluid.layers.data(name="label", shape=[1], dtype="int32")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(
            input=resnet_imagenet(img, 1000, depth=50, layout="NHWC"),
            label=label))
        fluid.optimizer.Momentum(learning_rate=0.01,
                                 momentum=0.9).minimize(loss)
    main.random_seed = startup.random_seed = SEED
    _, plan = fusion.apply(main, feed_names=["data_u8", "label"],
                           fetch_names=[loss.name])
    buckets = [b for b in plan.buckets if b["opt"] == "momentum"]
    return main, startup, loss, buckets


def _fence(out):
    """One scalar read back: waits for everything queued before it."""
    return float(out.reshape(-1)[-1].item())


def _timed_calls(exe, main, feeds, fetch, iters, warm, calls):
    """`warm` untimed then `calls` timed exe.run(iters=...) calls; the host
    clock runs from the first timed dispatch to one scalar fetch of the
    loss, fetch[0] (bench.py:159-179). Returns (seconds, the last call's
    fetches as tensors [iters, ...])."""
    for _ in range(warm):
        outs = exe.run(main, feed=feeds, fetch_list=fetch, iters=iters,
                       return_numpy=False)
        _fence(outs[0])
    t0 = time.perf_counter()
    for _ in range(calls):
        outs = exe.run(main, feed=feeds, fetch_list=fetch, iters=iters,
                       return_numpy=False)
    _fence(outs[0])
    return time.perf_counter() - t0, outs


def _losses(out):
    return out.reshape(-1).float().cpu().numpy()


def phase_headline(card):
    """bench.py's headline run through the port: bf16 AMP, fused Momentum,
    batch 128, Executor.run(iters=40) replayed from the captured step; the
    interpreter beside it; traces; graph vs interpreter bitwise."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, convert, flags
    from paddle_tpu_torch.fusion import kernels as fk

    main, startup, loss, buckets = build_headline()
    log(f"[headline] bench.py's program: {len(buckets)} fused momentum "
        f"buckets of {[b['numel'] for b in buckets]} elements")
    rs = np.random.RandomState(SEED)
    u8 = rs.randint(0, 256, (HEADLINE_K, HEADLINE_BATCH, 224, 224, 3),
                    dtype=np.uint8)
    lab = rs.randint(0, 1000, (HEADLINE_K, HEADLINE_BATCH, 1)).astype(
        np.int32)
    feeds = {"data_u8": torch.from_numpy(u8).cuda(),
             "label": torch.from_numpy(lab).cuda()}
    del u8, lab
    place = fluid.CUDAPlace(0)
    result = {"batch": HEADLINE_BATCH, "iters": HEADLINE_K,
              "warm_calls": HEADLINE_WARM, "timed_calls": HEADLINE_CALLS}
    amp.enable("bfloat16")
    try:
        with flags.flag_guard(fuse=True):
            init_scope = fluid.Scope()
            with fluid.scope_guard(init_scope):
                fluid.Executor(place).run(startup)
            init = convert.numpy_state(init_scope, main)
            del init_scope

            # the captured step, as bench.py times it
            scope = fluid.Scope()
            convert.load_numpy_state(scope, main, init, place)
            exe = fluid.Executor()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fk.reset_launch_counts()
            with fluid.scope_guard(scope):
                dt, outs = _timed_calls(exe, main, feeds, [loss], HEADLINE_K,
                                        HEADLINE_WARM, HEADLINE_CALLS)
                lv = _losses(outs[0])
                torch.cuda.synchronize()
                launches = fk.momentum_bucket.launches
                steps = (HEADLINE_WARM + HEADLINE_CALLS) * HEADLINE_K
                mode = exe.step_mode(main)
                if mode != "graph":
                    raise AssertionError(f"headline ran as {mode!r}")
                if launches != len(buckets) * steps:
                    raise AssertionError(
                        f"momentum kernel launched {launches} times, "
                        f"expected {len(buckets)} buckets x {steps} steps")
                if not np.all(np.isfinite(lv)):
                    raise AssertionError(f"non-finite headline loss {lv}")
                _check_master_state(scope)
                img_s = HEADLINE_BATCH * HEADLINE_K * HEADLINE_CALLS / dt
                result.update(
                    step_mode=mode, images_per_sec=img_s,
                    step_ms=dt / (HEADLINE_K * HEADLINE_CALLS) * 1e3,
                    peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                    momentum_launches=launches, steps=steps,
                    last_losses=[float(v) for v in lv[-3:]])
                log(f"[headline] {card}: graph: "
                    f"resnet50_train_images_per_sec {img_s:.2f} "
                    f"({result['step_ms']:.2f} ms a step; {HEADLINE_CALLS} "
                    f"calls of iters={HEADLINE_K} in {dt:.3f} s after "
                    f"{HEADLINE_WARM} warm); peak mem "
                    f"{result['peak_mem_gib']:.2f} GiB; momentum_bucket "
                    f"launches {launches} ({len(buckets)} buckets x {steps} "
                    f"steps); last losses {result['last_losses']}")
                step0 = {n: t[0] for n, t in feeds.items()}
                wall, busy, idle, rows, _ = profile_step(
                    exe, main, step0, [loss], result["step_ms"],
                    "headline_graph")
                result.update(graph_trace_wall_ms=wall,
                              graph_trace_busy_ms=busy, graph_idle_share=idle,
                              graph_momentum_rows=rows)
                log(f"[headline] graph: one replayed step traced on the card "
                    f"only: wall {wall:.2f} ms, device busy {busy:.2f} ms, "
                    f"idle share {idle:.3f}; momentum_kernel rows {rows}")
                if rows != len(buckets):
                    raise AssertionError(
                        f"{rows} momentum_kernel rows in one traced replay, "
                        f"not {len(buckets)}")
            del exe, scope
            _release()

            # the same program through the interpreter
            scope = fluid.Scope()
            convert.load_numpy_state(scope, main, init, place)
            exe = fluid.Executor()
            four = {n: t[:4] for n, t in feeds.items()}
            torch.cuda.reset_peak_memory_stats()
            with fluid.scope_guard(scope), flags.flag_guard(cuda_graph=False):
                dt, outs = _timed_calls(exe, main, four, [loss], 4, 1, 1)
                lv = _losses(outs[0])
                if exe.step_mode(main) != "interpreter":
                    raise AssertionError("the interpreter run was captured")
                if not np.all(np.isfinite(lv)):
                    raise AssertionError(f"non-finite interpreter loss {lv}")
                img_s = HEADLINE_BATCH * 4 / dt
                result.update(
                    interpreter_images_per_sec=img_s,
                    interpreter_step_ms=dt / 4 * 1e3,
                    interpreter_peak_mem_gib=torch.cuda.max_memory_allocated()
                    / 2 ** 30)
                step0 = {n: t[0] for n, t in feeds.items()}
                wall, busy, idle, rows, _ = profile_step(
                    exe, main, step0, [loss], result["interpreter_step_ms"],
                    "headline_interpreter")
                result.update(interpreter_trace_wall_ms=wall,
                              interpreter_trace_busy_ms=busy,
                              interpreter_idle_share=idle)
                log(f"[headline] interpreter: {img_s:.2f} img/s "
                    f"({result['interpreter_step_ms']:.2f} ms a step; one "
                    f"iters=4 call after one warm); peak mem "
                    f"{result['interpreter_peak_mem_gib']:.2f} GiB; one step "
                    f"traced on the card only: wall {wall:.2f} ms, device "
                    f"busy {busy:.2f} ms, idle share {idle:.3f}; "
                    f"momentum_kernel rows {rows}")
            del exe, scope
            _release()
            result["bitwise"] = _graph_vs_interpreter(
                "headline", main, [loss], init,
                [{n: t[k, :BATCH] for n, t in feeds.items()}
                 for k in range(3)])
    finally:
        amp.disable()
    return result


def _check_master_state(scope):
    """Every persistable on the card and, after bf16 AMP steps, still f32
    where it is a float (master weights, velocities, running stats)."""
    bad = [(n, t.dtype, t.device) for n in scope.local_var_names()
           for t in [scope.find_var(n)]
           if not t.is_cuda or (t.dtype.is_floating_point
                                and t.dtype != torch.float32)]
    if bad:
        raise AssertionError(f"persistables not f32 on the card: {bad[:5]}")


def _graph_vs_interpreter(tag, main, fetch, init, batches):
    """The steps of `batches` from the same state through the captured step
    and through the interpreter, cuDNN deterministic on both sides: every
    fetch (the loss first; a dropout mask, drawn on both paths from the
    program's random stream) and every persistable (params, velocities,
    moments, running stats) bitwise; a difference is printed by var with
    its size and then held to rtol 1e-6."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert, flags

    place = fluid.CUDAPlace(0)
    out = {}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for mode in ("graph", "interpreter"):
            scope = fluid.Scope()
            convert.load_numpy_state(scope, main, init, place)
            exe = fluid.Executor()
            with fluid.scope_guard(scope), \
                    flags.flag_guard(cuda_graph=mode == "graph"):
                fetched = [exe.run(main, feed=b, fetch_list=fetch)
                           for b in batches]
                if exe.step_mode(main) != mode:
                    raise AssertionError(f"bitwise check ran {mode} as "
                                         f"{exe.step_mode(main)}")
            out[mode] = ([np.stack([f[i] for f in fetched])
                          for i in range(len(fetch))],
                         convert.numpy_state(scope, main))
            del exe, scope
            _release()
    finally:
        torch.backends.cudnn.deterministic = prev
    (gf, gs), (inf, ist) = out["graph"], out["interpreter"]
    gl, il = gf[0].reshape(-1), inf[0].reshape(-1)
    diff = {n: float(np.abs(gs[n].astype(np.float64) - ist[n]).max())
            for n in ist if not np.array_equal(gs[n], ist[n])}
    fetch_equal = all(np.array_equal(g, i) for g, i in zip(gf, inf))
    equal = fetch_equal and not diff
    batch = next(iter(batches[0].values())).shape[0]
    log(f"[{tag}] graph vs interpreter, {len(batches)} steps at batch {batch} "
        f"from one state (cuDNN deterministic): losses {gl.tolist()} / "
        f"{il.tolist()}; {'bitwise equal' if equal else 'DIFFER'} over "
        f"{len(fetch)} fetches and {len(ist)} persistables"
        + ("" if equal else f": fetches equal {fetch_equal}, {len(diff)} "
           f"persistables differ, largest "
           f"{sorted(diff.items(), key=lambda kv: -kv[1])[:5]}"))
    if not equal:
        for g, i in zip(gf, inf):
            np.testing.assert_allclose(g, i, rtol=1e-6)
        for n in ist:
            np.testing.assert_allclose(gs[n], ist[n], rtol=1e-6, err_msg=n)
    return {"equal": equal, "losses": gl.tolist(), "n_differ": len(diff)}


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


def phase_adam(name, main, startup, loss, buckets, shape):
    """ADAM_STEPS fused Adam steps at batch ADAM_BATCH on y = argmax(x @ W)
    (x [ADAM_BATCH] + shape, 784 features) through the captured step: the
    loss must fall and the adam kernel must cover every bucket of every
    step. Returns the kernel's launches."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.fusion import kernels as fk

    rs = np.random.RandomState(SEED)
    w_fixed = rs.randn(784, 10).astype(np.float32)
    x = rs.rand(ADAM_BATCH, *shape).astype(np.float32)
    y = np.argmax(x.reshape(ADAM_BATCH, -1) @ w_fixed, axis=1).reshape(
        -1, 1).astype(np.int64)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(fluid.Scope()), flags.flag_guard(fuse=True):
        exe.run(startup)
        torch.cuda.synchronize()
        fk.reset_launch_counts()
        losses = [float(exe.run(main, feed={"img": x, "label": y},
                                fetch_list=[loss])[0].reshape(-1)[0])
                  for _ in range(ADAM_STEPS)]
        launches = fk.adam_bucket.launches
        mode = exe.step_mode(main)
    log(f"[adam] {name}: {ADAM_STEPS} steps ({mode}), loss {losses[0]:.4f} "
        f"-> {losses[-1]:.4f}; adam_bucket launches {launches} "
        f"({len(buckets)} bucket(s) of {[b['numel'] for b in buckets]})")
    if mode != "graph":
        raise AssertionError(f"{name} ran as {mode!r}")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{name} loss did not fall: {losses}")
    if launches != ADAM_STEPS * len(buckets):
        raise AssertionError(f"adam kernel launched {launches} times in "
                             f"{ADAM_STEPS} steps of {len(buckets)} "
                             f"bucket(s)")
    return launches


def build_image_model(model):
    """One of the benchmark/fluid image configs built with the port, as its
    get_model declares it: float32 NCHW input, int64 labels, and the
    accuracy op; with its fusion plan's buckets and its last dropout's mask
    (None without dropout).
      se_resnext50: se_resnext(depth=50, 1000 classes) on 224x224,
                    Momentum(0.01, 0.9);
      vgg16:        vgg16_bn_drop + fc(102, softmax) on 224x224, Adam(1e-3);
      mnist_cnn:    cnn_model on 1x28x28, Adam(1e-3, 0.9, 0.999)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import fusion
    from paddle_tpu_torch.models import mnist, se_resnext, vgg

    shape = [1, 28, 28] if model == "mnist_cnn" else [3, 224, 224]
    classes = {"se_resnext50": 1000, "vgg16": 102, "mnist_cnn": 10}[model]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=shape, dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        if model == "se_resnext50":
            probs = se_resnext.se_resnext(img, classes, depth=50)
            opt = fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9)
        elif model == "vgg16":
            probs = fluid.layers.fc(input=vgg.vgg16_bn_drop(img),
                                    size=classes, act="softmax")
            opt = fluid.optimizer.Adam(learning_rate=1e-3)
        else:
            probs = mnist.cnn_model(img)
            opt = fluid.optimizer.AdamOptimizer(learning_rate=1e-3,
                                                beta1=0.9, beta2=0.999)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(input=probs,
                                                             label=label))
        fluid.layers.accuracy(input=probs, label=label)
        opt.minimize(loss)
    main.random_seed = startup.random_seed = SEED
    _, plan = fusion.apply(main, feed_names=["img", "label"],
                           fetch_names=[loss.name])
    kind = "momentum" if model == "se_resnext50" else "adam"
    buckets = [b for b in plan.buckets if b["opt"] == kind]
    drops = [op for op in main.global_block().ops if op.type == "dropout"]
    n_params = sum(int(np.prod(p.shape))
                   for p in main.global_block().all_parameters())
    log(f"[plan] {model}: {n_params} parameters; {len(buckets)} fused {kind} "
        f"buckets of {[b['numel'] for b in buckets]} elements "
        f"({sum(b['numel'] for b in buckets)} in all); ops "
        f"{plan.n_ops_before} -> {plan.n_ops_after}; {len(drops)} dropout "
        f"ops")
    return {"name": model, "main": main, "startup": startup, "loss": loss,
            "shape": shape, "classes": classes, "buckets": buckets,
            "kind": kind,
            "mask": drops[-1].output("Mask")[0] if drops else None,
            "keep": 1 - drops[-1].attrs["dropout_prob"] if drops else None}


def phase_image(m, card):
    """An image config's training on the captured step as bench.py runs the
    headline: bf16 AMP, its fused optimizer, batch IMAGE_BATCH,
    Executor.run(iters=IMAGE_K) over a seeded feed stack made on the card,
    IMAGE_WARM warm then IMAGE_CALLS timed calls, fetching the loss and
    the last dropout's mask. Checks: step_mode "graph", the update kernel's
    launches = buckets x steps, finite losses, each step's mask keeps
    1 - p of its elements within KEEP_TOL and differs from the step
    before (every timed step is a replay), every persistable f32; then one
    replayed step traced (idle share, top-10 in chiprun_out/) and 3 steps
    at batch BATCH through the graph and the interpreter, bitwise, masks
    included."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, convert, flags
    from paddle_tpu_torch.fusion import kernels as fk

    tag, main, loss = m["name"], m["main"], m["loss"]
    fetch = [loss, m["mask"]]
    kernel = fk.momentum_bucket if m["kind"] == "momentum" else fk.adam_bucket
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    feeds = {"img": torch.rand([IMAGE_K, IMAGE_BATCH] + m["shape"],
                               generator=gen, device="cuda"),
             "label": torch.randint(0, m["classes"],
                                    (IMAGE_K, IMAGE_BATCH, 1), generator=gen,
                                    device="cuda")}
    place = fluid.CUDAPlace(0)
    result = {"batch": IMAGE_BATCH, "iters": IMAGE_K,
              "warm_calls": IMAGE_WARM, "timed_calls": IMAGE_CALLS,
              "buckets": [b["numel"] for b in m["buckets"]]}
    amp.enable("bfloat16")
    try:
        with flags.flag_guard(fuse=True):
            init_scope = fluid.Scope()
            with fluid.scope_guard(init_scope):
                fluid.Executor(place).run(m["startup"])
            init = convert.numpy_state(init_scope, main)
            del init_scope
            scope = fluid.Scope()
            convert.load_numpy_state(scope, main, init, place)
            exe = fluid.Executor()
            _release()
            torch.cuda.reset_peak_memory_stats()
            fk.reset_launch_counts()
            with fluid.scope_guard(scope):
                dt, outs = _timed_calls(exe, main, feeds, fetch, IMAGE_K,
                                        IMAGE_WARM, IMAGE_CALLS)
                torch.cuda.synchronize()
                launches = kernel.launches
                steps = (IMAGE_WARM + IMAGE_CALLS) * IMAGE_K
                mode = exe.step_mode(main)
                lv = _losses(outs[0])
                masks = outs[1].float().reshape(IMAGE_K, -1)
                keep = masks.mean(dim=1).cpu().numpy()
                fresh = [not torch.equal(masks[k], masks[k + 1])
                         for k in range(IMAGE_K - 1)]
                if mode != "graph":
                    raise AssertionError(f"{tag} ran as {mode!r}")
                if launches != len(m["buckets"]) * steps:
                    raise AssertionError(
                        f"{tag}: {m['kind']} kernel launched {launches} "
                        f"times, expected {len(m['buckets'])} buckets x "
                        f"{steps} steps")
                if not np.all(np.isfinite(lv)):
                    raise AssertionError(f"non-finite {tag} loss {lv}")
                if not np.all(np.abs(keep - m["keep"]) < KEEP_TOL):
                    raise AssertionError(f"{tag}: masks keep {keep}, not "
                                         f"{m['keep']} +- {KEEP_TOL}")
                if not all(fresh):
                    raise AssertionError(f"{tag}: a replay drew the mask of "
                                         f"the step before: {fresh}")
                _check_master_state(scope)
                n_img = IMAGE_BATCH * IMAGE_K * IMAGE_CALLS
                result.update(
                    step_mode=mode, images_per_sec=n_img / dt,
                    step_ms=dt / (IMAGE_K * IMAGE_CALLS) * 1e3,
                    peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                    launches=launches, steps=steps,
                    mask_keep=[float(k) for k in keep],
                    last_losses=[float(v) for v in lv[-3:]])
                log(f"[{tag}] {card}: graph: {result['images_per_sec']:.2f} "
                    f"img/s ({result['step_ms']:.2f} ms a step; "
                    f"{IMAGE_CALLS} calls of iters={IMAGE_K} at batch "
                    f"{IMAGE_BATCH} in {dt:.3f} s after {IMAGE_WARM} warm); "
                    f"peak mem {result['peak_mem_gib']:.2f} GiB; "
                    f"{m['kind']}_bucket launches {launches} "
                    f"({len(m['buckets'])} buckets of {result['buckets']} x "
                    f"{steps} steps); mask keep fractions "
                    f"{np.round(keep, 4).tolist()} (1 - p = {m['keep']}), "
                    f"each step's mask new; last losses "
                    f"{result['last_losses']}")
                step0 = {n: t[0] for n, t in feeds.items()}
                wall, busy, idle, rows, draw = profile_step(
                    exe, main, step0, fetch, result["step_ms"],
                    f"{tag}_graph", f"{m['kind']}_kernel")
                result.update(trace_wall_ms=wall, trace_busy_ms=busy,
                              idle_share=idle, kernel_rows=rows,
                              draw_ms=draw)
                log(f"[{tag}] one replayed step traced on the card only: "
                    f"wall {wall:.2f} ms, device busy {busy:.2f} ms, idle "
                    f"share {idle:.3f}; {m['kind']}_kernel rows {rows}; "
                    f"the dropout masks' random draws {draw:.3f} ms of "
                    f"device time")
                if rows != len(m["buckets"]):
                    raise AssertionError(
                        f"{rows} {m['kind']}_kernel rows in one traced "
                        f"replay, not {len(m['buckets'])}")
            del exe, scope
            _release()
            result["bitwise"] = _graph_vs_interpreter(
                tag, main, fetch, init,
                [{n: t[k, :BATCH] for n, t in feeds.items()}
                 for k in range(3)])
            if not result["bitwise"]["equal"]:
                raise AssertionError(f"{tag}: graph and interpreter differ")
    finally:
        amp.disable()
    del feeds
    _release()
    return result


def phase_parity(amp):
    """resnet_cifar10(depth=8), batch 4, 2 fused Momentum steps on the card
    and on the host from the same weights: losses within rtol 1e-4 in fp32.
    Under bf16 AMP within rtol PARITY_AMP_RTOL: cuDNN on the card and
    PyTorch's CPU kernels both round each bf16 conv and matmul output once
    but sum differently before it, so a logit can land one bf16 ulp (2^-8
    relative) apart and the f32 loss inherits a few such ulps."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp as tamp
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
            with fluid.scope_guard(scope), tamp.auto_cast(enabled=amp):
                out[repr(place)] = [
                    float(exe.run(main, feed={"data": x, "label": y},
                                  fetch_list=[loss])[0].reshape(-1)[0])
                    for _ in range(2)]
                out[repr(place) + " mode"] = exe.step_mode(main)
    host_l, card_l = out["CPUPlace()"], out["CUDAPlace(0)"]
    rtol = PARITY_AMP_RTOL if amp else 1e-4
    rel = max(abs(c / h - 1) for c, h in zip(card_l, host_l))
    log(f"[parity] resnet_cifar10(8) {'bf16 AMP' if amp else 'fp32'}: losses "
        f"host {host_l} ({out['CPUPlace() mode']}) card {card_l} "
        f"({out['CUDAPlace(0) mode']}); largest relative difference "
        f"{rel:.3e} (rtol {rtol:g})")
    np.testing.assert_allclose(card_l, host_l, rtol=rtol)


def _qkv(shape, dtype, gen):
    B, H, Sq, Sk, D = shape
    return [torch.randn(B, H, S, D, generator=gen, device="cuda").to(dtype)
            for S in (Sq, Sk, Sk)]


def _flash_work(shape, dtype, causal):
    """(flops, bytes) the forward must do and move: 4·D flops per visible
    (query, key) pair (q·kᵀ and p·V), q, k, v and out read or written once
    plus the f32 lse."""
    B, H, Sq, Sk, D = shape
    pairs = (sum(min(i + 1, Sk) for i in range(Sq)) if causal
             else Sq * Sk)
    size = torch.finfo(dtype).bits // 8
    return (4 * B * H * pairs * D,
            B * H * (2 * Sq + 2 * Sk) * D * size + B * H * Sq * 4)


def _check_flash(flash, q, k, v, causal, what, worst):
    """One kernel call against the plain version; returns the errors."""
    D = q.shape[-1]
    out, lse = flash.flash_fwd(q, k, v, D ** -0.5, causal)
    want, want_lse = flash.flash_fwd_plain(q, k, v, D ** -0.5, causal)
    dtype = q.dtype
    if out.dtype != dtype or not torch.isfinite(out).all():
        raise AssertionError(f"flash {what}: bad output")
    torch.testing.assert_close(out, want, **FLASH_TOL[dtype],
                               msg=f"flash out {what}")
    # lse is -inf exactly where a row sees no key, on both sides
    torch.testing.assert_close(lse, want_lse, atol=LSE_ATOL, rtol=0,
                               msg=f"flash lse {what}")
    diff = (out.float() - want.float()).abs()
    seen = torch.isfinite(want_lse)
    e_out = diff.max().item() if diff.numel() else 0.0
    e_lse = ((lse - want_lse)[seen].abs().max().item() if seen.any()
             else 0.0)
    # the largest share of the limit any element used
    used = ((diff / (FLASH_TOL[dtype]["atol"] + FLASH_TOL[dtype]["rtol"]
                     * want.float().abs())).max().item()
            if diff.numel() else 0.0)
    name = str(dtype).split(".")[1]
    worst[name] = max(worst[name], e_out)
    worst[name + "_limit_used"] = max(worst[name + "_limit_used"], used)
    worst["lse"] = max(worst["lse"], e_lse)
    if k.shape[2] == 0 and (out.any() or not torch.isneginf(lse).all()):
        raise AssertionError(f"flash {what}: no keys must give out 0 and "
                             f"lse -inf")
    return e_out, e_lse, used, want


def phase_flash(sass):
    """The flash-attention forward kernels against their plain version,
    the differentiable entry point on the card, and the full-width
    timings."""
    import torch.nn.functional as F

    from paddle_tpu_torch.parallel import flash

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flash.reset_launch_counts()
    calls = {torch.float32: 0, torch.bfloat16: 0}
    worst = {"float32": 0.0, "bfloat16": 0.0, "float32_limit_used": 0.0,
             "bfloat16_limit_used": 0.0, "lse": 0.0}
    full_err = {}
    for shape in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _qkv(shape, dtype, gen)
            if dtype == torch.float32:
                # the f32 kernel's prologue against its plain twin, bitwise
                got = flash.split_tf32(k, v)
                want = flash.split_tf32_plain(k, v)
                if not all(a.shape == b.shape and torch.equal(a, b)
                           for a, b in zip(got, want)):
                    raise AssertionError(f"split_tf32 {shape} differs from "
                                         f"its plain twin")
            for causal in (False, True):
                what = f"{shape} {dtype} causal={causal}"
                e_out, e_lse, used, want = _check_flash(flash, q, k, v, causal,
                                                        what, worst)
                calls[dtype] += 1
                if shape[3] == 0:
                    log(f"[flash] no keys {what}: out 0, lse -inf")
                if shape == FLASH_FULL:
                    full_err[(dtype, causal)] = (e_out, e_lse, used)
                    log(f"[flash] full width {what}: max |out err| "
                        f"{e_out:.3e} ({used:.3f} of the limit; rms |out| "
                        f"{want.float().pow(2).mean().sqrt().item():.4f}), "
                        f"max |lse err| {e_lse:.3e}")

    # a [B, S, H, D] tensor viewed as [B, H, S, D] is read in place (bf16
    # by TMA, f32 by the prologue and the q loads), and the answer is the
    # contiguous one, bitwise
    bshd = torch.randn(2, 777, 4, 128, generator=gen, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        view = bshd.to(dtype).transpose(1, 2)
        if dtype == torch.bfloat16 and flash._tma_operand(view) is not view:
            raise AssertionError("a [B, S, H, D] bf16 view was copied")
        for causal in (False, True):
            got = flash.flash_fwd(view, view, view, 128 ** -0.5, causal)
            dense = view.contiguous()
            want = flash.flash_fwd(dense, dense, dense, 128 ** -0.5, causal)
            calls[dtype] += 2
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{dtype} view causal={causal} differs "
                                     f"from the contiguous answer")
    torch.cuda.synchronize()
    counts = (flash.flash_fwd.launches, flash.flash_fwd.tf32_launches,
              flash.flash_fwd.sm90_launches)
    want_counts = (sum(calls.values()), calls[torch.float32],
                   calls[torch.bfloat16])
    if counts != want_counts:
        raise AssertionError(f"flash_fwd launched (all, tf32, bf16) {counts} "
                             f"times for {want_counts} CUDA calls")
    log(f"[flash] kernel == plain version at {len(FLASH_SHAPES)} shapes x "
        f"f32/bf16 x causal/not, split prologue == its plain twin bitwise at "
        f"every f32 shape, and f32/bf16 [B, S, H, D] views read in place "
        f"== their contiguous copies bitwise ({counts[0]} launches: "
        f"{counts[1]} of the 3xTF32 kernel, {counts[2]} of the bf16 one; "
        f"{flash.split_tf32.launches} of the prologue); max |err| "
        f"f32 {worst['float32']:.3e} ({worst['float32_limit_used']:.3f} of "
        f"its limit), bf16 {worst['bfloat16']:.3e} "
        f"({worst['bfloat16_limit_used']:.3f} of its limit), lse "
        f"{worst['lse']:.3e}")

    # the entry point a user calls, at full width: forward (the kernels)
    # and backward through autograd; f32 against the same loss through the
    # plain version, bf16 against the plain forward at the kernel's limit
    shape = FLASH_FULL
    B, H, S, _, D = shape
    q, k, v, cot = _qkv(shape, torch.float32, gen) + [
        torch.randn(B, H, S, D, generator=gen, device="cuda")]
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launch_counts()
    grads, outs = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            leaves = [t.to(dtype, copy=True).requires_grad_(True)
                      for t in (q, k, v)]
            out = flash.flash_attention(*leaves, causal=causal)
            (out.float() * cot).sum().backward()
            grads[dtype, causal] = [t.grad for t in leaves]
            outs[dtype, causal] = out.detach()
    torch.cuda.synchronize()
    launches = flash.flash_fwd.launches
    sm90 = flash.flash_fwd.sm90_launches
    tf32 = flash.flash_fwd.tf32_launches
    split = flash.split_tf32.launches
    if (launches, sm90, tf32, split) != (4, 2, 2, 2):
        raise AssertionError(f"flash_attention launched the kernels "
                             f"{launches} times ({sm90} bf16, {tf32} 3xTF32, "
                             f"{split} prologues) in 4 forward passes (2 "
                             f"bf16, 2 f32)")
    grad_err = 0.0
    for causal in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out, _ = flash.flash_fwd_plain(*leaves, D ** -0.5, causal)
        (out * cot).sum().backward()
        for got, t, n in zip(grads[torch.float32, causal], leaves, "qkv"):
            grad_err = max(grad_err, (got - t.grad).abs().max().item())
            torch.testing.assert_close(got, t.grad, **GRAD_TOL,
                                       msg=f"d{n} causal={causal}")
        low = [t.to(torch.bfloat16) for t in (q, k, v)]
        want, _ = flash.flash_fwd_plain(*low, D ** -0.5, causal)
        torch.testing.assert_close(outs[torch.bfloat16, causal], want,
                                   **FLASH_TOL[torch.bfloat16],
                                   msg=f"bf16 flash_attention causal={causal}")
        for g in grads[torch.bfloat16, causal]:
            if g.dtype != torch.bfloat16 or not torch.isfinite(g).all():
                raise AssertionError(f"bf16 grads causal={causal}: bad")
    log(f"[flash] flash_attention {shape} forward + backward: f32 grads of "
        f"q, k, v == the plain version's (atol 5e-5, rtol 1e-3), causal and "
        f"not, max |err| {grad_err:.3e}; bf16 out == the plain version's at "
        f"the kernel's limit, bf16 grads finite; kernel launches {launches} "
        f"({sm90} bf16, {tf32} 3xTF32, {split} prologues); peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # full width: kernel, plain version and torch's SDPA (causal mask
    # top-left; Sq == Sk, so every backend agrees on it)
    configs = {}
    D = FLASH_FULL[-1]
    flash.reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _qkv(FLASH_FULL, dtype, gen)
        for causal in (False, True):

            def sdpa():
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, scale=D ** -0.5)

            ms = _time_ms(lambda: flash.flash_fwd(q, k, v, D ** -0.5, causal))
            plain_ms = _time_ms(
                lambda: flash.flash_fwd_plain(q, k, v, D ** -0.5, causal))
            library_ms = _time_ms(sdpa)
            # the yardstick's own distance from the plain version
            library_err = (sdpa().float() - flash.flash_fwd_plain(
                q, k, v, D ** -0.5, causal)[0].float()).abs().max().item()
            flops, nbytes = _flash_work(FLASH_FULL, dtype, causal)
            ops_s = (flops / BF16_FLOPS if dtype == torch.bfloat16
                     else TF32_PRODUCTS * flops / TF32_FLOPS)
            bytes_s = nbytes / HBM_BYTES_PER_S
            c = configs[dtype, causal] = {
                "dtype": str(dtype).split(".")[1], "causal": causal,
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": max(ops_s, bytes_s) * 1e3,
                "bound_by": "operations" if ops_s >= bytes_s else "bytes",
                "flops": flops, "bytes": nbytes,
                "tflop_per_s": flops / (ms * 1e-3) / 1e12,
                "bound_share": max(ops_s, bytes_s) * 1e3 / ms,
                "vs_library": ms / library_ms,
                "max_abs_err": full_err[(dtype, causal)][0],
                "lse_max_abs_err": full_err[(dtype, causal)][1],
                "limit_used": full_err[(dtype, causal)][2],
                "library_max_abs_err": library_err}
            if dtype == torch.float32:
                # the earlier design's yardstick: f32 on the CUDA cores
                c["cuda_core_bound_ms"] = flops / FP32_FLOPS * 1e3
            log(f"[flash] {FLASH_FULL} {c['dtype']} causal={causal}: kernel "
                f"{ms:.4f} ms ({c['tflop_per_s']:.2f} TFLOP/s, "
                f"{c['bound_share']:.3f} of the bound); plain "
                f"{plain_ms:.4f} ms; sdpa {library_ms:.4f} ms (kernel / sdpa "
                f"{c['vs_library']:.3f}; sdpa max |err| vs plain "
                f"{library_err:.3e}); bound {c['bound_ms']:.4f} ms "
                f"({c['bound_by']})")
    timed = flash.flash_fwd.launches
    if timed != 4 * 28:
        raise AssertionError(f"timing launched the kernel {timed} times, "
                             f"not 4 x 28")

    # the split prologue alone at full width: bytes bound (k and v read
    # once, four parts written once)
    q, k, v = _qkv(FLASH_FULL, torch.float32, gen)
    split_err = max((a - b).abs().max().item() for a, b in zip(
        flash.split_tf32(k, v), flash.split_tf32_plain(k, v)))
    split_ms = _time_ms(lambda: flash.split_tf32(k, v))
    split_plain_ms = _time_ms(lambda: flash.split_tf32_plain(k, v))
    split_bytes = 2 * k.numel() * 4 + 4 * k.numel() * 4
    split_bound = split_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[flash] split_tf32 {FLASH_FULL}: {split_ms:.4f} ms "
        f"({split_bytes / (split_ms * 1e-3) / 1e9:.0f} GB/s); plain "
        f"{split_plain_ms:.4f} ms; bound {split_bound:.4f} ms (bytes)")

    # one row per kernel; each flash row's own numbers are its causal
    # variant, a decoder's training shape
    rows = []
    for dtype, source, n in (
            (torch.bfloat16, "flash_attention_sm90.cu", sm90),
            (torch.float32, "flash_attention_f32_sm90.cu", tf32)):
        c = configs[dtype, True]
        rows.append({
            "name": f"flash_fwd_{'bf16' if dtype == torch.bfloat16 else 'f32'}",
            "route": "cuda", "source": f"paddle_tpu_torch/csrc/{source}",
            "replaces": "paddle_tpu/parallel/flash.py:81", "launches": n,
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "shape": list(FLASH_FULL), "dtype": c["dtype"], "causal": True,
            "configs": [configs[dtype, m] for m in (False, True)]})
    rows[0]["sass"] = sass["flash_fwd_sm90_kernel"]
    rows[0]["max_abs_err_all"] = worst
    rows[1]["sass"] = sass["flash_fwd_tf32_kernel"]
    rows[1]["grad_max_abs_err"] = grad_err
    rows.append({
        "name": "split_tf32", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention_f32_sm90.cu",
        "replaces": "paddle_tpu/parallel/flash.py:81", "launches": split,
        "max_abs_err": split_err, "ms": split_ms, "plain_ms": split_plain_ms,
        "bound_ms": split_bound, "bound_by": "bytes", "library_ms": None,
        "shape": list(FLASH_FULL), "bytes": split_bytes})
    return rows


def main():
    card_line = phase_device()
    card = torch.cuda.get_device_name(0)
    sass = phase_build()
    resnet = build_resnet50()
    mlp = build_mlp()
    images = {name: build_image_model(name)
              for name in ("se_resnext50", "vgg16", "mnist_cnn")}

    def numels(plan):
        return [b["numel"] for b in plan]

    rows = phase_kernels({
        "momentum_bucket": {"resnet50": numels(resnet[3]),
                            "se_resnext50": numels(
                                images["se_resnext50"]["buckets"])},
        "adam_bucket": {"vgg16": numels(images["vgg16"]["buckets"]),
                        "mlp": numels(mlp[3]),
                        "mnist_cnn": numels(images["mnist_cnn"]["buckets"])}})
    momentum, adam = rows[0], rows[1]
    paths = {"resnet50_fp32": phase_resnet(*resnet, card)}
    _release()
    headline = phase_headline(card)
    paths["headline"] = headline["momentum_launches"]
    _release()
    se = phase_image(images["se_resnext50"], card)
    paths["se_resnext50"] = se["launches"]
    momentum["launches"], momentum["launches_by_path"] = (
        headline["momentum_launches"], paths)
    vgg = phase_image(images["vgg16"], card)
    mnist = images["mnist_cnn"]
    paths = {"vgg16": vgg["launches"],
             "mlp": phase_adam("mlp", *mlp, [784]),
             "mnist_cnn": phase_adam("mnist_cnn", mnist["main"],
                                     mnist["startup"], mnist["loss"],
                                     mnist["buckets"], mnist["shape"])}
    adam["launches"], adam["launches_by_path"] = vgg["launches"], paths
    phase_parity(amp=False)
    phase_parity(amp=True)
    rows += phase_flash(sass)
    log(card_line)
    log(json.dumps({"headline": headline, "se_resnext50": se,
                    "vgg16": vgg}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
