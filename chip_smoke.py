"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure is an uncaught exception and a non-zero exit:
  1. device   — a CUDA card must be present; print its name and power limit
  2. build    — build the port's kernels from paddle_tpu_torch/csrc, all
                in one torch.utils.cpp_extension.load extension; count the
                HGMMA and UTMALDG instructions in the SASS (cuobjdump) of
                both flash kernels and the 128-bit global loads and stores
                (LDG/STG .128) of the adam kernel, which must not be 0, and
                print the HGMMA forms (the f32 kernel's must be .TF32)
  3. plan     — build the ResNet-50, README MLP, SE-ResNeXt-50, VGG-16,
                MNIST conv net, stacked-LSTM and NMT training programs and
                their fusion plans;
                one interpreter step at batch 2 under bf16 AMP of the
                headline, SE-ResNeXt-50 and VGG-16 gives the dtype of
                each fused member's grad
  4. kernels  — each hand-written kernel, through its wrapper, against its
                plain torch twin on the card, bitwise, at n in {1, 17, 1029,
                4194307} and at every bucket size of every plan (ResNet-50,
                SE-ResNeXt-50; the MLP, VGG-16, the MNIST conv net, the
                stacked LSTM, the NMT); the
                in-place adam entry (adam_bucket_) at those n and at every
                adam bucket's member shapes, grads in their path's dtypes
                and flipped, aligned and with a member 4 bytes off; then
                timed over the buckets one step of each path updates,
                beside the plain twin, PyTorch's closest fused optimizer
                call, the bytes bound and the card's device-to-device copy
                rate: from a CUDA
                graph of one step's launches over enough rotating copies of
                the buckets to exceed the L2 cache, replayed 100 times
                between one pair of events (no host time between launches),
                and one wrapper call between two events ("single_call_ms":
                the Python wrapper and one launch). adam: on flat lanes
                (the TPU kernel's signature) and on the buckets' member
                lists in place, as the main path runs it, beside the same
                lists with f32 grads through the kernel and through
                torch._fused_adam_, and the fused op now against the op as
                it ran before (pack, flat kernel, write-back copies).
                momentum: its op route (pack, kernel, write-back) against
                the kernel alone
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
  6b. parallel — the headline's program, feeds and timing through
                fluid.ParallelExecutor(use_cuda=True) over a one-rank NCCL
                group (parallel.distributed.initialize, file:// rendezvous
                in a temp dir): 1 warm + 3 timed iters=40 calls through the
                captured step, its gradient all-reduces and global-batch
                collectives inside the graph; step_mode "graph", the
                momentum kernel's launches = buckets x steps, the
                collective launches of one replay (> 0), img/s beside the
                headline Executor's, peak memory, one replayed step traced
                (idle share); then PE and the Executor over 3 steps at batch
                32 from one state, bitwise (losses and every persistable);
                the group destroyed after
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
  9. lstm, nmt — the benchmark/fluid sequence configs as the JAX
                package's get_model builds them, f32 and fused Adam as
                fluid_benchmark.py runs them: the stacked LSTM (IMDB
                vocabulary 5148, 512 wide, max_len 128; log tag
                [stacked_lstm]) and the seq2seq NMT (dictionary 30000, 512
                everywhere, decoder caps 32/32; [nmt]), batch 128, seeded
                ragged batches drawn as the synthetic readers draw them,
                bucketed (create_bucketed_seq_tensor) to one flat total per
                feed and stacked on the card, Executor.run(iters=10), 1 warm
                + 3 timed calls through the captured step: words/s (review
                tokens; target tokens), step ms, peak memory, adam_bucket_
                launches = buckets x steps, f32 state; one replayed step
                traced (idle share, top-10 in chiprun_out/); the loop
                ops' forwards timed alone (the derived grads run each
                again); the embedding grads bitwise run to run; graph vs interpreter over 3 steps at batch 32
                bitwise; host vs card within rtol 1e-4 over 3 steps at
                batch 16
 10. parity   — a small ResNet trained 2 steps on the card and on the host
                from the same weights must agree, in fp32 and under bf16 AMP
 10b. serve  — the serving slice: the headline's network (uint8 NHWC
                224x224x3 cast and scaled on the card, ResNet-50, 1000
                classes) trained 3 steps at batch 32 under bf16 AMP and
                saved (io.save_inference_model, io.save_params);
                serve.Server.from_inference_model under bf16 AMP, buckets
                1..32, every bucket a captured CUDA graph after start();
                16 requests of 1-4 rows against the host's f32 (rtol 2e-2
                of each row's top); a second server through
                from_infer_func with the InferenceTranspiler's conv+bn
                fold, f32, against the unfolded program on the card (rtol
                1e-4); each bucket's replay timed alone (CUDA events, 50
                replays); closed-loop one-image loads from C = 64 client
                threads (2,048 requests) and C = 1 (256): img/s,
                p50/p95/p99, pad fraction, rows a batch, device-busy share
                (the batches' replay ms over the wall time); no
                hand-written kernel launched and no steady-state compile
                while serving; 4 HTTP round trips, /healthz, /stats,
                /metrics; drain serves its backlog and refuses a new submit
                ([serve] lines)
 10c. tail_ops — the single-device op tail: (a) every op type it
                registered (the reductions, matmul, clipping, the tensor
                ops, comparison and logic, the dense losses, the eight
                update rules) on the card and on the host from the same
                seeded inputs, forward and grad, at full-width shapes
                (NMT's target logits [1472, 30000] for
                softmax_with_cross_entropy, label_smooth, arg_max and
                argsort; ResNet-50's last activation [128, 2048, 7, 7]
                for the reductions; the rules over ResNet-50's
                25,557,032 parameter lanes); (b) the headline's program
                with GradientClipByGlobalNorm(1.0) and exponential_decay
                on fused Momentum, bf16 AMP, batch 128, iters=10 through
                the captured step: momentum_bucket's launches (path
                headline_clip_decay), the rate fetched at each step
                equal to the schedule at the step counter's value, img/s
                beside the headline's; (c) each of the eight new update
                rules trains fp32 ResNet-50 (NHWC 224x224x3, batch 32)
                for 3 steps, graph and interpreter bitwise equal, step
                ms; the phase's seconds ([tail_ops] lines)
 11. flash    — the flash-attention kernels (both wgmma fed by TMA; f32
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
import threading
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
PARALLEL_WARM = 1
PARALLEL_CALLS = 3
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
# the sequence configs (benchmark/fluid's stacked_dynamic_lstm and
# machine_translation) in f32 with Adam, as fluid_benchmark.py runs them:
# batch 128, iters=10 a call, 1 warm + 3 timed calls; every ragged feed
# tail-padded to one flat total, the steps' largest rounded up to a
# multiple of SEQ_BUCKET tokens (fluid_benchmark.bucket_totals). The
# LSTM's loop bound is --max_seq_len 128 (the longest synthetic review
# has 127 tokens); the NMT's are seq_to_seq_net's defaults, 32 and 32.
SEQ_BATCH = 128
SEQ_K = 10
SEQ_WARM = 1
SEQ_CALLS = 3
SEQ_BUCKET = 64
LSTM_MAX_LEN = 128
IMDB_VOCAB = 5148
WMT_DICT = 30000
# host vs card at full width: 3 steps at this batch (the host's f32
# matmuls over the 30000-word softmax set its size)
SEQ_PARITY_BATCH = 16
# a fetched dropout mask keeps 1 - p of its elements within this: the
# smallest mask checked holds 64 x 512 elements, whose keep fraction's
# standard deviation at p = 0.5 is 2.8e-3
KEEP_TOL = 0.01

# phase serve: the saved headline network served under bf16 AMP, buckets
# 1..32; parity over 16 requests of 1-4 rows (rtol PARITY_AMP_RTOL against
# the host's f32, SERVE_FOLD_RTOL folded against unfolded in f32 on the
# card, each with an atol of rtol x the row's largest probability);
# each bucket's replay timed over 50 runs; closed-loop loads of one-image
# requests from C client threads: (C, requests)
SERVE_MAX_BATCH = 32
SERVE_TRAIN_STEPS = 3
SERVE_PARITY_REQUESTS = 16
SERVE_FOLD_RTOL = 1e-4
SERVE_REPLAYS = 50
SERVE_LOADS = ((64, 2048), (1, 256))
SERVE_HTTP_REQUESTS = 4
SERVE_DRAIN_BACKLOG = 128

# phase tail_ops: (a) each op type of the single-device tail on the card
# and on the host, at NMT's target logits (the 1,472-token bucket total x
# the 30,000-word dictionary), ResNet-50's last activation at the
# headline's batch, and the update rules over ResNet-50's parameter lanes;
# within TAIL_RTOL (the parity phase's fp32 rtol) of each array's largest
# magnitude, the rules within TAIL_RULE_ULPS units in the last place at
# the array's scale. (b) the headline with GradientClipByGlobalNorm(1.0) and
# exponential_decay(0.01, TAIL_DECAY_STEPS, 0.5) on fused Momentum, bf16,
# batch 128, TAIL_WARM + TAIL_CALLS calls of iters=TAIL_K. (c) the eight
# new update rules on fp32 ResNet-50 at batch 32: TAIL_OPT_STEPS steps,
# graph against interpreter, then TAIL_OPT_TIMED replays timed
TAIL_LOGITS = (1472, 30000)
TAIL_ACT = (128, 2048, 7, 7)
TAIL_LANES = 25557032
TAIL_RTOL = 1e-4
TAIL_RULE_ULPS = 4
TAIL_DECAY_STEPS = 10
TAIL_K = 10
TAIL_WARM = 1
TAIL_CALLS = 3
TAIL_OPT_STEPS = 3
TAIL_OPT_TIMED = 3
TAIL_OPTIMIZERS = {
    "adamax": lambda f: f.optimizer.Adamax(learning_rate=1e-3),
    "adagrad": lambda f: f.optimizer.Adagrad(learning_rate=0.01),
    "decayed_adagrad": lambda f: f.optimizer.DecayedAdagrad(
        learning_rate=0.01),
    "adadelta": lambda f: f.optimizer.Adadelta(learning_rate=1.0),
    "rmsprop": lambda f: f.optimizer.RMSProp(learning_rate=1e-3,
                                             momentum=0.9),
    "ftrl": lambda f: f.optimizer.Ftrl(learning_rate=0.01, l1=1e-4,
                                       l2=1e-4),
    "proximal_gd": lambda f: f.optimizer.ProximalGD(learning_rate=0.01,
                                                    l1=1e-5),
    "proximal_adagrad": lambda f: f.optimizer.ProximalAdagrad(
        learning_rate=0.01, l2=1e-4),
}

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
    # the adam kernel's 16-byte global loads and stores
    sass["adam_kernel"] = sass_counts(ext.__file__, "adam_kernel",
                                      (r"LDG\.E\S*\.128", r"STG\.E\S*\.128"))
    if not any("TF32" in form
               for form in sass["flash_fwd_tf32_kernel"]["HGMMA_forms"]):
        raise AssertionError("flash_fwd_tf32_kernel: no TF32 HGMMA")
    return sass


def sass_counts(library, kernel, opcodes):
    """How many instructions the SASS of `kernel` in the built `library`
    holds (cuobjdump -sass) of each opcode in `opcodes` (regular
    expressions matched at the opcode's start), the distinct HGMMA forms
    and its registers and stack (cuobjdump -res-usage); fails on a count
    of 0."""
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
    counts = {op: sum(bool(re.match(op, o)) for o in ops) for op in opcodes}
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


def build_resnet50(optimizer=None, quiet=False):
    """ResNet-50 NHWC 224x224x3, 1000 classes, fp32, trained by
    Momentum(0.01, 0.9), or by `optimizer(fluid)`; with its fusion plan's
    momentum buckets."""
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
        if optimizer is None:
            fluid.optimizer.Momentum(learning_rate=0.01,
                                     momentum=0.9).minimize(loss)
        else:
            optimizer(fluid).minimize(loss)
    main.random_seed = startup.random_seed = SEED
    _, plan = fusion.apply(main, feed_names=["data", "label"],
                           fetch_names=[loss.name])
    buckets = [] if plan is None else [b for b in plan.buckets
                                       if b["opt"] == "momentum"]
    if quiet:
        return main, startup, loss, buckets
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


def _operands(members, gen, kind, misaligned=False):
    """One bucket's operand lists on the card for `members` [(shape, grad
    dtype)]: p, g in its dtype, and the accumulators (v for momentum; m1,
    m2 >= 0 for adam). With `misaligned`, the first member's operands are
    views 4 bytes (one f32 element, not 16 bytes) into their buffers."""
    lists = []
    for j in range(3 if kind == "momentum" else 4):
        lst = []
        for k, (shape, gdtype) in enumerate(members):
            off = 1 if misaligned and k == 0 else 0
            t = torch.randn(int(np.prod(shape)) + off, generator=gen,
                            device="cuda")[off:].view(shape)
            if j == 1:
                t = t.to(gdtype)
            elif j == 3:
                t = t.abs()
            lst.append(t)
        lists.append(lst)
    return lists


def _adam_inplace_bitwise(members, gen, lr_t, err, what, misaligned):
    """adam_bucket_ over one bucket's members against its plain twin on
    the card, both in place on copies of the same operands."""
    from paddle_tpu_torch.fusion import kernels as fk

    ps, gs, m1s, m2s = _operands(members, gen, "adam", misaligned)
    want = [[t.clone() for t in lst] for lst in (ps, m1s, m2s)]
    fk.adam_bucket_plain_(want[0], gs, want[1], want[2], lr_t, 0.9, 0.999,
                          1e-8)
    fk.adam_bucket_(ps, gs, m1s, m2s, lr_t, 0.9, 0.999, 1e-8)
    for got, ref in zip((ps, m1s, m2s), want):
        _bitwise("adam_bucket", got, ref, err, what)


def bucket_members(main, buckets, dtypes=None):
    """[[(shape, grad dtype) of each member] of each fused bucket]: the
    members' shapes as `main` declares them, their grads f32 unless
    `dtypes` ({param: dtype}, from grad_dtypes) says otherwise."""
    gb = main.global_block()
    return [[(tuple(gb.var(p).shape), (dtypes or {}).get(p, torch.float32))
             for p in b["params"]] for b in buckets]


def grad_dtypes(main, startup, buckets, feed):
    """{param: the dtype its gradient has} for every member of `buckets`,
    from one interpreter step of `main` on the card under bf16 AMP, as
    the fused update receives them; `feed` holds a batch of 2."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, flags
    from paddle_tpu_torch.core.framework import grad_var_name

    params = [p for b in buckets for p in b["params"]]
    exe = fluid.Executor()
    with fluid.scope_guard(fluid.Scope()), \
            flags.flag_guard(fuse=True, cuda_graph=False):
        exe.run(startup)
        amp.enable("bfloat16")
        try:
            grads = exe.run(main, feed=feed, return_numpy=False,
                            fetch_list=[grad_var_name(p) for p in params])
        finally:
            amp.disable()
    dtypes = dict(zip(params, (g.dtype for g in grads)))
    del exe, grads
    _release()
    return dtypes


def phase_kernels(paths, members):
    """Each kernel against its plain twin at the fixed sizes and at every
    bucket size of every path's fusion plan, the in-place adam update at
    every adam bucket's member shapes, then timed over the buckets one step
    of each path updates. `paths`: {kernel: {path: bucket numels}}, the
    row's own path first (ResNet-50's momentum buckets, the headline's;
    VGG-16's adam buckets, the adam kernel's largest). `members`: {kernel:
    {path: [[(shape, grad dtype) of each member] of each bucket]}}."""
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
        # in place: the bucket [n, n // 3 + 1, 5], grads bf16 / f32 / bf16,
        # aligned and with its first member 4 bytes off
        for misaligned in (False, True):
            _adam_inplace_bitwise(
                [((n,), torch.bfloat16), ((n // 3 + 1,), torch.float32),
                 ((5,), torch.bfloat16)], gen, lr_t, err,
                f"in place, n={n}, misaligned={misaligned}", misaligned)
        del p, g, v, m1, m2
    # every adam bucket's members: the grads in the dtypes its path gives
    # them, aligned; then each grad in the other dtype, the first member 4
    # bytes off
    flip = {torch.float32: torch.bfloat16, torch.bfloat16: torch.float32}
    shapes = 0
    for path, plan in members["adam_bucket"].items():
        for k, bucket in enumerate(plan):
            _adam_inplace_bitwise(bucket, gen, lr_t, err,
                                  f"in place, {path} bucket {k}", False)
            _adam_inplace_bitwise([(s, flip[d]) for s, d in bucket], gen,
                                  lr_t, err, f"in place, {path} bucket {k}, "
                                  f"grad dtypes flipped, misaligned", True)
            shapes += len(bucket)
    torch.cuda.synchronize()
    log(f"[kernels] bitwise equal to the plain twins at n in {sizes} "
        f"(every bucket size: {buckets}); adam_bucket_ in place at those n "
        f"and at the {shapes} member shapes of every adam bucket, with bf16 "
        f"and f32 grads and a misaligned member")

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
        for path, plan in members[name].items():
            if name == "adam_bucket":
                timed[path]["in_place"] = _time_adam_members(
                    path, plan, gen, copy_gb_per_s)
            else:
                timed[path]["op_route"] = _time_momentum_route(
                    path, plan, gen, timed[path]["ms"])
        own = timed[next(iter(by_path))]
        if name == "adam_bucket":  # the main path runs the in-place entry
            own = own["in_place"]
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


def _numel(members):
    return sum(int(np.prod(s)) for s, _ in members)


def _adam_op_before(ps, gs, m1s, m2s, scalars):
    """The fused adam op as it ran before it updated in place: the members
    packed into four lanes (torch.cat), the grad lane cast to f32, the
    flat kernel into three fresh lanes, sliced back; then the captured
    step's write-back copies into the scope's tensors."""
    from paddle_tpu_torch.fusion import kernels as fk
    from paddle_tpu_torch.ops import fused_ops

    p, m1, m2 = (fused_ops._pack(t, 0) for t in (ps, m1s, m2s))
    g = fused_ops._pack(gs, 0).to(p.dtype)
    lr, b1p, b2p = (scalars[s][0].reshape(()) for s in
                    ("LearningRate", "Beta1Pow", "Beta2Pow"))
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    lanes = fk.adam_bucket(p, g, m1, m2, lr_t, 0.9, 0.999, 1e-8)
    for dsts, lane in zip((ps, m1s, m2s), lanes):
        for dst, new in zip(dsts, fused_ops._unpack(lane, dsts, 0)):
            dst.copy_(new)


def _time_adam_members(path, plan, gen, copy_gb_per_s):
    """adam over one step's buckets as the main path runs it: the members
    in place (adam_bucket_), each grad in its path's dtype, on rotating
    copies beyond the L2; beside its plain twin, the same lists with f32
    grads through the kernel and through torch._fused_adam_ (which takes
    one dtype for all its lists), and the op routes: the fused op now
    (lr_t and adam_bucket_) and as it ran before (pack, flat kernel,
    write-back)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor_core, registry
    from paddle_tpu_torch.fusion import kernels as fk

    n = sum(_numel(b) for b in plan)
    nbytes = sum(int(np.prod(s)) * (26 if d == torch.bfloat16 else 28)
                 for b in plan for s, d in b)
    sets = max(1, -(-2 * L2_BYTES // nbytes))
    lists = [[_operands(b, gen, "adam") for b in plan] for _ in range(sets)]
    f32 = [[(ps, [g.float() for g in gs], m1s, m2s)
            for ps, gs, m1s, m2s in one] for one in lists]
    lr_t = torch.full((), 3.3e-4, device="cuda")
    scalars = {s: [torch.full((1,), x, device="cuda")] for s, x in
               (("LearningRate", 1e-3), ("Beta1Pow", 0.9 ** 3),
                ("Beta2Pow", 0.999 ** 3))}
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8, "shard_rows": 0}
    op = registry.lookup("fused_adam_update")
    ctx = executor_core.OpContext(fluid.CUDAPlace(0))
    step = torch.ones((), device="cuda")

    def kern(lists=lists):
        for one in lists:
            for ps, gs, m1s, m2s in one:
                fk.adam_bucket_(ps, gs, m1s, m2s, lr_t, 0.9, 0.999, 1e-8)

    def plain():
        for one in lists:
            for ps, gs, m1s, m2s in one:
                fk.adam_bucket_plain_(ps, gs, m1s, m2s, lr_t, 0.9, 0.999,
                                      1e-8)

    def lib():
        for one in f32:
            for ps, gs, m1s, m2s in one:
                torch._fused_adam_(
                    ps, gs, m1s, m2s, [], [step] * len(ps), lr=1e-3,
                    beta1=0.9, beta2=0.999, weight_decay=0.0, eps=1e-8,
                    amsgrad=False, maximize=False)

    def op_now():
        for one in lists:
            for ps, gs, m1s, m2s in one:
                registry.run_kernel(op, ctx, dict(
                    scalars, Param=ps, Grad=gs, Moment1=m1s, Moment2=m2s),
                    attrs)

    def op_before():
        for one in lists:
            for ps, gs, m1s, m2s in one:
                _adam_op_before(ps, gs, m1s, m2s, scalars)

    r = {"ms": _graph_ms(kern) / sets, "plain_ms": _graph_ms(plain) / sets,
         "f32_grads_ms": _graph_ms(lambda: kern(f32)) / sets,
         "library_ms": _graph_ms(lib) / sets,
         "op_ms": _graph_ms(op_now) / sets,
         "op_before_ms": _graph_ms(op_before) / sets,
         "op_ms_again": _graph_ms(op_now) / sets,
         "op_before_ms_again": _graph_ms(op_before) / sets,
         "single_call_ms": _time_ms(lambda: kern(lists[:1])),
         "members": [len(b) for b in plan], "numel": n,
         "bf16_grads": sum(d == torch.bfloat16 for b in plan for _, d in b),
         "rotating_sets": sets, "bytes": nbytes,
         "f32_grads_bytes": 28 * n,
         "library_inputs": "the same member lists, grads in f32 "
                           "(torch._fused_adam_ takes one dtype)"}
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, 12 * n / FP32_FLOPS
    r.update(bound_ms=max(bytes_s, ops_s) * 1e3,
             bound_by="bytes" if bytes_s >= ops_s else "operations",
             f32_grads_bound_ms=28 * n / HBM_BYTES_PER_S * 1e3,
             copy_bound_ms=nbytes / (copy_gb_per_s * 1e9) * 1e3,
             gb_per_s=nbytes / (r["ms"] * 1e-3) / 1e9)
    log(f"[kernels] adam_bucket_ in place, {path}'s {len(plan)} bucket(s) "
        f"of {r['members']} members ({n} elements, {r['bf16_grads']} bf16 "
        f"grads, {nbytes / 1e6:.1f} MB; {sets} rotating set(s)): "
        f"{r['ms']:.4f} ms ({r['gb_per_s']:.0f} GB/s, "
        f"{r['bound_ms'] / r['ms']:.3f} of the {r['bound_ms']:.4f} ms bound; "
        f"at the copy rate {r['copy_bound_ms']:.4f}); plain twin "
        f"{r['plain_ms']:.4f} ms; all grads f32: kernel "
        f"{r['f32_grads_ms']:.4f} ms, torch._fused_adam_ "
        f"{r['library_ms']:.4f} ms (bound {r['f32_grads_bound_ms']:.4f}); "
        f"one call {r['single_call_ms']:.4f} ms. The fused op: in place "
        f"{r['op_ms']:.4f} / {r['op_ms_again']:.4f} ms, as before (pack + "
        f"flat kernel + write-back) {r['op_before_ms']:.4f} / "
        f"{r['op_before_ms_again']:.4f} ms")
    del lists, f32
    return r


def _time_momentum_route(path, plan, gen, kernel_ms):
    """The fused momentum op route as a step runs it (pack, cast, flat
    kernel, slices, the captured step's write-back copies) over one step's
    buckets, grads in the path's dtypes, on rotating copies beyond the L2,
    beside the kernel alone on flat f32 lanes of the same buckets
    (`kernel_ms`, timed in this run)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor_core, registry

    n = sum(_numel(b) for b in plan)
    gbytes = sum(int(np.prod(s)) * (2 if d == torch.bfloat16 else 4)
                 for b in plan for s, d in b)
    sets = max(1, -(-2 * L2_BYTES // (16 * n + gbytes)))
    lists = [[_operands(b, gen, "momentum") for b in plan]
             for _ in range(sets)]
    lr = [torch.full((1,), 0.01, device="cuda")]
    attrs = {"mu": 0.9, "use_nesterov": False, "shard_rows": 0}
    op = registry.lookup("fused_momentum_update")
    ctx = executor_core.OpContext(fluid.CUDAPlace(0))

    def route():
        for one in lists:
            for ps, gs, vs in one:
                outs = registry.run_kernel(
                    op, ctx, {"Param": ps, "Grad": gs, "Velocity": vs,
                              "LearningRate": lr}, attrs)
                for dst, new in zip(ps + vs, outs["ParamOut"]
                                    + outs["VelocityOut"]):
                    dst.copy_(new)

    r = {"ms": _graph_ms(route) / sets, "kernel_ms": kernel_ms,
         "members": [len(b) for b in plan], "numel": n,
         "bf16_grads": sum(d == torch.bfloat16 for b in plan for _, d in b),
         "rotating_sets": sets}
    r["pack_and_write_back_ms"] = r["ms"] - kernel_ms
    log(f"[kernels] fused_momentum_update op route, {path}'s {len(plan)} "
        f"buckets of {r['members']} members ({n} elements, "
        f"{r['bf16_grads']} bf16 grads; {sets} rotating set(s)): "
        f"{r['ms']:.4f} ms against the kernel alone {kernel_ms:.4f} ms: "
        f"pack, cast and write-back {r['pack_and_write_back_ms']:.4f} ms")
    del lists
    return r


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


def _graph_ms(fn, replays=GRAPH_REPLAYS):
    """ms of one fn(), from a CUDA graph of one fn() replayed `replays`
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
        for _ in range(replays):
            graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / replays)
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


def trace_step(exe, main, feed, fetch, kernel="momentum_kernel",
               table=None):
    """One step traced on the card only, which adds little host time:
    (wall ms, device busy ms, idle share, rows of `kernel`, device ms of
    the random draws: torch's distribution kernels, behind dropout's
    masks). `fetch` is the fetch list the step was prepared (and
    captured) with. With `table`, the device time by kernel goes whole to
    chiprun_out/<table>_profile.txt and its top 10 to the log."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=fetch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    rows = sum(e.count for e in device if kernel in e.key)
    if table is not None:
        device.sort(key=lambda e: -e.self_device_time_total)
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, f"{table}_profile.txt"), "w") as f:
            for e in device:
                f.write(f"{e.self_device_time_total / 1e3:10.3f} "
                        f"{e.count:7d}  {e.key}\n")
        log(f"[profile] {table}: {sum(e.count for e in device)} device "
            f"rows; top 10 by device ms (calls):")
        for e in device[:10]:
            log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} "
                f"({e.count:5d})  {e.key[:70]}")
    draw_ms = sum(e.self_device_time_total for e in device
                  if "distribution" in e.key) / 1e3
    return wall_ms, busy_ms, 1 - busy_ms / wall_ms, rows, draw_ms


def profile_step(exe, main, feed, fetch, warm_ms, name,
                 kernel="momentum_kernel"):
    """Two more steps under torch.profiler. The first traces the card only:
    its wall and device-busy time give the device idle share of one step
    (returned as trace_step returns them). The second also records the
    host ops, for the table of device time by op and kernel (all rows in
    chiprun_out/<name>_profile.txt, the top 10 and the count of torch.cat
    kernels printed)."""
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
                                      row_limit=-1)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"{name}_profile.txt"), "w") as f:
        f.write(table)
    cats = sum(e.count for e in top if "CatArrayBatchedCopy" in e.key)
    log(f"[profile] {name}: step traced with host ops: wall {wall_ms:.2f} "
        f"ms, device busy {_device_ms(prof):.2f} ms; {cats} torch.cat "
        f"kernels; top 10 by device ms (calls):")
    for e in top[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} "
            f"({e.count:5d})  {e.key[:70]}")
    return card


def headline_net():
    """The headline's network in the current program: raw uint8 NHWC
    224x224x3 pixels ("data_u8") cast and scaled on the card, ResNet-50,
    1000 classes. Returns the softmax prediction. Serving builds it alone
    as its inference function; the names match the training program's
    under a fresh unique_name.guard()."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.resnet import resnet_imagenet

    raw = fluid.layers.data(name="data_u8", shape=[224, 224, 3],
                            dtype="uint8")
    img = fluid.layers.scale(fluid.layers.cast(raw, "float32"),
                             scale=1.0 / 255.0)
    return resnet_imagenet(img, 1000, depth=50, layout="NHWC")


def build_headline(with_prediction=False):
    """bench.py's headline program (bench.py:105-124) built with the port:
    raw uint8 NHWC pixels cast and scaled on the card, int32 labels,
    ResNet-50, Momentum(0.01, 0.9); with its fusion plan's momentum
    buckets (and, `with_prediction`, the softmax prediction last)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import fusion

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        prediction = headline_net()
        label = fluid.layers.data(name="label", shape=[1], dtype="int32")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(
            input=prediction, label=label))
        fluid.optimizer.Momentum(learning_rate=0.01,
                                 momentum=0.9).minimize(loss)
    main.random_seed = startup.random_seed = SEED
    _, plan = fusion.apply(main, feed_names=["data_u8", "label"],
                           fetch_names=[loss.name])
    buckets = [b for b in plan.buckets if b["opt"] == "momentum"]
    if with_prediction:
        return main, startup, loss, buckets, prediction
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
    first = next(iter(batches[0].values()))
    batch = (first.batch if hasattr(first, "lengths")
             else first.shape[0])
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


class _PERunner:
    """A ParallelExecutor behind the Executor.run / step_mode calls that
    _timed_calls and trace_step make."""

    def __init__(self, pe):
        self.pe = pe

    def run(self, main, feed, fetch_list, iters=None, return_numpy=True):
        return self.pe.run(fetch_list, feed=feed, iters=iters,
                           return_numpy=return_numpy)

    def step_mode(self, main):
        return self.pe.step_mode()


def _pe_vs_executor(main, fetch, init, batches):
    """The steps of `batches` from the same state through the Executor and
    through ParallelExecutor over the one-rank group, both on the captured
    step with cuDNN deterministic: every fetch and every persistable
    bitwise (a one-rank sum is a copy, and the global mean is one rank's
    mean over one); a difference is printed and then held to rtol 1e-6."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert

    place = fluid.CUDAPlace(0)
    out = {}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for mode in ("executor", "parallel_executor"):
            scope = fluid.Scope()
            convert.load_numpy_state(scope, main, init, place)
            with fluid.scope_guard(scope):
                runner = (fluid.Executor() if mode == "executor" else
                          _PERunner(fluid.ParallelExecutor(
                              use_cuda=True, loss_name=fetch[0].name,
                              main_program=main)))
                fetched = [runner.run(main, feed=b, fetch_list=fetch)
                           for b in batches]
                if runner.step_mode(main) != "graph":
                    raise AssertionError(f"{mode} ran its steps as "
                                         f"{runner.step_mode(main)!r}")
            out[mode] = (np.stack([f[0] for f in fetched]).reshape(-1),
                         convert.numpy_state(scope, main))
            del runner, scope
            _release()
    finally:
        torch.backends.cudnn.deterministic = prev
    (el, es), (pl, ps) = out["executor"], out["parallel_executor"]
    diff = {n: float(np.abs(ps[n].astype(np.float64) - es[n]).max())
            for n in es if not np.array_equal(ps[n], es[n])}
    equal = np.array_equal(pl, el) and not diff
    log(f"[parallel] ParallelExecutor (one NCCL rank) vs Executor, "
        f"{len(batches)} steps at batch {BATCH} from one state (cuDNN "
        f"deterministic): losses {pl.tolist()} / {el.tolist()}; "
        f"{'bitwise equal' if equal else 'DIFFER'} over the loss and "
        f"{len(es)} persistables" + ("" if equal else
                                     f": {len(diff)} differ, largest "
                                     f"{sorted(diff.items(), key=lambda kv: -kv[1])[:5]}"))
    if not equal:
        np.testing.assert_allclose(pl, el, rtol=1e-6)
        for n in es:
            np.testing.assert_allclose(ps[n], es[n], rtol=1e-6, err_msg=n)
    return {"equal": equal, "losses": pl.tolist(), "n_differ": len(diff)}


def phase_parallel(card, executor_img_s):
    """bench.py's headline program through ParallelExecutor over a one-rank
    NCCL group: the captured step with its collectives inside, timed as
    the headline; one replay's collective launches; a replayed step
    traced; PE vs Executor bitwise."""
    import tempfile

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, convert, flags
    from paddle_tpu_torch.fusion import kernels as fk
    from paddle_tpu_torch.ops import collective_ops
    from paddle_tpu_torch.parallel import distributed

    t0 = time.perf_counter()
    rendezvous = tempfile.mkdtemp()
    distributed.initialize(
        "file://" + os.path.join(rendezvous, "rendezvous"), 1, 0,
        local_device_ids=[0])
    main, startup, loss, buckets = build_headline()
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
              "warm_calls": PARALLEL_WARM, "timed_calls": PARALLEL_CALLS,
              "ranks": torch.distributed.get_world_size(),
              "backend": torch.distributed.get_backend()}
    amp.enable("bfloat16")
    try:
        with flags.flag_guard(fuse=True):
            init_scope = fluid.Scope()
            with fluid.scope_guard(init_scope):
                fluid.Executor(place).run(startup)
            init = convert.numpy_state(init_scope, main)
            del init_scope

            scope = fluid.Scope()
            convert.load_numpy_state(scope, main, init, place)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fk.reset_launch_counts()
            collective_ops.reset_launch_counts()
            with fluid.scope_guard(scope):
                runner = _PERunner(fluid.ParallelExecutor(
                    use_cuda=True, loss_name=loss.name, main_program=main))
                dt, outs = _timed_calls(runner, main, feeds, [loss],
                                        HEADLINE_K, PARALLEL_WARM,
                                        PARALLEL_CALLS)
                lv = _losses(outs[0])
                torch.cuda.synchronize()
                steps = (PARALLEL_WARM + PARALLEL_CALLS) * HEADLINE_K
                launches = fk.momentum_bucket.launches
                collectives = collective_ops.launch.launches
                mode = runner.step_mode(main)
                if mode != "graph":
                    raise AssertionError(f"the PE headline ran as {mode!r}")
                if launches != len(buckets) * steps:
                    raise AssertionError(
                        f"momentum kernel launched {launches} times under "
                        f"PE, expected {len(buckets)} buckets x {steps} "
                        f"steps")
                if not np.all(np.isfinite(lv)):
                    raise AssertionError(f"non-finite PE loss {lv}")
                _check_master_state(scope)
                img_s = HEADLINE_BATCH * HEADLINE_K * PARALLEL_CALLS / dt
                result.update(
                    step_mode=mode, images_per_sec=img_s,
                    step_ms=dt / (HEADLINE_K * PARALLEL_CALLS) * 1e3,
                    executor_images_per_sec=executor_img_s,
                    pe_over_executor=img_s / executor_img_s,
                    peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                    momentum_launches=launches, steps=steps,
                    collective_launches=collectives,
                    last_losses=[float(v) for v in lv[-3:]])
                step0 = {n: t[0] for n, t in feeds.items()}
                collective_ops.reset_launch_counts()
                runner.run(main, feed=step0, fetch_list=[loss])
                torch.cuda.synchronize()
                per_replay = collective_ops.launch.launches
                if per_replay <= 0:
                    raise AssertionError("no collective ran in a replay of "
                                         "the PE step")
                wall, busy, idle, rows, _ = trace_step(runner, main, step0,
                                                       [loss])
                result.update(collective_launches_per_replay=per_replay,
                              trace_wall_ms=wall, trace_busy_ms=busy,
                              idle_share=idle, momentum_rows=rows)
                log(f"[parallel] {card}: ParallelExecutor over "
                    f"{result['ranks']} {result['backend']} rank: "
                    f"step_mode {mode}; resnet50_train_images_per_sec "
                    f"{img_s:.2f} ({result['step_ms']:.2f} ms a step; "
                    f"{PARALLEL_CALLS} calls of iters={HEADLINE_K} in "
                    f"{dt:.3f} s after {PARALLEL_WARM} warm) beside the "
                    f"Executor's {executor_img_s:.2f} in this run (ratio "
                    f"{result['pe_over_executor']:.4f}); collective launches "
                    f"in one replay {per_replay} ({collectives} over "
                    f"{steps} steps, the eager step's included); "
                    f"momentum_bucket launches {launches}; peak mem "
                    f"{result['peak_mem_gib']:.2f} GiB; one replayed step "
                    f"traced on the card only: wall {wall:.2f} ms, device "
                    f"busy {busy:.2f} ms, idle share {idle:.3f}, "
                    f"momentum_kernel rows {rows}")
            del runner, scope
            _release()
            result["bitwise"] = _pe_vs_executor(
                main, [loss], init,
                [{n: t[k, :BATCH] for n, t in feeds.items()}
                 for k in range(3)])
            if not result["bitwise"]["equal"]:
                raise AssertionError("ParallelExecutor over one rank is not "
                                     "bitwise equal to the Executor")
    finally:
        amp.disable()
        torch.distributed.destroy_process_group()
    result["seconds"] = time.perf_counter() - t0
    log(f"[parallel] phase seconds {result['seconds']:.1f}")
    return result


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


def seq_batches(model, rs, steps, batch):
    """`steps` batches of `batch` samples drawn as the JAX package's
    synthetic readers draw them (paddle_tpu/dataset/imdb.py
    _synthetic_reader, wmt14.py _reader): reviews of 16..127 word ids, 70%
    from their class's half of the vocabulary, and a 0/1 label; source
    sentences of 4..15 ids, the target a token-wise function of the source
    after <s> (id 0), the label the target shifted, ending in <e> (id 1).
    Each batch is {feed name: list of per-sequence id arrays, or an
    array}."""
    out = []
    for _ in range(steps):
        if model == "stacked_lstm":
            half = IMDB_VOCAB // 2
            words, labels = [], []
            for _ in range(batch):
                y, n = rs.randint(2), rs.randint(16, 128)
                biased = rs.randint(y * half, y * half + half, n)
                noise = rs.randint(0, IMDB_VOCAB - 1, n)
                words.append(np.where(rs.rand(n) < 0.7, biased, noise))
                labels.append(y)
            out.append({"words": words, "label": np.asarray(
                labels, np.int64).reshape(-1, 1)})
        else:
            src, trg, lab = [], [], []
            for _ in range(batch):
                s = rs.randint(3, WMT_DICT, rs.randint(4, 16))
                t = (s * 17 + 3) % (WMT_DICT - 3) + 3
                src.append(s)
                trg.append(np.concatenate([[0], t]))
                lab.append(np.concatenate([t, [1]]))
            out.append({"source_sequence": src, "target_sequence": trg,
                        "label_sequence": lab})
    return out


def seq_tokens(model, batch):
    """The words of a batch as fluid_benchmark.tokens_in_batch counts
    them: review tokens; target tokens for the NMT."""
    key = "words" if model == "stacked_lstm" else "target_sequence"
    return sum(len(s) for s in batch[key])


def seq_feeds(batches, place):
    """Per-step feed dicts: every ragged feed bucketed with
    create_bucketed_seq_tensor on `place` to one flat total, the batches'
    largest rounded up to SEQ_BUCKET; dense feeds as they are. Returns
    (feeds, {name: flat total})."""
    import paddle_tpu_torch as fluid

    ragged = [n for n, v in batches[0].items() if isinstance(v, list)]
    totals = {n: -(-max(sum(len(s) for s in b[n]) for b in batches)
                   // SEQ_BUCKET) * SEQ_BUCKET for n in ragged}
    return [{n: fluid.create_bucketed_seq_tensor(v, totals[n], place)
             if n in totals else v for n, v in b.items()}
            for b in batches], totals


def _stacked(feeds):
    """Per-step feed dicts -> one dict of [K, ...] values on the card, a
    SeqTensor's data, lengths and host lengths stacked componentwise."""
    from paddle_tpu_torch.core.registry import SeqTensor

    out = {}
    for n, v in feeds[0].items():
        vals = [f[n] for f in feeds]
        if isinstance(v, SeqTensor):
            out[n] = SeqTensor(torch.stack([x.data for x in vals]),
                               torch.stack([x.lengths for x in vals]),
                               np.stack([x.host_lengths for x in vals]))
        else:
            out[n] = torch.from_numpy(np.stack(vals)).cuda()
    return out


def build_seq_model(model):
    """One of the benchmark/fluid sequence configs built with the port, as
    the JAX package's get_model builds it, with its fusion plan:
      stacked_lstm: stacked_lstm_net over the IMDB vocabulary (5148), 512
                    wide, max_len 128, Adam();
      nmt:          seq_to_seq_net(512, 512, 512, 30000, 30000),
                    Adam(2e-4).
    Returns the fused adam buckets and the params left to plain adam ops
    (a member alone over the bucket budget)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import fusion
    from paddle_tpu_torch.models import machine_translation as mt
    from paddle_tpu_torch.models import stacked_dynamic_lstm as sl

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        if model == "stacked_lstm":
            loss, _ = sl.stacked_lstm_net(IMDB_VOCAB, max_len=LSTM_MAX_LEN)
            opt = fluid.optimizer.Adam()
            feeds = ["words", "label"]
        else:
            loss, _ = mt.seq_to_seq_net(512, 512, 512, WMT_DICT, WMT_DICT)
            opt = fluid.optimizer.Adam(learning_rate=2e-4)
            feeds = ["source_sequence", "target_sequence", "label_sequence"]
        opt.minimize(loss)
    main.random_seed = startup.random_seed = SEED
    fused, plan = fusion.apply(main, feed_names=feeds,
                               fetch_names=[loss.name])
    buckets = [b for b in plan.buckets if b["opt"] == "adam"]
    gb = main.global_block()
    plain = {op.input("Param")[0]: int(np.prod(gb.var(op.input("Param")[0])
                                               .shape))
             for op in fused.global_block().ops if op.type == "adam"}
    n_params = sum(int(np.prod(p.shape)) for p in gb.all_parameters())
    log(f"[plan] {model}: {n_params} parameters; {len(buckets)} fused adam "
        f"bucket(s) of {[b['n'] for b in buckets]} members, "
        f"{[b['numel'] for b in buckets]} elements; plain adam ops for "
        f"{plain}; ops {plan.n_ops_before} -> {plan.n_ops_after}")
    return {"name": model, "main": main, "startup": startup, "loss": loss,
            "buckets": buckets, "plain": plain}


LOOP_OPS = ("lstm", "attention_lstm_decoder")


def _loop_forward_ms(main, init, feed, fetch):
    """{op name: ms} of each loop op's forward (LOOP_OPS) at the inputs one
    interpreter step gives it on the card: the op's call alone, captured
    as a CUDA graph and replayed (_graph_ms). Its derived grad runs the
    same forward again."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert, flags
    from paddle_tpu_torch.core import executor_core, registry

    run_one = executor_core._run_one_op
    out = {}

    def timed(op, env, ctx):
        run_one(op, env, ctx)
        if op.type in LOOP_OPS:
            op_def = registry.lookup(op.type)
            ins = {slot: [env[n] if n else None for n in names]
                   for slot, names in op.inputs.items()}
            out[f"{op.type}:{op.output_arg_names()[0]}"] = _graph_ms(
                lambda: registry.run_kernel(op_def, ctx, ins, op.attrs),
                replays=3)

    scope = fluid.Scope()
    convert.load_numpy_state(scope, main, init, fluid.CUDAPlace(0))
    exe = fluid.Executor()
    executor_core._run_one_op = timed
    try:
        with fluid.scope_guard(scope), \
                flags.flag_guard(fuse=True, cuda_graph=False):
            exe.run(main, feed=feed, fetch_list=fetch)
    finally:
        executor_core._run_one_op = run_one
    del exe, scope
    _release()
    return out


def _embedding_grad_bitwise(main, scope, feed):
    """lookup_table_grad of every embedding at the feed's ids and a random
    Out@GRAD, twice on the card: bitwise equal (index_put_ with
    accumulate sorts the ids; index_add_ would add with atomics), and
    within the repo's fp32 bound of the host's (rtol 1e-4; atol 1e-5 for
    rows where a sum of ~100 standard normals cancels). Returns the
    largest difference from the host."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor_core, registry

    op_def = registry.lookup("lookup_table_grad")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    for op in main.global_block().ops:
        if op.type != "lookup_table":
            continue
        ids, w = feed[op.input("Ids")[0]], scope.find_var(op.input("W")[0])
        g = torch.randn((ids.ntokens, w.shape[1]), generator=gen,
                        device="cuda")
        ins = {"Ids": [ids], "W": [w], "Out@GRAD": [g]}
        outs = []
        for place in (fluid.CUDAPlace(0), fluid.CUDAPlace(0),
                      fluid.CPUPlace()):
            dev = "cuda" if isinstance(place, fluid.CUDAPlace) else "cpu"
            moved = {k: [registry.SeqTensor(v.data.to(dev), v.lengths.to(dev))
                         if isinstance(v, registry.SeqTensor) else v.to(dev)
                         for v in vs] for k, vs in ins.items()}
            outs.append(registry.run_kernel(
                op_def, executor_core.OpContext(place), moved,
                dict(op.attrs))["W@GRAD"][0].cpu())
        if not torch.equal(outs[0], outs[1]):
            raise AssertionError(f"lookup_table_grad of {op.input('W')[0]} "
                                 f"differs between two runs on the card")
        np.testing.assert_allclose(outs[0].numpy(), outs[2].numpy(),
                                   rtol=1e-4, atol=1e-5)
        worst = max(worst, float((outs[0] - outs[2]).abs().max()))
    return worst


def _seq_parity(m, init, card_line):
    """3 steps of the full-width model at batch SEQ_PARITY_BATCH on the
    host and on the card from the same weights, fused Adam: losses within
    rtol 1e-4 (the repo's fp32 bound)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert, flags

    batches = seq_batches(m["name"], np.random.RandomState(SEED + 1), 3,
                          SEQ_PARITY_BATCH)
    out = {}
    for place in (fluid.CPUPlace(), fluid.CUDAPlace(0)):
        scope = fluid.Scope()
        convert.load_numpy_state(scope, m["main"], init, place)
        exe = fluid.Executor(place)
        with fluid.scope_guard(scope), flags.flag_guard(fuse=True):
            out[repr(place)] = [
                float(exe.run(m["main"], feed=f,
                              fetch_list=[m["loss"]])[0].reshape(-1)[0])
                for f in seq_feeds(batches, place)[0]]
        del exe, scope
        _release()
    host, card = out["CPUPlace()"], out["CUDAPlace(0)"]
    rel = max(abs(c / h - 1) for c, h in zip(card, host))
    log(f"[{m['name']}] host vs card, 3 steps at batch {SEQ_PARITY_BATCH} "
        f"from one weight set: losses host {host} card {card}; largest "
        f"relative difference {rel:.3e} (rtol 1e-4) [{card_line}]")
    np.testing.assert_allclose(card, host, rtol=1e-4)
    return {"host": host, "card": card, "max_rel": rel}


def phase_seq(m, card_line):
    """A sequence config's training on the captured step, in f32 as
    fluid_benchmark.py runs it: fused Adam, batch SEQ_BATCH,
    Executor.run(iters=SEQ_K) over seeded bucketed feeds stacked on the
    card, SEQ_WARM warm then SEQ_CALLS timed calls, fetching the loss.
    Checks: step_mode "graph", adam_bucket_ launched once a bucket a step,
    finite losses, every persistable f32 on the card; words/s, step ms,
    peak memory; one replayed step traced (idle share, top-10 in
    chiprun_out/); the loop ops' forwards timed alone (each runs again
    inside its derived grad); the embedding grads bitwise run to run; 3
    steps at batch 32 through the graph and the interpreter, bitwise;
    host vs card."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert, flags
    from paddle_tpu_torch.fusion import kernels as fk

    tag, main, loss = m["name"], m["main"], m["loss"]
    batches = seq_batches(tag, np.random.RandomState(SEED), SEQ_K, SEQ_BATCH)
    place = fluid.CUDAPlace(0)
    per_step, totals = seq_feeds(batches, place)
    feeds = _stacked(per_step)
    words = sum(seq_tokens(tag, b) for b in batches)
    seconds = {}
    t0 = time.perf_counter()
    result = {"batch": SEQ_BATCH, "iters": SEQ_K, "warm_calls": SEQ_WARM,
              "timed_calls": SEQ_CALLS, "flat_totals": totals,
              "words_per_call": words, "card": card_line,
              "buckets": [b["numel"] for b in m["buckets"]],
              "plain_adam": m["plain"]}
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
            dt, outs = _timed_calls(exe, main, feeds, [loss], SEQ_K,
                                    SEQ_WARM, SEQ_CALLS)
            torch.cuda.synchronize()
            seconds["setup_and_calls"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            launches = fk.adam_bucket.launches
            steps = (SEQ_WARM + SEQ_CALLS) * SEQ_K
            mode = exe.step_mode(main)
            lv = _losses(outs[0])
            if mode != "graph":
                raise AssertionError(f"{tag} ran as {mode!r}")
            if launches != len(m["buckets"]) * steps:
                raise AssertionError(
                    f"{tag}: adam kernel launched {launches} times, expected "
                    f"{len(m['buckets'])} buckets x {steps} steps")
            if not np.all(np.isfinite(lv)):
                raise AssertionError(f"non-finite {tag} loss {lv}")
            _check_master_state(scope)
            result.update(
                step_mode=mode, words_per_sec=words * SEQ_CALLS / dt,
                step_ms=dt / (SEQ_K * SEQ_CALLS) * 1e3,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                launches=launches, steps=steps,
                last_losses=[float(v) for v in lv[-3:]])
            log(f"[{tag}] {card_line}: graph: {result['words_per_sec']:.1f} "
                f"words/s ({result['step_ms']:.2f} ms a step; {SEQ_CALLS} "
                f"calls of iters={SEQ_K} at batch {SEQ_BATCH}, {words} words "
                f"a call, in {dt:.3f} s after {SEQ_WARM} warm; flat totals "
                f"{totals}); peak mem {result['peak_mem_gib']:.2f} GiB; "
                f"adam_bucket launches {launches} ({len(m['buckets'])} "
                f"bucket(s) of {result['buckets']} x {steps} steps); last "
                f"losses {result['last_losses']}")
            wall, busy, idle, rows, _ = trace_step(
                exe, main, per_step[0], [loss], "adam_kernel",
                table=f"{tag}_graph")
            result.update(trace_wall_ms=wall, trace_busy_ms=busy,
                          idle_share=idle, kernel_rows=rows,
                          idle_share_of_untraced_step=1 - busy
                          / result["step_ms"])
            log(f"[{tag}] {card_line}: one replayed step traced on the card "
                f"only: wall {wall:.2f} ms, device busy {busy:.2f} ms, idle "
                f"share {idle:.3f} (1 - busy / untraced step ms: "
                f"{result['idle_share_of_untraced_step']:.3f}); adam_kernel "
                f"rows {rows}")
            if rows != len(m["buckets"]):
                raise AssertionError(f"{rows} adam_kernel rows in one traced "
                                     f"replay, not {len(m['buckets'])}")
            result["embedding_grad_host_diff"] = _embedding_grad_bitwise(
                main, scope, per_step[0])
        del exe, scope
        _release()
        seconds["traces_and_embedding_grads"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        loops = _loop_forward_ms(main, init, per_step[0], [loss])
        result.update(loop_forward_ms=loops,
                      recompute_share=sum(loops.values()) / result["step_ms"])
        log(f"[{tag}] {card_line}: the loop ops' forwards alone, each "
            f"replayed from a graph at a step's inputs: "
            f"{ {k: round(v, 3) for k, v in loops.items()} } ms; each runs "
            f"again inside its derived grad: that recompute is "
            f"{result['recompute_share']:.3f} of the {result['step_ms']:.2f} "
            f"ms step")
        seconds["loop_forwards"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        small = seq_feeds([{n: v[:BATCH] for n, v in b.items()}
                           for b in batches[:3]], place)[0]
        result["bitwise"] = _graph_vs_interpreter(tag, main, [loss], init,
                                                  small)
        if not result["bitwise"]["equal"]:
            raise AssertionError(f"{tag}: graph and interpreter differ")
        seconds["bitwise"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        result["parity"] = _seq_parity(m, init, card_line)
        seconds["parity"] = time.perf_counter() - t0
    log(f"[{tag}] phase seconds: "
        f"{ {k: round(v, 1) for k, v in seconds.items()} }")
    result["seconds"] = seconds
    del feeds, per_step
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


def _rows_diff(got, want):
    """The largest |got - want| over its row's largest |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    top = np.abs(want).max(axis=-1, keepdims=True)
    return float((np.abs(got - want) / top).max())


def _rows_close(got, want, rtol, what):
    """Hold `got` to `want` elementwise within rtol x (|want| + the row's
    largest |want|): rtol relative where a probability is near its row's
    top, and rtol of the top where it is small. Returns the largest
    difference over the row's largest |want| (a normwise relative
    difference)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        raise AssertionError(f"[serve] {what}: got {got.shape} (finite: "
                             f"{np.all(np.isfinite(got))}), want "
                             f"{want.shape}")
    top = np.abs(want).max(axis=-1, keepdims=True)
    err = np.abs(got - want)
    if np.any(err > rtol * (np.abs(want) + top)):
        raise AssertionError(
            f"[serve] {what}: outside rtol {rtol:g}; largest difference "
            f"{float((err / top).max()):.3e} of its row's top")
    return float((err / top).max())


def _serve_load(server, images, clients, n, replay_ms):
    """`n` one-image requests from `clients` closed-loop client threads
    (each submits, waits for its result, submits the next): wall time,
    served images/s, the server's latency percentiles and pad fraction
    for this load alone (Server.reset_stats), batches by bucket (the
    registry's serve_batches_total), mean rows a batch, and the
    device-busy share: the batches' replay ms (each its bucket's,
    timed alone) over the wall time."""
    from paddle_tpu_torch import monitor

    server.reset_stats()
    before = monitor.registry().snapshot()
    next_request = iter(range(n)).__next__
    errors = []

    def client():
        while True:
            try:
                i = next_request()
            except StopIteration:
                return
            try:
                server.submit({"data_u8": images[i % len(images)]}).result(
                    timeout=120)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
                return

    threads = [threading.Thread(target=client, name=f"serve-client-{k}")
               for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    after = monitor.registry().snapshot()
    key = 'serve_batches_total{{bucket="{}"}}'.format
    batches = {b: int(after.get(key(b), 0) - before.get(key(b), 0))
               for b in replay_ms}
    st = server.stats()
    nb = sum(batches.values())
    return {
        "clients": clients, "requests": n, "wall_s": wall,
        "images_per_sec": n / wall,
        "p50_ms": st["p50_ms"], "p95_ms": st["p95_ms"],
        "p99_ms": st["p99_ms"], "pad_fraction": st["pad_fraction"],
        "batches": nb, "rows_per_batch": st["rows"] / nb,
        "batches_by_bucket": {str(b): c for b, c in batches.items() if c},
        "device_busy_share": sum(c * replay_ms[b]
                                 for b, c in batches.items())
        / (wall * 1e3),
    }


def phase_serve(card_line):
    """The serving slice on the card: the headline's network trained 3
    steps under bf16 AMP and saved with io.save_inference_model, served by
    serve.Server.from_inference_model under bf16 AMP from one captured
    CUDA graph per bucket (1..32); its rows against the host's f32; a
    second server from io.save_params through from_infer_func with the
    InferenceTranspiler's conv+bn fold, in f32, against the unfolded
    program on the card; each bucket's replay timed alone; closed-loop
    loads; HTTP round trips; drain."""
    import tempfile
    import urllib.request

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, cuda_build, flags, monitor, serve
    from paddle_tpu_torch.serve.http import make_http_server

    t_phase = time.perf_counter()
    place = fluid.CUDAPlace(0)
    buckets = [b for b in (1, 2, 4, 8, 16, 32) if b <= SERVE_MAX_BATCH]
    result = {"max_batch": SERVE_MAX_BATCH, "buckets": buckets}
    rs = np.random.RandomState(SEED + 1)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    model_dir = os.path.join(tmp, "model")
    params_dir = os.path.join(tmp, "params")
    server = None
    try:
        # 1. train briefly, so the running statistics move, and save
        main, startup, loss, _, prediction = build_headline(
            with_prediction=True)
        exe = fluid.Executor(place)
        u8 = rs.randint(0, 256, (SERVE_TRAIN_STEPS, BATCH, 224, 224, 3),
                        dtype=np.uint8)
        lab = rs.randint(0, 1000, (SERVE_TRAIN_STEPS, BATCH, 1)).astype(
            np.int32)
        with fluid.scope_guard(fluid.Scope()), flags.flag_guard(fuse=True):
            exe.run(startup)
            with amp.auto_cast():
                losses = [float(exe.run(
                    main, feed={"data_u8": u8[k], "label": lab[k]},
                    fetch_list=[loss])[0].reshape(-1)[0])
                    for k in range(SERVE_TRAIN_STEPS)]
            if not np.all(np.isfinite(losses)):
                raise AssertionError(f"[serve] training losses {losses}")
            fluid.io.save_inference_model(model_dir, ["data_u8"],
                                          [prediction], exe,
                                          main_program=main)
            fluid.io.save_params(exe, params_dir, main_program=main)
        files = os.listdir(model_dir)
        nbytes = sum(os.path.getsize(os.path.join(model_dir, f))
                     for f in files)
        result.update(train_losses=losses, saved_files=len(files),
                      saved_bytes=nbytes)
        log(f"[serve] trained {SERVE_TRAIN_STEPS} steps at batch {BATCH} "
            f"under bf16 AMP (losses {losses}); save_inference_model: "
            f"{len(files)} files, {nbytes} bytes")
        del exe, u8, lab
        _release()

        # the parity requests and their references: the host's f32 and
        # the card's f32 (unfolded), from the saved directory
        sizes = rs.randint(1, 5, SERVE_PARITY_REQUESTS)
        offs = np.concatenate([[0], np.cumsum(sizes)])
        pool = rs.randint(0, 256, (int(offs[-1]), 224, 224, 3),
                          dtype=np.uint8)
        requests = [pool[offs[i]:offs[i + 1]] for i in range(len(sizes))]
        refs = {}
        for name, ref_place in (("host", fluid.CPUPlace()), ("card", place)):
            t0 = time.perf_counter()
            ref_exe = fluid.Executor(ref_place)
            with fluid.scope_guard(fluid.Scope()):
                prog, feeds, fetches = fluid.io.load_inference_model(
                    model_dir, ref_exe)
                refs[name] = ref_exe.run(prog, feed={feeds[0]: pool},
                                         fetch_list=fetches)[0]
            log(f"[serve] f32 reference on the {name}: {len(pool)} rows "
                f"in {time.perf_counter() - t0:.2f} s")
            del ref_exe
        _release()

        # 2. serve the saved directory under bf16 AMP
        amp.enable("bfloat16")
        server = serve.Server.from_inference_model(
            model_dir, place=place,
            config=serve.ServeConfig(max_batch=SERVE_MAX_BATCH))
        server.start()
        warm_ms = monitor.registry().gauge("serve_warmup_ms").value
        modes = server.step_modes()
        if sorted(modes) != buckets \
                or any(m != ["graph"] for m in modes.values()):
            raise AssertionError(f"[serve] step modes {modes}")
        rexe, rscope = server._replicas[0]
        info = rexe.compile_cache_info()
        if info["entries"] != 2 * len(buckets):
            raise AssertionError(f"[serve] compile_cache_info {info}")
        result.update(warmup_ms=warm_ms, step_modes={
            str(b): m[0] for b, m in modes.items()},
            compile_cache_info=info)
        log(f"[serve] {card_line}: Server.from_inference_model warm-up "
            f"{warm_ms:.1f} ms; step modes {result['step_modes']}; "
            f"compile_cache_info {info}")

        # 3. parity: the served bf16 rows against the host's f32
        futs = [server.submit({"data_u8": r}) for r in requests]
        served = [f.result(timeout=120)[0] for f in futs]
        got = np.concatenate(served)
        amp_err = _rows_close(got, refs["host"], PARITY_AMP_RTOL,
                              "served bf16 vs host f32")
        top1 = float(np.mean(got.argmax(-1) == refs["host"].argmax(-1)))
        card_err = _rows_diff(refs["card"], refs["host"])
        # the folded program in f32: a second server, from save_params
        probe = fluid.Program()
        with fluid.program_guard(probe, fluid.Program()), \
                fluid.unique_name.guard():
            headline_net()
        ops_before = [op.type for op in probe.global_block().ops]
        amp.disable()
        folded = serve.Server.from_infer_func(
            headline_net, params_dir, place=place,
            config=serve.ServeConfig(max_batch=4,
                                     max_queue_rows=len(pool)),
            transpile=True)
        ops_after = [op.type for op in folded.program.global_block().ops]
        if "batch_norm" in ops_after:
            raise AssertionError("[serve] a batch_norm was not folded")
        with folded:
            ffuts = [folded.submit({"data_u8": r}) for r in requests]
            fgot = np.concatenate([f.result(timeout=120)[0] for f in ffuts])
            fstats = folded.stats()
        amp.enable("bfloat16")
        if fstats["steady_state_compiles"] != 0 or any(
                m != ["graph"] for m in folded.step_modes().values()):
            raise AssertionError(f"[serve] folded server {fstats}")
        fold_err = _rows_close(fgot, refs["card"], SERVE_FOLD_RTOL,
                               "folded vs unfolded, f32 on the card")
        del folded
        result.update(
            parity_requests=len(requests), parity_rows=len(pool),
            amp_vs_host_max_rel=amp_err, amp_top1_agreement=top1,
            card_vs_host_f32_max_rel=card_err,
            ops_before_fold=len(ops_before), ops_after_fold=len(ops_after),
            batch_norms_folded=ops_before.count("batch_norm"),
            folded_vs_unfolded_max_rel=fold_err)
        log(f"[serve] parity: {len(requests)} requests of 1-4 rows "
            f"({len(pool)} rows): served bf16 vs host f32 largest "
            f"difference {amp_err:.3e} of the row's top (rtol "
            f"{PARITY_AMP_RTOL:g}), top-1 agreement {top1:.3f}; card vs "
            f"host f32 {card_err:.3e}; InferenceTranspiler: "
            f"{len(ops_before)} ops ({ops_before.count('batch_norm')} "
            f"batch_norm, {ops_before.count('elementwise_add')} "
            f"elementwise_add) -> {len(ops_after)} "
            f"({ops_after.count('batch_norm')} batch_norm, "
            f"{ops_after.count('elementwise_add')} elementwise_add); "
            f"folded vs unfolded f32 on the card {fold_err:.3e} (rtol "
            f"{SERVE_FOLD_RTOL:g})")

        # 4. the traffic: each bucket's replay alone, then closed loops
        steps = {cs.feeds["data_u8"].shape[0]: cs
                 for cs in rexe.captured_steps(server.program, rscope)}
        replay_ms = {}
        for b in buckets:
            graph = steps[b].graph
            graph.replay()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(SERVE_REPLAYS):
                graph.replay()
            end.record()
            end.synchronize()
            replay_ms[b] = start.elapsed_time(end) / SERVE_REPLAYS
        full = rs.randint(0, 256, (SERVE_MAX_BATCH, 224, 224, 3),
                          dtype=np.uint8)
        h2d = []
        for _ in range(21):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.from_numpy(full).to(rexe.device)
            torch.cuda.synchronize()
            h2d.append((time.perf_counter() - t0) * 1e3)
        result.update(replay_ms={str(b): v for b, v in replay_ms.items()},
                      h2d_ms=statistics.median(h2d), h2d_bytes=full.nbytes)
        log(f"[serve] {card_line}: replay ms by bucket (CUDA events, "
            f"{SERVE_REPLAYS} replays): "
            + ", ".join(f"{b}: {v:.3f}" for b, v in replay_ms.items())
            + f"; pageable H2D of {full.nbytes} bytes "
            f"{result['h2d_ms']:.3f} ms (median of 21)")
        images = rs.randint(0, 256, (256, 224, 224, 3), dtype=np.uint8)
        counts = cuda_build.launch_counts()
        result["loads"] = []
        for clients, n in SERVE_LOADS:
            r = _serve_load(server, images, clients, n, replay_ms)
            result["loads"].append(r)
            log(f"[serve] {card_line}: C={clients}: {n} requests in "
                f"{r['wall_s']:.3f} s: {r['images_per_sec']:.2f} img/s; "
                f"p50 {r['p50_ms']:.3f} p95 {r['p95_ms']:.3f} p99 "
                f"{r['p99_ms']:.3f} ms; pad fraction "
                f"{r['pad_fraction']:.4f}; {r['batches']} batches, "
                f"{r['rows_per_batch']:.2f} rows each "
                f"{r['batches_by_bucket']}; device-busy share "
                f"{r['device_busy_share']:.3f}")
        hand = {f"{w.__name__}.{a}": n - counts[(w, a)]
                for (w, a), n in cuda_build.launch_counts().items()}
        if any(hand.values()):
            raise AssertionError(f"[serve] hand-written kernels launched "
                                 f"while serving: {hand}")
        steady = server.stats()["steady_state_compiles"]
        if steady != 0:
            raise AssertionError(f"[serve] {steady} steady-state compiles")
        result.update(steady_state_compiles=steady,
                      hand_kernel_launches=0)

        # 5. HTTP round trips, the admin endpoints, then drain
        httpd = make_http_server(server, port=0)
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        threading.Thread(target=httpd.serve_forever, name="serve-http",
                         daemon=True).start()
        try:
            http_err = 0.0
            for i in range(SERVE_HTTP_REQUESTS):
                body = json.dumps({"inputs": {
                    "data_u8": requests[i][:1].tolist()}}).encode()
                req = urllib.request.Request(
                    url + "/v1/infer", data=body,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as r:
                    out = np.asarray(json.loads(r.read())["outputs"][0])
                http_err = max(http_err, _rows_close(
                    out, served[i][:1], PARITY_AMP_RTOL, "HTTP vs step 3"))
            with urllib.request.urlopen(url + "/healthz") as r:
                if r.status != 200 or r.read() != b"ok\n":
                    raise AssertionError("[serve] /healthz not ok")
            with urllib.request.urlopen(url + "/stats") as r:
                if json.loads(r.read())["requests"] != \
                        SERVE_LOADS[-1][1] + SERVE_HTTP_REQUESTS:
                    raise AssertionError("[serve] /stats request count")
            with urllib.request.urlopen(url + "/metrics") as r:
                text = r.read().decode()
            series = ("serve_requests_total", "serve_rows_total",
                      "serve_batches_total", "serve_request_ms",
                      "serve_request_phase_ms", "serve_queue_rows",
                      "serve_warmup_ms", "serve_ready")
            missing = [n for n in series if n not in text]
            if missing:
                raise AssertionError(f"[serve] /metrics lacks {missing}")
        finally:
            httpd.shutdown()
            httpd.server_close()
        backlog = [server.submit({"data_u8": images[i]})
                   for i in range(SERVE_DRAIN_BACKLOG)]
        drained = {}
        drainer = threading.Thread(
            target=lambda: drained.update(ok=server.drain(timeout=120)),
            name="serve-drain")
        drainer.start()
        deadline = time.perf_counter() + 60
        while not server.draining() and time.perf_counter() < deadline:
            time.sleep(0.0005)
        try:
            server.submit({"data_u8": images[0]})
            raise AssertionError("[serve] a submit while draining was "
                                 "admitted")
        except serve.ServerDraining:
            pass
        drainer.join(150)
        served_backlog = sum(f.exception(timeout=0) is None
                             for f in backlog)
        if not drained.get("ok") or server.state() != "stopped" \
                or served_backlog != SERVE_DRAIN_BACKLOG:
            raise AssertionError(
                f"[serve] drain: {drained}, state {server.state()}, "
                f"{served_backlog} of {SERVE_DRAIN_BACKLOG} served")
        result.update(http_round_trips=SERVE_HTTP_REQUESTS,
                      http_vs_served_max_rel=http_err,
                      drain_backlog_served=served_backlog)
        log(f"[serve] HTTP: {SERVE_HTTP_REQUESTS} POST /v1/infer round "
            f"trips, largest difference from step 3's rows {http_err:.3e}; "
            f"/healthz, /stats, /metrics ({len(series)} serve_* series) "
            f"ok; drain served the backlog of {served_backlog} requests "
            f"and refused a new submit with ServerDraining")
    finally:
        amp.disable()
        if server is not None:
            server.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    _release()
    result["seconds"] = time.perf_counter() - t_phase
    log(f"[serve] phase seconds {result['seconds']:.1f}")
    return result


# ---------------------------------------------------------------------------
# phase tail_ops: the single-device op tail on the card
# ---------------------------------------------------------------------------
def _tail_inputs(rs):
    """{case: (op type, numpy inputs, attrs, output slots given a
    cotangent)} for every op type of the tail, at full-width shapes: NMT's
    target logits (TAIL_LOGITS), ResNet-50's last activation at the
    headline's batch (TAIL_ACT), its pooled features and classifier
    weight; the comparisons and the small ops on the features too."""
    def f32(*shape, lo=None, hi=None):
        if lo is None:
            return rs.randn(*shape).astype(np.float32)
        return rs.uniform(lo, hi, shape).astype(np.float32)

    b, c = TAIL_ACT[0], TAIL_ACT[1]
    logits = f32(*TAIL_LOGITS)
    labels = rs.randint(0, TAIL_LOGITS[1], (TAIL_LOGITS[0], 1))
    act = f32(*TAIL_ACT, lo=0.5, hi=1.5)
    feat, w = f32(b, c), f32(c, 1000, lo=-0.05, hi=0.05)
    col, col2 = f32(b, 1), f32(b, 1)
    ints = rs.randint(0, 3, (b, c)).astype(np.float32)
    ints2 = rs.randint(0, 3, (b, c)).astype(np.float32)
    mask, mask2 = rs.rand(b, c) > 0.5, rs.rand(b, c) > 0.5
    cases = {
        "softmax_with_cross_entropy": (
            "softmax_with_cross_entropy",
            {"Logits": [logits], "Label": [labels]}, {}, ["Loss"]),
        "label_smooth": ("label_smooth", {"X": [logits]},
                         {"epsilon": 0.1}, ["Out"]),
        "arg_max": ("arg_max", {"X": [logits]}, {"axis": -1}, []),
        "argsort": ("argsort", {"X": [logits]}, {"axis": -1}, ["Out"]),
        "reduce_sum": ("reduce_sum", {"X": [act]}, {"dim": [2, 3]},
                       ["Out"]),
        "reduce_mean": ("reduce_mean", {"X": [act]},
                        {"dim": [2, 3], "keep_dim": True}, ["Out"]),
        "reduce_max": ("reduce_max", {"X": [act]}, {"dim": [1]}, ["Out"]),
        "reduce_min": ("reduce_min", {"X": [act]}, {"dim": [2, 3]},
                       ["Out"]),
        "reduce_prod": ("reduce_prod", {"X": [act]}, {"dim": [3]},
                        ["Out"]),
        "matmul": ("matmul", {"X": [feat], "Y": [w]}, {}, ["Out"]),
        "clip": ("clip", {"X": [w]}, {"min": -0.02, "max": 0.03}, ["Out"]),
        "clip_by_norm": ("clip_by_norm", {"X": [w]}, {"max_norm": 1.0},
                         ["Out"]),
        "cos_sim": ("cos_sim", {"X": [feat], "Y": [feat[:1]]}, {},
                    ["Out"]),
        "cumsum": ("cumsum", {"X": [feat]}, {"axis": 1}, ["Out"]),
        "norm": ("norm", {"X": [feat]}, {"axis": 1}, ["Out"]),
        "split": ("split", {"X": [feat]}, {"axis": 1, "num": 4}, ["Out"]),
        "transpose": ("transpose", {"X": [act]}, {"axis": [0, 2, 3, 1]},
                      ["Out"]),
        "pad": ("pad", {"X": [feat]}, {"paddings": [0, 0, 1, 3]},
                ["Out"]),
        "crop": ("crop", {"X": [feat]}, {"offsets": [0, 8],
                                         "shape": [b, 1024]}, ["Out"]),
        "gather": ("gather", {"X": [w], "Index": [rs.randint(0, c, 4096)]},
                   {}, ["Out"]),
        "scatter": ("scatter", {"X": [w], "Ids": [rs.randint(0, c, 4096)],
                                "Updates": [f32(4096, 1000)]}, {},
                    ["Out"]),
        "one_hot": ("one_hot", {"X": [labels]},
                    {"depth": TAIL_LOGITS[1]}, []),
        "fill_constant_batch_size_like": (
            "fill_constant_batch_size_like", {"Input": [feat]},
            {"shape": [-1, 1000], "value": 0.5, "dtype": "float32"}, []),
        "fill_zeros_like": ("fill_zeros_like", {"X": [act]}, {}, []),
        "shape": ("shape", {"X": [act]}, {}, []),
        "increment": ("increment", {"X": [np.array([41], np.int64)]},
                      {"step": 1.0}, []),
        "expand": ("expand", {"X": [col]}, {"expand_times": [1, c]},
                   ["Out"]),
        "reverse": ("reverse", {"X": [feat]}, {"axis": [1]}, ["Out"]),
        "assign_value": ("assign_value", {}, {
            "shape": [4, 3], "dtype": "float32",
            "values": [float(v) for v in rs.randn(12)]}, []),
        "arg_min": ("arg_min", {"X": [feat]}, {"axis": 1}, []),
        "isfinite": ("isfinite", {"X": [act]}, {}, []),
        "logical_not": ("logical_not", {"X": [mask]}, {}, []),
        "sigmoid_cross_entropy_with_logits": (
            "sigmoid_cross_entropy_with_logits",
            {"X": [feat], "Label": [f32(b, c, lo=0.0, hi=1.0)]}, {},
            ["Out"]),
        "square_error_cost": ("square_error_cost", {"X": [col],
                                                    "Y": [col2]}, {},
                              ["Out"]),
        "squared_l2_norm": ("squared_l2_norm", {"X": [w]}, {}, ["Out"]),
        "squared_l2_distance": ("squared_l2_distance",
                                {"X": [feat], "Y": [f32(b, c)]}, {},
                                ["Out"]),
        "smooth_l1_loss": ("smooth_l1_loss", {"X": [feat], "Y": [f32(b, c)]},
                           {"sigma": 1.0}, ["Out"]),
        "huber_loss": ("huber_loss", {"X": [col], "Y": [col2]},
                       {"delta": 0.5}, ["Out"]),
        "hinge_loss": ("hinge_loss", {"Logits": [col], "Labels": [
            rs.randint(0, 2, (b, 1)).astype(np.float32)]}, {}, ["Loss"]),
        "rank_loss": ("rank_loss", {"Label": [rs.randint(0, 2, (
            b, 1)).astype(np.float32)], "Left": [col], "Right": [col2]}, {},
            ["Out"]),
        "margin_rank_loss": ("margin_rank_loss", {
            "Label": [np.sign(col2) + (col2 == 0)], "X1": [col],
            "X2": [col2]}, {"margin": 0.1}, ["Out"]),
        "log_loss": ("log_loss", {"Predicted": [f32(b, 1, lo=0.05,
                                                    hi=0.95)],
                                  "Labels": [rs.randint(0, 2, (b, 1)).astype(
                                      np.float32)]}, {}, ["Loss"]),
    }
    for op in ("equal", "not_equal", "less_than", "less_equal",
               "greater_than", "greater_equal"):
        cases[op] = (op, {"X": [ints], "Y": [ints2]}, {}, [])
    for op in ("logical_and", "logical_or", "logical_xor"):
        cases[op] = (op, {"X": [mask], "Y": [mask2]}, {}, [])
    return cases


def _tail_run(op_type, ins, attrs, place):
    """The op (its kernel through registry.run_kernel) on `place`: its
    outputs as tensors."""
    from paddle_tpu_torch.core import executor_core, registry

    ctx = executor_core.OpContext(place)
    return registry.run_kernel(
        registry.lookup(op_type), ctx,
        {s: [torch.from_numpy(np.asarray(v)).to(ctx.device) for v in vs]
         for s, vs in ins.items()}, dict(attrs))


def _tail_compare(card, host, what, worst):
    """Card outputs against the host's: integers and bools equal; floats
    within TAIL_RTOL of the host array's largest magnitude (a sum over
    2,048 or 30,000 terms in another order differs by a fraction of its
    terms' size, not of its own), recorded in `worst`."""
    for slot, hs in host.items():
        cs = card.get(slot, [])
        if len(cs) != len(hs):
            raise AssertionError(f"[tail_ops] {what} {slot}: {len(cs)} "
                                 f"outputs on the card, {len(hs)} on the host")
        for c, h in zip(cs, hs):
            if h is None:
                continue
            c = c.detach().cpu()
            if c.shape != h.shape or c.dtype != h.dtype:
                raise AssertionError(
                    f"[tail_ops] {what} {slot}: card {c.dtype}"
                    f"{tuple(c.shape)} vs host {h.dtype}{tuple(h.shape)}")
            if not h.dtype.is_floating_point:
                if not torch.equal(c, h):
                    raise AssertionError(f"[tail_ops] {what} {slot}: card "
                                         f"and host differ")
                continue
            if not h.numel():
                continue
            scale = float(h.abs().max())
            diff = float((c - h).abs().max())
            if not (np.isfinite(scale) and diff <= TAIL_RTOL * scale):
                raise AssertionError(
                    f"[tail_ops] {what} {slot}: card vs host {diff:.3e}, "
                    f"over {TAIL_RTOL:g} of the host's largest {scale:.3e}")
            worst[what] = max(worst.get(what, 0.0),
                              diff / scale if scale else diff)


def _tail_ops_on_card():
    """(a) every op type of the tail on the card and on the host from the
    same seeded inputs, forward and grad. Returns the count of op types."""
    import paddle_tpu_torch as fluid

    rs = np.random.RandomState(SEED)
    cases = _tail_inputs(rs)
    card, host = fluid.CUDAPlace(0), fluid.CPUPlace()
    worst, secs = {}, {}
    grads = 0
    for what, (op_type, ins, attrs, slots) in cases.items():
        t0 = time.perf_counter()
        h = _tail_run(op_type, ins, attrs, host)
        _tail_compare(_tail_run(op_type, ins, attrs, card), h, what, worst)
        if slots:
            cot = {f"{s}@GRAD": [rs.randn(*v.shape).astype(np.float32)
                                 for v in h[s]] for s in slots}
            gins = dict(ins, **cot)
            gh = _tail_run(op_type + "_grad", gins, attrs, host)
            gc_ = _tail_run(op_type + "_grad", gins, attrs, card)
            _tail_compare(gc_, gh, what + "_grad", worst)
            grads += 1
        del h
        secs[what] = time.perf_counter() - t0
    t0 = time.perf_counter()
    units = _tail_rules_on_card(rs)
    secs["the rules"] = time.perf_counter() - t0
    types = {v[0] for v in cases.values()} | set(units)
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    log(f"[tail_ops] (a) {len(types)} op types on the card and the host "
        f"from the same inputs ({len(cases)} forward cases, {grads} grads; "
        f"softmax_with_cross_entropy, label_smooth, arg_max, argsort at "
        f"{list(TAIL_LOGITS)}, the reductions over {list(TAIL_ACT)}, the "
        f"{len(units)} update rules over {TAIL_LANES} lanes): all within "
        f"{TAIL_RTOL:g} of the host array's scale, largest "
        f"{[(k, f'{v:.2e}') for k, v in top]}; the rules within "
        f"{TAIL_RULE_ULPS} units in the last place at it, largest "
        f"{max(units.values()):.2f} ({max(units, key=units.get)}); "
        f"slowest cases (s, host and card) "
        f"{[(k, round(v, 1)) for k, v in sorted(secs.items(), key=lambda kv: -kv[1])[:4]]}")
    return len(types)


def _tail_rules_on_card(rs):
    """One step of each update rule over ResNet-50's parameter lanes, on
    the card and on the host: every output within TAIL_RULE_ULPS units in
    the last place at the array's scale (tests/test_torch_optimizers.py's
    bound; pow, sqrt and division round on each side alone). Returns
    {rule: the largest difference in those units}."""
    import paddle_tpu_torch as fluid

    n = TAIL_LANES
    p, g = rs.randn(n).astype(np.float32), rs.randn(n).astype(np.float32)
    pos = rs.uniform(0.1, 1.0, n).astype(np.float32)
    small = rs.uniform(0.0, 0.1, n).astype(np.float32)
    base = {"Param": [p], "Grad": [g],
            "LearningRate": [np.array([0.01], np.float32)]}
    rules = {
        "adamax": ({"Moment": [small], "InfNorm": [pos],
                    "Beta1Pow": [np.array([0.81], np.float32)]}, {}),
        "adagrad": ({"Moment": [pos]}, {}),
        "decayed_adagrad": ({"Moment": [pos]}, {}),
        "adadelta": ({"AvgSquaredGrad": [pos], "AvgSquaredUpdate": [small]},
                     {}),
        "rmsprop": ({"MeanSquare": [pos], "Moment": [small]},
                    {"momentum": 0.5}),
        "ftrl": ({"SquaredAccumulator": [pos], "LinearAccumulator": [small]},
                 {"l1": 0.01, "l2": 0.01}),
        "proximal_gd": ({}, {"l1": 0.01, "l2": 0.01}),
        "proximal_adagrad": ({"Moment": [pos]}, {"l1": 0.01, "l2": 0.01}),
    }
    units = {}
    for rule, (extra, attrs) in rules.items():
        ins = dict(base, **extra)
        h = _tail_run(rule, ins, attrs, fluid.CPUPlace())
        c = _tail_run(rule, ins, attrs, fluid.CUDAPlace(0))
        for slot, (hv,) in h.items():
            cv = c[slot][0].cpu()
            unit = float(np.spacing(np.float32(hv.abs().max())))
            diff = float((cv - hv).abs().max())
            if diff > TAIL_RULE_ULPS * unit:
                raise AssertionError(
                    f"[tail_ops] {rule} {slot}: card vs host {diff:.3e}, "
                    f"over {TAIL_RULE_ULPS} units of {unit:.3e}")
            units[rule] = max(units.get(rule, 0.0), diff / unit)
        del h, c
    return units


def build_headline_clip_decay():
    """The headline's program with GradientClipByGlobalNorm(clip_norm=1.0)
    and exponential_decay(0.01, TAIL_DECAY_STEPS, 0.5) feeding Momentum:
    the rate is computed on the card from the step counter each step.
    Returns (main, startup, loss, lr var, momentum buckets)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import fusion

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        prediction = headline_net()
        label = fluid.layers.data(name="label", shape=[1], dtype="int32")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(
            input=prediction, label=label))
        lr = fluid.layers.exponential_decay(0.01, TAIL_DECAY_STEPS, 0.5)
        fluid.clip.set_gradient_clip(
            fluid.clip.GradientClipByGlobalNorm(clip_norm=1.0))
        fluid.optimizer.Momentum(learning_rate=lr,
                                 momentum=0.9).minimize(loss)
    main.random_seed = startup.random_seed = SEED
    _, plan = fusion.apply(main, feed_names=["data_u8", "label"],
                           fetch_names=[loss.name, lr.name])
    buckets = [b for b in plan.buckets if b["opt"] == "momentum"]
    return main, startup, loss, lr, buckets


def _tail_headline(card, headline_img_s):
    """(b) the headline with the global-norm clip and the decaying rate,
    bf16 AMP, fused Momentum, batch 128, iters=TAIL_K through the captured
    step: the momentum kernel's launches (counts zeroed just before), the
    rate fetched at every step against the schedule at the counter's
    value, img/s on the headline's clock."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, convert, flags
    from paddle_tpu_torch.fusion import kernels as fk

    main, startup, loss, lr, buckets = build_headline_clip_decay()
    rs = np.random.RandomState(SEED + 1)
    feeds = {"data_u8": torch.from_numpy(rs.randint(
        0, 256, (TAIL_K, HEADLINE_BATCH, 224, 224, 3),
        dtype=np.uint8)).cuda(),
        "label": torch.from_numpy(rs.randint(
            0, 1000, (TAIL_K, HEADLINE_BATCH, 1)).astype(np.int32)).cuda()}
    place = fluid.CUDAPlace(0)
    amp.enable("bfloat16")
    try:
        with flags.flag_guard(fuse=True):
            scope = fluid.Scope()
            with fluid.scope_guard(scope):
                fluid.Executor(place).run(startup)
            exe = fluid.Executor()
            torch.cuda.synchronize()
            fk.reset_launch_counts()
            with fluid.scope_guard(scope):
                dt, outs = _timed_calls(exe, main, feeds, [loss, lr], TAIL_K,
                                        TAIL_WARM, TAIL_CALLS)
                torch.cuda.synchronize()
                launches = fk.momentum_bucket.launches
                mode = exe.step_mode(main)
                counter = int(scope.find_var("@LR_DECAY_COUNTER@")
                              .reshape(-1)[0])
                _check_master_state(scope)
                # one more replay traced on the card alone: where the time
                # beside the headline's goes (the clip's ops, the rate's)
                wall, busy, idle, rows, _ = trace_step(
                    exe, main, {n: t[0] for n, t in feeds.items()},
                    [loss, lr], table="headline_clip_decay")
    finally:
        amp.disable()
    steps = (TAIL_WARM + TAIL_CALLS) * TAIL_K
    lv, rates = _losses(outs[0]), outs[1].reshape(-1).cpu().numpy()
    want = np.array([0.01 * 0.5 ** (k / TAIL_DECAY_STEPS)
                     for k in range(counter - TAIL_K + 1, counter + 1)])
    img_s = HEADLINE_BATCH * TAIL_K * TAIL_CALLS / dt
    log(f"[tail_ops] (b) {card}: headline + GradientClipByGlobalNorm(1.0) + "
        f"exponential_decay(0.01, {TAIL_DECAY_STEPS}, 0.5), bf16 AMP, "
        f"fused Momentum, batch {HEADLINE_BATCH}: {mode}; "
        f"{img_s:.2f} img/s ({dt / (TAIL_K * TAIL_CALLS) * 1e3:.2f} ms a "
        f"step; {TAIL_CALLS} calls of iters={TAIL_K} after {TAIL_WARM} warm) "
        f"beside the headline's {headline_img_s:.2f}; momentum_bucket "
        f"launches {launches} ({len(buckets)} buckets x {steps} steps); "
        f"counter {counter}; last call's rates {rates.tolist()}; last "
        f"losses {lv[-3:].tolist()}; one replay traced on the card: wall "
        f"{wall:.2f} ms, device busy {busy:.2f} ms, idle share {idle:.3f}, "
        f"momentum_kernel rows {rows}")
    if mode != "graph":
        raise AssertionError(f"the clip-and-decay headline ran as {mode!r}")
    if launches != len(buckets) * steps:
        raise AssertionError(
            f"momentum kernel launched {launches} times, expected "
            f"{len(buckets)} buckets x {steps} steps")
    if counter != steps - 1:
        raise AssertionError(f"the step counter reads {counter} after "
                             f"{steps} steps, not {steps - 1}")
    np.testing.assert_allclose(rates, want, rtol=1e-6)
    if len(set(rates.tolist())) != TAIL_K:
        raise AssertionError(f"the rate did not change every step: {rates}")
    if not np.all(np.isfinite(lv)):
        raise AssertionError(f"non-finite loss {lv}")
    del exe, scope, feeds
    _release()
    return {"images_per_sec": img_s, "headline_images_per_sec":
            headline_img_s, "step_ms": dt / (TAIL_K * TAIL_CALLS) * 1e3,
            "momentum_launches": launches, "steps": steps,
            "counter": counter, "rates": rates.tolist(),
            "trace_wall_ms": wall, "trace_busy_ms": busy,
            "idle_share": idle}


def _tail_optimizers(card):
    """(c) each of the eight new update rules trains the fp32 ResNet-50
    path (NHWC 224x224x3, batch 32, FLAGS_fuse=1) for TAIL_OPT_STEPS steps
    through the captured step and through the interpreter from one state,
    cuDNN deterministic: losses and every persistable bitwise equal. Then
    TAIL_OPT_TIMED replays timed (host clock to one fetch): step ms."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert, flags

    rs = np.random.RandomState(SEED)
    x = torch.from_numpy(rs.rand(BATCH, 224, 224, 3).astype(
        np.float32)).cuda()
    y = torch.from_numpy(rs.randint(0, 1000, (BATCH, 1))).cuda()
    feed = {"data": x, "label": y}
    place = fluid.CUDAPlace(0)
    step_ms = {}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, make in TAIL_OPTIMIZERS.items():
            main, startup, loss, _ = build_resnet50(make, quiet=True)
            init_scope = fluid.Scope()
            with fluid.scope_guard(init_scope):
                fluid.Executor(place).run(startup)
            init = convert.numpy_state(init_scope, main)
            del init_scope
            out = {}
            for mode in ("graph", "interpreter"):
                scope = fluid.Scope()
                convert.load_numpy_state(scope, main, init, place)
                exe = fluid.Executor()
                with fluid.scope_guard(scope), flags.flag_guard(
                        fuse=True, cuda_graph=mode == "graph"):
                    losses = [float(exe.run(main, feed=feed,
                                            fetch_list=[loss])[0][0])
                              for _ in range(TAIL_OPT_STEPS)]
                    if exe.step_mode(main) != mode:
                        raise AssertionError(
                            f"[tail_ops] {name} ran {mode} as "
                            f"{exe.step_mode(main)}")
                    out[mode] = (losses, convert.numpy_state(scope, main))
                    if mode == "graph":
                        t0 = time.perf_counter()
                        for _ in range(TAIL_OPT_TIMED):
                            (lt,) = exe.run(main, feed=feed,
                                            fetch_list=[loss],
                                            return_numpy=False)
                        _fence(lt)
                        step_ms[name] = (time.perf_counter() - t0) \
                            / TAIL_OPT_TIMED * 1e3
                del exe, scope
                _release()
            (gl, gs), (il, ist) = out["graph"], out["interpreter"]
            differ = [n for n in ist if not np.array_equal(gs[n], ist[n])]
            log(f"[tail_ops] (c) {name}: ResNet-50 fp32 batch {BATCH}, "
                f"losses graph {gl} / interpreter {il}; "
                f"{'bitwise equal' if gl == il and not differ else 'DIFFER'}"
                f" over {len(ist)} persistables; step "
                f"{step_ms[name]:.2f} ms ({card})")
            if gl != il or differ:
                raise AssertionError(f"[tail_ops] {name}: graph and "
                                     f"interpreter differ: {differ[:5]}")
            if not np.all(np.isfinite(gl)):
                raise AssertionError(f"[tail_ops] {name}: loss {gl}")
    finally:
        torch.backends.cudnn.deterministic = prev
    return step_ms


def phase_tail_ops(card, headline_img_s):
    """(a) every op type of the single-device tail, card against host;
    (b) the clip-and-decay headline; (c) the eight new update rules on
    ResNet-50, graph against interpreter. Prints its seconds."""
    t0 = time.perf_counter()
    n_types = _tail_ops_on_card()
    _release()
    t1 = time.perf_counter()
    head = _tail_headline(card, headline_img_s)
    t2 = time.perf_counter()
    step_ms = _tail_optimizers(card)
    t3 = time.perf_counter()
    parts = {"ops": t1 - t0, "clip_decay": t2 - t1, "optimizers": t3 - t2}
    log(f"[tail_ops] phase {t3 - t0:.1f} s: (a) {parts['ops']:.1f} s, (b) "
        f"{parts['clip_decay']:.1f} s, (c) {parts['optimizers']:.1f} s")
    return {"op_types": n_types, "clip_decay": head,
            "optimizer_step_ms": step_ms, "seconds": t3 - t0,
            "seconds_by_part": parts}


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
    seqs = {name: build_seq_model(name) for name in ("stacked_lstm", "nmt")}

    def numels(plan):
        return [b["numel"] for b in plan]

    # the grads the fused updates receive: bf16 AMP on the headline,
    # SE-ResNeXt-50 and VGG-16; f32 on the MLP and the MNIST conv net
    rs = np.random.RandomState(SEED)
    head = build_headline()
    image_feed = {"img": rs.rand(2, 3, 224, 224).astype(np.float32),
                  "label": rs.randint(0, 10, (2, 1)).astype(np.int64)}
    amp_dtypes = {
        "headline": grad_dtypes(
            head[0], head[1], head[3],
            {"data_u8": rs.randint(0, 256, (2, 224, 224, 3)).astype(
                np.uint8),
             "label": rs.randint(0, 10, (2, 1)).astype(np.int32)}),
        **{m: grad_dtypes(images[m]["main"], images[m]["startup"],
                          images[m]["buckets"], image_feed)
           for m in ("se_resnext50", "vgg16")}}
    for path, dtypes in amp_dtypes.items():
        bf16 = sum(d == torch.bfloat16 for d in dtypes.values())
        log(f"[plan] {path} under bf16 AMP: {bf16} of the {len(dtypes)} "
            f"fused members' grads arrive in bf16")
    members = {
        # the headline's ResNet-50 buckets, which the fp32 path shares
        "momentum_bucket": {
            "resnet50": bucket_members(head[0], head[3],
                                       amp_dtypes["headline"]),
            "se_resnext50": bucket_members(
                images["se_resnext50"]["main"],
                images["se_resnext50"]["buckets"],
                amp_dtypes["se_resnext50"])},
        "adam_bucket": {
            "vgg16": bucket_members(images["vgg16"]["main"],
                                    images["vgg16"]["buckets"],
                                    amp_dtypes["vgg16"]),
            "mlp": bucket_members(mlp[0], mlp[3]),
            "mnist_cnn": bucket_members(images["mnist_cnn"]["main"],
                                        images["mnist_cnn"]["buckets"]),
            **{name: bucket_members(m["main"], m["buckets"])
               for name, m in seqs.items()}}}
    del head
    rows = phase_kernels({
        "momentum_bucket": {"resnet50": numels(resnet[3]),
                            "se_resnext50": numels(
                                images["se_resnext50"]["buckets"])},
        "adam_bucket": {"vgg16": numels(images["vgg16"]["buckets"]),
                        "mlp": numels(mlp[3]),
                        "mnist_cnn": numels(images["mnist_cnn"]["buckets"]),
                        **{name: numels(m["buckets"])
                           for name, m in seqs.items()}}},
        members)
    momentum, adam = rows[0], rows[1]
    paths = {"resnet50_fp32": phase_resnet(*resnet, card)}
    _release()
    headline = phase_headline(card)
    paths["headline"] = headline["momentum_launches"]
    _release()
    parallel = phase_parallel(card, headline["images_per_sec"])
    paths["parallel_executor"] = parallel["momentum_launches"]
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
    seq = {}
    for name, m in seqs.items():
        seq[name] = phase_seq(m, card_line)
        paths[name] = seq[name]["launches"]
    del seqs
    adam["launches"], adam["launches_by_path"] = vgg["launches"], paths
    phase_parity(amp=False)
    phase_parity(amp=True)
    served = phase_serve(card_line)
    _release()
    tail = phase_tail_ops(card, headline["images_per_sec"])
    momentum["launches_by_path"]["headline_clip_decay"] = \
        tail["clip_decay"]["momentum_launches"]
    _release()
    rows += phase_flash(sass)
    log(card_line)
    log(json.dumps({"headline": headline, "parallel": parallel,
                    "se_resnext50": se, "vgg16": vgg, **seq,
                    "serve": served, "tail_ops": tail}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
