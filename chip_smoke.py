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
                iters=20) over a seeded feed stack moved to the card once: 1
                warm call, then 3 timed calls from the first dispatch to one
                scalar fetch (resnet50_train_images_per_sec), through the
                captured step; the same program through the interpreter (one
                warm and one timed iters=4 call); one replayed step and one
                interpreter step traced on the card alone (idle shares, the
                momentum kernel's rows); graph vs interpreter from the same
                state for 3 steps at batch 32 (cuDNN deterministic on both
                sides), bitwise; every persistable f32 after the AMP steps;
                the timed calls monitored (FLAGS_monitor, on by default)
                and journaled to chiprun_out/headline_journal.jsonl
  6a. monitor — the run-time instruments on the same program and state:
                1 warm + 2 calls with FLAGS_monitor=0 (the monitored
                headline at >= 0.95 of it; momentum launches 4 a step);
                the journal, one record a call, through `python3 -m
                paddle_tpu_torch monitor`; on a fresh prepare with
                FLAGS_monitor_hlo_cost, the compile probe's FLOPs equal to
                the program's shape count (_analytic_step_flops), GFLOP an
                image and mfu against monitor.chip_peak_flops();
                FLAGS_benchmark's gauge beside the host clock;
                FLAGS_check_nan_inf's cost (off, on, on, off calls of
                iters=5); a profiler session over 3 replays exported as
                one chrome trace (host lane, 4 momentum_kernel rows a
                replay) and trace.costs' slowest ops; FLAGS_health's cost
                a step, one interpreter step's stats against float64
                host sums, 3 steps graph vs interpreter bitwise; fp32
                ResNet-50 with a NaN running mean, named by the captured
                step and, with its op, by the interpreter ([monitor] lines)
  6b. parallel — the headline's program, feeds and timing through
                fluid.ParallelExecutor(use_cuda=True) over a one-rank NCCL
                group (parallel.distributed.initialize, file:// rendezvous
                in a temp dir): 1 warm + 1 timed iters=20 calls through the
                captured step, its gradient all-reduces and global-batch
                collectives inside the graph; step_mode "graph", the
                momentum kernel's launches = buckets x steps, the
                collective launches of one replay (> 0), img/s beside the
                headline Executor's, peak memory, one replayed step traced
                (idle share); then PE and the Executor over 3 steps at batch
                32 from one state, bitwise (losses and every persistable);
                the group destroyed after
  6c. input  — the input path: INPUT_IMAGES seeded 256x256x3 uint8
                images written to a RecordIO file (recordio.Writer,
                compressor none; the native library built at first use)
                and the headline's program (bf16 AMP, fused Momentum,
                batch 128) trained from it through DataPipe.from_recordio
                -> map(random 224 crop and flip, INPUT_WORKERS processes)
                -> batch(128) -> prefetch_to_device(CUDAPlace(0),
                chunk=20) fed to Executor.run: (a) 1 warm + 2 timed calls
                through the captured step: img/s and its ratio to the
                headline's, the monitor's feed_wait a call, the pipe's
                per-stage stats, the link's share, one replay traced
                (idle share), peak memory, momentum launches (4 a step);
                the link's pinned and pageable copy rates on the idle card;
                (b) the first chunk through the pipe and as the same
                images stacked in numpy, bitwise (losses and every
                persistable); (f) the fused shm route, one pass drained;
                (c) resnet.get_model(flowers) fp32 fed uint8 under
                WireSpec.uint8_images("data", scale=1/255), decoded in the
                captured step, bitwise against the host-normalised float32
                feed, a quarter of its link bytes; (d) the MNIST conv net
                from open_recordio_file -> batch -> double_buffer ->
                read_file on the interpreter, card against host within
                1e-4; (e) each get_model's first train batch through a
                DataFeeder and one card step, a finite loss ([input]
                lines). Alone: `python3 chip_smoke.py --only input`
  7. se_resnext50, vgg16 — the benchmark/fluid image configs as their
                get_model declares them (float32 NCHW 224x224, int64 labels,
                the accuracy op): SE-ResNeXt-50 (1000 classes, Momentum(0.01,
                0.9), dropout 0.2 before the classifier) and VGG-16
                (vgg16_bn_drop + fc(102, softmax), Adam(1e-3), ten dropout
                ops), each FLAGS_fuse=1 under bf16 AMP, batch 64,
                Executor.run(iters=5) over a seeded feed stack made on the
                card, 1 warm + 2 timed calls through the captured step,
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
                feed and stacked on the card, Executor.run(iters=5), 1 warm
                + 2 timed calls through the captured step: words/s (review
                tokens; target tokens), step ms, peak memory, adam_bucket_
                launches = buckets x steps, f32 state; one replayed step
                traced (idle share, top-10 in chiprun_out/); the stacked
                LSTM's loop ops' forwards timed alone (the derived grads
                run each again); the embedding grads bitwise run to run; graph vs
                interpreter over 3 steps at batch 32 bitwise; host vs card
                within rtol 1e-4 over 2 steps at batch 16
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
                for 2 steps, graph and interpreter bitwise equal, step
                ms; the phase's seconds ([tail_ops] lines)
 10d. loss_ops — the structured losses, the metrics and the rest of the
                nn ops: (a) every op type the slice registered (warpctc,
                ctc_align, linear_chain_crf, crf_decoding, nce and
                nce_grad, hierarchical_sigmoid, auc, precision_recall,
                edit_distance, chunk_eval, layer_norm, the transposed,
                depthwise and 3-d convolutions, lrn, prelu,
                bilinear_interp, row_conv, im2sequence, spp, unpool,
                maxout, multiplex, lod_reset) on the card and on the host
                from the same seeded inputs, forward and grad, each at a
                full-width shape printed on its line (the book tagger's
                CRF batch, NCE and hierarchical sigmoid over 30,000
                classes, layer_norm over 8,192 x 1,024, ...), and the
                three drawing ops (truncated_gaussian_random, random_crop,
                nce's negatives) by their laws on both; (b) the
                PaddlePaddle book's label_semantic_roles db_lstm with its
                CRF at the book's widths and batch (10 sentences of 10-60
                tokens), SGD on exponential_decay: 2 steps through the
                captured step bitwise equal to the interpreter, host
                losses within rtol 1e-4, 2 more replays timed (tokens/s,
                ms a step), decoded tags in range, chunk_eval
                on the test program through the interpreter, no
                hand-written kernel launched ([loss_ops] lines). Alone:
                `python3 chip_smoke.py --only loss_ops`
 10e. control_flow — control flow and beam decoding: (a) the NMT
                (seq_to_seq_net(512, 512, 512, 30000, 30000), f32)
                trained 3 fused-Adam steps at batch 32 through the
                captured step, then models.machine_translation.
                beam_decode, beam 4, max_len 16, of 32 synthetic WMT14
                sources of 4-15 tokens: a first call (it builds the step
                programs and their graphs) and a warm one, ms a decode
                step (the attention_lstm_step run and the beam_search run,
                CUDA events and the host clock), sources/s; card against
                the host's decode on the same weights, scores within
                rtol 1e-4 and the token ids equal, or different only
                where the host's top 5 scores of that step hold a gap
                under 1e-4 (printed with the K-th/(K+1)-th margin); the
                beam_search op alone, card against host, bitwise, on the
                decode's candidates (NEG_INF ties) and on them rounded
                (live ties); (b) the headline's program under
                piecewise_decay([10, 30, 90], [0.1, 0.01, 0.001, 1e-4]),
                bf16 AMP, fused Momentum, batch 128, 1 warm + 1 timed
                calls of iters=20 through the captured step: one
                CapturedStep, no capture after the first call, momentum
                launches 4 a step, every step's rate equal to the numpy
                schedule, img/s at >= 0.97 of the same run's headline;
                graph vs interpreter bitwise over 3 steps across the
                first boundary; (c) the reference benchmark's
                gate-by-gate LSTM in a DynamicRNN (embedding and hidden
                512, vocabulary 5148, f32, fused Adam) at batch 16,
                reviews of 16-64 tokens bucketed: 2 steps card vs host
                within rtol 1e-4, graph vs interpreter bitwise, 2 more
                replays timed (ms a step, words/s); (d) a small program
                of each new op family (While with its grad, Switch,
                IfElse on mixed rows, StaticRNN, tensor arrays, the
                rank-table ops, is_empty, print) card against host
                ([control_flow] lines). Alone: `python3 chip_smoke.py
                --only control_flow`
 10f. resilience — the training services: (a) fluid.Trainer over the
                headline's network (Momentum(0.01, 0.9), FLAGS_fuse, bf16
                AMP) fed by a DataPipe over a seeded in-memory pool of
                uint8 images, batch 128, prefetch_to_device(chunk=2), 2
                epochs of 6 dispatches: img/s over the dispatches after
                the first and its ratio to the same run's headline, the
                event counts, momentum launches 4 a step; (b) the same
                under ResilienceConfig(checkpoint_interval=10), async
                writes: img/s against (a), the step-gap ms of a save (CUDA
                events around its snapshot copies, and its host ms), the
                writer's seconds and the bytes of a checkpoint,
                inspect_dir's statuses; (a) and (b) end in the same state,
                the rule for (c)-(e): bitwise, or, where they are not,
                within (a)-(b)'s largest difference; (c) a chaos sigterm
                after dispatch 5 raises Preempted after a grace save, a
                fresh Trainer restores and finishes, the time to recover
                (restore to its first completed dispatch, capture
                included); (d) a chaos nan at dispatch 6 under
                nan_policy="restore" rolls back in the same Trainer on its
                captured graph; (e) a chaos transient at run call 3, twice,
                is retried; (f) the README MLP with a dropout after its
                hidden layer, fused Adam, graph mode, killed after
                dispatch 2 and restored: bitwise equal to its
                uninterrupted run (the random stream rides the
                checkpoint), adam launches one a bucket a step; (g) the
                headline with async_fetch, fenced one call behind: every
                fetched loss equal to a synchronous run's from the same
                state, img/s against the headline; (h) FLAGS_debug_nans:
                log(-1) raises FloatingPointError naming log, a training
                scope trains after the trap, and with the flag off the
                program is back on its captured graph; (i)
                FLAGS_step_deadline_ms with a chaos delay writes a hang
                dump ([resilience] lines). Alone: `python3 chip_smoke.py
                --only resilience`
 10g. compile_services — the compile-time services: (a) the headline
                (bf16 AMP, fused Momentum, batch 128) under
                FLAGS_verify=full, 1 warm + 1 timed calls of iters=20
                through the captured step: no error-severity diagnostic,
                the verify's host seconds on the miss, img/s as a ratio to
                the same run's headline, momentum launches 4 a step; the
                program with a conv2d deleted raises
                ProgramVerificationError (PTA001) at its prepare, no op
                run and no kernel launched; (b) estimate_peak_hbm at batch
                128 beside max_memory_allocated over one replayed and one
                interpreted step (reset_peak_memory_stats before each),
                and the state's measured_live_bytes within 2x of the
                estimate's state bytes; (c) the headline network's
                for_test clone (f32, cuDNN deterministic) at batches 8,
                16, 32, then 8, under FLAGS_compile_cache_cap=2: 2
                evictions, the bytes each evicted graph freed, the
                recaptured batch-8 outputs bitwise equal to the first,
                memory_reserved after empty_cache below an uncapped
                executor's with the three graphs alive; (d) three fresh
                processes (`--l2-child`) of the headline under
                FLAGS_verify=full, its startup and two steps each, one
                FLAGS_compile_cache_dir (all three started at once; each
                imports and builds its program, then waits for its turn): the first misses L2 and puts,
                the second hits (the monitor counts no miss), the third,
                after the main program's entry is corrupted, counts one
                l2_fallback; first-step losses bitwise equal; each
                prepare's host split (L2 read, fusion, verify, step
                build, first eager step, capture); (e) a Go block sends
                4 CUDA tensors through a buffered channel and Selects
                with a default case receive them: equal to the host's
                ([compile_services] lines). Alone: `python3 chip_smoke.py
                --only compile_services`
 11. continuous — serving's continuous batching and the fleet: (a) greedy
                NMT decode at published widths (seq_to_seq_net(512, 512,
                512, 30000, 30000), random weights from SEED): the
                sources encoded once through the Executor, then
                models/machine_translation.greedy_step_program (the
                attention_lstm_step, arg_max, the target embedding's
                lookup) served by a ContinuousServer of 8 slots at the
                one rung 8 under bench.py's A/B mix (3 streams of 48
                steps, 16 requests of 2 joining mid-stream): every
                request bitwise its solo replay through a plain Executor
                at 8 rows, zero steady-state captures, the first 8 steps
                of each request card = host (tokens; h within rtol 1e-4);
                step ms by rung (CUDA events), tokens/s, host ms a step,
                the short requests' p99 solo, continuous and under
                run-to-completion FIFO; (b) the default ladder (1, 2, 4,
                8) on the same requests: for each rung pair, bitwise or
                the largest ulp gap of h; (c) a two-head program through
                the InterOpRunner, a CUDA stream a branch, bitwise the
                single program's, its overlap efficiency; (d) the
                headline network's inference model served under bf16 by
                2 `python -m paddle_tpu_torch fleet replica` processes
                behind a Router, 128 requests from 16 clients, one
                replica SIGKILLed at half: zero lost, the answers within
                phase serve's bf16 bound of an in-process Server's,
                routed img/s, p50/p99, retries, seconds until the router
                marked the killed replica dead; the survivor drained,
                exit 0 ([continuous] lines). Alone: `python3
                chip_smoke.py --only continuous`
 12. pserver  — the parameter server: pserver processes launched through
                `python -m paddle_tpu_torch train --role pserver` (this
                script as their child, `--pserver-child`), on ports the OS
                picked, each killed in a `finally`; (a) bench.py's
                headline (bf16, batch 128, Momentum) trained PS_STEPS steps
                (the first warm) by this process against one pserver,
                after a pull of its params, and (b) against two (the split
                path: split_byref, split blocks and their accumulators)
                from the same start pushed to them: each bitwise equal to
                the untranspiled program's plain Executor run (FLAGS_fuse
                =0, captured) over the losses and every persistable the
                trainer writes; img/s beside the plain run's, a step split
                into the trainer's compute (CUDA events), send, the
                pserver's round (its optimize blocks timed by the pserver
                process) and recv, bytes and GB/s each way; (c) the
                distributed lookup table at the NMT's source vocabulary
                (30,000 x 512) over two pservers, 50 steps of 2,048 Zipf
                ids: the loss falls over 3x, each pserver holds only its
                shard, every grown row within rtol 1e-5 of a dense replay
                on the card (captured), prefetch ms and rows/s; (d)
                memory_optimize on the headline: renames, 2 steps under
                FLAGS_fuse (the first eager, the second captured) bitwise
                the unoptimized fused program's, momentum launches and
                peak memory each way ([pserver] lines). Alone: `python3
                chip_smoke.py --only pserver`
 13. detection — detection and the native runtimes: (a) SSD300 (VGG-16
                base, fc6 dilated, four extra layers, conv4_3 L2-normalized
                with a learnable scale; multi_box_head: 8,732 priors, 21
                classes; 26.3 M parameters) trained at batch SSD_BATCH
                under bf16 AMP and FLAGS_fuse with Momentum(0.001, 0.9) on
                seeded synthetic images with 1-8 painted boxes: 1 warm step
                and 20 on one batch, on the interpreter (its host ops);
                every loss finite, the last 5 below the first 5; img/s and
                a step split into the card's work (one traced step), each
                host op's host and wait ms and the interpreter's other host
                time; the momentum kernel's launches = buckets x steps; (b)
                prior_box, iou_similarity and box_coder card vs host within
                1e-6 and the five host ops bitwise, at SSD300's widths; the
                loss at batch 2 in fp32 card vs host within 1e-4, each of 3
                steps from the host's state, any mined negative that
                differs printed; (c) detection_output at SSD's test
                settings and DetectionMAP (11point, overlap 0.5, difficult
                left out) over 2 batches of 32 with (a)'s weights: ms a
                batch, detections an image, the mAPs; the accumulated mAP
                equal to the one-shot detection_map over both; (d) roi_pool
                at Fast R-CNN's VGG-16 widths (X [2, 512, 38, 63] ReLU'd,
                128 ROIs, some over the edge, 1/16, 7x7): forward and
                gradient bitwise the host's, ms of each; (e) the MNIST conv
                net trained 5 steps on the card and saved; the native C++
                predictor within 1e-4 of the card's Executor on the saved
                model, host ms a batch ([detection] lines). Alone:
                `python3 chip_smoke.py --only detection`
 14. flash    — the flash-attention kernels (both wgmma fed by TMA; f32
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
 15. ring     — ring attention at the flash table's full width (B=1,
                H=32, S=4096, D=128), bf16 and f32, causal and not: (a) a
                one-rank sp group (gloo): ring_flash_attention bitwise
                flash_fwd over the whole sequence; (b) RING_WORLD = 4 sp
                ranks, one process each (`--ring-child`), sharing the card
                over a gloo group (NCCL refuses two ranks on one device),
                their permutes through pinned host buffers: each hop
                flash_fwd on the card at [1, 32, 1024, 128], the gathered
                output against flash_fwd over the whole sequence
                (RING_TOL) and against plain attention in float64 on the
                same inputs (FLASH_TOL), the flash launches idx + 1 a rank
                causal and 4 not (10 and 16 over the ring), each hop's
                kernel ms and each rotation's permute ms (CUDA events);
                ring_attention f32, forward and q/k/v grads against plain
                attention in float64 (RING_TOL); the ranks' logs in
                chiprun_out/ring_r*.log ([ring] lines). Alone: `python3
                chip_smoke.py --only ring`
 16. pipeline — the headline's program (bf16 AMP, FLAGS_fuse, batch 128)
                through parallel.pipeline.PipelineRunner, PIPE_MICRO = 4
                microbatches of 32, PIPE_STEPS steps, at one stage and at
                PIPE_STAGES = 4 from one state: losses and every
                persistable bitwise; each cell a program of its own,
                captured once; img/s over the steps after the captures
                beside the headline's; the plan's balance and cut bytes;
                the structural bubble (= 3/7) and the one measured on the
                card's timeline; peak memory; momentum_bucket launches =
                the optimizer cells' fused buckets x steps; and `python
                -m paddle_tpu_torch analyze pipeline --selftest --stages 4
                --microbatches 4` on the card, rc 0, started beside phase
                ring and waited for before this phase's first step
                ([pipeline] lines).
                Alone: `python3 chip_smoke.py --only pipeline`
 17. elastic  — the control plane: this process hosts a
                parallel.master.MasterService and an obs Collector (both
                on ports the OS picks); ELASTIC_WORLD = 2 card ranks
                sharing the card over gloo (`--elastic-child` processes)
                train bench.py's headline (uint8 NHWC 224², bf16 AMP,
                Momentum(0.01, 0.9), FLAGS_fuse, global batch 128) from
                one seeded state through ParallelExecutor.run under a
                ResilientRunner holding an ElasticController, each with
                FLAGS_compile_service (the master), FLAGS_obs_push (the
                collector), a plan store and a journal of its own: steps
                0-2 at world 2, then w1 takes worker_preempt (it drains
                and exits) and w0 runs steps 3-5 at world 1, then w0's
                worker_join spawns a joiner and steps 6-8 run at world 2.
                Checked: w0's worlds [1, 2] and 2 resizes; the joiner's
                first step 6 (none lost or repeated); every loss within
                PARITY_AMP_RTOL of a one-rank PE's run here from the same
                state on the same feeds; after each resize every rank's
                persistables bitwise the committed checkpoint (loaded
                here); at world 2 the ranks' persistables bitwise equal
                after every step; momentum_bucket launches 4 x the steps
                a rank ran (the op route: gloo steps run on the
                interpreter), the kernel bitwise its twin at the
                headline's buckets; the joiner's prepare a compile-service
                hit, w0's at world 1 a clean miss; the collector's summary
                listing the workers; `obs timeline` and `monitor` over the
                workers' journals rc 0 with the per-step skew. Printed:
                each resize's ms and parts, step ms at each world, the
                gloo all-reduce's share of a step and its bytes, peak
                memory per rank ([elastic] lines; the workers' logs in
                chiprun_out/elastic_*.log).
                Alone: `python3 chip_smoke.py --only elastic`
Then one JSON line of the paths' numbers (the monitor phase's under
"monitor"), one of per-kernel numbers (launches on every path that runs the
kernel; momentum's "headline_unmonitored" path is the monitor phase's
unmonitored calls; the flash rows' launches are the ring's, the path that
runs them, with the entry point's beside them), and as the last line
{"ok": true, "device": {...}}.
"""

import atexit
import gc
import json
import os
import re
import shutil
import statistics
import struct
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
# replays of a timed graph in each of _graph_ms's 5 windows (cut from 100
# to keep the script's time)
GRAPH_REPLAYS = 40
# bench.py's headline program: batch 128, iters=HEADLINE_K a call,
# HEADLINE_WARM + HEADLINE_CALLS timed (cut from 40 and 2 + 5 to keep the
# script well inside its time limit)
HEADLINE_BATCH = 128
HEADLINE_K = 20
HEADLINE_WARM = 1
HEADLINE_CALLS = 3
PARALLEL_WARM = 1
PARALLEL_CALLS = 1
# host vs card losses under bf16 AMP: five bf16 ulps (5 x 2^-8)
PARITY_AMP_RTOL = 2e-2
# SE-ResNeXt-50 and VGG-16 under bf16 AMP: batch 64, iters=5 a call,
# 1 warm + 2 timed calls; the README MLP and the MNIST conv net: batch
# 128, 30 single steps
IMAGE_BATCH = 64
IMAGE_K = 5
IMAGE_WARM = 1
IMAGE_CALLS = 2
ADAM_BATCH = 128
ADAM_STEPS = 30
# the sequence configs (benchmark/fluid's stacked_dynamic_lstm and
# machine_translation) in f32 with Adam, as fluid_benchmark.py runs them:
# batch 128, iters=5 a call, 1 warm + 2 timed calls; every ragged feed
# tail-padded to one flat total, the steps' largest rounded up to a
# multiple of SEQ_BUCKET tokens (fluid_benchmark.bucket_totals). The
# LSTM's loop bound is --max_seq_len 128 (the longest synthetic review
# has 127 tokens); the NMT's are seq_to_seq_net's defaults, 32 and 32.
SEQ_BATCH = 128
SEQ_K = 5
SEQ_WARM = 1
SEQ_CALLS = 2
SEQ_BUCKET = 64
LSTM_MAX_LEN = 128
IMDB_VOCAB = 5148
WMT_DICT = 30000
# host vs card at full width: SEQ_PARITY_STEPS steps at this batch (the
# host's f32 matmuls over the 30000-word softmax set its size)
# the loop ops' forwards timed alone: the stacked LSTM's only (the NMT's
# took 20 s of the script and measure the same recompute share)
LOOP_FORWARD_TAGS = ("stacked_lstm",)
SEQ_PARITY_BATCH = 16
SEQ_PARITY_STEPS = 2
# a fetched dropout mask keeps 1 - p of its elements within this: the
# smallest mask checked holds 64 x 512 elements, whose keep fraction's
# standard deviation at p = 0.5 is 2.8e-3
KEEP_TOL = 0.01

# phase monitor: the headline's monitored img/s against FLAGS_monitor=0
# (MONITOR_WARM + MONITOR_CALLS calls) must keep MONITOR_MIN_RATIO; the compile
# probe's model FLOPs must equal the step's convolution and matmul FLOPs
# counted from the program's shapes (_analytic_step_flops; 2 a
# multiply-add); the FLAGS_benchmark, FLAGS_check_nan_inf and FLAGS_health
# calls run
# iters=MONITOR_K; health's stats against a float64 host recompute within
# MONITOR_HEALTH_RTOL (bf16 grads); the profiler session spans
# MONITOR_TRACE_STEPS replays
MONITOR_MIN_RATIO = 0.95
MONITOR_K = 5
# the headline re-run unmonitored: MONITOR_WARM + MONITOR_CALLS calls
MONITOR_WARM = 1
MONITOR_CALLS = 2
MONITOR_HEALTH_RTOL = 2e-2
MONITOR_TRACE_STEPS = 3

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
TAIL_CALLS = 2
TAIL_OPT_STEPS = 2
TAIL_OPT_TIMED = 2
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

# phase loss_ops: (a) each op type of the loss-ops and nn-rest slice on
# the card and on the host (TAIL_RTOL, TF32 off) at one full-width shape:
# the CRF ops at the book tagger's batch below; warpctc over LOSS_CTC
# (sequences, fewest and most frames) x LOSS_CTC_CLASSES with labels of
# 4..LOSS_CTC_LABEL_MAX (the loop's trip count is the batch's frame total,
# as in the JAX package); nce and hierarchical_sigmoid over LOSS_NCE (rows,
# width, classes); auc and precision_recall over LOSS_AUC_ROWS rows;
# edit_distance over LOSS_EDIT sequences; layer_norm and multiplex over
# LOSS_LN; the drawing ops by their laws (TRUNC_NORMAL_VAR: the variance
# of N(0, 1) cut at +-2). (b) the PaddlePaddle book's label_semantic_roles
# db_lstm at its published widths (conll05's vocabularies, word_dim 32,
# mark_dim 5, hidden_dim 512, depth 8) at its BATCH_SIZE 10, sentences of
# SRL_LEN tokens: SRL_STEPS steps graph against interpreter (the first
# eager, the rest the captured graph), host losses within SRL_RTOL, then
# SRL_STEPS more replays timed
LOSS_CTC = (8, 64, 128)
LOSS_CTC_CLASSES = 96
LOSS_CTC_LABEL_MAX = 24
LOSS_NCE = (4096, 512, 30000)
LOSS_AUC_ROWS = 65536
LOSS_EDIT = (32, 8, 48)
LOSS_LN = (8192, 1024)
LOSS_TGR = (4096, 4096)
LOSS_CROP_IN = (64, 3, 256, 256)
LOSS_CROP = (3, 224, 224)
TRUNC_NORMAL_VAR = 0.7737413
SRL_WORD_V, SRL_PRED_V, SRL_LABELS = 44068, 3162, 67
SRL_CHUNK_TYPES = 33  # ceil((67 - 1) / 2): IOB over 33 role types, and O
SRL_WORD_DIM, SRL_MARK_DIM, SRL_HIDDEN, SRL_DEPTH = 32, 5, 512, 8
SRL_SLOTS = ["word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2",
             "verb", "mark", "target"]
SRL_BATCH = 10
SRL_LEN = (10, 60)
SRL_STEPS = 2
SRL_RTOL = 1e-4
# phase control_flow: (a) the NMT trained CF_NMT_STEPS fused-Adam steps at
# batch CF_NMT_BATCH, then beam_decode (beam CF_BEAM, max_len CF_MAX_LEN)
# of CF_NMT_BATCH sources; (b) the headline under piecewise_decay (the
# reference ImageNet recipes' schedule, cut to boundaries the timed calls
# cross), CF_HEAD_WARM + CF_HEAD_CALLS calls of iters=HEADLINE_K; (c) the
# gate-by-gate DynamicRNN LSTM at its published widths, batch
# CF_DRNN_BATCH, reviews of CF_DRNN_LEN tokens, CF_DRNN_STEPS checked and
# CF_DRNN_TIMED timed steps; card vs host within CF_RTOL, and beams that
# differ only where the host's K-th/(K+1)-th margin is under CF_NEAR_TIE
# (or, where the card took the same K candidates in another order, the
# host's score differences between the candidates they swapped)
CF_NMT_BATCH = 32
CF_NMT_STEPS = 3
CF_BEAM = 4
CF_MAX_LEN = 16
CF_BOUNDARIES = [10, 30, 90]
CF_VALUES = [0.1, 0.01, 0.001, 0.0001]
CF_HEAD_WARM = 1
CF_HEAD_CALLS = 1
CF_HEAD_MIN_RATIO = 0.97
CF_HEAD_BUCKETS = 4  # the headline's fused momentum buckets
CF_DRNN_WIDTH = 512
CF_DRNN_BATCH = 16
CF_DRNN_LEN = (16, 65)
CF_DRNN_STEPS = 2
CF_DRNN_TIMED = 2
CF_RTOL = 1e-4
CF_NEAR_TIE = 1e-4

# phase resilience: the headline's network under fluid.Trainer fed by a
# DataPipe over RES_POOL seeded uint8 images, batch HEADLINE_BATCH, chunks
# of RES_CHUNK steps, RES_EPOCHS epochs of RES_DISPATCHES dispatches; the
# checkpoint cadence of (b) RES_INTERVAL dispatches, of (c)-(e)
# RES_FAULT_INTERVAL; the faults' dispatches; the MLP with dropout at
# batch RES_MLP_BATCH, chunks of RES_MLP_CHUNK, RES_MLP_DISPATCHES a
# epoch, killed after dispatch RES_MLP_KILL; async_fetch over
# RES_ASYNC_CALLS calls of RES_CHUNK steps
RES_POOL = 512
RES_CHUNK = 2
RES_EPOCHS = 2
RES_DISPATCHES = 6
RES_INTERVAL = 10
RES_FAULT_INTERVAL = 4
RES_KILL_AT = 5
RES_NAN_AT = 6
RES_TRANSIENT_AT = 3
RES_MLP_BATCH = 128
RES_MLP_CHUNK = 4
RES_MLP_DISPATCHES = 3
RES_MLP_KILL = 2
RES_ASYNC_CALLS = 2

# phase input: the headline's program trained from a RecordIO file of
# INPUT_IMAGES seeded INPUT_SIDE^2 x 3 uint8 images through a DataPipe:
# INPUT_WORKERS decode processes (a random 224x224 crop and flip), batch
# HEADLINE_BATCH, chunks of HEADLINE_K steps, INPUT_WARM + INPUT_CALLS
# calls; (c) resnet.get_model(flowers) fed uint8 under a WireSpec,
# INPUT_WIRE_STEPS steps at INPUT_WIRE_BATCH; (d) the MNIST conv net from
# the reader ops, INPUT_READER_STEPS batches of INPUT_READER_BATCH, card
# against host within INPUT_READER_RTOL; (e) one batch of INPUT_MODEL_BATCH
# from each get_model's train reader; the link's pinned and pageable rates
# best of INPUT_LINK_REPS
INPUT_IMAGES = 2560
INPUT_SIDE = 256
INPUT_WORKERS = min(8, (os.cpu_count() or 2) // 2)
INPUT_WARM = 1
INPUT_CALLS = 2
INPUT_WIRE_STEPS = 3
INPUT_WIRE_BATCH = 32
INPUT_READER_STEPS = 20
INPUT_READER_BATCH = 64
INPUT_READER_RTOL = 1e-4
INPUT_MODEL_BATCH = 8
INPUT_LINK_REPS = 3

# phase compile_services: (a) the headline under FLAGS_verify=full,
# CS_WARM + CS_CALLS calls of iters=HEADLINE_K; (c) the headline
# network's for_test clone at CS_CAP_BATCHES, then the first again, under
# FLAGS_compile_cache_cap=2; (d) each fresh process of the L2 warm start
# within CS_CHILD_S seconds; (e) CS_CSP_VALUES tensors through a channel
CS_WARM = 1
CS_CALLS = 1
CS_CAP_BATCHES = (8, 16, 32)
CS_CHILD_S = 300
CS_CSP_VALUES = 4

# phase continuous: (a) greedy NMT streams at published widths through a
# ContinuousServer of CONT_SLOTS slots at the one rung CONT_SLOTS —
# bench.py's A/B mix (bench.py:531-533): CONT_LONG streams of
# CONT_LONG_STEPS, CONT_SHORT requests of CONT_SHORT_STEPS joining
# mid-stream — sources padded to CONT_TS; each rung's step timed
# CONT_STEP_REPS times; the first CONT_CHECK_STEPS steps of each request
# against the host's run of the same step (h within CONT_HOST_RTOL /
# CONT_HOST_ATOL, tokens equal); (b) the default ladder; (c) two heads of
# CONT_IO_WIDTH on two streams; (d) CONT_FLEET_REPLICAS `fleet replica`
# processes, CONT_FLEET_REQUESTS requests from CONT_FLEET_CLIENTS
# clients, each replica up within CONT_FLEET_START_S
CONT_SLOTS = 8
CONT_LONG = 3
CONT_LONG_STEPS = 48
CONT_SHORT = 16
CONT_SHORT_STEPS = 2
CONT_TS = 16
CONT_STEP_REPS = 20
CONT_CHECK_STEPS = 8
CONT_HOST_RTOL = 1e-4
CONT_HOST_ATOL = 1e-6
CONT_IO_WIDTH = 1024
CONT_FLEET_REPLICAS = 2
CONT_FLEET_REQUESTS = 128
CONT_FLEET_CLIENTS = 16
CONT_FLEET_START_S = 240

# phase pserver: (a) bench.py's headline program (uint8 224², batch
# HEADLINE_BATCH, bf16 AMP, Momentum(0.01, 0.9)) trained PS_STEPS steps
# (the first warm) by this process against one pserver process, and (b)
# against two (the split path), each held bitwise to the untranspiled
# program's plain Executor run (FLAGS_fuse=0, cuDNN deterministic) from
# the same start; (c) the distributed lookup table: PS_TABLE ([vocab,
# width]: the NMT's source vocabulary and width) mod-sharded over two
# pservers, the embedding -> fc -> square error model under
# SGD(PS_TABLE_LR), PS_TABLE_STEPS steps of PS_TABLE_IDS ids (128 x 16)
# drawn Zipf(PS_TABLE_ZIPF) over a seeded permutation of the vocabulary,
# held to a dense replay on the card within PS_TABLE_RTOL; (d)
# memory_optimize on the headline program, PS_MEMOPT_STEPS interpreter
# steps each way. Every pserver is a `python -m paddle_tpu_torch train
# --role pserver` process, up within PS_START_S and killed past
# PS_DEADLINE_S
PS_STEPS = 4
PS_TABLE = (30000, 512)
PS_TABLE_IDS = 128 * 16
PS_TABLE_STEPS = 50
PS_TABLE_LR = 0.5
PS_TABLE_ZIPF = 1.7
PS_TABLE_RTOL = 1e-5
PS_MEMOPT_STEPS = 2
PS_START_S = 180
PS_DEADLINE_S = 600

# Phase detection: (a) SSD300 (VOC's 21 classes, 8,732 priors) trained on
# the card under bf16 AMP and FLAGS_fuse, Momentum(SSD_LR, 0.9), batch
# SSD_BATCH: SSD_WARM step, then SSD_STEPS on one fixed batch of synthetic
# images with 1-SSD_MAX_GT boxes each; (b) the five host ops card vs host
# bitwise, the box ops within SSD_BOX_RTOL, the whole loss at
# SSD_PARITY_BATCH in fp32 over SSD_PARITY_STEPS within SSD_PARITY_RTOL;
# (c) detection_output at SSD's test settings (SSD_NMS) and DetectionMAP
# over SSD_INFER_BATCHES batches; (d) roi_pool at Fast R-CNN's VGG-16
# widths (ROI_X, ROI_PER_IMAGE ROIs an image, 1/16, ROI_BINS x ROI_BINS);
# (e) the native predictor on the MNIST conv net trained NATIVE_STEPS
# steps at NATIVE_BATCH, within NATIVE_RTOL of the card's Executor
SSD_CLASSES = 21
SSD_SIDE = 300
SSD_PRIORS = 8732
SSD_BATCH = 32
SSD_WARM = 1
SSD_STEPS = 20
SSD_LR = 0.001
SSD_MAX_GT = 8
SSD_PARITY_BATCH = 2
SSD_PARITY_STEPS = 3
SSD_PARITY_RTOL = 1e-4
SSD_BOX_RTOL = 1e-6
SSD_INFER_BATCHES = 2
SSD_NMS = {"nms_threshold": 0.45, "nms_top_k": 400, "keep_top_k": 200,
           "score_threshold": 0.01}
ROI_X = (2, 512, 38, 63)
ROI_PER_IMAGE = 64
ROI_SCALE = 1.0 / 16
ROI_BINS = 7
DET_REPS = 5
NATIVE_STEPS = 5
NATIVE_BATCH = 64
NATIVE_RTOL = 1e-4

# ring attention (phase ring): sp ranks, one process each, sharing the
# card over a gloo group; f32 held at the JAX ring test's bound
RING_WORLD = 4
RING_TOL = {torch.float32: {"atol": 3e-5, "rtol": 1e-4},
            torch.bfloat16: {"atol": 2e-3, "rtol": 1.6e-2}}
RING_CHILD_S = 300
# pipeline parallelism (phase pipeline): the headline at batch 128 in 4
# stages of 4 microbatches of 32; the first step captures the forward and
# backward cells, the second the optimizer cells, the rest are timed
PIPE_STAGES = 4
PIPE_MICRO = 4
PIPE_STEPS = 4
PIPE_CLI_S = 300

# phase elastic: bench.py's headline (bf16 AMP, fused Momentum, batch
# HEADLINE_BATCH) trained ELASTIC_STEPS global steps by ELASTIC_WORLD
# card ranks sharing the card over gloo (`--elastic-child` processes)
# under ElasticControllers: the rank "w1" preempted after step
# ELASTIC_PREEMPT_AT, a joiner spawned by "w0" after step
# ELASTIC_JOIN_AT; every loss within PARITY_AMP_RTOL of a one-rank PE's
# run of the same steps; each process killed past ELASTIC_CHILD_S
ELASTIC_WORLD = 2
ELASTIC_STEPS = 9
ELASTIC_PREEMPT_AT = 2
ELASTIC_JOIN_AT = 5
ELASTIC_CHILD_S = 300

SEED = 20261016
BATCH = 32
SIZES = (1, 17, 1029, 4194307)
OUT_DIR = "chiprun_out"  # long reports (gitignored)
TRACE_ATTEMPTS = 3  # traces of one step, at most, for its kernel's rows

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
    # the same line behind the script's seconds so far, for the time a
    # part of a phase takes
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_timeline.txt"), "a") as f:
        f.write(f"{time.perf_counter() - _LAPS['start']:8.1f} {msg}\n")


_LAPS = {"start": time.perf_counter(), "last": time.perf_counter(),
         "seconds": {}}


def lap(name):
    """Close the wall-clock lap `name` (the seconds since the last lap) and
    print it with the script's seconds so far: the whole script must end
    well inside its 1,200 s, so each phase's share is in the log."""
    now = time.perf_counter()
    secs = _LAPS["seconds"][name] = round(now - _LAPS["last"], 1)
    _LAPS["last"] = now
    log(f"[time] {name} {secs} s; script {now - _LAPS['start']:.1f} s")


def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False — this "
                 "script measures the port on a CUDA card and has no host "
                 "fallback")
    if os.path.exists(os.path.join(OUT_DIR, "chip_smoke_timeline.txt")):
        os.remove(os.path.join(OUT_DIR, "chip_smoke_timeline.txt"))
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
               table=None, expect=None):
    """One step traced on the card only, which adds little host time:
    (wall ms, device busy ms, idle share, rows of `kernel`, device ms of
    the random draws: torch's distribution kernels, behind dropout's
    masks). `fetch` is the fetch list the step was prepared (and
    captured) with. With `table`, the device time by kernel goes whole to
    chiprun_out/<table>_profile.txt and its top 10 to the log. With
    `expect`, a trace holding another number of `kernel` rows is logged
    and the step traced again, TRACE_ATTEMPTS traces at most: a CUPTI
    trace of a replay has come back without the kernel's rows while the
    wrapper's launch count showed it ran. The caller checks the rows of
    the trace returned."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, TRACE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            exe.run(main, feed=feed, fetch_list=fetch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        device = _device_rows(prof)
        busy_ms = sum(ms for ms, _ in device.values())
        rows = sum(n for key, (_, n) in device.items() if kernel in key)
        if expect is None or rows == expect or attempt == TRACE_ATTEMPTS:
            break
        log(f"[profile] trace {attempt} of at most {TRACE_ATTEMPTS}: {rows} "
            f"{kernel} rows, not {expect}, among "
            f"{sum(n for _, n in device.values())} device rows; wall "
            f"{wall_ms:.2f} ms, device busy {busy_ms:.2f} ms; tracing the "
            f"step again")
    if table is not None:
        ranked = sorted(device.items(), key=lambda kv: -kv[1][0])
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, f"{table}_profile.txt"), "w") as f:
            for key, (ms, n) in ranked:
                f.write(f"{ms:10.3f} {n:7d}  {key}\n")
        log(f"[profile] {table}: {sum(n for _, n in device.values())} "
            f"device rows; top 10 by device ms (calls):")
        for key, (ms, n) in ranked[:10]:
            log(f"[profile]   {ms:8.3f} ({n:5d})  {key[:70]}")
    draw_ms = sum(ms for key, (ms, _) in device.items()
                  if "distribution" in key)
    return wall_ms, busy_ms, 1 - busy_ms / wall_ms, rows, draw_ms


def _device_rows(prof):
    """{name: [device ms, count]} of a profiled region's device events
    (kernels, copies, sets): the rows and times key_averages() gives them,
    summed from the raw trace without building a FunctionEvent an event,
    which takes seconds for a step of ~10^5 kernels."""
    from torch.autograd.profiler_util import _filter_name, _rewrite_name

    rows = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != torch.autograd.DeviceType.CUDA
                or e.is_async() or e.start_thread_id() != e.end_thread_id()
                or getattr(e, "is_hidden_event", lambda: False)()
                or _filter_name(e.name())):
            continue
        row = rows.setdefault(_rewrite_name(e.name()), [0.0, 0])
        row[0] += e.duration_ns() / 1e6
        row[1] += 1
    return rows


def profile_step(exe, main, feed, fetch, warm_ms, name,
                 kernel="momentum_kernel", expect=None):
    """Two more steps under torch.profiler. The first traces the card only:
    its wall and device-busy time give the device idle share of one step
    (returned as trace_step returns them). The second also records the
    host ops, for the table of device time by op and kernel (all rows in
    chiprun_out/<name>_profile.txt, the top 10 and the count of torch.cat
    kernels printed). `expect` goes to trace_step."""
    from torch.profiler import ProfilerActivity, profile

    card = trace_step(exe, main, feed, fetch, kernel, expect=expect)
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


def build_headline(with_prediction=False, plan=True):
    """bench.py's headline program (bench.py:105-124) built with the port:
    raw uint8 NHWC pixels cast and scaled on the card, int32 labels,
    ResNet-50, Momentum(0.01, 0.9); with its fusion plan's momentum
    buckets (None with plan=False: no fusion pass run here), and, with
    `with_prediction`, the softmax prediction last."""
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
    buckets = None
    if plan:
        _, fplan = fusion.apply(main, feed_names=["data_u8", "label"],
                                fetch_names=[loss.name])
        buckets = [b for b in fplan.buckets if b["opt"] == "momentum"]
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


def phase_headline(card, journal):
    """bench.py's headline run through the port: bf16 AMP, fused Momentum,
    batch 128, Executor.run(iters=HEADLINE_K) replayed from the captured step,
    monitored (FLAGS_monitor, on by default) and its calls journaled to
    `journal`; the interpreter beside it; traces; graph vs interpreter
    bitwise. Returns (its numbers, what phase monitor reruns: the program,
    its loss and buckets, the feed stack on the card, the initial
    state)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, convert, flags
    from paddle_tpu_torch.fusion import kernels as fk

    main, startup, loss, buckets = build_headline()
    log(f"[headline] bench.py's program: {len(buckets)} fused momentum "
        f"buckets of {[b['numel'] for b in buckets]} elements")
    os.makedirs(OUT_DIR, exist_ok=True)
    if os.path.exists(journal):
        os.remove(journal)
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
                with flags.flag_guard(monitor_journal=journal):
                    dt, outs = _timed_calls(exe, main, feeds, [loss],
                                            HEADLINE_K, HEADLINE_WARM,
                                            HEADLINE_CALLS)
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
                log(f"[headline] {card}: graph (monitored, journaled): "
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
                    "headline_graph", expect=len(buckets))
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
    return result, {"main": main, "loss": loss, "buckets": buckets,
                    "feeds": feeds, "init": init}


def _analytic_step_flops(main, batch):
    """The convolution and matmul FLOPs of one training step of `main` at
    `batch`, from the program's shapes (2 a multiply-add): each conv2d and
    mul once, and each of their grad ops once for every input grad it
    writes (Input/Filter, X/Y), at the forward's cost. The compile probe
    counts what the step runs; this counts what the program asks for."""
    gb = main.global_block()

    def numel(name):
        return int(np.prod([batch if d == -1 else d
                            for d in gb.vars[name].shape]))

    def cost(op, out):
        if op.type.startswith("conv2d"):
            # each output element: Cin/groups x kh x kw multiply-adds
            return 2 * numel(out) * int(np.prod(
                gb.vars[op.inputs["Filter"][0]].shape[1:]))
        y = gb.vars[op.inputs["Y"][0]].shape
        k = int(np.prod(y[:op.attrs.get("y_num_col_dims", 1)]))
        return 2 * numel(out) * k

    total = 0
    for op in gb.ops:
        if op.type in ("conv2d", "mul"):
            total += cost(op, op.output_arg_names()[0])
        elif op.type in ("conv2d_grad", "mul_grad"):
            out = next(names[0] for slot, names in op.inputs.items()
                       if slot.endswith("@GRAD"))
            writes = sum(1 for names in op.outputs.values()
                         if names and names[0])
            total += writes * cost(op, out)
    return total


def _fenced_ms(exe, main, feeds, fetch, iters):
    """Host ms of one exe.run(iters=...) from its dispatch to one scalar
    fetch of its loss (every step done)."""
    t0 = time.perf_counter()
    outs = exe.run(main, feed=feeds, fetch_list=fetch, iters=iters,
                   return_numpy=False)
    _fence(outs[0])
    return (time.perf_counter() - t0) * 1e3


def phase_monitor(card_line, headline, rerun):
    """The run-time instruments on the headline (bench.py's program, bf16
    AMP, fused Momentum, batch 128, through the captured step):
    (1) the headline's monitored img/s beside MONITOR_WARM +
    MONITOR_CALLS calls with FLAGS_monitor=0; (2) its journal, one record a call, through `python3
    -m paddle_tpu_torch monitor`; (3) the compile probe's model FLOPs an
    image and the MFU against the card's peak; (4) FLAGS_benchmark's gauge
    beside the same call's host clock; (5) FLAGS_health: its cost a step,
    one step's stats against a float64 host recompute, graph vs
    interpreter bitwise; (6) FLAGS_check_nan_inf: its cost on the clean
    headline, then on fp32 ResNet-50 a NaN running mean named by the
    captured step and by the interpreter with its op; (7) a profiler
    session over replays: host lane, momentum_kernel rows, slowest ops."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, convert, flags, health, monitor
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch import trace as ptrace
    from paddle_tpu_torch.fusion import kernels as fk

    t_phase = time.perf_counter()
    tag = f"[monitor] {card_line}:"
    main, loss, buckets = rerun["main"], rerun["loss"], rerun["buckets"]
    feeds, init = rerun["feeds"], rerun["init"]
    place = fluid.CUDAPlace(0)
    result = {}

    def fresh():
        scope = fluid.Scope()
        convert.load_numpy_state(scope, main, init, place)
        return scope, fluid.Executor()

    amp.enable("bfloat16")
    try:
        with flags.flag_guard(fuse=True):
            # (1) the headline re-run unmonitored (fewer calls: a rate)
            scope, exe = fresh()
            fk.reset_launch_counts()
            with fluid.scope_guard(scope), flags.flag_guard(monitor=False):
                steps_before = monitor.steps_done()
                dt, _ = _timed_calls(exe, main, feeds, [loss], HEADLINE_K,
                                     MONITOR_WARM, MONITOR_CALLS)
                torch.cuda.synchronize()
                if monitor.steps_done() != steps_before:
                    raise AssertionError("FLAGS_monitor=0 recorded a step")
            steps = (MONITOR_WARM + MONITOR_CALLS) * HEADLINE_K
            launches = fk.momentum_bucket.launches
            if launches != len(buckets) * steps:
                raise AssertionError(
                    f"unmonitored: momentum kernel launched {launches} "
                    f"times, not {len(buckets)} x {steps}")
            off = HEADLINE_BATCH * HEADLINE_K * MONITOR_CALLS / dt
            on = headline["images_per_sec"]
            ratio = on / off
            result.update(monitored_images_per_sec=on,
                          unmonitored_images_per_sec=off,
                          monitored_over_unmonitored=ratio,
                          unmonitored_launches=launches)
            log(f"{tag} headline img/s monitored (journal on, phase "
                f"headline) {on:.2f} vs FLAGS_monitor=0 {off:.2f} "
                f"({MONITOR_WARM} warm + {MONITOR_CALLS} timed calls of "
                f"iters={HEADLINE_K}): ratio {ratio:.4f}; momentum_bucket "
                f"launches unmonitored {launches} = {len(buckets)} x "
                f"{steps} steps (monitored: "
                f"{headline['momentum_launches']})")
            if ratio < MONITOR_MIN_RATIO:
                raise AssertionError(
                    f"the monitored headline runs at {ratio:.4f} of the "
                    f"unmonitored one (< {MONITOR_MIN_RATIO})")
            del exe, scope
            _release()

            # (2) the headline's journal and the CLI's summary of it
            journal = os.path.join(OUT_DIR, "headline_journal.jsonl")
            records = monitor.read_journal(journal)
            calls = HEADLINE_WARM + HEADLINE_CALLS
            if len(records) != calls or any(
                    r["iters"] != HEADLINE_K or r["kind"] != "executor"
                    for r in records):
                raise AssertionError(
                    f"journal: {len(records)} records "
                    f"{[(r['kind'], r['iters']) for r in records]}, not "
                    f"{calls} of iters={HEADLINE_K}")
            if records[0]["cache"] != "miss" or any(
                    r["cache"] != "hit" for r in records[1:]) \
                    or "compile" not in records[0]["phases_ms"]:
                raise AssertionError(
                    f"journal cache outcomes "
                    f"{[r['cache'] for r in records]}")
            cli = subprocess.run(
                [sys.executable, "-m", "paddle_tpu_torch", "monitor",
                 journal], capture_output=True, text=True, timeout=120)
            if cli.returncode != 0:
                raise AssertionError(f"monitor CLI rc {cli.returncode}: "
                                     f"{cli.stderr}")
            log(f"{tag} journal {journal}: {len(records)} records, iters="
                f"{HEADLINE_K} each; phases of the first (ms) "
                f"{records[0]['phases_ms']}, of the last "
                f"{records[-1]['phases_ms']}; python3 -m paddle_tpu_torch "
                f"monitor (rc 0):")
            for line in cli.stdout.splitlines():
                log(f"{tag}   {line}")
            result.update(journal_records=len(records),
                          journal_first_phases_ms=records[0]["phases_ms"],
                          journal_last_phases_ms=records[-1]["phases_ms"])

            # (3) the compile probe on a fresh prepare: model FLOPs, MFU
            scope, exe = fresh()
            with fluid.scope_guard(scope), \
                    flags.flag_guard(monitor_hlo_cost=True):
                two = {n: t[:2] for n, t in feeds.items()}
                t0 = time.perf_counter()
                _fence(exe.run(main, feed=two, fetch_list=[loss], iters=2,
                               return_numpy=False)[0])
                probe_s = time.perf_counter() - t0
                fp = monitor.last_step()["fingerprint"]
                info = monitor.compile_info()[fp]
            flops_step = info["flops"] / 2
            gflop_img = flops_step / HEADLINE_BATCH / 1e9
            analytic = _analytic_step_flops(main, HEADLINE_BATCH)
            peak = monitor.chip_peak_flops()
            mfu = monitor.mfu(flops_step, on / HEADLINE_BATCH,
                              peak_flops=peak)
            result.update(model_flops_per_step=flops_step,
                          model_gflop_per_image=gflop_img,
                          chip_peak_flops=peak, mfu=mfu,
                          analytic_flops_per_step=analytic,
                          probe_run_s=probe_s,
                          compile_wall_s=info["wall_s"])
            log(f"{tag} compile probe (FlopCounterMode over the first "
                f"eager step, the derived grads' recomputed forward left "
                f"out): {flops_step:.6e} FLOP a step = {gflop_img:.4f} "
                f"GFLOP an image (2 a multiply-add), the program's shapes "
                f"give {analytic:.6e}; the first run (probe, "
                f"capture, replay) {probe_s:.2f} s, compile_info wall_s "
                f"{info['wall_s']:.3f}; peak {peak} FLOP/s for "
                f"{torch.cuda.get_device_name(0)!r}; mfu {mfu:.5f} at the "
                f"monitored headline's {on:.2f} img/s")
            if flops_step != analytic:
                raise AssertionError(
                    f"the probe counted {flops_step:.6e} FLOP a step; the "
                    f"program's convolutions and matmuls do {analytic:.6e}")
            if peak is None or mfu is None:
                raise AssertionError("no peak for this card in "
                                     "monitor.CHIP_PEAK_TFLOPS")

            # (4) FLAGS_benchmark beside the same call's host clock, and
            # (6a) FLAGS_check_nan_inf on the clean headline
            k_feeds = {n: t[:MONITOR_K] for n, t in feeds.items()}
            with fluid.scope_guard(scope):
                _fenced_ms(exe, main, k_feeds, [loss], MONITOR_K)  # warm
                with flags.flag_guard(benchmark=True):
                    host_ms = _fenced_ms(exe, main, k_feeds, [loss],
                                         MONITOR_K)
                gauge_ms = monitor.registry().gauge(
                    "benchmark_run_ms").value
                nan_ms = {False: [], True: []}
                for check in (False, True, True, False):
                    with flags.flag_guard(check_nan_inf=check):
                        nan_ms[check].append(_fenced_ms(
                            exe, main, k_feeds, [loss], MONITOR_K))
            result.update(benchmark_gauge_ms=gauge_ms,
                          benchmark_host_ms=host_ms)
            log(f"{tag} FLAGS_benchmark: gauge benchmark_run_ms "
                f"{gauge_ms:.3f} ms beside the same call's host clock "
                f"{host_ms:.3f} ms (iters={MONITOR_K})")
            if not 0 < gauge_ms <= host_ms:
                raise AssertionError("benchmark gauge outside the call")
            off_ms = statistics.mean(nan_ms[False])
            on_ms = statistics.mean(nan_ms[True])
            result.update(nan_check_off_ms=nan_ms[False],
                          nan_check_on_ms=nan_ms[True])
            log(f"{tag} FLAGS_check_nan_inf on the clean headline: a call "
                f"of iters={MONITOR_K} {on_ms:.3f} ms on vs {off_ms:.3f} ms "
                f"off (off, on, on, off: {nan_ms[False][0]:.3f}, "
                f"{nan_ms[True][0]:.3f}, {nan_ms[True][1]:.3f}, "
                f"{nan_ms[False][1]:.3f}); one check a call: "
                f"{on_ms - off_ms:.3f} ms")

            # (7) a profiler session over replays
            trace_dir = os.path.join(OUT_DIR, "monitor_trace")
            three = {n: t[:MONITOR_TRACE_STEPS] for n, t in feeds.items()}
            with fluid.scope_guard(scope):
                profiler.reset_profiler()
                profiler.start_profiler("All", trace_dir=trace_dir)
                _fenced_ms(exe, main, three, [loss], MONITOR_TRACE_STEPS)
                torch.cuda.synchronize()
                profiler.stop_profiler(
                    "total", os.path.join(OUT_DIR, "monitor_profile"))
            chrome = profiler.export_chrome_trace(
                os.path.join(OUT_DIR, "monitor_chrome_trace.json"))
            with open(chrome) as f:
                events = json.load(f)["traceEvents"]
            host = [e for e in events if e.get("pid") == 0
                    and e.get("ph") != "M"]
            kernels = [e for e in events if e.get("cat") == "kernel"]
            momentum = [e for e in kernels
                        if "momentum_kernel" in e.get("name", "")]
            result.update(trace_host_events=len(host),
                          trace_kernel_rows=len(kernels),
                          trace_momentum_rows=len(momentum))
            log(f"{tag} profiler session over {MONITOR_TRACE_STEPS} "
                f"replays: {chrome} holds {len(host)} host-lane events "
                f"(pid 0), {len(kernels)} kernel rows, "
                f"{len(momentum)} momentum_kernel rows")
            if not host or len(momentum) != \
                    len(buckets) * MONITOR_TRACE_STEPS:
                raise AssertionError(
                    f"chrome trace: {len(host)} host events, "
                    f"{len(momentum)} momentum_kernel rows (want "
                    f"{len(buckets) * MONITOR_TRACE_STEPS})")
            table = ptrace.format_ops_table(ptrace.slowest_ops(
                fp, batch_size=HEADLINE_BATCH, top=10))
            log(f"{tag} trace.costs.slowest_ops, top 10:")
            for line in table.splitlines():
                log(f"{tag}   {line}")
            del exe, scope
            _release()

            # (5) FLAGS_health: its cost a step, against its host recompute
            scope, exe = fresh()
            with fluid.scope_guard(scope), flags.flag_guard(health=1):
                _fenced_ms(exe, main, {n: t[:2] for n, t in feeds.items()},
                           [loss], 2)  # eager step, capture, replay
                health_ms = _fenced_ms(exe, main, k_feeds, [loss], MONITOR_K)
                if exe.step_mode(main) != "graph":
                    raise AssertionError("health step not captured")
            health_cost = (health_ms - off_ms) / MONITOR_K
            result.update(health_on_ms=health_ms,
                          health_cost_ms_per_step=health_cost)
            log(f"{tag} FLAGS_health=1: a call of iters={MONITOR_K} "
                f"{health_ms:.3f} ms vs {off_ms:.3f} ms off: "
                f"{health_cost:.3f} ms a step "
                f"({len(health.plan_for(main).pairs)} parameters)")
            del exe, scope
            _release()
            result.update(_health_checks(main, loss, init, feeds, tag))
    finally:
        amp.disable()
    result.update(_nan_checks(tag))
    result["seconds"] = time.perf_counter() - t_phase
    log(f"{tag} phase monitor took {result['seconds']:.1f} s")
    return result


def _health_checks(main, loss, init, feeds, tag):
    """FLAGS_health at batch 32 from the headline's state: one
    interpreter step's stats against float64 sums over its fetched grads
    and its parameters before and after; then 3 steps through the
    captured step (eager, capture, replay) and through the interpreter,
    cuDNN deterministic: every step's stats bitwise equal."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert, flags, health

    place = fluid.CUDAPlace(0)
    plan = health.plan_for(main)
    steps = [{n: t[k, :BATCH] for n, t in feeds.items()} for k in range(3)]
    scope = fluid.Scope()
    convert.load_numpy_state(scope, main, init, place)
    exe = fluid.Executor()
    before = convert.numpy_state(scope, main)
    with fluid.scope_guard(scope), \
            flags.flag_guard(health=1, cuda_graph=False):
        outs = exe.run(main, feed=steps[0],
                       fetch_list=[loss] + plan.fetch_names)
    after = convert.numpy_state(scope, main)
    params = health.last_record()["params"]
    worst = 0.0
    for (label, _), g in zip(plan.pairs, outs[1:]):
        g = g.astype(np.float64)
        w0, w1 = before[label].astype(np.float64), \
            after[label].astype(np.float64)
        want = {"grad_norm": np.sqrt((g * g).sum()),
                "weight_norm": np.sqrt((w1 * w1).sum())}
        want["update_ratio"] = np.sqrt(((w1 - w0) ** 2).sum()) / \
            want["weight_norm"]
        for k, v in want.items():
            err = abs(params[label][k] - v) / max(abs(v), 1e-30)
            worst = max(worst, err)
            if err > MONITOR_HEALTH_RTOL:
                raise AssertionError(f"health {label} {k}: "
                                     f"{params[label][k]} vs {v}")
    log(f"{tag} FLAGS_health: one interpreter step at batch {BATCH}, "
        f"{len(plan.pairs)} parameters' grad norm, weight norm and update "
        f"ratio against float64 host sums over the fetched grads and the "
        f"parameters before and after: largest relative difference "
        f"{worst:.3e} (limit {MONITOR_HEALTH_RTOL})")
    del exe, scope
    _release()
    records = {}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for mode in ("graph", "interpreter"):
            scope = fluid.Scope()
            convert.load_numpy_state(scope, main, init, place)
            exe = fluid.Executor()
            with fluid.scope_guard(scope), flags.flag_guard(
                    health=1, cuda_graph=mode == "graph"):
                records[mode] = []
                for f in steps:
                    exe.run(main, feed=f, fetch_list=[loss])
                    records[mode].append(health.last_record()["params"])
                if exe.step_mode(main) != mode:
                    raise AssertionError(f"health ran {mode} as "
                                         f"{exe.step_mode(main)}")
            del exe, scope
            _release()
    finally:
        torch.backends.cudnn.deterministic = prev
    equal = records["graph"] == records["interpreter"]
    log(f"{tag} FLAGS_health: 3 steps at batch {BATCH} (eager, capture, "
        f"replay) vs the interpreter, cuDNN deterministic: stats of "
        f"{len(plan.pairs)} parameters "
        f"{'bitwise equal' if equal else 'DIFFER'}")
    if not equal:
        raise AssertionError("health stats: graph and interpreter differ")
    return {"health_recompute_worst_rel": worst, "health_bitwise": equal}


def _nan_checks(tag):
    """FLAGS_check_nan_inf on fp32 ResNet-50 (NHWC 224x224x3, batch 32,
    fused Momentum) with the first batch norm's running mean set to NaN:
    a persistable the step writes and no other op of a training step
    reads, so the NaN stays in it. The captured step (its first two runs
    clean) raises after the replay naming that var; the interpreter
    raises at the batch_norm op that writes it."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import flags

    main, startup, loss, _ = build_resnet50(quiet=True)
    bn = next(op for op in main.global_block().ops
              if op.type == "batch_norm")
    name = bn.inputs["Mean"][0]
    rs = np.random.RandomState(SEED)
    feed = {"data": rs.rand(BATCH, 224, 224, 3).astype(np.float32),
            "label": rs.randint(0, 1000, (BATCH, 1)).astype(np.int64)}
    got = {}
    for mode in ("graph", "interpreter"):
        scope = fluid.Scope()
        exe = fluid.Executor()
        with fluid.scope_guard(scope), flags.flag_guard(
                fuse=True, check_nan_inf=True,
                cuda_graph=mode == "graph"):
            exe.run(startup)
            if mode == "graph":
                for _ in range(2):  # eager, then the capture: clean
                    exe.run(main, feed=feed, fetch_list=[loss])
            scope.find_var(name).fill_(float("nan"))
            try:
                exe.run(main, feed=feed, fetch_list=[loss])
            except RuntimeError as e:
                got[mode] = str(e)
            else:
                raise AssertionError(f"{mode}: a NaN {name} passed the "
                                     f"check")
            if exe.step_mode(main) != mode:
                raise AssertionError(f"nan check ran {mode} as "
                                     f"{exe.step_mode(main)}")
        del exe, scope
        _release()
    want = {"graph": f"Variable {name!r} contains NaN after compiled step",
            "interpreter": f"Variable {name!r} contains NaN after op "
                           f"'batch_norm'"}
    for mode, msg in got.items():
        log(f"{tag} FLAGS_check_nan_inf, fp32 ResNet-50 with {name} set to "
            f"NaN, {mode}: RuntimeError: {msg}")
        if not msg.startswith(want[mode]):
            raise AssertionError(f"{mode}: {msg!r} does not name {name}")
    return {"nan_poisoned": name, "nan_messages": got}


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


# ---------------------------------------------------------------------------
# phase input: the headline trained from a RecordIO file through a DataPipe
# ---------------------------------------------------------------------------
def _input_record(index, label, image):
    """One record of the input phase's file: (index, label) as two int32,
    then the raw HWC uint8 pixels."""
    return struct.pack("<ii", index, label) + image.tobytes()


def parse_input_record(rec):
    """The pipe's parse_fn: a record as {"image", "index", "label"}."""
    index, label = struct.unpack_from("<ii", rec)
    image = np.frombuffer(rec, np.uint8, offset=8).reshape(
        INPUT_SIDE, INPUT_SIDE, 3)
    return {"image": image, "index": index, "label": label}


def random_crop_flip_224(sample):
    """ImageNet's training preprocessing without the JPEG decode: a random
    224x224 window of the 256x256 image, flipped left to right half the
    time, drawn from a generator seeded by the image's index (the same
    crop on every pass and in every process). It runs in a decode worker
    process, on numpy arrays only: a forked worker never touches
    torch.cuda."""
    rs = np.random.RandomState(SEED + sample["index"])
    y, x = rs.randint(0, INPUT_SIDE - 224 + 1, 2)
    image = sample["image"][y:y + 224, x:x + 224]
    if rs.rand() < 0.5:
        image = image[:, ::-1]
    return {"data_u8": np.ascontiguousarray(image),
            "label": np.array([sample["label"]], np.int32)}


def _write_input_file(path):
    """INPUT_IMAGES seeded 256x256x3 uint8 images with labels in [0,
    1000), written by the port's recordio.Writer uncompressed (noise does
    not compress). Returns the file's bytes."""
    from paddle_tpu_torch import recordio

    rs = np.random.RandomState(SEED)
    labels = rs.randint(0, 1000, INPUT_IMAGES)
    with recordio.Writer(path, compressor="none", max_num_records=64) as w:
        for i in range(INPUT_IMAGES):
            image = rs.randint(0, 256, (INPUT_SIDE, INPUT_SIDE, 3),
                               dtype=np.uint8)
            w.write(_input_record(i, int(labels[i]), image))
    return os.path.getsize(path)


def _input_pipe(path, passes, place):
    """The main path's pipe: the file's records parsed, cropped and
    flipped in INPUT_WORKERS processes (order kept), batched and staged in
    chunks of HEADLINE_K steps."""
    import paddle_tpu_torch as fluid

    return (fluid.DataPipe.from_recordio(path, parse_fn=parse_input_record,
                                         pass_num=passes)
            .map(random_crop_flip_224, num_workers=INPUT_WORKERS,
                 processes=True)
            .batch(HEADLINE_BATCH)
            .prefetch_to_device(place, chunk=HEADLINE_K))


def _input_chunk_numpy(path, steps, batch):
    """The first `steps` x `batch` images the pipe yields, made here from
    the same records with the same crop, stacked as the headline phase
    stacks its feed: ({name: [steps, batch, ...] array})."""
    from paddle_tpu_torch import recordio

    data = np.empty((steps, batch, 224, 224, 3), np.uint8)
    label = np.empty((steps, batch, 1), np.int32)
    i = 0
    while i < steps * batch:
        scanner = recordio.Scanner(path)
        for rec in scanner:
            if i == steps * batch:
                break
            s = random_crop_flip_224(parse_input_record(rec))
            k, b = divmod(i, batch)
            data[k, b], label[k, b] = s["data_u8"], s["label"]
            i += 1
        scanner.close()
    return {"data_u8": data, "label": label}


def _stage_sums(deltas):
    """The per-stage DataPipe deltas of several runs (the monitor's
    records), summed."""
    keys = ("items", "bytes", "busy_s", "wait_in_s", "wait_out_s",
            "bp_wait_s")
    out = {}
    for d in deltas:
        for stage, row in d.items():
            if isinstance(row, dict):
                acc = out.setdefault(stage, dict.fromkeys(keys, 0))
                for k in keys:
                    acc[k] += row.get(k, 0)
    return out


def _input_speed(main, loss, buckets, init, path, place, headline_img_s,
                 result):
    """(a) 1 warm + 2 timed calls of HEADLINE_K steps fed by the pipe, as
    the headline phase times its calls: img/s and its ratio to the
    headline's, feed_wait, per-stage stats, the link's share, one replay
    traced (idle share), peak memory, the momentum kernel's launches."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert, flags, monitor
    from paddle_tpu_torch.datapipe import WIRE_KEY
    from paddle_tpu_torch.fusion import kernels as fk

    calls = INPUT_WARM + INPUT_CALLS
    passes = calls * HEADLINE_K * HEADLINE_BATCH // INPUT_IMAGES
    scope = fluid.Scope()
    convert.load_numpy_state(scope, main, init, place)
    exe = fluid.Executor()
    pipe = _input_pipe(path, passes, place)
    waits, deltas = [], []

    def call():
        outs = exe.run(main, feed=pipe, fetch_list=[loss],
                       return_numpy=False)
        rec = monitor.last_step()
        waits.append(rec["phases_ms"].get("feed_wait", 0.0))
        deltas.append(rec.get("datapipe", {}))
        return outs

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_launch_counts()
    try:
        with fluid.scope_guard(scope), flags.flag_guard(monitor=True):
            for _ in range(INPUT_WARM):
                _fence(call()[0])
            t0 = time.perf_counter()
            for _ in range(INPUT_CALLS):
                outs = call()
            _fence(outs[0])
            dt = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = fk.momentum_bucket.launches
            steps = calls * HEADLINE_K
            mode = exe.step_mode(main)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            lv = _losses(outs[0])
            wire = pipe.wire_spec
            if mode != "graph":
                raise AssertionError(f"the pipe's steps ran as {mode!r}")
            if launches != len(buckets) * steps:
                raise AssertionError(
                    f"momentum kernel launched {launches} times on the "
                    f"input path, expected {len(buckets)} x {steps} steps")
            if not np.all(np.isfinite(lv)):
                raise AssertionError(f"non-finite input-path loss {lv}")
            _check_master_state(scope)
            # one replay of the same captured step, traced
            rs = np.random.RandomState(SEED + 1)
            one = {"data_u8": torch.from_numpy(rs.randint(
                       0, 256, (HEADLINE_BATCH, 224, 224, 3),
                       dtype=np.uint8)).cuda(),
                   "label": torch.from_numpy(rs.randint(
                       0, 1000, (HEADLINE_BATCH, 1)).astype(
                           np.int32)).cuda(),
                   WIRE_KEY: wire}
            wall, busy, idle, rows, _ = trace_step(exe, main, one, [loss])
            if len(exe.captured_steps(main, scope)) != 1:
                raise AssertionError("the traced step was captured anew")
    finally:
        pipe.close()
    img_s = HEADLINE_BATCH * HEADLINE_K * INPUT_CALLS / dt
    timed = _stage_sums(deltas[INPUT_WARM:])
    tr = timed.get("transfer", {})
    # the lanes' busy time is their copies' time on the card
    lanes = [row for stage, row in timed.items() if stage.startswith("link")]
    card_s = sum(row["busy_s"] for row in lanes)
    link_gb_s = sum(row["bytes"] for row in lanes) / card_s / 1e9 \
        if card_s else 0.0
    host_gb_s = tr["bytes"] / tr["busy_s"] / 1e9 if tr.get("busy_s") else 0
    result.update(
        images_per_sec=img_s, ratio_to_headline=img_s / headline_img_s,
        step_ms=dt / (HEADLINE_K * INPUT_CALLS) * 1e3,
        feed_wait_ms=waits, peak_mem_gib=peak, momentum_launches=launches,
        steps=steps, passes=passes, wire=wire.describe() if wire else None,
        stages=timed, link_gb_per_s=link_gb_s,
        transfer_host_gb_per_s=host_gb_s, link_busy_share=card_s / dt,
        trace_wall_ms=wall, trace_busy_ms=busy, idle_share=idle,
        momentum_rows=rows, last_losses=[float(v) for v in lv[-3:]])
    log(f"[input] {INPUT_CALLS} calls of iters={HEADLINE_K} fed by the "
        f"pipe in {dt:.3f} s after {INPUT_WARM} warm: {img_s:.2f} img/s "
        f"({result['step_ms']:.2f} ms a step), "
        f"{img_s / headline_img_s:.4f} of the headline's {headline_img_s:.2f}"
        f"; step_mode {mode}; wire {result['wire']}")
    log(f"[input] feed_wait ms a call (warm first): "
        f"{[round(w, 3) for w in waits]}")
    for stage, row in timed.items():
        gb = row["bytes"] / row["busy_s"] / 1e9 if row["busy_s"] else 0.0
        log(f"[input] stage {stage:9s} over the timed calls: items "
            f"{row['items']}, busy {row['busy_s']:.3f} s, wait in "
            f"{row['wait_in_s']:.3f} s, wait out (starved) "
            f"{row['wait_out_s']:.3f} s, backpressure "
            f"{row['bp_wait_s']:.3f} s, {row['bytes'] / 1e9:.3f} GB"
            + (f" at {gb:.2f} GB/s busy" if row["bytes"] else ""))
    log(f"[input] link: {tr.get('bytes', 0) / 1e9:.3f} GB copied from "
        f"pinned buffers at {link_gb_s:.2f} GB/s of the copies' card time "
        f"(the lanes' host time: {host_gb_s:.2f} GB/s), busy "
        f"{result['link_busy_share']:.4f} of the timed wall time; one "
        f"replay traced on the card only: wall {wall:.2f} ms, device busy "
        f"{busy:.2f} ms, idle share {idle:.3f}; peak mem {peak:.2f} GiB; "
        f"momentum_bucket launches {launches} ({len(buckets)} buckets x "
        f"{steps} steps); last losses {result['last_losses']}")


def _input_link(result):
    """The host-to-card copy rate of one chunk's bytes on an idle card,
    from pinned and from pageable memory (CUDA events, best of
    INPUT_LINK_REPS): what the feeder's copies are held against."""
    nbytes = HEADLINE_K * HEADLINE_BATCH * 224 * 224 * 3
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    rates = {}
    for kind in ("pinned", "pageable"):
        src = torch.empty(nbytes, dtype=torch.uint8,
                          pin_memory=kind == "pinned")
        src.fill_(1)
        best = None
        for _ in range(INPUT_LINK_REPS):
            t0, t1 = torch.cuda.Event(True), torch.cuda.Event(True)
            t0.record()
            dst.copy_(src, non_blocking=kind == "pinned")
            t1.record()
            t1.synchronize()
            ms = t0.elapsed_time(t1)
            best = ms if best is None else min(best, ms)
        rates[kind] = nbytes / best / 1e6
        del src
    del dst
    result["link_probe_gb_per_s"] = rates
    log(f"[input] link probe, one chunk ({nbytes / 1e6:.1f} MB) to the idle "
        f"card, best of {INPUT_LINK_REPS}: pinned {rates['pinned']:.2f} "
        f"GB/s, pageable {rates['pageable']:.2f} GB/s")


def _input_shm_route(path, place, result):
    """(f) The fused route: the decode processes write straight into the
    shared-memory ring (map(processes=True) right before
    prefetch_to_device, chunks of HEADLINE_BATCH images), the feeder stacks
    each slot into its pinned buffer (one host copy; the slot is free
    again) and copies that to the card: one pass of the file, drained
    without training. Stack and copy GB/s from the pipe's stats."""
    import paddle_tpu_torch as fluid

    pipe = (fluid.DataPipe.from_recordio(path, parse_fn=parse_input_record)
            .map(random_crop_flip_224, num_workers=INPUT_WORKERS,
                 processes=True)
            .prefetch_to_device(place, chunk=HEADLINE_BATCH))
    n = 0
    t0 = time.perf_counter()
    try:
        for chunk in pipe:
            if tuple(chunk["data_u8"].shape) != (HEADLINE_BATCH, 224, 224, 3):
                raise AssertionError(f"fused chunk {chunk['data_u8'].shape}")
            chunk["__donate__"].release()
            n += 1
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        st = pipe.stats()
    finally:
        pipe.close()
    stack, tr = st["stack"], st["transfer"]
    lanes = [d for k, d in st.items() if k.startswith("link")
             and isinstance(d, dict)]
    link = {"bytes": sum(d["bytes"] for d in lanes),
            "busy_s": sum(d["busy_s"] for d in lanes)}
    rate = {k: d["bytes"] / d["busy_s"] / 1e9 if d["busy_s"] else 0.0
            for k, d in (("stack", stack), ("transfer", tr), ("link", link))}
    result["shm_route"] = {"chunks": n, "images_per_sec":
                           n * HEADLINE_BATCH / dt,
                           "stack_gb_per_s": rate["stack"],
                           "transfer_gb_per_s": rate["transfer"],
                           "link_gb_per_s": rate["link"],
                           "bottleneck_stage": st.get("bottleneck_stage")}
    log(f"[input] shm route (map(processes=True) fused with "
        f"prefetch_to_device(chunk={HEADLINE_BATCH})): {n} chunks in "
        f"{dt:.2f} s, {n * HEADLINE_BATCH / dt:.1f} img/s drained; slot -> "
        f"pinned stack {stack['bytes'] / 1e9:.3f} GB at "
        f"{rate['stack']:.2f} GB/s busy, pinned -> card "
        f"{tr['bytes'] / 1e9:.3f} GB at {rate['link']:.2f} GB/s of card time "
        f"({rate['transfer']:.2f} GB/s of the lanes' host time); "
        f"bottleneck stage {st.get('bottleneck_stage')}")
    if n != INPUT_IMAGES // HEADLINE_BATCH:
        raise AssertionError(f"the fused route staged {n} chunks")


def _input_bitwise(main, loss, init, path, place, result):
    """(b) The first chunk through the pipe and the same images stacked in
    numpy, fed as the headline phase feeds them, from one state (cuDNN
    deterministic): the losses and every persistable bitwise equal."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.core.framework import Parameter

    ref = _input_chunk_numpy(path, HEADLINE_K, HEADLINE_BATCH)
    runs = {}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for how in ("pipe", "numpy"):
            scope = fluid.Scope()
            convert.load_numpy_state(scope, main, init, place)
            exe = fluid.Executor()
            with fluid.scope_guard(scope):
                if how == "pipe":
                    passes = -(-HEADLINE_K * HEADLINE_BATCH // INPUT_IMAGES)
                    pipe = _input_pipe(path, passes, place)
                    try:
                        lv = exe.run(main, feed=pipe, fetch_list=[loss])[0]
                    finally:
                        pipe.close()
                else:
                    feeds = {n: torch.from_numpy(a).cuda()
                             for n, a in ref.items()}
                    lv = exe.run(main, feed=feeds, fetch_list=[loss],
                                 iters=HEADLINE_K)[0]
                    del feeds
                runs[how] = (lv.reshape(-1), convert.numpy_state(scope, main))
            del exe, scope
            _release()
    finally:
        torch.backends.cudnn.deterministic = prev
    (pl, ps), (nl, ns) = runs["pipe"], runs["numpy"]
    params = [n for n, v in main.global_block().vars.items()
              if isinstance(v, Parameter) and v.trainable]
    differ = sorted(n for n in ns if not np.array_equal(ps[n], ns[n]))
    equal = np.array_equal(pl, nl) and not differ
    result["bitwise"] = {"equal": bool(equal), "steps": HEADLINE_K,
                         "params": len(params), "persistables": len(ns),
                         "losses": [float(v) for v in pl[-3:]]}
    log(f"[input] pipe vs numpy stack, the first {HEADLINE_K}-step chunk at "
        f"batch {HEADLINE_BATCH} from one state (cuDNN deterministic): "
        f"losses {'bitwise equal' if np.array_equal(pl, nl) else 'DIFFER'} "
        f"(last {pl[-3:].tolist()} / {nl[-3:].tolist()}); {len(params)} "
        f"trainable params and {len(ns) - len(params)} other persistables "
        f"(momenta, batch-norm statistics): {len(differ)} differ "
        f"{differ[:5]}")
    if not equal:
        raise AssertionError("the pipe's chunk and the numpy stack trained "
                             "to different states")


def _input_wire(place, result):
    """(c) resnet.get_model at flowers (float32 "data" [3, 224, 224]):
    INPUT_WIRE_STEPS steps at batch INPUT_WIRE_BATCH fed by a pipe that
    ships uint8 pixels under WireSpec.uint8_images("data", scale=1/255),
    decoded in the captured step, against the host-normalised float32 feed
    (the same cast, then the same f32 product): losses bitwise equal; the
    link's bytes against the float32 feed's."""
    import random

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import datapipe, flags
    from paddle_tpu_torch.models import resnet

    class Args:
        batch_size, data_set = INPUT_WIRE_BATCH, "flowers"

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss, _, opt, train_reader, _, _ = resnet.get_model(Args())
        opt.minimize(loss)
    main.random_seed = startup.random_seed = SEED
    random.seed(SEED)
    samples = []
    for batch in train_reader():
        samples += batch
        if len(samples) >= INPUT_WIRE_STEPS * INPUT_WIRE_BATCH:
            break
    samples = samples[:INPUT_WIRE_STEPS * INPUT_WIRE_BATCH]
    u8 = np.stack([np.rint(np.asarray(img) * 255).astype(np.uint8).reshape(
        3, 224, 224) for img, _ in samples])
    lab = np.array([[lbl] for _, lbl in samples], np.int64)

    def gen():
        for x, y in zip(u8, lab):
            yield {"data": x, "label": y}

    scale = 1.0 / 255.0
    f32 = u8.astype(np.float32) * np.float32(scale)
    shape = (INPUT_WIRE_STEPS, INPUT_WIRE_BATCH)
    runs = {}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with flags.flag_guard(fuse=True):
            for how in ("wire", "float32"):
                scope = fluid.Scope()
                exe = fluid.Executor()
                with fluid.scope_guard(scope):
                    exe.run(startup)
                    if how == "wire":
                        pipe = (fluid.DataPipe.from_reader(gen)
                                .batch(INPUT_WIRE_BATCH)
                                .prefetch_to_device(
                                    place, chunk=INPUT_WIRE_STEPS,
                                    wire=datapipe.WireSpec.uint8_images(
                                        "data", scale=scale)))
                        try:
                            lv = exe.run(main, feed=pipe,
                                         fetch_list=[loss])[0]
                            link = pipe.stats()["transfer"]["bytes"]
                        finally:
                            pipe.close()
                    else:
                        feeds = {"data": torch.from_numpy(f32.reshape(
                                     shape + f32.shape[1:])).cuda(),
                                 "label": torch.from_numpy(lab.reshape(
                                     shape + (1,))).cuda()}
                        lv = exe.run(main, feed=feeds, fetch_list=[loss],
                                     iters=INPUT_WIRE_STEPS)[0]
                        link = f32.nbytes + lab.nbytes
                    if exe.step_mode(main) != "graph":
                        raise AssertionError(
                            f"the {how} feed ran as {exe.step_mode(main)}")
                runs[how] = (lv.reshape(-1), link)
                del exe, scope
                _release()
    finally:
        torch.backends.cudnn.deterministic = prev
    (wl, wb), (fl, fb) = runs["wire"], runs["float32"]
    equal = np.array_equal(wl, fl)
    result["wire"] = {"equal": bool(equal), "losses": wl.tolist(),
                      "link_bytes": int(wb), "float32_bytes": int(fb),
                      "link_ratio": wb / fb}
    log(f"[input] wire: resnet.get_model(flowers) fp32, {INPUT_WIRE_STEPS} "
        f"steps at batch {INPUT_WIRE_BATCH}, uint8 on the link decoded "
        f"(cast, x {scale:.8g}) in the captured step: losses {wl.tolist()} "
        f"against the host-normalised float32 feed's {fl.tolist()}: "
        f"{'bitwise equal' if equal else 'DIFFER'}; link bytes {wb} vs "
        f"{fb} for float32 ({wb / fb:.4f})")
    if not equal:
        raise AssertionError("the wire-decoded losses differ from the host-"
                             "normalised reference's")


def _input_readers(workdir, result):
    """(d) The MNIST conv net fed by open_recordio_file -> batch ->
    double_buffer -> read_file: INPUT_READER_STEPS steps on the card (the
    interpreter: reader ops are host ops; the double buffer stages each
    batch from pinned memory on its stream) and on the host from one
    state, losses within INPUT_READER_RTOL (TF32 off)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert, recordio
    from paddle_tpu_torch.models import mnist

    path = os.path.join(workdir, "mnist.recordio")
    n = INPUT_READER_STEPS * INPUT_READER_BATCH

    def samples():
        for i, (img, lbl) in enumerate(fluid.dataset.mnist.train()()):
            if i == n:
                return
            yield [(np.asarray(img, np.float32).reshape(1, 28, 28), None),
                   (np.array([lbl], np.int64), None)]

    recordio.convert_reader_to_recordio_file(path, samples)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        reader = fluid.layers.open_recordio_file(
            path, shapes=[[-1, 1, 28, 28], [-1, 1]], lod_levels=[0, 0],
            dtypes=["float32", "int64"])
        reader = fluid.layers.batch(reader, batch_size=INPUT_READER_BATCH)
        reader = fluid.layers.double_buffer(reader)
        img, label = fluid.layers.read_file(reader)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(
            input=mnist.cnn_model(img), label=label))
        fluid.optimizer.AdamOptimizer(learning_rate=0.001, beta1=0.9,
                                      beta2=0.999).minimize(loss)
    main.random_seed = startup.random_seed = SEED
    losses, init = {}, None
    for name, place in (("host", fluid.CPUPlace()),
                        ("card", fluid.CUDAPlace(0))):
        scope = fluid.Scope()
        exe = fluid.Executor(place)
        with fluid.scope_guard(scope):
            exe.run(startup)
            if init is None:
                init = convert.numpy_state(scope, main)
            else:
                convert.load_numpy_state(scope, main, init, place)
            t0 = time.perf_counter()
            out = []
            for _ in range(INPUT_READER_STEPS):
                out.append(float(exe.run(main, fetch_list=[loss])[0].item()))
            dt = time.perf_counter() - t0
            try:
                exe.run(main, fetch_list=[loss])
                raise AssertionError("the reader did not end after "
                                     f"{INPUT_READER_STEPS} batches")
            except StopIteration:
                pass
            if exe.step_mode(main) != "interpreter":
                raise AssertionError(f"reader program ran as "
                                     f"{exe.step_mode(main)}")
        losses[name] = (np.array(out), dt)
        del exe, scope
    (hl, hdt), (cl, cdt) = losses["host"], losses["card"]
    rel = float(np.max(np.abs(cl - hl) / np.abs(hl)))
    result["readers"] = {"steps": INPUT_READER_STEPS,
                         "card_losses": cl.tolist(), "max_rel": rel,
                         "card_step_ms": cdt / INPUT_READER_STEPS * 1e3,
                         "host_step_ms": hdt / INPUT_READER_STEPS * 1e3}
    log(f"[input] readers: MNIST conv net from open_recordio_file -> batch "
        f"({INPUT_READER_BATCH}) -> double_buffer -> read_file, "
        f"{INPUT_READER_STEPS} steps on the interpreter: card losses "
        f"{cl[[0, -1]].tolist()} against the host's {hl[[0, -1]].tolist()}, "
        f"largest relative difference {rel:.3g} (limit {INPUT_READER_RTOL}); "
        f"{result['readers']['card_step_ms']:.2f} ms a card step, "
        f"{result['readers']['host_step_ms']:.2f} on the host")
    if not rel <= INPUT_READER_RTOL:
        raise AssertionError(f"reader program: card and host losses differ "
                             f"by {rel}")


def _input_models(result):
    """(e) Each get_model's train reader yields one batch (of
    INPUT_MODEL_BATCH), a DataFeeder turns it into a feed, and one card
    step takes it: the loss is finite."""
    import random

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import models

    class Args:
        batch_size, data_set = INPUT_MODEL_BATCH, "flowers"
        max_seq_len, learning_rate = LSTM_MAX_LEN, 2e-4

    out = {}
    for name in ("resnet", "se_resnext", "vgg", "mnist",
                 "stacked_dynamic_lstm", "machine_translation"):
        t0 = time.perf_counter()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            loss, _, opt, train_reader, _, _ = getattr(
                models, name).get_model(Args())
            opt.minimize(loss)
        main.random_seed = startup.random_seed = SEED
        random.seed(SEED)
        batch = next(train_reader())
        slots = [v for v in main.global_block().vars.values() if v.is_data]
        feeder = fluid.DataFeeder(feed_list=slots, place=fluid.CUDAPlace(0),
                                  program=main)
        feed = feeder.feed(batch)
        exe = fluid.Executor()
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            lv = float(np.asarray(exe.run(main, feed=feed,
                                          fetch_list=[loss])[0]).ravel()[0])
        del exe
        out[name] = lv
        log(f"[input] get_model {name}: one train batch of {len(batch)} "
            f"through DataFeeder ({', '.join(s.name for s in slots)}) and "
            f"one card step: loss {lv:.6f} "
            f"({time.perf_counter() - t0:.2f} s)")
        if not np.isfinite(lv):
            raise AssertionError(f"get_model {name}: non-finite loss {lv}")
        _release()
    result["get_model_losses"] = out


def phase_input(card_line, headline_img_s):
    """The input path: the headline's program (bf16 AMP, fused Momentum,
    batch 128) trained from a RecordIO file through DataPipe's worker
    processes, pinned staging and the captured step ((a), (b)); a wire
    decode inside the captured step (c); the reader ops (d); get_model's
    readers through a DataFeeder (e). Its file is made in a temporary
    directory, removed after."""
    import tempfile

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, convert, flags

    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_input_")
    place = fluid.CUDAPlace(0)
    result = {"workers": INPUT_WORKERS, "images": INPUT_IMAGES,
              "batch": HEADLINE_BATCH, "iters": HEADLINE_K,
              "warm_calls": INPUT_WARM, "timed_calls": INPUT_CALLS}
    try:
        path = os.path.join(workdir, "train.recordio")
        t0 = time.perf_counter()
        size = _write_input_file(path)
        result["file_bytes"] = size
        log(f"[input] {card_line}: {INPUT_IMAGES} seeded {INPUT_SIDE}x"
            f"{INPUT_SIDE}x3 uint8 images written by recordio.Writer "
            f"(compressor none, native library built at first use) in "
            f"{time.perf_counter() - t0:.2f} s: {size / 1e6:.1f} MB; "
            f"{INPUT_WORKERS} decode worker processes")
        main, startup, loss, buckets = build_headline()
        amp.enable("bfloat16")
        try:
            with flags.flag_guard(fuse=True):
                init_scope = fluid.Scope()
                with fluid.scope_guard(init_scope):
                    fluid.Executor(place).run(startup)
                init = convert.numpy_state(init_scope, main)
                del init_scope
                _input_speed(main, loss, buckets, init, path, place,
                             headline_img_s, result)
                _release()
                _input_bitwise(main, loss, init, path, place, result)
                _release()
        finally:
            amp.disable()
        _input_link(result)
        _input_shm_route(path, place, result)
        _release()
        _input_wire(place, result)
        _release()
        _input_readers(workdir, result)
        _release()
        _input_models(result)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    result["seconds"] = time.perf_counter() - t_phase
    log(f"[input] phase seconds {result['seconds']:.1f}")
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
                    f"{tag}_graph", f"{m['kind']}_kernel",
                    expect=len(m["buckets"]))
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


def seq_batches(model, rs, steps, batch, review_len=(16, 128)):
    """`steps` batches of `batch` samples drawn as the JAX package's
    synthetic readers draw them (paddle_tpu/dataset/imdb.py
    _synthetic_reader, wmt14.py _reader): reviews of 16..127 word ids
    (`review_len`'s half-open range), 70%
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
                y, n = rs.randint(2), rs.randint(*review_len)
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


def seq_feeds(batches, place, totals=None):
    """Per-step feed dicts: every ragged feed bucketed with
    create_bucketed_seq_tensor on `place` to one flat total, the batches'
    largest rounded up to SEQ_BUCKET (or `totals`' {name: flat total});
    dense feeds as they are. Returns (feeds, {name: flat total})."""
    import paddle_tpu_torch as fluid

    ragged = [n for n, v in batches[0].items() if isinstance(v, list)]
    if totals is None:
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
    """SEQ_PARITY_STEPS steps of the full-width model at batch
    SEQ_PARITY_BATCH on the host and on the card from the same weights,
    fused Adam: losses within rtol 1e-4 (the repo's fp32 bound)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert, flags

    batches = seq_batches(m["name"], np.random.RandomState(SEED + 1),
                          SEQ_PARITY_STEPS, SEQ_PARITY_BATCH)
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
    log(f"[{m['name']}] host vs card, {SEQ_PARITY_STEPS} steps at batch "
        f"{SEQ_PARITY_BATCH} "
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
                table=f"{tag}_graph", expect=len(m["buckets"]))
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
        if tag in LOOP_FORWARD_TAGS:
            loops = _loop_forward_ms(main, init, per_step[0], [loss])
            result.update(loop_forward_ms=loops,
                          recompute_share=sum(loops.values())
                          / result["step_ms"])
            log(f"[{tag}] {card_line}: the loop ops' forwards alone, each "
                f"replayed from a graph at a step's inputs: "
                f"{ {k: round(v, 3) for k, v in loops.items()} } ms; each "
                f"runs again inside its derived grad: that recompute is "
                f"{result['recompute_share']:.3f} of the "
                f"{result['step_ms']:.2f} ms step")
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


def _train_and_save_headline(rs, model_dir, params_dir=None):
    """The headline's network trained SERVE_TRAIN_STEPS steps at batch
    BATCH under bf16 AMP (fused Momentum), so the running statistics
    move, then saved with io.save_inference_model (and, with
    `params_dir`, io.save_params). Returns the losses."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, flags

    main, startup, loss, _, prediction = build_headline(
        with_prediction=True)
    exe = fluid.Executor(fluid.CUDAPlace(0))
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
        if params_dir is not None:
            fluid.io.save_params(exe, params_dir, main_program=main)
    return losses


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
        losses = _train_and_save_headline(rs, model_dir, params_dir)
        files = os.listdir(model_dir)
        nbytes = sum(os.path.getsize(os.path.join(model_dir, f))
                     for f in files)
        result.update(train_losses=losses, saved_files=len(files),
                      saved_bytes=nbytes)
        log(f"[serve] trained {SERVE_TRAIN_STEPS} steps at batch {BATCH} "
            f"under bf16 AMP (losses {losses}); save_inference_model: "
            f"{len(files)} files, {nbytes} bytes")
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


def _tail_compare(card, host, what, worst, tag="tail_ops"):
    """Card outputs against the host's: integers and bools equal; floats
    within TAIL_RTOL of the host array's largest magnitude (a sum over
    2,048 or 30,000 terms in another order differs by a fraction of its
    terms' size, not of its own), recorded in `worst`."""
    for slot, hs in host.items():
        cs = card.get(slot, [])
        if len(cs) != len(hs):
            raise AssertionError(f"[{tag}] {what} {slot}: {len(cs)} "
                                 f"outputs on the card, {len(hs)} on the host")
        for c, h in zip(cs, hs):
            if h is None:
                continue
            c = c.detach().cpu()
            if c.shape != h.shape or c.dtype != h.dtype:
                raise AssertionError(
                    f"[{tag}] {what} {slot}: card {c.dtype}"
                    f"{tuple(c.shape)} vs host {h.dtype}{tuple(h.shape)}")
            if not h.dtype.is_floating_point:
                if not torch.equal(c, h):
                    raise AssertionError(f"[{tag}] {what} {slot}: card "
                                         f"and host differ")
                continue
            if not h.numel():
                continue
            scale = float(h.abs().max())
            diff = float((c - h).abs().max())
            if not (np.isfinite(scale) and diff <= TAIL_RTOL * scale):
                raise AssertionError(
                    f"[{tag}] {what} {slot}: card vs host {diff:.3e}, "
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


# ---------------------------------------------------------------------------
# phase loss_ops: the structured losses, the metrics and the nn rest on the
# card; the book's semantic-role-labelling db_lstm trained there
# ---------------------------------------------------------------------------
class _Seq:
    """A ragged numpy input: data [N, ...] and lengths [B]."""

    def __init__(self, data, lengths):
        self.data = data
        self.lengths = np.asarray(lengths, np.int32)

    @property
    def shape(self):
        return f"{len(self.lengths)} sequences, {self.data.shape[0]} rows x " \
            f"{list(self.data.shape[1:])}"


def _ragged(rs, n, lo, hi, *feature, ids=None, low=0):
    """n sequences of lo..hi rows: f32 rows, or ints in [low, ids)."""
    lengths = rs.randint(lo, hi + 1, n)
    rows = int(lengths.sum())
    data = rs.randint(low, ids, (rows,) + feature).astype(np.int64) \
        if ids is not None else rs.randn(rows, *feature).astype(np.float32)
    return _Seq(data, lengths)


def _loss_inputs(rs):
    """{case: (op type, inputs, attrs, output slots given a cotangent,
    {grad input slot: forward output slot})} for the 25 op types whose
    card and host runs must agree, each at one full-width shape: the
    book's CRF tagger batch (10 sentences of 10-60 tokens, 67 tags), a
    speech recogniser's CTC batch (96 classes), NCE and hierarchical
    sigmoid over 30,000 classes, a Transformer-width layer norm, the
    image ops at the widths of the nets that use them."""
    def f32(*shape, scale=1.0):
        return (rs.randn(*shape) * scale).astype(np.float32)

    c = {}
    em = _ragged(rs, SRL_BATCH, *SRL_LEN, SRL_LABELS)
    tags = _Seq(rs.randint(0, SRL_LABELS, (em.data.shape[0], 1)),
                em.lengths)
    trans = f32(SRL_LABELS + 2, SRL_LABELS, scale=0.1)
    c["linear_chain_crf"] = ("linear_chain_crf", {
        "Emission": [em], "Transition": [trans], "Label": [tags]}, {},
        ["LogLikelihood"], {})
    c["crf_decoding"] = ("crf_decoding", {"Emission": [em],
                                          "Transition": [trans]}, {}, [], {})
    c["crf_decoding_label"] = ("crf_decoding", {
        "Emission": [em], "Transition": [trans], "Label": [tags]}, {}, [], {})
    logits = _ragged(rs, *LOSS_CTC, LOSS_CTC_CLASSES)
    labels = _ragged(rs, LOSS_CTC[0], 4, LOSS_CTC_LABEL_MAX, 1,
                     ids=LOSS_CTC_CLASSES, low=1)
    c["warpctc"] = ("warpctc", {"Logits": [logits], "Label": [labels]},
                    {"blank": 0, "norm_by_times": False}, ["Loss"], {})
    greedy = _Seq(rs.randint(0, 4, (logits.data.shape[0], 1)),
                  logits.lengths)
    c["ctc_align"] = ("ctc_align", {"Input": [greedy]},
                      {"blank": 0, "merge_repeated": True}, [], {})
    b, d, n = LOSS_NCE
    c["nce"] = ("nce", {
        "Input": [f32(b, d)], "Label": [rs.randint(0, n, (b, 1))],
        "Weight": [f32(n, d, scale=0.05)], "Bias": [f32(n, 1, scale=0.01)]},
        {"num_total_classes": n, "num_neg_samples": 10,
         "custom_neg_classes": [int(v) for v in rs.choice(n, 10, False)]},
        ["Cost"], {"SampleLabels": "SampleLabels"})
    c["hierarchical_sigmoid"] = ("hierarchical_sigmoid", {
        "X": [f32(b, d)], "W": [f32(n - 1, d, scale=0.05)],
        "Label": [rs.randint(0, n, (b, 1))],
        "Bias": [f32(n - 1, 1, scale=0.01)]}, {"num_classes": n}, ["Out"],
        {})
    prob = rs.rand(LOSS_AUC_ROWS).astype(np.float32)
    c["auc"] = ("auc", {
        "Predict": [np.stack([1 - prob, prob], 1)],
        "Label": [(rs.rand(LOSS_AUC_ROWS, 1) < prob[:, None]).astype(
            np.int64)],
        "StatPos": [np.zeros(201, np.float32)],
        "StatNeg": [np.zeros(201, np.float32)]}, {"num_thresholds": 200},
        [], {})
    k = rs.randint(0, 1000, (LOSS_AUC_ROWS, 1))
    c["precision_recall"] = ("precision_recall", {
        "MaxProbs": [rs.rand(LOSS_AUC_ROWS, 1).astype(np.float32)],
        "Indices": [k], "Labels": [np.where(rs.rand(LOSS_AUC_ROWS, 1) < 0.5,
                                            k, rs.randint(0, 1000, k.shape))],
        "Weights": [rs.rand(LOSS_AUC_ROWS, 1).astype(np.float32)],
        "StatesInfo": [np.zeros((1000, 4), np.float32)]},
        {"class_number": 1000}, [], {})
    hyps = _ragged(rs, *LOSS_EDIT, 1, ids=30)
    refs = _ragged(rs, *LOSS_EDIT, 1, ids=30)
    c["edit_distance"] = ("edit_distance", {"Hyps": [hyps], "Refs": [refs]},
                          {"normalized": True}, [], {})
    inf = _ragged(rs, 512, 10, 60, 1, ids=SRL_LABELS)
    lab = _Seq(np.where(rs.rand(*inf.data.shape) < 0.8, inf.data,
                        rs.randint(0, SRL_LABELS, inf.data.shape)),
               inf.lengths)
    c["chunk_eval"] = ("chunk_eval", {"Inference": [inf], "Label": [lab]},
                       {"num_chunk_types": SRL_CHUNK_TYPES,
                        "chunk_scheme": "IOB"}, [], {})
    rows, width = LOSS_LN
    c["layer_norm"] = ("layer_norm", {"X": [f32(rows, width)],
                                      "Scale": [f32(width)],
                                      "Bias": [f32(width)]},
                       {"begin_norm_axis": 1, "epsilon": 1e-5}, ["Y"], {})
    c["conv2d_transpose"] = ("conv2d_transpose", {
        "Input": [f32(16, 256, 16, 16)],
        "Filter": [f32(256, 128, 4, 4, scale=0.05)]},
        {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1]},
        ["Output"], {})
    c["depthwise_conv2d"] = ("depthwise_conv2d", {
        "Input": [f32(32, 128, 56, 56)], "Filter": [f32(128, 1, 3, 3)]},
        {"strides": [1, 1], "paddings": [1, 1]}, ["Output"], {})
    c["conv3d"] = ("conv3d", {"Input": [f32(2, 32, 16, 28, 28)],
                              "Filter": [f32(64, 32, 3, 3, 3, scale=0.05)]},
                   {"strides": [1, 1, 1], "paddings": [1, 1, 1]},
                   ["Output"], {})
    c["lrn"] = ("lrn", {"X": [f32(64, 96, 55, 55)]},
                {"n": 5, "k": 2.0, "alpha": 1e-4, "beta": 0.75}, ["Out"], {})
    c["prelu"] = ("prelu", {"X": [f32(64, 64, 56, 56)],
                            "Alpha": [np.array([0.25], np.float32)]},
                  {"mode": "all"}, ["Out"], {})
    c["bilinear_interp"] = ("bilinear_interp", {"X": [f32(16, 256, 64, 64)]},
                            {"out_h": 128, "out_w": 128}, ["Out"], {})
    c["row_conv"] = ("row_conv", {"X": [_ragged(rs, 32, 64, 256, 1024)],
                                  "Filter": [f32(3, 1024)]}, {}, ["Out"], {})
    c["im2sequence"] = ("im2sequence", {"X": [f32(64, 3, 32, 100)]},
                        {"kernels": [3, 3], "strides": [1, 1],
                         "paddings": [1, 1, 1, 1]}, ["Out"], {})
    c["spp"] = ("spp", {"X": [f32(64, 256, 13, 13)]},
                {"pyramid_height": 3, "pooling_type": "max"}, ["Out"], {})
    pooled, idx = torch.nn.functional.max_pool2d(
        torch.from_numpy(f32(16, 64, 112, 112)), 2, 2, return_indices=True)
    c["unpool"] = ("unpool", {"X": [pooled.numpy()], "Indices": [idx.numpy()]},
                   {"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0]},
                   ["Out"], {})
    c["maxout"] = ("maxout", {"X": [f32(64, 512, 14, 14)]}, {"groups": 2},
                   ["Out"], {})
    c["multiplex"] = ("multiplex", {
        "X": [f32(rows, width) for _ in range(4)],
        "Ids": [rs.randint(0, 4, (rows, 1))]}, {}, ["Out"], {})
    lr = _ragged(rs, 32, 64, 256, 1024)
    offs = np.concatenate([[0], np.cumsum(lr.lengths[::-1])]).tolist()
    c["lod_reset"] = ("lod_reset", {"X": [lr]}, {"target_lod": offs},
                      ["Out"], {})
    return c


def _loss_value(v, device):
    if isinstance(v, _Seq):
        from paddle_tpu_torch.core.registry import SeqTensor

        return SeqTensor(torch.from_numpy(v.data).to(device),
                         torch.from_numpy(v.lengths).to(device), v.lengths)
    return torch.from_numpy(np.asarray(v)).to(device)


def _loss_run(op_type, ins, attrs, place, ctx=None):
    """The op's kernel on `place` (registry.run_kernel): its outputs, a
    SeqTensor as two entries (`slot`: data, `slot.lengths`)."""
    from paddle_tpu_torch.core import executor_core, registry

    ctx = ctx or executor_core.OpContext(place)
    outs = registry.run_kernel(
        registry.lookup(op_type), ctx,
        {s: [_loss_value(v, ctx.device) for v in vs]
         for s, vs in ins.items()}, dict(attrs))
    flat = {}
    for slot, vals in outs.items():
        flat[slot] = [registry.seq_data(v) for v in vals]
        if any(isinstance(v, registry.SeqTensor) for v in vals):
            flat[slot + ".lengths"] = [v.lengths for v in vals]
    return outs, flat


def _as_input(v):
    """An output (tensor or SeqTensor) as a numpy input of another op."""
    from paddle_tpu_torch.core.registry import SeqTensor

    if isinstance(v, SeqTensor):
        return _Seq(v.data.cpu().numpy(), v.lengths.cpu().numpy())
    return v.cpu().numpy()


def _loss_cotangents(rs, outs, slots):
    from paddle_tpu_torch.core.registry import SeqTensor

    cot = {}
    for s in slots:
        vals = []
        for v in outs[s]:
            d = v.data if isinstance(v, SeqTensor) else v
            g = rs.randn(*d.shape).astype(np.float32)
            vals.append(_Seq(g, v.lengths.cpu().numpy())
                        if isinstance(v, SeqTensor) else g)
        cot[f"{s}@GRAD"] = vals
    return cot


def _loss_random_laws(card):
    """The three drawing ops, on the card and on the host, each held by
    its law (the two devices' generators draw other numbers):
    truncated_gaussian_random within [-2, 2] with the truncated law's
    variance; every random_crop a window of its own image at an offset
    in range; nce's drawn negatives in range, fresh each step, and its
    grad at the drawn SampleLabels equal to its grad at the same
    negatives given as custom_neg_classes."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor_core

    out = {}
    for name, place in (("card", card), ("host", fluid.CPUPlace())):
        ctx = executor_core.OpContext(place)
        ctx.rng = executor_core.RandomStream(ctx.device, SEED)
        z = _loss_run("truncated_gaussian_random", {},
                      {"shape": list(LOSS_TGR), "dtype": "float32"}, place,
                      ctx)[1]["Out"][0].double()
        var = float(z.var())
        if not (float(z.min()) >= -2.0 and float(z.max()) <= 2.0
                and abs(float(z.mean())) < 2e-3
                and abs(var - TRUNC_NORMAL_VAR) < 2e-3):
            raise AssertionError(f"[loss_ops] truncated_gaussian_random on "
                                 f"the {name}: min {float(z.min())}, max "
                                 f"{float(z.max())}, var {var}")
        x = np.arange(np.prod(LOSS_CROP_IN), dtype=np.float64).reshape(
            LOSS_CROP_IN)
        crop = _loss_run("random_crop", {"X": [x]},
                         {"shape": list(LOSS_CROP)}, place,
                         ctx)[1]["Out"][0].cpu().numpy()
        h, w = LOSS_CROP_IN[-2:]
        offsets = set()
        for i in range(0, LOSS_CROP_IN[0], 7):
            r, col = divmod(int(crop[i, 0, 0, 0] - x[i, 0, 0, 0]), w)
            if not (0 <= r <= h - LOSS_CROP[1] and 0 <= col <= w
                    - LOSS_CROP[2] and np.array_equal(
                        crop[i], x[i, :, r:r + LOSS_CROP[1],
                                   col:col + LOSS_CROP[2]])):
                raise AssertionError(f"[loss_ops] random_crop on the {name}: "
                                     f"image {i} is no window of its input")
            offsets.add((r, col))
        rs = np.random.RandomState(SEED)
        b, d, n = LOSS_NCE
        ins = {"Input": [rs.randn(b, d).astype(np.float32)],
               "Label": [rs.randint(0, n, (b, 1))],
               "Weight": [(rs.randn(n, d) * 0.05).astype(np.float32)],
               "Bias": [np.zeros((n, 1), np.float32)]}
        attrs = {"num_total_classes": n, "num_neg_samples": 10}
        s1 = _loss_run("nce", ins, attrs, place, ctx)[1]["SampleLabels"][0]
        s2 = _loss_run("nce", ins, attrs, place, ctx)[1]["SampleLabels"][0]
        neg = s1[:, 1:]
        if not (int(neg.min()) >= 0 and int(neg.max()) < n
                and not torch.equal(neg, s2[:, 1:])):
            raise AssertionError(f"[loss_ops] nce's draw on the {name}")
        one = {"Input": [ins["Input"][0][:1]], "Label": [ins["Label"][0][:1]],
               "Weight": ins["Weight"], "Bias": ins["Bias"],
               "Cost@GRAD": [np.ones((1, 1), np.float32)]}
        drawn = _loss_run("nce_grad", dict(one, SampleLabels=[
            s1[:1].cpu().numpy()]), attrs, place)[1]
        custom = dict(attrs, custom_neg_classes=[int(v) for v in neg[0]])
        fixed = _loss_run("nce_grad", dict(one, SampleLabels=[
            s1[:1].cpu().numpy()]), custom, place)[1]
        for slot in ("Input@GRAD", "Weight@GRAD", "Bias@GRAD"):
            if not torch.equal(drawn[slot][0], fixed[slot][0]):
                raise AssertionError(f"[loss_ops] nce_grad on the {name} "
                                     f"does not replay its SampleLabels")
        out[name] = {"trunc_var": var, "crop_offsets": len(offsets)}
    log(f"[loss_ops] (a) the drawing ops by their laws, card and host "
        f"(other generators, other numbers): truncated_gaussian_random "
        f"{list(LOSS_TGR)} in [-2, 2], variance "
        f"{out['card']['trunc_var']:.5f} / {out['host']['trunc_var']:.5f} "
        f"(law {TRUNC_NORMAL_VAR}); random_crop {list(LOSS_CROP_IN)} -> "
        f"{list(LOSS_CROP)}: every checked image a window of itself, "
        f"{out['card']['crop_offsets']} / {out['host']['crop_offsets']} "
        f"distinct offsets; nce over {LOSS_NCE[2]} classes with 10 drawn "
        f"negatives: in range, fresh each step, nce_grad replays them")
    return out


def _loss_ops_on_card(card):
    """(a) every op type of the slice on the card and on the host from the
    same seeded inputs at a full-width shape, forward and grad (the
    phase tail_ops tolerance, TF32 off); the drawing ops by their laws.
    Returns the count of op types."""
    import paddle_tpu_torch as fluid

    rs = np.random.RandomState(SEED)
    cases = _loss_inputs(rs)
    host = fluid.CPUPlace()
    worst, grads = {}, 0
    for what, (op_type, ins, attrs, slots, extra) in cases.items():
        t0 = time.perf_counter()
        h_outs, h = _loss_run(op_type, ins, attrs, host)
        t1 = time.perf_counter()
        _, c = _loss_run(op_type, ins, attrs, card)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        _tail_compare(c, h, what, worst, tag="loss_ops")
        line = ""
        if slots:
            gins = dict(ins, **_loss_cotangents(rs, h_outs, slots),
                        **{g: [_as_input(v) for v in h_outs[f]]
                           for g, f in extra.items()})
            grad_type = "nce_grad" if op_type == "nce" else op_type + "_grad"
            gh = _loss_run(grad_type, gins, attrs, host)[1]
            gc_ = _loss_run(grad_type, gins, attrs, card)[1]
            _tail_compare(gc_, gh, what + "_grad", worst, tag="loss_ops")
            grads += 1
            line = f", grad {worst.get(what + '_grad', 0.0):.2e}"
        shapes = {s: (v.shape if isinstance(v, _Seq) else list(np.shape(v)))
                  for s, vs in ins.items() for v in vs[:1]}
        log(f"[loss_ops] (a) {what} at {shapes}: card vs host "
            f"{worst.get(what, 0.0):.2e}{line} of the host's largest "
            f"(host {t1 - t0:.2f} s, card {t2 - t1:.2f} s)")
        del h_outs, h, c
    laws = _loss_random_laws(card)
    types = {v[0] for v in cases.values()} | {
        "nce_grad", "random_crop", "truncated_gaussian_random"}
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    log(f"[loss_ops] (a) {len(types)} op types on the card and the host "
        f"({len(cases)} cases, {grads} with grads, 3 drawing ops by their "
        f"laws): all within {TAIL_RTOL:g} of the host array's scale, "
        f"integers and the decoded tags equal; largest "
        f"{[(k, f'{v:.2e}') for k, v in top]}")
    return {"op_types": len(types), "cases": len(cases), "grads": grads,
            "worst": worst, "laws": laws}


def build_srl(fluid, widths=None):
    """The PaddlePaddle book's label_semantic_roles db_lstm (chapter 07)
    at its published widths, built with `fluid`'s layers: six word-id
    slots share the non-trainable `emb` (44,068 x 32) beside the
    predicate's `vemb` (3,162 x 32) and the mark's (2 x 5) embeddings; a
    sum of fc(512, tanh); SRL_DEPTH dynamic_lstm(512) with a relu
    candidate and sigmoid gate and cell, reversed on odd layers, each
    (hidden, cell) pair feeding the next fc as the book passes it;
    feature_out a sum of two fc(67, tanh); linear_chain_crf on `crfw`
    (learning rate 1e-3), mean, crf_decoding on `crfw`; SGD on
    exponential_decay(0.01, 100000, 0.5, staircase). The test program
    (the net cloned for test before the optimizer) holds chunk_eval (IOB,
    33 chunk types). Returns (main, test, startup, loss, decode, chunk
    outputs)."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        data = {n: L.data(name=n, shape=[1], dtype="int64", lod_level=1)
                for n in SRL_SLOTS}
        embs = [L.embedding(data[n], size=[SRL_WORD_V, SRL_WORD_DIM],
                            param_attr=fluid.ParamAttr(name="emb",
                                                       trainable=False))
                for n in SRL_SLOTS[:6]]
        embs += [L.embedding(data["verb"], size=[SRL_PRED_V, SRL_WORD_DIM],
                             param_attr="vemb"),
                 L.embedding(data["mark"], size=[2, SRL_MARK_DIM])]
        hidden_0 = L.sums(input=[L.fc(input=e, size=SRL_HIDDEN, act="tanh")
                                 for e in embs])
        lstm = L.dynamic_lstm(input=hidden_0, size=SRL_HIDDEN,
                              candidate_activation="relu",
                              gate_activation="sigmoid",
                              cell_activation="sigmoid")
        tmp = [hidden_0, lstm]
        for i in range(1, SRL_DEPTH):
            mix = L.sums(input=[
                L.fc(input=tmp[0], size=SRL_HIDDEN, act="tanh"),
                L.fc(input=tmp[1], size=SRL_HIDDEN, act="tanh")])
            lstm = L.dynamic_lstm(input=mix, size=SRL_HIDDEN,
                                  candidate_activation="relu",
                                  gate_activation="sigmoid",
                                  cell_activation="sigmoid",
                                  is_reverse=(i % 2) == 1)
            tmp = [mix, lstm]
        feature_out = L.sums(input=[
            L.fc(input=tmp[0], size=SRL_LABELS, act="tanh"),
            L.fc(input=tmp[1], size=SRL_LABELS, act="tanh")])
        loss = L.mean(L.linear_chain_crf(
            input=feature_out, label=data["target"],
            param_attr=fluid.ParamAttr(name="crfw", learning_rate=1e-3)))
        decode = L.crf_decoding(input=feature_out,
                                param_attr=fluid.ParamAttr(name="crfw"))
        test = main.clone(for_test=True)
        with fluid.program_guard(test, startup):
            block = test.global_block()
            chunks = L.chunk_eval(input=block.var(decode.name),
                                  label=block.var("target"),
                                  chunk_scheme="IOB",
                                  num_chunk_types=SRL_CHUNK_TYPES)
        fluid.optimizer.SGD(learning_rate=L.exponential_decay(
            learning_rate=0.01, decay_steps=100000, decay_rate=0.5,
            staircase=True)).minimize(loss)
    main.random_seed = startup.random_seed = SEED % 1000
    return main, test, startup, loss, decode, chunks


def srl_batches(rs, steps):
    """`steps` batches of SRL_BATCH sentences of SRL_LEN tokens, drawn as
    the JAX package's synthetic conll05 reader draws them: random words,
    one marked predicate, the context windows around it, labels that
    follow the signed distance to it. {slot: [per-sentence id arrays]}."""
    out = []
    for _ in range(steps):
        b = {s: [] for s in SRL_SLOTS}
        for _ in range(SRL_BATCH):
            t = int(rs.randint(SRL_LEN[0], SRL_LEN[1] + 1))
            words = rs.randint(0, SRL_WORD_V, t)
            pos = int(rs.randint(t))
            b["word"].append(words)
            for s, off in zip(SRL_SLOTS[1:6], (-2, -1, 0, 1, 2)):
                b[s].append(np.full(t, words[min(max(pos + off, 0), t - 1)]))
            b["verb"].append(np.full(t, rs.randint(SRL_PRED_V)))
            mark = np.zeros(t, np.int64)
            mark[pos] = 1
            b["mark"].append(mark)
            dist = np.arange(t) - pos
            b["target"].append((np.abs(dist) * 2 + (dist < 0)) % SRL_LABELS)
        out.append(b)
    return out


def _srl_runs(main, fetch, init, feeds, place, graph, timed=0):
    """`feeds`' steps from `init` on one Executor, through the captured
    step (`graph`) or the interpreter: (the fetches of each step as numpy,
    the persistables after them, the ms a step of `timed` more replays
    over the first feeds again, host clock to one scalar read, and the
    executor and scope)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert, flags

    scope = fluid.Scope()
    convert.load_numpy_state(scope, main, init, place)
    exe = fluid.Executor(place)
    with fluid.scope_guard(scope), flags.flag_guard(cuda_graph=graph):
        fetched = [[np.asarray(v) for v in exe.run(main, feed=f,
                                                   fetch_list=fetch)]
                   for f in feeds]
        mode = exe.step_mode(main)
        state = convert.numpy_state(scope, main)
        ms = None
        if timed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for f in feeds[:timed]:  # the same fetches: the same graph
                outs = exe.run(main, feed=f, fetch_list=fetch,
                               return_numpy=False)
            _fence(outs[0])
            ms = (time.perf_counter() - t0) / timed * 1e3
    want = "graph" if graph and place.__class__.__name__ == "CUDAPlace" \
        else "interpreter"
    if mode != want:
        raise AssertionError(f"[loss_ops] db_lstm ran as {mode}, not {want}")
    return fetched, state, ms, exe, scope


def _srl_train(card, card_line):
    """(b) the book's db_lstm at its widths: SRL_STEPS steps through the
    captured step (the first eager, the next the capture, then replays)
    bitwise equal to the interpreter's from one state, fetches and every
    persistable; the host's losses within SRL_RTOL of the card's; then
    SRL_STEPS more replays on the same executor timed (tokens/s, ms a
    step); decoded tags in range; chunk_eval on the test program through
    the interpreter; no hand-written kernel launched (plain SGD:
    FLAGS_fuse buckets only momentum and adam)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert, cuda_build

    main, test, startup, loss, decode, chunks = build_srl(fluid)
    rs = np.random.RandomState(SEED)
    batches = srl_batches(rs, SRL_STEPS + 1)
    per_step, totals = seq_feeds(batches, card)
    host_feeds = seq_feeds(batches[:SRL_STEPS], fluid.CPUPlace(),
                           totals)[0]
    tokens = [sum(len(s) for s in b["word"]) for b in batches]
    init_scope = fluid.Scope()
    with fluid.scope_guard(init_scope):
        fluid.Executor(card).run(startup)
    init = convert.numpy_state(init_scope, main)
    del init_scope
    feeds = per_step[:SRL_STEPS]
    t0 = time.perf_counter()
    counts = cuda_build.launch_counts()
    g_fetch, g_state, step_ms, exe, scope = _srl_runs(
        main, [loss, decode], init, feeds, card, True, timed=SRL_STEPS)
    hand = {f"{w.__name__}.{a}": n - counts[(w, a)]
            for (w, a), n in cuda_build.launch_counts().items()}
    t1 = time.perf_counter()
    i_fetch, i_state = _srl_runs(main, [loss, decode], init, feeds, card,
                                 False)[:2]
    t2 = time.perf_counter()
    h_fetch = _srl_runs(main, [loss], init, host_feeds, fluid.CPUPlace(),
                        False)[0]
    t3 = time.perf_counter()
    losses = [float(f[0].reshape(())) for f in g_fetch]
    host = [float(f[0].reshape(())) for f in h_fetch]
    differ = [n for n in i_state if not np.array_equal(g_state[n],
                                                       i_state[n])]
    equal = not differ and all(
        np.array_equal(g, i) for gs, is_ in zip(g_fetch, i_fetch)
        for g, i in zip(gs, is_))
    if not equal:
        raise AssertionError(f"[loss_ops] db_lstm: graph and interpreter "
                             f"differ (persistables {differ[:5]})")
    if any(hand.values()):
        raise AssertionError(f"[loss_ops] hand-written kernels launched on "
                             f"the db_lstm path: {hand}")
    np.testing.assert_allclose(losses, host, rtol=SRL_RTOL,
                               err_msg="[loss_ops] db_lstm host vs card")
    tags = np.concatenate([f[1] for f in g_fetch])
    with fluid.scope_guard(scope):
        ev = exe.run(test, feed=per_step[SRL_STEPS], fetch_list=list(chunks))
        test_mode = exe.step_mode(test)
        _check_master_state(scope)
    t4 = time.perf_counter()
    prf = [float(np.asarray(v)) for v in ev[:3]]
    if not (np.all(np.isfinite(losses)) and tags.min() >= 0
            and tags.max() < SRL_LABELS and np.all(np.isfinite(prf))
            and test_mode == "interpreter"):
        raise AssertionError(f"[loss_ops] db_lstm: losses {losses}, tags "
                             f"in [{tags.min()}, {tags.max()}], chunk_eval "
                             f"{prf} ({test_mode})")
    result = {
        "batch": SRL_BATCH, "flat_total": totals["word"], "tokens": tokens,
        "card": card_line, "step_ms": step_ms,
        "tokens_per_sec": sum(tokens[:SRL_STEPS]) / (step_ms * SRL_STEPS)
        * 1e3, "losses": losses, "host_losses": host,
        "graph_interpreter_bitwise": equal, "persistables": len(i_state),
        "chunk_eval": {"precision": prf[0], "recall": prf[1], "f1": prf[2],
                       "infer_chunks": int(np.asarray(ev[3])),
                       "label_chunks": int(np.asarray(ev[4])),
                       "correct_chunks": int(np.asarray(ev[5]))},
        "hand_kernel_launches": 0,
        "seconds": {"graph_and_timed": t1 - t0, "interpreter": t2 - t1,
                    "host": t3 - t2, "test_program": t4 - t3}}
    log(f"[loss_ops] (b) {card_line}: book db_lstm (depth {SRL_DEPTH}, "
        f"hidden {SRL_HIDDEN}, vocabularies {SRL_WORD_V} / {SRL_PRED_V} / "
        f"{SRL_LABELS}) at batch {SRL_BATCH}, sentences of "
        f"{SRL_LEN[0]}-{SRL_LEN[1]} tokens bucketed to {totals['word']} "
        f"(the loops' trip count): {result['tokens_per_sec']:.1f} tokens/s, "
        f"{step_ms:.2f} ms a step ({SRL_STEPS} replays of "
        f"{sum(tokens[:SRL_STEPS])} tokens, host clock); graph vs "
        f"interpreter bitwise equal over {SRL_STEPS} steps (the first "
        f"eager, the rest the captured graph), {len(i_state)} persistables "
        f"and the decoded tags; losses {losses}, host {host} (rtol "
        f"{SRL_RTOL:g}); decoded tags in [0, {SRL_LABELS}); chunk_eval on "
        f"the test program (interpreter) P/R/F1 "
        f"{[round(v, 4) for v in prf]}; no hand-written kernel on this path "
        f"(plain SGD; FLAGS_fuse buckets only momentum and adam): launches "
        f"{hand}; seconds "
        f"{ {k: round(v, 1) for k, v in result['seconds'].items()} }")
    del exe, scope
    _release()
    return result


def phase_loss_ops(card_line):
    """(a) every op type of the loss-ops and nn-rest slice, card against
    host, at full width; (b) the book's db_lstm trained on the card.
    Prints its seconds."""
    import paddle_tpu_torch as fluid

    t0 = time.perf_counter()
    ops = _loss_ops_on_card(fluid.CUDAPlace(0))
    _release()
    t1 = time.perf_counter()
    srl = _srl_train(fluid.CUDAPlace(0), card_line)
    t2 = time.perf_counter()
    log(f"[loss_ops] phase {t2 - t0:.1f} s: (a) {t1 - t0:.1f} s, (b) "
        f"{t2 - t1:.1f} s")
    return {"ops": ops, "db_lstm": srl, "seconds": t2 - t0,
            "seconds_by_part": {"ops": t1 - t0, "db_lstm": t2 - t1}}


# ---------------------------------------------------------------------------
# phase control_flow
# ---------------------------------------------------------------------------
def build_drnn_lstm(fluid, vocab=IMDB_VOCAB, emb=CF_DRNN_WIDTH,
                    hidden=CF_DRNN_WIDTH):
    """The reference benchmark's gate-by-gate LSTM
    (benchmark/fluid/models/stacked_dynamic_lstm.py in the reference; the
    JAX package's paddle_tpu/models/stacked_dynamic_lstm.py:4-8), one
    layer, built with `fluid`'s layers: embedding, fc(hidden, tanh), then
    in a DynamicRNN each gate as fc(word) + fc(prev_hidden, no bias) with
    sigmoid (forget, input, output) or tanh (cell), the cell and hidden
    updates as memories, the last step's hidden into fc(2, softmax),
    cross_entropy, mean, Adam(0.002). Feeds "words" (int64, lod_level 1)
    and "label" (int64). Returns (main, startup, loss)."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        words = L.data(name="words", shape=[1], dtype="int64", lod_level=1)
        label = L.data(name="label", shape=[1], dtype="int64")
        sentence = L.fc(input=L.embedding(input=words, size=[vocab, emb]),
                        size=hidden, act="tanh")
        rnn = L.DynamicRNN()
        with rnn.block():
            word = rnn.step_input(sentence)
            prev_hidden = rnn.memory(value=0.0, shape=[hidden])
            prev_cell = rnn.memory(value=0.0, shape=[hidden])

            def gate(act):
                return act(L.elementwise_add(
                    L.fc(input=word, size=hidden),
                    L.fc(input=prev_hidden, size=hidden, bias_attr=False)))

            forget, inp, out = (gate(L.sigmoid) for _ in range(3))
            cell = L.elementwise_add(L.elementwise_mul(forget, prev_cell),
                                     L.elementwise_mul(inp, gate(L.tanh)))
            hidden_t = L.elementwise_mul(out, L.tanh(cell))
            rnn.update_memory(prev_cell, cell)
            rnn.update_memory(prev_hidden, hidden_t)
            rnn.output(hidden_t)
        logit = L.fc(input=L.sequence_last_step(rnn()), size=2,
                     act="softmax")
        loss = L.mean(L.cross_entropy(input=logit, label=label))
        fluid.optimizer.Adam(learning_rate=0.002).minimize(loss)
    main.random_seed = startup.random_seed = SEED
    return main, startup, loss


def build_headline_piecewise():
    """The headline's program with piecewise_decay(CF_BOUNDARIES,
    CF_VALUES) feeding Momentum(0.9): a Switch of conditional blocks
    writes the rate from the step counter each step. Returns (main,
    startup, loss, lr var, momentum buckets)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import fusion

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        prediction = headline_net()
        label = fluid.layers.data(name="label", shape=[1], dtype="int32")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(
            input=prediction, label=label))
        lr = fluid.layers.piecewise_decay(CF_BOUNDARIES, CF_VALUES)
        fluid.optimizer.Momentum(learning_rate=lr,
                                 momentum=0.9).minimize(loss)
    main.random_seed = startup.random_seed = SEED
    _, plan = fusion.apply(main, feed_names=["data_u8", "label"],
                           fetch_names=[loss.name, lr.name])
    buckets = [b for b in plan.buckets if b["opt"] == "momentum"]
    return main, startup, loss, lr, buckets


def _piecewise(step):
    """The schedule's rate at step counter `step` (numpy's answer)."""
    i = int(np.searchsorted(CF_BOUNDARIES, step, side="right"))
    return np.float32(CF_VALUES[i])


class _TimedExecutor:
    """An Executor behind beam_decode that times each run by the program's
    kind (encoder, step, beam, backtrack: the op that tells them apart):
    host ms around Executor.run (its fetch read back included) and the
    card's ms between CUDA events recorded before and after it; and keeps
    each beam step's feeds (pre_ids, pre_scores, cand_scores)."""

    def __init__(self, exe):
        self.exe, self.device = exe, exe.device
        self.runs, self.steps = {}, []

    @staticmethod
    def _kind(program):
        types = {op.type for op in program.global_block().ops}
        for op_type, kind in (("attention_lstm_step", "step"),
                              ("beam_search", "beam"),
                              ("beam_search_decode", "backtrack")):
            if op_type in types:
                return kind
        return "encoder"

    def run(self, program, **kw):
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        t0 = time.perf_counter()
        outs = self.exe.run(program, **kw)
        host = (time.perf_counter() - t0) * 1e3
        end.record()
        kind = self._kind(program)
        self.runs.setdefault(kind, []).append((start, end, host))
        if kind == "beam":
            feed = kw["feed"]
            self.steps.append((feed["pre_ids"], feed["pre_scores"],
                               feed["cand_scores"]))
        return outs

    def last(self, kind):
        """[(card ms, host ms)] of the runs of `kind`."""
        torch.cuda.synchronize()
        return [(s.elapsed_time(e), h) for s, e, h in self.runs[kind]]


def _masked_candidates(pre_ids, pre_scores, cand, K, end_id):
    """The host's [B, K*V] candidate scores as the beam_search op sees
    them: a finished beam keeps one candidate, (end_id, its score), an
    inactive slot none."""
    from paddle_tpu_torch.ops.beam_search_ops import NEG_INF

    c = cand.astype(np.float32).copy()
    fin = pre_ids[:, 0] == end_id
    c[fin] = NEG_INF
    c[fin, 0] = pre_scores[fin, 0]
    c[pre_ids[:, 0] < 0] = NEG_INF
    return c.reshape(-1, K * c.shape[1])


def _first_flip(crecord, record, b, n_steps):
    """The first decode step at which source b's selection on the card
    (from its own candidates, `crecord`) differs from the host's
    (`record`), by the beam_search op's order: a stable descending sort
    of the masked candidates, first K. Returns {step, same_set (the card
    took the host's K candidates in another order), margin (the host's
    K-th minus (K+1)-th score), order_gap (the largest difference of the
    host's scores between the candidates the card and the host put at
    one place)}, or None if no step differs."""
    K = CF_BEAM
    for s in range(n_steps):
        host = _masked_candidates(*record[s], K, 1)[b]
        picked = np.argsort(-host, kind="stable")[:K + 1]
        card = np.argsort(-_masked_candidates(*crecord[s], K, 1)[b],
                          kind="stable")[:K]
        if np.array_equal(card, picked[:K]):
            continue
        top = host[picked]
        return {"step": s,
                "same_set": set(card.tolist()) == set(picked[:K].tolist()),
                "margin": float(top[K - 1] - top[K]),
                "order_gap": float(np.max(np.abs(host[card] - top[:K])))}
    return None


def _cf_decode(exe, scope, main, state, lt, tag, card_line):
    """beam_decode of `lt` on the card, three calls: the first builds the
    step programs on new shapes and captures those that run twice in it
    (a program runs eagerly once, then is captured), the second captures
    the encoder's, which runs once a call, the third replays every graph
    (the warm call); and on the host from `state`, the same weights:
    scores within CF_RTOL, token ids equal or differing only at a
    near-tie of the host's scores (CF_NEAR_TIE): at the first step whose
    selection differs, the host's K-th/(K+1)-th margin, or, where the
    card took the same K candidates in another order, the host's score
    differences between the candidates the two put at one place
    (_first_flip). Returns its numbers and the host's recorded steps."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models import machine_translation as mt

    timed = _TimedExecutor(exe)
    calls = []
    for _ in range(3):
        timed.steps.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = mt.beam_decode(timed, main, lt, beam_size=CF_BEAM,
                              max_len=CF_MAX_LEN, scope=scope)
        calls.append(time.perf_counter() - t0)
    crecord = timed.steps
    n = len(crecord)  # decode steps a call
    runs = {kind: timed.last(kind) for kind in
            ("encoder", "step", "beam", "backtrack")}
    step = [c + b for (c, _), (b, _) in zip(runs["step"][-n:],
                                             runs["beam"][-n:])]
    step_host = [h + g for (_, h), (_, g) in zip(runs["step"][-n:],
                                                 runs["beam"][-n:])]

    def med(kind, i):
        return statistics.median(r[i] for r in runs[kind][-n:])

    result = {
        "decode_steps": n, "call_s": calls, "warm_call_s": calls[-1],
        "sources_per_sec": CF_NMT_BATCH / calls[-1],
        "encoder_ms": {"card": runs["encoder"][-1][0],
                       "host": runs["encoder"][-1][1]},
        "step_program_ms": {"card": med("step", 0), "host": med("step", 1)},
        "beam_program_ms": {"card": med("beam", 0), "host": med("beam", 1)},
        "backtrack_ms": {"card": runs["backtrack"][-1][0],
                         "host": runs["backtrack"][-1][1]},
        "decode_step_ms": {"card": statistics.median(step),
                           "host": statistics.median(step_host)}}
    accounted = (result["encoder_ms"]["host"] + sum(step_host)
                 + result["backtrack_ms"]["host"])
    outside = calls[-1] * 1e3 - accounted
    result["host_outside_runs_ms"] = outside
    log(f"[control_flow] (a) {tag}: beam_decode of {CF_NMT_BATCH} sources, "
        f"beam {CF_BEAM}, max_len {CF_MAX_LEN} ({CF_NMT_BATCH * CF_BEAM} "
        f"rows of {WMT_DICT} candidates a step), {n} steps: calls "
        f"{calls[0]:.3f} s (builds the programs), {calls[1]:.3f} s (captures "
        f"the encoder), warm {calls[2]:.3f} s = "
        f"{result['sources_per_sec']:.2f} sources/s; a warm decode step "
        f"{result['decode_step_ms']['host']:.3f} ms on the host clock, "
        f"{result['decode_step_ms']['card']:.3f} ms between CUDA events "
        f"(attention_lstm_step run {result['step_program_ms']['card']:.3f}"
        f" / {result['step_program_ms']['host']:.3f} ms, beam_search run "
        f"{result['beam_program_ms']['card']:.3f} / "
        f"{result['beam_program_ms']['host']:.3f} ms, events / host); the "
        f"encoder run {result['encoder_ms']['card']:.3f} / "
        f"{result['encoder_ms']['host']:.3f} ms, the backtrack run "
        f"{result['backtrack_ms']['card']:.3f} / "
        f"{result['backtrack_ms']['host']:.3f} ms; host time outside the "
        f"runs {outside:.3f} ms (the embedding table read back, the "
        f"padding, the parents' gathers) [{card_line}]")

    hscope = fluid.Scope()
    convert.load_numpy_state(hscope, main, state, fluid.CPUPlace())
    hexe = _TimedExecutor(fluid.Executor(fluid.CPUPlace()))
    host = mt.beam_decode(hexe, main, lt, beam_size=CF_BEAM,
                          max_len=CF_MAX_LEN, scope=hscope)
    record = hexe.steps
    np.testing.assert_allclose(card[1], host[1], rtol=CF_RTOL)
    flips = []
    n_steps = min(len(crecord), len(record))
    for b in range(CF_NMT_BATCH):
        rows = slice(b * CF_BEAM, (b + 1) * CF_BEAM)
        if card[0][rows] == host[0][rows]:
            continue
        flip = _first_flip(crecord, record, b, n_steps)
        if flip is None:
            raise AssertionError(f"source {b}: card and host beams differ "
                                 f"but every step selected alike")
        flip["source"] = b
        flips.append(flip)
        took = ("the same set in another order" if flip["same_set"]
                else "another set")
        log(f"[control_flow] (a) {tag}: source {b}'s beams differ card vs "
            f"host at step {flip['step']}, where the card took {took}; "
            f"the host's K-th/(K+1)-th score margin there "
            f"{flip['margin']:.3e}, its scores' largest difference between "
            f"the candidates the two put at one place {flip['order_gap']:.3e}"
            f" (near-tie limit {CF_NEAR_TIE:g}: on that difference for the "
            f"same set, else on the margin)")
        tie = flip["order_gap"] if flip["same_set"] else flip["margin"]
        if tie >= CF_NEAR_TIE:
            raise AssertionError(f"source {b}: card and host beams differ "
                                 f"({took}) with no near-tie ({tie:.3e})")
    rel = max(abs(c / h - 1) for c, h in zip(card[1], host[1]) if h)
    lengths = [len(s) for s in card[0]]
    log(f"[control_flow] (a) {tag}: card vs host: {len(card[0])} beams of "
        f"{min(lengths)}-{max(lengths)} tokens, {CF_NMT_BATCH - len(flips)} "
        f"of {CF_NMT_BATCH} sources' token ids equal, scores' largest "
        f"relative difference {rel:.3e} (rtol {CF_RTOL:g}); the first "
        f"source's best beam {card[0][0]} ({card[1][0]:.4f})")
    result.update(host_vs_card_max_rel=rel, flips=flips,
                  beam_lengths=[min(lengths), max(lengths)])
    return result, record


def _cf_nmt(card_line):
    """(a) the NMT at its published widths: beam_decode (beam CF_BEAM,
    max_len CF_MAX_LEN) of CF_NMT_BATCH synthetic WMT14 sources from its
    initial weights, where beams run their full length, then
    CF_NMT_STEPS fused-Adam steps at batch CF_NMT_BATCH through the
    captured step and the same decode from the trained weights, each on
    the card and on the host (_cf_decode); the beam_search op alone, card
    against host, bitwise."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert, flags
    from paddle_tpu_torch.core import executor_core, registry
    from paddle_tpu_torch.core.lod_tensor import LoDTensor
    from paddle_tpu_torch.fusion import kernels as fk

    m = build_seq_model("nmt")
    main, loss = m["main"], m["loss"]
    place = fluid.CUDAPlace(0)
    rs = np.random.RandomState(SEED + 15)
    src = [rs.randint(3, WMT_DICT, rs.randint(4, 16))
           for _ in range(CF_NMT_BATCH)]
    offs = np.concatenate([[0], np.cumsum([len(s) for s in src])])
    lt = LoDTensor(np.concatenate(src).astype(np.int64)[:, None],
                   [offs.tolist()])
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    with fluid.scope_guard(scope):
        exe.run(m["startup"])
    result = {}
    result["initial"], record = _cf_decode(
        exe, scope, main, convert.numpy_state(scope, main), lt,
        "initial weights", card_line)

    feeds, _ = seq_feeds(seq_batches("nmt", rs, CF_NMT_STEPS,
                                     CF_NMT_BATCH), place)
    with fluid.scope_guard(scope):
        fk.reset_launch_counts()
        with flags.flag_guard(fuse=True):
            losses = [float(exe.run(main, feed=f, fetch_list=[loss])[0]
                            .reshape(-1)[0]) for f in feeds]
        launches = fk.adam_bucket.launches
        mode = exe.step_mode(main)
    want = len(m["buckets"]) * CF_NMT_STEPS
    log(f"[control_flow] (a) NMT trained {CF_NMT_STEPS} steps at batch "
        f"{CF_NMT_BATCH} ({mode}): losses {losses}; adam_bucket_ launches "
        f"{launches} ({len(m['buckets'])} buckets x {CF_NMT_STEPS} steps)")
    if mode != "graph" or launches != want:
        raise AssertionError(f"NMT training ran {mode} with {launches} "
                             f"adam launches, not graph with {want}")
    result["trained"], _ = _cf_decode(
        exe, scope, main, convert.numpy_state(scope, main), lt,
        "trained weights", card_line)
    result.update(train_losses=losses, adam_launches=launches)

    # the op alone, card against host, on the host decode's candidates:
    # the first step (3 inactive slots a source: NEG_INF ties), the last
    # one, and the last one rounded to 0.5 (ties among live candidates)
    op = registry.lookup("beam_search")
    sets = [record[0], record[-1],
            record[-1][:2] + (np.round(record[-1][2] * 2) / 2,)]
    for i, (pre_ids, pre_scores, cand) in enumerate(sets):
        outs = {}
        for p in (fluid.CPUPlace(), fluid.CUDAPlace(0)):
            ctx = executor_core.OpContext(p)
            outs[repr(p)] = op.fn(ctx, {
                "pre_ids": [torch.from_numpy(pre_ids).to(ctx.device)],
                "pre_scores": [torch.from_numpy(pre_scores).to(ctx.device)],
                "scores": [torch.from_numpy(
                    np.ascontiguousarray(cand)).to(ctx.device)]},
                {"beam_size": CF_BEAM, "end_id": 1})
        for slot, (h,) in outs["CPUPlace()"].items():
            if not torch.equal(outs["CUDAPlace(0)"][slot][0].cpu(), h):
                raise AssertionError(f"beam_search {slot}: card and host "
                                     f"differ on candidate set {i}")
    log(f"[control_flow] (a) the beam_search op alone on {len(sets)} "
        f"candidate sets of [{CF_NMT_BATCH * CF_BEAM}, {WMT_DICT}] (NEG_INF "
        f"ties, live ties): card and host bitwise equal [{card_line}]")
    del exe, scope, record
    _release()
    return result


def _cf_headline(card, headline_img_s):
    """(b) the headline under piecewise_decay, bf16 AMP, fused Momentum,
    batch 128, iters=HEADLINE_K, CF_HEAD_WARM + CF_HEAD_CALLS calls
    through the captured step: one CapturedStep and no capture after the
    first call, momentum launches, each call's rates against the numpy
    schedule at its step counters, img/s against `headline_img_s`; graph
    against interpreter bitwise over 3 steps that cross a boundary."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, convert, flags
    from paddle_tpu_torch.fusion import kernels as fk

    main, startup, loss, lr, buckets = build_headline_piecewise()
    rs = np.random.RandomState(SEED + 16)
    feeds = {"data_u8": torch.from_numpy(rs.randint(
        0, 256, (HEADLINE_K, HEADLINE_BATCH, 224, 224, 3),
        dtype=np.uint8)).cuda(),
        "label": torch.from_numpy(rs.randint(
            0, 1000, (HEADLINE_K, HEADLINE_BATCH, 1)).astype(
                np.int32)).cuda()}
    place = fluid.CUDAPlace(0)
    amp.enable("bfloat16")
    try:
        with flags.flag_guard(fuse=True):
            init_scope = fluid.Scope()
            with fluid.scope_guard(init_scope):
                fluid.Executor(place).run(startup)
            init = convert.numpy_state(init_scope, main)
            scope = init_scope
            exe = fluid.Executor()
            torch.cuda.synchronize()
            fk.reset_launch_counts()
            rates = []
            with fluid.scope_guard(scope):
                for _ in range(CF_HEAD_WARM):
                    outs = exe.run(main, feed=feeds, fetch_list=[loss, lr],
                                   iters=HEADLINE_K, return_numpy=False)
                    rates.append(outs[1])
                    _fence(outs[0])
                entries = exe.compile_cache_info()["entries"]
                t0 = time.perf_counter()
                for _ in range(CF_HEAD_CALLS):
                    outs = exe.run(main, feed=feeds, fetch_list=[loss, lr],
                                   iters=HEADLINE_K, return_numpy=False)
                    rates.append(outs[1])
                _fence(outs[0])
                dt = time.perf_counter() - t0
                launches = fk.momentum_bucket.launches
                mode = exe.step_mode(main)
                captured = len(exe.captured_steps(main, scope))
                later = exe.compile_cache_info()["entries"] - entries
                counter = int(scope.find_var("@LR_DECAY_COUNTER@")
                              .reshape(-1)[0])
                _check_master_state(scope)
            lv = _losses(outs[0])
            del exe, scope, init_scope
            _release()
            # 3 steps from counter CF_BOUNDARIES[0] - 2 on: the first
            # boundary falls between the first and the second
            init["@LR_DECAY_COUNTER@"] = np.array(
                [CF_BOUNDARIES[0] - 2], np.int64)
            bitwise = _graph_vs_interpreter(
                "control_flow", main, [loss, lr], init,
                [{n: t[k, :BATCH] for n, t in feeds.items()}
                 for k in range(3)])
    finally:
        amp.disable()
    steps = (CF_HEAD_WARM + CF_HEAD_CALLS) * HEADLINE_K
    got = np.concatenate([r.reshape(-1).float().cpu().numpy()
                          for r in rates])
    want = np.array([_piecewise(k) for k in range(steps)])
    img_s = HEADLINE_BATCH * HEADLINE_K * CF_HEAD_CALLS / dt
    ratio = img_s / headline_img_s
    crossings = [(b, float(got[b - 1]), float(got[b]))
                 for b in CF_BOUNDARIES if b < steps]
    log(f"[control_flow] (b) {card}: headline + piecewise_decay("
        f"{CF_BOUNDARIES}, {CF_VALUES}), bf16 AMP, fused Momentum, batch "
        f"{HEADLINE_BATCH}: {mode}, {captured} CapturedStep, {later} "
        f"captures after the first call; {img_s:.2f} img/s "
        f"({dt / (HEADLINE_K * CF_HEAD_CALLS) * 1e3:.2f} ms a step; "
        f"{CF_HEAD_CALLS} calls of iters={HEADLINE_K} after {CF_HEAD_WARM} "
        f"warm), {ratio:.4f} of the headline's {headline_img_s:.2f} (limit "
        f"{CF_HEAD_MIN_RATIO}); momentum_bucket launches {launches} "
        f"({len(buckets)} buckets x {steps} steps); counter {counter}; "
        f"rates at the boundaries {crossings}; "
        f"graph vs interpreter over counters "
        f"{CF_BOUNDARIES[0] - 1}..{CF_BOUNDARIES[0] + 1}: "
        f"{'bitwise equal' if bitwise['equal'] else 'DIFFER'}; last losses "
        f"{lv[-3:].tolist()}")
    if mode != "graph" or captured != 1 or later:
        raise AssertionError(f"the piecewise headline ran {mode} with "
                             f"{captured} captured steps, {later} later")
    if launches != len(buckets) * steps or len(buckets) != CF_HEAD_BUCKETS:
        raise AssertionError(
            f"momentum kernel launched {launches} times over "
            f"{len(buckets)} buckets, expected {CF_HEAD_BUCKETS} buckets x "
            f"{steps} steps")
    if counter != steps - 1:
        raise AssertionError(f"the step counter reads {counter} after "
                             f"{steps} steps")
    np.testing.assert_array_equal(got, want)
    if not bitwise["equal"]:
        raise AssertionError("graph and interpreter differ under "
                             "piecewise_decay")
    if not np.all(np.isfinite(lv)):
        raise AssertionError(f"non-finite loss {lv}")
    if ratio < CF_HEAD_MIN_RATIO:
        raise AssertionError(f"the piecewise headline ran at {ratio:.4f} "
                             f"of the headline, under {CF_HEAD_MIN_RATIO}")
    del feeds
    _release()
    return {"images_per_sec": img_s, "headline_images_per_sec":
            headline_img_s, "ratio": ratio,
            "step_ms": dt / (HEADLINE_K * CF_HEAD_CALLS) * 1e3,
            "momentum_launches": launches, "steps": steps,
            "captured_steps": captured, "later_captures": later,
            "bitwise": bitwise["equal"]}


def _cf_drnn(card_line, lstm_words_s):
    """(c) the gate-by-gate DynamicRNN LSTM at published widths, f32,
    fused Adam: CF_DRNN_STEPS steps on the host and on the card (the
    captured step) from one state, losses within CF_RTOL; the same steps
    through the interpreter on the card, bitwise; CF_DRNN_TIMED more
    replays timed."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert, flags
    from paddle_tpu_torch.fusion import kernels as fk

    from paddle_tpu_torch import fusion

    main, startup, loss = build_drnn_lstm(fluid)
    _, plan = fusion.apply(main, feed_names=["words", "label"],
                           fetch_names=[loss.name])
    n_buckets = sum(b["opt"] == "adam" for b in plan.buckets)
    rs = np.random.RandomState(SEED + 17)
    batches = seq_batches("stacked_lstm", rs, CF_DRNN_STEPS + CF_DRNN_TIMED,
                          CF_DRNN_BATCH, CF_DRNN_LEN)
    total = -(-max(sum(len(s) for s in b["words"]) for b in batches)
              // SEQ_BUCKET) * SEQ_BUCKET
    init_scope = fluid.Scope()
    with fluid.scope_guard(init_scope):
        fluid.Executor(fluid.CUDAPlace(0)).run(startup)
    init = convert.numpy_state(init_scope, main)
    del init_scope
    out = {}
    for name, place, graph in (("host", fluid.CPUPlace(), False),
                               ("interpreter", fluid.CUDAPlace(0), False),
                               ("graph", fluid.CUDAPlace(0), True)):
        feeds, _ = seq_feeds(batches, place, {"words": total})
        scope = fluid.Scope()
        convert.load_numpy_state(scope, main, init, place)
        exe = fluid.Executor(place)
        fk.reset_launch_counts()
        with fluid.scope_guard(scope), flags.flag_guard(
                fuse=True, cuda_graph=graph):
            lv = [float(exe.run(main, feed=f, fetch_list=[loss])[0]
                        .reshape(-1)[0]) for f in feeds[:CF_DRNN_STEPS]]
            out[name] = {"losses": lv, "mode": exe.step_mode(main),
                         "state": convert.numpy_state(scope, main)}
            if graph:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for f in feeds[CF_DRNN_STEPS:]:
                    last = exe.run(main, feed=f, fetch_list=[loss],
                                   return_numpy=False)[0]
                _fence(last)
                out[name]["ms"] = (time.perf_counter() - t0) \
                    / CF_DRNN_TIMED * 1e3
            out[name]["launches"] = fk.adam_bucket.launches
        del exe, scope, feeds
        _release()
    host, interp, graph = out["host"], out["interpreter"], out["graph"]
    rel = max(abs(c / h - 1) for c, h in zip(graph["losses"],
                                             host["losses"]))
    equal = graph["losses"] == interp["losses"] and all(
        np.array_equal(graph["state"][n], v)
        for n, v in interp["state"].items())
    words = np.mean([sum(len(s) for s in b["words"])
                     for b in batches[CF_DRNN_STEPS:]])
    words_s = words / graph["ms"] * 1e3
    log(f"[control_flow] (c) DynamicRNN LSTM (embedding {CF_DRNN_WIDTH}, "
        f"hidden {CF_DRNN_WIDTH}, vocabulary {IMDB_VOCAB}, one layer, f32, "
        f"fused Adam) at batch {CF_DRNN_BATCH}, reviews of "
        f"{CF_DRNN_LEN[0]}-{CF_DRNN_LEN[1] - 1} tokens bucketed to {total} "
        f"(the loop's trip count): {graph['mode']}; losses host "
        f"{host['losses']} card {graph['losses']}, largest relative "
        f"difference {rel:.3e} (rtol {CF_RTOL:g}); graph vs interpreter "
        f"over {CF_DRNN_STEPS} steps: {'bitwise equal' if equal else 'DIFFER'}; "
        f"{graph['ms']:.2f} ms a step over {CF_DRNN_TIMED} replays, "
        f"{words_s:.1f} words/s beside the fused dynamic_lstm's "
        f"{lstm_words_s} (phase stacked_lstm, batch {SEQ_BATCH}); "
        f"adam_bucket_ launches {graph['launches']} ({n_buckets} buckets x "
        f"{CF_DRNN_STEPS + CF_DRNN_TIMED} steps) [{card_line}]")
    np.testing.assert_allclose(graph["losses"], host["losses"],
                               rtol=CF_RTOL)
    if graph["mode"] != "graph" or interp["mode"] != "interpreter":
        raise AssertionError(f"DynamicRNN ran {graph['mode']} / "
                             f"{interp['mode']}")
    if not equal:
        raise AssertionError("DynamicRNN: graph and interpreter differ")
    if graph["launches"] != n_buckets * (CF_DRNN_STEPS + CF_DRNN_TIMED):
        raise AssertionError(f"adam kernel launched {graph['launches']} "
                             f"times, expected {n_buckets} buckets x "
                             f"{CF_DRNN_STEPS + CF_DRNN_TIMED} steps")
    return {"tokens_bucket": total, "losses_host": host["losses"],
            "losses_card": graph["losses"], "max_rel": rel,
            "bitwise": equal, "step_ms": graph["ms"], "words_per_sec":
            words_s, "adam_launches": graph["launches"]}


def _cf_programs(fluid):
    """{name: (main, startup, fetch vars, feed)}: a small program for each
    new op family, built with `fluid`'s layers."""
    L = fluid.layers
    rs = np.random.RandomState(SEED + 18)
    x4 = rs.randn(2, 4).astype(np.float32)
    progs = {}

    def make(name, body, feed):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            fetch = body()
        main.random_seed = startup.random_seed = SEED
        progs[name] = (main, startup, fetch, feed)

    def x_input():
        x = L.data(name="x", shape=[4], dtype="float32")
        x.stop_gradient = False
        return x

    def while_grad():
        x = x_input()
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        n = L.fill_constant(shape=[1], dtype="int64", value=3)
        h = L.fc(input=x, size=4, act="tanh")
        acc = L.fill_constant_batch_size_like(input=h, shape=[-1, 4],
                                              dtype="float32", value=0.0)
        cond = L.less_than(x=i, y=n)
        loop = L.While(cond=cond, max_trip_count=5)
        with loop.block():
            L.assign(L.elementwise_add(acc, L.fc(input=h, size=4,
                                                 act="tanh")), acc)
            L.increment(i, value=1, in_place=True)
            L.less_than(x=i, y=n, cond=cond)
        loss = L.mean(acc)
        return [loss] + fluid.backward.calc_gradient(loss, [x])

    def switch():
        x = x_input()
        c = L.data(name="c", shape=[1], dtype="float32")
        res = L.fill_constant(shape=[2, 4], dtype="float32", value=0.0)
        half = L.fill_constant(shape=[1], dtype="float32", value=0.5)
        first = L.reduce_sum(c)
        with L.Switch() as sw:
            with sw.case(L.less_than(x=first, y=half)):
                L.assign(L.scale(x, scale=2.0), res)
            with sw.default():  # not taken: sqrt of x < 0 is NaN
                L.assign(L.sqrt(x), res)
        loss = L.mean(res)
        return [res] + fluid.backward.calc_gradient(loss, [x])

    def ifelse():
        x = x_input()
        c = L.data(name="c", shape=[1], dtype="float32")
        ie = L.IfElse(L.less_than(x=c, y=L.fill_constant(
            shape=[1], dtype="float32", value=0.5)))
        with ie.true_block():  # sqrt: singular on the false rows' x
            ie.output(L.sqrt(ie.input(x)))
        with ie.false_block():
            ie.output(L.tanh(ie.input(x)))
        out = ie()[0]
        return [out] + fluid.backward.calc_gradient(L.mean(out), [x])

    def static_rnn():
        x = L.data(name="xs", shape=[3, 2, 4], append_batch_size=False,
                   dtype="float32")
        x.stop_gradient = False
        init = L.fill_constant(shape=[2, 4], dtype="float32", value=0.0)
        rnn = L.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            h = rnn.memory(init=init)
            nh = L.fc(input=L.elementwise_add(h, x_t), size=4, act="tanh")
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        out = rnn()
        return [out] + fluid.backward.calc_gradient(L.mean(out), [x])

    def arrays():
        x = x_input()
        i0 = L.fill_constant(shape=[1], dtype="int64", value=0)
        i1 = L.fill_constant(shape=[1], dtype="int64", value=1)
        arr = L.array_write(L.scale(x, scale=2.0), i0)
        L.array_write(L.exp(x), i1, array=arr)
        a, b = L.array_read(arr, i0), L.array_read(arr, i1)
        loss = L.mean(L.sums([a, b]))
        return [a, b, L.array_length(arr)] + fluid.backward.calc_gradient(
            loss, [x])

    def rank_tables():
        seq = L.data(name="seq", shape=[4], dtype="float32", lod_level=1)
        table = L.lod_rank_table(seq)
        arr = L.lod_tensor_to_array(seq, table)
        i1 = L.fill_constant(shape=[1], dtype="int64", value=1)
        return [L.max_sequence_len(table), L.array_read(arr, i1),
                L.shrink_memory(L.array_read(arr, i1), i1, table),
                L.array_to_lod_tensor(arr, table),
                L.reorder_lod_tensor_by_rank(seq, table)]

    def small_ops():
        x = x_input()
        shown = L.Print(L.scale(x, scale=3.0), message="[control_flow] "
                        "(d) print:", summarize=4)
        empty = L.create_tensor(dtype="bool")
        fluid.default_main_program().current_block().append_op(
            "is_empty", {"X": [x]}, {"Out": [empty]})
        return [shown, empty]

    lod = fluid.create_lod_tensor(rs.randn(10, 4).astype(np.float32),
                                  [[2, 3, 1, 4]], fluid.CPUPlace())
    make("while_grad", while_grad, {"x": x4})
    make("switch", switch, {"x": x4, "c": np.array([[0.2], [0.1]],
                                                   np.float32)})
    make("ifelse_mixed_rows", ifelse, {"x": np.array(
        [[-1.0, 0.0, -2.0, -3.0], [1.0, 4.0, 9.0, 2.0]], np.float32),
        "c": np.array([[0.9], [0.1]], np.float32)})
    make("static_rnn", static_rnn,
         {"xs": rs.randn(3, 2, 4).astype(np.float32)})
    make("tensor_arrays", arrays, {"x": x4})
    make("rank_tables", rank_tables, {"seq": lod})
    make("is_empty_print", small_ops, {"x": x4})
    return progs


def _cf_ops():
    """(d) each new op family's small program on the card and on the
    host from one state: fetched values within CF_RTOL of the host
    array's largest magnitude. Returns {program: worst error / scale}."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert

    worst = {}
    for name, (main, startup, fetch, feed) in _cf_programs(fluid).items():
        runs = {}
        init = None
        for place in (fluid.CPUPlace(), fluid.CUDAPlace(0)):
            scope = fluid.Scope()
            if init is None:
                with fluid.scope_guard(scope):
                    fluid.Executor(place).run(startup)
                init = convert.numpy_state(scope, main)
            else:
                convert.load_numpy_state(scope, main, init, place)
            exe = fluid.Executor(place)
            with fluid.scope_guard(scope):
                runs[repr(place)] = (exe.run(main, feed=feed,
                                             fetch_list=fetch),
                                     exe.step_mode(main))
        (host, _), (card, mode) = runs["CPUPlace()"], runs["CUDAPlace(0)"]
        for h, c in zip(host, card):
            h = np.asarray(h.numpy() if hasattr(h, "lod") else h, np.float64)
            c = np.asarray(c.numpy() if hasattr(c, "lod") else c, np.float64)
            if h.shape != c.shape:
                raise AssertionError(f"[control_flow] (d) {name}: card "
                                     f"{c.shape} vs host {h.shape}")
            if not (np.isfinite(h).all() and np.isfinite(c).all()):
                raise AssertionError(f"[control_flow] (d) {name}: a "
                                     f"value is not finite")
            scale = float(np.abs(h).max()) if h.size else 0.0
            err = float(np.abs(c - h).max()) if h.size else 0.0
            if err > CF_RTOL * scale:
                raise AssertionError(f"[control_flow] (d) {name}: card vs "
                                     f"host {err:.3e} over {CF_RTOL:g} of "
                                     f"{scale:.3e}")
            worst[name] = max(worst.get(name, 0.0),
                              err / scale if scale else err)
        log(f"[control_flow] (d) {name}: card ({mode}) vs host, "
            f"{len(host)} fetches, worst error / scale {worst[name]:.3e}")
    return worst


def phase_control_flow(card, card_line, headline_img_s, lstm_words_s):
    """(a) NMT beam decode, (b) the headline under piecewise_decay, (c) the
    DynamicRNN LSTM, (d) the new op families card against host. Prints
    its seconds."""
    t = [time.perf_counter()]
    result = {"nmt_decode": _cf_nmt(card_line)}
    t.append(time.perf_counter())
    result["headline_piecewise"] = _cf_headline(card, headline_img_s)
    t.append(time.perf_counter())
    result["dynamic_rnn_lstm"] = _cf_drnn(card_line, lstm_words_s)
    _release()
    t.append(time.perf_counter())
    result["ops"] = _cf_ops()
    t.append(time.perf_counter())
    parts = dict(zip(("nmt_decode", "headline_piecewise",
                      "dynamic_rnn_lstm", "ops"),
                     (b - a for a, b in zip(t, t[1:]))))
    log(f"[control_flow] phase {t[-1] - t[0]:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()))
    result.update(seconds=t[-1] - t[0], seconds_by_part=parts)
    return result


def _res_headline_func():
    """The Trainer's train_func for the headline: its network, int32
    labels, the mean cross entropy; names fixed by a unique_name guard, so
    every Trainer builds the same vars and a checkpoint restores into
    another."""
    import paddle_tpu_torch as fluid

    with fluid.unique_name.guard():
        prediction = headline_net()
        label = fluid.layers.data(name="label", shape=[1], dtype="int32")
        return fluid.layers.mean(fluid.layers.cross_entropy(
            input=prediction, label=label))


def _res_momentum():
    import paddle_tpu_torch as fluid

    return fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9)


def _res_pool():
    """RES_POOL seeded 224x224x3 uint8 images and their labels."""
    rs = np.random.RandomState(SEED + 23)
    return (rs.randint(0, 256, (RES_POOL, 224, 224, 3), dtype=np.uint8),
            rs.randint(0, 1000, RES_POOL).astype(np.int32))


def _res_pipe(pool):
    """An epoch of RES_DISPATCHES chunks: samples drawn in order from the
    pool (sample i is image i mod RES_POOL), batched and staged on the
    card RES_CHUNK steps a chunk."""
    import paddle_tpu_torch as fluid

    images, labels = pool
    n = RES_DISPATCHES * RES_CHUNK * HEADLINE_BATCH

    def reader():
        for i in range(n):
            j = i % RES_POOL
            yield {"data_u8": images[j], "label": labels[j:j + 1]}

    return (fluid.DataPipe.from_reader(reader).batch(HEADLINE_BATCH)
            .prefetch_to_device(fluid.CUDAPlace(0), chunk=RES_CHUNK))


class _ResEvents:
    """A Trainer's event handler: counts by event type, the host time of
    each EndStepEvent (its loss is read back: the dispatch has finished)
    and the losses."""

    def __init__(self):
        self.counts = {}
        self.ends = []
        self.losses = []

    def __call__(self, event):
        name = type(event).__name__
        self.counts[name] = self.counts.get(name, 0) + 1
        if name == "EndStepEvent":
            self.ends.append(time.perf_counter())
            self.losses.append(np.asarray(event.metrics[0]).reshape(-1))


def _res_state(trainer):
    from paddle_tpu_torch import convert

    return convert.numpy_state(trainer.scope, trainer.train_program)


def _res_diff(a, b):
    """{var: largest |a - b|} over the vars where two states differ."""
    return {n: float(np.abs(a[n].astype(np.float64) - b[n]).max())
            for n in a if not np.array_equal(a[n], b[n])}


def _res_train(pool, cfg=None, faults=(), hook=None):
    """One Trainer over the headline, trained RES_EPOCHS epochs under `cfg`
    (a ResilienceConfig or None) with the chaos `faults` installed:
    (trainer, events, Preempted or None). `hook(trainer)` runs before
    train()."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, flags
    from paddle_tpu_torch.resilience import Preempted, chaos

    events = _ResEvents()
    pipe = _res_pipe(pool)
    preempted = None
    amp.enable("bfloat16")
    try:
        with flags.flag_guard(fuse=True):
            if faults:
                chaos.install(chaos.ChaosMonkey(list(faults)))
            # as in a fresh process: the optimizer's vars (velocities, the
            # learning rate) take the names of every other run's, so a
            # checkpoint restores into them
            fluid.unique_name.switch()
            trainer = fluid.Trainer(
                train_func=_res_headline_func, optimizer_func=_res_momentum,
                place=fluid.CUDAPlace(0), resilience_config=cfg)
            if hook is not None:
                hook(trainer)
            try:
                trainer.train(num_epochs=RES_EPOCHS, event_handler=events,
                              reader=pipe)
            except Preempted as e:
                preempted = e
    finally:
        chaos.uninstall()
        amp.disable()
        pipe.close()
    torch.cuda.synchronize()
    return trainer, events, preempted


def _res_img_s(events):
    """img/s over the dispatches after the first (which holds the eager
    step and the capture)."""
    ends = events.ends
    return (len(ends) - 1) * RES_CHUNK * HEADLINE_BATCH / (ends[-1] - ends[0])


def _res_bound(want, got, tol, what):
    """Hold a state to the uninterrupted run's: bitwise when `tol` is None
    (the uninterrupted run repeats bitwise), else within `tol`, the largest
    difference between two uninterrupted runs."""
    diff = _res_diff(want, got)
    worst = max(diff.values(), default=0.0)
    if tol is None and diff:
        raise AssertionError(
            f"{what}: {len(diff)} vars differ from the uninterrupted run "
            f"(largest {sorted(diff.items(), key=lambda kv: -kv[1])[:3]})")
    if tol is not None and worst > tol:
        raise AssertionError(f"{what}: largest difference {worst} over the "
                             f"uninterrupted runs' {tol}")
    return {"vars_differ": len(diff), "max_abs_diff": worst}


def _res_trainer(card, headline_img_s, workdir):
    """(a)-(e): the headline under fluid.Trainer, plain, checkpointed, and
    under each fault."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.fusion import kernels as fk
    from paddle_tpu_torch.resilience import ResilienceConfig, chaos, \
        inspect_dir

    pool = _res_pool()
    steps = RES_EPOCHS * RES_DISPATCHES * RES_CHUNK
    out = {}
    # (a) plain
    fk.reset_launch_counts()
    trainer, events, _ = _res_train(pool)
    launches_a = fk.momentum_bucket.launches
    state_a = _res_state(trainer)
    img_a = _res_img_s(events)
    out["trainer_headline"] = {
        "images_per_sec": img_a, "ratio": img_a / headline_img_s,
        "events": dict(events.counts), "momentum_launches": launches_a,
        "steps": steps}
    log(f"[resilience] (a) {card}: fluid.Trainer over the headline, bf16 "
        f"AMP, fused Momentum, DataPipe batch {HEADLINE_BATCH} chunk "
        f"{RES_CHUNK}, {RES_EPOCHS} epochs of {RES_DISPATCHES} dispatches: "
        f"{img_a:.2f} img/s over dispatches 2-{len(events.ends)}, "
        f"{img_a / headline_img_s:.4f} of the headline's "
        f"{headline_img_s:.2f}; events {events.counts}; momentum_bucket "
        f"launches {launches_a} ({CF_HEAD_BUCKETS} buckets x {steps} "
        f"steps); last losses {np.concatenate(events.losses)[-3:].tolist()}")
    del trainer
    _release()
    # (b) checkpointed, async writes
    ckdir = os.path.join(workdir, "b")
    cfg = ResilienceConfig(checkpoint_dir=ckdir,
                           checkpoint_interval=RES_INTERVAL)
    saves = []

    def timed_saves(trainer):
        mgr = trainer._resilience.checkpoint
        save = mgr.save

        def save_timed(*args, **kwargs):
            t0 = time.perf_counter()
            serial = save(*args, **kwargs)
            saves.append((time.perf_counter() - t0, mgr))
            return serial

        mgr.save = save_timed

    fk.reset_launch_counts()
    trainer, events, _ = _res_train(pool, cfg, hook=timed_saves)
    launches_b = fk.momentum_bucket.launches
    state_b = _res_state(trainer)
    img_b = _res_img_s(events)
    gap_ms = [mgr.last_gap_ms() for _, mgr in saves[-1:]]
    host_ms = [s * 1e3 for s, _ in saves]
    write_ms = monitor.registry().gauge("checkpoint_write_ms").value
    report = inspect_dir(ckdir)
    statuses = [e["status"] for e in report["serials"]]
    ck_bytes = [e["bytes"] for e in report["serials"]]
    del trainer, saves
    _release()
    diff_ab = _res_diff(state_a, state_b)
    tol = max(diff_ab.values()) if diff_ab else None
    out["trainer_checkpointed"] = {
        "images_per_sec": img_b, "ratio_to_a": img_b / img_a,
        "save_gap_ms": gap_ms, "save_host_ms": host_ms,
        "write_s": write_ms / 1e3, "checkpoint_bytes": ck_bytes,
        "statuses": statuses, "momentum_launches": launches_b,
        "a_vs_b_vars_differ": len(diff_ab),
        "a_vs_b_max_abs_diff": tol or 0.0}
    log(f"[resilience] (b) the same under ResilienceConfig("
        f"checkpoint_interval={RES_INTERVAL}), async writes: {img_b:.2f} "
        f"img/s, {img_b / img_a:.4f} of (a); a save's snapshot copies "
        f"{gap_ms} ms on the card (CUDA events), save() {host_ms} ms on "
        f"the host; the writer {write_ms / 1e3:.3f} s a checkpoint of "
        f"{ck_bytes} bytes; inspect_dir {statuses}; momentum launches "
        f"{launches_b}; (a) vs (b): "
        + ("bitwise equal" if not diff_ab else
           f"{len(diff_ab)} vars differ, largest "
           f"{sorted(diff_ab.items(), key=lambda kv: -kv[1])[:5]}"))
    if launches_a != CF_HEAD_BUCKETS * steps \
            or launches_b != CF_HEAD_BUCKETS * steps:
        raise AssertionError(f"momentum launched {launches_a} / "
                             f"{launches_b} times, expected "
                             f"{CF_HEAD_BUCKETS} x {steps}")
    want_events = {"BeginEpochEvent": RES_EPOCHS,
                   "EndEpochEvent": RES_EPOCHS,
                   "BeginStepEvent": RES_EPOCHS * RES_DISPATCHES,
                   "EndStepEvent": RES_EPOCHS * RES_DISPATCHES}
    if out["trainer_headline"]["events"] != want_events:
        raise AssertionError(f"events {events.counts} != {want_events}")
    if not statuses or set(statuses) != {"committed"}:
        raise AssertionError(f"checkpoint statuses {statuses}")
    # (c) kill after dispatch RES_KILL_AT, restore in a fresh Trainer
    ckdir = os.path.join(workdir, "c")
    cfg = ResilienceConfig(checkpoint_dir=ckdir,
                           checkpoint_interval=RES_FAULT_INTERVAL)
    trainer, events, pre = _res_train(
        pool, cfg, faults=[chaos.Fault("sigterm", at=RES_KILL_AT)])
    killed_at = len(events.ends)
    del trainer
    _release()
    if pre is None or pre.checkpoint_serial is None:
        raise AssertionError(f"the sigterm run ended with {pre!r}")
    marks = {}

    def timed_restore(trainer):
        runner = trainer._resilience
        restore = runner.restore

        def restore_timed(*args, **kwargs):
            marks["restore"] = time.perf_counter()
            return restore(*args, **kwargs)

        runner.restore = restore_timed

    cfg = ResilienceConfig(checkpoint_dir=ckdir,
                           checkpoint_interval=RES_FAULT_INTERVAL)
    trainer, events, _ = _res_train(pool, cfg, hook=timed_restore)
    ttr = events.ends[0] - marks["restore"]
    resumed = len(events.ends)
    check_c = _res_bound(state_a, _res_state(trainer), tol, "(c) restored")
    del trainer
    _release()
    out["kill_restore"] = {"killed_after": killed_at,
                           "serial": pre.checkpoint_serial,
                           "resumed_dispatches": resumed,
                           "time_to_recover_s": ttr, **check_c}
    log(f"[resilience] (c) chaos sigterm after dispatch {RES_KILL_AT}: "
        f"Preempted after {killed_at} dispatches, grace save serial "
        f"{pre.checkpoint_serial}; a fresh Trainer restored and ran "
        f"{resumed} dispatches; time to recover {ttr:.3f} s (restore to "
        f"its first completed dispatch, capture included); against (a): "
        f"{check_c}")
    # (d) nan at dispatch RES_NAN_AT under nan_policy=restore
    cfg = ResilienceConfig(checkpoint_dir=os.path.join(workdir, "d"),
                           checkpoint_interval=RES_FAULT_INTERVAL,
                           nan_policy="restore")
    trainer, events, _ = _res_train(
        pool, cfg, faults=[chaos.Fault("nan", at=RES_NAN_AT)])
    mode = trainer._resilience.executor.step_mode(trainer.train_program)
    rolled = len(events.ends)
    check_d = _res_bound(state_a, _res_state(trainer), tol, "(d) nan")
    del trainer
    _release()
    if mode != "graph":
        raise AssertionError(f"(d) ran {mode}")
    out["nan_restore"] = {"dispatches": rolled, "mode": mode, **check_d}
    log(f"[resilience] (d) chaos nan at dispatch {RES_NAN_AT}, "
        f"nan_policy=restore: rolled back to the checkpoint of dispatch "
        f"{RES_NAN_AT // RES_FAULT_INTERVAL * RES_FAULT_INTERVAL} in the "
        f"same Trainer ({mode}), {rolled} dispatches in all; against (a): "
        f"{check_d}")
    # (e) transient at run call RES_TRANSIENT_AT, twice
    from paddle_tpu_torch.resilience import RetryPolicy

    cfg = ResilienceConfig(checkpoint_dir=os.path.join(workdir, "e"),
                           checkpoint_interval=RES_FAULT_INTERVAL,
                           retry=RetryPolicy(max_attempts=4,
                                             base_delay_ms=1))
    before = monitor.registry().counter("resilience_retries_total",
                                        kind="executor").value
    trainer, events, _ = _res_train(
        pool, cfg, faults=[chaos.Fault("transient", at=RES_TRANSIENT_AT,
                                       times=2)])
    retries = monitor.registry().counter("resilience_retries_total",
                                         kind="executor").value - before
    check_e = _res_bound(state_a, _res_state(trainer), tol, "(e) transient")
    del trainer
    _release()
    if retries != 2:
        raise AssertionError(f"(e) retried {retries} times, expected 2")
    out["transient_retry"] = {"retries": retries, **check_e}
    log(f"[resilience] (e) chaos transient at run call "
        f"{RES_TRANSIENT_AT}, twice: {retries} retries; against (a): "
        f"{check_e}")
    return out, tol


def _res_mlp_func():
    """The README MLP with a dropout after its hidden layer."""
    import paddle_tpu_torch as fluid

    with fluid.unique_name.guard():
        img = fluid.layers.data(name="img", shape=[784], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        hidden = fluid.layers.fc(input=img, size=200, act="relu")
        hidden = fluid.layers.dropout(hidden, dropout_prob=0.5)
        probs = fluid.layers.fc(input=hidden, size=10, act="softmax")
        return fluid.layers.mean(
            fluid.layers.cross_entropy(input=probs, label=label))


def _res_mlp(workdir):
    """(f) the MLP with dropout under fused Adam on its captured step:
    uninterrupted, then killed after dispatch RES_MLP_KILL and restored;
    bitwise."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import flags, fusion
    from paddle_tpu_torch.fusion import kernels as fk
    from paddle_tpu_torch.resilience import Preempted, ResilienceConfig, \
        chaos

    rs = np.random.RandomState(SEED + 29)
    n = RES_MLP_DISPATCHES * RES_MLP_CHUNK * RES_MLP_BATCH
    x = rs.rand(n, 784).astype(np.float32)
    y = (x @ rs.randn(784, 10)).argmax(1).astype(np.int64)[:, None]

    def pipe():
        def reader():
            for i in range(n):
                yield {"img": x[i], "label": y[i]}
        return (fluid.DataPipe.from_reader(reader).batch(RES_MLP_BATCH)
                .prefetch_to_device(fluid.CUDAPlace(0), chunk=RES_MLP_CHUNK))

    def run(cfg, faults=()):
        p = pipe()
        try:
            with flags.flag_guard(fuse=True):
                if faults:
                    chaos.install(chaos.ChaosMonkey(list(faults)))
                fluid.unique_name.switch()
                t = fluid.Trainer(
                    train_func=_res_mlp_func,
                    optimizer_func=lambda: fluid.optimizer.Adam(1e-3),
                    place=fluid.CUDAPlace(0), resilience_config=cfg)
                events = _ResEvents()
                try:
                    t.train(num_epochs=RES_EPOCHS, event_handler=events,
                            reader=p)
                except Preempted:
                    pass
        finally:
            chaos.uninstall()
            p.close()
        return t, events

    fk.reset_launch_counts()
    t, events = run(None)
    launches = fk.adam_bucket.launches
    main = t.train_program
    _, plan = fusion.apply(main, feed_names=["img", "label"],
                           fetch_names=[t.train_func_outputs[0].name])
    buckets = [b for b in plan.buckets if b["opt"] == "adam"]
    want = _res_state(t)
    losses = np.concatenate(events.losses)
    del t
    ckdir = os.path.join(workdir, "f")
    cfg = ResilienceConfig(checkpoint_dir=ckdir, checkpoint_interval=2)
    t, events = run(cfg, [chaos.Fault("sigterm", at=RES_MLP_KILL)])
    killed = len(events.ends)
    del t
    t, events = run(ResilienceConfig(checkpoint_dir=ckdir,
                                     checkpoint_interval=2))
    mode = t._resilience.executor.step_mode(t.train_program)
    got = _res_state(t)
    del t
    _release()
    steps = RES_EPOCHS * RES_MLP_DISPATCHES * RES_MLP_CHUNK
    diff = _res_diff(want, got)
    log(f"[resilience] (f) the README MLP + dropout(0.5), fused Adam, "
        f"batch {RES_MLP_BATCH}, chunk {RES_MLP_CHUNK}: {mode}; killed "
        f"after {killed} dispatches, restored: "
        + ("bitwise equal to the uninterrupted run" if not diff else
           f"{len(diff)} vars DIFFER {diff}")
        + f"; adam launches {launches} ({len(buckets)} buckets x {steps} "
        f"steps); last losses {losses[-3:].tolist()}")
    if mode != "graph":
        raise AssertionError(f"(f) ran {mode}")
    if diff:
        raise AssertionError(f"(f) the restored dropout run differs: {diff}")
    if launches != len(buckets) * steps:
        raise AssertionError(f"adam launched {launches} times, expected "
                             f"{len(buckets)} x {steps}")
    return {"adam_launches": launches, "steps": steps,
            "buckets": len(buckets), "killed_after": killed,
            "bitwise": not diff}


def _res_async(headline_img_s, tol):
    """(g) the headline with async_fetch, the result of call i read after
    call i + 1 is enqueued, against a synchronous run of the same calls
    from the same state on the same Executor and graph."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, convert, flags

    main, startup, loss, _ = build_headline()
    rs = np.random.RandomState(SEED + 31)
    feeds = [{"data_u8": torch.from_numpy(rs.randint(
        0, 256, (RES_CHUNK, HEADLINE_BATCH, 224, 224, 3),
        dtype=np.uint8)).cuda(),
        "label": torch.from_numpy(rs.randint(
            0, 1000, (RES_CHUNK, HEADLINE_BATCH, 1)).astype(
                np.int32)).cuda()} for _ in range(RES_ASYNC_CALLS)]
    place = fluid.CUDAPlace(0)
    amp.enable("bfloat16")
    try:
        with flags.flag_guard(fuse=True):
            scope = fluid.Scope()
            with fluid.scope_guard(scope):
                fluid.Executor(place).run(startup)
            init = convert.numpy_state(scope, main)
            exe = fluid.Executor()
            with fluid.scope_guard(scope):
                # warm: the eager step and the capture
                exe.run(main, feed=feeds[0], fetch_list=[loss],
                        iters=RES_CHUNK)
                convert.load_numpy_state(scope, main, init, place)
                sync = [exe.run(main, feed=f, fetch_list=[loss],
                                iters=RES_CHUNK)[0] for f in feeds]
                convert.load_numpy_state(scope, main, init, place)
                torch.cuda.synchronize()
                got, prev = [], None
                t0 = time.perf_counter()
                for f in feeds:
                    futs = exe.run(main, feed=f, fetch_list=[loss],
                                   iters=RES_CHUNK, async_fetch=True)
                    if prev is not None:
                        got.append(prev[0].result())
                    prev = futs
                got.append(prev[0].result())
                dt = time.perf_counter() - t0
                mode = exe.step_mode(main)
            del exe, scope
    finally:
        amp.disable()
    _release()
    img_s = RES_ASYNC_CALLS * RES_CHUNK * HEADLINE_BATCH / dt
    worst = max(float(np.abs(g.astype(np.float64) - s).max())
                for g, s in zip(got, sync))
    equal = all(np.array_equal(g, s) for g, s in zip(got, sync))
    log(f"[resilience] (g) the headline with async_fetch, fenced one call "
        f"behind ({mode}, {RES_ASYNC_CALLS} calls of iters={RES_CHUNK}): "
        f"{img_s:.2f} img/s, {img_s / headline_img_s:.4f} of the "
        f"headline; losses against the synchronous run's: "
        + ("bitwise equal" if equal else f"largest difference {worst}"))
    if mode != "graph":
        raise AssertionError(f"(g) ran {mode}")
    if (tol is None and not equal) or (tol is not None and worst > tol):
        raise AssertionError(f"(g) async fetches differ by {worst}")
    return {"images_per_sec": img_s, "ratio": img_s / headline_img_s,
            "bitwise": equal, "max_abs_diff": worst}


def _res_tiny(fluid, with_log=False):
    """A small fc regression trained by SGD (x of 3 features), or log(x)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[3], dtype="float32")
        if with_log:
            out = fluid.layers.log(x)
        else:
            h = fluid.layers.fc(input=x, size=2)
            out = fluid.layers.sums([
                fluid.layers.mean(fluid.layers.log(x)),
                fluid.layers.mean(h)])
            fluid.optimizer.SGD(learning_rate=0.1).minimize(out)
    return main, startup, out


def _res_debug_nans():
    """(h) FLAGS_debug_nans on the card."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import flags

    main, startup, y = _res_tiny(fluid, with_log=True)
    exe = fluid.Executor()
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        bad = np.array([[-1.0, 2.0, 3.0]], np.float32)
        try:
            with flags.flag_guard(debug_nans=True):
                exe.run(main, feed={"x": bad}, fetch_list=[y])
            raise AssertionError("log(-1) ran under FLAGS_debug_nans")
        except FloatingPointError as e:
            msg = str(e)
        if "'log'" not in msg:
            raise AssertionError(f"the trap does not name log: {msg}")
    main, startup, y = _res_tiny(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor()
    good = np.abs(np.random.RandomState(SEED).randn(4, 3)).astype(
        np.float32) + 5
    with fluid.scope_guard(scope):
        exe.run(startup)
        params = [p.name for p in main.global_block().all_parameters()]
        before = {p: fluid.fetch_var(p) for p in params}
        try:
            with flags.flag_guard(debug_nans=True):
                exe.run(main, feed={"x": -np.ones((4, 3), np.float32)},
                        fetch_list=[y])
            raise AssertionError("the trap did not fire")
        except FloatingPointError:
            pass
        kept = all(np.array_equal(fluid.fetch_var(p), before[p])
                   for p in params)
        with flags.flag_guard(debug_nans=True):
            trapped_mode = (exe.run(main, feed={"x": good},
                                    fetch_list=[y]),
                            exe.step_mode(main))[1]
        outs = [exe.run(main, feed={"x": good}, fetch_list=[y])[0]
                for _ in range(3)]
        mode = exe.step_mode(main)
        captured = len(exe.captured_steps(main, scope))
    log(f"[resilience] (h) FLAGS_debug_nans: log(-1) raised "
        f"FloatingPointError: {msg}; the training scope kept its params "
        f"{kept} and trained on ({trapped_mode} under the flag); flag off: "
        f"{mode}, {captured} CapturedStep, losses "
        f"{[float(o.reshape(-1)[0]) for o in outs]}")
    if not kept or trapped_mode != "interpreter" or mode != "graph" \
            or captured != 1 \
            or not all(np.isfinite(o).all() for o in outs):
        raise AssertionError("(h) debug_nans: the scope or the graph did "
                             "not come back")
    return {"message": msg, "mode_after": mode}


def _res_watchdog(workdir):
    """(i) FLAGS_step_deadline_ms: a warm run inside the deadline writes no
    dump; the same run held by a chaos delay past it writes one."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.resilience import chaos, watchdog

    main, startup, y = _res_tiny(fluid, with_log=True)
    dump_dir = os.path.join(workdir, "hang")
    exe = fluid.Executor()
    feed = {"x": np.ones((2, 3), np.float32)}
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        exe.run(main, feed=feed, fetch_list=[y])
        watchdog.reset()
        with flags.flag_guard(step_deadline_ms=300, hang_dump_dir=dump_dir):
            exe.run(main, feed=feed, fetch_list=[y])
            quiet = os.listdir(dump_dir) if os.path.isdir(dump_dir) else []
            chaos.install(chaos.ChaosMonkey([chaos.Fault(
                "delay", at=0, delay_ms=1000.0)]))
            try:
                exe.run(main, feed=feed, fetch_list=[y])
            finally:
                chaos.uninstall()
    dumps = sorted(os.listdir(dump_dir)) if os.path.isdir(dump_dir) else []
    log(f"[resilience] (i) FLAGS_step_deadline_ms=300: a warm run, dumps "
        f"{quiet}; with a chaos delay of 1000 ms, dumps {dumps}")
    if quiet or not any(d.startswith("hang_executor_") for d in dumps):
        raise AssertionError(f"hang dumps {quiet} / {dumps}")
    return {"dumps": dumps}


def phase_resilience(card, headline_img_s):
    """(a)-(i) of the module docstring. Prints its seconds."""
    import tempfile

    # checkpoints of ~205 MB each: kept out of OUT_DIR, which comes back
    workdir = tempfile.mkdtemp(prefix="chip_smoke_resilience_")
    t = [time.perf_counter()]
    try:
        result, tol = _res_trainer(card, headline_img_s, workdir)
        t.append(time.perf_counter())
        result["trainer_mlp_dropout"] = _res_mlp(workdir)
        t.append(time.perf_counter())
        result["async_fetch"] = _res_async(headline_img_s, tol)
        t.append(time.perf_counter())
        result["debug_nans"] = _res_debug_nans()
        result["watchdog"] = _res_watchdog(workdir)
        t.append(time.perf_counter())
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    parts = dict(zip(("trainer", "mlp_dropout", "async_fetch", "flags"),
                     (b - a for a, b in zip(t, t[1:]))))
    log(f"[resilience] phase {t[-1] - t[0]:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()))
    result.update(seconds=t[-1] - t[0], seconds_by_part=parts)
    return result


def _cs_feeds(seed, steps, batch):
    """A seeded headline feed stack on the card: [steps, batch, ...]."""
    rs = np.random.RandomState(seed)
    return {"data_u8": torch.from_numpy(rs.randint(
                0, 256, (steps, batch, 224, 224, 3), dtype=np.uint8)).cuda(),
            "label": torch.from_numpy(rs.randint(
                0, 1000, (steps, batch, 1)).astype(np.int32)).cuda()}


def _cs_prepared(exe, program):
    """The (program to run, FusionPlan, step) `exe` prepared for
    `program` (the one key of it in the compile cache)."""
    (entry,) = [v for k, v in exe._prepared.items() if k[0] == id(program)]
    return entry


def _cs_verify(card, headline_img_s):
    """(a) the headline under FLAGS_verify=full, CS_WARM + CS_CALLS calls
    of iters=HEADLINE_K through the captured step, and a program broken on
    purpose refused before any launch; (b) the peak-HBM estimate beside
    the card's max_memory_allocated over one replayed and one interpreted
    step, and the state's measured live bytes within 2x of the
    estimate's state bytes."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, analysis, flags
    from paddle_tpu_torch.core import executor_core
    from paddle_tpu_torch.fusion import kernels as fk

    main, startup, loss, _ = build_headline()
    feeds = _cs_feeds(SEED + 17, HEADLINE_K, HEADLINE_BATCH)
    one = {n: t[0] for n, t in feeds.items()}
    out = {}
    analysis.reset()
    amp.enable("bfloat16")
    scope = fluid.Scope()
    try:
        with flags.flag_guard(fuse=True, verify="full"), \
                fluid.scope_guard(scope):
            exe = fluid.Executor()
            exe.run(startup)
            torch.cuda.synchronize()
            fk.reset_launch_counts()
            dt, outs = _timed_calls(exe, main, feeds, [loss], HEADLINE_K,
                                    CS_WARM, CS_CALLS)
            launches = fk.momentum_bucket.launches
            if launches != CF_HEAD_BUCKETS * HEADLINE_K * (CS_WARM
                                                           + CS_CALLS):
                raise AssertionError(f"[compile_services] momentum launched "
                                     f"{launches} times")
            if exe.step_mode(main) != "graph":
                raise AssertionError("the verified headline left the graph")
            split = dict(exe.last_prepare)
            run_prog, plan, _ = _cs_prepared(exe, main)
            report = analysis.ensure_verified(
                run_prog, feed_names=list(feeds), fetch_names=[loss.name])
            if not report.ok or report.level != "full":
                raise AssertionError(report.render())
            img_s = HEADLINE_BATCH * HEADLINE_K * CS_CALLS / dt
            out["verify"] = {
                "images_per_sec": img_s,
                "ratio_to_headline": img_s / headline_img_s,
                "verify_s": split["verify"], "prepare_s": split,
                "errors": 0, "warnings": len(report.warnings()),
                "warning_codes": sorted({d.code for d in report.warnings()}),
                "ops_verified": report.summary["n_ops"],
                "momentum_launches": launches,
                "loss_finite": bool(np.isfinite(_losses(outs[0])).all())}
            log(f"[compile_services] (a) headline under FLAGS_verify=full "
                f"{card}: {img_s:.2f} img/s, {img_s / headline_img_s:.4f} "
                f"of the same run's headline ({headline_img_s:.2f}); verify "
                f"{split['verify']:.4f} s of host time on the miss "
                f"({report.summary['n_ops']} ops; 0 errors, "
                f"{len(report.warnings())} warnings "
                f"{out['verify']['warning_codes']}); prepare split "
                + ", ".join(f"{k} {v:.4f} s" for k, v in split.items()
                            if k != "level")
                + f"; momentum launches {launches}")

            # a producer deleted: PTA001 at the prepare, nothing launched
            broken = main.clone()
            ops = broken.global_block().ops
            del ops[next(i for i, op in enumerate(ops)
                         if op.type == "conv2d")]
            broken._mutation += 1
            calls = [0]
            run_ops = executor_core.run_ops

            def counted(*args, **kwargs):
                calls[0] += 1
                return run_ops(*args, **kwargs)

            executor_core.run_ops = counted
            before = fk.momentum_bucket.launches
            try:
                exe.run(broken, feed=one, fetch_list=[loss])
                raise AssertionError("the broken program ran")
            except analysis.ProgramVerificationError as e:
                codes = sorted(e.report.codes())
            finally:
                executor_core.run_ops = run_ops
            if "PTA001" not in codes or calls[0] or \
                    fk.momentum_bucket.launches != before or \
                    exe.captured_steps(broken):
                raise AssertionError(f"broken program: codes {codes}, "
                                     f"{calls[0]} op runs")
            out["broken"] = {"codes": codes, "op_runs": calls[0]}
            log(f"[compile_services] (a) a conv2d deleted: "
                f"ProgramVerificationError {codes} at the prepare, no op "
                f"run, no kernel launched")

            # (b) the estimate beside the card's own numbers
            est = analysis.estimate_peak_hbm(
                run_prog, fetch_names=[loss.name],
                nominal_batch=HEADLINE_BATCH)
            peaks, reserved = {}, {}
            for mode, graph in (("graph", True), ("interpreter", False)):
                with flags.flag_guard(cuda_graph=graph):
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    _fence(exe.run(main, feed=one, fetch_list=[loss],
                                   return_numpy=False)[0])
                    peaks[mode] = torch.cuda.max_memory_allocated()
                    reserved[mode] = torch.cuda.max_memory_reserved()
            state_in, _ = executor_core.collect_state_names(run_prog, scope)
            live = analysis.measured_live_bytes(
                [scope.find_var(n) for n in state_in])
            state_est = est["param_bytes"] + est["optimizer_state_bytes"]
            if not state_est / 2 <= live <= 2 * state_est:
                raise AssertionError(f"measured state {live} B is not within "
                                     f"2x of the estimate's {state_est} B")
            out["hbm"] = {
                "estimate_peak_bytes": est["peak_bytes_per_replica"],
                "estimate_at_batch_1": report.hbm["peak_bytes_per_replica"],
                "estimate_state_bytes": state_est,
                "estimate_transient_bytes": est["peak_transient_bytes"],
                "estimate_peak_op": est["peak_op_type"],
                "max_allocated_graph_step": peaks["graph"],
                "max_allocated_interpreter_step": peaks["interpreter"],
                "max_reserved_graph_step": reserved["graph"],
                "max_reserved_interpreter_step": reserved["interpreter"],
                "measured_state_bytes": live,
                "state_ratio": live / state_est,
                "peak_ratio_graph": peaks["graph"]
                / est["peak_bytes_per_replica"],
                "peak_ratio_interpreter": peaks["interpreter"]
                / est["peak_bytes_per_replica"]}
            log(f"[compile_services] (b) peak-HBM estimate at batch "
                f"{HEADLINE_BATCH}: {est['peak_bytes_per_replica']} B "
                f"({est['peak_bytes_per_replica'] / 2**30:.3f} GiB; state "
                f"{state_est} B, transients {est['peak_transient_bytes']} B "
                f"at {est['peak_op_type']}; the gauge's, at nominal batch 1: "
                f"{report.hbm['peak_bytes_per_replica']} B); "
                f"max_memory_allocated over one replayed step "
                f"{peaks['graph']} B ({peaks['graph'] / 2**30:.3f} GiB, "
                f"{out['hbm']['peak_ratio_graph']:.3f} of the estimate), "
                f"one interpreted step {peaks['interpreter']} B "
                f"({out['hbm']['peak_ratio_interpreter']:.3f}; a captured "
                f"step's working set lives in its graph's private pool, "
                f"which max_memory_allocated does not count: "
                f"max_memory_reserved {reserved['graph']} / "
                f"{reserved['interpreter']} B); the state's "
                f"measured live bytes {live} = "
                f"{out['hbm']['state_ratio']:.4f} of the estimate's")
            _check_master_state(scope)
    finally:
        amp.disable()
    return out


def _cs_cap(card):
    """(c) the headline network's for_test clone at batches 8, 16, 32, then
    8 again under FLAGS_compile_cache_cap=2 (f32, cuDNN deterministic):
    the evictions counted, the recaptured batch-8 outputs bitwise equal to
    the first, the bytes each evicted graph freed (memory_reserved after
    empty_cache, before and after the eviction), and the card's reserved
    memory after the run below an uncapped executor's with the three
    graphs alive."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import flags

    main, startup, _, _, prediction = build_headline(with_prediction=True)
    test_prog = main.clone(for_test=True)
    rs = np.random.RandomState(SEED + 18)
    feeds = {b: torch.from_numpy(rs.randint(
        0, 256, (b, 224, 224, 3), dtype=np.uint8)).cuda()
        for b in CS_CAP_BATCHES}

    def run(exe, b):
        # eager warm-up step, capture, one replay
        return [exe.run(test_prog, feed={"data_u8": feeds[b]},
                        fetch_list=[prediction], return_numpy=False)[0]
                for _ in range(3)][-1].clone()

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with fluid.scope_guard(fluid.Scope()):
            fluid.Executor().run(startup)
            free = fluid.Executor()
            for b in CS_CAP_BATCHES:
                run(free, b)
            if len(free.captured_steps(test_prog)) != 3:
                raise AssertionError("the uncapped executor holds "
                                     f"{len(free.captured_steps(test_prog))}"
                                     " graphs")
            _release()
            three = torch.cuda.memory_reserved()
            del free
            _release()
            base = torch.cuda.memory_reserved()
            freed = []
            with flags.flag_guard(compile_cache_cap=2):
                exe = fluid.Executor()
                evict = exe._prepared.on_evict

                def measured(key, entry):
                    _release()
                    before = torch.cuda.memory_reserved()
                    evict(key, entry)
                    _release()
                    freed.append(before - torch.cuda.memory_reserved())

                exe._prepared.on_evict = measured
                first = run(exe, CS_CAP_BATCHES[0])
                for b in CS_CAP_BATCHES[1:]:
                    run(exe, b)
                again = run(exe, CS_CAP_BATCHES[0])
                info = exe.compile_cache_info()
                alive = len(exe.captured_steps(test_prog))
            _release()
            after = torch.cuda.memory_reserved()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if info["evictions"] != 2 or alive != 2 or len(freed) != 2:
        raise AssertionError(f"cap 2: {info['evictions']} evictions, "
                             f"{alive} graphs alive")
    if not torch.equal(again, first):
        raise AssertionError("the recaptured batch-8 outputs differ")
    if not after < three or min(freed) <= 0:
        raise AssertionError(f"reserved {after} B after eviction, {three} B "
                             f"with three graphs alive; freed {freed}")
    out = {"batches": list(CS_CAP_BATCHES) + [CS_CAP_BATCHES[0]],
           "evictions": info["evictions"], "entries": info["entries"],
           "freed_bytes": freed, "reserved_three_graphs": three,
           "reserved_after_evictions": after, "reserved_no_graphs": base,
           "recapture_bitwise": True}
    log(f"[compile_services] (c) cap 2 over batches {out['batches']} "
        f"{card}: {info['evictions']} evictions, the graphs of batches "
        f"{CS_CAP_BATCHES[0]} and {CS_CAP_BATCHES[1]} freed "
        f"{freed[0]} / {freed[1]} B reserved; reserved {after} B after "
        f"(two graphs alive) < {three} B with three (uncapped), {base} B "
        f"with none; the recaptured batch-{CS_CAP_BATCHES[0]} outputs "
        f"bitwise equal to the first")
    return out


def l2_child(root, go):
    """`python3 chip_smoke.py --l2-child DIR GO`: one fresh process of
    phase compile_services (d): the kernels' extension loaded and the
    headline program (bf16 AMP, fused Momentum, batch HEADLINE_BATCH)
    built; then, once the file GO exists, under FLAGS_verify=full, cuDNN
    deterministic and FLAGS_compile_cache_dir=DIR, its startup and two
    steps (the eager first step, the capture); prints one JSON line: the
    losses (hex), the compile cache's payload, the prepare's host split,
    the monitor's misses, the momentum launches and the extension's load
    seconds."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, flags, monitor
    from paddle_tpu_torch.fusion import kernels as fk

    from paddle_tpu_torch import cuda_build

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    # the kernels' extension (built by the parent) loaded here, so that
    # the first eager step's time is the step's own
    cuda_build.kernels()
    kernel_load = time.perf_counter() - t0
    main, startup, loss, _ = build_headline(plan=False)
    one = {n: t[0] for n, t in _cs_feeds(SEED + 19, 1,
                                         HEADLINE_BATCH).items()}
    deadline = time.monotonic() + CS_CHILD_S
    while not os.path.exists(go):
        if time.monotonic() > deadline:
            sys.exit(f"l2 child: no {go} within {CS_CHILD_S} s")
        time.sleep(0.02)
    t0 = time.perf_counter()
    amp.enable("bfloat16")
    with flags.flag_guard(fuse=True, verify="full", monitor=True,
                          compile_cache_dir=root):
        exe = fluid.Executor()
        exe.run(startup)
        monitor.reset()
        fk.reset_launch_counts()
        losses = [float(exe.run(main, feed=one, fetch_list=[loss],
                                return_numpy=False)[0].reshape(-1)[0])
                  for _ in range(2)]
        torch.cuda.synchronize()
        snap = monitor.registry().snapshot()
        print(json.dumps({
            "losses": [v.hex() for v in losses],
            "info": exe.compile_cache_info(),
            "prepare": exe.last_prepare,
            "monitor_misses": sum(v for k, v in snap.items()
                                  if "compile_cache_misses_total" in k),
            "momentum_launches": fk.momentum_bucket.launches,
            "mode": exe.step_mode(main),
            "kernel_load_s": kernel_load,
            "seconds": time.perf_counter() - t0}))  # from the go


def _cs_l2(card):
    """(d) two fresh processes of the headline with one
    FLAGS_compile_cache_dir: the first misses and puts, the second hits
    (no miss on its monitor) with bitwise the first's losses; then the
    main program's entry corrupted: a third counts one l2_fallback and
    runs to the same losses. The three start at once, import and build
    their programs side by side, and each runs once the one before it has
    ended (its go file)."""
    import tempfile

    from paddle_tpu_torch.cache import L2Store

    root = tempfile.mkdtemp(prefix="chip_smoke_l2_")
    gates = tempfile.mkdtemp(prefix="chip_smoke_l2_go_")
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--l2-child", root,
         os.path.join(gates, str(i))], cwd=here, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(3)]

    def child(i, tag):
        proc = procs[i]
        open(os.path.join(gates, str(i)), "w").close()
        t0 = time.perf_counter()
        try:
            out, err = proc.communicate(timeout=CS_CHILD_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"l2 child {tag}: rc {proc.returncode}\n"
                                 f"{err[-4000:]}")
        got = json.loads(out.strip().splitlines()[-1])
        got["wall_s"] = time.perf_counter() - t0
        split = got["prepare"]
        outcome = ("hit" if split.get("level") == "l2" else "fallback"
                   if got["info"]["l2"]["fallbacks"] else "miss")
        log(f"[compile_services] (d) {tag} process {card}: L2 {outcome} "
            f"(main program); prepare host split "
            + ", ".join(f"{k} {split[k]:.4f} s" for k in (
                "l2_load", "fusion", "verify", "step_build", "first_step",
                "capture") if k in split)
            + f"; the kernels' extension loaded first in "
            f"{got['kernel_load_s']:.2f} s; l2 {got['info']['l2']}; "
            f"monitor misses "
            f"{got['monitor_misses']}; momentum launches "
            f"{got['momentum_launches']}; losses {got['losses']}; process "
            f"{got['wall_s']:.1f} s from its go")
        return got

    try:
        cold = child(0, "first")
        warm = child(1, "second")
        store = L2Store(root)
        big = max(store.entries(), key=lambda e: e["bytes"])
        with open(big["path"], "r+b") as f:
            f.seek(-8, 2)
            tail = f.read(8)
            f.seek(-8, 2)
            f.write(bytes(b ^ 0xFF for b in tail))
        hurt = child(2, "third (main entry corrupted)")
        entries = len(store.entries())
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(gates, ignore_errors=True)
    l2c, l2w, l2h = (g["info"]["l2"] for g in (cold, warm, hurt))
    if (l2c["misses"], l2c["puts"], l2c["hits"]) != (2, 2, 0):
        raise AssertionError(f"first process: {l2c}")
    if (l2w["hits"], l2w["puts"], warm["monitor_misses"]) != (2, 0, 0) \
            or warm["prepare"].get("level") != "l2":
        raise AssertionError(f"second process: {l2w}, "
                             f"{warm['monitor_misses']} misses")
    if (l2h["fallbacks"], l2h["hits"], l2h["puts"]) != (1, 1, 1):
        raise AssertionError(f"third process: {l2h}")
    for g in (cold, warm, hurt):
        if g["mode"] != "graph" or g["momentum_launches"] \
                != 2 * CF_HEAD_BUCKETS:
            raise AssertionError(f"a process ran {g['mode']}, "
                                 f"{g['momentum_launches']} launches")
    if warm["losses"][0] != cold["losses"][0] \
            or hurt["losses"][0] != cold["losses"][0]:
        raise AssertionError(f"first-step losses differ: {cold['losses']} "
                             f"{warm['losses']} {hurt['losses']}")

    def saved(part):
        return cold["prepare"].get(part, 0.0) - warm["prepare"].get(part,
                                                                   0.0)

    out = {"first": cold, "second": warm, "third": hurt,
           "entries": entries,
           "second_step_losses_equal": warm["losses"] == cold["losses"],
           "saved_s": {p: saved(p) for p in (
               "l2_load", "fusion", "verify", "step_build", "first_step",
               "capture")},
           "momentum_launches": sum(g["momentum_launches"]
                                    for g in (cold, warm, hurt))}
    log(f"[compile_services] (d) the L2 hit against the miss, host s by "
        f"part: " + ", ".join(f"{k} {v:+.4f}"
                              for k, v in out["saved_s"].items())
        + f"; first-step losses bitwise equal in the three processes "
        f"(second step too: {out['second_step_losses_equal']})")
    return out


def _cs_go_select(fluid, csp, n):
    """A Go block computes n [256, 256] products on its own stream and
    sends each through a buffered channel, then says "done" over a second
    one; the main block waits for "done", and n Selects with a default
    case receive the n values. Returns the n received vars."""
    ch = csp.make_channel(dtype="float32", capacity=n)
    done = csp.make_channel(dtype="float32", capacity=1)
    x = fluid.layers.fill_constant(shape=[256, 256], dtype="float32",
                                   value=0.5)
    with csp.Go():
        y = x
        for k in range(n):
            y = fluid.layers.matmul(y, x)
            csp.channel_send(ch, fluid.layers.scale(y, scale=float(k + 1)))
        csp.channel_send(done, x)
    flag = fluid.layers.fill_constant(shape=[256, 256], dtype="float32",
                                      value=0.0)
    csp.channel_recv(done, flag)
    outs = []
    for _ in range(n):
        got = fluid.layers.fill_constant(shape=[256, 256], dtype="float32",
                                         value=-1.0)
        sel = csp.Select()
        with sel:
            with sel.case(csp.channel_recv, ch, got):
                pass
            with sel.default():
                pass
        outs.append(got)
    return outs


def _cs_csp(card):
    """(e) the Go/Select program on the card and on the host: equal
    values."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import concurrency

    got = {}
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            outs = _cs_go_select(fluid, concurrency, CS_CSP_VALUES)
        exe = fluid.Executor(place)
        got[str(place)] = exe.run(main, fetch_list=outs)
        mode = exe.step_mode(main)
    card_vals, host_vals = got.values()
    for c, h in zip(card_vals, host_vals):
        if not np.array_equal(c, h) or c[0, 0] == -1.0:
            raise AssertionError("the Go/Select values differ on the card")
    log(f"[compile_services] (e) a Go block sent {CS_CSP_VALUES} CUDA "
        f"tensors through a buffered channel, Selects with a default case "
        f"received them on {card}: equal to the host's (first "
        f"{card_vals[0][0, 0]}, last {card_vals[-1][0, 0]}; {mode})")
    return {"values": CS_CSP_VALUES, "equal_to_host": True}


def phase_compile_services(card, headline_img_s):
    """(a)-(e) of the module docstring. Prints its seconds."""
    t = [time.perf_counter()]
    result = _cs_verify(card, headline_img_s)
    t.append(time.perf_counter())
    _release()
    result["cap"] = _cs_cap(card)
    t.append(time.perf_counter())
    _release()
    result["l2"] = _cs_l2(card)
    t.append(time.perf_counter())
    result["csp"] = _cs_csp(card)
    t.append(time.perf_counter())
    parts = dict(zip(("verify_hbm", "cap", "l2", "csp"),
                     (b - a for a, b in zip(t, t[1:]))))
    log(f"[compile_services] phase {t[-1] - t[0]:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()))
    result.update(seconds=t[-1] - t[0], seconds_by_part=parts)
    return result


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


def _cont_nmt():
    """The NMT's training program at its published widths, random
    weights from SEED in a card scope; CONT_SOURCES synthetic WMT14
    sources (4..15 ids, seq_batches' draw) as one ragged batch."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.lod_tensor import LoDTensor
    from paddle_tpu_torch.models import machine_translation as mt

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        mt.seq_to_seq_net(512, 512, 512, WMT_DICT, WMT_DICT)
    main.random_seed = startup.random_seed = SEED
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(scope):
        exe.run(startup)
    rs = np.random.RandomState(SEED + 18)
    src = [rs.randint(3, WMT_DICT, rs.randint(4, 16))
           for _ in range(CONT_LONG + CONT_SHORT)]
    offs = np.concatenate([[0], np.cumsum([len(s) for s in src])])
    lt = LoDTensor(np.concatenate(src).astype(np.int64)[:, None],
                   [offs.tolist()])
    t0 = time.perf_counter()
    feeds = mt.greedy_feeds(exe, main, lt, CONT_TS, scope=scope)
    return main, scope, feeds, time.perf_counter() - t0


def _cont_server(prog, names, fetch, state, scope, buckets, interop=False):
    from paddle_tpu_torch import serve

    srv = serve.ContinuousServer(
        config=serve.ContinuousConfig(max_slots=CONT_SLOTS,
                                      slot_buckets=buckets))
    srv.add_model("m", prog, names, fetch, state=state, scope=scope,
                  slo_ms=100.0, interop=interop)
    t0 = time.perf_counter()
    srv.start()
    return srv, (time.perf_counter() - t0) * 1e3


def _cont_traffic(srv, feeds):
    """bench.py's A/B mix (bench.py:531-533): each short alone (solo),
    then CONT_LONG streams of CONT_LONG_STEPS with the shorts of
    CONT_SHORT_STEPS submitted one after another while they run. ->
    ({solo_ms, cont_ms, mixed_s, steps, tokens}, results in feed order)."""
    longs, shorts = feeds[:CONT_LONG], feeds[CONT_LONG:]
    solo_ms, cont_ms = [], []
    for f in shorts:
        t0 = time.perf_counter()
        srv.infer(f, steps=CONT_SHORT_STEPS, timeout=120)
        solo_ms.append((time.perf_counter() - t0) * 1e3)
    steps0 = srv.model_stats("m")["steps"]
    t_mix = time.perf_counter()
    futs = [srv.submit(f, steps=CONT_LONG_STEPS) for f in longs]
    short_res = []
    for f in shorts:
        t0 = time.perf_counter()
        short_res.append(srv.infer(f, steps=CONT_SHORT_STEPS, timeout=120))
        cont_ms.append((time.perf_counter() - t0) * 1e3)
    long_res = [f.result(timeout=300) for f in futs]
    mixed_s = time.perf_counter() - t_mix
    steps = srv.model_stats("m")["steps"] - steps0
    tokens = CONT_LONG * CONT_LONG_STEPS + CONT_SHORT * CONT_SHORT_STEPS
    return ({"solo_ms": solo_ms, "cont_ms": cont_ms, "mixed_s": mixed_s,
             "steps": steps, "tokens": tokens}, long_res + short_res)


def _cont_step_ms(srv, rungs):
    """Each rung's model step (feeds gathered from the bank: load, replay,
    fetch copies) between two CUDA events, median of CONT_STEP_REPS, with
    the loop stopped."""
    m = srv.models["m"]
    out = {}
    for b in rungs:
        feed = m.bank.gather(np.full(b, m.bank.scratch, dtype=np.int32))
        times = []
        for _ in range(CONT_STEP_REPS):
            e0, e1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            e0.record()
            m.run_step(feed)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        out[str(b)] = statistics.median(times)
    return out


def _cont_solo(exe, prog, fetch, state, scope, feed, steps, rows):
    """One stream replayed alone through a plain Executor at `rows` rows
    (its row first, zero pad rows, as the slot bank pads a rung): its
    [steps] tokens, [steps, D] h, and the step inputs it ran on."""
    import paddle_tpu_torch as fluid

    cur = {n: np.zeros((rows,) + np.shape(v), np.asarray(v).dtype)
           for n, v in feed.items()}
    for n, v in feed.items():
        cur[n][0] = v
    toks, hs, inputs = [], [], []
    names = [state["prev_emb"], state["prev_c"]]
    with fluid.scope_guard(scope):
        for _ in range(steps):
            inputs.append({n: v[:1].copy() for n, v in cur.items()})
            t, h, emb, c = exe.run(prog, feed=cur,
                                   fetch_list=list(fetch) + names)
            toks.append(t[0])
            hs.append(h[0])
            for n, v in (("prev_emb", emb), ("prev_h", h), ("prev_c", c)):
                cur[n] = np.zeros_like(cur[n])
                cur[n][0] = v[0]
    return np.asarray(toks), np.stack(hs), inputs


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def _cont_ladder_pairs(prog, fetch, scope, feeds):
    """(b) the same step at each rung of the default ladder on the same
    live rows (the first CONT_SLOTS streams' initial feeds, padded with
    zero rows): for each rung pair, whether the rows both hold are
    bitwise equal, else the largest ulp gap of h."""
    import paddle_tpu_torch as fluid

    exe = fluid.Executor(fluid.CUDAPlace(0))
    rungs = (1, 2, 4, 8)
    live = feeds[:CONT_SLOTS]
    hs = {}
    with fluid.scope_guard(scope):
        for b in rungs:
            feed = {n: np.stack([f[n] for f in live[:b]]) for n in live[0]}
            for _ in range(3):  # eager, capture, replay
                hs[b] = exe.run(prog, feed=feed, fetch_list=fetch)[1]
    pairs = {}
    for i, a in enumerate(rungs):
        for b in rungs[i + 1:]:
            k = min(a, b)
            gap = _ulps(hs[a][:k], hs[b][:k])
            pairs[f"{a}-{b}"] = "bitwise" if gap == 0 else gap
    return pairs


def _cont_greedy(card_line):
    """(a) greedy NMT decode at published widths through the
    ContinuousServer at a fixed rung; (b) the default ladder."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models import machine_translation as mt

    main, scope, feeds, encode_s = _cont_nmt()
    prog, names, fetch, state = mt.greedy_step_program(main, CONT_TS)
    res = {"sources": len(feeds), "max_source_len": CONT_TS,
           "encode_s": encode_s}
    log(f"[continuous] (a) NMT seq_to_seq_net(512, 512, 512, {WMT_DICT}, "
        f"{WMT_DICT}): {len(feeds)} sources encoded in one Executor run "
        f"({encode_s:.3f} s), padded to {CONT_TS}")
    srv, warm_ms = _cont_server(prog, names, fetch, state, scope,
                                (CONT_SLOTS,))
    try:
        load, got = _cont_traffic(srv, feeds)
        stats = srv.stats()
    finally:
        srv.stop()
    if stats["steady_state_compiles"] != 0:
        raise AssertionError(f"[continuous] steady-state captures: "
                             f"{stats['steady_state_compiles']}")
    m = srv.models["m"]
    res["fixed_rung_step_ms"] = _cont_step_ms(srv, (CONT_SLOTS,))
    p99 = lambda v: float(np.percentile(np.asarray(v), 99))  # noqa: E731
    # run to completion (bench.py:579-590): the same arrival order served
    # FIFO, each request decoded to its end before the next starts, at
    # one row through a plain Executor (warmed first: eager, capture)
    fexe = fluid.Executor(fluid.CUDAPlace(0))
    _cont_solo(fexe, prog, fetch, state, scope, feeds[0], 3, 1)
    t_base = time.perf_counter()
    fifo_ms = []
    for i, f in enumerate(feeds):
        k = CONT_LONG_STEPS if i < CONT_LONG else CONT_SHORT_STEPS
        _cont_solo(fexe, prog, fetch, state, scope, f, k, 1)
        if i >= CONT_LONG:
            fifo_ms.append((time.perf_counter() - t_base) * 1e3)
    res.update(
        warmup_ms=warm_ms, steady_state_compiles=0,
        model_steps=load["steps"], tokens=load["tokens"],
        tokens_per_sec=load["tokens"] / load["mixed_s"],
        host_ms_per_step=load["mixed_s"] * 1e3 / load["steps"],
        short_p99_solo_ms=p99(load["solo_ms"]),
        short_p99_continuous_ms=p99(load["cont_ms"]),
        short_p99_fifo_ms=p99(fifo_ms))
    res["continuous_over_fifo"] = (res["short_p99_continuous_ms"]
                                   / res["short_p99_fifo_ms"])
    # every request bitwise its solo replay at the fixed rung; each step
    # of its first CONT_CHECK_STEPS against the host's run of that step
    sexe = fluid.Executor(fluid.CUDAPlace(0))
    host_scope = fluid.Scope()
    state_np = convert.numpy_state(scope, main)
    convert.load_numpy_state(
        host_scope, prog, {n: np.asarray(state_np[n])
                           for n, v in prog.global_block().vars.items()
                           if v.persistable}, fluid.CPUPlace())
    del state_np
    hexe = fluid.Executor(fluid.CPUPlace())
    worst, checked = 0.0, 0
    for i, (f, out) in enumerate(zip(feeds, got)):
        k = CONT_LONG_STEPS if i < CONT_LONG else CONT_SHORT_STEPS
        toks, hs, inputs = _cont_solo(sexe, prog, fetch, state, scope, f,
                                      k, CONT_SLOTS)
        if not (np.array_equal(out[0], toks) and np.array_equal(out[1], hs)):
            raise AssertionError(
                f"[continuous] request {i}: not bitwise its solo replay at "
                f"rung {CONT_SLOTS}")
        with fluid.scope_guard(host_scope):
            for t, inp in enumerate(inputs[:CONT_CHECK_STEPS]):
                ht, hh = hexe.run(prog, feed=inp, fetch_list=fetch)
                if int(ht[0]) != int(toks[t]):
                    raise AssertionError(
                        f"[continuous] request {i} step {t}: token "
                        f"{int(toks[t])} on the card, {int(ht[0])} on the "
                        f"host")
                err = np.abs(hs[t] - hh[0])
                bound = CONT_HOST_RTOL * np.abs(hh[0]) + CONT_HOST_ATOL
                if np.any(err > bound):
                    raise AssertionError(
                        f"[continuous] request {i} step {t}: h card vs "
                        f"host outside rtol {CONT_HOST_RTOL:g} (largest "
                        f"difference {float(err.max()):.3e})")
                worst = max(worst, float((err / bound).max()))
                checked += 1
    res.update(bitwise_vs_solo=len(feeds), host_steps_checked=checked,
               host_h_max_share_of_bound=worst)
    log(f"[continuous] (a) {card_line}: rung {CONT_SLOTS} warm-up "
        f"{warm_ms:.1f} ms; {load['steps']} model steps, "
        f"{res['tokens_per_sec']:.1f} tokens/s, host "
        f"{res['host_ms_per_step']:.3f} ms a step, device "
        f"{res['fixed_rung_step_ms']} ms a step (CUDA events); short "
        f"p99 solo {res['short_p99_solo_ms']:.3f} / continuous "
        f"{res['short_p99_continuous_ms']:.3f} / FIFO "
        f"{res['short_p99_fifo_ms']:.3f} ms (ratio "
        f"{res['continuous_over_fifo']:.4f}); all {len(feeds)} requests "
        f"bitwise their solo replay at rung {CONT_SLOTS}; zero "
        f"steady-state captures; {checked} steps card = host (tokens; h "
        f"within rtol {CONT_HOST_RTOL:g} + atol {CONT_HOST_ATOL:g}: at "
        f"most {worst:.3f} of the bound)")
    # (b) the default ladder, the same requests
    srv2, warm2 = _cont_server(prog, names, fetch, state, scope, None)
    try:
        load2, got2 = _cont_traffic(srv2, feeds)
        stats2 = srv2.stats()
    finally:
        srv2.stop()
    if stats2["steady_state_compiles"] != 0:
        raise AssertionError("[continuous] (b) steady-state captures")
    same = sum(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
               for a, b in zip(got, got2))
    tok_same = sum(np.array_equal(a[0], b[0]) for a, b in zip(got, got2))
    h_gap = max(_ulps(a[1], b[1]) for a, b in zip(got, got2))
    pairs = _cont_ladder_pairs(prog, fetch, scope, feeds)
    res["ladder"] = {
        "rungs": list(srv2.models["m"].bank.rungs), "warmup_ms": warm2,
        "step_ms": _cont_step_ms(srv2, srv2.models["m"].bank.rungs),
        "tokens_per_sec": load2["tokens"] / load2["mixed_s"],
        "requests_bitwise_fixed_rung": same,
        "requests_same_tokens": tok_same, "h_max_ulps": h_gap,
        "rung_pairs": pairs}
    log(f"[continuous] (b) default ladder {res['ladder']['rungs']}: step "
        f"ms {res['ladder']['step_ms']}; {same} of {len(feeds)} requests "
        f"bitwise the fixed rung's ({tok_same} the same tokens, h within "
        f"{h_gap} ulps); rung pairs (bitwise or the largest ulp gap of h): "
        f"{pairs}")
    del srv, srv2, m
    return res


def _cont_interop(card_line):
    """(c) a two-head program (CONT_IO_WIDTH in, a tanh tower as the
    state, a relu tower beside it) through the InterOpRunner, each
    branch on its own stream, against the single program: bitwise."""
    import paddle_tpu_torch as fluid

    w = CONT_IO_WIDTH
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        x = fluid.layers.data(name="x", shape=[w], dtype="float32")
        a = fluid.layers.fc(fluid.layers.fc(x, 4 * w, act="tanh"), w,
                            act="tanh")
        b = fluid.layers.fc(fluid.layers.fc(x, 4 * w, act="relu"), w)
    prog.random_seed = startup.random_seed = SEED
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CUDAPlace(0)).run(startup)
    rs = np.random.RandomState(SEED + 19)
    rows = [{"x": rs.randn(w).astype(np.float32)} for _ in range(6)]
    outs, eff = {}, None
    for interop in (False, True):
        srv, _ = _cont_server(prog, ["x"], [a, b], {"x": a.name}, scope,
                              (CONT_SLOTS,), interop=interop)
        try:
            with srv:
                futs = [srv.submit(r, steps=4 + i) for i, r in
                        enumerate(rows)]
                outs[interop] = [f.result(timeout=120) for f in futs]
            runner = srv.models["m"].runner
            if interop:
                if runner is None or len(runner.streams) != 2:
                    raise AssertionError("[continuous] (c) no two-stream "
                                         "runner")
                eff = runner.last_efficiency
                costs = list(runner.branch_cost_ms)
            if srv.stats()["steady_state_compiles"]:
                raise AssertionError("[continuous] (c) steady captures")
        finally:
            srv.stop()
    for p, q in zip(outs[False], outs[True]):
        if not all(np.array_equal(u, v) for u, v in zip(p, q)):
            raise AssertionError("[continuous] (c) interop outputs differ "
                                 "from the single program's")
    log(f"[continuous] (c) {card_line}: two heads ({w} -> {4 * w} -> {w}) "
        f"on two streams bitwise the single program's over {len(rows)} "
        f"streams; branch ms {costs}; overlap efficiency {eff}")
    return {"width": w, "streams": len(rows), "bitwise": True,
            "branch_cost_ms": costs, "overlap_efficiency": eff}


def _cont_fleet(card_line):
    """(d) the fleet on one card: the headline network's inference model
    trained and saved as phase serve's, CONT_FLEET_REPLICAS `fleet
    replica` processes serving it under bf16 AMP (max batch 8) behind a
    Router; CONT_FLEET_REQUESTS one-image requests from
    CONT_FLEET_CLIENTS clients, one replica SIGKILLed after half of them.
    Zero lost; each answer within phase serve's bf16 bound of an
    in-process Server's at the closest bucket."""
    import json as _json
    import signal
    import tempfile

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, serve
    from paddle_tpu_torch.serve.fleet import DEAD, FleetConfig, Router

    os.makedirs(OUT_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    model_dir = os.path.join(tmp, "model")
    rs = np.random.RandomState(SEED + 20)
    # trained as phase serve's, so that bf16 rows are well conditioned
    # (at its initial running statistics the network's softmax saturates)
    _train_and_save_headline(rs, model_dir)
    _release()
    images = rs.randint(0, 256, (CONT_FLEET_CLIENTS, 224, 224, 3),
                        dtype=np.uint8)
    bodies = [_json.dumps({"inputs": {"data_u8": im[None].tolist()}}
                          ).encode() for im in images]
    procs, router, result = [], None, {}
    try:
        t0 = time.perf_counter()
        pfs = [os.path.join(tmp, f"port{i}")
               for i in range(CONT_FLEET_REPLICAS)]
        for i, pf in enumerate(pfs):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "paddle_tpu_torch", "fleet",
                 "replica", "--model-dir", model_dir, "--place", "cuda",
                 "--amp", "bfloat16", "--max-batch", "8", "--port", "0",
                 "--port-file", pf, "--name", f"r{i}"],
                stdout=subprocess.DEVNULL,
                stderr=open(os.path.join(OUT_DIR, f"fleet_r{i}.log"), "w")))
        endpoints = {}
        deadline = time.monotonic() + CONT_FLEET_START_S
        for i, pf in enumerate(pfs):
            while not os.path.exists(pf):
                if time.monotonic() > deadline or procs[i].poll() is not None:
                    raise AssertionError(f"[continuous] (d) replica r{i} "
                                         f"did not start")
                time.sleep(0.05)
            endpoints[f"r{i}"] = f"127.0.0.1:{open(pf).read().strip()}"
        router = Router(endpoints, config=FleetConfig(probe_interval_s=0.1))
        router.start()
        if router.membership.healthy_count() != CONT_FLEET_REPLICAS:
            raise AssertionError("[continuous] (d) replicas not healthy")
        start_s = time.perf_counter() - t0
        # the in-process Server's answers, the bound's reference: each
        # image at each bucket (the first row of a batch of its copies) —
        # a row's bf16 bits follow the batch size its dispatch ran at,
        # and a replica's batches mix the clients' requests
        amp.enable("bfloat16")
        try:
            with serve.Server.from_inference_model(
                    model_dir, place=fluid.CUDAPlace(0),
                    config=serve.ServeConfig(max_batch=8)) as local:
                want = {b: [local.infer({"data_u8": np.repeat(
                    im[None], b, axis=0)}, timeout=120)[0][0]
                    for im in images] for b in local.config.buckets}
        finally:
            amp.disable()
        codes, answers, lock = {}, {}, threading.Lock()
        order = iter(range(CONT_FLEET_REQUESTS)).__next__
        killed, dead_s = threading.Event(), []

        def client(c):
            while True:
                with lock:
                    try:
                        i = order()
                    except StopIteration:
                        return
                    if i == CONT_FLEET_REQUESTS // 2 and not killed.is_set():
                        os.kill(procs[1].pid, signal.SIGKILL)
                        killed.set()
                        threading.Thread(target=watch, daemon=True,
                                         args=(time.perf_counter(),)).start()
                status, _, body = router.route(bodies[i % len(bodies)])
                with lock:
                    codes[status] = codes.get(status, 0) + 1
                    if status == 200 and i % len(bodies) not in answers:
                        answers[i % len(bodies)] = body

        def watch(t_kill):
            while router.membership.get("r1").state != DEAD:
                time.sleep(0.001)
            dead_s.append(time.perf_counter() - t_kill)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(CONT_FLEET_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        st = router.stats()
        if set(codes) != {200} or sum(codes.values()) \
                != CONT_FLEET_REQUESTS:
            raise AssertionError(f"[continuous] (d) lost requests: {codes}")
        worst, at_one = 0.0, 0
        for j, body in answers.items():
            got = np.asarray(_json.loads(body)["outputs"][0], np.float32)
            errs = {b: float((np.abs(got[0] - w[j]) / np.abs(w[j]).max()
                              ).max()) for b, w in want.items()}
            b = min(errs, key=errs.get)
            worst = max(worst, _rows_close(
                got[0], want[b][j], PARITY_AMP_RTOL,
                f"fleet answer {j}: largest difference over the row's top "
                f"by bucket {errs}; closest"))
            at_one += errs[1] <= PARITY_AMP_RTOL
        result = {
            "replicas": CONT_FLEET_REPLICAS,
            "requests": CONT_FLEET_REQUESTS,
            "clients": CONT_FLEET_CLIENTS, "lost": 0,
            "start_s": start_s, "wall_s": wall,
            "images_per_sec": CONT_FLEET_REQUESTS / wall,
            "p50_ms": st["p50_ms"], "p99_ms": st["p99_ms"],
            "retries": st["retries"],
            "dead_after_kill_s": dead_s[0] if dead_s else None,
            "answers_checked": len(answers), "max_rel_vs_local": worst,
            "answers_within_bound_of_bucket_1": at_one}
        log(f"[continuous] (d) {card_line}: {CONT_FLEET_REPLICAS} `fleet "
            f"replica` processes up in {start_s:.1f} s; "
            f"{CONT_FLEET_REQUESTS} requests from {CONT_FLEET_CLIENTS} "
            f"clients, r1 SIGKILLed at half: 0 lost, "
            f"{result['images_per_sec']:.1f} img/s routed, p50 "
            f"{st['p50_ms']:.2f} / p99 {st['p99_ms']:.2f} ms, "
            f"{st['retries']} retries, r1 dead after "
            f"{result['dead_after_kill_s']} s; answers within rtol "
            f"{PARITY_AMP_RTOL:g} of the in-process Server's at the "
            f"closest bucket (largest {worst:.3e}; {at_one} of "
            f"{len(answers)} also of its batch-1 answer)")
        report = router.drain("r0", timeout_s=60.0)
        result["drain_exit"] = procs[0].wait(timeout=60)
        if not report["drained"] or result["drain_exit"] != 0:
            raise AssertionError(f"[continuous] (d) drain: {report}, "
                                 f"exit {result['drain_exit']}")
    finally:
        if router is not None:
            router.stop()
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    return result


def phase_continuous(card_line):
    """Serving's continuous batching and the fleet on the card: (a) greedy
    NMT streams at published widths joining and leaving a running batch,
    (b) the default ladder, (c) interop streams, (d) the fleet."""
    t0 = time.perf_counter()
    result = {"nmt": _cont_greedy(card_line)}
    _release()
    result["interop"] = _cont_interop(card_line)
    _release()
    result["fleet"] = _cont_fleet(card_line)
    _release()
    result["seconds"] = time.perf_counter() - t0
    log(f"[continuous] phase {result['seconds']:.1f} s")
    return result


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def build_table(distributed=True):
    """The distributed-table model of the JAX package's tests
    (tests/test_sparse_table.py) at PS_TABLE: ids -> embedding (is_sparse;
    is_distributed unless `distributed` is False, the dense replay) -> fc
    -> square error, SGD(PS_TABLE_LR)."""
    import paddle_tpu_torch as fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[1], dtype="int64")
        label = fluid.layers.data(name="label", shape=[1], dtype="float32")
        emb = fluid.layers.embedding(
            ids, size=list(PS_TABLE), is_sparse=True,
            is_distributed=distributed,
            param_attr=fluid.ParamAttr(name="table_w"))
        fc = fluid.layers.fc(input=emb, size=1,
                             param_attr=fluid.ParamAttr(name="fc_w"))
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=fc, label=label))
        fluid.optimizer.SGD(learning_rate=PS_TABLE_LR).minimize(loss)
    main.random_seed = startup.random_seed = SEED
    return main, startup, loss


def _ps_transpile(model, pservers):
    """(trainer program, its startup, loss, DistributeTranspiler) of
    `model` ("headline" or "table") for `pservers`."""
    import paddle_tpu_torch as fluid

    if model == "headline":
        main, startup, loss, _ = build_headline(plan=False)
    else:
        main, startup, loss = build_table()
    t = fluid.DistributeTranspiler()
    t.transpile(0, program=main, startup_program=startup, pservers=pservers,
                trainers=1)
    return main, startup, loss, t


def pserver_child(model, dump):
    """`python3 chip_smoke.py --pserver-child MODEL DIR`, exec'd by `python
    -m paddle_tpu_torch train --role pserver` (PADDLE_PSERVERS,
    PADDLE_CURRENT_ENDPOINT): the pserver program of MODEL for this
    endpoint, its startup and then its service on the card, until the
    trainer stops it. Each round's optimize blocks are timed (host clock;
    CUDA events from the first block's start to the last block's end).
    Prints one JSON line: the rounds, the kernels' launches, and a table's
    row count (its rows and values saved to DIR)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.executor import Executor
    from paddle_tpu_torch.fusion import kernels as fk
    from paddle_tpu_torch.parallel import rpc

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ep = os.environ["PADDLE_CURRENT_ENDPOINT"]
    t = _ps_transpile(model, os.environ["PADDLE_PSERVERS"])[3]
    pp = t.get_pserver_program(ep)
    sp = t.get_startup_program(ep, pp)
    rounds, cur = [], {}
    run_block, barrier = (Executor.run_block_eager,
                          rpc.VariableServer._handle_batch_barrier)

    def timed_block(self, block, scope):
        if not cur:
            cur["t0"] = time.perf_counter()
            cur["start"] = torch.cuda.Event(enable_timing=True)
            cur["start"].record()
        run_block(self, block, scope)

    def timed_barrier(self):
        cur.clear()
        barrier(self)
        if cur:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            rounds.append([(time.perf_counter() - cur["t0"]) * 1e3,
                           cur["start"].elapsed_time(end)])

    Executor.run_block_eager = timed_block
    rpc.VariableServer._handle_batch_barrier = timed_barrier
    fk.reset_launch_counts()
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(sp, scope=scope)
    exe.run(pp, scope=scope)  # serves until the trainer sends exit
    torch.cuda.synchronize()
    out = {"endpoint": ep, "blocks": len(pp.blocks) - 1, "rounds": rounds,
           "momentum_launches": fk.momentum_bucket.launches,
           "adam_launches": fk.adam_bucket.launches}
    table = scope.find_var("table_w")
    if table is not None:
        rows = table.rows()
        np.savez(os.path.join(dump, f"table_{ep.rsplit(':', 1)[1]}.npz"),
                 rows=rows, values=table.gather(rows, auto_grow=False))
        out["table_rows"] = len(table)
    print(json.dumps(out), flush=True)


def _ps_launch(model, n, dump):
    """n pserver processes of `model` on ports the OS picked."""
    eps = [f"127.0.0.1:{_free_port()}" for _ in range(n)]
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for i, ep in enumerate(eps):
        path = os.path.join(OUT_DIR, f"pserver_{model}{n}_{i}.log")
        with open(path, "w") as out:
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "paddle_tpu_torch", "train", "--role",
                 "pserver", "--pservers", ",".join(eps),
                 "--current-endpoint", ep, os.path.join(here, "chip_smoke.py"),
                 "--pserver-child", model, dump],
                cwd=here, stdout=out, stderr=subprocess.STDOUT), path))
    return {"model": model, "eps": eps, "procs": procs,
            "t0": time.monotonic()}


def _ps_wait(cluster):
    """Until every pserver of `cluster` accepts a connection; fails on one
    that exited or is not up within PS_START_S. Returns the seconds."""
    import socket

    for ep, (proc, path) in zip(cluster["eps"], cluster["procs"]):
        host, port = ep.rsplit(":", 1)
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"[pserver] {ep} exited with "
                                     f"{proc.returncode} (see {path})")
            try:
                socket.create_connection((host, int(port)), timeout=1).close()
                break
            except OSError:
                if time.monotonic() > cluster["t0"] + PS_START_S:
                    raise AssertionError(f"[pserver] {ep} not up within "
                                         f"{PS_START_S} s (see {path})")
                time.sleep(0.05)
    return time.monotonic() - cluster["t0"]


def _ps_stop(cluster):
    """Stop the pservers of `cluster` (the trainer's clients send exit),
    wait for each, which must exit 0, and return their reports."""
    from paddle_tpu_torch.ops import rpc_ops
    from paddle_tpu_torch.parallel import rpc

    rpc_ops.reset_clients()
    for ep in cluster["eps"]:
        try:
            rpc.VariableClient(ep, connect_timeout=0.3).shutdown()
        except OSError:
            pass
    reports = []
    for proc, path in cluster["procs"]:
        proc.wait(timeout=max(1.0, cluster["t0"] + PS_DEADLINE_S
                              - time.monotonic()))
        with open(path) as f:
            lines = f.read().strip().splitlines()
        if proc.returncode != 0:
            raise AssertionError(f"[pserver] exited with {proc.returncode}: "
                                 f"{lines[-5:]}")
        reports.append(json.loads(lines[-1]))
    return reports


def _ps_kill(clusters):
    """Kill every pserver process still alive; returns how many were."""
    alive = 0
    for cluster in clusters:
        for proc, _ in cluster["procs"]:
            if proc.poll() is None:
                alive += 1
                proc.kill()
                proc.wait(timeout=30)
    return alive


def _ps_recvs(main):
    """[(param, [(block or param name, endpoint, rows)])] the trainer
    program receives, a split param's blocks in order."""
    gb = main.global_block()
    out = {}
    for op in main.global_block().ops:
        if op.type == "recv":
            for name, ep in zip(op.output("Out"), op.attrs["epmap"]):
                out.setdefault(name.split(".block")[0], []).append(
                    (name, ep, gb.vars[name].shape[0]))
    return out


def _ps_pull(main, scope):
    """Each param the trainer program receives, got from its pserver
    before the first round (a split param's blocks joined) and copied into
    `scope`'s tensor."""
    from paddle_tpu_torch.ops import rpc_ops

    for name, parts in _ps_recvs(main).items():
        scope.find_var(name).copy_(torch.from_numpy(np.concatenate(
            [rpc_ops._client(ep).get_var(b) for b, ep, _ in parts])))


def _ps_push(main, state):
    """`state`'s value of each param the trainer program receives, sent to
    its pserver before the first round (a split param's blocks by their
    rows): the pservers start where `state` does."""
    from paddle_tpu_torch.ops import rpc_ops

    for name, parts in _ps_recvs(main).items():
        at = 0
        for block, ep, rows in parts:
            rpc_ops._client(ep).send_var(block, state[name][at:at + rows])
            at += rows


def _ps_steps(exe, main, loss, scope, feeds):
    """The trainer program's steps: (the losses as tensors, each step's
    wall ms and its parts: the trainer's compute on the card (CUDA events
    from the step's start to the send's), send (device-to-host and the
    wire), the pserver's round (the send barrier), recv (the wire and
    host-to-device), the fetch barrier; bytes each way)."""
    from paddle_tpu_torch.ops import rpc_ops

    losses, steps = [], []
    for f in feeds:
        rpc_ops.reset_stats()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        out = exe.run(main, feed=f, fetch_list=[loss], scope=scope,
                      return_numpy=False)
        _fence(out[0])
        wall = (time.perf_counter() - t0) * 1e3
        st = rpc_ops.stats
        losses.append(out[0].reshape(-1)[0].float().cpu())
        steps.append({
            "wall_ms": wall,
            "compute_ms": start.elapsed_time(rpc_ops.send_event),
            "send_ms": st["send_s"] * 1e3,
            "round_ms": st["send_barrier_s"] * 1e3,
            "recv_ms": st["recv_s"] * 1e3,
            "fetch_barrier_ms": st["fetch_barrier_s"] * 1e3,
            "bytes_out": st["send_bytes"], "bytes_in": st["recv_bytes"]})
    return losses, steps


def _ps_headline_feeds():
    rs = np.random.RandomState(SEED + 29)
    return [{"data_u8": torch.from_numpy(rs.randint(
                 0, 256, (HEADLINE_BATCH, 224, 224, 3),
                 dtype=np.uint8)).cuda(),
             "label": torch.from_numpy(rs.randint(
                 0, 1000, (HEADLINE_BATCH, 1)).astype(np.int32)).cuda()}
            for _ in range(PS_STEPS)]


def _ps_plain(start, feeds):
    """The untranspiled headline program through a plain Executor
    (FLAGS_fuse=0, bf16 AMP) from `start`: (losses, state, the replays'
    ms, step mode)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, convert, flags

    main, startup, loss, _ = build_headline(plan=False)
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    convert.load_numpy_state(scope, main, start, fluid.CUDAPlace(0))
    losses, ms = [], []
    with flags.flag_guard(fuse=False), amp.auto_cast():
        for f in feeds:
            t0 = time.perf_counter()
            out = exe.run(main, feed=f, fetch_list=[loss], scope=scope,
                          return_numpy=False)
            _fence(out[0])
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(out[0].reshape(-1)[0].float().cpu())
    return losses, convert.numpy_state(scope, main), ms, exe.step_mode(main)


def _ps_headline(tag, cluster, start, feeds, plain):
    """The headline's trainer against `cluster` from `start` (None: pull
    the pservers' own start; else push it to them), bitwise against the
    plain run (`plain`, None: run it here from the start). Returns (its
    numbers, the start, the plain run)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, convert, flags
    from paddle_tpu_torch.core import executor_core

    main, startup, loss, _ = _ps_transpile("headline",
                                           ",".join(cluster["eps"]))
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    if start is None:
        _ps_pull(main, scope)
        start = convert.numpy_state(scope, main)
    else:
        convert.load_numpy_state(scope, main, start, fluid.CUDAPlace(0))
        _ps_push(main, start)
    with flags.flag_guard(fuse=False), amp.auto_cast():
        losses, steps = _ps_steps(exe, main, loss, scope, feeds)
    if exe.step_mode(main) != "interpreter":
        raise AssertionError(f"[pserver] {tag}: the trainer ran "
                             f"{exe.step_mode(main)}")
    state = convert.numpy_state(scope, main)
    reports = _ps_stop(cluster)
    if plain is None:
        plain = _ps_plain(start, feeds)
    plosses, pstate, pms, pmode = plain
    written = executor_core.written_persistables(main)
    diff = {n: float(np.abs(state[n].astype(np.float64) - pstate[n]).max())
            for n in written if not np.array_equal(state[n], pstate[n])}
    loss_equal = all(torch.equal(a, b) for a, b in zip(losses, plosses))
    timed = steps[1:]
    n = len(timed)
    avg = {k: sum(s[k] for s in timed) / n for k in timed[0]}
    img_s = HEADLINE_BATCH * n / (sum(s["wall_ms"] for s in timed) / 1e3)
    replays = pms[2:]
    plain_img_s = HEADLINE_BATCH * len(replays) / (sum(replays) / 1e3)
    rounds = [r for rep in reports for r in rep["rounds"][1:]]
    result = {
        "pservers": len(cluster["eps"]),
        "blocks": [rep["blocks"] for rep in reports],
        "steps": PS_STEPS, "images_per_sec": img_s,
        "plain_images_per_sec": plain_img_s, "plain_mode": pmode,
        "step_ms": avg, "plain_replay_ms": replays,
        "pserver_round_host_ms": [r[0] for r in rounds],
        "pserver_round_device_ms": [r[1] for r in rounds],
        "send_GB_s": avg["bytes_out"] / avg["send_ms"] / 1e6,
        "recv_GB_s": avg["bytes_in"] / avg["recv_ms"] / 1e6,
        "losses": [float(v) for v in losses],
        "bitwise": loss_equal and not diff, "params_checked": len(written),
        "momentum_launches": sum(rep["momentum_launches"]
                                 for rep in reports),
        "adam_launches": sum(rep["adam_launches"] for rep in reports)}
    log(f"[pserver] {tag}: {len(cluster['eps'])} pserver(s) "
        f"({result['blocks']} optimize blocks), {PS_STEPS} steps at batch "
        f"{HEADLINE_BATCH}, bf16: {img_s:.2f} img/s against the plain "
        f"Executor's {plain_img_s:.2f} ({pmode}); a step {avg['wall_ms']:.1f}"
        f" ms = trainer compute {avg['compute_ms']:.1f} (CUDA events) + "
        f"send {avg['send_ms']:.1f} + pserver round "
        f"{avg['round_ms']:.1f} + recv {avg['recv_ms']:.1f} + fetch "
        f"barrier {avg['fetch_barrier_ms']:.1f} + the rest; "
        f"{avg['bytes_out'] / 1e6:.1f} MB out at "
        f"{result['send_GB_s']:.3f} GB/s, {avg['bytes_in'] / 1e6:.1f} MB in "
        f"at {result['recv_GB_s']:.3f} GB/s; the pservers' optimize blocks "
        f"a round {[round(r[0], 2) for r in rounds]} host ms, "
        f"{[round(r[1], 3) for r in rounds]} device ms; losses "
        f"{result['losses']}; vs the plain run: "
        f"{'bitwise equal' if result['bitwise'] else 'DIFFER'} "
        f"(losses and {len(written)} written persistables)"
        + ("" if not diff else f", {len(diff)} differ, largest "
           f"{sorted(diff.items(), key=lambda kv: -kv[1])[:5]}"))
    if not result["bitwise"]:
        raise AssertionError(f"[pserver] {tag}: not bitwise equal to the "
                             f"plain Executor run")
    return result, start, plain


def _ps_zipf_feeds(rs):
    vocab = PS_TABLE[0]
    p = 1.0 / np.arange(1, vocab + 1) ** PS_TABLE_ZIPF
    p /= p.sum()
    perm = rs.permutation(vocab)
    target = rs.uniform(-1, 1, vocab).astype(np.float32)
    feeds = []
    for _ in range(PS_TABLE_STEPS):
        ids = perm[rs.choice(vocab, PS_TABLE_IDS, p=p)].astype(np.int64)
        feeds.append({"ids": ids.reshape(-1, 1),
                      "label": target[ids].reshape(-1, 1)})
    return feeds


def _ps_table(cluster, dump):
    """(c) the distributed table: PS_TABLE_STEPS steps against two
    pservers from the pulled start; the loss falls over 3x; each pserver
    holds only its shard's ids; every grown row equals a dense replay on
    the card (the untranspiled is_sparse program, captured) within
    PS_TABLE_RTOL."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.selected_rows import SparseTable
    from paddle_tpu_torch.ops import rpc_ops

    main, startup, loss, _ = _ps_transpile("table", ",".join(cluster["eps"]))
    feeds = _ps_zipf_feeds(np.random.RandomState(SEED + 31))
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    _ps_pull(main, scope)
    start = {n: scope.find_var(n).cpu().numpy().copy()
             for n in _ps_recvs(main)}
    rpc_ops.reset_stats()
    t0 = time.perf_counter()
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0].reshape(-1)[0]) for f in feeds]
    wall = time.perf_counter() - t0
    st = dict(rpc_ops.stats)
    reports = _ps_stop(cluster)
    tables = [np.load(os.path.join(dump, f"table_{ep.rsplit(':', 1)[1]}"
                                         f".npz")) for ep in cluster["eps"]]
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    shards = [bool(np.all(t["rows"] % len(tables) == i))
              for i, t in enumerate(tables)]
    # the dense replay: the table's rows at the pservers' first-touch init
    # (SparseTable's per-id draw), the rest of the state pulled
    rmain, rstartup, rloss = build_table(distributed=False)
    rscope = fluid.Scope()
    rexe = fluid.Executor()
    rexe.run(rstartup, scope=rscope)
    seen = np.unique(np.concatenate([f["ids"][:, 0] for f in feeds]))
    init = np.zeros(PS_TABLE, np.float32)
    init[seen] = SparseTable(PS_TABLE[1], height=PS_TABLE[0]).gather(seen)
    rscope.find_var("table_w").copy_(torch.from_numpy(init))
    for n, arr in start.items():
        rscope.find_var(n).copy_(torch.from_numpy(arr))
    rlosses = [float(rexe.run(rmain, feed=f, fetch_list=[rloss],
                              scope=rscope)[0].reshape(-1)[0])
               for f in feeds]
    dense = rscope.find_var("table_w").cpu().numpy()
    grown = np.concatenate([t["rows"] for t in tables])
    got = np.concatenate([t["values"] for t in tables])
    want = dense[grown]
    err = np.abs(got.astype(np.float64) - want) / np.maximum(
        np.abs(want), 1e-30)
    close = np.allclose(got, want, rtol=PS_TABLE_RTOL, atol=0)
    prefetch_s = st.get("prefetch_s", 0.0)
    result = {
        "steps": PS_TABLE_STEPS, "ids_a_step": PS_TABLE_IDS,
        "rows_grown": [int(t["rows"].size) for t in tables],
        "distinct_ids": int(seen.size), "shards_only": shards,
        "loss_first10": float(first), "loss_last10": float(last),
        "loss_ratio": float(last / first),
        "replay_mode": rexe.step_mode(rmain),
        "replay_loss_max_rel": float(np.max(np.abs(
            np.array(losses) - rlosses) / np.abs(rlosses))),
        "rows_max_rel_err": float(err.max()), "rows_close": bool(close),
        "rows_bitwise": bool(np.array_equal(got, want)),
        "step_ms": wall / PS_TABLE_STEPS * 1e3,
        "prefetch_ms": prefetch_s / PS_TABLE_STEPS * 1e3,
        "prefetch_rows_per_sec": st.get("prefetch_rows", 0) / prefetch_s,
        "pserver_round_host_ms": [round(r[0], 3) for rep in reports
                                  for r in rep["rounds"][-3:]]}
    log(f"[pserver] (c) table {PS_TABLE[0]} x {PS_TABLE[1]} over 2 "
        f"pservers, {PS_TABLE_STEPS} steps of {PS_TABLE_IDS} Zipf("
        f"{PS_TABLE_ZIPF}) ids: loss {first:.4f} -> {last:.4f} (x"
        f"{last / first:.3f}); {seen.size} distinct ids, rows grown "
        f"{result['rows_grown']}, each pserver only its shard {shards}; "
        f"a step {result['step_ms']:.2f} ms, prefetch "
        f"{result['prefetch_ms']:.2f} ms a step "
        f"({result['prefetch_rows_per_sec']:.0f} rows/s); the dense replay "
        f"({result['replay_mode']}): rows within rtol "
        f"{result['rows_max_rel_err']:.3g} (limit {PS_TABLE_RTOL}; "
        f"{'bitwise' if result['rows_bitwise'] else 'not bitwise'}), "
        f"losses within {result['replay_loss_max_rel']:.3g}")
    if not (last < 0.3 * first and all(shards) and close
            and result["replay_mode"] == "graph"):
        raise AssertionError(f"[pserver] (c) failed: {result}")
    return result


def _ps_memopt(feeds):
    """(d) memory_optimize on the headline program: PS_MEMOPT_STEPS steps
    (bf16 AMP, FLAGS_fuse, the first eager, the next captured) from one
    state with and without it: the losses bitwise; the renames, each
    run's peak memory and momentum launches."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, convert, flags
    from paddle_tpu_torch.fusion import kernels as fk

    out, init = {}, None
    for opt in (False, True):
        main, startup, loss, _ = build_headline(plan=False)
        renames = fluid.memory_optimize(main) if opt else {}
        scope = fluid.Scope()
        exe = fluid.Executor()
        exe.run(startup, scope=scope)
        if init is None:
            init = convert.numpy_state(scope, main)
        else:
            convert.load_numpy_state(scope, main, init, fluid.CUDAPlace(0))
        _release()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fk.reset_launch_counts()
        # fused and captured: the fusion pass's hazard check pairs a grad
        # op with the forward op it came from, so a rename is no hazard
        with flags.flag_guard(fuse=True), amp.auto_cast():
            losses = [exe.run(main, feed=f, fetch_list=[loss], scope=scope,
                              return_numpy=False)[0].reshape(-1)[0]
                      .float().cpu() for f in feeds[:PS_MEMOPT_STEPS]]
        out[opt] = {"renames": len(renames), "losses": losses,
                    "peak_bytes": torch.cuda.max_memory_allocated() - base,
                    "mode": exe.step_mode(main),
                    "momentum_launches": fk.momentum_bucket.launches}
        del exe, scope
        _release()
    equal = all(torch.equal(a, b) for a, b in zip(out[False]["losses"],
                                                  out[True]["losses"]))
    result = {"renames": out[True]["renames"], "bitwise": equal,
              "losses": [float(v) for v in out[True]["losses"]],
              "peak_bytes": out[False]["peak_bytes"],
              "peak_bytes_optimized": out[True]["peak_bytes"],
              "mode": out[True]["mode"],
              "momentum_launches": out[True]["momentum_launches"],
              "momentum_launches_unoptimized":
                  out[False]["momentum_launches"]}
    log(f"[pserver] (d) memory_optimize on the headline: "
        f"{result['renames']} renames; {PS_MEMOPT_STEPS} steps (bf16, "
        f"FLAGS_fuse, step mode {result['mode']}): losses "
        f"{result['losses']} {'bitwise equal' if equal else 'DIFFER'} to "
        f"the unoptimized program's; momentum_bucket launches "
        f"{result['momentum_launches']} (unoptimized "
        f"{result['momentum_launches_unoptimized']}); peak memory above the "
        f"state {result['peak_bytes']} B without, "
        f"{result['peak_bytes_optimized']} B with it")
    if not equal or result["mode"] != "graph" \
            or not result["momentum_launches"] \
            or result["momentum_launches"] \
            != result["momentum_launches_unoptimized"]:
        raise AssertionError(f"[pserver] (d) failed: {result}")
    return result


def phase_pserver(card_line):
    """The parameter server on the card (module docstring, phase 12):
    (a)-(d); every pserver process stopped, none left alive."""
    import tempfile

    from paddle_tpu_torch.fusion import kernels as fk

    os.makedirs(OUT_DIR, exist_ok=True)
    t0 = time.perf_counter()
    dump = tempfile.mkdtemp(prefix="chip_smoke_pserver_")
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    clusters = [_ps_launch("headline", 1, dump),
                _ps_launch("headline", 2, dump),
                _ps_launch("table", 2, dump)]
    result = {}
    try:
        feeds = _ps_headline_feeds()
        # (d) needs no pserver: it runs while they start
        result["memory_optimize"] = _ps_memopt(feeds)
        up = [_ps_wait(c) for c in clusters]
        log(f"[pserver] {sum(len(c['eps']) for c in clusters)} pserver "
            f"processes up after {[round(s, 1) for s in up]} s")
        fk.reset_launch_counts()
        result["one"], start, plain = _ps_headline("(a) the headline",
                                                   clusters[0], None, feeds,
                                                   None)
        result["two"], _, _ = _ps_headline("(b) the split path",
                                           clusters[1], start, feeds, plain)
        trainer_launches = fk.momentum_bucket.launches + \
            fk.adam_bucket.launches
        del plain
        _release()
        result["table"] = _ps_table(clusters[2], dump)
        _release()
        result["trainer_launches"] = trainer_launches
    finally:
        torch.backends.cudnn.deterministic = prev
        left = _ps_kill(clusters)
        shutil.rmtree(dump, ignore_errors=True)
    if left:
        raise AssertionError(f"[pserver] {left} pserver process(es) left "
                             f"alive")
    if trainer_launches or any(result[k]["momentum_launches"]
                               or result[k]["adam_launches"]
                               for k in ("one", "two")):
        raise AssertionError("[pserver] a hand-written kernel ran on the "
                             "pserver path")
    result["seconds"] = time.perf_counter() - t0
    log(f"[pserver] phase {result['seconds']:.1f} s; {card_line}")
    return result


def build_ssd300(fluid, train=True):
    """SSD300 (Liu et al., ECCV 2016) built with the port's layers: VGG-16's
    conv1_1 to conv5_3 with 2x2/2 max pools (pool3 ceil_mode: 75 -> 38),
    pool5 3x3/1, fc6 a 3x3 conv of 1024 with dilation 6, fc7 1x1 1024; the
    extra layers 1x1 256 + 3x3/2 512 (10x10), 1x1 128 + 3x3/2 256 (5x5),
    1x1 128 + 3x3 valid 256 (3x3), 1x1 128 + 3x3 valid 256 (1x1); conv4_3
    L2-normalized over channels times a learnable [512] scale that starts
    at 20; multi_box_head over conv4_3, fc7 and the four extra maps
    (min_ratio 20, max_ratio 90, steps 8/16/32/64/100/300, 3x3 heads): 8,732
    priors, SSD_CLASSES classes. train: ssd_loss at its defaults, summed
    over the priors, Momentum(SSD_LR, 0.9); else detection_output at SSD's test
    settings (SSD_NMS) over the softmaxed scores and a DetectionMAP
    evaluator (11point, overlap 0.5, the difficult flags)."""
    from paddle_tpu_torch.initializer import Constant

    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        image = L.data(name="image", shape=[3, SSD_SIDE, SSD_SIDE],
                       dtype="float32")
        gt_box = L.data(name="gt_box", shape=[4], dtype="float32",
                        lod_level=1)
        gt_label = L.data(name="gt_label", shape=[1], dtype="int64",
                          lod_level=1)

        def conv(x, n, k=3, pad=1, stride=1, dilation=1):
            return L.conv2d(input=x, num_filters=n,
                            filter_size=k, stride=stride, padding=pad,
                            dilation=dilation, act="relu")

        x = image
        for i, (width, reps) in enumerate(((64, 2), (128, 2), (256, 3),
                                           (512, 3), (512, 3))):
            for _ in range(reps):
                x = conv(x, width)
            if i == 3:
                conv4_3 = x
            if i < 4:
                x = L.pool2d(x, pool_size=2, pool_stride=2, pool_type="max",
                             ceil_mode=i == 2)
        x = L.pool2d(x, pool_size=3, pool_stride=1, pool_padding=1,
                     pool_type="max")
        x = conv(conv(x, 1024, pad=6, dilation=6), 1024, k=1, pad=0)
        scale = L.create_parameter(shape=[512], dtype="float32",
                                   default_initializer=Constant(20.0))
        maps = [L.elementwise_mul(L.l2_normalize(conv4_3, axis=1), scale,
                                  axis=1), x]
        for width, stride, pad in ((512, 2, 1), (256, 2, 1), (256, 1, 0),
                                   (256, 1, 0)):
            x = conv(conv(x, width // 2, k=1, pad=0), width, stride=stride,
                     pad=pad)
            maps.append(x)
        locs, confs, boxes, variances = L.multi_box_head(
            inputs=maps, image=image, base_size=SSD_SIDE,
            num_classes=SSD_CLASSES,
            aspect_ratios=[[2.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0], [2.0],
                           [2.0]],
            min_ratio=20, max_ratio=90, steps=[8, 16, 32, 64, 100, 300],
            flip=True, kernel_size=3, pad=1)
        net = {"main": main, "startup": startup, "boxes": boxes,
               "variances": variances}
        if train:
            loss = L.reduce_sum(L.ssd_loss(locs, confs, gt_box, gt_label,
                                           boxes, variances))
            fluid.optimizer.Momentum(learning_rate=SSD_LR,
                                     momentum=0.9).minimize(loss)
            net["loss"] = loss
            net["neg"] = next(op for op in main.global_block().ops
                              if op.type == "mine_hard_examples"
                              ).output("NegIndices")[0]
        else:
            difficult = L.data(name="gt_difficult", shape=[1],
                               dtype="int32", lod_level=1)
            scores = L.reshape(L.softmax(L.reshape(
                confs, shape=[-1, SSD_CLASSES], inplace=False)),
                shape=[-1, boxes.shape[0], SSD_CLASSES], inplace=False)
            nmsed = L.detection_output(locs, scores, boxes, variances,
                                       **SSD_NMS)
            ev = fluid.evaluator.DetectionMAP(
                nmsed, gt_label, gt_box, difficult, class_num=SSD_CLASSES,
                overlap_threshold=0.5, evaluate_difficult=False,
                ap_version="11point")
            net["nmsed"] = nmsed
            net["evaluator"] = ev
    main.random_seed = startup.random_seed = SEED
    return net


def ssd_batch(rs, batch):
    """A seeded synthetic VOC-like batch: float images with 1-SSD_MAX_GT
    boxes each (width and height 0.05-0.9 of the image), labels 1-20, one
    in ten boxes difficult; each box painted into its image (a label's
    color over noise), so the boxes can be learned."""
    side = SSD_SIDE
    images = (rs.rand(batch, 3, side, side) * 0.25).astype(np.float32)
    boxes, labels, difficult, lengths = [], [], [], []
    for b in range(batch):
        n = rs.randint(1, SSD_MAX_GT + 1)
        lengths.append(n)
        for _ in range(n):
            w, h = rs.uniform(0.05, 0.9, size=2)
            x0, y0 = rs.uniform(0, 1 - w), rs.uniform(0, 1 - h)
            label = rs.randint(1, SSD_CLASSES)
            boxes.append([x0, y0, x0 + w, y0 + h])
            labels.append(label)
            difficult.append(int(rs.rand() < 0.1))
            c0, r0 = int(x0 * side), int(y0 * side)
            c1, r1 = int((x0 + w) * side), int((y0 + h) * side)
            images[b, label % 3, r0:r1, c0:c1] = 0.25 + 0.75 * label / 20
    return {"image": images, "gt_box": np.asarray(boxes, np.float32),
            "gt_label": np.asarray(labels, np.int64).reshape(-1, 1),
            "gt_difficult": np.asarray(difficult, np.int32).reshape(-1, 1),
            "lengths": lengths}


def ssd_feed(fluid, batch, place, names=("image", "gt_box", "gt_label")):
    """The batch as feeds on `place`: the images a tensor there, the
    ground truth LoDTensors of its lengths."""
    feed = {}
    for name in names:
        if name == "image":
            feed[name] = torch.from_numpy(batch[name]).to(
                "cpu" if isinstance(place, fluid.CPUPlace) else "cuda")
        else:
            feed[name] = fluid.create_lod_tensor(
                batch[name], [batch["lengths"]], place)
    return feed


def _ssd_host_split(dops, steps):
    """{op: [host ms, wait ms] a step} from detection_ops.host_stats."""
    return {op: [round(v[1] * 1e3 / steps, 3), round(v[2] * 1e3 / steps, 3)]
            for op, v in sorted(dops.host_stats.items())}


def _ssd_train(card_line):
    """(a): SSD300 trained on the card (module docstring, phase 13)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, flags, fusion
    from paddle_tpu_torch.fusion import kernels as fk
    from paddle_tpu_torch.ops import detection_ops as dops

    net = build_ssd300(fluid)
    main, startup, loss = net["main"], net["startup"], net["loss"]
    _, plan = fusion.apply(main, feed_names=["image", "gt_box", "gt_label"],
                           fetch_names=[loss.name])
    buckets = [b for b in plan.buckets if b["opt"] == "momentum"]
    n_params = sum(int(np.prod(p.shape))
                   for p in main.global_block().all_parameters())
    log(f"[detection] (a) SSD300: {n_params} parameters, "
        f"{net['boxes'].shape[0]} priors; ops {plan.n_ops_before} -> "
        f"{plan.n_ops_after}; {len(buckets)} fused momentum buckets of "
        f"{[b['numel'] for b in buckets]}")
    if net["boxes"].shape[0] != SSD_PRIORS:
        raise AssertionError(f"SSD300 has {net['boxes'].shape[0]} priors")
    rs = np.random.RandomState(SEED + 20)
    batch = ssd_batch(rs, SSD_BATCH)
    place = fluid.CUDAPlace(0)
    feed = ssd_feed(fluid, batch, place)
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    losses, walls, runs, steps = [], [], [], SSD_WARM + SSD_STEPS
    amp.enable("bfloat16")
    try:
        with flags.flag_guard(fuse=True), fluid.scope_guard(scope):
            exe.run(startup)
            torch.cuda.synchronize()
            fk.reset_launch_counts()
            for step in range(steps):
                if step == SSD_WARM:
                    dops.reset_host_stats()
                t0 = time.perf_counter()
                outs = exe.run(main, feed=feed, fetch_list=[loss],
                               return_numpy=False)
                t1 = time.perf_counter()
                losses.append(float(outs[0].reshape(-1)[0].float().item()))
                if step >= SSD_WARM:
                    walls.append(time.perf_counter() - t0)
                    runs.append(t1 - t0)
            launches = fk.momentum_bucket.launches
            split = _ssd_host_split(dops, SSD_STEPS)
            mode = exe.step_mode(main)
            wall_ms, busy_ms, idle, rows, _ = trace_step(
                exe, main, feed, [loss])
            peak = torch.cuda.max_memory_allocated()
    finally:
        amp.disable()
    timed = losses[SSD_WARM:]
    first, last = float(np.mean(timed[:5])), float(np.mean(timed[-5:]))
    step_ms = statistics.median(walls) * 1e3
    host_ms = sum(h + w for h, w in split.values())
    other_ms = statistics.median(runs) * 1e3 - host_ms
    result = {
        "parameters": n_params, "priors": SSD_PRIORS, "mode": mode,
        "losses": [round(v, 5) for v in losses],
        "first5_mean": first, "last5_mean": last, "ratio": last / first,
        "images_per_sec": SSD_BATCH / statistics.median(walls),
        "step_ms": step_ms, "device_busy_ms": busy_ms,
        "traced_wall_ms": wall_ms, "idle_share": idle,
        "host_ops_ms": split, "interpreter_other_host_ms": other_ms,
        "momentum_launches": launches, "buckets": len(buckets),
        "traced_momentum_rows": rows, "peak_bytes": peak}
    log(f"[detection] (a) {steps} steps ({mode}) at batch {SSD_BATCH}, bf16 "
        f"AMP, fused momentum: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"mean of the first 5 timed {first:.4f}, of the last 5 {last:.4f} "
        f"(ratio {last / first:.4f}); {result['images_per_sec']:.2f} img/s, "
        f"a step {step_ms:.2f} ms; peak {peak / 2**30:.2f} GiB")
    log(f"[detection] (a) a step's split: the card's work {busy_ms:.2f} ms "
        f"(one traced step, wall {wall_ms:.2f} ms, idle {idle:.3f}); host "
        f"ops [host ms, wait for the card ms] {split}; the interpreter's "
        f"other host time {other_ms:.2f} ms; momentum launches {launches} "
        f"({len(buckets)} buckets x {steps} steps); {card_line}")
    if mode != "interpreter":
        raise AssertionError(f"SSD300 ran as {mode!r}: its host ops keep it "
                             f"on the interpreter")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"SSD300 loss not finite: {losses}")
    if not last < first:
        raise AssertionError(f"SSD300 loss did not fall: {timed}")
    if launches != len(buckets) * steps or not launches:
        raise AssertionError(f"momentum kernel launched {launches} times in "
                             f"{steps} steps of {len(buckets)} buckets")
    return result, scope, batch


def _compare(name, card, host, bitwise, worst):
    """card (a tensor or SeqTensor) against host: bitwise, or within
    SSD_BOX_RTOL; the worst relative error joins `worst`."""
    from paddle_tpu_torch.core.registry import SeqTensor

    if isinstance(card, SeqTensor):
        if not torch.equal(card.lengths.cpu(), host.lengths.cpu()):
            raise AssertionError(f"{name}: lengths differ card vs host")
        card, host = card.data, host.data
    c, h = card.cpu(), host.cpu()
    if c.shape != h.shape or c.dtype != h.dtype:
        raise AssertionError(f"{name}: {tuple(c.shape)} {c.dtype} on the "
                             f"card, {tuple(h.shape)} {h.dtype} on the host")
    if bitwise:
        if not torch.equal(c, h):
            raise AssertionError(f"{name}: card and host differ")
        worst[name] = max(worst.get(name, 0.0), 0.0)
        return
    err = (c.double() - h.double()).abs()
    rel = float((err / h.double().abs().clamp_min(1e-30)).max()) \
        if c.numel() else 0.0
    worst[name] = max(worst.get(name, 0.0), rel)
    torch.testing.assert_close(c, h, rtol=SSD_BOX_RTOL, atol=0.0,
                               msg=lambda m: f"{name}: card vs host beyond "
                                             f"rtol {SSD_BOX_RTOL}: {m}")


def _ssd_ops_card_host(batch):
    """(b): the box ops within SSD_BOX_RTOL and the five host ops bitwise,
    card against host, at SSD300's full width (8,732 priors, batch 32)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor_core, registry
    from paddle_tpu_torch.core.registry import SeqTensor
    from paddle_tpu_torch.ops import detection_ops as dops

    net = build_ssd300(fluid)
    places = {"card": fluid.CUDAPlace(0), "host": fluid.CPUPlace()}
    ctx = {k: executor_core.OpContext(p) for k, p in places.items()}
    dev = {"card": torch.device("cuda"), "host": torch.device("cpu")}
    worst = {}

    def to(v, d):
        if isinstance(v, SeqTensor):
            return SeqTensor(v.data.to(d), v.lengths.to(d),
                             host_lengths=v.host_lengths)
        return v.to(d)

    def run(op_type, ins, attrs):
        outs = {}
        for k in ("card", "host"):
            moved = {slot: [to(v, dev[k]) for v in vals]
                     for slot, vals in ins.items()}
            outs[k] = registry.run_kernel(registry.lookup(op_type), ctx[k],
                                          moved, attrs)
        return outs

    def check(op_type, outs, bitwise):
        for slot, vals in outs["host"].items():
            _compare(f"{op_type}.{slot}", outs["card"][slot][0], vals[0],
                     bitwise, worst)

    # prior_box at each of the six maps, as the program's ops call it
    priors, variances = {"card": [], "host": []}, {"card": [], "host": []}
    image = torch.empty((1, 3, SSD_SIDE, SSD_SIDE))
    for op, side in zip([op for op in net["main"].global_block().ops
                         if op.type == "prior_box"], (38, 19, 10, 5, 3, 1)):
        outs = run("prior_box", {"Input": [torch.empty((1, 1, side, side))],
                                 "Image": [image]}, op.attrs)
        check("prior_box", outs, bitwise=False)
        for k in outs:
            priors[k].append(outs[k]["Boxes"][0].reshape(-1, 4))
            variances[k].append(outs[k]["Variances"][0].reshape(-1, 4))
    prior = torch.cat(priors["host"])
    pvar = torch.cat(variances["host"])
    lens = np.asarray(batch["lengths"], np.int32)

    def seq(a):
        return SeqTensor(torch.from_numpy(a), torch.from_numpy(lens),
                         host_lengths=lens)

    gt_box, gt_label = seq(batch["gt_box"]), seq(batch["gt_label"])
    outs = run("iou_similarity", {"X": [gt_box], "Y": [prior]}, {})
    check("iou_similarity", outs, bitwise=False)
    iou = outs["host"]["Out"][0]
    outs = run("box_coder", {"PriorBox": [prior], "PriorBoxVar": [pvar],
                             "TargetBox": [gt_box.data]},
               {"code_type": "encode_center_size"})
    check("box_coder(encode)", outs, bitwise=False)
    # the five host ops on the same arrays
    outs = run("bipartite_match", {"DistMat": [iou]},
               {"match_type": "per_prediction", "dist_threshold": 0.5})
    check("bipartite_match", outs, bitwise=True)
    match = outs["host"]["ColToRowMatchIndices"][0]
    mdist = outs["host"]["ColToRowMatchDist"][0]
    gen = torch.Generator().manual_seed(SEED)
    cls_loss = torch.rand((SSD_BATCH * SSD_PRIORS, 1), generator=gen) * 3
    outs = run("mine_hard_examples", {"ClsLoss": [cls_loss],
                                      "MatchIndices": [match],
                                      "MatchDist": [mdist]},
               {"neg_pos_ratio": 3.0, "neg_dist_threshold": 0.5})
    check("mine_hard_examples", outs, bitwise=True)
    neg = outs["host"]["NegIndices"][0]
    outs = run("target_assign", {"X": [gt_label], "MatchIndices": [match],
                                 "NegIndices": [neg]}, {"mismatch_value": 0})
    check("target_assign(labels)", outs, bitwise=True)
    outs = run("target_assign", {"X": [gt_box], "MatchIndices": [match]}, {})
    check("target_assign(boxes)", outs, bitwise=True)
    target = outs["host"]["Out"][0]
    outs = run("box_coder", {"PriorBox": [prior], "PriorBoxVar": [pvar],
                             "TargetBox": [target]},
               {"code_type": "encode_center_size", "elementwise": True})
    check("box_coder(elementwise)", outs, bitwise=False)
    loc = torch.randn((SSD_BATCH, SSD_PRIORS, 4), generator=gen) * 0.5
    outs = run("box_coder", {"PriorBox": [prior], "PriorBoxVar": [pvar],
                             "TargetBox": [loc]},
               {"code_type": "decode_center_size"})
    check("box_coder(decode)", outs, bitwise=False)
    decoded = outs["host"]["OutputBox"][0]
    scores = torch.softmax(torch.randn(
        (SSD_BATCH, SSD_CLASSES, SSD_PRIORS), generator=gen) * 2, dim=1)
    dops.reset_host_stats()
    outs = run("multiclass_nms", {"BBoxes": [decoded], "Scores": [scores]},
               dict(SSD_NMS, background_label=0))
    check("multiclass_nms", outs, bitwise=True)
    nms_ms = dops.host_stats["multiclass_nms"][1] * 1e3 / 2
    det = outs["host"]["Out"][0]
    label = seq(np.concatenate([batch["gt_label"].astype(np.float32),
                                batch["gt_difficult"].astype(np.float32),
                                batch["gt_box"]], axis=1))
    outs = run("detection_map", {"DetectRes": [det], "Label": [label]},
               {"class_num": SSD_CLASSES, "overlap_threshold": 0.5,
                "evaluate_difficult": False, "ap_type": "11point"})
    check("detection_map", outs, bitwise=True)
    log(f"[detection] (b) card vs host at 8,732 priors, batch {SSD_BATCH}: "
        f"the five host ops bitwise; box ops' worst relative error "
        f"{ {k: v for k, v in worst.items() if v} } (rtol {SSD_BOX_RTOL}); "
        f"NMS of {int(det.data.shape[0])} detections {nms_ms:.1f} host ms "
        f"({SSD_CLASSES - 1} classes x {SSD_BATCH} images, top "
        f"{SSD_NMS['nms_top_k']})")
    return {"worst_rel": worst, "nms_host_ms_full_scores": nms_ms}


def _ssd_loss_card_host():
    """(b): SSD300's whole loss at SSD_PARITY_BATCH, fp32, fused momentum,
    card against host for SSD_PARITY_STEPS steps, each step from the
    host's state (its parameters and velocities put into the card's scope
    first): the host's fp32 convolutions and cuDNN's round differently,
    and training a deep net carries that apart step by step, so each step
    is compared from one state. Each image's mined negatives compared, and
    any that differ printed."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert, flags

    net = build_ssd300(fluid)
    main, startup = net["main"], net["startup"]
    batch = ssd_batch(np.random.RandomState(SEED + 21), SSD_PARITY_BATCH)
    places = {"host": fluid.CPUPlace(), "card": fluid.CUDAPlace(0)}
    scopes = {k: fluid.Scope() for k in places}
    exes = {k: fluid.Executor(p) for k, p in places.items()}
    feeds = {k: ssd_feed(fluid, batch, p) for k, p in places.items()}
    losses = {k: [] for k in places}
    secs = {k: 0.0 for k in places}
    differ = []
    with flags.flag_guard(fuse=True):
        with fluid.scope_guard(scopes["host"]):
            exes["host"].run(startup)
        for step in range(SSD_PARITY_STEPS):
            state = convert.numpy_state(scopes["host"], main)
            convert.load_numpy_state(scopes["card"], main, state,
                                     places["card"])
            negs = {}
            for k in ("host", "card"):
                with fluid.scope_guard(scopes[k]):
                    t0 = time.perf_counter()
                    loss, neg = exes[k].run(
                        main, feed=feeds[k],
                        fetch_list=[net["loss"], net["neg"]],
                        return_numpy=False)
                    losses[k].append(float(loss.reshape(-1)[0].item()))
                    secs[k] += time.perf_counter() - t0
                rows = neg.data.reshape(-1).cpu().numpy()
                ends = np.cumsum(neg.lengths.cpu().numpy())
                negs[k] = np.split(rows, ends[:-1])
            for image, (c, h) in enumerate(zip(negs["card"], negs["host"])):
                if not np.array_equal(c, h):
                    differ.append({
                        "step": step, "image": image,
                        "card_only": sorted(set(c.tolist())
                                            - set(h.tolist())),
                        "host_only": sorted(set(h.tolist())
                                            - set(c.tolist()))})
    rel = max(abs(c - h) / abs(h) for c, h in zip(losses["card"],
                                                    losses["host"]))
    log(f"[detection] (b) the loss at batch {SSD_PARITY_BATCH} fp32, each "
        f"step from the host's state: card {losses['card']} host "
        f"{losses['host']}: worst relative {rel:.3e} (rtol "
        f"{SSD_PARITY_RTOL}); {SSD_PARITY_STEPS} steps {secs['host']:.1f} s "
        f"on the host, {secs['card']:.1f} s on the card")
    if differ:
        log(f"[detection] (b) hard-negative mining picked other negatives "
            f"on the card (a last-bit difference in the loss it ranks): "
            f"{differ}")
    else:
        log("[detection] (b) every step mined the same negatives on both")
    if not rel <= SSD_PARITY_RTOL:
        raise AssertionError(f"SSD300 loss card vs host: {rel:.3e} > "
                             f"{SSD_PARITY_RTOL}")
    return {"card": losses["card"], "host": losses["host"], "worst_rel": rel,
            "negatives_differ": differ}


def _ssd_infer(train_scope, trained_batch):
    """(c): detection_output and DetectionMAP over SSD_INFER_BATCHES batches
    of SSD_BATCH with (a)'s weights; the accumulated mAP equal to the
    one-shot detection_map over the batches together."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor_core, registry
    from paddle_tpu_torch.core.registry import SeqTensor
    from paddle_tpu_torch.ops import detection_ops as dops

    net = build_ssd300(fluid, train=False)
    main, ev = net["main"], net["evaluator"]
    cur, accum = ev.get_map_var()
    place = fluid.CUDAPlace(0)
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    rs = np.random.RandomState(SEED + 22)
    batches = [trained_batch] + [ssd_batch(rs, SSD_BATCH)
                                 for _ in range(SSD_INFER_BATCHES - 1)]
    names = ("image", "gt_box", "gt_label", "gt_difficult")
    maps, dets, walls, splits = [], [], [], []
    with fluid.scope_guard(scope):
        exe.run(net["startup"])
        for p in main.global_block().all_parameters():
            scope.set_var(p.name, train_scope.find_var(p.name))
        ev.reset(exe)
        for b in batches:
            feed = ssd_feed(fluid, b, place, names)
            torch.cuda.synchronize()
            dops.reset_host_stats()
            t0 = time.perf_counter()
            d, c, a = exe.run(main, feed=feed,
                              fetch_list=[net["nmsed"], cur, accum],
                              return_numpy=False)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            splits.append(_ssd_host_split(dops, 1))
            dets.append(d)
            maps.append((float(c.reshape(-1)[0].item()),
                         float(a.reshape(-1)[0].item())))
        busy = trace_step(exe, main, feed, [net["nmsed"], cur, accum])[1]
    # the one-shot mAP over every image of the batches at once
    det = SeqTensor(torch.cat([d.data.cpu() for d in dets]),
                    torch.cat([d.lengths.cpu() for d in dets]))
    rows = np.concatenate([np.concatenate(
        [b["gt_label"].astype(np.float32), b["gt_difficult"].astype(
            np.float32), b["gt_box"]], axis=1) for b in batches])
    lens = np.concatenate([b["lengths"] for b in batches]).astype(np.int32)
    once = registry.run_kernel(
        registry.lookup("detection_map"),
        executor_core.OpContext(fluid.CPUPlace()),
        {"DetectRes": [det], "Label": [SeqTensor(torch.from_numpy(rows),
                                                 torch.from_numpy(lens))]},
        {"class_num": SSD_CLASSES, "overlap_threshold": 0.5,
         "evaluate_difficult": False, "ap_type": "11point"})["MAP"][0]
    once = float(once.reshape(-1)[0])
    per_image = [float((d.data[:, 0] >= 0).sum().item()) / SSD_BATCH
                 for d in dets]
    log(f"[detection] (c) detection_output ({SSD_NMS}) and DetectionMAP "
        f"(11point, overlap 0.5, difficult left out) over "
        f"{len(batches)} batches of {SSD_BATCH}: ms a batch {walls} "
        f"(the card's forward busy {busy:.2f} ms in a traced batch; host ops "
        f"[host ms, wait ms] {splits}); detections an image {per_image}; "
        f"mAP (batch, accumulated) {maps}; one-shot over both {once}")
    if maps[-1][1] != once:
        raise AssertionError(f"accumulated mAP {maps[-1][1]} != one-shot "
                             f"{once}")
    return {"ms_a_batch": walls, "forward_busy_ms": busy,
            "host_ops_ms": splits, "detections_an_image": per_image,
            "map": maps, "one_shot_map": once}


def _roi_pool_card_host():
    """(d): roi_pool at Fast R-CNN's VGG-16 widths, forward and gradient
    card against host bitwise; ms of each on the card."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor_core, registry

    rs = np.random.RandomState(SEED + 23)
    n, c, h, w = ROI_X
    x = torch.relu(torch.from_numpy(rs.randn(*ROI_X).astype(np.float32)))
    side_h, side_w = h / ROI_SCALE, w / ROI_SCALE
    rois = []
    for b in range(n):
        for _ in range(ROI_PER_IMAGE):
            bw, bh = rs.uniform(16, side_w * 0.7), rs.uniform(16, side_h * 0.7)
            x0 = rs.uniform(-0.15 * side_w, side_w - 0.5 * bw)
            y0 = rs.uniform(-0.15 * side_h, side_h - 0.5 * bh)
            rois.append([b, x0, y0, x0 + bw, y0 + bh])
    rois = torch.from_numpy(np.asarray(rois, np.float32))
    crossing = int(((rois[:, 1] < 0) | (rois[:, 2] < 0)
                    | (rois[:, 3] >= side_w) | (rois[:, 4] >= side_h)).sum())
    g = torch.from_numpy(rs.randn(n * ROI_PER_IMAGE, c, ROI_BINS,
                                  ROI_BINS).astype(np.float32))
    attrs = {"pooled_height": ROI_BINS, "pooled_width": ROI_BINS,
             "spatial_scale": ROI_SCALE}
    fwd, bwd = registry.lookup("roi_pool"), registry.lookup("roi_pool_grad")
    res, ms = {}, {}
    for k, place in (("host", fluid.CPUPlace()), ("card", fluid.CUDAPlace(0))):
        ctx = executor_core.OpContext(place)
        d = ctx.device
        xi, ri, gi = x.to(d), rois.to(d), g.to(d)
        t0 = time.perf_counter()
        o = registry.run_kernel(fwd, ctx, {"X": [xi], "ROIs": [ri]},
                                attrs)["Out"][0]
        gx = registry.run_kernel(bwd, ctx, {"X": [xi], "ROIs": [ri],
                                            "Out@GRAD": [gi]},
                                 attrs)["X@GRAD"][0]
        res[k] = (o.cpu(), gx.cpu())
        if k == "host":
            ms["host_s"] = time.perf_counter() - t0
            continue
        for name, fn in (("forward", lambda: registry.run_kernel(
                fwd, ctx, {"X": [xi], "ROIs": [ri]}, attrs)),
                         ("backward", lambda: registry.run_kernel(
                             bwd, ctx, {"X": [xi], "ROIs": [ri],
                                        "Out@GRAD": [gi]}, attrs))):
            times = []
            for _ in range(DET_REPS):
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                fn()
                e1.record()
                e1.synchronize()
                times.append(e0.elapsed_time(e1))
            ms[name] = statistics.median(times)
    ties = int((res["host"][0] == 0).sum())
    log(f"[detection] (d) roi_pool X {list(ROI_X)} ReLU'd, "
        f"{n * ROI_PER_IMAGE} ROIs ({crossing} crossing the map's edge), "
        f"1/16, {ROI_BINS}x{ROI_BINS}: {ties} of {res['host'][0].numel()} "
        f"bins' max is a tied 0; forward {ms['forward']:.3f} ms, backward "
        f"(the derived grad: forward again, then the tie-split backward) "
        f"{ms['backward']:.3f} ms on the card (median of {DET_REPS}); the "
        f"host's pair {ms['host_s']:.1f} s")
    for i, what in enumerate(("forward", "gradient")):
        if not torch.equal(res["card"][i], res["host"][i]):
            raise AssertionError(f"roi_pool {what}: card and host differ")
    # the layer's program on the card: its first step eager, its second
    # captured; sum(roi_pool(x) * g) gives x's gradient for cotangent g
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        xv = L.data(name="x", shape=list(ROI_X[1:]), dtype="float32")
        xv.stop_gradient = False
        rv = L.data(name="rois", shape=[5], dtype="float32")
        gv = L.data(name="g", shape=[c, ROI_BINS, ROI_BINS],
                    dtype="float32")
        o = L.roi_pool(xv, rv, ROI_BINS, ROI_BINS, ROI_SCALE)
        fluid.backward.append_backward(L.reduce_sum(L.elementwise_mul(o, gv)))
    exe = fluid.Executor(fluid.CUDAPlace(0))
    feed = {"x": x.cuda(), "rois": rois.cuda(), "g": g.cuda()}
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        for step in range(2):
            got = exe.run(main, feed=feed, fetch_list=[o, "x@GRAD"],
                          return_numpy=False)
            for i, what in enumerate(("forward", "gradient")):
                if not torch.equal(got[i].cpu(), res["host"][i]):
                    raise AssertionError(
                        f"roi_pool's program, step {step} "
                        f"({exe.step_mode(main)}): {what} differs from the "
                        f"host's kernel")
        mode = exe.step_mode(main)
    log(f"[detection] (d) layers.roi_pool's program on the card, its forward "
        f"and x's gradient bitwise the host's, eager and then as {mode!r}")
    if mode != "graph":
        raise AssertionError(f"roi_pool's program ran as {mode!r}")
    return {"forward_ms": ms["forward"], "backward_ms": ms["backward"],
            "rois_crossing_edge": crossing, "tied_zero_bins": ties,
            "program_mode": mode}


def _native_predictor():
    """(e): the MNIST conv net trained on the card, saved, and served by
    the native C++ predictor on the host, against the card's Executor on
    the saved model."""
    import tempfile

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import mnist
    from paddle_tpu_torch.native.infer import NativePredictor

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[1, 28, 28],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        probs = mnist.cnn_model(img)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(input=probs,
                                                             label=label))
        fluid.optimizer.AdamOptimizer(learning_rate=1e-3).minimize(loss)
    main.random_seed = startup.random_seed = SEED
    rs = np.random.RandomState(SEED + 24)
    place = fluid.CUDAPlace(0)
    exe = fluid.Executor(place)
    root = tempfile.mkdtemp(prefix="chip_smoke_native_")
    try:
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            for _ in range(NATIVE_STEPS):
                exe.run(main, feed={
                    "img": rs.rand(NATIVE_BATCH, 1, 28, 28).astype(
                        np.float32),
                    "label": rs.randint(0, 10, (NATIVE_BATCH, 1)).astype(
                        np.int64)}, fetch_list=[loss])
            fluid.io.save_inference_model(root, ["img"], [probs], exe,
                                          main_program=main)
        x = rs.rand(NATIVE_BATCH, 1, 28, 28).astype(np.float32)
        with fluid.scope_guard(fluid.Scope()):
            prog, feeds, fetches = fluid.io.load_inference_model(root, exe)
            want = exe.run(prog, feed={feeds[0]: x}, fetch_list=fetches)[0]
        pred = NativePredictor(root)
        got = pred.run({"img": x})[0]
        times = []
        for _ in range(DET_REPS):
            t0 = time.perf_counter()
            pred.run({"img": x})
            times.append((time.perf_counter() - t0) * 1e3)
        pred.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    host_ms = statistics.median(times)
    log(f"[detection] (e) the MNIST conv net, {NATIVE_STEPS} steps on the "
        f"card, saved; the native predictor (C++, the host) against the "
        f"card's Executor on the saved model: worst relative {rel:.3e} "
        f"(rtol {NATIVE_RTOL}); {host_ms:.2f} host ms a batch of "
        f"{NATIVE_BATCH} (median of {DET_REPS})")
    np.testing.assert_allclose(got, want, rtol=NATIVE_RTOL, atol=0)
    return {"worst_rel": rel, "host_ms_a_batch": host_ms}


def phase_detection(card_line):
    """Detection and the native runtimes on the card (module docstring,
    phase 13): (a)-(e)."""
    t0 = time.perf_counter()
    result = {}
    result["ssd300"], scope, batch = _ssd_train(card_line)
    _release()
    result["card_host"] = _ssd_ops_card_host(batch)
    result["loss_card_host"] = _ssd_loss_card_host()
    _release()
    result["inference"] = _ssd_infer(scope, batch)
    del scope
    _release()
    result["roi_pool"] = _roi_pool_card_host()
    _release()
    result["native"] = _native_predictor()
    result["seconds"] = time.perf_counter() - t0
    log(f"[detection] phase {result['seconds']:.1f} s; {card_line}")
    return result


def _ring_inputs(gen_seed, dtype=torch.float32):
    """The full-width q, k, v [B, H, S, D] (and a cotangent) on the card,
    drawn from one seeded generator: every rank draws the same tensors and
    keeps its sequence shard."""
    B, H, S, _, D = FLASH_FULL
    gen = torch.Generator(device="cuda").manual_seed(gen_seed)
    return [torch.randn(B, H, S, D, generator=gen, device="cuda").to(dtype)
            for _ in range(4)]


def ring_child(spec_path, rank):
    """One rank of phase ring (b): joins a RING_WORLD-rank gloo group on
    card 0 (`--ring-child SPEC RANK`), and on the mesh {"sp": W} runs
    ring_flash_attention at full width, bf16 and f32, causal and not (a
    warm run, then the counted and timed one), and ring_attention f32 with
    its q/k/v grads; saves its output shards and grads and writes its
    counts and hop times as JSON."""
    from paddle_tpu_torch.ops import collective_ops
    from paddle_tpu_torch.parallel import distributed, flash, make_mesh, ring

    with open(spec_path) as f:
        spec = json.load(f)
    world, out_dir = spec["world"], spec["out"]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize("file://" + spec["rendezvous"], world, rank,
                           local_device_ids=[0], backend="gloo")
    try:
        mesh = make_mesh({"sp": world})
        S = FLASH_FULL[2] // world
        sl = slice(rank * S, (rank + 1) * S)
        q, k, v, dout = _ring_inputs(SEED + 31)
        res = {"flash": {}, "plain": {}}
        for dtype in (torch.bfloat16, torch.float32):
            qs, ks, vs = (t.to(dtype)[:, :, sl].contiguous()
                          for t in (q, k, v))
            for causal in (False, True):
                ring.ring_flash_attention(qs, ks, vs, mesh, causal=causal)
                torch.cuda.synchronize()
                flash.reset_launch_counts()
                collective_ops.reset_launch_counts()
                hops = []
                t0 = time.perf_counter()
                out = ring.ring_flash_attention(qs, ks, vs, mesh,
                                                causal=causal, timings=hops)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                key = f"{str(dtype).split('.')[1]}_{causal}"
                res["flash"][key] = {
                    "launches": flash.flash_fwd.launches,
                    "sm90_launches": flash.flash_fwd.sm90_launches,
                    "tf32_launches": flash.flash_fwd.tf32_launches,
                    "split_launches": flash.split_tf32.launches,
                    "permutes": collective_ops.launch.launches,
                    "host_staged_bytes":
                        collective_ops.permute.host_staged_bytes,
                    "hops": hops, "wall_ms": wall * 1e3}
                torch.save(out.cpu(), os.path.join(
                    out_dir, f"flash_{key}.{rank}.pt"))
        for causal in (False, True):
            leaves = [t[:, :, sl].clone().requires_grad_(True)
                      for t in (q, k, v)]
            collective_ops.reset_launch_counts()
            t0 = time.perf_counter()
            out = ring.ring_attention(*leaves, mesh, causal=causal)
            (out * dout[:, :, sl]).sum().backward()
            torch.cuda.synchronize()
            res["plain"][str(causal)] = {
                "ms": (time.perf_counter() - t0) * 1e3,
                "permutes": collective_ops.launch.launches}
            torch.save([out.detach().cpu()] + [t.grad.cpu() for t in leaves],
                        os.path.join(out_dir, f"plain_{causal}.{rank}.pt"))
            del out, leaves
        with open(os.path.join(out_dir, f"result.{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        torch.distributed.destroy_process_group()


def _ring_one_rank():
    """(a) one rank: a one-rank sp group (gloo, card 0); the ring is one
    hop and equals flash_fwd over the whole sequence bitwise. Returns the
    ring's own launches by dtype."""
    import tempfile

    from paddle_tpu_torch.parallel import distributed, flash, make_mesh, ring

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ring1_")
    distributed.initialize("file://" + os.path.join(tmp, "rendezvous"), 1,
                           0, local_device_ids=[0], backend="gloo")
    launches = {}
    try:
        mesh = make_mesh({"sp": 1})
        q, k, v, _ = _ring_inputs(SEED + 31)
        D = q.shape[-1]
        for dtype in (torch.bfloat16, torch.float32):
            qd, kd, vd = (t.to(dtype) for t in (q, k, v))
            n = 0
            for causal in (False, True):
                flash.reset_launch_counts()
                got = ring.ring_flash_attention(qd, kd, vd, mesh,
                                                causal=causal)
                torch.cuda.synchronize()
                n += flash.flash_fwd.launches
                want, _ = flash.flash_fwd(qd, kd, vd, D ** -0.5, causal)
                bits = torch.int16 if dtype == torch.bfloat16 \
                    else torch.int32
                if got.dtype != dtype or not torch.equal(got.view(bits),
                                                         want.view(bits)):
                    raise AssertionError(
                        f"[ring] (a) one rank {dtype} causal={causal}: not "
                        f"bitwise flash_fwd over the sequence")
            launches[str(dtype).split(".")[1]] = n
    finally:
        torch.distributed.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[ring] (a) one-rank sp group at {list(FLASH_FULL[:3])}+"
        f"[{FLASH_FULL[4]}]: ring_flash_attention == flash_fwd over the "
        f"whole sequence bitwise, bf16 and f32, causal and not (one hop; "
        f"kernel launches {launches})")
    return launches


def _dense_attention(q, k, v, dout, causal, heads=8):
    """Plain attention over the whole sequence in float64, a few heads at
    a time: (out, dq, dk, dv), or (out,) where `dout` is None."""
    grads = dout is not None
    outs = [[], [], [], []] if grads else [[]]
    S = q.shape[2]
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    for h in range(0, q.shape[1], heads):
        with torch.set_grad_enabled(grads):
            t = [x[:, h:h + heads].double().requires_grad_(grads)
                 for x in (q, k, v)]
            s = t[0] @ t[1].transpose(-1, -2) / q.shape[-1] ** 0.5
            if causal:
                s = s.masked_fill(~mask, float("-inf"))
            out = torch.softmax(s, -1) @ t[2]
        if grads:
            (out * dout[:, h:h + heads].double()).sum().backward()
        for lst, x in zip(outs, [out.detach()] + [x.grad for x in t]):
            lst.append(x.float())
        del s, out, t
    return [torch.cat(x, 1) for x in outs]


def phase_ring(card):
    """Ring attention on the card (module docstring, phase 15): (a) one
    rank, bitwise; (b) RING_WORLD gloo ranks sharing the card, each hop
    the flash kernel, against flash_fwd over the whole sequence, and the
    plain ring's forward and grads against plain attention. Returns the
    numbers and each flash kernel's launches on the ring path."""
    import tempfile

    from paddle_tpu_torch.parallel import flash

    result = {"one_rank_launches": _ring_one_rank()}
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ring_")
    spec = os.path.join(tmp, "spec.json")
    with open(spec, "w") as f:
        json.dump({"world": RING_WORLD, "out": tmp,
                   "rendezvous": os.path.join(tmp, "rendezvous")}, f)
    procs = []
    t0 = time.perf_counter()
    try:
        for r in range(RING_WORLD):
            path = os.path.join(OUT_DIR, f"ring_r{r}.log")
            with open(path, "w") as out:
                procs.append((subprocess.Popen(
                    [sys.executable, os.path.join(here, "chip_smoke.py"),
                     "--ring-child", spec, str(r)], cwd=here, stdout=out,
                    stderr=subprocess.STDOUT), path))
        deadline = time.monotonic() + RING_CHILD_S
        for p, path in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
            if p.returncode != 0:
                raise AssertionError(f"[ring] rank exited {p.returncode} "
                                     f"(see {path})")
        children_s = time.perf_counter() - t0
        ranks = []
        for r in range(RING_WORLD):
            with open(os.path.join(tmp, f"result.{r}.json")) as f:
                ranks.append(json.load(f))
        q, k, v, dout = _ring_inputs(SEED + 31)
        D = q.shape[-1]
        flash_rows = {}
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            for causal in (False, True):
                key = f"{name}_{causal}"
                got = torch.cat([torch.load(os.path.join(
                    tmp, f"flash_{key}.{r}.pt")) for r in range(RING_WORLD)],
                    dim=2).cuda()
                qd, kd, vd = (t.to(dtype) for t in (q, k, v))
                want, _ = flash.flash_fwd(qd, kd, vd, D ** -0.5, causal)
                err = (got.float() - want.float()).abs().max().item()
                torch.testing.assert_close(
                    got, want, **RING_TOL[dtype],
                    msg=f"[ring] (b) {key}: gathered ring output vs "
                        f"flash_fwd over the whole sequence")
                # the hops' kernel (at [1, H, S/n, D], full and diagonal)
                # held against plain attention in float64 on the same
                # (dtype-rounded) inputs, at the flash phase's bound
                plain_out = _dense_attention(qd, kd, vd, None, causal)[0]
                plain_err = (got.float() - plain_out).abs().max().item()
                torch.testing.assert_close(
                    got.float(), plain_out, **FLASH_TOL[dtype],
                    msg=f"[ring] (b) {key}: gathered ring output vs plain "
                        f"attention (float64)")
                del plain_out
                per_rank = [rk["flash"][key] for rk in ranks]
                launches = [x["launches"] for x in per_rank]
                want_l = ([i + 1 for i in range(RING_WORLD)] if causal
                          else [RING_WORLD] * RING_WORLD)
                if launches != want_l:
                    raise AssertionError(f"[ring] (b) {key}: flash launches "
                                         f"by rank {launches}, not {want_l}")
                which = "sm90_launches" if dtype == torch.bfloat16 \
                    else "tf32_launches"
                if [x[which] for x in per_rank] != want_l:
                    raise AssertionError(f"[ring] (b) {key}: the {which} "
                                         f"counts differ")
                hops = [h for x in per_rank for h in x["hops"]]
                kern = [h["kernel_ms"] for h in hops if h["case"] != "skip"]
                perm = [h["permute_ms"] for h in hops
                        if h["hop"] < RING_WORLD - 1]
                row = flash_rows[key] = {
                    "max_abs_err": err, "max_abs_err_plain": plain_err,
                    "launches_by_rank": launches,
                    "launches": sum(launches),
                    "split_launches": sum(x["split_launches"]
                                          for x in per_rank),
                    "permutes_by_rank": [x["permutes"] for x in per_rank],
                    "host_staged_bytes": sum(x["host_staged_bytes"]
                                             for x in per_rank),
                    "hop_kernel_ms_median": statistics.median(kern),
                    "hop_kernel_ms": [round(x, 4) for x in kern],
                    "permute_ms_median": statistics.median(perm),
                    "ring_wall_ms_by_rank": [round(x["wall_ms"], 2)
                                             for x in per_rank]}
                log(f"[ring] (b) sp={RING_WORLD} gloo ranks on one card, "
                    f"{name} causal={causal}: gathered output == flash_fwd "
                    f"over the whole sequence within {RING_TOL[dtype]} "
                    f"(max |err| {err:.3e}), and == plain attention "
                    f"(float64) within {FLASH_TOL[dtype]} (max |err| "
                    f"{plain_err:.3e}); flash launches by rank "
                    f"{launches} ({row['launches']}); a hop's kernel "
                    f"{row['hop_kernel_ms_median']:.4f} ms median of "
                    f"{len(kern)}, a rotation's permute (k or v over the "
                    f"pinned host wire) {row['permute_ms_median']:.3f} ms "
                    f"median; {row['host_staged_bytes']} bytes staged; a "
                    f"rank's ring {row['ring_wall_ms_by_rank']} ms")
        result["flash"] = flash_rows
        plain = {}
        for causal in (False, True):
            got = [torch.load(os.path.join(tmp, f"plain_{causal}.{r}.pt"))
                   for r in range(RING_WORLD)]
            got = [torch.cat([g[i] for g in got], dim=2).cuda()
                   for i in range(4)]
            want = _dense_attention(q, k, v, dout, causal)
            errs = {}
            for n, a, b in zip(("out", "dq", "dk", "dv"), got, want):
                errs[n] = (a - b).abs().max().item()
                torch.testing.assert_close(
                    a, b, **RING_TOL[torch.float32],
                    msg=f"[ring] (b) ring_attention causal={causal} {n} vs "
                        f"plain attention")
            plain[str(causal)] = {
                "max_abs_err": errs,
                "ms_by_rank": [round(rk["plain"][str(causal)]["ms"], 2)
                               for rk in ranks],
                "permutes_by_rank": [rk["plain"][str(causal)]["permutes"]
                                     for rk in ranks]}
            log(f"[ring] (b) ring_attention f32 causal={causal}: forward "
                f"and q/k/v grads == plain attention (float64) within "
                f"{RING_TOL[torch.float32]}, max |err| {errs}; forward + "
                f"backward {plain[str(causal)]['ms_by_rank']} ms by rank, "
                f"permutes {plain[str(causal)]['permutes_by_rank']}")
        result["plain"] = plain
        result["children_s"] = children_s
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    causal_n = flash_rows["bfloat16_True"]["launches"]
    full_n = flash_rows["bfloat16_False"]["launches"]
    if (causal_n, full_n) != (10, 16):
        raise AssertionError(f"[ring] flash launches over the ring "
                             f"{causal_n} causal, {full_n} not")
    result["launches"] = {
        name: {"ring_sp4_causal": flash_rows[f"{name}_True"]["launches"],
               "ring_sp4_full": flash_rows[f"{name}_False"]["launches"],
               "ring_one_rank": result["one_rank_launches"][name]}
        for name in ("bfloat16", "float32")}
    result["split_launches"] = sum(
        flash_rows[f"float32_{c}"]["split_launches"] for c in (False, True))
    return result


def _pipe_feeds():
    rs = np.random.RandomState(SEED + 37)
    return [{"data_u8": torch.from_numpy(rs.randint(
                 0, 256, (HEADLINE_BATCH, 224, 224, 3),
                 dtype=np.uint8)).cuda(),
             "label": torch.from_numpy(rs.randint(
                 0, 1000, (HEADLINE_BATCH, 1)).astype(np.int32)).cuda()}
            for _ in range(PIPE_STEPS)]


def _pipe_run(n_stages, feeds, init):
    """The headline program through PipelineRunner at n_stages, PIPE_MICRO
    microbatches, FLAGS_fuse and bf16 AMP, from `init` (None: its own
    startup, returned): the losses, the state, the timed steps' img/s,
    the plan's numbers, the bubbles, peak memory, the momentum kernel's
    launches and the fused buckets of the optimizer cells."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, convert, flags, fusion
    from paddle_tpu_torch.fusion import kernels as fk
    from paddle_tpu_torch.parallel import pipeline as pl

    main, startup, loss, _ = build_headline(plan=False)
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    if init is None:
        init = convert.numpy_state(scope, main)
    else:
        convert.load_numpy_state(scope, main, init, fluid.CUDAPlace(0))
    t0 = time.perf_counter()
    runner = pl.PipelineRunner(main, n_stages, loss_name=loss.name,
                               feed_names=["data_u8", "label"],
                               n_microbatches=PIPE_MICRO, scope=scope,
                               batch_size=HEADLINE_BATCH // PIPE_MICRO)
    build_s = time.perf_counter() - t0
    buckets = 0
    for (_, phase), sp in runner.stages.items():
        if phase != pl.PHASE_OPT:
            continue
        _, fplan = fusion.apply(
            sp.program, feed_names=sp.data_feeds + sp.local_in + [
                n + pl.PP_IN_SUFFIX for n in sp.boundary_in],
            fetch_names=sp.fetch_names)
        buckets += sum(b["opt"] == "momentum" for b in fplan.buckets)
    _release()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_launch_counts()
    losses, times, reps = [], [], []
    with flags.flag_guard(fuse=True), amp.auto_cast():
        for f in feeds:
            t1 = time.perf_counter()
            rep = runner.run(f)
            times.append(time.perf_counter() - t1)
            losses.append(rep["loss"].reshape(-1)[0])
            reps.append(rep)
    launches = fk.momentum_bucket.launches
    modes = sorted({runner._exe.step_mode(sp.program)
                    for sp in runner.stages.values()})
    captures = [len(runner._exe.captured_steps(sp.program, scope))
                for sp in runner.stages.values()]
    rep = reps[-1]
    out = {
        "losses": [float(x) for x in losses],
        "loss_bits": [np.float32(x).tobytes().hex() for x in losses],
        "state": convert.numpy_state(scope, main),
        "images_per_sec": HEADLINE_BATCH * (len(times) - 2)
                          / sum(times[2:]),
        "step_s": [round(t, 4) for t in times], "build_s": build_s,
        "balance": runner.plan.balance(),
        "cut_bytes": runner.plan.cut_bytes,
        "stage_flops": runner.plan.stage_flops,
        "cells": len(runner.stages),
        "bubble_fraction": rep["bubble_fraction"],
        "bubble_measured": rep["bubble_measured"],
        "bubble_analytic": rep["bubble_analytic"],
        "makespan_ms": rep["makespan_s"] * 1e3,
        "peak_bytes": torch.cuda.max_memory_allocated() - base,
        "momentum_launches": launches, "opt_buckets": buckets,
        "modes": modes, "captures": captures}
    del runner, exe, scope
    _release()
    return out, init


_PIPE_CLI = {}


def start_pipe_cli():
    """Start phase pipeline's `python -m paddle_tpu_torch analyze pipeline
    --selftest` on the card in the background, once (its output in
    chiprun_out/pipeline_cli.{out,err}). The whole script starts it beside
    phase ring, whose rank processes spend their first seconds importing,
    and phase pipeline waits for it before its own first step, so that it
    overlaps none of that phase's timed steps. A selftest still running
    when the script exits is killed."""
    if _PIPE_CLI:
        return
    os.makedirs(OUT_DIR, exist_ok=True)
    here = os.path.dirname(os.path.abspath(__file__))
    files = [open(os.path.join(OUT_DIR, f"pipeline_cli.{x}"), "w+")
             for x in ("out", "err")]
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "analyze", "pipeline",
         "--selftest", "--stages", str(PIPE_STAGES), "--microbatches",
         str(PIPE_MICRO)], cwd=here, stdout=files[0], stderr=files[1])
    _PIPE_CLI.update(files=files, t0=time.perf_counter(), proc=proc)
    atexit.register(_stop_pipe_cli)


def _stop_pipe_cli():
    proc = _PIPE_CLI.get("proc")
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait()


def wait_pipe_cli():
    """Wait for the selftest (starting it if it is not running): (its rc,
    stdout, stderr, seconds from its start, seconds waited here)."""
    start_pipe_cli()
    proc, t1 = _PIPE_CLI["proc"], time.perf_counter()
    try:
        proc.wait(timeout=max(PIPE_CLI_S - (t1 - _PIPE_CLI["t0"]), 1))
    except subprocess.TimeoutExpired:
        _stop_pipe_cli()
        raise AssertionError(f"[pipeline] the CLI selftest ran over "
                             f"{PIPE_CLI_S} s")
    t2 = time.perf_counter()
    text = []
    for f in _PIPE_CLI["files"]:
        f.seek(0)
        text.append(f.read())
        f.close()
    return proc.returncode, text[0], text[1], t2 - _PIPE_CLI["t0"], t2 - t1


def phase_pipeline(card, headline_ips):
    """Pipeline parallelism on the card (module docstring, phase 16)."""
    cli_rc, cli_out, cli_err, cli_s, cli_wait = wait_pipe_cli()
    log(f"[pipeline] python -m paddle_tpu_torch analyze pipeline --selftest "
        f"--stages {PIPE_STAGES} --microbatches {PIPE_MICRO} (on the card, "
        f"started beside phase ring): rc {cli_rc} in {cli_s:.1f} s, "
        f"{cli_wait:.1f} s of it waited for here: "
        + (cli_out.strip().splitlines()[-1] if cli_out.strip()
           else cli_err[-500:]))
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        feeds = _pipe_feeds()
        one, init = _pipe_run(1, feeds, None)
        many, _ = _pipe_run(PIPE_STAGES, feeds, init)
    finally:
        torch.backends.cudnn.deterministic = prev
    del init, feeds
    bad = [n for n in one["state"]
           if not np.array_equal(one["state"][n], many["state"][n])]
    equal = one["loss_bits"] == many["loss_bits"] and not bad \
        and sorted(one["state"]) == sorted(many["state"])
    n_state = len(one["state"])
    analytic = (PIPE_STAGES - 1) / (PIPE_MICRO + PIPE_STAGES - 1)
    for r, p in ((one, 1), (many, PIPE_STAGES)):
        log(f"[pipeline] headline (bf16 AMP, fused Momentum, batch "
            f"{HEADLINE_BATCH}) in {p} stage(s) x {PIPE_MICRO} microbatches "
            f"of {HEADLINE_BATCH // PIPE_MICRO}: {r['cells']} cells, modes "
            f"{r['modes']}, captures by cell {r['captures']}; losses "
            f"{r['losses']}; {r['images_per_sec']:.2f} img/s over steps 3-"
            f"{PIPE_STEPS} (headline {headline_ips} img/s; steps "
            f"{r['step_s']} s); plan balance {r['balance']:.4f}, cut "
            f"{r['cut_bytes'] / 1e6:.2f} MB a microbatch, stage GFLOP "
            f"{[round(f / 1e9, 2) for f in r['stage_flops']]}; bubble "
            f"structural {r['bubble_fraction']:.6f} (analytic "
            f"{r['bubble_analytic']:.6f}), measured "
            f"{r['bubble_measured']:.4f} (makespan {r['makespan_ms']:.2f} "
            f"ms); peak memory above the state "
            f"{r['peak_bytes'] / 2**30:.2f} GiB; momentum_bucket launches "
            f"{r['momentum_launches']} = {r['opt_buckets']} fused buckets "
            f"x {PIPE_STEPS} steps")
    log(f"[pipeline] {PIPE_STAGES} stages vs 1: losses and all {n_state} "
        f"persistables {'bitwise equal' if equal else 'DIFFER: ' + str(bad[:5])}")
    problems = []
    if not equal:
        problems.append("not bitwise")
    if abs(many["bubble_fraction"] - analytic) > 1e-12:
        problems.append(f"structural bubble {many['bubble_fraction']}")
    for r in (one, many):
        if r["momentum_launches"] != r["opt_buckets"] * PIPE_STEPS \
                or not r["momentum_launches"]:
            problems.append(f"momentum launches {r['momentum_launches']}")
        if r["modes"] != ["graph"] or set(r["captures"]) != {1}:
            problems.append(f"cells {r['modes']} {r['captures']}")
    if cli_rc != 0:
        problems.append(f"selftest rc {cli_rc}: {cli_err[-2000:]}")
    if problems:
        raise AssertionError(f"[pipeline] failed: {problems}")
    for r in (one, many):
        del r["state"], r["loss_bits"]
    return {"one_stage": one, "stages": many, "bitwise": equal,
            "persistables": n_state, "headline_images_per_sec": headline_ips,
            "ratio_to_one_stage": many["images_per_sec"]
                                  / one["images_per_sec"],
            "cli_selftest_rc": cli_rc, "cli_selftest_s": cli_s,
            "cli_selftest_waited_s": cli_wait}


def _elastic_feed(step):
    """Global step `step`'s batch of the elastic drill, the same on every
    rank and world (a rank keeps its rows)."""
    rs = np.random.RandomState(SEED + 41 + step)
    return {"data_u8": rs.randint(0, 256, (HEADLINE_BATCH, 224, 224, 3),
                                  dtype=np.uint8),
            "label": rs.randint(0, 1000, (HEADLINE_BATCH, 1)).astype(
                np.int32)}


def _state_digest(scope, main):
    """blake2b over every checkpoint var of `main` in `scope` (the
    persistables a resilience checkpoint holds: names, dtypes, shapes and
    bytes, in name order): equal digests are equal states bit for bit."""
    import hashlib

    from paddle_tpu_torch import convert
    from paddle_tpu_torch import io as fio

    keep = {v.name for v in main.list_vars() if fio._is_checkpoint_var(v)}
    state = {n: a for n, a in convert.numpy_state(scope, main).items()
             if n in keep}
    h = hashlib.blake2b(digest_size=16)
    for n in sorted(state):
        a = np.ascontiguousarray(state[n])
        h.update(f"{n}|{a.dtype.str}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def elastic_child(spec_path, name, joiner):
    """`python3 chip_smoke.py --elastic-child SPEC NAME [--joiner]`: one
    worker of phase elastic. A card rank on card 0 (a gloo group formed
    on it by its ElasticController, TF32 off) that trains the headline
    through ParallelExecutor.run under a ResilientRunner, with the plan
    store, journal and obs identity of its own, the compile service and
    the collector of the spec; w1 takes worker_preempt after
    ELASTIC_PREEMPT_AT, w0 worker_join after ELASTIC_JOIN_AT (the joiner
    is this command with --joiner), and every incumbent then waits for the
    joiner and polls. Its output goes to chiprun_out/elastic_<name>.log;
    it writes <out>/<name>[_joiner].json: per step its world, loss, ms,
    the gloo wire's seconds and bytes and the state's digest; the resizes'
    parts and the digest after each adopt; the compile cache's counters
    of each ParallelExecutor; peak memory; momentum launches."""
    tag = name + ("_joiner" if joiner else "")
    os.makedirs(OUT_DIR, exist_ok=True)
    log_fd = os.open(os.path.join(OUT_DIR, f"elastic_{tag}.log"),
                     os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(log_fd, 1)
    os.dup2(log_fd, 2)
    import faulthandler

    faulthandler.dump_traceback_later(ELASTIC_CHILD_S, exit=True)
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, convert, cuda_build, flags
    from paddle_tpu_torch.fusion import kernels as fk
    from paddle_tpu_torch.ops import collective_ops
    from paddle_tpu_torch.parallel import MeshSpec
    from paddle_tpu_torch.parallel.elastic import (ConstantRescale,
                                                   ElasticConfig,
                                                   ElasticController,
                                                   Resized)
    from paddle_tpu_torch.resilience import (Preempted, ResilienceConfig,
                                             ResilientRunner, chaos)

    t_start = time.perf_counter()
    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.kernels()  # built by the parent: loaded here
    place = fluid.CUDAPlace(0)
    main, startup, loss, _ = build_headline(plan=False)
    scope = fluid.Scope()
    fluid.Executor(place).run(startup, scope=scope)
    deadline = time.monotonic() + ELASTIC_CHILD_S
    while not os.path.exists(spec["init"]):  # the parent writes it whole
        if time.monotonic() > deadline:
            raise AssertionError(f"no start state {spec['init']}")
        time.sleep(0.05)
    with np.load(spec["init"]) as data:
        convert.load_numpy_state(scope, main, dict(data), place)
    flags.set("fuse", True)
    flags.set("compile_cache_dir", os.path.join(spec["work"], f"plans_{tag}"))
    flags.set("compile_service", spec["master"])
    flags.set("obs_push", spec["collector"])
    flags.set("obs_replica", tag)
    flags.set("obs_push_interval_s", 0.5)
    flags.set("monitor_journal", os.path.join(OUT_DIR,
                                              f"elastic_{tag}.jsonl"))
    here = os.path.abspath(__file__)
    monkey = chaos.ChaosMonkey()
    if not joiner and name == "w1":
        monkey.add(chaos.Fault("worker_preempt", at=ELASTIC_PREEMPT_AT))
    if not joiner and name == "w0":
        monkey.add(chaos.Fault("worker_join", at=ELASTIC_JOIN_AT, argv=[
            sys.executable, here, "--elastic-child", spec_path, "w1",
            "--joiner"]))
    chaos.install(monkey)
    ctl = ElasticController(ElasticConfig(
        spec["master"], name=name, ttl=30.0, heartbeat_interval=0.1,
        start_world=None if joiner else ELASTIC_WORLD,
        barrier_timeout=60.0, resize_timeout=ELASTIC_CHILD_S,
        policy=ConstantRescale(), mesh_spec=MeshSpec(),
        local_device_ids=[0], backend="gloo"))
    runner = ResilientRunner(
        ResilienceConfig(checkpoint_dir=spec["checkpoint_dir"],
                         async_checkpoints=False, restore_on_start=False,
                         save_on_preempt=False, elastic=ctl),
        scope=scope, program=main, place=place)

    def make_pe():
        return fluid.ParallelExecutor(use_cuda=True, loss_name=loss.name,
                                      main_program=main)

    res = {"name": name, "joiner": joiner, "steps": [], "resizes": [],
           "left": False, "caches": [], "start_s": None}
    amp.enable("bfloat16")
    fk.reset_launch_counts()
    collective_ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    try:
        with fluid.scope_guard(scope), runner.session():
            res["start_s"] = time.perf_counter() - t_start
            if joiner:
                manifest = runner.adopt(
                    expect_mesh=MeshSpec().geometry(ctl.world_size))
                assert manifest is not None, "nothing committed to adopt"
                res["resizes"].append({
                    "world": ctl.world_size, "serial": manifest["serial"],
                    "step": manifest["step"], "parts": None,
                    "digest": _state_digest(scope, main)})
            pe, fresh = make_pe(), True
            while runner.global_step < ELASTIC_STEPS:
                s = runner.global_step
                feed = _elastic_feed(s)
                wire_s = collective_ops.launch.host_wire_s
                wire_b = collective_ops.launch.host_staged_bytes
                t0 = time.perf_counter()
                out, = runner.run_step(
                    lambda: pe.run([loss.name], feed=feed))
                ms = (time.perf_counter() - t0) * 1e3
                rec = {"step": s, "world": ctl.world_size, "ms": ms,
                       "loss": float(np.asarray(out).reshape(-1)[0]),
                       "wire_s": collective_ops.launch.host_wire_s - wire_s,
                       "wire_bytes": collective_ops.launch.host_staged_bytes
                       - wire_b, "mode": pe.step_mode(),
                       "first_after_resize": fresh}
                if fresh:
                    res["caches"].append(dict(pe.compile_cache_info()["l2"],
                                              world=ctl.world_size))
                    fresh = False
                # the state this step left (after_step changes none of it
                # unless it resizes, which the resize's record covers)
                rec["digest"] = _state_digest(scope, main)
                res["steps"].append(rec)
                try:
                    runner.after_step([out])
                    if s == ELASTIC_JOIN_AT \
                            and ctl.world_size < ELASTIC_WORLD:
                        # the joiner is on its way: wait until it joined,
                        # then take the resize at this boundary
                        deadline = time.monotonic() + ELASTIC_CHILD_S
                        while not ctl.resize_pending() or len(
                                ctl.membership()["members"]) \
                                < ELASTIC_WORLD:
                            if time.monotonic() > deadline:
                                raise AssertionError("no joiner joined")
                            time.sleep(0.02)
                        ctl.poll(runner)
                except Resized as r:
                    res["resizes"].append({
                        "world": r.world_size,
                        "serial": (r.manifest or {}).get("serial"),
                        "step": (r.manifest or {}).get("step"),
                        "parts": ctl.last_resize,
                        "digest": _state_digest(scope, main)})
                    pe, fresh = make_pe(), True
    except Preempted:
        res["left"] = True
    finally:
        amp.disable()
    from paddle_tpu_torch import monitor

    res["resize_gauge_ms"] = monitor.registry().gauge(
        "elastic_resize_duration_ms").value
    res["momentum_launches"] = fk.momentum_bucket.launches
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    res["seconds"] = time.perf_counter() - t_start
    with open(os.path.join(spec["out"], f"{tag}.json"), "w") as f:
        json.dump(res, f)
    for p in monkey.spawned:
        try:
            p.wait(timeout=ELASTIC_CHILD_S)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            raise
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def _elastic_reference(main, startup, loss, init):
    """The drill's steps through a ParallelExecutor with no group (one
    rank) from `init`: the losses."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, convert, flags

    scope = fluid.Scope()
    convert.load_numpy_state(scope, main, init, fluid.CUDAPlace(0))
    losses = []
    amp.enable("bfloat16")
    try:
        with flags.flag_guard(fuse=True), fluid.scope_guard(scope):
            pe = fluid.ParallelExecutor(use_cuda=True, loss_name=loss.name,
                                        main_program=main)
            for s in range(ELASTIC_STEPS):
                out, = pe.run([loss.name], feed=_elastic_feed(s))
                losses.append(float(np.asarray(out).reshape(-1)[0]))
    finally:
        amp.disable()
    del pe, scope
    _release()
    return losses


def phase_elastic(card_line):
    """The control plane on the card (module docstring, phase 17)."""
    import tempfile

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert, obs
    from paddle_tpu_torch.parallel.master import MasterService

    here = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    svc = MasterService()
    master = f"127.0.0.1:{svc.serve()}"
    col = obs.Collector(ttl_s=600.0)
    httpd = obs.make_obs_http(col, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    collector = f"127.0.0.1:{httpd.server_address[1]}"
    procs, cli = [], {}
    try:
        out = os.path.join(work, "out")
        os.makedirs(out)
        spec = {"master": master, "collector": collector, "work": work,
                "out": out, "init": os.path.join(work, "init.npz"),
                "checkpoint_dir": os.path.join(work, "ckpt")}
        spec_path = os.path.join(work, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        t0 = time.perf_counter()
        # the workers import and build while the start state is made here
        # (they wait for its file)
        for name in ("w0", "w1"):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(here, "chip_smoke.py"),
                 "--elastic-child", spec_path, name], cwd=here,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        main, startup, loss, buckets = build_headline()
        scope = fluid.Scope()
        fluid.Executor().run(startup, scope=scope)
        init = convert.numpy_state(scope, main)
        del scope
        np.savez(os.path.join(work, "init.tmp.npz"), **init)
        os.replace(os.path.join(work, "init.tmp.npz"), spec["init"])
        # the one-rank reference while the workers start
        ref = _elastic_reference(main, startup, loss, init)
        deadline = time.monotonic() + ELASTIC_CHILD_S
        for p, name in zip(procs, ("w0", "w1")):
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"[elastic] {name} ran over "
                                     f"{ELASTIC_CHILD_S} s")
            if p.returncode != 0:
                raise AssertionError(
                    f"[elastic] {name} exited {p.returncode} (see "
                    f"{OUT_DIR}/elastic_{name}.log)")
        drill_s = time.perf_counter() - t0
        cli = _elastic_cli(collector, here)
        res = {}
        for tag in _ELASTIC_TAGS:
            path = os.path.join(out, f"{tag}.json")
            if not os.path.exists(path):
                raise AssertionError(f"[elastic] {tag} wrote no result (see "
                                     f"{OUT_DIR}/elastic_{tag}.log)")
            with open(path) as f:
                res[tag] = json.load(f)
        result = _elastic_checks(res, ref, main, spec, buckets)
        result["drill_s"] = drill_s
        result.update(_elastic_obs(col, cli))
        result["kernel_max_abs_err"] = _elastic_kernel_check(buckets)
        log(f"[elastic] momentum_bucket at the headline's {len(buckets)} "
            f"bucket sizes {[b['numel'] for b in buckets]}: bitwise its "
            f"plain twin on the card (max |err| "
            f"{result['kernel_max_abs_err']})")
        return result
    finally:
        for p in procs + list(cli.values()):
            if p.poll() is None:
                p.kill()
                p.wait()
        httpd.shutdown()
        httpd.server_close()
        svc.stop()
        shutil.rmtree(work, ignore_errors=True)


def _elastic_checks(res, ref, main, spec, buckets):
    """Phase elastic's checks over the workers' results (module
    docstring); prints the [elastic] lines and returns the numbers."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.resilience import CheckpointManager

    w0, w1, joiner = res["w0"], res["w1"], res["w1_joiner"]
    problems = []
    worlds = [r["world"] for r in w0["resizes"]]
    if worlds != [1, 2]:
        problems.append(f"w0's worlds {worlds}")
    steps = {t: [r["step"] for r in res[t]["steps"]] for t in res}
    if steps["w0"] != list(range(ELASTIC_STEPS)):
        problems.append(f"w0 ran steps {steps['w0']}")
    if not w1["left"] or steps["w1"] != list(range(ELASTIC_PREEMPT_AT + 1)):
        problems.append(f"w1 left {w1['left']} after {steps['w1']}")
    want_join = list(range(ELASTIC_JOIN_AT + 1, ELASTIC_STEPS))
    if steps["w1_joiner"] != want_join:
        problems.append(f"the joiner ran {steps['w1_joiner']}")
    # losses against the one-rank run
    worst = 0.0
    for t, r in res.items():
        for rec in r["steps"]:
            want = ref[rec["step"]]
            rel = abs(rec["loss"] - want) / abs(want)
            worst = max(worst, rel)
            if not np.isfinite(rec["loss"]) or rel > PARITY_AMP_RTOL:
                problems.append(f"{t} step {rec['step']} loss "
                                f"{rec['loss']} vs {want}")
    # world 2: the ranks' states equal after every step they shared
    digests = {}
    for t, r in res.items():
        for rec in r["steps"]:
            if "digest" in rec and rec["world"] == ELASTIC_WORLD:
                digests.setdefault(rec["step"], set()).add(rec["digest"])
    shared = sorted(k for k, v in digests.items())
    unequal = [k for k in shared if len(digests[k]) != 1]
    if unequal:
        problems.append(f"world-2 states differ after steps {unequal}")
    # after each resize: every rank's state is the committed checkpoint
    cm = CheckpointManager(spec["checkpoint_dir"], async_write=False)
    committed = {}
    for t, r in res.items():
        for z in r["resizes"]:
            serial = z["serial"]
            if serial not in committed:
                scope = fluid.Scope()
                man = cm.restore(scope=scope, program=main,
                                 place=fluid.CPUPlace(), serial=serial)
                committed[serial] = (man["step"], _state_digest(scope, main))
                del scope
            if z["digest"] != committed[serial][1]:
                problems.append(f"{t}'s state after the resize to world "
                                f"{z['world']} is not serial {serial}")
    # rank 0's state at each resize point is what it committed
    at = {rec["step"]: rec.get("digest") for rec in w0["steps"]}
    for serial, (step, dig) in committed.items():
        if at.get(step - 1) != dig:
            problems.append(f"serial {serial} is not w0's state after "
                            f"step {step - 1}")
    # momentum: 4 buckets x the steps a rank ran, on the op route
    n_buckets = len(buckets)
    for t, r in res.items():
        if r["momentum_launches"] != n_buckets * len(r["steps"]):
            problems.append(f"{t} momentum launches "
                            f"{r['momentum_launches']}, not {n_buckets} x "
                            f"{len(r['steps'])}")
        if {rec["mode"] for rec in r["steps"]} != {"interpreter"}:
            problems.append(f"{t} modes "
                            f"{sorted({rec['mode'] for rec in r['steps']})}")
    # the compile service: the joiner's prepare a hit, w0's at world 1 a
    # clean miss
    j_cache = joiner["caches"][0]
    w0_one = [c for c in w0["caches"] if c["world"] == 1]
    if j_cache["remote_hits"] < 1:
        problems.append(f"the joiner's prepare {j_cache}")
    if not w0_one or w0_one[0]["remote_hits"] != 0 \
            or w0_one[0]["remote_misses"] < 1 or w0_one[0]["fallbacks"]:
        problems.append(f"w0's prepare at world 1 {w0_one}")
    if problems:
        raise AssertionError(f"[elastic] failed: {problems}")

    def median_ms(world, rows):
        xs = [x["ms"] for x in rows if x["world"] == world
              and not x["first_after_resize"]]
        return statistics.median(xs) if xs else None

    rows = [x for t in ("w0",) for x in res[t]["steps"]]
    step_ms = {w: median_ms(w, rows) for w in (1, 2)}
    share = {}
    for w in (1, 2):
        xs = [x for x in rows if x["world"] == w
              and not x["first_after_resize"]]
        share[w] = {"wire_share": sum(x["wire_s"] for x in xs) * 1e3
                    / sum(x["ms"] for x in xs) if xs else None,
                    "wire_bytes_per_step": statistics.median(
                        x["wire_bytes"] for x in xs) if xs else None}
    resizes = []
    for z, kind in zip(w0["resizes"], ("shrink", "grow")):
        first = next(x for x in w0["steps"] if x["step"] == z["step"])
        resizes.append(dict(z["parts"], kind=kind, world=z["world"],
                            first_step_after_ms=first["ms"]))
        p = z["parts"]
        log(f"[elastic] resize {kind} to world {z['world']} at step "
            f"{z['step']}: {p['total']:.1f} ms (barriers "
            f"{p['barriers']:.1f}, rank 0's checkpoint "
            f"{p['checkpoint']:.1f}, group re-form {p.get('reform', 0):.1f}, "
            f"adopt {p['adopt']:.1f} ms); the first step after it "
            f"{first['ms']:.1f} ms (a new ParallelExecutor's prepare "
            f"included)")
    log(f"[elastic] gauge elastic_resize_duration_ms (w0, the last "
        f"resize): {w0['resize_gauge_ms']:.1f} ms")
    for w in (2, 1):
        log(f"[elastic] world {w}: step {step_ms[w]:.1f} ms median (w0, "
            f"first steps after a resize left out; interpreter, gloo on "
            f"one card); the gloo all-reduce's pinned host wire "
            f"{share[w]['wire_share']:.3f} of a step, "
            f"{share[w]['wire_bytes_per_step'] / 1e6:.1f} MB a step "
            f"copied through the host")
    log(f"[elastic] losses within {PARITY_AMP_RTOL} of the one-rank PE's "
        f"(worst relative {worst:.3e}); steps run: {steps}; world-2 "
        f"states bitwise equal across ranks after steps {shared}; every "
        f"state after a resize bitwise its committed serial "
        f"{sorted(committed)}; momentum_bucket launches "
        f"{ {t: r['momentum_launches'] for t, r in res.items()} } = "
        f"{n_buckets} x steps")
    log(f"[elastic] compile service: the joiner's first prepare "
        f"remote_hits {j_cache['remote_hits']}, w0's at world 1 "
        f"remote_misses {w0_one[0]['remote_misses']}, remote_hits 0; peak "
        f"memory by rank "
        f"{ {t: round(r['peak_bytes'] / 2**30, 2) for t, r in res.items()} }"
        f" GiB; from a worker's imports to its group formed (program "
        f"built, state loaded, the start barrier) "
        f"{ {t: round(r['start_s'], 1) for t, r in res.items()} } s")
    return {"worlds": worlds, "resizes": resizes, "step_ms": step_ms,
            "wire": share, "steps": steps, "worst_rel": worst,
            "reference_losses": ref,
            "losses": {t: [x["loss"] for x in r["steps"]]
                       for t, r in res.items()},
            "momentum_launches": sum(r["momentum_launches"]
                                     for r in res.values()),
            "momentum_launches_by_rank": {t: r["momentum_launches"]
                                          for t, r in res.items()},
            "caches": {t: r["caches"] for t, r in res.items()},
            "peak_bytes": {t: r["peak_bytes"] for t, r in res.items()},
            "start_s": {t: r["start_s"] for t, r in res.items()},
            "resize_gauge_ms": w0["resize_gauge_ms"]}


_ELASTIC_TAGS = ("w0", "w1", "w1_joiner")


def _elastic_cli(collector, here):
    """Start `python -m paddle_tpu_torch obs timeline` over the collector
    and `monitor` over the workers' journals (they run beside the phase's
    other checks): {name: Popen}."""
    journals = [os.path.join(OUT_DIR, f"elastic_{n}.jsonl")
                for n in _ELASTIC_TAGS]
    cmds = {"timeline": [sys.executable, "-m", "paddle_tpu_torch", "obs",
                         "timeline", "--collector", collector],
            "monitor": [sys.executable, "-m", "paddle_tpu_torch", "monitor",
                        *journals]}
    return {k: subprocess.Popen(c, cwd=here, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
            for k, c in cmds.items()}


def _elastic_obs(col, running):
    """The collector's summary lists the workers; the two commands of
    `running` (_elastic_cli) exit 0, `monitor` with the per-step skew."""
    summary = col.summary()
    procs = {p["labels"].get("replica"): p for p in summary["processes"]}
    names = _ELASTIC_TAGS
    missing = [n for n in names if n not in procs
               or not procs[n]["journal_steps"]]
    if missing:
        raise AssertionError(f"[elastic] the collector lacks {missing}: "
                             f"{sorted(procs)}")
    outs = {k: p.communicate(timeout=120) for k, p in running.items()}
    for k, p in running.items():
        if p.returncode != 0:
            raise AssertionError(f"[elastic] {k} rc {p.returncode}: "
                                 f"{outs[k][1][-2000:]}")
    skew = [ln for ln in outs["monitor"][0].splitlines()
            if ln.startswith("fleet:")]
    if not skew or "max skew" not in skew[0]:
        raise AssertionError(f"[elastic] monitor printed no skew: "
                             f"{outs['monitor'][0][-2000:]}")
    tl_lines = outs["timeline"][0].strip().splitlines()
    seen = ", ".join(f"{n}: {procs[n]['journal_steps']} journal steps"
                     for n in names)
    log(f"[elastic] collector: {len(summary['processes'])} processes "
        f"({seen}), {summary['fleet']['pushes']} pushes, "
        f"{summary['fleet']['dropped_snapshots']} dropped")
    log(f"[elastic] python -m paddle_tpu_torch monitor <3 journals>: rc 0; "
        f"{skew[0]}")
    log(f"[elastic] python -m paddle_tpu_torch obs timeline --collector: rc "
        f"0; {tl_lines[0] if tl_lines else ''}")
    with open(os.path.join(OUT_DIR, "elastic_obs.txt"), "w") as f:
        f.write(outs["timeline"][0] + "\n" + outs["monitor"][0])
    return {"collector_processes": sorted(procs),
            "journal_steps": {n: procs[n]["journal_steps"] for n in names},
            "monitor_skew": skew[0]}


def _elastic_kernel_check(buckets):
    """momentum_bucket against its plain twin on the card at each of the
    headline's bucket sizes, bitwise (phase kernels' check, here for the
    path this phase runs); returns the max |err| (0.0)."""
    from paddle_tpu_torch.fusion import kernels as fk

    gen = torch.Generator(device="cuda").manual_seed(SEED + 43)
    lr = torch.full((), 0.01, device="cuda")
    err = {"momentum_bucket": 0.0}
    for b in buckets:
        p, g, v = _lanes(b["numel"], 3, gen)
        _bitwise("momentum_bucket", fk.momentum_bucket(p, g, v, lr, 0.9,
                                                       False),
                 fk.momentum_bucket_plain(p, g, v, lr, 0.9, False), err,
                 f"elastic bucket n={b['numel']}")
        del p, g, v
    torch.cuda.synchronize()
    return err["momentum_bucket"]


def main_elastic():
    """`python3 chip_smoke.py --only elastic`: the device check, the build
    and phase elastic alone."""
    card_line = phase_device()
    phase_build()
    lap("device_and_build")
    result = phase_elastic(card_line)
    lap("elastic")
    log(card_line)
    log(json.dumps({"elastic": result}))
    log(_device_line())


def main_ring():
    """`python3 chip_smoke.py --only ring`: the device check, the build
    and phase ring alone."""
    card_line = phase_device()
    phase_build()
    lap("device_and_build")
    result = phase_ring(card_line)
    lap("ring")
    log(card_line)
    log(json.dumps({"ring": result}))
    log(_device_line())


def main_pipeline():
    """`python3 chip_smoke.py --only pipeline`: the device check, the
    build and phase pipeline alone (the headline's img/s is the whole
    script's: not measured here)."""
    card_line = phase_device()
    phase_build()
    lap("device_and_build")
    result = phase_pipeline(card_line, None)
    lap("pipeline")
    log(card_line)
    log(json.dumps({"pipeline": result}))
    log(_device_line())


def main_detection():
    """`python3 chip_smoke.py --only detection`: the device check, the
    build (the fused momentum kernel of SSD300's path) and phase detection
    alone."""
    card_line = phase_device()
    phase_build()
    result = phase_detection(card_line)
    log(card_line)
    log(json.dumps({"detection": result}))
    log(_device_line())


def main_pserver():
    """`python3 chip_smoke.py --only pserver`: the device check and phase
    pserver alone (its path launches no hand-written kernel; (d)'s fused
    update builds the kernels)."""
    card_line = phase_device()
    phase_build()
    result = phase_pserver(card_line)
    log(card_line)
    log(json.dumps({"pserver": result}))
    log(_device_line())


def _device_line():
    return json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


def main_loss_ops():
    """`python3 chip_smoke.py --only loss_ops`: the device check and phase
    loss_ops alone (its slice's kernels are torch's: nothing to build)."""
    card_line = phase_device()
    result = phase_loss_ops(card_line)
    log(card_line)
    log(json.dumps({"loss_ops": result}))
    log(_device_line())


def main_input():
    """`python3 chip_smoke.py --only input`: the device check, the build
    and phase input alone, its speed against the headline's numpy feed
    timed here the same way (1 warm + INPUT_CALLS calls)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, flags

    card_line = phase_device()
    phase_build()
    main, startup, loss, _ = build_headline()
    rs = np.random.RandomState(SEED)
    feeds = {"data_u8": torch.from_numpy(rs.randint(
                 0, 256, (HEADLINE_K, HEADLINE_BATCH, 224, 224, 3),
                 dtype=np.uint8)).cuda(),
             "label": torch.from_numpy(rs.randint(
                 0, 1000, (HEADLINE_K, HEADLINE_BATCH, 1)).astype(
                     np.int32)).cuda()}
    amp.enable("bfloat16")
    try:
        with flags.flag_guard(fuse=True), fluid.scope_guard(fluid.Scope()):
            exe = fluid.Executor()
            exe.run(startup)
            dt, _ = _timed_calls(exe, main, feeds, [loss], HEADLINE_K,
                                 INPUT_WARM, INPUT_CALLS)
    finally:
        amp.disable()
    img_s = HEADLINE_BATCH * HEADLINE_K * INPUT_CALLS / dt
    log(f"[input] the headline's numpy feed: {img_s:.2f} img/s")
    del feeds, exe
    _release()
    result = phase_input(card_line, img_s)
    log(card_line)
    log(json.dumps({"input": result}))
    log(_device_line())


def main_control_flow():
    """`python3 chip_smoke.py --only control_flow`: the device check, the
    build and phase control_flow alone; the headline and the stacked
    LSTM it compares with are timed here (1 warm + CF_HEAD_CALLS calls;
    1 warm + SEQ_CALLS calls of phase stacked_lstm)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, flags

    card_line = phase_device()
    card = torch.cuda.get_device_name(0)
    phase_build()
    main, startup, loss, _ = build_headline()
    rs = np.random.RandomState(SEED)
    feeds = {"data_u8": torch.from_numpy(rs.randint(
                 0, 256, (HEADLINE_K, HEADLINE_BATCH, 224, 224, 3),
                 dtype=np.uint8)).cuda(),
             "label": torch.from_numpy(rs.randint(
                 0, 1000, (HEADLINE_K, HEADLINE_BATCH, 1)).astype(
                     np.int32)).cuda()}
    amp.enable("bfloat16")
    try:
        with flags.flag_guard(fuse=True), fluid.scope_guard(fluid.Scope()):
            exe = fluid.Executor()
            exe.run(startup)
            dt, _ = _timed_calls(exe, main, feeds, [loss], HEADLINE_K,
                                 CF_HEAD_WARM, CF_HEAD_CALLS)
    finally:
        amp.disable()
    img_s = HEADLINE_BATCH * HEADLINE_K * CF_HEAD_CALLS / dt
    log(f"[control_flow] the headline: {img_s:.2f} img/s")
    del feeds, exe
    _release()
    lstm = phase_seq(build_seq_model("stacked_lstm"), card_line)
    _release()
    result = phase_control_flow(card, card_line, img_s,
                                lstm["words_per_sec"])
    log(card_line)
    log(json.dumps({"control_flow": result}))
    log(_device_line())


def main_resilience():
    """`python3 chip_smoke.py --only resilience`: the device check, the
    build and phase resilience alone, the headline it compares with timed
    here (1 warm + CF_HEAD_CALLS calls of iters=HEADLINE_K)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, flags

    card_line = phase_device()
    card = torch.cuda.get_device_name(0)
    phase_build()
    main, startup, loss, _ = build_headline()
    rs = np.random.RandomState(SEED)
    feeds = {"data_u8": torch.from_numpy(rs.randint(
                 0, 256, (HEADLINE_K, HEADLINE_BATCH, 224, 224, 3),
                 dtype=np.uint8)).cuda(),
             "label": torch.from_numpy(rs.randint(
                 0, 1000, (HEADLINE_K, HEADLINE_BATCH, 1)).astype(
                     np.int32)).cuda()}
    amp.enable("bfloat16")
    try:
        with flags.flag_guard(fuse=True), fluid.scope_guard(fluid.Scope()):
            exe = fluid.Executor()
            exe.run(startup)
            dt, _ = _timed_calls(exe, main, feeds, [loss], HEADLINE_K,
                                 CF_HEAD_WARM, CF_HEAD_CALLS)
    finally:
        amp.disable()
    img_s = HEADLINE_BATCH * HEADLINE_K * CF_HEAD_CALLS / dt
    log(f"[resilience] the headline: {img_s:.2f} img/s")
    del feeds, exe
    _release()
    result = phase_resilience(card, img_s)
    log(card_line)
    log(json.dumps({"resilience": result}))
    log(_device_line())


def main_compile_services():
    """`python3 chip_smoke.py --only compile_services`: the device check,
    the build and phase compile_services alone, the headline it compares
    with timed here (1 warm + CS_CALLS calls of iters=HEADLINE_K)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, flags

    card_line = phase_device()
    card = torch.cuda.get_device_name(0)
    phase_build()
    main, startup, loss, _ = build_headline()
    feeds = _cs_feeds(SEED + 17, HEADLINE_K, HEADLINE_BATCH)
    amp.enable("bfloat16")
    try:
        with flags.flag_guard(fuse=True), fluid.scope_guard(fluid.Scope()):
            exe = fluid.Executor()
            exe.run(startup)
            dt, _ = _timed_calls(exe, main, feeds, [loss], HEADLINE_K,
                                 CS_WARM, CS_CALLS)
    finally:
        amp.disable()
    img_s = HEADLINE_BATCH * HEADLINE_K * CS_CALLS / dt
    log(f"[compile_services] the headline: {img_s:.2f} img/s")
    del feeds, exe
    _release()
    result = phase_compile_services(card, img_s)
    log(card_line)
    log(json.dumps({"compile_services": result}))
    log(_device_line())


def main_continuous():
    """`python3 chip_smoke.py --only continuous`: the device check and
    phase continuous alone (its slice launches no hand-written kernel:
    nothing to build)."""
    card_line = phase_device()
    result = phase_continuous(card_line)
    log(card_line)
    log(json.dumps({"continuous": result}))
    log(_device_line())


def main():
    card_line = phase_device()
    card = torch.cuda.get_device_name(0)
    sass = phase_build()
    lap("device_and_build")
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
    lap("plan")
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
    lap("kernels")
    paths = {"resnet50_fp32": phase_resnet(*resnet, card)}
    _release()
    lap("resnet")
    headline, rerun = phase_headline(
        card, os.path.join(OUT_DIR, "headline_journal.jsonl"))
    paths["headline"] = headline["momentum_launches"]
    _release()
    lap("headline")
    monitored = phase_monitor(card_line, headline, rerun)
    paths["headline_unmonitored"] = monitored["unmonitored_launches"]
    del rerun
    _release()
    lap("monitor")
    parallel = phase_parallel(card, headline["images_per_sec"])
    paths["parallel_executor"] = parallel["momentum_launches"]
    _release()
    lap("parallel")
    fed = phase_input(card_line, headline["images_per_sec"])
    paths["input"] = fed["momentum_launches"]
    _release()
    lap("input")
    se = phase_image(images["se_resnext50"], card)
    paths["se_resnext50"] = se["launches"]
    momentum["launches"], momentum["launches_by_path"] = (
        headline["momentum_launches"], paths)
    lap("se_resnext50")
    vgg = phase_image(images["vgg16"], card)
    lap("vgg16")
    mnist = images["mnist_cnn"]
    paths = {"vgg16": vgg["launches"],
             "mlp": phase_adam("mlp", *mlp, [784]),
             "mnist_cnn": phase_adam("mnist_cnn", mnist["main"],
                                     mnist["startup"], mnist["loss"],
                                     mnist["buckets"], mnist["shape"])}
    lap("adam")
    seq = {}
    for name, m in seqs.items():
        seq[name] = phase_seq(m, card_line)
        paths[name] = seq[name]["launches"]
        lap(name)
    del seqs
    adam["launches"], adam["launches_by_path"] = vgg["launches"], paths
    phase_parity(amp=False)
    phase_parity(amp=True)
    lap("parity")
    served = phase_serve(card_line)
    _release()
    lap("serve")
    tail = phase_tail_ops(card, headline["images_per_sec"])
    momentum["launches_by_path"]["headline_clip_decay"] = \
        tail["clip_decay"]["momentum_launches"]
    _release()
    lap("tail_ops")
    losses = phase_loss_ops(card_line)
    _release()
    lap("loss_ops")
    flow = phase_control_flow(card, card_line, headline["images_per_sec"],
                              seq["stacked_lstm"]["words_per_sec"])
    momentum["launches_by_path"]["headline_piecewise"] = \
        flow["headline_piecewise"]["momentum_launches"]
    adam["launches_by_path"]["nmt_decode_train"] = \
        flow["nmt_decode"]["adam_launches"]
    adam["launches_by_path"]["dynamic_rnn_lstm"] = \
        flow["dynamic_rnn_lstm"]["adam_launches"]
    _release()
    lap("control_flow")
    resil = phase_resilience(card, headline["images_per_sec"])
    for path in ("trainer_headline", "trainer_checkpointed"):
        momentum["launches_by_path"][path] = \
            resil[path]["momentum_launches"]
    adam["launches_by_path"]["trainer_mlp_dropout"] = \
        resil["trainer_mlp_dropout"]["adam_launches"]
    _release()
    lap("resilience")
    services = phase_compile_services(card, headline["images_per_sec"])
    momentum["launches_by_path"]["headline_verify_full"] = \
        services["verify"]["momentum_launches"]
    momentum["launches_by_path"]["headline_l2_processes"] = \
        services["l2"]["momentum_launches"]
    _release()
    lap("compile_services")
    continuous = phase_continuous(card_line)
    _release()
    lap("continuous")
    pserver = phase_pserver(card_line)
    for path in ("one", "two"):
        momentum["launches_by_path"][f"pserver_{path}"] = \
            pserver[path]["momentum_launches"]
    momentum["launches_by_path"]["pserver_trainer"] = \
        pserver["trainer_launches"]
    momentum["launches_by_path"]["pserver_memopt"] = \
        pserver["memory_optimize"]["momentum_launches"]
    _release()
    lap("pserver")
    detection = phase_detection(card_line)
    momentum["launches_by_path"]["ssd300"] = \
        detection["ssd300"]["momentum_launches"]
    _release()
    lap("detection")
    start_pipe_cli()
    ring = phase_ring(card_line)
    _release()
    lap("ring")
    pipe = phase_pipeline(card_line, headline["images_per_sec"])
    momentum["launches_by_path"]["pipeline_one_stage"] = \
        pipe["one_stage"]["momentum_launches"]
    momentum["launches_by_path"]["pipeline_stages"] = \
        pipe["stages"]["momentum_launches"]
    _release()
    lap("pipeline")
    elastic = phase_elastic(card_line)
    momentum["launches_by_path"]["elastic"] = elastic["momentum_launches"]
    _release()
    lap("elastic")
    entry = phase_flash(sass)
    # the flash rows' launches: the ring's (the path that runs them), the
    # entry point's beside them
    for row, name in zip(entry[:2], ("bfloat16", "float32")):
        row["launches_by_path"] = dict(ring["launches"][name],
                                       flash_attention_entry=row["launches"])
        row["launches"] = ring["launches"][name]["ring_sp4_causal"] \
            + ring["launches"][name]["ring_sp4_full"]
    entry[2]["launches_by_path"] = {"ring_sp4": ring["split_launches"],
                                    "flash_attention_entry":
                                        entry[2]["launches"]}
    entry[2]["launches"] = ring["split_launches"]
    rows += entry
    lap("flash")
    log(card_line)
    log(json.dumps({"headline": headline, "monitor": monitored,
                    "parallel": parallel, "input": fed,
                    "se_resnext50": se, "vgg16": vgg, **seq,
                    "serve": served, "tail_ops": tail, "loss_ops": losses,
                    "control_flow": flow, "resilience": resil,
                    "compile_services": services,
                    "continuous": continuous, "pserver": pserver,
                    "detection": detection, "ring": ring,
                    "pipeline": pipe, "elastic": elastic,
                    "seconds_by_phase": _LAPS["seconds"]}))
    log(json.dumps({"kernels": rows}))
    log(_device_line())


if __name__ == "__main__":
    if sys.argv[1:] == ["--only", "loss_ops"]:
        main_loss_ops()
    elif sys.argv[1:] == ["--only", "input"]:
        main_input()
    elif sys.argv[1:] == ["--only", "control_flow"]:
        main_control_flow()
    elif sys.argv[1:] == ["--only", "resilience"]:
        main_resilience()
    elif sys.argv[1:] == ["--only", "compile_services"]:
        main_compile_services()
    elif sys.argv[1:] == ["--only", "continuous"]:
        main_continuous()
    elif sys.argv[1:] == ["--only", "pserver"]:
        main_pserver()
    elif sys.argv[1:] == ["--only", "detection"]:
        main_detection()
    elif sys.argv[1:] == ["--only", "ring"]:
        main_ring()
    elif sys.argv[1:] == ["--only", "pipeline"]:
        main_pipeline()
    elif sys.argv[1:] == ["--only", "elastic"]:
        main_elastic()
    elif sys.argv[1:2] == ["--elastic-child"] and len(sys.argv) in (4, 5):
        elastic_child(sys.argv[2], sys.argv[3], sys.argv[4:] == ["--joiner"])
    elif sys.argv[1:2] == ["--ring-child"] and len(sys.argv) == 4:
        ring_child(sys.argv[2], int(sys.argv[3]))
    elif sys.argv[1:2] == ["--pserver-child"] and len(sys.argv) == 4:
        pserver_child(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["--l2-child"] and len(sys.argv) == 4:
        l2_child(sys.argv[2], sys.argv[3])
    else:
        main()
