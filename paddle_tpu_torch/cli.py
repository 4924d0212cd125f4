"""Command-line entry: `python -m paddle_tpu_torch <command>`.

The JAX package's `python -m paddle_tpu` commands that read the run-time
instruments' files (paddle_tpu/cli.py), with the same text and exit codes
on the same input files, so either package's CLI reads the other's
journals and ledgers:

  version            print version + backend info
  flags              list registered runtime flags (FLAGS_* env overrides)
  monitor JOURNAL... summarize a FLAGS_monitor_journal step journal
                     (step/phase timings, compile-cache hit rate, replica
                     skew); several journals (one a process) give a
                     per-process table and the fleet merge: per-step
                     cross-process skew and stragglers (obs.
                     merge_step_timeline); --json emits it as JSON.
  health summary LEDGER
                     summarize a FLAGS_health_ledger run ledger (loss
                     curve, grad norms, detector events, divergence
                     step); --json emits the summary as JSON.
  health compare A B [--tol-final F] [--tol-traj F]
                     assert convergence parity between two run ledgers
                     (final-loss delta, step-aligned trajectory max
                     deviation, divergence-step agreement); rc 0 on
                     parity, 1 on a violated tolerance, 2 on an
                     unreadable ledger.
  checkpoint inspect DIR [--serial N] [--json]
                     list a checkpoint directory's serials, their commit
                     status and bytes, and a serial's manifest
                     (resilience.inspect_dir); either package's
                     checkpoints.

  cache ls|prune|clear [--dir D] [--max-mb N] [--json]
                     list, prune (oldest-used first) or empty the
                     persistent compile cache (FLAGS_compile_cache_dir)
  check [--model-dir D | --selftest] [--level basic|full] [--mesh A=N,..]
        [--json] [--quiet]
                     static program verification (analysis.verify) of a
                     saved inference model, with the peak-HBM table at
                     `full`; rc 0 clean, 1 on errors, 2 on usage errors
  analyze graph|fusion [--model-dir D | --selftest] [--zero1 N] ...
                     the SSA dataflow graph and its PTA03x hazards, or
                     the fusion pass's plan
  analyze schedule [--model-dir D | --selftest] [--mesh dp=8] [--zero1 N]
        [--batch N] [--bucket-bytes B] [--peak-tflops F] [--link-gbps F]
        [--json] [--quiet]
                     the critical path over the analytic cost models
                     (compute at the card's peak, the zero1 collectives'
                     ring bytes over its link) and the bucketed
                     reduce-scatter overlap plan; the defaults are one
                     H100 SXM's data-sheet figures, and --peak-tflops
                     197 --link-gbps 180 give the JAX command's report.
                     --selftest plans a zero1-rewritten demo program
                     (buckets must hoist) and a seeded gather rewire
                     (must be refused with PTA033); rc 0 ok, 1 refused
                     or failed, 2 usage
  analyze pipeline [--model-dir D | --selftest] [--stages P]
        [--microbatches M] [--place cuda|cpu] ...
                     the pp-axis stage partition, its PTA040/041
                     legality and the 1F1B bubble; --selftest trains the
                     demo MLP through PipelineRunner (on the card unless
                     --place cpu): losses bitwise the n_stages=1 run's,
                     the bubble (p-1)/(m+p-1), a seeded backwards edge
                     refused with PTA040

  serve --model-dir D [--place cuda|cpu] [--http PORT | --selftest N]
                     serve a saved inference model with the batching
                     engine, behind the HTTP frontend or a synthetic
                     load (stats JSON; rc 1 on a steady-state capture)
  fleet replica --model-dir D [--place cuda|cpu] [--router H:P] ...
  fleet router --replicas H:P,... [--autoscale-model-dir D] ...
                     one serving replica process (drains clean on
                     /admin/drain or SIGTERM), or the fleet router over
                     replicas; --place defaults to the first card in
                     every command (the JAX package's replica: cpu). A
                     replica's --master registers it (kind "serve") in
                     an elastic master's registry through a Heartbeater,
                     and the router's --master discovers replicas there
                     (MasterClient.lookup); --obs pushes to an obs
                     collector; --compile-service warm-starts a replica
                     from its peers' prepared plans
  elastic status --master HOST:PORT [--json]
  elastic drain NAME --master HOST:PORT
                     membership snapshot of an elastic training job
                     (epoch, world size, members), or a manual
                     scale-down: the survivors resize at their next step
                     boundary
  obs collect [--port P] [--scrape [NAME=]HOST:PORT] ...
  obs top --collector HOST:PORT [--once] [--json]
  obs timeline [--collector HOST:PORT] [--dump DIR ...] [--out F]
                     fleet observability: the collector (push sink,
                     scrape poller, aggregated /metrics), its live
                     table, the merged step timeline and chrome trace
  trace ops --model-dir D [--place cuda|cpu] [--batch N] [--top K]
  trace summary DIR
  trace dump [--out D] [--selftest]
                     per-op cost attribution of a saved model's first
                     step (FLAGS_monitor_hlo_cost's FLOP probe), a
                     flight-recorder dump's span table, or a dump of
                     this process's recorder

  train [--role trainer|pserver] [--trainers N] [--trainer-id I]
        [--pservers H:P,...] [--current-endpoint H:P] SCRIPT [ARGS ...]
                     exec a training script with the parameter-server
                     cluster environment: PADDLE_TRAINING_ROLE,
                     PADDLE_TRAINERS, PADDLE_TRAINER_ID, PADDLE_PSERVERS
                     and PADDLE_CURRENT_ENDPOINT (the JAX command's
                     names; fluid.Trainer itself reads the reference's
                     PADDLE_PSERVER_IPS, PADDLE_PSERVER_PORT and
                     PADDLE_CURRENT_IP, as the JAX package's does)

  shard plan [--model-dir DIR | --selftest] [--mesh dp=4,mp=2]
        [--seed NAME=SPEC] [--batch-axis dp] [--json] [--quiet]
                     propagate the program's set_sharding seeds (and
                     --seed ones) over it and render the total
                     ShardingPlan with its conflicts and reshard edges;
                     --json emits plan.describe(). rc 0 total, 1 bad
                     seed, 2 not total (or the selftest failed).
  shard search [--model-dir DIR | --selftest] [--mesh ...] [--batch N]
        [--hbm-budget BYTES] [--max-params N] [--rounds N]
        [--peak-tflops F] [--link-gbps F] [--json] [--quiet]
                     search seed placements for the largest params and
                     keep the cheapest whole plan under the cost model
                     (compute at the card's peak, collective bytes over
                     its link, a peak-HBM budget); the defaults are one
                     H100 SXM's data-sheet figures (989.4 dense bf16
                     TFLOP/s, NVLink 450 GB/s each way), and
                     --peak-tflops 275 --link-gbps 90 give the JAX
                     command's. rc 0 ok, 1 error, 2 the searched plan
                     costs more than the manual seeds.
"""

import argparse
import glob
import json
import os
import sys


def _cmd_version(args):
    import torch

    from . import __version__

    print(f"paddle_tpu_torch {__version__}")
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        print(f"torch {torch.__version__}; {n} device(s): cuda "
              f"({torch.cuda.get_device_name(0)})")
    else:
        print(f"torch {torch.__version__}; 0 device(s): no CUDA card")
    return 0


def _cmd_train(args):
    """Exec `args.script` in this process with the cluster environment
    (the JAX package's `train`, paddle_tpu/cli.py:1545-1556)."""
    env = dict(os.environ)
    env["PADDLE_TRAINING_ROLE"] = args.role.upper()
    env["PADDLE_TRAINERS"] = str(args.trainers)
    env["PADDLE_TRAINER_ID"] = str(args.trainer_id)
    if args.pservers:
        env["PADDLE_PSERVERS"] = args.pservers
    if args.current_endpoint:
        env["PADDLE_CURRENT_ENDPOINT"] = args.current_endpoint
    cmd = [sys.executable, args.script] + args.script_args
    os.execve(sys.executable, cmd, env)


def _cmd_flags(args):
    from . import flags

    for name, (value, type_, help_) in flags.all_flags().items():
        print(f"FLAGS_{name} ({type_}, current={value}): {help_}")
    return 0


def _cmd_monitor(args):
    from .monitor import format_summary, read_journal, summarize_journal

    paths = []
    for pat in args.journal:
        hits = sorted(glob.glob(pat))
        paths.extend(p for p in (hits or [pat]) if p not in paths)
    journals = {}
    for path in paths:
        try:
            journals[path] = read_journal(path)
        except OSError as e:
            print(f"cannot read journal: {e}", file=sys.stderr)
            return 1
    if len(journals) == 1:
        summary = summarize_journal(next(iter(journals.values())))
        if args.json:
            print(json.dumps(summary, indent=2))
        else:
            print(format_summary(summary))
        return 0

    # several journals = one per fleet process: per-process summaries
    # plus the obs clock-aligned merge (same-host processes share the
    # epoch clock, so offset 0 per journal) for cross-replica skew
    from .obs import merge_step_timeline

    summaries = {p: summarize_journal(r) for p, r in journals.items()}
    merged = merge_step_timeline(
        [{"name": os.path.basename(p) or p, "journal": r,
          "offset_s": 0.0} for p, r in journals.items()])
    if args.json:
        print(json.dumps({"journals": summaries,
                          "fleet": {k: merged[k] for k in
                                    ("steps", "stragglers")}}, indent=2))
        return 0
    hdr = (f"{'journal':<28}{'steps':>7}{'mean_ms':>10}{'p50_ms':>9}"
           f"{'p95_ms':>9}{'cache_hit%':>11}")
    print(hdr)
    print("-" * len(hdr))
    for path, s in summaries.items():
        ms = s.get("step_ms") or {}
        cache = s.get("cache") or {}
        lookups = (cache.get("hit") or 0) + (cache.get("miss") or 0)
        hit = 100.0 * (cache.get("hit") or 0) / lookups if lookups \
            else None
        print(f"{os.path.basename(path) or path:<28.27}"
              f"{s.get('steps', 0):>7}"
              f"{_opt_num(ms.get('mean')):>10}"
              f"{_opt_num(ms.get('p50')):>9}"
              f"{_opt_num(ms.get('p95')):>9}"
              f"{_opt_num(hit):>11}")
    steps = merged["steps"]
    if steps:
        worst = max(steps, key=lambda s: s["skew_ms"])
        print(f"fleet: {len(steps)} step(s) aligned across processes; "
              f"max skew {worst['skew_ms']:.1f} ms at step "
              f"{worst['step']} (slowest {worst['slowest']})")
        for name, run in sorted(merged["stragglers"].items()):
            print(f"straggler: {name} slowest on {run} consecutive "
                  f"step(s)")
    else:
        print("fleet: no step overlap between the journals")
    return 0


def _opt_num(v, spec="{:.1f}"):
    return "-" if v is None else spec.format(v)


def _cmd_health(args):
    from .health import compare as hcompare
    from .health.ledger import read_ledger

    if args.health_action == "summary":
        try:
            records = read_ledger(args.ledger)
        except OSError as e:
            print(f"cannot read ledger: {e}", file=sys.stderr)
            return 2
        summary = hcompare.summarize_ledger(records)
        if args.json:
            print(json.dumps(summary, indent=2))
        else:
            print(hcompare.format_ledger_summary(summary))
        return 0
    try:
        a = read_ledger(args.a)
        b = read_ledger(args.b)
    except OSError as e:
        print(f"cannot read ledger: {e}", file=sys.stderr)
        return 2
    report = hcompare.compare_ledgers(
        a, b, tol_final=args.tol_final, tol_traj=args.tol_traj)
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print(hcompare.format_compare(report))
    return 0 if report["ok"] else 1


def _cmd_checkpoint(args):
    from .resilience import inspect_dir

    try:
        report = inspect_dir(args.dir, serial=args.serial)
    except (OSError, ValueError) as e:
        print(f"cannot inspect checkpoint dir: {e}", file=sys.stderr)
        return 1
    if args.json:
        import json

        print(json.dumps(report, indent=2))
        return 0
    print(f"checkpoint dir: {report['checkpoint_dir']}")
    if not report["serials"]:
        print("  (no checkpoints)")
        return 0
    for ent in report["serials"]:
        # an orphaned .tmp dir has no serial and no size (the JAX CLI
        # raises KeyError on one: ROADMAP §3)
        print(f"  {ent['dir']:<24} serial={ent.get('serial')!s:<6} "
              f"{ent['status']:<12} {ent.get('bytes', 0)} bytes")
    print(f"latest committed serial: {report['latest']}")
    manifest = report.get("manifest")
    if manifest:
        print(f"manifest (serial {manifest.get('serial')}): "
              f"format={manifest.get('format')} step={manifest.get('step')}")
        var_names = sorted((manifest.get("vars") or {}).keys())
        print(f"  vars ({len(var_names)}): {', '.join(var_names[:8])}"
              + (" ..." if len(var_names) > 8 else ""))
        dp = manifest.get("datapipe")
        if dp:
            print(f"  datapipe: {dp}")
        mesh = manifest.get("mesh")
        if mesh:
            mesh_s = "×".join(f"{k}={v}" for k, v in mesh.items())
            print(f"  mesh geometry: [{mesh_s}] (dp may change across a "
                  f"restore; other axes must match the target mesh)")
        el = (manifest.get("extra") or {}).get("elastic")
        if el:
            print(f"  elastic resize point: epoch={el.get('epoch')} "
                  f"world_size={el.get('world_size')} "
                  f"members={el.get('members')}")
        zero1 = manifest.get("zero1")
        if zero1:
            print(f"  zero1 shard layout ({len(zero1)} sharded params; "
                  f"checkpoint stores canonical full layout):")
            for pname in sorted(zero1):
                ent = zero1[pname]
                owners = ent.get("owners") or {}
                own = ", ".join(
                    f"dp{r}:[{owners[r][0]}:{owners[r][1]})"
                    for r in sorted(owners, key=int)[:4])
                if len(owners) > 4:
                    own += ", ..."
                print(f"    {pname}: shape={ent.get('shape')} "
                      f"shards={ent.get('num_shards')}x"
                      f"{ent.get('shard_numel')} "
                      f"param_shard={ent.get('param_shard_bytes')}B "
                      f"accum_shard={ent.get('accum_shard_bytes')}B")
                print(f"      owners: {own}")
                accs = ent.get("accums") or []
                if accs:
                    print(f"      accums: {', '.join(accs)}")
        ashard = manifest.get("autoshard")
        if ashard:
            mesh = ashard.get("mesh_axes") or {}
            mesh_s = "×".join(f"{k}={v}" for k, v in mesh.items())
            params = ashard.get("params") or {}
            print(f"  autoshard plan digest={ashard.get('digest')} "
                  f"mesh[{mesh_s}] layout={ashard.get('layout', 'full')} "
                  f"({len(params)} sharded params; checkpoint stores "
                  f"canonical full layout):")
            for pname in sorted(params):
                spec = ", ".join(str(a) for a in params[pname])
                print(f"    {pname}: ({spec})")
        pp = manifest.get("pipeline")
        if pp:
            print(f"  pipeline: stages={pp.get('stages')} "
                  f"axis={pp.get('axis', 'pp')} "
                  f"microbatches={pp.get('microbatches')} "
                  f"schedule={pp.get('schedule', '1f1b')} "
                  f"plan digest={pp.get('digest')} (params stored full; "
                  f"restore requires a matching pp axis size)")
    elif report.get("format"):
        print(f"legacy io-format checkpoint (no manifest); files: "
              f"{len(report.get('files', []))}")
    return 0


def _fmt_age(seconds):
    s = float(seconds)
    if s < 60:
        return f"{s:.0f}s"
    if s < 3600:
        return f"{s / 60:.0f}m"
    if s < 86400:
        return f"{s / 3600:.1f}h"
    return f"{s / 86400:.1f}d"


def _cmd_cache(args):
    import json

    from . import flags
    from .cache import L2Store

    root = args.dir or flags.get("compile_cache_dir")
    if not root:
        print("no cache dir: pass --dir or set FLAGS_compile_cache_dir",
              file=sys.stderr)
        return 2
    if not os.path.isdir(root):
        print(f"not a directory: {root}", file=sys.stderr)
        return 2
    store = L2Store(root)
    if args.cache_action == "ls":
        ents = store.entries()
        if args.json:
            print(json.dumps({
                "dir": root,
                "total_bytes": sum(e["bytes"] for e in ents),
                "entries": ents,
            }, indent=2))
            return 0
        if not ents:
            print(f"{root}: empty")
            return 0
        print(f"{'digest':<18} {'kind':<20} {'bytes':>10} {'age':>7} "
              f"{'torch':<16} status")
        for e in ents:
            print(f"{e['digest'][:16] + '..':<18} "
                  f"{e.get('kind', '?'):<20} {e['bytes']:>10} "
                  f"{_fmt_age(e['age_s']):>7} {e.get('torch', '?'):<16} "
                  f"{'ok' if e['ok'] else 'CORRUPT'}")
        total = sum(e["bytes"] for e in ents)
        print(f"{len(ents)} entries, {total / 1e6:.1f} MB in {root}")
        return 0
    if args.cache_action == "prune":
        max_mb = args.max_mb if args.max_mb is not None \
            else flags.get("compile_cache_dir_max_mb")
        removed = store.prune(int(max_mb) * (1 << 20))
        print(f"pruned {removed} entries "
              f"({store.total_bytes() / 1e6:.1f} MB resident, "
              f"cap {max_mb} MB)")
        return 0
    if args.cache_action == "clear":
        removed = store.clear()
        print(f"removed {removed} entries from {root}")
        return 0
    return 2


def _check_demo_program():
    """Small MLP training program for `check --selftest`."""
    import paddle_tpu_torch as fluid

    main, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, start):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, 16, act="relu")
        p = fluid.layers.fc(h, 1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(p, y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, ["x", "y"], [loss.name]


def _cmd_check(args):
    import json

    from . import analysis

    mesh_axes = None
    if args.mesh:
        mesh_axes = {}
        for part in args.mesh.split(","):
            if not part.strip():
                continue
            k, _, v = part.partition("=")
            try:
                mesh_axes[k.strip()] = int(v)
            except ValueError:
                print(f"bad --mesh entry {part!r} (want name=size)",
                      file=sys.stderr)
                return 2

    if args.selftest:
        # 1) a well-formed training program must verify clean ...
        prog, feeds, fetches = _check_demo_program()
        clean = analysis.verify(prog, level="full", feed_names=feeds,
                                fetch_names=fetches, mesh_axes=mesh_axes,
                                context="check --selftest")
        # 2) ... and the SAME program with an op knocked out must not:
        # drop the first fc's matmul, leaving its output undefined
        broken = prog.clone()
        ops = broken.global_block().ops
        del ops[next(i for i, op in enumerate(ops) if op.type == "mul")]
        bad = analysis.verify(broken, level="full", feed_names=feeds,
                              fetch_names=fetches, mesh_axes=mesh_axes,
                              context="check --selftest (broken)")
        ok = clean.ok and not bad.ok and "PTA001" in bad.codes()
        if args.json:
            print(json.dumps({"ok": ok, "clean": clean.to_dict(),
                              "broken": bad.to_dict()}, indent=2))
        else:
            print(clean.render(verbose=not args.quiet))
            print("--- intentionally broken program (must flag PTA001) ---")
            print(bad.render(verbose=not args.quiet))
            print(f"check selftest: {'OK' if ok else 'FAILED'}")
        return 0 if ok else 1

    if not args.model_dir:
        print("check needs --model-dir or --selftest", file=sys.stderr)
        return 2
    from .core.framework import Program

    model_path = os.path.join(args.model_dir, "__model__")
    try:
        with open(model_path) as f:
            payload = json.load(f)
    except (OSError, ValueError) as e:
        print(f"cannot load {model_path}: {e}", file=sys.stderr)
        return 2
    program = Program.from_dict(payload["program"])
    report = analysis.verify(
        program, level=args.level,
        feed_names=payload.get("feed_var_names"),
        fetch_names=payload.get("fetch_var_names"),
        mesh_axes=mesh_axes, context=f"check {args.model_dir}")
    if args.json:
        print(json.dumps(report.to_dict(), indent=2))
    else:
        print(report.render(verbose=not args.quiet))
    return report.rc


def _search_default(name):
    """search.py's default constant `name` (PEAK_FLOPS,
    LINK_BYTES_PER_S)."""
    from .parallel.autoshard import search

    return getattr(search, name)


def _schedule_default(name):
    """analysis/schedule.py's default constant `name` (DEFAULT_PEAK_FLOPS,
    DEFAULT_ICI_BYTES_PER_S)."""
    from .analysis import schedule

    return getattr(schedule, name)


def _shard_demo_program():
    """Small embedding+fc net with mp seeds on the embedding table and the
    first fc weight (the JAX command's demo net)."""
    import paddle_tpu_torch as fluid

    main, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, start):
        ids = fluid.layers.data(name="ids", shape=[1], dtype="int64")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        emb = fluid.layers.embedding(ids, size=[32, 16])
        h = fluid.layers.fc(emb, 32, act="relu")
        p = fluid.layers.fc(h, 1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(p, y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    gb = main.global_block()
    embw = next(n for n, v in gb.vars.items()
                if getattr(v, "persistable", False) and v.shape == (32, 16))
    w1 = next(n for n, v in gb.vars.items()
              if getattr(v, "persistable", False) and v.shape == (16, 32))
    fluid.parallel.set_sharding(gb.var(embw), ("mp", None))
    fluid.parallel.set_sharding(gb.var(w1), (None, "mp"))
    return main


def _shard_mesh(text):
    """{axis: size} of a --mesh value, or None (printed) when malformed."""
    mesh_axes = {}
    for part in (text or "").split(","):
        if not part.strip():
            continue
        k, _, v = part.partition("=")
        try:
            mesh_axes[k.strip()] = int(v)
        except ValueError:
            print(f"bad --mesh entry {part!r} (want name=size)",
                  file=sys.stderr)
            return None
    if not mesh_axes:
        print("empty --mesh", file=sys.stderr)
        return None
    return mesh_axes


def _shard_program(args, action):
    """The program `shard <action>` reads, or None (printed)."""
    if args.selftest:
        return _shard_demo_program()
    if args.model_dir:
        loaded = _load_saved_program(args.model_dir)
        if isinstance(loaded, str):
            print(loaded, file=sys.stderr)
            return None
        return loaded[0]
    print(f"shard {action} needs --model-dir or --selftest",
          file=sys.stderr)
    return None


def _cmd_shard(args):
    import json

    from .parallel import autoshard

    mesh_axes = _shard_mesh(args.mesh)
    if mesh_axes is None:
        return 1
    if args.shard_action == "search":
        return _cmd_shard_search(args, mesh_axes)
    seeds = {}
    for s in args.seed or []:
        name, _, spec_s = s.partition("=")
        seeds[name.strip()] = tuple(
            None if e.strip() in ("", "None", "none", "-") else e.strip()
            for e in spec_s.split(","))
    program = _shard_program(args, "plan")
    if program is None:
        return 1
    try:
        plan = autoshard.build_plan(program, mesh_axes,
                                    batch_axis=args.batch_axis,
                                    extra_seeds=seeds or None)
    except (TypeError, ValueError) as e:
        print(f"shard plan error: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(plan.describe(), indent=2))
    else:
        print(plan.render(verbose=not args.quiet))
    ok = plan.is_total() and not plan.unresolved
    if args.selftest:
        ok = ok and len(plan.sharded_names()) > 0
        # stderr so --json stdout stays machine-parseable
        print(f"shard plan selftest: {'OK' if ok else 'FAILED'}",
              file=sys.stderr if args.json else sys.stdout)
    return 0 if ok else 2


def _cmd_shard_search(args, mesh_axes):
    """`shard search`: enumerate seed placements, score whole plans with
    the unified cost model, report the cheapest vs the manual seeds.
    rc 0 search ok, 1 plan/search error, 2 selftest contract violated."""
    import json

    from .parallel import autoshard

    program = _shard_program(args, "search")
    if program is None:
        return 1
    try:
        res = autoshard.search_plan(
            program, mesh_axes, batch_axis=args.batch_axis,
            batch_size=args.batch, hbm_budget=args.hbm_budget,
            max_params=args.max_params, rounds=args.rounds,
            peak_flops=args.peak_tflops * 1e12,
            link_bytes_per_s=args.link_gbps * 1e9)
    except (TypeError, ValueError) as e:
        print(f"shard search error: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(res.to_dict(), indent=2))
    else:
        print(res.render())
        if not args.quiet:
            print(res.plan.render(verbose=False))
    ok = res.plan.is_total() and not res.plan.unresolved \
        and res.cost["score_s"] <= res.manual_cost["score_s"]
    if args.selftest:
        # the searched plan must never lose to the manual seeds, and the
        # demo net must actually end up sharded
        ok = ok and len(res.plan.sharded_names()) > 0
        print(f"shard search selftest: {'OK' if ok else 'FAILED'}",
              file=sys.stderr if args.json else sys.stdout)
    return 0 if ok else 2


def _load_saved_program(model_dir):
    """(program, feed_names, fetch_names) from a save_inference_model dir,
    or an error string."""
    import json

    from .core.framework import Program

    model_path = os.path.join(model_dir, "__model__")
    try:
        with open(model_path) as f:
            payload = json.load(f)
    except (OSError, ValueError) as e:
        return f"cannot load {model_path}: {e}"
    return (Program.from_dict(payload["program"]),
            payload.get("feed_var_names"),
            payload.get("fetch_var_names"))


def _seed_cycle(program):
    """Clone with a genuine def-use cycle appended (two scale ops reading
    each other's outputs) — the `analyze graph --selftest` mutation."""
    from .core.framework import OP_ROLE_ATTR_NAME, OpRole

    clone = program.clone()
    gb = clone.global_block()
    for nm in ("a_cyc", "b_cyc"):
        gb.create_var(name=nm, shape=[1], dtype="float32")
    role = {OP_ROLE_ATTR_NAME: int(OpRole.Forward), "scale": 1.0}
    gb.append_op(type="scale", inputs={"X": ["b_cyc"]},
                 outputs={"Out": ["a_cyc"]}, attrs=dict(role))
    gb.append_op(type="scale", inputs={"X": ["a_cyc"]},
                 outputs={"Out": ["b_cyc"]}, attrs=dict(role))
    return clone


def _cmd_analyze(args):
    import json

    from .analysis import ProgramVerificationError, Report, dataflow

    mesh_axes = None
    if getattr(args, "mesh", None):
        mesh_axes = {}
        for part in args.mesh.split(","):
            if not part.strip():
                continue
            k, _, v = part.partition("=")
            try:
                mesh_axes[k.strip()] = int(v)
            except ValueError:
                print(f"bad --mesh entry {part!r} (want name=size)",
                      file=sys.stderr)
                return 2

    def _resolve_program():
        """(program, feeds) for the non-selftest path, honoring --zero1."""
        if not args.model_dir:
            print(f"analyze {args.analyze_action} needs --model-dir or "
                  f"--selftest", file=sys.stderr)
            return None
        loaded = _load_saved_program(args.model_dir)
        if isinstance(loaded, str):
            print(loaded, file=sys.stderr)
            return None
        program, feeds, _ = loaded
        if args.zero1:
            from .parallel import zero1 as _z1
            program, _ = _z1.apply(program, args.zero1)
        return program, feeds

    if args.analyze_action == "schedule":
        return _cmd_analyze_schedule(args, mesh_axes)
    if args.analyze_action == "pipeline":
        return _cmd_analyze_pipeline(args)

    if args.analyze_action == "graph":
        if args.selftest:
            prog, feeds, _ = _check_demo_program()
            if args.zero1:
                from .parallel import zero1 as _z1
                prog, _ = _z1.apply(prog, args.zero1)
            graph = dataflow.build_graph(prog, feed_names=feeds)
            clean = Report(level="full", context="analyze graph --selftest")
            dataflow.check_hazards(prog, clean, feed_names=feeds,
                                   graph=graph)
            seeded = Report(level="full",
                            context="analyze graph --selftest (cyclic)")
            dataflow.check_hazards(_seed_cycle(prog), seeded,
                                   feed_names=feeds)
            ok = clean.ok and not graph.has_cycle \
                and not seeded.ok and "PTA030" in seeded.codes()
            if args.json:
                print(json.dumps({"ok": ok, "graph": graph.summary(),
                                  "clean": clean.to_dict(),
                                  "seeded": seeded.to_dict()}, indent=2))
            else:
                print(f"graph: {graph.summary()}")
                print(clean.render(verbose=not args.quiet))
                print("--- seeded cyclic clone (must flag PTA030) ---")
                print(seeded.render(verbose=not args.quiet))
                print(f"analyze graph selftest: {'OK' if ok else 'FAILED'}")
            return 0 if ok else 1
        resolved = _resolve_program()
        if resolved is None:
            return 2
        program, feeds = resolved
        report = Report(level="full",
                        context=f"analyze graph {args.model_dir}")
        graph = dataflow.check_hazards(program, report, feed_names=feeds)
        if args.json:
            print(json.dumps({"graph": graph.summary(),
                              "report": report.to_dict()}, indent=2))
        else:
            print(f"graph: {graph.summary()}")
            print(report.render(verbose=not args.quiet))
        return report.rc

    if args.analyze_action == "fusion":
        from . import analysis, fusion

        bucket_bytes = (args.bucket_mb << 20) if args.bucket_mb else None

        def render(plan):
            if plan is None:
                return "fusion: nothing fused"
            lines = [f"fusion: ops {plan.n_ops_before} -> "
                     f"{plan.n_ops_after}  digest={plan.digest()}"]
            for c in plan.chains:
                lines.append(f"  chain  {'+'.join(c['types'])}  "
                             f"{c['vars'][0]} -> {c['vars'][1]}  "
                             f"benefit={c['benefit_us']}us")
            for b in plan.buckets:
                lines.append(f"  bucket fused_{b['opt']}_update x{b['n']} "
                             f"bytes={b['bytes']} "
                             f"shard_rows={b['shard_rows']}")
            if plan.skipped and not args.quiet:
                for base, why in plan.skipped:
                    lines.append(f"  skipped {base}: {why}")
            return "\n".join(lines)

        if args.selftest:
            import paddle_tpu_torch as fluid

            # training demo: 6 params under adam -> one fused bucket,
            # and the fused program must verify clean at level full
            main, start = fluid.Program(), fluid.Program()
            with fluid.unique_name.guard(), \
                    fluid.program_guard(main, start):
                x = fluid.layers.data(name="x", shape=[8],
                                      dtype="float32")
                y = fluid.layers.data(name="y", shape=[1],
                                      dtype="float32")
                h = fluid.layers.fc(x, 16, act="relu")
                h2 = fluid.layers.fc(h, 8, act="relu")
                p = fluid.layers.fc(h2, 1)
                loss = fluid.layers.mean(
                    fluid.layers.square_error_cost(p, y))
                fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
            fused, plan = fusion.apply(main, feed_names=["x", "y"],
                                       fetch_names=[loss.name],
                                       bucket_bytes=bucket_bytes)
            rep = analysis.verify(fused, feed_names=["x", "y"],
                                  fetch_names=[loss.name], level="full",
                                  context="analyze fusion --selftest")
            ok = plan is not None and bool(plan.buckets) \
                and max(b["n"] for b in plan.buckets) >= 2 and rep.ok

            # inference demo: an elementwise chain must fuse vertically
            inf = fluid.Program()
            with fluid.unique_name.guard(), \
                    fluid.program_guard(inf, fluid.Program()):
                xi = fluid.layers.data(name="x", shape=[64],
                                       dtype="float32")
                out = fluid.layers.scale(
                    fluid.layers.sigmoid(fluid.layers.tanh(
                        fluid.layers.relu(xi))), scale=2.0)
            _, vplan = fusion.apply(inf, feed_names=["x"],
                                    fetch_names=[out.name])
            ok = ok and vplan is not None and len(vplan.chains) >= 1

            # a hazardous source program must be REFUSED, never fused
            refused, codes = False, []
            try:
                fusion.apply(_seed_cycle(main), feed_names=["x", "y"],
                             fetch_names=[loss.name])
            except ProgramVerificationError as e:
                refused = True
                codes = sorted(e.report.codes())
            ok = ok and refused and "PTA030" in codes
            if args.json:
                print(json.dumps({
                    "ok": bool(ok),
                    "plan": plan.to_dict() if plan else None,
                    "vertical": vplan.to_dict() if vplan else None,
                    "verify_ok": rep.ok,
                    "seeded_refused": refused,
                    "seeded_codes": codes}, indent=2))
            else:
                print(render(plan))
                print(render(vplan))
                print("--- seeded cyclic source: "
                      + ("refused " + str(codes) if refused
                         else "NOT refused") + " ---")
                print("analyze fusion selftest: "
                      + ("OK" if ok else "FAILED"))
            return 0 if ok else 1

        resolved = _resolve_program()
        if resolved is None:
            return 2
        program, feeds = resolved
        try:
            fused, plan = fusion.apply(program, feed_names=feeds,
                                       bucket_bytes=bucket_bytes)
        except ProgramVerificationError as e:
            print(e.report.render(verbose=not args.quiet),
                  file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(plan.to_dict() if plan else None, indent=2))
        else:
            print(render(plan))
        return 0


def _seed_gather_rewire(program):
    """Clone of a zero1-rewritten program whose first zero1_gather is
    rewired to consume the PRE-update param shard: the flat index order
    stays valid (PTA012-clean) but the gather no longer consumes the
    update, the dependence-path divergence only PTA033 sees."""
    clone = program.clone()
    gb = clone.global_block()
    gat = next(op for op in gb.ops if op.type == "zero1_gather")
    pupd = gat.input("X")[0]
    gat.rename_input(pupd, pupd.replace("@zero1_upd", "@zero1_shard"))
    clone._mutation += 1
    return clone


def _cmd_analyze_schedule(args, mesh_axes):
    """`analyze schedule`: the JAX command's report and rc codes, costed
    at --peak-tflops / --link-gbps. A zero1-rewritten program is costed in
    the JAX package's layout (zero1.global_view: [W, shard] where a rank
    holds [1, shard]) and reordered as it is."""
    import json

    from .analysis import ProgramVerificationError, schedule
    from .parallel import zero1 as _z1

    knobs = {"peak_flops": args.peak_tflops * 1e12,
             "ici_bytes_per_s": args.link_gbps * 1e9}
    if args.selftest:
        prog, feeds, _ = _check_demo_program()
        parts = args.zero1 or (mesh_axes or {}).get("dp", 8)
        z, zplan = _z1.apply(prog, parts)
        sched = schedule.analyze(
            _z1.global_view(z, zplan), mesh_axes=mesh_axes or {"dp": parts},
            feed_names=feeds, batch_size=args.batch,
            bucket_bytes=args.bucket_bytes, **knobs)
        reordered, plan = schedule.apply_plan(z, sched.plan,
                                              feed_names=feeds)
        ok = sched.critical_path_ms > 0 and len(plan.buckets) > 0 \
            and len(plan.moves) > 0 and reordered is not z
        # the seeded divergence must be REJECTED, never silently scheduled
        rejected = False
        codes = []
        try:
            schedule.analyze(_seed_gather_rewire(z),
                             mesh_axes=mesh_axes or {"dp": parts},
                             feed_names=feeds, **knobs)
        except ProgramVerificationError as e:
            rejected = True
            codes = sorted(e.report.codes())
        ok = ok and rejected and "PTA033" in codes
        if args.json:
            print(json.dumps({"ok": ok, "schedule": sched.to_dict(),
                              "seeded_rejected": rejected,
                              "seeded_codes": codes}, indent=2))
        else:
            print(sched.render())
            print(f"--- seeded gather-rewire clone: "
                  f"{'rejected ' + str(codes) if rejected else 'NOT rejected'}"
                  f" ---")
            print(f"analyze schedule selftest: {'OK' if ok else 'FAILED'}")
        return 0 if ok else 1

    if not args.model_dir:
        print("analyze schedule needs --model-dir or --selftest",
              file=sys.stderr)
        return 2
    loaded = _load_saved_program(args.model_dir)
    if isinstance(loaded, str):
        print(loaded, file=sys.stderr)
        return 2
    program, feeds, _ = loaded
    if args.zero1:
        program, zplan = _z1.apply(program, args.zero1)
        program = _z1.global_view(program, zplan)
    try:
        sched = schedule.analyze(
            program, mesh_axes=mesh_axes, feed_names=feeds,
            batch_size=args.batch, bucket_bytes=args.bucket_bytes, **knobs)
    except ProgramVerificationError as e:
        print(e.report.render(verbose=not args.quiet), file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(sched.to_dict(), indent=2))
    else:
        print(sched.render())
    return 0


def _pipeline_demo_program():
    """Fixed-name 3-layer MLP trainer for `analyze pipeline --selftest` —
    explicit layer names so two builds yield identical param names (and
    therefore identical startup init) for the parity comparison (the JAX
    command's net)."""
    import paddle_tpu_torch as fluid

    main, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, start):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, 32, act="relu", name="pls1")
        h = fluid.layers.fc(h, 16, act="relu", name="pls2")
        p = fluid.layers.fc(h, 1, name="pls3")
        loss = fluid.layers.mean(fluid.layers.square_error_cost(p, y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, start, ["x", "y"], loss.name


def _pipeline_selftest(p, m, place):
    """The selftest's result dict: the demo net through PipelineRunner at
    p stages and at one (same microbatching, same start), its structural
    bubble, and a seeded backwards-edge split (must be refused, PTA040)."""
    import numpy as np

    from .analysis import ProgramVerificationError
    from .core.scope import Scope
    from .executor import Executor
    from .parallel import pipeline as pl

    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(4 * m, 16).astype(np.float32),
            "y": rng.randn(4 * m, 1).astype(np.float32)}

    def run(n_stages):
        main, start, feeds, loss_name = _pipeline_demo_program()
        scope = Scope()
        Executor(place).run(start, scope=scope)
        runner = pl.PipelineRunner(
            main, n_stages, loss_name=loss_name, feed_names=feeds,
            n_microbatches=m, scope=scope, batch_size=4 * m, place=place)
        reports = [runner.run(feed) for _ in range(2)]
        return [np.asarray(r["loss"]) for r in reports], reports[-1]

    ref_losses, _ = run(1)
    losses, rep = run(p)
    parity = all(a.tobytes() == b.tobytes()
                 for a, b in zip(ref_losses, losses))
    bound = pl.analytic_bubble(p, m)
    bubble_ok = abs(rep["bubble_fraction"] - bound) <= 1e-9

    # a split that sends forward data to an EARLIER stage must be
    # refused, never silently executed
    main, start, feeds, loss_name = _pipeline_demo_program()
    plan = pl.partition(main, max(2, p), feed_names=feeds,
                        batch_size=4 * m)
    # force a forward def-use edge to run BACKWARDS: producer (the first
    # matmul) onto the last stage, its consumer onto stage 0
    ops = main.global_block().ops
    u = min(i for i, op in enumerate(ops)
            if plan.phases[i] == pl.PHASE_FWD and op.type == "mul")
    outs = set(ops[u].output_arg_names())
    v = min(i for i, op in enumerate(ops)
            if i > u and plan.phases[i] == pl.PHASE_FWD
            and outs & set(op.input_arg_names()))
    plan.assignment[u] = plan.n_stages - 1
    plan.assignment[v] = 0
    rejected, codes = False, []
    try:
        pl.build_stage_programs(main, plan, feed_names=feeds,
                                fetch_names=[loss_name])
    except ProgramVerificationError as e:
        rejected = True
        codes = sorted(e.report.codes())
    return {
        "ok": parity and bubble_ok and rejected and "PTA040" in codes,
        "parity_bitwise": parity,
        "losses": [float(np.asarray(x).reshape(-1)[0]) for x in losses],
        "bubble_fraction": rep["bubble_fraction"],
        "bubble_analytic": bound,
        "bubble_measured": rep["bubble_measured"],
        "n_stages": p, "n_microbatches": m,
        "seeded_rejected": rejected, "seeded_codes": codes,
        "plan": rep["plan"],
    }


def _cmd_analyze_pipeline(args):
    """`analyze pipeline`: partition a program over the pp axis, verify
    the split (PTA040/041), and report the 1F1B schedule + bubble.

    --selftest additionally 1F1B-executes the demo net at the requested
    stage count (on --place), asserts bitwise loss parity against an
    unpartitioned (n_stages=1) replay with identical microbatching,
    asserts the structural bubble equals the analytic (p-1)/(m+p-1)
    bound, and asserts a seeded backwards-edge mutation is REFUSED with
    PTA040. rc 0 ok, 1 contract violated / illegal split, 2 usage
    error."""
    from . import flags
    from .analysis import Report
    from .parallel import pipeline as pl

    p, m = args.stages, args.microbatches
    if p is None:
        p = flags.get("pipeline_stages") or 2
    if p < 1 or m < 1:
        print("--stages and --microbatches must be >= 1", file=sys.stderr)
        return 2

    if args.selftest:
        result = _pipeline_selftest(p, m, _place(args.place))
        if args.json:
            print(json.dumps(result, indent=2))
        else:
            print(f"pipeline: {p} stages x {m} microbatches  "
                  f"bubble {result['bubble_fraction']:.4f} "
                  f"(analytic {result['bubble_analytic']:.4f}, measured "
                  f"{result['bubble_measured']:.4f})")
            print(f"  bitwise loss parity vs n_stages=1: "
                  f"{result['parity_bitwise']}")
            codes = result["seeded_codes"]
            print(f"--- seeded backwards-edge clone: "
                  f"{'rejected ' + str(codes) if result['seeded_rejected'] else 'NOT rejected'}"
                  f" ---")
            print(f"analyze pipeline selftest: "
                  f"{'OK' if result['ok'] else 'FAILED'}")
        return 0 if result["ok"] else 1

    if not args.model_dir:
        print("analyze pipeline needs --model-dir or --selftest",
              file=sys.stderr)
        return 2
    loaded = _load_saved_program(args.model_dir)
    if isinstance(loaded, str):
        print(loaded, file=sys.stderr)
        return 2
    program, feeds, _ = loaded
    try:
        plan = pl.partition(program, p, feed_names=feeds,
                            batch_size=args.batch)
    except ValueError as e:
        print(f"analyze pipeline error: {e}", file=sys.stderr)
        return 2
    report = Report(level="full",
                    context=f"analyze pipeline {args.model_dir}")
    pl.check_partition(program, plan, report, feed_names=feeds)
    sim = pl.simulate_schedule(pl.schedule_1f1b(p, m))
    out = {
        "plan": plan.to_dict(),
        "bubble_analytic": pl.analytic_bubble(p, m),
        "bubble_fraction": sim["bubble_fraction"],
        "n_microbatches": m,
        "report": report.to_dict(),
    }
    if args.json:
        print(json.dumps(out, indent=2))
    else:
        print(plan.describe())
        print(f"  1F1B x {m} microbatches: bubble "
              f"{sim['bubble_fraction']:.4f} "
              f"(analytic {out['bubble_analytic']:.4f})")
        print(report.render(verbose=not args.quiet))
    return report.rc


def _place(name):
    """--place cuda|cpu -> a Place: the first card unless `cpu` (the
    port's rule; the JAX package's `fleet replica` defaults to cpu)."""
    from .core.places import CPUPlace, CUDAPlace

    return CPUPlace() if name == "cpu" else CUDAPlace(0)


def _cmd_serve(args):
    import threading

    import numpy as np

    from . import flags
    from .serve import ServeConfig, Server
    from .serve.http import serve_http

    if args.cache_dir:
        # the persistent store of prepared plans: bucket warm-up loads the
        # plans an earlier process stored (FLAGS_compile_cache_dir)
        flags.set("compile_cache_dir", args.cache_dir)
    config = ServeConfig(
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        replicas=args.replicas, slo_ms=args.slo_ms,
        max_queue_rows=args.max_queue_rows)
    try:
        server = Server.from_inference_model(
            args.model_dir, place=_place(args.place), config=config)
    except (OSError, ValueError) as e:
        print(f"cannot load inference model: {e}", file=sys.stderr)
        return 1
    server.start()
    print(f"ready: buckets={list(server.config.buckets)} "
          f"replicas={config.replicas} "
          f"warm_compiles={server._warm_entries}", file=sys.stderr)
    if args.http is not None:
        print(f"http frontend on {args.host}:{args.http}", file=sys.stderr)
        serve_http(server, host=args.host, port=args.http)
        return 0
    # selftest: synthetic single-example requests from the feed shapes,
    # a handful of concurrent clients so the batcher actually batches
    n, per = args.selftest, max(1, args.selftest // 8)
    rng = np.random.RandomState(0)

    def fire(k):
        for _ in range(k):
            feed = {name: rng.standard_normal(
                server._example_shape(name)).astype(
                server._feed_dtype(name))
                for name in server.feed_names}
            server.submit(feed).result()

    threads = [threading.Thread(target=fire, args=(per,))
               for _ in range(-(-n // per))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stats = server.stats()
    server.stop()
    print(json.dumps(stats, indent=2))
    return 0 if stats["steady_state_compiles"] == 0 else 1


def _cmd_fleet_replica(args):
    import signal
    import threading

    from . import flags
    from .serve import ServeConfig, Server
    from .serve.http import make_http_server

    if args.cache_dir:
        # fleet spin-up: the replicas share one store of prepared plans,
        # so only the first one prepares each bucket from scratch
        flags.set("compile_cache_dir", args.cache_dir)
    if args.compile_service:
        # ... or each replica has its own store (the compile service
        # commits fetched plans there) and the first MISSER prepares
        # while the rest fetch the plan by digest
        if not args.cache_dir:
            print("fleet replica: --compile-service needs --cache-dir, the "
                  "store its fetched plans land in", file=sys.stderr)
            return 2
        flags.set("compile_service", args.compile_service)
    if args.chaos_kill_at is not None or args.chaos_hang_at is not None \
            or args.chaos_delay_ms is not None:
        from .resilience import chaos

        monkey = chaos.ChaosMonkey()
        if args.chaos_kill_at is not None:
            monkey.add(chaos.Fault("replica_kill", at=args.chaos_kill_at))
        if args.chaos_hang_at is not None:
            monkey.add(chaos.Fault("replica_hang", at=args.chaos_hang_at,
                                   times=args.chaos_hang_times,
                                   delay_ms=args.chaos_hang_ms))
        if args.chaos_delay_ms is not None:
            # every dispatch: a deterministic per-batch service-time
            # floor -> replica capacity ~= 1000/delay_ms batches/s on
            # any host, which makes autoscale drills reproducible
            monkey.add(chaos.Fault("delay", at=0, times=1 << 62,
                                   delay_ms=args.chaos_delay_ms))
        chaos.install(monkey)
    config = ServeConfig(
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        replicas=args.replicas, max_queue_rows=args.max_queue_rows,
        slo_ms=args.slo_ms)
    try:
        server = Server.from_inference_model(
            args.model_dir, place=_place(args.place), config=config)
    except (OSError, ValueError) as e:
        print(f"cannot load inference model: {e}", file=sys.stderr)
        return 1
    if args.amp:
        from . import amp

        amp.enable(args.amp)
    server.start()
    # a drained replica's frontend shuts itself down -> serve_forever
    # returns -> this process exits 0: the rolling-restart contract
    httpd = make_http_server(server, host=args.host, port=args.port,
                             shutdown_on_drain=True)
    port = httpd.server_address[1]
    endpoint = f"{args.host}:{port}"
    name = args.name or f"replica-{port}"
    if args.port_file:
        # written whole, then renamed: a reader never sees a partial port
        tmp = f"{args.port_file}.tmp"
        with open(tmp, "w") as f:
            f.write(f"{port}\n")
        os.replace(tmp, args.port_file)
    print(f"replica {name} serving on {endpoint}", file=sys.stderr)

    obs_client = None
    if args.obs:
        from . import obs as obs_mod

        obs_client = obs_mod.maybe_start("replica", replica=name,
                                         endpoint=args.obs)

    heartbeater = None
    stop_beats = threading.Event()
    if args.master:
        from .parallel.master import Heartbeater, MasterClient

        heartbeater = Heartbeater(MasterClient(args.master), "serve",
                                  name, endpoint, ttl=args.ttl)
        heartbeater.start()
    elif args.router:
        import http.client

        def _register_loop():
            body = json.dumps({"name": name, "endpoint": endpoint})
            while not server._stop and not stop_beats.is_set():
                try:
                    host, rport = args.router.rsplit(":", 1)
                    conn = http.client.HTTPConnection(host, int(rport),
                                                      timeout=2.0)
                    try:
                        conn.request("POST", "/admin/register", body=body)
                        conn.getresponse().read()
                    finally:
                        conn.close()
                except OSError:
                    pass  # router restart: next beat re-registers
                stop_beats.wait(max(0.5, args.ttl / 3.0))

        threading.Thread(target=_register_loop, name="fleet-register",
                         daemon=True).start()

    def _sigterm(signum, frame):
        # SIGTERM = drain, not die: finish the backlog, THEN stop the
        # HTTP loop — same ordering as /admin/drain's shutdown_on_drain
        # path, so serve_forever() only returns once the queue is empty
        def _drain_then_exit():
            server.drain()
            httpd.shutdown()

        threading.Thread(target=_drain_then_exit, name="serve-drain-sig",
                         daemon=True).start()

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        server.drain()
    finally:
        httpd.server_close()
        stop_beats.set()
        if heartbeater is not None:
            heartbeater.close()
    stats = server.stats()
    server.stop()
    if obs_client is not None:
        # final push AFTER stop: the collector sees the terminal journal
        # tail and any shutdown trace dump
        obs_client.stop()
    leftover = stats["queue_rows"]
    print(f"replica {name} exiting: drained queue_rows={leftover}",
          file=sys.stderr)
    return 0 if leftover == 0 else 1


def _cmd_fleet_router(args):
    from .serve.fleet import FleetConfig, Router, serve_fleet

    replicas = {}
    if args.replicas:
        for i, ep in enumerate(e for e in args.replicas.split(",") if e):
            replicas[f"r{i}"] = ep
    discover = None
    if args.master:
        from .parallel.master import MasterClient

        client = MasterClient(args.master)
        discover = lambda: client.lookup("serve")  # noqa: E731
    if not replicas and discover is None and not args.autoscale_model_dir:
        print("router needs --replicas, --master or "
              "--autoscale-model-dir; replicas may also join over POST "
              "/admin/register", file=sys.stderr)
        return 1
    config = FleetConfig(
        probe_interval_s=args.probe_interval,
        request_deadline_ms=args.deadline_ms,
        attempt_timeout_ms=args.attempt_timeout_ms,
        max_attempts=args.max_attempts, hedge_ms=args.hedge_ms)
    router = Router(replicas, config=config, discover=discover)
    obs_client = None
    if args.obs:
        from . import obs as obs_mod

        obs_client = obs_mod.maybe_start("router", endpoint=args.obs)
    autoscaler = None
    if args.autoscale_model_dir:
        import tempfile

        from .serve.fleet import (Autoscaler, AutoscalerConfig,
                                  ProcessReplicaSpawner)

        workdir = tempfile.mkdtemp(prefix="fleet_autoscale_")
        argv_base = [sys.executable, "-m", "paddle_tpu_torch", "fleet",
                     "replica", "--model-dir", args.autoscale_model_dir,
                     "--port", "0"]
        if args.compile_service:
            argv_base += ["--compile-service", args.compile_service]
        if args.autoscale_cache_dir:
            argv_base += ["--cache-dir", args.autoscale_cache_dir]
        spawner = ProcessReplicaSpawner(
            argv_base, workdir,
            per_replica_cache=not args.autoscale_cache_dir)
        autoscaler = Autoscaler(router, spawner, AutoscalerConfig(
            target_p99_ms=args.autoscale_target_p99_ms,
            high_queue_rows=args.autoscale_queue_rows,
            min_replicas=args.autoscale_min,
            max_replicas=args.autoscale_max,
            interval_s=args.autoscale_interval,
            cooldown_out_s=args.autoscale_cooldown_out,
            cooldown_in_s=args.autoscale_cooldown_in)).start()
    print(f"fleet router on {args.host}:{args.port} over "
          f"{sorted(replicas.values()) or 'registered replicas'}"
          f"{' and master-discovered replicas' if discover else ''}",
          file=sys.stderr)
    serve_fleet(router, host=args.host, port=args.port)
    if autoscaler is not None:
        autoscaler.stop()
        autoscaler.spawner.stop_all()
    if obs_client is not None:
        obs_client.stop()
    return 0


def _cmd_elastic(args):
    from .parallel import elastic as elastic_mod

    if args.elastic_action == "status":
        try:
            st = elastic_mod.fetch_status(args.master, timeout=args.timeout)
        except OSError as e:
            print(f"cannot reach master {args.master}: {e}",
                  file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(st, indent=2))
        else:
            print(f"elastic job at {st['endpoint']}: epoch={st['epoch']} "
                  f"world_size={st['world_size']}")
            for name, addr in sorted(st["members"].items()):
                print(f"  {name}" + (f"  {addr}" if addr else ""))
        return 0
    if args.elastic_action == "drain":
        from .parallel.master import MasterClient

        client = MasterClient(args.master, connect_timeout=args.timeout)
        try:
            r = client.elastic_leave(args.name)
        except OSError as e:
            print(f"cannot reach master {args.master}: {e}",
                  file=sys.stderr)
            return 1
        finally:
            client.close()
        print(f"drained {args.name}: membership epoch now {r['epoch']} "
              f"(survivors resize at their next step boundary)")
        return 0
    return 1


def _cmd_obs(args):
    from . import obs as obs_mod

    if args.obs_action == "collect":
        import threading

        col = obs_mod.Collector(ttl_s=args.ttl,
                                straggler_ratio=args.straggler_ratio,
                                straggler_steps=args.straggler_steps)
        for target in args.scrape or []:
            name, _, endpoint = target.rpartition("=")
            col.add_scrape_target(name or endpoint, endpoint)
        httpd = obs_mod.make_obs_http(col, host=args.host, port=args.port)
        port = httpd.server_address[1]
        if args.port_file:
            with open(args.port_file, "w") as f:
                f.write(f"{port}\n")
        print(f"obs collector on {args.host}:{port} "
              f"(POST /v1/obs/push, GET /metrics /v1/obs/summary "
              f"/v1/obs/timeline; {len(args.scrape or [])} scrape "
              f"target(s))", file=sys.stderr)
        stop = threading.Event()
        if args.scrape:
            col.scrape_tick()

            def _scrape_loop():
                while not stop.wait(args.scrape_interval):
                    col.scrape_tick()

            threading.Thread(target=_scrape_loop, name="obs-scrape",
                             daemon=True).start()
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            stop.set()
            httpd.server_close()
        return 0

    if args.obs_action == "top":
        return obs_mod.run_top(
            args.collector, interval_s=args.interval, once=args.once,
            json_out=args.json, iterations=args.iterations)

    if args.obs_action == "timeline":
        from .trace import load_dump

        dump_dirs = []        # [(lane name or None, dir)]
        merged_steps = None
        if args.collector:
            import http.client

            try:
                host, port = args.collector.rsplit(":", 1)
                conn = http.client.HTTPConnection(host, int(port),
                                                  timeout=5.0)
                try:
                    conn.request("GET", "/v1/obs/timeline")
                    resp = conn.getresponse()
                    body = resp.read()
                    if resp.status != 200:
                        raise OSError(f"HTTP {resp.status}")
                finally:
                    conn.close()
                tl = json.loads(body)
            except (OSError, ValueError) as e:
                print(f"cannot reach collector {args.collector}: {e}",
                      file=sys.stderr)
                return 2
            merged_steps = tl.get("timeline")
            dump_dirs.extend((d.get("replica"), d["dir"])
                             for d in tl.get("dumps", []))
        for d in args.dump or []:
            dump_dirs.append((None, d))
        if not dump_dirs and merged_steps is None:
            print("obs timeline needs --collector and/or --dump",
                  file=sys.stderr)
            return 2
        dumps, names = [], []
        for lane, d in dump_dirs:
            try:
                dumps.append(load_dump(d))
            except (OSError, ValueError) as e:
                print(f"skipping dump {d}: {e}", file=sys.stderr)
                continue
            names.append(lane or os.path.basename(d.rstrip("/")))
        if merged_steps is not None:
            print(obs_mod.format_timeline(merged_steps))
        if dumps:
            trace = obs_mod.merge_chrome_traces(dumps, names=names)
            lanes = {e['pid'] for e in trace['traceEvents']}
            print(f"merged trace: {len(dumps)} dump(s), "
                  f"{len(lanes)} pid lane(s), "
                  f"{sum(1 for e in trace['traceEvents'] if e['ph'] == 'X')}"
                  f" span event(s)")
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(trace, f)
                print(f"wrote {args.out}")
        elif args.out:
            print("no trace dumps to merge (nothing written)",
                  file=sys.stderr)
            return 1
        return 0
    return 1


def _cmd_trace(args):
    from . import trace

    if args.trace_action == "ops":
        import numpy as np

        from . import flags
        from .core.scope import Scope, scope_guard
        from .executor import Executor
        from .io import load_inference_model

        flags.set("monitor", True)
        flags.set("monitor_hlo_cost", True)
        flags.set("trace", True)
        exe = Executor(_place(args.place))
        scope = Scope()
        try:
            with scope_guard(scope):
                program, feed_names, fetch_targets = load_inference_model(
                    args.model_dir, exe)
        except (OSError, ValueError) as e:
            print(f"cannot load inference model: {e}", file=sys.stderr)
            return 1
        feed = {}
        for name in feed_names:
            var = program.global_block().var(name)
            shape = [args.batch if d is None or d < 0 else d
                     for d in var.shape]
            feed[name] = np.zeros(shape, dtype=var.dtype)
        with scope_guard(scope):
            exe.run(program, feed=feed, fetch_list=fetch_targets)
        report = trace.slowest_ops(batch_size=args.batch, top=args.top)
        if report is None:
            print("no compile recorded — nothing to attribute",
                  file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(report, indent=2))
        else:
            print(trace.format_ops_table(report))
        return 0

    if args.trace_action == "summary":
        try:
            loaded = trace.load_dump(args.dir)
        except (OSError, ValueError) as e:
            print(f"cannot load dump: {e}", file=sys.stderr)
            return 1
        man, spans = loaded["manifest"], loaded["spans"]
        print(f"dump: {args.dir}")
        print(f"  reason={man.get('reason')} format={man.get('format')} "
              f"spans={len(spans)} dropped={man.get('dropped')} "
              f"traces={man.get('traces')}")
        by_name = {}
        for sp in spans:
            agg = by_name.setdefault(sp["name"], [0, 0.0])
            agg[0] += 1
            agg[1] += sp["t1"] - sp["t0"]
        print(f"  {'span':<24} {'count':>6} {'total_ms':>10} {'avg_ms':>9}")
        for name, (n, tot) in sorted(by_name.items(),
                                     key=lambda kv: -kv[1][1]):
            print(f"  {name:<24} {n:>6} {tot * 1e3:>10.2f} "
                  f"{tot * 1e3 / n:>9.3f}")
        slow = sorted(spans, key=lambda s: s["t0"] - s["t1"])[:5]
        print("  slowest spans:")
        for sp in slow:
            print(f"    {(sp['t1'] - sp['t0']) * 1e3:>9.2f} ms  "
                  f"{sp['name']}  trace={sp['trace'][:8]} "
                  f"thread={sp.get('thread')}")
        return 0

    if args.trace_action == "dump":
        from . import flags

        if args.selftest:
            import time

            flags.set("trace", True)
            with trace.span("selftest.root", kind="selftest"):
                t0 = time.perf_counter()
                with trace.span("selftest.child", n=1):
                    pass
                trace.record("selftest.retro", t0, time.perf_counter())
        if not trace.enabled():
            print("tracing is off (FLAGS_trace=0) — nothing recorded",
                  file=sys.stderr)
            return 1
        path = trace.dump(reason="manual", out_dir=args.out)
        spans, dropped = trace.snapshot()
        print(f"dump written: {path} ({len(spans)} spans, "
              f"{dropped} dropped)")
        if args.selftest:
            loaded = trace.load_dump(path)
            names = {sp["name"] for sp in loaded["spans"]}
            want = {"selftest.root", "selftest.child", "selftest.retro"}
            if not want <= names:
                print(f"selftest FAILED: missing {want - names}",
                      file=sys.stderr)
                return 1
            print("selftest ok: record -> dump -> load round-trip")
        return 0
    return 1


def _cmd_fleet(args):
    if args.fleet_action == "replica":
        return _cmd_fleet_replica(args)
    return _cmd_fleet_router(args)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="paddle_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("version", help="print version and backend info")
    sub.add_parser("flags", help="list runtime flags")

    m = sub.add_parser("monitor", help="summarize a step journal "
                                       "(FLAGS_monitor_journal)")
    m.add_argument("journal", nargs="+",
                   help="JSONL step journal path(s); globs OK. Several "
                        "journals render a per-process comparison table "
                        "plus the clock-aligned cross-replica skew/"
                        "straggler merge")
    m.add_argument("--json", action="store_true",
                   help="emit the summary as JSON instead of a table")

    h = sub.add_parser("health", help="model-health run ledgers: "
                                      "summarize and assert convergence "
                                      "parity")
    hsub = h.add_subparsers(dest="health_action", required=True)
    hs = hsub.add_parser("summary", help="summarize a FLAGS_health_ledger "
                                         "run ledger")
    hs.add_argument("ledger", help="path of the JSONL health ledger")
    hs.add_argument("--json", action="store_true",
                    help="emit the summary as JSON instead of a table")
    hc = hsub.add_parser("compare", help="convergence parity between two "
                                         "run ledgers (rc 0 parity / "
                                         "1 fail / 2 unreadable)")
    hc.add_argument("a", help="reference run ledger")
    hc.add_argument("b", help="candidate run ledger")
    hc.add_argument("--tol-final", type=float, default=1e-3,
                    help="max |final loss A - final loss B| at the last "
                         "common sampled step")
    hc.add_argument("--tol-traj", type=float, default=5e-3,
                    help="max step-aligned |loss A - loss B| over all "
                         "common sampled steps")
    hc.add_argument("--json", action="store_true",
                    help="emit the parity report as JSON")

    c = sub.add_parser("checkpoint", help="inspect checkpoint directories")
    csub = c.add_subparsers(dest="checkpoint_action", required=True)
    ci = csub.add_parser("inspect", help="list serials, commit status and "
                                         "the manifest of a checkpoint dir")
    ci.add_argument("dir", help="checkpoint directory "
                                "(holds checkpoint_<N> subdirs)")
    ci.add_argument("--serial", type=int, default=None,
                    help="show this serial's manifest instead of the latest")
    ci.add_argument("--json", action="store_true",
                    help="emit the report as JSON")

    ca = sub.add_parser("cache", help="persistent compile-cache store "
                                      "(FLAGS_compile_cache_dir)")
    casub = ca.add_subparsers(dest="cache_action", required=True)
    cal = casub.add_parser("ls", help="list entries: digest, kind, bytes, "
                                      "age, torch version")
    cal.add_argument("--dir", default=None,
                     help="store directory (default "
                          "FLAGS_compile_cache_dir)")
    cal.add_argument("--json", action="store_true",
                     help="emit the listing as JSON")
    cap_ = casub.add_parser("prune", help="delete oldest-used entries "
                                          "until the store fits the cap")
    cap_.add_argument("--dir", default=None,
                      help="store directory (default "
                           "FLAGS_compile_cache_dir)")
    cap_.add_argument("--max-mb", type=int, default=None,
                      help="size cap in MiB (default "
                           "FLAGS_compile_cache_dir_max_mb)")
    cac = casub.add_parser("clear", help="delete every entry")
    cac.add_argument("--dir", default=None,
                     help="store directory (default "
                          "FLAGS_compile_cache_dir)")

    sh = sub.add_parser("shard", help="autoshard: GSPMD-style sharding "
                                      "plans over a program")
    shsub = sh.add_subparsers(dest="shard_action", required=True)
    shp = shsub.add_parser("plan", help="propagate seeds and render the "
                                        "total ShardingPlan with per-edge "
                                        "estimated reshard bytes")
    shp.add_argument("--model-dir", default=None,
                     help="save_inference_model directory to plan")
    shp.add_argument("--selftest", action="store_true",
                     help="build a small embedding+fc demo net, plan it, "
                          "and verify the plan is total")
    shp.add_argument("--mesh", default="dp=4,mp=2",
                     help="mesh axes as name=size pairs (plan construction "
                          "is analytic — no devices needed)")
    shp.add_argument("--seed", action="append", metavar="NAME=SPEC",
                     help="extra seed annotation, e.g. fc_0.w_0=None,mp "
                          "(repeatable; entries are axis names or None)")
    shp.add_argument("--batch-axis", default="dp",
                     help="mesh axis seeded onto data vars' dim 0")
    shp.add_argument("--json", action="store_true",
                     help="emit plan.describe() as JSON")
    shp.add_argument("--quiet", action="store_true",
                     help="summary and edges only, no per-var table")
    shse = shsub.add_parser(
        "search", help="search candidate seed placements across the mesh "
                       "axes and keep the whole-plan cheapest (unified "
                       "compute + collective-bytes + peak-HBM cost model)")
    shse.add_argument("--model-dir", default=None,
                      help="save_inference_model directory to search")
    shse.add_argument("--selftest", action="store_true",
                      help="search the embedding+fc demo net and verify "
                           "the searched plan never costs more than the "
                           "manual seeds")
    shse.add_argument("--mesh", default="dp=4,mp=2",
                      help="mesh axes as name=size pairs")
    shse.add_argument("--batch-axis", default="dp",
                      help="mesh axis seeded onto data vars' dim 0")
    shse.add_argument("--batch", type=int, default=8,
                      help="batch size substituted for dynamic dims in "
                           "the cost model")
    shse.add_argument("--hbm-budget", type=int, default=None,
                      metavar="BYTES",
                      help="per-replica peak-HBM feasibility budget; "
                           "plans over it are penalized out")
    shse.add_argument("--max-params", type=int, default=8,
                      help="search seed placements for the N largest "
                           "params")
    shse.add_argument("--rounds", type=int, default=2,
                      help="greedy coordinate-descent passes")
    shse.add_argument("--peak-tflops", type=float,
                      default=_search_default("PEAK_FLOPS") / 1e12,
                      help="the card's dense peak in the compute term "
                           "(default: one H100 SXM's bf16 data-sheet "
                           "figure; 275 gives the JAX command's)")
    shse.add_argument("--link-gbps", type=float,
                      default=_search_default("LINK_BYTES_PER_S") / 1e9,
                      help="GB/s a card's collective bytes cross (default: "
                           "one direction of an H100 SXM's NVLink, data "
                           "sheet; 90 gives the JAX command's)")
    shse.add_argument("--json", action="store_true",
                      help="emit the search result as JSON")
    shse.add_argument("--quiet", action="store_true",
                      help="skip the winning plan's summary render")

    ck = sub.add_parser("check", help="static program verification: graph/"
                                      "safety/sharding checks and the "
                                      "peak-HBM estimate (docs/analysis.md)")
    ck.add_argument("--model-dir", default=None,
                    help="save_inference_model directory to verify")
    ck.add_argument("--level", default="full", choices=["basic", "full"],
                    help="basic: structure + shape contracts; full: adds "
                         "safety/sharding checks and the HBM table")
    ck.add_argument("--mesh", default=None, metavar="NAME=SIZE,...",
                    help="mesh axes for the sharding checks and per-replica "
                         "HBM accounting, e.g. dp=4,mp=2")
    ck.add_argument("--selftest", action="store_true",
                    help="verify a clean demo program AND an intentionally "
                         "broken clone (must flag PTA001); rc 0 when both "
                         "behave")
    ck.add_argument("--json", action="store_true",
                    help="emit the report as JSON")
    ck.add_argument("--quiet", action="store_true",
                    help="show errors only, not warnings")

    an = sub.add_parser("analyze", help="SSA dataflow graph, PTA03x hazard "
                                        "detection, the overlap schedule, "
                                        "the fusion plan and the pipeline "
                                        "partition")
    ansub = an.add_subparsers(dest="analyze_action", required=True)
    ag = ansub.add_parser("graph", help="build the SSA def-use dependency "
                                        "graph and run the dataflow hazard "
                                        "detector (PTA030-PTA034)")
    ag.add_argument("--model-dir", default=None,
                    help="save_inference_model directory to analyze")
    ag.add_argument("--zero1", type=int, default=0, metavar="N",
                    help="apply the ZeRO-1 rewrite with N shards before "
                         "analyzing")
    ag.add_argument("--selftest", action="store_true",
                    help="analyze a clean demo training program AND a "
                         "seeded cyclic clone (must flag PTA030); rc 0 "
                         "when both behave")
    ag.add_argument("--json", action="store_true",
                    help="emit the graph summary and report as JSON")
    ag.add_argument("--quiet", action="store_true",
                    help="show errors only, not warnings")
    asch = ansub.add_parser(
        "schedule", help="critical path over the analytic cost models and "
                         "the bucketed reduce-scatter overlap plan")
    asch.add_argument("--model-dir", default=None,
                      help="save_inference_model directory to schedule")
    asch.add_argument("--mesh", default="dp=8", metavar="NAME=SIZE,...",
                      help="mesh axes for the ring collective-bytes model")
    asch.add_argument("--zero1", type=int, default=0, metavar="N",
                      help="apply the ZeRO-1 rewrite with N shards before "
                           "scheduling")
    asch.add_argument("--batch", type=int, default=1,
                      help="batch size substituted for dynamic dims in the "
                           "FLOPs model")
    asch.add_argument("--bucket-bytes", type=int, default=None,
                      help="override FLAGS_overlap_bucket_bytes for the "
                           "gradient-bucketing plan")
    asch.add_argument("--selftest", action="store_true",
                      help="schedule a zero1-rewritten demo program (must "
                           "hoist a non-empty bucket plan) AND verify a "
                           "seeded collective-order divergence is rejected "
                           "with PTA033; rc 0 when both behave")
    asch.add_argument("--json", action="store_true",
                      help="emit the schedule report as JSON")
    asch.add_argument("--quiet", action="store_true",
                      help="show errors only, not warnings")
    asch.add_argument("--peak-tflops", type=float,
                      default=_schedule_default("DEFAULT_PEAK_FLOPS") / 1e12,
                      help="the card's dense peak a compute node is costed "
                           "at (default: one H100 SXM's bf16 data-sheet "
                           "figure; 197 gives the JAX command's)")
    asch.add_argument("--link-gbps", type=float,
                      default=_schedule_default("DEFAULT_ICI_BYTES_PER_S")
                      / 1e9,
                      help="GB/s a collective's ring bytes cross (default: "
                           "one direction of an H100 SXM's NVLink, data "
                           "sheet; 180 gives the JAX command's)")
    afu = ansub.add_parser(
        "fusion", help="cost-guided operator fusion plan: vertical "
                       "elementwise chains and the bucketed fused weight "
                       "update (docs/fusion.md)")
    afu.add_argument("--model-dir", default=None,
                     help="save_inference_model directory to plan fusion "
                          "for")
    afu.add_argument("--zero1", type=int, default=0, metavar="N",
                     help="apply the ZeRO-1 rewrite with N shards before "
                          "fusing (exercises shard-aware bucketing)")
    afu.add_argument("--bucket-mb", type=int, default=None,
                     help="override FLAGS_fuse_bucket_mb for the update "
                          "bucketing")
    afu.add_argument("--selftest", action="store_true",
                     help="fuse a demo trainer (must bucket >= 2 adam "
                          "updates and verify clean at level full), fuse "
                          "a demo elementwise chain, AND verify a seeded "
                          "cyclic source is refused with PTA030; rc 0 "
                          "when all behave")
    afu.add_argument("--json", action="store_true",
                     help="emit the fusion plan as JSON")
    afu.add_argument("--quiet", action="store_true",
                     help="hide skipped-candidate reasons")
    apl = ansub.add_parser(
        "pipeline", help="pp-axis stage partition (parallel.pipeline): "
                         "min-cut plan, PTA040/041 legality, and the 1F1B "
                         "schedule's bubble fraction")
    apl.add_argument("--model-dir", default=None,
                     help="save_inference_model directory to partition")
    apl.add_argument("--stages", type=int, default=None,
                     help="pipeline stage count (pp axis size; default "
                          "FLAGS_pipeline_stages, 2 where that is 0)")
    apl.add_argument("--microbatches", type=int, default=4,
                     help="1F1B microbatches per step")
    apl.add_argument("--batch", type=int, default=1,
                     help="batch size substituted for dynamic dims in the "
                          "FLOPs/bytes models")
    apl.add_argument("--selftest", action="store_true",
                     help="1F1B-execute the demo net (bitwise loss parity "
                          "vs unpartitioned, bubble = analytic bound) AND "
                          "verify a seeded backwards-edge split is refused "
                          "with PTA040; rc 0 when all hold")
    apl.add_argument("--place", default="cuda", choices=["cuda", "cpu"],
                     help="where --selftest trains (default: the first "
                          "card)")
    apl.add_argument("--json", action="store_true",
                     help="emit the report as JSON")
    apl.add_argument("--quiet", action="store_true",
                     help="show errors only, not warnings")

    s = sub.add_parser("serve", help="serve a saved inference model with "
                                     "the batching engine")
    s.add_argument("--model-dir", required=True,
                   help="save_inference_model directory")
    s.add_argument("--place", default="cuda", choices=["cuda", "cpu"],
                   help="the first CUDA card (default) or the host")
    s.add_argument("--max-batch", type=int, default=8)
    s.add_argument("--max-wait-ms", type=float, default=2.0)
    s.add_argument("--replicas", type=int, default=1)
    s.add_argument("--slo-ms", type=float, default=None)
    s.add_argument("--max-queue-rows", type=int, default=None)
    s.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="expose the HTTP frontend on PORT (blocking)")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--selftest", type=int, default=64, metavar="N",
                   help="without --http: fire N synthetic requests from "
                        "concurrent clients and print stats JSON")
    s.add_argument("--cache-dir", default=None,
                   help="persistent compile-cache directory "
                        "(FLAGS_compile_cache_dir): warm-up loads the "
                        "prepared plans earlier processes stored")

    f = sub.add_parser("fleet", help="multi-replica serving: replica and "
                                     "router processes")
    fsub = f.add_subparsers(dest="fleet_action", required=True)
    fr = fsub.add_parser("replica", help="run one serving replica process "
                                         "(drains clean on /admin/drain "
                                         "or SIGTERM)")
    fr.add_argument("--model-dir", required=True,
                    help="save_inference_model directory")
    fr.add_argument("--place", default="cuda", choices=["cuda", "cpu"],
                    help="the first CUDA card (default; the JAX "
                         "package's replica defaults to the host) or the "
                         "host")
    fr.add_argument("--amp", default=None, choices=["bfloat16"],
                    help="serve under bf16 AMP (amp.enable)")
    fr.add_argument("--host", default="127.0.0.1")
    fr.add_argument("--port", type=int, default=0,
                    help="HTTP port (0 = ephemeral; see --port-file)")
    fr.add_argument("--port-file", default=None,
                    help="write the bound port here once listening")
    fr.add_argument("--name", default=None,
                    help="replica name (default replica-<port>)")
    fr.add_argument("--max-batch", type=int, default=8)
    fr.add_argument("--max-wait-ms", type=float, default=2.0)
    fr.add_argument("--replicas", type=int, default=1,
                    help="engine executor replicas inside this process "
                         "(one card each)")
    fr.add_argument("--max-queue-rows", type=int, default=None)
    fr.add_argument("--slo-ms", type=float, default=None,
                    help="latency SLO; violations count "
                         "serve_slo_violations_total and trigger "
                         "flight-recorder dumps under FLAGS_trace")
    fr.add_argument("--router", default=None, metavar="HOST:PORT",
                    help="register with this fleet router over HTTP")
    fr.add_argument("--master", default=None, metavar="HOST:PORT",
                    help="heartbeat a TTL'd registration (kind serve) "
                         "in this elastic master's registry")
    fr.add_argument("--ttl", type=float, default=10.0,
                    help="registration TTL seconds (--router beats every "
                         "ttl/3)")
    fr.add_argument("--chaos-kill-at", type=int, default=None, metavar="N",
                    help="SIGKILL this replica on its Nth executor "
                         "dispatch (failover drill)")
    fr.add_argument("--chaos-hang-at", type=int, default=None, metavar="N",
                    help="hang this replica on its Nth executor dispatch")
    fr.add_argument("--chaos-hang-ms", type=float, default=None,
                    help="hang duration (default: effectively forever)")
    fr.add_argument("--chaos-hang-times", type=int, default=1,
                    metavar="K",
                    help="hang on K consecutive dispatches from "
                         "--chaos-hang-at (straggler drills)")
    fr.add_argument("--chaos-delay-ms", type=float, default=None,
                    help="sleep this long on EVERY executor dispatch: a "
                         "deterministic service-time floor, so capacity "
                         "drills see the same queueing on any host")
    fr.add_argument("--obs", default=None, metavar="HOST:PORT",
                    help="push metrics/journal/trace snapshots to this "
                         "obs collector")
    fr.add_argument("--cache-dir", default=None,
                    help="persistent compile-cache directory shared by "
                         "the fleet (FLAGS_compile_cache_dir): only the "
                         "first replica prepares each plan, the rest "
                         "load it")
    fr.add_argument("--compile-service", default=None, metavar="HOST:PORT",
                    help="the distributed compile service (an elastic "
                         "master): fetch peers' prepared plans by digest "
                         "into this replica's --cache-dir (required)")
    fo = fsub.add_parser("router", help="run the fleet router over a "
                                        "replica set")
    fo.add_argument("--replicas", default="",
                    help="comma-separated replica host:port list")
    fo.add_argument("--master", default=None, metavar="HOST:PORT",
                    help="discover replicas (kind serve) from this "
                         "elastic master's registry")
    fo.add_argument("--host", default="127.0.0.1")
    fo.add_argument("--port", type=int, default=8100)
    fo.add_argument("--probe-interval", type=float, default=0.5)
    fo.add_argument("--deadline-ms", type=float, default=30000.0,
                    help="per-request routing deadline")
    fo.add_argument("--attempt-timeout-ms", type=float, default=None,
                    help="per-attempt transport timeout")
    fo.add_argument("--max-attempts", type=int, default=3)
    fo.add_argument("--hedge-ms", type=float, default=None,
                    help="hedge a silent first attempt after this long")
    fo.add_argument("--obs", default=None, metavar="HOST:PORT",
                    help="push router metrics to this obs collector")
    fo.add_argument("--autoscale-model-dir", default=None, metavar="DIR",
                    help="enable the autoscaler: spawn `fleet replica` "
                         "processes serving this save_inference_model "
                         "dir when the latency target breaches, drain "
                         "them away when load calms")
    fo.add_argument("--autoscale-min", type=int, default=1,
                    help="autoscaler floor (replicas)")
    fo.add_argument("--autoscale-max", type=int, default=4,
                    help="autoscaler ceiling (replicas)")
    fo.add_argument("--autoscale-target-p99-ms", type=float, default=500.0,
                    help="windowed router p99 the autoscaler holds")
    fo.add_argument("--autoscale-queue-rows", type=float, default=None,
                    help="queued rows across the fleet that also arm "
                         "scale-out")
    fo.add_argument("--autoscale-interval", type=float, default=1.0,
                    help="control-loop tick seconds")
    fo.add_argument("--autoscale-cooldown-out", type=float, default=5.0,
                    help="seconds between scale-outs")
    fo.add_argument("--autoscale-cooldown-in", type=float, default=30.0,
                    help="seconds between scale-ins")
    fo.add_argument("--autoscale-cache-dir", default=None,
                    help="shared --cache-dir for spawned replicas "
                         "(default: per-replica dirs under a temp "
                         "workdir)")
    fo.add_argument("--compile-service", default=None, metavar="HOST:PORT",
                    help="pass through to spawned replicas")

    tr = sub.add_parser("trace", help="flight-recorder dumps and per-op "
                                      "cost attribution")
    trsub = tr.add_subparsers(dest="trace_action", required=True)
    tro = trsub.add_parser("ops", help="compile a saved model once and "
                                       "print the slowest-ops table")
    tro.add_argument("--model-dir", required=True,
                     help="save_inference_model directory")
    tro.add_argument("--place", default="cuda", choices=["cuda", "cpu"],
                     help="the first CUDA card (default) or the host")
    tro.add_argument("--batch", type=int, default=1,
                     help="batch size substituted for dynamic dims")
    tro.add_argument("--top", type=int, default=10,
                     help="rows in the table")
    tro.add_argument("--json", action="store_true",
                     help="emit the report as JSON")
    trs = trsub.add_parser("summary", help="summarize a flight-recorder "
                                           "dump directory")
    trs.add_argument("dir", help="dump directory (holds manifest.json)")
    trd = trsub.add_parser("dump", help="dump the in-process flight "
                                        "recorder")
    trd.add_argument("--out", default=None,
                     help="output base dir (default FLAGS_trace_dump_dir "
                          "or cwd)")
    trd.add_argument("--selftest", action="store_true",
                     help="record synthetic spans first and verify the "
                          "dump loads back")

    ob = sub.add_parser("obs", help="fleet-wide observability: collector "
                                    "sink, live top table, merged "
                                    "timeline")
    obsub = ob.add_subparsers(dest="obs_action", required=True)
    obc = obsub.add_parser("collect", help="run the fleet collector "
                                           "(push sink + scrape poller + "
                                           "aggregated /metrics)")
    obc.add_argument("--host", default="127.0.0.1")
    obc.add_argument("--port", type=int, default=9200,
                     help="HTTP port (0 = ephemeral; see --port-file)")
    obc.add_argument("--port-file", default=None,
                     help="write the bound port here once listening")
    obc.add_argument("--ttl", type=float, default=None,
                     help="stale-process expiry seconds "
                          "(default FLAGS_obs_ttl_s)")
    obc.add_argument("--scrape", action="append", default=None,
                     metavar="[NAME=]HOST:PORT",
                     help="poll this /metrics exposition as a fleet "
                          "member (repeatable)")
    obc.add_argument("--scrape-interval", type=float, default=2.0)
    obc.add_argument("--straggler-ratio", type=float, default=1.2,
                     help="slowest/median step-time ratio that counts "
                          "toward straggler attribution")
    obc.add_argument("--straggler-steps", type=int, default=3,
                     help="consecutive slowest steps before "
                          "fleet_straggler{replica=} fires")
    obt = obsub.add_parser("top", help="live fleet table over the "
                                       "collector summary (redraws in "
                                       "place on a TTY)")
    obt.add_argument("--collector", required=True, metavar="HOST:PORT")
    obt.add_argument("--interval", type=float, default=2.0)
    obt.add_argument("--once", action="store_true",
                     help="print one frame and exit")
    obt.add_argument("--json", action="store_true",
                     help="emit raw summary JSON frames")
    obt.add_argument("--iterations", type=int, default=None,
                     help=argparse.SUPPRESS)
    obl = obsub.add_parser("timeline", help="merged fleet timeline: "
                                            "cross-replica skew table + "
                                            "one chrome trace with a pid "
                                            "lane per process")
    obl.add_argument("--collector", default=None, metavar="HOST:PORT",
                     help="pull the step timeline and known dumps from "
                          "this collector")
    obl.add_argument("--dump", action="append", default=None,
                     metavar="DIR",
                     help="merge this flight-recorder dump directory "
                          "(repeatable)")
    obl.add_argument("--out", default=None,
                     help="write the merged chrome trace JSON here")

    e = sub.add_parser("elastic", help="elastic training membership: "
                                       "status snapshot and manual drain")
    esub = e.add_subparsers(dest="elastic_action", required=True)
    es = esub.add_parser("status", help="epoch, world size and members of "
                                        "a running elastic job")
    es.add_argument("--master", required=True, metavar="HOST:PORT",
                    help="the job's parallel.master endpoint")
    es.add_argument("--timeout", type=float, default=10.0,
                    help="master connect timeout seconds")
    es.add_argument("--json", action="store_true",
                    help="emit the snapshot as JSON")
    ed = esub.add_parser("drain", help="remove a worker from the "
                                       "membership (manual scale-down)")
    ed.add_argument("name", help="worker membership name to remove")
    ed.add_argument("--master", required=True, metavar="HOST:PORT",
                    help="the job's parallel.master endpoint")
    ed.add_argument("--timeout", type=float, default=10.0,
                    help="master connect timeout seconds")

    t = sub.add_parser("train", help="launch a training script with "
                                     "cluster environment")
    t.add_argument("--role", default="trainer",
                   choices=["trainer", "pserver"])
    t.add_argument("--trainers", type=int, default=1)
    t.add_argument("--trainer-id", type=int, default=0)
    t.add_argument("--pservers", default="",
                   help="comma-separated host:port list")
    t.add_argument("--current-endpoint", default="",
                   help="this pserver's host:port")
    t.add_argument("script")
    t.add_argument("script_args", nargs=argparse.REMAINDER)

    args = parser.parse_args(argv)
    commands = {"version": _cmd_version, "flags": _cmd_flags,
                "train": _cmd_train,
                "monitor": _cmd_monitor, "health": _cmd_health,
                "checkpoint": _cmd_checkpoint, "cache": _cmd_cache,
                "shard": _cmd_shard,
                "check": _cmd_check, "analyze": _cmd_analyze,
                "serve": _cmd_serve, "fleet": _cmd_fleet,
                "elastic": _cmd_elastic, "obs": _cmd_obs,
                "trace": _cmd_trace}
    return commands[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
