"""Command-line entry: `python -m paddle_tpu_torch <command>`.

The JAX package's `python -m paddle_tpu` commands that read the run-time
instruments' files (paddle_tpu/cli.py), with the same text and exit codes
on the same input files, so either package's CLI reads the other's
journals and ledgers:

  version            print version + backend info
  flags              list registered runtime flags (FLAGS_* env overrides)
  monitor JOURNAL    summarize a FLAGS_monitor_journal step journal
                     (step/phase timings, compile-cache hit rate, replica
                     skew); --json emits the summary as JSON.
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
                     every command (the JAX package's replica: cpu);
                     --master, --obs and --compile-service are refused
                     (ROADMAP queue 1 item 8)

  train [--role trainer|pserver] [--trainers N] [--trainer-id I]
        [--pservers H:P,...] [--current-endpoint H:P] SCRIPT [ARGS ...]
                     exec a training script with the parameter-server
                     cluster environment: PADDLE_TRAINING_ROLE,
                     PADDLE_TRAINERS, PADDLE_TRAINER_ID, PADDLE_PSERVERS
                     and PADDLE_CURRENT_ENDPOINT (the JAX command's
                     names; fluid.Trainer itself reads the reference's
                     PADDLE_PSERVER_IPS, PADDLE_PSERVER_PORT and
                     PADDLE_CURRENT_IP, as the JAX package's does)

The JAX CLI's other commands (trace ops, shard, elastic, obs, ...),
`analyze schedule` (ROADMAP queue 1 item 6) and `monitor` over several
journals (item 8) are not ported yet.
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
    if len(paths) > 1:
        print("several journals: the fleet merge of the JAX package's CLI "
              "is not ported yet (ROADMAP queue 1 item 8)", file=sys.stderr)
        return 2
    try:
        records = read_journal(paths[0])
    except OSError as e:
        print(f"cannot read journal: {e}", file=sys.stderr)
        return 1
    summary = summarize_journal(records)
    if args.json:
        print(json.dumps(summary, indent=2))
    else:
        print(format_summary(summary))
    return 0


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
        print("analyze schedule: not ported yet — the static overlap "
              "schedule (analysis/schedule.py): ROADMAP queue 1 item 6",
              file=sys.stderr)
        return 2
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


def _refuse_item8(args, command):
    """rc 2 with the reason when an option links to a service of ROADMAP
    queue 1 item 8 (the elastic master, obs/, the distributed compile
    service); None when there is none."""
    names = {"master": "--master (the elastic master's registry)",
             "obs": "--obs (the fleet obs collector)",
             "compile_service": "--compile-service (the distributed "
                                "compile service)"}
    used = [text for key, text in names.items()
            if getattr(args, key, None)]
    if not used:
        return None
    verb = "is" if len(used) == 1 else "are"
    print(f"{command}: {', '.join(used)} {verb} not ported yet (ROADMAP "
          f"queue 1 item 8)", file=sys.stderr)
    return 2


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

    refused = _refuse_item8(args, "fleet replica")
    if refused is not None:
        return refused
    if args.cache_dir:
        # fleet spin-up: the replicas share one store of prepared plans,
        # so only the first one prepares each bucket from scratch
        flags.set("compile_cache_dir", args.cache_dir)
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

    stop_beats = threading.Event()
    if args.router:
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
    stats = server.stats()
    server.stop()
    leftover = stats["queue_rows"]
    print(f"replica {name} exiting: drained queue_rows={leftover}",
          file=sys.stderr)
    return 0 if leftover == 0 else 1


def _cmd_fleet_router(args):
    from .serve.fleet import FleetConfig, Router, serve_fleet

    refused = _refuse_item8(args, "fleet router")
    if refused is not None:
        return refused
    replicas = {}
    if args.replicas:
        for i, ep in enumerate(e for e in args.replicas.split(",") if e):
            replicas[f"r{i}"] = ep
    if not replicas and not args.autoscale_model_dir:
        print("router needs --replicas (or --autoscale-model-dir); "
              "replicas may also join over POST /admin/register",
              file=sys.stderr)
        return 1
    config = FleetConfig(
        probe_interval_s=args.probe_interval,
        request_deadline_ms=args.deadline_ms,
        attempt_timeout_ms=args.attempt_timeout_ms,
        max_attempts=args.max_attempts, hedge_ms=args.hedge_ms)
    router = Router(replicas, config=config)
    autoscaler = None
    if args.autoscale_model_dir:
        import tempfile

        from .serve.fleet import (Autoscaler, AutoscalerConfig,
                                  ProcessReplicaSpawner)

        workdir = tempfile.mkdtemp(prefix="fleet_autoscale_")
        argv_base = [sys.executable, "-m", "paddle_tpu_torch", "fleet",
                     "replica", "--model-dir", args.autoscale_model_dir,
                     "--port", "0"]
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
          f"{sorted(replicas.values()) or 'registered replicas'}",
          file=sys.stderr)
    serve_fleet(router, host=args.host, port=args.port)
    if autoscaler is not None:
        autoscaler.stop()
        autoscaler.spawner.stop_all()
    return 0


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
                   help="JSONL step journal path; a glob OK")
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
                                        "detection, the fusion plan and "
                                        "the pipeline partition; the "
                                        "overlap schedule is not ported")
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
        "schedule", help="not ported (ROADMAP queue 1 item 6): critical "
                         "path and the bucketed reduce-scatter overlap plan")
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
                    help="not ported (ROADMAP queue 1 item 8): heartbeat "
                         "an elastic-master TTL registration")
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
                    help="not ported (ROADMAP queue 1 item 8): push "
                         "metrics/journal/trace snapshots to an obs "
                         "collector")
    fr.add_argument("--cache-dir", default=None,
                    help="persistent compile-cache directory shared by "
                         "the fleet (FLAGS_compile_cache_dir): only the "
                         "first replica prepares each plan, the rest "
                         "load it")
    fr.add_argument("--compile-service", default=None, metavar="HOST:PORT",
                    help="not ported (ROADMAP queue 1 item 8): the "
                         "distributed compile service")
    fo = fsub.add_parser("router", help="run the fleet router over a "
                                        "replica set")
    fo.add_argument("--replicas", default="",
                    help="comma-separated replica host:port list")
    fo.add_argument("--master", default=None, metavar="HOST:PORT",
                    help="not ported (ROADMAP queue 1 item 8): discover "
                         "replicas from an elastic-master registry")
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
                    help="not ported (ROADMAP queue 1 item 8): push "
                         "router metrics to an obs collector")
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
                    help="not ported (ROADMAP queue 1 item 8): pass "
                         "through to spawned replicas")

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
                "check": _cmd_check, "analyze": _cmd_analyze,
                "serve": _cmd_serve, "fleet": _cmd_fleet}
    return commands[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
