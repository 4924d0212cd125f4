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

The JAX CLI's other commands (trace ops, serve, fleet, cache, ...) and
`monitor` over several journals (the fleet's clock-aligned merge) are not
ported yet.
"""

import argparse
import glob
import json
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

    args = parser.parse_args(argv)
    commands = {"version": _cmd_version, "flags": _cmd_flags,
                "monitor": _cmd_monitor, "health": _cmd_health,
                "checkpoint": _cmd_checkpoint}
    return commands[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
