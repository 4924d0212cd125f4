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

The JAX CLI's other commands (trace ops, serve, fleet, checkpoint, cache,
...) and `monitor` over several journals (the fleet's clock-aligned
merge) are not ported yet.
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

    args = parser.parse_args(argv)
    commands = {"version": _cmd_version, "flags": _cmd_flags,
                "monitor": _cmd_monitor, "health": _cmd_health}
    return commands[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
