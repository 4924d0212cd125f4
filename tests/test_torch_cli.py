"""`python -m paddle_tpu_torch` (paddle_tpu_torch/cli.py) against the JAX
package's `python -m paddle_tpu` (paddle_tpu/cli.py) on the same files.

Journals and health ledgers written by each package (the nets of
test_torch_monitor_step and test_torch_health) are read by both CLIs: the
`monitor` (one journal, or several: the fleet merge) and `health
summary|compare` commands print the same text, as tables and as --json, and exit with the same codes (0; `health compare`
1 on a violated tolerance; 1 or 2 on a file that cannot be read, with the
same message). `version` and `flags` print the JAX package's line
formats, and the module runs as `python -m paddle_tpu_torch`.
"""

import json
import os
import subprocess
import sys

import pytest

from paddle_tpu import cli as jcli
from paddle_tpu import flags as jflags
from paddle_tpu import monitor as jmonitor

from paddle_tpu_torch import cli, flags, monitor

from test_torch_health import ledger_run
from test_torch_monitor_step import (_fresh_state, jax_init,  # noqa: F401
                                     journaled_runs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(capsys, argv):
    """{pkg: (rc, stdout, stderr)} of each CLI's main(argv)."""
    out = {}
    for pkg, main in (("jax", jcli.main), ("port", cli.main)):
        rc = main(list(argv))
        o, e = capsys.readouterr()
        out[pkg] = (rc, o, e)
    return out


def write_files(tmp):
    """Each package's journal and health ledger of the same MLP runs, in
    the directory `tmp`: {name: path}."""
    init = jax_init("mlp")
    paths = {}
    for pkg in ("jax", "port"):
        paths[f"{pkg}_journal"] = str(tmp / f"{pkg}.jsonl")
        journaled_runs(pkg, "mlp", init, paths[f"{pkg}_journal"])
        paths[f"{pkg}_ledger"] = str(tmp / f"{pkg}.health.jsonl")
        ledger_run(pkg, "mlp", init, paths[f"{pkg}_ledger"], steps=6,
                   iters_runs=1)
    # a ledger whose losses drift from the JAX run's
    drifted = []
    for line in open(paths["jax_ledger"]):
        rec = json.loads(line)
        rec["loss"] += 0.01 * rec["step"]
        drifted.append(json.dumps(rec))
    paths["drifted_ledger"] = str(tmp / "drifted.jsonl")
    with open(paths["drifted_ledger"], "w") as f:
        f.write("\n".join(drifted) + "\n")
    return paths


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_files(tmp_path_factory.mktemp("cli"))


def test_the_files_are_written_with_the_monitor_left_off(tmp_path):
    """A module fixture runs before any test's flag reset, after whatever
    file ran last on the worker: one that left FLAGS_monitor off in both
    packages (as tests/test_serve.py leaves the JAX package's) must not
    stop the journals from being written."""
    flags.set("monitor", False)
    jflags.set("monitor", False)
    try:
        paths = write_files(tmp_path)
        assert not flags.get("monitor") and not jflags.get("monitor")
    finally:
        flags.reset()
        jflags.reset()
    for pkg, mon in (("jax", jmonitor), ("port", monitor)):
        recs = mon.read_journal(paths[f"{pkg}_journal"])
        assert [r["step"] for r in recs] == [1, 2, 3, 4, 5], pkg
        assert os.path.getsize(paths[f"{pkg}_ledger"]) > 0, pkg


@pytest.mark.parametrize("json_flag", [[], ["--json"]])
@pytest.mark.parametrize("journal", ["jax_journal", "port_journal"])
def test_monitor_prints_the_same_summary(capsys, files, journal, json_flag):
    got = _both(capsys, ["monitor", files[journal]] + json_flag)
    assert got["port"] == got["jax"]
    rc, out, _ = got["port"]
    assert rc == 0
    if json_flag:
        assert json.loads(out)["steps"] == 5
    else:
        assert out.splitlines()[0] == "steps: 5  kinds: executor"
        assert "compile cache: 3 hits / 2 misses" in out


def test_monitor_on_a_missing_journal(capsys, tmp_path):
    got = _both(capsys, ["monitor", str(tmp_path / "none.jsonl")])
    assert got["port"] == got["jax"]
    assert got["port"][0] == 1
    assert got["port"][2].startswith("cannot read journal: ")


def test_monitor_refuses_several_journals(capsys, files):
    """Several journals (one a process): the fleet merge, refused until
    the control plane was ported (the name is kept) — the per-process
    table and the cross-process skew and stragglers print the JAX CLI's
    text, as a table and as --json."""
    for extra in ([], ["--json"]):
        got = _both(capsys, ["monitor", files["jax_journal"],
                             files["port_journal"]] + extra)
        assert got["port"] == got["jax"]
        rc, out, _ = got["port"]
        assert rc == 0
        if extra:
            merged = json.loads(out)
            assert len(merged["journals"]) == 2
            assert [s["step"] for s in merged["fleet"]["steps"]] == \
                [1, 2, 3, 4, 5]
        else:
            assert out.splitlines()[0].startswith("journal")
            assert "fleet: 5 step(s) aligned across processes" in out


@pytest.mark.parametrize("json_flag", [[], ["--json"]])
@pytest.mark.parametrize("ledger", ["jax_ledger", "port_ledger"])
def test_health_summary_prints_the_same_text(capsys, files, ledger,
                                             json_flag):
    got = _both(capsys, ["health", "summary", files[ledger]] + json_flag)
    assert got["port"] == got["jax"]
    assert got["port"][0] == 0
    if not json_flag:
        assert got["port"][1].startswith("records: 8  sampled steps: 8")


@pytest.mark.parametrize("pair,rc", [
    (("jax_ledger", "port_ledger"), 0),
    (("port_ledger", "jax_ledger"), 0),
    (("jax_ledger", "drifted_ledger"), 1),
    (("drifted_ledger", "port_ledger"), 1)])
def test_health_compare_prints_the_same_report(capsys, files, pair, rc):
    for extra in ([], ["--json"], ["--tol-final", "0.5", "--tol-traj",
                                   "0.5"]):
        got = _both(capsys, ["health", "compare", files[pair[0]],
                             files[pair[1]]] + extra)
        assert got["port"] == got["jax"]
        want = 0 if extra[:1] == ["--tol-final"] else rc
        assert got["port"][0] == want
    assert got["port"][1].splitlines()[-1] == "PARITY: ok"


def test_health_on_a_missing_ledger(capsys, files, tmp_path):
    for argv in (["health", "summary", str(tmp_path / "x")],
                 ["health", "compare", files["jax_ledger"],
                  str(tmp_path / "x")]):
        got = _both(capsys, argv)
        assert got["port"] == got["jax"]
        assert got["port"][0] == 2


def test_version_and_flags_print_the_jax_line_formats(capsys):
    assert cli.main(["version"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("paddle_tpu_torch ")
    assert lines[1].startswith("torch ")
    assert cli.main(["flags"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == len(flags.all_flags())
    assert any(line.startswith("FLAGS_monitor (bool, current=True): ")
               for line in out)
    assert any(line.startswith("FLAGS_check_nan_inf (bool, current=False)")
               for line in out)


def test_the_module_runs_as_a_command(files):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch", "monitor",
         files["jax_journal"]], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.splitlines()[0] == "steps: 5  kinds: executor"


def _spans(n, t0):
    return [{"trace": f"t{i}", "span": f"s{i}", "parent": None,
             "name": "step" if i % 2 else "resize", "kind": "span",
             "t0": t0 + i, "t1": t0 + i + 0.25 * (i + 1),
             "thread": "MainThread"} for i in range(n)]


def test_trace_summary_prints_the_same_text(capsys, tmp_path):
    """`trace summary DIR` of a flight-recorder dump the port wrote: the
    JAX CLI's text."""
    from paddle_tpu_torch.trace import write_dump

    d = write_dump(str(tmp_path / "dump"), _spans(5, 100.0))
    got = _both(capsys, ["trace", "summary", d])
    assert got["port"] == got["jax"]
    assert got["port"][0] == 0 and "spans=5" in got["port"][1]
    assert cli.main(["trace", "summary", str(tmp_path / "none")]) == 1


def test_trace_dump_selftest_and_ops(capsys, tmp_path):
    """`trace dump --selftest` records, dumps and loads back its spans;
    `trace ops` prints a saved model's per-op cost table (on the host:
    --place cpu)."""
    import paddle_tpu_torch as fluid

    try:
        assert cli.main(["trace", "dump", "--selftest", "--out",
                         str(tmp_path)]) == 0
        assert "selftest ok" in capsys.readouterr().out
        prog, start = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(prog, start):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            y = fluid.layers.fc(input=x, size=3)
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(fluid.Scope()):
            exe.run(start)
            with fluid.program_guard(prog, start):
                fluid.io.save_inference_model(str(tmp_path / "m"), ["x"],
                                              [y], exe)
        assert cli.main(["trace", "ops", "--model-dir",
                         str(tmp_path / "m"), "--place", "cpu", "--batch",
                         "2", "--json"]) == 0
        report = json.loads(capsys.readouterr().out)
        # the probe counts the product's multiply-adds, 2 x B x K x N
        assert report["total_flops"] == 2 * 2 * 4 * 3
        assert [r["op"] for r in report["ops"]][0] == "mul"
        assert report["measured"]
    finally:
        flags.reset()
