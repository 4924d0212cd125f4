"""`python -m paddle_tpu_torch` (paddle_tpu_torch/cli.py) against the JAX
package's `python -m paddle_tpu` (paddle_tpu/cli.py) on the same files.

Journals and health ledgers written by each package (the nets of
test_torch_monitor_step and test_torch_health) are read by both CLIs: the
`monitor` and `health summary|compare` commands print the same text, as
tables and as --json, and exit with the same codes (0; `health compare`
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

from paddle_tpu_torch import cli, flags

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


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Each package's journal and health ledger of the same MLP runs."""
    tmp = tmp_path_factory.mktemp("cli")
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
    rc = cli.main(["monitor", files["jax_journal"], files["port_journal"]])
    assert rc == 2
    assert "not ported yet (ROADMAP queue 1 item 8)" in \
        capsys.readouterr().err


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
