"""`python -m paddle_tpu_torch checkpoint inspect DIR [--serial N] [--json]`
against the JAX package's `python -m paddle_tpu checkpoint inspect` on the
same directories: a port CheckpointManager's, a JAX one's, an io-format
one (fluid.io.save_checkpoint), one with crash debris, a ZeRO-1 manifest,
an empty and a missing directory — the same text, the same JSON and the
same exit codes. On a directory holding an orphaned `.tmp` the JAX CLI
raises KeyError (ROADMAP §3); the port prints the entry.
"""

import json
import os
import subprocess
import sys

import pytest

from paddle_tpu import cli as jcli
from paddle_tpu.resilience import CheckpointManager as JCheckpointManager

import paddle_tpu_torch as fluid
from paddle_tpu_torch import cli
from paddle_tpu_torch.resilience import CheckpointManager

from test_torch_resilience import (_fresh_port_state,  # noqa: F401
                                   _jax_trained_scope, _trained_scope)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(capsys, argv):
    out = {}
    for pkg, main in (("jax", jcli.main), ("port", cli.main)):
        rc = main(list(argv))
        o, e = capsys.readouterr()
        out[pkg] = (rc, o, e)
    return out


def _save(mgr_cls, d, scope, main, steps, extra=None):
    mgr = mgr_cls(d, async_write=False)
    try:
        for step in steps:
            mgr.save(step, scope=scope, program=main, extra=extra)
    finally:
        mgr.close()


@pytest.fixture
def dirs(tmp_path):
    main, scope = _trained_scope()
    jmain, jscope = _jax_trained_scope()
    out = {}
    out["port"] = str(tmp_path / "port")
    _save(CheckpointManager, out["port"], scope, main, (4, 8),
          extra={"epoch": 1})
    out["jax"] = str(tmp_path / "jax")
    _save(JCheckpointManager, out["jax"], jscope, jmain, (2, 4, 6, 8))
    out["io"] = str(tmp_path / "io")
    with fluid.scope_guard(scope):
        fluid.io.save_checkpoint(fluid.Executor(fluid.CPUPlace()),
                                 out["io"], save_interval_secs=0,
                                 main_program=main)
    out["debris"] = str(tmp_path / "debris")
    _save(CheckpointManager, out["debris"], scope, main, (3,))
    os.makedirs(os.path.join(out["debris"], "checkpoint_7"))
    out["zero1"] = str(tmp_path / "zero1")
    _save(CheckpointManager, out["zero1"], scope, main, (5,))
    mpath = os.path.join(out["zero1"], "checkpoint_0", "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["zero1"] = {"w": {
        "shape": [4, 1], "numel": 4, "padded_numel": 4, "num_shards": 2,
        "shard_numel": 2, "param_shard_bytes": 8, "accum_shard_bytes": 8,
        "accums": ["velocity_0"], "owners": {"0": [0, 2], "1": [2, 4]}}}
    manifest["mesh"] = {"dp": 2}
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    out["empty"] = str(tmp_path / "empty")
    os.makedirs(out["empty"])
    out["missing"] = str(tmp_path / "missing")
    return out


@pytest.mark.parametrize("which", ["port", "jax", "io", "debris", "zero1",
                                   "empty", "missing"])
@pytest.mark.parametrize("json_flag", [False, True], ids=["text", "json"])
def test_checkpoint_inspect_prints_the_same(capsys, dirs, which, json_flag):
    argv = ["checkpoint", "inspect", dirs[which]] + (
        ["--json"] if json_flag else [])
    out = _both(capsys, argv)
    assert out["port"] == out["jax"]
    assert out["port"][0] == 0
    if which == "port" and not json_flag:
        text = out["port"][1]
        assert "committed" in text and "format=resilience-v1 step=8" in text


@pytest.mark.parametrize("serial", [0, 1])
def test_checkpoint_inspect_a_serial(capsys, dirs, serial):
    out = _both(capsys, ["checkpoint", "inspect", dirs["jax"], "--serial",
                         str(serial + 2)])
    assert out["port"] == out["jax"]
    # serials 1-3 of steps 4, 6, 8 are kept (LRU of 3)
    assert f"manifest (serial {serial + 2}): format=resilience-v1 " \
        f"step={2 * (serial + 2) + 2}" in out["port"][1]


def test_an_orphaned_tmp_dir_is_listed(capsys, dirs):
    d = dirs["port"]
    os.makedirs(os.path.join(d, "checkpoint_9.tmp"))
    assert cli.main(["checkpoint", "inspect", d]) == 0
    text = capsys.readouterr()[0]
    assert "checkpoint_9.tmp" in text and "orphaned-tmp" in text
    with pytest.raises(KeyError):
        jcli.main(["checkpoint", "inspect", d])


def test_the_command_runs_as_a_module(dirs):
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch", "checkpoint", "inspect",
         dirs["port"]], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("checkpoint dir: ")
