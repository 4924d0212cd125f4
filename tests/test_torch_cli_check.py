"""The port's CLI commands of the compile-time services:
`python -m paddle_tpu_torch check` (static verification of a saved model,
its selftest and usage errors), `cache ls|prune|clear` over the persistent
compile cache, and `analyze graph|fusion` (their selftests; `schedule` and
`pipeline` name the ROADMAP items that own them). The JAX package's
commands (paddle_tpu/cli.py) with the same options, text and exit codes.
"""

import json
import os

import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import analysis, flags
from paddle_tpu_torch.cache import L2Store
from paddle_tpu_torch.cli import main as cli_main
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope


@pytest.fixture(autouse=True)
def _fresh_port_state():
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    fluid.unique_name.switch()
    flags.reset()
    analysis.reset()
    yield
    flags.reset()


# ---------------------------------------------------------------------------
# CLI: check
# ---------------------------------------------------------------------------
def test_cli_check_selftest_ok(capsys):
    assert cli_main(["check", "--selftest"]) == 0
    out = capsys.readouterr().out
    assert "check selftest: OK" in out and "PTA001" in out
    assert cli_main(["check", "--selftest", "--json", "--quiet"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["ok"] and payload["clean"]["hbm"] is not None


def test_cli_check_model_dir_and_json(tmp_path, capsys):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        h = fluid.layers.fc(x, size=16, act="relu")
        p = fluid.layers.fc(h, size=1)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    d = str(tmp_path / "model")
    fluid.io.save_inference_model(d, ["x"], [p], exe, main_program=main)
    assert cli_main(["check", "--model-dir", d, "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] and rep["n_errors"] == 0
    assert rep["hbm"]["peak_bytes_per_replica"] > 0
    assert cli_main(["check", "--model-dir", d, "--level", "basic"]) == 0
    assert "verify[basic]" in capsys.readouterr().out
    path = os.path.join(d, "__model__")
    with open(path) as f:
        payload = json.load(f)
    blk = payload["program"]["blocks"][0]
    blk["ops"] = [op for op in blk["ops"] if op["type"] != "mul"]
    with open(path, "w") as f:
        json.dump(payload, f)
    assert cli_main(["check", "--model-dir", d, "--json"]) == 1
    rep = json.loads(capsys.readouterr().out)
    assert "PTA001" in {dd["code"] for dd in rep["diagnostics"]}


def test_cli_check_usage_errors(capsys):
    assert cli_main(["check"]) == 2
    assert cli_main(["check", "--model-dir", "/nonexistent-dir-xyz"]) == 2
    assert cli_main(["check", "--selftest", "--mesh", "dp=oops"]) == 2
    capsys.readouterr()


@pytest.mark.parametrize("action", ["graph", "fusion", "schedule"])
def test_cli_analyze_selftests_ok(action, capsys):
    assert cli_main(["analyze", action, "--selftest"]) == 0
    assert f"analyze {action} selftest: OK" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# CLI: python -m paddle_tpu_torch cache ls | prune | clear
# ---------------------------------------------------------------------------
def test_cache_cli_ls_prune_clear(tmp_path, capsys):
    with flags.flag_guard(compile_cache_dir=""):
        assert cli_main(["cache", "ls"]) == 2  # no dir anywhere
    assert cli_main(["cache", "ls", "--dir", str(tmp_path / "nope")]) == 2
    store = L2Store(str(tmp_path))
    for i, d in enumerate(("1" * 64, "2" * 64)):
        store.put(d, bytes(3 << 19), kind="executor")
        os.utime(store.path_for(d), (i, i))
    capsys.readouterr()
    assert cli_main(["cache", "ls", "--dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "2 entries" in out and torch.__version__ in out
    assert cli_main(["cache", "ls", "--dir", str(tmp_path), "--json"]) == 0
    listing = json.loads(capsys.readouterr().out)
    assert len(listing["entries"]) == 2 and listing["total_bytes"] > 3 << 20
    assert cli_main(["cache", "prune", "--dir", str(tmp_path),
                     "--max-mb", "2"]) == 0
    assert "pruned 1 entries" in capsys.readouterr().out
    assert [e["digest"] for e in store.entries()] == ["2" * 64]
    with flags.flag_guard(compile_cache_dir=str(tmp_path)):
        assert cli_main(["cache", "clear"]) == 0
    assert "removed 1 entries" in capsys.readouterr().out
    assert store.entries() == []
