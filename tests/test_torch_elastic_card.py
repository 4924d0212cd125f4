"""The elastic drill on the card (`cuda`-marked; it skips without one).
This file imports no JAX: the card's run is held to the port's own
one-rank run on the host.

    python -m pytest tests/test_torch_elastic_card.py -m cuda

Two card ranks sharing card 0 (tests/torch_elastic_worker.py with
"cuda": a gloo group formed on the card) train the worker's net through
dp 2 -> 1 -> 2: w1 preempted after step 2, a joiner after step 5. Every
step runs on the interpreter (gloo's host calls are not captured), its
gradient all-reduces staged through pinned host buffers; the losses
match a one-rank Executor run on the host from the same start within
1e-5 (f32, TF32 off), no step lost, the joiner starting at step 6.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.parallel.master import MasterService

import torch_elastic_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 9
DEADLINE_S = 300


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _host_run():
    """(start state, the one-rank losses) on the host."""
    main, start, loss = worker.build(fluid)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(start)
        init = {v.name: scope.find_var(v.name).numpy().copy()
                for v in main.list_vars()
                if v.persistable and scope.find_var(v.name) is not None}
        losses = [float(np.asarray(exe.run(main, feed=worker.feed(s),
                                           fetch_list=[loss])[0]).reshape(()))
                  for s in range(STEPS)]
    return init, losses


@pytest.mark.cuda
def test_dp2_to_1_to_2_card_ranks_share_the_card(tmp_path):
    _card()
    init, ref = _host_run()
    np.savez(tmp_path / "init.npz", **init)
    svc = MasterService()
    ep = f"127.0.0.1:{svc.serve()}"
    out = tmp_path / "out"
    out.mkdir()
    spec = {"master": ep, "checkpoint_dir": str(tmp_path / "ckpt"),
            "out": str(out), "init": str(tmp_path / "init.npz"),
            "steps": STEPS, "start_world": 2, "preempt": {"w1": 2},
            "join": {"w0": {"at": 5, "names": ["w1"]}},
            "deadline_s": DEADLINE_S, "cuda": True}
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.path.join(REPO, "tests"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests",
                                      "torch_elastic_worker.py"),
         str(spec_path), name], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name in ("w0", "w1")]
    logs = []
    try:
        deadline = time.monotonic() + DEADLINE_S + 30
        for p in procs:
            logs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        svc.stop()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    res = {f.name[:-5]: json.loads(f.read_text())
           for f in out.glob("*.json")}
    w0 = res["w0"]
    assert w0["worlds"] == [1, 2] and w0["resizes"] == 2
    assert w0["order"] == list(range(STEPS))
    assert set(w0["modes"]) == {"interpreter"}
    assert w0["host_staged_bytes"] > 0
    np.testing.assert_allclose([w0["losses"][str(s)] for s in range(STEPS)],
                               ref, rtol=1e-5, atol=1e-6)
    assert res["w1"]["left"] and res["w1"]["order"] == [0, 1, 2]
    joiner = res["w1.joiner"]
    assert joiner["first_step"] == 6 and joiner["order"] == [6, 7, 8]
