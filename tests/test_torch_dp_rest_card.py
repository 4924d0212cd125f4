"""Data parallelism over NCCL on several cards (`cuda`-marked; each test
skips below 2 cards). This file imports no JAX.

    python -m pytest tests/test_torch_dp_rest_card.py -m cuda

Each rank is a process on its own card in an NCCL group, its step
captured as a CUDA graph with the collectives inside, and every rank must
exit cleanly: it takes the group down through
parallel.distributed.shutdown (the card's work finished, a barrier, the
meshes' sub-groups, then the default group), and a rank that is still
running 15 s before the launcher's kill prints every thread's stack and
exits (the workers' RANK_HANG_DUMP_S), so a hang fails the test with the
place it hung.

- VGG-16's layers at narrow widths (tests/torch_tp_worker.py's
  `vgg_head`: a conv block, then its fc pair seeded (None, mp) and
  (mp, None)) at dp 1 x mp 2 under bf16 AMP with the fused Adam: finite
  losses, the same on both ranks.
- The headline's network (ResNet-50, models/resnet.py, at 32 x 32 inputs,
  batch 16) at dp 2 under zero1 with FLAGS_fuse and fused Momentum, 3
  steps with FLAGS_overlap_plan off and 3 with it on: both captured, the
  losses and the whole state bitwise equal, the hoisted scatters marked
  asynchronous. One more step of each under torch.profiler: how much of
  the NCCL reduce-scatter kernels' time another stream's kernels ran
  beside (recorded, not gated: PERF.md reads it).
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import convert

import torch_dp_worker as dp_worker
import torch_tp_worker as tp_worker

STEPS = 3


def _two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA cards: NCCL refuses two ranks on one")


@pytest.mark.cuda
def test_vgg_head_over_mp_on_two_cards_exits_cleanly(tmp_path):
    _two_cards()
    main, startup, _ = tp_worker.build(fluid, "vgg_head", "adam")
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    init, data = str(tmp_path / "init.npz"), str(tmp_path / "data.npz")
    np.savez(init, **convert.numpy_state(scope, main))
    np.savez(data, **tp_worker.batches("vgg_head", STEPS, 8))
    cases = [{"kind": "pe", "name": "mp", "net": "vgg_head", "opt": "adam",
              "auto": True, "reduce": False, "amp": True, "fuse": True,
              "init": init, "data": data, "fetch_grads": []}]
    got = tp_worker.launch(2, {"dp": 1, "mp": 2}, cases,
                           str(tmp_path / "ranks"), timeout=300, cuda=True,
                           nccl=True)["mp"]
    for r in got:
        assert np.isfinite(r["losses"]).all()
        assert str(r["step_mode"]) == "graph"
        np.testing.assert_array_equal(r["losses"], got[0]["losses"])


@pytest.mark.cuda
def test_headline_net_overlap_on_two_cards_is_bitwise_and_exits(tmp_path):
    _two_cards()
    main, startup, _, _ = dp_worker.build(fluid, "resnet50", "momentum")
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    init, data = str(tmp_path / "init.npz"), str(tmp_path / "data.npz")
    np.savez(init, **convert.numpy_state(scope, main))
    rs = np.random.RandomState(3)
    np.savez(data, x=rs.rand(STEPS, 16, 3, 32, 32).astype(np.float32),
             y=rs.randint(0, dp_worker.CLASSES,
                          (STEPS, 16, 1)).astype(np.int64))
    cases = [dict(kind="pe", name=f"overlap_{on}", net="resnet50",
                  opt="momentum", zero1=True, fuse=True, gss="",
                  init=init, data=data,
                  overlap=(4 << 20) if on else None,
                  profile=str(tmp_path / f"trace_{on}.json"))
             for on in (False, True)]
    got = dp_worker.launch(2, cases, str(tmp_path / "ranks"), timeout=420,
                           cuda=True)
    for rank in range(2):
        on, off = got["overlap_True"][rank], got["overlap_False"][rank]
        assert str(on["step_mode"]) == str(off["step_mode"]) == "graph"
        np.testing.assert_array_equal(on["losses"], off["losses"])
        for k, v in off.items():
            if k.startswith("state/"):
                np.testing.assert_array_equal(on[k], v, err_msg=k)
        assert int(on["n_overlap_async"]) > 0
        assert int(off["n_overlap_async"]) == 0
        for which, r in (("off", off), ("on", on)):
            print(f"[dp_rest_card] rank {rank} overlap {which}: "
                  f"{int(r['n_rs_kernels'])} reduce-scatter kernels, "
                  f"{float(r['rs_us']):.1f} us, "
                  f"{float(r['rs_overlapped_us']):.1f} us beside another "
                  f"stream's kernels; {int(r['n_kernels'])} kernels; "
                  f"the scatters on {len(r['rs_streams'])} stream(s), "
                  f"the rest on {len(r['other_streams'])}")
    assert os.path.exists(str(tmp_path / "trace_True.json.0"))
