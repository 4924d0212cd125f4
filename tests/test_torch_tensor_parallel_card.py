"""Tensor parallelism on the card (`cuda`-marked; it skips without one).
This file imports no JAX: the card's runs are held to the port's own
one-rank run on the card.

    python -m pytest tests/test_torch_tensor_parallel_card.py -m cuda

Phase tensor_parallel's checks of chip_smoke.py at a reduced depth: two
card ranks sharing card 0 (tests/torch_tp_worker.py with "cuda": a gloo
group formed on the card, TF32 off) train VGG-16's layers at narrow
widths (the worker's `vgg_head`: a conv block, then fc1 seeded
(None, mp), batch norm, dropout and fc2 seeded (mp, None)) at dp 1 × mp 2
under bf16 AMP with the fused Adam, auto_sharding on and off: every loss
within 2e-2 of a one-rank ParallelExecutor's on the card from the same
state, the state every rank holds whole bitwise equal across the ranks,
fc1's weight and moments within 2e-2 (relative norm) and adam_bucket
launches on each rank. (c): the sharded embedding at the NMT's table
width, bf16, over mp = 2: rows bitwise F.embedding's, its table gradient
within 1e-6 of F.embedding's taken in f32 and rounded to bf16 (the
cotangent's sums are exact in f32, so that is the exact gradient).
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import amp, convert, flags

import torch_tp_worker as worker

STEPS = 3
BATCH = 8
AMP_RTOL = 2e-2


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _inputs(tmp_path):
    """(init npz path, data npz path, init, data) of the vgg_head net."""
    main, startup, _ = worker.build(fluid, "vgg_head", "adam")
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    init = convert.numpy_state(scope, main)
    data = worker.batches("vgg_head", STEPS, BATCH)
    init_path, data_path = str(tmp_path / "init.npz"), str(
        tmp_path / "data.npz")
    np.savez(init_path, **init)
    np.savez(data_path, **data)
    return init_path, data_path, init, data


def _held_to_one_rank(ranks, losses, state):
    """Every rank's losses and fc1's state against the one-rank run's
    (AMP bounds), adam launches on each, the state bitwise across
    them."""
    fc1 = ("fc1_w", "fc1_w_moment1_0", "fc1_w_moment2_0")
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, rtol=AMP_RTOL)
        assert int(r["adam_launches"]) > 0
        for n in fc1:
            err = np.linalg.norm(r[f"state/{n}"] - state[n]) \
                / np.linalg.norm(state[n])
            assert err < AMP_RTOL, (n, err)
    for k, v in ranks[0].items():
        if k.startswith("state/"):
            np.testing.assert_array_equal(ranks[1][k], v, err_msg=k)


def _one_rank(init, data):
    """The one-rank ParallelExecutor on the card, bf16 AMP, FLAGS_fuse:
    (losses, full state)."""
    main, _, loss = worker.build(fluid, "vgg_head", "adam", seeds=False)
    place = fluid.CUDAPlace(0)
    scope = fluid.Scope()
    convert.load_numpy_state(scope, main, init, place)
    amp.enable("bfloat16")
    try:
        with fluid.scope_guard(scope), flags.flag_guard(fuse=True):
            pe = fluid.ParallelExecutor(use_cuda=True, loss_name=loss.name,
                                        main_program=main)
            losses = [float(pe.run([loss], feed={
                n: v[k] for n, v in data.items()})[0].reshape(-1)[0])
                for k in range(STEPS)]
            state = convert.numpy_state(scope, main)
    finally:
        amp.disable()
    return np.asarray(losses), state


@pytest.mark.cuda
def test_vgg_head_over_mp_on_the_card_matches_one_rank(tmp_path):
    _card()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    init_path, data_path, init, data = _inputs(tmp_path)
    cases = [{"kind": "pe", "name": f"auto_{auto}", "net": "vgg_head",
              "opt": "adam", "auto": auto, "reduce": False, "amp": True,
              "fuse": True, "init": init_path, "data": data_path,
              "fetch_grads": []} for auto in (True, False)]
    cases.append({"kind": "embedding", "name": "emb", "seed": 5,
                  "table": [30000, 512], "zipf": 2048})
    got = worker.launch(2, {"dp": 1, "mp": 2}, cases,
                        str(tmp_path / "ranks"), timeout=600, cuda=True)
    losses, state = _one_rank(init, data)
    for auto in (True, False):
        _held_to_one_rank(got[f"auto_{auto}"], losses, state)
    for r, e in enumerate(got["emb"]):
        np.testing.assert_array_equal(e["rows"], e["dense_rows"])
        rows = 30000 // 2
        want = e["dense_grad"][r * rows:(r + 1) * rows]
        assert np.abs(e["shard_grad"] - want).max() <= 1e-6

