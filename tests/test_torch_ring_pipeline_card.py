"""Ring attention and pipeline parallelism on the card (`cuda`-marked;
they skip without one). This file imports no JAX: the card's checks hold
the port to its own plain versions.

    python -m pytest tests/test_torch_ring_pipeline_card.py -m cuda

* sp = 4 gloo ranks sharing card 0 (tests/torch_ring_worker.py): each
  hop of ring_flash_attention the flash kernel, the permutes through
  pinned host buffers, causal launches idx + 1 a rank; the gathered
  output against plain attention, f32 and bf16.
* PipelineRunner on the card at p = 2 (the cells captured as CUDA
  graphs, bf16 AMP, the fused momentum kernel): bitwise the one-stage
  run.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import amp, convert, flags
from paddle_tpu_torch.parallel import pipeline

import torch_ring_worker as worker

STEPS = 3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _dense(q, k, v, causal):
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        S = q.shape[2]
        s = np.where(np.tril(np.ones((S, S), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bhkd->bhqd", p, v)


@pytest.mark.cuda
def test_ring_flash_on_one_card_over_gloo(tmp_path):
    _card()
    cases = [{"kind": "ring", "name": dtype, "seed": 7,
              "shape": [1, 4, 256, 64], "causal": True, "flash": True,
              "dtype": dtype} for dtype in ("float32", "bfloat16")]
    res = worker.launch(4, cases, str(tmp_path), timeout=300, cuda=True)
    for case in cases:
        dtype, got = case["dtype"], res[case["name"]]
        assert [int(r["flash_launches"]) for r in got] == [1, 2, 3, 4]
        assert all(int(r["host_staged_bytes"]) > 0 for r in got)
        inp = {n: torch.from_numpy(a).to(getattr(torch, dtype)).float()
               .numpy() for n, a in worker.ring_inputs(
                   7, case["shape"]).items()}
        tol = (3e-5, 1e-4) if dtype == "float32" else (2e-2, 2e-2)
        np.testing.assert_allclose(
            np.concatenate([r["out"] for r in got], axis=2),
            _dense(inp["q"], inp["k"], inp["v"], True), atol=tol[0],
            rtol=tol[1])


def _conv_bn():
    main, start = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, start):
        x = fluid.layers.data(name="x", shape=[3, 8, 8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.conv2d(input=x, num_filters=4, filter_size=3,
                                padding=1, bias_attr=False)
        h = fluid.layers.batch_norm(input=h, act="relu")
        h = fluid.layers.pool2d(input=h, pool_size=2, pool_stride=2,
                                pool_type="max")
        p = fluid.layers.fc(input=h, size=4, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(input=p,
                                                            label=y))
        fluid.optimizer.Momentum(learning_rate=0.05,
                                 momentum=0.9).minimize(loss)
    main.random_seed = start.random_seed = 1
    return main, start, loss.name


@pytest.mark.cuda
def test_pipeline_replay_is_bitwise_on_the_card():
    _card()
    rs = np.random.RandomState(0)
    feed = {"x": rs.randn(8, 3, 8, 8).astype(np.float32),
            "y": rs.randint(0, 4, (8, 1)).astype(np.int64)}
    out, init = {}, None
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for p in (1, 2):
            main, start, loss_name = _conv_bn()
            scope = fluid.Scope()
            fluid.Executor(fluid.CUDAPlace(0)).run(start, scope=scope)
            if init is None:
                init = convert.numpy_state(scope, main)
            convert.load_numpy_state(scope, main, init, fluid.CUDAPlace(0))
            runner = pipeline.PipelineRunner(
                main, p, loss_name=loss_name, feed_names=["x", "y"],
                n_microbatches=2, scope=scope)
            with flags.flag_guard(fuse=True), amp.auto_cast():
                losses = [runner.run(feed)["loss"].tobytes()
                          for _ in range(STEPS)]
            out[p] = (losses, convert.numpy_state(scope, main))
    finally:
        torch.backends.cudnn.deterministic = prev
    assert out[2][0] == out[1][0]
    for n in out[1][1]:
        np.testing.assert_array_equal(out[2][1][n], out[1][1][n],
                                      err_msg=n)
