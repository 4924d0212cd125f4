"""Ring attention (parallel/ring.py) and the P2P permute ops in the port,
held to the JAX package and to plain attention on the CPU.

sp = 2 and 4 gloo ranks, each a process (tests/torch_ring_worker.py,
importing only paddle_tpu_torch, file:// rendezvous in the test's tmp
dir, killed after 120 s), hold one sequence shard each of numpy-seeded
q, k, v at the JAX tests' shapes ([2, 4, 64, 16] for ring_attention,
tests/test_parallel.py; [1, 2, 128, 16] for ring_flash_attention,
tests/test_flash_attention.py). The gathered outputs match the JAX
package's own ring on its 8-device CPU mesh and plain attention over the
whole sequence at atol 3e-5 / rtol 1e-4, causal and not;
ring_attention's q/k/v grads match plain attention's (float64 autograd)
at the same bound. One rank is one hop: ring_flash_attention is then
flash_fwd over the sequence, bitwise. The permute ops are the JAX
package's identities off the mesh and shifts on it ({"pp": 2} over two
ranks, {"pp": 2, "sp": 2} over four: the axes' sub-groups); the
permute's gradient goes back along the inverse permutation.
"""

import concurrent.futures
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core import executor_core as jcore
from paddle_tpu.core import registry as jreg
from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.parallel.ring import (ring_attention as jring,
                                      ring_flash_attention as jring_flash)

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.executor_core import OpContext
from paddle_tpu_torch.parallel import flash as tflash
from paddle_tpu_torch.parallel import mesh as tmesh
from paddle_tpu_torch.parallel import ring as tring

import torch_ring_worker as worker

WORLDS = (2, 4)
ATOL, RTOL = 3e-5, 1e-4
PLAIN_SHAPE = [2, 4, 64, 16]
FLASH_SHAPE = [1, 2, 128, 16]
OPS_MESH = {2: {"pp": 2}, 4: {"pp": 2, "sp": 2}}


def _cases(world):
    cases = [{"kind": "ops", "name": "ops", "seed": 3,
              "mesh": OPS_MESH[world]}]
    for causal in (False, True):
        tag = "causal" if causal else "full"
        cases.append({"kind": "ring", "name": f"plain_{tag}", "seed": 0,
                      "shape": PLAIN_SHAPE, "causal": causal,
                      "flash": False, "grads": True})
        cases.append({"kind": "ring", "name": f"flash_{tag}", "seed": 7,
                      "shape": FLASH_SHAPE, "causal": causal,
                      "flash": True})
    return cases


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ring"))
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futs = {w: pool.submit(worker.launch, w, _cases(w),
                               os.path.join(tmp, f"w{w}"))
                for w in WORLDS}
        return {w: f.result() for w, f in futs.items()}


def _gathered(per_rank, key):
    return np.concatenate([r[key] for r in per_rank], axis=2)


def _dense(q, k, v, causal):
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        S = q.shape[2]
        s = np.where(np.tril(np.ones((S, S), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bhkd->bhqd", p, v)


def _dense_grads(inp, causal):
    """float64 autograd of plain attention over the whole sequence."""
    t = {n: torch.from_numpy(inp[n]).double().requires_grad_(n != "dout")
         for n in ("q", "k", "v", "dout")}
    s = t["q"] @ t["k"].transpose(-1, -2) / inp["q"].shape[-1] ** 0.5
    if causal:
        S = s.shape[-1]
        s = s.masked_fill(~torch.tril(torch.ones(S, S, dtype=torch.bool)),
                          float("-inf"))
    out = torch.softmax(s, -1) @ t["v"]
    (out * t["dout"]).sum().backward()
    return {"d" + n: t[n].grad.numpy() for n in ("q", "k", "v")}


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("world", WORLDS)
def test_ring_attention_matches_the_jax_ring_and_plain_attention(
        results, world, causal):
    tag = "causal" if causal else "full"
    inp = worker.ring_inputs(0, PLAIN_SHAPE, grads=True)
    got = _gathered(results[world][f"plain_{tag}"], "out")
    want = np.asarray(jring(jnp.asarray(inp["q"]), jnp.asarray(inp["k"]),
                            jnp.asarray(inp["v"]), jmake_mesh({"sp": 8}),
                            axis_name="sp", causal=causal))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, _dense(inp["q"], inp["k"], inp["v"],
                                           causal), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("world", WORLDS)
def test_ring_attention_grads_match_plain_attention(results, world, causal):
    tag = "causal" if causal else "full"
    inp = worker.ring_inputs(0, PLAIN_SHAPE, grads=True)
    want = _dense_grads(inp, causal)
    for n in ("dq", "dk", "dv"):
        got = _gathered(results[world][f"plain_{tag}"], n)
        np.testing.assert_allclose(got, want[n], atol=ATOL, rtol=RTOL,
                                   err_msg=n)
    # every hop but the last rotates k and v, and the backward sends
    # their cotangents back: 4 (n - 1) permutes a rank
    for r in results[world][f"plain_{tag}"]:
        assert int(r["permute_launches"]) == 4 * (world - 1)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("world", WORLDS)
def test_ring_flash_attention_matches_the_jax_ring_and_plain_attention(
        results, world, causal):
    tag = "causal" if causal else "full"
    inp = worker.ring_inputs(7, FLASH_SHAPE)
    got = _gathered(results[world][f"flash_{tag}"], "out")
    want = np.asarray(jring_flash(
        jnp.asarray(inp["q"]), jnp.asarray(inp["k"]), jnp.asarray(inp["v"]),
        jmake_mesh({"sp": 8}), axis_name="sp", causal=causal, block_q=16,
        block_k=16))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, _dense(inp["q"], inp["k"], inp["v"],
                                           causal), atol=ATOL, rtol=RTOL)
    for r in results[world][f"flash_{tag}"]:
        assert int(r["permute_launches"]) == 2 * (world - 1)
        assert int(r["host_staged_bytes"]) == 0  # host tensors: no staging


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_one_rank_is_one_hop_and_bitwise_flash_fwd(causal, dtype):
    """No group: the ring is one hop, and the merge with an empty
    accumulator is exact."""
    rs = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, 48, 16).astype(np.float32))
               .to(dtype) for _ in range(3))
    got = tring.ring_flash_attention(q, k, v, tmesh.make_mesh(),
                                     causal=causal)
    want, _ = tflash.flash_fwd(q, k, v, 1.0 / 4.0, causal)
    assert got.dtype == dtype
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))


@pytest.mark.parametrize("causal", [False, True])
def test_hop_cases_launch_as_the_jax_cases(monkeypatch, causal):
    """Each rank's hops in the JAX order: a block from an earlier shard in
    full, its own causally, a later one skipped (no flash_fwd call); the
    last hop does not rotate. Over sp = 4: idx + 1 calls causal (10 over
    the ring), 4 otherwise (16)."""
    calls, rotations = [], []

    def fake_flash(q, k, v, scale, diag):
        calls.append(diag)
        return tflash.flash_fwd_plain(q, k, v, scale, diag)

    monkeypatch.setattr(tring, "flash_fwd", fake_flash)
    monkeypatch.setattr(tring, "permute",
                        lambda x, axis, perm: rotations.append(perm) or x)
    q = torch.ones(1, 1, 8, 4)
    per_rank = []
    for idx in range(4):
        axis = tmesh.MeshAxis("sp", 4, idx, range(4), None, "gloo")
        mesh = tmesh.Mesh({"sp": 4}, {"sp": axis})
        calls.clear()
        rotations.clear()
        timings = []
        tring.ring_flash_attention(q, q, q, mesh, causal=causal,
                                   timings=timings)
        per_rank.append(len(calls))
        assert len(rotations) == 2 * 3
        assert rotations[0] == [(0, 1), (1, 2), (2, 3), (3, 0)]
        assert [t["src"] for t in timings] == [(idx - h) % 4
                                              for h in range(4)]
        if causal:
            assert calls == [True] + [False] * idx
            assert [t["case"] for t in timings] == (
                ["diagonal"] + ["full"] * idx + ["skip"] * (3 - idx))
        else:
            assert calls == [False] * 4
    assert sum(per_rank) == (10 if causal else 16)


def _port(op_type, x, ctx=None, **attrs):
    ctx = ctx or OpContext(tfluid.CPUPlace())
    return treg.run_kernel(treg.lookup(op_type), ctx,
                           {"X": [torch.from_numpy(x)]}, attrs)


def _jax(op_type, x, **attrs):
    return jreg.run_kernel(jreg.lookup(op_type), jcore.OpContext(),
                           {"X": [jnp.asarray(x)]}, attrs)


@pytest.mark.parametrize("op_type,attrs", [
    ("collective_permute", {"axis_name": "sp", "perm": [[0, 1], [1, 0]]}),
    ("pipeline_send", {"axis_name": "pp", "peer": 1}),
    ("pipeline_recv", {"axis_name": "pp", "peer": 1}),
    ("collective_permute_grad", {"axis_name": "sp",
                                 "perm": [[0, 1], [1, 0]]}),
])
def test_off_the_mesh_the_ops_are_the_jax_packages_identities(op_type,
                                                              attrs):
    x = worker.op_input(3, 0)
    if op_type.endswith("_grad"):
        ins = {"X": [torch.from_numpy(x)],
               "Out@GRAD": [torch.from_numpy(2 * x)]}
        got = treg.run_kernel(treg.lookup(op_type),
                              OpContext(tfluid.CPUPlace()), ins,
                              attrs)["X@GRAD"][0].numpy()
        np.testing.assert_array_equal(got, 2 * x)
        return
    got = _port(op_type, x, **attrs)["Out"][0].numpy()
    want = np.asarray(_jax(op_type, x, **attrs)["Out"][0])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("world", WORLDS)
def test_on_the_mesh_the_ops_shift_along_their_axes(results, world):
    """Rank r sits at row-major coordinates over the mesh's axes in the
    order named: collective_permute rotates over sp, pipeline_send shifts
    one hop along pp, pipeline_recv is the identity, and an axis of one
    rank is the identity; the permute's gradient returns each rank's
    cotangent (rank + 1) to its source."""
    shape = OPS_MESH[world]
    sp = shape.get("sp", 1)
    x = [worker.op_input(3, r) for r in range(world)]
    for r, got in enumerate(results[world]["ops"]):
        pp_i, sp_i = divmod(r, sp)
        np.testing.assert_array_equal(
            got["coords"], [pp_i, sp_i, 0] if sp > 1 else [pp_i, 0])
        np.testing.assert_array_equal(
            got["permute"], x[pp_i * sp + (sp_i - 1) % sp])
        np.testing.assert_array_equal(
            got["send"], x[((pp_i - 1) % 2) * sp + sp_i])
        np.testing.assert_array_equal(got["recv"], x[r])
        np.testing.assert_array_equal(got["dp_permute"], x[r])
        dst = pp_i * sp + (sp_i + 1) % sp
        np.testing.assert_array_equal(got["permute_grad"],
                                      np.full((4, 3), dst + 1, np.float32))


def test_mesh_axes_take_the_jax_packages_order():
    """make_mesh names the axes as the JAX package does; an mp axis, like
    any other, needs its ranks (the tensor-parallel slice's tests run it
    over two)."""
    m = tmesh.make_mesh((1, 1, 1, 1))
    assert list(m.shape) == ["dp", "mp", "pp", "sp"]
    assert m.axis("sp") is None and m.axis("pp") is None
    assert m.axis("mp") is None
    assert tmesh.make_mesh({"sp": 1}).shape == {"sp": 1, "dp": 1}
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmesh.make_mesh({"mp": 2})
    with pytest.raises(ValueError, match="needs 4 ranks"):
        tmesh.make_mesh({"sp": 4})
    with pytest.raises(ValueError, match="axes are"):
        tmesh.make_mesh({"tp": 1})
