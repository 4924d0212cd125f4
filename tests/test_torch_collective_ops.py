"""The port's collective ops (ops/collective_ops.py) on W in {1, 2, 4} gloo
ranks against numpy, and without a group against the JAX package's ops
outside a mapped axis.

Each W runs as W processes (tests/torch_dp_worker.py, importing only
paddle_tpu_torch, rendezvousing through a file in the test's tmp dir,
killed after 120 s); every rank runs each op's kernel with an OpContext
over its group on its own numpy-seeded inputs (worker.collective_inputs)
and writes what it got. The expected values are the same sums, gathers
and slices in numpy (fp32; the sums within rtol 1e-6, everything else
exact). Gradients take psum's transpose: a rank's cotangent is its part
of the global loss's gradient, so all_reduce's gradient is the sum of
the ranks' cotangents, all_gather's the reduce-scatter of them,
reduce_scatter's their all-gather, broadcast's their sum at the root.
"""

import concurrent.futures
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core import executor_core as jcore
from paddle_tpu.core import registry as jreg
from paddle_tpu.ops import collective_ops as jcoll
from paddle_tpu.parallel import zero1 as jzero1

from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.executor_core import OpContext
from paddle_tpu_torch.ops import collective_ops as tcoll

import torch_dp_worker as worker

WORLDS = (1, 2, 4)
SEED = 5
OPS = ["all_reduce_sum", "all_reduce_mean", "all_reduce_max",
       "all_reduce_min", "all_reduce_sum_grad", "all_reduce_mean_grad",
       "all_gather", "reduce_scatter", "broadcast", "all_gather_grad",
       "reduce_scatter_grad", "broadcast_grad", "zero1_scatter_reduce",
       "zero1_scatter", "zero1_gather"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("collectives"))
    case = [{"kind": "collectives", "name": "ops", "seed": SEED}]
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futs = {w: pool.submit(worker.launch, w, case,
                               os.path.join(tmp, f"w{w}"))
                for w in WORLDS}
        return {w: f.result()["ops"] for w, f in futs.items()}


def expected(op, world, rank):
    inp = [worker.collective_inputs(SEED, r) for r in range(world)]
    x = np.stack([i["x"] for i in inp])
    c = np.stack([i["c"] for i in inp])
    g = np.stack([i["g"] for i in inp])
    k = x.shape[1] // world
    if op == "all_reduce_sum":
        return x.sum(0)
    if op == "all_reduce_mean":
        return x.sum(0) / world
    if op == "all_reduce_max":
        return x.max(0)
    if op == "all_reduce_min":
        return x.min(0)
    if op == "all_reduce_sum_grad":
        return c.sum(0)
    if op == "all_reduce_mean_grad":
        return c.sum(0) / world
    if op == "all_gather":
        return x
    if op == "reduce_scatter":
        return x.sum(0)[rank * k:(rank + 1) * k]
    if op == "broadcast":
        return x[world - 1]
    cots = [worker.collective_cotangents(SEED, r, world)
            for r in range(world)]
    if op == "all_gather_grad":  # the sum of the ranks' rows for this rank
        return sum(t["all_gather"][rank] for t in cots)
    if op == "reduce_scatter_grad":  # every rank's slice, in rank order
        return np.concatenate([t["reduce_scatter"] for t in cots])
    if op == "broadcast_grad":  # the sum of the cotangents, to the root
        s = sum(t["broadcast"] for t in cots)
        return s if rank == world - 1 else np.zeros_like(s)
    if op == "zero1_scatter_reduce":
        return jzero1.to_shard_layout(g.sum(0), world)[rank:rank + 1] * 0.5
    if op == "zero1_scatter":
        return jzero1.to_shard_layout(g[rank], world)[rank:rank + 1]
    # zero1_gather of each rank's zero1_scatter row: row r from rank r
    rows = np.concatenate([jzero1.to_shard_layout(g[r], world)[r:r + 1]
                           for r in range(world)])
    return jzero1.from_shard_layout(rows, 15, (5, 3))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("world", WORLDS)
def test_collective_op_matches_numpy(results, world, op):
    for rank, got in enumerate(results[world]):
        want = expected(op, world, rank)
        assert got[op].shape == want.shape, (op, rank)
        np.testing.assert_allclose(got[op], want, rtol=1e-6, atol=0,
                                   err_msg=f"{op} rank {rank}")


@pytest.mark.cuda
@pytest.mark.parametrize("world", WORLDS)
def test_collective_ops_over_nccl_match_numpy(tmp_path, world):
    """The same ops on W cards over NCCL (its reduce-scatter and
    all-gather, which gloo does not reach), one process a card."""
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA cards")
    got = worker.launch(world, [{"kind": "collectives", "name": "ops",
                                 "seed": SEED}], str(tmp_path), timeout=300,
                        cuda=True)["ops"]
    for op in OPS:
        for rank, res in enumerate(got):
            np.testing.assert_allclose(res[op], expected(op, world, rank),
                                       rtol=1e-6, atol=0,
                                       err_msg=f"{op} rank {rank}")


def _port(op_type, ins, ctx=None, **attrs):
    ctx = ctx or OpContext(CPUPlace())
    return treg.run_kernel(treg.lookup(op_type), ctx,
                           {k: [torch.from_numpy(v)] for k, v in ins.items()},
                           attrs)


def _jax(op_type, ins, **attrs):
    return jreg.run_kernel(jreg.lookup(op_type), jcore.OpContext(),
                           {k: [jnp.asarray(v)] for k, v in ins.items()},
                           attrs)


@pytest.mark.parametrize("op_type,attrs,slot", [
    ("all_reduce", {"reduction": "sum"}, "Out"),
    ("all_reduce", {"reduction": "max"}, "Out"),
    ("all_gather", {}, "Out"),
    ("reduce_scatter", {}, "Out"),
    ("broadcast", {"root": 1}, "Out"),
    ("zero1_scatter", {"parts": 4, "scale": 0.5}, "Out"),
    ("zero1_gather", {"numel": 12, "shape": [3, 4]}, "Out"),
    ("all_reduce_grad", {"reduction": "sum"}, "X@GRAD"),
])
def test_without_a_group_the_ops_are_the_jax_packages_off_mesh_ops(
        op_type, attrs, slot):
    """No group (a plain Executor's step): the identities, and zero1's
    single-device reshape, of the JAX package outside a mapped axis."""
    inp = worker.collective_inputs(SEED, 0)
    x = inp["x"][:3, :] if op_type != "zero1_gather" else inp["x"][:4]
    ins = {"X": x}
    if op_type.endswith("_grad"):
        ins["Out@GRAD"] = inp["c"][:3]
    got = _port(op_type, ins, **attrs)[slot][0].numpy()
    want = np.asarray(_jax(op_type, ins, **attrs)[slot][0])
    np.testing.assert_array_equal(got, want)


def test_collective_table_is_the_jax_packages():
    assert tcoll.COLLECTIVE_RW == jcoll.COLLECTIVE_RW


def test_refusals():
    with pytest.raises(ValueError, match="unknown reduction"):
        _port("all_reduce", {"X": np.ones(2, np.float32)}, reduction="prod")
    with pytest.raises(NotImplementedError):
        treg.lookup("collective_permute")  # with ring attention, item 10


def test_launches_are_counted_and_max_has_no_gradient(tmp_path):
    """One rank in this process: each collective the ops issue counts one
    launch; all_reduce max/min has no gradient."""
    from paddle_tpu_torch.parallel import distributed, mesh

    distributed.initialize("file://" + str(tmp_path / "rendezvous"), 1, 0)
    try:
        ctx = OpContext(CPUPlace(), dp=mesh.make_mesh())
        x = np.arange(6, dtype=np.float32).reshape(3, 2)
        tcoll.reset_launch_counts()
        _port("all_reduce", {"X": x}, ctx)
        _port("zero1_scatter", {"X": x}, ctx, parts=1, reduce=True)
        _port("zero1_gather", {"X": x.reshape(1, 6)}, ctx, numel=6,
              shape=[3, 2])
        assert tcoll.launch.launches == 3
        with pytest.raises(NotImplementedError, match="no gradient"):
            _port("all_reduce_grad", {"X": x, "Out@GRAD": x}, ctx,
                  reduction="max")
    finally:
        torch.distributed.destroy_process_group()
