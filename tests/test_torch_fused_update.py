"""The fused bucket updates of the port (ops/fused_ops.py, fusion/kernels.py).

- against the JAX package's fused ops (the Pallas kernels, interpreted on
  the CPU): rtol 1e-6 / atol 1e-7 — XLA's CPU jit contracts multiply-adds
  into FMAs, torch rounds after every operation, so the two differ by an
  ulp here and there;
- inside the port, fused == unfused BITWISE: the packed update replays the
  scalar op's expression tree element by element;
- the kernels' plain twins == the scalar ops, bitwise;
- the CUDA entry points refuse CPU tensors instead of computing, and a
  CPU bucket never counts as a kernel launch;
- on a CUDA card (tests marked `cuda`, skipped elsewhere) each kernel is
  bitwise equal to its plain twin.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core import executor_core as jcore
from paddle_tpu.core import registry as jreg

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import executor_core as tcore
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.fusion import kernels as fk
from paddle_tpu_torch.ops import fused_ops

# members of a bucket of n elements: odd shapes, packed back to back
MEMBERS = {1: [(1,)], 17: [(4, 3), (5,)], 1029: [(7, 7, 7), (7, 49), (343,)]}
ADAM_ATTRS = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}


@pytest.fixture(autouse=True)
def _fresh_port_state():
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    tfluid.unique_name.switch()
    fk.reset_launch_counts()
    yield


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda", 0)


def _port(op_type, ins, attrs):
    outs = treg.run_kernel(
        treg.lookup(op_type), tcore.OpContext(tfluid.CPUPlace()),
        {s: [torch.from_numpy(np.array(v)) for v in vs]
         for s, vs in ins.items()}, dict(attrs))
    return {s: [v.numpy() for v in vs] for s, vs in outs.items()}


def _jax(op_type, ins, attrs):
    outs = jreg.run_kernel(
        jreg.lookup(op_type), jcore.OpContext(eager=True),
        {s: [jnp.asarray(v) for v in vs] for s, vs in ins.items()},
        dict(attrs))
    return {s: [np.asarray(v) for v in vs] for s, vs in outs.items()}


def _bucket(opt, n, seed=0):
    rs = np.random.RandomState(seed + n)

    def lanes():
        return [rs.randn(*s).astype(np.float32) for s in MEMBERS[n]]

    ins = {"Param": lanes(), "Grad": lanes(),
           "LearningRate": [np.asarray([0.1], np.float32)]}
    if opt == "momentum":
        ins["Velocity"] = lanes()
    else:
        ins["Moment1"] = lanes()
        ins["Moment2"] = [np.abs(v) for v in lanes()]
        ins["Beta1Pow"] = [np.asarray([0.9 ** 4], np.float32)]
        ins["Beta2Pow"] = [np.asarray([0.999 ** 4], np.float32)]
    return ins


def _attrs(opt, nesterov=False):
    if opt == "momentum":
        return {"mu": 0.9, "use_nesterov": nesterov, "shard_rows": 0}
    return dict(ADAM_ATTRS, shard_rows=0)


CASES = [("momentum", False), ("momentum", True), ("adam", False)]
IDS = ["momentum", "nesterov", "adam"]


@pytest.mark.parametrize("n", sorted(MEMBERS))
@pytest.mark.parametrize("opt,nesterov", CASES, ids=IDS)
def test_fused_update_matches_jax(opt, nesterov, n):
    ins, attrs = _bucket(opt, n), _attrs(opt, nesterov)
    got = _port(f"fused_{opt}_update", ins, attrs)
    want = _jax(f"fused_{opt}_update", ins, attrs)
    assert set(got) == set(want)
    for slot in want:
        for g, w in zip(got[slot], want[slot]):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7,
                                       err_msg=slot)


@pytest.mark.parametrize("n", sorted(MEMBERS))
@pytest.mark.parametrize("opt,nesterov", CASES, ids=IDS)
def test_fused_equals_unfused_bitwise(opt, nesterov, n):
    ins, attrs = _bucket(opt, n), _attrs(opt, nesterov)
    fused = _port(f"fused_{opt}_update", ins, attrs)
    shared = {s: vs for s, vs in ins.items()
              if s in ("LearningRate", "Beta1Pow", "Beta2Pow")}
    for k in range(len(MEMBERS[n])):
        member = dict(shared, **{s: [vs[k]] for s, vs in ins.items()
                                 if s not in shared})
        single = _port(opt, member, attrs)
        for slot, vals in single.items():
            np.testing.assert_array_equal(fused[slot][k], vals[0],
                                          err_msg=slot)
    assert fk.momentum_bucket.launches == fk.adam_bucket.launches == 0


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_plain_twin_equals_scalar_op_bitwise(nesterov):
    rs = np.random.RandomState(21)
    p, g, v = (torch.from_numpy(rs.randn(1029).astype(np.float32))
               for _ in range(3))
    lr = torch.tensor([0.1])
    po, vo = fk.momentum_bucket_plain(p, g, v, lr.reshape(()), 0.9, nesterov)
    ref = _port("momentum", {"Param": [p.numpy()], "Grad": [g.numpy()],
                             "Velocity": [v.numpy()],
                             "LearningRate": [lr.numpy()]},
                {"mu": 0.9, "use_nesterov": nesterov})
    np.testing.assert_array_equal(po.numpy(), ref["ParamOut"][0])
    np.testing.assert_array_equal(vo.numpy(), ref["VelocityOut"][0])


def test_adam_plain_twin_equals_scalar_op_bitwise():
    rs = np.random.RandomState(22)
    p, g, m1 = (torch.from_numpy(rs.randn(1029).astype(np.float32))
                for _ in range(3))
    m2 = torch.from_numpy(np.abs(rs.randn(1029)).astype(np.float32))
    lr, b1p, b2p = (torch.tensor([x], dtype=torch.float32)
                    for x in (0.01, 0.9 ** 2, 0.999 ** 2))
    lr_t = lr.reshape(()) * torch.sqrt(1 - b2p.reshape(())) \
        / (1 - b1p.reshape(()))
    po, m1o, m2o = fk.adam_bucket_plain(p, g, m1, m2, lr_t, 0.9, 0.999, 1e-8)
    ref = _port("adam", {"Param": [p.numpy()], "Grad": [g.numpy()],
                         "Moment1": [m1.numpy()], "Moment2": [m2.numpy()],
                         "LearningRate": [lr.numpy()],
                         "Beta1Pow": [b1p.numpy()], "Beta2Pow": [b2p.numpy()]},
                ADAM_ATTRS)
    np.testing.assert_array_equal(po.numpy(), ref["ParamOut"][0])
    np.testing.assert_array_equal(m1o.numpy(), ref["Moment1Out"][0])
    np.testing.assert_array_equal(m2o.numpy(), ref["Moment2Out"][0])


@pytest.mark.parametrize("kernel", ["momentum", "adam"])
def test_cuda_entry_points_refuse_cpu_tensors(kernel):
    x = torch.ones(17)
    lr = torch.tensor(0.1)
    with pytest.raises(ValueError, match="CUDA"):
        if kernel == "momentum":
            fk.momentum_bucket_cuda(x, x, x, lr, 0.9, False)
        else:
            fk.adam_bucket_cuda(x, x, x, x, lr, 0.9, 0.999, 1e-8)
    assert fk.momentum_bucket.launches == fk.adam_bucket.launches == 0


@pytest.mark.parametrize("opt,nesterov", CASES, ids=IDS)
def test_fuse_pallas_off_runs_the_packed_expression_bitwise(opt, nesterov):
    """FLAGS_fuse_pallas is accepted and gates nothing: with it off a CPU
    bucket still takes the plain twin, bit for bit the same."""
    ins, attrs = _bucket(opt, 1029), _attrs(opt, nesterov)
    on = _port(f"fused_{opt}_update", ins, attrs)
    with tfluid.flags.flag_guard(fuse_pallas=False):
        off = _port(f"fused_{opt}_update", ins, attrs)
    for slot in on:
        for a, b in zip(on[slot], off[slot]):
            np.testing.assert_array_equal(a, b, err_msg=slot)
    assert fk.momentum_bucket.launches == fk.adam_bucket.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["momentum", "adam"])
def test_fuse_pallas_off_still_launches_the_kernel_on_the_card(cuda_device,
                                                              opt):
    ins, attrs = _bucket(opt, 1029), _attrs(opt)
    with tfluid.flags.flag_guard(fuse_pallas=False):
        treg.run_kernel(
            treg.lookup(f"fused_{opt}_update"),
            tcore.OpContext(tfluid.CUDAPlace(cuda_device.index)),
            {s: [torch.from_numpy(np.array(v)).to(cuda_device) for v in vs]
             for s, vs in ins.items()}, dict(attrs))
    torch.cuda.synchronize()
    assert getattr(fk, f"{opt}_bucket").launches == 1


@pytest.mark.parametrize("rows", [0, 4], ids=["flat", "shard_layout"])
def test_pack_unpack_round_trip(rows):
    rs = np.random.RandomState(4)
    shapes = [(4, 3), (4, 1), (4, 5)] if rows else [(13, 3), (17,), (1,)]
    vals = [torch.from_numpy(rs.randn(*s).astype(np.float32))
            for s in shapes]
    buf = fused_ops._pack(vals, rows)
    assert tuple(buf.shape) == ((4, 9) if rows else (57,))
    for got, want in zip(fused_ops._unpack(buf, vals, rows), vals):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 17, 1029, 4194307])
def test_kernels_equal_plain_twins_on_the_card(cuda_device, n):
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    p, g, v = (torch.randn(n, generator=gen, device=cuda_device)
               for _ in range(3))
    lr = torch.full((), 0.01, device=cuda_device)
    for nesterov in (False, True):
        got = fk.momentum_bucket(p, g, v, lr, 0.9, nesterov)
        want = fk.momentum_bucket_plain(p, g, v, lr, 0.9, nesterov)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    m2 = v.abs()
    got = fk.adam_bucket(p, g, v, m2, lr, 0.9, 0.999, 1e-8)
    want = fk.adam_bucket_plain(p, g, v, m2, lr, 0.9, 0.999, 1e-8)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    torch.cuda.synchronize()
    assert fk.momentum_bucket.launches == 2 and fk.adam_bucket.launches == 1
