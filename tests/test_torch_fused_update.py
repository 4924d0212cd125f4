"""The fused bucket updates of the port (ops/fused_ops.py, fusion/kernels.py).

- against the JAX package's fused ops (the Pallas kernels, interpreted on
  the CPU): rtol 1e-6 / atol 1e-7 — XLA's CPU jit contracts multiply-adds
  into FMAs, torch rounds after every operation, so the two differ by an
  ulp here and there;
  the adam bucket also with an AMP-like mix of bf16 and f32 grads (the
  JAX side fed the same bf16 values widened to f32) and with zero1's
  (parts, shard) members;
- inside the port, fused == unfused BITWISE: the packed update replays the
  scalar op's expression tree element by element (a bf16 grad against the
  unfused op on the same grad widened, as AMP's black-listed adam op
  widens it);
- the fused adam update works in place: ParamOut / Moment1Out /
  Moment2Out are the member tensors themselves, holding the new values;
  `plan_adam_bucket` refuses, on either device, what the in-place kernel
  does not take;
- the kernels' plain twins == the scalar ops, bitwise;
- the CUDA entry points refuse CPU tensors instead of computing, and a
  CPU bucket never counts as a kernel launch;
- on a CUDA card (tests marked `cuda`, skipped elsewhere) each kernel is
  bitwise equal to its plain twin: the flat lanes with outputs apart from
  the inputs, and the in-place member lists with mixed bf16/f32 grads, a
  member at a 4-byte (not 16-byte) offset, and more members than one
  launch's table holds.
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


def _bf16(a):
    """f32 numpy -> the bf16 tensor nearest to it."""
    return torch.from_numpy(a).to(torch.bfloat16)


def _amp_grads(ins):
    """The bucket's grads as AMP hands them over: every other member's in
    bf16. Returns the port's grads (tensors) and the same values widened
    to f32 numpy, for the JAX package and the unfused op."""
    grads = [_bf16(g) if k % 2 == 0 else torch.from_numpy(g)
             for k, g in enumerate(ins["Grad"])]
    return grads, [g.float().numpy() for g in grads]


def _port_tensors(op_type, ins, attrs):
    """Run one port op on CPU tensors; returns its outputs as tensors."""
    return treg.run_kernel(
        treg.lookup(op_type), tcore.OpContext(tfluid.CPUPlace()),
        {s: [v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v)) for v in vs] for s, vs in ins.items()},
        dict(attrs))


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


@pytest.mark.parametrize("n", sorted(MEMBERS))
def test_fused_adam_with_bf16_grads_matches_jax(n):
    ins, attrs = _bucket("adam", n), _attrs("adam")
    grads, widened = _amp_grads(ins)
    got = _port_tensors("fused_adam_update", dict(ins, Grad=grads), attrs)
    want = _jax("fused_adam_update", dict(ins, Grad=widened), attrs)
    for slot in want:
        for g, w in zip(got[slot], want[slot]):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7,
                                       err_msg=slot)


@pytest.mark.parametrize("n", sorted(MEMBERS))
def test_fused_adam_with_bf16_grads_equals_unfused_bitwise(n):
    ins, attrs = _bucket("adam", n), _attrs("adam")
    grads, widened = _amp_grads(ins)
    fused = _port_tensors("fused_adam_update", dict(ins, Grad=grads), attrs)
    shared = {s: ins[s] for s in ("LearningRate", "Beta1Pow", "Beta2Pow")}
    for k in range(len(MEMBERS[n])):
        member = dict(shared, **{s: [ins[s][k]] for s in
                                 ("Param", "Moment1", "Moment2")},
                      Grad=[widened[k]])
        for slot, vals in _port("adam", member, attrs).items():
            np.testing.assert_array_equal(fused[slot][k].numpy(), vals[0],
                                          err_msg=slot)


def test_fused_adam_shard_layout_matches_jax():
    """zero1's (parts, shard) members: the JAX package packs them along
    the shard axis, the port updates them in place; the update is
    elementwise, so the two agree."""
    rs = np.random.RandomState(5)
    shapes = [(4, 3), (4, 1), (4, 5)]

    def lanes():
        return [rs.randn(*s).astype(np.float32) for s in shapes]

    ins = {"Param": lanes(), "Grad": lanes(), "Moment1": lanes(),
           "Moment2": [np.abs(v) for v in lanes()],
           "LearningRate": [np.asarray([0.1], np.float32)],
           "Beta1Pow": [np.asarray([0.9 ** 4], np.float32)],
           "Beta2Pow": [np.asarray([0.999 ** 4], np.float32)]}
    attrs = dict(ADAM_ATTRS, shard_rows=4)
    got = _port("fused_adam_update", ins, attrs)
    want = _jax("fused_adam_update", ins, attrs)
    for slot in want:
        for g, w in zip(got[slot], want[slot]):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7,
                                       err_msg=slot)


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16_grads"])
def test_fused_adam_updates_its_members_in_place(amp):
    ins, attrs = _bucket("adam", 1029), _attrs("adam")
    grads, widened = _amp_grads(ins) if amp else (ins["Grad"], ins["Grad"])
    want = _port("fused_adam_update", dict(ins, Grad=widened), attrs)
    members = {s: [torch.from_numpy(v.copy()) for v in ins[s]]
               for s in ("Param", "Moment1", "Moment2")}
    got = _port_tensors("fused_adam_update",
                        dict(ins, Grad=grads, **members), attrs)
    for slot, out_slot in (("Param", "ParamOut"), ("Moment1", "Moment1Out"),
                           ("Moment2", "Moment2Out")):
        for k, t in enumerate(members[slot]):
            assert got[out_slot][k] is t
            np.testing.assert_array_equal(t.numpy(), want[out_slot][k])
            assert not np.array_equal(t.numpy(), ins[slot][k])


def _members(n_members=3, n=17):
    """A CPU bucket's operand lists (p, g, m1, m2), each member its own
    tensors."""
    rs = np.random.RandomState(n_members + n)
    return [[torch.from_numpy(rs.rand(n).astype(np.float32))
             for _ in range(n_members)] for _ in range(4)]


def _refused(case):
    """The bucket `case` names, broken in that one way."""
    ps, gs, m1s, m2s = _members()
    lr_t = torch.tensor(0.01)
    if case == "off_device":
        m2s[1] = torch.empty(17, device="meta")
    elif case == "not_contiguous":
        m1s[2] = torch.rand(17, 2)[:, 0]
    elif case == "param_dtype":
        ps[0] = ps[0].double()
    elif case == "moment_dtype":
        m2s[0] = m2s[0].to(torch.bfloat16)
    elif case == "grad_dtype":
        gs[1] = gs[1].half()
    elif case == "shape":
        gs[2] = gs[2].reshape(17, 1)
    elif case == "shared_moment":  # one zero initializer for two members
        m1s[1] = m1s[0]
    elif case == "overlap":  # views of one buffer that overlap
        buf = torch.rand(30)
        ps[0], ps[1] = buf[:17], buf[10:27]
    elif case == "grad_is_param":
        gs[2] = ps[2]
    elif case == "lengths":
        m2s = m2s[:2]
    elif case == "lr_t":
        lr_t = torch.tensor([0.01, 0.02])
    return ps, gs, m1s, m2s, lr_t


REFUSED = ["off_device", "not_contiguous", "param_dtype", "moment_dtype",
           "grad_dtype", "shape", "shared_moment", "overlap", "grad_is_param",
           "lengths", "lr_t"]


@pytest.mark.parametrize("case", REFUSED)
def test_plan_adam_bucket_refuses(case):
    ps, gs, m1s, m2s, lr_t = _refused(case)
    before = [t.clone() for t in ps if t.device.type == "cpu"]
    with pytest.raises(ValueError, match="adam_bucket_"):
        fk.plan_adam_bucket(ps, gs, m1s, m2s, lr_t)
    with pytest.raises(ValueError, match="adam_bucket_"):
        fk.adam_bucket_(ps, gs, m1s, m2s, lr_t, 0.9, 0.999, 1e-8)
    after = [t for t in ps if t.device.type == "cpu"]
    assert all(torch.equal(a, b) for a, b in zip(after, before))


def test_plan_adam_bucket_takes_disjoint_views_and_bf16_grads():
    ps, gs, m1s, m2s = _members()
    buf = torch.rand(40)
    ps[0], ps[1] = buf[:17], buf[17:34]  # one buffer, no byte shared
    gs[0] = gs[0].to(torch.bfloat16)
    assert fk.plan_adam_bucket(ps, gs, m1s, m2s,
                               torch.tensor(0.01)) == torch.device("cpu")


def test_adam_cuda_entry_refuses_a_cpu_bucket():
    ps, gs, m1s, m2s = _members()
    with pytest.raises(ValueError, match="CUDA"):
        fk.adam_bucket_cuda_(ps, gs, m1s, m2s, torch.tensor(0.01), 0.9,
                             0.999, 1e-8)
    assert fk.adam_bucket.launches == 0


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


def _card_bucket(n, device, gen, misaligned):
    """The operand lists of a bucket of three members on the card — n, n //
    3 + 1 and 5 elements — its grads bf16, f32 and bf16; with
    `misaligned`, the second member's four operands are views 4 bytes (one
    f32 element, not 16 bytes) into their buffers."""
    sizes = [n, n // 3 + 1, 5]
    lists = [[], [], [], []]
    for k, m in enumerate(sizes):
        off = 1 if misaligned and k == 1 else 0
        for j, lst in enumerate(lists):
            t = torch.randn(m + off, generator=gen, device=device)[off:]
            if j == 1 and k != 1:
                t = t.to(torch.bfloat16)
            elif j == 3:
                t = t.abs()
            lst.append(t)
    return lists


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True],
                         ids=["aligned", "misaligned"])
@pytest.mark.parametrize("n", [1, 17, 1029, 4194307])
def test_adam_inplace_kernel_equals_plain_twin_on_the_card(cuda_device, n,
                                                           misaligned):
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    ps, gs, m1s, m2s = _card_bucket(n, cuda_device, gen, misaligned)
    if misaligned:
        assert ps[1].data_ptr() % 16 == 4
    lr_t = torch.full((), 0.01, device=cuda_device)
    plain = [[t.clone() for t in lst] for lst in (ps, m1s, m2s)]
    fk.adam_bucket_plain_(plain[0], gs, plain[1], plain[2], lr_t, 0.9,
                          0.999, 1e-8)
    fk.adam_bucket_(ps, gs, m1s, m2s, lr_t, 0.9, 0.999, 1e-8)
    torch.cuda.synchronize()
    assert fk.adam_bucket.launches == 1
    for got, want in zip((ps, m1s, m2s), plain):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_adam_inplace_kernel_past_one_table_on_the_card(cuda_device):
    """1000 members overflow the kernel's parameter table: several
    launches, each counted, bitwise equal to the plain twin."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    ps, gs, m1s, m2s = ([torch.randn(33, generator=gen, device=cuda_device)
                         for _ in range(1000)] for _ in range(4))
    m2s = [m.abs() for m in m2s]
    lr_t = torch.full((), 0.01, device=cuda_device)
    want = [[t.clone() for t in lst] for lst in (ps, m1s, m2s)]
    fk.adam_bucket_plain_(want[0], gs, want[1], want[2], lr_t, 0.9, 0.999,
                          1e-8)
    fk.adam_bucket_(ps, gs, m1s, m2s, lr_t, 0.9, 0.999, 1e-8)
    torch.cuda.synchronize()
    assert fk.adam_bucket.launches >= 2
    for got, w in zip((ps, m1s, m2s), want):
        assert all(torch.equal(a, b) for a, b in zip(got, w))
