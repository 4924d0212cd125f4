"""The single-device op tail of the port (the reductions, matmul, clipping,
cos_sim, cumsum, norm, the tensor ops, comparison and logic, the dense
losses) against the JAX package's kernels, op by op.

The same numpy inputs (np.random.RandomState) go through the JAX kernel
and the port's kernel on the CPU; gradients come from each side's derived
`<op>_grad` kernel (jax.vjp there, torch.autograd here) with the same
random cotangents. Bounds:
  * fp32: outputs and gradients within rtol 1e-4 (atol 1e-5 for values
    near 0); shapes equal, dtypes equal but for the JAX package's int32
    where the port holds int64 (64-bit types are off there);
  * under bf16 AMP (both packages' auto_cast, float inputs given in
    bf16): the same output dtypes, values within rtol 2e-2 (atol 2e-2
    near 0): bf16 keeps 8 significant bits and the two sum in another
    order before they round;
  * the port's gradient against central differences in float64 (step
    1e-6): rtol 1e-6, atol 1e-8.
The tests marked `cuda` hold each op on the card to its run on the CPU
(fp32 bounds) and skip without a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import amp as jamp
from paddle_tpu.core import executor_core as jcore
from paddle_tpu.core import registry as jreg

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.core import executor_core as tcore
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core import scope as tscope

F32 = dict(rtol=1e-4, atol=1e-5)
AMP = dict(rtol=2e-2, atol=2e-2)
FD = dict(rtol=1e-6, atol=1e-8)
FD_STEP = 1e-6


@pytest.fixture(autouse=True)
def _fresh_port_state():
    torch.set_num_threads(2)
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    tfluid.unique_name.switch()
    yield
    tamp.disable()


def _r(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _distinct(rs, *shape):
    """Values spaced at least 1e-3 apart: no ties, no kink within a
    finite-difference step."""
    n = int(np.prod(shape))
    return (rs.permutation(n).astype(np.float32) * 0.01 - n * 0.005
            + 0.001).reshape(shape)


def _cases():
    """{case: (op type, inputs, attrs, output slots that take a
    cotangent)}, small shapes, one RandomState each."""
    rs = np.random.RandomState(11)
    c = {}
    x = _distinct(rs, 3, 4, 5)
    c["reduce_sum"] = ("reduce_sum", {"X": [x]}, {"dim": [1],
                                                  "keep_dim": True}, ["Out"])
    c["reduce_mean"] = ("reduce_mean", {"X": [x]}, {}, ["Out"])
    c["reduce_max"] = ("reduce_max", {"X": [x]}, {"reduce_all": True},
                       ["Out"])
    c["reduce_min"] = ("reduce_min", {"X": [x]}, {"dim": -1,
                                                  "keep_dim": True}, ["Out"])
    c["reduce_prod"] = ("reduce_prod", {"X": [_r(rs, 2, 3, 4)]},
                        {"dim": [0, 2]}, ["Out"])
    c["reduce_sum_int"] = ("reduce_sum", {"X": [rs.randint(
        -5, 5, (3, 4)).astype(np.int32)]}, {"dim": [0]}, [])
    c["matmul"] = ("matmul", {"X": [_r(rs, 4, 3)], "Y": [_r(rs, 3, 5)]},
                   {}, ["Out"])
    c["matmul_transposed_alpha"] = (
        "matmul", {"X": [_r(rs, 3, 4)], "Y": [_r(rs, 5, 3)]},
        {"transpose_X": True, "transpose_Y": True, "alpha": 0.5}, ["Out"])
    c["matmul_vector"] = ("matmul", {"X": [_r(rs, 3)], "Y": [_r(rs, 3)]},
                          {}, ["Out"])
    c["matmul_batched"] = ("matmul", {"X": [_r(rs, 2, 4, 3)],
                                      "Y": [_r(rs, 3, 5)]}, {}, ["Out"])
    c["clip"] = ("clip", {"X": [_distinct(rs, 4, 5)]},
                 {"min": -0.0505, "max": 0.0405}, ["Out"])
    c["clip_by_norm"] = ("clip_by_norm", {"X": [_r(rs, 4, 5)]},
                         {"max_norm": 1.0}, ["Out"])
    c["clip_by_norm_below"] = ("clip_by_norm", {"X": [_r(rs, 4, 5)]},
                               {"max_norm": 100.0}, ["Out"])
    c["cos_sim"] = ("cos_sim", {"X": [_r(rs, 4, 6)], "Y": [_r(rs, 1, 6)]},
                    {}, ["Out"])
    c["cumsum"] = ("cumsum", {"X": [_r(rs, 3, 5)]}, {"axis": 1}, ["Out"])
    c["cumsum_exclusive_reverse"] = (
        "cumsum", {"X": [_r(rs, 3, 5)]},
        {"axis": 0, "exclusive": True, "reverse": True}, ["Out"])
    c["norm"] = ("norm", {"X": [_r(rs, 3, 4, 2)]}, {"axis": 1}, ["Out"])
    c["split_num"] = ("split", {"X": [_r(rs, 4, 6)]},
                      {"axis": 1, "num": 3}, ["Out"])
    c["split_sections"] = ("split", {"X": [_r(rs, 5, 4)]},
                           {"axis": 0, "sections": [2, 3]}, ["Out"])
    c["transpose"] = ("transpose", {"X": [_r(rs, 2, 3, 4)]},
                      {"axis": [2, 0, 1]}, ["Out"])
    c["pad"] = ("pad", {"X": [_r(rs, 2, 3)]},
                {"paddings": [1, 0, 2, 1], "pad_value": 0.5}, ["Out"])
    c["crop"] = ("crop", {"X": [_r(rs, 4, 5)]},
                 {"offsets": [1, 2], "shape": [2, 3]}, ["Out"])
    c["gather"] = ("gather", {"X": [_r(rs, 5, 3)],
                              "Index": [np.array([4, 0, 4, 2, 4])]}, {},
                   ["Out"])
    c["scatter_repeated_ids"] = (
        "scatter", {"X": [_r(rs, 6, 3)],
                    "Ids": [np.array([1, 3, 1, 1, 0, 3])],
                    "Updates": [_r(rs, 6, 3)]}, {}, ["Out"])
    c["one_hot"] = ("one_hot", {"X": [np.array([[0], [3], [2], [3]])]},
                    {"depth": 4}, [])
    c["fill_constant_batch_size_like"] = (
        "fill_constant_batch_size_like", {"Input": [_r(rs, 7, 2)]},
        {"shape": [-1, 3], "value": 1.5, "dtype": "float32"}, [])
    c["fill_zeros_like"] = ("fill_zeros_like", {"X": [_r(rs, 3, 2)]}, {},
                            [])
    c["shape"] = ("shape", {"X": [_r(rs, 3, 1, 4)]}, {}, [])
    c["increment"] = ("increment", {"X": [np.array([6], np.int64)]},
                      {"step": 1.0}, [])
    c["increment_float"] = ("increment", {"X": [_r(rs, 1)]},
                            {"step": 0.5}, ["Out"])
    c["expand"] = ("expand", {"X": [_r(rs, 2, 3)]},
                   {"expand_times": [2, 3]}, ["Out"])
    c["label_smooth"] = ("label_smooth", {"X": [np.eye(4, dtype=np.float32)[
        [0, 2, 3]]]}, {"epsilon": 0.1}, ["Out"])
    c["label_smooth_prior"] = (
        "label_smooth", {"X": [np.eye(4, dtype=np.float32)[[1, 2]]],
                         "PriorDist": [np.full((1, 4), 0.25, np.float32)]},
        {"epsilon": 0.2}, ["Out"])
    c["reverse"] = ("reverse", {"X": [_r(rs, 3, 4)]}, {"axis": [0, 1]},
                    ["Out"])
    c["assign_value"] = ("assign_value", {}, {
        "shape": [2, 3], "dtype": "float32",
        "values": [0.5, -1.0, 2.0, 3.25, 0.1, -7.0]}, [])
    c["arg_max"] = ("arg_max", {"X": [_distinct(rs, 3, 5)]}, {"axis": 1},
                    [])
    c["arg_max_rank1"] = ("arg_max", {"X": [np.array(
        [1.0, 3.0, 3.0, 2.0], np.float32)]}, {}, [])
    c["arg_min"] = ("arg_min", {"X": [np.array(
        [[2.0, 0.0, 0.0], [1.0, 1.0, 5.0]], np.float32)]}, {"axis": -1}, [])
    c["argsort_ties"] = ("argsort", {"X": [np.array(
        [[3.0, 1.0, 3.0, 1.0, 2.0, 1.0], [0.0, 0.0, -1.0, 0.0, 5.0, -1.0]],
        np.float32)]}, {"axis": -1}, [])
    c["argsort"] = ("argsort", {"X": [_distinct(rs, 4, 3)]}, {"axis": 0},
                    ["Out"])
    c["isfinite"] = ("isfinite", {"X": [_r(rs, 3, 4)]}, {}, [])
    c["isfinite_inf"] = ("isfinite", {"X": [np.array(
        [1.0, np.inf, 0.0], np.float32)]}, {}, [])
    a, b = rs.randint(0, 3, (3, 4)), rs.randint(0, 3, (3, 4))
    for op in ("less_than", "less_equal", "greater_than", "greater_equal",
               "equal", "not_equal"):
        c[op] = (op, {"X": [a.astype(np.float32)],
                      "Y": [b.astype(np.float32)]}, {}, [])
    c["less_than_broadcast"] = ("less_than", {"X": [_r(rs, 3, 4)],
                                              "Y": [_r(rs, 4)]}, {}, [])
    p, q = rs.rand(3, 4) > 0.5, rs.rand(3, 4) > 0.5
    for op in ("logical_and", "logical_or", "logical_xor"):
        c[op] = (op, {"X": [p], "Y": [q]}, {}, [])
    c["logical_not"] = ("logical_not", {"X": [p]}, {}, [])
    logits = _r(rs, 5, 7, scale=2.0)
    soft = rs.rand(5, 7).astype(np.float32)
    soft /= soft.sum(1, keepdims=True)
    c["softmax_with_cross_entropy"] = (
        "softmax_with_cross_entropy",
        {"Logits": [logits], "Label": [rs.randint(0, 7, (5, 1))]}, {},
        ["Loss", "Softmax"])
    c["softmax_with_cross_entropy_soft"] = (
        "softmax_with_cross_entropy", {"Logits": [logits], "Label": [soft]},
        {"soft_label": True}, ["Loss"])
    c["sigmoid_cross_entropy_with_logits"] = (
        "sigmoid_cross_entropy_with_logits",
        {"X": [_r(rs, 4, 3, scale=2.0)],
         "Label": [rs.rand(4, 3).astype(np.float32)]}, {}, ["Out"])
    c["square_error_cost"] = ("square_error_cost", {"X": [_r(rs, 4, 1)],
                                                    "Y": [_r(rs, 4, 1)]},
                              {}, ["Out"])
    c["squared_l2_norm"] = ("squared_l2_norm", {"X": [_r(rs, 3, 4)]}, {},
                            ["Out"])
    c["squared_l2_distance"] = ("squared_l2_distance",
                                {"X": [_r(rs, 4, 3)], "Y": [_r(rs, 4, 3)]},
                                {}, ["Out"])
    c["smooth_l1_loss"] = (
        "smooth_l1_loss", {"X": [_r(rs, 4, 3)], "Y": [_r(rs, 4, 3)],
                           "InsideWeight": [rs.rand(4, 3).astype(np.float32)],
                           "OutsideWeight": [rs.rand(4, 3).astype(
                               np.float32)]},
        {"sigma": 1.5}, ["Out"])
    c["huber_loss"] = ("huber_loss", {"X": [_r(rs, 5, 1)],
                                      "Y": [_r(rs, 5, 1)]}, {"delta": 0.7},
                       ["Out"])
    c["hinge_loss"] = ("hinge_loss", {"Logits": [_r(rs, 5, 1)],
                                      "Labels": [rs.randint(0, 2, (
                                          5, 1)).astype(np.float32)]}, {},
                       ["Loss"])
    c["rank_loss"] = ("rank_loss", {"Label": [rs.randint(0, 2, (
        4, 1)).astype(np.float32)], "Left": [_r(rs, 4, 1)],
        "Right": [_r(rs, 4, 1)]}, {}, ["Out"])
    c["margin_rank_loss"] = (
        "margin_rank_loss",
        {"Label": [np.array([[1.0], [-1.0], [1.0], [-1.0]], np.float32)],
         "X1": [_r(rs, 4, 1)], "X2": [_r(rs, 4, 1)]}, {"margin": 0.1},
        ["Out"])
    c["log_loss"] = ("log_loss", {"Predicted": [rs.uniform(
        0.05, 0.95, (5, 1)).astype(np.float32)], "Labels": [rs.randint(
            0, 2, (5, 1)).astype(np.float32)]}, {"epsilon": 1e-4}, ["Loss"])
    return c


CASES = _cases()
GRAD_CASES = sorted(k for k, v in CASES.items() if v[3])
FLOAT_CASES = sorted(k for k, v in CASES.items() if any(
    np.asarray(a).dtype == np.float32 for vs in v[1].values() for a in vs))


def test_every_op_type_of_the_slice_has_a_case():
    """The 51 op types of this slice that are not update rules (those are
    tests/test_torch_optimizers.py's) each have a case here."""
    want = {"reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
            "reduce_prod", "matmul", "clip", "clip_by_norm", "cos_sim",
            "cumsum", "norm", "split", "transpose", "pad", "crop", "gather",
            "scatter", "one_hot", "fill_constant_batch_size_like",
            "fill_zeros_like", "shape", "increment", "expand",
            "label_smooth", "reverse", "assign_value", "arg_max", "arg_min",
            "argsort", "isfinite", "equal", "not_equal", "less_than",
            "less_equal", "greater_than", "greater_equal", "logical_and",
            "logical_or", "logical_xor", "logical_not",
            "softmax_with_cross_entropy", "sigmoid_cross_entropy_with_logits",
            "square_error_cost", "squared_l2_norm", "squared_l2_distance",
            "smooth_l1_loss", "huber_loss", "hinge_loss", "rank_loss",
            "margin_rank_loss", "log_loss"}
    assert len(want) == 51
    assert {v[0] for v in CASES.values()} == want
    for t in want:
        assert treg.get_op_def(t) is not None, t


# ---------------------------------------------------------------------------
# running either package's kernel
# ---------------------------------------------------------------------------
def _jnp(v):
    return jnp.asarray(v)


def _torch(v, device="cpu"):
    """numpy -> torch; a bf16 (ml_dtypes) array goes through f32, exactly."""
    v = np.asarray(v)
    if v.dtype == jnp.bfloat16:
        return torch.from_numpy(v.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(v.copy()).to(device)


def _run_jax(op_type, ins, attrs):
    outs = jreg.run_kernel(jreg.lookup(op_type), jcore.OpContext(),
                           {s: [_jnp(v) for v in vs]
                            for s, vs in ins.items()}, dict(attrs))
    return {s: [None if v is None else np.asarray(v) for v in vs]
            for s, vs in outs.items()}


def _run_port(op_type, ins, attrs, device="cpu"):
    place = tfluid.CPUPlace() if device == "cpu" else tfluid.CUDAPlace(0)
    outs = treg.run_kernel(treg.lookup(op_type), tcore.OpContext(place),
                           {s: [_torch(v, device) for v in vs]
                            for s, vs in ins.items()}, dict(attrs))
    return {s: [None if v is None else v for v in vs]
            for s, vs in outs.items()}


def _np(t):
    return t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().cpu().numpy()


def _dtype_name(a):
    if isinstance(a, torch.Tensor):
        return str(a.dtype).replace("torch.", "")
    return str(np.asarray(a).dtype)


def _same_dtype(port, jax):
    """The port's int64 stands for the JAX package's int32."""
    p, j = _dtype_name(port), _dtype_name(jax)
    return p == j or (p == "int64" and j == "int32")


def _assert_outputs(got, want, tol):
    for slot, vals in want.items():
        assert len(got.get(slot, [])) == len(vals), slot
        for j, t in zip(vals, got[slot]):
            if j is None:
                continue
            assert tuple(t.shape) == tuple(np.shape(j)), (slot, t.shape,
                                                          np.shape(j))
            assert _same_dtype(t, j), (slot, t.dtype, j.dtype)
            tv = _np(t)
            if tv.dtype.kind in "biu":
                np.testing.assert_array_equal(tv, np.asarray(j),
                                              err_msg=slot)
            else:
                np.testing.assert_allclose(tv, np.asarray(j, np.float32),
                                           err_msg=slot, **tol)


def _cotangents(outs, slots, seed):
    rs = np.random.RandomState(seed)
    return {f"{s}@GRAD": [rs.randn(*np.shape(v)).astype(np.float32)
                          for v in outs[s]] for s in slots}


def _filled(outs):
    return {s: vs for s, vs in outs.items()
            if any(v is not None for v in vs)}


# ---------------------------------------------------------------------------
# fp32 and AMP parity with the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_grad_match_the_jax_op(case):
    op_type, ins, attrs, slots = CASES[case]
    want = _run_jax(op_type, ins, attrs)
    _assert_outputs(_run_port(op_type, ins, attrs), want, F32)
    if not slots:
        return
    gins = dict(ins, **_cotangents(want, slots, len(case)))
    jg = _filled(_run_jax(op_type + "_grad", gins, attrs))
    tg = _filled(_run_port(op_type + "_grad", gins, attrs))
    assert set(tg) == set(jg)
    _assert_outputs(tg, jg, F32)


def _bf16(ins):
    return {s: [np.asarray(v).astype(jnp.bfloat16)
                if np.asarray(v).dtype == np.float32 else v for v in vs]
            for s, vs in ins.items()}


@pytest.mark.parametrize("case", FLOAT_CASES)
def test_amp_dtype_flow_and_values_match_the_jax_op(case):
    """Under auto_cast(), from bf16 inputs: matmul (white) stays bf16, the
    losses and the norms (black) compute in f32, the rest keep bf16 — as
    in the JAX package — and the gradients follow."""
    op_type, ins, attrs, slots = CASES[case]
    ins = _bf16(ins)
    with tamp.auto_cast(), jamp.auto_cast():
        want = _run_jax(op_type, ins, attrs)
        _assert_outputs(_run_port(op_type, ins, attrs), want, AMP)
        if not slots:
            return
        gins = dict(ins, **_cotangents(want, slots, len(case)))
        jg = _filled(_run_jax(op_type + "_grad", gins, attrs))
        tg = _filled(_run_port(op_type + "_grad", gins, attrs))
    assert set(tg) == set(jg)
    _assert_outputs(tg, jg, AMP)


# ---------------------------------------------------------------------------
# the port's gradients against central differences (float64)
# ---------------------------------------------------------------------------
def _f64(ins):
    return {s: [np.asarray(v, np.float64)
                if np.asarray(v).dtype == np.float32 else np.asarray(v)
                for v in vs] for s, vs in ins.items()}


def _objective(op_type, ins, attrs, cots):
    outs = _run_port(op_type, ins, attrs)
    return sum(float(np.sum(_np(o) * c))
               for s, cs in cots.items() for o, c in zip(outs[s], cs))


@pytest.mark.parametrize("case", GRAD_CASES)
def test_grad_matches_central_differences_in_float64(case):
    op_type, ins, attrs, slots = CASES[case]
    ins = _f64(ins)
    outs = _run_port(op_type, ins, attrs)
    rs = np.random.RandomState(len(case) + 100)
    cots = {s: [rs.randn(*o.shape) for o in outs[s]] for s in slots}
    gins = dict(ins, **{f"{s}@GRAD": cs for s, cs in cots.items()})
    grads = _filled(_run_port(op_type + "_grad", gins, attrs))
    assert grads
    for gslot, gvals in grads.items():
        slot = gslot[: -len("@GRAD")]
        for i, g in enumerate(gvals):
            if g is None:
                continue
            x = ins[slot][i]
            num = np.zeros(x.shape)
            for k in np.ndindex(x.shape):
                vals = []
                for h in (FD_STEP, -FD_STEP):
                    xp = x.copy()
                    xp[k] += h
                    moved = dict(ins, **{slot: ins[slot][:i] + [xp]
                                         + ins[slot][i + 1:]})
                    vals.append(_objective(op_type, moved, attrs, cots))
                num[k] = (vals[0] - vals[1]) / (2 * FD_STEP)
            np.testing.assert_allclose(_np(g), num, err_msg=gslot, **FD)


# ---------------------------------------------------------------------------
# the properties the issue of each op names
# ---------------------------------------------------------------------------
def test_scatter_takes_the_last_update_of_a_repeated_id():
    x = np.zeros((4, 2), np.float32)
    ids = np.array([2, 0, 2, 2, -1, 9])
    upd = np.arange(12, dtype=np.float32).reshape(6, 2) + 1
    got = _np(_run_port("scatter", {"X": [x], "Ids": [ids],
                                    "Updates": [upd]}, {})["Out"][0])
    want = _run_jax("scatter", {"X": [x], "Ids": [ids], "Updates": [upd]},
                    {})["Out"][0]
    np.testing.assert_array_equal(got, want)
    # the 4th update names row 2 last; -1 is row 3; 9 is out of range
    np.testing.assert_array_equal(got, [[3, 4], [0, 0], [7, 8], [9, 10]])


def test_argsort_is_stable_and_arg_max_takes_the_first():
    x = np.array([2.0, 1.0, 2.0, 1.0, 0.0, 2.0], np.float32)
    idx = _np(_run_port("argsort", {"X": [x]}, {})["Indices"][0])
    np.testing.assert_array_equal(idx, [4, 1, 3, 0, 2, 5])
    am = _run_port("arg_max", {"X": [x]}, {})["Out"][0]
    assert tuple(am.shape) == (1,) and am.dtype == torch.int64
    assert int(am[0]) == 0


def test_gather_out_of_range_is_nan_as_in_the_jax_package():
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    ins = {"X": [x], "Index": [np.array([-1, 3, 0])]}
    got = _np(_run_port("gather", ins, {})["Out"][0])
    np.testing.assert_array_equal(got, _run_jax("gather", ins, {})["Out"][0])


def test_host_made_values_are_held_constants():
    """`shape` and `assign_value` copy their values from the host once, at
    the step's first (eager) run, and hand out copies: a captured replay
    then copies on the device."""
    rng = tcore.RandomStream("cpu", 0)
    ctx = tcore.OpContext(tfluid.CPUPlace(), rng)
    attrs = {"shape": [2], "dtype": "float32", "values": [1.0, 2.0]}
    a = treg.lookup("assign_value").fn(ctx, {}, attrs)["Out"][0]
    a.zero_()
    b = treg.lookup("assign_value").fn(ctx, {}, attrs)["Out"][0]
    np.testing.assert_array_equal(b.numpy(), [1.0, 2.0])
    s = treg.lookup("shape").fn(ctx, {"X": [torch.zeros(3, 5)]}, {})
    np.testing.assert_array_equal(s["Out"][0].numpy(), [3, 5])
    assert len(rng._held) == 2


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_op_on_the_card_matches_the_cpu(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    op_type, ins, attrs, slots = CASES[case]
    cpu = _run_port(op_type, ins, attrs)
    card = _run_port(op_type, ins, attrs, device="cuda")
    _assert_outputs(card, {s: [None if v is None else _np(v) for v in vs]
                           for s, vs in cpu.items()}, F32)
    if not slots:
        return
    gins = dict(ins, **_cotangents({s: [_np(v) for v in vs]
                                    for s, vs in cpu.items()}, slots, 1))
    gcpu = _filled(_run_port(op_type + "_grad", gins, attrs))
    gcard = _filled(_run_port(op_type + "_grad", gins, attrs,
                              device="cuda"))
    _assert_outputs(gcard, {s: [None if v is None else _np(v) for v in vs]
                            for s, vs in gcpu.items()}, F32)
