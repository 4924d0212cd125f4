"""The port's structured losses and metrics (ops/loss_ops.py: warpctc,
ctc_align, linear_chain_crf, crf_decoding, nce with its explicit nce_grad,
hierarchical_sigmoid; ops/metric_ops.py: auc, precision_recall,
edit_distance, chunk_eval) against the JAX package's kernels, op by op.

The same numpy inputs (np.random.RandomState) go through the JAX kernel
and the port's on the CPU. A ragged input is a SeqTensor in each package
(flat data and int32 lengths; some with bucket-padding rows after the
real ones). Gradients come from each side's `<op>_grad` kernel (jax.vjp
there, torch.autograd here; nce_grad is explicit on both sides and is
given the forward's SampleLabels) with the same random cotangents.
Bounds:
  * fp32: outputs and gradients within rtol 1e-4 (atol 1e-5 near 0);
    integer outputs equal (the port's int64 for the JAX package's int32);
    the decoded tags, ctc_align, edit_distance and chunk_eval exactly;
  * under bf16 AMP (both packages' auto_cast, float inputs in bf16): the
    same output dtypes, values within rtol 2e-2 (atol 2e-2 near 0);
  * the port's gradient against central differences in float64 (step
    1e-6): rtol 1e-6, atol 1e-8.
nce's random negatives are held through `custom_neg_classes`; its draw
from the program's stream is held by its law (in range, fresh at every
step, the same from the same generator seed) and by nce_grad replaying
the drawn SampleLabels. The tests marked `cuda` hold each op on the card
to its run on the CPU and skip without a card.

tests/test_torch_nn_rest.py runs the rest of the nn ops through the same
harness (`check_case`, `amp_case`, `fd_case`, `card_case`).
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


class Seq:
    """A ragged test input: numpy data [N, ...] and lengths [B]."""

    def __init__(self, data, lengths):
        self.data = data
        self.lengths = np.asarray(lengths, np.int32)


def seq(rs, lengths, *feature, pad=0, ids=None, lo=None):
    """A Seq of random f32 rows (ints in [lo or 0, ids) with `ids`) for
    `lengths`, with `pad` padding rows after the real ones."""
    n = int(np.sum(lengths)) + pad
    if ids is not None:
        data = rs.randint(lo or 0, ids, (n,) + feature).astype(np.int64)
    else:
        data = rs.randn(n, *feature).astype(np.float32)
    return Seq(data, lengths)


def r32(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# running either package's kernel
# ---------------------------------------------------------------------------
def _map(v, fn):
    return Seq(fn(v.data), v.lengths) if isinstance(v, Seq) else fn(v)


def _jnp(a):
    return jnp.asarray(a)


def _torch(a, device="cpu"):
    """numpy -> torch; a bf16 (ml_dtypes) array goes through f32, exactly."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(a.copy()).to(device)


def _to_jax(v):
    if isinstance(v, Seq):
        return jreg.SeqTensor(_jnp(v.data), _jnp(v.lengths))
    return None if v is None else _jnp(v)


def _to_port(v, device="cpu"):
    if isinstance(v, Seq):
        return treg.SeqTensor(_torch(v.data, device),
                              _torch(v.lengths, device))
    return None if v is None else _torch(v, device)


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return np.asarray(t)


def _dtype_of(v):
    if isinstance(v, torch.Tensor):
        return str(v.dtype).replace("torch.", "")
    return str(np.asarray(v).dtype)


class Out:
    """One output: numpy data, lengths (or None) and its dtype's name."""

    def __init__(self, v):
        seqv = isinstance(v, (jreg.SeqTensor, treg.SeqTensor))
        d = v.data if seqv else v
        self.dtype = _dtype_of(d)
        self.data = _np(d)
        self.lengths = _np(v.lengths) if seqv else None


def run_jax(op_type, ins, attrs, ctx=None):
    outs = jreg.run_kernel(jreg.lookup(op_type), ctx or jcore.OpContext(),
                           {s: [_to_jax(v) for v in vs]
                            for s, vs in ins.items()}, dict(attrs))
    return {s: [None if v is None else Out(v) for v in vs]
            for s, vs in outs.items()}


def run_port(op_type, ins, attrs, device="cpu", ctx=None):
    place = tfluid.CPUPlace() if device == "cpu" else tfluid.CUDAPlace(0)
    outs = treg.run_kernel(treg.lookup(op_type),
                           ctx or tcore.OpContext(place),
                           {s: [_to_port(v, device) for v in vs]
                            for s, vs in ins.items()}, dict(attrs))
    return {s: [None if v is None else Out(v) for v in vs]
            for s, vs in outs.items()}


def _same_dtype(port, jax_):
    """The port's int64 stands for the JAX package's int32."""
    return port == jax_ or (port == "int64" and jax_ == "int32")


def assert_outputs(got, want, tol, exact=()):
    """Every output of `want` in `got`: lengths equal, shapes equal,
    dtypes equal (but int64 for int32), integers equal, the slots in
    `exact` equal, floats within `tol`."""
    for slot, vals in want.items():
        assert len(got.get(slot, [])) == len(vals), slot
        for w, g in zip(vals, got[slot]):
            if w is None:
                continue
            if w.lengths is not None:
                assert g.lengths is not None, f"{slot}: lost the lengths"
                np.testing.assert_array_equal(g.lengths, w.lengths,
                                              err_msg=slot)
            assert g.data.shape == w.data.shape, (slot, g.data.shape,
                                                  w.data.shape)
            assert _same_dtype(g.dtype, w.dtype), (slot, g.dtype, w.dtype)
            if g.data.dtype.kind in "biu" or slot in exact:
                np.testing.assert_array_equal(g.data, w.data, err_msg=slot)
            else:
                np.testing.assert_allclose(g.data, w.data.astype(np.float32),
                                           err_msg=slot, **tol)


def _cotangents(outs, slots, seed):
    rs = np.random.RandomState(seed)
    return {f"{s}@GRAD": [
        Seq(rs.randn(*o.data.shape).astype(np.float32), o.lengths)
        if o.lengths is not None
        else rs.randn(*o.data.shape).astype(np.float32) for o in outs[s]]
        for s in slots}


def _filled(outs):
    return {s: vs for s, vs in outs.items()
            if any(v is not None for v in vs)}


class Case:
    """An op's test case: its type, inputs, attrs, the output slots a
    gradient flows from, the outputs compared exactly, and `grad_extra`,
    the forward outputs an explicit grad op takes ({grad slot: forward
    output slot})."""

    def __init__(self, op_type, ins, attrs=None, grad=(), exact=(),
                 grad_extra=None, jax_amp_grad=True):
        self.op_type, self.ins, self.attrs = op_type, ins, attrs or {}
        self.grad, self.exact = list(grad), tuple(exact)
        self.grad_extra = grad_extra or {}
        self.jax_amp_grad = jax_amp_grad

    def grad_ins(self, ins, fwd, cot):
        """The grad op's inputs: the forward's, the cotangents and the
        forward outputs it replays (each as numpy)."""
        extra = {s: [o.data for o in fwd[src]]
                 for s, src in self.grad_extra.items()}
        return dict(ins, **cot, **extra)

    def is_float(self):
        return any(np.asarray(v.data if isinstance(v, Seq) else v).dtype
                   == np.float32 for vs in self.ins.values() for v in vs)


def check_case(case, seed):
    """fp32 parity with the JAX kernel, forward and grad."""
    want = run_jax(case.op_type, case.ins, case.attrs)
    assert_outputs(run_port(case.op_type, case.ins, case.attrs), want, F32,
                   case.exact)
    if not case.grad:
        return
    gins = case.grad_ins(case.ins, want, _cotangents(want, case.grad, seed))
    jg = _filled(run_jax(case.op_type + "_grad", gins, case.attrs))
    tg = _filled(run_port(case.op_type + "_grad", gins, case.attrs))
    assert set(tg) == set(jg)
    assert_outputs(tg, jg, F32)


def _bf16(ins):
    def cast(a):
        a = np.asarray(a)
        return a.astype(jnp.bfloat16) if a.dtype == np.float32 else a

    return {s: [_map(v, cast) for v in vs] for s, vs in ins.items()}


def amp_case(case, seed):
    """Under both packages' auto_cast, from bf16 inputs: the same output
    dtypes, values within AMP, and the same for the grads. Where the JAX
    package's grad kernel cannot run under AMP (`jax_amp_grad` False), the
    port's grads are held to the JAX package's f32 grads of the same
    bf16-valued inputs."""
    ins = _bf16(case.ins)
    with tamp.auto_cast(), jamp.auto_cast():
        want = run_jax(case.op_type, ins, case.attrs)
        assert_outputs(run_port(case.op_type, ins, case.attrs), want, AMP,
                       case.exact)
        if not case.grad:
            return
        gins = case.grad_ins(ins, want, _cotangents(want, case.grad, seed))
        tg = _filled(run_port(case.op_type + "_grad", gins, case.attrs))
        if case.jax_amp_grad:
            jg = _filled(run_jax(case.op_type + "_grad", gins, case.attrs))
    if not case.jax_amp_grad:
        jg = _filled(run_jax(case.op_type + "_grad", _f32(gins),
                             case.attrs))
        tg = {s: [None if v is None else _widened(v) for v in vs]
              for s, vs in tg.items()}
    assert set(tg) == set(jg)
    assert_outputs(tg, jg, AMP)


def _f32(ins):
    def cast(a):
        a = np.asarray(a)
        return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a

    return {s: [_map(v, cast) for v in vs] for s, vs in ins.items()}


def _widened(o):
    """A bf16 output as the f32 one it is compared with."""
    if o.dtype == "bfloat16":
        o.dtype = "float32"
    return o


def _f64(ins):
    def cast(a):
        a = np.asarray(a)
        return a.astype(np.float64) if a.dtype == np.float32 else a

    return {s: [_map(v, cast) for v in vs] for s, vs in ins.items()}


def _objective(case, ins, cots):
    outs = run_port(case.op_type, ins, case.attrs)
    return sum(float(np.sum(o.data * _np_data(c)))
               for s, cs in cots.items() for o, c in zip(outs[s], cs))


def _np_data(c):
    return c.data if isinstance(c, Seq) else c


def fd_case(case, seed):
    """The port's grad kernel against float64 central differences of its
    forward, input element by input element."""
    ins = _f64(case.ins)
    outs = run_port(case.op_type, ins, case.attrs)
    rs = np.random.RandomState(seed + 100)
    cots = {s: [Seq(rs.randn(*o.data.shape), o.lengths)
                if o.lengths is not None else rs.randn(*o.data.shape)
                for o in outs[s]] for s in case.grad}
    gins = case.grad_ins(ins, outs, {f"{s}@GRAD": cs
                                     for s, cs in cots.items()})
    grads = _filled(run_port(case.op_type + "_grad", gins, case.attrs))
    assert grads
    for gslot, gvals in grads.items():
        slot = gslot[: -len("@GRAD")]
        for i, g in enumerate(gvals):
            if g is None:
                continue
            v = ins[slot][i]
            x = _np_data(v)
            num = np.zeros(x.shape)
            for k in np.ndindex(x.shape):
                vals = []
                for h in (FD_STEP, -FD_STEP):
                    xp = x.copy()
                    xp[k] += h
                    moved = Seq(xp, v.lengths) if isinstance(v, Seq) else xp
                    ins_k = dict(ins, **{slot: ins[slot][:i] + [moved]
                                         + ins[slot][i + 1:]})
                    vals.append(_objective(case, ins_k, cots))
                num[k] = (vals[0] - vals[1]) / (2 * FD_STEP)
            np.testing.assert_allclose(g.data, num, err_msg=gslot, **FD)


def card_case(case, seed):
    """The op on the card against its run on the CPU (fp32 bounds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cpu = run_port(case.op_type, case.ins, case.attrs)
    card = run_port(case.op_type, case.ins, case.attrs, device="cuda")
    assert_outputs(card, cpu, F32, case.exact)
    if not case.grad:
        return
    gins = case.grad_ins(case.ins, cpu, _cotangents(cpu, case.grad, seed))
    gcpu = _filled(run_port(case.op_type + "_grad", gins, case.attrs))
    gcard = _filled(run_port(case.op_type + "_grad", gins, case.attrs,
                             device="cuda"))
    assert_outputs(gcard, gcpu, F32)


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------
C_CRF = 5


def _cases():
    rs = np.random.RandomState(13)
    c = {}
    lens = [3, 1, 4, 2]
    for pad in (0, 3):
        tag = "" if not pad else "_bucket_padded"
        em = seq(rs, lens, C_CRF, pad=pad)
        lab = Seq(rs.randint(0, C_CRF, (em.data.shape[0], 1)).astype(
            np.int64), lens)
        trans = r32(rs, C_CRF + 2, C_CRF, scale=0.5)
        c["linear_chain_crf" + tag] = Case(
            "linear_chain_crf", {"Emission": [em], "Transition": [trans],
                                 "Label": [lab]}, grad=["LogLikelihood"])
        c["crf_decoding" + tag] = Case(
            "crf_decoding", {"Emission": [em], "Transition": [trans]},
            exact=["ViterbiPath"])
        c["crf_decoding_with_label" + tag] = Case(
            "crf_decoding", {"Emission": [em], "Transition": [trans],
                             "Label": [lab]}, exact=["ViterbiPath"])
    # CTC: 6 classes, blank 0 (and blank 5); a repeated label in sequence 0
    tlens, llens = [5, 3, 6], [2, 1, 3]
    logits = seq(rs, tlens, 6)
    labels = Seq(np.array([[2], [2], [4], [1], [3], [1]], np.int64), llens)
    for norm in (False, True):
        c[f"warpctc_norm_{norm}"] = Case(
            "warpctc", {"Logits": [logits], "Label": [labels]},
            {"blank": 0, "norm_by_times": norm}, grad=["Loss"])
    c["warpctc_blank_5_padded"] = Case(
        "warpctc", {"Logits": [seq(rs, tlens, 6, pad=2)],
                    "Label": [Seq(np.array([[2], [2], [4], [1], [3], [1],
                                            [0]], np.int64), llens)]},
        {"blank": 5}, grad=["Loss"])
    tokens = Seq(np.array([[0], [1], [1], [0], [2], [2], [3], [3], [0], [3],
                           [1], [1], [0], [4]], np.int64), [5, 1, 4, 2])
    for merge in (True, False):
        c[f"ctc_align_merge_{merge}"] = Case(
            "ctc_align", {"Input": [tokens]},
            {"blank": 0, "merge_repeated": merge}, exact=["Output"])
    c["ctc_align_blank_3"] = Case(
        "ctc_align", {"Input": [Seq(tokens.data, [6, 5])]}, {"blank": 3},
        exact=["Output"])
    # NCE: 12 classes, 4 fixed negatives a row, 1 or 2 true classes
    B, D, C = 5, 4, 12
    for tt in (1, 2):
        c[f"nce_true_{tt}"] = Case(
            "nce", {"Input": [r32(rs, B, D)],
                    "Label": [rs.randint(0, C, (B, tt)).astype(np.int64)],
                    "Weight": [r32(rs, C, D, scale=0.5)],
                    "Bias": [r32(rs, C, 1, scale=0.1)]},
            {"num_total_classes": C, "num_neg_samples": 4,
             "custom_neg_classes": [0, 3, 7, 11]}, grad=["Cost"],
            grad_extra={"SampleLabels": "SampleLabels"},
            # the JAX package's nce_grad hands jax.vjp a bf16 cotangent
            # for its f32 cost under AMP, which jax refuses
            jax_amp_grad=False)
    for nc in (6, 8):
        c[f"hierarchical_sigmoid_{nc}"] = Case(
            "hierarchical_sigmoid",
            {"X": [r32(rs, 7, 3)], "W": [r32(rs, nc - 1, 3)],
             "Label": [rs.randint(0, nc, (7, 1)).astype(np.int64)],
             "Bias": [r32(rs, nc - 1, 1)]}, {"num_classes": nc},
            grad=["Out"])
    # metrics
    nt = 20
    prob = rs.rand(9).astype(np.float32)
    c["auc"] = Case("auc", {
        "Predict": [np.stack([1 - prob, prob], 1)],
        "Label": [rs.randint(0, 2, (9, 1)).astype(np.int64)],
        "StatPos": [rs.randint(0, 3, nt + 1).astype(np.float32)],
        "StatNeg": [rs.randint(0, 3, nt + 1).astype(np.float32)]},
        {"num_thresholds": nt, "curve": "ROC"})
    c["precision_recall"] = Case("precision_recall", {
        "MaxProbs": [rs.rand(8, 1).astype(np.float32)],
        "Indices": [rs.randint(0, 4, (8, 1)).astype(np.int64)],
        "Labels": [rs.randint(0, 4, (8, 1)).astype(np.int64)],
        "Weights": [rs.rand(8, 1).astype(np.float32)],
        "StatesInfo": [rs.randint(0, 5, (4, 4)).astype(np.float32)]},
        {"class_number": 4})
    c["precision_recall_unweighted"] = Case("precision_recall", {
        "MaxProbs": [rs.rand(8, 1).astype(np.float32)],
        "Indices": [rs.randint(0, 3, (8, 1)).astype(np.int64)],
        "Labels": [rs.randint(0, 3, (8, 1)).astype(np.int64)]},
        {"class_number": 3})
    hyps = seq(rs, [4, 0, 3, 5], 1, ids=4, pad=2)
    refs = seq(rs, [3, 2, 3, 1], 1, ids=4)
    for norm in (True, False):
        c[f"edit_distance_norm_{norm}"] = Case(
            "edit_distance", {"Hyps": [hyps], "Refs": [refs]},
            {"normalized": norm}, exact=["Out"])
    c["edit_distance_dense"] = Case(
        "edit_distance", {"Hyps": [rs.randint(0, 3, (3, 5))],
                          "Refs": [rs.randint(0, 3, (3, 4))]},
        {"normalized": False}, exact=["Out"])
    inf = seq(rs, [6, 4, 7], 1, ids=7)
    lab = Seq(np.where(rs.rand(17, 1) < 0.7, inf.data,
                       rs.randint(0, 7, (17, 1))), inf.lengths)
    c["chunk_eval"] = Case(
        "chunk_eval", {"Inference": [inf], "Label": [lab]},
        {"num_chunk_types": 3, "chunk_scheme": "IOB"},
        exact=["Precision", "Recall", "F1_Score"])
    c["chunk_eval_excluded"] = Case(
        "chunk_eval", {"Inference": [inf], "Label": [lab]},
        {"num_chunk_types": 3, "chunk_scheme": "IOB",
         "excluded_chunk_types": [1]},
        exact=["Precision", "Recall", "F1_Score"])
    return c


CASES = _cases()
GRAD_CASES = sorted(k for k, v in CASES.items() if v.grad)
FLOAT_CASES = sorted(k for k, v in CASES.items() if v.is_float())
TYPES = {"warpctc", "ctc_align", "linear_chain_crf", "crf_decoding", "nce",
         "hierarchical_sigmoid", "auc", "precision_recall", "edit_distance",
         "chunk_eval"}


def test_every_type_of_the_two_modules_has_a_case():
    """loss_ops' six forward types (nce_grad through nce's cases) and the
    four metrics beside accuracy."""
    assert {v.op_type for v in CASES.values()} == TYPES
    for t in TYPES | {"nce_grad"}:
        assert treg.get_op_def(t) is not None, t


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_grad_match_the_jax_op(case):
    check_case(CASES[case], len(case))


@pytest.mark.parametrize("case", FLOAT_CASES)
def test_amp_dtype_flow_and_values_match_the_jax_op(case):
    amp_case(CASES[case], len(case))


@pytest.mark.parametrize("case", GRAD_CASES)
def test_grad_matches_central_differences_in_float64(case):
    fd_case(CASES[case], len(case))


# ---------------------------------------------------------------------------
# the properties each op's contract names
# ---------------------------------------------------------------------------
def test_warpctc_grad_output_is_the_loss_gradient():
    """WarpCTCGrad (made in the forward) equals the derived grad of Loss
    for a cotangent of ones, and the JAX package's WarpCTCGrad."""
    case = CASES["warpctc_norm_False"]
    fwd = run_port("warpctc", case.ins, case.attrs)
    ones = {"Loss@GRAD": [np.ones(fwd["Loss"][0].data.shape, np.float32)]}
    g = run_port("warpctc_grad", dict(case.ins, **ones), case.attrs)
    np.testing.assert_allclose(g["Logits@GRAD"][0].data,
                               fwd["WarpCTCGrad"][0].data, rtol=1e-6,
                               atol=1e-7)
    want = run_jax("warpctc", case.ins, case.attrs)
    assert_outputs(fwd, want, F32)


def test_warpctc_loss_is_torch_ctc_loss():
    """The loop's loss is the CTC loss torch computes with its own
    conventions (log-probabilities, [T, B, C]), though the port does not
    call it."""
    case = CASES["warpctc_norm_False"]
    got = run_port("warpctc", case.ins, case.attrs)["Loss"][0].data[:, 0]
    lg, lb = case.ins["Logits"][0], case.ins["Label"][0]
    offs, loffs = np.cumsum([0] + list(lg.lengths)), np.cumsum(
        [0] + list(lb.lengths))
    want = [float(torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.from_numpy(lg.data[offs[b]:offs[b + 1]]),
                          -1)[:, None],
        torch.from_numpy(lb.data[loffs[b]:loffs[b + 1], 0])[None],
        [int(lg.lengths[b])], [int(lb.lengths[b])], reduction="sum"))
        for b in range(len(lg.lengths))]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_crf_decoding_is_the_best_path_by_brute_force():
    """On the short sequences, the decoded tags score at least as much as
    every other tag path (start + emissions + transitions + stop)."""
    import itertools

    case = CASES["crf_decoding"]
    em, trans = case.ins["Emission"][0], case.ins["Transition"][0]
    path = run_port("crf_decoding", case.ins, {})["ViterbiPath"][0].data
    offs = np.cumsum([0] + list(em.lengths))

    def score(e, tags):
        s = trans[0, tags[0]] + trans[1, tags[-1]] + sum(
            e[t, tags[t]] for t in range(len(tags)))
        return s + sum(trans[2 + tags[t - 1], tags[t]]
                       for t in range(1, len(tags)))

    for b in range(len(em.lengths)):
        e = em.data[offs[b]:offs[b + 1]]
        got = path[offs[b]:offs[b + 1], 0]
        best = max(score(e, p) for p in itertools.product(
            range(C_CRF), repeat=len(e)))
        assert score(e, got) >= best - 1e-5


def test_crf_nll_is_the_log_partition_minus_the_gold_score():
    import itertools

    case = CASES["linear_chain_crf"]
    em, trans = case.ins["Emission"][0], case.ins["Transition"][0]
    lab = case.ins["Label"][0].data[:, 0]
    nll = run_port("linear_chain_crf", case.ins, {})["LogLikelihood"][0].data
    offs = np.cumsum([0] + list(em.lengths))

    def score(e, tags):
        s = trans[0, tags[0]] + trans[1, tags[-1]] + sum(
            e[t, tags[t]] for t in range(len(tags)))
        return s + sum(trans[2 + tags[t - 1], tags[t]]
                       for t in range(1, len(tags)))

    for b in range(len(em.lengths)):
        e = em.data[offs[b]:offs[b + 1]].astype(np.float64)
        all_ = [score(e, p) for p in itertools.product(range(C_CRF),
                                                       repeat=len(e))]
        log_z = np.log(np.sum(np.exp(all_)))
        gold = score(e, lab[offs[b]:offs[b + 1]])
        np.testing.assert_allclose(nll[b, 0], log_z - gold, rtol=1e-5)


def _drawn_nce(seed, steps=2):
    """nce with drawn negatives from a RandomStream seeded `seed`: each
    step's (Cost, SampleLabels)."""
    rs = np.random.RandomState(4)
    ins = {"Input": [r32(rs, 6, 4)], "Label": [rs.randint(0, 30, (6, 1))],
           "Weight": [r32(rs, 30, 4)], "Bias": [r32(rs, 30, 1)]}
    attrs = {"num_total_classes": 30, "num_neg_samples": 5}
    ctx = tcore.OpContext(tfluid.CPUPlace(), tcore.RandomStream("cpu", seed))
    return ins, attrs, [run_port("nce", ins, attrs, ctx=ctx)
                        for _ in range(steps)]


def test_nce_draws_in_range_fresh_each_step_and_replays_in_its_grad():
    ins, attrs, (a, b) = _drawn_nce(7)
    sa, sb = a["SampleLabels"][0].data, b["SampleLabels"][0].data
    assert sa.shape == (6, 6) and sa.dtype == np.int64
    np.testing.assert_array_equal(sa[:, 0], ins["Label"][0][:, 0])
    assert sa.min() >= 0 and sa.max() < 30
    assert not np.array_equal(sa[:, 1:], sb[:, 1:])
    _, _, (a2, b2) = _drawn_nce(7)
    np.testing.assert_array_equal(a2["SampleLabels"][0].data, sa)
    np.testing.assert_array_equal(b2["Cost"][0].data, b["Cost"][0].data)
    # nce_grad with the drawn SampleLabels is the grad of the cost at them:
    # the same as a forward whose custom negatives are those samples
    # (one row's draw given to every row: rows are independent)
    row = [int(v) for v in sa[0, 1:]]
    one = {s: [v[0][:1]] for s, v in ins.items() if s in ("Input", "Label")}
    fixed = dict(ins, **one)
    custom = dict(attrs, custom_neg_classes=row)
    cot = {"Cost@GRAD": [np.ones((1, 1), np.float32)]}
    g_drawn = run_port("nce_grad", dict(fixed, **cot, SampleLabels=[
        sa[:1]]), attrs)
    g_fixed = run_port("nce_grad", dict(fixed, **cot, SampleLabels=[
        run_port("nce", fixed, custom)["SampleLabels"][0].data]), custom)
    for slot in ("Input@GRAD", "Weight@GRAD", "Bias@GRAD"):
        np.testing.assert_array_equal(g_drawn[slot][0].data,
                                      g_fixed[slot][0].data)


def test_auc_matches_the_exact_area_on_a_fine_histogram():
    """With many buckets and no stats, the streamed AUC is the exact
    ROC area of the scores (no ties)."""
    rs = np.random.RandomState(5)
    prob = rs.permutation(50).astype(np.float32) / 50 + 0.005
    label = (rs.rand(50) < prob).astype(np.int64)
    nt = 1000
    got = run_port("auc", {"Predict": [prob[:, None]], "Label": [label],
                           "StatPos": [np.zeros(nt + 1, np.float32)],
                           "StatNeg": [np.zeros(nt + 1, np.float32)]},
                   {"num_thresholds": nt})["AUC"][0].data
    pos, neg = prob[label == 1], prob[label == 0]
    exact = np.mean(pos[:, None] > neg[None, :])
    np.testing.assert_allclose(got, exact, rtol=1e-5)


def test_edit_distance_matches_a_plain_dynamic_program():
    case = CASES["edit_distance_norm_False"]
    h, r = case.ins["Hyps"][0], case.ins["Refs"][0]
    got = run_port("edit_distance", case.ins, case.attrs)["Out"][0].data
    ho, ro = np.cumsum([0] + list(h.lengths)), np.cumsum([0] + list(r.lengths))
    for b in range(len(h.lengths)):
        a, c = h.data[ho[b]:ho[b + 1], 0], r.data[ro[b]:ro[b + 1], 0]
        d = np.arange(len(c) + 1)
        for i in range(len(a)):
            row = [i + 1]
            for j in range(len(c)):
                row.append(min(row[j] + 1, d[j + 1] + 1,
                               d[j] + (a[i] != c[j])))
            d = np.array(row)
        assert got[b, 0] == d[-1]


def test_chunk_eval_keeps_a_program_out_of_the_graph():
    """chunk_eval reads its inputs on the host: the rule that keeps a step
    out of a CUDA graph names it, and dead-code elimination may drop it."""
    op = type("Op", (), {"type": "chunk_eval", "attrs": {}})()
    assert tcore.capture_blocker([op]) is op
    assert "chunk_eval" in tcore.HOST_SYNC_OPS
    assert "chunk_eval" not in tcore.HOST_OPS


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_op_on_the_card_matches_the_cpu(case):
    card_case(CASES[case], len(case))
