"""Compile-time per-op shape contracts (r2 VERDICT missing #5).

Reference parity: every reference op declares an InferShape checked when the
OpDesc is built (framework/shape_inference.h:1, op_desc.cc InferShape call),
so a malformed program fails at append_op with op context — not deep inside
a jax trace. Same contract here: `infer(op, block)` runs from
Block.append_op for every op type with a registered contract.

Conventions:
- a Variable's shape may be None (unknown) — contracts skip checks that
  need it rather than failing;
- -1 is the dynamic (batch) dim and matches anything;
- contracts VALIDATE input consistency and SET output var shapes.
  Concrete dims are authoritative (they overwrite layer-side ad-hoc shape
  math so the two cannot drift); a -1 emitted by a contract means
  "unknown to the contract" and PRESERVES an existing more-specific
  layer-side dim (see set_output_dim) — otherwise a -1 written into a
  parameter's input chain propagates into weight shapes.

Kept free of jax imports so framework.py can use it without pulling the
backend in at program-build time.
"""

import math

_contracts = {}


class ShapeError(ValueError):
    pass


def register_infer_shape(*types):
    def deco(fn):
        for t in types:
            _contracts[t] = fn
        return fn
    return deco


def has_contract(type):
    return type in _contracts


class InferShapeContext:
    """Mirrors the reference InferShapeContext surface
    (shape_inference.h:28-60): typed access to input dims + output dim
    setting, by slot name."""

    def __init__(self, op, block):
        self.op = op
        self.block = block

    # -- vars -----------------------------------------------------------
    def _var(self, name):
        b = self.block
        while b is not None:
            v = b.vars.get(name)
            if v is not None:
                return v
            b = b.parent_block
        return None

    def has_input(self, slot):
        return bool(self.op.inputs.get(slot))

    def has_output(self, slot):
        return bool(self.op.outputs.get(slot))

    def input_dim(self, slot, i=0):
        names = self.op.inputs.get(slot) or []
        if i >= len(names):
            return None
        v = self._var(names[i])
        return tuple(v.shape) if v is not None and v.shape is not None \
            else None

    def input_dims(self, slot):
        return [self.input_dim(slot, i)
                for i in range(len(self.op.inputs.get(slot) or []))]

    def set_output_dim(self, slot, dim, i=0):
        names = self.op.outputs.get(slot) or []
        if i >= len(names):
            return
        v = self._var(names[i])
        if v is None or dim is None:
            return
        # None (unknown, e.g. a memory var's lazy batch) maps to the
        # dynamic dim like -1 does
        new = [-1 if d is None else int(d) for d in dim]
        # -1 means "unknown to this contract": keep the layer's existing
        # more-specific dim rather than clobbering it (a -1 written into a
        # parameter's input chain otherwise propagates into weight shapes)
        old = v.shape
        if old is not None and len(old) == len(new):
            new = [o if n == -1 and o is not None else n
                   for n, o in zip(new, old)]
        v.shape = tuple(new)

    def attr(self, name, default=None):
        return self.op.attrs.get(name, default)

    def enforce(self, cond, msg):
        if not cond:
            raise ShapeError(msg)


def infer(op, block):
    """Run the contract for op.type, if any, with op context on failure."""
    fn = _contracts.get(op.type)
    if fn is None:
        return
    ctx = InferShapeContext(op, block)
    try:
        fn(ctx)
    except ShapeError as e:
        raise ShapeError(
            f"InferShape failed for op '{op.type}' "
            f"(inputs={dict(op.inputs)}, attrs="
            f"{ {k: v for k, v in op.attrs.items() if not k.startswith('op_')} }): {e}"
        ) from None


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _dim_match(a, b):
    return a == b or a == -1 or b == -1


def _shapes_match(a, b):
    return len(a) == len(b) and all(_dim_match(x, y) for x, y in zip(a, b))


def _numel(shape):
    n = 1
    for d in shape:
        if d == -1:
            return None
        n *= d
    return n


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def _conv_out(in_size, k, pad, stride, dilation):
    if in_size in (-1, None):
        return -1
    return (in_size + 2 * pad - (dilation * (k - 1) + 1)) // stride + 1


def _pool_out(in_size, k, pad, stride, ceil_mode):
    if in_size in (-1, None):
        return -1
    num = in_size - k + 2 * pad
    return (math.ceil(num / stride) if ceil_mode else num // stride) + 1


# ---------------------------------------------------------------------------
# contracts — the high-traffic families (conv/pool/matmul/elementwise/
# reductions/reshape and friends)
# ---------------------------------------------------------------------------
@register_infer_shape("conv2d", "depthwise_conv2d")
def _conv2d(ctx):
    x = ctx.input_dim("Input")
    w = ctx.input_dim("Filter")
    if x is None or w is None:
        return
    nhwc = ctx.attr("data_format", "NCHW") == "NHWC"
    c_ax, h_ax, w_ax = (3, 1, 2) if nhwc else (1, 2, 3)
    ctx.enforce(len(x) == 4,
                f"Input must be {'NHWC' if nhwc else 'NCHW'} 4-D, got {x}")
    ctx.enforce(len(w) == 4, f"Filter must be [M, C/g, kh, kw], got {w}")
    groups = ctx.attr("groups", 1) or 1
    ctx.enforce(_dim_match(x[c_ax], w[1] * groups),
                f"in_channels {x[c_ax]} != filter_channels {w[1]} * groups "
                f"{groups}")
    ctx.enforce(w[0] % groups == 0,
                f"num_filters {w[0]} not divisible by groups {groups}")
    s = _pair(ctx.attr("strides", [1, 1]))
    p = _pair(ctx.attr("paddings", [0, 0]))
    d = _pair(ctx.attr("dilations", [1, 1]))
    oh = _conv_out(x[h_ax], w[2], p[0], s[0], d[0])
    ow = _conv_out(x[w_ax], w[3], p[1], s[1], d[1])
    ctx.enforce(oh != 0 and ow != 0 and (oh > 0 or oh == -1)
                and (ow > 0 or ow == -1),
                f"empty conv output {oh}x{ow} for input, filter "
                f"{w[2:]}, stride {s}, padding {p}, dilation {d}")
    ctx.set_output_dim(
        "Output",
        (x[0], oh, ow, w[0]) if nhwc else (x[0], w[0], oh, ow))


@register_infer_shape("pool2d")
def _pool2d(ctx):
    x = ctx.input_dim("X")
    if x is None:
        return
    nhwc = ctx.attr("data_format", "NCHW") == "NHWC"
    c_ax, h_ax, w_ax = (3, 1, 2) if nhwc else (1, 2, 3)
    ctx.enforce(len(x) == 4,
                f"X must be {'NHWC' if nhwc else 'NCHW'} 4-D, got {x}")
    if ctx.attr("global_pooling", False):
        ctx.set_output_dim(
            "Out", (x[0], 1, 1, x[c_ax]) if nhwc else (x[0], x[c_ax], 1, 1))
        return
    k = _pair(ctx.attr("ksize", [1, 1]))
    s = _pair(ctx.attr("strides", [1, 1]))
    p = _pair(ctx.attr("paddings", [0, 0]))
    ceil_mode = ctx.attr("ceil_mode", False)
    oh = _pool_out(x[h_ax], k[0], p[0], s[0], ceil_mode)
    ow = _pool_out(x[w_ax], k[1], p[1], s[1], ceil_mode)
    ctx.enforce((oh > 0 or oh == -1) and (ow > 0 or ow == -1),
                f"empty pool output {oh}x{ow}, ksize {k}, "
                f"stride {s}, padding {p}")
    ctx.set_output_dim(
        "Out",
        (x[0], oh, ow, x[c_ax]) if nhwc else (x[0], x[c_ax], oh, ow))


@register_infer_shape("mul")
def _mul(ctx):
    x = ctx.input_dim("X")
    y = ctx.input_dim("Y")
    if x is None or y is None:
        return
    xnc = ctx.attr("x_num_col_dims", 1)
    ync = ctx.attr("y_num_col_dims", 1)
    ctx.enforce(len(x) > xnc, f"X rank {len(x)} <= x_num_col_dims {xnc}")
    # reference mul_op InferShape: Y rank strictly greater than
    # y_num_col_dims, else y[ync:] is empty and Out silently loses cols
    ctx.enforce(len(y) > ync, f"Y rank {len(y)} <= y_num_col_dims {ync}")
    kx = _numel(x[xnc:])
    ky = _numel(y[:ync])
    if kx is not None and ky is not None:
        ctx.enforce(kx == ky,
                    f"flattened inner dims mismatch: X{x} cols {kx} vs "
                    f"Y{y} rows {ky}")
    ctx.set_output_dim("Out", tuple(x[:xnc]) + tuple(y[ync:]))


@register_infer_shape("matmul")
def _matmul(ctx):
    x = ctx.input_dim("X")
    y = ctx.input_dim("Y")
    if x is None or y is None:
        return
    tx, ty = ctx.attr("transpose_X", False), ctx.attr("transpose_Y", False)
    xs, ys = list(x), list(y)
    if len(xs) == 1:
        xs = [1, xs[0]]
    if len(ys) == 1:
        ys = [ys[0], 1]
    if tx:
        xs[-2], xs[-1] = xs[-1], xs[-2]
    if ty:
        ys[-2], ys[-1] = ys[-1], ys[-2]
    ctx.enforce(_dim_match(xs[-1], ys[-2]),
                f"contraction mismatch: X{x} (tx={tx}) K={xs[-1]} vs "
                f"Y{y} (ty={ty}) K={ys[-2]}")
    batch = xs[:-2] if len(xs) >= len(ys) else ys[:-2]
    # mirror the kernel (math_ops.py matmul_op) and reference
    # matmul_op.cc:306-317: the dim inserted to pad a 1-D operand is
    # squeezed back out of Out (-2 slot for X, -1 slot for Y)
    tail = [xs[-2], ys[-1]]
    if len(y) == 1:
        tail.pop(1)
    if len(x) == 1:
        tail.pop(0)
    out = list(batch) + tail
    ctx.set_output_dim("Out", tuple(out) if out else (1,))


@register_infer_shape(
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow")
def _elementwise(ctx):
    x = ctx.input_dim("X")
    y = ctx.input_dim("Y")
    if x is not None and y is not None:
        axis = ctx.attr("axis", -1)
        if axis is None:
            axis = -1
        ctx.enforce(len(y) <= len(x),
                    f"Y rank {len(y)} > X rank {len(x)}")
        # Reference broadcast rule (elementwise_op_function.h): Y is aligned
        # at `axis` (default: trailing); trailing size-1 dims of Y are
        # trimmed before alignment, and any size-1 Y dim broadcasts against
        # the corresponding X dim — a scalar/all-ones Y matches any X.
        # The runtime kernel (util.bcast_y_to_x + numpy broadcasting) accepts
        # exactly this, so the contract must too.
        if len(y) == len(x):
            for i in range(len(x)):
                ctx.enforce(_dim_match(x[i], y[i]) or y[i] == 1,
                            f"same-rank elementwise shape mismatch: X{x} vs "
                            f"Y{y}")
        else:
            # default axis aligns the UNtrimmed Y rank (reference computes
            # axis before trim_trailing_singular_dims)
            a = axis if axis >= 0 else len(x) - len(y)
            yr = len(y)
            while yr > 1 and y[yr - 1] == 1:
                yr -= 1
            ctx.enforce(0 <= a <= len(x) - yr,
                        f"axis {axis} out of range for X{x} vs Y{y}")
            for i in range(yr):
                ctx.enforce(_dim_match(x[a + i], y[i]) or y[i] == 1,
                            f"dim {a + i}: X{x} vs Y{y} (axis={axis})")
    if x is not None:
        ctx.set_output_dim("Out", x)


@register_infer_shape(
    "reduce_sum", "reduce_mean", "reduce_max", "reduce_min", "reduce_prod")
def _reduce(ctx):
    x = ctx.input_dim("X")
    if x is None:
        return
    if ctx.attr("reduce_all", False):
        ctx.set_output_dim("Out", (1,))
        return
    dim = ctx.attr("dim", 0)
    dims = [dim] if isinstance(dim, int) else list(dim)
    for d in dims:
        ctx.enforce(-len(x) <= d < len(x),
                    f"reduce dim {d} out of range for shape {x}")
    dims = [d % len(x) for d in dims]
    keep = ctx.attr("keep_dim", False)
    out = []
    for i, s in enumerate(x):
        if i in dims:
            if keep:
                out.append(1)
        else:
            out.append(s)
    ctx.set_output_dim("Out", tuple(out) if out else (1,))


@register_infer_shape("reshape")
def _reshape(ctx):
    x = ctx.input_dim("X")
    tgt = list(ctx.attr("shape", []))
    ctx.enforce(tgt.count(-1) <= 1, f"more than one -1 in shape {tgt}")
    if x is None:
        return
    out = []
    for i, d in enumerate(tgt):
        if d == 0:
            ctx.enforce(i < len(x),
                        f"shape[{i}]=0 but X rank is only {len(x)}")
            out.append(x[i])
        else:
            out.append(d)
    nx = _numel(x)
    if nx is not None:
        known = _numel([d for d in out if d != -1])
        if -1 in out:
            if known not in (None, 0):
                ctx.enforce(nx % known == 0,
                            f"cannot infer -1: numel {nx} not divisible by "
                            f"{known} (shape {tgt}, X{x})")
                out[out.index(-1)] = nx // known
        elif known is not None:
            ctx.enforce(known == nx,
                        f"reshape numel mismatch: X{x} has {nx}, shape "
                        f"{tgt} wants {known}")
    ctx.set_output_dim("Out", tuple(out))


@register_infer_shape("transpose")
def _transpose(ctx):
    x = ctx.input_dim("X")
    perm = list(ctx.attr("axis", []))
    if x is None:
        return
    ctx.enforce(sorted(perm) == list(range(len(x))),
                f"perm {perm} is not a permutation of rank {len(x)}")
    ctx.set_output_dim("Out", tuple(x[p] for p in perm))


@register_infer_shape("concat")
def _concat(ctx):
    xs = [s for s in ctx.input_dims("X") if s is not None]
    if not xs:
        return
    axis = ctx.attr("axis", 0)
    r = len(xs[0])
    ctx.enforce(-r <= axis < r, f"concat axis {axis} out of range ({r}-D)")
    axis %= r
    total = 0
    for s in xs:
        ctx.enforce(len(s) == r, f"rank mismatch among inputs: {xs}")
        for i in range(r):
            if i != axis:
                ctx.enforce(_dim_match(s[i], xs[0][i]),
                            f"dim {i} mismatch among concat inputs: {xs}")
        total = -1 if (total == -1 or s[axis] == -1) else total + s[axis]
    out = list(xs[0])
    out[axis] = total
    ctx.set_output_dim("Out", tuple(out))


@register_infer_shape("softmax")
def _softmax(ctx):
    x = ctx.input_dim("X")
    if x is not None:
        ctx.set_output_dim("Out", x)


@register_infer_shape("cross_entropy")
def _cross_entropy(ctx):
    x = ctx.input_dim("X")
    lab = ctx.input_dim("Label")
    if x is None:
        return
    ctx.enforce(len(x) >= 2, f"X must be at least 2-D [N, C], got {x}")
    if lab is not None:
        ctx.enforce(len(lab) == len(x),
                    f"Label rank {len(lab)} != X rank {len(x)}")
        for i in range(len(x) - 1):
            ctx.enforce(_dim_match(x[i], lab[i]),
                        f"batch dims mismatch: X{x} vs Label{lab}")
        if ctx.attr("soft_label", False):
            ctx.enforce(_dim_match(lab[-1], x[-1]),
                        f"soft_label needs Label{lab} last dim == C {x[-1]}")
        else:
            ctx.enforce(lab[-1] == 1,
                        f"hard-label Label{lab} last dim must be 1")
    ctx.set_output_dim("Y", tuple(x[:-1]) + (1,))


@register_infer_shape("softmax_with_cross_entropy")
def _softmax_xent(ctx):
    x = ctx.input_dim("Logits")
    lab = ctx.input_dim("Label")
    if x is None:
        return
    if lab is not None and not ctx.attr("soft_label", False):
        ctx.enforce(lab[-1] == 1,
                    f"hard-label Label{lab} last dim must be 1")
    ctx.set_output_dim("Softmax", x)
    ctx.set_output_dim("Loss", tuple(x[:-1]) + (1,))


@register_infer_shape("batch_norm")
def _batch_norm(ctx):
    x = ctx.input_dim("X")
    if x is None:
        return
    ctx.enforce(2 <= len(x) <= 5, f"X rank must be 2..5, got {x}")
    c = x[-1] if ctx.attr("data_layout", "NCHW") == "NHWC" else x[1]
    for slot in ("Scale", "Bias", "Mean", "Variance"):
        s = ctx.input_dim(slot)
        if s is not None and c != -1:
            ctx.enforce(len(s) == 1 and _dim_match(s[0], c),
                        f"{slot}{s} must be [{c}]")
    ctx.set_output_dim("Y", x)


@register_infer_shape("lookup_table", "shard_lookup_table")
def _lookup_table(ctx):
    w = ctx.input_dim("W")
    ids = ctx.input_dim("Ids")
    if w is None:
        return
    ctx.enforce(len(w) == 2, f"W must be 2-D [V, D], got {w}")
    if ids is not None:
        ctx.enforce(_dim_match(ids[-1], 1), f"Ids{ids} last dim must be 1")
        ctx.set_output_dim("Out", tuple(ids[:-1]) + (w[1],))


@register_infer_shape("mean")
def _mean(ctx):
    ctx.set_output_dim("Out", (1,))


@register_infer_shape("sum")
def _sum(ctx):
    xs = [s for s in ctx.input_dims("X") if s is not None]
    for s in xs[1:]:
        ctx.enforce(_shapes_match(s, xs[0]),
                    f"sum inputs must agree in shape: {xs}")
    if xs:
        ctx.set_output_dim("Out", xs[0])


@register_infer_shape("scale", "cast", "relu", "sigmoid", "tanh", "abs",
                      "exp", "sqrt", "square", "softsign", "softplus",
                      "ceil", "floor", "round", "reciprocal", "log",
                      "leaky_relu", "elu", "relu6", "hard_sigmoid",
                      "swish", "clip", "dropout")
def _same_shape(ctx):
    x = ctx.input_dim("X")
    if x is not None:
        ctx.set_output_dim("Out", x)
        if ctx.has_output("Mask"):  # dropout
            ctx.set_output_dim("Mask", x)


@register_infer_shape("top_k")
def _top_k(ctx):
    x = ctx.input_dim("X")
    if x is None:
        return
    k = ctx.attr("k", 1)
    if x[-1] != -1:
        ctx.enforce(k <= x[-1], f"k={k} > last dim of X{x}")
    out = tuple(x[:-1]) + (k,)
    ctx.set_output_dim("Out", out)
    ctx.set_output_dim("Indices", out)


@register_infer_shape("fill_constant")
def _fill_constant(ctx):
    shape = ctx.attr("shape")
    if shape is not None:
        ctx.set_output_dim("Out", tuple(int(s) for s in shape))


@register_infer_shape("split")
def _split(ctx):
    x = ctx.input_dim("X")
    if x is None:
        return
    axis = ctx.attr("axis", 0)
    ctx.enforce(-len(x) <= axis < len(x),
                f"split axis {axis} out of range for {x}")
    axis %= len(x)
    sections = ctx.attr("sections") or []
    num = ctx.attr("num", 0)
    n_out = len(ctx.op.outputs.get("Out") or [])
    if sections:
        ctx.enforce(len(sections) == n_out,
                    f"{len(sections)} sections vs {n_out} outputs")
        if x[axis] != -1:
            ctx.enforce(sum(sections) == x[axis],
                        f"sections {sections} don't sum to dim {x[axis]}")
        for i, s in enumerate(sections):
            out = list(x)
            out[axis] = s
            ctx.set_output_dim("Out", tuple(out), i)
    elif num:
        if x[axis] != -1:
            ctx.enforce(x[axis] % num == 0,
                        f"dim {x[axis]} not divisible by num {num}")
        for i in range(n_out):
            out = list(x)
            out[axis] = -1 if x[axis] == -1 else x[axis] // num
            ctx.set_output_dim("Out", tuple(out), i)


# ---------------------------------------------------------------------------
# Full-registry coverage (r4): every registered op type carries a contract.
#
# Reference parity: EVERY reference op declares InferShape
# (framework/shape_inference.h:28-60, invoked from op_desc.cc) — malformed
# programs fail at append_op, never inside a trace. Families whose output
# rows are data-dependent (LoD/ragged, NMS, CRF) validate what is static and
# leave the data-dependent dims unset, exactly like the reference's -1 dims.
# ---------------------------------------------------------------------------

# unary elementwise / same-shape ops not yet in the list above
register_infer_shape(
    "cos", "sin", "gelu", "brelu", "hard_shrink", "logsigmoid",
    "soft_relu", "softshrink", "stanh", "tanh_shrink", "thresholded_relu",
    "pow", "cumsum", "fill_zeros_like", "assign", "logical_not",
    "clip_by_norm", "prelu", "increment", "scatter", "reverse",
    "lod_reset",
)(_same_shape)


@register_infer_shape("label_smooth")
def _label_smooth(ctx):
    x = ctx.input_dim("X")
    d = ctx.input_dim("PriorDist")
    if x is None:
        return
    if d is not None and x[-1] != -1:
        ctx.enforce(_dim_match(d[-1], x[-1]),
                    f"PriorDist{d} last dim must match classes {x[-1]}")
    ctx.set_output_dim("Out", x)


def _bcast_out(x, y):
    """numpy-style broadcast of two shapes; -1 is "unknown" and must stay
    unknown unless the other side pins it (>1): resolving -1 vs 1 to 1
    would freeze a wrong static batch into downstream metadata."""
    r = max(len(x), len(y))
    xa = (1,) * (r - len(x)) + tuple(x)
    ya = (1,) * (r - len(y)) + tuple(y)
    o = []
    for a, b in zip(xa, ya):
        if a == -1:
            o.append(-1 if b in (1, -1) else b)
        elif b == -1:
            o.append(-1 if a == 1 else a)
        elif a == 1:
            o.append(b)
        elif b == 1 or b == a:
            o.append(a)
        else:
            return None
    return tuple(o)


@register_infer_shape(
    "less_than", "less_equal", "greater_than", "greater_equal", "equal",
    "not_equal", "logical_and", "logical_or", "logical_xor")
def _compare(ctx):
    x = ctx.input_dim("X")
    y = ctx.input_dim("Y")
    if x is None or y is None:
        if x is not None:
            ctx.set_output_dim("Out", x)
        return
    o = _bcast_out(x, y)
    ctx.enforce(o is not None,
                f"shapes X{x} and Y{y} are not broadcastable")
    ctx.set_output_dim("Out", o)


# -- optimizer family ------------------------------------------------------
_OPT_STATE_SLOTS = {
    "sgd": [],
    "momentum": ["Velocity"],
    "adam": ["Moment1", "Moment2"],
    "adamax": ["Moment", "InfNorm"],
    "adagrad": ["Moment"],
    "decayed_adagrad": ["Moment"],
    "adadelta": ["AvgSquaredGrad", "AvgSquaredUpdate"],
    "rmsprop": ["MeanSquare", "Moment"],
    "ftrl": ["SquaredAccumulator", "LinearAccumulator"],
    "proximal_gd": [],
    "proximal_adagrad": ["Moment"],
}


def _optimizer(ctx):
    p = ctx.input_dim("Param")
    g = ctx.input_dim("Grad")
    if p is not None and g is not None and len(g) > 0:
        # SelectedRows grads ride through the same slot with row-sliced
        # shapes; only enforce when ranks agree (dense update)
        if len(p) == len(g):
            ctx.enforce(_shapes_match(p, g),
                        f"Grad{g} must match Param{p}")
    lr = ctx.input_dim("LearningRate")
    if lr is not None:
        ctx.enforce(_numel(lr) in (1, None),
                    f"LearningRate{lr} must hold one scalar")
    if p is None:
        return
    ctx.set_output_dim("ParamOut", p)
    for slot in _OPT_STATE_SLOTS[ctx.op.type]:
        s = ctx.input_dim(slot)
        if s is not None:
            ctx.enforce(_shapes_match(s, p), f"{slot}{s} must match Param{p}")
            ctx.set_output_dim(slot + "Out", s)


for _t in _OPT_STATE_SLOTS:
    register_infer_shape(_t)(_optimizer)


# -- conv/interp family ----------------------------------------------------
@register_infer_shape("conv3d")
def _conv3d(ctx):
    x = ctx.input_dim("Input")
    w = ctx.input_dim("Filter")
    if x is None or w is None:
        return
    ctx.enforce(len(x) == 5, f"Input must be NCDHW 5-D, got {x}")
    ctx.enforce(len(w) == 5, f"Filter must be [M, C/g, kd, kh, kw], got {w}")
    groups = ctx.attr("groups", 1) or 1
    ctx.enforce(_dim_match(x[1], w[1] * groups),
                f"in_channels {x[1]} != filter_channels {w[1]} * groups "
                f"{groups}")
    s = list(ctx.attr("strides", [1, 1, 1]))
    p = list(ctx.attr("paddings", [0, 0, 0]))
    d = list(ctx.attr("dilations", [1, 1, 1]))
    dims = [_conv_out(x[2 + i], w[2 + i], p[i], s[i], d[i])
            for i in range(3)]
    ctx.enforce(all(v != 0 and (v > 0 or v == -1) for v in dims),
                f"empty conv3d output {dims}")
    ctx.set_output_dim("Output", (x[0], w[0], *dims))


@register_infer_shape("conv2d_transpose")
def _conv2d_transpose(ctx):
    x = ctx.input_dim("Input")
    w = ctx.input_dim("Filter")
    if x is None or w is None:
        return
    ctx.enforce(len(x) == 4, f"Input must be NCHW 4-D, got {x}")
    ctx.enforce(len(w) == 4, f"Filter must be [C, M, kh, kw], got {w}")
    ctx.enforce(_dim_match(x[1], w[0]),
                f"in_channels {x[1]} != filter dim0 {w[0]}")
    s = _pair(ctx.attr("strides", [1, 1]))
    p = _pair(ctx.attr("paddings", [0, 0]))
    d = _pair(ctx.attr("dilations", [1, 1]))
    oh = -1 if x[2] == -1 else \
        (x[2] - 1) * s[0] - 2 * p[0] + d[0] * (w[2] - 1) + 1
    ow = -1 if x[3] == -1 else \
        (x[3] - 1) * s[1] - 2 * p[1] + d[1] * (w[3] - 1) + 1
    ctx.set_output_dim("Output", (x[0], w[1], oh, ow))


@register_infer_shape("bilinear_interp")
def _bilinear_interp(ctx):
    x = ctx.input_dim("X")
    if x is None:
        return
    ctx.enforce(len(x) == 4, f"X must be NCHW 4-D, got {x}")
    oh = ctx.attr("out_h")
    ow = ctx.attr("out_w")
    ctx.set_output_dim("Out", (x[0], x[1],
                               oh if oh else -1, ow if ow else -1))


@register_infer_shape("maxout")
def _maxout(ctx):
    x = ctx.input_dim("X")
    if x is None:
        return
    ctx.enforce(len(x) == 4, f"X must be NCHW 4-D, got {x}")
    g = ctx.attr("groups", 1)
    if x[1] != -1:
        ctx.enforce(x[1] % g == 0,
                    f"channels {x[1]} not divisible by groups {g}")
        ctx.set_output_dim("Out", (x[0], x[1] // g, x[2], x[3]))


@register_infer_shape("lrn")
def _lrn(ctx):
    x = ctx.input_dim("X")
    if x is not None:
        ctx.enforce(len(x) == 4, f"X must be NCHW 4-D, got {x}")
        ctx.set_output_dim("Out", x)
        ctx.set_output_dim("MidOut", x)


@register_infer_shape("layer_norm")
def _layer_norm(ctx):
    x = ctx.input_dim("X")
    if x is None:
        return
    axis = ctx.attr("begin_norm_axis", 1)
    ctx.enforce(0 < axis < len(x),
                f"begin_norm_axis {axis} out of range for X{x}")
    ctx.set_output_dim("Y", x)
    left = _numel(x[:axis])
    if left is not None:
        ctx.set_output_dim("Mean", (left,))
        ctx.set_output_dim("Variance", (left,))


@register_infer_shape("norm")
def _norm(ctx):
    x = ctx.input_dim("X")
    if x is not None:
        ctx.set_output_dim("Out", x)


@register_infer_shape("row_conv")
def _row_conv(ctx):
    x = ctx.input_dim("X")
    w = ctx.input_dim("Filter")
    if x is not None and w is not None and x[-1] != -1:
        ctx.enforce(_dim_match(w[-1], x[-1]),
                    f"Filter{w} last dim must match features {x[-1]}")
    if x is not None:
        ctx.set_output_dim("Out", x)


# -- losses ----------------------------------------------------------------
def _pairwise_loss(ctx, x_slot, y_slot, *out_slots):
    x = ctx.input_dim(x_slot)
    y = ctx.input_dim(y_slot)
    if x is not None and y is not None:
        ctx.enforce(_shapes_match(x, y),
                    f"{x_slot}{x} and {y_slot}{y} must agree")
    if x is not None:
        for slot in out_slots:
            ctx.set_output_dim(slot, x)


@register_infer_shape("square_error_cost")
def _square_error_cost(ctx):
    _pairwise_loss(ctx, "X", "Y", "Out")


@register_infer_shape("sigmoid_cross_entropy_with_logits")
def _sigmoid_xent(ctx):
    _pairwise_loss(ctx, "X", "Label", "Out")


@register_infer_shape("hinge_loss")
def _hinge_loss(ctx):
    _pairwise_loss(ctx, "Logits", "Labels", "Loss")


@register_infer_shape("log_loss")
def _log_loss(ctx):
    _pairwise_loss(ctx, "Predicted", "Labels", "Loss")


@register_infer_shape("huber_loss")
def _huber_loss(ctx):
    _pairwise_loss(ctx, "X", "Y", "Out", "Residual")


@register_infer_shape("rank_loss")
def _rank_loss(ctx):
    _pairwise_loss(ctx, "Left", "Right", "Out")


@register_infer_shape("margin_rank_loss")
def _margin_rank_loss(ctx):
    _pairwise_loss(ctx, "X1", "X2", "Out", "Activated")


@register_infer_shape("squared_l2_norm")
def _squared_l2_norm(ctx):
    ctx.set_output_dim("Out", (1,))


@register_infer_shape("squared_l2_distance")
def _squared_l2_distance(ctx):
    x = ctx.input_dim("X")
    y = ctx.input_dim("Y")
    if x is None:
        return
    if y is not None:
        ctx.enforce(len(x) == len(y), f"X{x} vs Y{y} rank mismatch")
        ctx.enforce(y[0] == 1 or _dim_match(y[0], x[0]),
                    f"Y{y} rows must be 1 or match X{x}")
    ctx.set_output_dim("sub_result", x)
    ctx.set_output_dim("Out", (x[0], 1))


@register_infer_shape("smooth_l1_loss")
def _smooth_l1_loss(ctx):
    x = ctx.input_dim("X")
    y = ctx.input_dim("Y")
    if x is not None and y is not None:
        ctx.enforce(_shapes_match(x, y), f"X{x} and Y{y} must agree")
    if x is not None:
        ctx.set_output_dim("Diff", x)
        ctx.set_output_dim("Out", (x[0], 1))


@register_infer_shape("cos_sim")
def _cos_sim(ctx):
    x = ctx.input_dim("X")
    y = ctx.input_dim("Y")
    if x is None:
        return
    if y is not None:
        ctx.enforce(len(x) == len(y), f"X{x} vs Y{y} rank mismatch")
    ctx.set_output_dim("Out", (x[0], 1))
    ctx.set_output_dim("XNorm", (x[0], 1))
    if y is not None:
        ctx.set_output_dim("YNorm", (y[0], 1))


# -- tensor manipulation ---------------------------------------------------
@register_infer_shape("pad")
def _pad(ctx):
    x = ctx.input_dim("X")
    p = ctx.attr("paddings", [])
    if x is None:
        return
    ctx.enforce(len(p) == 2 * len(x),
                f"paddings {p} must hold 2 entries per dim of X{x}")
    ctx.set_output_dim("Out", tuple(
        -1 if d == -1 else d + p[2 * i] + p[2 * i + 1]
        for i, d in enumerate(x)))


@register_infer_shape("crop")
def _crop(ctx):
    x = ctx.input_dim("X")
    shape = ctx.attr("shape")
    offsets = ctx.attr("offsets")
    if x is None or shape is None:
        return
    ctx.enforce(len(shape) == len(x),
                f"crop shape {shape} rank must match X{x}")
    if offsets is not None:
        for i, (o, s) in enumerate(zip(offsets, shape)):
            if x[i] != -1:
                ctx.enforce(o + s <= x[i],
                            f"crop dim {i}: offset {o} + size {s} > {x[i]}")
    ctx.set_output_dim("Out", tuple(shape))


@register_infer_shape("gather")
def _gather(ctx):
    x = ctx.input_dim("X")
    idx = ctx.input_dim("Index")
    if x is None or idx is None:
        return
    if len(idx) == 1:
        ctx.set_output_dim("Out", (idx[0],) + tuple(x[1:]))


@register_infer_shape("one_hot")
def _one_hot(ctx):
    x = ctx.input_dim("X")
    depth = ctx.attr("depth")
    if x is None or depth is None:
        return
    n = _numel(x)
    if n is not None:
        ctx.set_output_dim("Out", (n, depth))


@register_infer_shape("expand")
def _expand(ctx):
    x = ctx.input_dim("X")
    times = ctx.attr("expand_times")
    if x is None or times is None:
        return
    ctx.enforce(len(times) == len(x),
                f"expand_times {times} rank must match X{x}")
    ctx.set_output_dim("Out", tuple(
        -1 if d == -1 else d * t for d, t in zip(x, times)))


@register_infer_shape("multiplex")
def _multiplex(ctx):
    xs = [s for s in ctx.input_dims("X") if s is not None]
    for s in xs[1:]:
        ctx.enforce(_shapes_match(s, xs[0]),
                    f"multiplex candidates must agree in shape: {xs}")
    if xs:
        ctx.set_output_dim("Out", xs[0])


@register_infer_shape("shape")
def _shape(ctx):
    x = ctx.input_dim("X")
    if x is not None:
        ctx.set_output_dim("Out", (len(x),))


@register_infer_shape("arg_max", "arg_min")
def _arg_extreme(ctx):
    x = ctx.input_dim("X")
    if x is None:
        return
    axis = ctx.attr("axis", -1)
    ctx.enforce(-len(x) <= axis < len(x),
                f"axis {axis} out of range for X{x}")
    axis %= len(x)
    out = tuple(d for i, d in enumerate(x) if i != axis)
    ctx.set_output_dim("Out", out if out else (1,))


@register_infer_shape("argsort")
def _argsort(ctx):
    x = ctx.input_dim("X")
    if x is not None:
        ctx.set_output_dim("Out", x)
        ctx.set_output_dim("Indices", x)


@register_infer_shape("gaussian_random", "uniform_random",
                      "truncated_gaussian_random")
def _random_fill(ctx):
    shape = ctx.attr("shape")
    if shape:
        ctx.set_output_dim("Out", tuple(int(s) for s in shape))


@register_infer_shape("fill_constant_batch_size_like")
def _fill_batch_like(ctx):
    ref = ctx.input_dim("Input")
    shape = list(ctx.attr("shape", []))
    if not shape:
        return
    in_idx = ctx.attr("input_dim_idx", 0)
    out_idx = ctx.attr("output_dim_idx", 0)
    if ref is not None and in_idx < len(ref) and out_idx < len(shape):
        shape[out_idx] = ref[in_idx]
    ctx.set_output_dim("Out", tuple(shape))


@register_infer_shape("assign_value")
def _assign_value(ctx):
    shape = ctx.attr("shape")
    if shape:
        ctx.set_output_dim("Out", tuple(int(s) for s in shape))


@register_infer_shape("im2sequence")
def _im2sequence(ctx):
    x = ctx.input_dim("X")
    if x is not None:
        ctx.enforce(len(x) == 4, f"X must be NCHW 4-D, got {x}")


# -- metrics ---------------------------------------------------------------
@register_infer_shape("accuracy")
def _accuracy(ctx):
    idx = ctx.input_dim("Indices")
    lab = ctx.input_dim("Label")
    if idx is not None and lab is not None:
        ctx.enforce(_dim_match(idx[0], lab[0]),
                    f"Indices{idx} and Label{lab} batch mismatch")
    ctx.set_output_dim("Accuracy", (1,))
    ctx.set_output_dim("Correct", (1,))
    ctx.set_output_dim("Total", (1,))


@register_infer_shape("auc")
def _auc(ctx):
    ctx.set_output_dim("AUC", (1,))


@register_infer_shape("precision_recall")
def _precision_recall(ctx):
    ctx.set_output_dim("BatchMetrics", (6,))
    ctx.set_output_dim("AccumMetrics", (6,))


@register_infer_shape("edit_distance")
def _edit_distance(ctx):
    ctx.set_output_dim("SequenceNum", (1,))


@register_infer_shape("chunk_eval")
def _chunk_eval(ctx):
    for slot in ("Precision", "Recall", "F1-Score", "NumInferChunks",
                 "NumLabelChunks", "NumCorrectChunks"):
        if ctx.has_output(slot):
            ctx.set_output_dim(slot, (1,))


# -- detection -------------------------------------------------------------
@register_infer_shape("prior_box")
def _prior_box(ctx):
    x = ctx.input_dim("Input")
    img = ctx.input_dim("Image")
    if x is not None:
        ctx.enforce(len(x) == 4, f"Input must be NCHW 4-D, got {x}")
    if img is not None:
        ctx.enforce(len(img) == 4, f"Image must be NCHW 4-D, got {img}")


@register_infer_shape("iou_similarity")
def _iou_similarity(ctx):
    x = ctx.input_dim("X")
    y = ctx.input_dim("Y")
    if x is not None:
        ctx.enforce(_dim_match(x[-1], 4), f"X{x} last dim must be 4 (boxes)")
    if y is not None:
        ctx.enforce(_dim_match(y[-1], 4), f"Y{y} last dim must be 4 (boxes)")
    if x is not None and y is not None:
        ctx.set_output_dim("Out", (x[0], y[0]))


@register_infer_shape("box_coder")
def _box_coder(ctx):
    pb = ctx.input_dim("PriorBox")
    if pb is not None:
        ctx.enforce(_dim_match(pb[-1], 4), f"PriorBox{pb} last dim must be 4")


@register_infer_shape("bipartite_match", "target_assign",
                      "mine_hard_examples", "multiclass_nms",
                      "detection_map", "ctc_align")
def _dynamic_rows(ctx):
    """Output rows are data-dependent (match counts, kept boxes, aligned
    tokens) — the reference sets -1 dims here too; nothing static to pin."""


# -- sequence (ragged) family ---------------------------------------------
@register_infer_shape("sequence_softmax", "sequence_erase")
def _seq_same(ctx):
    x = ctx.input_dim("X")
    if x is not None:
        ctx.set_output_dim("Out", x)


@register_infer_shape("sequence_pool")
def _sequence_pool(ctx):
    x = ctx.input_dim("X")
    if x is not None and len(x) >= 2:
        # rows collapse to one per sequence (count is data-dependent)
        ctx.set_output_dim("Out", (-1,) + tuple(x[1:]))


@register_infer_shape("sequence_conv")
def _sequence_conv(ctx):
    x = ctx.input_dim("X")
    w = ctx.input_dim("Filter")
    if x is None or w is None:
        return
    size = ctx.attr("contextLength", 1)
    if x[-1] != -1:
        ctx.enforce(_dim_match(w[0], size * x[-1]),
                    f"Filter{w} dim0 must be contextLength {size} * "
                    f"features {x[-1]}")
    ctx.set_output_dim("Out", (x[0], w[1]))


@register_infer_shape("sequence_reshape")
def _sequence_reshape(ctx):
    x = ctx.input_dim("X")
    d = ctx.attr("new_dim")
    if x is not None and d:
        ctx.set_output_dim("Out", (-1, d))


@register_infer_shape("sequence_expand", "sequence_slice", "sequence_pad",
                      "sequence_unpad", "sequence_concat")
def _seq_dynamic(ctx):
    """Row counts are LoD-dependent; static dims ride through the kernels
    (SeqTensor), nothing to pin at build time."""


# -- RNN family ------------------------------------------------------------
@register_infer_shape("lstm")
def _lstm(ctx):
    x = ctx.input_dim("Input")
    w = ctx.input_dim("Weight")
    if w is not None:
        ctx.enforce(_dim_match(w[1], 4 * w[0]),
                    f"Weight{w} must be [D, 4D]")
    if x is not None:
        ctx.set_output_dim(
            "Hidden", (x[0], w[0] if w is not None else -1))


@register_infer_shape("gru")
def _gru(ctx):
    x = ctx.input_dim("Input")
    w = ctx.input_dim("Weight")
    if w is not None:
        ctx.enforce(_dim_match(w[1], 3 * w[0]),
                    f"Weight{w} must be [D, 3D]")
    if x is not None:
        ctx.set_output_dim(
            "Hidden", (x[0], w[0] if w is not None else -1))


@register_infer_shape("lstm_unit")
def _lstm_unit(ctx):
    x = ctx.input_dim("X")
    c = ctx.input_dim("C_prev")
    if x is not None and c is not None and x[-1] != -1 and c[-1] != -1:
        ctx.enforce(_dim_match(x[-1], 4 * c[-1]),
                    f"X{x} features must be 4x C_prev{c} features")
    if c is not None:
        ctx.set_output_dim("C", c)
        ctx.set_output_dim("H", c)


@register_infer_shape("gru_unit")
def _gru_unit(ctx):
    h = ctx.input_dim("HiddenPrev")
    if h is not None:
        ctx.set_output_dim("Hidden", h)


@register_infer_shape("attention_lstm_decoder", "attention_lstm_step",
                      "dynamic_recurrent", "recurrent")
def _rnn_dynamic(ctx):
    """Sub-block / ragged outputs; shapes resolve at trace time."""


# -- NCE / hierarchical / CRF ---------------------------------------------
@register_infer_shape("nce")
def _nce(ctx):
    x = ctx.input_dim("Input")
    if x is not None:
        ctx.set_output_dim("Cost", (x[0], 1))


@register_infer_shape("hierarchical_sigmoid")
def _hsigmoid(ctx):
    x = ctx.input_dim("X")
    if x is not None:
        ctx.set_output_dim("Out", (x[0], 1))


@register_infer_shape("linear_chain_crf", "crf_decoding", "warpctc")
def _crf_dynamic(ctx):
    """Ragged inputs (SeqTensor); per-sequence outputs are LoD-dependent."""


# -- collectives -----------------------------------------------------------
@register_infer_shape("all_reduce", "broadcast", "collective_permute",
                      "pipeline_send", "pipeline_recv")
def _coll_same(ctx):
    x = ctx.input_dim("X")
    if x is not None:
        ctx.set_output_dim("Out", x)


@register_infer_shape("all_gather", "reduce_scatter")
def _coll_resize(ctx):
    """Output dim0 scales by the mesh axis size, which is a runtime mesh
    property — left dynamic at build time."""


@register_infer_shape("shard_gather", "shard_slice")
def _shard_dim(ctx):
    """X's shape with dim `dim` times (gather) or over (slice) `parts`,
    the mesh axis's ranks (parallel/autoshard/lower.py)."""
    x = ctx.input_dim("X")
    if x is None:
        return
    d, parts = int(ctx.attr("dim")), int(ctx.attr("parts", 1) or 1)
    ctx.enforce(0 <= d < len(x), f"dim {d} out of X{tuple(x)}")
    out = list(x)
    if out[d] >= 0:
        if ctx.op.type == "shard_gather":
            out[d] *= parts
        else:
            ctx.enforce(out[d] % parts == 0,
                        f"X{tuple(x)} dim {d} not divisible by {parts}")
            out[d] //= parts
    ctx.set_output_dim("Out", tuple(out))


@register_infer_shape("zero1_scatter")
def _zero1_scatter(ctx):
    """[parts, ceil(numel/parts)] shard layout of the flattened input."""
    x = ctx.input_dim("X")
    parts = ctx.attr("parts")
    if x is not None and parts and all(d >= 0 for d in x):
        numel = 1
        for d in x:
            numel *= d
        ctx.set_output_dim("Out", [int(parts), -(-numel // int(parts))])


@register_infer_shape("zero1_gather")
def _zero1_gather(ctx):
    """Regather restores the exact original parameter shape (attr)."""
    shape = ctx.attr("shape")
    if shape:
        ctx.set_output_dim("Out", [int(d) for d in shape])


# -- fused ops (paddle_tpu_torch.fusion) -----------------------------------------
@register_infer_shape("fused_elementwise")
def _fused_elementwise(ctx):
    """Every sub-op in the replayed chain is unary elementwise, so the
    chain preserves the input shape end to end."""
    x = ctx.input_dim("X")
    if x is not None:
        ctx.set_output_dim("Out", x)


@register_infer_shape("fused_sgd_update", "fused_momentum_update",
                      "fused_adam_update")
def _fused_update(ctx):
    """Bucketed weight update: slot i of every variadic output mirrors
    slot i of its input — the packed lane is sliced back exactly."""
    n = len(ctx.op.inputs.get("Param") or [])
    ctx.enforce(n >= 1, "fused update needs at least one Param")
    ctx.enforce(len(ctx.op.inputs.get("Grad") or []) == n,
                "fused update needs one Grad per Param")
    rows = ctx.attr("shard_rows", 0)
    for in_slot, out_slot in (("Param", "ParamOut"),
                              ("Velocity", "VelocityOut"),
                              ("Moment1", "Moment1Out"),
                              ("Moment2", "Moment2Out")):
        names = ctx.op.inputs.get(in_slot) or []
        ctx.enforce(len(names) in (0, n),
                    f"fused update slot {in_slot} must carry one entry "
                    f"per Param")
        for i in range(len(names)):
            d = ctx.input_dim(in_slot, i)
            if d is None:
                continue
            g = ctx.input_dim("Grad", i)
            if g is not None:
                ctx.enforce(_shapes_match(d, g),
                            f"{in_slot}[{i}] shape {d} does not match "
                            f"Grad[{i}] shape {g}")
            if rows:
                ctx.enforce(len(d) == 2 and _dim_match(d[0], int(rows)),
                            f"shard-layout member {in_slot}[{i}] must be "
                            f"(shard_rows={rows}, shard), got {d}")
            ctx.set_output_dim(out_slot, d, i)


# -- host / side-effect ops ------------------------------------------------
def _host_noop(ctx):
    """Side-effect / host ops: no dense output shape semantics at build
    time (readers hold ReaderHolder state, RPC ops move bytes, channel ops
    synchronize). The reference registers trivial InferShape for these too
    (e.g. operators/send_op.cc)."""


for _t in (
    "feed", "fetch", "print", "assert_op", "get_places", "delete_var",
    "save", "load", "save_combine", "load_combine",
    "create_recordio_file_reader", "create_datapipe_reader", "open_files",
    "create_random_data_generator", "create_shuffle_reader",
    "create_batch_reader", "create_double_buffer_reader",
    "create_multi_pass_reader", "read",
    "send", "recv", "send_vars", "send_barrier", "fetch_barrier",
    "prefetch", "listen_and_serv",
    "channel_create", "channel_send", "channel_recv", "channel_close",
    "go", "select", "while", "conditional_block",
    "write_to_array", "read_from_array", "read_from_array_grad",
    "lod_tensor_to_array",
    "array_to_lod_tensor", "lod_rank_table", "shrink_rnn_memory",
    "reorder_lod_tensor_by_rank", "beam_search", "beam_search_decode",
    "init_sparse_table", "lookup_sparse_table", "split_ids", "merge_ids",
    "is_empty", "isfinite",
):
    register_infer_shape(_t)(_host_noop)


@register_infer_shape("while_grad")
def _while_grad(ctx):
    # dX takes X's shape positionally; "" output slots are skipped
    for i in range(len(ctx.op.inputs.get("X") or [])):
        d = ctx.input_dim("X", i)
        if d is not None:
            ctx.set_output_dim("X@GRAD", d, i)


@register_infer_shape("conditional_block_grad")
def _conditional_block_grad(ctx):
    for i in range(len(ctx.op.inputs.get("Input") or [])):
        d = ctx.input_dim("Input", i)
        if d is not None:
            ctx.set_output_dim("Input@GRAD", d, i)


@register_infer_shape("write_to_array_grad")
def _write_to_array_grad(ctx):
    d = ctx.input_dim("X")
    if d is not None:
        ctx.set_output_dim("X@GRAD", d)


@register_infer_shape("lod_array_length", "max_sequence_len")
def _len_scalar(ctx):
    ctx.set_output_dim("Out", (1,))


@register_infer_shape("random_crop")
def _random_crop(ctx):
    x = ctx.input_dim("X")
    shape = ctx.attr("shape")
    if x is None or not shape:
        return
    ctx.enforce(len(shape) <= len(x),
                f"crop shape {shape} rank exceeds X{x}")
    batch = tuple(x[: len(x) - len(shape)])
    for i, s in enumerate(shape):
        d = x[len(x) - len(shape) + i]
        if d != -1:
            ctx.enforce(s <= d, f"crop size {s} > input dim {d}")
    ctx.set_output_dim("Out", batch + tuple(shape))


@register_infer_shape("roi_pool")
def _roi_pool(ctx):
    x = ctx.input_dim("X")
    rois = ctx.input_dim("ROIs")
    ph = ctx.attr("pooled_height", 1)
    pw = ctx.attr("pooled_width", 1)
    if x is not None:
        ctx.enforce(len(x) == 4, f"X must be NCHW 4-D, got {x}")
    if rois is not None:
        ctx.enforce(len(rois) == 2, f"ROIs must be 2-D [R, 4/5], got {rois}")
    if x is not None and rois is not None:
        out = (rois[0], x[1], ph, pw)
        ctx.set_output_dim("Out", out)
        ctx.set_output_dim("Argmax", out)


@register_infer_shape("spp")
def _spp(ctx):
    x = ctx.input_dim("X")
    if x is None:
        return
    ctx.enforce(len(x) == 4, f"X must be NCHW 4-D, got {x}")
    p = ctx.attr("pyramid_height", 1)
    bins = 2 ** (p - 1)
    for d in (2, 3):
        if x[d] != -1:
            ctx.enforce(bins <= x[d],
                        f"pyramid level {p - 1} needs {bins} bins but X{x} "
                        f"dim {d} is only {x[d]} (windows would lie wholly "
                        f"in padding: -inf/NaN outputs)")
    # sum of 4^level bins over the pyramid (reference spp_op.cc:74)
    if x[1] != -1:
        ctx.set_output_dim("Out", (x[0], x[1] * (4 ** p - 1) // 3))


@register_infer_shape("unpool")
def _unpool(ctx):
    x = ctx.input_dim("X")
    idx = ctx.input_dim("Indices")
    if x is not None and idx is not None:
        ctx.enforce(_shapes_match(x, idx),
                    f"Indices{idx} must match X{x}")
    if x is None:
        return
    ctx.enforce(len(x) == 4, f"X must be NCHW 4-D, got {x}")
    k = ctx.attr("ksize")
    ctx.enforce(k is not None and len(k) == 2,
                "unpool requires a 2-entry ksize attr (the kernel has no "
                "default)")
    s = ctx.attr("strides", [1, 1])
    p = ctx.attr("paddings", [0, 0])
    oh = -1 if x[2] == -1 else (x[2] - 1) * s[0] - 2 * p[0] + k[0]
    ow = -1 if x[3] == -1 else (x[3] - 1) * s[1] - 2 * p[1] + k[1]
    ctx.set_output_dim("Out", (x[0], x[1], oh, ow))


# ---------------------------------------------------------------------------
# Explicitly registered grad ops (r4 VERDICT missing #4). Every other grad
# derives from its forward kernel via registry.make_vjp_kernel and is
# shape-checked through it; these four have hand-written kernels, so they
# get hand-written contracts. Reference: every op declares InferShape
# (shape_inference.h:28, checked from op_desc.cc).
# ---------------------------------------------------------------------------
@register_infer_shape("dropout_grad")
def _dropout_grad(ctx):
    g = ctx.input_dim("Out@GRAD")
    m = ctx.input_dim("Mask")
    if g is not None and m is not None:
        ctx.enforce(_shapes_match(g, m),
                    f"Mask{m} must match Out@GRAD{g} (dropout_grad is "
                    f"elementwise g * mask)")
    if g is not None:
        ctx.set_output_dim("X@GRAD", g)


@register_infer_shape("reorder_lod_tensor_by_rank_grad")
def _reorder_lod_tensor_by_rank_grad(ctx):
    # the inverse row permutation: dX has exactly dOut's shape
    g = ctx.input_dim("Out@GRAD")
    if g is not None:
        ctx.set_output_dim("X@GRAD", g)


@register_infer_shape("lookup_table_grad", "shard_lookup_table_grad")
def _lookup_table_grad(ctx):
    w = ctx.input_dim("W")
    g = ctx.input_dim("Out@GRAD")
    if w is not None:
        ctx.enforce(len(w) == 2, f"W must be 2-D [vocab, dim], got {w}")
        if g is not None and g[-1] != -1 and w[1] != -1:
            ctx.enforce(g[-1] == w[1],
                        f"Out@GRAD trailing dim {g[-1]} != embedding dim "
                        f"{w[1]}")
        # dense scatter-add grad has the table's shape; the is_sparse
        # SelectedRows grad carries the same (height, dim) metadata
        ctx.set_output_dim("W@GRAD", w)
    elif ctx.attr("height") is not None:
        # distributed table: W pruned from the trainer program
        dim = g[-1] if g is not None else -1
        ctx.set_output_dim("W@GRAD", (int(ctx.attr("height")), dim))


@register_infer_shape("nce_grad")
def _nce_grad(ctx):
    x = ctx.input_dim("Input")
    w = ctx.input_dim("Weight")
    b = ctx.input_dim("Bias")
    if x is not None:
        ctx.enforce(len(x) == 2, f"Input must be 2-D [batch, dim], got {x}")
    if w is not None:
        ctx.enforce(len(w) == 2,
                    f"Weight must be 2-D [num_classes, dim], got {w}")
    if x is not None and w is not None and x[1] != -1 and w[1] != -1:
        ctx.enforce(x[1] == w[1],
                    f"Input dim {x[1]} != Weight dim {w[1]}")
    if b is not None:
        ctx.enforce(len(b) == 2 and (b[1] in (1, -1)),
                    f"Bias must be 2-D [num_classes, 1], got {b}")
        if w is not None and w[0] != -1 and b[0] != -1:
            ctx.enforce(b[0] == w[0],
                        f"Bias classes {b[0]} != Weight classes {w[0]}")
    for slot, d in (("Input@GRAD", x), ("Weight@GRAD", w),
                    ("Bias@GRAD", b)):
        if d is not None:
            ctx.set_output_dim(slot, d)


# ---------------------------------------------------------------------------
# High-traffic hand-written grad kernels. The VJP rule all of them share:
# d(input slot S) has S's shape — the grad op's output slots are the forward
# input slots suffixed @GRAD, and its inputs carry the forward slots plus
# the incoming output grads (registry.make_vjp_kernel's convention, which
# the hand-written kernels follow). Family-specific checks ride on top.
# Surfaced as the PTA005 worklist by analysis.verifier.check_contracts.
# ---------------------------------------------------------------------------
def _mirror_grad(ctx):
    for slot in list(ctx.op.outputs):
        if not slot.endswith("@GRAD"):
            continue
        d = ctx.input_dim(slot[: -len("@GRAD")])
        if d is not None:
            ctx.set_output_dim(slot, d)


register_infer_shape("mul_grad", "square_error_cost_grad",
                     "mean_grad")(_mirror_grad)


@register_infer_shape(
    "relu_grad", "tanh_grad", "sigmoid_grad", "sqrt_grad", "abs_grad",
    "square_grad", "exp_grad", "log_grad", "floor_grad", "ceil_grad",
    "round_grad", "reciprocal_grad", "softplus_grad", "softsign_grad",
    "leaky_relu_grad", "relu6_grad", "elu_grad", "hard_sigmoid_grad",
    "swish_grad", "softmax_grad", "scale_grad", "cos_grad", "sin_grad",
    "gelu_grad", "pow_grad")
def _unary_grad(ctx):
    # elementwise: dX is X-shaped and the incoming grad must agree with X
    x = ctx.input_dim("X")
    g = ctx.input_dim("Out@GRAD")
    if x is not None and g is not None:
        ctx.enforce(_shapes_match(x, g),
                    f"Out@GRAD{g} must match X{x} (elementwise grad)")
    d = x if x is not None else g
    if d is not None:
        ctx.set_output_dim("X@GRAD", d)


@register_infer_shape(
    "elementwise_add_grad", "elementwise_sub_grad", "elementwise_mul_grad",
    "elementwise_div_grad", "elementwise_max_grad", "elementwise_min_grad",
    "elementwise_pow_grad")
def _elementwise_grad(ctx):
    # Out has X's shape (Y broadcasts against X), so the incoming grad
    # must match X; dX/dY mirror their forward operands (dY is the
    # broadcast-reduced grad)
    x = ctx.input_dim("X")
    g = ctx.input_dim("Out@GRAD")
    if x is not None and g is not None:
        ctx.enforce(_shapes_match(x, g),
                    f"Out@GRAD{g} must match X{x} (Out is X-shaped)")
    _mirror_grad(ctx)


@register_infer_shape("cross_entropy_grad")
def _cross_entropy_grad(ctx):
    x = ctx.input_dim("X")
    lab = ctx.input_dim("Label")
    if x is not None:
        ctx.enforce(len(x) >= 2,
                    f"X must be [batch, classes], got {x}")
        if lab is not None:
            ctx.enforce(_dim_match(x[0], lab[0]),
                        f"batch mismatch: X{x} vs Label{lab}")
        ctx.set_output_dim("X@GRAD", x)


@register_infer_shape("conv2d_grad", "depthwise_conv2d_grad")
def _conv2d_grad(ctx):
    x = ctx.input_dim("Input")
    w = ctx.input_dim("Filter")
    g = ctx.input_dim("Output@GRAD")
    if w is not None:
        ctx.enforce(len(w) == 4, f"Filter must be [M, C/g, kh, kw], got {w}")
        if g is not None:
            nhwc = ctx.attr("data_format", "NCHW") == "NHWC"
            ctx.enforce(len(g) == 4, f"Output@GRAD must be 4-D, got {g}")
            ctx.enforce(_dim_match(g[3 if nhwc else 1], w[0]),
                        f"Output@GRAD channels {g} != num_filters {w[0]}")
        ctx.set_output_dim("Filter@GRAD", w)
    if x is not None:
        ctx.enforce(len(x) == 4, f"Input must be 4-D, got {x}")
        ctx.set_output_dim("Input@GRAD", x)


@register_infer_shape("pool2d_grad", "max_pool2d_with_index_grad")
def _pool2d_grad(ctx):
    x = ctx.input_dim("X")
    g = ctx.input_dim("Out@GRAD")
    if x is not None:
        ctx.enforce(len(x) == 4, f"X must be 4-D, got {x}")
        if g is not None:
            ctx.enforce(len(g) == 4 and _dim_match(x[0], g[0]),
                        f"Out@GRAD{g} must be 4-D with X{x}'s batch")
        ctx.set_output_dim("X@GRAD", x)


@register_infer_shape(
    "reduce_sum_grad", "reduce_mean_grad", "reduce_max_grad",
    "reduce_min_grad", "reduce_prod_grad")
def _reduce_grad(ctx):
    x = ctx.input_dim("X")
    if x is not None:
        ctx.set_output_dim("X@GRAD", x)
