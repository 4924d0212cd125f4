"""Per-op sharding propagation rules.

Each rule receives (op, ctx) and yields (var_name, proposed_spec) pairs.
Rules are *bidirectional*: they propose specs for outputs from known input
specs AND for inputs from known output specs, so the fixpoint engine in
propagate.py can push seeds both up and down the graph. A proposal is just
a suggestion — the engine arbitrates conflicts with the collective-bytes
cost model, so rules never mutate state directly.

The `ctx` object provides:
    ctx.spec(name)   -> current canonical spec tuple, or None if unknown
    ctx.shape(name)  -> static shape tuple (entries may be None/-1), or None
    ctx.rank(name)   -> len(shape) or None
    ctx.mesh_axes    -> {axis_name: size}

A copy of the JAX package's parallel/autoshard/rules.py. The four op
types the port registers and the JAX package does not take the engine's
defaults, registering no rule of their own: `split_lod_tensor`,
`merge_lod_tensor` and `split_byref` take `default_rule` (merge's one
output gets the spec of a same-rank input; the two splits write several
outputs, for which it proposes nothing, so those stay replicated unless
another op reaches them), and `merge_lod_tensor_grad` takes
`grad_mirror_rule`, as every `*_grad` type without a rule does. The lowering (lower.py) runs each of them on
whole values.
"""

from ...optimizer import ZERO1_SHARDABLE_SLOTS

__all__ = ["register_rule", "rule_for", "registered_ops"]

_RULES = {}


def register_rule(*op_types):
    def deco(fn):
        for t in op_types:
            _RULES[t] = fn
        return fn
    return deco


def rule_for(op_type):
    return _RULES.get(op_type)


def registered_ops():
    return sorted(_RULES)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _first(names):
    return names[0] if names else None


def _at(spec, d):
    """Entry of a (possibly short) spec at dim d."""
    if spec is None:
        return None
    return spec[d] if d < len(spec) else None


def _share(ctx, names):
    """Propose the first known spec among `names` to every other name of
    the same rank — the workhorse for ops where all args are laid out
    identically (sum, activations, assign-likes)."""
    known = None
    for n in names:
        s = ctx.spec(n)
        if s is not None:
            known = s
            break
    if known is None:
        return
    r = None
    for n in names:
        if ctx.spec(n) == known:
            r = ctx.rank(n)
            break
    for n in names:
        if ctx.spec(n) is None and (r is None or ctx.rank(n) == r):
            yield n, known


# ---------------------------------------------------------------------------
# elementwise / shape-preserving: X spec == Out spec, both directions
# ---------------------------------------------------------------------------
@register_rule(
    "relu", "sigmoid", "tanh", "abs", "exp", "sqrt", "square", "log",
    "softsign", "softplus", "ceil", "floor", "round", "reciprocal",
    "leaky_relu", "elu", "relu6", "hard_sigmoid", "swish", "scale",
    "cast", "clip", "dropout", "softmax", "assign", "increment",
    "memcpy", "print")
def _rule_unary(op, ctx):
    x = _first(op.input("X"))
    out = _first(op.output("Out"))
    if x is None or out is None:
        return
    xs, os_ = ctx.spec(x), ctx.spec(out)
    if xs is not None and os_ is None:
        yield out, xs
    elif os_ is not None and xs is None:
        yield x, os_
    # dropout's Mask rides along with Out
    for m in op.output("Mask"):
        if ctx.spec(m) is None and (xs or os_) is not None:
            yield m, xs if xs is not None else os_


@register_rule("sum")
def _rule_sum(op, ctx):
    names = list(op.input("X")) + list(op.output("Out"))
    yield from _share(ctx, names)


@register_rule(
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow")
def _rule_elementwise(op, ctx):
    x = _first(op.input("X"))
    y = _first(op.input("Y"))
    out = _first(op.output("Out"))
    if x is None or out is None:
        return
    xr = ctx.rank(x)
    # X and Out always share layout
    xs, os_ = ctx.spec(x), ctx.spec(out)
    if xs is not None and os_ is None:
        yield out, xs
    elif os_ is not None and xs is None:
        yield x, os_
    ref = xs if xs is not None else os_
    if y is None or xr is None:
        return
    yr = ctx.rank(y)
    if yr is None:
        return
    # Y dim j aligns with X dim (axis + j); default axis = x_rank - y_rank
    axis = op.attrs.get("axis", -1)
    if axis is None or axis < 0:
        axis = xr - yr
    ysh = ctx.shape(y) or ()
    if ref is not None and ctx.spec(y) is None:
        prop = []
        for j in range(yr):
            dim = ysh[j] if j < len(ysh) else None
            # a broadcasting (size-1) Y dim stays replicated
            if dim == 1:
                prop.append(None)
            else:
                prop.append(_at(ref, axis + j))
        yield y, tuple(prop)
    elif ctx.spec(y) is not None:
        ys = ctx.spec(y)
        prop = [None] * xr
        for j in range(yr):
            dim = ysh[j] if j < len(ysh) else None
            if dim != 1 and 0 <= axis + j < xr:
                prop[axis + j] = _at(ys, j)
        if ref is None:
            yield out, tuple(prop)
            yield x, tuple(prop)
        elif any(a is not None and _at(ref, i) is not None
                 and a != _at(ref, i) for i, a in enumerate(prop)):
            # both operands annotated and they CONTRADICT on a dim: put
            # Y's view in front of the arbiter so the disagreement is
            # resolved by cost (and recorded), not silently dropped
            yield out, tuple(prop)


# ---------------------------------------------------------------------------
# contractions: mul / matmul / conv2d
# ---------------------------------------------------------------------------
@register_rule("mul")
def _rule_mul(op, ctx):
    x = _first(op.input("X"))
    y = _first(op.input("Y"))
    out = _first(op.output("Out"))
    if None in (x, y, out):
        return
    xnc = op.attrs.get("x_num_col_dims", 1) or 1
    ync = op.attrs.get("y_num_col_dims", 1) or 1
    xr, yr, orr = ctx.rank(x), ctx.rank(y), ctx.rank(out)
    if None in (xr, yr, orr):
        return
    xs, ys, os_ = ctx.spec(x), ctx.spec(y), ctx.spec(out)
    # Out = [X rows (dims < xnc)] + [Y cols (dims >= ync)].
    # Contracting dims (X[xnc:], Y[:ync]) are flattened in the kernel, so
    # sharding there would misorder the flatten — keep them replicated and
    # only carry the batch/row and column layouts through.
    if os_ is None and (xs is not None or ys is not None):
        prop = [_at(xs, i) for i in range(xnc)]
        prop += [_at(ys, ync + j) for j in range(yr - ync)]
        yield out, tuple(prop)
    if xs is None and os_ is not None:
        yield x, tuple(_at(os_, i) for i in range(xnc))
    if ys is None and os_ is not None:
        prop = [None] * ync
        prop += [_at(os_, xnc + j) for j in range(yr - ync)]
        yield y, tuple(prop)


@register_rule("matmul")
def _rule_matmul(op, ctx):
    x = _first(op.input("X"))
    y = _first(op.input("Y"))
    out = _first(op.output("Out"))
    if None in (x, y, out):
        return
    xr, yr, orr = ctx.rank(x), ctx.rank(y), ctx.rank(out)
    if None in (xr, yr, orr) or xr < 2 or yr < 2 or orr < 2:
        return  # 1-D operands get squeezed; punt to the default rule
    tx = bool(op.attrs.get("transpose_X", False))
    ty = bool(op.attrs.get("transpose_Y", False))
    xs, ys, os_ = ctx.spec(x), ctx.spec(y), ctx.spec(out)
    # row dim of the product in X, col dim in Y (post-transpose)
    xm = xr - 1 if tx else xr - 2
    yn = yr - 2 if ty else yr - 1
    nb = orr - 2  # leading batch dims are elementwise with X's
    if os_ is None and (xs is not None or ys is not None):
        prop = [_at(xs, d) for d in range(min(nb, xr - 2))]
        prop += [None] * (nb - len(prop))
        prop += [_at(xs, xm), _at(ys, yn)]
        yield out, tuple(prop)
    if xs is None and os_ is not None:
        prop = [_at(os_, d) for d in range(xr - 2)]
        m, k = (_at(os_, orr - 2), None)
        prop += [k, m] if tx else [m, k]
        yield x, tuple(prop)
    if ys is None and os_ is not None:
        prop = [_at(os_, d) for d in range(yr - 2)]
        n, k = (_at(os_, orr - 1), None)
        prop += [n, k] if ty else [k, n]
        yield y, tuple(prop)


@register_rule("conv2d", "depthwise_conv2d")
def _rule_conv2d(op, ctx):
    x = _first(op.input("Input"))
    w = _first(op.input("Filter"))
    out = _first(op.output("Output"))
    if None in (x, w, out):
        return
    nhwc = op.attrs.get("data_format", "NCHW") == "NHWC"
    c_ax = 3 if nhwc else 1
    xs, ws, os_ = ctx.spec(x), ctx.spec(w), ctx.spec(out)
    # Out batch follows Input batch; Out channels follow Filter[0] (Cout);
    # spatial dims stay replicated (halo exchange is out of scope); the
    # contracting Cin dim (Input channel vs Filter[1]) stays replicated.
    if os_ is None and (xs is not None or ws is not None):
        prop = [None, None, None, None]
        prop[0] = _at(xs, 0)
        prop[c_ax] = _at(ws, 0)
        yield out, tuple(prop)
    if xs is None and os_ is not None:
        prop = [None, None, None, None]
        prop[0] = _at(os_, 0)
        yield x, tuple(prop)
    if ws is None and os_ is not None:
        yield w, (_at(os_, c_ax),)


# ---------------------------------------------------------------------------
# reductions and losses
# ---------------------------------------------------------------------------
@register_rule("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
               "reduce_prod")
def _rule_reduce(op, ctx):
    x = _first(op.input("X"))
    out = _first(op.output("Out"))
    if x is None or out is None:
        return
    xr = ctx.rank(x)
    if xr is None:
        return
    if op.attrs.get("reduce_all", False):
        if ctx.spec(out) is None:
            yield out, ()
        return
    dim = op.attrs.get("dim", 0)
    dims = {d % xr for d in ([dim] if isinstance(dim, int) else list(dim))}
    keep = bool(op.attrs.get("keep_dim", False))
    xs, os_ = ctx.spec(x), ctx.spec(out)
    if xs is not None and os_ is None:
        prop = []
        for i in range(xr):
            if i in dims:
                if keep:
                    prop.append(None)
            else:
                prop.append(_at(xs, i))
        yield out, tuple(prop)
    elif os_ is not None and xs is None:
        prop, j = [], 0
        for i in range(xr):
            if i in dims:
                prop.append(None)
                if keep:
                    j += 1
            else:
                prop.append(_at(os_, j))
                j += 1
        yield x, tuple(prop)


@register_rule("mean")
def _rule_mean(op, ctx):
    out = _first(op.output("Out"))
    if out is not None and ctx.spec(out) is None:
        yield out, ()


@register_rule("cross_entropy")
def _rule_cross_entropy(op, ctx):
    x = _first(op.input("X"))
    out = _first(op.output("Y"))
    if x is None or out is None:
        return
    xs = ctx.spec(x)
    if xs is not None and ctx.spec(out) is None:
        xr = ctx.rank(x) or 2
        # loss is [batch..., 1]: batch dims carry over, class dim reduced
        yield out, tuple(_at(xs, i) for i in range(xr - 1)) + (None,)


@register_rule("softmax_with_cross_entropy")
def _rule_softmax_xent(op, ctx):
    x = _first(op.input("Logits"))
    if x is None:
        return
    xs = ctx.spec(x)
    if xs is None:
        return
    xr = ctx.rank(x) or 2
    batch = tuple(_at(xs, i) for i in range(xr - 1))
    for sm in op.output("Softmax"):
        if ctx.spec(sm) is None:
            yield sm, xs
    for loss in op.output("Loss"):
        if ctx.spec(loss) is None:
            yield loss, batch + (None,)


@register_rule("square_error_cost", "accuracy")
def _rule_pairwise_loss(op, ctx):
    names = list(op.input("X")) + list(op.input("Input")) \
        + list(op.input("Label")) + list(op.output("Out"))
    yield from _share(ctx, names)


# ---------------------------------------------------------------------------
# layout ops: reshape / transpose / concat / split
# ---------------------------------------------------------------------------
def _reshape_specs(src_shape, dst_shape, src_spec, mesh_axes):
    """Propagate `src_spec` through a reshape from src_shape to dst_shape.
    Returns the dst spec, or None if nothing survives the mapping."""
    if src_spec is None:
        return None
    out = [None] * len(dst_shape)
    i = j = 0
    while i < len(src_shape) and j < len(dst_shape):
        a = src_shape[i] if src_shape[i] is not None else -1
        b = dst_shape[j] if dst_shape[j] is not None else -1
        if a == b:
            if i < len(src_spec):
                out[j] = src_spec[i]
            i += 1
            j += 1
            continue
        if a < 0 or b < 0:
            break
        # group of src dims <-> group of dst dims with equal product
        gi, gj = [i], [j]
        pa, pb = a, b
        i += 1
        j += 1
        while pa != pb:
            if pa < pb:
                if i >= len(src_shape):
                    return tuple(out)
                nxt = src_shape[i]
                if nxt is None or nxt < 0:
                    return tuple(out)
                pa *= nxt
                gi.append(i)
                i += 1
            else:
                if j >= len(dst_shape):
                    return tuple(out)
                nxt = dst_shape[j]
                if nxt is None or nxt < 0:
                    return tuple(out)
                pb *= nxt
                gj.append(j)
                j += 1
        # sharding on the major-most src dim of the group survives onto the
        # major-most dst dim if the axis size divides it; anything else in
        # the group is dropped (would interleave after the flatten).
        ax = src_spec[gi[0]] if gi[0] < len(src_spec) else None
        if ax is not None:
            d0 = dst_shape[gj[0]]
            size = mesh_axes.get(ax)
            if (d0 is not None and d0 > 0 and size
                    and d0 % int(size) == 0):
                out[gj[0]] = ax
    return tuple(out)


@register_rule("reshape", "flatten", "squeeze", "unsqueeze")
def _rule_reshape(op, ctx):
    x = _first(op.input("X"))
    out = _first(op.output("Out"))
    if x is None or out is None:
        return
    xsh, osh = ctx.shape(x), ctx.shape(out)
    if xsh is None or osh is None:
        return
    xs, os_ = ctx.spec(x), ctx.spec(out)
    from .spec import pad_spec
    if xs is not None and os_ is None:
        prop = _reshape_specs(xsh, osh, pad_spec(xs, len(xsh)),
                              ctx.mesh_axes)
        if prop is not None:
            yield out, prop
    elif os_ is not None and xs is None:
        prop = _reshape_specs(osh, xsh, pad_spec(os_, len(osh)),
                              ctx.mesh_axes)
        if prop is not None:
            yield x, prop


@register_rule("transpose")
def _rule_transpose(op, ctx):
    x = _first(op.input("X"))
    out = _first(op.output("Out"))
    if x is None or out is None:
        return
    perm = list(op.attrs.get("axis", []))
    if not perm:
        return
    xs, os_ = ctx.spec(x), ctx.spec(out)
    if xs is not None and os_ is None:
        yield out, tuple(_at(xs, p) for p in perm)
    elif os_ is not None and xs is None:
        inv = [0] * len(perm)
        for i, p in enumerate(perm):
            inv[p] = i
        yield x, tuple(_at(os_, q) for q in inv)


@register_rule("concat")
def _rule_concat(op, ctx):
    xs = list(op.input("X"))
    out = _first(op.output("Out"))
    if not xs or out is None:
        return
    r = ctx.rank(xs[0])
    if r is None:
        return
    axis = op.attrs.get("axis", 0) % r
    known = None
    for n in xs + [out]:
        s = ctx.spec(n)
        if s is not None:
            known = s
            break
    if known is None:
        return
    prop = tuple(None if i == axis else _at(known, i) for i in range(r))
    for n in xs + [out]:
        if ctx.spec(n) is None:
            yield n, prop


@register_rule("split")
def _rule_split(op, ctx):
    x = _first(op.input("X"))
    outs = list(op.output("Out"))
    if x is None or not outs:
        return
    r = ctx.rank(x)
    if r is None:
        return
    axis = op.attrs.get("axis", 0) % r
    known = ctx.spec(x)
    if known is None:
        for n in outs:
            s = ctx.spec(n)
            if s is not None:
                known = s
                break
    if known is None:
        return
    prop = tuple(None if i == axis else _at(known, i) for i in range(r))
    for n in [x] + outs:
        if ctx.spec(n) is None:
            yield n, prop


# ---------------------------------------------------------------------------
# embedding / norm / misc
# ---------------------------------------------------------------------------
@register_rule("lookup_table")
def _rule_lookup_table(op, ctx):
    ids = _first(op.input("Ids"))
    w = _first(op.input("W"))
    out = _first(op.output("Out"))
    if None in (ids, w, out):
        return
    ir = ctx.rank(ids)
    if ir is None:
        return
    is_, ws, os_ = ctx.spec(ids), ctx.spec(w), ctx.spec(out)
    # Out = Ids[:-1] + (D,): batch layout follows Ids, feature dim follows
    # W's column layout. A row-sharded (vocab) W contributes a psum, not an
    # output sharding — the gather result is replicated over that axis.
    if os_ is None and (is_ is not None or ws is not None):
        prop = tuple(_at(is_, i) for i in range(ir - 1)) + (_at(ws, 1),)
        yield out, prop
    if is_ is None and os_ is not None:
        yield ids, tuple(_at(os_, i) for i in range(ir - 1)) + (None,)


@register_rule("batch_norm")
def _rule_batch_norm(op, ctx):
    x = _first(op.input("X"))
    y = _first(op.output("Y"))
    if x is None or y is None:
        return
    nhwc = op.attrs.get("data_layout", "NCHW") == "NHWC"
    xs, ys = ctx.spec(x), ctx.spec(y)
    if xs is not None and ys is None:
        yield y, xs
    elif ys is not None and xs is None:
        yield x, ys
    ref = xs if xs is not None else ys
    if ref is None:
        return
    xr = ctx.rank(x) or 4
    c = _at(ref, xr - 1 if nhwc else 1)
    for slot in ("Scale", "Bias", "Mean", "Variance"):
        for n in op.input(slot):
            if ctx.spec(n) is None:
                yield n, (c,)
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        for n in op.output(slot):
            if ctx.spec(n) is None and ctx.rank(n) == 1:
                yield n, (c,)


@register_rule("fill_constant", "gaussian_random", "uniform_random",
               "fill_constant_batch_size_like", "one_hot", "shape",
               "top_k")
def _rule_fresh_replicated(op, ctx):
    # value-constructor outputs (and ops whose layout we don't model)
    # default to replicated so downstream consumers see *something*
    for slot, names in op.outputs.items():
        for n in names:
            if ctx.spec(n) is None:
                yield n, ()


# ---------------------------------------------------------------------------
# zero1 collective ops and optimizer update ops
# ---------------------------------------------------------------------------
@register_rule("zero1_scatter")
def _rule_zero1_scatter(op, ctx):
    ax = op.attrs.get("axis_name", "dp")
    for n in op.output("Out"):
        if ctx.spec(n) is None:
            yield n, (ax, None)


@register_rule("zero1_gather")
def _rule_zero1_gather(op, ctx):
    for n in op.output("Out"):
        if ctx.spec(n) is None:
            yield n, ()


def _optimizer_rule(op, ctx):
    """Shared rule for update ops: every Param-shaped slot (Grad, ParamOut,
    accumulators and their outputs) carries the Param's layout; scalar
    bookkeeping (LearningRate, beta pows) is replicated."""
    p = _first(op.input("Param"))
    if p is None:
        return
    ps = ctx.spec(p)
    psh = ctx.shape(p)
    for slots in (op.inputs, op.outputs):
        for slot, names in slots.items():
            for n in names:
                if n == p or ctx.spec(n) is not None:
                    continue
                if psh is not None and ctx.shape(n) == psh:
                    if ps is not None:
                        yield n, ps
                else:
                    yield n, ()
    if ps is not None:
        for n in op.output("ParamOut"):
            if ctx.spec(n) is None:
                yield n, ps


for _t in list(ZERO1_SHARDABLE_SLOTS) + ["ftrl", "lars_momentum"]:
    _RULES.setdefault(_t, _optimizer_rule)


# ---------------------------------------------------------------------------
# engine-level defaults for unregistered ops
# ---------------------------------------------------------------------------
def grad_mirror_rule(op, ctx):
    """Generic rule for `*_grad` ops: the default grad maker emits forward
    inputs under their original slots and gradients under `{slot}@GRAD`,
    so each grad output mirrors its forward twin's layout (the gradient
    of a var lives where the var lives). This keeps param grads aligned with
    the param's seed instead of whatever activation spec happens to reach
    the grad op first."""
    for slot, gnames in op.outputs.items():
        if not slot.endswith("@GRAD"):
            continue
        fnames = op.input(slot[: -len("@GRAD")])
        for g, f in zip(gnames, fnames):
            if ctx.shape(g) != ctx.shape(f):
                continue
            gs, fs = ctx.spec(g), ctx.spec(f)
            if fs is not None and gs is None:
                yield g, fs
            elif gs is not None and fs is None:
                yield f, gs


def default_rule(op, ctx):
    """Fallback: with exactly one output, copy the spec of a same-rank
    input (and vice versa). Conservative — rank must match exactly."""
    outs = [n for ns in op.outputs.values() for n in ns]
    if len(outs) != 1:
        return
    out = outs[0]
    orr = ctx.rank(out)
    ins = [n for ns in op.inputs.values() for n in ns]
    os_ = ctx.spec(out)
    if os_ is None:
        for n in ins:
            s = ctx.spec(n)
            if s is not None and ctx.rank(n) == orr:
                yield out, s
                return
    else:
        for n in ins:
            if ctx.spec(n) is None and ctx.rank(n) == orr:
                yield n, os_
                return
