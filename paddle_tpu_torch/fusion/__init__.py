"""Cost-guided operator fusion over the Program dataflow graph.

Reference parity: the reference rewrites its SSAGraph with
framework/ir/fuse_elewise_add_act_pass (vertical: collapse elementwise
chains) and framework/details/fuse_optimizer_op_pass + its
fuse_{adam,momentum,sgd}_op_pass subclasses (horizontal: one update
kernel over contiguous gradient/parameter buffers, cf.
alloc_continuous_space_op). This package is the port's copy of the JAX
package's pass, applied by the Executor behind FLAGS_fuse.

Two pass families:

* VERTICAL — maximal single-consumer chains of elementwise ops
  (activations / scale / cast) collapse into one `fused_elementwise` op
  whose kernel replays the recorded sub-op chain through the real
  registered kernels (ops/fused_ops.py), so amp policy and dtype casts
  apply per sub-op exactly as unfused. A chain only fuses when the cost
  model says the saved HBM round-trips plus kernel-launch floors beat
  the minimum benefit: every eliminated intermediate op saves one
  write+read of its tensor at HBM bandwidth plus one launch floor.

* HORIZONTAL — all (param, grad, slot) triples of one optimizer family
  with one hyperparameter signature (same attrs, LR var, beta-pow vars,
  dtypes, shard layout) group into buckets of at most
  FLAGS_fuse_bucket_mb, each updated by ONE `fused_<opt>_update` op
  (ops/fused_ops.py: sgd and momentum pack the members into one
  contiguous f32 lane; adam updates them in place).
  zero1-aware: shard-layout members ((parts, shard) tensors produced by
  parallel.zero1) bucket along the shard axis — `shard_rows` — keeping
  dim 0 pinned to the dp axis with no regather; the members' trailing
  zero1_gather ops (each with the shard_slice a tensor-parallel lowering
  puts behind it) move with the fused op (fused update first, then the
  gathers, at the LAST member's position, where every scatter has
  already run). Unpacking is exact, so checkpoints keep their canonical
  layout.

Safety: apply() refuses (ProgramVerificationError) when the SOURCE
program carries any PTA03x hazard, re-verifies the rewritten clone
before returning it, and every bucket passes an interleave check (no
foreign op between the members reads/writes a name the rewrite moves
across it). Loss parity vs. the unfused program is bitwise — gated in
tests/test_torch_fused_update.py and tests/test_torch_train.py.
"""

import hashlib

import numpy as np

from .. import flags
from ..analysis.dataflow import check_hazards, DATAFLOW_CODES
from ..analysis.diagnostics import ProgramVerificationError, Report

__all__ = ["FusionPlan", "apply", "ELEMENTWISE_OPS", "FUSABLE_OPT",
           "LAUNCH_FLOOR_S", "HBM_BYTES_PER_S", "MIN_BENEFIT_S"]

flags.define(
    "fuse", bool, False,
    "Apply cost-guided operator fusion (paddle_tpu_torch.fusion) to the "
    "resolved program before the Executor runs it: "
    "vertical elementwise-chain fusion plus the horizontal fused "
    "bucketed weight update (one fused_<opt>_update kernel per "
    "FLAGS_fuse_bucket_mb bucket of same-family parameters). "
    "Bitwise-parity-preserving by construction.")
flags.define(
    "fuse_bucket_mb", int, 32,
    "Horizontal fusion bucket budget in MB of f32 parameter payload: "
    "one fused_<opt>_update op covers at most this much. Smaller "
    "buckets bound the concat working set of sgd and momentum; larger "
    "ones cut more per-parameter kernels.")
flags.define(
    "fuse_pallas", bool, True,
    "Accepted so scripts written for the JAX package carry over; gates "
    "nothing in the port. A fused adam/momentum bucket on a CUDA device "
    "always runs the hand-written kernel in "
    "paddle_tpu_torch.fusion.kernels (or the step raises), and one on "
    "the CPU its plain torch twin, whatever this flag says.")

# cost model: an eliminated intermediate op saves ~one kernel-launch
# floor plus one HBM write+read of its tensor. These are the JAX
# package's values, kept so both packages make the same fusion decisions;
# they are parameters of a *relative* instrument, not measured rates of
# any card — the same floor applies to every candidate, so the fuse/skip
# decision is robust to the absolute scale being off.
LAUNCH_FLOOR_S = 2e-6
HBM_BYTES_PER_S = 8.2e11
MIN_BENEFIT_S = 4e-6

# unary X -> Out elementwise ops legal inside a fused_elementwise chain
# (ops/activation_ops.py's _act family + scale + cast)
ELEMENTWISE_OPS = frozenset({
    "sigmoid", "logsigmoid", "exp", "relu", "tanh", "tanh_shrink",
    "softshrink", "hard_shrink", "sqrt", "abs", "ceil", "floor", "round",
    "cos", "sin", "reciprocal", "log", "square", "softplus", "softsign",
    "brelu", "leaky_relu", "soft_relu", "elu", "relu6", "pow", "stanh",
    "hard_sigmoid", "thresholded_relu", "swish", "gelu",
    "scale", "cast",
})

# optimizer families the horizontal pass buckets: accumulator slot pairs
# (in-place contract: input name == output name) and extra scalar inputs
# shared bucket-wide (adam's global beta-pow accumulators)
FUSABLE_OPT = {
    "sgd": {"accums": (), "extra": ()},
    "momentum": {"accums": (("Velocity", "VelocityOut"),), "extra": ()},
    "adam": {"accums": (("Moment1", "Moment1Out"),
                        ("Moment2", "Moment2Out")),
             "extra": ("Beta1Pow", "Beta2Pow")},
}

_ZERO1_UPD = "@zero1_upd"


class FusionPlan:
    """What one apply() did: the fused chains and buckets, op-count
    deltas, and a digest for the executors' compile-cache keys."""

    def __init__(self, chains, buckets, skipped, n_ops_before, n_ops_after,
                 bucket_bytes):
        self.chains = list(chains)
        self.buckets = list(buckets)
        self.skipped = list(skipped)
        self.n_ops_before = int(n_ops_before)
        self.n_ops_after = int(n_ops_after)
        self.bucket_bytes = int(bucket_bytes)

    @property
    def n_fused(self):
        return len(self.chains) + len(self.buckets)

    def digest(self):
        h = hashlib.sha1()
        h.update(repr((
            [(c["types"], c["vars"]) for c in self.chains],
            [(b["opt"], b["params"], b["shard_rows"]) for b in self.buckets],
            self.bucket_bytes, self.n_ops_before, self.n_ops_after,
        )).encode())
        return h.hexdigest()[:16]

    def to_dict(self):
        return {
            "n_chains": len(self.chains),
            "n_buckets": len(self.buckets),
            "n_ops_before": self.n_ops_before,
            "n_ops_after": self.n_ops_after,
            "bucket_bytes": self.bucket_bytes,
            "chains": [dict(c) for c in self.chains],
            "buckets": [dict(b) for b in self.buckets],
            "skipped": list(self.skipped),
            "digest": self.digest(),
        }


def _require_hazard_free(program, feed_names, what):
    report = Report(level="full", context=f"fusion-{what}")
    check_hazards(program, report, feed_names=feed_names)
    if any(d.code in DATAFLOW_CODES for d in report.errors()):
        raise ProgramVerificationError(report)


def _nominal_numel(shape):
    """Static element count with -1 (dynamic batch) dims taken at a
    nominal 128 — the cost model needs a magnitude, not an exact count."""
    if not shape:
        return 0
    n = 1
    for d in shape:
        n *= 128 if d in (-1, None) else int(d)
    return n


def _chain_benefit_s(length, numel, itemsize):
    """Seconds saved by collapsing a `length`-op chain: each eliminated
    boundary saves one launch floor + one HBM write+read round-trip."""
    saved_bytes = (length - 1) * numel * itemsize * 2
    return (length - 1) * LAUNCH_FLOOR_S + saved_bytes / HBM_BYTES_PER_S


# ---------------------------------------------------------------------------
# vertical pass: elementwise chains
# ---------------------------------------------------------------------------
def _fuse_elementwise(clone, feed_names, fetch_names):
    from ..core.framework import Operator

    gb = clone.global_block()
    ops = gb.ops
    op_types = {op.type for b in clone.blocks for op in b.ops}
    pinned = set(feed_names) | set(fetch_names)

    def eligible(i):
        op = ops[i]
        if op.type not in ELEMENTWISE_OPS:
            return False
        if op.type + "_grad" in op_types:
            # consuming the last forward op of a type that still has
            # grad ops would break PTA007 type-level grad pairing (and
            # the chain's backward); vertical fusion targets inference
            return False
        ins = {s for s, n in op.inputs.items() if n}
        outs = {s for s, n in op.outputs.items() if n}
        return (ins == {"X"} and outs == {"Out"}
                and len(op.inputs["X"]) == 1 and len(op.outputs["Out"]) == 1)

    reads = {}
    for b in clone.blocks:
        for op in b.ops:
            for names in op.inputs.values():
                for nm in names:
                    reads[nm] = reads.get(nm, 0) + 1
    gb_reader = {}   # var -> unique global-block reader idx (if any)
    for i, op in enumerate(ops):
        for names in op.inputs.values():
            for nm in names:
                gb_reader[nm] = i if nm not in gb_reader else None
    produced = {}
    multi_prod = set()
    for b in clone.blocks:
        for op in b.ops:
            for names in op.outputs.values():
                for nm in names:
                    if nm in produced:
                        multi_prod.add(nm)
                    produced[nm] = True

    def fusable_edge(out_name):
        """Can the chain continue THROUGH out_name (kill it)?"""
        v = gb.vars.get(out_name)
        if v is None or getattr(v, "persistable", False) \
                or getattr(v, "is_data", False):
            return None
        if out_name in pinned or out_name in multi_prod:
            return None
        if reads.get(out_name, 0) != 1:
            return None
        return gb_reader.get(out_name)

    chains, used, dead_vars = [], set(), []
    for i in range(len(ops)):
        if i in used or not eligible(i):
            continue
        chain = [i]
        cur = i
        while True:
            nxt = fusable_edge(ops[cur].outputs["Out"][0])
            if nxt is None or nxt in used or nxt <= cur \
                    or not eligible(nxt):
                break
            chain.append(nxt)
            cur = nxt
        if len(chain) < 2:
            continue
        mid = gb.vars.get(ops[chain[0]].outputs["Out"][0])
        numel = _nominal_numel(getattr(mid, "shape", None))
        itemsize = np.dtype(getattr(mid, "dtype", "float32")).itemsize
        benefit = _chain_benefit_s(len(chain), numel, itemsize)
        if benefit < MIN_BENEFIT_S:
            continue
        used.update(chain)
        head, tail = ops[chain[0]], ops[chain[-1]]
        fused = Operator(
            gb, "fused_elementwise",
            {"X": [head.inputs["X"][0]]},
            {"Out": [tail.outputs["Out"][0]]},
            {"sub_types": [ops[j].type for j in chain],
             "sub_attrs": [{k: v for k, v in ops[j].attrs.items()
                            if not k.startswith("op_")} for j in chain],
             "op_role": head.attrs.get("op_role", 0)})
        dead_vars.extend(ops[j].outputs["Out"][0] for j in chain[:-1])
        chains.append({
            "op": fused, "first": chain[0], "drop": chain[1:],
            "types": [ops[j].type for j in chain],
            "vars": [head.inputs["X"][0], tail.outputs["Out"][0]],
            "benefit_us": round(benefit * 1e6, 3),
        })
    if chains:
        replace = {c["first"]: c["op"] for c in chains}
        drop = {j for c in chains for j in c["drop"]}
        gb.ops = [replace.get(i, op) for i, op in enumerate(ops)
                  if i not in drop]
        for nm in dead_vars:
            gb.vars.pop(nm, None)
    for c in chains:  # the Operator handle was only needed for the rewrite
        del c["op"], c["first"], c["drop"]
    return chains


# ---------------------------------------------------------------------------
# horizontal pass: fused bucketed weight update
# ---------------------------------------------------------------------------
def sparse_grad_names(ops):
    """Names that hold a SelectedRows at run time: the W@GRAD of an
    is_sparse lookup_table_grad, and a sum or scale of such names only
    (math_ops: all-sparse sums stay sparse). An update whose Grad is one
    stays on the per-op path, as the JAX package's FLAGS_fuse leaves it
    (paddle_tpu/core/executor_core.py:160-171, which finds it by value)."""
    sparse = set()
    for op in ops:
        if op.type == "lookup_table_grad" and op.attrs.get("is_sparse"):
            sparse.update(op.output("W@GRAD"))
        elif op.type in ("sum", "scale") and op.input("X") and all(
                n in sparse for n in op.input("X")):
            sparse.update(op.output("Out"))
    return sparse


def _member_of(gb, i, op, fam, sparse):
    """Member descriptor for optimizer op `op`, or None if ineligible (a
    Grad of `sparse`, a SelectedRows, among them)."""
    from ..core.framework import VarType

    def one(slots, name):
        v = slots.get(name) or []
        return v[0] if len(v) == 1 and v[0] else None

    pname, gname = one(op.inputs, "Param"), one(op.inputs, "Grad")
    lr, pout = one(op.inputs, "LearningRate"), one(op.outputs, "ParamOut")
    if not (pname and gname and lr and pout) or gname in sparse:
        return None
    pvar, gvar = gb.vars.get(pname), gb.vars.get(gname)
    if pvar is None or pvar.shape is None or any(
            d is None or d < 0 for d in pvar.shape or ()):
        return None
    if getattr(pvar, "type", None) == VarType.SELECTED_ROWS:
        return None
    if gvar is not None and (getattr(gvar, "type", None)
                             == VarType.SELECTED_ROWS
                             or getattr(gvar, "lod_level", 0)):
        return None
    sharded = pout.endswith(_ZERO1_UPD)
    if sharded:
        if len(pvar.shape) != 2:
            return None
        rows = int(pvar.shape[0])
    else:
        if pout != pname:  # not the in-place update wiring we replay
            return None
        rows = 0
    accums = []
    for in_slot, out_slot in fam["accums"]:
        a_in = one(op.inputs, in_slot)
        a_out = one(op.outputs, out_slot)
        avar = gb.vars.get(a_in) if a_in else None
        if not a_in or a_in != a_out or avar is None \
                or tuple(avar.shape or ()) != tuple(pvar.shape):
            return None
        accums.append((in_slot, a_in, str(avar.dtype)))
    extra = []
    for slot in fam["extra"]:
        nm = one(op.inputs, slot)
        if not nm:
            return None
        extra.append((slot, nm))
    sig = tuple(sorted((k, repr(v)) for k, v in op.attrs.items()
                       if not k.startswith("op_")))
    key = (op.type, sig, lr, tuple(nm for _, nm in extra),
           str(pvar.dtype), tuple(dt for _, _, dt in accums), rows)
    return {
        "idx": i, "op": op, "key": key, "pname": pname, "pout": pout,
        "gname": gname, "lr": lr, "accums": accums, "extra": extra,
        "rows": rows, "numel": int(np.prod(pvar.shape)),
        "base": pout[:-len(_ZERO1_UPD)] if sharded else pname,
    }


def _find_gather(ops, m):
    """Indices of the zero1_gather consuming this member's @zero1_upd,
    and of the shard_slice right behind it that keeps this rank's block
    of a param the tensor-parallel lowering shards over mp (parallel/
    autoshard/lower.py), which moves with it; None without a gather."""
    for k in range(m["idx"] + 1, len(ops)):
        op = ops[k]
        if op.type == "zero1_gather" \
                and (op.inputs.get("X") or [None])[0] == m["pout"]:
            nxt = ops[k + 1] if k + 1 < len(ops) else None
            if nxt is not None and nxt.type == "shard_slice" \
                    and nxt.inputs.get("X") == op.outputs.get("Out"):
                return [k, k + 1]
            return [k]
    return None


def _interleave_safe(ops, members, gather_idxs):
    """No foreign op between the bucket's members may interact with a
    name the rewrite moves across it: the fused update runs at the LAST
    member's position and the gathers move right behind it."""
    member_idxs = [m["idx"] for m in members]
    last = max(member_idxs)
    span_end = max(gather_idxs) if gather_idxs else last
    moved = set(member_idxs) | set(gather_idxs)
    in_pos = {}
    for m in members:
        for nm in ([m["pname"], m["gname"], m["lr"]]
                   + [nm for _, nm, _ in m["accums"]]
                   + [nm for _, nm in m["extra"]]):
            in_pos[nm] = min(in_pos.get(nm, m["idx"]), m["idx"])
    pouts = {m["pout"] for m in members}
    gather_outs = {(ops[k].outputs.get("Out") or [None])[0]
                   for k in gather_idxs}
    # each moved gather's output -> the gather's index before the move
    gathered_at = {(ops[k].outputs.get("Out") or [None])[0]: k
                   for k in gather_idxs}
    for k in range(min(member_idxs), span_end + 1):
        if k in moved:
            continue
        op = ops[k]
        w = {nm for names in op.outputs.values() for nm in names}
        r = {nm for names in op.inputs.values() for nm in names}
        if k < last:
            # writes to a member input would now be seen by the fused op
            if any(in_pos.get(nm, k + 1) < k for nm in w):
                return False
            # the member outputs don't exist yet at this position, nor
            # the outputs of a gather that ran before it and now moves
            if (r | w) & pouts or any(
                    gathered_at.get(nm, k) < k for nm in r | w):
                return False
        else:
            # the moved gathers now run BEFORE this op
            if (r | w) & gather_outs:
                return False
    return True


def _fuse_optimizers(clone, bucket_bytes):
    from ..core.framework import Operator

    gb = clone.global_block()
    ops = gb.ops
    groups, seen, skipped = {}, set(), []
    sparse = sparse_grad_names(ops)
    for i, op in enumerate(ops):
        fam = FUSABLE_OPT.get(op.type)
        if fam is None:
            continue
        m = _member_of(gb, i, op, fam, sparse)
        if m is None:
            skipped.append(((op.inputs.get("Param") or ["?"])[0],
                            "wiring outside the fusable contract"))
            continue
        if m["pname"] in seen or m["pout"] in seen:
            skipped.append((m["base"], "param updated more than once"))
            continue
        seen.update((m["pname"], m["pout"]))
        groups.setdefault(m["key"], []).append(m)

    inserts, drops, buckets = {}, set(), []
    for key, members in groups.items():
        opt_type, rows = key[0], key[-1]
        fam = FUSABLE_OPT[opt_type]
        # split into buckets by cumulative f32 payload, in program order
        cur, size = [], 0
        parts = []
        for m in members:
            if cur and size + m["numel"] * 4 > bucket_bytes:
                parts.append(cur)
                cur, size = [], 0
            cur.append(m)
            size += m["numel"] * 4
        if cur:
            parts.append(cur)
        for bucket in parts:
            if len(bucket) < 2:
                continue
            gather_idxs = []
            if rows:
                gs = [_find_gather(ops, m) for m in bucket]
                if any(g is None for g in gs):
                    skipped.append((bucket[0]["base"],
                                    "zero1 member without its gather"))
                    continue
                gather_idxs = [k for g in gs for k in g]
            if not _interleave_safe(ops, bucket, gather_idxs):
                skipped.append((bucket[0]["base"],
                                "unsafe op interleave inside the bucket"))
                continue
            first = bucket[0]["op"]
            ins = {"Param": [m["pname"] for m in bucket],
                   "Grad": [m["gname"] for m in bucket],
                   "LearningRate": [bucket[0]["lr"]]}
            outs = {"ParamOut": [m["pout"] for m in bucket]}
            for s_i, (in_slot, out_slot) in enumerate(fam["accums"]):
                ins[in_slot] = [m["accums"][s_i][1] for m in bucket]
                outs[out_slot] = [m["accums"][s_i][1] for m in bucket]
            for s_i, slot in enumerate(fam["extra"]):
                ins[slot] = [bucket[0]["extra"][s_i][1]]
            attrs = {k: v for k, v in first.attrs.items()
                     if not k.startswith("op_")}
            attrs["shard_rows"] = int(rows)
            attrs["op_role"] = first.attrs.get("op_role", 0)
            role_vars = []
            for m in bucket:
                role_vars.extend(m["op"].attrs.get("op_role_var", []))
            if role_vars:
                attrs["op_role_var"] = role_vars
            fused = Operator(gb, f"fused_{opt_type}_update",
                             ins, outs, attrs)
            last = max(m["idx"] for m in bucket)
            inserts[last] = [fused] + [ops[k] for k in sorted(gather_idxs)]
            drops.update(m["idx"] for m in bucket)
            drops.update(gather_idxs)
            buckets.append({
                "opt": opt_type, "n": len(bucket),
                "params": [m["base"] for m in bucket],
                "numel": sum(m["numel"] for m in bucket),
                "bytes": sum(m["numel"] for m in bucket) * 4,
                "shard_rows": int(rows),
            })
    if inserts:
        new_ops = []
        for i, op in enumerate(ops):
            if i in inserts:
                new_ops.extend(inserts[i])
            if i not in drops:
                new_ops.append(op)
        gb.ops = new_ops
    return buckets, skipped


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------
def apply(program, feed_names=None, fetch_names=None, bucket_bytes=None):
    """Fuse `program` on a clone. Returns (program, None) when nothing
    fuses, else (fused_clone, FusionPlan). Refuses hazardous source
    programs and re-verifies the rewritten clone — a rewrite that
    introduces any PTA03x hazard raises instead of shipping."""
    if bucket_bytes is None:
        bucket_bytes = flags.get("fuse_bucket_mb") << 20
    feed_names = list(feed_names or [])
    _require_hazard_free(program, feed_names, "source")
    clone = program.clone()
    n_before = len(clone.global_block().ops)
    chains = _fuse_elementwise(clone, feed_names, list(fetch_names or []))
    buckets, skipped = _fuse_optimizers(clone, int(bucket_bytes))
    if not chains and not buckets:
        return program, None
    clone._mutation += 1
    plan = FusionPlan(chains, buckets, skipped, n_before,
                      len(clone.global_block().ops), bucket_bytes)
    _require_hazard_free(clone, feed_names, "fused")
    return clone, plan
