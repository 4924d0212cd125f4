"""ShardingPlan: the total var -> PartitionSpec assignment plus the
bookkeeping the rest of the stack consumes — conflict/reshard edges with
an analytic collective-bytes estimate (same ring model as
zero1.Zero1Plan.collective_bytes), a stable digest for the prepared
step's key and checkpoint manifests, and the boundary set: the sharded
vars whose layout the port's partitioner (lower.py) makes local.

A copy of the JAX package's parallel/autoshard/plan.py: describe() and
digest() give what the JAX package's give for the same program and mesh.
mesh_axes is a plain {axis_name: size} dict — not a device mesh — so
plans can be built and rendered (CLI `shard plan`) on a host with no
card and no process group.
"""

import hashlib
import json

from .spec import canon, spec_str

__all__ = ["ShardingPlan", "transition_bytes"]

_DTYPE_BYTES = {
    "float64": 8, "int64": 8, "uint64": 8,
    "float32": 4, "int32": 4, "uint32": 4,
    "float16": 2, "bfloat16": 2, "int16": 2, "uint16": 2,
    "int8": 1, "uint8": 1, "bool": 1,
}

# spec assignment sources, in increasing override priority
SRC_DEFAULT = "default"        # finalize(): nothing reached it -> replicated
SRC_DERIVED = "derived"        # produced by a propagation rule
SRC_GRAD = "grad-link"         # copied across the fwd/grad var linkage
SRC_RESOLVED = "conflict"      # winner of a cost-arbitrated conflict
SRC_FEED = "feed"              # batch-axis seed on a data var
SRC_SEED = "seed"              # user annotation (locked)

_PRIORITY = {SRC_DEFAULT: 0, SRC_DERIVED: 1, SRC_GRAD: 1,
             SRC_RESOLVED: 2, SRC_FEED: 3, SRC_SEED: 4}


def _axes_factor(spec, mesh_axes):
    n = 1
    for ax in canon(spec) or ():
        if ax is not None:
            n *= int(mesh_axes.get(ax, 1))
    return n


def _numel(shape, mesh_axes):
    """Static element count; dynamic dims substitute the mesh device count
    as a nominal per-axis batch so estimates stay comparable across vars."""
    if not shape:
        return 1
    nominal = 1
    for s in mesh_axes.values():
        nominal *= int(s)
    n = 1
    for d in shape:
        d = -1 if d is None else int(d)
        n *= nominal if d < 0 else d
    return n


def transition_bytes(shape, dtype, src_spec, dst_spec, mesh_axes):
    """Estimated per-device ring-collective bytes to move one array from
    layout src_spec to dst_spec (zero1's model: all_gather and
    reduce_scatter cost (N-1)/N * bytes; a slice of a replicated array is
    free; mixed resharding is approximated as an all-to-all at the same
    (N-1)/N rate over the union of the involved axes)."""
    a, b = canon(src_spec) or (), canon(dst_spec) or ()
    if a == b:
        return 0
    itot = _numel(shape, mesh_axes) * _DTYPE_BYTES.get(str(dtype), 4)
    if not a:
        return 0  # replicated -> sharded: local slice, no comms
    axes = {ax for ax in a + b if ax is not None}
    n = 1
    for ax in axes:
        n *= int(mesh_axes.get(ax, 1))
    if n <= 1:
        return 0
    return int(itot * (n - 1) / n)


class ShardingPlan:
    def __init__(self, mesh_axes, batch_axis=None):
        self.mesh_axes = {str(k): int(v) for k, v in dict(mesh_axes).items()}
        self.batch_axis = batch_axis
        self.specs = {}        # name -> canonical spec tuple
        self.sources = {}      # name -> SRC_* tag
        self.shapes = {}       # name -> static shape tuple (or None)
        self.dtypes = {}       # name -> dtype string
        self.conflicts = []    # resolved conflicts (dicts)
        self.reshard_edges = []  # forced layout changes (dicts)
        self.unresolved = []   # locked-vs-locked contradictions (names)
        self.iterations = 0

    # -- queries ----------------------------------------------------------
    def spec_of(self, name):
        return self.specs.get(name)

    def source_of(self, name):
        return self.sources.get(name, SRC_DEFAULT)

    def is_total(self):
        return not self.unresolved and all(
            s is not None for s in self.specs.values())

    def sharded_names(self):
        return {n for n, s in self.specs.items() if canon(s)}

    def boundary_specs(self):
        """{name: spec} of the genuinely sharded vars: the ones the
        lowering (lower.py) gives a local layout; replicated ones are
        whole on every rank."""
        return {n: s for n, s in self.specs.items() if canon(s)}

    def reshard_bytes_per_step(self):
        return sum(int(e.get("bytes", 0)) for e in self.reshard_edges) + \
            sum(int(c.get("reshard_bytes", 0)) for c in self.conflicts)

    # -- identity ---------------------------------------------------------
    def digest(self):
        body = {
            "mesh": sorted(self.mesh_axes.items()),
            "specs": sorted((n, list(canon(s) or ()))
                            for n, s in self.specs.items()),
        }
        blob = json.dumps(body, sort_keys=True).encode()
        return hashlib.sha1(blob).hexdigest()[:16]

    # -- reporting --------------------------------------------------------
    def describe(self):
        return {
            "mesh_axes": dict(self.mesh_axes),
            "digest": self.digest(),
            "n_vars": len(self.specs),
            "n_sharded": len(self.sharded_names()),
            "n_conflicts": len(self.conflicts),
            "n_reshard_edges": len(self.reshard_edges),
            "unresolved": list(self.unresolved),
            "total": self.is_total(),
            "iterations": self.iterations,
            "reshard_bytes_per_step": self.reshard_bytes_per_step(),
            "specs": {n: list(canon(s) or ())
                      for n, s in sorted(self.specs.items())},
            "sources": dict(sorted(self.sources.items())),
            "conflicts": list(self.conflicts),
            "reshard_edges": list(self.reshard_edges),
        }

    def render(self, verbose=True):
        mesh = "×".join(f"{k}={v}" for k, v in self.mesh_axes.items())
        lines = [f"autoshard plan  mesh[{mesh}]  digest {self.digest()}",
                 f"  vars {len(self.specs)}  sharded "
                 f"{len(self.sharded_names())}  conflicts "
                 f"{len(self.conflicts)}  reshard "
                 f"~{self.reshard_bytes_per_step()} B/step  "
                 f"total={self.is_total()}"]
        if verbose:
            w = max((len(n) for n in self.specs), default=4)
            for n in sorted(self.specs):
                shp = self.shapes.get(n)
                shp = "?" if shp is None else str(tuple(shp))
                lines.append(
                    f"  {n:<{w}}  {shp:<18} "
                    f"{spec_str(self.specs[n]):<16} "
                    f"[{self.source_of(n)}]")
        for c in self.conflicts:
            lines.append(
                f"  conflict {c['var']}: kept {spec_str(c['kept'])} "
                f"over {spec_str(c['dropped'])} (op {c.get('op')}, "
                f"~{c.get('reshard_bytes', 0)} B)")
        for e in self.reshard_edges:
            lines.append(
                f"  reshard  {e['var']}: {spec_str(e['src'])} -> "
                f"{spec_str(e['dst'])} (op {e.get('op')}, "
                f"~{e.get('bytes', 0)} B)")
        for n in self.unresolved:
            lines.append(f"  UNRESOLVED {n}")
        return "\n".join(lines)
