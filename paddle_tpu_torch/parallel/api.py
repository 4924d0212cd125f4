"""User-facing sharding rules: declare how a Program variable is laid out
over the device mesh (the JAX package's parallel/api.py).

These are pure annotations on the IR: `set_sharding` records a spec on a
Variable, `sharding_scope` seeds every parameter built inside a block.
The port's ParallelExecutor runs the dp axis only, so a spec naming
another axis is carried in the Program but placed by nothing yet (ROADMAP
queue 1 item 5's tensor-parallel leftover); zero1 leaves an annotated
parameter on the replicated path, as in the JAX package.

    fluid.parallel.set_sharding(w, (None, "mp"))   # shard columns over mp
    fluid.parallel.set_sharding(w2, "mp")          # bare axis: shard dim 0
    with fluid.parallel.sharding_scope((None, "mp")):
        h = fluid.layers.fc(x, 256)   # weight gets (None, "mp")
"""

import contextlib

from ..core import framework
from ..core.framework import Variable

__all__ = ["set_sharding", "get_sharding", "sharding_scope",
           "normalize_spec"]


def normalize_spec(spec):
    """Canonicalize a user-supplied spec to a tuple of str|None: a bare
    mesh-axis name shards dim 0; any iterable of entries, each a str, None
    or a 1-element tuple/list wrapping a str, is taken positionally (a
    PartitionSpec-like object included). Raises TypeError for anything
    else, multi-axis-per-dim entries included."""
    if isinstance(spec, str):
        return (spec,)
    try:
        entries = tuple(spec)
    except TypeError:
        raise TypeError(
            f"sharding spec must be a mesh-axis name or a tuple of "
            f"axis-name/None entries, got {spec!r}") from None
    out = []
    for e in entries:
        if e is None or isinstance(e, str):
            out.append(e)
        elif (isinstance(e, (tuple, list)) and len(e) == 1
              and isinstance(e[0], str)):
            out.append(e[0])
        else:
            raise TypeError(
                f"spec entries must be mesh-axis names or None, got {e!r}"
                + (" (multiple mesh axes per dim are not supported)"
                   if isinstance(e, (tuple, list)) else ""))
    return tuple(out)


def set_sharding(var, spec):
    """Declare `var`'s mesh placement. spec: one entry per tensor dim — a
    mesh axis name (str) to shard that dim, or None to replicate it. A
    spec shorter than the rank leaves trailing dims replicated."""
    if not isinstance(var, Variable):
        raise TypeError(f"set_sharding expects a Variable, got {type(var)}")
    spec = normalize_spec(spec)
    if var.shape is not None and len(spec) > len(var.shape):
        raise ValueError(
            f"spec {spec} longer than {var.name}'s rank {len(var.shape)}")
    var.sharding = spec
    return var


def get_sharding(var):
    return getattr(var, "sharding", None)


@contextlib.contextmanager
def sharding_scope(spec):
    """Seed-annotate every parameter created inside the block with `spec`
    (truncated to each param's rank; params whose truncated spec names no
    mesh axis are left alone, as are params already annotated). Scopes
    nest; the innermost one wins."""
    spec = normalize_spec(spec)

    def hook(param):
        if getattr(param, "sharding", None) is not None:
            return
        rank = len(param.shape) if param.shape is not None else 0
        trimmed = spec[:rank]
        if any(e is not None for e in trimmed):
            param.sharding = tuple(trimmed)

    framework._param_creation_hooks.append(hook)
    try:
        yield
    finally:
        framework._param_creation_hooks.remove(hook)
