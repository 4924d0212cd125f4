"""PartitionSpec normalization and seed validation (the JAX package's
parallel/autoshard/spec.py, without jax.sharding.PartitionSpec).

A sharding spec is a tuple with one entry per tensor dim: a mesh-axis
name (str) to shard that dim, or None to replicate it. A spec shorter
than the rank leaves trailing dims replicated. This module accepts the
looser user-facing forms (bare axis string, any iterable of entries
such as a PartitionSpec-like object, 1-element per-dim tuples) and
canonicalizes them, and validates seed annotations against a mesh
*before* any step is prepared.
"""

__all__ = [
    "normalize_spec", "canon", "pad_spec", "validate_seed_spec",
    "spec_str",
]


def normalize_spec(spec):
    """Canonicalize a user-supplied spec to a tuple of str|None.

    Accepts:
      * a bare mesh-axis name string — shorthand for sharding dim 0
      * any iterable of entries (a PartitionSpec-like object included,
        iterated positionally), each a str, None, or a 1-element
        tuple/list wrapping a str (the per-dim tuple form)

    Raises TypeError for anything else, including multi-axis-per-dim
    entries, which are not supported.
    """
    if isinstance(spec, str):
        return (spec,)
    try:
        entries = tuple(spec)
    except TypeError:
        raise TypeError(
            f"sharding spec must be a mesh-axis name, a PartitionSpec, or "
            f"a tuple of axis-name/None entries, got {spec!r}") from None
    out = []
    for e in entries:
        if e is None or isinstance(e, str):
            out.append(e)
        elif (isinstance(e, (tuple, list)) and len(e) == 1
              and isinstance(e[0], str)):
            out.append(e[0])  # ("mp",) per dim; unwrap it
        else:
            raise TypeError(
                f"spec entries must be mesh-axis names or None, got {e!r}"
                + (" (multiple mesh axes per dim are not supported)"
                   if isinstance(e, (tuple, list)) else ""))
    return tuple(out)


def canon(spec):
    """Canonical comparison form: trim trailing Nones (trailing dims are
    replicated either way), so ('dp', None) == ('dp',) == ('dp',)."""
    if spec is None:
        return None
    spec = tuple(spec)
    n = len(spec)
    while n and spec[n - 1] is None:
        n -= 1
    return spec[:n]


def pad_spec(spec, rank):
    """Pad with trailing Nones to `rank` entries (for display/lowering)."""
    spec = tuple(spec)
    return spec + (None,) * max(0, rank - len(spec))


def spec_str(spec):
    if spec is None:
        return "?"
    if not canon(spec):
        return "replicated"
    return "(" + ", ".join(a if a is not None else "None"
                           for a in tuple(spec)) + ")"


def validate_seed_spec(name, spec, shape, mesh_axes):
    """Validate one seed annotation against the mesh. Raises ValueError
    with the var name, the spec, and the mesh axes in the message —
    this runs at plan-construction time, before any step is prepared.

    `mesh_axes` is a {axis_name: size} dict. Dynamic dims (None/-1) are
    skipped for divisibility — the runtime shape check in the executor
    remains authoritative for those.
    """
    spec = tuple(spec)
    rank = None if shape is None else len(shape)
    if rank is not None and len(spec) > rank:
        raise ValueError(
            f"variable {name!r}: sharding spec {spec_str(spec)} is longer "
            f"than its rank {rank} (shape {tuple(shape)})")
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        if ax not in mesh_axes:
            raise ValueError(
                f"variable {name!r}: sharding spec {spec_str(spec)} names "
                f"mesh axis {ax!r} which is not in the mesh "
                f"(axes: {sorted(mesh_axes)})")
        size = int(mesh_axes[ax])
        if shape is None:
            continue
        dim = shape[d]
        if dim is None or int(dim) < 0:
            continue  # dynamic dim: runtime check is authoritative
        if int(dim) % size != 0:
            raise ValueError(
                f"variable {name!r}: dim {d} of shape {tuple(shape)} is "
                f"not divisible by mesh axis {ax!r} (size {size}) for "
                f"spec {spec_str(spec)}")
