"""The data-parallel mesh: the ranks of the default process group as one
"dp" axis.

Reference contrast: the reference enumerates CUDA places and builds
NCCLContextMap per device set (platform/nccl_helper.h:75); the JAX package
names the axes of a jax.sharding.Mesh. In the port one process drives one
card, so a mesh is the process group itself: rank r of the group is
position r on "dp". Only the dp axis exists so far: a shape that gives any
other axis more than one position raises NotImplementedError (tensor,
pipeline and sequence parallelism are ROADMAP queue 1 item 5's
tensor-parallel leftover).
"""

import math

import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "data_parallel_mesh", "current_mesh",
           "mesh_scope", "mesh_geometry", "MeshSpec",
           "DP_AXIS", "MP_AXIS", "PP_AXIS", "SP_AXIS"]

DP_AXIS = "dp"   # data parallel (batch)
MP_AXIS = "mp"   # tensor/model parallel
PP_AXIS = "pp"   # pipeline stages
SP_AXIS = "sp"   # sequence/context parallel

_current = [None]


class Mesh:
    """The dp axis over the ranks of the default process group.

    `distributed` says whether the group existed when the mesh was made
    (without one: one rank, whose collectives are identities); `size` is
    the number of ranks, `rank` this process's position, `shape` {axis:
    size} (the other axes at 1). The collectives run on the default group
    itself, which the mesh does not hold: a group destroyed
    (torch.distributed.destroy_process_group) stays destroyed, and a
    collective over it raises."""

    def __init__(self, shape):
        self.distributed = dist.is_initialized()
        self.size = dist.get_world_size() if self.distributed else 1
        self.rank = dist.get_rank() if self.distributed else 0
        self.backend = dist.get_backend() if self.distributed else None
        self.shape = dict(shape)

    def __repr__(self):
        return (f"Mesh({self.shape}, rank {self.rank}, "
                f"backend {self.backend})")


def _world():
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape=None, axis_names=None, devices=None):
    """The mesh of the default group. shape: dict axis -> size or a tuple
    (named dp, mp, pp, sp in order); default: every rank on dp. The sizes
    must multiply to the world size; `devices`, if given, must hold one
    entry per rank."""
    world = _world()
    if devices is not None and len(devices) != world:
        raise ValueError(f"{len(devices)} devices for a group of {world} "
                         f"ranks: one process drives one device")
    if shape is None:
        shape = {DP_AXIS: world}
    elif not isinstance(shape, dict):
        dims = tuple(shape)
        names = tuple(axis_names or
                      (DP_AXIS, MP_AXIS, PP_AXIS, SP_AXIS)[: len(dims)])
        shape = dict(zip(names, dims))
    shape = {str(a): int(s) for a, s in shape.items()}
    other = {a: s for a, s in shape.items() if a != DP_AXIS and s > 1}
    if other:
        raise NotImplementedError(
            f"mesh axes {other}: the port's mesh has only the dp axis; "
            f"tensor, pipeline and sequence parallelism are ROADMAP queue 1 "
            f"item 5's tensor-parallel leftover")
    n = math.prod(shape.values())
    if n != world:
        raise ValueError(f"mesh shape {shape} needs {n} ranks, the group "
                         f"has {world}")
    shape.setdefault(DP_AXIS, world)
    return Mesh(shape)


def data_parallel_mesh(num_devices=None):
    if num_devices is not None and num_devices != _world():
        raise ValueError(f"a dp mesh of {num_devices} needs a group of that "
                         f"many ranks, this one has {_world()}")
    return make_mesh()


def current_mesh():
    return _current[0]


def mesh_geometry(mesh):
    """{axis: size} of a Mesh (None in -> None out)."""
    if mesh is None:
        return None
    return {str(a): int(s) for a, s in mesh.shape.items()}


class MeshSpec:
    """Re-formable mesh recipe (the JAX package's elastic-training helper):
    the non-dp axes are fixed by the model, the dp axis is whatever the
    fleet supports. In the port every fixed axis must be 1 (see the module
    docstring), and `build(dp)` needs a group of exactly `dp` ranks."""

    def __init__(self, **fixed_axes):
        self.fixed = {str(k): int(v) for k, v in fixed_axes.items()
                      if k != DP_AXIS}
        for ax, n in self.fixed.items():
            if n < 1:
                raise ValueError(f"mesh axis {ax!r} must be >= 1, got {n}")

    @property
    def fixed_size(self):
        return math.prod(self.fixed.values()) if self.fixed else 1

    def max_dp(self, devices=None):
        n = len(devices) if devices is not None else _world()
        return n // self.fixed_size

    def build(self, dp, devices=None):
        dp = int(dp)
        if dp < 1:
            raise ValueError(f"dp must be >= 1, got {dp}")
        return make_mesh(self.geometry(dp), devices=devices)

    def geometry(self, dp):
        g = {DP_AXIS: int(dp)}
        g.update(self.fixed)
        return g

    def __repr__(self):
        return f"MeshSpec(dp=<elastic>, {self.fixed})"


class mesh_scope:
    """with mesh_scope(mesh): ... — sets the ambient mesh."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        self._prev = _current[0]
        _current[0] = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        _current[0] = self._prev
        return False
