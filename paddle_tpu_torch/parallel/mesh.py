"""The device mesh: the ranks of the default process group laid out on
named axes, dp, mp, pp and sp.

Reference contrast: the reference enumerates CUDA places and builds
NCCLContextMap per device set (platform/nccl_helper.h:75); the JAX package
names the axes of a jax.sharding.Mesh. In the port one process drives one
card, so a mesh is the process group itself, its ranks in row-major order
over the axes (the JAX package's `np.array(devices).reshape(dims)`): the
axes a shape names, in the order it names them. Each axis of more than
one rank has its rank, its size and a torch.distributed group of the
ranks along it through this one (`Mesh.axis`). The dp axis carries the
data-parallel collectives, pp the pipeline's boundary ops and sp ring
attention's permutes. An mp axis of more than one rank raises
NotImplementedError: tensor parallelism is ROADMAP queue 1 item 6.
"""

import math

import torch.distributed as dist

from . import distributed as _distributed

__all__ = ["Mesh", "MeshAxis", "make_mesh", "data_parallel_mesh",
           "current_mesh", "mesh_scope", "mesh_geometry", "MeshSpec",
           "DP_AXIS", "MP_AXIS", "PP_AXIS", "SP_AXIS"]

DP_AXIS = "dp"   # data parallel (batch)
MP_AXIS = "mp"   # tensor/model parallel
PP_AXIS = "pp"   # pipeline stages
SP_AXIS = "sp"   # sequence/context parallel

_current = [None]


class MeshAxis:
    """One axis of a mesh as this rank sees it: `size` ranks, this rank at
    position `rank`, `ranks` the global ranks along the axis in position
    order, `group` their torch.distributed group (None: the default group,
    when the axis spans it), whose backend is `backend`."""

    __slots__ = ("name", "size", "rank", "ranks", "group", "backend")

    def __init__(self, name, size, rank, ranks, group, backend):
        self.name, self.size, self.rank = name, size, rank
        self.ranks, self.group, self.backend = tuple(ranks), group, backend

    def global_rank(self, position):
        """The global rank at `position` on this axis."""
        return self.ranks[position % self.size]

    def __repr__(self):
        return (f"MeshAxis({self.name!r}, {self.rank} of {self.size}, "
                f"ranks {list(self.ranks)}, {self.backend})")


class Mesh:
    """The default process group laid out on the axes of `shape`.

    `distributed` says whether the group existed when the mesh was made
    (without one: one rank, whose collectives are identities);
    `world_rank` is this process's rank in it; `size`, `rank` and
    `group` are the dp axis's (its size, this rank's position on it, its
    group: None when dp spans the default group), which the dp
    collectives run over; `shape` is {axis: size}. A group destroyed
    (torch.distributed.destroy_process_group) stays destroyed, and a
    collective over it raises. `generation` is the group formation the
    mesh was made under (distributed.generation()): after an elastic
    re-form the mesh is stale and `check_live` raises."""

    def __init__(self, shape, axes=None):
        self.distributed = dist.is_initialized()
        self.generation = _distributed.generation() if self.distributed \
            else None
        self.world_rank = dist.get_rank() if self.distributed else 0
        self.backend = dist.get_backend() if self.distributed else None
        self.shape = dict(shape)
        self.axes = dict(axes or {})
        dp = self.axes.get(DP_AXIS)
        self.size = dp.size if dp is not None else 1
        self.rank = dp.rank if dp is not None else 0
        self.group = dp.group if dp is not None else None

    def check_live(self):
        """Raise where the group this mesh spans is gone: destroyed, or
        re-formed since (an elastic resize). A mesh without a group is
        always live."""
        if not self.distributed:
            return
        if not dist.is_initialized() \
                or _distributed.generation() != self.generation:
            raise RuntimeError(
                f"{self!r} spans a process group that was destroyed or "
                f"re-formed (group formation {self.generation}, now "
                f"{_distributed.generation()}): after an elastic resize, "
                f"make the ParallelExecutor (and its mesh) anew")

    def axis(self, name):
        """The MeshAxis `name`, or None where the axis has one rank or is
        not in the mesh (there its collectives are identities)."""
        ax = self.axes.get(name)
        return ax if ax is not None and ax.size > 1 else None

    def __repr__(self):
        return (f"Mesh({self.shape}, rank {self.world_rank}, "
                f"backend {self.backend})")


def _world():
    return dist.get_world_size() if dist.is_initialized() else 1


def _axis_groups(shape):
    """{axis: MeshAxis} for this rank. Every rank makes every group of
    every axis of more than one rank that does not span the world, in one
    order (torch.distributed.new_group is a collective of the default
    group), and keeps the one it is on; an axis that spans the world runs
    on the default group. Every group has the default group's backend."""
    names, dims = list(shape), [shape[a] for a in shape]
    world, me = _world(), dist.get_rank() if dist.is_initialized() else 0
    backend = dist.get_backend() if dist.is_initialized() else None
    coords, rest = [], me
    for d in reversed(dims):
        coords.append(rest % d)
        rest //= d
    coords.reverse()
    strides = [math.prod(dims[k + 1:]) for k in range(len(dims))]
    axes = {}
    for k, name in enumerate(names):
        size = dims[k]
        mine = [me + (i - coords[k]) * strides[k] for i in range(size)]
        group = None
        if 1 < size < world:
            for base in range(world):
                if (base // strides[k]) % size:
                    continue  # not the first rank of a line along k
                ranks = [base + i * strides[k] for i in range(size)]
                g = dist.new_group(ranks)
                if ranks == mine:
                    group = g
        axes[name] = MeshAxis(name, size, coords[k], mine, group, backend)
    return axes


def make_mesh(shape=None, axis_names=None, devices=None):
    """The mesh of the default group. shape: dict axis -> size or a tuple
    (named dp, mp, pp, sp in order); default: every rank on dp. The sizes
    must multiply to the world size; `devices`, if given, must hold one
    entry per rank. An mp axis of more than one rank raises
    NotImplementedError."""
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
    if shape.get(MP_AXIS, 1) > 1:
        raise NotImplementedError(
            f"mesh axis mp={shape[MP_AXIS]}: the port's mesh has no "
            f"tensor-parallel axis yet (ROADMAP queue 1 item 6)")
    unknown = set(shape) - {DP_AXIS, MP_AXIS, PP_AXIS, SP_AXIS}
    if unknown:
        raise ValueError(f"mesh axes {sorted(unknown)}: the axes are dp, "
                         f"mp, pp and sp")
    n = math.prod(shape.values())
    if n != world:
        raise ValueError(f"mesh shape {shape} needs {n} ranks, the group "
                         f"has {world}")
    shape.setdefault(DP_AXIS, 1)
    return Mesh(shape, _axis_groups(shape))


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
    fleet supports. In the port mp must be 1 (see the module docstring),
    and `build(dp)` needs a group of dp times the fixed axes' ranks."""

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
