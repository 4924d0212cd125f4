"""paddle_tpu_torch.parallel.autoshard — GSPMD-style sharding propagation
and the port's partitioner.

Seed a handful of params with `parallel.set_sharding` (or wrap layer
construction in `parallel.sharding_scope`), and autoshard produces a
*total* ShardingPlan assigning every Program variable — params,
activations, grads, optimizer slots — a PartitionSpec over the mesh
(spec, plan, rules, propagate and search: the JAX package's modules).
The JAX package hands the plan to XLA's SPMD partitioner; the port has
none, so `lower.py` writes each rank's program itself: local shapes,
local kernels, and explicit collectives over the mesh's `mp` axis.
ParallelExecutor lowers the plan whenever the mesh has an mp axis of
more than one rank, and with `FLAGS_autoshard` /
`BuildStrategy.auto_sharding` on also registers it and sets its gauges.

    fluid.parallel.set_sharding(emb_w, ("mp", None))
    fluid.parallel.set_sharding(fc_w, (None, "mp"))
    bs = fluid.BuildStrategy(); bs.auto_sharding = True
    pe = fluid.ParallelExecutor(loss_name=loss.name,
                                mesh_shape={"dp": 4, "mp": 2},
                                build_strategy=bs)
"""

from .spec import normalize_spec, canon, pad_spec, spec_str
from .plan import ShardingPlan, transition_bytes
from .rules import register_rule, rule_for, registered_ops
from .propagate import (build_plan, validate_seeds, register_plan,
                        active_plan, reset_registry, manifest_section)
from .search import (plan_cost, enumerate_seed_candidates, search_plan,
                     SearchResult)
from . import lower

__all__ = [
    "normalize_spec", "canon", "pad_spec", "spec_str",
    "ShardingPlan", "transition_bytes",
    "register_rule", "rule_for", "registered_ops",
    "build_plan", "validate_seeds",
    "register_plan", "active_plan", "reset_registry", "manifest_section",
    "plan_cost", "enumerate_seed_candidates", "search_plan",
    "SearchResult",
]
