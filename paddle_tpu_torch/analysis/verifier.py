"""The structural helpers of the ProgramDesc verifier that the dataflow
hazard analysis (analysis.dataflow) builds on: op roles, sub-block lookup,
the collective op set and the runtime-managed var types. The structural
checks themselves (PTA001-PTA008) wait for the slice that ports
`FLAGS_verify`.
"""

from ..core.framework import Block, OpRole, OP_ROLE_ATTR_NAME, VarType

__all__ = ["op_role", "sub_blocks", "COLLECTIVE_OPS"]

# op types that move data across replicas; their issue order must be a
# single total order on every replica (see safety.check_collective_order)
COLLECTIVE_OPS = ("zero1_scatter", "zero1_gather", "all_reduce",
                  "all_gather", "reduce_scatter", "broadcast")

# var types the runtime materializes outside the op dataflow
_RUNTIME_VAR_TYPES = (VarType.READER, VarType.FEED_MINIBATCH,
                      VarType.FETCH_LIST, VarType.STEP_SCOPES,
                      VarType.LOD_RANK_TABLE, VarType.RAW)


def op_role(op):
    """Base OpRole with the Loss bit masked off."""
    return int(op.attrs.get(OP_ROLE_ATTR_NAME, OpRole.Forward)) \
        & ~OpRole.Loss


def sub_blocks(op):
    """Block-valued attrs of a control-flow op, in attr order."""
    return [v for v in op.attrs.values() if isinstance(v, Block)]

