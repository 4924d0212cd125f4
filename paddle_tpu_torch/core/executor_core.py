"""Executor core: an op-by-op interpreter over a Program block.

Reference parity: paddle/fluid/framework/executor.cc:133 runs the op list
one kernel launch at a time against a Scope. The port keeps that model:
`run_ops` walks the (dead-code-eliminated) op list and calls each op's
registered torch kernel on an env of tensors; the Executor seeds the env
from the Scope and writes persistable state back after the step. The JAX
package's whole-block `jax.jit` step, its lax.scan multi-step and the
FLAGS_fuse_optimizer_ops concat path have no counterpart yet.
"""

import numpy as np
import torch

from . import registry
from .places import device_for


class OpContext:
    """Per-step context passed to kernels: the device every allocation
    lands on, the step's random generator, and the test-mode flag."""

    def __init__(self, place, generator=None, is_test=False):
        self.place = place
        self.device = device_for(place)
        self.generator = generator if generator is not None \
            else torch.Generator(device=self.device)
        self.is_test = is_test
        self.current_op = None  # the op being run (derived grad kernels)


def step_generator(device, seed, step):
    """The generator a step's random ops draw from: one stream per
    (program.random_seed, step), the counterpart of the JAX Executor's
    fold_in(PRNGKey(seed), step). The two backends draw different numbers
    from the same seed."""
    mixed = np.random.SeedSequence([int(seed), int(step)]).generate_state(1)
    return torch.Generator(device=device).manual_seed(int(mixed[0]))


def env_get(env, name):
    if name in env:
        return env[name]
    raise KeyError(
        f"Variable {name!r} not materialized (missing feed or init?)")


def run_ops(ops, env, ctx):
    for op in ops:
        _run_one_op(op, env, ctx)
    return env


def _run_one_op(op, env, ctx):
    op_def = registry.lookup(op.type)
    ctx.current_op = op
    ins = {slot: [None if n == "" else env_get(env, n) for n in names]
           for slot, names in op.inputs.items()}
    try:
        outs = registry.run_kernel(op_def, ctx, ins, op.attrs) or {}
    except Exception as e:
        raise type(e)(f"while running op {op.type!r} ({op!r}): {e}") from e
    finally:
        ctx.current_op = None
    for slot, names in op.outputs.items():
        vals = outs.get(slot, [])
        for i, name in enumerate(names):
            if name and i < len(vals) and vals[i] is not None:
                env[name] = vals[i]


def _persistables(program):
    return {n for b in program.blocks for n, v in b.vars.items()
            if v.persistable}


def written_persistables(program):
    """Persistable vars some op of the program writes, sorted."""
    written = {n for b in program.blocks for op in b.ops
               for n in op.output_arg_names()}
    return sorted(written & _persistables(program))


def collect_state_names(program, scope):
    """Persistable vars the block reads or writes and that exist in scope,
    and the persistable vars it writes."""
    touched = set()
    for b in program.blocks:
        for op in b.ops:
            touched.update(op.input_arg_names())
            touched.update(op.output_arg_names())
    state_in = sorted(n for n in _persistables(program) & touched
                      if scope.has_var(n))
    return state_in, written_persistables(program)


def _block_read_names(op):
    """All var names read anywhere inside an op's sub-blocks (control flow)."""
    names = set()
    for v in op.attrs.values():
        if hasattr(v, "ops"):  # a Block attr
            for sub in v.ops:
                names.update(sub.input_arg_names())
                names.update(_block_read_names(sub))
    return names


def dead_code_eliminate(ops, needed_names):
    """Drop ops whose outputs feed neither fetches nor persistable state,
    so a clone(for_test=True) program runs with only its data inputs fed
    (the reference relies on Program.prune, framework.py:1112)."""
    needed = set(needed_names)
    live = []
    for op in reversed(ops):
        outs = set(op.output_arg_names())
        # control-flow ops (any Block attr) write into env by kernel side
        # effect with empty declared outputs — always keep them
        has_sub_block = any(hasattr(v, "ops") for v in op.attrs.values())
        keep = (bool(outs & needed) or has_sub_block
                or op.type in ("print", "assert_op"))
        if keep:
            live.append(op)
            needed |= set(op.input_arg_names())
            needed |= _block_read_names(op)
    live.reverse()
    return live
