"""Inference transpiler (reference
python/paddle/fluid/transpiler/inference_transpiler.py; the JAX package's
paddle_tpu/transpiler/inference_transpiler.py): graph rewrites for serving —
fold batch_norm into the preceding conv (scale/bias fusion), drop the vars
nothing uses. The folding is numpy float32 arithmetic on the scope's
values, the JAX package's own, so both packages fold the same weights to
the same bits; each folded array goes back into the scope as a tensor of
the dtype and on the device of the value it replaces."""

import numpy as np
import torch

from ..core.framework import Program
from ..core.scope import global_scope


def _numpy_f32(v):
    """A scope value as a float32 numpy array (a copy)."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).numpy().copy()
    return np.array(v, dtype=np.float32)


class InferenceTranspiler:
    def transpile(self, program, place=None, scope=None):
        if not isinstance(program, Program):
            raise TypeError("program should be as Program type")
        if scope is None:
            scope = global_scope()
        self.fuse_batch_norm(program, place, scope)

    def fuse_batch_norm(self, program, place, scope):
        """Fold y = bn(conv(x, W) [+ b_conv]) into y = conv(x, W') + b'.

        Both patterns fold:
          conv2d -> elementwise_add(bias) -> batch_norm
              the bias add survives with a folded bias value and its
              output rewired to the bn's Y (the conv op is untouched);
          conv2d -> batch_norm   (conv built with bias_attr=False)
              a fused bias var is created and an elementwise_add is
              inserted after the conv, writing straight into the bn's Y.
        In both cases the batch_norm op is dropped and the conv filter is
        rescaled per output channel in the scope."""
        self.scope = scope
        self.block = program.global_block()
        i = 0
        while i < len(self.block.ops) - 1:
            current_op = self.block.ops[i]
            if current_op.type != "conv2d":
                i += 1
                continue
            next_op = self.block.ops[i + 1]
            bias_op = None
            if (
                next_op.type == "elementwise_add"
                and i + 2 < len(self.block.ops)
                and self.block.ops[i + 2].type == "batch_norm"
            ):
                bias_op = next_op
                bn_op = self.block.ops[i + 2]
            elif next_op.type == "batch_norm":
                bn_op = next_op
            else:
                i += 1
                continue
            if not bn_op.attrs.get("is_test", False):
                i += 1
                continue
            if self._fuse_param(current_op, bn_op, bias_op):
                self.block.ops.remove(bn_op)
                program._mutation += 1
            i += 1
        self._remove_unused_var(program)

    def _channel_axis(self, conv_op, bn_op):
        """The bias-broadcast axis for this conv's activations (filters are
        OIHW in both layouts, activations follow data_format)."""
        layout = conv_op.attrs.get(
            "data_format", bn_op.attrs.get("data_layout", "NCHW"))
        return 3 if layout == "NHWC" else 1

    def _fuse_param(self, conv_op, bn_op, bias_op):
        def _load(name):
            v = self.scope.find_var(name)
            return None if v is None else _numpy_f32(v)

        w_name = conv_op.input("Filter")[0]
        scale = _load(bn_op.input("Scale")[0])
        bias = _load(bn_op.input("Bias")[0])
        mean = _load(bn_op.input("Mean")[0])
        var = _load(bn_op.input("Variance")[0])
        w = _load(w_name)
        if any(x is None for x in (scale, bias, mean, var, w)):
            return False
        eps = bn_op.attrs.get("epsilon", 1e-5)
        inv_std = 1.0 / np.sqrt(var + eps)
        alpha = scale * inv_std  # per-out-channel
        w_new = w * alpha.reshape(-1, 1, 1, 1)
        out_name = bn_op.output("Y")[0]
        if bias_op is not None:
            # bn(conv + b) = conv' + b': fold into the EXISTING bias add
            # and point its output at the bn's Y — the add must survive
            # (dropping it would lose the bias term entirely)
            b_name = bias_op.input("Y")[0]
            b = _load(b_name)
            b_new = (b - mean) * alpha + bias if b is not None \
                else bias - mean * alpha
            self._store(b_name, b_new, like=w_name)
            bias_op.outputs["Out"] = [out_name]
        else:
            # biasless conv (bias_attr=False): materialize the fused bias
            # and add it AFTER the conv, writing straight into the bn's Y
            # (the conv keeps its own output var — rewiring the conv while
            # the add reads its old name would orphan the add's input)
            b_new = bias - mean * alpha
            bias_name = w_name + "@bn_fused_bias"
            self._store(bias_name, b_new, like=w_name)
            self.block.create_var(
                name=bias_name, shape=(b_new.shape[0],), dtype="float32",
                persistable=True,
            )
            conv_out = conv_op.output("Output")[0]
            idx = self.block.ops.index(conv_op)
            self.block.insert_op(
                idx + 1,
                "elementwise_add",
                {"X": [conv_out], "Y": [bias_name]},
                {"Out": [out_name]},
                {"axis": self._channel_axis(conv_op, bn_op)},
            )
        self._store(w_name, w_new, like=w_name)
        return True

    def _store(self, name, array, like):
        """Put the float32 `array` into the scope as `name`: a tensor of the
        dtype and on the device of the value it replaces, or, for a new
        var, on the device of `like`'s value as float32."""
        old = self.scope.find_var(name)
        ref = old if isinstance(old, torch.Tensor) \
            else self.scope.find_var(like)
        t = torch.from_numpy(array.astype(np.float32))
        if isinstance(ref, torch.Tensor):
            dtype = old.dtype if isinstance(old, torch.Tensor) \
                else torch.float32
            t = t.to(device=ref.device, dtype=dtype)
        self.scope.var(name)
        self.scope.set_var(name, t)

    def _remove_unused_var(self, program):
        block = program.global_block()
        used = set()
        for op in block.ops:
            used.update(op.input_arg_names())
            used.update(op.output_arg_names())
        for name in list(block.vars.keys()):
            var = block.vars[name]
            if name not in used and not var.persistable:
                del block.vars[name]
