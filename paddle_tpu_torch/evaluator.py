"""In-graph stateful evaluators (reference python/paddle/fluid/evaluator.py;
the JAX package's paddle_tpu/evaluator.py): Evaluator base with state vars
+ reset program, Accuracy, ChunkEvaluator, EditDistance. States live as
persistable vars updated by in-graph ops and are read back through
executor.fetch_var. DetectionMAP needs the detection layers, not yet
ported (ROADMAP queue 1 item 9): building one raises."""

import numpy as np

from . import layers
from .layers import tensor as tensor_layers
from .core.framework import Program, Variable, program_guard, default_main_program
from .initializer import Constant
from .layer_helper import LayerHelper
from . import unique_name

__all__ = ["Accuracy", "ChunkEvaluator", "EditDistance", "DetectionMAP",
           "Evaluator"]


def _clone_var_(block, var):
    return block.create_var(
        name=var.name,
        shape=var.shape,
        dtype=var.dtype,
        lod_level=var.lod_level,
        persistable=True,
    )


class Evaluator:
    def __init__(self, name, **kwargs):
        self.states = []
        self.metrics = []
        self.helper = LayerHelper(name, **kwargs)

    def reset(self, executor, reset_program=None):
        if reset_program is None:
            reset_program = Program()
        with program_guard(main_program=reset_program):
            for var in self.states:
                assert isinstance(var, Variable)
                g_var = _clone_var_(reset_program.current_block(), var)
                layers.fill_constant(
                    shape=g_var.shape, value=0.0, dtype=g_var.dtype, out=g_var
                )
        executor.run(reset_program)

    def eval(self, executor, eval_program=None):
        raise NotImplementedError()

    def create_state(self, suffix, dtype, shape):
        state = self.helper.create_variable(
            name="_".join([unique_name.generate(self.helper.name), suffix]),
            persistable=True,
            dtype=dtype,
            shape=shape,
        )
        self.helper.set_variable_initializer(state, Constant(0.0))
        self.states.append(state)
        return state


class Accuracy(Evaluator):
    """reference evaluator.py Accuracy — accumulated over minibatches."""

    def __init__(self, input, label, k=1, **kwargs):
        super().__init__("accuracy", **kwargs)
        main_program = self.helper.main_program
        if main_program.current_block().idx != 0:
            raise ValueError("You can only invoke Evaluator in root block")

        self.total = self.create_state(dtype="int64", shape=[1], suffix="total")
        self.correct = self.create_state(dtype="int64", shape=[1], suffix="correct")
        total = self.helper.create_tmp_variable(dtype="int32")
        correct = self.helper.create_tmp_variable(dtype="int32")
        acc = layers.accuracy(input=input, label=label, k=k, correct=correct, total=total)
        total = tensor_layers.cast(x=total, dtype="int64")
        correct = tensor_layers.cast(x=correct, dtype="int64")
        tensor_layers.assign(layers.elementwise_add(x=self.total, y=total), self.total)
        tensor_layers.assign(layers.elementwise_add(x=self.correct, y=correct), self.correct)
        self.metrics.append(acc)

    def eval(self, executor, eval_program=None):
        if eval_program is None:
            eval_program = Program()
        block = eval_program.current_block()
        with program_guard(main_program=eval_program):
            total = _clone_var_(block, self.total)
            correct = _clone_var_(block, self.correct)
            total = tensor_layers.cast(total, dtype="float32")
            correct = tensor_layers.cast(correct, dtype="float32")
            out = layers.elementwise_div(x=correct, y=total)
        return np.array(executor.run(eval_program, fetch_list=[out])[0])


class ChunkEvaluator(Evaluator):
    def __init__(self, input, label, chunk_scheme, num_chunk_types,
                 excluded_chunk_types=None):
        super().__init__("chunk_eval")
        main_program = self.helper.main_program
        if main_program.current_block().idx != 0:
            raise ValueError("You can only invoke Evaluator in root block")

        self.num_infer_chunks = self.create_state(
            dtype="int64", shape=[1], suffix="num_infer_chunks"
        )
        self.num_label_chunks = self.create_state(
            dtype="int64", shape=[1], suffix="num_label_chunks"
        )
        self.num_correct_chunks = self.create_state(
            dtype="int64", shape=[1], suffix="num_correct_chunks"
        )
        precision, recall, f1_score, num_infer_chunks, num_label_chunks, num_correct_chunks = layers.chunk_eval(
            input=input,
            label=label,
            chunk_scheme=chunk_scheme,
            num_chunk_types=num_chunk_types,
            excluded_chunk_types=excluded_chunk_types,
        )
        tensor_layers.assign(
            layers.elementwise_add(x=self.num_infer_chunks, y=num_infer_chunks),
            self.num_infer_chunks,
        )
        tensor_layers.assign(
            layers.elementwise_add(x=self.num_label_chunks, y=num_label_chunks),
            self.num_label_chunks,
        )
        tensor_layers.assign(
            layers.elementwise_add(x=self.num_correct_chunks, y=num_correct_chunks),
            self.num_correct_chunks,
        )
        self.metrics.extend([precision, recall, f1_score])

    def eval(self, executor, eval_program=None):
        from .executor import fetch_var

        num_infer_chunks = int(np.asarray(fetch_var(self.num_infer_chunks.name)).reshape(-1)[0])
        num_label_chunks = int(np.asarray(fetch_var(self.num_label_chunks.name)).reshape(-1)[0])
        num_correct_chunks = int(
            np.asarray(fetch_var(self.num_correct_chunks.name)).reshape(-1)[0]
        )
        precision = (
            float(num_correct_chunks) / num_infer_chunks if num_infer_chunks else 0.0
        )
        recall = (
            float(num_correct_chunks) / num_label_chunks if num_label_chunks else 0.0
        )
        f1_score = (
            float(2 * precision * recall) / (precision + recall)
            if num_correct_chunks
            else 0.0
        )
        return np.array([precision]), np.array([recall]), np.array([f1_score])


class EditDistance(Evaluator):
    def __init__(self, input, label, ignored_tokens=None, **kwargs):
        super().__init__("edit_distance", **kwargs)
        main_program = self.helper.main_program
        if main_program.current_block().idx != 0:
            raise ValueError("You can only invoke Evaluator in root block")

        self.total_distance = self.create_state(
            dtype="float32", shape=[1], suffix="total_distance"
        )
        self.seq_num = self.create_state(dtype="int64", shape=[1], suffix="seq_num")
        self.instance_error = self.create_state(
            dtype="int64", shape=[1], suffix="instance_error"
        )
        distances, seq_num = layers.edit_distance(
            input=input, label=label, ignored_tokens=ignored_tokens
        )
        zero = layers.fill_constant(shape=(1,), value=0.0, dtype="float32")
        compare_result = layers.equal(distances, zero)
        compare_result_int = tensor_layers.cast(x=compare_result, dtype="int64")
        seq_right_count = layers.reduce_sum(compare_result_int)
        instance_error_count = layers.elementwise_sub(
            x=seq_num, y=seq_right_count
        )
        total_distance = layers.reduce_sum(distances)
        tensor_layers.assign(
            layers.elementwise_add(x=self.total_distance, y=total_distance),
            self.total_distance,
        )
        tensor_layers.assign(
            layers.elementwise_add(x=self.seq_num, y=seq_num), self.seq_num
        )
        tensor_layers.assign(
            layers.elementwise_add(x=self.instance_error, y=instance_error_count),
            self.instance_error,
        )
        self.metrics.append(total_distance)
        self.metrics.append(instance_error_count)

    def eval(self, executor, eval_program=None):
        from .executor import fetch_var

        total = float(np.asarray(fetch_var(self.total_distance.name)).reshape(-1)[0])
        seq_num = int(np.asarray(fetch_var(self.seq_num.name)).reshape(-1)[0])
        err = int(np.asarray(fetch_var(self.instance_error.name)).reshape(-1)[0])
        if seq_num == 0:
            return np.array([0.0]), np.array([0.0])
        return np.array([total / seq_num]), np.array([err / seq_num])


class DetectionMAP(Evaluator):
    """Detection mAP evaluator (reference evaluator.py:257). Its
    detection_map op lives in layers/detection.py, which the port lacks
    (ROADMAP queue 1 item 9)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "evaluator.DetectionMAP needs layers.detection (detection_map), "
            "which is not yet ported to paddle_tpu_torch (ROADMAP queue 1 "
            "item 9)")
