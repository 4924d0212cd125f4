"""Python-side metric accumulators (reference python/paddle/fluid/metrics.py;
the JAX package's paddle_tpu/metrics.py, copied: host numpy, the same
arithmetic): MetricBase, CompositeMetric, Accuracy, ChunkEvaluator,
EditDistance, DetectionMAP, Auc."""

import numpy as np

__all__ = [
    "MetricBase", "CompositeMetric", "Accuracy", "ChunkEvaluator",
    "EditDistance", "DetectionMAP", "Auc",
]


def _is_numpy_(var):
    return isinstance(var, (np.ndarray, np.generic))


def _is_number_(var):
    return isinstance(var, (int, float)) or (_is_numpy_(var) and var.size == 1)


def _is_number_or_matrix_(var):
    return _is_number_(var) or _is_numpy_(var)


class MetricBase:
    def __init__(self, name=None):
        self._name = str(name) if name is not None else self.__class__.__name__

    def __str__(self):
        return self._name

    def reset(self):
        states = {
            attr: value
            for attr, value in self.__dict__.items()
            if not attr.startswith("_")
        }
        for attr, value in states.items():
            if isinstance(value, int):
                setattr(self, attr, 0)
            elif isinstance(value, float):
                setattr(self, attr, 0.0)
            elif isinstance(value, (np.ndarray, np.generic)):
                setattr(self, attr, np.zeros_like(value))
            else:
                setattr(self, attr, None)

    def get_config(self):
        states = {
            attr: value
            for attr, value in self.__dict__.items()
            if not attr.startswith("_")
        }
        config = {}
        config.update({"name": self._name, "states": list(states.keys())})
        return config

    def update(self, preds, labels):
        raise NotImplementedError()

    def eval(self):
        raise NotImplementedError()


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        if not isinstance(metric, MetricBase):
            raise ValueError("SubMetric should be inherit from MetricBase.")
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        if not _is_number_or_matrix_(value):
            raise ValueError("update value should be a number or numpy array")
        if not _is_number_(weight):
            raise ValueError("weight should be a number")
        self.value += float(np.asarray(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("Accuracy: nothing accumulated — call update first")
        return self.value / self.weight


class ChunkEvaluator(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += int(np.asarray(num_infer_chunks).reshape(-1)[0])
        self.num_label_chunks += int(np.asarray(num_label_chunks).reshape(-1)[0])
        self.num_correct_chunks += int(np.asarray(num_correct_chunks).reshape(-1)[0])

    def eval(self):
        precision = (
            float(self.num_correct_chunks) / self.num_infer_chunks
            if self.num_infer_chunks
            else 0.0
        )
        recall = (
            float(self.num_correct_chunks) / self.num_label_chunks
            if self.num_label_chunks
            else 0.0
        )
        f1_score = (
            2 * precision * recall / (precision + recall)
            if self.num_correct_chunks
            else 0.0
        )
        return precision, recall, f1_score


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        seq_right_count = int(np.sum(np.asarray(distances) == 0))
        total_distance = float(np.sum(np.asarray(distances)))
        seq_num = int(np.asarray(seq_num).reshape(-1)[0])
        self.seq_num += seq_num
        self.instance_error += seq_num - seq_right_count
        self.total_distance += total_distance

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("EditDistance: nothing accumulated")
        avg_distance = self.total_distance / self.seq_num
        avg_instance_error = self.instance_error / self.seq_num
        return avg_distance, avg_instance_error


class DetectionMAP(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0

    def update(self, value, weight=1):
        if not _is_number_or_matrix_(value):
            raise ValueError("value must be a number or numpy array")
        self.value += float(np.asarray(value).reshape(-1)[0])
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("DetectionMAP: nothing accumulated")
        return self.value / self.weight


class Auc(MetricBase):
    """numpy streaming AUC (reference metrics.py Auc)."""

    def __init__(self, name=None, curve="ROC", num_thresholds=200):
        super().__init__(name)
        self._curve = curve
        self._num_thresholds = num_thresholds
        self._epsilon = 1e-6
        self.tp_list = np.zeros((num_thresholds,))
        self.fn_list = np.zeros((num_thresholds,))
        self.tn_list = np.zeros((num_thresholds,))
        self.fp_list = np.zeros((num_thresholds,))

    def update(self, labels, predictions):
        if not _is_numpy_(labels) or not _is_numpy_(predictions):
            raise ValueError("labels and predictions must be numpy arrays")
        kepsilon = 1e-7
        thresholds = [
            (i + 1) * 1.0 / (self._num_thresholds - 1)
            for i in range(self._num_thresholds - 2)
        ]
        thresholds = [0.0 - kepsilon] + thresholds + [1.0 + kepsilon]
        for idx_thresh, thresh in enumerate(thresholds):
            tp, fn, tn, fp = 0, 0, 0, 0
            for i, lbl in enumerate(labels):
                if lbl:
                    if predictions[i, 1] >= thresh:
                        tp += 1
                    else:
                        fn += 1
                else:
                    if predictions[i, 1] >= thresh:
                        fp += 1
                    else:
                        tn += 1
            self.tp_list[idx_thresh] += tp
            self.fn_list[idx_thresh] += fn
            self.tn_list[idx_thresh] += tn
            self.fp_list[idx_thresh] += fp

    def eval(self):
        epsilon = self._epsilon
        num_thresholds = self._num_thresholds
        tpr = (self.tp_list.astype("float32") + epsilon) / (
            self.tp_list + self.fn_list + epsilon
        )
        fpr = self.fp_list.astype("float32") / (self.fp_list + self.tn_list + epsilon)
        rec = (self.tp_list.astype("float32") + epsilon) / (
            self.tp_list + self.fp_list + epsilon
        )
        x = fpr[:num_thresholds - 1] - fpr[1:]
        y = (tpr[:num_thresholds - 1] + tpr[1:]) / 2.0
        auc_value = np.sum(x * y)
        return auc_value
