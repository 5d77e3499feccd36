"""Python-side metric accumulators.

Reference: ``python/paddle/fluid/metrics.py`` (MetricBase/Accuracy/
CompositeMetric/ChunkEvaluator/EditDistance/Auc) — host-side accumulators fed
by fetched per-batch values; the per-batch values themselves come from metric
ops (``operators/accuracy_op.cc``, ``auc_op.cc``), which here are the
functional ops in ``paddle_tpu_torch.ops.nn``. A copy of
``paddle_tpu.metrics`` (numpy only).
"""

from __future__ import annotations

import numpy as np


class MetricBase:
    def __init__(self, name: str = ""):
        self._name = name or type(self).__name__

    def reset(self):
        raise NotImplementedError

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class Accuracy(MetricBase):
    """Weighted running accuracy (reference metrics.Accuracy)."""

    def __init__(self, name: str = ""):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight=1.0):
        self.value += float(value) * float(weight)
        self.weight += float(weight)

    def eval(self):
        if self.weight == 0:
            raise ValueError("no updates to Accuracy metric")
        return self.value / self.weight


class Average(MetricBase):
    """Running mean of a scalar stream (e.g. loss); reference average.py
    WeightedAverage."""

    def __init__(self, name: str = ""):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.total = 0.0
        self.count = 0.0

    def update(self, value, weight=1.0):
        self.total += float(np.sum(value)) * float(weight)
        self.count += float(weight)

    def eval(self):
        return self.total / max(self.count, 1e-12)


class Precision(MetricBase):
    """Binary precision = tp / (tp + fp) over accumulated batches
    (reference ``metrics.py:208`` Precision)."""

    def __init__(self, name: str = ""):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.asarray(preds).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        pred_pos = np.rint(preds).astype(np.int64) == 1
        label_pos = labels.astype(np.int64) == 1
        self.tp += int(np.sum(pred_pos & label_pos))
        self.fp += int(np.sum(pred_pos & ~label_pos))

    def eval(self):
        denom = self.tp + self.fp
        return float(self.tp) / denom if denom else 0.0


class Recall(MetricBase):
    """Binary recall = tp / (tp + fn) over accumulated batches
    (reference ``metrics.py:255`` Recall)."""

    def __init__(self, name: str = ""):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.asarray(preds).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        pred_pos = np.rint(preds).astype(np.int64) == 1
        label_pos = labels.astype(np.int64) == 1
        self.tp += int(np.sum(pred_pos & label_pos))
        self.fn += int(np.sum(~pred_pos & label_pos))

    def eval(self):
        denom = self.tp + self.fn
        return float(self.tp) / denom if denom else 0.0


class ChunkEvaluator(MetricBase):
    """Accumulates ``ops.chunk_eval`` per-batch counts into pass-level
    precision/recall/F1 (reference ``metrics.py:355`` ChunkEvaluator)."""

    def __init__(self, name: str = ""):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += int(np.sum(num_infer_chunks))
        self.num_label_chunks += int(np.sum(num_label_chunks))
        self.num_correct_chunks += int(np.sum(num_correct_chunks))

    def eval(self):
        precision = (
            self.num_correct_chunks / self.num_infer_chunks
            if self.num_infer_chunks
            else 0.0
        )
        recall = (
            self.num_correct_chunks / self.num_label_chunks
            if self.num_label_chunks
            else 0.0
        )
        f1 = (
            2 * precision * recall / (precision + recall)
            if self.num_correct_chunks
            else 0.0
        )
        return precision, recall, f1


class DetectionMAP(MetricBase):
    """Weighted running mean of per-batch ``ops.detection_map`` values
    (reference ``metrics.py:481`` DetectionMAP)."""

    def __init__(self, name: str = ""):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(np.sum(value))
        self.weight += float(weight)

    def eval(self):
        if self.weight == 0:
            raise ValueError("no updates to DetectionMAP metric")
        return self.value / self.weight


class EditDistance(MetricBase):
    def __init__(self, name: str = ""):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = np.asarray(distances)
        self.total_distance += float(np.sum(distances))
        self.seq_num += int(seq_num)
        self.instance_error += int(np.sum(distances > 0))

    def eval(self):
        avg = self.total_distance / max(self.seq_num, 1)
        err_rate = self.instance_error / max(self.seq_num, 1)
        return avg, err_rate


class Auc(MetricBase):
    """Streaming ROC-AUC by thresholded confusion counts (reference
    ``auc_op.cc`` + metrics.Auc)."""

    def __init__(self, name: str = "", num_thresholds: int = 4095):
        super().__init__(name)
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self.tp = np.zeros(self.num_thresholds + 1, np.int64)
        self.fp = np.zeros(self.num_thresholds + 1, np.int64)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1).astype(bool)
        pos_prob = preds[:, 1] if preds.ndim == 2 else preds.reshape(-1)
        idx = np.clip((pos_prob * self.num_thresholds).astype(np.int64), 0, self.num_thresholds)
        # vectorized: tp[t] = #{i : idx_i >= t, label_i} = reversed-cumsum of
        # per-threshold counts
        pos_counts = np.bincount(idx[labels], minlength=self.num_thresholds + 1)
        neg_counts = np.bincount(idx[~labels], minlength=self.num_thresholds + 1)
        self.tp += np.cumsum(pos_counts[::-1])[::-1]
        self.fp += np.cumsum(neg_counts[::-1])[::-1]

    def eval(self):
        total_pos = self.tp[0]
        total_neg = self.fp[0]
        tpr = self.tp / max(total_pos, 1)
        fpr = self.fp / max(total_neg, 1)
        # integrate over descending thresholds
        trapz = getattr(np, "trapezoid", None) or np.trapz
        return float(abs(trapz(tpr, fpr)))


class CompositeMetric(MetricBase):
    def __init__(self, name: str = ""):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric: MetricBase):
        self._metrics.append(metric)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def update(self, *args):
        for m, a in zip(self._metrics, args):
            m.update(*a if isinstance(a, tuple) else (a,))

    def eval(self):
        return [m.eval() for m in self._metrics]
