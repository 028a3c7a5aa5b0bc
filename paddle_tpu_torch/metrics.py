"""Python-side streaming metric aggregators: the port's copy of
``paddle_tpu.metrics`` (numpy only).

Reference analog: ``python/paddle/fluid/metrics.py`` — MetricBase,
CompositeMetric, Precision, Recall, Accuracy, ChunkEvaluator, EditDistance,
Auc, DetectionMAP. These aggregate *fetched* per-batch values on the host.
"""
from __future__ import annotations

import numpy as np


class MetricBase:
    def __init__(self, name: str = ""):
        self._name = name

    def reset(self):
        raise NotImplementedError

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError

    def get_config(self):
        return {"name": self._name}


class CompositeMetric(MetricBase):
    def __init__(self, name=""):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric: MetricBase):
        self._metrics.append(metric)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Accuracy(MetricBase):
    def __init__(self, name=""):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight=1):
        self.value += float(value) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("no batches accumulated")
        return self.value / self.weight


class Precision(MetricBase):
    def __init__(self, name=""):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype("int32").reshape(-1)
        labels = np.asarray(labels).astype("int32").reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0


class Recall(MetricBase):
    def __init__(self, name=""):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype("int32").reshape(-1)
        labels = np.asarray(labels).astype("int32").reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0


class Auc(MetricBase):
    """Host-side streaming AUC (metrics.py Auc; the in-graph variant is
    layers.auc)."""

    def __init__(self, name="", curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._num = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self._num + 1)
        self._stat_neg = np.zeros(self._num + 1)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        pos_prob = preds[:, 1] if preds.ndim == 2 and preds.shape[1] == 2 else preds.reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        bucket = np.clip((pos_prob * self._num).astype(int), 0, self._num)
        np.add.at(self._stat_pos, bucket, labels == 1)
        np.add.at(self._stat_neg, bucket, labels == 0)

    def eval(self):
        tp = np.cumsum(self._stat_pos[::-1])[::-1]
        fp = np.cumsum(self._stat_neg[::-1])[::-1]
        tot_pos, tot_neg = tp[0], fp[0]
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        tp_prev = np.concatenate([tp[1:], [0.0]])
        fp_prev = np.concatenate([fp[1:], [0.0]])
        area = np.sum((fp - fp_prev) * (tp + tp_prev) / 2.0)
        return float(area / (tot_pos * tot_neg))


class EditDistance(MetricBase):
    def __init__(self, name=""):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.total = 0.0
        self.count = 0
        self.correct = 0

    def update(self, distances, seq_num):
        d = np.asarray(distances).reshape(-1)
        self.total += float(d.sum())
        self.count += int(seq_num)
        self.correct += int(np.sum(d == 0))

    def eval(self):
        if self.count == 0:
            raise ValueError("no data")
        return self.total / self.count, self.correct / self.count


class ChunkEvaluator(MetricBase):
    """metrics.py ChunkEvaluator: accumulate chunk_eval op counts into
    running precision/recall/F1."""

    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += int(np.asarray(num_infer_chunks).sum())
        self.num_label_chunks += int(np.asarray(num_label_chunks).sum())
        self.num_correct_chunks += int(np.asarray(num_correct_chunks).sum())

    def eval(self):
        precision = (self.num_correct_chunks / self.num_infer_chunks
                     if self.num_infer_chunks else 0.0)
        recall = (self.num_correct_chunks / self.num_label_chunks
                  if self.num_label_chunks else 0.0)
        f1 = (2 * precision * recall / (precision + recall)
              if self.num_correct_chunks else 0.0)
        return precision, recall, f1

    def reset(self):
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0


class DetectionMAP(MetricBase):
    """metrics.py DetectionMAP: mean average precision accumulator over
    (score, tp/fp) detections — 11-point interpolated AP per class."""

    def __init__(self, name=None, class_num=None, overlap_threshold=0.5,
                 evaluate_difficult=True, ap_version="integral",
                 input=None, gt_label=None, gt_box=None, gt_difficult=None):
        super().__init__(name)
        self.class_num = class_num
        self.ap_version = ap_version
        self.reset()

    def update(self, detections, gt_labels):
        """detections: rows [class, score, correct(0/1)] per detection;
        gt_labels: iterable of ground-truth class ids."""
        for row in np.asarray(detections).reshape(-1, 3):
            c, score, correct = int(row[0]), float(row[1]), int(row[2])
            self._dets.setdefault(c, []).append((score, correct))
        for g in np.asarray(gt_labels).reshape(-1):
            self._gt[int(g)] = self._gt.get(int(g), 0) + 1

    def eval(self):
        aps = []
        for c, npos in self._gt.items():
            dets = sorted(self._dets.get(c, []), reverse=True)
            if not dets:
                aps.append(0.0)
                continue
            tp = np.cumsum([d[1] for d in dets])
            fp = np.cumsum([1 - d[1] for d in dets])
            rec = tp / max(npos, 1)
            prec = tp / np.maximum(tp + fp, 1e-9)
            if self.ap_version == "11point":
                ap = np.mean([prec[rec >= t].max() if (rec >= t).any()
                              else 0.0 for t in np.linspace(0, 1, 11)])
            else:  # integral
                ap = float(np.sum((rec[1:] - rec[:-1]) * prec[1:])
                           + rec[0] * prec[0]) if len(rec) > 1 else \
                    float(rec[0] * prec[0])
            aps.append(float(ap))
        return float(np.mean(aps)) if aps else 0.0

    def reset(self, executor=None, reset_program=None):
        self._dets = {}
        self._gt = {}
