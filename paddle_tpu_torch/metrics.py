"""Streaming metrics on the host (counterpart of ``paddle_tpu/metrics.py``;
reference python/paddle/fluid/metrics.py): numpy accumulation across
minibatches. ``DetectionMAP`` and the host op ``detection_map``
(``ops/kernels_detection.py``) share one copy of the VOC mAP arithmetic,
``_detection_map``."""

from __future__ import annotations

import numpy as np

__all__ = ["MetricBase", "CompositeMetric", "Precision", "Recall",
           "Accuracy", "ChunkEvaluator", "EditDistance", "Auc"]


class MetricBase:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        for k in list(self.__dict__):
            if not k.startswith("_"):
                v = self.__dict__[k]
                if isinstance(v, (int, float)):
                    self.__dict__[k] = type(v)(0)
                elif isinstance(v, np.ndarray):
                    self.__dict__[k] = np.zeros_like(v)

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
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
        self.value += float(np.asarray(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("Accuracy: no updates")
        return self.value / self.weight


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).reshape(-1)
        labels = np.asarray(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).reshape(-1)
        labels = np.asarray(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0


class ChunkEvaluator(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks,
               num_correct_chunks):
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


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = np.asarray(distances).reshape(-1)
        self.total_distance += float(distances.sum())
        self.seq_num += int(seq_num)
        self.instance_error += int(np.sum(distances > 0))

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("EditDistance: no updates")
        return (self.total_distance / self.seq_num,
                self.instance_error / self.seq_num)


class Auc(MetricBase):
    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._num_thresholds = num_thresholds
        self._stat_pos = np.zeros(num_thresholds + 1, dtype=np.int64)
        self._stat_neg = np.zeros(num_thresholds + 1, dtype=np.int64)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        pos_prob = preds[:, 1] if preds.ndim == 2 else preds.reshape(-1)
        bucket = np.clip((pos_prob * self._num_thresholds).astype(np.int64),
                         0, self._num_thresholds)
        for b, l in zip(bucket, labels):
            if l:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def eval(self):
        tp = np.cumsum(self._stat_pos[::-1])
        fp = np.cumsum(self._stat_neg[::-1])
        tot_pos, tot_neg = tp[-1], fp[-1]
        if tot_pos * tot_neg == 0:
            return 0.0
        tp0 = np.concatenate([[0], tp[:-1]])
        fp0 = np.concatenate([[0], fp[:-1]])
        area = np.sum((fp - fp0) * (tp + tp0) / 2.0)
        return float(area / (tot_pos * tot_neg))


class DetectionMAP(MetricBase):
    """metrics.py DetectionMAP: streaming VOC mAP. update() takes dense
    detections [B, K, 6] (class, score, x1, y1, x2, y2; class<0 pads)
    and gt [B, G, 5] (class, box; class<0 pads) — the padded stand-in
    for the reference's LoD rows — and eval() runs the same
    accumulation as the detection_map op."""

    def __init__(self, name=None, overlap_threshold=0.5,
                 evaluate_difficult=True, ap_version="integral"):
        super().__init__(name)
        if not evaluate_difficult:
            # the dense gt rows carry no difficult flag; silently
            # ignoring the request would misreport mAP
            raise ValueError(
                "evaluate_difficult=False is not supported: the dense "
                "gt layout has no per-box difficult flag")
        self._overlap_threshold = overlap_threshold
        self._ap_version = ap_version
        self._dets = []
        self._gts = []

    def update(self, detections, gts):
        self._dets.append(np.asarray(detections))
        self._gts.append(np.asarray(gts))

    def reset(self):
        self._dets = []
        self._gts = []

    def eval(self):
        if not self._dets:
            raise ValueError("DetectionMAP.eval with no updates")
        kmax = max(d.shape[1] for d in self._dets)
        gmax = max(g.shape[1] for g in self._gts)

        def pad(a, n):
            if a.shape[1] == n:
                return a
            fill = np.zeros((a.shape[0], n - a.shape[1], a.shape[2]),
                            a.dtype)
            fill[:, :, 0] = -1
            return np.concatenate([a, fill], axis=1)

        det = np.concatenate([pad(d, kmax) for d in self._dets])
        gt = np.concatenate([pad(g, gmax) for g in self._gts])
        return _detection_map(det, gt, self._overlap_threshold,
                              self._ap_version)


def _detection_map(det, gt, iou_thr, ap_type):
    """VOC-style mAP (the reference's detection_map_op.h) over dense
    detections [B, K, 6] (class, score, box; class < 0 pads) against
    ground truth [B, G, 5] (class, box; class < 0 pads)."""
    iou_thr = float(iou_thr)
    b = det.shape[0]
    classes = sorted({int(c) for c in gt[..., 0].reshape(-1) if c >= 0})
    aps = []
    for cls in classes:
        scores, tps = [], []
        npos = 0
        for bi in range(b):
            gts = gt[bi][gt[bi, :, 0] == cls][:, 1:5]
            npos += len(gts)
            dets = det[bi][det[bi, :, 0] == cls]
            dets = dets[np.argsort(-dets[:, 1])]
            used = np.zeros(len(gts), bool)
            for d in dets:
                box = d[2:6]
                best, bi_idx = 0.0, -1
                for gi, g in enumerate(gts):
                    ix1 = max(box[0], g[0]); iy1 = max(box[1], g[1])
                    ix2 = min(box[2], g[2]); iy2 = min(box[3], g[3])
                    inter = max(ix2 - ix1, 0) * max(iy2 - iy1, 0)
                    ua = ((box[2] - box[0]) * (box[3] - box[1])
                          + (g[2] - g[0]) * (g[3] - g[1]) - inter)
                    ov = inter / ua if ua > 0 else 0.0
                    if ov > best:
                        best, bi_idx = ov, gi
                scores.append(d[1])
                if best >= iou_thr and bi_idx >= 0 and not used[bi_idx]:
                    tps.append(1)
                    used[bi_idx] = True
                else:
                    tps.append(0)
        if npos == 0:
            continue
        order = np.argsort(-np.asarray(scores))
        tp = np.asarray(tps)[order]
        fp = 1 - tp
        tp_c = np.cumsum(tp)
        fp_c = np.cumsum(fp)
        rec = tp_c / npos
        prec = tp_c / np.maximum(tp_c + fp_c, 1e-9)
        if ap_type == "11point":
            ap = np.mean([prec[rec >= t].max() if (rec >= t).any()
                          else 0.0 for t in np.linspace(0, 1, 11)])
        else:
            ap = 0.0
            prev_r = 0.0
            for p, r in zip(prec, rec):
                ap += p * (r - prev_r)
                prev_r = r
        aps.append(ap)
    return float(np.float32(np.mean(aps))) if aps else 0.0
