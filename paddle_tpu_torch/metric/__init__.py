"""Metrics (the JAX package's `metric`, the port's own copy): `Metric`,
`Accuracy`, `Precision`, `Recall`, `Auc`, `ChunkEvaluator`,
`CompositeMetric`, `DetectionMAP` and the functional `accuracy`.

The metric classes accumulate on the host in numpy, as the JAX ones
do, and give the JAX values on the same inputs. A torch tensor passed
in is copied to the host (`_np`): on the card that is one device sync
a call. `hapi.Model` calls `compute` and `update` once a step for each
metric, so an `Accuracy` costs a step one sync and the copy of the
logits (the loss's `float()` is another).

**Ties.** `Accuracy.compute` ranks with ``np.argsort(-p)`` on the host,
the JAX call, so tied scores fall in the same order in both packages; a
device `topk` would break ties in another order. The functional
`accuracy` follows the JAX function's `lax.top_k` (the lower index
first among equal scores) and stays on the tensor's device: a label is
within the top k when fewer than k scores beat it, counting equal
scores at lower indices.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy",
           "ChunkEvaluator", "CompositeMetric", "DetectionMAP"]


def _np(x):
    """x as a numpy array; a torch tensor is copied to the host (bfloat16
    widened to float32, which numpy can hold)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Metric:
    def __init__(self, name=None):
        self._name = name or type(self).__name__.lower()

    def name(self):
        return self._name

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__(name or "acc")
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        p = _np(pred)
        l = _np(label)
        if l.ndim == p.ndim and l.shape[-1] == 1:
            l = l[..., 0]
        idx = np.argsort(-p, axis=-1)[..., :self.maxk]
        correct = (idx == l[..., None])
        return correct

    def update(self, correct, *args):
        c = _np(correct)
        flat = c.reshape(-1, c.shape[-1])
        res = []
        for i, k in enumerate(self.topk):
            num = flat[:, :k].any(axis=-1).sum()
            self.total[i] += float(num)
            self.count[i] += flat.shape[0]
            res.append(float(num) / flat.shape[0])
        return res[0] if len(res) == 1 else res

    def accumulate(self):
        res = [t / c if c else 0.0 for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name=None):
        super().__init__(name or "precision")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        l = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fp += int(((p == 1) & (l == 0)).sum())

    def accumulate(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0


class Recall(Metric):
    def __init__(self, name=None):
        super().__init__(name or "recall")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        l = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fn += int(((p == 0) & (l == 1)).sum())

    def accumulate(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0


class Auc(Metric):
    """Streaming AUC via threshold buckets (operators/metrics/auc_op.cc)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        super().__init__(name or "auc")
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        l = _np(labels).reshape(-1)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        p = p.reshape(-1)
        buckets = np.clip((p * self.num_thresholds).astype(np.int64), 0,
                          self.num_thresholds)
        for b, y in zip(buckets, l):
            if y:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        area = 0.0
        pos = neg = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = pos + self._stat_pos[i]
            new_neg = neg + self._stat_neg[i]
            area += (new_neg - neg) * (pos + new_pos) / 2.0
            pos, neg = new_pos, new_neg
        return float(area / (tot_pos * tot_neg))


def accuracy(input, label, k=1):
    """The share of rows whose label is among the k highest scores, as a
    float32 0-d tensor on the input's device (the JAX function's
    `lax.top_k` tie order: equal scores rank by index)."""
    p = input if isinstance(input, torch.Tensor) else torch.as_tensor(
        np.asarray(input))
    lbl = label if isinstance(label, torch.Tensor) else torch.as_tensor(
        np.asarray(label))
    lbl = lbl.to(p.device).long()
    if lbl.dim() == p.dim() and lbl.shape[-1] == 1:
        lbl = lbl[..., 0]
    at = torch.gather(p, -1, lbl[..., None])
    cols = torch.arange(p.shape[-1], device=p.device)
    rank = (p > at).sum(-1) + ((p == at) & (cols < lbl[..., None])).sum(-1)
    return (rank < k).float().mean()


class ChunkEvaluator(Metric):
    """Chunking F1 over BIO tag sequences (fluid/metrics.py
    ChunkEvaluator + chunk_eval_op capability): update() takes
    (num_infer_chunks, num_label_chunks, num_correct_chunks) — scalars or
    size-1 arrays, as the chunk_eval op emits — or computes them from
    (pred_tags [B, T], label_tags [B, T], lengths [B]) with the IOB
    scheme. Tag sequences must be 2-D (batched); that is what makes the
    two forms unambiguous."""

    def __init__(self, num_chunk_types=None, name=None):
        super().__init__(name or "chunk")
        self.num_chunk_types = num_chunk_types
        self.reset()

    def reset(self):
        self.num_infer = 0
        self.num_label = 0
        self.num_correct = 0

    @staticmethod
    def extract_chunks(tags, num_chunk_types):
        """IOB tags (0..2T-1 with even=B-x, odd=I-x; O = any id >= 2T)
        -> set of (start, end, type). conlleval semantics: an I tag with
        no live chunk of its type BEGINS one (stray-I tolerant, like the
        reference chunk_eval)."""
        if num_chunk_types is None:
            raise ValueError(
                "extract_chunks needs num_chunk_types to tell O tags "
                "apart from chunk tags")
        chunks = []
        start = ctype = None
        tags = list(tags)
        for i, t in enumerate(tags):
            t = int(t)
            typ = t // 2
            is_o = typ >= num_chunk_types
            is_b = (not is_o) and t % 2 == 0
            ends = start is not None and (is_o or is_b or typ != ctype)
            if ends:
                chunks.append((start, i - 1, ctype))
                start = ctype = None
            if not is_o and start is None:  # B, or stray/other-type I
                start, ctype = i, typ
        if start is not None:
            chunks.append((start, len(tags) - 1, ctype))
        return set(chunks)

    def update(self, *args):
        args = tuple(_np(a) if isinstance(a, torch.Tensor) else a
                     for a in args)
        # count-tuple form: three scalar chunk counts, as emitted by the
        # chunk_eval op — 0-d scalars or size-1 arrays (fluid fetch results
        # arrive shaped (1,))
        if len(args) == 3 and np.ndim(args[0]) <= 1 and all(
                np.size(a) == 1 and np.ndim(a) <= 1 for a in args):
            # tag-sequence updates are always 2-D [B, T]; three size-1
            # low-rank values can only be the count-tuple form
            infer, label, correct = args
            self.num_infer += int(np.asarray(infer).ravel()[0])
            self.num_label += int(np.asarray(label).ravel()[0])
            self.num_correct += int(np.asarray(correct).ravel()[0])
            return
        pred, gold, lengths = args
        if self.num_chunk_types is None:
            raise ValueError(
                "ChunkEvaluator(num_chunk_types=...) is required for "
                "tag-sequence updates (count-tuple updates work without)")
        pred, gold = _np(pred), _np(gold)
        if pred.ndim != 2:
            raise ValueError(
                "ChunkEvaluator tag-sequence updates take 2-D [B, T] "
                f"pred/label tags (got ndim={pred.ndim}); pass counts as "
                "three scalars/size-1 arrays instead")
        lengths = _np(lengths).reshape(-1).astype(int)
        for b, n in enumerate(lengths):
            pc = self.extract_chunks(pred[b][:n], self.num_chunk_types)
            gc = self.extract_chunks(gold[b][:n], self.num_chunk_types)
            self.num_infer += len(pc)
            self.num_label += len(gc)
            self.num_correct += len(pc & gc)

    def accumulate(self):
        p = self.num_correct / self.num_infer if self.num_infer else 0.0
        r = self.num_correct / self.num_label if self.num_label else 0.0
        f1 = 2 * p * r / (p + r) if p + r else 0.0
        return p, r, f1


class CompositeMetric(Metric):
    """fluid/metrics.py CompositeMetric parity: fan one update out to
    several sub-metrics."""

    def __init__(self, *metrics, name=None):
        super().__init__(name or "composite")
        self._metrics = list(metrics)

    def add_metric(self, metric):
        self._metrics.append(metric)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def update(self, *args):
        for m in self._metrics:
            m.update(*args)

    def accumulate(self):
        return [m.accumulate() for m in self._metrics]


class DetectionMAP(Metric):
    """Streaming mean average precision for detection (reference
    fluid/metrics.py DetectionMAP + operators/detection/detection_map_op
    role, computed host-side from the static multiclass_nms outputs —
    see EXCLUDED_OPS['detection_map']).

    update(detections, gt_boxes, gt_labels, difficult=None) per image:
      detections  [K, 6] rows [label, score, x1, y1, x2, y2] (padded
                  rows with label < 0 are skipped — the static NMS form)
      gt_boxes    [G, 4], gt_labels [G]
    accumulate() -> mAP in [0, 1] over the stream so far.
    """

    def __init__(self, overlap_threshold=0.5, evaluate_difficult=False,
                 ap_version="integral", name=None):
        self._thr = float(overlap_threshold)
        self._eval_difficult = evaluate_difficult
        self._ap_version = ap_version
        self._name = name or "detection_map"
        self.reset()

    def reset(self):
        self._dets = {}     # label -> list of (score, matched)
        self._npos = {}     # label -> #gt

    def name(self):
        return self._name

    def update(self, detections, gt_boxes, gt_labels, difficult=None):
        det = _np(detections)
        gtb = _np(gt_boxes).reshape(-1, 4)
        gtl = _np(gt_labels).reshape(-1).astype(int)
        diff = (_np(difficult).reshape(-1).astype(bool)
                if difficult is not None
                else np.zeros(len(gtl), bool))
        for lab in np.unique(gtl):
            n = ((gtl == lab) & (self._eval_difficult | ~diff)).sum()
            self._npos[lab] = self._npos.get(lab, 0) + int(n)
        det = det[det[:, 0] >= 0]
        order = np.argsort(-det[:, 1])
        taken = np.zeros(len(gtl), bool)
        for row in det[order]:
            lab = int(row[0])
            box = row[2:6]
            cand = np.where((gtl == lab) & ~taken)[0]
            best, best_iou = -1, self._thr
            for g in cand:
                bb = gtb[g]
                ix = max(0.0, min(box[2], bb[2]) - max(box[0], bb[0]))
                iy = max(0.0, min(box[3], bb[3]) - max(box[1], bb[1]))
                inter = ix * iy
                ua = ((box[2] - box[0]) * (box[3] - box[1])
                      + (bb[2] - bb[0]) * (bb[3] - bb[1]) - inter)
                iou = inter / ua if ua > 0 else 0.0
                if iou >= best_iou:
                    best, best_iou = g, iou
            matched = best >= 0
            if matched:
                if diff[best] and not self._eval_difficult:
                    continue  # difficult matches are ignored entirely
                taken[best] = True
            self._dets.setdefault(lab, []).append(
                (float(row[1]), bool(matched)))

    def accumulate(self):
        aps = []
        for lab, n_pos in self._npos.items():
            if n_pos == 0:
                continue
            rows = sorted(self._dets.get(lab, []), reverse=True)
            if not rows:
                aps.append(0.0)
                continue
            tp = np.cumsum([m for _, m in rows])
            fp = np.cumsum([not m for _, m in rows])
            rec = tp / n_pos
            prec = tp / np.maximum(tp + fp, 1)
            if self._ap_version == "11point":
                ap = float(np.mean([
                    prec[rec >= t].max() if (rec >= t).any() else 0.0
                    for t in np.linspace(0, 1, 11)]))
            else:  # integral
                ap = float(np.sum((rec[1:] - rec[:-1]) * prec[1:])
                           + rec[0] * prec[0])
            aps.append(ap)
        return float(np.mean(aps)) if aps else 0.0
