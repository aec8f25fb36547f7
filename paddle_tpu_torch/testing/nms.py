"""The near-threshold rule for comparing two runs of greedy NMS.

Two runs over the same candidates keep the same indices, unless an IoU
computed in another order rounds to the other side of the threshold.
`divergences` finds each row where two keep lists part and whether that
is such a case: where the lists first differ, the candidate(s) one run
kept and the other did not are held against every box both runs kept
before it, and the row counts as a near-threshold case when one of those
IoUs (in float64) lies within `tol` of the threshold. The CPU parity
tests and `chip_smoke.py` judge NMS outputs by it and print the cases.
"""
from __future__ import annotations

import torch

__all__ = ["divergences", "agree"]


def _iou64(a, b, normalized):
    off = 0.0 if normalized else 1.0
    a, b = a.double(), b.double()
    w = (torch.minimum(a[2], b[2]) - torch.maximum(a[0], b[0]) + off).clamp(
        min=0)
    h = (torch.minimum(a[3], b[3]) - torch.maximum(a[1], b[1]) + off).clamp(
        min=0)
    inter = w * h
    union = ((a[2] - a[0] + off) * (a[3] - a[1] + off)
             + (b[2] - b[0] + off) * (b[3] - b[1] + off) - inter)
    return float(inter / union) if union > 0 else 0.0


def divergences(boxes, keep_a, keep_b, thr, normalized=True, tol=1e-6):
    """Rows where keep_a and keep_b ([R, K] int, padded -1) differ, over
    boxes [R, N, 4] (or [N, 4] for every row): a list of dicts with the
    row, the first differing position, the candidates there, the IoU
    nearest the threshold among them and the earlier common picks, and
    whether it lies within tol (`near`)."""
    ka, kb = keep_a.reshape(-1, keep_a.shape[-1]).cpu(), \
        keep_b.reshape(-1, keep_b.shape[-1]).cpu()
    bx = boxes.cpu()
    out = []
    for r in (ka != kb).any(1).nonzero()[:, 0].tolist():
        p = int((ka[r] != kb[r]).nonzero()[0, 0])
        rb = bx if bx.dim() == 2 else bx[r]
        cands = [int(c) for c in {int(ka[r, p]), int(kb[r, p])} if c >= 0]
        best = None
        for c in cands:
            for k in ka[r, :p].tolist():
                iou = _iou64(rb[c], rb[k], normalized)
                if best is None or abs(iou - thr) < abs(best - thr):
                    best = iou
        out.append({"row": r, "at": p, "candidates": cands, "iou": best,
                    "near": best is not None and abs(best - thr) < tol})
    return out


def agree(boxes, keep_a, keep_b, thr, normalized=True, tol=1e-6):
    """(every difference a near-threshold case, the differences)."""
    d = divergences(boxes, keep_a, keep_b, thr, normalized, tol)
    return all(x["near"] for x in d), d
