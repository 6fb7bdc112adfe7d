"""Detection metrics: the mAP protocol, fitness, TP matching and the
confusion matrix (counterpart of yolosomi_tpu/utils/metrics.py:23-196).

Host numpy code, the same arithmetic as the JAX package's: a 1000-point
confidence grid for the PR curves, 101-point interpolated AP, P and R at
the F1-argmax operating point, fitness weights [0.1, 0.1, 0.1, 0.7] over
(P, R, mAP@.5, mAP@.5:.95), greedy unique IoU matching at the 10
thresholds 0.5:0.95 and its alpha-IoU variant. The plots (matplotlib) are
ROADMAP queue A item 9(b).
"""

from __future__ import annotations

import numpy as np

EPS = 1e-16


def fitness(x: np.ndarray, aiou: bool = False) -> float:
    """Weighted fitness of [P, R, mAP@.5, mAP@.5:.95] (reference:
    metrics.py:15-18; metrics_aIoU.py:15 uses [0,0,0.1,0.9])."""
    w = np.array([0.0, 0.0, 0.1, 0.9]) if aiou else np.array([0.1, 0.1, 0.1, 0.7])
    return float((np.asarray(x)[:4] * w).sum())


def smooth(y: np.ndarray, f: float = 0.05) -> np.ndarray:
    """Box-filter smoothing (reference: metrics.py smooth)."""
    nf = round(len(y) * f * 2) // 2 + 1
    p = np.ones(nf // 2)
    yp = np.concatenate((p * y[0], y, p * y[-1]), 0)
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


def compute_ap(recall: np.ndarray, precision: np.ndarray):
    """AP from raw PR points: sentinel-append, monotone precision envelope,
    101-point interpolation (reference: metrics.py:79-95)."""
    # sentinel 1.0 (NOT the newer-upstream recall[-1]+0.01): exact protocol
    # parity with reference metrics.py:79-81
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = np.trapezoid(np.interp(x, mrec, mpre), x) if hasattr(np, "trapezoid") else np.trapz(
        np.interp(x, mrec, mpre), x
    )
    return ap, mpre, mrec


def ap_per_class(tp, conf, pred_cls, target_cls):
    """Per-class AP from accumulated (tp (N,10), conf (N,), pred_cls (N,),
    target_cls (M,)) statistics (reference: metrics.py:21-78).

    Returns (p, r, ap, f1, unique_classes) with p/r/f1 at the F1-argmax
    operating point and ap of shape (nc, 10).
    """
    i = np.argsort(-conf)
    tp, conf, pred_cls = tp[i], conf[i], pred_cls[i]
    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]

    px = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, tp.shape[1]))
    p = np.zeros((nc, 1000))
    r = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        mask = pred_cls == c
        n_l = nt[ci]
        n_p = mask.sum()
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[mask]).cumsum(0)
        tpc = tp[mask].cumsum(0)
        recall = tpc / (n_l + EPS)
        r[ci] = np.interp(-px, -conf[mask], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p[ci] = np.interp(-px, -conf[mask], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], _, _ = compute_ap(recall[:, j], precision[:, j])

    f1 = 2 * p * r / (p + r + EPS)
    # raw F1 argmax (NOT smoothed): exact protocol parity with reference
    # metrics.py:73 `i = f1.mean(0).argmax()`
    i = f1.mean(0).argmax()
    return p[:, i], r[:, i], ap, f1[:, i], unique_classes.astype(int)


def box_iou_np(box1: np.ndarray, box2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Matrix IoU in numpy: (N,4) x (M,4) xyxy -> (N,M)."""
    a1, a2 = box1[:, None, :2], box1[:, None, 2:]
    b1, b2 = box2[None, :, :2], box2[None, :, 2:]
    inter = np.clip(np.minimum(a2, b2) - np.maximum(a1, b1), 0, None).prod(2)
    area1 = (box1[:, 2] - box1[:, 0]) * (box1[:, 3] - box1[:, 1])
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    return inter / (area1[:, None] + area2[None, :] - inter + eps)


def alpha_box_iou_np(box1: np.ndarray, box2: np.ndarray, alpha: float = 3.0, eps: float = 1e-7):
    """alpha-IoU matrix (reference: metrics_aIoU.py:192-240, alpha=3)."""
    return np.power(box_iou_np(box1, box2, eps) + eps, alpha)


def process_batch(detections: np.ndarray, labels: np.ndarray, iouv: np.ndarray, alpha_iou: bool = False):
    """TP matrix at the 10 IoU thresholds (reference: val.py:50-71).

    detections: (N, 6) [x1,y1,x2,y2,conf,cls]; labels: (M, 5) [cls,x1,y1,x2,y2].
    Returns (N, len(iouv)) bool.
    """
    correct = np.zeros((detections.shape[0], iouv.shape[0]), dtype=bool)
    if detections.shape[0] == 0 or labels.shape[0] == 0:
        return correct
    iou = (
        alpha_box_iou_np(labels[:, 1:], detections[:, :4])
        if alpha_iou
        else box_iou_np(labels[:, 1:], detections[:, :4])
    )
    correct_class = labels[:, 0:1] == detections[None, :, 5]
    for i in range(len(iouv)):
        x = np.nonzero((iou >= iouv[i]) & correct_class)
        if x[0].shape[0]:
            matches = np.concatenate((np.stack(x, 1), iou[x[0], x[1]][:, None]), 1)
            if x[0].shape[0] > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            correct[matches[:, 1].astype(int), i] = True
    return correct


class ConfusionMatrix:
    """Greedy IoU>thr confusion matrix with background rows (reference:
    metrics.py:98-168)."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.matrix = np.zeros((nc + 1, nc + 1))
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres

    def process_batch(self, detections: np.ndarray, labels: np.ndarray):
        if detections is None or detections.shape[0] == 0:
            for gc in labels[:, 0].astype(int):
                self.matrix[self.nc, gc] += 1  # background FN
            return
        detections = detections[detections[:, 4] > self.conf]
        gt_classes = labels[:, 0].astype(int)
        det_classes = detections[:, 5].astype(int)
        if labels.shape[0] == 0:
            for dc in det_classes:
                self.matrix[dc, self.nc] += 1  # background FP
            return
        iou = box_iou_np(labels[:, 1:], detections[:, :4])
        x = np.nonzero(iou > self.iou_thres)
        if x[0].shape[0]:
            matches = np.concatenate((np.stack(x, 1), iou[x[0], x[1]][:, None]), 1)
            if x[0].shape[0] > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        else:
            matches = np.zeros((0, 3))
        n = matches.shape[0] > 0
        m0, m1, _ = matches.transpose().astype(int)
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if n and j.sum() == 1:
                self.matrix[det_classes[m1[j]][0], gc] += 1  # correct/miscls
            else:
                self.matrix[self.nc, gc] += 1  # background FN
        if n:
            for i, dc in enumerate(det_classes):
                if not (m1 == i).any():
                    self.matrix[dc, self.nc] += 1  # background FP

    def tp_fp(self):
        tp = self.matrix.diagonal()
        fp = self.matrix.sum(1) - tp
        return tp[:-1], fp[:-1]
