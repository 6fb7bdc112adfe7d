"""Weighted boxes fusion (Solovyev et al. 2021; counterpart of
yolosomi_tpu/ops/wbf.py:31), in numpy on the host: WBF is an offline
ensembling step over per-model label files, not a hot path.

Sort all predictions (scores times their model's weight) by score; a
prediction joins the first cluster of its label whose running fused box it
overlaps with IoU > iou_thr, else starts a cluster. A cluster's box is the
score-weighted mean of its members, and its score the mean (or max) member
score times the share of models that took part.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _iou(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    a = (box[2] - box[0]) * (box[3] - box[1])
    b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / (a + b - inter + 1e-9)


def weighted_boxes_fusion(
    boxes_list: Sequence[np.ndarray],  # per model: (n, 4) xyxy normalized to [0, 1]
    scores_list: Sequence[np.ndarray],
    labels_list: Sequence[np.ndarray],
    weights: Sequence[float] | None = None,
    iou_thr: float = 0.55,
    skip_box_thr: float = 0.0,
    conf_type: str = "avg",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fuse per-model predictions -> (boxes (m, 4), scores (m,), labels (m,)),
    by descending score. `conf_type` is "avg" or "max"."""
    n_models = len(boxes_list)
    weights = np.asarray([1.0] * n_models if weights is None else weights, np.float64)

    rows = []  # [label, weighted score, model weight, model index, x1, y1, x2, y2]
    for mi, (b, s, l) in enumerate(zip(boxes_list, scores_list, labels_list)):
        b = np.asarray(b, np.float64).reshape(-1, 4)
        s = np.asarray(s, np.float64).reshape(-1)
        l = np.asarray(l, np.float64).reshape(-1)  # noqa: E741
        keep = s > skip_box_thr
        for bb, ss, ll in zip(b[keep], s[keep], l[keep]):
            rows.append((ll, ss * weights[mi], weights[mi], mi, *bb))
    if not rows:
        return np.zeros((0, 4)), np.zeros(0), np.zeros(0)
    rows = np.array(rows, np.float64)
    rows = rows[rows[:, 1].argsort()[::-1]]

    fused: List[np.ndarray] = []  # the running fused row of each cluster
    members: List[List[np.ndarray]] = []
    for row in rows:
        matched = -1
        if fused:
            ious = _iou(row[4:8], np.array([f[4:8] for f in fused]))
            ious[np.array([f[0] for f in fused]) != row[0]] = 0.0
            j = int(np.argmax(ious))
            if ious[j] > iou_thr:
                matched = j
        if matched < 0:
            fused.append(row.copy())
            members.append([row])
        else:
            members[matched].append(row)
            mem = np.array(members[matched])
            w = mem[:, 1]
            f = fused[matched]
            f[4:8] = (mem[:, 4:8] * w[:, None]).sum(0) / w.sum()
            f[1] = w.mean() if conf_type == "avg" else w.max()
            f[2] = mem[:, 2].sum()

    out_boxes, out_scores, out_labels = [], [], []
    for f, mem in zip(fused, members):
        mem = np.array(mem)
        score = float(mem[:, 1].mean() if conf_type == "avg" else mem[:, 1].max())
        score *= min(len(np.unique(mem[:, 3])), n_models) / n_models  # the paper's T / N factor
        out_boxes.append(f[4:8])
        out_scores.append(score)
        out_labels.append(f[0])
    order = np.argsort(out_scores)[::-1]
    return np.array(out_boxes)[order], np.array(out_scores)[order], np.array(out_labels)[order]
