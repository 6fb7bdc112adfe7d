"""The bbox COCO evaluator of the `--save-json` path, in numpy
(counterpart of yolosomi_tpu/utils/cocoeval.py:32-204).

The published COCO detection protocol: greedy score-ordered matching per
(image, category) at 10 IoU thresholds, iscrowd-aware IoU, 101-point
precision interpolation over recall, area ranges, maxDets caps, and the
standard 12-number summary. The port always uses this copy: pycocotools
is not a dependency.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_xywh(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """(D,4) x (G,4) xywh IoU; for crowd gts the denominator is the
    detection area only (COCO 'iou = i / union or i / d-area')."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.clip(np.minimum(dx2[:, None], gx2[None]) - np.maximum(dx1[:, None], gx1[None]), 0, None)
    ih = np.clip(np.minimum(dy2[:, None], gy2[None]) - np.maximum(dy1[:, None], gy1[None]), 0, None)
    inter = iw * ih
    da = (dt[:, 2] * dt[:, 3])[:, None]
    ga = (gt[:, 2] * gt[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), da, da + ga - inter)
    return inter / np.maximum(union, 1e-10)


class COCOEvaluator:
    """gt: COCO annotation dict (images/annotations/categories);
    dt: list of prediction dicts (image_id, category_id, bbox, score)."""

    def __init__(self, gt: dict, dt: list):
        self.cat_ids = sorted({c["id"] for c in gt.get("categories", [])} or {a["category_id"] for a in gt["annotations"]})
        self.img_ids = sorted({im["id"] for im in gt.get("images", [])} or {a["image_id"] for a in gt["annotations"]})
        self._gts = defaultdict(list)
        for a in gt["annotations"]:
            if "area" not in a:
                a = dict(a, area=a["bbox"][2] * a["bbox"][3])
            self._gts[(a["image_id"], a["category_id"])].append(a)
        self._dts = defaultdict(list)
        for d in dt:
            self._dts[(d["image_id"], d["category_id"])].append(d)

    @classmethod
    def from_files(cls, ann_json, pred_json):
        gt = json.loads(Path(ann_json).read_text())
        dt = json.loads(Path(pred_json).read_text())
        return cls(gt, dt)

    def _evaluate_img(self, img_id, cat_id, area_rng, max_det):
        gts = self._gts[(img_id, cat_id)]
        dts = sorted(self._dts[(img_id, cat_id)], key=lambda d: -d["score"])[:max_det]
        if not gts and not dts:
            return None
        g_ignore = np.array(
            [bool(g.get("iscrowd", 0)) or not (area_rng[0] <= g["area"] < area_rng[1]) for g in gts],
            dtype=bool,
        )
        # sort gts: non-ignored first (COCO matching preference)
        order = np.argsort(g_ignore, kind="stable")
        gts = [gts[i] for i in order]
        g_ignore = g_ignore[order]
        iscrowd = np.array([int(g.get("iscrowd", 0)) for g in gts])
        gbox = np.array([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
        dbox = np.array([d["bbox"] for d in dts], np.float64).reshape(-1, 4)
        ious = _iou_xywh(dbox, gbox, iscrowd)

        T, D, G = len(IOU_THRS), len(dts), len(gts)
        dt_m = np.zeros((T, D), np.int64) - 1  # matched gt index
        gt_m = np.zeros((T, G), np.int64) - 1
        dt_ig = np.zeros((T, D), bool)
        for t, thr in enumerate(IOU_THRS):
            for di in range(D):
                best, best_g = min(thr, 1 - 1e-10), -1
                for gi in range(G):
                    if gt_m[t, gi] >= 0 and not iscrowd[gi]:
                        continue
                    # non-ignored match already found; stop at ignored gts
                    if best_g >= 0 and not g_ignore[best_g] and g_ignore[gi]:
                        break
                    if ious[di, gi] < best:
                        continue
                    best, best_g = ious[di, gi], gi
                if best_g >= 0:
                    dt_m[t, di] = best_g
                    gt_m[t, best_g] = di
                    dt_ig[t, di] = g_ignore[best_g]
        # unmatched dts outside the area range are ignored
        d_area = dbox[:, 2] * dbox[:, 3] if D else np.zeros(0)
        d_out = (d_area < area_rng[0]) | (d_area >= area_rng[1])
        dt_ig = dt_ig | ((dt_m == -1) & d_out[None])
        return {
            "scores": np.array([d["score"] for d in dts]),
            "dt_matched": dt_m >= 0,
            "dt_ignore": dt_ig,
            "n_gt": int((~g_ignore).sum()),
        }

    def accumulate(self):
        """precision[T, R, K, A, M] and recall[T, K, A, M] matrices."""
        T, R = len(IOU_THRS), len(REC_THRS)
        K, A, M = len(self.cat_ids), len(AREA_RNG), len(MAX_DETS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        for k, cat in enumerate(self.cat_ids):
            for a, rng in enumerate(AREA_RNG.values()):
                for m, max_det in enumerate(MAX_DETS):
                    evals = [self._evaluate_img(i, cat, rng, max_det) for i in self.img_ids]
                    evals = [e for e in evals if e is not None]
                    if not evals:
                        continue
                    n_gt = sum(e["n_gt"] for e in evals)
                    if n_gt == 0:
                        continue
                    scores = np.concatenate([e["scores"] for e in evals])
                    order = np.argsort(-scores, kind="mergesort")
                    matched = np.concatenate([e["dt_matched"] for e in evals], axis=1)[:, order]
                    ignored = np.concatenate([e["dt_ignore"] for e in evals], axis=1)[:, order]
                    tps = matched & ~ignored
                    fps = ~matched & ~ignored
                    tp_cum = tps.cumsum(axis=1).astype(np.float64)
                    fp_cum = fps.cumsum(axis=1).astype(np.float64)
                    for t in range(T):
                        tp, fp = tp_cum[t], fp_cum[t]
                        rc = tp / n_gt
                        pr = tp / np.maximum(tp + fp, 1e-10)
                        recall[t, k, a, m] = rc[-1] if len(rc) else 0.0
                        # monotone envelope then sample at REC_THRS
                        q = np.zeros(R)
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            pr[i - 1] = max(pr[i - 1], pr[i])
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precision[t, :, k, a, m] = q
        self.precision, self.recall = precision, recall
        return self

    def _ap(self, iou=None, area="all", max_det=100):
        a = list(AREA_RNG).index(area)
        m = MAX_DETS.index(max_det)
        p = self.precision[..., a, m]
        if iou is not None:
            p = p[[np.argmin(np.abs(IOU_THRS - iou))]]
        p = p[p > -1]
        return float(p.mean()) if p.size else -1.0

    def _ar(self, area="all", max_det=100):
        a = list(AREA_RNG).index(area)
        m = MAX_DETS.index(max_det)
        r = self.recall[:, :, a, m]
        r = r[r > -1]
        return float(r.mean()) if r.size else -1.0

    def summarize(self, log=print):
        """The standard 12 COCO stats; returns the array."""
        s = np.array(
            [
                self._ap(),
                self._ap(iou=0.5),
                self._ap(iou=0.75),
                self._ap(area="small"),
                self._ap(area="medium"),
                self._ap(area="large"),
                self._ar(max_det=1),
                self._ar(max_det=10),
                self._ar(max_det=100),
                self._ar(area="small"),
                self._ar(area="medium"),
                self._ar(area="large"),
            ]
        )
        names = [
            "AP@[.5:.95]", "AP@0.5", "AP@0.75", "AP small", "AP medium", "AP large",
            "AR max=1", "AR max=10", "AR max=100", "AR small", "AR medium", "AR large",
        ]
        for n, v in zip(names, s):
            log(f"  {n:<12} = {v:.4f}")
        self.stats = s
        return s
