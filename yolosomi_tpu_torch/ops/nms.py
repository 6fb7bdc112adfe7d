"""Postprocess: the serving path's fused score -> top-k -> decode-k ->
exact tiled NMS, and the eval path's NMS over decoded rows with its
multi-label mode (counterparts of yolosomi_tpu/ops/nms.py:84-260 and
:306-383); and Gaussian soft-NMS's score decay (:259-303).

The keep-set is the JAX package's: greedy NMS in score order with a
strict `>` on both the confidence and the IoU threshold, per-class by the
class-offset trick (+cls * MAX_WH). Candidates are chosen by `top_k`, a
stable descending sort: of two equal scores the lower index comes first,
as in jax.lax.top_k, so exact ties (a saturated sigmoid gives many scores
of exactly 1.0) order as in the JAX package and the same on every run.
JAX's while_loops become Python loops over tensors on the device; their
conditions sync with the host.

Outputs are padded to (max_det, 6) rows [x1, y1, x2, y2, conf, cls]; padded
rows are all zeros, so a row is valid iff conf > 0.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from yolosomi_tpu_torch.utils.boxes import box_iou, xywh2xyxy
from yolosomi_tpu_torch.utils.iou import bbox_iou

MAX_WH = 4096.0  # class-offset multiplier: boxes of different classes never overlap


def top_k(scores: torch.Tensor, k: int):
    """The k largest scores along the last axis and their indices, in
    descending order; equal scores keep their index order."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _self_suppress(E: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Resolve within-tile greedy suppression from the edge matrix
    E[i, j] (i outranks j and overlaps it above the threshold): rows with no
    incoming edge are final keepers, what they point at is final dead and
    loses its outgoing edges; repeat until nothing changes. The fixed point
    equals sequential greedy NMS."""
    dead = ~alive
    E = E & alive[:, None]
    while True:
        clean = ~E.any(0)
        kill = (E & clean[:, None]).any(0) & ~dead
        if not bool(kill.any()):
            return alive & ~dead
        dead = dead | kill
        E = E & ~dead[:, None]


def _nms_single_tiled(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float, max_det: int,
                      tile: int = 512):
    """Exact greedy NMS over score-sorted (K, 4) xyxy boxes (class-offset
    already added) in tiles of `tile`. Returns (max_det,) kept indices into
    `boxes` (-1 past the count) and the (max_det,) validity mask."""
    K = boxes.shape[0]
    T = min(tile, K)
    dev = boxes.device
    rank = torch.arange(T, device=dev)
    upper = rank[:, None] < rank[None, :]  # i suppresses j only when i < j
    keep_idx = torch.full((max_det,), -1, dtype=torch.long, device=dev)
    buf = boxes.new_zeros((0, 4))
    count = 0
    for t0 in range(0, K, T):
        if count >= max_det or not bool(scores[t0] > 0):
            break  # tiles are score-sorted: an empty first slot ends the walk
        tb = boxes[t0:t0 + T]
        tsc = scores[t0:t0 + T]
        n = tb.shape[0]
        sup = (box_iou(tb, buf) > iou_thres).any(1)
        alive = (tsc > 0) & ~sup
        tbz = torch.where(alive[:, None], tb, torch.zeros_like(tb))
        E = (box_iou(tbz, tbz) > iou_thres) & upper[:n, :n]
        alive = _self_suppress(E, alive)
        kept = torch.nonzero(alive).flatten()[: max_det - count]
        keep_idx[count:count + kept.numel()] = t0 + kept
        buf = torch.cat([buf, tb[kept]], 0)
        count += kept.numel()
    return keep_idx, torch.arange(max_det, device=dev) < count


def fused_postprocess(
    preds: Sequence[torch.Tensor],  # raw level maps (B, ny, nx, na, 5 + nc)
    anchors_px,  # (nl, na, 2) pixel anchors
    strides: Sequence[float],
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    classes: Optional[torch.Tensor] = None,  # (nc,) bool mask of allowed classes
    agnostic: bool = False,
    max_det: int = 300,
    max_nms: int = 4096,
) -> torch.Tensor:
    """Score the whole grid, keep the top `max_nms`, decode only those and
    run the tiled exact NMS (single-label). Returns (B, max_det, 6) float32."""
    b = preds[0].shape[0]
    dev = preds[0].device
    anchors_px = torch.as_tensor(np.asarray(anchors_px, np.float32), device=dev)
    allowed = None if classes is None else torch.as_tensor(classes, dtype=torch.bool, device=dev)

    conf_parts, cls_parts, traw_parts, mesh_parts, anc_parts, stride_parts = [], [], [], [], [], []
    for i, p in enumerate(preds):
        _, ny, nx, na, _ = p.shape
        y = torch.sigmoid(p[..., 4:].float())  # obj + cls only
        conf = y[..., 0:1] * y[..., 1:]
        if allowed is not None:
            # mask disallowed classes BEFORE the argmax, so a box whose best
            # class is filtered still surfaces its best allowed class
            conf = torch.where(allowed, conf, torch.zeros_like(conf))
        best, bestc = conf.max(-1)
        conf_parts.append(best.reshape(b, -1))
        cls_parts.append(bestc.reshape(b, -1).float())
        traw_parts.append(p[..., :4].reshape(b, -1, 4))
        gy, gx = torch.meshgrid(torch.arange(ny, dtype=torch.float32, device=dev),
                                torch.arange(nx, dtype=torch.float32, device=dev), indexing="ij")
        mesh_parts.append(torch.stack([gx, gy], -1)[:, :, None, :].expand(ny, nx, na, 2).reshape(-1, 2))
        anc_parts.append(anchors_px[i][None].expand(ny * nx, na, 2).reshape(-1, 2))
        stride_parts.append(torch.full((ny * nx * na,), float(strides[i]), device=dev))

    scores = torch.cat(conf_parts, 1)  # (B, N)
    clss = torch.cat(cls_parts, 1)
    traw = torch.cat(traw_parts, 1)  # (B, N, 4) raw box channels
    mesh = torch.cat(mesh_parts, 0)  # (N, 2)
    anc = torch.cat(anc_parts, 0)
    strd = torch.cat(stride_parts, 0)

    scores = torch.where(scores > conf_thres, scores, torch.zeros_like(scores))
    k = min(max_nms, scores.shape[1])
    top_scores, idx = top_k(scores, k)

    t = torch.gather(traw, 1, idx[..., None].expand(b, k, 4)).float()
    y = torch.sigmoid(t)
    xy = (y[..., :2] * 2.0 - 0.5 + mesh[idx]) * strd[idx][..., None]
    wh = torch.square(y[..., 2:4] * 2.0) * anc[idx]
    boxes = torch.cat([xy - wh / 2, xy + wh / 2], -1)  # xyxy
    cls_k = torch.gather(clss, 1, idx)
    offset = torch.zeros_like(cls_k) if agnostic else cls_k * MAX_WH
    offset_boxes = boxes + offset[..., None]

    out = torch.zeros((b, max_det, 6), dtype=torch.float32, device=dev)
    for i in range(b):
        keep_idx, keep_valid = _nms_single_tiled(offset_boxes[i], top_scores[i], iou_thres, max_det)
        kept = keep_idx[keep_valid]
        n = kept.numel()
        out[i, :n, :4] = boxes[i, kept]
        out[i, :n, 4] = top_scores[i, kept]
        out[i, :n, 5] = cls_k[i, kept]
    return out


def non_max_suppression(
    prediction: torch.Tensor,  # (B, N, 5 + nc) decoded rows [xc, yc, w, h, obj, cls...]
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    classes: Optional[torch.Tensor] = None,  # (nc,) bool mask of allowed classes
    multi_label: bool = False,
    agnostic: bool = False,
    max_det: int = 300,
    max_nms: int = 4096,
    exact: bool = False,
) -> torch.Tensor:
    """NMS over decoded rows -> (B, max_det, 6) float32 [x1, y1, x2, y2,
    conf, cls], padded with zeros; a row is valid iff conf > 0.

    Scores are cls * obj. Single-label keeps each row's best class;
    multi-label flattens the (N * nc) scores, so one box can survive once
    per class. Either way scores at or below `conf_thres` become 0 and the
    top min(max_nms, candidates) go to the tiled exact NMS. `exact` is
    accepted for the JAX signature and changes nothing: JAX's inexact
    selection (approx_max_k) is a TPU device feature, and `top_k` here is
    exact on every device."""
    del exact
    b, n, no = prediction.shape
    nc = no - 5
    dev = prediction.device
    pred = prediction.float()
    boxes = xywh2xyxy(pred[..., :4])  # (B, N, 4)
    cls_scores = pred[..., 5:] * pred[..., 4:5]  # (B, N, nc)
    if classes is not None:
        allowed = torch.as_tensor(classes, dtype=torch.bool, device=dev)
        cls_scores = torch.where(allowed, cls_scores, torch.zeros_like(cls_scores))

    if multi_label:
        flat = cls_scores.reshape(b, n * nc)
        flat = torch.where(flat > conf_thres, flat, torch.zeros_like(flat))
        scores, idx = top_k(flat, min(max_nms, n * nc))
        box_idx = torch.div(idx, nc, rounding_mode="floor")
        cls_idx = (idx % nc).float()
    else:
        best, best_cls = cls_scores.max(-1)
        best = torch.where(best > conf_thres, best, torch.zeros_like(best))
        scores, box_idx = top_k(best, min(max_nms, n))
        cls_idx = torch.gather(best_cls, 1, box_idx).float()
    cand = torch.gather(boxes, 1, box_idx[..., None].expand(*box_idx.shape, 4))
    offset = torch.zeros_like(cls_idx) if agnostic else cls_idx * MAX_WH
    offset_boxes = cand + offset[..., None]

    out = torch.zeros((b, max_det, 6), dtype=torch.float32, device=dev)
    for i in range(b):
        keep_idx, keep_valid = _nms_single_tiled(offset_boxes[i], scores[i], iou_thres, max_det)
        kept = keep_idx[keep_valid]
        m = kept.numel()
        out[i, :m, :4] = cand[i, kept]
        out[i, :m, 4] = scores[i, kept]
        out[i, :m, 5] = cls_idx[i, kept]
    return out


def soft_nms_scores(boxes: torch.Tensor, scores: torch.Tensor, sigma: float = 0.5, max_det: int = 300,
                    iou_thresh: float = 0.3, ciou: bool = True) -> torch.Tensor:
    """Gaussian soft-NMS (the reference's general.py:834-862, present but
    unwired there). min(max_det, K) times: take the live box with the top
    score (the lowest index on a tie), fix its score, and multiply the
    scores of the boxes that overlap it above `iou_thresh` by
    exp(-overlap^2 / sigma). Overlap is CIoU by default, as in the
    reference. Returns the decayed scores in input order; boxes never taken
    score 0. `boxes` is (K, 4) xyxy."""
    scores = torch.as_tensor(scores)
    boxes = torch.as_tensor(boxes, dtype=scores.dtype)
    live = scores.clone()
    final = torch.zeros_like(scores)
    for _ in range(min(max_det, boxes.shape[0])):
        j = int(torch.argmax(live))
        final[j] = live[j]
        if ciou:
            iou = bbox_iou(boxes[j][None], boxes, xywh=False, CIoU=True)
        else:
            iou = box_iou(boxes[j][None], boxes)[0]
        live = live * torch.where(iou > iou_thresh, torch.exp(-(iou**2) / sigma), torch.ones_like(iou))
        live[j] = 0.0
    return final
