"""The anchor-free (DetectV8 / DetectV11) loss with its task-aligned
assigner (counterpart of yolosomi_tpu/losses_v8.py).

The assignment is dense, as in the JAX package: (B, M, N) alignment
tensors over the M padded labels and the N anchors, masks instead of
ragged per-image loops.
  1. candidates: anchor centres inside the ground-truth box
  2. alignment = cls_score^0.5 * CIoU^6
  3. per ground truth the top 10 candidates by alignment (the lower anchor
     index first among equal values, as jax.lax.top_k)
  4. an anchor claimed by several keeps the one of highest IoU (the first
     of equal ones, as jnp.argmax)
  5. target score = alignment / its per-gt max * the per-gt max IoU
Loss = BCE(cls, target scores) / sum(target scores) + CIoU box + DFL, with
the gains box_v8 7.5, cls_v8 0.5, dfl 1.5 (hyp keys). Gradients flow
through the assignment's scores as they do in the JAX package (nothing is
stopped there). Everything runs in float32: the maps are cast, and the
train step calls the loss outside autocast.

Inside a data-parallel step (parallel.mesh.reducing) each rank returns its
share of the global batch's loss, as ComputeLoss does: the target-score
sum that normalises every term is summed over the ranks (differentiably)
and the batch size is the global one.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from yolosomi_tpu_torch.ops.nms import top_k
from yolosomi_tpu_torch.parallel import mesh
from yolosomi_tpu_torch.utils.iou import bbox_iou

INF = 1e9


def make_anchor_points(shapes, strides, offset: float = 0.5, device=None):
    """Per-level cell centres, concatenated: (N, 2) in level-grid units and
    (N,) the stride of each. shapes [(ny, nx), ...]."""
    pts, strs = [], []
    for (ny, nx), s in zip(shapes, strides):
        gy, gx = torch.meshgrid(torch.arange(ny, dtype=torch.float32, device=device) + offset,
                                torch.arange(nx, dtype=torch.float32, device=device) + offset, indexing="ij")
        pts.append(torch.stack([gx, gy], -1).reshape(-1, 2))
        strs.append(torch.full((ny * nx,), float(s), dtype=torch.float32, device=device))
    return torch.cat(pts), torch.cat(strs)


def dist2bbox(dist: torch.Tensor, anchor_points: torch.Tensor) -> torch.Tensor:
    """ltrb distances -> xyxy around the anchor points (same units)."""
    return torch.cat([anchor_points - dist[..., :2], anchor_points + dist[..., 2:]], -1)


def bbox2dist(bbox: torch.Tensor, anchor_points: torch.Tensor, reg_max: int) -> torch.Tensor:
    """xyxy -> ltrb distances, clamped to [0, reg_max - 1.01] (DFL targets)."""
    return torch.clamp(torch.cat([anchor_points - bbox[..., :2], bbox[..., 2:] - anchor_points], -1), 0,
                       reg_max - 1 - 0.01)


def _df_loss(pred_dist: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Distribution focal loss: cross-entropy against the two integer bins
    around the continuous target. pred_dist (..., 4, reg_max) logits,
    target (..., 4) -> (...,) the mean over the four sides."""
    tl = torch.floor(target).long()
    tr = tl + 1
    wl = tr.float() - target
    wr = 1.0 - wl
    logp = torch.log_softmax(pred_dist, -1)
    ll = torch.gather(logp, -1, tl[..., None])[..., 0]
    lr = torch.gather(logp, -1, torch.clamp(tr, max=pred_dist.shape[-1] - 1)[..., None])[..., 0]
    return -(ll * wl + lr * wr).mean(-1)


def task_aligned_assign(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, topk: int = 10,
                        alpha: float = 0.5, beta: float = 6.0, eps: float = 1e-9):
    """pd_scores (B, N, nc) probabilities, pd_bboxes (B, N, 4) xyxy,
    anc_points (N, 2), gt_labels (B, M) (-1: padding), gt_bboxes (B, M, 4)
    xyxy, all in one unit. Returns (target_labels (B, N), target_bboxes
    (B, N, 4), target_scores (B, N, nc), fg_mask (B, N))."""
    B, N, nc = pd_scores.shape
    mask_gt = gt_labels >= 0  # (B, M)

    # anchor centres inside the boxes: (B, M, N)
    lt = anc_points[None, None] - gt_bboxes[:, :, None, :2]
    rb = gt_bboxes[:, :, None, 2:] - anc_points[None, None]
    in_gts = torch.minimum(lt.amin(-1), rb.amin(-1)) > eps

    safe_labels = torch.clamp(gt_labels, min=0).long()
    cls_score = torch.gather(pd_scores.transpose(1, 2), 1, safe_labels[:, :, None].expand(-1, -1, N))  # (B, M, N)
    iou = torch.clamp(bbox_iou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :], xywh=False, CIoU=True), min=0.0)
    align = torch.pow(torch.clamp(cls_score, min=eps), alpha) * torch.pow(iou, beta)
    candidate = in_gts & mask_gt[:, :, None]
    align = torch.where(candidate, align, 0.0)

    # each ground truth's top-k candidates; a ground truth is dropped only
    # when its best alignment is ~0 (at init every alignment is small)
    topk_vals, topk_idx = top_k(align, min(topk, N))
    topk_valid = (topk_vals.amax(-1, keepdim=True) > eps) & (topk_vals > 0)
    mask_topk = torch.zeros_like(candidate).scatter_(2, topk_idx, topk_valid)
    mask_pos = mask_topk & candidate

    # an anchor claimed by several ground truths keeps the one of highest IoU
    best_gt = torch.argmax(torch.where(mask_pos, iou, -INF), 1)  # (B, N)
    fg_mask = mask_pos.any(1)
    target_labels = torch.where(fg_mask, torch.gather(safe_labels, 1, best_gt), 0)
    target_bboxes = torch.gather(gt_bboxes, 1, best_gt[..., None].expand(-1, -1, 4))

    pos_align = torch.where(mask_pos, align, 0.0)
    max_align = pos_align.amax(-1, keepdim=True)
    max_iou = torch.where(mask_pos, iou, 0.0).amax(-1, keepdim=True)
    norm_align = pos_align * max_iou / (max_align + eps)  # (B, M, N)
    score_val = torch.gather(norm_align, 1, best_gt[:, None, :])[:, 0]
    target_scores = F.one_hot(target_labels, nc).float() * torch.where(fg_mask, score_val, 0.0)[..., None]
    return target_labels, target_bboxes, target_scores, fg_mask


class ComputeLossV8:
    """The loss of the DFL heads, with ComputeLoss's contract:
    `loss(preds, targets) -> (total, components)`, preds the head's maps
    [(B, ny, nx, 4*reg_max + nc), ...], targets (B, M, 5) normalized
    [cls, x, y, w, h] with cls -1 padding; total the sum of the gained
    terms times the batch size, components the detached (3,)
    [box, dfl, cls]."""

    def __init__(self, meta, hyp: dict, reg_max: int = 16, topk: int = 10):
        self.nc, self.nl = meta.nc, meta.nl
        self.strides = tuple(float(s) for s in meta.strides)
        self.reg_max, self.topk = reg_max, topk
        self.box_gain = hyp.get("box_v8", 7.5)
        self.cls_gain = hyp.get("cls_v8", 0.5)
        self.dfl_gain = hyp.get("dfl", 1.5)

    def __call__(self, preds: Sequence[torch.Tensor], targets: torch.Tensor):
        reg_max, nc = self.reg_max, self.nc
        dev = preds[0].device
        targets = torch.as_tensor(targets, dtype=torch.float32, device=dev)
        B = preds[0].shape[0]
        imgsz_y, imgsz_x = preds[0].shape[1] * self.strides[0], preds[0].shape[2] * self.strides[0]
        anc_points, anc_strides = make_anchor_points([p.shape[1:3] for p in preds], self.strides, device=dev)
        N = anc_points.shape[0]
        flat = torch.cat([p.reshape(B, -1, 4 * reg_max + nc).float() for p in preds], 1)
        pred_dist = flat[..., :4 * reg_max].reshape(B, N, 4, reg_max)
        pred_logits = flat[..., 4 * reg_max:]

        bins = torch.arange(reg_max, dtype=torch.float32, device=dev)
        dist = (torch.softmax(pred_dist, -1) * bins).sum(-1)  # (B, N, 4) in each anchor's grid units
        pd_boxes_px = dist2bbox(dist, anc_points[None]) * anc_strides[None, :, None]

        gt_labels = targets[..., 0].long()
        cx, cy = targets[..., 1] * imgsz_x, targets[..., 2] * imgsz_y
        w, h = targets[..., 3] * imgsz_x, targets[..., 4] * imgsz_y
        gt_boxes_px = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
        _, target_bboxes_px, target_scores, fg_mask = task_aligned_assign(
            torch.sigmoid(pred_logits), pd_boxes_px, anc_points * anc_strides[:, None], gt_labels, gt_boxes_px,
            topk=self.topk)

        group = mesh.active()  # a data-parallel step: this rank's share of the global batch's loss
        ts_sum = target_scores.sum()
        if group is not None:
            ts_sum = mesh.all_reduce_sum(ts_sum)
        ts_sum = torch.clamp(ts_sum, min=1.0)
        bs = B * (group.world if group is not None else 1)

        # cls: BCE against the soft target scores over every anchor
        cls_loss = (torch.clamp(pred_logits, min=0) - pred_logits * target_scores
                    + torch.log1p(torch.exp(-pred_logits.abs()))).sum() / ts_sum
        # box: CIoU weighted by the target score on the foreground anchors
        weight = target_scores.sum(-1) * fg_mask
        iou = bbox_iou(pd_boxes_px, target_bboxes_px, xywh=False, CIoU=True)
        box_loss = ((1.0 - iou) * weight).sum() / ts_sum
        # dfl: the target distances in grid units
        target_ltrb = bbox2dist(target_bboxes_px / anc_strides[None, :, None], anc_points[None], reg_max)
        dfl_loss = (_df_loss(pred_dist, target_ltrb) * weight).sum() / ts_sum

        lbox, ldfl, lcls = box_loss * self.box_gain, dfl_loss * self.dfl_gain, cls_loss * self.cls_gain
        return (lbox + ldfl + lcls) * bs, torch.stack([lbox, ldfl, lcls]).detach()
