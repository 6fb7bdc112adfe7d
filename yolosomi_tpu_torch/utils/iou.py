"""Element-wise box IoU with the CIoU penalty, and the normalized
Wasserstein distance (counterparts of yolosomi_tpu/utils/iou.py:24
bbox_iou, its plain and CIoU branches, and :162-199 wasserstein_loss and
wasserstein). The training loss uses CIoU and, with the `nwdloss` hyp,
blends in NWD. The GIoU, DIoU, EIoU and SIoU variants are not used by the
loss and are not ported."""

from __future__ import annotations

import math

import torch


def _clip0(d: torch.Tensor) -> torch.Tensor:
    """max(d, 0) with the derivative of `jnp.clip(d, 0, None)`: 1/2 at
    d = 0 (where boxes touch), as JAX gives it; torch's clamp gives 1. The
    same values for finite d."""
    return 0.5 * (d + d.abs())


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True, CIoU: bool = False, alpha: float = 1.0,
             eps: float = 1e-7) -> torch.Tensor:
    """IoU (or CIoU) of aligned boxes of broadcastable shapes (..., 4),
    (xc, yc, w, h) when `xywh`, else (x1, y1, x2, y2). Both branches add
    eps to both heights, as the reference does: without it a zero height
    makes CIoU's arctan(w / h) and its gradient NaN."""
    if xywh:
        x1, y1, w1, h1 = box1.unbind(-1)
        x2, y2, w2, h2 = box2.unbind(-1)
        b1x1, b1x2, b1y1, b1y2 = x1 - w1 / 2, x1 + w1 / 2, y1 - h1 / 2, y1 + h1 / 2
        b2x1, b2x2, b2y1, b2y2 = x2 - w2 / 2, x2 + w2 / 2, y2 - h2 / 2, y2 + h2 / 2
        h1, h2 = h1 + eps, h2 + eps
    else:
        b1x1, b1y1, b1x2, b1y2 = box1.unbind(-1)
        b2x1, b2y1, b2x2, b2y2 = box2.unbind(-1)
        w1, h1 = b1x2 - b1x1, b1y2 - b1y1 + eps
        w2, h2 = b2x2 - b2x1, b2y2 - b2y1 + eps

    inter = _clip0(torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)) * \
        _clip0(torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1))
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if alpha != 1.0:
        iou = torch.pow(iou + eps, alpha)
    if not CIoU:
        return iou

    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)  # enclosing box
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    c2 = cw**2 + ch**2 + eps  # its diagonal squared
    rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2 + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
    v = (4 / math.pi**2) * torch.square(torch.atan(w2 / h2) - torch.atan(w1 / h1))
    with torch.no_grad():  # the trade-off coefficient is a constant for gradients
        # v + (1 - iou) + eps >= eps in exact arithmetic; f32 can put iou one
        # ulp above 1 and cancel it, so the denominator is clamped
        alpha_ciou = v / torch.clamp(v - iou + (1 + eps), min=1e-8)
    return iou - (torch.pow(rho2 / c2, alpha) + torch.pow(v * alpha_ciou + eps, alpha))


def _nwd_terms(pred: torch.Tensor, target: torch.Tensor, eps: float):
    """Widths, heights (+eps on the heights only, as the reference) and
    centres of xyxy boxes."""
    w1, h1 = pred[..., 2] - pred[..., 0], pred[..., 3] - pred[..., 1] + eps
    w2, h2 = target[..., 2] - target[..., 0], target[..., 3] - target[..., 1] + eps
    cx1, cy1 = (pred[..., 0] + pred[..., 2]) / 2, (pred[..., 1] + pred[..., 3]) / 2
    cx2, cy2 = (target[..., 0] + target[..., 2]) / 2, (target[..., 1] + target[..., 3]) / 2
    return w1, h1, w2, h2, cx1, cy1, cx2, cy2


def wasserstein_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-7,
                     constant: float = 12.8) -> torch.Tensor:
    """NWD similarity exp(-W2 / C) of xyxy boxes, element-wise over (..., 4)."""
    w1, h1, w2, h2, cx1, cy1, cx2, cy2 = _nwd_terms(pred, target, eps)
    center_dist = (cx1 - cx2) ** 2 + (cy1 - cy2) ** 2 + eps
    wh_dist = ((w1 - w2) ** 2 + (h1 - h2) ** 2) / 4
    return torch.exp(-torch.sqrt(center_dist + wh_dist) / constant)


def wasserstein(pred: torch.Tensor, target: torch.Tensor, scale1: float = 0.0, eps: float = 1e-7,
                constant: float = 2.5) -> torch.Tensor:
    """Shape-weighted NWD (the `shapeloss` hyp's variant). With scale1 = 0
    both shape weights are 1."""
    w1, h1, w2, h2, cx1, cy1, cx2, cy2 = _nwd_terms(pred, target, eps)
    w2s, h2s = torch.pow(w2, scale1), torch.pow(h2, scale1)
    ww, hh = 2 * w2s / (w2s + h2s), 2 * h2s / (w2s + h2s)
    center_dist = hh * (cx1 - cx2) ** 2 + ww * (cy1 - cy2) ** 2 + eps
    wh_dist = ((w1 - w2) ** 2 + (h1 - h2) ** 2) / 4
    return torch.exp(-torch.sqrt(center_dist + wh_dist) / constant)
