"""Element-wise box IoU with the CIoU penalty (counterpart of
yolosomi_tpu/utils/iou.py:24 bbox_iou, its plain and CIoU branches; the
GIoU, DIoU, EIoU, SIoU and NWD variants are training losses, ROADMAP queue
A item 5)."""

from __future__ import annotations

import math

import torch


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

    inter = (torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(min=0) * \
        (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp(min=0)
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
