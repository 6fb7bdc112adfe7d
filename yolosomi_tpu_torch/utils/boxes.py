"""Box geometry used by the serving postprocess (counterparts of
yolosomi_tpu/utils/boxes.py:31 and utils/iou.py:128)."""

from __future__ import annotations

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(xc, yc, w, h) -> (x1, y1, x2, y2)."""
    hw = x[..., 2] / 2
    hh = x[..., 3] / 2
    return torch.stack([x[..., 0] - hw, x[..., 1] - hh, x[..., 0] + hw, x[..., 1] + hh], dim=-1)


def box_iou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Matrix IoU: box1 (N, 4) xyxy vs box2 (M, 4) xyxy -> (N, M)."""
    a1 = box1[:, None, :2]
    a2 = box1[:, None, 2:]
    b1 = box2[None, :, :2]
    b2 = box2[None, :, 2:]
    inter = (torch.minimum(a2, b2) - torch.maximum(a1, b1)).clamp(min=0).prod(-1)
    area1 = (box1[:, 2] - box1[:, 0]) * (box1[:, 3] - box1[:, 1])
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    return inter / (area1[:, None] + area2[None, :] - inter + eps)
