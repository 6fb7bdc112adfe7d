"""Box geometry: format conversions, letterbox-inverse rescaling, clipping,
and the IoU matrix of the NMS (counterparts of
yolosomi_tpu/utils/boxes.py:21-140 and utils/iou.py:128).

The converters work on numpy arrays (the host data pipeline and the eval
loop) and on torch tensors (the postprocess); the array namespace follows
the input's type, as `_xp` does in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def _xp(x):
    return torch if isinstance(x, torch.Tensor) else np


def xyxy2xywh(x):
    """(x1, y1, x2, y2) -> (xc, yc, w, h)."""
    xc = (x[..., 0] + x[..., 2]) / 2
    yc = (x[..., 1] + x[..., 3]) / 2
    w = x[..., 2] - x[..., 0]
    h = x[..., 3] - x[..., 1]
    return _xp(x).stack([xc, yc, w, h], axis=-1)


def xywh2xyxy(x):
    """(xc, yc, w, h) -> (x1, y1, x2, y2)."""
    hw = x[..., 2] / 2
    hh = x[..., 3] / 2
    return _xp(x).stack([x[..., 0] - hw, x[..., 1] - hh, x[..., 0] + hw, x[..., 1] + hh], axis=-1)


def xywhn2xyxy(x, w=640, h=640, padw=0, padh=0):
    """Normalized (xc, yc, w, h) -> pixel (x1, y1, x2, y2), shifted by the pad."""
    return _xp(x).stack(
        [
            w * (x[..., 0] - x[..., 2] / 2) + padw,
            h * (x[..., 1] - x[..., 3] / 2) + padh,
            w * (x[..., 0] + x[..., 2] / 2) + padw,
            h * (x[..., 1] + x[..., 3] / 2) + padh,
        ],
        axis=-1,
    )


def xyxy2xywhn(x, w=640, h=640, clip=False, eps=0.0):
    """Pixel (x1, y1, x2, y2) -> normalized (xc, yc, w, h), optionally
    clipped to (h - eps, w - eps) first."""
    if clip:
        x = clip_coords(x, (h - eps, w - eps))
    return _xp(x).stack(
        [
            ((x[..., 0] + x[..., 2]) / 2) / w,
            ((x[..., 1] + x[..., 3]) / 2) / h,
            (x[..., 2] - x[..., 0]) / w,
            (x[..., 3] - x[..., 1]) / h,
        ],
        axis=-1,
    )


def clip_coords(boxes, shape):
    """Clip xyxy boxes to an image of shape (h, w)."""
    xp = _xp(boxes)
    h, w = shape[0], shape[1]
    return xp.stack(
        [
            xp.clip(boxes[..., 0], 0, w),
            xp.clip(boxes[..., 1], 0, h),
            xp.clip(boxes[..., 2], 0, w),
            xp.clip(boxes[..., 3], 0, h),
        ],
        axis=-1,
    )


def scale_coords(img1_shape, coords, img0_shape, ratio_pad=None):
    """Rescale xyxy coords from the letterboxed `img1_shape` (h, w) back to
    the original `img0_shape`, then clip to it. `ratio_pad` is the
    dataset's ((rh, rw), (padw, padh)); without it the letterbox is
    recomputed from the two shapes."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad = ((img1_shape[1] - img0_shape[1] * gain) / 2, (img1_shape[0] - img0_shape[0] * gain) / 2)
    else:
        gain = ratio_pad[0][0]
        pad = ratio_pad[1]
    out = _xp(coords).stack(
        [
            (coords[..., 0] - pad[0]) / gain,
            (coords[..., 1] - pad[1]) / gain,
            (coords[..., 2] - pad[0]) / gain,
            (coords[..., 3] - pad[1]) / gain,
        ],
        axis=-1,
    )
    return clip_coords(out, img0_shape)


def letterbox_params(shape, new_shape=(640, 640), scaleup=True, stride=32, auto=False, scalefill=False):
    """The geometry of a letterbox: (ratio (rw, rh), new_unpad (w, h),
    (dw, dh)), where dw, dh are half the total padding of each axis."""
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)
    ratio = (r, r)
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    if auto:  # minimal rectangle, padded to a stride multiple
        dw, dh = dw % stride, dh % stride
    elif scalefill:  # stretch
        dw, dh = 0.0, 0.0
        new_unpad = (new_shape[1], new_shape[0])
        ratio = (new_shape[1] / shape[1], new_shape[0] / shape[0])
    return ratio, new_unpad, (dw / 2, dh / 2)


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


def box_candidates(box1, box2, wh_thr=2, ar_thr=20, area_thr=0.1, eps=1e-16):
    """The boxes an augmentation keeps: box1 (4, n) before, box2 (4, n)
    after, xyxy pixels. Kept where the new box is over wh_thr px a side,
    keeps over area_thr of its area and has an aspect ratio under ar_thr."""
    xp = _xp(box2)
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = xp.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


def bbox_ioa(box1: np.ndarray, box2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Intersection over box2's area: box1 (4,) against box2 (n, 4), xyxy,
    in float32 as the JAX package computes it."""
    box1, box2 = np.asarray(box1, np.float32), np.asarray(box2, np.float32)
    inter = np.clip(np.minimum(box1[2], box2[:, 2]) - np.maximum(box1[0], box2[:, 0]), 0, None) * \
        np.clip(np.minimum(box1[3], box2[:, 3]) - np.maximum(box1[1], box2[:, 1]), 0, None)
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1]) + np.float32(eps)
    return inter / area2
