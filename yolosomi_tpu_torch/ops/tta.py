"""Test-time augmentation: multi-scale and flip inference with de-scaling
(counterpart of yolosomi_tpu/ops/tta.py).

Three passes at scales (1, 0.83, 0.67) with (none, lr-flip, none); each
pass's decoded rows are de-scaled and un-flipped, then the first pass
drops its coarsest level's rows and the last pass its finest level's
(`clip_augmented`), and the passes are concatenated along the rows.

Tensors are NCHW, as the port's models take them: the lr-flip is on W,
dim 3. The resize is antialiased bilinear, as `jax.image.resize(...,
"bilinear")` is when it shrinks; it runs in float32 (float64 stays
float64) and rounds once to the input's dtype.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F

from yolosomi_tpu_torch.models.layers import resize_linear

TTA_SCALES = (1.0, 0.83, 0.67)
TTA_FLIPS = (None, "lr", None)


def scale_img(img: torch.Tensor, ratio: float, gs: int = 32, pad_value: float = 0.447) -> torch.Tensor:
    """An NCHW batch resized by `ratio` (sizes truncated, int(h * ratio))
    and padded at the bottom and right with `pad_value` to the canvas
    ceil(h * ratio / gs) * gs."""
    if ratio == 1.0:
        return img
    h, w = img.shape[2:]
    nh, nw = int(h * ratio), int(w * ratio)
    ph = math.ceil(h * ratio / gs) * gs - nh
    pw = math.ceil(w * ratio / gs) * gs - nw
    return F.pad(resize_linear(img, (nh, nw)), (0, pw, 0, ph), value=pad_value)


def descale_pred(pred: torch.Tensor, flip: Optional[str], scale: float, img_w: int) -> torch.Tensor:
    """Undo the scale and the flip on decoded rows (B, N, no)
    [xc, yc, w, h, ...]."""
    xy = pred[..., :2] / scale
    wh = pred[..., 2:4] / scale
    if flip == "lr":
        xy = torch.stack([img_w - xy[..., 0], xy[..., 1]], -1)
    elif flip is not None:
        raise NotImplementedError(f"flip {flip!r}")
    return torch.cat([xy, wh, pred[..., 4:]], -1)


def clip_augmented(rows: List[torch.Tensor], nl: int) -> List[torch.Tensor]:
    """Drop the first pass's last N/g rows (its coarsest level) and the last
    pass's first 4**(nl-1) * N/g rows (its finest level), g = sum(4**i),
    on rows ordered level by level, finest first."""
    g = sum(4**x for x in range(nl))
    i = rows[0].shape[1] // g
    rows[0] = rows[0][:, :rows[0].shape[1] - i]
    i = (rows[-1].shape[1] // g) * 4 ** (nl - 1)
    rows[-1] = rows[-1][:, i:]
    return rows


def forward_augment(apply_decode: Callable[[torch.Tensor], torch.Tensor], images: torch.Tensor, nl: int,
                    gs: int = 32) -> torch.Tensor:
    """TTA over `apply_decode(images) -> (B, N, no)` decoded rows of an NCHW
    batch: the passes' rows in the input frame, concatenated (B, N_total, no)."""
    img_w = images.shape[3]
    rows = []
    for scale, flip in zip(TTA_SCALES, TTA_FLIPS):
        xi = images.flip(3) if flip == "lr" else images
        rows.append(descale_pred(apply_decode(scale_img(xi, scale, gs=gs)), flip, scale, img_w))
    return torch.cat(clip_augmented(rows, nl), 1)
