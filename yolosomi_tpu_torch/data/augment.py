"""The letterbox of the eval loader (counterpart of
yolosomi_tpu/data/augment.py:26-46). The training augmentations are
ROADMAP queue A item 5."""

from __future__ import annotations

import cv2
import numpy as np

from yolosomi_tpu_torch.utils.boxes import letterbox_params


def letterbox(
    im: np.ndarray,
    new_shape=(640, 640),
    color=(114, 114, 114),
    auto: bool = True,
    scale_fill: bool = False,
    scaleup: bool = True,
    stride: int = 32,
):
    """Ratio-preserving resize and pad. Returns (image, ratio, (dw, dh)),
    where dw, dh are half the padding; an odd padding puts the extra pixel
    right and bottom (`round(d -+ 0.1)`)."""
    shape = im.shape[:2]
    ratio, new_unpad, (dw, dh) = letterbox_params(
        shape, new_shape, scaleup=scaleup, stride=stride, auto=auto, scalefill=scale_fill
    )
    if shape[::-1] != new_unpad:
        im = cv2.resize(im, new_unpad, interpolation=cv2.INTER_LINEAR)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    im = cv2.copyMakeBorder(im, top, bottom, left, right, cv2.BORDER_CONSTANT, value=color)
    return im, ratio, (dw, dh)
