"""Image-space augmentations on the host, with numpy and cv2
(counterparts of yolosomi_tpu/data/augment.py:26-376): the letterbox,
and the training set's HSV jitter, perspective warp, mixup, SOMI's
copy-reduce-paste and the pixel plane of Albumentations.

Every random draw is made with Python's `random` or numpy's global
`np.random`, in the JAX package's order, so the same seeds give the same
bytes. Albumentations runs its native cv2 form (the JAX package's form
where the albumentations package is absent): Blur p 0.001, MedianBlur
0.01, ToGray 0.01, CLAHE 0.3, RandomBrightnessContrast 0.3.
"""

from __future__ import annotations

import math
import random
from typing import Optional, Tuple

import cv2
import numpy as np

from yolosomi_tpu_torch.utils.boxes import bbox_ioa, box_candidates, letterbox_params


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


def augment_hsv(im: np.ndarray, hgain=0.5, sgain=0.5, vgain=0.5) -> np.ndarray:
    """HSV jitter through look-up tables (one np.random.uniform draw of 3)."""
    if hgain or sgain or vgain:
        r = np.random.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
        hue, sat, val = cv2.split(cv2.cvtColor(im, cv2.COLOR_BGR2HSV))
        x = np.arange(0, 256, dtype=r.dtype)
        lut_hue = ((x * r[0]) % 180).astype(im.dtype)
        lut_sat = np.clip(x * r[1], 0, 255).astype(im.dtype)
        lut_val = np.clip(x * r[2], 0, 255).astype(im.dtype)
        im_hsv = cv2.merge((cv2.LUT(hue, lut_hue), cv2.LUT(sat, lut_sat), cv2.LUT(val, lut_val)))
        im = cv2.cvtColor(im_hsv, cv2.COLOR_HSV2BGR)
    return im


def perspective_params(h_in: int, w_in: int, degrees: float = 10, translate: float = 0.1, scale: float = 0.1,
                       shear: float = 10, perspective: float = 0.0, border: Tuple[int, int] = (0, 0)):
    """random_perspective's 3x3 matrix, drawn with Python's `random` in the
    reference's order (perspective, rotation and scale, shear, translation).
    Returns (M, the scale drawn, output width, output height)."""
    height = h_in + border[0] * 2
    width = w_in + border[1] * 2
    C = np.eye(3)
    C[0, 2] = -w_in / 2
    C[1, 2] = -h_in / 2
    P = np.eye(3)
    P[2, 0] = random.uniform(-perspective, perspective)
    P[2, 1] = random.uniform(-perspective, perspective)
    R = np.eye(3)
    a = random.uniform(-degrees, degrees)
    s = random.uniform(1 - scale, 1 + scale)
    R[:2] = cv2.getRotationMatrix2D(angle=a, center=(0, 0), scale=s)
    S = np.eye(3)
    S[0, 1] = math.tan(random.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(random.uniform(-shear, shear) * math.pi / 180)
    T = np.eye(3)
    T[0, 2] = random.uniform(0.5 - translate, 0.5 + translate) * width
    T[1, 2] = random.uniform(0.5 - translate, 0.5 + translate) * height
    M = T @ S @ R @ P @ C
    return M, s, width, height


def warp_labels(targets: np.ndarray, M: np.ndarray, s: float, width: int, height: int, perspective: float = 0.0):
    """(n, 5) [cls, x1, y1, x2, y2] pixel boxes through M: the corners'
    bounding box, clipped to the output, then box_candidates' filter."""
    n = len(targets)
    if n:
        xy = np.ones((n * 4, 3))
        xy[:, :2] = targets[:, [1, 2, 3, 4, 1, 4, 3, 2]].reshape(n * 4, 2)
        xy = xy @ M.T
        xy = (xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]).reshape(n, 8)
        x = xy[:, [0, 2, 4, 6]]
        y = xy[:, [1, 3, 5, 7]]
        new = np.concatenate((x.min(1), y.min(1), x.max(1), y.max(1))).reshape(4, n).T
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
        keep = box_candidates(targets[:, 1:5].T * s, new.T, area_thr=0.1)
        targets = targets[keep]
        targets[:, 1:5] = new[keep]
    return targets


def random_perspective(im: np.ndarray, targets: Optional[np.ndarray] = None, degrees: float = 10,
                       translate: float = 0.1, scale: float = 0.1, shear: float = 10, perspective: float = 0.0,
                       border: Tuple[int, int] = (0, 0)):
    """Rotation, scale, shear, translation (and perspective) as one warp of
    the image (border 114) and of its (n, 5) [cls, x1, y1, x2, y2] pixel
    boxes. `border` crops (negative) the output, as mosaic's canvas does."""
    if targets is None:
        targets = np.zeros((0, 5), np.float32)
    M, s, width, height = perspective_params(im.shape[0], im.shape[1], degrees=degrees, translate=translate,
                                             scale=scale, shear=shear, perspective=perspective, border=border)
    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        if perspective:
            im = cv2.warpPerspective(im, M, dsize=(width, height), borderValue=(114, 114, 114))
        else:
            im = cv2.warpAffine(im, M[:2], dsize=(width, height), borderValue=(114, 114, 114))
    return im, warp_labels(targets, M, s, width, height, perspective)


def mixup(im: np.ndarray, labels: np.ndarray, im2: np.ndarray, labels2: np.ndarray):
    """Blend two images with a Beta(32, 32) weight; labels concatenated."""
    r = np.random.beta(32.0, 32.0)
    im = (im * r + im2 * (1 - r)).astype(np.uint8)
    return im, np.concatenate((labels, labels2), 0)


def copy_reduce_paste(im: np.ndarray, labels: np.ndarray, p: float = 0.5, reduce_threshold: int = 32,
                      overlap_threshold: float = 0.3):
    """SOMI's small-object paster: copies of round(p * n) object crops,
    shrunk to at most `reduce_threshold` px wide, pasted at random spots
    that overlap the labels by less than `overlap_threshold` (IoA), each
    with a label. Crops come from the label boxes (the reference reads
    polygon segments, which box datasets do not have). labels: (n, 5)
    [cls, x1, y1, x2, y2] pixels. With p = 0 nothing is drawn."""
    n = len(labels)
    if p and n:
        h, w = im.shape[:2]
        for j in random.sample(range(n), k=round(p * n)):
            c, x1, y1, x2, y2 = labels[j]
            x1i, y1i = max(int(x1), 0), max(int(y1), 0)
            x2i, y2i = min(int(x2), w), min(int(y2), h)
            bw, bh = x2i - x1i, y2i - y1i
            if bw < 2 or bh < 2:
                continue
            crop = im[y1i:y2i, x1i:x2i]
            if bw > reduce_threshold:
                scale = reduce_threshold / bw
                crop = cv2.resize(crop, (0, 0), fx=scale, fy=scale)
            ch, cw = crop.shape[:2]
            if ch < 1 or cw < 1 or cw >= w or ch >= h:
                continue
            xn = random.randint(0, w - cw)
            yn = random.randint(0, h - ch)
            ioa = bbox_ioa(np.array([xn, yn, xn + cw, yn + ch], np.float32), labels[:, 1:5])
            if ioa.size == 0 or ioa.max() < overlap_threshold:
                im[yn:yn + ch, xn:xn + cw] = crop
                labels = np.concatenate((labels, [[c, xn, yn, xn + cw, yn + ch]]), 0).astype(labels.dtype)
    return im, labels


def blur(im: np.ndarray, ksize: int) -> np.ndarray:
    """Box blur, odd kernel (A.Blur)."""
    return cv2.blur(im, (ksize, ksize))


def median_blur(im: np.ndarray, ksize: int) -> np.ndarray:
    return cv2.medianBlur(im, ksize)


def to_gray(im: np.ndarray) -> np.ndarray:
    """Luminance on all three channels (A.ToGray)."""
    return cv2.cvtColor(cv2.cvtColor(im, cv2.COLOR_BGR2GRAY), cv2.COLOR_GRAY2BGR)


def clahe(im: np.ndarray, clip_limit: float = 2.0, tile: int = 8) -> np.ndarray:
    """CLAHE on the LAB luminance (A.CLAHE)."""
    lab = cv2.cvtColor(im, cv2.COLOR_BGR2LAB)
    lab[..., 0] = cv2.createCLAHE(clipLimit=clip_limit, tileGridSize=(tile, tile)).apply(lab[..., 0])
    return cv2.cvtColor(lab, cv2.COLOR_LAB2BGR)


def brightness_contrast(im: np.ndarray, alpha: float, beta: float) -> np.ndarray:
    """im * alpha + beta * 255, clipped (A.RandomBrightnessContrast, by max)."""
    return np.clip(im.astype(np.float32) * alpha + beta * 255.0, 0, 255).astype(np.uint8)


class Albumentations:
    """The pixel plane of the training set: the native cv2 form of the
    reference's Albumentations list, with its probabilities. Labels pass
    through unchanged."""

    PS = {"blur": 0.001, "median": 0.01, "gray": 0.01, "clahe": 0.3, "bc": 0.3}

    def _apply(self, im: np.ndarray) -> np.ndarray:
        ps = self.PS
        if random.random() < ps["blur"]:
            im = blur(im, random.choice([3, 5, 7]))
        if random.random() < ps["median"]:
            im = median_blur(im, random.choice([3, 5, 7]))
        if random.random() < ps["gray"]:
            im = to_gray(im)
        if random.random() < ps["clahe"]:
            im = clahe(im, clip_limit=random.uniform(1.0, 4.0))
        if random.random() < ps["bc"]:
            im = brightness_contrast(im, alpha=1.0 + random.uniform(-0.2, 0.2), beta=random.uniform(-0.2, 0.2))
        return im

    def __call__(self, im: np.ndarray, labels: np.ndarray, p: float = 1.0):
        if random.random() < p:
            im = self._apply(np.ascontiguousarray(im))
        return im, labels
