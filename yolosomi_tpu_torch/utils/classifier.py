"""Second-stage classifier filter (counterpart of
yolosomi_tpu/utils/classifier.py:21; the reference's general.py:769
apply_classifier and detect.py:93-95).

Each detection's crop is classified again, and only detections whose
second-stage class agrees with the detector's are kept. `classify_fn` is
any callable from a (N, size, size, 3) float32 RGB batch in [0, 1] (a
numpy array) to (N, n_classes) logits (numpy or a torch tensor): a
Runner built on a headless config (classifier.yaml's Classify tail) is
one, as detect's `--classify cfg[:weights]` builds it.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def apply_classifier(
    dets: np.ndarray,  # (M, 6) [x1, y1, x2, y2, conf, cls] in im0 pixels
    classify_fn: Callable,
    im0: np.ndarray,  # the HWC BGR image the boxes refer to
    size: int = 224,
) -> np.ndarray:
    """The rows of `dets` whose crop classifies to the same class."""
    import cv2

    if len(dets) == 0:
        return dets
    h0, w0 = im0.shape[:2]
    # square the boxes and pad them by 1.3x + 30 px (reference general.py:776-780)
    xy = (dets[:, :2] + dets[:, 2:4]) / 2
    wh = np.maximum(dets[:, 2:4] - dets[:, :2], 0).max(axis=1, keepdims=True) * 1.3 + 30
    x1y1 = np.clip(xy - wh / 2, 0, [w0 - 1, h0 - 1]).astype(int)
    x2y2 = np.clip(xy + wh / 2, 1, [w0, h0]).astype(int)
    crops = []
    for (x1, y1), (x2, y2) in zip(x1y1, x2y2):
        cut = im0[y1:y2, x1:x2]
        if cut.size == 0:
            cut = np.zeros((2, 2, 3), im0.dtype)
        crops.append(cv2.resize(cut[:, :, ::-1], (size, size)).astype(np.float32) / 255.0)
    keep = logits_to_numpy(classify_fn(np.stack(crops))).argmax(1) == dets[:, 5].astype(int)
    return dets[keep]


def logits_to_numpy(logits) -> np.ndarray:
    """A classifier's output, numpy or a torch tensor on any device, as numpy."""
    if isinstance(logits, torch.Tensor):
        return logits.detach().float().cpu().numpy()
    return np.asarray(logits)
