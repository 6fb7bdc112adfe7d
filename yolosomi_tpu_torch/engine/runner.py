"""The Runner (counterpart of yolosomi_tpu/engine/runner.py Runner.infer_fn,
:138-211): uint8 NHWC batch -> normalize on the device -> model ->
postprocess -> (B, max_det, 6). Single-label, inexact calls (serving) take
the fused postprocess; multi-label or exact calls (val) decode every row
and run `non_max_suppression`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from yolosomi_tpu_torch.models.heads import decode
from yolosomi_tpu_torch.models.yolo import build_model
from yolosomi_tpu_torch.ops.nms import fused_postprocess, non_max_suppression
from yolosomi_tpu_torch.utils.config import find_config, load_model_cfg
from yolosomi_tpu_torch.utils.weights import load_jax_variables


class Runner:
    """Builds a model from a YAML config name or path and runs batches.

    Weights are drawn from `seed`, or copied from `variables`, the JAX
    package's flax variables as nested dicts of numpy arrays. `imgsz` is
    taken for the JAX Runner's signature; nothing here depends on it.
    Loading a `.msgpack` checkpoint (ROADMAP queue A item 3), spatial
    sharding (item 6) and TTA (item 9) are not ported yet and raise
    NotImplementedError."""

    def __init__(self, cfg: str, nc: Optional[int] = None, dtype: torch.dtype = torch.bfloat16, imgsz: int = 640,
                 device=None, seed: int = 0, variables: Optional[dict] = None, weights: Optional[str] = None,
                 spatial_shards: int = 1):
        if weights is not None:
            raise NotImplementedError("loading a .msgpack checkpoint is not ported yet (ROADMAP queue A item 3)")
        if spatial_shards != 1:
            raise NotImplementedError("spatial sharding is not ported yet (ROADMAP queue A item 6)")
        self.model, self.meta = build_model(load_model_cfg(find_config(cfg)), nc=nc, device=device, dtype=dtype,
                                            seed=seed)
        self.device = next(self.model.parameters()).device
        self.dtype = dtype
        if variables is not None:
            unmatched, unused = load_jax_variables(self.model, variables)
            if unmatched or unused:
                raise ValueError(f"variables do not fit the model: unmatched {unmatched[:5]}, unused {unused[:5]}")

    @property
    def names(self):
        return self.meta.names

    @property
    def stride(self) -> int:
        """The model's largest stride: image sizes must be multiples of it."""
        return int(max(self.meta.strides))

    @torch.inference_mode()
    def forward(self, images_uint8_nhwc: np.ndarray):
        """Raw head outputs [(B, ny, nx, na, no), ...] for a uint8 NHWC batch.
        The batch is uploaded as uint8 and normalized on the device straight
        into the compute dtype."""
        images = np.asarray(images_uint8_nhwc)
        if images.dtype != np.uint8 or images.ndim != 4:
            raise TypeError(f"expected a uint8 (B, H, W, 3) batch, got {images.dtype} {images.shape}")
        x = torch.from_numpy(images).to(self.device).permute(0, 3, 1, 2)  # NCHW view, NHWC memory
        x = x.to(self.dtype) / torch.tensor(255.0, dtype=self.dtype, device=self.device)
        return self.model(x)

    @torch.inference_mode()
    def __call__(self, images_uint8_nhwc: np.ndarray, conf_thres: float = 0.25, iou_thres: float = 0.45,
                 max_det: int = 300, max_nms: int = 4096, multi_label: bool = False, exact: bool = False,
                 agnostic: bool = False, classes=None, augment: bool = False) -> np.ndarray:
        """(B, H, W, 3) uint8 -> numpy (B, max_det, 6) [x1, y1, x2, y2, conf, cls]
        in input pixels; padded rows are zeros. `classes` is an (nc,) bool
        mask of the classes to keep (the JAX Runner's `class_mask`)."""
        if augment:
            raise NotImplementedError("TTA (augment) is not ported yet (ROADMAP queue A item 9)")
        preds = self.forward(images_uint8_nhwc)
        if not multi_label and not exact:
            out = fused_postprocess(preds, self.meta.anchors_px, self.meta.strides, conf_thres=conf_thres,
                                    iou_thres=iou_thres, classes=classes, agnostic=agnostic, max_det=max_det,
                                    max_nms=max_nms)
        else:
            out = non_max_suppression(decode(preds, self.meta.anchors_px, self.meta.strides), conf_thres=conf_thres,
                                      iou_thres=iou_thres, classes=classes, multi_label=multi_label,
                                      agnostic=agnostic, max_det=max_det, max_nms=max_nms, exact=exact)
        return out.cpu().numpy()
