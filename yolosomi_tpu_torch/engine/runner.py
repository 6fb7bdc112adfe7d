"""The Runner (counterpart of yolosomi_tpu/engine/runner.py :28-211): an
image batch -> normalize on the device -> model -> postprocess ->
(B, max_det, 6). Single-label, inexact calls (serving) take the fused
postprocess; multi-label or exact calls (val) decode every row and run
`non_max_suppression`. Also the ensemble (EnsembleRunner, :251-321) and
`attempt_load` (:324-330).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from yolosomi_tpu_torch.engine.checkpoint import load_artifact
from yolosomi_tpu_torch.models.heads import decode
from yolosomi_tpu_torch.models.yolo import build_model, parse_model
from yolosomi_tpu_torch.ops.nms import fused_postprocess, non_max_suppression
from yolosomi_tpu_torch.utils.config import find_config, load_model_cfg
from yolosomi_tpu_torch.utils.general import LOGGER
from yolosomi_tpu_torch.utils.weights import load_jax_variables, without_adapters

# the head types whose raw maps decode with the anchor grid, and which the
# JAX Runner serves through the fused postprocess (runner.py:196-200)
ANCHOR_HEADS = ("Detect", "DecoupledDetect", "DetectODConv", "DecoupledDetect1", "Decoupled_Detect")


def _infer_nc(params: dict, na: int) -> Optional[int]:
    """nc from a checkpoint's head: a DecoupledDetect class conv `c3` has
    na * nc outputs, a coupled Detect conv na * (nc + 5)."""
    head_keys = [k for k in params if k.startswith("layers_")]
    if not head_keys:
        return None
    m0 = params[max(head_keys, key=lambda k: int(k.split("_")[1]))].get("m0", {})
    if "c3" in m0:
        return int(np.asarray(m0["c3"]["conv"]["bias"]).size // na)
    if "conv" in m0:
        return int(np.asarray(m0["conv"]["bias"]).size // na - 5)
    return None


class Runner:
    """Builds a model from a YAML config name or path and runs batches.

    Weights come from `weights`, a `.msgpack` weights file or a `.ckpt`
    checkpoint of either package (a checkpoint gives its EMA weights; nc is
    inferred from its head unless given; its anchors, when it carries them,
    replace the config's); else from `variables`, the JAX package's flax
    variables as nested dicts of numpy arrays; else, and when the `weights`
    path does not exist, from `seed`. `imgsz` is taken for the JAX Runner's
    signature; nothing here depends on it. Spatial sharding (ROADMAP queue A
    item 6) and TTA (item 9) raise NotImplementedError."""

    def __init__(self, cfg: str, weights: Optional[str] = None, nc: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16, imgsz: int = 640, device=None, seed: int = 0,
                 variables: Optional[dict] = None, spatial_shards: int = 1):
        if spatial_shards != 1:
            raise NotImplementedError("spatial sharding is not ported yet (ROADMAP queue A item 6)")
        cfg_dict = load_model_cfg(find_config(cfg))
        anchors = None
        if weights is not None and Path(weights).exists():
            variables, ckpt_anchors = load_artifact(weights)
            if nc is None:
                with torch.device("meta"):  # the anchor count only; nothing is allocated
                    _, meta = parse_model(cfg_dict)
                nc = _infer_nc(variables["params"], meta.na)
                if nc is not None and nc != meta.nc:
                    LOGGER.info(f"nc={nc} inferred from checkpoint (cfg said {meta.nc})")
            if ckpt_anchors is not None:
                anchors = ckpt_anchors.reshape(len(ckpt_anchors), -1).tolist()
                LOGGER.info("anchors restored from checkpoint")
        elif weights is not None:
            LOGGER.warning(f"weights {weights} not found; using random weights from seed {seed}")
        self.model, self.meta = build_model(cfg_dict, nc=nc, device=device, dtype=dtype, seed=seed, anchors=anchors)
        self.device = next(self.model.parameters()).device
        self.dtype = dtype
        if variables is not None:
            unmatched, unused = load_jax_variables(self.model, variables)
            unused = without_adapters(unused)
            if unmatched or unused:
                raise ValueError(f"variables do not fit the model: unmatched {unmatched[:5]}, unused {unused[:5]}")
            if weights is not None:
                LOGGER.info(f"loaded weights {weights}")

    @property
    def names(self):
        return self.meta.names

    @property
    def stride(self) -> int:
        """The model's largest stride: image sizes must be multiples of it."""
        return int(max(self.meta.strides))

    def _check_head(self) -> None:
        if self.meta.head_type not in ANCHOR_HEADS:
            raise NotImplementedError(
                f"head type {self.meta.head_type} decodes otherwise than the anchor grid; its decode is not "
                "ported yet (ROADMAP queue A item 8)")

    def upload(self, images: np.ndarray) -> torch.Tensor:
        """A (B, H, W, 3) batch -> the model's NCHW input on the device, in
        the compute dtype. uint8 goes up as uint8 and is divided by 255 on
        the device, straight into the compute dtype; float input is taken
        as already in [0, 1] (the JAX Runner's contract)."""
        images = np.asarray(images)
        if images.ndim != 4 or not (images.dtype == np.uint8 or np.issubdtype(images.dtype, np.floating)):
            raise TypeError(f"expected a uint8 or float (B, H, W, 3) batch, got {images.dtype} {images.shape}")
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device).permute(0, 3, 1, 2)  # NHWC memory
        if images.dtype == np.uint8:
            return x.to(self.dtype) / torch.tensor(255.0, dtype=self.dtype, device=self.device)
        return x.to(self.dtype)

    @torch.inference_mode()
    def forward(self, images: np.ndarray):
        """Raw head outputs [(B, ny, nx, na, no), ...] for a uint8 or float
        NHWC batch."""
        return self.model(self.upload(images))

    def val_loss_fn(self, compute_loss):
        """(images, targets) -> numpy (3,) [lbox, lobj, lcls] of
        `compute_loss` on the eval-mode forward of a uint8 or float NHWC
        batch and its (B, M, 5) padded targets (the val losses)."""
        @torch.inference_mode()
        def loss_fn_batch(images, targets) -> np.ndarray:
            t = torch.as_tensor(np.asarray(targets), dtype=torch.float32, device=self.device)
            return compute_loss(self.forward(images), t)[1].cpu().numpy()

        return loss_fn_batch

    def decode(self, preds) -> torch.Tensor:
        """Raw maps -> decoded rows (B, N, 5 + nc) in input pixels."""
        self._check_head()
        return decode(preds, self.meta.anchors_px, self.meta.strides)

    @torch.inference_mode()
    def __call__(self, images: np.ndarray, conf_thres: float = 0.25, iou_thres: float = 0.45,
                 max_det: int = 300, max_nms: int = 4096, multi_label: bool = False, exact: bool = False,
                 agnostic: bool = False, classes=None, augment: bool = False) -> np.ndarray:
        """(B, H, W, 3) uint8, or float in [0, 1] -> numpy (B, max_det, 6)
        [x1, y1, x2, y2, conf, cls] in input pixels; padded rows are zeros.
        `classes` is an (nc,) bool mask of the classes to keep (the JAX
        Runner's `class_mask`)."""
        if augment:
            raise NotImplementedError("TTA (augment) is not ported yet (ROADMAP queue A item 9)")
        self._check_head()
        preds = self.forward(images)
        if not multi_label and not exact:
            out = fused_postprocess(preds, self.meta.anchors_px, self.meta.strides, conf_thres=conf_thres,
                                    iou_thres=iou_thres, classes=classes, agnostic=agnostic, max_det=max_det,
                                    max_nms=max_nms)
        else:
            out = non_max_suppression(self.decode(preds), conf_thres=conf_thres, iou_thres=iou_thres,
                                      classes=classes, multi_label=multi_label, agnostic=agnostic,
                                      max_det=max_det, max_nms=max_nms, exact=exact)
        return out.cpu().numpy()


class EnsembleRunner:
    """Several checkpoints as one detector (the reference's Ensemble): each
    member's decoded rows are concatenated on the anchor axis before one
    shared `non_max_suppression`. `cfg` is one config for every member or
    one per checkpoint; every member must have the same nc."""

    def __init__(self, cfg, weights, nc: Optional[int] = None, dtype: torch.dtype = torch.bfloat16,
                 imgsz: int = 640, device=None):
        cfgs = cfg if isinstance(cfg, (list, tuple)) else [cfg] * len(weights)
        if len(cfgs) != len(weights):
            raise ValueError(f"{len(cfgs)} configs for {len(weights)} checkpoints")
        self.members = [Runner(c, w, nc=nc, dtype=dtype, imgsz=imgsz, device=device) for c, w in zip(cfgs, weights)]
        ncs = {m.meta.nc for m in self.members}
        if len(ncs) != 1:
            raise ValueError(f"ensemble members disagree on nc: {ncs}")
        self.meta = self.members[0].meta
        self.dtype = dtype
        LOGGER.info(f"ensemble of {len(self.members)} models")

    @property
    def names(self):
        return self.meta.names

    @property
    def stride(self) -> int:
        return max(m.stride for m in self.members)

    @torch.inference_mode()
    def __call__(self, images: np.ndarray, conf_thres: float = 0.25, iou_thres: float = 0.45,
                 max_det: int = 300, max_nms: int = 4096, multi_label: bool = False, exact: bool = False,
                 agnostic: bool = False, classes=None, augment: bool = False) -> np.ndarray:
        """As Runner.__call__, always through the decoded rows."""
        if augment:
            raise NotImplementedError("TTA (augment) is not ported yet (ROADMAP queue A item 9)")
        rows = torch.cat([m.decode(m.forward(images)) for m in self.members], 1)
        out = non_max_suppression(rows, conf_thres=conf_thres, iou_thres=iou_thres, classes=classes,
                                  multi_label=multi_label, agnostic=agnostic, max_det=max_det, max_nms=max_nms,
                                  exact=exact)
        return out.cpu().numpy()


def attempt_load(weights, cfg, nc: Optional[int] = None, dtype: torch.dtype = torch.bfloat16, imgsz: int = 640,
                 spatial_shards: int = 1, device=None):
    """The reference's attempt_load: one checkpoint -> a Runner, several ->
    an EnsembleRunner."""
    if isinstance(weights, (list, tuple)) and len(weights) > 1:
        if spatial_shards != 1:
            raise NotImplementedError("spatial sharding is not ported yet (ROADMAP queue A item 6)")
        return EnsembleRunner(cfg, list(weights), nc=nc, dtype=dtype, imgsz=imgsz, device=device)
    w = weights[0] if isinstance(weights, (list, tuple)) else weights
    return Runner(cfg, w, nc=nc, dtype=dtype, imgsz=imgsz, device=device, spatial_shards=spatial_shards)
