"""The Runner (counterpart of yolosomi_tpu/engine/runner.py :28-211): an
image batch -> normalize on the device -> model -> postprocess ->
(B, max_det, 6). Single-label, inexact calls (serving) take the fused
postprocess; multi-label or exact calls (val) decode every row and run
`non_max_suppression`. Also the ensemble (EnsembleRunner, :251-321) and
`attempt_load` (:324-330).

With `spatial_shards` S > 1 the Runner serves H-sharded (the JAX Runner's
spatial mesh, :36-47 and :227-238) over the process group of W = D x S
ranks (torchrun, or parallel.mesh.spawn_local): every rank is handed the
same batch, takes its batch slice r // S and its strip r % S of the rows
(parallel.spatial), runs the model under `spatial(strip)`, and gathers the
head's whole maps of the whole batch, so the postprocess runs as in one
process and every rank returns the whole (B, max_det, 6).

`augment=True` serves with test-time augmentation (ops/tta.py, the JAX
Runner's :188-195): the batch at scales 1, 0.83 and 0.67 (the middle one
flipped left-right), each canvas through the same forward (sharded
spatially where the Runner is) and decode, the rows de-scaled and clipped,
then `non_max_suppression` with the caller's arguments; never the fused
postprocess. A headless config (classifier.yaml's Classify tail) gives
its (B, nc) logits instead of rows.

The head type picks the postprocess, as in the JAX Runner (:124-136,
:160-212): Detect, the DecoupledDetects and DetectODConv take the fused
path when serving; IDetect, IAuxDetect, ASFF_Detect, CLLADetect and
TSCODE_Detect decode on the anchor grid, Segment too (its levels; the nm
mask coefficients are dropped), the DFL heads through `decode_v8`, each
then `non_max_suppression`; RTDETRDecoder takes its NMS-free top-k of the
query rows, before and in place of TTA. Only Detect and the
DecoupledDetects serve spatially sharded, and only graphs that name none
of the body zoo's blocks (models.yolo.STRIPLESS; ROADMAP queue A item 6).
"""

from __future__ import annotations

from collections import Counter
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from yolosomi_tpu_torch.engine.checkpoint import load_artifact
from yolosomi_tpu_torch.models.heads import decode, decode_v8
from yolosomi_tpu_torch.models.layers import strip_halo
from yolosomi_tpu_torch.models.yolo import STRIPLESS, build_model, parse_model
from yolosomi_tpu_torch.ops.nms import fused_postprocess, non_max_suppression, top_k
from yolosomi_tpu_torch.ops.tta import forward_augment
from yolosomi_tpu_torch.parallel import mesh
from yolosomi_tpu_torch.parallel.spatial import SpatialMesh, gather_level_outputs, spatial
from yolosomi_tpu_torch.utils.config import find_config, load_model_cfg
from yolosomi_tpu_torch.utils.general import LOGGER
from yolosomi_tpu_torch.utils.weights import load_jax_variables, without_adapters

# the head types whose raw maps decode with the anchor grid and which the
# JAX Runner serves through the fused postprocess (runner.py:196-200)
ANCHOR_HEADS = ("Detect", "DecoupledDetect", "DetectODConv", "DecoupledDetect1", "Decoupled_Detect")
# the other heads decoded on the anchor grid, then suppressed
GRID_HEADS = ANCHOR_HEADS + ("IDetect", "IAuxDetect", "ASFF_Detect", "CLLADetect", "TSCODE_Detect")
# the anchor-free DFL heads (decode_v8)
V8_HEADS = ("DetectYOLOv8", "DetectYOLO8Head", "DetectV8", "DetectYolov11", "DetectV11")
# the heads whose strip paths are ported (parallel/spatial.py)
SPATIAL_HEADS = ("Detect", "DecoupledDetect", "DecoupledDetect1", "Decoupled_Detect")


def _infer_nc(params: dict, na: int) -> Optional[int]:
    """nc from a checkpoint's head: a DecoupledDetect class conv `c3` has
    na * nc outputs, a bare `m0` conv na * (nc + 5), Segment's na * (nc +
    5 + nm) with nm its Proto's outputs. None for a head without them (the
    DFL heads, RT-DETR, TSCODE, DetectODConv), as in the JAX Runner."""
    head_keys = [k for k in params if k.startswith("layers_")]
    if not head_keys:
        return None
    head = params[max(head_keys, key=lambda k: int(k.split("_")[1]))]
    m0 = head.get("m0", {})
    if "c3" in m0:
        return int(np.asarray(m0["c3"]["conv"]["bias"]).size // na)
    if "conv" in m0:
        nm = np.asarray(head["proto"]["cv3"]["cv"]["conv"]["kernel"]).shape[-1] if "proto" in head else 0
        return int(np.asarray(m0["conv"]["bias"]).size // na - 5 - nm)
    return None


class Runner:
    """Builds a model from a YAML config name or path and runs batches.

    Weights come from `weights`, a `.msgpack` weights file or a `.ckpt`
    checkpoint of either package (a checkpoint gives its EMA weights; nc is
    inferred from its head unless given; its anchors, when it carries them,
    replace the config's); else from `variables`, the JAX package's flax
    variables as nested dicts of numpy arrays; else, and when the `weights`
    path does not exist, from `seed`. `imgsz` sizes the blocks that take
    the map's size at build (MHSA) for min(imgsz, 256), as the JAX Runner
    inits; a weights file's shapes replace that. `spatial_shards` > 1 serves
    H-sharded over the process group, which must be up (torchrun or
    spawn_local; SpatialMesh raises otherwise); `exchange` then holds the
    last batch's all-reduced bytes by kind (a TTA batch's summed over its
    three canvases). A headless config builds a classifier: __call__
    returns its logits, at imgsz 224 for detect's second stage."""

    def __init__(self, cfg: str, weights: Optional[str] = None, nc: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16, imgsz: int = 640, device=None, seed: int = 0,
                 variables: Optional[dict] = None, spatial_shards: int = 1):
        if spatial_shards < 1:
            raise ValueError(f"spatial_shards {spatial_shards} < 1")
        self.exchange = None
        cfg_dict = load_model_cfg(find_config(cfg))
        self.spatial = None
        if spatial_shards > 1:
            with torch.device("meta"):  # the head only; nothing is allocated
                head = parse_model(cfg_dict)[1]
            if not head.nl:
                raise NotImplementedError("a headless graph (Classify) is not served spatially sharded (ROADMAP "
                                          "queue A item 6)")
            if head.head_type not in SPATIAL_HEADS:
                raise NotImplementedError(f"the {head.head_type} head is not served spatially sharded: its strip "
                                          "path is not ported (ROADMAP queue A item 6)")
            stripless = sorted({s.name for s in head.specs} & STRIPLESS)
            if stripless:
                raise NotImplementedError(f"the graph is not served spatially sharded: the strip paths of "
                                          f"{', '.join(stripless)} are not ported (ROADMAP queue A item 6)")
            self.spatial = SpatialMesh(spatial_shards)
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
        self.model, self.meta = build_model(cfg_dict, nc=nc, device=device, dtype=dtype, seed=seed, anchors=anchors,
                                            imgsz=min(imgsz, 256))
        self.device = next(self.model.parameters()).device
        self.dtype = dtype
        if variables is not None:
            unmatched, unused = load_jax_variables(self.model, variables)
            unused = without_adapters(unused)
            if unmatched or unused:
                raise ValueError(f"variables do not fit the model: unmatched {unmatched[:5]}, unused {unused[:5]}")
            if weights is not None:
                LOGGER.info(f"loaded weights {weights}")
        if self.spatial is not None:
            sm = self.spatial
            self.halo = strip_halo(self.model)
            LOGGER.info(f"spatial sharding: {sm.world} ranks, {sm.slices} batch slices x {sm.shards} H-strips; rank "
                        f"{sm.rank} holds slice {sm.batch_slice}, strip {sm.index}")

    @property
    def names(self):
        return self.meta.names

    @property
    def stride(self) -> int:
        """The graph's deepest stride: image sizes must be multiples of it.
        It is the largest level's, except for a headless graph and for
        TSCODE_Detect, whose coarser input map lies below its levels."""
        return int(max(s.stride for s in self.meta.specs))

    def _check_head(self) -> None:
        if not self.meta.nl:
            raise TypeError("a headless graph gives logits, not detection rows")
        if self.meta.head_type not in GRID_HEADS + V8_HEADS + ("Segment", "RTDETRDecoder"):
            raise ValueError(f"unknown head type {self.meta.head_type!r}: the Runner has no postprocess for it")

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
        """Raw head outputs [(B, ny, nx, na, no), ...] (the head's own
        form: DFL maps, Segment's (levels, proto), RT-DETR's (B, nq,
        4 + nc)) for a uint8 or float NHWC batch; sharded spatially, the
        whole maps of the whole batch on every rank."""
        if self.spatial is None:
            return self.model(self.upload(images))
        images = np.asarray(images)
        strip = self.spatial.strip(images.shape[1], self.stride, self.halo)
        local = mesh.shard_batch(images, strip.batch_slice, strip.slices)[:, strip.rows]
        return self._sharded(strip, self.upload(local), len(images))

    @torch.inference_mode()
    def forward_tensor(self, x: torch.Tensor):
        """As `forward`, for an NCHW batch already on the device in the
        compute dtype (TTA's scaled canvases): sharded spatially, each rank
        takes its batch slice and strip of `x`."""
        if self.spatial is None:
            return self.model(x)
        strip = self.spatial.strip(x.shape[2], self.stride, self.halo)
        local = mesh.shard_batch(x, strip.batch_slice, strip.slices)[:, :, strip.rows]
        return self._sharded(strip, local, len(x))

    def _sharded(self, strip, local: torch.Tensor, batch: int):
        with spatial(strip):
            preds = gather_level_outputs(self.model(local), batch)
        self.exchange = strip.stats
        return preds

    @torch.inference_mode()
    def augment_rows(self, x: torch.Tensor) -> torch.Tensor:
        """TTA's decoded rows (B, N, 5 + nc) of an NCHW batch in the compute
        dtype, in its pixels: each scaled and flipped canvas through
        forward_tensor and decode (ops/tta.py forward_augment)."""
        self._check_head()
        exchange = Counter()

        def apply_decode(xi):
            rows = self.decode(self.forward_tensor(xi))
            exchange.update(self.exchange or {})
            return rows

        rows = forward_augment(apply_decode, x, self.meta.nl, gs=self.stride)
        if self.spatial is not None:
            self.exchange = dict(exchange)
        return rows

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
        head = self.meta.head_type
        if head in V8_HEADS:
            return decode_v8(preds, self.meta.strides, self.meta.nc)
        if head == "Segment":
            return decode(preds[0], self.meta.anchors_px, self.meta.strides)[..., :5 + self.meta.nc]
        if head == "RTDETRDecoder":
            raise ValueError("RTDETRDecoder's query rows are NMS-free: Runner.__call__ selects them, they do not "
                             "decode to rows for non_max_suppression")
        return decode(preds, self.meta.anchors_px, self.meta.strides)

    @staticmethod
    def query_rows(out: torch.Tensor, hw, conf_thres: float, max_det: int, classes=None) -> torch.Tensor:
        """RTDETRDecoder's (B, nq, 4 + nc) output (cxcywh in [0, 1], class
        scores) -> NMS-free rows (B, max_det, 6) [x1, y1, x2, y2, conf, cls]
        in the pixels of an (h, w) input (runner.py:160-185): each query's
        best class above conf_thres, the top max_det queries by it (the
        lower index first among equal ones), rows of no query zero."""
        out = out.float()
        h, w = hw
        cx, cy, bw, bh = out[..., 0], out[..., 1], out[..., 2], out[..., 3]
        boxes = torch.stack([(cx - bw / 2) * w, (cy - bh / 2) * h, (cx + bw / 2) * w, (cy + bh / 2) * h], -1)
        scores = out[..., 4:]
        if classes is not None:
            scores = torch.where(torch.as_tensor(np.asarray(classes), device=scores.device), scores, 0.0)
        conf, cls = scores.amax(-1), scores.argmax(-1).float()
        conf = torch.where(conf > conf_thres, conf, 0.0)
        k = min(max_det, conf.shape[1])
        top, idx = top_k(conf, k)
        rows = torch.cat([torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)), top[..., None],
                          torch.gather(cls, 1, idx)[..., None]], -1)
        rows = torch.where(top[..., None] > 0, rows, 0.0)
        return torch.nn.functional.pad(rows, (0, 0, 0, max_det - k))

    @torch.inference_mode()
    def __call__(self, images: np.ndarray, conf_thres: float = 0.25, iou_thres: float = 0.45,
                 max_det: int = 300, max_nms: int = 4096, multi_label: bool = False, exact: bool = False,
                 agnostic: bool = False, classes=None, augment: bool = False) -> np.ndarray:
        """(B, H, W, 3) uint8, or float in [0, 1] -> numpy (B, max_det, 6)
        [x1, y1, x2, y2, conf, cls] in input pixels; padded rows are zeros.
        `classes` is an (nc,) bool mask of the classes to keep (the JAX
        Runner's `class_mask`). `augment` runs TTA. A headless graph returns
        its (B, nc) logits as float32 numpy, and takes no other argument."""
        if not self.meta.nl:
            if augment:
                raise ValueError("TTA de-scales detection rows; a headless graph gives logits")
            return self.forward(images).float().cpu().numpy()
        self._check_head()
        if self.meta.head_type == "RTDETRDecoder":  # NMS-free, and never augmented (the JAX Runner's order)
            out = self.query_rows(self.forward(images), np.asarray(images).shape[1:3], conf_thres, max_det, classes)
            return out.cpu().numpy()
        if augment:
            out = non_max_suppression(self.augment_rows(self.upload(images)), conf_thres=conf_thres,
                                      iou_thres=iou_thres, classes=classes, multi_label=multi_label, agnostic=agnostic,
                                      max_det=max_det, max_nms=max_nms, exact=exact)
            return out.cpu().numpy()
        preds = self.forward(images)
        if not multi_label and not exact and self.meta.head_type in ANCHOR_HEADS:
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
        """As Runner.__call__, always through the decoded rows; `augment`
        runs each member's TTA before the one NMS."""
        rows = torch.cat([m.augment_rows(m.upload(images)) if augment else m.decode(m.forward(images))
                          for m in self.members], 1)
        out = non_max_suppression(rows, conf_thres=conf_thres, iou_thres=iou_thres, classes=classes,
                                  multi_label=multi_label, agnostic=agnostic, max_det=max_det, max_nms=max_nms,
                                  exact=exact)
        return out.cpu().numpy()


def attempt_load(weights, cfg, nc: Optional[int] = None, dtype: torch.dtype = torch.bfloat16, imgsz: int = 640,
                 spatial_shards: int = 1, device=None):
    """The reference's attempt_load: one checkpoint -> a Runner, several ->
    an EnsembleRunner, which serves unsharded as the JAX package's does
    (runner.py:325-326)."""
    if isinstance(weights, (list, tuple)) and len(weights) > 1:
        if spatial_shards > 1:
            LOGGER.info(f"an ensemble of {len(weights)} weights serves unsharded: spatial_shards={spatial_shards} "
                        "is ignored, as the JAX package's attempt_load ignores it")
        return EnsembleRunner(cfg, list(weights), nc=nc, dtype=dtype, imgsz=imgsz, device=device)
    w = weights[0] if isinstance(weights, (list, tuple)) else weights
    return Runner(cfg, w, nc=nc, dtype=dtype, imgsz=imgsz, device=device, spatial_shards=spatial_shards)
