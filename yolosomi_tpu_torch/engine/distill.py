"""Knowledge distillation: train a light student from the flagship
(counterpart of yolosomi_tpu/engine/distill.py:38-176).

The frozen teacher's forward runs inside the student's train step (eval
mode, no gradient, at the step's own input), and its soft targets join
the detection loss. Per pyramid level (the student's level i learns from
the teacher level `level_map[i]` of the same stride):
  kd_obj = BCE(student obj logits, sigmoid(teacher obj logits))
  kd_cls = BCE(student cls logits, sigmoid(teacher cls logits)),
           weighted by the teacher's objectness
  kd_box = 1 - CIoU(student decode, teacher decode) on the cells where
           the teacher's objectness exceeds obj_thr, each model decoded
           with its own anchors
  total  = detection loss + alpha * mean_levels(kd_obj + kd_cls + kd_box) * B
With `hint` > 0 a FitNets term adds hint * hint_loss * B: per level a
learnable 1x1 adapter (Cs, Ct) projects the student's head-input map to
the teacher's width, and the squared gap on the teacher-confident cells
is normalized by the teacher map's own power. The adapters are the
student model's `kd_adapter_<i>` modules (nn.Linear(Cs, Ct), the flax
`params/kd_adapter_<i>/kernel` being its weight transposed), so the
optimizer, the EMA and the checkpoints carry them (train.py plants them).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn as nn

from yolosomi_tpu_torch.losses import bce_with_logits
from yolosomi_tpu_torch.models.heads import decode_boxes_level
from yolosomi_tpu_torch.utils.iou import bbox_iou


def distill_loss(student_preds: Sequence[torch.Tensor], teacher_preds: Sequence[torch.Tensor], anchors_px, strides,
                 obj_thr: float = 0.25, temp: float = 1.0, teacher_anchors_px=None) -> torch.Tensor:
    """Soft-target distillation loss over the pyramid levels (a scalar).
    The teacher's maps carry no gradient; box imitation counts only the
    teacher-confident cells. `teacher_anchors_px` decodes the teacher's
    boxes with its own anchors (default: the student's)."""
    dev = student_preds[0].device
    anchors_px = torch.as_tensor(np.asarray(anchors_px, np.float32), device=dev)
    t_anchors = (torch.as_tensor(np.asarray(teacher_anchors_px, np.float32), device=dev)
                 if teacher_anchors_px is not None else anchors_px)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for i, (sp, tp) in enumerate(zip(student_preds, teacher_preds)):
        sp = sp.float()
        tp = tp.detach().float()
        t_obj = torch.sigmoid(tp[..., 4] / temp)
        kd_obj = bce_with_logits(sp[..., 4] / temp, t_obj).mean()
        t_cls = torch.sigmoid(tp[..., 5:] / temp)
        w = t_obj[..., None]
        kd_cls = (bce_with_logits(sp[..., 5:] / temp, t_cls) * w).sum() / (w.sum() * max(sp.shape[-1] - 5, 1) + 1e-6)
        sb = decode_boxes_level(sp, anchors_px[i], float(strides[i]))
        tb = decode_boxes_level(tp, t_anchors[i], float(strides[i]))
        m = (t_obj > obj_thr).float()
        ciou = bbox_iou(sb, tb, xywh=True, CIoU=True)
        kd_box = ((1.0 - ciou) * m).sum() / (m.sum() + 1e-6)
        total = total + kd_obj + kd_cls + kd_box
    return total / max(len(student_preds), 1)


def hint_loss(student_feats: Sequence[torch.Tensor], teacher_feats: Sequence[torch.Tensor],
              adapters: Sequence[torch.Tensor], teacher_preds: Sequence[torch.Tensor],
              obj_thr: float = 0.25) -> torch.Tensor:
    """The FitNets hint term over the levels (a scalar). Feature maps are
    NHWC (B, ny, nx, C), as the JAX package's; adapters[i] is the (Cs, Ct)
    matrix; the mask is the teacher's objectness, max over anchors, above
    obj_thr. Gradients reach the student's maps and the adapters."""
    total = torch.zeros((), dtype=torch.float32, device=student_feats[0].device)
    for sf, tf, a, tp in zip(student_feats, teacher_feats, adapters, teacher_preds):
        tf = tf.detach().float()
        tp = tp.detach().float()
        proj = torch.einsum("bhwc,cd->bhwd", sf.float(), a.float())
        t_obj = torch.sigmoid(tp[..., 4]).amax(-1)
        m = (t_obj > obj_thr).float()[..., None]
        num = (((proj - tf) ** 2) * m).sum()
        den = ((tf ** 2) * m).sum() + 1e-6
        total = total + num / den
    return total / max(len(student_feats), 1)


def plant_adapters(model: nn.Module, meta, t_meta, level_map, seed: int) -> list:
    """Put one kd_adapter_<i> = nn.Linear(Cs, Ct, bias=False) per student
    level on the student model (JAX train.py:283-303) and return the
    [(Cs, Ct)]: Cs the student's head-input channels, Ct those of the
    teacher level it learns from (the JAX package reads both from a
    forward at max(stride) * 4 px; they are the parse's channel counts).
    JAX draws each (Cs, Ct) kernel as normal / sqrt(Cs) from
    PRNGKey(seed + 7), bits torch cannot reproduce; the port draws the same
    law, in the same order, from a torch.Generator seeded with seed + 7."""
    gen = torch.Generator().manual_seed(seed + 7)
    dev = next(model.parameters()).device
    shapes = []
    for i, j in enumerate(level_map):
        cs, ct = meta.specs[meta.head_from[i]].c2, t_meta.specs[t_meta.head_from[j]].c2
        kernel = torch.randn((cs, ct), generator=gen) * float(1.0 / np.sqrt(cs))
        adapter = nn.Linear(cs, ct, bias=False, device=dev)
        with torch.no_grad():
            adapter.weight.copy_(kernel.t())
        setattr(model, f"kd_adapter_{i}", adapter)
        shapes.append((cs, ct))
    return shapes


def wrap_loss_with_distillation(base_loss: Callable, teacher_apply: Callable, meta, alpha: float = 1.0,
                                obj_thr: float = 0.25, teacher_anchors_px=None, level_map=None,
                                hint: float = 0.0) -> Callable:
    """A ComputeLoss-style (preds, targets) -> (total, comps) callable that
    also runs the teacher, `teacher_apply(aux, images)` (its raw maps, or
    (maps, head-input maps) for the hint), and adds the distillation
    terms. The train step passes the images and the teacher (`aux`), and
    with `hint` the student's head-input maps (`feats`, NCHW) and the
    student model (`params`, holding the adapters): the loss advertises
    needs_images, needs_aux and needs_features. A call without images or
    teacher (the per-epoch val loss) is the plain detection loss.
    `level_map[i]` is the teacher level student level i learns from;
    `teacher_anchors_px` is indexed to the student's levels already."""

    def loss_fn(preds, targets, images=None, aux=None, feats=None, params=None):
        total, comps = base_loss(preds, targets)
        if images is None or aux is None:
            return total, comps
        t_out = teacher_apply(aux, images)
        t_feats = None
        if isinstance(t_out, tuple) and len(t_out) == 2 and isinstance(t_out[1], (tuple, list)):
            t_preds, t_feats = t_out
        else:
            t_preds = t_out
        if level_map is not None:
            t_preds = [t_preds[j] for j in level_map]
            if t_feats is not None:
                t_feats = [t_feats[j] for j in level_map]
        kd = distill_loss(preds, t_preds, meta.anchors_px, meta.strides, obj_thr=obj_thr,
                          teacher_anchors_px=teacher_anchors_px)
        total = total + alpha * kd * preds[0].shape[0]
        if hint > 0.0 and feats is not None and t_feats is not None and params is not None:
            nhwc = lambda maps: [f.permute(0, 2, 3, 1) for f in maps]  # noqa: E731  (hint_loss takes JAX's layout)
            adapters = [getattr(params, f"kd_adapter_{i}").weight.t() for i in range(len(feats))]  # (Cs, Ct)
            h = hint_loss(nhwc(feats), nhwc(t_feats), adapters, t_preds, obj_thr=obj_thr)
            total = total + hint * h * preds[0].shape[0]
        return total, comps

    loss_fn.needs_images = True
    loss_fn.needs_aux = True
    loss_fn.needs_features = hint > 0.0
    return loss_fn
