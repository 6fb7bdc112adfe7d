"""The YOLOv5-family training loss (counterpart of yolosomi_tpu/losses.py:
44-384).

Targets arrive as a padded (B, M, 5) array of per-image rows [cls, x, y,
w, h] (normalized xywh), padding rows marked cls = -1. Assignment is the
JAX package's fixed lattice: for every image, level, neighbour offset (5),
anchor (na) and target row (M) one candidate, kept or dropped by a mask,
so the shapes never depend on the data. Invalid rows (padding, zero width
or height) get benign geometry, because their lanes stay in the lattice:
a 0/0 in CIoU's arctan would turn the whole backward NaN even though the
lane is masked. The objectness target is a scatter-max of the kept
candidates' detached IoU (`scatter_reduce_(..., "amax")`), the fixed
point of the reference's IoU-sorted scatter.

Options: label smoothing, FocalLoss (`fl_gamma`), SlideLoss
(`slide_ratio`), the NWD blend of the box loss (`nwdloss`, `shapeloss`,
and `nwd_ref_defect` to feed NWD the reference's xywh boxes as if they
were xyxy), and `rep` (--rep): the repulsion terms RepGT and RepBox over
each image's first 256 positives, added to the total. As in the JAX
package both box sets are cut from the graph, so the repulsion term
moves the loss's value and adds no gradient.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from yolosomi_tpu_torch.data.datasets import pad_targets  # noqa: F401  (the loss's target layout)
from yolosomi_tpu_torch.parallel import mesh
from yolosomi_tpu_torch.utils.boxes import xywh2xyxy
from yolosomi_tpu_torch.utils.iou import bbox_iou, wasserstein, wasserstein_loss


def smooth_bce(eps: float = 0.1) -> Tuple[float, float]:
    """Positive and negative class targets under label smoothing."""
    return 1.0 - 0.5 * eps, 0.5 * eps


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor, pos_weight: float = 1.0) -> torch.Tensor:
    """Element-wise BCE-with-logits with the positive class weighted, as
    torch.nn.BCEWithLogitsLoss(pos_weight=..., reduction="none")."""
    return -(pos_weight * targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits))


def focal_modulation(loss, logits, targets, gamma: float = 1.5, alpha: float = 0.25):
    """FocalLoss's weighting of an element-wise loss."""
    p = torch.sigmoid(logits)
    p_t = targets * p + (1 - targets) * (1 - p)
    alpha_factor = targets * alpha + (1 - targets) * (1 - alpha)
    return loss * alpha_factor * torch.pow(1.0 - p_t, gamma)


def slide_modulation(loss, targets, auto_iou):
    """SlideLoss: weight 1 below auto_iou - 0.1, exp(1 - auto_iou) in the
    slide band, exp(-(t - 1)) from auto_iou on (auto_iou at least 0.2)."""
    auto_iou = torch.clamp(auto_iou, min=0.2)
    b1 = targets <= auto_iou - 0.1
    b2 = (targets > auto_iou - 0.1) & (targets < auto_iou)
    b3 = targets >= auto_iou
    w = 1.0 * b1 + torch.exp(1.0 - auto_iou) * b2 + torch.exp(-(targets - 1.0)) * b3
    return loss * w


class LevelTargets(NamedTuple):
    """The dense assignment of one level; every array has leading shape
    (..., K) with K = 5 * na * M (the targets' leading shape first)."""

    a: torch.Tensor  # anchor index
    gj: torch.Tensor  # cell row
    gi: torch.Tensor  # cell column
    tcls: torch.Tensor  # class id (0 where masked)
    tbox: torch.Tensor  # (..., K, 4) [dx, dy, w, h] in grid units
    anch: torch.Tensor  # (..., K, 2) anchor wh in grid units
    mask: torch.Tensor  # (..., K) bool


_OFFSETS = [[0, 0], [1, 0], [0, 1], [-1, 0], [0, -1]]
_G = 0.5  # neighbour-cell threshold


def build_targets_level(targets: torch.Tensor, anchors: torch.Tensor, ny: int, nx: int,
                        anchor_t: float) -> LevelTargets:
    """The YOLOv5 assignment of one level for targets (..., M, 5) [cls, x,
    y, w, h] normalized (cls = -1 pads) and anchors (na, 2) in grid units.
    The leading dimensions (none for one image, B for a batch) are kept."""
    lead, M = targets.shape[:-2], targets.shape[-2]
    na = anchors.shape[0]
    dev = targets.device
    # zero-size rows are invalid whatever their class; their lanes stay in
    # the lattice, so their geometry must be benign
    valid = (targets[..., 0] >= 0) & (targets[..., 3] > 0) & (targets[..., 4] > 0)  # (..., M)
    grid = torch.tensor([nx, ny], dtype=torch.float32, device=dev)
    gxy = torch.where(valid[..., None], targets[..., 1:3] * grid, 0.5)  # (..., M, 2)
    gwh = torch.where(valid[..., None], targets[..., 3:5] * grid, 1.0)

    r = gwh[..., None, :, :] / anchors[:, None, :]  # (..., na, M, 2)
    ratio_ok = torch.maximum(r, 1.0 / r).amax(-1) < anchor_t  # (..., na, M)

    gxi = grid - gxy
    jmask = (gxy[..., 0] % 1 < _G) & (gxy[..., 0] > 1)
    kmask = (gxy[..., 1] % 1 < _G) & (gxy[..., 1] > 1)
    lmask = (gxi[..., 0] % 1 < _G) & (gxi[..., 0] > 1)
    mmask = (gxi[..., 1] % 1 < _G) & (gxi[..., 1] > 1)
    off_ok = torch.stack([torch.ones_like(jmask), jmask, kmask, lmask, mmask], -2)  # (..., 5, M)
    cand = off_ok[..., :, None, :] & ratio_ok[..., None, :, :] & valid[..., None, None, :]  # (..., 5, na, M)

    offsets = torch.tensor(_OFFSETS, dtype=torch.float32, device=dev)
    gxy_c = gxy[..., None, :, :] - offsets[:, None, :] * _G  # (..., 5, M, 2)
    gij = torch.floor(gxy_c)
    gi = torch.clamp(gij[..., 0], 0, nx - 1)
    gj = torch.clamp(gij[..., 1], 0, ny - 1)
    # tbox's offset is taken from the clamped cell
    dxy = gxy[..., None, :, :] - torch.stack([gi, gj], -1)  # (..., 5, M, 2)

    shape = (*lead, 5, na, M)
    K = 5 * na * M
    cls = targets[..., 0].to(torch.int64)[..., None, None, :].expand(shape)
    a = torch.arange(na, device=dev)[:, None].expand(shape)
    gi_f = gi[..., :, None, :].expand(shape).to(torch.int64)
    gj_f = gj[..., :, None, :].expand(shape).to(torch.int64)
    dxy_f = dxy[..., :, None, :, :].expand(*shape, 2)
    gwh_f = gwh[..., None, None, :, :].expand(*shape, 2)
    anch_f = anchors[:, None, :].expand(*shape, 2)
    return LevelTargets(
        a=a.reshape(*lead, K),
        gj=gj_f.reshape(*lead, K),
        gi=gi_f.reshape(*lead, K),
        tcls=torch.where(cand, cls, 0).reshape(*lead, K),
        tbox=torch.cat([dxy_f, gwh_f], -1).reshape(*lead, K, 4),
        anch=anch_f.reshape(*lead, K, 2),
        mask=cand.reshape(*lead, K),
    )


class ComputeLoss:
    """The loss: `loss(preds, targets) -> (total, components)`.

    preds: the head's raw maps [(B, ny, nx, na, no), ...] (taken in f32,
    whatever their dtype; IAuxDetect's 2 * nl train-mode maps add the aux
    half's total at 0.25); targets: (B, M, 5) padded as above, on the
    preds' device. `total` is the sum of the three gained terms times the
    batch size; `components` is the detached (3,) [lbox, lobj, lcls].

    Inside a data-parallel step (parallel.mesh.reducing) each rank returns
    its share of the global batch's loss, so that the shares and their
    gradients sum to the one-process loss on the global batch: the
    positives and the IoU sum behind the box and class normalisers and
    SlideLoss's auto_iou are all-reduced (values), `bs` is the global
    batch, and the per-rank means (objectness, repulsion) are divided by
    the world size."""

    def __init__(self, meta, hyp: dict):
        self.na, self.nc, self.nl = meta.na, meta.nc, meta.nl
        self.anchors_grid = (torch.as_tensor(meta.anchors_px, dtype=torch.float32)
                             / torch.as_tensor(meta.strides, dtype=torch.float32)[:, None, None])  # (nl, na, 2)
        self.hyp = dict(hyp)
        self.cp, self.cn = smooth_bce(hyp.get("label_smoothing", 0.0))
        self.balance = {3: [4.0, 1.0, 0.4]}.get(self.nl, [4.0, 1.0, 0.25, 0.06, 0.02])
        self.gr = 1.0
        self.fl_gamma = float(hyp.get("fl_gamma", 0.0))
        self.slide_ratio = float(hyp.get("slide_ratio", 0))
        self.nwd = float(hyp.get("nwdloss", 0))
        self.shape_nwd = float(hyp.get("shapeloss", 0))
        self.nwd_ref_defect = bool(hyp.get("nwd_ref_defect", False))
        self.anchor_t = float(hyp.get("anchor_t", 4.0))
        self.rep = False  # the trainer's --rep
        self.rep_alpha = float(hyp.get("alpha", 0.01))
        self.rep_beta = float(hyp.get("beta", 0.1))
        self.rep_deta = float(hyp.get("deta", 0.5))
        self.rep_nms = float(hyp.get("Rp_nms", 0.1))

    def __call__(self, preds: Sequence[torch.Tensor], targets: torch.Tensor):
        if len(preds) == 2 * self.nl:
            # IAuxDetect's train-mode lead + aux maps: the aux maps take the
            # same targets at weight 0.25 (losses.py:199-206); the components
            # are the lead maps'
            total, comps = self(preds[:self.nl], targets)
            return total + 0.25 * self(preds[self.nl:], targets)[0], comps
        dev = preds[0].device
        targets = torch.as_tensor(targets, dtype=torch.float32, device=dev)
        anchors = self.anchors_grid.to(dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        lbox, lobj, lcls, lrep = zero, zero, zero, zero
        group = mesh.active()  # a data-parallel step: this rank's share of the global batch's loss
        world = group.world if group is not None else 1
        bs = preds[0].shape[0] * world
        for i, pi in enumerate(preds):
            pi = pi.float()
            B, ny, nx, na, no = pi.shape
            lt = build_targets_level(targets, anchors[i], ny, nx, self.anchor_t)
            bidx = torch.arange(B, device=dev)[:, None]
            ps = pi[bidx, lt.gj, lt.gi, lt.a]  # (B, K, no)
            pxy = torch.sigmoid(ps[..., :2]) * 2.0 - 0.5
            pwh = torch.square(torch.sigmoid(ps[..., 2:4]) * 2.0) * lt.anch
            pbox = torch.cat([pxy, pwh], -1)
            iou = bbox_iou(pbox, lt.tbox, xywh=True, CIoU=True)
            r = 0.5
            if self.nwd > 0:
                nwd_fn = wasserstein if self.shape_nwd > 0 else wasserstein_loss
                nwd = nwd_fn(pbox, lt.tbox) if self.nwd_ref_defect else nwd_fn(xywh2xyxy(pbox), xywh2xyxy(lt.tbox))
                iou_t = torch.clamp(iou.detach() * (1 - r) + nwd.detach() * r, 0.0, 1.0)
            else:
                iou_t = torch.clamp(iou.detach(), 0.0, 1.0)
            mask = lt.mask
            maskf = mask.float()
            obj_val = ((1.0 - self.gr) + self.gr * iou_t) * maskf
            cell = (lt.gj * nx + lt.gi) * na + lt.a  # (B, K) flat index into (ny, nx, na)
            tobj = torch.zeros((B, ny * nx * na), dtype=torch.float32, device=dev)
            tobj = tobj.scatter_reduce(1, cell, obj_val, "amax", include_self=True).reshape(B, ny, nx, na)

            n_pos, iou_sum = maskf.sum(), (iou_t * maskf).sum()
            if group is not None:  # the global batch's positives and IoU sum, as values
                n_pos, iou_sum = mesh.all_reduce_flat([torch.stack([n_pos, iou_sum])])[0]
            denom = n_pos + 1e-12
            if self.nwd > 0:
                lbox = lbox + (1 - r) * ((1.0 - iou) * maskf).sum() / denom + r * ((1.0 - nwd) * maskf).sum() / denom
            else:
                lbox = lbox + ((1.0 - iou) * maskf).sum() / denom
            auto_iou = torch.where(n_pos > 0, iou_sum / denom, 0.5)

            if self.nc > 1:  # classification only with more than one class
                t = torch.where(F.one_hot(lt.tcls, self.nc).bool(), self.cp, self.cn)
                closs = bce_with_logits(ps[..., 5:], t, self.hyp["cls_pw"])
                if self.fl_gamma > 0:
                    closs = focal_modulation(closs, ps[..., 5:], t, self.fl_gamma)
                if self.slide_ratio > 0:
                    closs = slide_modulation(closs, t, auto_iou)
                lcls = lcls + (closs * maskf[..., None]).sum() / (denom * self.nc)

            oloss = bce_with_logits(pi[..., 4], tobj, self.hyp["obj_pw"])
            if self.fl_gamma > 0:
                oloss = focal_modulation(oloss, pi[..., 4], tobj, self.fl_gamma)
            if self.slide_ratio > 0:
                oloss = slide_modulation(oloss, tobj, auto_iou)
            lobj = lobj + oloss.mean() / world * self.balance[i]
            if self.rep:
                lrep = lrep + self.repulsion(pbox, lt).mean() / world

        lbox = lbox * self.hyp["box"]
        lobj = lobj * self.hyp["obj"]
        lcls = lcls * self.hyp["cls"]
        total = lbox + lobj + lcls
        if self.rep:
            total = total + lrep
        return total * bs, torch.stack([lbox, lobj, lcls]).detach()

    @torch.no_grad()
    def repulsion(self, pbox: torch.Tensor, lt: LevelTargets, cap: int = 256) -> torch.Tensor:
        """Each image's RepGT and RepBox, alpha * RepGT + beta * RepBox, over
        its first `cap` positives in candidate order. pbox (B, K, 4) xywh
        in grid units relative to the cell. Returns (B,), without a
        gradient."""
        B, K = lt.mask.shape
        cap = min(cap, K)
        idx = torch.argsort((~lt.mask).to(torch.uint8), dim=1, stable=True)[:, :cap]  # positives first, in order
        m = torch.gather(lt.mask, 1, idx)
        cell = torch.stack([torch.gather(lt.gi, 1, idx), torch.gather(lt.gj, 1, idx)], -1).float()
        shift = torch.cat([cell, torch.zeros_like(cell)], -1)
        take = idx[..., None].expand(-1, -1, 4)
        pb = torch.where(m[..., None], xywh2xyxy(torch.gather(pbox, 1, take) + shift), -1e4)
        gb = torch.where(m[..., None], xywh2xyxy(torch.gather(lt.tbox, 1, take) + shift), -1e4)

        pair_ok = m[:, :, None] & m[:, None, :]
        same_gt = (torch.abs(gb[:, :, None] - gb[:, None, :]) < 1e-6).all(-1)
        keep = (pair_ok & ~same_gt).float()

        # RepGT: each positive against its second-best ground truth
        pg = _iou_matrix(pb, gb) * keep
        max_iou, sec = pg.max(2)
        iog = _iog(torch.gather(gb, 1, sec[..., None].expand(-1, -1, 4)), pb)
        active = ((max_iou > 0.0) & m).float()
        repgt = (_smooth_ln(iog, self.rep_deta) * active).sum(1) / (active.sum(1) + 1e-9)

        # RepBox: positives of different ground truths against each other
        pp = _iou_matrix(pb, pb) * keep
        pair_active = (pp > self.rep_nms).float() * torch.tril(torch.ones_like(pp[0]), diagonal=-1)
        repbox = (_smooth_ln(pp, 0.0) * pair_active).sum((1, 2)) / (pair_active.sum((1, 2)) + 1e-9)
        return self.rep_alpha * repgt + self.rep_beta * repbox


def _iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, N, 4) x (B, M, 4) xyxy -> (B, N, M) IoU."""
    lt = torch.maximum(a[:, :, None, :2], b[:, None, :, :2])
    rb = torch.minimum(a[:, :, None, 2:], b[:, None, :, 2:])
    inter = torch.clamp(rb - lt, min=0).prod(-1)
    aa = torch.clamp(a[..., 2:] - a[..., :2], min=0).prod(-1)
    ab = torch.clamp(b[..., 2:] - b[..., :2], min=0).prod(-1)
    return inter / (aa[:, :, None] + ab[:, None, :] - inter + 1e-9)


def _smooth_ln(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """The repulsion smooth-ln: -ln(1 - x) up to sigma, linear beyond."""
    x = torch.clamp(x, 0.0, 1.0 - 1e-4)
    sig = min(max(sigma, 0.0), 1.0 - 1e-4)
    return torch.where(x <= sig, -torch.log1p(-x), (x - sig) / (1.0 - sig) - math.log(1.0 - sig))


def _iog(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Intersection over the ground truth's area, (..., 4) xyxy pairs."""
    x1 = torch.maximum(gt[..., 0], pred[..., 0])
    y1 = torch.maximum(gt[..., 1], pred[..., 1])
    x2 = torch.minimum(gt[..., 2], pred[..., 2])
    y2 = torch.minimum(gt[..., 3], pred[..., 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    return inter / torch.clamp((gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1]), min=1e-6)
