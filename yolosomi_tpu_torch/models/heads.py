"""The detection heads and their decodes (counterparts of
yolosomi_tpu/models/heads.py).

The anchor-grid heads (Detect, the SOMI DecoupledDetect, YOLOv7's IDetect
and IAuxDetect, ASFF_Detect, CLLADetect, TSCODE_Detect, DetectODConv and
the v5-seg Segment) emit raw per-level maps (B, ny, nx, na, no) with
no = nc + 5 (Segment: + nm mask coefficients) in the [xy, wh, obj, cls]
layout of the JAX package. Decode math:
    xy = (2*sigmoid(txy) - 0.5 + mesh) * stride
    wh = (2*sigmoid(twh))^2 * anchor_px
The anchor-free DFL heads (DetectV8, DetectV11) emit (B, ny, nx,
4*reg_max + nc) maps that `decode_v8` turns into the same rows with
obj = 1; DetectV11's NMS-free branch selects with `postprocess_end2end`.

Module and parameter names follow the flax modules' (`cv2_<i>_<j>`,
`ia<i>`, `m2_<i>`, `asff<i>`, `m_dpe<i>`, ...), so the weight bridge
(utils/weights.py) maps each flax path by name.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from yolosomi_tpu_torch.models.layers import SEAM, Conv, ConvRaw, ODConv2d
from yolosomi_tpu_torch.ops.nms import top_k  # jax.lax.top_k's order: the lower index first among equal values


def decouple_taper(c_: int, na5: int) -> list:
    """The Decouple branch channel taper,
    `[int(x + na*5) for x in (c_-na*5)*torch.linspace(1,0,4)]`, evaluated in
    float32 bit-for-bit (c_=128 gives [128, 91, 56, 20], not 92)."""
    step = np.float32(1) / np.float32(3)
    vals = (np.float32(1), np.float32(1) - step, step, np.float32(0))
    return [int(np.float32(c_ - na5) * v + np.float32(na5)) for v in vals]


class Detect(nn.Module):
    """YOLOv5's coupled head: one 1x1 conv with bias per level, na * (nc+5)
    outputs in [anchor][xywh, obj, cls] order."""

    def __init__(self, nc: int, na: int, ch: Sequence[int]):
        super().__init__()
        self.na, self.no = na, nc + 5
        self.m = nn.ModuleList(ConvRaw(c, na * self.no, 1) for c in ch)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        out = []
        for m, x in zip(self.m, xs):
            y = m(x).permute(0, 2, 3, 1)  # NHWC view
            b, ny, nx, _ = y.shape
            out.append(y.reshape(b, ny, nx, self.na, self.no))
        return out


class Decouple(nn.Module):
    """Decoupled branch head for one level: a 1x1 stem, a 2-conv box+obj
    branch tapering toward na*5 channels, and a 2-conv class branch."""

    def __init__(self, c1: int, nc: int, na: int):
        super().__init__()
        self.nc, self.na = nc, na
        c_ = min(c1, 256)
        na5 = na * 5
        taper = decouple_taper(c_, na5)
        self.a = Conv(c1, c_, 1)
        self.b1 = Conv(c_, taper[1], 3)
        self.b2 = Conv(taper[1], taper[2], 3)
        self.b3 = ConvRaw(taper[2], na5, 1)
        self.c1 = Conv(c_, c_, 1)
        self.c2 = Conv(c_, c_, 1)
        self.c3 = ConvRaw(c_, na * nc, 1)

    def forward(self, x):
        stem = self.a(x)
        r = self.b3(self.b2(self.b1(stem))).permute(0, 2, 3, 1)  # NHWC view
        c = self.c3(self.c2(self.c1(stem))).permute(0, 2, 3, 1)
        b, ny, nx, _ = r.shape
        r = r.reshape(b, ny, nx, self.na, 5)
        c = c.reshape(b, ny, nx, self.na, self.nc)
        return torch.cat([r, c], -1)


class DecoupledDetect(nn.Module):
    """The SOMI head: one Decouple branch per level."""

    def __init__(self, nc: int, na: int, ch: Sequence[int]):
        super().__init__()
        self.m = nn.ModuleList(Decouple(c, nc, na) for c in ch)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        return [m(x) for m, x in zip(self.m, xs)]


def _grid_boxes(y: torch.Tensor, anchors_px: torch.Tensor, stride: float) -> torch.Tensor:
    """Sigmoided maps (B, ny, nx, na, >=4) -> pixel xywh (B, ny, nx, na, 4)."""
    _, ny, nx, na = y.shape[:4]
    gy, gx = torch.meshgrid(torch.arange(ny, dtype=torch.float32, device=y.device),
                            torch.arange(nx, dtype=torch.float32, device=y.device), indexing="ij")
    mesh = torch.stack([gx, gy], -1)[None, :, :, None, :]
    xy = (y[..., 0:2] * 2.0 - 0.5 + mesh) * stride
    wh = torch.square(y[..., 2:4] * 2.0) * anchors_px.reshape(1, 1, 1, na, 2)
    return torch.cat([xy, wh], -1)


def decode_boxes_level(p4: torch.Tensor, anchors_px: torch.Tensor, stride: float) -> torch.Tensor:
    """The box decode of one raw level map (B, ny, nx, na, >=4) -> pixel
    xywh (B, ny, nx, na, 4) (heads.py:138): the geometry the eval decode
    and the distillation's box imitation share."""
    return _grid_boxes(torch.sigmoid(p4[..., :4].float()), anchors_px, stride)


def decode_level(p: torch.Tensor, anchors_px: torch.Tensor, stride: float) -> torch.Tensor:
    """One raw level map (B, ny, nx, na, no) -> (B, ny*nx*na, no) rows
    [xc, yc, w, h, obj, cls...] in pixels, with sigmoid applied to obj and cls."""
    b, ny, nx, na, no = p.shape
    y = torch.sigmoid(p.float())
    return torch.cat([_grid_boxes(y, anchors_px, stride), y[..., 4:]], -1).reshape(b, ny * nx * na, no)


def decode(preds: Sequence[torch.Tensor], anchors_px, strides) -> torch.Tensor:
    """Decode all levels and concatenate -> (B, sum(ny*nx*na), no)."""
    anchors_px = torch.as_tensor(np.asarray(anchors_px, np.float32), device=preds[0].device)
    return torch.cat([decode_level(p, anchors_px[i], float(strides[i])) for i, p in enumerate(preds)], 1)


# ---------------------------------------------------------------------------
# the anchor-free DFL heads (heads.py:181-253, :669-724)
# ---------------------------------------------------------------------------


def dfl(x: torch.Tensor) -> torch.Tensor:
    """Distribution focal decode (heads.py:181): softmax over the last axis
    of reg_max bins -> the expected bin, in float32."""
    bins = torch.arange(x.shape[-1], dtype=torch.float32, device=x.device)
    return (torch.softmax(x.float(), -1) * bins).sum(-1)


class _DFLHead(nn.Module):
    """Per level a box branch (two 3x3 Convs -> 4*reg_max) and a class
    branch (a 3x3 Conv, then `cls_mid`, -> nc), named `<prefix>cv2_<i>_<j>`
    and `<prefix>cv3_<i>_<j>` as the flax modules."""

    def _add_branches(self, nc: int, ch: Sequence[int], reg_max: int, c3: int, cls_mid, prefix: str = "") -> None:
        c2 = max(16, ch[0] // 4, reg_max * 4)
        for i, c in enumerate(ch):
            for name, mods in (("cv2", (Conv(c, c2, 3), Conv(c2, c2, 3), ConvRaw(c2, 4 * reg_max, 1))),
                               ("cv3", (Conv(c, c3, 3), cls_mid(c3), ConvRaw(c3, nc, 1)))):
                for j, m in enumerate(mods):
                    self.add_module(f"{prefix}{name}_{i}_{j}", m)

    def _branches(self, xs: List[torch.Tensor], prefix: str = "") -> List[torch.Tensor]:
        def run(name, i, x):
            for j in range(3):
                x = getattr(self, f"{prefix}{name}_{i}_{j}")(x)
            return x

        return [torch.cat([run("cv2", i, x), run("cv3", i, x)], 1).permute(0, 2, 3, 1) for i, x in enumerate(xs)]


class DetectV8(_DFLHead):
    """The anchor-free YOLOv8 head (heads.py:193): per level (B, ny, nx,
    4*reg_max + nc) raw maps; `decode_v8` gives pixel rows. Its class
    width is the uncapped max(ch[0], nc) (heads.py:211-214)."""

    def __init__(self, nc: int, ch: Sequence[int], reg_max: int = 16):
        super().__init__()
        self.nc, self.reg_max = nc, reg_max
        self._add_branches(nc, ch, reg_max, max(ch[0], nc), lambda c: Conv(c, c, 3))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        return self._branches(xs)


class DetectV11(_DFLHead):
    """The anchor-free v11 head (heads.py:669): DetectV8's box branch and a
    class branch with SEAM, its width max(ch[0], min(nc, 100)). With
    `end2end` a copy `one2one_*` runs on the detached inputs: in train mode
    the head returns {"one2many": maps, "one2one": maps}, in eval the
    one2one maps (for `postprocess_end2end`)."""

    def __init__(self, nc: int, ch: Sequence[int], reg_max: int = 16, end2end: bool = False,
                 approx_gelu: bool = False):
        super().__init__()
        self.nc, self.reg_max, self.end2end = nc, reg_max, end2end
        c3 = max(ch[0], min(nc, 100))
        seam = lambda c: SEAM(c, 1, 16, approx_gelu=approx_gelu)  # noqa: E731
        for prefix in ("", "one2one_") if end2end else ("",):
            self._add_branches(nc, ch, reg_max, c3, seam, prefix)

    def forward(self, xs: List[torch.Tensor]):
        one2many = self._branches(xs)
        if not self.end2end:
            return one2many
        one2one = self._branches([x.detach() for x in xs], "one2one_")
        return {"one2many": one2many, "one2one": one2one} if self.training else one2one


def decode_v8(preds: Sequence[torch.Tensor], strides, nc: int, reg_max: int = 16) -> torch.Tensor:
    """Anchor-free decode (heads.py:226): DFL ltrb distances from the cell
    centres -> rows [xc, yc, w, h, 1, cls...] in pixels, in float32, so the
    anchor heads' NMS applies."""
    rows = []
    for p, s in zip(preds, strides):
        b, ny, nx, _ = p.shape
        stride = float(s)
        dist = dfl(p[..., :4 * reg_max].reshape(b, ny, nx, 4, reg_max))
        gy, gx = torch.meshgrid(torch.arange(ny, dtype=torch.float32, device=p.device) + 0.5,
                                torch.arange(nx, dtype=torch.float32, device=p.device) + 0.5, indexing="ij")
        x1, y1 = gx - dist[..., 0], gy - dist[..., 1]
        x2, y2 = gx + dist[..., 2], gy + dist[..., 3]
        box = torch.stack([(x1 + x2) / 2 * stride, (y1 + y2) / 2 * stride, (x2 - x1) * stride, (y2 - y1) * stride,
                           torch.ones_like(x1)], -1)
        conf = torch.sigmoid(p[..., 4 * reg_max:].float())
        rows.append(torch.cat([box, conf], -1).reshape(b, ny * nx, 5 + nc))
    return torch.cat(rows, 1)


def postprocess_end2end(pred_rows: torch.Tensor, max_det: int, nc: int) -> torch.Tensor:
    """NMS-free top-k selection (heads.py:709). pred_rows (B, N, 4 + nc)
    decoded [x, y, w, h, cls...] -> (B, max_det, 6) rows [x, y, w, h,
    score, cls]."""
    b, n, _ = pred_rows.shape
    boxes, scores = pred_rows[..., :4], pred_rows[..., 4:]
    k = min(max_det, n)
    _, idx = top_k(scores.amax(-1), k)
    boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    scores = torch.gather(scores, 1, idx[..., None].expand(-1, -1, nc))
    flat_scores, flat_idx = top_k(scores.reshape(b, -1), k)
    sel = torch.gather(boxes, 1, (flat_idx // nc)[..., None].expand(-1, -1, 4))
    return torch.cat([sel, flat_scores[..., None], (flat_idx % nc).to(pred_rows.dtype)[..., None]], -1)


# ---------------------------------------------------------------------------
# YOLOv7's implicit heads (heads.py:261-372)
# ---------------------------------------------------------------------------


class ImplicitA(nn.Module):
    """Learnable additive implicit knowledge, (1, C, 1, 1)."""

    def __init__(self, c: int):
        super().__init__()
        self.implicit = nn.Parameter(torch.zeros(1, c, 1, 1))

    def forward(self, x):
        return x + self.implicit.to(x.dtype)


class ImplicitM(ImplicitA):
    """Learnable multiplicative implicit knowledge, (1, C, 1, 1)."""

    def forward(self, x):
        return x * self.implicit.to(x.dtype)


def _level_map(y: torch.Tensor, na: int, no: int) -> torch.Tensor:
    """A prediction conv's NCHW output -> (B, ny, nx, na, no)."""
    y = y.permute(0, 2, 3, 1)
    b, ny, nx, _ = y.shape
    return y.reshape(b, ny, nx, na, no)


class IDetect(nn.Module):
    """YOLOv7's implicit head (heads.py:291): ImplicitA -> 1x1 conv ->
    ImplicitM per level."""

    def __init__(self, nc: int, na: int, ch: Sequence[int]):
        super().__init__()
        self.na, self.no = na, nc + 5
        self.m = nn.ModuleList(ConvRaw(c, na * self.no, 1) for c in ch)
        for i, c in enumerate(ch):
            self.add_module(f"ia{i}", ImplicitA(c))
            self.add_module(f"im{i}", ImplicitM(na * self.no))

    def lead(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return _level_map(getattr(self, f"im{i}")(self.m[i](getattr(self, f"ia{i}")(x))), self.na, self.no)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        return [self.lead(i, x) for i, x in enumerate(xs)]


class IAuxDetect(IDetect):
    """YOLOv7's auxiliary head (heads.py:327): the first nl inputs take the
    implicit lead head, the second nl a plain 1x1 conv `m2_<i>`. Train mode
    returns the 2*nl lead and aux maps (ComputeLoss weighs the aux ones
    0.25), eval the nl lead maps."""

    def __init__(self, nc: int, na: int, ch: Sequence[int]):
        nl = len(ch) // 2
        super().__init__(nc, na, ch[:nl])
        for i, c in enumerate(ch[nl:]):
            self.add_module(f"m2_{i}", ConvRaw(c, na * self.no, 1))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        nl = len(self.m)
        if len(xs) != 2 * nl:
            raise ValueError(f"IAuxDetect wants 2*nl={2 * nl} inputs, got {len(xs)}")
        lead = [self.lead(i, x) for i, x in enumerate(xs[:nl])]
        if not self.training:
            return lead
        return lead + [_level_map(getattr(self, f"m2_{i}")(x), self.na, self.no) for i, x in enumerate(xs[nl:])]


# ---------------------------------------------------------------------------
# ASFF (heads.py:379-473)
# ---------------------------------------------------------------------------


def _up(x: torch.Tensor, s: int) -> torch.Tensor:
    return F.interpolate(x, scale_factor=s, mode="nearest")


class ASFF(nn.Module):
    """Adaptively spatial feature fusion at one pyramid level (heads.py:399):
    the three maps (deepest first) brought to this level's size and width,
    mixed by a per-pixel softmax over three learned weights (in float32).
    Every conv is Conv with LeakyReLU(0.1); the deepest map reaches level 0
    through a 3x3 stride-2 max pool with padding 1, then a stride-2 Conv."""

    def __init__(self, level: int, ch: Sequence[int], compress_c: int = 16):
        super().__init__()
        self.level = level
        c = ch[level]
        leaky = lambda c1, c2, k, s=1: Conv(c1, c2, k, s, act=nn.LeakyReLU(0.1))  # noqa: E731
        if level == 0:
            self.stride_level_1 = leaky(ch[1], c, 3, 2)
            self.stride_level_2 = leaky(ch[2], c, 3, 2)
        elif level == 1:
            self.compress_level_0 = leaky(ch[0], c, 1)
            self.stride_level_2 = leaky(ch[2], c, 3, 2)
        else:
            self.compress_level_0 = leaky(ch[0], c, 1)
            self.compress_level_1 = leaky(ch[1], c, 1)
        for i in range(3):
            self.add_module(f"weight_level_{i}", leaky(c, compress_c, 1))
        self.weight_levels = ConvRaw(3 * compress_c, 3, 1)
        self.expand = leaky(c, c, 3)

    def forward(self, xs: List[torch.Tensor]) -> torch.Tensor:
        x0, x1, x2 = xs
        if self.level == 0:
            r = (x0, self.stride_level_1(x1), self.stride_level_2(F.max_pool2d(x2, 3, 2, 1)))
        elif self.level == 1:
            r = (_up(self.compress_level_0(x0), 2), x1, self.stride_level_2(x2))
        else:
            r = (_up(self.compress_level_0(x0), 4), _up(self.compress_level_1(x1), 2), x2)
        w = self.weight_levels(torch.cat([getattr(self, f"weight_level_{i}")(t) for i, t in enumerate(r)], 1))
        w = torch.softmax(w.float(), 1).to(r[0].dtype)
        return self.expand(r[0] * w[:, 0:1] + r[1] * w[:, 1:2] + r[2] * w[:, 2:3])


class ASFFDetect(nn.Module):
    """Detect after ASFF at each of its three levels (heads.py:440), fused
    in turn from the deepest, each fusion seeing the levels fused before."""

    def __init__(self, nc: int, na: int, ch: Sequence[int]):
        super().__init__()
        if len(ch) != 3:
            raise ValueError(f"ASFF_Detect is a 3-level head, got {len(ch)} inputs")
        self.na, self.no = na, nc + 5
        rev = list(ch[::-1])
        for i in range(3):
            self.add_module(f"asff{i}", ASFF(i, rev))
        self.m = nn.ModuleList(ConvRaw(c, na * self.no, 1) for c in ch)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        rev = list(xs[::-1])
        for i in range(3):
            rev[i] = getattr(self, f"asff{i}")(rev)
        return [_level_map(m(x), self.na, self.no) for m, x in zip(self.m, rev[::-1])]


# ---------------------------------------------------------------------------
# CLLA (heads.py:481-567)
# ---------------------------------------------------------------------------


class CLLA(nn.Module):
    """Cross-layer local attention (heads.py:481): each pixel of the coarse
    map x2 attends over the range x range taps of the 2x-finer map x1 with
    the inverted relevance 2*mean - dots (softmax in float32)."""

    def __init__(self, c: int, range_: int = 2):
        super().__init__()
        self.range_ = range_
        self.q, self.k, self.v = nn.Linear(c, c), nn.Linear(c, c), nn.Linear(c, c)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        r = self.range_
        pad = int(r / 2 - 1)
        x1 = x1.permute(0, 2, 3, 1)
        x2 = x2.permute(0, 2, 3, 1)
        _, h2, w2, _ = x2.shape
        x1p = F.pad(x1, (0, 0, pad, pad, pad, pad))
        local = torch.stack([x1p[:, i::2, j::2][:, :h2, :w2] for i in range(r) for j in range(r)], 3)
        q = self.q(x2)[:, :, :, None, :]
        dots = (q * self.k(local) / r).sum(-1)
        irr = dots.mean(3, keepdim=True) * 2 - dots
        att = torch.softmax(irr.float(), -1).to(x2.dtype)
        out = (self.v(local) * att[..., None]).sum(3)
        return ((out + x2) / 2).permute(0, 3, 1, 2)


class CLLABlock(nn.Module):
    """1x1 projections of both maps to c, CLLA, a 1x1 prediction conv."""

    def __init__(self, c1: int, c2: int, out: int, c: int, range_: int = 2):
        super().__init__()
        self.conv1, self.conv2 = ConvRaw(c1, c, 1), ConvRaw(c2, c, 1)
        self.att = CLLA(c, range_)
        self.det = ConvRaw(c, out, 1)

    def forward(self, x1, x2):
        return self.det(self.att(self.conv1(x1), self.conv2(x2)))


class CLLADetect(nn.Module):
    """Detect whose level 0 is a CLLA fusion of the two finest inputs at the
    second one's size (heads.py:530); level i > 0 is a 1x1 conv `m<i-1>` of
    input i + 1. nl + 1 inputs."""

    def __init__(self, nc: int, na: int, ch: Sequence[int]):
        super().__init__()
        self.na, self.no = na, nc + 5
        self.det = CLLABlock(ch[0], ch[1], na * self.no, ch[0])
        self.m = nn.ModuleList(ConvRaw(c, na * self.no, 1) for c in ch[2:])

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        if len(xs) != len(self.m) + 2:
            raise ValueError(f"CLLADetect wants nl+1={len(self.m) + 2} inputs, got {len(xs)}")
        return [_level_map(self.det(xs[0], xs[1]), self.na, self.no)] + [
            _level_map(m(x), self.na, self.no) for m, x in zip(self.m, xs[2:])]


# ---------------------------------------------------------------------------
# TSCODE (heads.py:575-660)
# ---------------------------------------------------------------------------


class SCE(nn.Module):
    """Semantic context encoding: the level downsampled, beside the next
    coarser map."""

    def __init__(self, c1: int):
        super().__init__()
        self.down = Conv(c1, c1, 3, 2)

    def forward(self, xs):
        return torch.cat([self.down(xs[0]), xs[1]], 1)


class DPE(nn.Module):
    """Detail-preserving encoding over (finer, level, coarser) maps."""

    def __init__(self, ch: Sequence[int], c2: int):
        super().__init__()
        cf, cm, cc = ch
        self.adjust_channel_forp2 = Conv(cm, c2, 1)
        self.up_forp2 = Conv(c2, c2, 1)
        self.adjust_channel_forp1 = Conv(cf, c2, 1)
        self.down = Conv(c2, c2, 3, 2)
        self.up_forp3 = Conv(cc, c2, 1)

    def forward(self, xs):
        f, m, c = xs
        x_p2 = self.adjust_channel_forp2(m)
        x_p1 = self.down(self.adjust_channel_forp1(f) + self.up_forp2(_up(x_p2, 2)))
        return x_p1 + x_p2 + self.up_forp3(_up(c, 2))


class TSCODEDetect(nn.Module):
    """Task-separate context-decoupled head (heads.py:606): nl + 2 inputs;
    level i (input i + 1) predicts its classes from SCE at half size,
    pixel-shuffled 2x2 back up, and box and objectness from DPE."""

    def __init__(self, nc: int, na: int, ch: Sequence[int]):
        super().__init__()
        self.nc, self.na, self.nl = nc, na, len(ch) - 2
        for i in range(self.nl):
            c = ch[i + 1]
            self.add_module(f"m_sce{i}", SCE(c))
            self.add_module(f"m_dpe{i}", DPE(ch[i:i + 3], c))
            for j, m in enumerate((Conv(c + ch[i + 2], c, 1), Conv(c, c, 3), ConvRaw(c, na * nc * 4, 1))):
                self.add_module(f"m_cls{i}_{j}", m)
            self.add_module(f"m_reg_conf{i}_0", Conv(c, c, 3))
            self.add_module(f"m_reg_conf{i}_1", Conv(c, c, 3))
            self.add_module(f"m_reg{i}", ConvRaw(c, na * 4, 1))
            self.add_module(f"m_conf{i}", ConvRaw(c, na, 1))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        if len(xs) != self.nl + 2:
            raise ValueError(f"TSCODE_Detect wants nl+2={self.nl + 2} inputs, got {len(xs)}")
        na, nc = self.na, self.nc
        outs = []
        for i in range(self.nl):
            x = xs[i + 1]
            b, _, ny, nx = x.shape
            get = lambda name: getattr(self, name)  # noqa: E731
            c = get(f"m_sce{i}")(xs[i + 1:i + 3])
            for j in range(3):
                c = get(f"m_cls{i}_{j}")(c)
            c = c.permute(0, 2, 3, 1)
            hh, ww = c.shape[1:3]
            c = c.reshape(b, hh, ww, na, 2, 2, nc).permute(0, 1, 4, 2, 5, 3, 6).reshape(b, hh * 2, ww * 2, na, nc)
            r = get(f"m_reg_conf{i}_1")(get(f"m_reg_conf{i}_0")(get(f"m_dpe{i}")(xs[i:i + 3])))
            reg = _level_map(get(f"m_reg{i}")(r), na, 4)
            conf = _level_map(get(f"m_conf{i}")(r), na, 1)
            outs.append(torch.cat([reg, conf, c[:, :ny, :nx]], -1))
        return outs


# ---------------------------------------------------------------------------
# DetectODConv and Segment (heads.py:727-834)
# ---------------------------------------------------------------------------


class DetectODConvHead(nn.Module):
    """Detect with 1x1 stride-1 ODConv2d prediction convs (heads.py:727)."""

    def __init__(self, nc: int, na: int, ch: Sequence[int]):
        super().__init__()
        self.na, self.no = na, nc + 5
        self.m = nn.ModuleList(ODConv2d(c, na * self.no, 1, 1) for c in ch)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        return [_level_map(m(x), self.na, self.no) for m, x in zip(self.m, xs)]


class Proto(nn.Module):
    """The v5-seg mask prototypes: 3x3 Conv, 2x nearest upsample, 3x3 Conv,
    1x1 Conv to nm maps."""

    def __init__(self, c1: int, npr: int = 256, nm: int = 32):
        super().__init__()
        self.cv1, self.cv2, self.cv3 = Conv(c1, npr, 3), Conv(npr, npr, 3), Conv(npr, nm, 1)

    def forward(self, x):
        return self.cv3(self.cv2(_up(self.cv1(x), 2)))


class Segment(nn.Module):
    """The v5-seg head (heads.py:778): Detect with nm mask coefficients per
    anchor, and Proto on the finest level. Returns (levels, proto): levels
    (B, ny, nx, na, 5 + nc + nm), proto (B, 2*H0, 2*W0, nm)."""

    def __init__(self, nc: int, na: int, ch: Sequence[int], nm: int = 32, npr: int = 256):
        super().__init__()
        self.na, self.nm, self.no = na, nm, nc + 5 + nm
        self.proto = Proto(ch[0], npr, nm)
        self.m = nn.ModuleList(ConvRaw(c, na * self.no, 1) for c in ch)

    def forward(self, xs: List[torch.Tensor]):
        levels = [_level_map(m(x), self.na, self.no) for m, x in zip(self.m, xs)]
        return levels, self.proto(xs[0]).permute(0, 2, 3, 1)


def assemble_masks(proto: torch.Tensor, coeffs: torch.Tensor, boxes_xyxy: torch.Tensor) -> torch.Tensor:
    """Prototypes (Hm, Wm, nm) and per-detection coefficients (N, nm) ->
    (N, Hm, Wm) sigmoid masks, zero outside each box (N, 4) xyxy in
    mask-map pixels (heads.py:821)."""
    hm, wm, _ = proto.shape
    masks = torch.sigmoid(torch.einsum("hwc,nc->nhw", proto, coeffs))
    ys = torch.arange(hm, dtype=boxes_xyxy.dtype, device=proto.device)[None, :, None]
    xs = torch.arange(wm, dtype=boxes_xyxy.dtype, device=proto.device)[None, None, :]
    x1, y1, x2, y2 = (boxes_xyxy[:, i][:, None, None] for i in range(4))
    return masks * ((xs >= x1) & (xs < x2) & (ys >= y1) & (ys < y2))
