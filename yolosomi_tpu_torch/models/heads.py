"""The anchor-grid detection heads, the SOMI head and YOLOv5's coupled
one, and the grid decode (counterparts of yolosomi_tpu/models/heads.py:29-180).

Heads emit raw per-level maps (B, ny, nx, na, no) with no = nc + 5 and the
[xy, wh, obj, cls] layout of the JAX package. Decode math:
    xy = (2*sigmoid(txy) - 0.5 + mesh) * stride
    wh = (2*sigmoid(twh))^2 * anchor_px
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn as nn

from yolosomi_tpu_torch.models.layers import Conv, ConvRaw


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
