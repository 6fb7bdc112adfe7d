"""layers_zoo.py's blocks (counterparts of
yolosomi_tpu/models/layers_zoo.py): SimConv, CoordConv / CoordConvd, ADown,
DownSimper, the SPP family (ASPP, SPPELAN, SPPCSPCS, SPPF_improve), the RFB
blocks, RepVGGBlock in its train form, the ConvNeXt, Conv2Former and
ConvMix CSP blocks (CNeB, C3CR, CSPCM), Conv_SWS's sliced SimAM, ACmix,
CPCA and the C3 / C2f blocks with attention bottlenecks; then the fusion
kinds: the transposed convs and the standalone BatchNorm, the n-ary merges
(Add, Multiply, CShortcut), the single-map blocks (ContextAggregation,
PSContextAggregation, ChannelAttentionHSFPN, CAM, SimAMWithSlicing,
C3CBAM, Conv2Former) and the multi-scale fusions (SDI, BiFPNSDI, BiFPNs,
BiFusion, SF, ScalSeq, AttentionModel).

Modules are NCHW in `torch.channels_last`, as models/layers.py's, and take
the input channels first (a list of them for a block of several inputs),
then the flax module's fields after `c2` in their declaration order (a
YAML row's args fill them so). Submodule and parameter names are the flax
names, which the weight bridge (utils/weights.py) maps by name; ACmix's
`fc` keeps its flax shape, and ACmix's `dep_conv` and ContextAggregation's
`m` are bare flax nn.Conv. A transposed conv converts its flax kernel
itself (`from_flax` / `to_flax`).

Numerical conventions kept from the JAX package:
- every GELU here is exact (`approximate=False`) in every dtype;
- the coordinate maps of CoordConv and ACmix are jnp.linspace(-1, 1, n)
  in the input's dtype, rounded after each operation as XLA computes it
  (`jax_linspace`): in bfloat16 that is not torch.linspace's result;
- LayerNorms take flax's fast variance at eps 1e-6 (models/layers.py
  FlaxLayerNorm); BatchNorms eps 1e-3;
- Conv_SWS leaves the pixels no tile covers at zero and divides each tile
  by the coverage count at the time of its add;
- ACmix's reflect padding reflects again where the pad reaches past the
  map (jnp.pad's "reflect"; F.pad refuses it), through gathered indices;
- flax's nn.ConvTranspose (transpose_kernel False) convolves the dilated
  input with its kernel as stored, where torch's flips it;
- the fusions' growth is bilinear with aligned corners at positions
  arange * (in - 1) / (out - 1) in float32, their shrink an average pool
  where the ratio is whole and jax.image.resize's antialiased linear
  resize where it is not; ScalSeq's nearest resize has half-pixel centres
  (floor((i + 0.5) * in / out) in float32);
- BiFPNSDI divides its raw weights by the sum of their swish, as the JAX
  package does.

None of them has a strip path: the Runner refuses to shard a graph that
names one (models.yolo.STRIPLESS), and those that reduce over the map,
read its coordinates, resize it or pad at its edges refuse a strip
themselves.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from yolosomi_tpu_torch.models import layers as L
from yolosomi_tpu_torch.models.layers import Conv, ConvRaw, refuse_strip

_K = Union[int, Tuple[int, int]]


def _bn(c: int) -> L.FlaxBatchNorm2d:
    return L.FlaxBatchNorm2d(c, eps=L.BN_EPS, momentum=L.BN_MOMENTUM)


def jax_linspace(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """jnp.linspace(-1.0, 1.0, n, dtype=dtype): the steps i / (n - 1) and
    -1 * (1 - step) + step, each operation rounded to `dtype`, then the end
    point 1 (jax/_src/numpy/array_creation.py `_linspace`)."""
    if n == 1:
        return torch.full((1,), -1.0, dtype=dtype, device=device)
    div = torch.tensor(n - 1, dtype=dtype, device=device)
    step = torch.arange(n - 1, dtype=dtype, device=device) / div
    out = -1.0 * (1 - step) + step
    return torch.cat([out, torch.ones(1, dtype=dtype, device=device)])


def coord_maps(h: int, w: int, dtype: torch.dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (1, 1, h, w) maps of the row and the column coordinate."""
    hh = jax_linspace(h, dtype, device).view(1, 1, h, 1).expand(1, 1, h, w)
    ww = jax_linspace(w, dtype, device).view(1, 1, 1, w).expand(1, 1, h, w)
    return hh, ww


class SimConv(nn.Module):
    """Bias-free conv `conv` ('same' padding), BatchNorm `bn`, ReLU
    (layers_zoo.py:134)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1):
        super().__init__()
        self.conv = ConvRaw(c1, c2, k, s, L.autopad(k), groups=g, bias=False)
        self.bn = _bn(c2)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class BasicConvB(nn.Module):
    """Bias-free conv `conv` with explicit padding p and dilation d,
    BatchNorm `bn`, then ReLU where `relu` (layers_zoo.py:150; the RFB
    blocks take its BatchNorm, ungrouped, everywhere)."""

    def __init__(self, c1: int, c2: int, k: _K = 1, s: int = 1, p: _K = 0, d: int = 1, relu: bool = True):
        super().__init__()
        self.conv = ConvRaw(c1, c2, k, s, p, dilation=d, bias=False)
        self.bn = _bn(c2)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return torch.relu(x) if self.relu else x


class CoordConv(nn.Module):
    """The row and column coordinates (and with_r their distance from
    (0.5, 0.5)) concatenated after the channels, then Conv `conv` (k, s,
    dilation d) (layers_zoo.py:176)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, with_r: bool = False, d: int = 1):
        super().__init__()
        self.with_r = with_r
        self.conv = Conv(c1 + 2 + int(with_r), c2, k, s, d=d)

    def forward(self, x):
        refuse_strip(self)
        b, _, h, w = x.shape
        hh, ww = coord_maps(h, w, x.dtype, x.device)
        coords = [hh.expand(b, 1, h, w), ww.expand(b, 1, h, w)]
        if self.with_r:
            coords.append(torch.sqrt((coords[0] - 0.5) ** 2 + (coords[1] - 0.5) ** 2))
        return self.conv(torch.cat([x, *coords], 1).contiguous(memory_format=torch.channels_last))


class CoordConvd(CoordConv):
    """CoordConv at dilation 2 (layers_zoo.py:200)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, with_r: bool = False, d: int = 2):
        super().__init__(c1, c2, k, s, with_r, d)


class ADown(nn.Module):
    """YOLOv9's downsample (layers_zoo.py:206): a VALID 2x2 mean at stride 1
    (H - 1 rows), then the first half of the channels through Conv `cv1`
    (3x3, stride 2) beside the second's 3x3 stride-2 max-pool and Conv
    `cv2` (1x1), c2 / 2 channels each."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        c = c2 // 2
        self.cv1 = Conv(c1 // 2, c, 3, 2)
        self.cv2 = Conv(c1 - c1 // 2, c, 1, 1, 0)

    def forward(self, x):
        refuse_strip(self)
        x = F.avg_pool2d(x, 2, 1, 0)
        half = x.shape[1] // 2
        return torch.cat([self.cv1(x[:, :half]), self.cv2(F.max_pool2d(x[:, half:], 3, 2, 1))], 1)


class DownSimper(nn.Module):
    """Conv `cv1` (3x3, stride 2) to c2 / 2 beside Conv `cv2` (1x1) to c2 / 2,
    whose halves take a 3x3 stride-2 max-pool and a 3x3 stride-2 mean
    (zero padding counted, flax's default) (layers_zoo.py:226)."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        c = c2 // 2
        self.cv1 = Conv(c1, c, 3, 2)
        self.cv2 = Conv(c1, c, 1, 1, 0)

    def forward(self, x):
        refuse_strip(self)
        y = self.cv2(x)
        half = y.shape[1] // 2
        return torch.cat([self.cv1(x), F.max_pool2d(y[:, :half], 3, 2, 1), F.avg_pool2d(y[:, half:], 3, 2, 1)], 1)


# ---------------------------------------------------------------------------
# the SPP family
# ---------------------------------------------------------------------------


class ASPP(nn.Module):
    """Atrous SPP (layers_zoo.py:328): Conv `cv1` to c1 / 2; the map, its
    3x3 max-pool and bias-free 3x3 convs `m<i>` dilated (k - 1) / 2 for k in
    `k` (2, 4, 6), concatenated into Conv `cv2`."""

    def __init__(self, c1: int, c2: int, k: Sequence[int] = (5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.m = nn.ModuleList(ConvRaw(c_, c_, 3, 1, (kk - 1) // 2, dilation=(kk - 1) // 2, bias=False) for kk in k)
        self.cv2 = Conv(c_ * (len(self.m) + 2), c2, 1, 1)

    def forward(self, x):
        x = self.cv1(x)
        return self.cv2(torch.cat([x, L.max_pool(x, 3), *(m(x) for m in self.m)], 1))


class SPPELAN(nn.Module):
    """YOLOv9's SPP-ELAN (layers_zoo.py:349): Conv `cv1` to c3 (c2 / 2 where
    c3 is 0), three chained 5x5 max-pools, all four into Conv `cv5`."""

    def __init__(self, c1: int, c2: int, c3: int = 0):
        super().__init__()
        c3 = c3 or c2 // 2
        self.cv1 = Conv(c1, c3, 1, 1)
        self.cv5 = Conv(4 * c3, c2, 1, 1)

    def forward(self, x):
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(L.max_pool(y[-1], 5))
        return self.cv5(torch.cat(y, 1))


class SPPCSPCS(nn.Module):
    """SPPCSPC with a SimAM gate `cv3` after `cv1` (layers_zoo.py:366), c_ =
    int(2 c2 e): the map beside its max-pools of each size in k into `cv5`,
    `cv6` (3x3); beside `cv2` of the input; `cv7` of both."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, g: int = 1, e: float = 0.5,
                 k: Sequence[int] = (3, 5, 9)):
        super().__init__()
        c_ = int(2 * c2 * e)
        self.k = tuple(k)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv3 = L.SimAM(c_)
        self.cv5 = Conv(c_ * (len(self.k) + 1), c_, 1, 1)
        self.cv6 = Conv(c_, c_, 3, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv7 = Conv(2 * c_, c2, 1, 1)

    def forward(self, x):
        x1 = self.cv3(self.cv1(x))
        y1 = self.cv6(self.cv5(torch.cat([x1] + [L.max_pool(x1, k) for k in self.k], 1)))
        return self.cv7(torch.cat([y1, self.cv2(x)], 1))


class SPPF_improve(nn.Module):
    """SPPF with the map's max and mean broadcast as two more branches
    (layers_zoo.py:390): Conv `cv1` to c1 / 2, three chained k-pools, then
    [x, y1, y2, y3, max, mean] into Conv `cv2`."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.k = k
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(6 * c_, c2, 1, 1)

    def forward(self, x):
        refuse_strip(self)
        x = self.cv1(x)
        y1 = L.max_pool(x, self.k)
        y2 = L.max_pool(y1, self.k)
        y3 = L.max_pool(y2, self.k)
        gmax = x.amax((2, 3), keepdim=True).expand_as(x)
        gavg = x.mean((2, 3), keepdim=True).expand_as(x)
        return self.cv2(torch.cat([x, y1, y2, y3, gmax, gavg], 1))


# ---------------------------------------------------------------------------
# RFB
# ---------------------------------------------------------------------------


class BasicRFB(nn.Module):
    """Receptive-field block (layers_zoo.py:416), ip = c1 / 8: three
    branches of BasicConvB `b<i>_<j>` dilated visual, visual + 1 and
    2 visual + 1 (stride s), concatenated into `linear`, scaled by `scale`,
    plus `shortcut` (1x1, stride s), ReLU."""

    def __init__(self, c1: int, c2: int, s: int = 1, scale: float = 0.1, visual: int = 1):
        super().__init__()
        ip, v = c1 // 8, visual
        self.scale = scale
        self.b0_0 = BasicConvB(c1, 2 * ip, 1, s)
        self.b0_1 = BasicConvB(2 * ip, 2 * ip, 3, 1, p=v, d=v, relu=False)
        self.b1_0 = BasicConvB(c1, ip, 1, 1)
        self.b1_1 = BasicConvB(ip, 2 * ip, 3, s, p=1)
        self.b1_2 = BasicConvB(2 * ip, 2 * ip, 3, 1, p=v + 1, d=v + 1, relu=False)
        self.b2_0 = BasicConvB(c1, ip, 1, 1)
        self.b2_1 = BasicConvB(ip, (ip // 2) * 3, 3, 1, p=1)
        self.b2_2 = BasicConvB((ip // 2) * 3, 2 * ip, 3, s, p=1)
        self.b2_3 = BasicConvB(2 * ip, 2 * ip, 3, 1, p=2 * v + 1, d=2 * v + 1, relu=False)
        self.linear = BasicConvB(6 * ip, c2, 1, 1, relu=False)
        self.shortcut = BasicConvB(c1, c2, 1, s, relu=False)

    def forward(self, x):
        b0 = self.b0_1(self.b0_0(x))
        b1 = self.b1_2(self.b1_1(self.b1_0(x)))
        b2 = self.b2_3(self.b2_2(self.b2_1(self.b2_0(x))))
        return torch.relu(self.linear(torch.cat([b0, b1, b2], 1)) * self.scale + self.shortcut(x))


class BasicRFB_a(nn.Module):
    """RFB-a (layers_zoo.py:447), ip = c1 / 4: four branches with 3x1 and 1x3
    kernels (stride s) and 3x3 convs dilated 1, 3, 3 and 5, concatenated
    into `linear`, scaled by `scale`, plus `shortcut`, ReLU."""

    def __init__(self, c1: int, c2: int, s: int = 1, scale: float = 0.1):
        super().__init__()
        ip = c1 // 4
        self.scale = scale
        self.b0_0 = BasicConvB(c1, ip, 1, 1)
        self.b0_1 = BasicConvB(ip, ip, 3, 1, p=1, relu=False)
        self.b1_0 = BasicConvB(c1, ip, 1, 1)
        self.b1_1 = BasicConvB(ip, ip, (3, 1), 1, p=(1, 0))
        self.b1_2 = BasicConvB(ip, ip, 3, 1, p=3, d=3, relu=False)
        self.b2_0 = BasicConvB(c1, ip, 1, 1)
        self.b2_1 = BasicConvB(ip, ip, (1, 3), s, p=(0, 1))
        self.b2_2 = BasicConvB(ip, ip, 3, 1, p=3, d=3, relu=False)
        self.b3_0 = BasicConvB(c1, ip // 2, 1, 1)
        self.b3_1 = BasicConvB(ip // 2, (ip // 4) * 3, (1, 3), 1, p=(0, 1))
        self.b3_2 = BasicConvB((ip // 4) * 3, ip, (3, 1), s, p=(1, 0))
        self.b3_3 = BasicConvB(ip, ip, 3, 1, p=5, d=5, relu=False)
        self.linear = BasicConvB(4 * ip, c2, 1, 1, relu=False)
        self.shortcut = BasicConvB(c1, c2, 1, s, relu=False)

    def forward(self, x):
        b0 = self.b0_1(self.b0_0(x))
        b1 = self.b1_2(self.b1_1(self.b1_0(x)))
        b2 = self.b2_2(self.b2_1(self.b2_0(x)))
        b3 = self.b3_3(self.b3_2(self.b3_1(self.b3_0(x))))
        return torch.relu(self.linear(torch.cat([b0, b1, b2, b3], 1)) * self.scale + self.shortcut(x))


# ---------------------------------------------------------------------------
# RepVGG, ConvNeXt, Conv2Former and ConvMix
# ---------------------------------------------------------------------------


class RepVGGBlock(nn.Module):
    """RepVGG in its train form (layers_zoo.py:483): bias-free `dense` (k,
    s, padding p) with `dense_bn`, plus bias-free 1x1 `one` (padding
    p - k / 2) with `one_bn`, plus BatchNorm `id_bn` of the input where c1
    == c2 and s == 1; SiLU. The branches stay apart, as in the JAX package."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, p: int = 1, g: int = 1):
        super().__init__()
        self.dense = ConvRaw(c1, c2, k, s, p, groups=g, bias=False)
        self.dense_bn = _bn(c2)
        self.one = ConvRaw(c1, c2, 1, s, p - k // 2, groups=g, bias=False)
        self.one_bn = _bn(c2)
        self.id_bn = _bn(c1) if c1 == c2 and s == 1 else None

    def forward(self, x):
        y = self.dense_bn(self.dense(x)) + self.one_bn(self.one(x))
        if self.id_bn is not None:
            y = y + self.id_bn(x)
        return F.silu(y)


class ConvNextBlock(nn.Module):
    """ConvNeXt block (layers_zoo.py:511): biased depthwise 7x7 `dwconv`,
    LayerNorm `norm` over the channels, Dense `pwconv1` (4c), exact GELU,
    Dense `pwconv2`, scaled by `gamma` (layer_scale_init_value), plus x."""

    def __init__(self, c1: int, layer_scale_init_value: float = 1e-6):
        super().__init__()
        self.dwconv = ConvRaw(c1, c1, 7, 1, 3, groups=c1)
        self.norm = L.FlaxLayerNorm(c1)
        self.pwconv1 = nn.Linear(c1, 4 * c1)
        self.pwconv2 = nn.Linear(4 * c1, c1)
        self.gamma = nn.Parameter(torch.full((c1,), layer_scale_init_value))

    def forward(self, x):
        y = self.pwconv2(F.gelu(self.pwconv1(self.norm(self.dwconv(x).permute(0, 2, 3, 1)))))
        return x + (self.gamma * y).permute(0, 3, 1, 2)


class CNeB(nn.Module):
    """CSP over n ConvNextBlocks `m<i>` (layers_zoo.py:531)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.m = nn.Sequential(*(ConvNextBlock(c_) for _ in range(n)))
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1, 1)

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class ConvMod(nn.Module):
    """Conv2Former's modulation (layers_zoo.py:551): LayerNorm `norm`; the
    biased 1x1 `a0`, exact GELU and depthwise 3x3 `a1` times the biased 1x1
    `v`; the biased 1x1 `proj`."""

    def __init__(self, c1: int):
        super().__init__()
        self.norm = L.FlaxLayerNorm(c1, dim=1)
        self.a0 = ConvRaw(c1, c1, 1)
        self.a1 = ConvRaw(c1, c1, 3, 1, 1, groups=c1)
        self.v = ConvRaw(c1, c1, 1)
        self.proj = ConvRaw(c1, c1, 1)

    def forward(self, x):
        x = self.norm(x)
        return self.proj(self.a1(F.gelu(self.a0(x))) * self.v(x))


class ConvBlock2F(nn.Module):
    """Conv2Former block (layers_zoo.py:568): x + `layer_scale_1` ConvMod
    `attn`; then LayerNorm `mlp_norm`, biased 1x1 `mlp_fc1` to mid (c where
    0), exact GELU, plus the GELU of its depthwise 3x3 `mlp_pos`, biased 1x1
    `mlp_fc2` back to c, scaled by `layer_scale_2`, plus x. Channel-preserving."""

    def __init__(self, c1: int, mid: int = 0):
        super().__init__()
        mid = mid or c1
        self.layer_scale_1 = nn.Parameter(torch.full((c1,), 1e-6))
        self.layer_scale_2 = nn.Parameter(torch.full((c1,), 1e-6))
        self.attn = ConvMod(c1)
        self.mlp_norm = L.FlaxLayerNorm(c1, dim=1)
        self.mlp_fc1 = ConvRaw(c1, mid, 1)
        self.mlp_pos = ConvRaw(mid, mid, 3, 1, 1, groups=mid)
        self.mlp_fc2 = ConvRaw(mid, c1, 1)

    def forward(self, x):
        x = x + self.layer_scale_1[:, None, None] * self.attn(x)
        y = F.gelu(self.mlp_fc1(self.mlp_norm(x)))
        y = self.mlp_fc2(y + F.gelu(self.mlp_pos(y)))
        return x + self.layer_scale_2[:, None, None] * y


class C3CR(nn.Module):
    """C3 whose stack is one ConvBlock2F `m` of width c_, whatever n
    (layers_zoo.py:607)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.m = ConvBlock2F(c_, c_)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1, 1)

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class ConvMix(nn.Module):
    """ConvMixer-style mixing (layers_zoo.py:626): the biased depthwise k x k
    `dw`, exact GELU, BatchNorm `dw_bn`, plus x; the biased 1x1 `pw`, exact
    GELU, BatchNorm `pw_bn`. Channel-preserving."""

    def __init__(self, c1: int, kernel_size: int = 9):
        super().__init__()
        self.dw = ConvRaw(c1, c1, kernel_size, 1, kernel_size // 2, groups=c1)
        self.dw_bn = _bn(c1)
        self.pw = ConvRaw(c1, c1, 1)
        self.pw_bn = _bn(c1)

    def forward(self, x):
        x = x + self.dw_bn(F.gelu(self.dw(x)))
        return self.pw_bn(F.gelu(self.pw(x)))


class CSPCM(nn.Module):
    """CSP over n ConvMix blocks `m<i>` (layers_zoo.py:646)."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.m = nn.Sequential(*(ConvMix(c_) for _ in range(n)))
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1)

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


# ---------------------------------------------------------------------------
# CPCA, Conv_SWS and ACmix
# ---------------------------------------------------------------------------


class CPCAChannelAttention(nn.Module):
    """CPCA's channel gate (layers_zoo.py:682): the map's mean and its
    maximum each through the biased 1x1 `fc1` (internal), ReLU, `fc2` and a
    sigmoid; x times the sum of the two gates."""

    def __init__(self, c1: int, internal: int):
        super().__init__()
        self.fc1 = ConvRaw(c1, internal, 1)
        self.fc2 = ConvRaw(internal, c1, 1)

    def forward(self, x):
        a = torch.sigmoid(self.fc2(torch.relu(self.fc1(x.mean((2, 3), keepdim=True)))))
        m = torch.sigmoid(self.fc2(torch.relu(self.fc1(x.amax((2, 3), keepdim=True)))))
        return x * (a + m)


class CPCA(nn.Module):
    """Channel-prior convolutional attention (layers_zoo.py:700): one biased
    1x1 `conv` applied three times (its gradient sums over the three), exact
    GELU, the channel gate `ca` (c / reduction), then the biased depthwise
    5x5 `d55` and its 1x7 / 7x1, 1x11 / 11x1 and 1x21 / 21x1 strip pairs,
    summed through `conv` into a gate of x, and `conv` again.
    Channel-preserving."""

    def __init__(self, c1: int, reduction: int = 4):
        super().__init__()
        self.conv = ConvRaw(c1, c1, 1)
        self.ca = CPCAChannelAttention(c1, max(c1 // reduction, 1))
        row = lambda k: ConvRaw(c1, c1, (1, k), 1, (0, k // 2), groups=c1)  # noqa: E731
        col = lambda k: ConvRaw(c1, c1, (k, 1), 1, (k // 2, 0), groups=c1)  # noqa: E731
        self.d55 = ConvRaw(c1, c1, 5, 1, 2, groups=c1)
        self.d17, self.d71 = row(7), col(7)
        self.d111, self.d111b = row(11), col(11)
        self.d121, self.d121b = row(21), col(21)

    def forward(self, x):
        refuse_strip(self)
        x = self.ca(F.gelu(self.conv(x)))
        x0 = self.d55(x)
        x1 = self.d71(self.d17(x0))
        x2 = self.d111b(self.d111(x0))
        x3 = self.d121b(self.d121(x0))
        return self.conv(self.conv(x0 + x1 + x2 + x3) * x)


def _simam(t: torch.Tensor, e_lambda: float) -> torch.Tensor:
    """SimAM over each map of t (layers_zoo.py:822): t times the sigmoid of
    d / (4 (sum(d) / (h w - 1) + e_lambda)) + 0.5, d the squared distance
    from the map's mean."""
    n = t.shape[2] * t.shape[3] - 1
    d = (t - t.mean((2, 3), keepdim=True)) ** 2
    return t * torch.sigmoid(d / (4 * (d.sum((2, 3), keepdim=True) / n + e_lambda)) + 0.5)


class SimAMWithFlexibleSlicing(nn.Module):
    """SimAM on target_size tiles at a stride of target_size (1 -
    overlap_ratio) (layers_zoo.py:839; c1 is the row's input channels, which
    it ignores): tiles start where a whole one fits,
    in row-major order; each adds its SimAM divided by the coverage count
    its pixels have once it is counted; pixels no tile covers stay zero."""

    def __init__(self, c1: int = 0, target_size: int = 8, overlap_ratio: float = 0.0, e_lambda: float = 1e-4):
        super().__init__()
        self.t, self.e_lambda = target_size, e_lambda
        self.stride = target_size if overlap_ratio == 0.0 else max(int(target_size * (1 - overlap_ratio)), 1)

    def forward(self, x):
        refuse_strip(self)
        _, _, h, w = x.shape
        t = self.t
        out = torch.zeros_like(x)
        coverage = np.zeros((h, w), np.int64)
        for i in range(0, h - t + 1, self.stride):
            for j in range(0, w - t + 1, self.stride):
                coverage[i:i + t, j:j + t] += 1
                tile = _simam(x[:, :, i:i + t, j:j + t], self.e_lambda)
                if coverage[i:i + t, j:j + t].max() > 1:
                    tile = tile / torch.as_tensor(coverage[i:i + t, j:j + t], dtype=x.dtype, device=x.device)
                out[:, :, i:i + t, j:j + t] += tile
        return out


class Conv_SWS(nn.Module):
    """Sliced SimAM `att`, then the bias-free conv `conv` (k, s, g; 'same'
    padding), BatchNorm `bn` and SiLU (layers_zoo.py:868)."""

    def __init__(self, c1: int, c2: int, target_size: int = 8, overlap_ratio: float = 0.0, e_lambda: float = 1e-4,
                 k: int = 1, s: int = 1, g: int = 1):
        super().__init__()
        self.att = SimAMWithFlexibleSlicing(c1, target_size, overlap_ratio, e_lambda)
        self.conv = ConvRaw(c1, c2, k, s, L.autopad(k), groups=g, bias=False)
        self.bn = _bn(c2)

    def forward(self, x):
        return F.silu(self.bn(self.conv(self.att(x))))


def reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """The source index of each of the n + 2 pad positions along an axis
    padded by jnp.pad(mode="reflect"): the mirror without its edge, again
    and again where the pad reaches past the axis (period 2 (n - 1))."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    i = (i % (2 * (n - 1))).abs()
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def reflect_pad(t: torch.Tensor, pad: int) -> torch.Tensor:
    """jnp.pad(t, pad, mode="reflect") over H and W of an NCHW tensor."""
    t = t.index_select(2, reflect_index(t.shape[2], pad, t.device))
    return t.index_select(3, reflect_index(t.shape[3], pad, t.device))


class ACmix(nn.Module):
    """Mixed self-attention and convolution (layers_zoo.py:892) over shared
    biased 1x1 projections `conv1` / `conv2` / `conv3` (q, k, v; head heads
    of hd = c2 / head channels). Attention: q scaled by hd^-0.5 against
    the kernel_att^2 keys of a reflect-padded window (stride s), each key
    plus the position difference of `conv_p`'s encoding of the linspace
    coordinates, softmaxed over the window, weighting the values. Conv
    path: q, k and v's 3 head maps mixed by the bare `fc` (1, 1, 3 head,
    kernel_conv^2; flax-shaped) into kernel_conv^2 maps of hd channels,
    then the bare flax nn.Conv `dep_conv` (3x3 padded 1, stride s, groups
    hd, shift-initialised). The sum weighted by the 0-d `rate1` / `rate2`."""

    flax_shaped = ("fc",)
    flax_convs = ("dep_conv",)  # a bare flax nn.Conv, not a ConvRaw

    def __init__(self, c1: int, c2: int, kernel_att: int = 7, head: int = 4, kernel_conv: int = 3, s: int = 1,
                 d: int = 1):
        super().__init__()
        self.co, self.nh, self.ka, self.kc, self.s, self.d = c2, head, kernel_att, kernel_conv, s, d
        self.hd = c2 // head
        self.conv1 = ConvRaw(c1, c2, 1)
        self.conv2 = ConvRaw(c1, c2, 1)
        self.conv3 = ConvRaw(c1, c2, 1)
        self.conv_p = ConvRaw(2, self.hd, 1)
        self.fc = nn.Parameter(torch.zeros(1, 1, 3 * head, kernel_conv ** 2))
        self.dep_conv = nn.Conv2d(kernel_conv ** 2 * self.hd, c2, kernel_conv, s, 1, groups=self.hd)
        self.rate1 = nn.Parameter(torch.tensor(0.5))
        self.rate2 = nn.Parameter(torch.tensor(0.5))

    @torch.no_grad()
    def shift_init(self) -> None:
        """`dep_conv`'s flax init: output o reads kernel tap o mod kc^2 of
        input channel min(o mod kc^2, kc^2 - 1) of its group; bias zero."""
        kc2 = self.kc ** 2
        w = torch.zeros_like(self.dep_conv.weight)
        for o in range(w.shape[0]):
            i = o % kc2
            w[o, min(i, w.shape[1] - 1), i // self.kc, i % self.kc] = 1.0
        self.dep_conv.weight.copy_(w)
        self.dep_conv.bias.zero_()

    def _unfold(self, t: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
        """(B, C, H, W) -> (B, oh, ow, ka^2, C): the windows of the
        reflect-padded map at stride s, taps in row-major order."""
        pad, s = (self.d * (self.ka - 1) + 1) // 2, self.s
        tp = reflect_pad(t, pad).permute(0, 2, 3, 1)
        taps = [tp[:, dy:dy + (oh - 1) * s + 1:s, dx:dx + (ow - 1) * s + 1:s]
                for dy in range(self.ka) for dx in range(self.ka)]
        return torch.stack(taps, 3)

    def forward(self, x):
        refuse_strip(self)
        b, _, h, w = x.shape
        co, nh, hd, s = self.co, self.nh, self.hd, self.s
        q, k, v = self.conv1(x), self.conv2(x), self.conv3(x)
        pe = self.conv_p(torch.cat(coord_maps(h, w, x.dtype, x.device), 1))  # (1, hd, H, W)
        oh, ow = h // s, w // s
        heads = lambda t: t.permute(0, 2, 3, 1).reshape(b, h, w, nh, hd)  # noqa: E731
        q_att = heads(q) * float(hd) ** -0.5
        q_pe = pe.permute(0, 2, 3, 1)
        if s > 1:
            q_att, q_pe = q_att[:, ::s, ::s], q_pe[:, ::s, ::s]
        k_un = self._unfold(k, oh, ow).reshape(b, oh, ow, -1, nh, hd)
        pe_un = self._unfold(pe, oh, ow)  # (1, oh, ow, ka^2, hd)
        att = torch.einsum("bhwnd,bhwknd->bhwkn", q_att, k_un + (q_pe[:, :, :, None, None] - pe_un[..., None, :]))
        att = torch.softmax(att, 3)
        v_un = self._unfold(v, oh, ow).reshape(b, oh, ow, -1, nh, hd)
        out_att = torch.einsum("bhwkn,bhwknd->bhwnd", att, v_un).reshape(b, oh, ow, co).permute(0, 3, 1, 2)
        f_all = torch.cat([heads(q), heads(k), heads(v)], 3)  # (B, H, W, 3 nh, hd)
        f_conv = torch.einsum("bhwnd,xynm->bhwmd", f_all, self.fc.to(x.dtype)).reshape(b, h, w, -1)
        out_conv = self.dep_conv(f_conv.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
        return self.rate1.to(x.dtype) * out_att + self.rate2.to(x.dtype) * out_conv


# ---------------------------------------------------------------------------
# the attention bottlenecks and their C3 / C2f blocks
# ---------------------------------------------------------------------------


class CBAMBottleneckDWC(nn.Module):
    """Conv `cv1` (k[0]) to c_, Conv `cv2` (k[1], grouped by g) to c2, the
    channel gate `channel_attention` (ratio), then a spatial gate from the
    [mean, max] maps: the biased depthwise 2 -> 2 `sa_dw` (kernel_size) and
    the biased pointwise 2 -> 1 `sa_pw`, a sigmoid; the residual where
    `shortcut` and c1 == c2 (layers_zoo.py:1027)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, e: float = 0.5, k=(3, 3),
                 ratio: int = 16, kernel_size: int = 7):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0], 1)
        self.cv2 = Conv(c_, c2, k[1], 1, g=g)
        self.channel_attention = L.ChannelAttentionModule(c2, ratio)
        self.sa_dw = ConvRaw(2, 2, kernel_size, 1, kernel_size // 2, groups=2)
        self.sa_pw = ConvRaw(2, 1, 1)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        y = self.channel_attention(y) * y
        pool = torch.cat([y.mean(1, keepdim=True), y.amax(1, keepdim=True)], 1)
        y = torch.sigmoid(self.sa_pw(self.sa_dw(pool))) * y
        return x + y if self.add else y


class SCBAMBottleneck(nn.Module):
    """Conv `cv1` (1x1), Conv `cv2` (3x3, grouped by g); yc the channel-gated
    map, ys the spatial gate of yc times the map; sigmoid(yc + ys); the
    residual where `shortcut` and c1 == c2 (layers_zoo.py:1058)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, e: float = 0.5, ratio: int = 16,
                 kernel_size: int = 7):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_, c2, 3, 1, g=g)
        self.channel_attention = L.ChannelAttentionModule(c2, ratio)
        self.spatial_attention = L.SpatialAttentionModule(kernel_size)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        yc = self.channel_attention(y) * y
        out = torch.sigmoid(yc + self.spatial_attention(yc) * y)
        return x + out if self.add else out


class CABottleneck(nn.Module):
    """Conv `cv1` (1x1), Conv `cv2` (3x3, grouped by g), then coordinate
    attention (layers_zoo.py:1082): the means over W and over H side by side
    as one (H + W)-long strip through the biased 1x1 `conv1` (mip =
    max(8, c1 / ratio), from the input's channels), one BatchNorm `bn1` over
    the strip, h_swish through relu6, then `conv_h` / `conv_w` and sigmoid
    gates along H and W; the residual where `shortcut` and c1 == c2."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, e: float = 0.5, ratio: int = 32):
        super().__init__()
        c_ = int(c2 * e)
        mip = max(8, c1 // ratio)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_, c2, 3, 1, g=g)
        self.conv1 = ConvRaw(c2, mip, 1)
        self.bn1 = _bn(mip)
        self.conv_h = ConvRaw(mip, c2, 1)
        self.conv_w = ConvRaw(mip, c2, 1)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        refuse_strip(self)
        y = self.cv2(self.cv1(x))
        h = y.shape[2]
        t = self.bn1(self.conv1(torch.cat([y.mean(3), y.mean(2)], 2)[..., None]))  # (B, mip, H + W, 1)
        t = t * F.relu6(t + 3.0) / 6.0
        out = y * torch.sigmoid(self.conv_h(t[:, :, :h])) * torch.sigmoid(self.conv_w(t[:, :, h:])).transpose(2, 3)
        return x + out if self.add else out


class GSCBAMBottleneck(nn.Module):
    """GSConv `cv1` (k[0]) to c_, the channel gate (ratio) and the spatial
    gate (kernel_size), GSConv `cv2` (k[1], no activation) to c2; the
    residual where `shortcut` and c1 == c2 (layers_zoo.py:1115)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, e: float = 0.5, k=(1, 3),
                 ratio: int = 8, kernel_size: int = 3):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = L.GSConv(c1, c_, k[0], 1)
        self.channel_attention = L.ChannelAttentionModule(c_, ratio)
        self.spatial_attention = L.SpatialAttentionModule(kernel_size)
        self.cv2 = L.GSConv(c_, c2, k[1], 1, act=False)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv1(x)
        y = self.channel_attention(y) * y
        y = self.cv2(self.spatial_attention(y) * y)
        return x + y if self.add else y


class CPCABottleneck(nn.Module):
    """Conv `cv1` (k[0]), Conv `cv2` (k[1], grouped by g), CPCA `cpca`
    (reduction); the residual adds the raw input where `shortcut` and c1 ==
    c2 (layers_zoo.py:1139)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, e: float = 0.5, k=(3, 3),
                 reduction: int = 4):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0], 1)
        self.cv2 = Conv(c_, c2, k[1], 1, g=g)
        self.cpca = CPCA(c2, reduction)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        out = self.cpca(self.cv2(self.cv1(x)))
        return x + out if self.add else out


class _GatedResidual(nn.Module):
    """C3GAM's and C3_BAM's bottleneck: a gate of the input, plus the input
    where `shortcut` (layers_zoo.py:1209, :1234); the gate's flax name is
    `name`."""

    def __init__(self, name: str, gate: nn.Module, shortcut: bool):
        super().__init__()
        setattr(self, name, gate)
        self.gate, self.add = name, shortcut

    def forward(self, x):
        out = getattr(self, self.gate)(x)
        return x + out if self.add else out


class C3_CBAM(L.C3):
    """C3 with CBAMBottleneck (1x1 then 3x3, ratio 8, a 7x7 spatial gate)
    bottlenecks `m<i>` (layers_zoo.py:1161)."""

    kernel_size = 7

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e, block=lambda c: L.CBAMBottleneck(
            c, c, shortcut, e=1.0, k=(1, 3), ratio=8, kernel_size=self.kernel_size))


class C3_CBAMS(C3_CBAM):
    """C3_CBAM with a 3x3 spatial gate (layers_zoo.py:1171)."""

    kernel_size = 3


class C3_CBAM_DWC(L.C3):
    """C3 with CBAMBottleneckDWC (1x1 then 3x3, ratio 16, a 7x7 depthwise
    spatial gate) bottlenecks (layers_zoo.py:1177)."""

    kernel_size = 7

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e, block=lambda c: CBAMBottleneckDWC(
            c, c, shortcut, g, e=1.0, k=(1, 3), kernel_size=self.kernel_size))


class C3_CBAMS_DWC(C3_CBAM_DWC):
    """C3_CBAM_DWC with a 3x3 spatial gate (layers_zoo.py:1187)."""

    kernel_size = 3


class C3CPCA(L.C3):
    """C3 with CPCABottleneck (1x1 then 3x3) bottlenecks (layers_zoo.py:1193)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e, block=lambda c: CPCABottleneck(c, c, shortcut, g, 1.0, (1, 3)))


class C3GAM(L.C3):
    """C3 whose bottlenecks are GAMAttention `gam` of their input plus the
    input where `shortcut` (layers_zoo.py:1200; the reference's convs are
    dead code there too)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e,
                         block=lambda c: _GatedResidual("gam", L.GAMAttention(c), shortcut))


class C3_SCBAM(L.C3):
    """C3 with SCBAMBottleneck bottlenecks (layers_zoo.py:1221)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e, block=lambda c: SCBAMBottleneck(c, c, shortcut, g, 1.0))


class C3_BAM(L.C3):
    """C3 whose bottlenecks are BAM `bam` of their input plus the input
    where `shortcut` (layers_zoo.py:1228)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e, block=lambda c: _GatedResidual("bam", L.BAM(c), shortcut))


class C3_CA(L.C3):
    """C3 with CABottleneck bottlenecks (layers_zoo.py:1246)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e, block=lambda c: CABottleneck(c, c, shortcut, g, 1.0))


class C2fBAM(L.C2f):
    """C2f (3x3 bottlenecks) with BAM `bam` on its output (layers_zoo.py:1253)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e)
        self.bam = L.BAM(c2)

    def forward(self, x):
        return self.bam(super().forward(x))


class DWR(nn.Module):
    """Dilation-wise residual (layers_zoo.py:1277): Conv `conv_3x3` to c / 2;
    3x3 Convs `d1` (to c), `d3` and `d5` (to c / 2) dilated 1, 3, 5;
    concatenated into Conv `conv_1x1`, plus x."""

    def __init__(self, c1: int):
        super().__init__()
        self.conv_3x3 = Conv(c1, c1 // 2, 3)
        self.d1 = Conv(c1 // 2, c1, 3, d=1)
        self.d3 = Conv(c1 // 2, c1 // 2, 3, d=3)
        self.d5 = Conv(c1 // 2, c1 // 2, 3, d=5)
        self.conv_1x1 = Conv(c1 + 2 * (c1 // 2), c1, 1)

    def forward(self, x):
        y = self.conv_3x3(x)
        return self.conv_1x1(torch.cat([self.d1(y), self.d3(y), self.d5(y)], 1)) + x


class DWRSegConv(nn.Module):
    """Conv `conv` (1x1), DWR `dwr`, BatchNorm `bn`, exact GELU
    (layers_zoo.py:1295)."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.conv = Conv(c1, c2, 1)
        self.dwr = DWR(c2)
        self.bn = _bn(c2)

    def forward(self, x):
        return F.gelu(self.bn(self.dwr(self.conv(x))))


class C2f_DWR(nn.Module):
    """C2f whose n bottlenecks are Conv `m<i>_cv1` (3x3) then DWRSegConv
    `m<i>_cv2`, plus their input where `shortcut` (layers_zoo.py:1309)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, g: int = 1, e: float = 0.5):
        super().__init__()
        self.c, self.n, self.add = int(c2 * e), n, shortcut
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        for i in range(n):
            setattr(self, f"m{i}_cv1", Conv(self.c, self.c, 3))
            setattr(self, f"m{i}_cv2", DWRSegConv(self.c, self.c))
        self.cv2 = Conv((2 + n) * self.c, c2, 1)

    def forward(self, x):
        ys = list(self.cv1(x).split(self.c, 1))
        for i in range(self.n):
            z = getattr(self, f"m{i}_cv2")(getattr(self, f"m{i}_cv1")(ys[-1]))
            ys.append(ys[-1] + z if self.add else z)
        return self.cv2(torch.cat(ys, 1))


class VoVGSCSPCBAM(nn.Module):
    """VoV-GSCSP with CBAM'd GS bottlenecks (layers_zoo.py:1331): Conv `cv1`
    and n GSCBAMBottlenecks `gsb<i>` (e 1) beside Conv `cv2` of the input;
    Conv `cv3` of [cv2's, the bottlenecks'] in that order."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.n = n
        self.cv1 = Conv(c1, c_, 1, 1)
        for i in range(n):
            setattr(self, f"gsb{i}", GSCBAMBottleneck(c_, c_, e=1.0))
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1)

    def forward(self, x):
        x1 = self.cv1(x)
        for i in range(self.n):
            x1 = getattr(self, f"gsb{i}")(x1)
        return self.cv3(torch.cat([self.cv2(x), x1], 1))



# ---------------------------------------------------------------------------
# the fusion kinds: resizing
# ---------------------------------------------------------------------------


def bilinear_align_corners(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """F.interpolate(mode="bilinear", align_corners=True) as the JAX package
    computes it (layers_zoo.py:73): each axis gathers its two neighbours at
    the float32 positions arange(out) * (in - 1) / (out - 1) and lerps by
    the fraction in x's dtype; an axis of one pixel, in or out, reads pixel 0."""
    h, w = x.shape[2:]
    if (h, w) == tuple(out_hw):
        return x

    def lerp_axis(v, size_in, size_out, dim):
        if size_out == 1 or size_in == 1:
            return v.index_select(dim, torch.zeros(size_out, dtype=torch.long, device=v.device))
        pos = torch.arange(size_out, dtype=torch.float32, device=v.device) * (size_in - 1) / (size_out - 1)
        lo = pos.floor().long()
        hi = (lo + 1).clamp(max=size_in - 1)
        shape = [1] * v.ndim
        shape[dim] = size_out
        t = (pos - lo.float()).to(v.dtype).view(shape)
        return v.index_select(dim, lo) * (1 - t) + v.index_select(dim, hi) * t

    return lerp_axis(lerp_axis(x, h, out_hw[0], 2), w, out_hw[1], 3)


def resize_to(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """SDI's recipe (layers_zoo.py:120), decided by the height alone: shrink
    by adaptive_avg_pool (models/layers.py), grow bilinearly with the
    corners aligned, or pass x on."""
    h = x.shape[2]
    if h > out_hw[0]:
        return L.adaptive_avg_pool(x, out_hw)
    if h < out_hw[0]:
        return bilinear_align_corners(x, out_hw)
    return x


def resize_nearest(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """jax.image.resize(..., "nearest"): output pixel i of an axis reads
    floor((i + 0.5) * in / out), computed in float32 (torch's
    "nearest-exact" scales by a rounded in / out and can floor apart)."""
    for dim, n in ((2, out_hw[0]), (3, out_hw[1])):
        m = x.shape[dim]
        if m != n:
            idx = ((torch.arange(n, dtype=torch.float32, device=x.device) + 0.5) * m / n).floor().long()
            x = x.index_select(dim, idx)
    return x


# ---------------------------------------------------------------------------
# the transposed convs and the standalone BatchNorm
# ---------------------------------------------------------------------------


def _dilated_conv(x: torch.Tensor, w: torch.Tensor, s: int, lo: int, hi: int, groups: int) -> torch.Tensor:
    """x with s - 1 zeros between its pixels, padded lo / hi (a negative pad
    crops), convolved with the OIHW kernel w: a transposed conv as the
    JAX package writes it, for the cases conv_transpose2d refuses."""
    b, c, h, wd = x.shape
    d = x.new_zeros(b, c, (h - 1) * s + 1, (wd - 1) * s + 1)
    d[:, :, ::s, ::s] = x
    return F.conv2d(F.pad(d, (lo, hi, lo, hi)), w, groups=groups)


class FlaxConvTranspose(nn.ConvTranspose2d):
    """flax nn.ConvTranspose (transpose_kernel False; stride s, padding k - 1
    - p each side): the dilated input convolved with the flax HWIO kernel
    as stored, which is torch's transposed conv with that kernel flipped
    and its in / out swapped. The weight is torch's (I, O, k, k)."""

    def __init__(self, c1: int, c2: int, k: int, s: int, p: int, bias: bool):
        super().__init__(c1, c2, k, s, p, bias=bias)

    @staticmethod
    def from_flax(v: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(v[::-1, ::-1].transpose(2, 3, 0, 1))

    @staticmethod
    def to_flax(t: torch.Tensor) -> torch.Tensor:
        return t.permute(2, 3, 0, 1).flip((0, 1))


class ConvTransposeLayer(nn.Module):
    """Transposed conv `conv` (k, stride s, padding p: output (H - 1) s - 2 p
    + k; biased where there is no BatchNorm), BatchNorm `bn` where `bn`,
    SiLU where `act` (layers_zoo.py:244)."""

    def __init__(self, c1: int, c2: int, k: int = 2, s: int = 2, p: int = 0, bn: bool = True, act: bool = True):
        super().__init__()
        self.conv = FlaxConvTranspose(c1, c2, k, s, p, bias=not bn)
        self.bn = _bn(c2) if bn else None
        self.act = act

    def forward(self, x):
        refuse_strip(self)
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.silu(x) if self.act else x


class ConvTranspose2dRaw(ConvTransposeLayer):
    """The bare nn.ConvTranspose2d row: biased, no BatchNorm, no activation
    (layers_zoo.py:1551)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: int = 0, bn: bool = False, act: bool = False):
        super().__init__(c1, c2, k, s, p, bn, act)


class DWConvTranspose2d(nn.ConvTranspose2d):
    """Grouped transposed conv, g = gcd(c1, c2), biased (layers_zoo.py:278):
    the JAX package flips its (k, k, c1 / g, c2) kernel into a conv of the
    dilated input padded k - 1 - p1 and k - 1 - p1 + p2, which is torch's
    transposed conv with padding p1 and output_padding p2 on that kernel
    unflipped. Where p2 >= s, which conv_transpose2d refuses, it runs that
    conv of the dilated input itself."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p1: int = 0, p2: int = 0):
        super().__init__(c1, c2, k, s, p1, groups=math.gcd(c1, c2), bias=True)
        self.p2 = p2

    def from_flax(self, v: np.ndarray) -> np.ndarray:
        k, g = self.kernel_size[0], self.groups
        ci, co = v.shape[2], v.shape[3]
        return np.ascontiguousarray(v.reshape(k, k, ci, g, co // g).transpose(3, 2, 4, 0, 1).reshape(g * ci, co // g,
                                                                                                       k, k))

    def to_flax(self, t: torch.Tensor) -> torch.Tensor:
        k, g = self.kernel_size[0], self.groups
        c1, co_g = t.shape[:2]
        return t.reshape(g, c1 // g, co_g, k, k).permute(3, 4, 1, 0, 2).reshape(k, k, c1 // g, g * co_g)

    def forward(self, x):
        refuse_strip(self)
        s, p1, k, g = self.stride[0], self.padding[0], self.kernel_size[0], self.groups
        w = self.weight.to(x.dtype)
        if self.p2 < s:
            y = F.conv_transpose2d(x, w, None, s, p1, self.p2, g)
        else:  # the OIHW kernel of the dilated conv: each group's (c2 / g, c1 / g) block, flipped
            c1, co_g = w.shape[:2]
            wc = w.reshape(g, c1 // g, co_g, k, k).transpose(1, 2).reshape(g * co_g, c1 // g, k, k).flip((2, 3))
            y = _dilated_conv(x, wc, s, k - 1 - p1, k - 1 - p1 + self.p2, g)
        return y + self.bias.to(y.dtype)[:, None, None]


class BatchNorm2d(nn.Module):
    """The standalone BatchNorm row `bn` (layers_zoo.py:313)."""

    def __init__(self, c1: int):
        super().__init__()
        self.bn = _bn(c1)

    def forward(self, x):
        return self.bn(x)


# ---------------------------------------------------------------------------
# the n-ary merges
# ---------------------------------------------------------------------------


class Add(nn.Module):
    """The sum of all inputs (layers_zoo.py:1356)."""

    def forward(self, xs: List[torch.Tensor]):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out


class Multiply(nn.Module):
    """The product of the first two inputs (layers_zoo.py:1368)."""

    def forward(self, xs: List[torch.Tensor]):
        return xs[0] * xs[1]


class CShortcut(nn.Module):
    """The sum of the first two inputs (layers_zoo.py:1377)."""

    def forward(self, xs: List[torch.Tensor]):
        return xs[0] + xs[1]


# ---------------------------------------------------------------------------
# the single-map blocks
# ---------------------------------------------------------------------------


class ContextAggregation(nn.Module):
    """Global context aggregation (layers_zoo.py:726): the biased 1x1 `k`'s
    softmax over the map weights the biased 1x1 `v` (c / reduction) into one
    vector, which the bare flax nn.Conv `m` (zero at init) projects back to
    c; x plus that times the sigmoid of the biased 1x1 `a`."""

    flax_convs = ("m",)

    def __init__(self, c1: int, reduction: int = 1):
        super().__init__()
        ic = max(c1 // reduction, 1)
        self.a = ConvRaw(c1, 1, 1)
        self.k = ConvRaw(c1, 1, 1)
        self.v = ConvRaw(c1, ic, 1)
        self.m = nn.Conv2d(ic, c1, 1)

    def forward(self, x):
        refuse_strip(self)
        b = x.shape[0]
        a = torch.sigmoid(self.a(x))
        k = torch.softmax(self.k(x).reshape(b, -1), 1)
        y = torch.einsum("bcn,bn->bc", self.v(x).reshape(b, -1, k.shape[1]), k)[:, :, None, None]
        return x + self.m(y) * a


class PSContextAggregation(nn.Module):
    """PSA-style split (layers_zoo.py:747), c = c1 e: Conv `cv1` to 2c; the
    second half plus its ContextAggregation `attn` (itself plus the
    context), plus Conv `ffn0` (2c) and Conv `ffn1` (c, no activation) of
    that; Conv `cv2` of both halves back to c1."""

    def __init__(self, c1: int, c2: int = 0, e: float = 0.5):
        super().__init__()
        c = int(c1 * e)
        self.c = c
        self.cv1 = Conv(c1, 2 * c, 1, 1)
        self.attn = ContextAggregation(c)
        self.ffn0 = Conv(c, 2 * c, 1)
        self.ffn1 = Conv(2 * c, c, 1, act=False)
        self.cv2 = Conv(2 * c, c1, 1)

    def forward(self, x):
        a, b = self.cv1(x).split(self.c, 1)
        b = b + self.attn(b)
        b = b + self.ffn1(self.ffn0(b))
        return self.cv2(torch.cat([a, b], 1))


class ChannelAttentionHSFPN(nn.Module):
    """HS-FPN's channel gate (layers_zoo.py:768): the map's mean and its
    maximum each through the bias-free 1x1 `fc1` (c / ratio), ReLU and
    `fc2`, summed into a sigmoid; x times it where `flag`, else the
    (B, C, 1, 1) gate itself."""

    def __init__(self, c1: int, ratio: int = 4, flag: bool = True):
        super().__init__()
        self.flag = flag
        self.fc1 = ConvRaw(c1, max(c1 // ratio, 1), 1, bias=False)
        self.fc2 = ConvRaw(max(c1 // ratio, 1), c1, 1, bias=False)

    def forward(self, x):
        refuse_strip(self)
        avg = self.fc2(torch.relu(self.fc1(x.mean((2, 3), keepdim=True))))
        mx = self.fc2(torch.relu(self.fc1(x.amax((2, 3), keepdim=True))))
        gate = torch.sigmoid(avg + mx)
        return gate * x if self.flag else gate


class CAM(nn.Module):
    """Context augmentation (layers_zoo.py:787): 3x3 Convs `conv1` / `conv2`
    / `conv3` dilated 1, 3 and 5, each through a 1x1 Conv `fusion_<i>`;
    "weight" sums the three, "adaptive" weighs the dilated convs' maps by
    the channel softmax of Conv `fusion_4` (3) of the three, anything else
    concatenates them (3 c1 channels for "concat")."""

    def __init__(self, c1: int, fusion: str = "weight"):
        super().__init__()
        self.fusion = fusion
        for i, d in enumerate((1, 3, 5), 1):
            setattr(self, f"conv{i}", Conv(c1, c1, 3, 1, d=d))
            setattr(self, f"fusion_{i}", Conv(c1, c1, 1))
        if fusion == "adaptive":
            self.fusion_4 = Conv(3 * c1, 3, 1)

    def forward(self, x):
        xs = [getattr(self, f"conv{i}")(x) for i in (1, 2, 3)]
        fs = [getattr(self, f"fusion_{i}")(t) for i, t in enumerate(xs, 1)]
        if self.fusion == "weight":
            return fs[0] + fs[1] + fs[2]
        if self.fusion == "adaptive":
            w = torch.softmax(self.fusion_4(torch.cat(fs, 1)), 1)
            return xs[0] * w[:, 0:1] + xs[1] * w[:, 1:2] + xs[2] * w[:, 2:3]
        return torch.cat(fs, 1)


class SimAMWithSlicing(nn.Module):
    """SimAM on each of the four blocks the map's halves cut (h // 2 and
    w // 2 rows and columns first; layers_zoo.py:815): a block of h w / 4
    pixels divides by h w / 4 - 1, so a 2x2 map gives 0 / 0."""

    def __init__(self, c1: int = 0, e_lambda: float = 1e-4):
        super().__init__()
        self.e_lambda = e_lambda

    def forward(self, x):
        refuse_strip(self)
        bh, bw = x.shape[2] // 2, x.shape[3] // 2
        rows = [torch.cat([_simam(r[:, :, :, :bw], self.e_lambda), _simam(r[:, :, :, bw:], self.e_lambda)], 3)
                for r in (x[:, :, :bh], x[:, :, bh:])]
        return torch.cat(rows, 2)


class C3CBAM(nn.Module):
    """Plain CBAM, whatever the name and the row's args (layers_zoo.py:669):
    the channel gate `channel_attention` (ratio 16), then the 7x7 spatial
    gate `spatial_attention`. Channel-preserving."""

    def __init__(self, c1: int, c2: int = 0):
        super().__init__()
        self.channel_attention = L.ChannelAttentionModule(c1, 16)
        self.spatial_attention = L.SpatialAttentionModule(7)

    def forward(self, x):
        x = self.channel_attention(x) * x
        return self.spatial_attention(x) * x


class Conv2Former(nn.Module):
    """n ConvBlock2F `blk<i>` with MLP width `mid` (the row's c2, scaled);
    channel-preserving (layers_zoo.py:592)."""

    def __init__(self, c1: int, mid: int = 0, n: int = 1):
        super().__init__()
        self.n = n
        for i in range(n):
            setattr(self, f"blk{i}", ConvBlock2F(c1, mid))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"blk{i}")(x)
        return x


# ---------------------------------------------------------------------------
# the multi-scale fusions (chs: the channels of each input)
# ---------------------------------------------------------------------------


class SDI(nn.Module):
    """Scale-wise decoupled interaction (layers_zoo.py:1388): each input
    resized to the first's size (resize_to), through its biased 3x3
    `conv<i>` to c2, all multiplied together."""

    def __init__(self, chs: Sequence[int], c2: int):
        super().__init__()
        self.n = len(chs)
        for i, c in enumerate(chs):
            setattr(self, f"conv{i}", ConvRaw(c, c2, 3, 1, 1))

    def forward(self, xs: List[torch.Tensor]):
        refuse_strip(self)
        hw = tuple(xs[0].shape[2:])
        out = None
        for i, x in enumerate(xs):
            y = getattr(self, f"conv{i}")(resize_to(x, hw))
            out = y if out is None else out * y
        return out


class BiFPNSDI(nn.Module):
    """Weighted fusion at the least height among the inputs
    (layers_zoo.py:1408): each input resized there (resize_to), through its
    biased 3x3 `conv<i>` to c2, weighted by `w` / (sum(swish(w)) + 1e-4)
    (`w` ones at init; raw over swish, as in the JAX package; float32, cast
    to the maps' dtype)."""

    def __init__(self, chs: Sequence[int], c2: int):
        super().__init__()
        self.w = nn.Parameter(torch.ones(len(chs)))
        for i, c in enumerate(chs):
            setattr(self, f"conv{i}", ConvRaw(c, c2, 3, 1, 1))

    def forward(self, xs: List[torch.Tensor]):
        refuse_strip(self)
        hw = tuple(min((tuple(x.shape[2:]) for x in xs), key=lambda s: s[0]))
        w = self.w.float()
        norm = w / (F.silu(w).sum() + 1e-4)
        out = None
        for i, x in enumerate(xs):
            y = getattr(self, f"conv{i}")(resize_to(x, hw))
            y = norm[i].to(y.dtype) * y
            out = y if out is None else out + y
        return out


class BiFPNs(nn.Module):
    """Swish-normalised weighted sum (layers_zoo.py:1431): each input
    through its bias-free 1x1 `conv<i>` to c2, weighted by swish(w) /
    (sum(swish(w)) + 1e-4) (`w` normal(1.0) at init; float32, cast to the
    maps' dtype)."""

    def __init__(self, chs: Sequence[int], c2: int):
        super().__init__()
        self.w = nn.Parameter(torch.ones(len(chs)))
        for i, c in enumerate(chs):
            setattr(self, f"conv{i}", ConvRaw(c, c2, 1, bias=False))

    def forward(self, xs: List[torch.Tensor]):
        sw = F.silu(self.w.float())
        norm = sw / (sw.sum() + 1e-4)
        out = None
        for i, x in enumerate(xs):
            y = getattr(self, f"conv{i}")(x)
            y = norm[i].to(y.dtype) * y
            out = y if out is None else out + y
        return out


class BiFusion(nn.Module):
    """YOLOv6's BiFusion of [coarse, mid, fine] (layers_zoo.py:1452): Conv
    `cv1` of the coarse map and ConvTransposeLayer `upsample` (2x2, stride
    2), Conv `cv2` of the mid map, Conv `cv3` of the fine map and Conv
    `downsample` (3x3, stride 2), all to c2, concatenated into Conv
    `cv_out`. The output lies at the mid map's scale."""

    def __init__(self, chs: Sequence[int], c2: int):
        super().__init__()
        self.cv1 = Conv(chs[0], c2, 1, 1)
        self.upsample = ConvTransposeLayer(c2, c2, 2, 2)
        self.cv2 = Conv(chs[1], c2, 1, 1)
        self.cv3 = Conv(chs[2], c2, 1, 1)
        self.downsample = Conv(c2, c2, 3, 2)
        self.cv_out = Conv(3 * c2, c2, 1, 1)

    def forward(self, xs: List[torch.Tensor]):
        x0 = self.upsample(self.cv1(xs[0]))
        x2 = self.downsample(self.cv3(xs[2]))
        return self.cv_out(torch.cat([x0, self.cv2(xs[1]), x2], 1))


class SF(nn.Module):
    """Simplified fusion (layers_zoo.py:1472): the first map through
    ConvTransposeLayer `upsample` (2x2, stride 2) and Conv `cv1` (3x3), the
    second as it is, the third through the depthwise 1x1 Conv `cv3` and
    Conv `downsample` (3x3, stride 2); concatenated (c2 the sum of the
    inputs' channels)."""

    def __init__(self, chs: Sequence[int]):
        super().__init__()
        c0, c2in = chs[0], chs[2]
        self.upsample = ConvTransposeLayer(c0, c0, 2, 2)
        self.cv1 = Conv(c0, c0, 3, 1)
        self.cv3 = Conv(c2in, c2in, 1, 1, g=c2in)
        self.downsample = Conv(c2in, c2in, 3, 2)

    def forward(self, xs: List[torch.Tensor]):
        x0 = self.cv1(self.upsample(xs[0]))
        x2 = self.downsample(self.cv3(xs[2]))
        return torch.cat([x0, xs[1], x2], 1)


class ScalSeq(nn.Module):
    """Scale-sequence fusion of [P3, P4, P5] (layers_zoo.py:1489): Conv
    `conv1` / `conv2` (1x1 to c2) of P4 and P5, each resized nearest to
    P3's size (resize_nearest); the three stacked on a scale axis, the
    Dense `conv3d` over the channels, one BatchNorm `bn` over every scale,
    LeakyReLU 0.1, the maximum over the scales. P3 must have c2 channels."""

    def __init__(self, chs: Sequence[int], c2: int):
        super().__init__()
        self.conv1 = Conv(chs[1], c2, 1)
        self.conv2 = Conv(chs[2], c2, 1)
        self.conv3d = nn.Linear(c2, c2)
        self.bn = _bn(c2)

    def forward(self, xs: List[torch.Tensor]):
        refuse_strip(self)
        p3 = xs[0]
        b, c, h, w = p3.shape
        p4 = resize_nearest(self.conv1(xs[1]), (h, w))
        p5 = resize_nearest(self.conv2(xs[2]), (h, w))
        t = self.conv3d(torch.stack([p3, p4, p5], 1).permute(0, 1, 3, 4, 2))  # (B, 3, H, W, C)
        t = self.bn(t.reshape(b * 3, h, w, -1).permute(0, 3, 1, 2))
        t = F.leaky_relu(t, 0.1)
        return t.reshape(b, 3, *t.shape[1:]).amax(1)


class AttentionModel(nn.Module):
    """ASF-YOLO's attention_model of [x0, x1] (layers_zoo.py:1516): x0 gated
    by ECA (the bias-free 1-D flax nn.Conv `ca_conv`, k the odd of (log2(c)
    + 1) / 2, 'same' padding, over its channel means), plus x1; then
    coordinate attention: the means over W and over H as one (H + W)-long
    strip through the bias-free 1x1 `la_conv1` (c / reduction), BatchNorm
    `la_bn`, ReLU, and the bias-free 1x1 `la_fh` / `la_fw` sigmoid gates
    along H and W."""

    def __init__(self, chs: Sequence[int], reduction: int = 16):
        super().__init__()
        c = chs[0]
        mid = max(c // reduction, 1)
        k = L.eca_kernel_size(c)
        self.ca_conv = nn.Conv1d(1, 1, k, padding=k // 2, bias=False)
        self.la_conv1 = ConvRaw(c, mid, 1, bias=False)
        self.la_bn = _bn(mid)
        self.la_fh = ConvRaw(mid, c, 1, bias=False)
        self.la_fw = ConvRaw(mid, c, 1, bias=False)

    def forward(self, xs: List[torch.Tensor]):
        refuse_strip(self)
        x0, x1 = xs[0], xs[1]
        v = self.ca_conv(x0.mean((2, 3))[:, None, :])  # (B, 1, C)
        x = x0 * torch.sigmoid(v)[:, 0, :, None, None] + x1
        h = x.shape[2]
        t = torch.cat([x.mean(3, keepdim=True), x.mean(2, keepdim=True).transpose(2, 3)], 2)  # (B, C, H + W, 1)
        t = torch.relu(self.la_bn(self.la_conv1(t)))
        sh = torch.sigmoid(self.la_fh(t[:, :, :h]))
        sw = torch.sigmoid(self.la_fw(t[:, :, h:]))
        return x * sh * sw.transpose(2, 3)
