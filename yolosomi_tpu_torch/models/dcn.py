"""The deformable blocks (counterparts of yolosomi_tpu/ops/dcn.py DCNv3,
DCNv2, BottleneckDCN, C3_DCN and C2f_DCN, :127-307).

Modules are NCHW in `torch.channels_last` memory, so `permute(0, 2, 3, 1)`
is the free NHWC view the sampling kernels (ops/dcn.py) take. Submodule
names are the flax names, which the weight bridge maps one to one.

Numerical conventions kept from the JAX package:
- DCNv3's LayerNorm has eps 1e-6 (flax's default) and its GELU is the tanh
  form in every dtype (flax `nn.gelu` defaults to approximate=True).
- DCNv2's `conv_offset_mask` channels are [dy x P | dx x P | mask x P]
  with p = ky*k + kx (dcn.py:215-224), not torchvision's interleaved pairs.
- DCNv2's weight keeps the JAX (P, C, c2) layout, so the columns of
  `dcnv2_im2col` (p-major) multiply its (P*C, c2) view directly.
- DCNv3's mask is cast to value's dtype before the sampling (the kernels
  take one dtype): under torch.autocast its softmax runs in f32, where
  flax's bf16 module computes it in bf16. Without autocast the cast is a
  no-op, so the f32 and the bf16 (serving) models are unchanged. DCNv2's
  operands (a conv, cuDNN's BatchNorm and a sigmoid of bf16) stay bf16
  under autocast.

Under spatial sharding (parallel.spatial) the offsets are unbounded, so a
strip gathers the layer's whole sampled map (DCNv2's x, DCNv3's value)
and samples it for its own output rows only: the sampling takes the
strip's first output row as `row0`. The offset convs fetch their halo
rows as every conv does (models.layers.HaloConv2d).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from yolosomi_tpu_torch.models.layers import BN_EPS, BN_MOMENTUM, C2f, C3, Conv, FlaxBatchNorm2d, HaloConv2d
from yolosomi_tpu_torch.ops.dcn import dcnv2_columns, dcnv3_sampling
from yolosomi_tpu_torch.parallel.spatial import active_strip, gather_h


class DCNv3(nn.Module):
    """Input projection, a depthwise-conv + LayerNorm + GELU context branch
    that predicts offsets and per-group softmax masks, the deformable
    sampling (`dcnv3_core`), an optional center-feature-scale blend and an
    output projection. Channel-preserving."""

    def __init__(self, channels: int, kernel_size: int = 3, stride: int = 1, pad: int = 1, dilation: int = 1,
                 group: int = 4, offset_scale: float = 1.0, center_feature_scale: bool = False):
        super().__init__()
        if channels % group:
            raise ValueError(f"channels {channels} not divisible by group {group}")
        if kernel_size % 2 == 0:
            raise NotImplementedError("an even kernel_size (flax 'SAME' pads it unevenly)")
        C, G, P = channels, group, kernel_size * kernel_size
        self.k, self.stride, self.pad, self.dilation = kernel_size, stride, pad, dilation
        self.group, self.offset_scale, self.center_feature_scale = group, offset_scale, center_feature_scale
        self.input_proj = nn.Linear(C, C)
        self.dw_conv = HaloConv2d(C, C, kernel_size, 1, kernel_size // 2, groups=C)
        self.norm = nn.LayerNorm(C, eps=1e-6)
        self.offset = nn.Linear(C, G * P * 2)
        self.mask = nn.Linear(C, G * P)
        if center_feature_scale:
            self.cfs_weight = nn.Parameter(torch.zeros(G, C))
            self.cfs_bias = nn.Parameter(torch.zeros(G))
        self.output_proj = nn.Linear(C, C)

    def forward(self, x):
        N, C, H, W = x.shape
        G, k = self.group, self.k
        P = k * k
        value = self.input_proj(x.permute(0, 2, 3, 1))  # (N, H, W, C)
        ctx = F.gelu(self.norm(self.dw_conv(x).permute(0, 2, 3, 1)), approximate="tanh")
        offset = self.offset(ctx)
        mask = torch.softmax(self.mask(ctx).reshape(N, H, W, G, P), -1).reshape(N, H, W, G * P)
        mask = mask.to(value.dtype)
        sampled, row0 = value, 0
        if active_strip() is not None:  # the whole value map; this strip's output rows from row0 on
            sampled, row0 = gather_h(value, 1), active_strip().level(H).start
        out = dcnv3_sampling(sampled.contiguous(), offset.contiguous(), mask.contiguous(), k, k, self.stride,
                             self.stride, self.pad, self.pad, self.dilation, self.dilation, G, C // G,
                             self.offset_scale, row0=row0)
        if self.center_feature_scale:
            ct = torch.promote_types(ctx.dtype, torch.float32)
            scale = torch.sigmoid(torch.einsum("nhwc,gc->nhwg", ctx.to(ct), self.cfs_weight.to(ct))
                                  + self.cfs_bias.to(ct))
            scale = scale.repeat_interleave(C // G, dim=-1).to(out.dtype)
            out = out * (1 - scale) + value * scale
        return self.output_proj(out).permute(0, 3, 1, 2)


class DCNv2(nn.Module):
    """Modulated deformable conv: an offset/mask conv, the sampled columns
    (`dcnv2_im2col`) times the (P, C, c2) weight, bias, BatchNorm(eps 1e-3)
    and SiLU. `g` is taken and unused, as in the JAX package."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, p: int = 1, g: int = 1, act=True):
        super().__init__()
        self.k, self.s, self.p = k, s, p
        self.conv_offset_mask = HaloConv2d(c1, 3 * k * k, k, s, p, bias=True)
        self.weight = nn.Parameter(torch.zeros(k * k, c1, c2))
        self.bias = nn.Parameter(torch.zeros(c2))
        self.bn = FlaxBatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = nn.SiLU() if act is True else nn.Identity()

    def forward(self, x):
        N = x.shape[0]
        P = self.k * self.k
        om = self.conv_offset_mask(x).permute(0, 2, 3, 1)  # (N, Ho, Wo, 3P)
        Ho, Wo = om.shape[1:3]
        offset_y = om[..., :P].contiguous()
        offset_x = om[..., P:2 * P].contiguous()
        mask = torch.sigmoid(om[..., 2 * P:]).contiguous()
        sampled, row0 = x, 0
        if active_strip() is not None:  # the whole x; this strip's output rows from row0 on
            sampled, row0 = gather_h(x), active_strip().level(Ho).start
        cols = dcnv2_columns(sampled.permute(0, 2, 3, 1).contiguous(), offset_y, offset_x, mask, self.k, self.s,
                             self.p, row0=row0)
        w = self.weight.reshape(-1, self.weight.shape[-1]).to(cols.dtype)
        out = torch.matmul(cols, w) + self.bias.to(cols.dtype)  # (N, Ho*Wo, c2)
        out = out.reshape(N, Ho, Wo, -1).permute(0, 3, 1, 2)
        return self.act(self.bn(out))


class BottleneckDCN(nn.Module):
    """1x1 Conv then a DCNv2, with a residual when shapes allow."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = DCNv2(c_, c2, 3, 1)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3_DCN(C3):
    """C3 with deformable bottlenecks."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, e=e, block=lambda c: BottleneckDCN(c, c, shortcut, g, e=1.0))


class C2f_DCN(C2f):
    """C2f with deformable bottlenecks."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, e=e, block=lambda c: BottleneckDCN(c, c, shortcut, g, e=1.0))


@torch.no_grad()
def init_dcn_heads(module: nn.Module, g: torch.Generator) -> None:
    """The JAX package's init where it differs from the graph's generic one:
    zero offset/mask heads (identity sampling), the DCNv2 weight from
    variance_scaling(2, fan_out, normal) with a zero bias, and DCNv3's
    depthwise conv from flax's default lecun_normal."""
    if isinstance(module, DCNv2):
        P, _, c2 = module.weight.shape
        module.weight.normal_(0.0, math.sqrt(2.0 / (P * c2)), generator=g)
        module.bias.zero_()
        module.conv_offset_mask.weight.zero_()
        module.conv_offset_mask.bias.zero_()
    elif isinstance(module, DCNv3):
        for head in (module.offset, module.mask):
            head.weight.zero_()
            head.bias.zero_()
        std = 1.0 / math.sqrt(module.k * module.k) / 0.87962566103423978
        nn.init.trunc_normal_(module.dw_conv.weight, std=std, a=-2 * std, b=2 * std, generator=g)
        module.dw_conv.bias.zero_()


@torch.no_grad()
def randomize_offset_heads(model: nn.Module, seed: int = 0) -> None:
    """Random offset/mask heads for every DCNv2 and DCNv3 in `model`, for
    checks of the sampling. At the JAX init the heads are zero, so a model
    built from a seed samples only integer taps with uniform masks; here
    each offset gets a bias of ~2 px (normal, std 2) plus a data-dependent
    part with weights of std 1/sqrt(fan_in), so offsets are fractional,
    reach several pixels and leave the map, and masks differ per point."""
    g = torch.Generator().manual_seed(seed)

    def draw(t: torch.Tensor, std: float):
        t.copy_(torch.randn(t.shape, generator=g, dtype=torch.float64) * std)

    for m in model.modules():
        if isinstance(m, DCNv2):
            P = m.k * m.k
            head = m.conv_offset_mask
            draw(head.weight, 1.0 / math.sqrt(head.weight[0].numel()))
            draw(head.bias[: 2 * P], 2.0)
            draw(head.bias[2 * P:], 1.0)
        elif isinstance(m, DCNv3):
            for head, bias_std in ((m.offset, 2.0), (m.mask, 1.0)):
                draw(head.weight, 1.0 / math.sqrt(head.in_features))
                draw(head.bias, bias_std)
