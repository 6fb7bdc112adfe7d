"""The detection family's blocks (counterparts of
yolosomi_tpu/models/layers.py): the flagship's, the YOLOv5 / YOLOv8
blocks of the other model configs, yolov3-tiny's pool and pad, the Ghost,
transformer and YOLOv10 blocks, and the Classify head.

Modules are NCHW and run in `torch.channels_last` memory format, so a
tensor's memory is NHWC like the JAX package's arrays. Submodule names
follow the reference checkpoints' state_dict keys, which the weight bridge
(utils/weights.py) maps flax paths onto.

Numerical conventions kept from the JAX package:
- Conv's BatchNorm has eps 1e-3 (layers.py:39-40); the ODConv attention
  trunk's BatchNorm has eps 1e-5 (layers.py:842). The momentum
  conventions (flax 0.97 == torch 0.03, flax 0.9 == torch 0.1) matter only
  for training.
- In training mode every BatchNorm normalizes with the batch statistics
  and updates its running variance with the biased batch variance, as
  flax.linen.BatchNorm does (FlaxBatchNorm1d / FlaxBatchNorm2d); torch's
  own update uses the unbiased one (2x flax's for ODConv's trunk at batch
  2). Eval mode is torch's BatchNorm unchanged.
- SEAM's GELU is exact erf in float32 and the tanh form in bfloat16
  (layers.py:631-632).

Under `parallel.spatial.spatial(strip)` (spatial sharding for serving)
every operator that looks across rows runs on its strip: convs and pools
of more than one row (and strided convs) fetch their halo rows,
whole-map means and maxima reduce over the strips, EMA-CBAM's profile and
GroupNorm span the whole map, ODConv's per-sample conv runs on the strip
and two rows above it, the attention blocks (TransformerBlock,
AttentionPSA) run on the gathered whole map, and ZeroPad2d hands the
stride-1 MaxPool2d after it the strip with its rows below. Outside it
every module computes as before.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from yolosomi_tpu_torch.ops.odconv import per_sample_conv
from yolosomi_tpu_torch.parallel import mesh, spatial
from yolosomi_tpu_torch.parallel.spatial import active_strip, check_aligned, halo_rows, strip_amax_hw, strip_mean_hw

BN_EPS = 1e-3
BN_MOMENTUM = 0.03  # torch convention; flax momentum 0.97


class _FlaxRunningStats:
    """Training-mode BatchNorm with flax's running statistics: normalize
    with the batch mean and biased variance, then
    running = (1 - momentum) * running + momentum * batch statistic, with
    the biased variance. The batch statistics come from the same fused
    batch_norm call (momentum 1 into scratch buffers, which receive the
    mean and the unbiased variance); the variance is rescaled by (n-1)/n.
    With `update_stats` False (frozen_running_stats) it normalizes the same
    way and leaves the running statistics alone.

    Inside a data-parallel train step (parallel.mesh.reducing) the
    statistics are the global batch's, as under the JAX mesh: each rank
    takes its exact two-pass moments in f32 (or the input's wider dtype),
    the sum and the sum of squares about its own mean, and one
    differentiable all-reduce of the stacked (2, C) float64 buffer
    [sum, M2 + sum * mean] merges them into the global mean and biased
    variance over n counted on every rank. Float64 keeps the merge free of
    the cancellation that flax's one-pass E[x^2] - E[x]^2 suffers in f32
    for a channel whose mean is far larger than its spread."""

    update_stats = True

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        if mesh.active() is not None:
            return self._global_forward(x)
        n = x.numel() // x.shape[1]
        if n == 1:  # one value a channel (ODConv's trunk under --quad at batch 4), which torch refuses:
            # flax's mean is the value and its variance 0, so the output is the bias
            mean = x.detach().reshape(-1)
            y = x * 0 + self.bias.view(1, -1, *([1] * (x.dim() - 2)))
        else:
            mean = torch.zeros_like(self.running_mean)
            var = torch.ones_like(self.running_var)
            y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        if not self.update_stats:
            return y
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m)
            if n > 1:
                self.running_var.add_(var, alpha=m * (n - 1) / n)
        return y

    def _global_forward(self, x):
        dims = [0] + list(range(2, x.dim()))
        shape = (1, -1, *([1] * (x.dim() - 2)))
        xf = x.to(torch.promote_types(x.dtype, torch.float32))  # at least f32, as flax reduces
        n_r = x.numel() // x.shape[1]
        s1 = xf.sum(dims)
        d_r = xf - (s1 / n_r).view(shape)
        s1, m2 = s1.double(), (d_r * d_r).sum(dims).double()
        moments = mesh.all_reduce_sum(torch.stack([s1, m2 + s1 * s1 / n_r]))
        n = float(n_r * mesh.active().world)
        mean = moments[0] / n
        var = moments[1] / n - mean * mean
        mul = torch.rsqrt(var + self.eps) * self.weight.double()
        y = ((xf - mean.to(xf.dtype).view(shape)) * mul.to(xf.dtype).view(shape)
             + self.bias.to(xf.dtype).view(shape)).to(x.dtype)
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean.detach().to(self.running_mean.dtype), alpha=m)
                self.running_var.mul_(1.0 - m).add_(var.detach().to(self.running_var.dtype), alpha=m)
        return y


class FlaxBatchNorm1d(_FlaxRunningStats, nn.BatchNorm1d):
    pass


class FlaxBatchNorm2d(_FlaxRunningStats, nn.BatchNorm2d):
    pass


@contextlib.contextmanager
def frozen_running_stats(model: nn.Module):
    """Train-mode BatchNorms of `model` that leave their running statistics
    alone: the recompute of a checkpointed segment runs its forward a
    second time, which would move them twice."""
    bns = [m for m in model.modules() if isinstance(m, _FlaxRunningStats)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


# int8 serving (ops/quant.py): None, or the function that runs every
# ConvRaw in place of its float forward while a quant mode is active
# (calibration, or the int8 conv), as the JAX package's trace-time
# QUANT_MODE switches ConvRaw's branch (layers.py:44-89)
QUANT_HOOK: list = [None]


class HaloConv2d(nn.Conv2d):
    """nn.Conv2d that runs on the active strip under spatial sharding: a
    conv of more than one row, a strided or a row-padded one fetches the
    rows of its window from the neighbouring strips
    (parallel.spatial.conv2d)."""

    def forward(self, x):
        if active_strip() is None or (self.kernel_size[0], self.stride[0], self.padding[0]) == (1, 1, 0):
            return super().forward(x)
        return spatial.conv2d(x, self.weight, self.bias, self.stride, self.padding, self.dilation, self.groups)

    def halo(self) -> int:
        """The most rows this conv asks of a neighbouring strip."""
        return max(spatial.conv_halo(self.kernel_size[0], self.stride[0], self.padding[0], self.dilation[0]))


class ConvRaw(HaloConv2d):
    """nn.Conv2d where the JAX package builds a ConvRaw (layers.py:104):
    Conv's conv, BottleneckCSP's cv2 / cv3, the CBAM spatial gate, SEAM's
    depthwise and pointwise convs, EMA-CBAM's cv1 / cv2 / conv_spatial and
    the heads' output convs. These are the convs int8 serving calibrates
    and quantizes; the other Conv2d (EMA-CBAM's Dense pair, the DCN offset
    and depthwise convs) are flax nn.Conv or Dense there and stay float.
    The float forward is nn.Conv2d's unless ops.quant has a mode active.
    `a_scale` is the calibrated activation absmax (a scalar, or (Cin,)
    per channel: the JAX package's `quant` collection entry), None until
    ops.quant.load_quant_scales sets it; `quant_path` is the flax path that
    int8 exclusion patterns match."""

    quant_path = None

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.register_buffer("a_scale", None, persistent=False)

    def forward(self, x):
        hook = QUANT_HOOK[0]
        if hook is None:
            return super().forward(x)
        if active_strip() is not None:
            raise RuntimeError("int8 serving is not sharded spatially (the JAX package's quantized_infer_fn runs "
                               "unsharded)")
        return hook(self, x)


def autopad(k, p: Optional[int] = None, d: int = 1):
    """'same' padding for an odd kernel size, an int or an (h, w) pair, at
    dilation d."""
    if p is not None:
        return p
    if d > 1:
        k = d * (k - 1) + 1 if isinstance(k, int) else tuple(d * (x - 1) + 1 for x in k)
    return k // 2 if isinstance(k, int) else tuple(x // 2 for x in k)


class Conv(nn.Module):
    """Conv2d (no bias) + BatchNorm(eps 1e-3) + SiLU. `k` is an int or an
    (h, w) pair; `act` True (SiLU), False (none) or an activation module
    (ASFF's LeakyReLU(0.1)); `d` the dilation."""

    def __init__(self, c1: int, c2: int, k: Union[int, Tuple[int, int]] = 1, s: int = 1, p: Optional[int] = None,
                 g: int = 1, act: Union[bool, nn.Module] = True, d: int = 1):
        super().__init__()
        self.conv = ConvRaw(c1, c2, k, s, autopad(k, p, d), dilation=d, groups=g, bias=False)
        self.bn = FlaxBatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = act if isinstance(act, nn.Module) else nn.SiLU() if act else nn.Identity()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class Focus(nn.Module):
    """Space-to-depth by 2, then Conv. The pixel order is the JAX package's
    (layers.py:289): (even, even), (odd, even), (even, odd), (odd, odd)
    over (H, W), each block of input channels whole."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: Optional[int] = None, g: int = 1,
                 act: bool = True):
        super().__init__()
        self.conv = Conv(4 * c1, c2, k, s, p, g, act)

    def forward(self, x):
        check_aligned([x], 2)
        return self.conv(torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2], x[..., ::2, 1::2], x[..., 1::2, 1::2]], 1))


class Bottleneck(nn.Module):
    """Conv k[0], Conv k[1] (grouped by g), and the residual where
    `shortcut` and c1 == c2. k[i] is an int or an (h, w) pair."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, k: Sequence = (3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0], 1)
        self.cv2 = Conv(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class BottleneckCSP(nn.Module):
    """CSP bottleneck: cv1 and n bottlenecks, then the bare 1x1 conv cv3, in
    parallel with the bare 1x1 conv cv2 of the input; one BatchNorm
    (eps 1e-3) and SiLU over their concatenation; then cv4."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, e=1.0) for _ in range(n)))
        self.cv3 = ConvRaw(c_, c_, 1, bias=False)
        self.cv2 = ConvRaw(c1, c_, 1, bias=False)
        self.bn = FlaxBatchNorm2d(2 * c_, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = nn.SiLU()
        self.cv4 = Conv(2 * c_, c2, 1, 1)

    def forward(self, x):
        y = torch.cat([self.cv3(self.m(self.cv1(x))), self.cv2(x)], 1)
        return self.cv4(self.act(self.bn(y)))


class C3(nn.Module):
    """CSP bottleneck with three convs: cv1 and n bottlenecks beside cv2,
    concatenated into cv3. `block(c)` makes one bottleneck of c channels:
    by default Bottleneck with k 1x1 then 3x3 and e 1.0."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5,
                 block: Optional[Callable[[int], nn.Module]] = None):
        super().__init__()
        c_ = int(c2 * e)
        block = block or (lambda c: Bottleneck(c, c, shortcut, g, k=((1, 1), (3, 3)), e=1.0))
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1, 1)
        self.m = nn.Sequential(*(block(c_) for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class C2f(nn.Module):
    """YOLOv8's split CSP block: cv1 to 2c channels, split in halves, n
    bottlenecks chained on the last piece, every piece concatenated into
    cv2. `block(c)` makes one bottleneck of c channels: by default
    Bottleneck with k 3x3 then 3x3 and e 1.0. The C2f variants of the
    flagship and of yolo-somi-dcn are this skeleton with their own block."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, g: int = 1, e: float = 0.5,
                 block: Optional[Callable[[int], nn.Module]] = None):
        super().__init__()
        self.c = int(c2 * e)
        block = block or (lambda c: Bottleneck(c, c, shortcut, g, k=((3, 3), (3, 3)), e=1.0))
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(block(self.c) for _ in range(n))

    def forward(self, x):
        ys = list(self.cv1(x).split(self.c, 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


# ---------------------------------------------------------------------------
# CBAM family
# ---------------------------------------------------------------------------


class ChannelAttentionModule(nn.Module):
    """CBAM channel gate: shared MLP over avg- and max-pooled stats, sigmoid.
    Returns the (B, C, 1, 1) gate."""

    def __init__(self, c1: int, reduction: int = 16):
        super().__init__()
        mid = max(c1 // reduction, 1)
        self.shared_MLP = nn.Sequential(nn.Linear(c1, mid), nn.ReLU(), nn.Linear(mid, c1))

    def forward(self, x):
        gate = torch.sigmoid(self.shared_MLP(strip_mean_hw(x)) + self.shared_MLP(strip_amax_hw(x)))
        return gate[:, :, None, None]


class SpatialAttentionModule(nn.Module):
    """CBAM spatial gate: k x k conv over the [mean_c, max_c] maps, sigmoid.
    Returns the (B, 1, H, W) gate."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.cv1 = ConvRaw(2, 1, kernel_size, padding=kernel_size // 2)

    def forward(self, x):
        stats = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], 1)
        return torch.sigmoid(self.cv1(stats))


class CBAM(nn.Module):
    """Channel gate then spatial gate."""

    def __init__(self, c1: int, reduction: int = 16, kernel_size: int = 7):
        super().__init__()
        self.channel_attention = ChannelAttentionModule(c1, reduction)
        self.spatial_attention = SpatialAttentionModule(kernel_size)

    def forward(self, x):
        x = self.channel_attention(x) * x
        return self.spatial_attention(x) * x


class CBAMBottleneck(CBAM):
    """Conv, CBAM on the mid features, Conv, optional residual."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 1.0, k=(3, 3), ratio: int = 8,
                 kernel_size: int = 3):
        c_ = int(c2 * e)
        super().__init__(c_, ratio, kernel_size)
        self.cv1 = Conv(c1, c_, k[0], 1)
        self.cv2 = Conv(c_, c2, k[1], 1)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(super().forward(self.cv1(x)))
        return x + y if self.add else y


class C2fCBAM(C2f):
    """C2f whose bottlenecks carry CBAM (ratio 16, 7x7 spatial gate)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, e: float = 0.5,
                 kernel_size: int = 7):
        super().__init__(c1, c2, n, e=e, block=lambda c: CBAMBottleneck(c, c, shortcut, e=1.0, ratio=16,
                                                                          kernel_size=kernel_size))


# ---------------------------------------------------------------------------
# SEAM and the EMA-CBAM bottleneck
# ---------------------------------------------------------------------------


class _Residual(nn.Module):
    """x + fn(x); the attribute name `fn` is the reference's key."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return x + self.fn(x)


class SEAM(nn.Module):
    """Spatially-enhanced attention: a depthwise-residual conv stack, global
    pool, SE-style MLP, and an exp-of-sigmoid channel gate. `approx_gelu`
    selects the tanh GELU, which the JAX package uses under bfloat16."""

    def __init__(self, c1: int, n: int = 1, reduction: int = 16, approx_gelu: bool = False):
        super().__init__()
        c = c1
        gelu = lambda: nn.GELU(approximate="tanh" if approx_gelu else "none")  # noqa: E731
        bn = lambda: FlaxBatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)  # noqa: E731
        self.DCovN = nn.Sequential(
            ConvRaw(c, c, 3, 1, 1, groups=c), gelu(), bn(),
            *[
                nn.Sequential(
                    _Residual(nn.Sequential(ConvRaw(c, c, 3, 1, 1, groups=c), gelu(), bn())),
                    ConvRaw(c, c, 1), gelu(), bn(),
                )
                for _ in range(n)
            ],
        )
        mid = max(c // reduction, 1)
        self.fc = nn.Sequential(nn.Linear(c, mid, bias=False), nn.ReLU(), nn.Linear(mid, c, bias=False))

    def forward(self, x):
        v = self.fc(strip_mean_hw(self.DCovN(x)))
        return x * torch.exp(torch.sigmoid(v))[:, :, None, None]


class EMACBAMBottleneck(nn.Module):
    """Two plain convs, a CBAM-style channel gate, an EMA-style per-group
    spatial gate from h- and w-pooled profiles, then per-channel GroupNorm.
    No residual."""

    def __init__(self, c1: int, c2: int, e: float = 0.5, factor: int = 8):
        super().__init__()
        c_ = int(c2 * e)
        self.factor = factor
        gch = max(c2 // factor, 1)
        self.cv1 = ConvRaw(c1, c_, 3, 1, 1)
        self.cv2 = ConvRaw(c_, c2, 3, 1, 1)
        self.fc = nn.Sequential(nn.Conv2d(c2, gch, 1, bias=False), nn.ReLU(), nn.Conv2d(gch, c2, 1, bias=False))
        self.conv_spatial = ConvRaw(gch, 1, (7, 1), padding=(3, 0), bias=False)
        self.gn = nn.GroupNorm(c2, c2, eps=1e-5)

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        b, c, h, w = y.shape
        g = self.factor
        gch = c // g
        gate_c = torch.sigmoid(self.fc(strip_mean_hw(y, keepdim=True)) + self.fc(strip_amax_hw(y, keepdim=True)))
        y = y * gate_c
        gy = y.reshape(b, g, gch, h, w)
        st = active_strip()
        if st is None:
            top, height = 0, h
            profile = torch.cat([gy.mean(4), gy.mean(3)], 3)  # (b, g, gch, h + w)
            gate_s = self.conv_spatial(profile.reshape(b * g, gch, h + w, 1))
        else:  # the whole profile on every rank: the (7, 1) taps cross the seam of its h and w parts
            lv = st.level(h)
            top, height = lv.start, lv.height
            profile = torch.cat([spatial.gather_h(gy.mean(4), 3), spatial.strip_mean_h(gy, 3)], 3)
            gate_s = nn.Conv2d.forward(self.conv_spatial, profile.reshape(b * g, gch, height + w, 1))
        gate_s = torch.sigmoid(gate_s.reshape(b, g, 1, height + w))
        gate_h = gate_s[..., top:top + h].reshape(b, g, 1, h, 1)
        gate_w = gate_s[..., height:].reshape(b, g, 1, 1, w)
        gy = (gy * gate_h * gate_w).reshape(b, c, h, w)
        if height * w == 1:  # one value a group (torch refuses it at batch 1): flax's output is the bias
            return gy * 0 + self.gn.bias.view(1, -1, 1, 1)
        return self.gn(gy) if st is None else self._strip_group_norm(gy)

    def _strip_group_norm(self, x):
        """GroupNorm(c2, c2) over the whole map on a strip: each channel's
        mean, then its centred squares' mean, in f32, across the strips."""
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        n = active_strip().level(x.shape[2]).height * x.shape[3]
        d = xf - (spatial.strip_sum_hw(xf, keepdim=True) / n)
        var = spatial.strip_sum_hw(d * d, keepdim=True) / n
        shape = (1, -1, 1, 1)
        y = d * torch.rsqrt(var + self.gn.eps) * self.gn.weight.to(xf.dtype).view(shape) + self.gn.bias.to(
            xf.dtype).view(shape)
        return y.to(x.dtype)


class C2fEMACBAM(C2f):
    """C2f with EMA-CBAM bottlenecks (the YAML's `C2fEACBAM` rows alias it)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, e: float = 0.5):
        super().__init__(c1, c2, n, e=e, block=lambda c: EMACBAMBottleneck(c, c, e=0.5, factor=8))


# ---------------------------------------------------------------------------
# Pooling, resampling, fusion
# ---------------------------------------------------------------------------


def max_pool(x, k: int):
    """The stride-1 k x k max-pool of SPP and SPPF, padded by k // 2. On a
    strip the k // 2 rows above and below come from the neighbours, and
    -inf past the image's edges, as the pool pads (SiLU maps reach -0.28,
    so zero rows would change the result)."""
    if active_strip() is None:
        return F.max_pool2d(x, k, 1, k // 2)
    return F.max_pool2d(halo_rows(x, k // 2, k // 2, fill=float("-inf")), k, 1, (0, k // 2))


class SPP(nn.Module):
    """Spatial pyramid pooling: cv1, then the map beside its stride-1
    max-pools of each size in k, concatenated into cv2."""

    def __init__(self, c1: int, c2: int, k: Sequence[int] = (5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * (len(k) + 1), c2, 1, 1)
        self.k = tuple(k)

    def forward(self, x):
        y = self.cv1(x)
        return self.cv2(torch.cat([y] + [max_pool(y, k) for k in self.k], 1))


class SPPF(nn.Module):
    """Fast SPP: three chained k-pools."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * 4, c2, 1, 1)
        self.k = k

    def forward(self, x):
        y = self.cv1(x)
        pool = lambda t: max_pool(t, self.k)  # noqa: E731
        y1 = pool(y)
        y2 = pool(y1)
        return self.cv2(torch.cat([y, y1, y2, pool(y2)], 1))


class Upsample(nn.Module):
    """Nearest-neighbour upsampling by an integer factor."""

    def __init__(self, scale_factor: int = 2):
        super().__init__()
        self.scale_factor = int(scale_factor)

    def forward(self, x):
        return F.interpolate(x, scale_factor=self.scale_factor, mode="nearest")


class Concat(nn.Module):
    """Concatenation along the channels."""

    def forward(self, xs: List[torch.Tensor]):
        check_aligned(xs)
        return torch.cat(xs, 1)


class Contract(nn.Module):
    """Space-to-depth by `gain`: (B, C, H, W) -> (B, C*g*g, H/g, W/g). The
    channel order is the JAX package's NHWC one, (gy, gx, c): output
    channel (gy*g + gx)*C + c holds input channel c at (g*y + gy, g*x + gx).
    The work runs on the NHWC view, so a channels_last input gives a
    channels_last output."""

    def __init__(self, gain: int = 2):
        super().__init__()
        self.gain = gain

    def forward(self, x):
        b, c, h, w = x.shape
        g = self.gain
        check_aligned([x], g)
        y = x.permute(0, 2, 3, 1).reshape(b, h // g, g, w // g, g, c).transpose(2, 3)
        return y.reshape(b, h // g, w // g, g * g * c).permute(0, 3, 1, 2)


class BiFPN(nn.Module):
    """Learned-weight fusion of N equal-shaped inputs:
    w_i / (sum(swish(w)) + eps), weighted sum. The weights are normalised in
    float32, then cast to the inputs' dtype, as the JAX package does."""

    def __init__(self, length: int, epsilon: float = 1e-4):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(length))
        self.epsilon = epsilon

    def forward(self, xs: List[torch.Tensor]):
        check_aligned(xs)
        w = self.weight.float()
        wn = (w / (torch.sum(w * torch.sigmoid(w)) + self.epsilon)).to(xs[0].dtype)
        out = wn[0] * xs[0]
        for i in range(1, len(xs)):
            out = out + wn[i] * xs[i]
        return out


# ---------------------------------------------------------------------------
# Dynamic convolution (ODConv)
# ---------------------------------------------------------------------------


class ODConv2d(nn.Module):
    """Omni-dimensional dynamic conv: K candidate kernels mixed per sample by
    four attention factors (kernel-wise softmax, spatial, in-channel and
    out-channel sigmoids). The per-sample conv at the flagship's shape (3x3,
    stride 2, padding 1, one group, no dilation) is ops.odconv.odconv_s2 (a
    CUDA kernel on the GPU); any other shape (DetectODConv's 1x1 stride-1
    prediction convs) is one grouped conv over the batch (`grouped_conv`),
    as the JAX package runs every shape its Pallas kernel does not take
    through vmap(conv) (layers.py:928, odconv_pallas.supported). The trunk
    and the mix are small tensor ops left to PyTorch, as the JAX package
    left them to XLA.

    `weight` is the (K, Cout, Cin/g, k, k) candidate bank and `bias` the
    (K, Cout) bias bank, as in the reference checkpoints."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, p: Optional[int] = None, g: int = 1, d: int = 1,
                 K: int = 4, r: float = 1.0 / 16.0):
        super().__init__()
        self.k, self.s, self.g, self.d = k, s, g, d
        self.p = d * (k - 1) // 2 if p is None else p  # autopad(k, p, d)
        self.c1, self.c2, self.K = c1, c2, K
        hidden = max(int(c1 * r), 16)
        self.weight = nn.Parameter(torch.zeros(K, c2, c1 // g, k, k))
        self.bias = nn.Parameter(torch.zeros(K, c2))
        self.fc = nn.Linear(c1, hidden, bias=False)
        self.bn = FlaxBatchNorm1d(hidden, eps=1e-5, momentum=0.1)
        self.fc_f = nn.Linear(hidden, c2)
        self.fc_s = nn.Linear(hidden, k * k)
        self.fc_c = nn.Linear(hidden, c1 // g)
        self.fc_w = nn.Linear(hidden, K)

    @property
    def uses_kernel(self) -> bool:
        """Whether odconv_s2 computes this conv."""
        return (self.k, self.s, self.p, self.g, self.d) == (3, 2, 1, 1, 1)

    def forward(self, x):
        b = x.shape[0]
        k = self.k
        # attention trunk: GAP -> fc -> BN -> ReLU -> four factors
        v = torch.relu(self.bn(self.fc(strip_mean_hw(x))))
        attn_f = torch.sigmoid(self.fc_f(v))  # (B, Cout)
        attn_s = torch.sigmoid(self.fc_s(v)).reshape(b, k, k)
        attn_c = torch.sigmoid(self.fc_c(v))  # (B, Cin/g)
        attn_w = torch.softmax(self.fc_w(v), -1)  # (B, K)
        # mix over K once, then the separable factors -> (B, k, k, Cin/g, Cout)
        wmix = torch.einsum("bk,koihw->bhwio", attn_w, self.weight)
        wmix = wmix * attn_s[:, :, :, None, None] * attn_c[:, None, None, :, None] * attn_f[:, None, None, None, :]
        bias = (attn_w.float() @ self.bias.float()).to(x.dtype)
        if not self.uses_kernel:
            if active_strip() is not None and (k, self.s) != (1, 1):
                raise NotImplementedError(f"ODConv2d at k={k} s={self.s} on a strip (ROADMAP queue A item 6)")
            out = grouped_conv(x, wmix.to(x.dtype), self.s, self.p, self.d, self.g)
            return out + bias[:, :, None, None]
        x_nhwc = x.permute(0, 2, 3, 1).contiguous()  # free for a channels_last x
        if active_strip() is None:
            out = per_sample_conv(x_nhwc, wmix.to(x.dtype).contiguous())
        else:  # the kernel pads one row: given the two rows above an even strip, its first output row is surplus
            out = per_sample_conv(halo_rows(x_nhwc, 2, 0, dim=1), wmix.to(x.dtype).contiguous())[:, 1:]
        out = out + bias[:, None, None, :]
        return out.permute(0, 3, 1, 2)


def grouped_conv(x: torch.Tensor, wmix: torch.Tensor, s: int, p: int, d: int, g: int) -> torch.Tensor:
    """Per-sample conv as one conv of B*g groups (the reference's
    view(1, B*C, H, W) trick): x (B, Cin, H, W), wmix (B, k, k, Cin/g,
    Cout) -> (B, Cout, H', W'), channels_last."""
    B, cin, H, W = x.shape
    k, cout = wmix.shape[1], wmix.shape[-1]
    w = wmix.permute(0, 4, 3, 1, 2).reshape(B * cout, cin // g, k, k)  # per-sample OIHW stacked
    out = F.conv2d(x.reshape(1, B * cin, H, W), w, stride=s, padding=p, dilation=d, groups=B * g)
    return out.reshape(B, cout, *out.shape[2:]).contiguous(memory_format=torch.channels_last)


class ODConv(nn.Module):
    """ODConv2d + BatchNorm(eps 1e-3) + SiLU, the YAML-visible module
    (`ODConv_3rd`; the JAX ODConv's [c2, k, s, kerNums, g, p])."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, kerNums: int = 4, g: int = 1,
                 p: Optional[int] = None):
        super().__init__()
        self.conv = ODConv2d(c1, c2, k, s, p, g, K=kerNums)
        self.bn = FlaxBatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = nn.SiLU()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


# ---------------------------------------------------------------------------
# yolov3-tiny's pool and pad, the Ghost, transformer and YOLOv10 families,
# and the classification head
# ---------------------------------------------------------------------------


def on_whole_map(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """fn(x), where fn looks at the whole map at once (attention over every
    position): on a strip, fn runs on the whole map gathered along H, with
    the strip context off, and this strip's rows of its output come back."""
    st = active_strip()
    if st is None:
        return fn(x)
    lv = st.level(x.shape[2])
    whole = spatial.gather_h(x).contiguous(memory_format=torch.channels_last)
    with spatial.spatial(None):
        y = fn(whole)
    return y[:, :, lv.start:lv.stop]


class MaxPool2d(nn.Module):
    """The YAML's nn.MaxPool2d with torch's [k, s, p] semantics (a -inf
    fill). On a strip the window's rows above and below come from the
    neighbours, -inf past the image's edges; a strip that ZeroPad2d has
    already given the rows below it (`pad_below`) is pooled as it is."""

    def __init__(self, k: int = 2, s: int = 2, p: int = 0):
        super().__init__()
        self.k, self.s, self.p = k, s, p

    def forward(self, x):
        if active_strip() is None:
            return F.max_pool2d(x, self.k, self.s, self.p)
        below = getattr(x, "pad_below", None)
        if below is not None:
            if (self.s, self.p, self.k - 1) != (1, 0, below):
                raise NotImplementedError(f"a {self.k}x{self.k} stride-{self.s} pool after a pad of {below} rows on "
                                          "a strip (ROADMAP queue A item 6)")
            return F.max_pool2d(x, self.k, 1, 0)
        above, below = spatial.conv_halo(self.k, self.s, self.p)
        y = F.max_pool2d(halo_rows(x, above, below, fill=float("-inf")), self.k, self.s, (0, self.p))
        if y.shape[2] * self.s != x.shape[2]:
            raise ValueError(f"a strip of {x.shape[2]} rows gave {y.shape[2]} rows at stride {self.s}")
        return y

    def halo(self) -> int:
        return max(spatial.conv_halo(self.k, self.s, self.p))


class ZeroPad2d(nn.Module):
    """The YAML's nn.ZeroPad2d, pads (left, right, top, bottom). On a strip
    W pads as on the whole map, and the strip takes `top` rows above and
    `bottom` rows below it: its neighbours' rows, zeros past the image's
    true edges. The result is no level of the strip (it holds top + bottom
    rows more), so only a stride-1 MaxPool2d whose window spans them reads
    it (yolov3-tiny's pad (0, 1, 0, 1) and 2x2 stride-1 pool); it carries
    `pad_below` = top + bottom for that pool."""

    def __init__(self, pads: Sequence[int] = (0, 1, 0, 1)):
        super().__init__()
        self.pads = tuple(pads)

    def forward(self, x):
        left, right, top, bottom = self.pads
        if active_strip() is None:
            return F.pad(x, (left, right, top, bottom))
        y = F.pad(halo_rows(x, top, bottom), (left, right))
        y.pad_below = top + bottom
        return y


class DWConv(Conv):
    """Depthwise Conv: groups g = gcd(c1, c2) unless given."""

    def __init__(self, c1: int, c2: int, k=1, s: int = 1, p: Optional[int] = None, g: Optional[int] = None,
                 act: bool = True):
        super().__init__(c1, c2, k, s, p, math.gcd(c1, c2) if g is None else g, act)


class GhostConv(nn.Module):
    """Ghost convolution: Conv to c2 / 2 channels, and a 5x5 depthwise Conv
    of that beside it."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1, act: bool = True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_, k, s, None, g, act)
        self.cv2 = Conv(c_, c_, 5, 1, None, c_, act)

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], 1)


class GhostBottleneck(nn.Module):
    """Ghost bottleneck: GhostConv, a depthwise Conv at stride 2, GhostConv
    without activation; the shortcut is the input, or at stride 2 (or
    c1 != c2) a depthwise and a pointwise Conv. The names are the JAX
    package's (conv1, dw, conv2, sc_dw, sc_pw)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.conv1 = GhostConv(c1, c_, 1, 1)
        self.dw = DWConv(c_, c_, k, s, g=c_, act=False) if s == 2 else nn.Identity()
        self.conv2 = GhostConv(c_, c2, 1, 1, act=False)
        self.sc_dw = DWConv(c1, c1, k, s, g=c1, act=False) if s == 2 else nn.Identity()
        self.sc_pw = Conv(c1, c2, 1, 1, act=False) if s == 2 or c1 != c2 else nn.Identity()

    def forward(self, x):
        return self.conv2(self.dw(self.conv1(x))) + self.sc_pw(self.sc_dw(x))


class C3Ghost(C3):
    """C3 with Ghost bottlenecks (k 3, stride 1)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e, block=lambda c: GhostBottleneck(c, c, 3, 1))


class TorchMHA(nn.Module):
    """nn.MultiheadAttention's body in its parameter layout: the packed
    `in_proj_weight` / `in_proj_bias` rows [W_q; W_k; W_v], q scaled by
    head_dim**-0.5 after its projection, the softmax in the compute dtype,
    and `out_proj`."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.c, self.num_heads = c, num_heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * c, c))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * c))
        self.out_proj = nn.Linear(c, c)

    def forward(self, q, k, v):  # each (B, N, C)
        c, h = self.c, self.num_heads
        hd = c // h
        w, b = self.in_proj_weight, self.in_proj_bias
        q = F.linear(q, w[:c], b[:c]) * hd ** -0.5
        k = F.linear(k, w[c:2 * c], b[c:2 * c])
        v = F.linear(v, w[2 * c:], b[2 * c:])
        bsz, n, _ = q.shape
        split = lambda t: t.reshape(bsz, n, h, hd).transpose(1, 2)  # noqa: E731
        attn = torch.softmax(split(q) @ split(k).transpose(-1, -2), -1)
        return self.out_proj((attn @ split(v)).transpose(1, 2).reshape(bsz, n, c))


class TransformerLayer(nn.Module):
    """Pre-LayerNorm (eps 1e-5) attention whose q / k / v Linear layers feed
    a whole TorchMHA (the reference projects twice), then pre-LayerNorm and
    a bias-free 4x ReLU MLP, each with its residual. Dropout is off in eval,
    as in the JAX package."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(c, eps=1e-5)
        self.q = nn.Linear(c, c, bias=False)
        self.k = nn.Linear(c, c, bias=False)
        self.v = nn.Linear(c, c, bias=False)
        self.ma = TorchMHA(c, num_heads)
        self.ln2 = nn.LayerNorm(c, eps=1e-5)
        self.fc1 = nn.Linear(c, 4 * c, bias=False)
        self.fc2 = nn.Linear(4 * c, c, bias=False)

    def forward(self, x):  # (B, N, C)
        y = self.ln1(x)
        x = self.ma(self.q(y), self.k(y), self.v(y)) + x
        return x + self.fc2(torch.relu(self.fc1(self.ln2(x))))


class TransformerBlock(nn.Module):
    """A Conv to c2 where c1 != c2, then n TransformerLayers over the
    flattened positions (row-major) with a learned position term
    `linear(p)` added. On a strip it runs on the whole map."""

    def __init__(self, c1: int, c2: int, num_heads: int = 4, n: int = 1):
        super().__init__()
        self.conv = Conv(c1, c2) if c1 != c2 else nn.Identity()
        self.linear = nn.Linear(c2, c2)
        self.tr = nn.Sequential(*(TransformerLayer(c2, num_heads) for _ in range(n)))

    def forward(self, x):
        return on_whole_map(self._whole, x)

    def _whole(self, x):
        x = self.conv(x)
        b, c, h, w = x.shape
        p = x.flatten(2).transpose(1, 2)  # (B, H*W, C)
        p = self.tr(p + self.linear(p))
        return p.transpose(1, 2).reshape(b, c, h, w)  # channels_last in memory


class C3TR(C3):
    """C3 whose bottleneck stack is one TransformerBlock (4 heads, n layers)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, 0, shortcut, g, e)
        c_ = int(c2 * e)
        self.m = TransformerBlock(c_, c_, 4, n)


class RepVGGDW(nn.Module):
    """7x7 and 3x3 depthwise Convs without activation, summed, then SiLU (no
    fused form)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv(c, c, 7, 1, g=c, act=False)
        self.conv1 = Conv(c, c, 3, 1, g=c, act=False)

    def forward(self, x):
        return F.silu(self.conv(x) + self.conv1(x))


class CIB(nn.Module):
    """Compact inverted block: depthwise 3x3, pointwise to 2c_, depthwise 3x3
    (RepVGGDW with `lk`), pointwise to c2, depthwise 3x3, in `cv1`
    (reference names cv1.0-4; flax cv1_0-4); the residual where `shortcut`
    and c1 == c2."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5, lk: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = nn.Sequential(Conv(c1, c1, 3, g=c1), Conv(c1, 2 * c_, 1),
                                 RepVGGDW(2 * c_) if lk else Conv(2 * c_, 2 * c_, 3, g=2 * c_),
                                 Conv(2 * c_, c2, 1), Conv(c2, c2, 3, g=c2))
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv1(x)
        return x + y if self.add else y


class C2fCIB(C2f):
    """C2f with CIB bottlenecks (e 1.0)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, g: int = 1, e: float = 0.5,
                 lk: bool = False):
        super().__init__(c1, c2, n, shortcut, g, e, block=lambda c: CIB(c, c, shortcut, e=1.0, lk=lk))


class SCDown(nn.Module):
    """Separable downsample: pointwise Conv, then a depthwise k x k Conv at
    stride s without activation."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 2):
        super().__init__()
        self.cv1 = Conv(c1, c2, 1, 1)
        self.cv2 = Conv(c2, c2, k, s, g=c2, act=False)

    def forward(self, x):
        return self.cv2(self.cv1(x))


class AttentionPSA(nn.Module):
    """Multi-head self-attention over the positions with a positional
    depthwise 3x3 conv `pe` on v. The qkv channels split per head as
    (B, N, heads, 2 key_dim + head_dim) of the NHWC map; the softmax runs
    in f32 (f64 stays f64) and is cast back. On a strip it runs on the whole map."""

    def __init__(self, dim: int, num_heads: int = 8, attn_ratio: float = 0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim ** -0.5
        self.qkv = Conv(dim, dim + 2 * self.key_dim * num_heads, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 3, 1, g=dim, act=False)

    def forward(self, x):
        return on_whole_map(self._whole, x)

    def _whole(self, x):
        b, c, h, w = x.shape
        kd = self.key_dim
        qkv = self.qkv(x).permute(0, 2, 3, 1).reshape(b, h * w, self.num_heads, 2 * kd + self.head_dim)
        q, k, v = qkv.transpose(1, 2).split([kd, kd, self.head_dim], -1)
        logits = (q @ k.transpose(-1, -2)) * self.scale
        attn = torch.softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)), -1).to(v.dtype)
        nchw = lambda t: t.transpose(1, 2).reshape(b, h, w, c).permute(0, 3, 1, 2)  # noqa: E731
        return self.proj(nchw(attn @ v) + self.pe(nchw(v)))


class PSA(nn.Module):
    """Partial self-attention: cv1 to 2c channels (c = c1 e), AttentionPSA
    (max(c // 64, 1) heads) and a Conv pair `ffn` (ffn.0-1; flax ffn_0-1),
    each with its residual, on the second half; cv2 back to c1."""

    def __init__(self, c1: int, c2: int, e: float = 0.5):
        super().__init__()
        self.c = c = int(c1 * e)
        self.cv1 = Conv(c1, 2 * c, 1, 1)
        self.attn = AttentionPSA(c, num_heads=max(c // 64, 1))
        self.ffn = nn.Sequential(Conv(c, 2 * c, 1), Conv(2 * c, c, 1, act=False))
        self.cv2 = Conv(2 * c, c1, 1)

    def forward(self, x):
        a, b = self.cv1(x).split(self.c, 1)
        b = b + self.attn(b)
        b = b + self.ffn(b)
        return self.cv2(torch.cat([a, b], 1))


class Classify(nn.Module):
    """Classification head: the global mean of the map (of each map of a
    list, concatenated), then a Linear `linear` to c2 logits. On a strip
    the means are the whole map's."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.linear = nn.Linear(c1, c2)

    def forward(self, x):
        if isinstance(x, (list, tuple)):
            return self.linear(torch.cat([strip_mean_hw(xi) for xi in x], 1))
        return self.linear(strip_mean_hw(x))


# ---------------------------------------------------------------------------
# The parser's remaining kinds and the body zoo: gates, conv and CSP
# variants, space-to-depth and depth-to-space, fusion, the content-aware
# upsamplers, involution and Zoom_cat (yolosomi_tpu/models/layers.py). None
# of them has a strip path: those that reduce over the whole map or sample
# anywhere in it refuse a strip (refuse_strip), and the Runner refuses to
# shard a graph that names any of them (models.yolo.STRIPLESS).
# ---------------------------------------------------------------------------


def refuse_strip(module: nn.Module) -> None:
    """Raise under spatial sharding: `module` has no strip path, and its
    whole-map reduction or unbounded reach would be wrong on a strip."""
    if active_strip() is not None:
        raise NotImplementedError(f"{type(module).__name__} on a strip: its strip path is not ported (ROADMAP "
                                  "queue A item 6)")


class SE(nn.Module):
    """Squeeze-excitation gate (layers.py:589): the whole-map mean, a
    bias-free Dense pair `l1` / `l2` through ReLU, a sigmoid gate."""

    def __init__(self, c1: int, ratio: int = 16):
        super().__init__()
        self.l1 = nn.Linear(c1, max(c1 // ratio, 1), bias=False)
        self.l2 = nn.Linear(max(c1 // ratio, 1), c1, bias=False)

    def forward(self, x):
        refuse_strip(self)
        v = self.l2(torch.relu(self.l1(x.mean((2, 3)))))
        return x * torch.sigmoid(v)[:, :, None, None]


def eca_kernel_size(c: int, b: int = 1, gamma: int = 2) -> int:
    """ECA's odd kernel from the channel count (layers.py:1268-1269)."""
    t = int(abs((math.log2(c) + b) / gamma))
    return t if t % 2 else t + 1


class ECA(nn.Module):
    """Efficient channel attention (layers.py:1259): the whole-map mean, a
    bias-free 1-D conv `conv` over the channel axis ('same' padding, k from
    log2(c), b and gamma), a sigmoid gate."""

    def __init__(self, c1: int, b: int = 1, gamma: int = 2):
        super().__init__()
        self.b, self.gamma = b, gamma
        k = eca_kernel_size(c1, b, gamma)
        self.conv = nn.Conv1d(1, 1, k, padding=k // 2, bias=False)

    def forward(self, x):
        refuse_strip(self)
        v = self.conv(x.mean((2, 3))[:, None, :])[:, 0]
        return x * torch.sigmoid(v)[:, :, None, None]


class SimAM(nn.Module):
    """Parameter-free SimAM (layers.py:1169): x * sigmoid(d / (4 (v +
    e_lambda)) + 0.5), d the squared distance from the channel's whole-map
    mean and v d's sum over h * w - 1."""

    def __init__(self, c1: int = 0, e_lambda: float = 1e-4):
        super().__init__()
        self.e_lambda = e_lambda

    def forward(self, x):
        refuse_strip(self)
        n = x.shape[2] * x.shape[3] - 1
        d = (x - x.mean((2, 3), keepdim=True)).square()
        v = d.sum((2, 3), keepdim=True) / n
        return x * torch.sigmoid(d / (4 * (v + self.e_lambda)) + 0.5)


class CoorAttention(nn.Module):
    """Coordinate attention (layers.py:1187): the h- and w-profiles (means
    over W and over H) side by side, a shared biased 1x1 conv `conv1` to
    mip = max(8, c // reduction), BatchNorm `bn1` (eps 1e-3), hard-swish,
    then `conv_h` / `conv_w` back to c and sigmoid gates along H and W.
    The YAML row is of the conv kind; `c2` does not enter the block."""

    def __init__(self, c1: int, c2: int = 0, reduction: int = 32):
        super().__init__()
        mip = max(8, c1 // reduction)
        self.conv1 = ConvRaw(c1, mip, 1)
        self.bn1 = FlaxBatchNorm2d(mip, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.conv_h = ConvRaw(mip, c1, 1)
        self.conv_w = ConvRaw(mip, c1, 1)

    def forward(self, x):
        refuse_strip(self)
        h = x.shape[2]
        y = torch.cat([x.mean(3), x.mean(2)], 2)[..., None]  # (B, C, H + W, 1)
        y = F.hardswish(self.bn1(self.conv1(y)))
        gh = torch.sigmoid(self.conv_h(y[:, :, :h]))  # (B, C, H, 1)
        gw = torch.sigmoid(self.conv_w(y[:, :, h:]))  # (B, C, W, 1)
        return x * gh * gw.transpose(2, 3)


class BAM(nn.Module):
    """Bottleneck attention (layers.py:1279): a channel branch (whole-map
    mean, biased Dense `fc1` / `fc2` through ReLU) beside a spatial branch
    (1x1 `sp1`, two 3x3 convs dilated 4 `sp2` / `sp3`, 1x1 `sp4` to one
    channel, ReLU between), x * (1 + sigmoid(channel + spatial))."""

    def __init__(self, c1: int, reduction: int = 16):
        super().__init__()
        mid = max(c1 // reduction, 1)
        self.fc1 = nn.Linear(c1, mid)
        self.fc2 = nn.Linear(mid, c1)
        self.sp1 = ConvRaw(c1, mid, 1)
        self.sp2 = ConvRaw(mid, mid, 3, 1, 4, dilation=4)
        self.sp3 = ConvRaw(mid, mid, 3, 1, 4, dilation=4)
        self.sp4 = ConvRaw(mid, 1, 1)

    def forward(self, x):
        refuse_strip(self)
        ch = self.fc2(torch.relu(self.fc1(x.mean((2, 3)))))[:, :, None, None]
        s = torch.relu(self.sp3(torch.relu(self.sp2(torch.relu(self.sp1(x))))))
        return x * (1.0 + torch.sigmoid(ch + self.sp4(s)))


class MultiSEAM(nn.Module):
    """SEAM with three depthwise branches dilated 1, 2, 3 (`dcov<i>`, biased,
    each GELU then BatchNorm `bn<i>`), averaged; the whole-map mean, a
    bias-free Dense pair `fc1` / `fc2` through ReLU, and an exp(sigmoid)
    channel gate (layers.py:2765). The GELU is flax's default, the tanh form,
    in every dtype (SEAM's is exact in f32)."""

    def __init__(self, c1: int):
        super().__init__()
        for i, d in enumerate((1, 2, 3)):
            setattr(self, f"dcov{i}", ConvRaw(c1, c1, 3, 1, d, dilation=d, groups=c1))
            setattr(self, f"bn{i}", FlaxBatchNorm2d(c1, eps=BN_EPS, momentum=BN_MOMENTUM))
        self.fc1 = nn.Linear(c1, max(c1 // 16, 1), bias=False)
        self.fc2 = nn.Linear(max(c1 // 16, 1), c1, bias=False)

    def forward(self, x):
        refuse_strip(self)
        outs = [getattr(self, f"bn{i}")(F.gelu(getattr(self, f"dcov{i}")(x), approximate="tanh")) for i in range(3)]
        y = (outs[0] + outs[1] + outs[2]) / 3.0
        v = self.fc2(torch.relu(self.fc1(y.mean((2, 3)))))
        return x * torch.exp(torch.sigmoid(v))[:, :, None, None]


class BiFPNAdd(nn.Module):
    """Weighted add of the first `n` inputs + a biased 1x1 conv `conv`
    (BiFPN_Add2 / BiFPN_Add3, layers.py:755, :770): w = relu(`w`),
    normalised by its sum + 1e-4 in float32 and cast to the inputs' dtype,
    then SiLU before the conv."""

    n = 2

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.w = nn.Parameter(torch.ones(self.n))
        self.conv = ConvRaw(c1, c2, 1)

    def forward(self, xs: List[torch.Tensor]):
        check_aligned(xs[:self.n])
        w = torch.relu(self.w.float())
        wn = (w / (w.sum() + 1e-4)).to(xs[0].dtype)
        y = wn[0] * xs[0]
        for i in range(1, self.n):
            y = y + wn[i] * xs[i]
        return self.conv(F.silu(y))


class BiFPN_Add2(BiFPNAdd):
    n = 2


class BiFPN_Add3(BiFPNAdd):
    n = 3


class CrossConv(nn.Module):
    """Cross convolution (layers.py:1421): Conv 1 x k at stride (1, s), then
    Conv k x 1 at stride (s, 1) grouped by g, and the residual where
    `shortcut` and c1 == c2."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, g: int = 1, e: float = 1.0,
                 shortcut: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, (1, k), (1, s))
        self.cv2 = Conv(c_, c2, (k, 1), (s, 1), g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


def mix_splits(c2: int, n: int) -> List[int]:
    """MixConv2d's output channels per kernel size: the linspace-floor
    buckets of the equal-channel split (layers.py:1477-1478)."""
    idx = np.floor(np.linspace(0, n - 1e-6, c2))
    return [int((idx == g).sum()) for g in range(n)]


class MixConv2d(nn.Module):
    """Mixed-kernel conv (layers.py:1464): one bias-free conv `m<i>` per
    kernel size (groups gcd(c1, its channels), 'same' padding, stride s),
    concatenated, then one BatchNorm `bn` (eps 1e-3) and SiLU."""

    def __init__(self, c1: int, c2: int, k: Sequence[int] = (1, 3), s: int = 1):
        super().__init__()
        self.m = nn.ModuleList(ConvRaw(c1, c, kk, s, kk // 2, groups=math.gcd(c1, c), bias=False)
                               for c, kk in zip(mix_splits(c2, len(k)), k))
        self.bn = FlaxBatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x):
        return F.silu(self.bn(torch.cat([m(x) for m in self.m], 1)))


class GSConv(nn.Module):
    """Slim-neck GSConv (layers.py:1572): Conv to c2 / 2, a 5x5 depthwise
    Conv of that beside it, and the channel shuffle of the NHWC
    reshape(..., 2, c / 2) transpose: output channel 2j + i is input channel
    i * c / 2 + j."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1, act: bool = True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_, k, s, g=g, act=act)
        self.cv2 = Conv(c_, c_, 5, 1, g=c_, act=act)

    def forward(self, x):
        y1 = self.cv1(x)
        y = torch.cat([y1, self.cv2(y1)], 1)
        b, c, h, w = y.shape
        y = y.permute(0, 2, 3, 1).reshape(b, h, w, 2, c // 2).transpose(3, 4).reshape(b, h, w, c)
        return y.permute(0, 3, 1, 2)


class C3SE(C3):
    """C3 whose bottlenecks `m<i>` each feed an SE gate `se<i>` (layers.py:1491)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e)
        self.se = nn.ModuleList(SE(int(c2 * e)) for _ in range(n))

    def forward(self, x):
        y = self.cv1(x)
        for m, gate in zip(self.m, self.se):
            y = gate(m(y))
        return self.cv3(torch.cat([y, self.cv2(x)], 1))


class C3ECA(C3):
    """C3 whose bottlenecks `m<i>` each feed an ECA gate `eca<i>` (b 1,
    gamma 2; layers.py:1507)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e)
        self.eca = nn.ModuleList(ECA(int(c2 * e)) for _ in range(n))

    def forward(self, x):
        y = self.cv1(x)
        for m, gate in zip(self.m, self.eca):
            y = gate(m(y))
        return self.cv3(torch.cat([y, self.cv2(x)], 1))


class C3SPP(C3):
    """C3 whose stack is one SPP (5, 9, 13) `m`, whatever n (layers.py:1523)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, 0, shortcut, g, e)
        self.m = SPP(int(c2 * e), int(c2 * e), (5, 9, 13))


class C3x(C3):
    """C3 with CrossConv (k 3, s 1, e 1) bottlenecks (layers.py:1537)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e, block=lambda c: CrossConv(c, c, 3, 1, g, 1.0, shortcut))


class RepC3(nn.Module):
    """RT-DETR's RepC3 (layers.py:1550): cv1 then n 3x3 Convs `m<i>`, plus
    cv2 of the input, summed; cv3 (no activation) to c2 only where the
    hidden width c2 * e is not c2."""

    def __init__(self, c1: int, c2: int, n: int = 3, e: float = 1.0):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.m = nn.Sequential(*(Conv(c_, c_, 3, 1) for _ in range(n)))
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(c_, c2, 1, 1, act=False) if c_ != c2 else nn.Identity()

    def forward(self, x):
        return self.cv3(self.m(self.cv1(x)) + self.cv2(x))


class SPPCSPC(nn.Module):
    """YOLOv7's CSP SPP (layers.py:1212), c_ = int(2 c2 e): cv1, cv3, cv4,
    the map beside its stride-1 max-pools of each size in k, cv5, cv6;
    beside cv2 of the input; cv7 of both."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, g: int = 1, e: float = 0.5,
                 k: Sequence[int] = (5, 9, 13)):
        super().__init__()
        c_ = int(2 * c2 * e)
        self.k = tuple(k)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(c_, c_, 3, 1)
        self.cv4 = Conv(c_, c_, 1, 1)
        self.cv5 = Conv(c_ * (len(self.k) + 1), c_, 1, 1)
        self.cv6 = Conv(c_, c_, 3, 1)
        self.cv7 = Conv(2 * c_, c2, 1, 1)

    def forward(self, x):
        x1 = self.cv4(self.cv3(self.cv1(x)))
        y1 = self.cv6(self.cv5(torch.cat([x1] + [max_pool(x1, k) for k in self.k], 1)))
        return self.cv7(torch.cat([y1, self.cv2(x)], 1))


class SPD(nn.Module):
    """SPD-Conv's space-to-depth by 2 (layers.py:1594): the phases (0, 0),
    (0, 1), (1, 0), (1, 1) by (row, column), concatenated on the channels
    in that order (the JAX package's, not the usual SPD-Conv torch order)."""

    def forward(self, x):
        refuse_strip(self)
        return torch.cat([x[..., i::2, j::2] for i in range(2) for j in range(2)], 1)


class Expand(nn.Module):
    """Depth-to-space by `gain` (layers.py:1040): (B, C, H, W) -> (B, C/g²,
    H g, W g), input channel (gy g + gx) C/g² + c to output channel c at
    (g y + gy, g x + gx), as the NHWC reshape; the work runs on the NHWC
    view, as Contract's does."""

    def __init__(self, gain: int = 2):
        super().__init__()
        self.gain = gain

    def forward(self, x):
        refuse_strip(self)
        b, c, h, w = x.shape
        g = self.gain
        y = x.permute(0, 2, 3, 1).reshape(b, h, w, g, g, c // (g * g)).transpose(2, 3)
        return y.reshape(b, h * g, w * g, c // (g * g)).permute(0, 3, 1, 2)


class CARAFE(nn.Module):
    """Content-aware upsampling (layers.py:1822): `comp` (1x1 Conv to
    c_mid) and `enc` (k_enc Conv to (scale k_up)², no activation) predict a
    reassembly kernel per source pixel; pixel-shuffled to the upsampled
    grid (channels split (k_up², s, s), channel-major), softmax in float32;
    each output pixel is the kernel-weighted sum of the k_up x k_up
    neighbourhood, dilated by scale, of the nearest-upsampled input
    (F.unfold's (c, kh, kw) order is the JAX package's `_patches`)."""

    def __init__(self, c1: int, k_enc: int = 3, k_up: int = 5, c_mid: int = 64, scale: int = 2):
        super().__init__()
        if scale != 2:
            raise NotImplementedError(f"CARAFE at scale {scale}: the graph compiler records the row's stride as "
                                      "its input's / 2, as the JAX package's does")
        self.k_up, self.scale = k_up, scale
        self.comp = Conv(c1, c_mid, 1)
        self.enc = Conv(c_mid, (scale * k_up) ** 2, k_enc, act=False)

    def forward(self, x):
        refuse_strip(self)
        b, c, h, w = x.shape
        s, k = self.scale, self.k_up
        kernel = F.pixel_shuffle(self.enc(self.comp(x)), s)  # (b, k², h s, w s)
        kernel = torch.softmax(kernel.float(), 1).to(x.dtype)
        up = F.interpolate(x, scale_factor=s, mode="nearest")
        patches = F.unfold(up, k, dilation=s, padding=(k - 1) // 2 * s).view(b, c, k * k, h * s, w * s)
        out = torch.einsum("bkhw,bckhw->bchw", kernel, patches)
        return out.contiguous(memory_format=torch.channels_last)


def bilinear_sample(img: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """The JAX package's `_bilinear_sample` (layers.py:1855) batched: img
    (N, C, H, W), px / py (N, P) pixel coordinates (x right, y down),
    clamped to the border; returns (N, C, P) in float32, the four corners
    weighted as JAX weighs them."""
    n, c, H, W = img.shape
    px = px.clamp(0.0, W - 1.0)
    py = py.clamp(0.0, H - 1.0)
    x0, y0 = px.floor(), py.floor()
    wx, wy = (px - x0)[:, None], (py - y0)[:, None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
    flat = img.float().reshape(n, c, H * W)

    def at(yi, xi):
        return torch.gather(flat, 2, (yi * W + xi)[:, None].expand(-1, c, -1))

    return (at(y0, x0) * (1 - wx) * (1 - wy) + at(y0, x1) * wx * (1 - wy) + at(y1, x0) * (1 - wx) * wy
            + at(y1, x1) * wx * wy)


class DySample(nn.Module):
    """Dynamic-offset upsampling, 'lp' style (layers.py:1876): a biased 1x1
    conv `offset` predicts 2 g s² offsets a pixel (laid out (2, g, s²),
    x then y), x 0.25 plus the sub-pixel grid of the s x s cells; each
    channel group is sampled bilinearly, border-clamped, at its own
    coordinates (the sampling runs in float32, the output is cast back).
    The offsets are unbounded: no strip path."""

    def __init__(self, c1: int, scale: int = 2, groups: int = 4):
        super().__init__()
        if c1 % groups:
            raise ValueError(f"DySample: {c1} channels do not split into {groups} groups")
        self.scale, self.groups = scale, groups
        self.offset = ConvRaw(c1, 2 * groups * scale * scale, 1)

    def forward(self, x):
        refuse_strip(self)
        b, c, h, w = x.shape
        s, g = self.scale, self.groups
        off = self.offset(x).float() * 0.25
        grid = (torch.arange(s, dtype=torch.float32, device=x.device) - (s - 1) / 2) / s
        iy, ix = torch.meshgrid(grid, grid, indexing="ij")
        init = torch.stack([ix, iy], 0).reshape(1, 2, 1, s * s, 1, 1)
        off = off.reshape(b, 2, g, s * s, h, w) + init
        cx = torch.arange(w, dtype=torch.float32, device=x.device) + 0.5
        cy = torch.arange(h, dtype=torch.float32, device=x.device) + 0.5
        px = off[:, 0] + cx - 0.5  # (b, g, s², h, w)
        py = off[:, 1] + cy[:, None] - 0.5

        def shuffle(o):  # the s x s cells onto the upsampled grid: (b g, h s w s)
            return o.reshape(b, g, s, s, h, w).permute(0, 1, 4, 2, 5, 3).reshape(b * g, h * s * w * s)

        out = bilinear_sample(x.reshape(b * g, c // g, h, w), shuffle(px), shuffle(py))
        return out.reshape(b, c, h * s, w * s).to(x.dtype).contiguous(memory_format=torch.channels_last)


class Involution(nn.Module):
    """Involution (layers.py:1921): per-pixel kernels over groups of 16
    channels, generated by `conv1` (Conv to c / 4, on the stride x stride
    average pool when stride > 1) and `conv2` (Conv to k² groups), applied
    to the input's k x k patches at the stride. Channel-preserving."""

    def __init__(self, c1: int, kernel_size: int = 3, stride: int = 1):
        super().__init__()
        self.k, self.stride = kernel_size, stride
        self.groups = c1 // 16
        self.conv1 = Conv(c1, c1 // 4, 1)
        self.conv2 = Conv(c1 // 4, kernel_size ** 2 * self.groups, 1)

    def forward(self, x):
        refuse_strip(self)
        b, c, h, w = x.shape
        k, s, g = self.k, self.stride, self.groups
        weight = self.conv2(self.conv1(x if s == 1 else F.avg_pool2d(x, s, s)))
        ho, wo = weight.shape[2:]
        patches = F.unfold(x, k, padding=(k - 1) // 2, stride=s).view(b, g, 16, k * k, ho, wo)
        out = (weight.reshape(b, g, 1, k * k, ho, wo) * patches).sum(3)
        return out.reshape(b, c, ho, wo).contiguous(memory_format=torch.channels_last)


class ZoomCat(nn.Module):
    """Zoom_cat (layers.py:2163): of the (large, middle, small) maps, the
    large one max-pooled plus average-pooled down to the middle's size, the
    middle one, and the small one repeated (nearest) up to it, concatenated
    on the channels. The output lies at the middle map's resolution."""

    def forward(self, xs: List[torch.Tensor]):
        refuse_strip(self)
        big, mid, small = xs
        th, tw = mid.shape[2:]
        kern = (big.shape[2] // th, big.shape[3] // tw)
        lm = F.max_pool2d(big, kern, kern) + F.avg_pool2d(big, kern, kern)
        sm = F.interpolate(small, size=(th, tw), mode="nearest")
        return torch.cat([lm, mid, sm], 1)


def strip_halo(model: nn.Module) -> int:
    """The most rows any operator of `model` asks of a neighbouring strip
    under spatial sharding (parallel.spatial.strip_plan holds the strips
    to at least this many rows at the coarsest level)."""
    halo = 0
    for m in model.modules():
        if isinstance(m, HaloConv2d):
            halo = max(halo, m.halo())
        elif isinstance(m, (SPP, SPPF)):
            halo = max(halo, max(m.k if isinstance(m, SPP) else (m.k,)) // 2)
        elif isinstance(m, ODConv2d) and m.uses_kernel:
            halo = max(halo, 2)
        elif isinstance(m, MaxPool2d):
            halo = max(halo, m.halo())
        elif isinstance(m, ZeroPad2d):
            halo = max(halo, *m.pads[2:])
    return halo


# ---------------------------------------------------------------------------
# layers.py's attention family, LSKA / SPPF_LSKA, the Swin and HorNet blocks
# and the RFEM / EVC family (yolosomi_tpu/models/layers.py:1310-1406,
# :1765-1805, :1951-2163, :2186-2760). Several of them work on the NHWC
# tensor as the JAX package does (a Dense over the channels, reshapes of
# the NHWC array); these take `x.permute(0, 2, 3, 1)`, which is the
# channels_last memory itself, and hand back its permute. The f32 islands
# of the JAX package (softmaxes, some einsums, TridentBlock's convs) run in
# at least float32 (float64 stays float64) with autocast off. None of them
# has a strip path: those that reduce over the whole map, attend across
# it or convolve without a halo refuse a strip.
# ---------------------------------------------------------------------------


def wide(x: torch.Tensor) -> torch.Tensor:
    """`x` in at least float32: float64 stays float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


@contextlib.contextmanager
def no_autocast(x: torch.Tensor):
    """Autocast off on `x`'s device: the JAX package's f32 einsums and convs."""
    with torch.autocast(x.device.type, enabled=False):
        yield


def raw_conv(c1: int, c2: int, k, s: int = 1, g: int = 1, d: int = 1, p=None, bias: bool = True) -> ConvRaw:
    """A bare ConvRaw with the JAX package's padding: k // 2 of the dilated
    kernel per axis unless `p` is given (layers.py:91)."""
    kk = (k, k) if isinstance(k, int) else tuple(k)
    pad = tuple((d * (x - 1) + 1) // 2 for x in kk) if p is None else p
    return ConvRaw(c1, c2, kk, s, pad, dilation=d, groups=g, bias=bias)


def nhwc_conv(conv: nn.Module, t: torch.Tensor) -> torch.Tensor:
    """`conv` of an NHWC tensor, as an NHWC tensor."""
    return conv(t.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _flax_normalize(x: torch.Tensor, dims, eps: float, fast: bool, scale, bias, shape) -> torch.Tensor:
    """flax.linen's normalization: the statistics over `dims` in at least
    float32, the variance E[x²] - E[x]² clipped at 0 where `fast` (flax's
    default) or E[(x - mean)²], then (x - mean) * (rsqrt(var + eps) *
    scale) + bias, cast back to x's dtype."""
    xf = wide(x)
    mean = xf.mean(dims, keepdim=True)
    if fast:
        var = (xf.square().mean(dims, keepdim=True) - mean.square()).clamp_min(0)
    else:
        var = (xf - mean).square().mean(dims, keepdim=True)
    mul = torch.rsqrt(var + eps) * scale.to(xf.dtype).view(shape)
    return ((xf - mean) * mul + bias.to(xf.dtype).view(shape)).to(x.dtype)


class FlaxLayerNorm(nn.LayerNorm):
    """flax.linen.LayerNorm over the channel axis `dim` (eps 1e-6 and the
    fast variance unless given)."""

    def __init__(self, c: int, eps: float = 1e-6, dim: int = -1):
        super().__init__(c, eps=eps)
        self.dim = dim

    def forward(self, x):
        shape = [1] * x.dim()
        shape[self.dim] = -1
        return _flax_normalize(x, [self.dim], self.eps, True, self.weight, self.bias, shape)


class FlaxGroupNorm(nn.GroupNorm):
    """flax.linen.GroupNorm (eps 1e-6 and the fast variance unless given)
    on an NCHW tensor, or on an NHWC one with `nhwc`: per sample, over the
    map and each group's channels."""

    def __init__(self, groups: int, c: int, eps: float = 1e-6, fast: bool = True):
        super().__init__(groups, c, eps=eps)
        self.fast = fast

    def forward(self, x, nhwc: bool = False):
        t = x if nhwc else x.movedim(1, -1)
        shape = t.shape
        g = t.reshape(shape[0], -1, self.num_groups, shape[-1] // self.num_groups)
        y = _flax_normalize(g, [1, 3], self.eps, self.fast, self.weight.view(self.num_groups, -1),
                            self.bias.view(self.num_groups, -1), (1, 1, self.num_groups, -1)).reshape(shape)
        return y if nhwc else y.movedim(-1, 1)


def adaptive_avg_pool(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """The JAX package's `_adaptive_avg_pool` (layers.py:2442) on NCHW: the
    map itself at its own size, the mean of whole blocks where the size
    divides, else jax.image.resize's linear resize, which antialiases when
    it shrinks (F.interpolate's antialiased bilinear, in at least float32)."""
    b, c, h, w = x.shape
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    if h % oh == 0 and w % ow == 0:
        return x.reshape(b, c, oh, h // oh, ow, w // ow).mean((3, 5))
    return resize_linear(x, (oh, ow))


def resize_linear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """jax.image.resize(..., "linear") of an NCHW map: half-pixel centres,
    antialiased when it shrinks, in at least float32, cast back."""
    y = F.interpolate(wide(x), size=tuple(out_hw), mode="bilinear", align_corners=False, antialias=True)
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


class GAMAttention(nn.Module):
    """Global attention (layers.py:1310): a Dense pair `fc1` / `fc2` (c / rate)
    over the channels of every pixel gates x, then two biased 7x7 convs
    `sp1` / `sp2` each with a BatchNorm `bn1` / `bn2` (eps 1e-3) gate it
    again. The row's c2 slot does not enter the block."""

    def __init__(self, c1: int, rate: int = 4):
        super().__init__()
        mid = max(c1 // rate, 1)
        self.fc1 = nn.Linear(c1, mid)
        self.fc2 = nn.Linear(mid, c1)
        self.sp1 = raw_conv(c1, mid, 7)
        self.bn1 = FlaxBatchNorm2d(mid, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.sp2 = raw_conv(mid, c1, 7)
        self.bn2 = FlaxBatchNorm2d(c1, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x):
        v = self.fc2(torch.relu(self.fc1(x.permute(0, 2, 3, 1)))).permute(0, 3, 1, 2)
        x = x * torch.sigmoid(v)
        s = self.bn2(self.sp2(torch.relu(self.bn1(self.sp1(x)))))
        return x * torch.sigmoid(s)


class SKAttention(nn.Module):
    """Selective-kernel attention (layers.py:1336): a Conv `k<k>` per kernel
    size, summed; the whole-map mean through Dense `fc` (max(c / reduction,
    32)) and one Dense `fc_<k>` per branch; the softmax across the branches
    weighs them."""

    def __init__(self, c1: int, kernels: Sequence[int] = (1, 3, 5, 7), reduction: int = 16):
        super().__init__()
        self.kernels = tuple(kernels)
        mid = max(c1 // reduction, 32)
        for k in self.kernels:
            setattr(self, f"k{k}", Conv(c1, c1, k, 1))
        self.fc = nn.Linear(c1, mid)
        for k in self.kernels:
            setattr(self, f"fc_{k}", nn.Linear(mid, c1))

    def forward(self, x):
        refuse_strip(self)
        branches = [getattr(self, f"k{k}")(x) for k in self.kernels]
        z = self.fc(sum(branches).mean((2, 3)))
        attn = torch.softmax(torch.stack([getattr(self, f"fc_{k}")(z) for k in self.kernels], 0), 0)
        return sum(a[:, :, None, None] * b for a, b in zip(attn, branches))


class ShuffleAttention(nn.Module):
    """Shuffle attention (layers.py:1360): the channels in `groups` groups
    of 2 cg; the first cg of each gated by its whole-map mean, the other cg
    by its GroupNorm `gn` (eps 1e-5, two-pass variance), each through its
    (1, 1, 1, g, cg) `cweight` / `cbias` or `sweight` / `sbias`; then the
    channel shuffle (g, 2) -> (2, g)."""

    flax_shaped = ("cweight", "cbias", "sweight", "sbias")

    def __init__(self, c1: int, groups: int = 8):
        super().__init__()
        self.groups = groups
        cg = c1 // (2 * groups)
        self.cweight = nn.Parameter(torch.zeros(1, 1, 1, groups, cg))
        self.cbias = nn.Parameter(torch.ones(1, 1, 1, groups, cg))
        self.sweight = nn.Parameter(torch.zeros(1, 1, 1, groups, cg))
        self.sbias = nn.Parameter(torch.ones(1, 1, 1, groups, cg))
        self.gn = FlaxGroupNorm(groups, groups * cg, eps=1e-5, fast=False)

    def forward(self, x):
        refuse_strip(self)
        t = x.permute(0, 2, 3, 1)
        b, h, w, c = t.shape
        g = self.groups
        cg = c // (2 * g)
        xg = t.reshape(b, h, w, g, 2 * cg)
        x0, x1 = xg[..., :cg], xg[..., cg:]
        x0 = x0 * torch.sigmoid(x0.mean((1, 2), keepdim=True) * self.cweight + self.cbias)
        gn = self.gn(x1.reshape(b, h, w, g * cg), nhwc=True).reshape(b, h, w, g, cg)
        x1 = x1 * torch.sigmoid(gn * self.sweight + self.sbias)
        out = torch.cat([x0, x1], -1).reshape(b, h, w, g, 2, cg).transpose(3, 4).reshape(b, h, w, c)
        return out.permute(0, 3, 1, 2)


class NAMAttention(nn.Module):
    """Normalization-based attention (layers.py:1393): a BatchNorm `bn`
    without scale or bias (eps 1e-3), then its own `gamma` / `beta`, each
    channel weighted by |gamma| / sum |gamma| * c, a sigmoid gate."""

    def __init__(self, c1: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(c1))
        self.beta = nn.Parameter(torch.zeros(c1))
        self.bn = FlaxBatchNorm2d(c1, eps=BN_EPS, momentum=BN_MOMENTUM, affine=False)

    def forward(self, x):
        y = self.bn(x) * self.gamma[:, None, None] + self.beta[:, None, None]
        g = self.gamma.abs()
        wn = g / (g.sum() + 1e-12) * x.shape[1]
        return x * torch.sigmoid(y * wn[:, None, None])


class EMAAttention(nn.Module):
    """Efficient multi-scale attention (layers.py:2390). The NHWC array is
    reshaped to (b * factor, h, w, c / factor) as the JAX package does: its
    memory cut into bands of h / factor rows (not channel groups), each a
    map of c / factor channels. On each: the h- and w-profiles through a
    biased 1x1 `conv1x1`, sigmoid gates, GroupNorm `gn` (one group a
    channel, eps 1e-6); a biased 3x3 `conv3x3` beside it; the two softmaxed
    channel means cross-weigh the pixels."""

    def __init__(self, c1: int, factor: int = 8):
        super().__init__()
        self.factor = factor
        cg = c1 // factor
        self.conv1x1 = raw_conv(cg, cg, 1)
        self.conv3x3 = raw_conv(cg, cg, 3)
        self.gn = FlaxGroupNorm(cg, cg)

    def forward(self, x):
        refuse_strip(self)
        b, c, h, w = x.shape
        g = self.factor
        cg = c // g
        xg = x.permute(0, 2, 3, 1).reshape(b * g, h, w, cg)
        hw = torch.cat([xg.mean(2), xg.mean(1)], 1)[:, :, None, :]  # (bg, h + w, 1, cg)
        hw = nhwc_conv(self.conv1x1, hw)[:, :, 0]
        gated = xg * torch.sigmoid(hw[:, :h])[:, :, None, :] * torch.sigmoid(hw[:, h:])[:, None, :, :]
        x1 = self.gn(gated, nhwc=True)
        x2 = nhwc_conv(self.conv3x3, xg)
        a11 = torch.softmax(x1.mean((1, 2)), -1)[:, None, :]
        a21 = torch.softmax(x2.mean((1, 2)), -1)[:, None, :]
        weights = (torch.einsum("bkc,bnc->bn", a11, x2.reshape(b * g, h * w, cg))
                   + torch.einsum("bkc,bnc->bn", a21, x1.reshape(b * g, h * w, cg))).reshape(b * g, h, w, 1)
        return (xg * torch.sigmoid(weights)).reshape(b, h, w, c).permute(0, 3, 1, 2)


class LSKblock(nn.Module):
    """Large-selective-kernel gating (layers.py:2421): a 5x5 depthwise
    `conv0`, a 7x7 depthwise `conv_spatial` dilated 3 after it, each to c / 2
    by `conv1` / `conv2`; their channel mean and max through the 7x7
    `conv_squeeze` weigh them; `conv` back to c gates x. All biased."""

    def __init__(self, c1: int):
        super().__init__()
        self.conv0 = raw_conv(c1, c1, 5, g=c1)
        self.conv_spatial = raw_conv(c1, c1, 7, g=c1, d=3)
        self.conv1 = raw_conv(c1, c1 // 2, 1)
        self.conv2 = raw_conv(c1, c1 // 2, 1)
        self.conv_squeeze = raw_conv(2, 2, 7)
        self.conv = raw_conv(c1 // 2, c1, 1)

    def forward(self, x):
        a1 = self.conv0(x)
        a2 = self.conv_spatial(a1)
        a1, a2 = self.conv1(a1), self.conv2(a2)
        attn = torch.cat([a1, a2], 1)
        sig = torch.sigmoid(self.conv_squeeze(torch.cat([attn.mean(1, keepdim=True), attn.amax(1, keepdim=True)], 1)))
        return x * self.conv(a1 * sig[:, 0:1] + a2 * sig[:, 1:2])


class MLCA(nn.Module):
    """Mixed local-channel attention (layers.py:2453): the map pooled to
    local_size x local_size (adaptive_avg_pool: block means where the size
    divides, the antialiased linear resize otherwise) and its mean; a 1-D
    conv of k taps (k odd from log2(c), b and gamma) along the channels of
    each (`conv_local`, `conv`: flax (1, k, 1, 1) kernels, (1, 1, 1, k)
    here), in at least float32; the sigmoids mixed by local_weight and
    resized (linear) to the map gate x."""

    hwio = ("conv_local", "conv")

    def __init__(self, c1: int, local_size: int = 5, gamma: int = 2, b: int = 1, local_weight: float = 0.5):
        super().__init__()
        self.local_size, self.local_weight = local_size, local_weight
        t = int(abs(math.log2(c1) + b) / gamma)
        k = max(t if t % 2 else t + 1, 1)
        self.conv_local = nn.Parameter(torch.zeros(1, 1, 1, k))
        self.conv = nn.Parameter(torch.zeros(1, 1, 1, k))

    def _conv1d(self, v: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:  # (n, c) -> (n, c)
        k = kern.shape[-1]
        with no_autocast(v):
            return F.conv2d(wide(v)[:, None, None, :], wide(kern), padding=(0, (k - 1) // 2))[:, 0, 0, :]

    def forward(self, x):
        refuse_strip(self)
        b, c, h, w = x.shape
        ls = self.local_size
        local = adaptive_avg_pool(x, (ls, ls))
        glob = local.mean((2, 3))
        y_local = self._conv1d(local.permute(0, 2, 3, 1).reshape(-1, c), self.conv_local).reshape(b, ls, ls, c)
        y_global = self._conv1d(glob, self.conv)
        att = torch.sigmoid(y_global)[:, None, None, :] * (1 - self.local_weight) \
            + torch.sigmoid(y_local) * self.local_weight
        return x * resize_linear(att.permute(0, 3, 1, 2), (h, w)).to(x.dtype)


class TripletAttention(nn.Module):
    """Triplet attention (layers.py:2493): three gates, each the channel
    max and mean of a view of the NHWC array through a bias-free 7x7 conv
    and a sigmoid: `cw` on the array, `hc` on its (b, c, w, h) transpose and
    `wc` on its (b, h, c, w) one (their kernels run over (c, w) and (h, c)),
    averaged."""

    def __init__(self, c1: int):
        super().__init__()
        self.cw = raw_conv(2, 1, 7, bias=False)
        self.hc = raw_conv(2, 1, 7, bias=False)
        self.wc = raw_conv(2, 1, 7, bias=False)

    @staticmethod
    def _gate(t: torch.Tensor, conv: nn.Module) -> torch.Tensor:  # NHWC
        z = torch.cat([t.amax(-1, keepdim=True), t.mean(-1, keepdim=True)], -1)
        return t * torch.sigmoid(nhwc_conv(conv, z))

    def forward(self, x):
        refuse_strip(self)
        t = x.permute(0, 2, 3, 1)
        b1 = self._gate(t, self.cw)
        b2 = self._gate(t.permute(0, 3, 2, 1), self.hc).permute(0, 3, 2, 1)
        b3 = self._gate(t.permute(0, 1, 3, 2), self.wc).permute(0, 1, 3, 2)
        return ((b1 + b2 + b3) / 3.0).permute(0, 3, 1, 2)


class GlobalContextBlock(nn.Module):
    """GCNet's context block (layers.py:2516): a biased 1x1 `conv_mask`
    softmaxed over the map weighs the pixels (in at least float32), then
    Dense `fc1` (c ratio), LayerNorm `ln` (eps 1e-6), ReLU, Dense `fc2`,
    added to every pixel."""

    def __init__(self, c1: int, ratio: float = 0.25):
        super().__init__()
        hid = max(int(c1 * ratio), 1)
        self.conv_mask = raw_conv(c1, 1, 1)
        self.fc1 = nn.Linear(c1, hid)
        self.ln = FlaxLayerNorm(hid)
        self.fc2 = nn.Linear(hid, c1)

    def forward(self, x):
        refuse_strip(self)
        b, c, h, w = x.shape
        with no_autocast(x):
            ctx_w = torch.softmax(wide(self.conv_mask(x)).reshape(b, h * w), 1)
            ctx = torch.einsum("bn,bnc->bc", ctx_w, wide(x).permute(0, 2, 3, 1).reshape(b, h * w, c))
        t = self.fc2(torch.relu(self.ln(self.fc1(ctx.to(x.dtype)))))
        return x + t[:, :, None, None]


class SpatialGroupEnhance(nn.Module):
    """SGE (layers.py:2621). The NHWC array is reshaped to (b * groups, h,
    w, c / groups) as the JAX package does (bands of rows, not channel
    groups); each pixel's channel sum of x * its map mean is standardized
    over the map (population std, + 1e-5), reshaped (b, h, w, groups) across
    the bands, scaled by `weight` and shifted by `bias` ((1, 1, 1, groups)
    each), and gates the band."""

    flax_shaped = ("weight", "bias")

    def __init__(self, c1: int, groups: int = 8):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(1, 1, 1, groups))
        self.bias = nn.Parameter(torch.zeros(1, 1, 1, groups))

    def forward(self, x):
        refuse_strip(self)
        b, c, h, w = x.shape
        g = self.groups
        xg = x.permute(0, 2, 3, 1).reshape(b * g, h, w, c // g)
        t = (xg * xg.mean((1, 2), keepdim=True)).sum(-1, keepdim=True)
        t = (t - t.mean((1, 2), keepdim=True)) / (t.std((1, 2), keepdim=True, correction=0) + 1e-5)
        t = (t.reshape(b, h, w, g) * self.weight + self.bias).reshape(b * g, h, w, 1)
        return (xg * torch.sigmoid(t)).reshape(b, h, w, c).permute(0, 3, 1, 2)


class ELA(nn.Module):
    """Efficient local attention (layers.py:2727): the h-profile (mean over
    W) through a bias-free depthwise (7, 1) `conv_h` and GroupNorm `gn`, the
    w-profile through (1, 7) `conv_w` and `gn2` (16 groups where c divides,
    else 1; eps 1e-6), sigmoid gates along H and W."""

    def __init__(self, c1: int):
        super().__init__()
        groups = 16 if c1 % 16 == 0 else 1
        self.conv_h = raw_conv(c1, c1, (7, 1), g=c1, bias=False)
        self.conv_w = raw_conv(c1, c1, (1, 7), g=c1, bias=False)
        self.gn = FlaxGroupNorm(groups, c1)
        self.gn2 = FlaxGroupNorm(groups, c1)

    def forward(self, x):
        refuse_strip(self)
        ah = torch.sigmoid(self.gn(self.conv_h(x.mean(3, keepdim=True))))
        aw = torch.sigmoid(self.gn2(self.conv_w(x.mean(2, keepdim=True))))
        return x * ah * aw


class MSCAAttention(nn.Module):
    """SegNeXt's multi-scale strip-conv attention (layers.py:2746): a 5x5
    depthwise `conv0`, then for k in 7, 11, 21 a depthwise (1, k) `conv<i>_1`
    and (k, 1) `conv<i>_2` added on in turn, a 1x1 `conv3`; it gates x. All
    biased."""

    def __init__(self, c1: int):
        super().__init__()
        self.conv0 = raw_conv(c1, c1, 5, g=c1)
        for i, k in enumerate((7, 11, 21)):
            setattr(self, f"conv{i}_1", raw_conv(c1, c1, (1, k), g=c1))
            setattr(self, f"conv{i}_2", raw_conv(c1, c1, (k, 1), g=c1))
        self.conv3 = raw_conv(c1, c1, 1)

    def forward(self, x):
        a = self.conv0(x)
        for i in range(3):
            a = a + getattr(self, f"conv{i}_2")(getattr(self, f"conv{i}_1")(a))
        return x * self.conv3(a)


class LSKA(nn.Module):
    """Large separable kernel attention (layers.py:1765): depthwise (1, k)
    `dw_h` and (k, 1) `dw_v`, the dilated pair `dwd_h` / `dwd_v`, a 1x1
    `conv1` (all biased), gating x; (k, dilated k, dilation) from k_size by
    the JAX package's table."""

    CFG = {7: (3, 3, 2), 11: (3, 5, 2), 23: (5, 7, 3), 35: (5, 11, 3), 41: (5, 13, 3), 53: (5, 17, 3)}

    def __init__(self, c1: int, k_size: int = 11):
        super().__init__()
        if k_size not in self.CFG:
            raise KeyError(f"LSKA k_size {k_size} is not one of {sorted(self.CFG)}")
        bk, dk, dil = self.CFG[k_size]
        self.dw_h = raw_conv(c1, c1, (1, bk), g=c1)
        self.dw_v = raw_conv(c1, c1, (bk, 1), g=c1)
        self.dwd_h = raw_conv(c1, c1, (1, dk), g=c1, d=dil)
        self.dwd_v = raw_conv(c1, c1, (dk, 1), g=c1, d=dil)
        self.conv1 = raw_conv(c1, c1, 1)

    def forward(self, x):
        return x * self.conv1(self.dwd_v(self.dwd_h(self.dw_v(self.dw_h(x)))))


class SPPF_LSKA(nn.Module):
    """SPPF with LSKA (k_size 11) on the pooled concatenation (layers.py:1788):
    cv1 to c1 / 2, three chained k x k stride-1 max-pools, `lska`, cv2."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.k = k
        self.cv1 = Conv(c1, c_, 1, 1)
        self.lska = LSKA(4 * c_, 11)
        self.cv2 = Conv(4 * c_, c2, 1, 1)

    def forward(self, x):
        x = self.cv1(x)
        y1 = max_pool(x, self.k)
        y2 = max_pool(y1, self.k)
        return self.cv2(self.lska(torch.cat([x, y1, y2, max_pool(y2, self.k)], 1)))


class NonLocalBlock(nn.Module):
    """Embedded-Gaussian non-local block (layers.py:2536): biased 1x1
    `theta`, `phi`, `g` to c / 2, the (hw x hw) affinity softmaxed in at least
    float32 and cast back, then `out` back to c, with the residual."""

    def __init__(self, c1: int):
        super().__init__()
        inter = max(c1 // 2, 1)
        self.theta = raw_conv(c1, inter, 1)
        self.phi = raw_conv(c1, inter, 1)
        self.g = raw_conv(c1, inter, 1)
        self.out = raw_conv(inter, c1, 1)

    def forward(self, x):
        refuse_strip(self)
        b, c, h, w = x.shape
        flat = lambda t: t.permute(0, 2, 3, 1).reshape(b, h * w, -1)  # noqa: E731
        logits = flat(self.theta(x)) @ flat(self.phi(x)).transpose(1, 2)
        attn = torch.softmax(wide(logits), -1).to(x.dtype)
        y = (attn @ flat(self.g(x))).reshape(b, h, w, -1).permute(0, 3, 1, 2)
        return x + self.out(y)


class CoTAttention(nn.Module):
    """Contextual transformer attention (layers.py:2555): `key_embed` (a k x k
    Conv grouped by 4), `value_embed` (a 1x1 Conv, no activation); `att1`
    (a 1x1 Conv to c / 2) and the biased 1x1 `att2` to k² c channels of
    [key, x], averaged over the k² of each channel and softmaxed over the
    channels (in at least float32), weigh the values; plus key."""

    def __init__(self, c1: int, kernel_size: int = 3):
        super().__init__()
        k = self.k = kernel_size
        self.key_embed = Conv(c1, c1, k, 1, g=4)
        self.value_embed = Conv(c1, c1, 1, act=False)
        self.att1 = Conv(2 * c1, 2 * c1 // 4, 1)
        self.att2 = raw_conv(2 * c1 // 4, k * k * c1, 1)

    def forward(self, x):
        key = self.key_embed(x)
        val = self.value_embed(x)
        b, c, h, w = x.shape
        att = self.att2(self.att1(torch.cat([key, x], 1))).permute(0, 2, 3, 1).reshape(b, h, w, c, -1).mean(-1)
        k2 = torch.softmax(wide(att), -1).to(x.dtype) * val.permute(0, 2, 3, 1)
        return key + k2.permute(0, 3, 1, 2)


class DoubleAttention(nn.Module):
    """A²-Nets double attention (layers.py:2575): biased 1x1 `convA`,
    `convB`, `convV` to c / 2; B softmaxed over the map gathers A into a
    (c/2 x c/2) descriptor, V softmaxed over the channels reads it out (all
    in at least float32); `conv_out` back to c, with the residual."""

    def __init__(self, c1: int):
        super().__init__()
        cm = max(c1 // 2, 1)
        self.convA = raw_conv(c1, cm, 1)
        self.convB = raw_conv(c1, cm, 1)
        self.convV = raw_conv(c1, cm, 1)
        self.conv_out = raw_conv(cm, c1, 1)

    def forward(self, x):
        refuse_strip(self)
        b, c, h, w = x.shape
        flat = lambda t: wide(t).permute(0, 2, 3, 1).reshape(b, h * w, -1)  # noqa: E731
        with no_autocast(x):
            desc = torch.einsum("bnc,bnd->bcd", torch.softmax(flat(self.convB(x)), 1), flat(self.convA(x)))
            z = torch.einsum("bnc,bdc->bnd", torch.softmax(flat(self.convV(x)), -1), desc)
        return x + self.conv_out(z.reshape(b, h, w, -1).to(x.dtype).permute(0, 3, 1, 2))


class ParallelPolarizedSelfAttention(nn.Module):
    """Polarized self-attention, parallel (layers.py:2594). Channel branch:
    `ch_wv` (c / 2) pooled by the map softmax of `ch_wq` (one channel),
    `ch_wz` back to c, LayerNorm `ln` (eps 1e-6), a sigmoid gate. Spatial
    branch: `sp_wv` (c / 2) weighted by the channel softmax of `sp_wq`'s
    map mean, a sigmoid gate. Softmaxes in at least float32; the sum of
    the two gated maps."""

    def __init__(self, c1: int):
        super().__init__()
        ch = c1 // 2
        self.ch_wv = raw_conv(c1, ch, 1)
        self.ch_wq = raw_conv(c1, 1, 1)
        self.ch_wz = raw_conv(ch, c1, 1)
        self.ln = FlaxLayerNorm(c1)
        self.sp_wv = raw_conv(c1, ch, 1)
        self.sp_wq = raw_conv(c1, ch, 1)

    def forward(self, x):
        refuse_strip(self)
        b, c, h, w = x.shape
        wv = self.ch_wv(x).permute(0, 2, 3, 1).reshape(b, h * w, -1)
        wq = torch.softmax(wide(self.ch_wq(x)).reshape(b, h * w), 1).to(x.dtype)
        z = self.ch_wz(torch.einsum("bnc,bn->bc", wv, wq)[:, :, None, None])
        ch_out = x * torch.sigmoid(self.ln(z[:, :, 0, 0]))[:, :, None, None]
        sq = torch.softmax(wide(self.sp_wq(x).mean((2, 3))), -1).to(x.dtype)
        sp = torch.sigmoid(torch.einsum("bchw,bc->bhw", self.sp_wv(x), sq))[:, None]
        return ch_out + x * sp


class MHSA(nn.Module):
    """2-D multi-head self-attention with learned positions (layers.py:2644):
    biased 1x1 `query`, `key`, `value`; the logits q k + q pos, softmaxed
    (in at least float32) after / sqrt(head dim); no output projection.
    `rel_h` (1, 1, h, 1, hd) and `rel_w` (1, w, 1, 1, hd) take the map's
    size at build (`hw`; models.yolo.build_model's imgsz, the JAX
    init_model's), and a weights file's shapes replace it (`refit`); a map
    of another size raises ValueError, as flax refuses the parameters' shape.
    pos is rel_h + rel_w broadcast to (w, h) and then flattened as the
    row-major (h, w) tokens are, as the JAX package does."""

    flax_shaped = ("rel_h", "rel_w")

    def __init__(self, c1: int, num_heads: int = 4, hw: Tuple[int, int] = (8, 8)):
        super().__init__()
        self.num_heads = num_heads
        hd = c1 // num_heads
        self.query = raw_conv(c1, c1, 1)
        self.key = raw_conv(c1, c1, 1)
        self.value = raw_conv(c1, c1, 1)
        self.rel_h = nn.Parameter(torch.zeros(1, 1, hw[0], 1, hd))
        self.rel_w = nn.Parameter(torch.zeros(1, hw[1], 1, 1, hd))

    def refit(self, name: str, shape: Tuple[int, ...]) -> None:
        """`rel_h` or `rel_w` re-made at `shape` (a weights file's map size)."""
        old = getattr(self, name)
        setattr(self, name, nn.Parameter(old.new_zeros(shape)))

    def forward(self, x):
        refuse_strip(self)
        b, c, h, w = x.shape
        if (h, w) != (self.rel_h.shape[2], self.rel_w.shape[1]):
            raise ValueError(f"MHSA was built for a {self.rel_h.shape[2]}x{self.rel_w.shape[1]} map (its rel_h / "
                             f"rel_w), not {h}x{w}: build the model at the image size it serves (build_model's "
                             "imgsz) or load weights made at that size")
        nh = self.num_heads
        hd = c // nh
        heads = lambda t: t.permute(0, 2, 3, 1).reshape(b, h * w, nh, hd)  # noqa: E731
        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        pos = (self.rel_h + self.rel_w).reshape(h * w, hd).to(q.dtype)
        logits = torch.einsum("bnhd,bmhd->bhnm", q, k) + torch.einsum("bnhd,md->bhnm", q, pos)
        attn = torch.softmax(wide(logits) / math.sqrt(hd), -1).to(x.dtype)
        return torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, h, w, c).permute(0, 3, 1, 2)


class S2Attention(nn.Module):
    """Spatial-shift attention (layers.py:2674): Dense `mlp1` to 3c over the
    channels; the first c rolled by +1 and the next c by -1 pixel in four
    channel quarters (right, left, down, up; the rolls wrap around), the
    last c as is; their map means through Dense `mlp_a` and a softmax
    across the three (in at least float32) weigh them; Dense `mlp2`."""

    def __init__(self, c1: int):
        super().__init__()
        self.mlp1 = nn.Linear(c1, 3 * c1)
        self.mlp_a = nn.Linear(3 * c1, 3 * c1)
        self.mlp2 = nn.Linear(c1, c1)

    @staticmethod
    def _shift(t: torch.Tensor, part: int) -> torch.Tensor:  # NHWC
        q = t.shape[-1] // 4
        segs = (t[..., :q], t[..., q:2 * q], t[..., 2 * q:3 * q], t[..., 3 * q:])
        return torch.cat([torch.roll(s, (dy * part, dx * part), (1, 2))
                          for s, (dy, dx) in zip(segs, ((0, 1), (0, -1), (1, 0), (-1, 0)))], -1)

    def forward(self, x):
        refuse_strip(self)
        b, c = x.shape[:2]
        y = self.mlp1(x.permute(0, 2, 3, 1))
        stacked = torch.stack([self._shift(y[..., :c], 1), self._shift(y[..., c:2 * c], -1), y[..., 2 * c:]], 1)
        ahat = self.mlp_a(stacked.mean((2, 3)).reshape(b, 3 * c)).reshape(b, 3, c)
        ahat = torch.softmax(wide(ahat), 1).to(x.dtype)
        return self.mlp2((stacked * ahat[:, :, None, None, :]).sum(1)).permute(0, 3, 1, 2)


class EfficientAttention(nn.Module):
    """Linear attention (layers.py:2705): biased 1x1 `queries`, `keys`,
    `values` in heads; keys softmaxed over the map and queries over the
    head's channels, the (hd x hd) context and its read-out in at least
    float32; `reproj` with the residual."""

    def __init__(self, c1: int, num_heads: int = 4):
        super().__init__()
        self.num_heads = num_heads
        self.queries = raw_conv(c1, c1, 1)
        self.keys = raw_conv(c1, c1, 1)
        self.values = raw_conv(c1, c1, 1)
        self.reproj = raw_conv(c1, c1, 1)

    def forward(self, x):
        refuse_strip(self)
        b, c, h, w = x.shape
        heads = lambda t: wide(t).permute(0, 2, 3, 1).reshape(b, h * w, self.num_heads, -1)  # noqa: E731
        with no_autocast(x):
            k = torch.softmax(heads(self.keys(x)), 1)
            q = torch.softmax(heads(self.queries(x)), -1)
            ctx = torch.einsum("bnhd,bnhe->bhde", k, heads(self.values(x)))
            out = torch.einsum("bnhd,bhde->bnhe", q, ctx).reshape(b, h, w, c)
        return x + self.reproj(out.to(x.dtype).permute(0, 3, 1, 2))


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B nW, ws, ws, C); H and W multiples of ws."""
    b, h, w, c = x.shape
    return x.reshape(b, h // ws, ws, w // ws, ws, c).transpose(2, 3).reshape(-1, ws, ws, c)


def window_reverse(wins: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """The inverse of window_partition: (B nW, ws, ws, C) -> (B, H, W, C)."""
    b = wins.shape[0] // (h * w // ws // ws)
    return wins.reshape(b, h // ws, w // ws, ws, ws, -1).transpose(2, 3).reshape(b, h, w, -1)


_MASKS: dict = {}


def shifted_window_mask(hp: int, wp: int, ws: int, ss: int, device) -> torch.Tensor:
    """The (nW, ws², ws²) attention mask of the shifted windows of a padded
    hp x wp map (layers.py:2029-2044): -100 between tokens of different
    regions, else 0, float32. Cached per shape and device."""
    key = (hp, wp, ws, ss, str(device))
    if key not in _MASKS:
        img = np.zeros((hp, wp), np.float32)
        cnt = 0
        for hs in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
            for wsl in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
                img[hs, wsl] = cnt
                cnt += 1
        mw = img.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
        am = mw[:, None, :] - mw[:, :, None]
        _MASKS[key] = torch.from_numpy(np.where(am != 0, -100.0, 0.0).astype(np.float32)).to(device)
    return _MASKS[key]


class WindowAttention(nn.Module):
    """Window multi-head attention with a relative position bias
    (layers.py:1964): `qkv` (no bias here, as the layer asks), the logits
    q k / sqrt(hd) plus the `relative_position_bias_table` ((2 ws - 1)², nh)
    entry of each token pair, indexed W-major (the W delta the major term,
    layers.py:1986-1992), plus the shifted windows' mask; the softmax in at
    least float32; `proj`."""

    flax_shaped = ("relative_position_bias_table",)

    def __init__(self, dim: int, window_size: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        ws = self.window_size = window_size
        self.num_heads = num_heads
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * ws - 1) ** 2, num_heads))
        coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij"), 0).reshape(2, -1)
        rel = coords[:, :, None] - coords[:, None, :]
        self.register_buffer("index", (rel[1] + ws - 1) * (2 * ws - 1) + (rel[0] + ws - 1), persistent=False)
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, mask: Optional[torch.Tensor] = None):  # (B nW, N, C)
        bw, n, c = x.shape
        nh = self.num_heads
        hd = c // nh
        bias = self.relative_position_bias_table[self.index.reshape(-1)].reshape(n, n, nh).permute(2, 0, 1)
        q, k, v = self.qkv(x).reshape(bw, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        attn = (q * hd ** -0.5) @ k.transpose(-1, -2) + bias[None].to(q.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bw // nw, nw, nh, n, n) + mask[None, :, None].to(attn.dtype)).reshape(bw, nh, n, n)
        attn = torch.softmax(wide(attn), -1).to(v.dtype)
        return self.proj((attn @ v).transpose(1, 2).reshape(bw, n, c))


class SwinTransformerLayer(nn.Module):
    """One (shifted-)window layer on an NHWC map (layers.py:2008): LayerNorm
    `norm1` (eps 1e-5), zero padding to window multiples (the padded
    tokens take part in attention), the roll by -shift and the mask of the
    padded size where shifted, WindowAttention `attn`, the roll back and
    crop, the residual; LayerNorm `norm2`, Dense `mlp_fc1` (4c), GELU (exact,
    tanh with `approx_gelu`), Dense `mlp_fc2`, the residual."""

    def __init__(self, c: int, num_heads: int, window_size: int = 7, shift_size: int = 0, mlp_ratio: int = 4,
                 approx_gelu: bool = False):
        super().__init__()
        self.ws, self.ss = window_size, shift_size
        self.approximate = "tanh" if approx_gelu else "none"
        self.norm1 = FlaxLayerNorm(c, eps=1e-5)
        self.attn = WindowAttention(c, window_size, num_heads, qkv_bias=False)
        self.norm2 = FlaxLayerNorm(c, eps=1e-5)
        self.mlp_fc1 = nn.Linear(c, c * mlp_ratio)
        self.mlp_fc2 = nn.Linear(c * mlp_ratio, c)

    def forward(self, x):  # (B, H, W, C)
        b, h, w, c = x.shape
        ws, ss = self.ws, self.ss
        pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
        y = F.pad(self.norm1(x), (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        mask = None
        if ss > 0:
            y = torch.roll(y, (-ss, -ss), (1, 2))
            mask = shifted_window_mask(hp, wp, ws, ss, x.device)
        wins = self.attn(window_partition(y, ws).reshape(-1, ws * ws, c), mask)
        y = window_reverse(wins.reshape(-1, ws, ws, c), ws, hp, wp)
        if ss > 0:
            y = torch.roll(y, (ss, ss), (1, 2))
        x = x + y[:, :h, :w]
        z = F.gelu(self.mlp_fc1(self.norm2(x)), approximate=self.approximate)
        return x + self.mlp_fc2(z)


class SwinTransformerBlock(nn.Module):
    """A Conv to c2 where c1 != c2, then num_layers Swin layers `tr<i>`,
    every other one shifted by window_size // 2 (layers.py:2067)."""

    def __init__(self, c1: int, c2: int, num_heads: int, num_layers: int, window_size: int = 8,
                 approx_gelu: bool = False):
        super().__init__()
        self.conv = Conv(c1, c2) if c1 != c2 else nn.Identity()
        self.tr = nn.ModuleList(
            SwinTransformerLayer(c2, num_heads, window_size, 0 if i % 2 == 0 else window_size // 2,
                                 approx_gelu=approx_gelu) for i in range(num_layers))

    def forward(self, x):
        refuse_strip(self)
        t = self.conv(x).permute(0, 2, 3, 1)
        for layer in self.tr:
            t = layer(t)
        return t.permute(0, 3, 1, 2)


class C3STR(C3):
    """C3 whose inner branch `m` is a SwinTransformerBlock (max(c_ // 32, 1)
    heads, n layers, window 8; layers.py:2093)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5,
                 approx_gelu: bool = False):
        super().__init__(c1, c2, 0, shortcut, g, e)
        c_ = int(c2 * e)
        self.m = SwinTransformerBlock(c_, c_, max(c_ // 32, 1), n, approx_gelu=approx_gelu)


class GnConv(nn.Module):
    """Recursive gated convolution (layers.py:2117): biased 1x1 `proj_in` to
    2 dim, a biased 7x7 depthwise `dwconv` over all but the first dims[0]
    channels (times s), then the first part gated by the first split and
    each 1x1 `pw<i>` gated by the next; `proj_out`. dims are dim / 2^i,
    smallest first. The block is channel-preserving in the graph: its dim
    must be its input's channel count."""

    def __init__(self, c1: int, dim: Optional[int] = None, order: int = 5, s: float = 1.0):
        super().__init__()
        dim = c1 if dim is None else dim
        if dim != c1:
            raise ValueError(f"gnconv dim {dim} on {c1} input channels: the graph records the row as "
                             "channel-preserving, so dim must be the input's channels (ROADMAP queue C)")
        self.dims = [dim // 2 ** i for i in range(order)][::-1]
        self.s = s
        self.proj_in = raw_conv(c1, 2 * dim, 1)
        self.dwconv = raw_conv(sum(self.dims), sum(self.dims), 7, g=sum(self.dims))
        self.pw = nn.ModuleList(raw_conv(self.dims[i], self.dims[i + 1], 1) for i in range(order - 1))
        self.proj_out = raw_conv(dim, dim, 1)

    def forward(self, x):
        fused = self.proj_in(x)
        pwa, abc = fused[:, :self.dims[0]], fused[:, self.dims[0]:]
        dw = (self.dwconv(abc) * self.s).split(self.dims, 1)
        y = pwa * dw[0]
        for i, pw in enumerate(self.pw):
            y = pw(y) * dw[i + 1]
        return self.proj_out(y)


class HorBlock(nn.Module):
    """HorNet block (layers.py:2140): LayerNorm `norm1` over the channels
    (eps 1e-6), GnConv `gnconv`, layer-scaled by `gamma1`; LayerNorm `norm2`,
    Dense `pwconv1` (4c), tanh GELU (flax's default, every dtype), Dense
    `pwconv2`, layer-scaled by `gamma2`; each with the residual."""

    def __init__(self, c1: int, order: int = 5):
        super().__init__()
        self.gamma1 = nn.Parameter(torch.full((c1,), 1e-6))
        self.gamma2 = nn.Parameter(torch.full((c1,), 1e-6))
        self.norm1 = FlaxLayerNorm(c1, dim=1)
        self.gnconv = GnConv(c1, order=order)
        self.norm2 = FlaxLayerNorm(c1)
        self.pwconv1 = nn.Linear(c1, 4 * c1)
        self.pwconv2 = nn.Linear(4 * c1, c1)

    def forward(self, x):
        x = x + self.gamma1[:, None, None] * self.gnconv(self.norm1(x))
        z = self.pwconv2(F.gelu(self.pwconv1(self.norm2(x.permute(0, 2, 3, 1))), approximate="tanh"))
        return x + (self.gamma2 * z).permute(0, 3, 1, 2)


class TridentBlock(nn.Module):
    """Weight-shared three-branch dilated residual block (layers.py:2186):
    the same bias-free 1x1 `share_weightconv1` and 3x3 `share_weightconv2`
    (bare flax HWIO kernels, OIHW here) at dilations 1, 2, 3, each conv in
    at least float32 with autocast off, cast back; one BatchNorm `bn1` and
    one `bn2` (eps 1e-3) shared by the branches, whose running statistics a
    train-mode forward moves three times, in branch order; SiLU after bn1,
    and SiLU of bn2 plus the branch's input. Takes a map (three times) or a
    list of three; returns three maps."""

    hwio = ("share_weightconv1", "share_weightconv2")

    def __init__(self, c1: int, c2: int, stride: int = 1, e: float = 0.5, dilate: Sequence[int] = (1, 2, 3)):
        super().__init__()
        c_ = int(c2 * e)
        self.stride, self.dilate = stride, tuple(dilate)
        self.share_weightconv1 = nn.Parameter(torch.zeros(c_, c1, 1, 1))
        self.share_weightconv2 = nn.Parameter(torch.zeros(c2, c_, 3, 3))
        self.bn1 = FlaxBatchNorm2d(c_, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.bn2 = FlaxBatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)

    def _branch(self, inp: torch.Tensor, d: int) -> torch.Tensor:
        with no_autocast(inp):
            y = F.conv2d(wide(inp), wide(self.share_weightconv1)).to(inp.dtype)
        y = F.silu(self.bn1(y))
        with no_autocast(y):
            y = F.conv2d(wide(y), wide(self.share_weightconv2), None, self.stride, d, d).to(inp.dtype)
        return F.silu(self.bn2(y) + inp)

    def forward(self, x):
        refuse_strip(self)
        xs = list(x) if isinstance(x, (list, tuple)) else [x, x, x]
        return [self._branch(xs[i], self.dilate[i]) for i in range(3)]


class RFEM(nn.Module):
    """Receptive-field enhancement (layers.py:2228): TridentBlock `t0`, the
    sum of its three maps and x, BatchNorm `bn` (eps 1e-3), SiLU. c2 must
    be c1. n > 1 raises: the JAX package's second TridentBlock takes the
    first one's list and fails on it, so there is no reference (ROADMAP
    queue C)."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__()
        if n != 1:
            raise ValueError(f"RFEM n={n}: the JAX package's RFEM runs only n 1 (its TridentBlock t1 takes a list)")
        self.t0 = TridentBlock(c1, c2, e=e)
        self.bn = FlaxBatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x):
        out = self.t0(x)
        return F.silu(self.bn(out[0] + out[1] + out[2] + x))


class C3RFEM(nn.Module):
    """C3 with n RFEMs `m<i>` (width c_, e) as its inner branch (layers.py:2249)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.m = nn.Sequential(*(RFEM(c_, c_, 1, e) for _ in range(n)))
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1)

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class Encoding(nn.Module):
    """Learned-codebook soft assignment (layers.py:2268): each pixel's
    squared distance to each of `num_codes` codes, softmaxed over the codes
    with per-code (negative) scales, weighs its residuals, summed over the
    map -> (B, num_codes, C), in at least float32 with autocast off, cast
    back. The parameters are stored as flax stores them, before the
    forward's shifts: the codes are `codewords` - 1 / sqrt(num_codes C) and
    the scales -`scale`."""

    flax_shaped = ("codewords", "scale")  # not a norm's scale

    def __init__(self, c1: int, num_codes: int = 64):
        super().__init__()
        self.codewords = nn.Parameter(torch.zeros(num_codes, c1))
        self.scale = nn.Parameter(torch.zeros(num_codes))

    def forward(self, x):
        b, c, h, w = x.shape
        k = self.codewords.shape[0]
        with no_autocast(x):
            flat = wide(x).permute(0, 2, 3, 1).reshape(b, h * w, 1, c)
            codes = wide(self.codewords) - 1.0 / math.sqrt(k * c)
            diff = flat - codes[None, None]  # (b, n, k, c)
            wts = torch.softmax(-wide(self.scale)[None, None] * diff.square().sum(-1), 2)
            enc = (wts[..., None] * diff).sum(1)
        return enc.to(x.dtype)


class EVCConvBlock(nn.Module):
    """The EVC neck's bottleneck (layers.py:2290): bias-free 1x1 `conv1` to
    c2 / 4, 3x3 `conv2`, 1x1 `conv3` to c2, each with a BatchNorm (eps 1e-6)
    `bn1`-`bn3` (ReLU after the first two); the residual through a bare 1x1
    `residual_conv` and `residual_bn` where `res_conv`; ReLU of the sum."""

    def __init__(self, c1: int, c2: int, res_conv: bool = False):
        super().__init__()
        c = c2 // 4
        bn = lambda n: FlaxBatchNorm2d(n, eps=1e-6, momentum=BN_MOMENTUM)  # noqa: E731
        self.conv1 = raw_conv(c1, c, 1, bias=False)
        self.bn1 = bn(c)
        self.conv2 = raw_conv(c, c, 3, bias=False)
        self.bn2 = bn(c)
        self.conv3 = raw_conv(c, c2, 1, bias=False)
        self.bn3 = bn(c2)
        self.res_conv = res_conv
        if res_conv:
            self.residual_conv = raw_conv(c1, c2, 1, bias=False)
            self.residual_bn = bn(c2)

    def forward(self, x):
        y = torch.relu(self.bn2(self.conv2(torch.relu(self.bn1(self.conv1(x))))))
        y = self.bn3(self.conv3(y))
        res = self.residual_bn(self.residual_conv(x)) if self.res_conv else x
        return torch.relu(y + res)


class LVCBlock(nn.Module):
    """Learned-vector-codebook gating (layers.py:2319): EVCConvBlock
    `conv_1` (with its residual conv), then the bare 1x1 `lvc_conv`,
    BatchNorm `lvc_bn`, ReLU, Encoding `encoding` (num_codes), BatchNorm
    `en_bn` over its (B, codes, C) channels, ReLU and the mean over the
    codes, Dense `fc` and a sigmoid: relu(x + x * gate). The row's c2 slot
    does not enter the block."""

    def __init__(self, c1: int, num_codes: int = 64):
        super().__init__()
        self.conv_1 = EVCConvBlock(c1, c1, res_conv=True)
        self.lvc_conv = raw_conv(c1, c1, 1, bias=False)
        self.lvc_bn = FlaxBatchNorm2d(c1, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.encoding = Encoding(c1, num_codes)
        self.en_bn = FlaxBatchNorm1d(c1, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.fc = nn.Linear(c1, c1)

    def forward(self, x):
        refuse_strip(self)
        x = self.conv_1(x)
        en = self.encoding(torch.relu(self.lvc_bn(self.lvc_conv(x))))
        en = torch.relu(self.en_bn(en.transpose(1, 2))).mean(2)
        gam = torch.sigmoid(self.fc(en))
        return torch.relu(x + x * gam[:, :, None, None])


class ConvMixer(nn.Module):
    """Patch embedding and a depthwise mixer with an exp gate
    (layers.py:2344); c2 is c1 whatever the row says. A biased patch x
    patch `patch` conv at stride patch, tanh GELU, BatchNorm `bn_p`; depth
    times a biased depthwise `dw<i>` (padding 1), GELU, `bn_dw<i>`, plus
    its input, then a biased 1x1 `pw<i>`, GELU, `bn_pw<i>` (eps 1e-3); the
    map mean through bias-free Dense `fc1` (c / reduction), ReLU, `fc2`,
    sigmoid gates x by its exp."""

    def __init__(self, c1: int, c2: int = 0, depth: int = 1, kernel_size: int = 3, patch_size: int = 4,
                 reduction: int = 16):
        super().__init__()
        bn = lambda: FlaxBatchNorm2d(c1, eps=BN_EPS, momentum=BN_MOMENTUM)  # noqa: E731
        self.patch = raw_conv(c1, c1, patch_size, s=patch_size, p=0)
        self.bn_p = bn()
        self.dw = nn.ModuleList(raw_conv(c1, c1, kernel_size, g=c1, p=1) for _ in range(depth))
        self.bn_dw = nn.ModuleList(bn() for _ in range(depth))
        self.pw = nn.ModuleList(raw_conv(c1, c1, 1) for _ in range(depth))
        self.bn_pw = nn.ModuleList(bn() for _ in range(depth))
        self.fc1 = nn.Linear(c1, c1 // reduction, bias=False)
        self.fc2 = nn.Linear(c1 // reduction, c1, bias=False)

    def forward(self, x):
        refuse_strip(self)
        gelu = lambda t: F.gelu(t, approximate="tanh")  # noqa: E731
        y = self.bn_p(gelu(self.patch(x)))
        for dw, bn_dw, pw, bn_pw in zip(self.dw, self.bn_dw, self.pw, self.bn_pw):
            y = y + bn_dw(gelu(dw(y)))
            y = bn_pw(gelu(pw(y)))
        v = torch.sigmoid(self.fc2(torch.relu(self.fc1(y.mean((2, 3))))))
        return x * torch.exp(v)[:, :, None, None]
