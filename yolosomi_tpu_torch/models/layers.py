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


def autopad(k, p: Optional[int] = None):
    """'same' padding for an odd kernel size, an int or an (h, w) pair."""
    if p is not None:
        return p
    return k // 2 if isinstance(k, int) else tuple(x // 2 for x in k)


class Conv(nn.Module):
    """Conv2d (no bias) + BatchNorm(eps 1e-3) + SiLU. `k` is an int or an
    (h, w) pair; `act` True (SiLU), False (none) or an activation module
    (ASFF's LeakyReLU(0.1))."""

    def __init__(self, c1: int, c2: int, k: Union[int, Tuple[int, int]] = 1, s: int = 1, p: Optional[int] = None,
                 g: int = 1, act: Union[bool, nn.Module] = True):
        super().__init__()
        self.conv = ConvRaw(c1, c2, k, s, autopad(k, p), groups=g, bias=False)
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
