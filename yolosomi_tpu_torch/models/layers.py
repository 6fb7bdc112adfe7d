"""The detection family's blocks (counterparts of
yolosomi_tpu/models/layers.py): the flagship's, and the YOLOv5 / YOLOv8
blocks of the other model configs.

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
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from yolosomi_tpu_torch.ops.odconv import per_sample_conv

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
    way and leaves the running statistics alone."""

    update_stats = True

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
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


class ConvRaw(nn.Conv2d):
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
        return super().forward(x) if hook is None else hook(self, x)


def autopad(k, p: Optional[int] = None):
    """'same' padding for an odd kernel size, an int or an (h, w) pair."""
    if p is not None:
        return p
    return k // 2 if isinstance(k, int) else tuple(x // 2 for x in k)


class Conv(nn.Module):
    """Conv2d (no bias) + BatchNorm(eps 1e-3) + SiLU. `k` is an int or an
    (h, w) pair."""

    def __init__(self, c1: int, c2: int, k: Union[int, Tuple[int, int]] = 1, s: int = 1, p: Optional[int] = None,
                 g: int = 1, act: bool = True):
        super().__init__()
        self.conv = ConvRaw(c1, c2, k, s, autopad(k, p), groups=g, bias=False)
        self.bn = FlaxBatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = nn.SiLU() if act else nn.Identity()

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
        gate = torch.sigmoid(self.shared_MLP(x.mean((2, 3))) + self.shared_MLP(x.amax((2, 3))))
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
        v = self.fc(self.DCovN(x).mean((2, 3)))
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
        gate_c = torch.sigmoid(self.fc(y.mean((2, 3), keepdim=True)) + self.fc(y.amax((2, 3), keepdim=True)))
        y = y * gate_c
        gy = y.reshape(b, g, gch, h, w)
        profile = torch.cat([gy.mean(4), gy.mean(3)], 3)  # (b, g, gch, h + w)
        gate_s = self.conv_spatial(profile.reshape(b * g, gch, h + w, 1))
        gate_s = torch.sigmoid(gate_s.reshape(b, g, 1, h + w))
        gate_h = gate_s[..., :h].reshape(b, g, 1, h, 1)
        gate_w = gate_s[..., h:].reshape(b, g, 1, 1, w)
        gy = (gy * gate_h * gate_w).reshape(b, c, h, w)
        if h * w == 1:  # one value a group (torch refuses it at batch 1): flax's output is the bias
            return gy * 0 + self.gn.bias.view(1, -1, 1, 1)
        return self.gn(gy)


class C2fEMACBAM(C2f):
    """C2f with EMA-CBAM bottlenecks (the YAML's `C2fEACBAM` rows alias it)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, e: float = 0.5):
        super().__init__(c1, c2, n, e=e, block=lambda c: EMACBAMBottleneck(c, c, e=0.5, factor=8))


# ---------------------------------------------------------------------------
# Pooling, resampling, fusion
# ---------------------------------------------------------------------------


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
        return self.cv2(torch.cat([y] + [F.max_pool2d(y, k, 1, k // 2) for k in self.k], 1))


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
        pool = lambda t: F.max_pool2d(t, self.k, 1, self.k // 2)  # noqa: E731
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
    out-channel sigmoids). The per-sample 3x3 stride-2 conv is
    ops.odconv.odconv_s2 (a CUDA kernel on the GPU); the trunk and the mix
    are small tensor ops left to PyTorch, as the JAX package left them to XLA.

    `weight` is the (K, Cout, Cin, k, k) candidate bank and `bias` the
    (K, Cout) bias bank, as in the reference checkpoints."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, K: int = 4, r: float = 1.0 / 16.0):
        super().__init__()
        if (k, s) != (3, 2):
            raise NotImplementedError(f"ODConv is ported for k=3 s=2 (every flagship site), got k={k} s={s}")
        self.k, self.c1, self.c2, self.K = k, c1, c2, K
        hidden = max(int(c1 * r), 16)
        self.weight = nn.Parameter(torch.zeros(K, c2, c1, k, k))
        self.bias = nn.Parameter(torch.zeros(K, c2))
        self.fc = nn.Linear(c1, hidden, bias=False)
        self.bn = FlaxBatchNorm1d(hidden, eps=1e-5, momentum=0.1)
        self.fc_f = nn.Linear(hidden, c2)
        self.fc_s = nn.Linear(hidden, k * k)
        self.fc_c = nn.Linear(hidden, c1)
        self.fc_w = nn.Linear(hidden, K)

    def forward(self, x):
        b = x.shape[0]
        k = self.k
        # attention trunk: GAP -> fc -> BN -> ReLU -> four factors
        v = torch.relu(self.bn(self.fc(x.mean((2, 3)))))
        attn_f = torch.sigmoid(self.fc_f(v))  # (B, Cout)
        attn_s = torch.sigmoid(self.fc_s(v)).reshape(b, k, k)
        attn_c = torch.sigmoid(self.fc_c(v))  # (B, Cin)
        attn_w = torch.softmax(self.fc_w(v), -1)  # (B, K)
        # mix over K once, then the separable factors -> (B, 3, 3, Cin, Cout)
        wmix = torch.einsum("bk,koihw->bhwio", attn_w, self.weight)
        wmix = wmix * attn_s[:, :, :, None, None] * attn_c[:, None, None, :, None] * attn_f[:, None, None, None, :]
        x_nhwc = x.permute(0, 2, 3, 1).contiguous()  # free for a channels_last x
        out = per_sample_conv(x_nhwc, wmix.to(x.dtype).contiguous())
        out = out + (attn_w.float() @ self.bias.float()).to(x.dtype)[:, None, None, :]
        return out.permute(0, 3, 1, 2)


class ODConv(nn.Module):
    """ODConv2d + BatchNorm(eps 1e-3) + SiLU, the YAML-visible module
    (`ODConv_3rd`)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, kerNums: int = 4):
        super().__init__()
        self.conv = ODConv2d(c1, c2, k, s, K=kerNums)
        self.bn = FlaxBatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = nn.SiLU()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))
