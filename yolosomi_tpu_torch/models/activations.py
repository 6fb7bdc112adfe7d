"""The activation zoo, free of JAX (counterpart of
yolosomi_tpu/models/activations.py:22-92).

The parameter-free activations are plain functions of a tensor; the
learnable ones (FReLU, AconC, MetaAconC) are modules that take the input
channels first, as every block of the port does, and that the YAML names
as rows of the `noarg` kind. Modules are NCHW; their parameter names are
the JAX package's flax names, which the weight bridge (utils/weights.py)
maps by name.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from yolosomi_tpu_torch.models.layers import BN_EPS, BN_MOMENTUM, ConvRaw, FlaxBatchNorm2d, refuse_strip


def silu(x):
    return F.silu(x)


def hardswish(x):
    """x * relu6(x + 3) / 6 (activations.py:26)."""
    return x * F.relu6(x + 3.0) / 6.0


def mish(x):
    """x * tanh(softplus(x)) (activations.py:30)."""
    return x * torch.tanh(F.softplus(x))


def hardsigmoid(x):
    """relu6(x + 3) / 6 (activations.py:37)."""
    return F.relu6(x + 3.0) / 6.0


def _channel(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (C,) parameter as a (1, C, 1, 1) factor in x's dtype."""
    return p.to(x.dtype).view(1, -1, 1, 1)


class FReLU(nn.Module):
    """Funnel activation: max(x, BN(depthwise k x k conv(x))), the conv
    padded by 1 whatever k is (activations.py:41-58)."""

    def __init__(self, c1: int, k: int = 3):
        super().__init__()
        self.conv = ConvRaw(c1, c1, k, 1, 1, groups=c1, bias=False)
        self.bn = FlaxBatchNorm2d(c1, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x):
        return torch.maximum(x, self.bn(self.conv(x)))


class AconC(nn.Module):
    """(p1 - p2) x sigmoid(beta (p1 - p2) x) + p2 x with learnable
    per-channel p1, p2 and beta (activations.py:61-75); models.yolo.init_weights
    draws p1 and p2 from N(0, 1), as flax does."""

    def __init__(self, c1: int):
        super().__init__()
        self.p1 = nn.Parameter(torch.zeros(c1))
        self.p2 = nn.Parameter(torch.zeros(c1))
        self.beta = nn.Parameter(torch.ones(c1))

    def forward(self, x):
        dpx = _channel(self.p1 - self.p2, x) * x
        return dpx * torch.sigmoid(_channel(self.beta, x) * dpx) + _channel(self.p2, x) * x


class MetaAconC(nn.Module):
    """AconC whose beta is sigmoid(fc2(fc1(the whole-map mean))), two biased
    1x1 convs of max(r, c // r) hidden channels and no BatchNorm
    (activations.py:78-92). The mean spans the whole map: no strip path."""

    def __init__(self, c1: int, r: int = 16):
        super().__init__()
        mid = max(r, c1 // r)
        self.p1 = nn.Parameter(torch.zeros(c1))
        self.p2 = nn.Parameter(torch.zeros(c1))
        self.fc1 = ConvRaw(c1, mid, 1)
        self.fc2 = ConvRaw(mid, c1, 1)

    def forward(self, x):
        refuse_strip(self)
        beta = torch.sigmoid(self.fc2(self.fc1(x.mean((2, 3), keepdim=True))))
        dpx = _channel(self.p1 - self.p2, x) * x
        return dpx * torch.sigmoid(beta * dpx) + _channel(self.p2, x) * x
