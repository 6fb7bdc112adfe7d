"""The train step's on-device preprocessing: normalize, HSV jitter, flips
and a batched affine warp (counterpart of yolosomi_tpu/ops/preprocess.py).

The functions take NHWC batches on any device and explicit per-image
parameters, and compute as the JAX package's functions do. Only
`preprocess_train_batch` draws: from a `torch.Generator` on the CPU, so
the same seed gives the same draws whatever the batch's device. JAX draws
from `jax.random.fold_in(PRNGKey(seed), step)`, bits the port cannot
reproduce; the trainer seeds the generator from (seed, step) instead, so
a resumed run replays the same stream.
"""

from __future__ import annotations

from typing import Tuple

import torch


def normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [0, 1]; a float batch is taken as normalized."""
    if images.dtype == torch.uint8:
        return images.float() / 255.0
    return images.float()


def _rgb_to_hsv(rgb: torch.Tensor):
    """(h in [0, 1), s, v) of the last axis's (r, g, b)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn + 1e-12
    h = torch.where(mx == r, torch.remainder((g - b) / d, 6.0),
                    torch.where(mx == g, (b - r) / d + 2.0, (r - g) / d + 4.0)) / 6.0
    s = d / (mx + 1e-12)
    return torch.remainder(h, 1.0), s, mx


def _hsv_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    h6 = h * 6.0
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)
    rgb = []
    for sector in ((v, q, p, p, t, v), (t, v, v, q, p, p), (p, p, t, v, v, q)):
        out = sector[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, sector[k], out)
        rgb.append(out)
    return torch.stack(rgb, -1)


def hsv_jitter(images: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """Multiplicative (h, s, v) gains (B, 3) on float [0, 1] NHWC images:
    hue wraps, saturation and value clip to [0, 1]."""
    h, s, v = _rgb_to_hsv(images)
    h = torch.remainder(h * gains[:, None, None, 0], 1.0)
    s = torch.clamp(s * gains[:, None, None, 1], 0.0, 1.0)
    v = torch.clamp(v * gains[:, None, None, 2], 0.0, 1.0)
    return _hsv_to_rgb(h, s, v)


def flips(images: torch.Tensor, targets: torch.Tensor, do_lr: torch.Tensor, do_ud: torch.Tensor):
    """Per-image left-right and up-down flips (do_lr, do_ud (B,) bool) of
    NHWC images and their (B, M, 5) normalized targets; padding rows (cls
    < 0) keep their coordinates."""
    images = torch.where(do_lr[:, None, None, None], images.flip(2), images)
    images = torch.where(do_ud[:, None, None, None], images.flip(1), images)
    valid = targets[..., 0] >= 0
    xc = torch.where(do_lr[:, None] & valid, 1.0 - targets[..., 1], targets[..., 1])
    yc = torch.where(do_ud[:, None] & valid, 1.0 - targets[..., 2], targets[..., 2])
    return images, torch.cat([targets[..., 0:1], xc[..., None], yc[..., None], targets[..., 3:5]], -1)


def affine_batch(images: torch.Tensor, mats: torch.Tensor, out_hw: Tuple[int, int],
                 fill: float = 114 / 255) -> torch.Tensor:
    """Inverse affine warp with bilinear taps: mats (B, 2, 3) map output
    pixel coordinates (x, y, 1) to input ones; taps outside the image read
    `fill`. images (B, H, W, C) float -> (B, Ho, Wo, C)."""
    B, H, W, C = images.shape
    Ho, Wo = out_hw
    dev = images.device
    ys, xs = torch.meshgrid(torch.arange(Ho, dtype=torch.float32, device=dev),
                            torch.arange(Wo, dtype=torch.float32, device=dev), indexing="ij")
    coords = torch.stack([xs, ys, torch.ones_like(xs)], -1)
    src = torch.einsum("bij,hwj->bhwi", mats.float(), coords)
    px, py = src[..., 0], src[..., 1]
    x0, y0 = torch.floor(px), torch.floor(py)
    flat_img = images.reshape(B, H * W, C)
    out = 0.0
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xc, yc = x0 + dx, y0 + dy
        w = torch.abs(1 - torch.abs(px - xc)) * torch.abs(1 - torch.abs(py - yc))
        inb = (xc >= 0) & (xc <= W - 1) & (yc >= 0) & (yc <= H - 1)
        flat = (torch.clamp(yc, 0, H - 1).long() * W + torch.clamp(xc, 0, W - 1).long()).reshape(B, -1, 1)
        tap = torch.gather(flat_img, 1, flat.expand(-1, -1, C)).reshape(B, Ho, Wo, C)
        out = out + torch.where(inb[..., None], tap, fill) * w[..., None]
    return out


def preprocess_train_batch(images: torch.Tensor, targets: torch.Tensor, gen: torch.Generator, hyp: dict,
                           rank: int = 0, world: int = 1):
    """normalize, then the HSV gains 1 + U(-1, 1) * (hsv_h, hsv_s, hsv_v),
    then flips with probabilities fliplr and flipud, each drawn per image
    from `gen` (a CPU generator), in that order. With `world` > 1 the
    images are rank `rank`'s slice of a global batch of world x B: the
    draws are the global batch's, and the slice takes its own rows."""
    b, dev = images.shape[0], images.device
    B = b * world
    images = normalize(images)
    gain = torch.tensor([hyp.get("hsv_h", 0.0), hyp.get("hsv_s", 0.0), hyp.get("hsv_v", 0.0)])
    rows = slice(rank * b, (rank + 1) * b)
    gains = (1.0 + (torch.rand((B, 3), generator=gen) * 2.0 - 1.0) * gain)[rows]
    do_lr = (torch.rand(B, generator=gen) < hyp.get("fliplr", 0.0))[rows]
    do_ud = (torch.rand(B, generator=gen) < hyp.get("flipud", 0.0))[rows]
    images = hsv_jitter(images, gains.to(dev, non_blocking=True))
    return flips(images, targets, do_lr.to(dev, non_blocking=True), do_ud.to(dev, non_blocking=True))
