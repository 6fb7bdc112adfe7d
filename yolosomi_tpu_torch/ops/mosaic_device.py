"""--cache device: the training images in one uint8 slab on the device, and
the mosaic, perspective warp and mixup composited there from the host's
plans (counterpart of yolosomi_tpu/ops/mosaic_device.py).

The slab is (N, S, S, 3) uint8, each image long-side resized to S and
anchored top left, the rest 114 (the mosaic canvas's fill). A batch ships
only its plan (data/datasets.py `plan_item`): per composite the 4 tile
images, the inverse warp, the mosaic centre, each tile's offset on the
canvas and its source rectangle, and per row the mixup weight. Every
output pixel maps through the inverse warp to the canvas, takes the tile
whose quadrant it lands in, and reads 4 bilinear taps of that tile: one
gather of (B, H, W, 4) flat indices from the slab. A tap outside the
tile's pasted rectangle reads 114, as the host canvas does.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

FILL = 114.0
_TAPS = ((0, 0), (1, 0), (0, 1), (1, 1))


def build_device_cache(dataset):
    """Every image of `dataset` through its load_image (long side
    img_size), in an (N, S, S, 3) uint8 slab filled with 114, on the host
    (the trainer uploads it once). Returns (slab, hw): hw (N, 2) int32 the
    resized (h, w) of each image."""
    n, s = len(dataset), dataset.img_size
    slab = np.full((n, s, s, 3), int(FILL), np.uint8)
    hw = np.zeros((n, 2), np.int32)

    def load(i):
        img, _, (h, w) = dataset.load_image(i)
        slab[i, :h, :w] = img
        hw[i] = (h, w)

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:  # cv2 releases the GIL
        list(pool.map(load, range(n)))
    return slab, hw


def _pick(per_tile: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, 4, F) per-tile values -> (B, H, W, F) per pixel, by the owning
    tile k (B, H, W)."""
    B, H, W = k.shape
    F = per_tile.shape[-1]
    return torch.gather(per_tile, 1, k.reshape(B, H * W, 1).expand(-1, -1, F)).reshape(B, H, W, F)


def _composite(slab_flat: torch.Tensor, s: int, idx, minv, center, offs, srect, out_size: int) -> torch.Tensor:
    """One mosaic composite per batch row: idx (B, 4), minv (B, 3, 3),
    center (B, 2), offs (B, 4, 2), srect (B, 4, 4). Returns (B, out, out,
    3) float32 in [0, 255]."""
    B, dev = idx.shape[0], slab_flat.device
    ys, xs = torch.meshgrid(torch.arange(out_size, dtype=torch.float32, device=dev),
                            torch.arange(out_size, dtype=torch.float32, device=dev), indexing="ij")

    def row(r):  # output pixel -> mosaic canvas, homogeneous
        return minv[:, r, 0, None, None] * xs + minv[:, r, 1, None, None] * ys + minv[:, r, 2, None, None]

    cw = row(2)
    cx, cy = row(0) / cw, row(1) / cw
    # the quadrant the pixel lands in: top left 0, top right 1, bottom left 2, bottom right 3
    k = (cx >= center[:, 0, None, None]).long() + 2 * (cy >= center[:, 1, None, None]).long()
    off = _pick(offs, k)
    rect = _pick(srect, k)
    img = torch.gather(idx.long(), 1, k.reshape(B, -1)).reshape(k.shape)
    sx, sy = cx - off[..., 0], cy - off[..., 1]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    xt = x0[..., None] + torch.tensor([dx for dx, _ in _TAPS], dtype=torch.float32, device=dev)
    yt = y0[..., None] + torch.tensor([dy for _, dy in _TAPS], dtype=torch.float32, device=dev)
    flat = (img[..., None] * (s * s) + torch.clamp(yt, 0, s - 1).long() * s + torch.clamp(xt, 0, s - 1).long())
    taps = slab_flat.index_select(0, flat.reshape(-1)).reshape(*flat.shape, 3).float()  # (B, H, W, 4, 3)
    acc = torch.zeros((B, out_size, out_size, 3), dtype=torch.float32, device=dev)
    for t in range(4):
        w = (1.0 - torch.abs(sx - xt[..., t])) * (1.0 - torch.abs(sy - yt[..., t]))
        # a texel outside the tile's pasted rectangle is canvas fill
        v = ((xt[..., t] >= rect[..., 0]) & (xt[..., t] < rect[..., 2]) & (yt[..., t] >= rect[..., 1])
             & (yt[..., t] < rect[..., 3]))
        acc = acc + w[..., None] * torch.where(v[..., None], taps[..., t, :], FILL)
    return acc


def mosaic_mixup_batch(slab: torch.Tensor, plan: dict, out_size: int) -> torch.Tensor:
    """The augmented batch from the slab and a batch plan (numpy arrays or
    tensors): idx (B, 2, 4), minv (B, 2, 3, 3), center (B, 2, 2), offs
    (B, 2, 4, 2), srect (B, 2, 4, 4) and mixw (B,), the pair axis being
    the mixup partner. Where every mixw is 1 the second composite is
    skipped. Returns (B, out, out, 3) float32 in [0, 1] on the slab's
    device."""
    N, S = slab.shape[0], slab.shape[1]
    slab_flat = slab.reshape(N * S * S, 3)
    p = {k: torch.as_tensor(v).to(slab.device, non_blocking=True) for k, v in plan.items()}

    def comp(j):
        return _composite(slab_flat, S, p["idx"][:, j], p["minv"][:, j], p["center"][:, j], p["offs"][:, j],
                          p["srect"][:, j], out_size)

    a = comp(0)
    w = p["mixw"][:, None, None, None]
    b = a if bool((torch.as_tensor(plan["mixw"]) >= 1.0).all()) else comp(1)
    return (a * w + b * (1.0 - w)) / 255.0
