"""The RT-DETR decoder (counterpart of yolosomi_tpu/models/rtdetr.py): the
multi-level input projection, anchor proposals with top-k query
selection, ndl decoder layers of self-attention, multi-scale deformable
cross-attention and an FFN with iterative box refinement; NMS-free
output (B, nq, 4 + nc): sigmoid cxcywh in [0, 1] and per-class sigmoid
scores.

The deformable sampling is gathers with the `|1 - |p - c||` corner
weights and zero outside the map (rtdetr.py:47-72), not grid_sample, whose
border rules differ. Top-k selections keep jax.lax.top_k's order (the
lower index first among equal values). Names follow the flax modules'
(`input_proj<i>_conv`, `layer<i>`, `dec_bbox_head<i>`, ...); the flax
MultiHeadDotProductAttention's DenseGeneral kernels keep their flax
shapes (DenseGeneral below), so the weight bridge maps every leaf by name.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from yolosomi_tpu_torch.ops.nms import top_k
from yolosomi_tpu_torch.models.layers import FlaxBatchNorm2d

LN_EPS = 1e-6  # flax LayerNorm's epsilon


def layer_norm(c: int) -> nn.LayerNorm:
    return nn.LayerNorm(c, eps=LN_EPS)


class MLP(nn.Module):
    """num_layers Linear layers `l<i>` with ReLU between them."""

    def __init__(self, c1: int, hidden: int, out: int, num_layers: int = 3):
        super().__init__()
        dims = [c1] + [hidden] * (num_layers - 1) + [out]
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"l{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"l{i}")(x)
            if i < self.num_layers - 1:
                x = torch.relu(x)
        return x


class DenseGeneral(nn.Module):
    """flax.linen.DenseGeneral of the attention projections, its kernel in
    flax's shape: `in_dims` contracted axes, then the output axes (query /
    key / value: (hd, nh, dh); out: (nh, dh, hd))."""

    def __init__(self, in_shape: Tuple[int, ...], out_shape: Tuple[int, ...]):
        super().__init__()
        self.in_dims = len(in_shape)
        self.weight = nn.Parameter(torch.zeros(*in_shape, *out_shape))
        self.bias = nn.Parameter(torch.zeros(*out_shape))

    def forward(self, x):
        dims = list(range(x.dim() - self.in_dims, x.dim()))
        return torch.tensordot(x, self.weight.to(x.dtype), dims=(dims, list(range(self.in_dims)))) + \
            self.bias.to(x.dtype)


class FlaxMHA(nn.Module):
    """flax.linen.MultiHeadDotProductAttention (no mask, no dropout): q, k
    and v projected per head, softmax(q k^T / sqrt(dh)) v, projected back."""

    def __init__(self, hd: int, nh: int):
        super().__init__()
        dh = hd // nh
        self.query, self.key, self.value = (DenseGeneral((hd,), (nh, dh)) for _ in range(3))
        self.out = DenseGeneral((nh, dh), (hd,))

    def forward(self, q, k, v):
        q, k, v = self.query(q), self.key(k), self.value(v)  # (B, N, nh, dh)
        q = q / math.sqrt(q.shape[-1])
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), -1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v))


def _bilinear_sample_level(value: torch.Tensor, loc: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Sample (B, h*w, C) level features at normalized locations loc
    (B, Q, P, 2) in [0, 1] (pixel centres at (i + 0.5) / w) -> (B, Q, P, C);
    taps outside the map contribute zero (rtdetr.py:47)."""
    b, _, c = value.shape
    px = loc[..., 0] * w - 0.5
    py = loc[..., 1] * h - 0.5
    x0, y0 = torch.floor(px), torch.floor(py)
    out = 0.0
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xc, yc = x0 + dx, y0 + dy
        wgt = torch.abs(1.0 - torch.abs(px - xc)) * torch.abs(1.0 - torch.abs(py - yc))
        inb = (xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1)
        flat = torch.clamp(yc, 0, h - 1).long() * w + torch.clamp(xc, 0, w - 1).long()  # (B, Q, P)
        tap = torch.gather(value, 1, flat.reshape(b, -1, 1).expand(-1, -1, c)).reshape(*flat.shape, c)
        out = out + tap * (wgt * inb)[..., None]
    return out


class DeformableAttention(nn.Module):
    """Multi-scale deformable cross-attention (rtdetr.py:75): each head
    samples ndp points per level at learned offsets around the reference
    box and mixes them with learned softmax weights."""

    def __init__(self, hd: int = 256, nh: int = 8, nl: int = 3, ndp: int = 4):
        super().__init__()
        self.hd, self.nh, self.nl, self.ndp = hd, nh, nl, ndp
        self.sampling_offsets = nn.Linear(hd, nh * nl * ndp * 2)
        self.attention_weights = nn.Linear(hd, nh * nl * ndp)
        self.value_proj = nn.Linear(hd, hd)
        self.output_proj = nn.Linear(hd, hd)

    def forward(self, query, refer_bbox, feats, shapes):
        b, q, _ = query.shape
        nh, nl, P = self.nh, len(shapes), self.ndp
        dh = self.hd // nh
        offsets = self.sampling_offsets(query).reshape(b, q, nh, nl, P, 2)
        weights = torch.softmax(self.attention_weights(query).reshape(b, q, nh, nl * P), -1).reshape(b, q, nh, nl, P)
        value = self.value_proj(feats)
        center = refer_bbox[:, :, None, None, None, :2]
        wh = refer_bbox[:, :, None, None, None, 2:]
        loc = center + offsets.float() / P * wh * 0.5  # (B, Q, nh, nl, P, 2), in float32 as the boxes
        heads = []
        for hi in range(nh):
            acc, start = 0.0, 0
            for li, (h, w) in enumerate(shapes):
                v = value[:, start:start + h * w, hi * dh:(hi + 1) * dh]
                start += h * w
                tap = _bilinear_sample_level(v, loc[:, :, hi, li], h, w)
                acc = acc + (tap * weights[:, :, hi, li, :, None]).sum(2)
            heads.append(acc)
        return self.output_proj(torch.stack(heads, 2).reshape(b, q, self.hd).to(query.dtype))


class DecoderLayer(nn.Module):
    """Self-attention, deformable cross-attention and a ReLU FFN, each with
    its residual and a LayerNorm after it (rtdetr.py:120)."""

    def __init__(self, hd: int = 256, nh: int = 8, d_ffn: int = 1024, nl: int = 3, ndp: int = 4):
        super().__init__()
        self.self_attn = FlaxMHA(hd, nh)
        self.norm1 = layer_norm(hd)
        self.cross_attn = DeformableAttention(hd, nh, nl, ndp)
        self.norm2 = layer_norm(hd)
        self.linear1 = nn.Linear(hd, d_ffn)
        self.linear2 = nn.Linear(d_ffn, hd)
        self.norm3 = layer_norm(hd)

    def forward(self, embed, refer_bbox, feats, shapes, query_pos):
        q = embed + query_pos
        embed = self.norm1(embed + self.self_attn(q, q, embed))
        embed = self.norm2(embed + self.cross_attn(embed + query_pos, refer_bbox, feats, shapes))
        return self.norm3(embed + self.linear2(torch.relu(self.linear1(embed))))


class RTDETRDecoder(nn.Module):
    """NMS-free detection decoder over the FPN levels (rtdetr.py:146).
    Returns (B, nq, 4 + nc): sigmoid cxcywh in [0, 1] units and per-class
    sigmoid scores. Anchors outside (0.01, 0.99) have their memory rows
    zeroed and +inf logits: a query picked there starts from the reference
    box sigmoid(inf) = 1, and the refinement's 1e-9 terms keep it finite."""

    def __init__(self, nc: int, ch: Sequence[int], hd: int = 256, nq: int = 300, ndp: int = 4, nh: int = 8,
                 ndl: int = 6, d_ffn: int = 1024):
        super().__init__()
        self.nc, self.hd, self.nq, self.ndl = nc, hd, nq, ndl
        for i, c in enumerate(ch):
            self.add_module(f"input_proj{i}_conv", nn.Conv2d(c, hd, 1, bias=False))
            self.add_module(f"input_proj{i}_bn", FlaxBatchNorm2d(hd, eps=1e-3, momentum=0.03))
        self.enc_output = nn.Linear(hd, hd)
        self.enc_norm = layer_norm(hd)
        self.enc_score_head = nn.Linear(hd, nc)
        self.enc_bbox_head = MLP(hd, hd, 4, 3)
        self.query_pos_head = MLP(4, 2 * hd, hd, 2)
        for li in range(ndl):
            self.add_module(f"layer{li}", DecoderLayer(hd, nh, d_ffn, len(ch), ndp))
            self.add_module(f"dec_bbox_head{li}", MLP(hd, hd, 4, 3))
        self.add_module(f"dec_score_head{ndl - 1}", nn.Linear(hd, nc))

    def forward(self, xs: List[torch.Tensor]) -> torch.Tensor:
        b = xs[0].shape[0]
        shapes = tuple((x.shape[2], x.shape[3]) for x in xs)
        feats = []
        for i, x in enumerate(xs):
            p = getattr(self, f"input_proj{i}_bn")(getattr(self, f"input_proj{i}_conv")(x))
            feats.append(p.permute(0, 2, 3, 1).reshape(b, -1, self.hd))
        feats = torch.cat(feats, 1)  # (B, sum HW, hd)

        # anchor proposals: grid centres, 0.05 * 2^level sizes, logit space, invalid -> +inf
        dev = feats.device
        anchors = []
        for li, (h, w) in enumerate(shapes):
            gy, gx = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij")
            xy = torch.stack([(gx + 0.5) / w, (gy + 0.5) / h], -1).reshape(-1, 2).float()
            anchors.append(torch.cat([xy, torch.full((h * w, 2), 0.05 * 2.0 ** li, device=dev)], -1))
        anchors = torch.cat(anchors, 0)[None]  # (1, sum HW, 4)
        eps = 1e-2
        valid = ((anchors > eps) & (anchors < 1 - eps)).all(-1, keepdim=True)
        anchors = torch.where(valid, torch.log(anchors / (1 - anchors)), torch.inf)

        memory = torch.where(valid, feats, torch.zeros((), dtype=feats.dtype, device=dev))
        memory = self.enc_norm(self.enc_output(memory))
        enc_scores = self.enc_score_head(memory)
        _, top_i = top_k(enc_scores.amax(-1), self.nq)  # (B, nq)
        top_feats = torch.gather(memory, 1, top_i[..., None].expand(-1, -1, self.hd))
        top_anchors = torch.gather(anchors.expand(b, -1, -1), 1, top_i[..., None].expand(-1, -1, 4))
        # the reference boxes stay float32 whatever the compute dtype, as
        # JAX promotes the model dtype's sums with the float32 anchors
        refer_bbox = torch.sigmoid(self.enc_bbox_head(top_feats).float() + top_anchors)

        embed, refer = top_feats.detach(), refer_bbox.detach()
        for li in range(self.ndl):
            query_pos = self.query_pos_head(refer.to(embed.dtype))  # from the refined boxes, shared weights
            embed = getattr(self, f"layer{li}")(embed, refer, feats, shapes, query_pos)
            delta = getattr(self, f"dec_bbox_head{li}")(embed)
            refer = torch.sigmoid(delta.float() + torch.log(refer / (1 - refer + 1e-9) + 1e-9))
        scores = torch.sigmoid(getattr(self, f"dec_score_head{self.ndl - 1}")(embed))
        return torch.cat([refer, scores.float()], -1)
