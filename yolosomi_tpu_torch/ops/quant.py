"""Post-training int8 quantization of the serving path (counterpart of
yolosomi_tpu/ops/quant.py, with ConvRaw's calib and int8 branches,
yolosomi_tpu/models/layers.py:44-89, :131-160, :192-246).

Symmetric int8: a per-tensor activation scale calibrated from
representative batches (or one per input channel, folded into the weights),
per-output-channel weight scales, int32 accumulation in the hand-written
conv_int8 kernel (ops/int8.py), which quantizes each conv's float input on
its way into shared memory (conv_int8_fused): no int8 copy of x is made. Every models.layers.ConvRaw takes part; the
rest of the graph (ODConv, the DCN blocks, pooling, attention's Dense
layers) stays in the float dtype, as in the JAX package.

    quant = calibrate(model, [batch1, batch2, ...])   # the JAX `quant` collection's tree
    load_quant_scales(model, quant)
    with quant_mode("int8", exclude=("^layers_35/",)):
        preds = model(x)

The scales are keyed by the JAX package's `quant` collection paths
(`{"layers_3": {"cv": {"a_scale": ...}}}`, numpy float32): calibrate
returns that tree, load_quant_scales carries such a tree (the JAX
package's own, device_get) into the model's ConvRaws, and
export_quant_scales carries it back. Exclusion patterns are regexes
searched in each ConvRaw's slash-joined flax path
(utils.weights.conv_raw_paths).

Rounding follows the JAX package: x / s_a, round half to even, clip to
+-127; w / w_scale the same; s_a = max(a_scale, 1e-8) / 127; the output
float(acc) * (s_a * w_scale) + bias in float32, cast to the input's dtype.
The fold compose of that branch (layers.py:227-237) applies only under
FOLD_W_MODE, which the port leaves out by choice (ROADMAP queue A item 9).
"""

from __future__ import annotations

import contextlib
import re
from typing import Iterable, Optional

import numpy as np
import torch
import torch.nn as nn

from yolosomi_tpu_torch.models import layers as L
from yolosomi_tpu_torch.ops.int8 import int8_conv_fused, pack_conv_int8_weights
from yolosomi_tpu_torch.ops.nms import non_max_suppression
from yolosomi_tpu_torch.utils.weights import conv_raw_paths

# the active mode: None, "calib" or "int8", its options, the calibration
# statistics being gathered and the int8 operands of each ConvRaw (a cache
# that lives as long as a quantized_infer_fn)
_STATE = {"mode": None, "exclude": (), "per_channel": False, "stats": None, "cache": None}


def _excluded(path: Optional[str]) -> bool:
    pats = _STATE["exclude"]
    return bool(pats) and path is not None and any(re.search(p, path) for p in pats)


def _hook(m: L.ConvRaw, x: torch.Tensor) -> torch.Tensor:
    """A ConvRaw's forward while a mode is active (L.QUANT_HOOK)."""
    mode = _STATE["mode"]
    if mode == "calib":
        a = x.detach().float().abs()
        v = a.amax(dim=(0, 2, 3)) if _STATE["per_channel"] else a.amax()
        stats = _STATE["stats"]
        stats[m.quant_path] = torch.maximum(stats[m.quant_path], v) if m.quant_path in stats else v
    elif mode == "int8" and m.a_scale is not None and not _excluded(m.quant_path):
        return _int8_forward(m, x)
    return nn.Conv2d.forward(m, x)


def _int8_operands(m: L.ConvRaw):
    """(w_q (N, kh, kw, C/g) int8, w_q packed for the kernel, the output
    scale (N,), the activation scale s_a (scalar or (C,)), bias or None),
    all float32 but the weights, from the module's weights and calibrated
    scale (layers.py:192-223)."""
    a_scale = m.a_scale.float()
    w = m.weight.float()  # (N, C/g, kh, kw)
    if a_scale.dim() == 1:
        # per channel: the (C,) scales folded into the kernel's input
        # channels, group-aware (output channel o of group o // (N/g) reads
        # input channels (o // (N/g)) * C/g + i), then per-output-channel
        # scales of the folded kernel
        s_a = torch.clamp(a_scale, min=1e-8) / 127.0
        cout, cin_g = w.shape[:2]
        idx = (torch.arange(cout, device=w.device) // (cout // m.groups))[:, None] * cin_g \
            + torch.arange(cin_g, device=w.device)[None, :]
        w = w * s_a[idx][:, :, None, None]
    w_scale = torch.clamp(w.abs().amax(dim=(1, 2, 3)), min=1e-8) / 127.0
    w_q = torch.clamp(torch.round(w / w_scale[:, None, None, None]), -127, 127).to(torch.int8)
    if a_scale.dim() == 1:
        scale = w_scale  # JAX's s_a = 1.0: already folded into the kernel
    else:
        s_a = torch.clamp(a_scale, min=1e-8) / 127.0
        scale = s_a * w_scale
    bias = m.bias.float() if m.bias is not None else None
    w_q = w_q.permute(0, 2, 3, 1).contiguous()
    return w_q, pack_conv_int8_weights(w_q, m.groups), scale, s_a, bias


def _int8_forward(m: L.ConvRaw, x: torch.Tensor) -> torch.Tensor:
    """The quantize, the int8 conv and the dequant in one call of the
    fused kernel, on x's NHWC view (a view of a channels_last x; any other
    layout is made channels-last first)."""
    cache = _STATE["cache"]
    ops = cache.get(m) if cache is not None else None
    if ops is None:
        ops = _int8_operands(m)
        if cache is not None:
            cache[m] = ops
    w_q, packed, scale, s_a, bias = ops
    x_nhwc = x.permute(0, 2, 3, 1)
    if x_nhwc.stride(3) != 1:
        x_nhwc = x_nhwc.contiguous()
    y = int8_conv_fused(x_nhwc, s_a, w_q, scale, bias, m.stride, m.padding, m.dilation, m.groups,
                        out_dtype=x.dtype, packed=packed)
    return y.permute(0, 3, 1, 2)


@contextlib.contextmanager
def quant_mode(mode, exclude=(), per_channel: bool = False, _stats: Optional[dict] = None,
               _cache: Optional[dict] = None):
    """Run every ConvRaw in `mode` inside the block: "calib" records each
    conv's input absmax (per input channel with `per_channel`); "int8"
    runs each conv that has a calibrated scale and whose flax path matches
    no `exclude` regex through the int8 conv. Not thread-safe."""
    prev, prev_hook = dict(_STATE), L.QUANT_HOOK[0]
    _STATE.update(mode=mode, exclude=tuple(exclude), per_channel=bool(per_channel), stats=_stats, cache=_cache)
    L.QUANT_HOOK[0] = _hook if mode else None
    try:
        yield
    finally:
        _STATE.update(prev)
        L.QUANT_HOOK[0] = prev_hook


def _attach_paths(model: nn.Module) -> dict:
    """{flax path: ConvRaw}, each ConvRaw told its path."""
    out = {}
    for path, m in conv_raw_paths(model):
        m.quant_path = path
        out[path] = m
    return out


def _batch_input(model: nn.Module, batch) -> torch.Tensor:
    """A (B, H, W, 3) batch (uint8, or float in [0, 1]) -> the model's
    NCHW input in its dtype, on its device."""
    p = next(model.parameters())
    x = torch.as_tensor(np.ascontiguousarray(batch)).to(p.device)
    x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
    return x.to(p.dtype).permute(0, 3, 1, 2)


@torch.no_grad()
def calibrate(model: nn.Module, batches: Iterable, per_channel: bool = False) -> dict:
    """Run representative (B, H, W, 3) batches (uint8 is divided by 255)
    through the model in eval mode in calib mode and return the `quant`
    tree: each ConvRaw's input absmax, the largest over the batches, as
    `a_scale` at its flax path (a scalar, or (Cin,) with `per_channel`)."""
    _attach_paths(model)
    was_training = model.training
    model.eval()
    stats: dict = {}
    try:
        with quant_mode("calib", per_channel=per_channel, _stats=stats):
            for batch in batches:
                model(_batch_input(model, batch))
    finally:
        model.train(was_training)
    if not stats:
        raise ValueError("calibration produced no statistics (no ConvRaw on the path?)")
    tree: dict = {}
    for path, v in stats.items():
        node = tree
        for part in path.split("/"):
            node = node.setdefault(part, {})
        node["a_scale"] = v.cpu().numpy().astype(np.float32)
    return tree


def _quant_leaves(tree: dict, prefix=()):
    for k, v in tree.items():
        if k == "a_scale":
            yield "/".join(prefix), v
        elif isinstance(v, dict):
            yield from _quant_leaves(v, prefix + (k,))


def load_quant_scales(model: nn.Module, quant: dict) -> None:
    """Carry a `quant` tree (this module's calibrate, or the JAX package's
    collection as numpy) into the model: each ConvRaw's `a_scale`, None for
    the convs the tree does not name. Raises on a path that is not a
    ConvRaw of the model."""
    convs = _attach_paths(model)
    for m in convs.values():
        m.a_scale = None
    for path, v in _quant_leaves(quant):
        if path not in convs:
            raise KeyError(f"quant scale at {path}: the model has no ConvRaw there")
        m = convs[path]
        m.a_scale = torch.tensor(np.asarray(v, np.float32), device=m.weight.device)


def export_quant_scales(model: nn.Module) -> dict:
    """The model's calibrated scales as the JAX package's `quant` tree."""
    tree: dict = {}
    for path, m in conv_raw_paths(model):
        if m.a_scale is None:
            continue
        node = tree
        for part in path.split("/"):
            node = node.setdefault(part, {})
        node["a_scale"] = m.a_scale.float().cpu().numpy()
    return tree


def quantized_infer_fn(runner, calib_images, exclude=(), per_channel: bool = False, **nms_kw):
    """Calibrate `runner`'s model on `calib_images` (uint8 NHWC), load the
    scales into it, and return fn(images) -> numpy (B, max_det, 6)
    detections through the int8 convs, decoded and suppressed by
    non_max_suppression(**nms_kw). `exclude`: flax path regexes kept in
    float; `per_channel`: per-channel activation scales. The returned fn
    quantizes each conv's weights at its first call and keeps them: it
    serves the weights the model holds when it is built."""
    load_quant_scales(runner.model, calibrate(runner.model, [calib_images], per_channel=per_channel))
    cache: dict = {}

    @torch.inference_mode()
    def fn(images) -> np.ndarray:
        with quant_mode("int8", exclude=exclude, _cache=cache):
            preds = runner.forward(images)
        return non_max_suppression(runner.decode(preds), **nms_kw).cpu().numpy()

    return fn
