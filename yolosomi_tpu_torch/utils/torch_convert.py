"""The reference's PyTorch state dicts <-> the port's weights (counterpart
of yolosomi_tpu/utils/torch_convert.py and of onnx_export.py:35-91's
`state_dict_from_variables`).

Weights in: `convert_state_dict` fills a flax variable tree (nested dicts
of numpy arrays; the template is `utils.weights.export_jax_variables` of
the model to fill) from a reference state dict, by the JAX package's key
rules, copied here (torch_convert.py:39-175): for each flax leaf, the
torch keys it may have, the first one the state dict holds with a shape
that converts. A leaf that nothing matches keeps its template value and is
reported; `strict=True` raises KeyError instead. The filled tree loads
into the model through `utils.weights.load_jax_variables`, or is written
as a weights file (convert_torch.py). `anchors_from_state_dict` reads the
head's grid-unit `anchors` buffer back as pixels.

Weights out: `reference_state_dict` writes the reference's state dict
from the port's own modules, whose keys and layouts are the reference's
for the graphs the JAX package's torch mirror covers
(yolosomi_tpu/utils/torch_mirror.py:480-510, MIRRORED here): every
tensor as float32 numpy (BatchNorm's `num_batches_tracked` as int64), and
the head's `anchors` buffer in grid units. Another graph raises
NotImplementedError, as the JAX package's mirror does.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from yolosomi_tpu_torch.utils.general import LOGGER

_LIST_RE = re.compile(r"^(m|dw|pw|bn_dw|bn_pw|ia|im|tr)(\d+)$")

# the rows and heads of the JAX package's torch mirror (torch_mirror.py:480-508)
MIRRORED = ("Conv", "DWConv", "Focus", "Bottleneck", "C3", "C2fCBAM", "C2fEMACBAM", "C2fEACBAM", "SPP", "SPPF",
            "ODConv", "ODConv_3rd", "SEAM", "BiFPN", "nn.Upsample", "Upsample", "Concat")
MIRRORED_HEADS = ("Detect", "DecoupledDetect", "DecoupledDetect1", "Decoupled_Detect")


def _path_to_torch_key(path: List[str], collection: str) -> str:
    """One flax tree path -> the reference state dict's key for it."""
    parts = []
    for p in path[:-1]:
        if p.startswith("layers_"):
            parts.append(f"model.{p.split('_')[1]}")
            continue
        m = _LIST_RE.match(p)
        parts.append(f"{m.group(1)}.{m.group(2)}" if m else p)
    leaf = path[-1]
    key = ".".join(parts)
    # CBAM's channel-attention MLP: fc1 / fc2 are shared_MLP's slots 0 and 2
    key = key.replace(".channel_attention.fc1", ".channel_attention.shared_MLP.0")
    key = key.replace(".channel_attention.fc2", ".channel_attention.shared_MLP.2")
    # SEAM's depthwise-residual stack is one Sequential DCovN: patch conv [0],
    # its BN [2], then per repeat i at [3+i] Residual(fn=[conv, GELU, BN]),
    # a pointwise conv at [1] and its BN at [3]
    key = key.replace(".dcov_patch", ".DCovN.0")
    key = key.replace(".bn_patch", ".DCovN.2")
    key = re.sub(r"\.bn_dw\.(\d+)", lambda m: f".DCovN.{3 + int(m.group(1))}.0.fn.2", key)
    key = re.sub(r"\.bn_pw\.(\d+)", lambda m: f".DCovN.{3 + int(m.group(1))}.3", key)
    key = re.sub(r"\.dw\.(\d+)", lambda m: f".DCovN.{3 + int(m.group(1))}.0.fn.0", key)
    key = re.sub(r"\.pw\.(\d+)", lambda m: f".DCovN.{3 + int(m.group(1))}.1", key)
    # head lists whose flax stem is not the torch attribute: ASFF_Detect's
    # `asffs`, IAuxDetect's `m2`
    key = re.sub(r"(^|\.)asff(\d+)\.", lambda m: f"{m.group(1)}asffs.{m.group(2)}.", key)
    key = re.sub(r"(^|\.)m2_(\d+)\.", lambda m: f"{m.group(1)}m2.{m.group(2)}.", key)
    # TSCODE_Detect's six per-level lists, their inner Sequentials flattened by flax
    key = re.sub(
        r"(^|\.)m_(sce|dpe|cls|reg_conf|reg|conf)(\d+)(?:_(\d+))?\.",
        lambda m: f"{m.group(1)}m_{m.group(2)}.{m.group(3)}." + (f"{m.group(4)}." if m.group(4) is not None else ""),
        key,
    )
    # DPE's up_forp2 / up_forp3 are Sequential(Upsample, Conv): the Conv is slot 1
    key = key.replace(".up_forp2.", ".up_forp2.1.").replace(".up_forp3.", ".up_forp3.1.")
    # Swin's Mlp: flax's flat mlp_fc1 / mlp_fc2 live in the `mlp` submodule
    key = key.replace(".mlp_fc1", ".mlp.fc1").replace(".mlp_fc2", ".mlp.fc2")
    # the DFL heads' per-level Sequential branches cv2.<i>.<j> / cv3.<i>.<j>
    key = re.sub(
        r"(^|\.)(one2one_)?(cv2|cv3)_(\d+)_(\d+)\.",
        lambda m: f"{m.group(1)}{m.group(2) or ''}{m.group(3)}.{m.group(4)}.{m.group(5)}.",
        key,
    )

    if collection == "batch_stats":
        return key + {"mean": ".running_mean", "var": ".running_var"}[leaf]
    if leaf in ("kernel", "bias"):
        # Conv wraps ConvRaw 'cv' holding nn.Conv 'conv' (X.conv.weight); a
        # bare ConvRaw named 'conv' is a raw Conv2d (X.weight)
        name = "weight" if leaf == "kernel" else "bias"
        if key.endswith(".cv.conv"):
            return key[: -len(".cv.conv")] + f".conv.{name}"
        if key.endswith(".conv"):
            return key[: -len(".conv")] + f".{name}"
        return f"{key}.{name}"
    if leaf == "scale":  # a norm's gamma
        return key + ".weight"
    return f"{key}.{leaf}"


def _torch_key_candidates(path: List[str], collection: str) -> List[str]:
    """Every torch key a flax path may have, primary first; the state
    dict's own keys and the shapes decide among them. A flax `X/conv/bias`
    is a bare conv's X.bias or ODConv's (K, c2) bias bank X.conv.bias;
    fc1 / fc2 are direct attributes in some blocks and slots 0 / 2 of a
    Sequential `fc` in others; ASFF's add_conv names its BatchNorm
    `batch_norm`; GhostBottleneck wraps its stages in Sequentials `conv` /
    `shortcut`; CIB and PSA in `cv1` / `ffn`; a repeated plain row is an
    anonymous Sequential, whose copies flax names mods_<i>."""
    primary = _path_to_torch_key(path, collection).lstrip(".")  # a root-level leaf has no module prefix
    out = [primary]
    if path[-1] == "bias" and len(path) >= 2 and path[-2] == "conv":
        out.append(f"{primary[: -len('.bias')]}.conv.bias")
    for flax_name, seq_name in ((".fc1.", ".fc.0."), (".fc2.", ".fc.2.")):
        if flax_name in primary:
            out.append(primary.replace(flax_name, seq_name))
    if ".bn." in primary:
        out.append(primary.replace(".bn.", ".batch_norm."))
    for pat, rep in ((r"(^|\.)conv1\.", r"\1conv.0."), (r"(^|\.)dw\.", r"\1conv.1."), (r"(^|\.)conv2\.", r"\1conv.2."),
                     (r"(^|\.)sc_dw\.", r"\1shortcut.0."), (r"(^|\.)sc_pw\.", r"\1shortcut.1.")):
        alt = re.sub(pat, rep, primary)
        if alt != primary:
            out.append(alt)
    for pat, rep in ((r"(^|\.)(cv1|ffn)_(\d+)\.", lambda m: f"{m.group(1)}{m.group(2)}.{m.group(3)}."),
                     (r"\.mods_(\d+)\.", lambda m: f".{m.group(1)}.")):
        alt = re.sub(pat, rep, primary)
        if alt != primary:
            out.append(alt)
    return out


def _convert_leaf(value, our_shape: Tuple[int, ...], leaf: str = "") -> np.ndarray:
    """A torch tensor's layout -> the flax leaf's: ODConv banks
    (K,O,I,kh,kw) -> (K,kh,kw,I,O), a 1x1-conv attention head -> a Dense
    kernel, ImplicitA / M's (1,C,1,1) -> (1,1,1,C), OIHW -> HWIO, a Dense
    (out,in) -> (in,out). Raises ValueError where the shape does not fit."""
    v = np.asarray(value, np.float32)
    if v.ndim == 5:
        v = v.transpose(0, 3, 4, 2, 1)
    elif v.ndim == 4 and len(our_shape) == 2 and v.shape[2:] == (1, 1):
        v = v[:, :, 0, 0].T
    elif v.ndim == 4 and v.shape[0] == 1 and v.shape[2:] == (1, 1) and tuple(our_shape[:3]) == (1, 1, 1):
        v = v.transpose(0, 2, 3, 1)
    elif v.ndim == 4:
        v = v.transpose(2, 3, 1, 0)
    elif v.ndim == 2 and (leaf == "kernel" or tuple(v.shape) != tuple(our_shape)):
        # a Dense kernel always transposes, square ones too; ODConv's
        # same-shape (K, c2) bias bank passes through
        v = v.T
    if tuple(v.shape) != tuple(our_shape):
        raise ValueError(f"shape mismatch {v.shape} vs {tuple(our_shape)}")
    return np.ascontiguousarray(v)


def _sorted_leaves(tree: dict, prefix=()) -> Iterator[Tuple[List[str], np.ndarray]]:
    """The tree's leaves in jax.tree_util's order (dict keys sorted)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _sorted_leaves(v, prefix + (str(k),))
        else:
            yield list(prefix + (str(k),)), v


def convert_state_dict(torch_sd: Dict[str, np.ndarray], variables: dict, strict: bool = False) -> dict:
    """A new flax variable tree: each leaf of `variables` from the state
    dict's tensor of its key, converted to flax layout as float32, or the
    template's own value where no key matches (logged). `strict` raises
    KeyError on any such leaf."""
    out: dict = {"params": {}, "batch_stats": {}}
    matched, misses = 0, []
    for collection in ("params", "batch_stats"):
        for path, leaf in _sorted_leaves(variables.get(collection, {})):
            hit, err = None, None
            for tk in _torch_key_candidates(path, collection):
                if tk not in torch_sd:
                    continue
                try:
                    hit = _convert_leaf(torch_sd[tk], np.shape(leaf), leaf=path[-1])
                    break
                except ValueError as e:
                    err = f"{tk}: {e}"
            if hit is not None:
                matched += 1
            else:
                misses.append(err or _path_to_torch_key(path, collection))
            node = out[collection]
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = hit if hit is not None else leaf
    LOGGER.info(f"torch_convert: matched {matched}, missed {len(misses)} leaves")
    if misses:
        LOGGER.info("torch_convert: first misses: " + "; ".join(misses[:8]))
    if strict and misses:
        raise KeyError(f"{len(misses)} unmatched leaves, e.g. {misses[:5]}")
    return out


def anchors_from_state_dict(torch_sd: Dict[str, np.ndarray], strides) -> Optional[np.ndarray]:
    """The pixel anchors (nl, na, 2) of a state dict's head buffer, which
    the reference keeps in grid units (anchors / stride); None without one."""
    for k, v in torch_sd.items():
        if k.endswith(".anchors"):
            return np.asarray(v, np.float32) * np.asarray(strides, np.float32)[:, None, None]
    return None


def _host(t: torch.Tensor) -> np.ndarray:
    """A float32 numpy copy of a floating tensor (int64 for a count)."""
    dtype = torch.float32 if t.is_floating_point() else t.dtype
    return t.detach().to("cpu", dtype, copy=True, memory_format=torch.contiguous_format).numpy()


@torch.no_grad()
def reference_state_dict(model: nn.Module, meta) -> Dict[str, np.ndarray]:
    """The reference's state dict of a port model, key for key the JAX
    package's `state_dict_from_variables` on its torch mirror: float32
    numpy tensors, `num_batches_tracked` as int64, and the head's
    `anchors` buffer (grid units). Distillation's
    adapters are left out. Raises NotImplementedError for a graph outside
    the mirror (MIRRORED, MIRRORED_HEADS)."""
    last = len(meta.specs) - 1
    outside = [f"row {s.i}: {s.name}" for s in meta.specs
               if s.name not in (MIRRORED_HEADS if s.i == last and meta.nl else MIRRORED)]
    if outside or not meta.nl:
        raise NotImplementedError("no reference state dict for: " + (", ".join(outside) or "a headless graph")
                                  + " (the JAX package's torch mirror covers the yolov5 family graphs)")
    strides = np.asarray([int(s) for s in meta.strides], np.float32)
    out = {k: _host(v) for k, v in model.state_dict().items() if not k.startswith("kd_adapter_")}
    out[f"model.{last}.anchors"] = np.array(meta.anchors_px, np.float32) / strides[:, None, None]
    return out
