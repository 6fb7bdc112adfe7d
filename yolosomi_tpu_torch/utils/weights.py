"""Weight bridge: the JAX package's flax variables -> the port's modules.

`variables` is the JAX package's `{"params": ..., "batch_stats": ...}` tree
as nested dicts of numpy arrays (the caller does the device_get; this
module never imports jax). Each flax leaf path maps to the reference
checkpoint key that the port's modules are named after
(counterpart of yolosomi_tpu/utils/torch_convert.py:39-175, for the rules
the flagship and yolo-somi-dcn need), and each value is transposed to
torch layout (counterpart of yolosomi_tpu/utils/onnx_export.py:35-51).
DCNv3's Dense layers, depthwise conv and LayerNorm map by name; DCNv2's
3-D (P, C, c2) weight keeps its flax layout in the port (models/dcn.py),
so it passes through untransposed.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

_LIST_RE = re.compile(r"^(m|dw|pw|bn_dw|bn_pw)(\d+)$")


def _path_to_key(path: List[str], collection: str) -> str:
    """One flax path -> its primary torch key."""
    parts = []
    for p in path[:-1]:
        if p.startswith("layers_"):
            parts.append(f"model.{p.split('_')[1]}")
            continue
        m = _LIST_RE.match(p)
        parts.append(f"{m.group(1)}.{m.group(2)}" if m else p)
    leaf = path[-1]
    key = ".".join(parts)
    # CBAM channel-attention MLP: fc1/fc2 are shared_MLP slots 0 and 2
    key = key.replace(".channel_attention.fc1", ".channel_attention.shared_MLP.0")
    key = key.replace(".channel_attention.fc2", ".channel_attention.shared_MLP.2")
    # SEAM's depthwise-residual stack is one Sequential `DCovN`: patch conv
    # [0], its BN [2], then per repeat i at [3+i]: Residual(fn=[conv, GELU,
    # BN]) [0], pointwise conv [1], its BN [3]
    key = key.replace(".dcov_patch", ".DCovN.0")
    key = key.replace(".bn_patch", ".DCovN.2")
    key = re.sub(r"\.bn_dw\.(\d+)", lambda m: f".DCovN.{3 + int(m.group(1))}.0.fn.2", key)
    key = re.sub(r"\.bn_pw\.(\d+)", lambda m: f".DCovN.{3 + int(m.group(1))}.3", key)
    key = re.sub(r"\.dw\.(\d+)", lambda m: f".DCovN.{3 + int(m.group(1))}.0.fn.0", key)
    key = re.sub(r"\.pw\.(\d+)", lambda m: f".DCovN.{3 + int(m.group(1))}.1", key)

    if collection == "batch_stats":
        return _join(key, {"mean": "running_mean", "var": "running_var"}[leaf])
    if leaf in ("kernel", "bias"):
        name = "weight" if leaf == "kernel" else "bias"
        # Conv wraps ConvRaw 'cv' holding nn.Conv 'conv' (X.conv.weight); a
        # bare ConvRaw named 'conv' is a raw Conv2d (X.weight)
        if key.endswith(".cv.conv"):
            return key[: -len(".cv.conv")] + f".conv.{name}"
        if key.endswith(".conv"):
            return key[: -len(".conv")] + f".{name}"
        return _join(key, name)
    if leaf == "scale":  # norm gamma
        return _join(key, "weight")
    return _join(key, leaf)


def _join(key: str, name: str) -> str:
    """`key.name`, or `name` for a leaf of the root module (a DCNv2's own
    weight and bias when the module is loaded on its own)."""
    return f"{key}.{name}" if key else name


def _key_candidates(path: List[str], collection: str) -> List[str]:
    """All torch keys a flax path may map to, primary first. ODConv keeps a
    (K, Cout) bias bank at X.conv.bias where a bare conv has X.bias; SEAM
    and EMA-CBAM hold their fc pair in a Sequential `fc` (slots 0 and 2)."""
    primary = _path_to_key(path, collection)
    out = [primary]
    if path[-1] == "bias" and len(path) >= 2 and path[-2] == "conv":
        out.append(primary[: -len(".bias")] + ".conv.bias")
    for flax_name, seq_name in ((".fc1.", ".fc.0."), (".fc2.", ".fc.2.")):
        if flax_name in primary:
            out.append(primary.replace(flax_name, seq_name))
    return out


def _to_torch_layout(v: np.ndarray, leaf: str, torch_shape: Tuple[int, ...]) -> np.ndarray:
    """Flax layout -> torch layout: ODConv bank (K,kh,kw,I,O) -> (K,O,I,kh,kw),
    HWIO -> OIHW, a Dense kernel -> a 1x1 Conv2d or a Linear weight; a 3-D
    DCNv2 weight (P, C, c2) and 1-D leaves pass through."""
    v = np.asarray(v, np.float32)
    if v.ndim == 5:
        v = v.transpose(0, 4, 3, 1, 2)
    elif v.ndim == 4:
        v = v.transpose(3, 2, 0, 1)
    elif v.ndim == 2 and leaf == "kernel":
        # a Dense kernel always transposes, square ones included; the
        # ODConv (K, Cout) bias bank is not a kernel and passes through
        v = v.T
        if len(torch_shape) == 4:
            v = v[:, :, None, None]
    if tuple(v.shape) != tuple(torch_shape):
        raise ValueError(f"shape mismatch {v.shape} vs {tuple(torch_shape)}")
    return v


def _leaves(tree: dict, prefix=()) -> Iterator[Tuple[List[str], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield list(prefix + (str(k),)), v


@torch.no_grad()
def load_jax_variables(model: torch.nn.Module, variables: dict) -> Tuple[List[str], List[str]]:
    """Copy flax variables into `model` in place (each value cast to the
    parameter's dtype and device). Returns (torch keys left unmatched,
    flax leaves not used), both as lists of names."""
    state = model.state_dict()
    unused: List[str] = []
    matched: Dict[str, bool] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            key = next((k for k in _key_candidates(path, collection) if k in state), None)
            if key is None:
                unused.append(f"{collection}/{'/'.join(path)}")
                continue
            dst = state[key]
            dst.copy_(torch.tensor(_to_torch_layout(value, path[-1], tuple(dst.shape)), dtype=dst.dtype))
            matched[key] = True
    unmatched = [k for k in state if k not in matched and not k.endswith("num_batches_tracked")]
    return unmatched, unused
