"""Weight bridge: the JAX package's flax variables <-> the port's modules.

`variables` is the JAX package's `{"params": ..., "batch_stats": ...}` tree
as nested dicts of numpy arrays (the caller does the device_get; this
module never imports jax). Each flax leaf path maps to the reference
checkpoint key that the port's modules are named after
(counterpart of yolosomi_tpu/utils/torch_convert.py:39-175, for the rules
the detection family the port serves needs; a repeated row's flax copies
`mods_<i>` are the <i>th module of its nn.Sequential), and each value is
transposed to torch layout (counterpart of
yolosomi_tpu/utils/onnx_export.py:35-51).
DCNv3's Dense layers, depthwise conv and LayerNorm map by name; DCNv2's
3-D (P, C, c2) weight keeps its flax layout in the port (models/dcn.py),
so it passes through untransposed.

`export_jax_variables` is the inverse: a port model -> the flax tree, with
flax paths, flax layouts and float32 numpy values, for the checkpoint
writers (engine/checkpoint.py). Where the forward map is many-to-one, the
module types decide: L.Conv's Conv2d is the flax `cv/conv`, any other
Conv2d a bare ConvRaw `<name>/conv`, except DCNv2's `conv_offset_mask` and
DCNv3's `dw_conv` (flax nn.Conv, no wrapper) and EMA-CBAM's `fc` pair
(flax Dense kernels held as 1x1 Conv2d).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from yolosomi_tpu_torch.models import dcn as D
from yolosomi_tpu_torch.models import layers as L

_LIST_RE = re.compile(r"^(m|dw|pw|bn_dw|bn_pw)(\d+)$")


def _path_to_key(path: List[str], collection: str) -> str:
    """One flax path -> its primary torch key."""
    parts = []
    for p in path[:-1]:
        if p.startswith("layers_"):
            parts.append(f"model.{p.split('_')[1]}")
            continue
        if p.startswith("mods_"):  # the copies of a repeated row (JAX's _Repeat): an nn.Sequential
            parts.append(p.split("_")[1])
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


# ---------------------------------------------------------------------------
# the inverse: port model -> flax variables
# ---------------------------------------------------------------------------

# torch module path -> flax path, applied in order to the dotted path of the
# module that holds a leaf (the inverse of _path_to_key's rewrites)
_INVERSE_RE = (
    (re.compile(r"^model\.(\d+)"), lambda m: f"layers_{m.group(1)}"),
    (re.compile(r"^(layers_\d+)\.(\d+)"), lambda m: f"{m.group(1)}.mods_{m.group(2)}"),
    (re.compile(r"\.DCovN\.(\d+)\.0\.fn\.0$"), lambda m: f".dw{int(m.group(1)) - 3}"),
    (re.compile(r"\.DCovN\.(\d+)\.0\.fn\.2$"), lambda m: f".bn_dw{int(m.group(1)) - 3}"),
    (re.compile(r"\.DCovN\.0$"), lambda m: ".dcov_patch"),
    (re.compile(r"\.DCovN\.2$"), lambda m: ".bn_patch"),
    (re.compile(r"\.DCovN\.(\d+)\.1$"), lambda m: f".pw{int(m.group(1)) - 3}"),
    (re.compile(r"\.DCovN\.(\d+)\.3$"), lambda m: f".bn_pw{int(m.group(1)) - 3}"),
    (re.compile(r"\.(?:shared_MLP|fc)\.([02])$"), lambda m: f".fc{int(m.group(1)) // 2 + 1}"),
    (re.compile(r"\.m\.(\d+)"), lambda m: f".m{m.group(1)}"),
)
_NORMS = (nn.BatchNorm1d, nn.BatchNorm2d, nn.GroupNorm, nn.LayerNorm)


def _flax_leaf(model: nn.Module, key: str) -> Tuple[str, List[str], Callable[[torch.Tensor], torch.Tensor]]:
    """One torch state key -> (collection, flax path, torch-to-flax layout)."""
    prefix, name = key.rsplit(".", 1) if "." in key else ("", key)
    mod = model.get_submodule(prefix)
    path = prefix
    for pattern, repl in _INVERSE_RE:
        path = pattern.sub(repl, path)
    same = lambda t: t  # noqa: E731
    layout = same
    if isinstance(mod, nn.Conv2d):
        parent = model.get_submodule(prefix.rsplit(".", 1)[0]) if "." in prefix else model
        dense = re.search(r"\.fc[12]$", path) is not None  # EMA-CBAM's fc pair: flax Dense
        if isinstance(parent, L.Conv):
            path = path[: -len(".conv")] + ".cv.conv"
        elif not (dense or isinstance(parent, (D.DCNv2, D.DCNv3))):
            path += ".conv"
        if name == "weight":
            layout = (lambda t: t[:, :, 0, 0].T) if dense else (lambda t: t.permute(2, 3, 1, 0))
    elif isinstance(mod, nn.Linear) and name == "weight":
        layout = lambda t: t.T  # noqa: E731
    elif isinstance(mod, L.ODConv2d) and name == "weight":
        layout = lambda t: t.permute(0, 3, 4, 2, 1)  # noqa: E731  (K,O,I,kh,kw) -> (K,kh,kw,I,O)
    collection = "params"
    if isinstance(mod, _NORMS) and name in ("running_mean", "running_var"):
        collection, name = "batch_stats", {"running_mean": "mean", "running_var": "var"}[name]
    elif isinstance(mod, _NORMS) and name == "weight":
        name = "scale"
    elif isinstance(mod, (nn.Conv2d, nn.Linear)) and name == "weight":
        name = "kernel"
    return collection, [p for p in path.split(".") if p] + [name], layout


def without_adapters(unused: List[str]) -> List[str]:
    """Flax leaves a model left unused, less distillation's FitNets adapters
    (`params/kd_adapter_<i>`, engine/distill.py): training-only leaves of a
    hint-distilled student's file, which flax's apply ignores too."""
    return [u for u in unused if not u.startswith("params/kd_adapter_")]


def conv_raw_paths(model: nn.Module) -> List[Tuple[str, nn.Module]]:
    """[(flax path, module)] of the model's ConvRaws, in module order: the
    slash-joined path of the JAX package's ConvRaw (its kernel's flax path
    without `conv/kernel`), which int8 exclusion patterns and the `quant`
    collection are keyed by (e.g. `layers_3/cv`, `layers_35/m0/b3`)."""
    out = []
    for name, m in model.named_modules():
        if isinstance(m, L.ConvRaw):
            path = _flax_leaf(model, f"{name}.weight")[1]
            if path[-2:] != ["conv", "kernel"]:
                raise ValueError(f"{name} maps to {'/'.join(path)}, not a ConvRaw's conv/kernel")
            out.append(("/".join(path[:-2]), m))
    return out


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A contiguous float32 numpy copy of `t` on the host. Always a copy:
    `.float().cpu().contiguous()` returns the tensor itself for a
    contiguous float32 CPU tensor, and a numpy view of live model state
    would change under the optimizer's and the EMA's in-place updates."""
    return t.detach().to("cpu", torch.float32, copy=True, memory_format=torch.contiguous_format).numpy()


@torch.no_grad()
def export_jax_variables(model: nn.Module) -> dict:
    """The port model's weights as the JAX package's flax variables
    `{"params": ..., "batch_stats": ...}`: nested dicts of float32 numpy
    arrays in flax layout, which load_jax_variables maps back exactly.
    Every array is a copy that shares no memory with the model."""
    variables: dict = {"params": {}, "batch_stats": {}}
    for key, value in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        collection, path, layout = _flax_leaf(model, key)
        if key not in _key_candidates(path, collection):
            raise ValueError(f"{key} exports to {collection}/{'/'.join(path)}, which does not load back to it")
        node = variables[collection]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _host_copy(layout(value))
    return variables


def export_param_tree(model: nn.Module, names: List[str], tensors: List[torch.Tensor]) -> dict:
    """Per-parameter tensors (optimizer buffers, gradients) laid out as the
    flax `params` tree of `model`'s parameters `names`: flax paths, flax
    layouts, float32 numpy copies."""
    tree: dict = {}
    for name, t in zip(names, tensors):
        _, path, layout = _flax_leaf(model, name)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _host_copy(layout(t.detach()))
    return tree


def import_param_tree(model: nn.Module, names: List[str], tree: dict) -> List[torch.Tensor]:
    """The inverse of export_param_tree: a flax `params`-shaped tree ->
    one float32 CPU tensor per parameter name, in torch layout."""
    params = dict(model.named_parameters())
    out = []
    for name in names:
        _, path, _ = _flax_leaf(model, name)
        node = tree
        for p in path:
            node = node[p]
        out.append(torch.from_numpy(np.array(_to_torch_layout(node, path[-1], tuple(params[name].shape)))))
    return out


@torch.no_grad()
def load_matching_params(model: nn.Module, params: dict) -> Tuple[int, int]:
    """Copy every parameter of a flax `params` tree that the model has at
    the same path and shape (transfer learning); the rest keep their
    values. Returns (parameters copied, parameters of the model)."""
    loaded, named = 0, dict(model.named_parameters())
    for name, p in named.items():
        _, path, _ = _flax_leaf(model, name)
        node = params
        for key in path:
            node = node.get(key) if isinstance(node, dict) else None
        if node is None:
            continue
        try:
            value = _to_torch_layout(node, path[-1], tuple(p.shape))
        except ValueError:  # another shape
            continue
        p.copy_(torch.from_numpy(np.array(value)))
        loaded += 1
    return loaded, len(named)
