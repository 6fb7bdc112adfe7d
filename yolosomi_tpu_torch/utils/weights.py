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
The transformer blocks' LayerNorms (scale / bias), Dense kernels
(transposed), TorchMHA's packed `in_proj_weight` / `in_proj_bias` and
`out_proj`, and the YOLOv10 blocks' flattened Sequentials (flax cv1_<i>,
ffn_<i>, tr<i>: cv1.<i>, ffn.<i>, tr.<i> here) map by name. DCNv3's
Dense layers, depthwise conv and LayerNorm map by name too; DCNv2's
3-D (P, C, c2) weight keeps its flax layout in the port (models/dcn.py),
so it passes through untransposed. The heads' leaves map by name too:
ImplicitA / ImplicitM's (1, 1, 1, C) `implicit` is (1, C, 1, 1) here;
RT-DETR's flax attention DenseGeneral kernels keep their flax shapes
(models/rtdetr.py DenseGeneral), and its input projections are bare flax
nn.Conv, as DCNv3's depthwise conv is.

`export_jax_variables` is the inverse: a port model -> the flax tree, with
flax paths, flax layouts and float32 numpy values, for the checkpoint
writers (engine/checkpoint.py). Where the forward map is many-to-one, the
module types decide: L.Conv's Conv2d is the flax `cv/conv`, any other
Conv2d a bare ConvRaw `<name>/conv`, except DCNv2's `conv_offset_mask`,
DCNv3's `dw_conv` and the children a module lists in `flax_convs`
(ACmix's `dep_conv`) (flax nn.Conv, no wrapper) and EMA-CBAM's `fc` pair
(flax Dense kernels held as 1x1 Conv2d). ACmix's (1, 1, 3 heads, kc^2)
`fc` is `flax_shaped` and its 0-d `rate1` / `rate2` pass as they are. A
transposed conv (nn.ConvTranspose2d: models/layers_zoo.py's
FlaxConvTranspose, flipped, and DWConvTranspose2d, regrouped) converts
its kernel by its own `from_flax` / `to_flax`.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from yolosomi_tpu_torch.models import dcn as D
from yolosomi_tpu_torch.models import heads as H
from yolosomi_tpu_torch.models import layers as L
from yolosomi_tpu_torch.models.rtdetr import DenseGeneral, RTDETRDecoder

_LIST_RE = re.compile(r"^(m|dw|pw|bn_dw|bn_pw|tr|se|eca)(\d+)$")
# the YOLOv10 blocks' Sequentials, flattened by flax: CIB's cv1_0-4, PSA's ffn_0-1
_SEQ_RE = re.compile(r"^(cv1|ffn)_(\d+)$")


# SEAM's depthwise-residual stack is one Sequential `DCovN`: patch conv
# [0], its BN [2], then per repeat i at [3+i]: Residual(fn=[conv, GELU,
# BN]) [0], pointwise conv [1], its BN [3]
_SEAM_SLOTS = {"dcov_patch": lambda i: "0", "bn_patch": lambda i: "2", "dw": lambda i: f"{3 + i}.0.fn.0",
               "bn_dw": lambda i: f"{3 + i}.0.fn.2", "pw": lambda i: f"{3 + i}.1", "bn_pw": lambda i: f"{3 + i}.3"}
_SEAM_RE = re.compile(r"\.(dcov_patch|bn_patch|(?:bn_)?(?:dw|pw)\.\d+)(?=\.|$)")


def _submodule(model: nn.Module, name: str):
    """model's submodule `name`, or None where it has none."""
    try:
        return model.get_submodule(name)
    except AttributeError:
        return None


def _seam_key(model: nn.Module, key: str) -> str:
    """`key` with a SEAM's flax-named stack members moved into its DCovN;
    other modules' dw<i> / pw<i> (gnconv's, ConvMixer's) keep their names."""
    def slot(m):
        if not isinstance(_submodule(model, m.string[: m.start()]), L.SEAM):
            return m.group(0)
        name, _, i = m.group(1).partition(".")
        return ".DCovN." + _SEAM_SLOTS[name](int(i or 0))

    return _SEAM_RE.sub(slot, key)


def _path_to_key(path: List[str], collection: str, model: nn.Module) -> str:
    """One flax path -> its primary torch key in `model`."""
    parts = []
    for p in path[:-1]:
        if p.startswith("layers_"):
            parts.append(f"model.{p.split('_')[1]}")
            continue
        if p.startswith("mods_"):  # the copies of a repeated row (JAX's _Repeat): an nn.Sequential
            parts.append(p.split("_")[1])
            continue
        m = _LIST_RE.match(p) or _SEQ_RE.match(p)
        parts.append(f"{m.group(1)}.{m.group(2)}" if m else p)
    leaf = path[-1]
    key = ".".join(parts)
    # CBAM channel-attention MLP: fc1/fc2 are shared_MLP slots 0 and 2
    key = key.replace(".channel_attention.fc1", ".channel_attention.shared_MLP.0")
    key = key.replace(".channel_attention.fc2", ".channel_attention.shared_MLP.2")
    key = _seam_key(model, key)

    if collection == "batch_stats":
        return _join(key, {"mean": "running_mean", "var": "running_var"}[leaf])
    if leaf in ("kernel", "bias"):
        name = "weight" if leaf == "kernel" else "bias"
        # Conv wraps ConvRaw 'cv' holding nn.Conv 'conv' (X.conv.weight); a
        # bare ConvRaw named 'conv' is a raw Conv2d (X.weight)
        if f".{key}".endswith(".cv.conv"):  # a Conv at the root too (a DWConv loaded on its own)
            return key[: -len("cv.conv")] + f"conv.{name}"
        if key.endswith(".conv"):
            return key[: -len(".conv")] + f".{name}"
        return _join(key, name)
    if leaf == "scale" and leaf not in getattr(_submodule(model, key), "flax_shaped", ()):  # norm gamma
        return _join(key, "weight")
    return _join(key, leaf)


def _join(key: str, name: str) -> str:
    """`key.name`, or `name` for a leaf of the root module (a DCNv2's own
    weight and bias when the module is loaded on its own)."""
    return f"{key}.{name}" if key else name


def _key_candidates(path: List[str], collection: str, model: nn.Module) -> List[str]:
    """All torch keys a flax path may map to in `model`, primary first.
    ODConv keeps a (K, Cout) bias bank at X.conv.bias where a bare conv has
    X.bias, and ECA's flax nn.Conv `conv` is X.conv here; SEAM and EMA-CBAM
    hold their fc pair in a Sequential `fc` (slots 0 and 2)."""
    primary = _path_to_key(path, collection, model)
    out = [primary]
    if path[-1] in ("bias", "kernel") and len(path) >= 2 and path[-2] == "conv":
        out.append(primary.rsplit(".", 1)[0] + ".conv." + primary.rsplit(".", 1)[1])
    for flax_name, seq_name in ((".fc1.", ".fc.0."), (".fc2.", ".fc.2.")):
        if flax_name in primary:
            out.append(primary.replace(flax_name, seq_name))
    return out


def _to_torch_layout(v: np.ndarray, leaf: str, torch_shape: Tuple[int, ...], flax_shaped: bool = False,
                     module: nn.Module = None) -> np.ndarray:
    """Flax layout -> torch layout: ODConv bank (K,kh,kw,I,O) -> (K,O,I,kh,kw),
    HWIO -> OIHW, a 1-D conv's WIO -> OIW (ECA), a Dense kernel -> a 1x1
    Conv2d or a Linear weight, a transposed conv's kernel by its module's
    `from_flax`; a 3-D DCNv2 weight (P, C, c2), 1-D leaves and a module's
    `flax_shaped` parameters pass through."""
    v = np.asarray(v, np.float32)
    if leaf == "kernel" and hasattr(module, "from_flax"):
        v = module.from_flax(v)
    elif flax_shaped:
        pass
    elif leaf == "implicit":  # (1, 1, 1, C) -> (1, C, 1, 1)
        v = v.reshape(1, -1, 1, 1)
    elif v.ndim == 5:
        v = v.transpose(0, 4, 3, 1, 2)
    elif v.ndim == 4:
        v = v.transpose(3, 2, 0, 1)
    elif v.ndim == 3 and leaf == "kernel" and v.shape != tuple(torch_shape):  # not RT-DETR's DenseGeneral
        v = v.transpose(2, 1, 0)
    elif v.ndim == 2 and leaf == "kernel":
        # a Dense kernel always transposes, square ones included; the
        # ODConv (K, Cout) bias bank is not a kernel and passes through
        v = v.T
        if len(torch_shape) == 4:
            v = v[:, :, None, None]
    if tuple(v.shape) != tuple(torch_shape):
        raise ValueError(f"shape mismatch {v.shape} vs {tuple(torch_shape)}")
    return v


def _holder(model: nn.Module, key: str) -> Tuple[nn.Module, str]:
    """The module that holds state key `key`, and the key's last name."""
    prefix, name = key.rsplit(".", 1) if "." in key else ("", key)
    return model.get_submodule(prefix), name


def _flax_shaped(model: nn.Module, key: str) -> bool:
    """Whether `key` is a parameter its module keeps in its flax shape and
    layout (the blocks' bare parameters: ShuffleAttention's gates, SGE's,
    MHSA's positions, Swin's bias table, the Encoding's codes and scales;
    `flax_shaped` on the module)."""
    mod, name = _holder(model, key)
    return name in getattr(mod, "flax_shaped", ())


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
            key = next((k for k in _key_candidates(path, collection, model) if k in state), None)
            if key is None:
                unused.append(f"{collection}/{'/'.join(path)}")
                continue
            dst = state[key]
            mod, name = _holder(model, key)
            shaped = name in getattr(mod, "flax_shaped", ())
            if shaped and tuple(np.shape(value)) != tuple(dst.shape) and hasattr(mod, "refit"):
                mod.refit(name, tuple(np.shape(value)))  # a map-sized parameter takes the file's size (MHSA)
                dst = getattr(mod, name).data
            dst.copy_(torch.tensor(_to_torch_layout(value, path[-1], tuple(dst.shape), shaped, mod), dtype=dst.dtype))
            matched[key] = True
    unmatched = [k for k in state if k not in matched and not k.endswith("num_batches_tracked")]
    return unmatched, unused


# ---------------------------------------------------------------------------
# the inverse: port model -> flax variables
# ---------------------------------------------------------------------------

# torch module path -> flax path, applied in order to the dotted path of the
# module that holds a leaf (the inverse of _path_to_key's rewrites; a block
# exported on its own has its lists at the path's start)
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
    (re.compile(r"(^|\.)(m|se|eca|dw|pw|bn_dw|bn_pw|tr)\.(\d+)"), lambda m: f"{m.group(1)}{m.group(2)}{m.group(3)}"),
    (re.compile(r"(^|\.)(cv1|ffn)\.(\d+)"), lambda m: f"{m.group(1)}{m.group(2)}_{m.group(3)}"),
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
        dense = re.search(r"\.fc\.[02]$", prefix) is not None  # EMA-CBAM's fc pair: flax Dense
        bare = prefix.rsplit(".", 1)[-1] in getattr(parent, "flax_convs", ())  # a flax nn.Conv (ACmix's dep_conv)
        if isinstance(parent, L.Conv):
            path = path[: -len(".conv")] + ".cv.conv"
        elif not (dense or bare or isinstance(parent, (D.DCNv2, D.DCNv3, RTDETRDecoder))):
            path += ".conv"
        if name == "weight":
            layout = (lambda t: t[:, :, 0, 0].T) if dense else (lambda t: t.permute(2, 3, 1, 0))
    elif isinstance(mod, nn.Conv1d) and name == "weight":  # ECA's flax nn.Conv `conv`, no ConvRaw around it
        layout = lambda t: t.permute(2, 1, 0)  # noqa: E731
    elif isinstance(mod, nn.Linear) and name == "weight":
        layout = lambda t: t.T  # noqa: E731
    elif isinstance(mod, L.ODConv2d) and name == "weight":
        layout = lambda t: t.permute(0, 3, 4, 2, 1)  # noqa: E731  (K,O,I,kh,kw) -> (K,kh,kw,I,O)
    elif isinstance(mod, H.ImplicitA):
        layout = lambda t: t.reshape(1, 1, 1, -1)  # noqa: E731
    elif isinstance(mod, nn.ConvTranspose2d) and name == "weight":  # the module's own flax kernel layout
        layout = mod.to_flax
    elif name in getattr(mod, "hwio", ()):  # a bare conv kernel (TridentBlock's, MLCA's): OIHW -> HWIO
        layout = lambda t: t.permute(2, 3, 1, 0)  # noqa: E731
    collection = "params"
    if isinstance(mod, _NORMS) and name in ("running_mean", "running_var"):
        collection, name = "batch_stats", {"running_mean": "mean", "running_var": "var"}[name]
    elif isinstance(mod, _NORMS) and name == "weight":
        name = "scale"
    elif isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear, DenseGeneral)) and name == "weight":
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
        if key not in _key_candidates(path, collection, model):
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
        out.append(torch.from_numpy(np.array(_to_torch_layout(node, path[-1], tuple(params[name].shape),
                                                              _flax_shaped(model, name), _holder(model, name)[0]))))
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
            value = _to_torch_layout(node, path[-1], tuple(p.shape), _flax_shaped(model, name), _holder(model, name)[0])
        except ValueError:  # another shape
            continue
        p.copy_(torch.from_numpy(np.array(value)))
        loaded += 1
    return loaded, len(named)
