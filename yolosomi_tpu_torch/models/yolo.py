"""YAML model-graph compiler and DetectionModel, free of JAX
(counterpart of yolosomi_tpu/models/yolo.py).

The same `[from, repeats, module, args]` rows compile into torch modules
through an explicit registry, with the JAX package's channel, repeat and
analytic stride propagation, and its named anchor presets
(configs/models/hub/anchors.yaml). The registry holds the anchor-grid
detection family: the flagship (configs/models/yolo-somi.yaml), its DCN
variant, yolo-somi-s / -t / -t-p3 / -t-p3s / -t-p3s8, the ablation
configs, yolov5n/s/m/l/x, yolov5s-p2 and yolov5s6, and the hub configs
yolov5{n,s,m,l,x}6, yolov5-p2 / -p6 / -p7 / -bifpn / -fpn / -panet and
yolov3 / yolov3-spp. A row outside it raises KeyError naming ROADMAP queue
A item 8: yolov3-tiny (nn.MaxPool2d, nn.ZeroPad2d), yolov5s-ghost
(GhostConv, C3Ghost), yolov5s-transformer (C3TR), yolov10 (C2fCIB, SCDown,
PSA), classifier.yaml (Classify), and the rest of the JAX package's zoo
and heads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import yaml

from yolosomi_tpu_torch.models import dcn as D
from yolosomi_tpu_torch.models import heads as H
from yolosomi_tpu_torch.models import layers as L
from yolosomi_tpu_torch.utils.config import find_config
from yolosomi_tpu_torch.utils.general import LOGGER, make_divisible, resolve_device

# Kind controls how parse_model rewrites args:
#   conv    : args [c2, ...] -> [c2*gw, ...]
#   csp     : conv + the repeat count n inserted as arg 2
#   seam    : channel-preserving (c2 forced to c1)
#   upsample: [size, scale, mode]
#   fuse    : equal-shape fusion; c2 = channels of the first input
#   concat  : c2 = the sum of the inputs' channels
#   contract: space-to-depth by args[0]; c2 = c1 * g * g, stride * g
#   dcnv3   : channel-preserving (c2 = channels of the input), cls(c2, *args[1:])
#   head    : detection head
_REGISTRY: Dict[str, Tuple[Any, str]] = {
    "Conv": (L.Conv, "conv"),
    "Focus": (L.Focus, "conv"),
    "Bottleneck": (L.Bottleneck, "conv"),
    "SPP": (L.SPP, "conv"),
    "BottleneckCSP": (L.BottleneckCSP, "csp"),
    "C3": (L.C3, "csp"),
    "C2f": (L.C2f, "csp"),
    "Concat": (L.Concat, "concat"),
    "Contract": (L.Contract, "contract"),
    "ODConv_3rd": (L.ODConv, "conv"),
    "ODConv": (L.ODConv, "conv"),
    "SPPF": (L.SPPF, "conv"),
    "SEAM": (L.SEAM, "seam"),
    "C2fCBAM": (L.C2fCBAM, "csp"),
    "C2fEMACBAM": (L.C2fEMACBAM, "csp"),
    "C2fEACBAM": (L.C2fEMACBAM, "csp"),  # alias for the reference YAML's spelling
    "nn.Upsample": (L.Upsample, "upsample"),
    "Upsample": (L.Upsample, "upsample"),
    "BiFPN": (L.BiFPN, "fuse"),
    "DCNv2": (D.DCNv2, "conv"),
    "DCNV3": (D.DCNv3, "dcnv3"),
    "DCNv3": (D.DCNv3, "dcnv3"),
    "C3_DCN": (D.C3_DCN, "csp"),
    "C2f_DCN": (D.C2f_DCN, "csp"),
    "Detect": (H.Detect, "head"),
    "DecoupledDetect": (H.DecoupledDetect, "head"),
    "DecoupledDetect1": (H.DecoupledDetect, "head"),
    "Decoupled_Detect": (H.DecoupledDetect, "head"),
}

# positional index of the stride arg (after c2) of conv-kind modules; DCNv2
# is left out, as in the JAX package, so its stride never reaches the graph
_STRIDE_ARG_POS = {"Conv": 2, "ODConv": 2, "ODConv_3rd": 2}
# conv-kind modules whose graph stride is 2 by construction, whatever their
# stride arg (Focus's space-to-depth)
_FIXED_STRIDE2 = {"Focus"}

# default pixel anchors for `anchors: <int>`: nl=4 is the SOMI VisDrone set,
# nl=3 the stock YOLOv5 set
_DEFAULT_ANCHORS = {
    3: [
        [10, 13, 16, 30, 33, 23],
        [30, 61, 62, 45, 59, 119],
        [116, 90, 156, 198, 373, 326],
    ],
    4: [
        [3, 4, 4, 8, 7, 6, 7, 11],
        [13, 8, 10, 17, 18, 12, 17, 23],
        [32, 15, 31, 26, 28, 49, 65, 35],
        [78, 73, 64, 98, 161, 47, 235, 85],
    ],
}


@dataclasses.dataclass
class LayerSpec:
    i: int
    f: Any  # int or list[int]
    n: int
    name: str
    args: list
    c2: int
    stride: float  # cumulative downsample factor of this layer's output


@dataclasses.dataclass
class ModelMeta:
    nc: int
    names: List[str]
    nl: int
    na: int
    strides: Tuple[float, ...]
    anchors_px: np.ndarray  # (nl, na, 2) pixel-space
    save: Tuple[int, ...]
    head_from: Tuple[int, ...]
    specs: List[LayerSpec]
    yaml: dict
    head_type: str = "DecoupledDetect"


def _anchor_preset(name: str):
    """A named anchor set of configs/models/hub/anchors.yaml (per-level
    pixel lists), for `anchors: <preset-name>` in a model YAML."""
    path = find_config("hub/anchors", kind="models")
    with open(path) as f:
        presets = yaml.safe_load(f)
    if name not in presets:
        raise KeyError(f"anchor preset {name!r} not in {path} (have: {sorted(presets)})")
    return presets[name]


def _resolve_anchors(anchors, nl: int) -> np.ndarray:
    """(nl, na, 2) pixel anchors from a YAML anchors field: explicit lists,
    a preset name, or an integer count per level (the default set,
    resampled to na)."""
    if isinstance(anchors, str):
        anchors = _anchor_preset(anchors)
        if len(anchors) != nl:
            raise ValueError(f"anchor preset has {len(anchors)} levels, model has {nl}")
    if isinstance(anchors, int):
        base = _DEFAULT_ANCHORS.get(nl)
        if base is not None and len(base[0]) // 2 == anchors:
            anchors = base
        elif base is not None:
            anchors = [
                np.array(lv, np.float32).reshape(-1, 2)[
                    np.linspace(0, len(lv) // 2 - 1, anchors).round().astype(int)
                ].reshape(-1).tolist()
                for lv in base
            ]
        else:
            anchors = [(4.0 * 2**i * np.power(2.0, np.arange(anchors * 2) / 2.0)).tolist() for i in range(nl)]
    return np.asarray(anchors, np.float32).reshape(nl, -1, 2)


def parse_model(cfg: dict, ch: int = 3, dtype: torch.dtype = torch.float32):
    """Compile YAML rows into (modules, ModelMeta)."""
    anchors, nc = cfg["anchors"], cfg["nc"]
    if isinstance(anchors, str):
        anchors = _anchor_preset(anchors)
    gd = cfg.get("depth_multiple", 1.0)
    gw = cfg.get("width_multiple", 1.0)
    na = (len(anchors[0]) // 2) if isinstance(anchors, list) else int(anchors)
    no = na * (nc + 5)

    chans: List[int] = [ch]
    strides: List[float] = [1.0]
    modules: List[nn.Module] = []
    specs: List[LayerSpec] = []
    save: List[int] = []
    head_from: Tuple[int, ...] = ()
    head_name = ""

    rows = list(cfg["backbone"]) + list(cfg["head"])
    for i, (f, n, mname, args) in enumerate(rows):
        mname = str(mname)
        if mname not in _REGISTRY:
            raise KeyError(f"module '{mname}' not in registry (row {i}): the rest of the model zoo is not ported "
                           "yet (ROADMAP queue A item 8)")
        cls, kind = _REGISTRY[mname]
        tokens = {"nc": nc, "anchors": anchors, "None": None, "True": True, "False": False}
        args = [tokens.get(a, a) if isinstance(a, str) else a for a in args]
        n_rep = max(round(n * gd), 1) if n > 1 else n

        def in_ch(fi):
            return chans[fi] if fi >= 0 else chans[len(chans) + fi]

        def in_stride(fi):
            return strides[fi] if fi >= 0 else strides[len(strides) + fi]

        stride = in_stride(f if isinstance(f, int) else f[0])
        if kind in ("conv", "csp", "seam"):
            c1 = in_ch(f)
            c2 = args[0]
            if c2 != no:
                c2 = make_divisible(c2 * gw, 8)
            if kind == "seam":
                c2 = c1  # SEAM is channel-preserving
                mod = cls(c1, *args[1:], approx_gelu=dtype == torch.bfloat16)
                margs = [c2, *args[1:]]
            else:
                margs = [c2, n_rep, *args[1:]] if kind == "csp" else [c2, *args[1:]]
                if kind == "csp":
                    n_rep = 1
                mod = cls(c1, *margs)
            spos = _STRIDE_ARG_POS.get(mname)
            if kind == "conv" and spos is not None and len(margs) > spos and isinstance(margs[spos], int) \
                    and not isinstance(margs[spos], bool):
                stride *= margs[spos]
            if mname in _FIXED_STRIDE2:
                stride *= 2
        elif kind == "upsample":
            c2 = in_ch(f)
            scale = args[1] if len(args) > 1 else 2
            if len(args) > 2 and args[2] != "nearest":
                raise NotImplementedError(f"Upsample mode {args[2]!r} (row {i})")
            mod = cls(scale)
            stride /= scale
        elif kind == "fuse":
            c2 = in_ch(f[0])
            mod = cls(len(f))
        elif kind == "concat":
            c2 = sum(in_ch(x) for x in f)
            mod = cls()
        elif kind == "contract":
            g = args[0] if args else 2
            c2 = in_ch(f) * g * g
            mod = cls(g)
            stride *= g
        elif kind == "dcnv3":
            c2 = in_ch(f)
            mod = cls(c2, *args[1:])
        else:  # head
            head_from = tuple(x if x >= 0 else len(chans) + x for x in f)
            na_head = _resolve_anchors(args[1] if len(args) > 1 else anchors, len(f)).shape[1]
            mod = cls(nc, na_head, [in_ch(x) for x in f])
            c2 = 0
            head_name = mname
            stride = 0.0
        if n_rep > 1:  # a row repeated in sequence (JAX's _Repeat); the copies after the first take c2 in
            if kind != "conv":
                raise NotImplementedError(f"repeated {kind}-kind module {mname} (row {i})")
            mod = nn.Sequential(mod, *(cls(c2, *margs) for _ in range(n_rep - 1)))

        modules.append(mod)
        specs.append(LayerSpec(i, f, n_rep, mname, args, int(c2), stride))
        save.extend(x % i for x in ([f] if isinstance(f, int) else list(f)) if x != -1)
        if kind == "head":
            save.extend(head_from)
        if i == 0:
            chans, strides = [], []
        chans.append(int(c2))
        strides.append(stride)

    if not head_from:
        raise NotImplementedError("a graph without a detection head")
    anchors_px = _resolve_anchors(anchors, len(head_from))
    meta = ModelMeta(
        nc=nc,
        names=[str(i) for i in range(nc)],
        nl=len(head_from),
        na=anchors_px.shape[1],
        strides=tuple(specs[j].stride for j in head_from),
        anchors_px=anchors_px,
        save=tuple(sorted(set(save))),
        head_from=head_from,
        specs=specs,
        yaml=cfg,
        head_type=head_name,
    )
    return modules, meta


class DetectionModel(nn.Module):
    """The parsed graph under reference indexing (`model.<i>`), with the
    from/save forward walk. `forward` takes an NCHW batch and returns the
    head's raw per-level maps [(B, ny, nx, na, no), ...]. Distillation's
    `kd_adapter_<i>` (nn.Linear, engine/distill.py) hang on the model when
    a run plants them, so the optimizer, the EMA and the checkpoints carry
    them as the JAX package's params tree does; the forward ignores them."""

    def __init__(self, modules: List[nn.Module], meta: ModelMeta):
        super().__init__()
        self.model = nn.ModuleList(modules)
        self.froms = [s.f for s in meta.specs]
        self.save = set(meta.save)
        self.head_from = meta.head_from

    def forward(self, x, features: bool = False):
        """The head's raw maps; with `features` also the head's per-level
        input maps (NCHW, in head_from order): the hint plane of feature
        distillation (the JAX Model's `features=True`, yolo.py:709-743)."""
        preds, saved = self.run_range(x, {}, 0, len(self.model))
        return (preds, tuple(saved[j] for j in self.head_from)) if features else preds

    def run_range(self, x, saved_in: Dict[int, torch.Tensor], lo: int, hi: int):
        """Run rows [lo, hi) from the boundary activation `x` and the skip
        tensors `saved_in` of earlier rows. Returns (out, saved): the
        boundary activation for row hi (the head's maps where the range
        ends with the head) and the skip tensors with this range's added."""
        saved = dict(saved_in)
        n = len(self.model)
        for i in range(lo, hi):
            m, f = self.model[i], self.froms[i]
            if i == n - 1:  # the head consumes its `from` list
                return m([saved[j] for j in self.head_from]), saved
            if isinstance(f, int):
                inp = x if f == -1 else saved[f if f >= 0 else i + f]
            else:
                inp = [x if j == -1 else saved[j if j >= 0 else i + j] for j in f]
            x = m(inp)
            if i in self.save:
                saved[i] = x
        return x, saved


def _trunc_normal(t: torch.Tensor, fan: int, scale: float, g: torch.Generator):
    """Flax's variance_scaling(scale, fan, "truncated_normal")."""
    std = math.sqrt(scale / fan) / 0.87962566103423978
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=g)


@torch.no_grad()
def init_weights(model: DetectionModel, meta: ModelMeta, seed: int = 0) -> None:
    """Random init from `seed`, in the JAX package's scheme (conv kernels
    variance_scaling(2, fan_out), dense kernels lecun_normal, zero biases,
    unit norms; the deformable blocks' own init in
    models/dcn.py:init_dcn_heads), then its detection-prior biases
    (obj log(8/(640/s)^2), cls log(0.6/(nc-0.99999)))."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            o, _, kh, kw = m.weight.shape
            _trunc_normal(m.weight, o * kh * kw, 2.0, g)
        elif isinstance(m, nn.Linear):
            _trunc_normal(m.weight, m.in_features, 1.0, g)
        elif isinstance(m, L.ODConv2d):
            K, o, _, kh, kw = m.weight.shape
            _trunc_normal(m.weight, K * o * kh * kw, 2.0, g)
            m.bias.zero_()
        if isinstance(m, (nn.Conv2d, nn.Linear)) and m.bias is not None:
            m.bias.zero_()
    for m in model.modules():  # after the generic pass, which also reached their children
        D.init_dcn_heads(m, g)
    head = model.model[-1]
    nc, na = meta.nc, meta.na
    cls_prior = math.log(0.6 / (nc - 0.99999)) if nc > 1 else 0.0
    for s, mi in zip(meta.strides, head.m):
        obj_prior = math.log(8.0 / (640.0 / s) ** 2)
        if isinstance(head, H.DecoupledDetect):
            mi.b3.bias.view(na, 5)[:, 4] += obj_prior
            mi.c3.bias += cls_prior
        else:  # the coupled Detect's conv, [xywh, obj, cls] per anchor
            b = mi.bias.view(na, nc + 5)
            b[:, 4] += obj_prior
            b[:, 5:] += cls_prior


def build_model(cfg: dict, nc: Optional[int] = None, device=None, dtype: torch.dtype = torch.float32,
                seed: int = 0, anchors=None, compute_dtype: Optional[torch.dtype] = None):
    """Compile a model YAML dict -> (DetectionModel, ModelMeta), with random
    weights from `seed`, in eval mode, in `dtype` and channels_last on
    `device` (CUDA unless the caller names another). An explicit `nc` or
    `anchors` (per-level pixel lists, as the YAML writes them) overrides the
    YAML's. `compute_dtype` is the dtype the model runs in where it is not
    `dtype` (bfloat16 under autocast over float32 weights); SEAM takes its
    GELU form from it."""
    device = resolve_device(device)
    cfg = dict(cfg)
    if nc is not None and nc != cfg.get("nc"):
        LOGGER.info(f"Overriding model.yaml nc={cfg.get('nc')} with nc={nc}")
        cfg["nc"] = nc
    if anchors is not None:
        LOGGER.info(f"Overriding model.yaml anchors with anchors={anchors}")
        cfg["anchors"] = anchors
    modules, meta = parse_model(cfg, ch=cfg.get("ch", 3), dtype=compute_dtype or dtype)
    model = DetectionModel(modules, meta)
    init_weights(model, meta, seed)
    model = model.to(device=device, dtype=dtype)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):  # Module.to(memory_format=...) refuses ODConv's 5-D bank
            m.to(memory_format=torch.channels_last)
    return model.eval(), meta
