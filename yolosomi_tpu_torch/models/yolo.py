"""YAML model-graph compiler and DetectionModel, free of JAX
(counterpart of yolosomi_tpu/models/yolo.py).

The same `[from, repeats, module, args]` rows compile into torch modules
through an explicit registry, with the JAX package's channel, repeat and
analytic stride propagation, and its named anchor presets
(configs/models/hub/anchors.yaml). The registry holds the detection
family: the flagship (configs/models/yolo-somi.yaml), its DCN variant,
yolo-somi-s / -t / -t-p3 / -t-p3s / -t-p3s8, the ablation configs,
yolov5n/s/m/l/x, yolov5s-p2 and yolov5s6, and the hub configs
yolov5{n,s,m,l,x}6, yolov5-p2 / -p6 / -p7 / -bifpn / -fpn / -panet,
yolov3 / yolov3-spp / yolov3-tiny (nn.MaxPool2d, nn.ZeroPad2d),
yolov5s-ghost (GhostConv, C3Ghost), yolov5s-transformer (C3TR) and
yolov10 (SCDown, C2fCIB, PSA); classifier.yaml, a headless graph whose
Classify tail gives logits (ModelMeta with nl 0); every head of the
JAX registry (yolo.py:151-167): Detect, DecoupledDetect (and its two
aliases), DetectODConv, IDetect, IAuxDetect, ASFF_Detect, CLLADetect,
TSCODE_Detect, Segment, the anchor-free DFL heads and RTDETRDecoder; and
the parser's own row kinds with layers.py's body zoo (yolo.py:60-170,
:457-540): SPD / space_to_depth, Expand, BiFPN_Add2 / BiFPN_Add3, CARAFE,
DySample, Involution, Zoom_cat, the learnable activations FReLU / AconC /
MetaAconC (models/activations.py), the gates SE / se_block, ECA /
eca_block, SimAM, CoorAttention, BAM and CBAM, MultiSEAM, CrossConv,
MixConv2d, GSConv, C3SE, C3ECA, C3SPP, C3x, RepC3 and SPPCSPC; layers.py's
attention family (GAMAttention, SKAttention, ShuffleAttention,
NAMAttention, EMA, LSKblock, MLCA, TripletAttention, GlobalContextBlock,
NonLocalBlock, CoT / CoTAttention, DoubleAttention,
ParallelPolarizedSelfAttention, SpatialGroupEnhance, MHSA, S2Attention,
EfficientAttention, ELA, MSCAAttention), LSKA / SPPF_LSKA,
SwinTransformerBlock / C3STR, HorBlock / HorNet / gnconv, RFEM / C3RFEM,
LVCBlock and ConvMixer; layers_zoo.py's conv and csp kinds
(models/layers_zoo.py: SimConv, CoordConv / CoordConvd, ADown,
DownSimper, ASPP, SPPELAN, SPPF_improve, BasicRFB / BasicRFB_a,
RepVGGBlock, ACmix, Conv_SWS, SPPCSPCS, CNeB, CSPCM, C3CR, the
C3_<attention> blocks, C2fBAM, C2f_DWR, VoVGSCSPCBAM) and CPCA; and its
fusion kinds (the transposed convs ConvTranspose / nn.ConvTranspose2d /
DWConvTranspose2d, nn.BatchNorm2d, Add / Multiply / CShortcut,
ContextAggregation / PSContextAggregation, ChannelAttention_HSFPN, CAM,
SimAMWithSlicing / SimAMWithFlexibleSlicing, C3CBAM, ConvMix,
Conv2Former, SDI, BiFPNSDI, BiFPNs, BiFusion, SF, ScalSeq,
attention_model): every name of the JAX registry. A row of any kind but
the heads may repeat (JAX's _Repeat). An nn.Upsample row of another mode
than nearest upsamples nearest, as the JAX package's Upsample does, and
the parser logs the mode it dropped. Deliberate divergences (ROADMAP
queue C): a Zoom_cat row's stride is its second input's, where its
output lies (the JAX parser records the first input's); a block with no
field but dtype builds from an empty row (the JAX parser raises
TypeError); gnconv's dim must be its input's channels and RFEM's n 1 (the
JAX package builds a graph whose recorded widths are wrong, or fails,
otherwise). A row outside the registry raises KeyError, as the JAX
parser does.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import yaml

from yolosomi_tpu_torch.models import activations as A
from yolosomi_tpu_torch.models import dcn as D
from yolosomi_tpu_torch.models import heads as H
from yolosomi_tpu_torch.models import layers as L
from yolosomi_tpu_torch.models import layers_zoo as Z
from yolosomi_tpu_torch.models.rtdetr import DenseGeneral, RTDETRDecoder
from yolosomi_tpu_torch.utils.config import find_config
from yolosomi_tpu_torch.utils.general import LOGGER, make_divisible, resolve_device

# Kind controls how parse_model rewrites args:
#   conv    : args [c2, ...] -> [c2*gw, ...]
#   csp     : conv + the repeat count n inserted as arg 2
#   seam    : channel-preserving (c2 forced to c1)
#   upsample: [size, scale, mode]
#   fuse    : equal-shape fusion; c2 = channels of the first input
#   addN    : weighted add + 1x1 conv; c2 = the widest input's channels
#   concat  : c2 = the sum of the inputs' channels
#   zoomcat : c2 = the sum of the inputs' channels, at the second input's stride
#   contract: space-to-depth by args[0]; c2 = c1 * g * g, stride * g
#   expand  : depth-to-space by args[0]; c2 = c1 / (g * g), stride / g
#   spd     : space-to-depth by 2; c2 = c1 * 4, stride * 2
#   carafe  : channel-preserving 2x upsample, cls(c1, *args); stride / 2
#   dysample: channel-preserving upsample by args[0], cls(c1, *args)
#   involution: channel-preserving, [c2, k, s]; stride * s
#   dcnv3   : channel-preserving (c2 = channels of the input), cls(c2, *args[1:])
#   plain   : channel-preserving; the args fill the JAX module's fields
#             (_PLAIN_FIELDS), or cls(*args) / cls(c2) (RepVGGDW)
#   noarg   : channel-preserving, cls(c1) (the learnable activations)
#   c2former: channel-preserving; args[0] (scaled) is the MLP width, n the blocks
#   preserve_args1: channel-preserving, cls(c1, *args[1:]) (args[0] is an ignored c2)
#   hsfpn   : channel-preserving, cls(c1, *args)
#   cam     : cls(c1, fusion=args[0]); c2 = 3 c1 for "concat", else c1
#   nary    : elementwise merge; c2 = the first input's channels
#   sdi     : cls(chs, c2); c2 = the first input's channels, at its size
#   bifpnsdi: cls(chs, args[0]), c2 unscaled, at the largest input stride
#   bifpns  : cls(chs, args[1] or args[0]), c2 unscaled
#   bifusion: cls(chs, args[3] or args[-1]), c2 unscaled, at the second input's stride
#   sf      : cls(chs); c2 = the sum of the inputs' channels, at the second input's stride
#   scalseq : cls(chs, args[0]), c2 unscaled, at the first input's stride
#   attmodel: cls(chs); c2 = the first input's channels, at its stride
#   convtranspose: conv's args, c2 scaled; stride / args[2] (else the class's s)
#   pool    : nn.MaxPool2d [k, s, p]; stride * s
#   zeropad : nn.ZeroPad2d [(left, right, top, bottom)]
#   classify: c2 = args[0], the class count, never width-scaled
#   head    : anchor-grid detection head, cls(nc, na, ch)
#   head_v8 : anchor-free DFL head, cls(nc, ch)
#   head_rtdetr: the RT-DETR decoder, cls(nc, ch, [hd, nq])
_REGISTRY: Dict[str, Tuple[Any, str]] = {
    "Conv": (L.Conv, "conv"),
    "DWConv": (L.DWConv, "conv"),
    "Focus": (L.Focus, "conv"),
    "GhostConv": (L.GhostConv, "conv"),
    "GhostBottleneck": (L.GhostBottleneck, "conv"),
    "Bottleneck": (L.Bottleneck, "conv"),
    "SPP": (L.SPP, "conv"),
    "BottleneckCSP": (L.BottleneckCSP, "csp"),
    "C3TR": (L.C3TR, "csp"),
    "C3Ghost": (L.C3Ghost, "csp"),
    "TransformerBlock": (L.TransformerBlock, "conv"),
    "Classify": (L.Classify, "classify"),
    "C3": (L.C3, "csp"),
    "C2f": (L.C2f, "csp"),
    "C2fCIB": (L.C2fCIB, "csp"),
    "CIB": (L.CIB, "conv"),
    "PSA": (L.PSA, "conv"),
    "SCDown": (L.SCDown, "conv"),
    "RepVGGDW": (L.RepVGGDW, "plain"),
    "nn.MaxPool2d": (L.MaxPool2d, "pool"),
    "nn.ZeroPad2d": (L.ZeroPad2d, "zeropad"),
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
    "DetectODConv": (H.DetectODConvHead, "head"),
    "IDetect": (H.IDetect, "head"),
    "IAuxDetect": (H.IAuxDetect, "head"),
    "ASFF_Detect": (H.ASFFDetect, "head"),
    "CLLADetect": (H.CLLADetect, "head"),
    "TSCODE_Detect": (H.TSCODEDetect, "head"),
    "Segment": (H.Segment, "head"),
    "DetectYOLOv8": (H.DetectV8, "head_v8"),
    "DetectYOLO8Head": (H.DetectV8, "head_v8"),
    "DetectV8": (H.DetectV8, "head_v8"),
    "DetectYolov11": (H.DetectV11, "head_v8"),
    "DetectV11": (H.DetectV11, "head_v8"),
    "RTDETRDecoder": (RTDETRDecoder, "head_rtdetr"),
}
# the parser's remaining kinds and the body zoo (yolosomi_tpu/models/yolo.py:60-206); none of these
# blocks has a strip path, so a graph that names one is not served spatially sharded (engine/runner.py)
_BODY_ZOO: Dict[str, Tuple[Any, str]] = {
    "MultiSEAM": (L.MultiSEAM, "seam"),
    "CBAM": (L.CBAM, "plain"),
    "SE": (L.SE, "plain"),
    "se_block": (L.SE, "plain"),
    "SimAM": (L.SimAM, "plain"),
    "eca_block": (L.ECA, "plain"),
    "ECA": (L.ECA, "plain"),
    "BAM": (L.BAM, "plain"),
    "CoorAttention": (L.CoorAttention, "conv"),
    "C3SE": (L.C3SE, "csp"),
    "C3ECA": (L.C3ECA, "csp"),
    "C3SPP": (L.C3SPP, "csp"),
    "C3x": (L.C3x, "csp"),
    "RepC3": (L.RepC3, "csp"),
    "SPPCSPC": (L.SPPCSPC, "csp"),
    "CrossConv": (L.CrossConv, "conv"),
    "MixConv2d": (L.MixConv2d, "conv"),
    "GSConv": (L.GSConv, "conv"),
    "SPD": (L.SPD, "spd"),
    "space_to_depth": (L.SPD, "spd"),
    "Expand": (L.Expand, "expand"),
    "BiFPN_Add2": (L.BiFPN_Add2, "addN"),
    "BiFPN_Add3": (L.BiFPN_Add3, "addN"),
    "CARAFE": (L.CARAFE, "carafe"),
    "DySample": (L.DySample, "dysample"),
    "Involution": (L.Involution, "involution"),
    "Zoom_cat": (L.ZoomCat, "zoomcat"),
    "FReLU": (A.FReLU, "noarg"),
    "AconC": (A.AconC, "noarg"),
    "MetaAconC": (A.MetaAconC, "noarg"),
    # layers.py's attention family, LSKA / SPPF_LSKA, Swin / C3STR, HorBlock / gnconv, RFEM / C3RFEM,
    # LVCBlock and ConvMixer (yolosomi_tpu/models/yolo.py:94-134)
    "GAMAttention": (L.GAMAttention, "plain"),
    "SKAttention": (L.SKAttention, "plain"),
    "ShuffleAttention": (L.ShuffleAttention, "plain"),
    "NAMAttention": (L.NAMAttention, "plain"),
    "EMA": (L.EMAAttention, "plain"),
    "LSKblock": (L.LSKblock, "plain"),
    "MLCA": (L.MLCA, "plain"),
    "TripletAttention": (L.TripletAttention, "plain"),
    "GlobalContextBlock": (L.GlobalContextBlock, "plain"),
    "NonLocalBlock": (L.NonLocalBlock, "plain"),
    "CoT": (L.CoTAttention, "plain"),
    "CoTAttention": (L.CoTAttention, "plain"),
    "DoubleAttention": (L.DoubleAttention, "plain"),
    "ParallelPolarizedSelfAttention": (L.ParallelPolarizedSelfAttention, "plain"),
    "SpatialGroupEnhance": (L.SpatialGroupEnhance, "plain"),
    "MHSA": (L.MHSA, "plain"),
    "S2Attention": (L.S2Attention, "plain"),
    "EfficientAttention": (L.EfficientAttention, "plain"),
    "ELA": (L.ELA, "plain"),
    "MSCAAttention": (L.MSCAAttention, "plain"),
    "LSKA": (L.LSKA, "plain"),
    "SPPF_LSKA": (L.SPPF_LSKA, "conv"),
    "SwinTransformerBlock": (L.SwinTransformerBlock, "conv"),
    "C3STR": (L.C3STR, "csp"),
    "HorBlock": (L.HorBlock, "plain"),
    "HorNet": (L.HorBlock, "plain"),
    "gnconv": (L.GnConv, "plain"),
    "RFEM": (L.RFEM, "conv"),
    "C3RFEM": (L.C3RFEM, "csp"),
    "LVCBlock": (L.LVCBlock, "plain"),
    "ConvMixer": (L.ConvMixer, "conv"),
    # layers_zoo.py's conv and csp kinds, and CPCA (yolosomi_tpu/models/yolo.py:172-200, :206)
    "SimConv": (Z.SimConv, "conv"),
    "CoordConv": (Z.CoordConv, "conv"),
    "CoordConvd": (Z.CoordConvd, "conv"),
    "ADown": (Z.ADown, "conv"),
    "DownSimper": (Z.DownSimper, "conv"),
    "ASPP": (Z.ASPP, "conv"),
    "SPPELAN": (Z.SPPELAN, "conv"),
    "SPPF_improve": (Z.SPPF_improve, "conv"),
    "BasicRFB": (Z.BasicRFB, "conv"),
    "BasicRFB_a": (Z.BasicRFB_a, "conv"),
    "RepVGGBlock": (Z.RepVGGBlock, "conv"),
    "ACmix": (Z.ACmix, "conv"),
    "Conv_SWS": (Z.Conv_SWS, "conv"),
    "SPPCSPCS": (Z.SPPCSPCS, "csp"),
    "CNeB": (Z.CNeB, "csp"),
    "CSPCM": (Z.CSPCM, "csp"),
    "C3CR": (Z.C3CR, "csp"),
    "C3_CBAM": (Z.C3_CBAM, "csp"),
    "C3_CBAMS": (Z.C3_CBAMS, "csp"),
    "C3_CBAM_DWC": (Z.C3_CBAM_DWC, "csp"),
    "C3_CBAMS_DWC": (Z.C3_CBAMS_DWC, "csp"),
    "C3CPCA": (Z.C3CPCA, "csp"),
    "C3GAM": (Z.C3GAM, "csp"),
    "C3_SCBAM": (Z.C3_SCBAM, "csp"),
    "C3_BAM": (Z.C3_BAM, "csp"),
    "C3_CA": (Z.C3_CA, "csp"),
    "C2fBAM": (Z.C2fBAM, "csp"),
    "C2f_DWR": (Z.C2f_DWR, "csp"),
    "VoVGSCSPCBAM": (Z.VoVGSCSPCBAM, "csp"),
    "CPCA": (Z.CPCA, "noarg"),
    # layers_zoo.py's fusion kinds and the rest of its names (yolosomi_tpu/models/yolo.py:201-224)
    "Conv2Former": (Z.Conv2Former, "c2former"),
    "ConvMix": (Z.ConvMix, "preserve_args1"),
    "SimAMWithSlicing": (Z.SimAMWithSlicing, "preserve_args1"),
    "SimAMWithFlexibleSlicing": (Z.SimAMWithFlexibleSlicing, "preserve_args1"),
    "C3CBAM": (Z.C3CBAM, "preserve_args1"),
    "ContextAggregation": (Z.ContextAggregation, "noarg"),
    "PSContextAggregation": (Z.PSContextAggregation, "noarg"),
    "ChannelAttention_HSFPN": (Z.ChannelAttentionHSFPN, "hsfpn"),
    "CAM": (Z.CAM, "cam"),
    "Add": (Z.Add, "nary"),
    "Multiply": (Z.Multiply, "nary"),
    "CShortcut": (Z.CShortcut, "nary"),
    "SDI": (Z.SDI, "sdi"),
    "BiFPNSDI": (Z.BiFPNSDI, "bifpnsdi"),
    "BiFPNs": (Z.BiFPNs, "bifpns"),
    "BiFusion": (Z.BiFusion, "bifusion"),
    "SF": (Z.SF, "sf"),
    "ScalSeq": (Z.ScalSeq, "scalseq"),
    "attention_model": (Z.AttentionModel, "attmodel"),
    "ConvTranspose": (Z.ConvTransposeLayer, "convtranspose"),
    "nn.ConvTranspose2d": (Z.ConvTranspose2dRaw, "convtranspose"),
    "DWConvTranspose2d": (Z.DWConvTranspose2d, "convtranspose"),
    "nn.BatchNorm2d": (Z.BatchNorm2d, "noarg"),
}
_REGISTRY.update(_BODY_ZOO)
STRIPLESS = frozenset(_BODY_ZOO)
# a `plain` row's YAML args fill the JAX module's dataclass fields in
# order (`cls(*args)`, or `cls(c2)` without args); the torch module takes
# the input channels first and these fields by name, less the `c2` slot
# that CBAM, SE, BAM, the attention blocks, HorBlock and LVCBlock ignore.
# RepVGGDW's one field is its width. A block with no field takes an empty
# row (the JAX parser's `cls(c2, dtype=dtype)` fills its only field,
# dtype, twice and raises TypeError: ROADMAP queue C).
_PLAIN_FIELDS = {
    "CBAM": ("c2", "reduction"),
    "SE": ("c2", "ratio"),
    "se_block": ("c2", "ratio"),
    "SimAM": ("e_lambda",),
    "eca_block": ("b", "gamma"),
    "ECA": ("b", "gamma"),
    "BAM": ("c2", "reduction"),
    "GAMAttention": ("c2", "rate"),
    "SKAttention": ("c2", "kernels", "reduction"),
    "ShuffleAttention": ("c2", "groups"),
    "NAMAttention": ("c2",),
    "EMA": ("factor",),
    "LSKblock": (),
    "MLCA": ("local_size", "gamma", "b", "local_weight"),
    "TripletAttention": (),
    "GlobalContextBlock": ("ratio",),
    "NonLocalBlock": (),
    "CoT": ("kernel_size",),
    "CoTAttention": ("kernel_size",),
    "DoubleAttention": (),
    "ParallelPolarizedSelfAttention": (),
    "SpatialGroupEnhance": ("groups",),
    "MHSA": ("num_heads",),
    "S2Attention": (),
    "EfficientAttention": ("num_heads",),
    "ELA": (),
    "MSCAAttention": (),
    "LSKA": ("k_size",),
    "HorBlock": ("c2", "order"),
    "HorNet": ("c2", "order"),
    "gnconv": ("dim", "order", "s"),
    "LVCBlock": ("c2", "num_codes"),
}
# the blocks whose GELU is exact in float32 and the tanh form in bfloat16
# (the JAX package's `approximate=dtype == bfloat16`)
_DTYPE_GELU = (L.SEAM, L.SwinTransformerBlock, L.C3STR, H.DetectV11)
HEAD_KINDS = ("head", "head_v8", "head_rtdetr")
# the heads that take more input maps than they have detection levels:
# name -> fn(n_inputs) -> the slice of the inputs that are the levels
# (CLLADetect fuses inputs 0 and 1 into level 0, TSCODE_Detect detects on
# the middle maps, IAuxDetect's second half is its aux maps; yolo.py:252-256)
_HEAD_LEVEL_SLICE = {
    "CLLADetect": lambda n: slice(1, n),
    "TSCODE_Detect": lambda n: slice(1, n - 1),
    "IAuxDetect": lambda n: slice(0, n // 2),
}


def level_slice(head_name: str, n: int) -> slice:
    return _HEAD_LEVEL_SLICE.get(head_name, lambda n: slice(0, n))(n)

# positional index of the stride arg (after c2) of conv-kind modules; DCNv2
# is left out, as in the JAX package, so its stride never reaches the graph
_STRIDE_ARG_POS = {"Conv": 2, "DWConv": 2, "GhostConv": 2, "GhostBottleneck": 2, "SCDown": 2, "ODConv": 2,
                   "ODConv_3rd": 2, "CrossConv": 2, "MixConv2d": 2, "GSConv": 2, "Involution": 2, "SimConv": 2,
                   "CoordConv": 2, "CoordConvd": 2, "RepVGGBlock": 2, "BasicRFB": 1, "BasicRFB_a": 1, "ACmix": 4,
                   "Conv_SWS": 5}
# conv-kind modules whose graph stride is 2 by construction, whatever their
# stride arg (Focus's space-to-depth, ADown's and DownSimper's halving)
_FIXED_STRIDE2 = {"Focus", "ADown", "DownSimper"}

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


def parse_model(cfg: dict, ch: int = 3, dtype: torch.dtype = torch.float32, imgsz: int = 256):
    """Compile YAML rows into (modules, ModelMeta). `imgsz` is the square
    image the blocks that take the map's size at build (MHSA) are sized
    for, as the JAX init_model's dummy image sizes them."""
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
            raise KeyError(f"module '{mname}' not in registry (row {i}); the registry holds the JAX package's names")
        cls, kind = _REGISTRY[mname]
        tokens = {"nc": nc, "anchors": anchors, "None": None, "True": True, "False": False}
        args = [tokens.get(a, a) if isinstance(a, str) else a for a in args]
        n_rep = max(round(n * gd), 1) if n > 1 else n

        def in_ch(fi):
            return chans[fi] if fi >= 0 else chans[len(chans) + fi]

        def in_stride(fi):
            return strides[fi] if fi >= 0 else strides[len(strides) + fi]

        stride = in_stride(f if isinstance(f, int) else f[0])
        c_in = in_ch(f if isinstance(f, int) else f[0])
        chs = [in_ch(x) for x in f] if isinstance(f, list) else [c_in]
        gelu_kw = {"approx_gelu": dtype == torch.bfloat16} if cls in _DTYPE_GELU else {}
        # make(c) builds the row's module for c input channels: once for the
        # row, then once for each copy of a repeated row, which takes c2 in
        if kind in ("conv", "csp", "seam"):
            c2 = args[0]
            if c2 != no:
                c2 = make_divisible(c2 * gw, 8)
            if kind == "seam":
                c2 = c_in  # SEAM and MultiSEAM are channel-preserving
                margs = [c2, *args[1:]]
                make = lambda c: cls(c, *args[1:], **gelu_kw)  # noqa: E731
            else:
                margs = [c2, n_rep, *args[1:]] if kind == "csp" else [c2, *args[1:]]
                if kind == "csp":
                    n_rep = 1
                make = lambda c: cls(c, *margs, **gelu_kw)  # noqa: E731
            spos = _STRIDE_ARG_POS.get(mname)
            if kind == "conv" and spos is not None and len(margs) > spos and isinstance(margs[spos], int) \
                    and not isinstance(margs[spos], bool):
                stride *= margs[spos]
            if mname in _FIXED_STRIDE2:
                stride *= 2
        elif kind == "upsample":
            c2 = c_in
            scale = args[1] if len(args) > 1 else 2
            if len(args) > 2 and args[2] != "nearest":  # the JAX package's Upsample repeats whatever the mode
                LOGGER.info(f"Upsample row {i}: mode {args[2]!r} dropped, upsampling nearest as the JAX package does")
            make = lambda c: cls(scale)  # noqa: E731
            stride /= scale
        elif kind == "fuse":
            c2 = c_in
            make = lambda c: cls(len(f))  # noqa: E731
        elif kind == "addN":  # BiFPN_Add2 / 3: c2 = the widest input, whatever the args
            c2 = max(in_ch(x) for x in f)
            make = lambda c: cls(c, c2)  # noqa: E731
        elif kind in ("concat", "zoomcat", "spd"):
            c2 = c_in * 4 if kind == "spd" else sum(in_ch(x) for x in f)
            make = lambda c: cls()  # noqa: E731
            if kind == "spd":
                stride *= 2
            elif kind == "zoomcat":  # at the second input's resolution: its stride (JAX records the first's)
                stride = in_stride(f[1])
        elif kind in ("contract", "expand"):
            g = args[0] if args else 2
            c2 = c_in * g * g if kind == "contract" else c_in // (g * g)
            make = lambda c: cls(g)  # noqa: E731
            stride = stride * g if kind == "contract" else stride / g
        elif kind in ("carafe", "dysample"):  # channel-preserving upsamples, cls(c1, *args)
            c2 = c_in
            make = lambda c: cls(c, *args)  # noqa: E731
            stride /= 2 if kind == "carafe" or not args else args[0]
        elif kind == "involution":  # channel-preserving whatever its c2 arg: [c2, k, s]
            c2 = c_in
            k, s_loc = (args[1] if len(args) > 1 else 3), (args[2] if len(args) > 2 else 1)
            make = lambda c: cls(c, kernel_size=k, stride=s_loc)  # noqa: E731
            stride *= s_loc
        elif kind == "dcnv3":
            c2 = c_in
            make = lambda c: cls(c, *args[1:])  # noqa: E731
        elif kind == "noarg":  # the JAX module takes none of the row's args
            c2 = c_in
            make = cls
        elif kind == "c2former":  # channel-preserving whatever its c2, the blocks' MLP width
            c2 = c_in
            mid = args[0] if args[0] == no else make_divisible(args[0] * gw, 8)
            make = lambda c, reps=n_rep: cls(c, mid, reps)  # noqa: E731
            n_rep = 1
        elif kind in ("preserve_args1", "hsfpn"):  # channel-preserving; preserve_args1's args[0] is an ignored c2
            c2 = c_in
            margs = args[1:] if kind == "preserve_args1" else args
            make = lambda c: cls(c, *margs)  # noqa: E731
        elif kind == "cam":
            fusion = args[0] if args else "weight"
            c2 = 3 * c_in if fusion == "concat" else c_in
            make = lambda c: cls(c, fusion)  # noqa: E731
        elif kind in ("nary", "sdi", "attmodel"):  # at the first input's channels and stride
            c2 = c_in
            make = {"nary": lambda c: cls(), "sdi": lambda c: cls(chs, c2), "attmodel": lambda c: cls(chs)}[kind]
        elif kind in ("bifpnsdi", "bifpns", "bifusion", "scalseq"):  # c2 raw, never width-scaled
            c2 = {"bifpnsdi": args[0], "scalseq": args[0], "bifpns": args[1] if len(args) > 1 else args[0],
                  "bifusion": args[3] if len(args) > 3 else args[-1]}[kind]
            make = lambda c: cls(chs, c2)  # noqa: E731
            if kind == "bifpnsdi":
                stride = max(in_stride(x) for x in f)
            elif kind == "bifusion":
                stride = in_stride(f[1])
        elif kind == "sf":
            c2 = sum(chs)
            make = lambda c: cls(chs)  # noqa: E731
            stride = in_stride(f[1])
        elif kind == "convtranspose":
            c2 = args[0] if args[0] == no else make_divisible(args[0] * gw, 8)
            make = lambda c: cls(c, c2, *args[1:])  # noqa: E731
            stride /= args[2] if len(args) > 2 else inspect.signature(cls).parameters["s"].default
        elif kind == "plain":
            c2 = c_in
            fields = _PLAIN_FIELDS.get(mname)
            if fields is None:  # RepVGGDW
                make = lambda c: cls(*args) if args else cls(c)  # noqa: E731
            else:
                if len(args) > len(fields):
                    raise TypeError(f"{mname} takes at most {len(fields)} args {fields} (row {i})")
                kw = dict(zip(fields, args or [c2]))
                kw.pop("c2", None)
                if cls is L.MHSA:  # its positions take the map's size: the image's at this row's stride
                    kw["hw"] = (math.ceil(imgsz / stride),) * 2
                make = lambda c: cls(c, **kw)  # noqa: E731
        elif kind == "pool":
            c2 = c_in
            k = args[0] if args else 2
            s = args[1] if len(args) > 1 else k
            make = lambda c: cls(k, s, args[2] if len(args) > 2 else 0)  # noqa: E731
            stride *= s
        elif kind == "zeropad":
            c2 = c_in
            make = lambda c: cls(tuple(args[0]) if args else (0, 1, 0, 1))  # noqa: E731
        elif kind == "classify":
            c2 = args[0]
            c_in = c_in if isinstance(f, int) else sum(in_ch(x) for x in f)
            make = lambda c: cls(c, *args)  # noqa: E731
        else:  # head, head_v8, head_rtdetr
            head_from = tuple(x if x >= 0 else len(chans) + x for x in f)
            ch_in = [in_ch(x) for x in f]
            if kind == "head_rtdetr":  # [nc, hd, nq]; hd width-scales
                hkw = {}
                if len(args) > 1 and isinstance(args[1], int):
                    hkw["hd"] = make_divisible(args[1] * gw, 8)
                if len(args) > 2:
                    hkw["nq"] = args[2]
                mod = cls(nc, ch_in, **hkw)
            elif kind == "head_v8":  # anchor-free: nc only
                mod = cls(nc, ch_in, **gelu_kw)
            else:
                nl = len(f[level_slice(mname, len(f))])
                na_head = _resolve_anchors(args[1] if len(args) > 1 else anchors, nl).shape[1]
                hkw = {}
                if mname == "Segment":  # [nc, anchors, nm, npr]; npr width-scales
                    if len(args) > 2:
                        hkw["nm"] = args[2]
                    if len(args) > 3:
                        hkw["npr"] = make_divisible(args[3] * gw, 8)
                mod = cls(nc, na_head, ch_in, **hkw)
            c2 = 0
            head_name = mname
            stride = 0.0
        if kind not in HEAD_KINDS:
            mod = make(c_in)
        if n_rep > 1:  # a row repeated in sequence (JAX's _Repeat, flax mods_<i>)
            if kind in HEAD_KINDS:
                raise NotImplementedError(f"a repeated head {mname} (row {i})")
            mod = nn.Sequential(mod, *(make(int(c2)) for _ in range(n_rep - 1)))

        modules.append(mod)
        specs.append(LayerSpec(i, f, n_rep, mname, args, int(c2), stride))
        save.extend(x % i for x in ([f] if isinstance(f, int) else list(f)) if x != -1)
        if kind in HEAD_KINDS:
            save.extend(head_from)
        if i == 0:
            chans, strides = [], []
        chans.append(int(c2))
        strides.append(stride)

    if not head_from:  # a headless graph (a Classify tail: detect's second-stage classifier)
        return modules, ModelMeta(nc=nc, names=[str(i) for i in range(nc)], nl=0, na=0, strides=(),
                                  anchors_px=np.zeros((0, 0, 2), np.float32), save=tuple(sorted(set(save))),
                                  head_from=(), specs=specs, yaml=cfg, head_type=head_name)
    levels = head_from[level_slice(head_name, len(head_from))]
    anchors_px = _resolve_anchors(anchors, len(levels))
    meta = ModelMeta(
        nc=nc,
        names=[str(i) for i in range(nc)],
        nl=len(levels),
        na=anchors_px.shape[1],
        strides=tuple(specs[j].stride for j in levels),
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
    head's raw per-level maps [(B, ny, nx, na, no), ...]; a headless graph
    returns its last row's output (a Classify tail's (B, nc) logits). Distillation's
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
            if i == n - 1 and self.head_from:  # the head consumes its `from` list
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
    variance_scaling(2, fan_out), dense kernels lecun_normal, the packed
    attention projection xavier_uniform, zero biases, unit norms; the
    deformable blocks' own init in
    models/dcn.py:init_dcn_heads; ECA's 1-D conv lecun_normal, the ACON
    p1 / p2 N(0, 1), the bare kernels of MLCA and TridentBlock as conv
    kernels, MHSA's positions N(0, 0.02), Swin's bias table truncated
    N(0, 0.02), the Encoding's uniform codes and scales, ACmix's bare
    (1, 1, 3 heads, kc^2) kernel as a conv kernel and its dep_conv's shift
    init, the transposed convs' kernels as conv kernels, ContextAggregation's
    `m` zero, BiFPNs' `w` N(0, 1); the other bare parameters keep their
    constructors' flax values, BiFPNSDI's `w` ones), then its detection-prior biases
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
        elif isinstance(m, L.TorchMHA):
            nn.init.xavier_uniform_(m.in_proj_weight, generator=g)
            m.in_proj_bias.zero_()
        elif isinstance(m, DenseGeneral):
            _trunc_normal(m.weight, math.prod(m.weight.shape[:m.in_dims]), 1.0, g)
            m.bias.zero_()
        elif isinstance(m, H.ImplicitA):  # N(0, 0.02), ImplicitM N(1, 0.02)
            nn.init.normal_(m.implicit, 1.0 if isinstance(m, H.ImplicitM) else 0.0, 0.02, generator=g)
        elif isinstance(m, nn.Conv1d):  # ECA's flax nn.Conv: lecun_normal
            _trunc_normal(m.weight, m.weight.shape[1] * m.weight.shape[2], 1.0, g)
        elif isinstance(m, (A.AconC, A.MetaAconC)):  # flax normal(1.0)
            nn.init.normal_(m.p1, generator=g)
            nn.init.normal_(m.p2, generator=g)
        elif isinstance(m, (L.MLCA, L.TridentBlock)):  # bare conv kernels (OIHW): variance_scaling(2, fan_out)
            for p in (getattr(m, name) for name in m.hwio):
                _trunc_normal(p, p.shape[0] * p.shape[2] * p.shape[3], 2.0, g)
        elif isinstance(m, L.MHSA):  # flax normal(0.02)
            nn.init.normal_(m.rel_h, 0.0, 0.02, generator=g)
            nn.init.normal_(m.rel_w, 0.0, 0.02, generator=g)
        elif isinstance(m, L.WindowAttention):  # flax truncated_normal(0.02)
            nn.init.trunc_normal_(m.relative_position_bias_table, std=0.02, a=-0.04, b=0.04, generator=g)
        elif isinstance(m, L.Encoding):  # flax uniform(2 / sqrt(k c)) and uniform(1), before the forward's shifts
            k, c = m.codewords.shape
            m.codewords.copy_(torch.rand(k, c, generator=g) * (2.0 / math.sqrt(k * c)))
            m.scale.copy_(torch.rand(k, generator=g))
        elif isinstance(m, Z.ACmix):  # its bare (1, 1, 3 heads, kc^2) kernel: variance_scaling(2, fan_out)
            _trunc_normal(m.fc, m.fc.shape[-1], 2.0, g)
        elif isinstance(m, nn.ConvTranspose2d):  # the flax kernel (k, k, c1 / g, c2): variance_scaling(2, fan_out)
            _trunc_normal(m.weight, m.weight.shape[1] * m.groups * m.weight.shape[2] * m.weight.shape[3], 2.0, g)
        elif isinstance(m, Z.BiFPNs):  # flax normal(1.0)
            nn.init.normal_(m.w, generator=g)
        if isinstance(m, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)) and m.bias is not None:
            m.bias.zero_()
    for m in model.modules():  # after the generic pass, which also reached their children
        D.init_dcn_heads(m, g)
        if isinstance(m, Z.ACmix):
            m.shift_init()
        elif isinstance(m, Z.ContextAggregation):  # its bare flax nn.Conv `m`: zeros
            m.m.weight.zero_()
    if not meta.nl:  # headless: no detection priors
        return
    # the priors go where the JAX init_model puts them (yolo.py:596-626):
    # level i's `m<i>` when it is a Decouple branch or a bare conv (a
    # CLLADetect's m<i> is level i + 1's conv, and its last level has none)
    head = model.model[-1]
    nc, na = meta.nc, meta.na
    cls_prior = math.log(0.6 / (nc - 0.99999)) if nc > 1 else 0.0
    ms = getattr(head, "m", ())
    for s, mi in zip(meta.strides, ms):
        obj_prior = math.log(8.0 / (640.0 / s) ** 2)
        if isinstance(mi, H.Decouple):
            mi.b3.bias.view(na, 5)[:, 4] += obj_prior
            mi.c3.bias += cls_prior
        elif isinstance(mi, nn.Conv2d):  # [xywh, obj, cls (, mask coefficients)] per anchor
            b = mi.bias.view(na, -1)
            b[:, 4] += obj_prior
            b[:, 5:5 + nc] += cls_prior


def build_model(cfg: dict, nc: Optional[int] = None, device=None, dtype: torch.dtype = torch.float32,
                seed: int = 0, anchors=None, compute_dtype: Optional[torch.dtype] = None, imgsz: int = 256):
    """Compile a model YAML dict -> (DetectionModel, ModelMeta), with random
    weights from `seed`, in eval mode, in `dtype` and channels_last on
    `device` (CUDA unless the caller names another). An explicit `nc` or
    `anchors` (per-level pixel lists, as the YAML writes them) overrides the
    YAML's. `compute_dtype` is the dtype the model runs in where it is not
    `dtype` (bfloat16 under autocast over float32 weights); SEAM and Swin
    take their GELU form from it. `imgsz` sizes the blocks that take the
    map's size at build (MHSA): the JAX init_model's default 256, and the
    Runner's min(imgsz, 256), as the JAX Runner inits."""
    device = resolve_device(device)
    cfg = dict(cfg)
    if nc is not None and nc != cfg.get("nc"):
        LOGGER.info(f"Overriding model.yaml nc={cfg.get('nc')} with nc={nc}")
        cfg["nc"] = nc
    if anchors is not None:
        LOGGER.info(f"Overriding model.yaml anchors with anchors={anchors}")
        cfg["anchors"] = anchors
    modules, meta = parse_model(cfg, ch=cfg.get("ch", 3), dtype=compute_dtype or dtype, imgsz=imgsz)
    model = DetectionModel(modules, meta)
    init_weights(model, meta, seed)
    model = model.to(device=device, dtype=dtype)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):  # Module.to(memory_format=...) refuses ODConv's 5-D bank
            m.to(memory_format=torch.channels_last)
    return model.eval(), meta
