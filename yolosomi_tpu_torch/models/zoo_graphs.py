"""The body zoo's graphs: the full-width flagship (configs/models/yolo-somi.yaml,
nc 10) with rows replaced or inserted, one graph per family of the
blocks the parser's remaining kinds and layers.py's body zoo bring (no
shipped config uses them): the upsamplers, fusion, space-to-depth, CSP
variants and first gates, then the attention family, the Swin / HorNet
blocks and the RFEM / EVC family, then layers_zoo.py's conv and csp
kinds, then its fusion kinds. Each keeps the flagship's four ODConv sites.

An edit names flagship rows: `replace` maps a row to its new rows (the
first takes its place, the rest follow it), `after` inserts rows after
one. Absolute `from` indices, in the edits too, are flagship rows; a row
that read row i reads the last row that now stands for it (i's
replacement or the last row inserted after it). `-1` reads the row above.

    cfg = zoo_graph("zoo-carafe")          # a YAML dict for build_model
    Runner(path_of_that_yaml_dump, ...)
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from yolosomi_tpu_torch.utils.config import find_config, load_model_cfg

_UP = [-1, 1, "DySample", [2, 4]]
ZOO_GRAPHS: Dict[str, dict] = {
    # CARAFE in place of the three nearest upsamples
    "zoo-carafe": {"replace": {i: [[-1, 1, "CARAFE", [3, 5]]] for i in (14, 18, 22)}},
    # sub-pixel upsampling (a 1x1 Conv to 4x the channels and Expand), two
    # DySamples and Zoom_cat's three-scale merge
    "zoo-dysample": {"replace": {14: [[-1, 1, "Conv", [1024, 1, 1]], [-1, 1, "Expand", [2]]],
                                 18: [_UP], 22: [_UP], 19: [[[10, -1, 13], 1, "Zoom_cat", []]]}},
    # the weighted BiFPN adds, MultiSEAM and the learnable activations on the laterals
    "zoo-fusion": {"replace": {**{i: [["same", 1, "BiFPN_Add2", [256]]] for i in (15, 19, 23, 33)},
                               **{i: [["same", 1, "BiFPN_Add3", [256]]] for i in (27, 30)},
                               **{i: [[-1, 1, "MultiSEAM", [256]]] for i in (16, 20, 24)}},
                   "after": {10: [[-1, 1, "FReLU", []]], 11: [[-1, 1, "AconC", []]],
                             12: [[-1, 1, "MetaAconC", []]]}},
    # SPD-Conv's space-to-depth for the stride-2 Convs, MixConv2d, GSConv, CrossConv
    "zoo-spd": {"replace": {0: [[-1, 1, "MixConv2d", [64, [3, 5, 7], 2]]],
                            **{i: [[-1, 1, "SPD", []], [-1, 1, "Conv", [c, 3, 1]]]
                               for i, c in ((3, 256), (5, 512), (7, 1024))},
                            **{i: [["same", 1, "GSConv", [256, 1, 1]]] for i in (10, 11)},
                            **{i: [["same", 1, "CrossConv", [256, 3, 1]]] for i in (12, 13)}}},
    # the CSP variants in the backbone, SPPCSPC for SPPF, C3SPP in the neck
    "zoo-csp": {"replace": {2: [["same", "same", "C3x", [128, True]]], 4: [["same", "same", "C3SE", [256, True]]],
                            6: [["same", "same", "C3ECA", [512, True]]], 8: [["same", "same", "RepC3", [1024]]],
                            9: [[-1, 1, "SPPCSPC", [1024]]], 17: [[-1, 1, "C3SPP", [256]]]}},
    # the gates, a repeated plain row and Involution
    "zoo-attention": {"after": {2: [[-1, 1, "SimAM", []]], 4: [[-1, 1, "eca_block", []]],
                                6: [[-1, 1, "se_block", []]], 8: [[-1, 1, "CoorAttention", [1024]]],
                                9: [[-1, 2, "CBAM", [1024]], [-1, 1, "Involution", [1024, 3, 1]]],
                                25: [[-1, 1, "BAM", [256]]]}},
    # layers.py's attention family: the gates in the backbone and on the detection paths
    "zoo-gates2": {"after": {2: [[-1, 1, "GAMAttention", [128]]],
                             4: [[-1, 1, "SKAttention", [256]], [-1, 1, "ShuffleAttention", [256]]],
                             6: [[-1, 1, "NAMAttention", []], [-1, 1, "EMA", [8]], [-1, 1, "MLCA", [5]]],
                             8: [[-1, 1, "LSKblock", []], [-1, 1, "TripletAttention", []],
                                 [-1, 1, "GlobalContextBlock", [0.25]]],
                             25: [[-1, 1, "SpatialGroupEnhance", [8]]], 28: [[-1, 1, "ELA", []]],
                             31: [[-1, 1, "MSCAAttention", []]]}},
    # the global attentions at P5 and P4 (MHSA takes the map's size at build), SPPF_LSKA for SPPF
    "zoo-global": {"replace": {9: [[-1, 1, "SPPF_LSKA", [1024, 5]]]},
                   "after": {8: [[-1, 1, "NonLocalBlock", []], [-1, 1, "MHSA", [4]], [-1, 1, "DoubleAttention", []]],
                             12: [[-1, 1, "CoT", [3]], [-1, 1, "LSKA", [11]]],
                             13: [[-1, 1, "EfficientAttention", [4]], [-1, 1, "ParallelPolarizedSelfAttention", []],
                                  [-1, 1, "S2Attention", []]]}},
    # C3STR at P5 (20x20 at 640 px: padded to 24, nine 8x8 windows), a Swin block, HorBlock and gnconv
    "zoo-swin": {"replace": {8: [["same", "same", "C3STR", [1024]]]},
                 "after": {11: [[-1, 1, "gnconv", []]], 12: [[-1, 1, "HorBlock", [256]]],
                           13: [[-1, 1, "SwinTransformerBlock", [256, 8, 2]]]}},
    # C3RFEM for the P4 CSP stage, RFEM, LVCBlock at P5 (its Encoding's (b, hw, codes, c) difference is
    # 0.84 GB in f32 at b8 there, 3.4 GB at P3) and ConvMixer
    "zoo-rfem": {"replace": {6: [["same", "same", "C3RFEM", [512]]]},
                 "after": {4: [[-1, 1, "RFEM", [256]]], 9: [[-1, 1, "LVCBlock", [1024, 64]]],
                           12: [[-1, 1, "ConvMixer", [256]]]}},
    # layers_zoo.py's downsamplers and SPP family: SimConv, ADown, DownSimper and a stride-2 RepVGGBlock for the
    # stride-2 Convs, a RepVGGBlock with its identity branch, SPPELAN for SPPF, CoordConv / CoordConvd,
    # SPPF_improve and ASPP on the laterals
    "zoo-down": {"replace": {0: [[-1, 1, "SimConv", [64, 3, 2]]], 3: [[-1, 1, "ADown", [256]]],
                             5: [[-1, 1, "DownSimper", [512]]], 7: [[-1, 1, "RepVGGBlock", [1024, 3, 2]]],
                             9: [[-1, 1, "SPPELAN", [1024, 256]]]},
                 "after": {4: [[-1, 1, "RepVGGBlock", [256]]], 10: [[-1, 1, "CoordConv", [256, 3, 1]]],
                           11: [[-1, 1, "CoordConvd", [256, 3, 1]]], 12: [[-1, 1, "SPPF_improve", [256, 5]]],
                           13: [[-1, 1, "ASPP", [256]]]}},
    # the RFB blocks (BasicRFB's stride is its arg 1), ConvNeXt, SPPCSPCS for SPPF, ACmix and Conv_SWS on the P4
    # lateral (40x40 at 640 px: 25 tiles of 8x8), the ConvMix and Conv2Former CSP blocks in the neck
    "zoo-rfb": {"replace": {2: [["same", "same", "CNeB", [128]]], 3: [[-1, 1, "BasicRFB", [256, 2]]],
                            9: [[-1, 1, "SPPCSPCS", [1024]]], 17: [["same", "same", "CSPCM", [256]]],
                            21: [["same", "same", "C3CR", [256]]]},
                "after": {4: [[-1, 1, "BasicRFB", [256, 1]]], 6: [[-1, 1, "BasicRFB_a", [512, 1]]],
                          12: [[-1, 1, "ACmix", [256, 7, 4, 3, 1]], [-1, 1, "Conv_SWS", [256, 8, 0.0, 1e-4, 1, 1]]]}},
    # the C3 blocks with attention bottlenecks (CBAM, its depthwise spatial gate, CPCA, summed CBAM, coordinate
    # attention, GAM, BAM), C2fBAM, C2f_DWR and VoVGSCSPCBAM for the CSP stages, CPCA on a lateral
    "zoo-c3att": {"replace": {2: [["same", "same", "C3_CBAM", [128, True]]],
                              4: [["same", "same", "C3_CBAM_DWC", [256, True]]],
                              6: [["same", "same", "C3CPCA", [512, True]]],
                              8: [["same", "same", "C3_SCBAM", [1024, True]]],
                              17: [["same", "same", "C3_CA", [256]]], 21: [["same", "same", "C3GAM", [256]]],
                              25: [["same", "same", "C3_BAM", [256]]], 28: [["same", "same", "C2fBAM", [256]]],
                              31: [["same", "same", "C2f_DWR", [512]]], 34: [["same", "same", "VoVGSCSPCBAM", [1024]]]},
                  "after": {10: [[-1, 1, "C3_CBAMS", [256]]], 11: [[-1, 1, "C3_CBAMS_DWC", [256]]],
                            12: [[-1, 1, "CPCA", []]]}},
    # layers_zoo.py's fusion kinds: the transposed-conv upsamplers, the n-ary merges, the context / HS-FPN gates,
    # Conv2Former, the sliced SimAMs (SimAMWithFlexibleSlicing's 16x16 tiles on the P2 lateral: 1 at 64 px, 100 at
    # 640 px), C3CBAM, ConvMix and a standalone BatchNorm
    "zoo-tconv": {"replace": {14: [[-1, 1, "ConvTranspose", [256, 2, 2]]],
                              18: [[-1, 1, "nn.ConvTranspose2d", [256, 2, 2]]],
                              22: [[-1, 1, "DWConvTranspose2d", [256, 2, 2]]],
                              15: [[[-1, 12], 1, "Add", []]], 19: [[[-1, 11], 1, "CShortcut", []]],
                              23: [[[-1, 10], 1, "Multiply", []]],
                              16: [[-1, 1, "ContextAggregation", []]], 20: [[-1, 1, "PSContextAggregation", []]],
                              24: [[-1, 1, "ChannelAttention_HSFPN", [4]]], 17: [[-1, 3, "Conv2Former", [256]]]},
                  "after": {9: [[-1, 1, "nn.BatchNorm2d", []]],
                            10: [[-1, 1, "SimAMWithSlicing", [256]], [-1, 1, "SimAMWithFlexibleSlicing", [256, 16]]],
                            11: [[-1, 1, "C3CBAM", [256]]], 12: [[-1, 1, "ConvMix", [256]]]}},
    # the multi-scale fusions: YOLOv6's BiFusion and SF, BiFPNs, U-Net v2's SDI (growing with aligned corners and
    # passing its first input on), BiFPNSDI (P2 pooled to P3), ASF-YOLO's ScalSeq and attention_model (fed from
    # BiFPNSDI's unscaled output, so it builds at any width), CAM on the P5 lateral
    "zoo-asf": {"replace": {14: [[[13, 12, 11], 1, "BiFusion", [0, 0, 0, 256]]],
                            15: [[[-1, 12], 1, "BiFPNs", [256, 256]]],
                            18: [[[17, 11, 10], 1, "SF", []]], 19: [[-1, 1, "Conv", [256, 1, 1]]],
                            22: [[[10, 21, 17], 1, "SDI", []]],
                            27: [[[25, -1, 21], 1, "BiFPNSDI", [256]]]},
                "after": {13: [[-1, 1, "CAM", ["adaptive"]]],
                          28: [[[27, 12, 13], 1, "ScalSeq", [256]], [[-1, 27], 1, "attention_model", []]]}},
}


def apply_edits(rows: List[list], edits: dict) -> Tuple[List[list], Dict[int, int]]:
    """`rows` (backbone + head) with `edits` applied, and the map from each
    row of `rows` to the last row that stands for it; "same" in an edited
    row's from or repeats keeps the replaced row's."""
    new: List[list] = []
    last = {}  # flagship row -> the index of the last row that stands for it
    for i, row in enumerate(rows):
        block = [[row[j] if v == "same" else v for j, v in enumerate(r)] for r in edits.get("replace", {}).get(i, [row])]
        block += edits.get("after", {}).get(i, [])
        new += [list(r) for r in block]
        last[i] = len(new) - 1

    def remap(f):
        if isinstance(f, list):
            return [remap(x) for x in f]
        if f < 0 and f != -1:
            raise ValueError(f"a relative from {f} other than -1")
        return f if f == -1 else last[f]

    return [[remap(r[0]), *r[1:]] for r in new], last


def zoo_graph(name: str, base: str = "yolo-somi") -> dict:
    """The YAML dict of graph `name` of ZOO_GRAPHS, built on `base`."""
    cfg = dict(load_model_cfg(find_config(base)))
    rows, last = apply_edits(list(cfg["backbone"]) + list(cfg["head"]), ZOO_GRAPHS[name])
    cut = last[len(cfg["backbone"]) - 1] + 1
    cfg["backbone"], cfg["head"] = rows[:cut], rows[cut:]
    return cfg
