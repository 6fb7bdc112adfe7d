"""Hub entry points (counterpart of the root hubconf.py of the JAX package;
the reference's hubconf.py): thin calls to `api.load`.

    from yolosomi_tpu_torch import hubconf
    model = hubconf.yolo_somi(weights="somi.msgpack")   # device="cpu" to run on the CPU
    results = model(["img1.jpg", "img2.jpg"])
    results.records()

`yolov5s` and `yolov5l` build their YAML's model (nc 80, the coupled
Detect head). `custom` takes any config the port serves: the flagship and
its DCN variant, yolo-somi-s / -t / -t-p3 / -t-p3s / -t-p3s8, the ablation
configs, yolov5n/s/m/l/x, yolov5s-p2 / s6 and the hub configs
yolov5{n,s,m,l,x}6, yolov5-p2 / -p6 / -p7 / -bifpn / -fpn / -panet,
yolov3 / yolov3-spp / yolov3-tiny, yolov5s-ghost, yolov5s-transformer and
yolov10, and any graph that ends in one of the JAX package's heads
(IDetect, IAuxDetect, ASFF_Detect, CLLADetect, TSCODE_Detect,
DetectODConv, Segment, the DFL heads DetectV8 / DetectV11 and their
aliases, RTDETRDecoder), and any graph of the JAX registry's other
names: the parser's own row kinds and layers.py's body zoo (SPD, Expand,
BiFPN_Add2 / 3, CARAFE, DySample, Involution, Zoom_cat, FReLU / AconC /
MetaAconC, the gates, MultiSEAM, the CSP variants), layers.py's attention
family, LSKA / SPPF_LSKA, Swin / C3STR, HorBlock / gnconv, RFEM / C3RFEM,
LVCBlock and ConvMixer, and layers_zoo.py's conv, csp and fusion kinds
(models/zoo_graphs.py builds fifteen such graphs). `AutoShape(...,
augment=True)` calls serve with TTA. A config with a row outside the
registry raises KeyError naming the row, as the JAX package's parser does.
"""

from __future__ import annotations

from yolosomi_tpu_torch.api import load


def custom(cfg: str, weights: str = None, **kw):
    """Any config with any weights."""
    return load(cfg, weights, **kw)


def yolo_somi(weights: str = None, **kw):
    return load("yolo-somi", weights, **kw)


def yolo_somi_dcn(weights: str = None, **kw):
    return load("yolo-somi-dcn", weights, **kw)


def yolov5s(weights: str = None, **kw):
    return load("yolov5s", weights, **kw)


def yolov5l(weights: str = None, **kw):
    return load("yolov5l", weights, **kw)
