"""Hub entry points (counterpart of the root hubconf.py of the JAX package;
the reference's hubconf.py): thin calls to `api.load`.

    from yolosomi_tpu_torch import hubconf
    model = hubconf.yolo_somi(weights="somi.msgpack")   # device="cpu" to run on the CPU
    results = model(["img1.jpg", "img2.jpg"])
    results.records()

The yolov5 configs need C3, Focus and Concat, which are not ported yet:
`yolov5s` and `yolov5l` raise KeyError naming ROADMAP queue A item 8.
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
