"""Hyperparameter, model and data YAML loading (counterpart of
yolosomi_tpu/utils/config.py:20-127).

The YAML files under configs/ are data shared by both packages.
"""

from __future__ import annotations

import os
from pathlib import Path

import yaml

CONFIG_ROOT = Path(__file__).resolve().parents[2] / "configs"

# The full default hyp set: YOLOv5's scratch hyps and the SOMI extras. A
# hyp YAML's keys override these, so a file that leaves a key out still
# loads.
DEFAULT_HYP = {
    "lr0": 0.01, "lrf": 0.1, "momentum": 0.937, "weight_decay": 0.0005, "warmup_epochs": 3.0,
    "warmup_momentum": 0.8, "warmup_bias_lr": 0.1, "box": 0.05, "cls": 0.5, "cls_pw": 1.0, "obj": 1.0,
    "obj_pw": 1.0, "iou_t": 0.2, "anchor_t": 4.0, "fl_gamma": 0.0, "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4,
    "degrees": 0.0, "translate": 0.1, "scale": 0.5, "shear": 0.0, "perspective": 0.0, "flipud": 0.0,
    "fliplr": 0.5, "mosaic": 1.0, "mixup": 0.0, "copy_paste": 0.0, "label_smoothing": 0.0,
    # SOMI extras: repulsion weights (alpha, beta, Rp_nms, deta), SlideLoss, the NWD blend
    "alpha": 0.01, "beta": 0.1, "Rp_nms": 0.1, "deta": 0.5, "slide_ratio": 0, "nwdloss": 0, "shapeloss": 0,
}


def load_hyp(path=None, overrides: dict | None = None) -> dict:
    """A hyp YAML merged over DEFAULT_HYP, then `overrides`."""
    hyp = dict(DEFAULT_HYP)
    if path:
        with open(path, errors="ignore") as f:
            hyp.update(yaml.safe_load(f) or {})
    if overrides:
        hyp.update(overrides)
    return hyp


def save_yaml(path, data: dict) -> None:
    with open(path, "w") as f:
        yaml.safe_dump({k: (str(v) if isinstance(v, Path) else v) for k, v in data.items()}, f, sort_keys=False)


def load_data_cfg(path) -> dict:
    """Load a dataset YAML (path/train/val/test/nc/names): names given as a
    dict become a list, nc is inferred from names when absent, and
    relative split paths resolve against `path` (itself relative to the
    YAML's directory)."""
    path = Path(path)
    with open(path, errors="ignore") as f:
        data = yaml.safe_load(f)
    if "names" in data and isinstance(data["names"], dict):
        data["names"] = [data["names"][i] for i in sorted(data["names"])]
    if "nc" not in data and "names" in data:
        data["nc"] = len(data["names"])
    root = Path(data.get("path", path.parent))
    if not root.is_absolute():
        root = (path.parent / root).resolve()
    for k in ("train", "val", "test"):
        if data.get(k) and isinstance(data[k], str) and not os.path.isabs(data[k]):
            data[k] = str(root / data[k])
        elif data.get(k) and isinstance(data[k], list):
            data[k] = [str(root / x) if not os.path.isabs(x) else x for x in data[k]]
    data["path"] = str(root)
    return data


def load_model_cfg(path) -> dict:
    """Load a model-graph YAML (`nc`, `depth_multiple`, `width_multiple`,
    `anchors`, `backbone`, `head` rows)."""
    with open(path, errors="ignore") as f:
        cfg = yaml.safe_load(f)
    for key in ("backbone", "head"):
        if key not in cfg:
            raise ValueError(f"model yaml {path} missing '{key}' section")
    cfg.setdefault("depth_multiple", 1.0)
    cfg.setdefault("width_multiple", 1.0)
    cfg.setdefault("ch", 3)
    return cfg


def find_config(name: str, kind: str = "models") -> Path:
    """Resolve a config by name: absolute path, cwd-relative, or bundled
    under configs/{models,hyps,data}/."""
    p = Path(name)
    if p.exists():
        return p
    for base in (CONFIG_ROOT / kind, CONFIG_ROOT / kind / "hub"):
        for cand in (base / name, base / f"{name}.yaml"):
            if cand.exists():
                return cand
    raise FileNotFoundError(f"config '{name}' not found (searched cwd and {CONFIG_ROOT / kind})")
