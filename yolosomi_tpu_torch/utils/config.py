"""Model- and data-YAML loading (counterpart of
yolosomi_tpu/utils/config.py:73-127).

The YAML files under configs/ are data shared by both packages.
"""

from __future__ import annotations

import os
from pathlib import Path

import yaml

CONFIG_ROOT = Path(__file__).resolve().parents[2] / "configs"


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
