"""Model-YAML loading (counterpart of yolosomi_tpu/utils/config.py:95-127).

The YAML files under configs/ are data shared by both packages.
"""

from __future__ import annotations

from pathlib import Path

import yaml

CONFIG_ROOT = Path(__file__).resolve().parents[2] / "configs"


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
