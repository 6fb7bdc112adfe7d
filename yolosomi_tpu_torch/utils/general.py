"""General helpers: logger, channel rounding, image-size check, run
directories, the latest run, device resolution, per-rank logging, and the class and image
weights of --image-weights (counterparts of
yolosomi_tpu/utils/general.py:23-108, :117-141)."""

from __future__ import annotations

import glob
import logging
import math
import os
from pathlib import Path

import numpy as np
import torch


def _logger(name: str = "yolosomi_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    return logger


LOGGER = _logger()


def make_divisible(x, divisor: int = 8) -> int:
    """Round a channel count up to a multiple of `divisor` (the YAML
    compiler's width_multiple scaling)."""
    return int(math.ceil(x / divisor) * divisor)


def check_img_size(imgsz: int, s: int = 32) -> int:
    """Round an image size up to a multiple of the model's largest stride
    `s`, warning when it changes."""
    new_size = make_divisible(imgsz, int(s))
    if new_size != imgsz:
        LOGGER.warning(f"WARNING: --img-size {imgsz} must be multiple of max stride {s}, updating to {new_size}")
    return new_size


def increment_path(path, exist_ok: bool = False, mkdir: bool = False) -> Path:
    """The run directory `path`, or, when it exists and not `exist_ok`, the
    first free one of path2, path3, ...; `mkdir` creates it."""
    path = Path(path)
    if path.exists() and not exist_ok:
        for n in range(2, 9999):
            if not Path(f"{path}{n}").exists():
                path = Path(f"{path}{n}")
                break
    if mkdir:
        path.mkdir(parents=True, exist_ok=True)
    return path


def get_latest_run(search_dir: str = ".") -> str:
    """The most recently created last.ckpt (or last.msgpack) under
    search_dir, for a bare --resume; "" when there is none."""
    runs = glob.glob(f"{search_dir}/**/last.ckpt", recursive=True) + \
        glob.glob(f"{search_dir}/**/last.msgpack", recursive=True)
    return max(runs, key=os.path.getctime) if runs else ""


def resolve_device(device=None) -> torch.device:
    """Entry points run on CUDA unless the caller names another device.
    With no device given and no GPU present this raises instead of
    silently running on the CPU. Under torchrun (LOCAL_RANK set) CUDA is
    the rank's own card, cuda:LOCAL_RANK."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
        device = "cuda"
    if device == "cuda" and "LOCAL_RANK" in os.environ:
        device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
    return torch.device(device)


def log_rank(rank: int) -> None:
    """Rank 0 logs everything; the other ranks of a data-parallel run
    only warnings."""
    LOGGER.setLevel(logging.INFO if rank == 0 else logging.WARNING)


def labels_to_class_weights(labels, nc: int = 80) -> np.ndarray:
    """Inverse class frequencies over a list of (n, 5) label arrays,
    normalized to sum 1 (a class without labels counts once)."""
    if len(labels) == 0:
        return np.ones(nc)
    classes = np.concatenate([lb[:, 0] for lb in labels], 0).astype(int)
    weights = np.bincount(classes, minlength=nc).astype(float)
    weights[weights == 0] = 1
    weights = 1.0 / weights
    return weights / weights.sum()


def labels_to_image_weights(labels, nc: int = 80, class_weights=None) -> np.ndarray:
    """Each image's sampling weight: its label count per class times the
    class weights (default 1), summed."""
    if class_weights is None:
        class_weights = np.ones(nc)
    class_counts = np.array([np.bincount(lb[:, 0].astype(int), minlength=nc) for lb in labels])
    return (class_weights.reshape(1, nc) * class_counts).sum(1)
