"""General helpers: logger, channel rounding, device resolution."""

from __future__ import annotations

import logging
import math

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


def resolve_device(device=None) -> torch.device:
    """Entry points run on CUDA unless the caller names another device.
    With no device given and no GPU present this raises instead of
    silently running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)
