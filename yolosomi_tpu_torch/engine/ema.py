"""Model EMA and early stopping (counterpart of
yolosomi_tpu/engine/ema.py:32-59).

The EMA is a copy of the model whose every floating state entry,
parameters and BatchNorm statistics alike, follows the model:
e = d * e + (1 - d) * v with d = decay * (1 - exp(-updates / tau)), so
early updates follow the model closely. The copy is an nn.Module in eval
mode, so validation and checkpoints use it as they use the model.
"""

from __future__ import annotations

import copy
from typing import List, Optional

import torch
import torch.nn as nn


def _floating_state(model: nn.Module) -> List[torch.Tensor]:
    """The model's floating state tensors (parameters and norm statistics),
    in state_dict order; num_batches_tracked and other integers are left out."""
    return [t for t in model.state_dict().values() if t.is_floating_point()]


class ModelEMA:
    """EMA of a model's floating state. `updates` is an int32 device tensor."""

    def __init__(self, model: nn.Module, decay: float = 0.9999, tau: float = 2000.0):
        self.ema = copy.deepcopy(model).eval()
        for p in self.ema.parameters():
            p.requires_grad_(False)
        self.decay, self.tau = decay, tau
        dev = next(model.parameters()).device
        self.updates = torch.zeros((), dtype=torch.int32, device=dev)

    @torch.no_grad()
    def update(self, model: nn.Module, ok: Optional[torch.Tensor] = None) -> None:
        """One EMA step towards `model`; none (counter included) where `ok`
        is False."""
        dev = self.updates.device
        ok = torch.ones((), dtype=torch.bool, device=dev) if ok is None else ok
        self.updates += ok.to(torch.int32)
        d = self.decay * (1.0 - torch.exp(-self.updates.to(torch.float32) / self.tau))
        d = torch.where(ok, d, torch.ones_like(d))
        e, v = _floating_state(self.ema), _floating_state(model)
        torch._foreach_mul_(e, d)
        torch._foreach_add_(e, torch._foreach_mul(v, 1.0 - d))


class EarlyStopping:
    """Stop after `patience` epochs without a better fitness."""

    def __init__(self, patience: int = 30):
        self.best_fitness = 0.0
        self.best_epoch = 0
        self.patience = patience or float("inf")

    def __call__(self, epoch: int, fitness: float) -> bool:
        if fitness >= self.best_fitness:
            self.best_epoch = epoch
            self.best_fitness = fitness
        return (epoch - self.best_epoch) >= self.patience
