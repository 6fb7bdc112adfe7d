"""The train step (counterpart of yolosomi_tpu/engine/trainer.py:27-255):
forward in train mode, ComputeLoss, backward, the finite guard, the
optimizer, then the EMA, all on the device.

- bf16: the forward runs under torch.autocast with float32 master
  weights; the loss runs in float32 (ComputeLoss takes the maps in f32).
- The finite guard: a step whose gradients hold any non-finite value
  changes no parameter, no optimizer state (its step counter included,
  which drives the schedule), no EMA and no BatchNorm statistic: the
  statistics the forward moved are put back. It is decided on the device
  and returned as `grads_finite`; nothing is read back to the host.
- `accumulate` > 1: gradients add up over `accumulate` calls and the
  optimizer and the EMA step on the last of them (a non-finite call adds
  zeros); BatchNorm statistics move on every finite call.
- `freeze` N: the gradients and the updates of graph rows 0..N-1 are
  zero (their optimizer buffers still move under weight decay, as in the
  JAX package, which masks the updates and not the state).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn as nn

from yolosomi_tpu_torch.engine.ema import ModelEMA
from yolosomi_tpu_torch.engine.optim import OptState, YoloOptimizer, named_param_groups
from yolosomi_tpu_torch.models.layers import FlaxBatchNorm1d, FlaxBatchNorm2d


@dataclass
class TrainState:
    """What a run carries from step to step."""

    model: nn.Module
    names: List[str]  # parameter names, in the order of params
    params: List[torch.Tensor]
    groups: List[str]  # 'weight' / 'bn' / 'bias' per parameter
    opt_state: OptState
    ema: ModelEMA
    bn_buffers: List[torch.Tensor]  # every BatchNorm's running mean and variance
    step: int = 0  # train-step calls, skipped ones included
    grad_accum: Optional[List[torch.Tensor]] = None


def create_train_state(model: nn.Module, optimizer: YoloOptimizer, accumulate: int = 1) -> TrainState:
    named = named_param_groups(model)
    params = [p for _, p, _ in named]
    return TrainState(
        model=model,
        names=[n for n, _, _ in named],
        params=params,
        groups=[g for _, _, g in named],
        opt_state=optimizer.init(params),
        ema=ModelEMA(model),
        bn_buffers=[t for m in model.modules() if isinstance(m, (FlaxBatchNorm1d, FlaxBatchNorm2d))
                    for t in (m.running_mean, m.running_var)],
        grad_accum=[torch.zeros_like(p) for p in params] if accumulate > 1 else None,
    )


def upload_images(images, device: torch.device) -> torch.Tensor:
    """A (B, H, W, 3) uint8 (or [0, 1] float) NHWC batch -> the model's
    float32 NCHW input (NHWC in memory) on `device`."""
    x = torch.as_tensor(np.ascontiguousarray(images) if isinstance(images, np.ndarray) else images)
    x = x.to(device, non_blocking=True).permute(0, 3, 1, 2)
    return x.float() / 255.0 if x.dtype == torch.uint8 else x.float()


class TrainStep:
    """`step(state, images, targets)` -> metrics, device tensors: loss,
    lbox, lobj, lcls and grads_finite. `images` (B, H, W, 3) uint8 NHWC,
    `targets` (B, M, 5) padded with cls = -1."""

    def __init__(self, loss_fn: Callable, optimizer: YoloOptimizer, accumulate: int = 1, freeze: int = 0,
                 amp_dtype: Optional[torch.dtype] = None):
        self.loss_fn, self.optimizer = loss_fn, optimizer
        self.accumulate, self.freeze, self.amp_dtype = accumulate, freeze, amp_dtype

    def frozen(self, state: TrainState) -> List[bool]:
        prefixes = tuple(f"model.{i}." for i in range(self.freeze))
        return [n.startswith(prefixes) for n in state.names] if self.freeze > 0 else [False] * len(state.names)

    def __call__(self, state: TrainState, images, targets) -> dict:
        model = state.model
        dev = state.params[0].device
        model.train()
        x = upload_images(images, dev)
        t = torch.as_tensor(targets, dtype=torch.float32).to(dev, non_blocking=True)
        bn = state.bn_buffers
        bn_old = torch.cat([b.reshape(-1) for b in bn]) if bn else None
        amp = (torch.autocast(device_type=dev.type, dtype=self.amp_dtype) if self.amp_dtype is not None
               else contextlib.nullcontext())
        with amp:
            preds = model(x)
        loss, comps = self.loss_fn(preds, t)
        grads = torch.autograd.grad(loss, state.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(state.params, grads)]
        frozen = self.frozen(state)
        if self.freeze > 0:
            grads = [torch.zeros_like(g) if f else g for g, f in zip(grads, frozen)]
        with torch.no_grad():
            finite = torch.isfinite(torch.stack(torch._foreach_norm(grads, float("inf")))).all()
            zero = torch.zeros((), dtype=grads[0].dtype, device=dev)
            grads = [torch.where(finite, g, zero) for g in grads]
            if bn:  # a non-finite step keeps the statistics it found
                kept = torch.where(finite, torch.cat([b.reshape(-1) for b in bn]), bn_old)
                torch._foreach_copy_(bn, list(kept.split([b.numel() for b in bn])))
            if self.accumulate > 1:
                torch._foreach_add_(state.grad_accum, grads)
                if (state.step + 1) % self.accumulate == 0:
                    self.optimizer.update(state.opt_state, state.params, state.grad_accum, state.groups,
                                          frozen=frozen)
                    state.ema.update(model)
                    torch._foreach_zero_(state.grad_accum)
            else:
                self.optimizer.update(state.opt_state, state.params, grads, state.groups, ok=finite, frozen=frozen)
                state.ema.update(model, ok=finite)
        state.step += 1
        return {"loss": loss.detach(), "lbox": comps[0], "lobj": comps[1], "lcls": comps[2], "grads_finite": finite}


def make_train_step(loss_fn: Callable, optimizer: YoloOptimizer, accumulate: int = 1, freeze: int = 0,
                    amp_dtype: Optional[torch.dtype] = None) -> TrainStep:
    """The train step; `amp_dtype` torch.bfloat16 runs the forward under
    autocast (None: float32 throughout)."""
    return TrainStep(loss_fn, optimizer, accumulate, freeze, amp_dtype)

