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

What the step is fed, in the JAX step's order (make_train_step's options):
`device_mosaic` composites the batch from the device slab and the host's
plan (ops/mosaic_device.py, already / 255); `device_preprocess` (the hyp)
jitters HSV and flips on the device (ops/preprocess.py), drawing from a
CPU generator seeded from (seed, step); a uint8 batch is divided by 255;
`scale_to` resizes to a square of that side (multi-scale) where it is
not the batch's height, bilinear with antialiasing, as jax.image.resize
does. `remat_segments` N cuts the graph's rows into N segments
(round(n k / N)) under torch.utils.checkpoint: only the boundary
activations and the skip tensors crossing a boundary are kept, and each
segment's forward runs again in the backward, with its BatchNorms'
running statistics frozen, so they move once a step, as without remat.

A loss that advertises `needs_images` / `needs_aux` / `needs_features`
(engine/distill.py) gets the step's model input, the step's `aux` (the
teacher), and with `needs_features` the head-input maps of a
`features=True` forward and the model (its adapters), as the JAX step
passes them (trainer.py:118-171). The teacher runs in the loss, outside
the remat segments; the hint's features and remat do not go together.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from yolosomi_tpu_torch.engine.ema import ModelEMA
from yolosomi_tpu_torch.engine.optim import OptState, YoloOptimizer, named_param_groups
from yolosomi_tpu_torch.models.layers import FlaxBatchNorm1d, FlaxBatchNorm2d, frozen_running_stats
from yolosomi_tpu_torch.ops.mosaic_device import mosaic_mixup_batch
from yolosomi_tpu_torch.ops.preprocess import normalize, preprocess_train_batch


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
    return normalize(_nhwc(images, device)).permute(0, 3, 1, 2)


def _nhwc(images, device: torch.device) -> torch.Tensor:
    x = torch.as_tensor(np.ascontiguousarray(images) if isinstance(images, np.ndarray) else images)
    return x.to(device, non_blocking=True)


def remat_forward(model: nn.Module, x: torch.Tensor, n_segments: int):
    """The model's forward as `n_segments` checkpointed row ranges, cut at
    round(n k / n_segments) of its n rows; the recompute runs with the
    running statistics frozen."""
    n = len(model.model)
    cuts = sorted({int(round(n * k / n_segments)) for k in range(n_segments + 1)} | {0, n})
    saved = {}
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        x, saved = checkpoint(model.run_range, x, saved, lo, hi, use_reentrant=False,
                              context_fn=lambda: (contextlib.nullcontext(), frozen_running_stats(model)))
    return x


class TrainStep:
    """`step(state, images, targets, aux=None)` -> metrics, device
    tensors: loss, lbox, lobj, lcls and grads_finite. `images` (B, H, W, 3)
    uint8 NHWC (or [0, 1] float), or with `device_mosaic` the pair (slab,
    plan); `targets` (B, M, 5) padded with cls = -1; `aux` what a
    distillation loss takes (the teacher)."""

    def __init__(self, loss_fn: Callable, optimizer: YoloOptimizer, accumulate: int = 1, freeze: int = 0,
                 amp_dtype: Optional[torch.dtype] = None, scale_to: Optional[int] = None,
                 device_preprocess: Optional[dict] = None, device_mosaic: Optional[int] = None,
                 remat_segments: int = 0):
        self.loss_fn, self.optimizer = loss_fn, optimizer
        self.accumulate, self.freeze, self.amp_dtype = accumulate, freeze, amp_dtype
        self.scale_to, self.device_preprocess = scale_to, device_preprocess
        self.device_mosaic, self.remat_segments = device_mosaic, remat_segments

    def frozen(self, state: TrainState) -> List[bool]:
        prefixes = tuple(f"model.{i}." for i in range(self.freeze))
        return [n.startswith(prefixes) for n in state.names] if self.freeze > 0 else [False] * len(state.names)

    def inputs(self, state: TrainState, images, targets):
        """The batch as the model takes it (float32 NCHW, NHWC in memory,
        on the parameters' device) and its targets, after the device
        mosaic, the device preprocess and the resize."""
        dev = state.params[0].device
        t = torch.as_tensor(targets, dtype=torch.float32).to(dev, non_blocking=True)
        if self.device_mosaic is not None:
            slab, plan = images
            x = mosaic_mixup_batch(slab, plan, self.device_mosaic)
        else:
            x = _nhwc(images, dev)
        if self.device_preprocess is not None:
            # a stream per (seed, step): a resumed run replays the same draws
            gen = torch.Generator().manual_seed(int(self.device_preprocess.get("seed", 0)) * 2**32 + state.step)
            x, t = preprocess_train_batch(x, t, gen, self.device_preprocess)
        x = normalize(x).permute(0, 3, 1, 2)
        if self.scale_to is not None and self.scale_to != x.shape[2]:  # the height alone, as the JAX step tests
            x = F.interpolate(x, size=(self.scale_to, self.scale_to), mode="bilinear", align_corners=False,
                              antialias=True)
        return x, t

    def __call__(self, state: TrainState, images, targets, aux=None) -> dict:
        model = state.model
        dev = state.params[0].device
        model.train()
        x, t = self.inputs(state, images, targets)
        bn = state.bn_buffers
        bn_old = torch.cat([b.reshape(-1) for b in bn]) if bn else None
        amp = (torch.autocast(device_type=dev.type, dtype=self.amp_dtype) if self.amp_dtype is not None
               else contextlib.nullcontext())
        needs_feats = getattr(self.loss_fn, "needs_features", False)
        feats = None
        with amp:
            if self.remat_segments > 0:
                if needs_feats:
                    raise ValueError("--distill-hint is incompatible with --remat")
                preds = remat_forward(model, x, self.remat_segments)
            elif needs_feats:
                preds, feats = model(x, features=True)
            else:
                preds = model(x)
        if getattr(self.loss_fn, "needs_images", False):  # distillation: the teacher runs in the loss
            kw = {"feats": feats, "params": model} if needs_feats else {}
            loss, comps = self.loss_fn(preds, t, images=x, aux=aux, **kw)
        else:
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
                    amp_dtype: Optional[torch.dtype] = None, scale_to: Optional[int] = None,
                    device_preprocess: Optional[dict] = None, device_mosaic: Optional[int] = None,
                    remat_segments: int = 0) -> TrainStep:
    """The train step; `amp_dtype` torch.bfloat16 runs the forward under
    autocast (None: float32 throughout). The other options are the JAX
    make_train_step's (the module docstring)."""
    return TrainStep(loss_fn, optimizer, accumulate, freeze, amp_dtype, scale_to, device_preprocess, device_mosaic,
                     remat_segments)
