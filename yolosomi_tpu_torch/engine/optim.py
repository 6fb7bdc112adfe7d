"""The 3-group optimizer with YOLOv5's warmup and one-cycle schedule
(counterpart of yolosomi_tpu/engine/optim.py:34-153).

- "weight" (conv and dense kernels): coupled weight decay, g + decay * p,
  with decay = weight_decay * batch_size * accumulate / 64;
- "bn" (norm scales and the 1-D fusion weights): no decay;
- "bias": no decay, and its own warmup start (warmup_bias_lr falling to
  the LR while the other groups rise from 0).

Groups follow the flax leaf name (`param_group`), not the torch name: a
torch `weight` is a flax `kernel` (decayed) in a conv or dense layer, a
`scale` (not decayed) in a norm, and stays `weight` (not decayed) for
ODConv's candidate bank and BiFPN's fusion weights, as the JAX package
groups them.

Warmup runs over nw = max(round(warmup_epochs * nb), 1000) optimizer
steps: the bias LR falls from warmup_bias_lr, the other LRs rise from 0,
the momentum rises from warmup_momentum. The epoch LR is one-cycle cosine
lr0 -> lr0 * lrf, or linear with `linear_lr`. SGD with Nesterov momentum
(torch's form: buf = mom * buf + g; d = g + mom * buf), or Adam with betas
(momentum, 0.999) and eps 1e-8.

The whole update runs on the device and reads nothing back: the schedule
is computed from the step counter (an int32 tensor), and a step that is
not `ok` (a device bool) changes no parameter, no buffer and no counter.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.nn as nn

from yolosomi_tpu_torch.utils.weights import _flax_leaf

GROUPS = ("weight", "bn", "bias")


def param_group(leaf: str) -> str:
    """'bias', 'bn' (a norm scale, or the 1-D fusion weights `weight` /
    `w`) or 'weight' (everything else, e.g. a `kernel`), by flax leaf name."""
    if leaf == "bias":
        return "bias"
    if leaf in ("scale", "weight", "w"):
        return "bn"
    return "weight"


def named_param_groups(model: nn.Module):
    """[(torch name, parameter, group)] of the model's parameters, each
    grouped by its flax leaf name (from the inverse weight bridge)."""
    out = []
    for name, p in model.named_parameters():
        _, path, _ = _flax_leaf(model, name)
        out.append((name, p, param_group(path[-1])))
    return out


@dataclass
class OptState:
    """The optimizer's state, every tensor on the parameters' device."""

    step: torch.Tensor  # int32: optimizer steps taken (skipped steps not counted)
    momentum_buf: List[torch.Tensor]  # SGD's momentum, one per parameter (zeros under Adam)
    adam_mu: Optional[List[torch.Tensor]] = None
    adam_nu: Optional[List[torch.Tensor]] = None


class YoloOptimizer:
    """`init(params)` -> OptState; `update(state, params, grads, groups, ok)`
    steps the parameters in place."""

    def __init__(self, hyp: dict, nb: int, epochs: int, batch_size: int, accumulate: int = 1, adam: bool = False,
                 linear_lr: bool = False):
        self.lr0, self.lrf = float(hyp["lr0"]), float(hyp["lrf"])
        self.momentum = float(hyp["momentum"])
        self.warmup_momentum = float(hyp["warmup_momentum"])
        self.warmup_bias_lr = float(hyp["warmup_bias_lr"])
        self.decay = float(hyp["weight_decay"]) * batch_size * accumulate / 64
        self.nb, self.epochs = nb, epochs
        self.nw = max(round(float(hyp["warmup_epochs"]) * nb), 1000)
        self.adam, self.linear_lr = adam, linear_lr

    def schedules(self, step: torch.Tensor):
        """(bias LR, other LR, momentum) at optimizer step `step`, as f32
        device tensors."""
        step_f = step.to(torch.float32)
        epoch = torch.floor(step_f / self.nb)
        if self.linear_lr:
            lf = (1 - epoch / self.epochs) * (1.0 - self.lrf) + self.lrf
        else:
            lf = ((1 - torch.cos(epoch * math.pi / self.epochs)) / 2) * (self.lrf - 1) + 1
        base_lr = self.lr0 * lf
        frac = torch.clamp(step_f / self.nw, 0.0, 1.0)
        in_warmup = step_f < self.nw
        lr_bias = torch.where(in_warmup, self.warmup_bias_lr + frac * (base_lr - self.warmup_bias_lr), base_lr)
        lr_other = torch.where(in_warmup, frac * base_lr, base_lr)
        mom = torch.where(in_warmup, self.warmup_momentum + frac * (self.momentum - self.warmup_momentum),
                          torch.full_like(frac, self.momentum))
        return lr_bias, lr_other, mom

    def init(self, params: List[torch.Tensor]) -> OptState:
        dev = params[0].device
        zeros = lambda: [torch.zeros_like(p, memory_format=torch.preserve_format) for p in params]  # noqa: E731
        return OptState(step=torch.zeros((), dtype=torch.int32, device=dev), momentum_buf=zeros(),
                        adam_mu=zeros() if self.adam else None, adam_nu=zeros() if self.adam else None)

    @torch.no_grad()
    def update(self, state: OptState, params: List[torch.Tensor], grads: List[torch.Tensor], groups: List[str],
               ok: Optional[torch.Tensor] = None, frozen: Optional[List[bool]] = None) -> None:
        """One step on finite `grads` (the caller zeroes a non-finite
        gradient). With `ok` False nothing changes; `frozen` parameters get
        no update, though their optimizer buffers move as the others' do
        (the JAX package masks the updates, not the state)."""
        dev = params[0].device
        ok = torch.ones((), dtype=torch.bool, device=dev) if ok is None else ok
        okf = ok.to(torch.float32)
        lr_bias, lr_other, mom = self.schedules(state.step)
        one = torch.ones((), dtype=torch.float32, device=dev)
        # grads with the decay term, and zero when the step is skipped
        g = [gr + self.decay * p if grp == "weight" else gr for p, gr, grp in zip(params, grads, groups)]
        g = torch._foreach_mul(g, okf)
        if self.adam:
            t = state.step.to(torch.float32) + 1.0
            b1, b2 = self.momentum, 0.999
            keep1 = torch.where(ok, torch.full_like(one, b1), one)
            keep2 = torch.where(ok, torch.full_like(one, b2), one)
            torch._foreach_mul_(state.adam_mu, keep1)
            torch._foreach_add_(state.adam_mu, torch._foreach_mul(g, 1 - b1))
            torch._foreach_mul_(state.adam_nu, keep2)
            torch._foreach_add_(state.adam_nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2))
            c1, c2 = 1 - torch.pow(b1, t), 1 - torch.pow(b2, t)
            mhat = torch._foreach_div(state.adam_mu, c1)
            den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(state.adam_nu, c2)), 1e-8)
            d = torch._foreach_div(mhat, den)
        else:
            keep = torch.where(ok, mom, one)  # momentum buffers stay put on a skipped step
            torch._foreach_mul_(state.momentum_buf, keep)
            torch._foreach_add_(state.momentum_buf, g)
            d = torch._foreach_add(g, torch._foreach_mul(state.momentum_buf, mom))  # Nesterov
        neg_lr = {"bias": -lr_bias * okf, "bn": -lr_other * okf, "weight": -lr_other * okf}
        for grp in GROUPS:
            idx = [i for i, gp in enumerate(groups) if gp == grp and not (frozen and frozen[i])]
            if idx:
                torch._foreach_add_([params[i] for i in idx], torch._foreach_mul([d[i] for i in idx], neg_lr[grp]))
        state.step += ok.to(torch.int32)


def make_optimizer(hyp: dict, nb: int, epochs: int, batch_size: int, accumulate: int = 1, adam: bool = False,
                   linear_lr: bool = False) -> YoloOptimizer:
    """The optimizer of a run of `epochs` epochs of `nb` optimizer steps."""
    return YoloOptimizer(hyp, nb, epochs, batch_size, accumulate, adam, linear_lr)


def current_lr(hyp: dict, step: int, nb: int, epochs: int, linear_lr: bool = False) -> float:
    """The epoch LR at optimizer step `step`, on the host (for logging)."""
    lr0, lrf = float(hyp["lr0"]), float(hyp["lrf"])
    epoch = step // max(nb, 1)
    if linear_lr:
        lf = (1 - epoch / epochs) * (1.0 - lrf) + lrf
    else:
        lf = ((1 - math.cos(epoch * math.pi / epochs)) / 2) * (lrf - 1) + 1
    return lr0 * lf
