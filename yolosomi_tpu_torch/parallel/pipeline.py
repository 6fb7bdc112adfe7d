"""Pipeline parallelism: stage-partitioned weights, N-stage GPipe training
(PipelineTrainer) and a 2-stage inference schedule (pipeline_infer)
(counterpart of yolosomi_tpu/parallel/pipeline.py).

The graph's rows are split into contiguous stages; each stage is a module
holding copies of its own rows only, placed on its own device, so the
parameter bytes per device drop to about 1 / stages (the reason to
pipeline a graph too large for one card). What crosses a stage boundary
is the boundary activation plus exactly the skip tensors that later rows
consume (`stage_payload_keys`, from the graph's `froms`).

1. `PipelineTrainer`: the GPipe schedule over M microbatches. The
   forwards run stage by stage (under no_grad: each stage keeps only its
   inputs), then the backwards in reverse microbatch and stage order, each
   recomputing its stage's forward with gradients on (full
   rematerialisation) while its BatchNorms' running statistics are frozen
   (models.layers.frozen_running_stats), so they move once per microbatch,
   as in the JAX schedule. Cotangents hop back stage to stage; gradients
   add up on each stage's device; with an optimizer each stage steps its
   own YoloOptimizer state over its own parameters, without one the
   gradients stay exposed (`grads`). The loss is batch-size scaled, so the
   summed microbatch losses and gradients are the whole batch's; at
   microbatch = batch the step is the one-process step. BatchNorm
   normalises each microbatch with its own statistics, as JAX's does.
2. `pipeline_infer`: two stages, M microbatches in M + 1 ticks (stage 0
   runs microbatch t while stage 1 runs t - 1); on two cards the stages
   overlap through each card's own queue.

Stage boundaries come from `balance_stages`: the JAX package's exact DP
over per-row parameter bytes (parameters and BatchNorm statistics, the
flax variables of `layers_<i>`), which gives the same boundaries on the
same graph.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from yolosomi_tpu_torch.engine.optim import named_param_groups
from yolosomi_tpu_torch.engine.trainer import upload_images
from yolosomi_tpu_torch.models.layers import frozen_running_stats
from yolosomi_tpu_torch.models.yolo import DetectionModel


def stage_payload_keys(model, split: int) -> Tuple[int, ...]:
    """The saved-row indices that rows [split:] consume from rows [:split]:
    the skip tensors that must cross the boundary at `split`."""
    needed = set()
    n = len(model.model)
    for i in range(split, n):
        f = model.froms[i]
        srcs = [f] if isinstance(f, int) else list(f)
        if i == n - 1 and model.head_from:
            srcs = list(model.head_from)
        for j in srcs:
            if j == -1:
                continue
            j_abs = j if j >= 0 else i + j
            if j_abs < split:
                needed.add(j_abs)
    return tuple(sorted(needed))


def _state_bytes(items) -> int:
    """Bytes of (name, tensor) pairs, BatchNorm's step counter left out (it
    has no flax variable)."""
    return sum(t.numel() * t.element_size() for k, t in items if not k.endswith("num_batches_tracked"))


def layer_bytes(model) -> np.ndarray:
    """Parameter and BatchNorm-statistic bytes of each graph row."""
    per_layer = np.zeros(len(model.model))
    for k, t in model.state_dict().items():
        if k.startswith("model.") and not k.endswith("num_batches_tracked"):
            per_layer[int(k.split(".")[1])] += t.numel() * t.element_size()
    return per_layer


def balance_stages(model, n_stages: int) -> Tuple[int, ...]:
    """Contiguous row -> stage partition minimising the largest stage's
    bytes (exact DP, O(S n^2)). Returns boundaries (0, b_1, ..., n): stage s
    owns rows [b_s, b_s+1)."""
    n = len(model.model)
    if not 1 <= n_stages <= n:
        raise ValueError(f"{n_stages} stages for a graph of {n} rows")
    prefix = np.concatenate([[0.0], np.cumsum(layer_bytes(model))])
    INF = float("inf")
    # dp[s][i]: the least largest-stage bytes over partitions of rows [0, i) into s non-empty stages
    dp = np.full((n_stages + 1, n + 1), INF)
    cut = np.zeros((n_stages + 1, n + 1), np.int64)
    dp[0][0] = 0.0
    for s in range(1, n_stages + 1):
        for i in range(s, n - (n_stages - s) + 1):
            best, best_j = INF, s - 1
            for j in range(s - 1, i):
                if dp[s - 1][j] == INF:
                    continue
                cost = max(dp[s - 1][j], prefix[i] - prefix[j])
                if cost < best:
                    best, best_j = cost, j
            dp[s][i], cut[s][i] = best, best_j
    bounds = [n]
    for s in range(n_stages, 0, -1):
        bounds.append(int(cut[s][bounds[-1]]))
    return tuple(reversed(bounds))


class Stage(nn.Module):
    """Copies of rows [lo, hi) of a DetectionModel on `device`, under the
    model's own names (`model.<i>.`; the other rows are empty), run by
    DetectionModel.run_range."""

    run_range = DetectionModel.run_range

    def __init__(self, model, lo: int, hi: int, device):
        super().__init__()
        self.model = nn.ModuleList([copy.deepcopy(m) if lo <= i < hi else nn.Identity()
                                    for i, m in enumerate(model.model)])
        self.froms, self.save, self.head_from = model.froms, model.save, model.head_from
        self.lo, self.hi = lo, hi
        self.to(device)
        self.train(model.training)

    def forward(self, x, saved_in: Dict[int, torch.Tensor]):
        return self.run_range(x, saved_in, self.lo, self.hi)


class PipelineTrainer:
    """N-stage GPipe training with stage-local weights (the module
    docstring, item 1). `step(images, targets)` per batch: images (B, H, W,
    3) uint8 or [0, 1] float NHWC, targets (B, M, 5); returns the summed
    (batch-size scaled) loss. `optimizer` a YoloOptimizer (each stage keeps
    its own state) or None (the gradients stay in `grads`, one dict of
    parameter name -> gradient per stage). `loss_fn(preds, targets)` ->
    (loss, components), ComputeLoss's contract."""

    def __init__(self, model, loss_fn: Callable, n_stages: int, devices: Optional[Sequence] = None,
                 optimizer=None, microbatch: Optional[int] = None):
        if devices is None:
            devices = [torch.device("cuda", i) for i in range(n_stages)]
        if len(devices) < n_stages:
            raise ValueError(f"need {n_stages} devices, got {len(devices)}")
        self.loss_fn, self.n_stages, self.microbatch = loss_fn, n_stages, microbatch
        self.devices = [torch.device(d) for d in devices[:n_stages]]
        self.bounds = balance_stages(model, n_stages)
        n = len(model.model)
        # stage s consumes keys_at[s] and emits keys_at[s + 1] (the first and the last are empty)
        self.keys_at = [stage_payload_keys(model, b) if 0 < b < n else () for b in self.bounds]
        self.stages = [Stage(model, self.bounds[s], self.bounds[s + 1], self.devices[s]).train()
                       for s in range(n_stages)]
        named = [named_param_groups(st) for st in self.stages]
        self.names = [[nm for nm, _, _ in nd] for nd in named]
        self.params = [[p for _, p, _ in nd] for nd in named]
        self.groups = [[g for _, _, g in nd] for nd in named]
        self.optimizer = optimizer
        self.opt_state = [optimizer.init(p) if optimizer is not None else None for p in self.params]
        self.grads: Optional[List[Dict[str, torch.Tensor]]] = None

    def per_device_param_bytes(self) -> List[int]:
        """Live parameter and BatchNorm-statistic bytes per stage device."""
        return [_state_bytes(st.state_dict().items()) for st in self.stages]

    def merged_state_dict(self) -> Dict[str, torch.Tensor]:
        """The whole model's state_dict from the stages (on their devices)."""
        out = {}
        for st in self.stages:
            out.update(st.state_dict())
        return out

    def step(self, images, targets) -> float:
        x_all = upload_images(images, self.devices[0])
        t_all = torch.as_tensor(np.asarray(targets), dtype=torch.float32)
        B = x_all.shape[0]
        mb = self.microbatch or B
        if B % mb:
            raise ValueError(f"batch {B} not divisible by microbatch {mb}")
        M, S, dev = B // mb, self.n_stages, self.devices

        # forward: every stage's inputs are kept for its recompute; BatchNorm statistics move here
        inputs = [[None] * S for _ in range(M)]
        losses = []
        with torch.no_grad():
            for t in range(M):
                x, sin = x_all[t * mb:(t + 1) * mb], {}
                tgt = t_all[t * mb:(t + 1) * mb]
                for s, st in enumerate(self.stages):
                    tgt_s = tgt.to(dev[s])
                    inputs[t][s] = (x, sin, tgt_s)
                    out, saved = st(x, sin)
                    if s == S - 1:
                        losses.append(self.loss_fn(out, tgt_s)[0])
                    else:
                        x = out.to(dev[s + 1])
                        sin = {k: saved[k].to(dev[s + 1]) for k in self.keys_at[s + 1]}

        # backward: reverse microbatch, reverse stage; the forward recomputed with its statistics frozen
        grads = [None] * S
        for t in reversed(range(M)):
            ct = None
            for s in reversed(range(S)):
                st, params = self.stages[s], self.params[s]
                x, sin, tgt_s = inputs[t][s]
                x_in = x.detach().requires_grad_(s > 0)
                keys_in = self.keys_at[s]
                sin_in = {k: sin[k].detach().requires_grad_(True) for k in keys_in}
                with torch.enable_grad(), frozen_running_stats(st):
                    out, saved = st(x_in, sin_in)
                    if s == S - 1:
                        outs, douts = [self.loss_fn(out, tgt_s)[0]], None
                    else:
                        outs, douts = [out] + [saved[k] for k in self.keys_at[s + 1]], ct
                wrt = params + ([x_in] if s > 0 else []) + [sin_in[k] for k in keys_in]
                g = torch.autograd.grad(outs, wrt, grad_outputs=douts, allow_unused=True)
                g = [torch.zeros_like(w) if gi is None else gi for w, gi in zip(wrt, g)]
                gp = g[:len(params)]
                grads[s] = gp if grads[s] is None else torch._foreach_add(grads[s], gp)
                if s > 0:  # d(boundary activation) and d(payload): the previous stage's output cotangents
                    ct = [gi.to(dev[s - 1]) for gi in g[len(params):]]

        if self.optimizer is not None:
            for s in range(S):
                self.optimizer.update(self.opt_state[s], self.params[s], grads[s], self.groups[s])
            self.grads = None
        else:
            self.grads = [dict(zip(self.names[s], grads[s])) for s in range(S)]
        return float(sum(loss.item() for loss in losses))


def pipeline_infer(model, devices: Sequence, split: int, microbatch: int) -> Callable:
    """fn(x (M * microbatch, 3, H, W), the model's input) -> the head's maps,
    computed as a 2-stage pipeline: rows [:split] on devices[0], the rest
    on devices[1] (copies, in eval mode), M + 1 ticks. The maps are on
    devices[1]."""
    keys = stage_payload_keys(model, split)
    n = len(model.model)
    s0 = Stage(model, 0, split, devices[0]).eval()
    s1 = Stage(model, split, n, devices[1]).eval()
    d0, d1 = torch.device(devices[0]), torch.device(devices[1])

    @torch.no_grad()
    def fn(x: torch.Tensor) -> List[torch.Tensor]:
        if x.shape[0] % microbatch:
            raise ValueError(f"batch ({x.shape[0]}) must be a multiple of microbatch ({microbatch})")
        M = x.shape[0] // microbatch
        x = x.to(d0)
        carry, outs = None, []
        for t in range(M + 1):
            sent = None
            if t < M:  # stage 0 on microbatch t
                out, saved = s0(x[t * microbatch:(t + 1) * microbatch], {})
                sent = (out.to(d1, non_blocking=True), {k: saved[k].to(d1, non_blocking=True) for k in keys})
            if carry is not None:  # stage 1 on microbatch t - 1
                outs.append(s1(*carry)[0])
            carry = sent
        return [torch.cat(level, 0) for level in zip(*outs)]

    return fn
