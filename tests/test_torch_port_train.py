"""yolosomi_tpu_torch's training slice against the JAX package, on the CPU:
the loss and its target assignment, the optimizer's groups and schedule,
the EMA, three train steps against make_train_step (with the finite guard
on a NaN batch), --accumulate and --freeze, the augmenting loader bitwise,
autoanchor, checkpoint interchange both ways, flax's BatchNorm statistics,
the gradient kernels' launch geometry, and the train CLI.

Sizes: the flagship at width 0.25 / depth 0.33, 64 px, batch 2, nc 3,
f32. Three JAX programs, each compiled once for the module: the train
step, the loss cases, and the train step with --accumulate 2 --freeze 3
on the flagship cut to its backbone and head (cut_flagship_cfg).

Tolerances, stated where they are used:
- losses: 1e-5 relative (f32; XLA and torch sum in other orders);
- parameter updates p_after - p_before: the update's own rounding. Most
  updates of the first steps are below the parameters' ulp (the non-bias
  LR starts at 0 and rises over 1000 warmup steps), so each leaf is held
  to 2% of its largest update plus 4 ulp of its largest parameter;
- BatchNorm statistics and EMA: 1e-5 relative plus 1e-6 absolute;
- momentum buffers (sums of gradients): 2% of each leaf's largest element
  plus 1e-6; those of frozen rows (the weight decay alone): 1e-6 relative.
"""

import math
import os
import random
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import torch.nn as nn
import yaml

import jax
import jax.numpy as jnp
import flax.linen as fnn
from flax import serialization

from tests._torch_port_common import IMGSZ, NC, few_threads, jax_flagship, small_flagship_cfg  # noqa: F401
from yolosomi_tpu import losses as jax_losses
from yolosomi_tpu.data import datasets as jax_datasets
from yolosomi_tpu.engine import checkpoint as jax_ckpt
from yolosomi_tpu.engine import ema as jax_ema
from yolosomi_tpu.engine import optim as jax_optim
from yolosomi_tpu.engine import trainer as jax_trainer
from yolosomi_tpu.utils import autoanchor as jax_autoanchor
from yolosomi_tpu.utils import iou as jax_iou
from yolosomi_tpu_torch import losses, train
from yolosomi_tpu_torch.data import datasets
from yolosomi_tpu_torch.engine import checkpoint, optim
from yolosomi_tpu_torch.engine.ema import ModelEMA
from yolosomi_tpu_torch.engine.runner import Runner
from yolosomi_tpu_torch.engine.trainer import create_train_state, make_train_step
from yolosomi_tpu_torch.models.layers import FlaxBatchNorm1d, FlaxBatchNorm2d
from yolosomi_tpu_torch.models.yolo import build_model, parse_model
from yolosomi_tpu_torch.ops.odconv import _DW_MAX_SPLIT, _dw_split
from yolosomi_tpu_torch.utils import autoanchor, iou
from yolosomi_tpu_torch.utils.config import find_config, load_hyp
from yolosomi_tpu_torch.utils.weights import _flax_leaf, _leaves, export_jax_variables, load_jax_variables

ROOT = Path(__file__).resolve().parents[1]
B, M = 2, 8  # batch, target rows per image
NB, EPOCHS = 4, 3  # the optimizer's schedule: batches per epoch, epochs


def flat(tree) -> dict:
    return {"/".join(p): np.asarray(v) for p, v in _leaves(tree)}


def targets_batch() -> np.ndarray:
    """(B, M, 5): real rows, a zero-width row, a zero-height row and
    padding (cls -1)."""
    t = np.full((B, M, 5), -1.0, np.float32)
    t[..., 1:] = 0.0
    t[0, :5] = [[0, .3, .4, .2, .3], [1, .6, .6, .1, .1], [2, .5, .5, .5, .4], [1, .4, .4, 0.0, .2],
                [0, .02, .97, .05, .04]]
    t[1, :3] = [[1, .2, .7, .15, .2], [0, .8, .3, .05, .08], [2, .5, .5, .3, 0.0]]
    return t


def batches() -> list:
    """Four image batches, already divided by 255 in f32 (both steps take
    float images as they are), so the NaN batch has their dtype and the
    JAX step compiles once."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (B, IMGSZ, IMGSZ, 3), dtype=np.uint8).astype(np.float32) / np.float32(255)
            for _ in range(4)]


def assert_updates_close(before: dict, got: dict, want: dict) -> None:
    """Each leaf's update within 2% of its largest update plus 4 ulp of its
    largest parameter (see the module docstring)."""
    for k in want:
        du, dj = got[k] - before[k], want[k] - before[k]
        tol = 0.02 * np.abs(dj).max() + 4 * np.spacing(np.float32(np.abs(before[k]).max()))
        assert np.abs(du - dj).max() <= tol, (k, np.abs(du - dj).max(), tol)


def assert_stats_close(got: dict, want: dict) -> None:
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def hyp():
    return load_hyp(find_config("hyp.visdrone", "hyps"))


ACC, FREEZE = 2, 3  # --accumulate 2 --freeze 3, in one JAX step


def cut_flagship_cfg() -> dict:
    """The small flagship's backbone (rows 0-8: Conv, ODConv, C2f-CBAM) under
    its DecoupledDetect at strides 4-32, without the neck: every kind of
    layer that --accumulate and --freeze act on, at a third of the JAX
    compile time."""
    cfg = small_flagship_cfg()
    cfg["backbone"] = cfg["backbone"][:9]
    cfg["head"] = [[[2, 4, 6, 8], 1, "DecoupledDetect", ["nc", "anchors"]]]
    return cfg


@pytest.fixture(scope="module")
def jax_programs(hyp):
    """The module's three JAX programs: the small flagship's train step, its
    loss in every LOSS_CASES case with the gradient with respect to the
    maps, and the cut flagship's train step with --accumulate 2 --freeze 3.
    Each compiles on a thread of its own as soon as it is lowered (XLA's
    compile releases the GIL), without XLA's backend optimizations (a third
    less compile time on the CPU; the arithmetic is the same)."""
    cfg, cut = small_flagship_cfg(), cut_flagship_cfg()
    model, meta, variables = jax_flagship(cfg)
    cut_model, cut_meta, cut_variables = jax_flagship(cut)
    t = jnp.asarray(targets_batch())
    x = jnp.asarray(batches()[0])
    opt = jax_optim.make_optimizer(hyp, nb=NB, epochs=EPOCHS, batch_size=B)
    state = jax_trainer.create_train_state(jax.tree_util.tree_map(jnp.asarray, variables), opt)
    acc_opt = jax_optim.make_optimizer(hyp, nb=NB, epochs=EPOCHS, batch_size=B, accumulate=ACC)
    acc_state = jax_trainer.create_train_state(jax.tree_util.tree_map(jnp.asarray, cut_variables), acc_opt,
                                               accumulate=ACC)
    fns = {case: jax_losses.ComputeLoss(meta, dict(hyp, **kw)) for case, kw in LOSS_CASES.items()}

    def all_cases(preds):
        return {case: jax.value_and_grad(lambda p, f=f: f(p, t), has_aux=True)(preds) for case, f in fns.items()}

    preds = [jnp.asarray(p) for p in seeded_preds(meta)]
    lowerings = {  # the largest first, so that it compiles while the others lower
        "step": lambda: jax_trainer.make_train_step(model, jax_losses.ComputeLoss(meta, hyp), opt).lower(state, x, t),
        "acc_step": lambda: jax_trainer.make_train_step(cut_model, jax_losses.ComputeLoss(cut_meta, hyp), acc_opt,
                                                        accumulate=ACC, freeze=FREEZE).lower(acc_state, x, t),
        "loss_cases": lambda: jax.jit(all_cases).lower(preds),
    }
    with ThreadPoolExecutor(len(lowerings)) as pool:
        futures = {k: pool.submit(lower().compile, {"xla_backend_optimization_level": 0})
                   for k, lower in lowerings.items()}
        compiled = {k: f.result() for k, f in futures.items()}
    return dict(compiled, cfg=cfg, model=model, meta=meta, variables=variables, opt=opt, state=state, preds=preds,
                cut=cut, cut_variables=cut_variables, acc_state=acc_state)


@pytest.fixture(scope="module")
def jax_run(jax_programs, tmp_path_factory):
    """The JAX package's train step: three steps, a NaN batch, a checkpoint
    of the three-step state, and a fourth step from it."""
    meta, step, state = jax_programs["meta"], jax_programs["step"], jax_programs["state"]
    t = jnp.asarray(targets_batch())
    imgs = batches()
    states, metrics = [state], []
    for i in range(3):
        state, m = step(state, jnp.asarray(imgs[i]), t)
        states.append(state)
        metrics.append(jax.device_get(m))
    nan_state, nan_metrics = step(state, jnp.full((B, IMGSZ, IMGSZ, 3), jnp.nan, jnp.float32), t)
    ckpt_path = tmp_path_factory.mktemp("jax_ckpt") / "step3.ckpt"
    jax_ckpt.save_checkpoint(ckpt_path, state, epoch=0, best_fitness=0.25, anchors=meta.anchors_px.reshape(4, -1))
    state4, m4 = step(state, jnp.asarray(imgs[3]), t)
    return dict(cfg=jax_programs["cfg"], meta=meta, variables=jax_programs["variables"], opt=jax_programs["opt"],
                states=jax.device_get(states), metrics=metrics, nan_state=jax.device_get(nan_state),
                nan_metrics=jax.device_get(nan_metrics), ckpt=ckpt_path, state4=jax.device_get(state4),
                metrics4=jax.device_get(m4), step=step)


def port_model(cfg, variables):
    model, meta = build_model(cfg, nc=NC, device="cpu")
    unmatched, unused = load_jax_variables(model, variables)
    assert not unmatched and not unused
    return model, meta


@pytest.fixture(scope="module")
def port_run(jax_run, hyp, tmp_path_factory):
    """The port's three steps from the same variables, a NaN batch, and a
    checkpoint of the three-step state."""
    model, meta = port_model(jax_run["cfg"], jax_run["variables"])
    opt = optim.make_optimizer(hyp, nb=NB, epochs=EPOCHS, batch_size=B)
    state = create_train_state(model, opt)
    step = make_train_step(losses.ComputeLoss(meta, hyp), opt)
    t, imgs = targets_batch(), batches()
    metrics = [{k: v.item() for k, v in step(state, imgs[i], t).items()} for i in range(3)]
    after3 = export_jax_variables(model)
    ema3 = export_jax_variables(state.ema.ema)
    ckpt_path = tmp_path_factory.mktemp("port_ckpt") / "step3.ckpt"
    checkpoint.save_checkpoint(ckpt_path, state, epoch=0, best_fitness=0.25, anchors=meta.anchors_px.reshape(4, -1))
    opt_step3 = int(state.opt_state.step)
    nan_metrics = step(state, np.full((B, IMGSZ, IMGSZ, 3), np.nan, np.float32), t)
    return dict(state=state, metrics=metrics, after3=after3, ema3=ema3, ckpt=ckpt_path, opt_step3=opt_step3,
                nan_metrics=nan_metrics, after_nan=export_jax_variables(model),
                ema_nan=export_jax_variables(state.ema.ema))


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


def seeded_preds(meta, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, IMGSZ // int(s), IMGSZ // int(s), meta.na, meta.nc + 5)) * 1.5).astype(np.float32)
            for s in meta.strides]


LOSS_CASES = {
    "ciou": {},  # NWD off
    "nwd": {"nwdloss": 1},
    "nwd_shape_ref_defect": {"nwdloss": 1, "shapeloss": 1, "nwd_ref_defect": True},
    "slide_focal_smoothing": {"slide_ratio": 1, "fl_gamma": 1.5, "label_smoothing": 0.1},
}


@pytest.fixture(scope="module")
def jax_loss_cases(jax_programs):
    """Every case's JAX loss and its gradient with respect to the maps."""
    return jax.device_get(jax_programs["loss_cases"](jax_programs["preds"]))


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_compute_loss_and_its_gradient_match_jax(jax_run, jax_loss_cases, hyp, case):
    """Padded and zero-size target rows included. Loss and components
    within 1e-5 relative; the gradient with respect to the maps within
    1e-4 of its largest element (f32, other summation orders)."""
    h = dict(hyp, **LOSS_CASES[case])
    meta = jax_run["meta"]
    preds = seeded_preds(meta)
    t = targets_batch()
    (jtotal, jcomps), jgrads = jax_loss_cases[case]
    tp = [torch.from_numpy(p).requires_grad_() for p in preds]
    ptotal, pcomps = losses.ComputeLoss(meta, h)(tp, torch.from_numpy(t))
    pgrads = torch.autograd.grad(ptotal, tp)
    np.testing.assert_allclose(ptotal.item(), float(jtotal), rtol=1e-5)
    np.testing.assert_allclose(pcomps.numpy(), np.asarray(jcomps), rtol=1e-5, atol=1e-8)
    for g, jg in zip(pgrads, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=1e-4 * np.abs(jg).max())


@pytest.mark.parametrize("ciou", [False, True], ids=["iou", "ciou"])
def test_bbox_iou_gradient_matches_jax_where_boxes_touch(ciou):
    """Pairs whose overlap is exactly 0 wide or high (boxes that touch):
    there JAX's clip has derivative 1/2 and torch's clamp 1, so the port
    clips as JAX does (utils/iou.py `_clip0`). The same values; gradients
    within 1e-6 of the largest."""
    b1 = np.array([[0.0, 0.0, 0.5, 0.5], [0.1, 0.2, 0.5, 0.75], [0.25, 0.25, 0.75, 0.5], [0.2, 0.1, 0.6, 0.3]],
                  np.float32)
    b2 = np.array([[0.5, 0.0, 1.0, 0.5], [0.5, 0.25, 0.875, 0.5], [0.0, 0.5, 0.5, 1.0], [0.3, 0.2, 0.5, 0.9]],
                  np.float32)
    want, jgrad = jax.value_and_grad(
        lambda a: jax_iou.bbox_iou(a, jnp.asarray(b2), xywh=False, CIoU=ciou).sum())(jnp.asarray(b1))
    t = torch.from_numpy(b1).requires_grad_()
    got = iou.bbox_iou(t, torch.from_numpy(b2), xywh=False, CIoU=ciou).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(t.grad.numpy(), jgrad, rtol=0, atol=1e-6 * np.abs(jgrad).max())


def test_build_targets_level_matches_jax_exactly(jax_run):
    """One image and one level, padded and zero-size rows included: every
    field, masked lanes and their benign geometry alike."""
    meta = jax_run["meta"]
    anchors = (meta.anchors_px[1] / meta.strides[1]).astype(np.float32)
    t = targets_batch()[0]
    ny = nx = IMGSZ // int(meta.strides[1])
    want = jax.jit(jax_losses.build_targets_level, static_argnums=(2, 3, 4))(jnp.asarray(t), jnp.asarray(anchors),
                                                                             ny, nx, 3.0)
    got = losses.build_targets_level(torch.from_numpy(t), torch.from_numpy(anchors), ny, nx, 3.0)
    for name in losses.LevelTargets._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    assert got.mask.sum() > 0


def test_pad_targets_marks_padding_with_cls_minus_one():
    got = losses.pad_targets([np.ones((2, 5), np.float32), np.zeros((0, 5), np.float32)], 3)
    np.testing.assert_array_equal(got, jax_losses.pad_targets([np.ones((2, 5), np.float32),
                                                               np.zeros((0, 5), np.float32)], 3))
    assert (got[0, 2] == [-1, 0, 0, 0, 0]).all() and (got[1, :, 0] == -1).all()


# ---------------------------------------------------------------------------
# the optimizer and the EMA
# ---------------------------------------------------------------------------


def test_optimizer_groups_every_leaf_as_jax_does(jax_run):
    """By flax leaf name: ODConv's candidate bank and BiFPN's fusion
    weights are `weight` leaves, so they are not decayed."""
    model, _ = port_model(jax_run["cfg"], jax_run["variables"])
    want = {"/".join(str(getattr(k, "key", k)) for k in path): jax_optim.param_group(path)
            for path, _ in jax.tree_util.tree_flatten_with_path(jax_run["variables"]["params"])[0]}
    got = {"/".join(_flax_leaf(model, n)[1]): g for n, _, g in optim.named_param_groups(model)}
    assert got == want
    bifpn = [k for k in got if k.startswith("layers_15/")]
    assert bifpn and all(got[k] == "bn" for k in bifpn)
    assert got["layers_1/conv/weight"] == "bn"  # ODConv's candidate bank
    assert got["layers_1/conv/fc/kernel"] == "weight" and got["layers_0/bn/scale"] == "bn"


@pytest.mark.parametrize("adam", [False, True], ids=["sgd", "adam"])
def test_optimizer_lr_and_momentum_over_1100_steps_match_jax(hyp, adam):
    """A three-leaf tree (two biases at 0 and a decayed kernel at 0.5, with
    fixed gradients and buffers) updated from every step count 0..1100:
    the warmup of the bias and other LRs and of the momentum, then the
    epoch schedule. The biases' updates within 1e-5 relative (the
    schedules are f32 on both sides); the kernel, 0.5 plus its update,
    within 2 ulp of 0.5."""
    steps = np.arange(1101)
    params = {"a": {"bias": jnp.zeros(3)}, "b": {"bias": jnp.zeros(3)}, "c": {"kernel": jnp.full((3,), 0.5)}}
    grads = {"a": {"bias": jnp.ones(3)}, "b": {"bias": jnp.zeros(3)}, "c": {"kernel": jnp.full((3,), 0.25)}}
    ones = jax.tree_util.tree_map(jnp.ones_like, params)
    jopt = jax_optim.make_optimizer(hyp, nb=50, epochs=30, batch_size=16, adam=adam)

    def jax_update(step):
        st = jax_optim.YoloOptState(step.astype(jnp.int32), ones, ones if adam else None, ones if adam else None)
        return jopt.update(grads, st, params)[0]

    want = jax.device_get(jax.jit(jax.vmap(jax_update))(jnp.asarray(steps)))
    popt = optim.make_optimizer(hyp, nb=50, epochs=30, batch_size=16, adam=adam)
    got = {k: [] for k in ("a", "b", "c")}
    for s in steps:
        p = [torch.zeros(3), torch.zeros(3), torch.full((3,), 0.5)]
        state = popt.init(p)
        state.step.fill_(int(s))
        for buf in (state.momentum_buf, state.adam_mu, state.adam_nu):
            if buf is not None:
                for t in buf:
                    t.fill_(1.0)
        popt.update(state, p, [torch.ones(3), torch.zeros(3), torch.full((3,), 0.25)], ["bias", "bias", "weight"])
        for k, t in zip("abc", p):
            got[k].append(t.numpy().copy())
    for k in ("a", "b"):
        np.testing.assert_allclose(np.array(got[k]), want[k]["bias"], rtol=1e-5, atol=1e-12, err_msg=k)
    np.testing.assert_allclose(np.array(got["c"]), np.float32(0.5) + want["c"]["kernel"].astype(np.float32), rtol=0,
                               atol=2 * np.spacing(np.float32(0.5)))
    assert np.abs(want["c"]["kernel"]).max() > 1e-4


def test_current_lr_matches_jax(hyp):
    for step in (0, 49, 50, 700, 1499):
        assert optim.current_lr(hyp, step, 50, 30) == pytest.approx(jax_optim.current_lr(hyp, step, 50, 30))
        assert optim.current_lr(hyp, step, 50, 30, True) == pytest.approx(
            jax_optim.current_lr(hyp, step, 50, 30, True))


def test_ema_matches_jax_over_params_and_batch_stats():
    """Five EMA updates towards a moving model (row 2 of the small
    flagship, a C2f-CBAM block): every floating leaf, BatchNorm statistics
    included; then a skipped update changes nothing."""
    cfg = small_flagship_cfg()
    cfg["head"] = cfg["head"][-1:]
    cfg["head"][0] = [[2, 2, 2, 2], 1, cfg["head"][0][2], cfg["head"][0][3]]
    model, _ = build_model(cfg, nc=NC, device="cpu")
    ema = ModelEMA(model)
    jstate = jax_ema.ema_init(jax.tree_util.tree_map(jnp.asarray, export_jax_variables(model)))
    jax_update = jax.jit(jax_ema.ema_update)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for _ in range(5):
            for t in model.state_dict().values():
                if t.is_floating_point():
                    t.add_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)) * 0.01)
            ema.update(model)
            jstate = jax_update(jstate, export_jax_variables(model))
    got, want = export_jax_variables(ema.ema), jax.device_get(jstate.variables)
    for c in ("params", "batch_stats"):
        assert_stats_close(flat(got[c]), flat(want[c]))
    assert int(ema.updates) == int(jstate.updates) == 5
    before = {k: v.clone() for k, v in ema.ema.state_dict().items()}
    ema.update(model, ok=torch.tensor(False))
    assert int(ema.updates) == 5 and all(torch.equal(v, before[k]) for k, v in ema.ema.state_dict().items())


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def test_three_train_steps_match_make_train_step(jax_run, port_run):
    """Loss components, parameter updates, BatchNorm statistics and the
    EMA after three steps (tolerances in the module docstring)."""
    for got, want in zip(port_run["metrics"], jax_run["metrics"]):
        for k in ("loss", "lbox", "lobj", "lcls"):
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, err_msg=k)
        assert got["grads_finite"] and bool(want["grads_finite"])
    s3 = jax_run["states"][3]
    before = flat(jax_run["variables"]["params"])
    assert_updates_close(before, flat(port_run["after3"]["params"]), flat(s3.params))
    assert_stats_close(flat(port_run["after3"]["batch_stats"]), flat(s3.batch_stats))
    assert_stats_close(flat(port_run["ema3"]["params"]), flat(s3.ema.variables["params"]))
    assert_stats_close(flat(port_run["ema3"]["batch_stats"]), flat(s3.ema.variables["batch_stats"]))
    assert port_run["opt_step3"] == int(s3.opt_state.step) == 3


def test_a_nan_batch_changes_nothing(jax_run, port_run):
    """The finite guard: no parameter, BatchNorm statistic, EMA leaf or
    optimizer step moves on a step with non-finite gradients, in either
    package; the train-step counter does."""
    assert not bool(port_run["nan_metrics"]["grads_finite"]) and not bool(jax_run["nan_metrics"]["grads_finite"])
    for c in ("params", "batch_stats"):
        for k, v in flat(port_run["after3"][c]).items():
            np.testing.assert_array_equal(flat(port_run["after_nan"][c])[k], v, err_msg=k)
            np.testing.assert_array_equal(flat(port_run["ema_nan"][c])[k], flat(port_run["ema3"][c])[k], err_msg=k)
    state = port_run["state"]
    assert int(state.opt_state.step) == 3 and state.step == 4 and int(state.ema.updates) == 3
    js = jax_run["nan_state"]
    assert int(js.opt_state.step) == 3 and int(js.step) == 4
    for k, v in flat(jax_run["states"][3].batch_stats).items():
        np.testing.assert_array_equal(flat(js.batch_stats)[k], v)


def fresh_step(jax_run, hyp, **kw):
    model, meta = port_model(jax_run["cfg"], jax_run["variables"])
    opt = optim.make_optimizer(hyp, nb=NB, epochs=EPOCHS, batch_size=B, accumulate=kw.get("accumulate", 1))
    state = create_train_state(model, opt, accumulate=kw.get("accumulate", 1))
    return model, meta, opt, state, make_train_step(losses.ComputeLoss(meta, hyp), opt, **kw)



def assert_buffers_close(got: dict, want: dict) -> None:
    """Momentum buffers hold sums of gradients: each leaf within 2% of its
    largest element plus 1e-6 (leaves whose gradients are ~0)."""
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= 0.02 * np.abs(want[k]).max() + 1e-6, k


@pytest.fixture(scope="module")
def acc_freeze_runs(jax_programs, hyp):
    """Four calls of each package's train step with --accumulate 2 and
    --freeze 3 on the cut flagship from the same variables (so two
    optimizer steps), and each package's state after every call:
    parameters, BatchNorm statistics, EMA, the optimizer's step and its
    momentum buffers in flax's layout."""
    imgs, t = batches(), targets_batch()
    step, state = jax_programs["acc_step"], jax_programs["acc_state"]
    want = []
    for x in imgs:
        state, _ = step(state, jnp.asarray(x), jnp.asarray(t))
        s = jax.device_get(state)
        want.append(dict(params=flat(s.params), batch_stats=flat(s.batch_stats),
                         ema_params=flat(s.ema.variables["params"]),
                         ema_batch_stats=flat(s.ema.variables["batch_stats"]), ema_updates=int(s.ema.updates),
                         opt_step=int(s.opt_state.step), momentum=flat(s.opt_state.momentum_buf)))
    cut = dict(cfg=jax_programs["cut"], variables=jax_programs["cut_variables"])
    pmodel, _, popt, pstate, pstep = fresh_step(cut, hyp, accumulate=ACC, freeze=FREEZE)
    got = []
    for x in imgs:
        pstep(pstate, x, t)
        payload = checkpoint.build_checkpoint_payload(pstate)  # its arrays are views of the live tensors
        copied = {k: {n: v.copy() for n, v in flat(payload[k]).items()}
                  for k in ("params", "batch_stats", "ema_params", "ema_batch_stats")}
        got.append(dict(copied, ema_updates=payload["ema_updates"], opt_step=int(payload["opt_state"]["step"]),
                        momentum={n: v.copy() for n, v in flat(payload["opt_state"]["momentum_buf"]).items()}))
    assert popt.decay == pytest.approx(hyp["weight_decay"] * B * ACC / 64)
    return dict(want=want, got=got, before=flat(jax_programs["cut_variables"]["params"]))


def test_accumulate_2_steps_once_on_the_summed_gradients(acc_freeze_runs):
    """Against the JAX step with --accumulate 2 (--freeze 3 on too): the
    first call of each pair moves only BatchNorm statistics; the second
    steps the optimizer and the EMA once on the sum of both calls'
    gradients, with the decay scaled by the accumulation. After every call,
    each package's parameter updates, BatchNorm statistics, EMA, optimizer
    step and momentum buffers agree (tolerances in the module docstring
    and assert_buffers_close)."""
    before = acc_freeze_runs["before"]
    for i, (got, want) in enumerate(zip(acc_freeze_runs["got"], acc_freeze_runs["want"])):
        assert got["opt_step"] == want["opt_step"] == (i + 1) // ACC, i
        assert got["ema_updates"] == want["ema_updates"] == (i + 1) // ACC, i
        if i == 0:  # nothing but the statistics has moved yet
            for k, v in before.items():
                np.testing.assert_array_equal(got["params"][k], v, err_msg=k)
                np.testing.assert_array_equal(want["params"][k], v, err_msg=k)
        assert_updates_close(before, got["params"], want["params"])
        for c in ("batch_stats", "ema_params", "ema_batch_stats"):
            assert_stats_close(got[c], want[c])
        assert_buffers_close(got["momentum"], want["momentum"])
    assert any(np.abs(v).max() > 0 for v in acc_freeze_runs["got"][-1]["momentum"].values())


def test_freeze_masks_the_first_layers(acc_freeze_runs):
    """Against the JAX step with --freeze 3 (--accumulate 2 on too): rows
    0-2 keep their parameters through both optimizer steps in both
    packages, while the later rows' biases move; the frozen rows' momentum
    buffers still take the (accumulation-scaled) weight decay, as the JAX
    package masks the updates and not the optimizer state, and match
    JAX's."""
    before, got, want = acc_freeze_runs["before"], acc_freeze_runs["got"][-1], acc_freeze_runs["want"][-1]
    frozen = [k for k in before if k.split("/")[0] in {f"layers_{i}" for i in range(FREEZE)}]
    assert frozen
    for k in frozen:
        np.testing.assert_array_equal(got["params"][k], before[k], err_msg=k)
        np.testing.assert_array_equal(want["params"][k], before[k], err_msg=k)
    # the biases move at warmup_bias_lr (the other LRs start at 0)
    biases = [k for k in before if k.endswith("/bias") and k not in frozen]
    moved = [k for k in biases if not np.array_equal(got["params"][k], before[k])]
    assert len(moved) >= 0.8 * len(biases)
    decayed = [k for k in frozen if k.endswith("/kernel")]
    assert decayed and all(np.abs(got["momentum"][k]).max() > 0 for k in decayed)
    for k in frozen:
        np.testing.assert_allclose(got["momentum"][k], want["momentum"][k], rtol=1e-6, atol=1e-9, err_msg=k)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_jax_resumes_a_port_checkpoint(jax_run, port_run):
    """load_checkpoint + from_state_dict restore the port's file into the
    JAX train state's structure; the values are the port's three steps,
    and the JAX train step resumed from them takes JAX's fourth step."""
    ckpt = jax_ckpt.load_checkpoint(port_run["ckpt"])
    s3 = jax_run["states"][3]
    opt_state = serialization.from_state_dict(s3.opt_state, ckpt["opt_state"])
    assert int(opt_state.step) == 3 and ckpt["epoch"] == 0 and ckpt["best_fitness"] == 0.25
    assert ckpt["step"] == 3 and ckpt["ema_updates"] == 3
    for tree in ("params", "batch_stats", "ema_params", "ema_batch_stats"):
        src = {"params": s3.params, "batch_stats": s3.batch_stats, "ema_params": s3.ema.variables["params"],
               "ema_batch_stats": s3.ema.variables["batch_stats"]}[tree]
        assert jax.tree_util.tree_structure(ckpt[tree]) == jax.tree_util.tree_structure(src), tree
    assert jax.tree_util.tree_structure(opt_state.momentum_buf) == jax.tree_util.tree_structure(s3.params)
    assert_updates_close(flat(jax_run["variables"]["params"]), flat(ckpt["params"]), flat(s3.params))
    assert_buffers_close(flat(opt_state.momentum_buf), flat(s3.opt_state.momentum_buf))
    np.testing.assert_array_equal(ckpt["anchors"], np.asarray(jax_run["meta"].anchors_px, np.float32).reshape(4, -1))
    resumed = jax_trainer.TrainState(
        params=ckpt["params"], batch_stats=ckpt["batch_stats"], opt_state=opt_state,
        ema=jax_ema.EMAState({"params": ckpt["ema_params"], "batch_stats": ckpt["ema_batch_stats"]},
                             np.asarray(ckpt["ema_updates"], np.int32)),
        step=np.asarray(ckpt["step"], np.int32))
    state4, m4 = jax_run["step"](jax.tree_util.tree_map(jnp.asarray, resumed), jnp.asarray(batches()[3]),
                                 jnp.asarray(targets_batch()))
    for k in ("loss", "lbox", "lobj", "lcls"):
        np.testing.assert_allclose(float(m4[k]), float(jax_run["metrics4"][k]), rtol=1e-5, err_msg=k)
    want = jax_run["state4"]
    assert_updates_close(flat(s3.params), flat(jax.device_get(state4.params)), flat(want.params))
    assert_stats_close(flat(jax.device_get(state4.batch_stats)), flat(want.batch_stats))


def test_port_resumes_a_jax_checkpoint_and_takes_its_step(jax_run, hyp):
    """The port restores the JAX package's three-step checkpoint (weights,
    BatchNorm statistics, EMA, optimizer state) and its fourth step
    matches the JAX step from the same state."""
    model, meta, opt, state, step = fresh_step(jax_run, hyp)
    checkpoint.restore_train_state(state, checkpoint.load_checkpoint(jax_run["ckpt"]))
    assert int(state.opt_state.step) == 3 and state.step == 3 and int(state.ema.updates) == 3
    m = step(state, batches()[3], targets_batch())
    for k in ("loss", "lbox", "lobj", "lcls"):
        np.testing.assert_allclose(m[k].item(), float(jax_run["metrics4"][k]), rtol=1e-5, err_msg=k)
    s3, s4 = jax_run["states"][3], jax_run["state4"]
    assert_updates_close(flat(s3.params), flat(export_jax_variables(model)["params"]), flat(s4.params))
    assert_stats_close(flat(export_jax_variables(model)["batch_stats"]), flat(s4.batch_stats))
    assert_stats_close(flat(export_jax_variables(state.ema.ema)["params"]), flat(s4.ema.variables["params"]))


def test_async_checkpointer_writes_the_newest_state(jax_run, hyp, tmp_path):
    model, meta, opt, state, step = fresh_step(jax_run, hyp)
    writer = checkpoint.AsyncCheckpointer()
    try:
        writer.save([tmp_path / "a.ckpt", tmp_path / "b.ckpt"], state, epoch=1)
        writer.save([tmp_path / "a.ckpt", tmp_path / "b.ckpt"], state, epoch=2)
        writer.wait()
    finally:
        writer.close()
    assert (tmp_path / "a.ckpt").read_bytes() == (tmp_path / "b.ckpt").read_bytes()
    assert checkpoint.load_checkpoint(tmp_path / "a.ckpt")["epoch"] == 2
    assert not list(tmp_path.glob("*.tmp"))


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------


def test_eval_outputs_are_those_of_torch_batchnorm(jax_run):
    """Serving does not move: with every Flax BatchNorm swapped for torch's
    own (same state), the eval-mode outputs are bitwise the same."""
    model, _ = port_model(jax_run["cfg"], jax_run["variables"])
    plain, _ = port_model(jax_run["cfg"], jax_run["variables"])
    found = [(parent, name, child) for parent in plain.modules() for name, child in parent.named_children()
             if isinstance(child, (FlaxBatchNorm1d, FlaxBatchNorm2d))]
    for parent, name, child in found:
        base = nn.BatchNorm1d if isinstance(child, FlaxBatchNorm1d) else nn.BatchNorm2d
        swap = base(child.num_features, eps=child.eps, momentum=child.momentum)
        swap.load_state_dict(child.state_dict())
        setattr(parent, name, swap)
    assert not any(isinstance(m, (FlaxBatchNorm1d, FlaxBatchNorm2d)) for m in plain.modules())
    x = torch.from_numpy(batches()[0]).permute(0, 3, 1, 2)
    with torch.no_grad():
        for a, b in zip(model.eval()(x), plain.eval()(x)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(2, 16), (1, 16), (2, 8, 5, 3)], ids=["1d_batch_2", "1d_batch_1", "2d"])
def test_train_mode_batchnorm_keeps_flax_running_statistics(shape):
    """flax.linen.BatchNorm updates its running variance with the biased
    batch variance (at batch 2, torch's unbiased update is twice it), and
    normalizes a batch of one value per channel (ODConv's attention trunk
    under --quad at batch 4), where torch's batch_norm refuses."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32) * 3 + 1
    c = shape[1]
    bn = (FlaxBatchNorm1d if len(shape) == 2 else FlaxBatchNorm2d)(c, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        bn.running_mean.uniform_(-1, 1)
        bn.running_var.uniform_(0.5, 2)
    rm, rv = bn.running_mean.numpy().copy(), bn.running_var.numpy().copy()
    y = bn.train()(torch.from_numpy(x)).detach().numpy()
    xj = np.moveaxis(x, 1, -1)  # channels last, as flax normalizes the last axis
    fbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.ones(c), "bias": jnp.zeros(c)},
                 "batch_stats": {"mean": jnp.asarray(rm), "var": jnp.asarray(rv)}}
    yj, upd = fbn.apply(variables, jnp.asarray(xj), mutable=["batch_stats"])
    np.testing.assert_allclose(y, np.moveaxis(np.asarray(yj), -1, 1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the gradient kernels' geometry (the kernels themselves run on the card)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 320, 64, 128), (8, 160, 256, 256), (8, 80, 256, 256), (8, 40, 512, 256),
                                   (2, 320, 64, 128), (2, 32, 16, 32), (3, 22, 24, 72), (1, 2, 8, 8)])
def test_dwmix_split_covers_the_pixel_reduction_once(shape):
    """Parts of whole 32-pixel steps, none empty, together every pixel once
    (csrc/odconv_s2_bwd.cu's pix_per_split); at 640 px, b8, only row 1
    splits."""
    b, h, cin, cout = shape
    split = _dw_split(b, h, h, cin, cout)
    pixels = (h // 2) ** 2
    steps = math.ceil(pixels / 32)
    per = math.ceil(steps / split) * 32
    covered = [range(i * per, min(pixels, (i + 1) * per)) for i in range(split)]
    assert 1 <= split <= _DW_MAX_SPLIT and all(len(r) > 0 for r in covered)
    assert sorted(p for r in covered for p in r) == list(range(pixels))
    if b == 8:  # the flagship's sites at 640 px
        assert (split > 1) == (h == 320)


# ---------------------------------------------------------------------------
# data: the augmenting loader and autoanchor
# ---------------------------------------------------------------------------


def write_set(root: Path, n: int, seed: int = 0) -> Path:
    """n small JPEGs of two sizes with 0-4 labelled boxes each."""
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        h, w = (72, 96) if i % 2 else (100, 80)
        cv2.imwrite(str(root / "images" / f"{i}.jpg"), rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
        rows = [f"{rng.integers(0, 3)} {rng.uniform(.2, .8):.6f} {rng.uniform(.2, .8):.6f} "
                f"{rng.uniform(.05, .4):.6f} {rng.uniform(.05, .4):.6f}" for _ in range(rng.integers(0, 5))]
        (root / "labels" / f"{i}.txt").write_text("\n".join(rows))
    return root / "images"


def test_mosaic_mixup_batches_are_bitwise_jax_batches(tmp_path, hyp):
    """hyp.visdrone with mixup always on, two epochs of shuffled batches
    from one item thread and no prefetch thread, each package after
    random.seed and np.random.seed of the same seed: the same bytes."""
    images = write_set(tmp_path / "ds", 6)
    h = dict(hyp, mixup=1.0)

    def run(mod):
        random.seed(3)
        np.random.seed(3)
        ds = mod.DetectionDataset(str(images), img_size=IMGSZ, augment=True, hyp=h, max_labels=16)
        loader = mod.DataLoader(ds, 2, shuffle=True, drop_last=True, prefetch=0, workers=1)
        return [b for _ in range(2) for b in loader]

    want, got = run(jax_datasets), run(datasets)
    assert len(got) == len(want) == 6
    for (gi, gt, gp, _), (wi, wt, wp, _) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gt, wt)
        assert gp == wp
    assert sum(int((b[1][..., 0] >= 0).sum()) for b in got) > 0


def test_check_anchors_matches_jax(tmp_path):
    """Labels far from the default anchors fail the recall check; both
    packages re-cluster them (scipy's k-means and the 1000-generation
    mutation) from the same seeds to the same anchors."""
    root = tmp_path / "ds"
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.default_rng(1)
    for i in range(12):
        cv2.imwrite(str(root / "images" / f"{i}.png"), np.zeros((48, 64, 3), np.uint8))
        rows = [f"0 0.5 0.5 {rng.uniform(.6, .95):.6f} {rng.uniform(.02, .05):.6f}" for _ in range(3)]
        (root / "labels" / f"{i}.txt").write_text("\n".join(rows))
    cfg = small_flagship_cfg()
    from yolosomi_tpu.models.yolo import build_model as jax_build_model

    _, jmeta = jax_build_model(cfg, nc=NC)
    with torch.device("meta"):
        _, pmeta = parse_model(dict(cfg, nc=NC))
    results = []
    for mod, meta, aa in ((jax_datasets, jmeta, jax_autoanchor), (datasets, pmeta, autoanchor)):
        ds = mod.DetectionDataset(str(root / "images"), img_size=IMGSZ)
        random.seed(0)
        np.random.seed(0)
        results.append(aa.check_anchors(ds, meta, thr=3.0, imgsz=IMGSZ))
    assert results[1] is not None and results[1].shape == (4, 8)
    np.testing.assert_allclose(results[1], results[0], rtol=1e-6)


def test_kmeanplus_anchors_find_the_clusters():
    """The port's own k-means++ (the JAX package calls scikit-learn's,
    which the card does not have) on wh drawn around six known centres
    with a spread of 0.5 px (so the true clusters are k-means' optimum):
    each centre found within 5%, sorted by area."""
    rng = np.random.default_rng(0)
    centres = np.array([4, 9, 20, 45, 90, 180], np.float64)
    wh = np.concatenate([rng.normal(c, 0.5, (30, 2)) for c in centres]).clip(2.5)
    got = autoanchor.kmeanplus_anchors(wh, n=6)
    assert got.shape == (6, 2) and (np.diff(got.prod(1)) >= 0).all()
    np.testing.assert_allclose(got, np.repeat(centres[:, None], 2, 1), rtol=0.05)


# ---------------------------------------------------------------------------
# val and the CLI
# ---------------------------------------------------------------------------


def test_val_run_reports_the_mean_loss_of_the_eval_forward(jax_run, hyp, tmp_path):
    """results[4:7] are ComputeLoss's components on the Runner's eval-mode
    forward, averaged over the batches (checked batch by batch)."""
    images = write_set(tmp_path / "ds", 4)
    cfg = tmp_path / "somi-small.yaml"
    cfg.write_text(yaml.safe_dump(jax_run["cfg"]))
    runner = Runner(str(cfg), nc=NC, dtype=torch.float32, device="cpu", variables=jax_run["variables"])
    loss = losses.ComputeLoss(runner.meta, hyp)
    from yolosomi_tpu_torch import val

    data = {"path": str(tmp_path / "ds"), "val": str(images), "nc": NC, "names": ["a", "b", "c"]}
    loader = datasets.DataLoader(datasets.DetectionDataset(str(images), img_size=IMGSZ), 2)
    results, _, _ = val.run(data, runner=runner, batch_size=2, imgsz=IMGSZ, compute_loss=loss, dataloader=loader,
                            project=str(tmp_path / "runs"))
    want = np.mean([runner.val_loss_fn(loss)(imgs, t) for imgs, t, _, _ in loader], 0)
    np.testing.assert_allclose(results[4:7], want, rtol=1e-6)
    assert all(v > 0 for v in results[4:6])


@pytest.mark.parametrize("flag", ["--upload-dataset"])
def test_train_refuses_what_is_not_ported(flag, tmp_path):
    opt = train.parse_opt(["--project", str(tmp_path), "--device", "cpu", *flag.split()])
    with pytest.raises(NotImplementedError, match="not ported"):
        train.train(load_hyp(find_config("hyp.visdrone", "hyps")), opt)


def test_train_cli_on_the_cpu_writes_results_and_weights(tmp_path):
    """python -m yolosomi_tpu_torch.train --device cpu: 2 epochs of 2
    batches on the small flagship; results.csv in the JAX package's
    columns, and weights/{last,best}.{ckpt,msgpack} that load back."""
    images = write_set(tmp_path / "ds", 4)
    data = tmp_path / "data.yaml"
    data.write_text(yaml.safe_dump({"path": str(tmp_path / "ds"), "train": str(images), "val": str(images),
                                    "nc": NC, "names": ["a", "b", "c"]}))
    cfg = tmp_path / "somi-small.yaml"
    cfg.write_text(yaml.safe_dump(small_flagship_cfg()))
    proc = subprocess.run(
        [sys.executable, "-m", "yolosomi_tpu_torch.train", "--cfg", str(cfg), "--data", str(data), "--epochs", "2",
         "--batch-size", "2", "--imgsz", str(IMGSZ), "--device", "cpu", "--no-bf16", "--workers", "2",
         "--max-labels", "16", "--project", str(tmp_path / "runs"), "--name", "t"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    run = tmp_path / "runs" / "t"
    lines = (run / "results.csv").read_text().splitlines()
    assert lines[0] == "epoch,box,obj,cls,P,R,mAP50,mAP,fitness" and [ln.split(",")[0] for ln in lines[1:]] == ["0", "1"]
    for f in ("last.ckpt", "best.ckpt", "last.msgpack", "best.msgpack"):
        assert (run / "weights" / f).exists(), f
    ckpt = checkpoint.load_checkpoint(run / "weights" / "last.ckpt")
    assert ckpt["epoch"] == 1 and int(ckpt["opt_state"]["step"]) == 4 and ckpt["step"] == 4
    runner = Runner(str(cfg), str(run / "weights" / "last.msgpack"), device="cpu", dtype=torch.float32)
    out = runner(np.zeros((1, IMGSZ, IMGSZ, 3), np.uint8))
    assert out.shape == (1, 300, 6) and np.isfinite(out).all()
