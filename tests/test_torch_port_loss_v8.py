"""The anchor-free heads' task-aligned loss (losses_v8.py), ComputeLoss's
IAuxDetect branch and the training of the four detection configs of the
zoo, against the JAX package on the CPU: the anchor points and distance
codecs, the distribution focal loss, the assigner's masks, targets and
scores (a constructed top-k tie and an IoU tie included), ComputeLossV8's
total and components (rtol 1e-5) and its gradient with respect to the maps
(within 1e-4 of the largest element, f32), one DetectV8 train step
against make_train_step, and one train-mode forward, loss and backward of
yolov3-tiny (two levels), yolov5s-ghost, yolov5s-transformer and yolov10
against jax.value_and_grad.

The JAX programs are compiled on threads at once, without XLA's backend
optimizations (the arithmetic is the same), as
tests/test_torch_port_train.py does.
"""

from concurrent.futures import ThreadPoolExecutor

import json

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from tests._torch_port_common import IMGSZ, NC, few_threads, jax_random_model  # noqa: F401
from tests.test_torch_port_heads import head_cfg, jax_variables, lively
from tests.test_torch_port_train import (B, EPOCHS, NB, assert_stats_close, assert_updates_close, flat, targets_batch,
                                         write_set)
from tests.test_torch_port_zoo import DETECTION, small_cfg
from yolosomi_tpu import losses as jax_losses
from yolosomi_tpu import losses_v8 as jv8
from yolosomi_tpu.engine import optim as jax_optim
from yolosomi_tpu.engine import trainer as jax_trainer
from yolosomi_tpu.models import yolo as jyolo
from yolosomi_tpu_torch import losses_v8 as pv8
from yolosomi_tpu_torch import train
from yolosomi_tpu_torch.engine import optim
from yolosomi_tpu_torch.engine.trainer import create_train_state, make_train_step
from yolosomi_tpu_torch.losses import ComputeLoss
from yolosomi_tpu_torch.models.yolo import build_model
from yolosomi_tpu_torch.utils.config import find_config, load_hyp
from yolosomi_tpu_torch.utils.weights import export_jax_variables, export_param_tree, load_jax_variables

STRIDES = (8.0, 16.0, 32.0)
SHAPES = [(IMGSZ // 8, IMGSZ // 8), (IMGSZ // 16, IMGSZ // 16), (IMGSZ // 32, IMGSZ // 32)]
REG_MAX = 16


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def v8_preds(seed: int = 0):
    """DFL maps of the three levels: the box logits spread so that the
    decoded boxes range over a few cells, the class logits about -1."""
    rng = np.random.default_rng(seed)
    return [np.concatenate([rng.standard_normal((B, h, w, 4 * REG_MAX)) * 2.0,
                            rng.standard_normal((B, h, w, NC)) - 1.0], -1).astype(np.float32) for h, w in SHAPES]


class Meta:  # what the losses read of a ModelMeta
    nc, nl, strides = NC, 3, STRIDES


def tie_case():
    """One image whose every anchor has the same class scores and the same
    box, so that a ground truth's candidates tie in alignment (more than
    top-k of them inside it: the lower index wins), and two ground truths
    with the same box and different classes (the IoU tie: the first wins)."""
    n = sum(h * w for h, w in SHAPES)
    pd_scores = np.full((1, n, NC), 0.4, np.float32)
    pd_bboxes = np.tile(np.array([[[8.0, 8.0, 40.0, 48.0]]], np.float32), (1, n, 1))
    gt = np.array([[[8.0, 8.0, 40.0, 48.0], [8.0, 8.0, 40.0, 48.0], [30.0, 20.0, 60.0, 40.0], [0, 0, 0, 0]]],
                  np.float32)
    labels = np.array([[1, 2, 0, -1]], np.int32)
    return pd_scores, pd_bboxes, labels, gt


# ---------------------------------------------------------------------------
# the JAX programs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hyp():
    return load_hyp(find_config("hyp.visdrone", "hyps"))


@pytest.fixture(scope="module")
def jax_results(hyp):
    """Every JAX program of the module, lowered and compiled on threads,
    and run: the loss and its gradient, the assigner on random and tied
    inputs, ComputeLoss's IAuxDetect branch with its gradient, the
    DetectV8 graph's train step, and each zoo config's loss, gradients
    and moved statistics."""
    t = jnp.asarray(targets_batch())
    preds = [jnp.asarray(p) for p in v8_preds()]
    rng = np.random.default_rng(1)
    n = sum(h * w for h, w in SHAPES)
    anc, strs = jv8.make_anchor_points(SHAPES, STRIDES)
    anc_px = anc * strs[:, None]
    rand_assign = (jnp.asarray(rng.random((B, n, NC)).astype(np.float32)),
                   jnp.asarray(np.sort(rng.random((B, n, 4)).astype(np.float32) * 64, -1)[..., [0, 1, 2, 3]]),
                   anc_px, jnp.asarray(targets_batch()[..., 0].astype(np.int32)),
                   jnp.asarray(_xyxy(targets_batch())))
    tie = tuple(jnp.asarray(a) for a in tie_case())

    loss_v8 = jv8.ComputeLossV8(Meta, hyp)
    cfg_aux = head_cfg("IAuxDetect")
    _, aux_meta = jyolo.build_model(cfg_aux)
    aux_loss = jax_losses.ComputeLoss(aux_meta, hyp)
    aux_preds = [jnp.asarray(p) for p in aux_maps(aux_meta)]

    cfg8 = head_cfg("DetectV8")
    model8, meta8 = jyolo.build_model(cfg8)
    variables8 = jax_variables(model8, jnp.zeros((1, IMGSZ, IMGSZ, 3)), 3)
    variables8 = {"params": lively(variables8["params"]), "batch_stats": variables8["batch_stats"]}
    opt = jax_optim.make_optimizer(hyp, nb=NB, epochs=EPOCHS, batch_size=B)
    state8 = jax_trainer.create_train_state(jax.tree_util.tree_map(jnp.asarray, variables8), opt)
    x = jnp.asarray(step_images())

    programs = {
        "loss": (jax.jit(jax.value_and_grad(lambda p: loss_v8(p, t), has_aux=True)), (preds,)),
        "assign": (jax.jit(lambda *a: jv8.task_aligned_assign(*a)), rand_assign),
        "assign_tie": (jax.jit(lambda p, b, a, l, g: jv8.task_aligned_assign(p, b, a, l, g)),
                       (tie[0], tie[1], anc_px, tie[2], tie[3])),
        "aux": (jax.jit(jax.value_and_grad(lambda p: aux_loss(p, t), has_aux=True)), (aux_preds,)),
        "step8": (jax_trainer.make_train_step(model8, jv8.ComputeLossV8(meta8, hyp), opt), (state8, x, t)),
    }
    zoo = {}
    for name in DETECTION:
        jmodel, jmeta, variables = jax_random_model(small_cfg(name))
        jloss = jax_losses.ComputeLoss(jmeta, hyp)

        def loss_of(params, jmodel=jmodel, jloss=jloss, stats=variables["batch_stats"]):
            out, mutated = jmodel.apply({"params": params, "batch_stats": stats}, x, train=True,
                                        mutable=["batch_stats"])
            loss, comps = jloss(out, t)
            return loss, (comps, mutated["batch_stats"])

        programs[name] = (jax.jit(jax.value_and_grad(loss_of, has_aux=True)), (variables["params"],))
        zoo[name] = variables
    with ThreadPoolExecutor(4) as pool:
        futures = {k: pool.submit(lambda f, a: f.lower(*a).compile({"xla_backend_optimization_level": 0}), f, a)
                   for k, (f, a) in programs.items()}
        compiled = {k: fut.result() for k, fut in futures.items()}
    out = {k: jax.device_get(compiled[k](*a)) for k, (_, a) in programs.items()}
    return dict(out, rand_assign=jax.device_get(rand_assign), anc_px=np.asarray(anc_px), aux_meta=aux_meta,
                aux_preds=jax.device_get(aux_preds), cfg8=cfg8, variables8=variables8, zoo=zoo)


def _xyxy(t: np.ndarray) -> np.ndarray:
    """Normalized xywh rows -> pixel xyxy at IMGSZ."""
    xy, wh = t[..., 1:3] * IMGSZ, t[..., 3:5] * IMGSZ
    return np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)


def aux_maps(meta, seed: int = 2):
    """IAuxDetect's train-mode maps: nl lead and nl aux (B, ny, nx, na, no)."""
    rng = np.random.default_rng(seed)
    lead = [(rng.standard_normal((B, IMGSZ // int(s), IMGSZ // int(s), meta.na, meta.nc + 5)) * 1.5).astype(np.float32)
            for s in meta.strides]
    return lead + [(p * 0.5 + 0.3).astype(np.float32) for p in lead]


def step_images() -> np.ndarray:
    return (np.random.default_rng(4).integers(0, 256, (B, IMGSZ, IMGSZ, 3), dtype=np.uint8).astype(np.float32)
            / np.float32(255))


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


def test_anchor_points_and_distance_codecs_match_jax():
    anc, strs = pv8.make_anchor_points(SHAPES, STRIDES)
    janc, jstrs = jv8.make_anchor_points(SHAPES, STRIDES)
    np.testing.assert_array_equal(anc.numpy(), np.asarray(janc))
    np.testing.assert_array_equal(strs.numpy(), np.asarray(jstrs))
    rng = np.random.default_rng(5)
    dist = (rng.random((B, len(anc), 4)) * 20).astype(np.float32)
    boxes = pv8.dist2bbox(torch.from_numpy(dist), anc[None])
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jv8.dist2bbox(jnp.asarray(dist), janc[None])), rtol=1e-6)
    back = pv8.bbox2dist(boxes, anc[None], REG_MAX)  # clamped to [0, 14.99]
    np.testing.assert_allclose(back.numpy(), np.asarray(jv8.bbox2dist(jnp.asarray(boxes.numpy()), janc[None], REG_MAX)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(back.numpy(), np.clip(dist, 0, REG_MAX - 1.01), atol=1e-5)


def test_df_loss_and_its_gradient_match_jax():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((B, 20, 4, REG_MAX)).astype(np.float32)
    target = np.concatenate([rng.random((B, 19, 4)) * (REG_MAX - 1.01), np.full((B, 1, 4), REG_MAX - 1.01)],
                            1).astype(np.float32)  # the last row at the clamp: its upper bin is the last
    want, jgrad = jax.value_and_grad(lambda p: jv8._df_loss(p, jnp.asarray(target)).sum())(jnp.asarray(logits))
    p = torch.from_numpy(logits).requires_grad_()
    got = pv8._df_loss(p, torch.from_numpy(target))
    np.testing.assert_allclose(got.sum().item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(torch.autograd.grad(got.sum(), p)[0].numpy(), np.asarray(jgrad), atol=1e-6)


@pytest.mark.parametrize("case", ["random", "tie"])
def test_task_aligned_assign_matches_jax(jax_results, case):
    """Labels, foreground mask and the per-anchor box exactly; target
    scores within 1e-6. In the tie case more candidates than top-k share
    one alignment and two ground truths share one box: the same anchors
    and the same ground truths win."""
    if case == "random":
        args = [np.asarray(a) for a in jax_results["rand_assign"]]
    else:
        pd_scores, pd_bboxes, labels, gt = tie_case()
        args = [pd_scores, pd_bboxes, jax_results["anc_px"], labels, gt]
    want = jax_results["assign" if case == "random" else "assign_tie"]
    got = pv8.task_aligned_assign(*(torch.from_numpy(np.array(a)) for a in args))
    labels, bboxes, scores, fg = (t.numpy() for t in got)
    np.testing.assert_array_equal(fg, np.asarray(want[3]))
    np.testing.assert_array_equal(labels, np.asarray(want[0]))
    np.testing.assert_array_equal(bboxes, np.asarray(want[1]))
    np.testing.assert_allclose(scores, np.asarray(want[2]), atol=1e-6)
    assert fg.any()
    if case == "tie":  # ten anchors per ground truth, and a lower-index claim wins every contested one
        assert 10 <= fg.sum() <= 20 and set(np.unique(labels[fg])) <= {1, 0}


def test_compute_loss_v8_and_its_gradient_match_jax(jax_results, hyp):
    """Padded, zero-width and zero-height target rows included: the total
    and components within 1e-5 relative, the gradient with respect to the
    maps within 1e-4 of its largest element (it flows through the
    assigner's scores, as in JAX)."""
    (jtotal, jcomps), jgrads = jax_results["loss"]
    tp = [torch.from_numpy(p).requires_grad_() for p in v8_preds()]
    total, comps = pv8.ComputeLossV8(Meta, hyp)(tp, torch.from_numpy(targets_batch()))
    grads = torch.autograd.grad(total, tp)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    np.testing.assert_allclose(comps.numpy(), np.asarray(jcomps), rtol=1e-5)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=1e-4 * np.abs(jg).max())


def test_compute_loss_takes_iaux_detects_aux_maps_at_a_quarter(jax_results, hyp):
    """ComputeLoss on IAuxDetect's 2 * nl train-mode maps: the lead maps'
    loss plus 0.25 of the aux maps', its components the lead's; value and
    gradient as JAX's."""
    meta = jax_results["aux_meta"]
    (jtotal, jcomps), jgrads = jax_results["aux"]
    tp = [torch.from_numpy(np.array(p)).requires_grad_() for p in jax_results["aux_preds"]]
    loss = ComputeLoss(meta, hyp)
    total, comps = loss(tp, torch.from_numpy(targets_batch()))
    grads = torch.autograd.grad(total, tp)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    np.testing.assert_allclose(comps.numpy(), np.asarray(jcomps), rtol=1e-5, atol=1e-8)
    lead, lead_comps = loss(tp[:meta.nl], torch.from_numpy(targets_batch()))
    torch.testing.assert_close(comps, lead_comps)
    np.testing.assert_allclose(total.item(), lead.item() + 0.25 * loss(tp[meta.nl:], torch.from_numpy(
        targets_batch()))[0].item(), rtol=1e-6)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=1e-4 * np.abs(jg).max())


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------


def test_detect_v8_train_step_matches_make_train_step(jax_results, hyp):
    """One step of the DetectV8 graph (`lively` random variables) through
    ComputeLossV8 in both packages: the loss and its components within
    1e-5, the parameter updates within 2% of each leaf's largest update
    and the BatchNorm statistics within 1e-5 (test_torch_port_train.py's
    limits)."""
    state, metrics = jax_results["step8"]
    variables = jax_results["variables8"]
    model, meta = build_model(jax_results["cfg8"], device="cpu")
    assert load_jax_variables(model, variables) == ([], [])
    opt = optim.make_optimizer(hyp, nb=NB, epochs=EPOCHS, batch_size=B)
    pstate = create_train_state(model, opt)
    got = {k: v.item() for k, v in make_train_step(pv8.ComputeLossV8(meta, hyp), opt)(
        pstate, step_images(), targets_batch()).items()}
    for k in ("loss", "lbox", "lobj", "lcls"):
        np.testing.assert_allclose(got[k], float(metrics[k]), rtol=1e-5, err_msg=k)
    assert got["grads_finite"] and bool(metrics["grads_finite"])
    after = export_jax_variables(model)
    assert_updates_close(flat(variables["params"]), flat(after["params"]), flat(state.params))
    assert_stats_close(flat(after["batch_stats"]), flat(state.batch_stats))


@pytest.mark.parametrize("name", DETECTION)
def test_zoo_config_trains_as_jax(jax_results, hyp, name):
    """One train-mode forward, ComputeLoss (hyp.visdrone) and the gradient
    of every parameter of the small config (width 0.25, depth 0.33, 64 px):
    the loss within 1e-5 relative, its components too, each gradient leaf
    within 1e-4 of its largest element plus 1e-6 of the largest gradient
    (test_torch_port_family.py's limits), the moved BatchNorm statistics
    within 1e-5. yolov3-tiny has two levels: the level balance is
    [4.0, 1.0], as JAX's table gives it."""
    (jl, (jcomps, jstats)), jgrads = jax_results[name]
    variables = jax_results["zoo"][name]
    model, meta = build_model(small_cfg(name), nc=NC, device="cpu")
    assert load_jax_variables(model, variables) == ([], [])
    model.train()
    names, params = zip(*model.named_parameters())
    loss, comps = ComputeLoss(meta, hyp)(model(_nchw(step_images())), torch.from_numpy(targets_batch()))
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(comps.numpy(), np.asarray(jcomps), rtol=1e-5)
    got, want = flat(export_param_tree(model, list(names), list(grads))), flat(jgrads)
    assert sorted(got) == sorted(want) and len(want) == len(names)
    top = max(np.abs(v).max() for v in want.values())
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= 1e-4 * np.abs(w).max() + 1e-6 * top, (k, np.abs(got[k] - w).max())
    stats = flat(export_jax_variables(model)["batch_stats"])
    for k, w in flat(jstats).items():
        np.testing.assert_allclose(stats[k], w, rtol=1e-5, atol=1e-6, err_msg=k)
    assert meta.nl == (2 if name == "hub/yolov3-tiny" else 3)


# ---------------------------------------------------------------------------
# train.py's dispatch
# ---------------------------------------------------------------------------


def _train_files(tmp_path, name: str):
    images = write_set(tmp_path / "ds", 4)
    data = tmp_path / "data.yaml"
    data.write_text(yaml.safe_dump({"path": str(tmp_path / "ds"), "train": str(images), "val": str(images),
                                    "nc": NC, "names": ["a", "b", "c"]}))
    cfg = tmp_path / f"{name}.yaml"
    cfg.write_text(yaml.safe_dump(head_cfg(name)))
    return dict(cfg=str(cfg), data=str(data), device="cpu", no_bf16=True, workers=1, max_labels=16,
                project=str(tmp_path / "runs"), name="t", noautoanchor=True)


def test_train_run_of_a_detect_v8_graph_trains_through_the_v8_loss(tmp_path, monkeypatch):
    """train.run on the DetectV8 graph: every step through ComputeLossV8
    (its components logged as box, obj (DFL), cls), finite, and the val of
    the EMA weights through decode_v8."""
    calls = []
    real = pv8.ComputeLossV8.__call__

    def spy(self, preds, targets):
        calls.append(len(preds))
        return real(self, preds, targets)

    monkeypatch.setattr(pv8.ComputeLossV8, "__call__", spy)
    train.run(epochs=1, batch_size=2, imgsz=IMGSZ, **_train_files(tmp_path, "DetectV8"))
    log = [json.loads(line) for line in (tmp_path / "runs" / "t" / "train_log.jsonl").read_text().splitlines()]
    assert calls and set(calls) == {3} and log[0]["opt_step"] == 2
    assert all(np.isfinite(v) for row in log[0]["logged_losses"] for v in row[1:])


@pytest.mark.parametrize("name", ["Segment", "RTDETRDecoder"])
def test_train_refuses_the_heads_without_a_loss(tmp_path, name):
    """The JAX package ships no loss for Segment or RTDETRDecoder: the port
    refuses them before any data is read, saying so."""
    with pytest.raises(NotImplementedError, match="no training loss"):
        train.run(epochs=1, batch_size=2, imgsz=IMGSZ, **_train_files(tmp_path, name))
