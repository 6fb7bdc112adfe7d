"""yolosomi_tpu_torch's distillation and hyperparameter evolution against
the JAX package (engine/distill.py, engine/evolve.py), on the CPU.

Sizes: the teacher is the flagship at width 0.25 / depth 0.33 (P2-P5), the
student yolo-somi-t-p3 at the same multiples (P3-P5, so the level map
skips the teacher's stride-4 plane), 64 px, batch 2, nc 3, f32. One JAX
program per hint setting, each a whole distilled train step, compiled on
threads for the module.

Tolerances, stated where they are used:
- mutate's hyps and log_generation's file: bitwise (the same draws);
- the distillation terms on random maps: values 1e-5 relative, gradients
  1e-4 of each tensor's largest element (f32 sums in other orders);
- the distilled train step: the loss 1e-5 relative, and the momentum
  buffers after one step from zero (the step's gradients plus the weight
  decay) within 2% of each leaf's largest element plus 1e-6 (the bound
  tests/test_torch_port_train.py states for a step's buffers);
- the head-input maps of a features=True forward: 1e-4 of their largest
  element.
"""

import random
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from tests._torch_port_common import (IMGSZ, NC, DEPTH, WIDTH, few_threads, jax_flagship,  # noqa: F401
                                      jax_random_model, small_flagship_cfg)
from yolosomi_tpu import losses as jax_losses
from yolosomi_tpu.engine import distill as jax_distill
from yolosomi_tpu.engine import evolve as jax_evolve
from yolosomi_tpu.engine import optim as jax_optim
from yolosomi_tpu.engine import trainer as jax_trainer
from yolosomi_tpu.models.yolo import build_model as jax_build_model
from yolosomi_tpu_torch import losses, train
from yolosomi_tpu_torch.engine import distill, evolve, optim
from yolosomi_tpu_torch.engine.trainer import create_train_state, make_train_step
from yolosomi_tpu_torch.models.yolo import build_model
from yolosomi_tpu_torch.utils.config import find_config, load_hyp, load_model_cfg
from yolosomi_tpu_torch.utils.weights import _leaves, export_param_tree, load_jax_variables

B = 2
HINTS = (0.0, 0.5)
SEED = 0


def flat(tree) -> dict:
    return {"/".join(p): np.asarray(v) for p, v in _leaves(tree)}


@pytest.fixture(scope="module")
def hyp():
    return load_hyp(find_config("hyp.visdrone", "hyps"))


# ---------------------------------------------------------------------------
# evolve
# ---------------------------------------------------------------------------


def write_rows(path, n: int) -> None:
    """n generations of JAX's log_generation: hyps and fitness from numpy seed n."""
    base = load_hyp(find_config("hyp.visdrone", "hyps"))
    rng = np.random.default_rng(n)
    for _ in range(n):
        hyp = {k: v * float(1 + 0.2 * rng.standard_normal()) for k, v in base.items()}
        jax_evolve.log_generation(path, hyp, float(rng.random()))


@pytest.mark.parametrize("rows", [0, 1, 7], ids=["no_csv", "1_row", "7_rows"])
def test_mutate_draws_the_jax_hyps(rows, hyp, tmp_path):
    """With Python's random and numpy's global generator seeded alike, the
    same dict: from hyp.visdrone (no evolve.csv), from the one row's
    parent, and from a fitness-weighted pick of the top 5 of 7 rows."""
    csv = tmp_path / "evolve.csv"
    write_rows(csv, rows)
    assert evolve.META == jax_evolve.META
    random.seed(3)
    np.random.seed(3)
    want = jax_evolve.mutate(hyp, csv)
    random.seed(3)
    np.random.seed(3)
    got = evolve.mutate(hyp, csv)
    assert got == want and got != hyp
    assert all(lo <= got[k] <= hi for k, (_, lo, hi) in evolve.META.items() if k in got)


def test_log_generation_writes_the_jax_bytes(hyp, tmp_path):
    for i, fi in enumerate((0.5, 0.123456789, 1e-7)):
        h = {k: v * (1 + 0.1 * i) for k, v in hyp.items()}
        jax_evolve.log_generation(tmp_path / "jax.csv", h, fi)
        evolve.log_generation(tmp_path / "port.csv", h, fi)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


# ---------------------------------------------------------------------------
# the distillation terms
# ---------------------------------------------------------------------------


def level_maps(strides, na: int, no: int, c, rng):
    """Raw maps (B, n, n, na, no) and NHWC feature maps (B, n, n, c) per stride."""
    preds = [(rng.standard_normal((B, IMGSZ // s, IMGSZ // s, na, no)) * 1.5).astype(np.float32) for s in strides]
    feats = [rng.standard_normal((B, IMGSZ // s, IMGSZ // s, ci)).astype(np.float32) for s, ci in zip(strides, c)]
    return preds, feats


@pytest.mark.parametrize("mapped", [False, True], ids=["same_levels", "p2p5_teacher_p3p5_student"])
def test_distillation_terms_and_their_gradients_match_jax(mapped):
    """wrap_loss_with_distillation with a zero detection loss and a teacher
    that returns fixed maps: distill_loss plus hint_loss (alpha 0.7, hint
    0.5), scaled by the batch, with each model's own anchors, and with the
    level map of a P2-P5 teacher and a P3-P5 student as in
    tests/test_distill.py:60. Gradients with respect to the student's
    maps, its head-input maps and the adapters."""
    rng = np.random.default_rng(4)
    na, no = 3, NC + 5
    s_strides, s_c = (8, 16, 32), (16, 24, 32)
    t_strides, t_c = ((4, 8, 16, 32), (8, 12, 20, 40)) if mapped else (s_strides, (12, 20, 40))
    level_map = tuple(t_strides.index(s) for s in s_strides)
    s_anchors = (rng.uniform(4, 60, (3, na, 2))).astype(np.float32)
    t_anchors = (rng.uniform(4, 60, (len(t_strides), na, 2))).astype(np.float32)
    sp, sf = level_maps(s_strides, na, no, s_c, rng)
    tp, tf = level_maps(t_strides, na, no, t_c, rng)
    tp = [p * 2.0 for p in tp]  # a confident teacher: the box and hint masks are not empty
    adapters = [(rng.standard_normal((cs, t_c[j])) / np.sqrt(cs)).astype(np.float32)
                for cs, j in zip(s_c, level_map)]
    meta = SimpleNamespace(anchors_px=s_anchors, strides=s_strides)
    t_px = t_anchors[list(level_map)]

    def jax_loss(p, f, a):
        fn = jax_distill.wrap_loss_with_distillation(
            lambda preds, targets: (jnp.zeros(()), jnp.zeros(3)), lambda aux, im: (tp, tf), meta, alpha=0.7,
            teacher_anchors_px=t_px, level_map=level_map if mapped else None, hint=0.5)
        params = {f"kd_adapter_{i}": {"kernel": ai} for i, ai in enumerate(a)}
        return fn(p, None, images=jnp.zeros(1), aux={}, feats=f, params=params)[0]

    want, jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(
        [jnp.asarray(p) for p in sp], [jnp.asarray(f) for f in sf], [jnp.asarray(a) for a in adapters])
    want_kd = jax_distill.distill_loss(sp, [tp[j] for j in level_map], s_anchors, s_strides, teacher_anchors_px=t_px)
    want_hint = jax_distill.hint_loss(sf, [tf[j] for j in level_map], adapters, [tp[j] for j in level_map])

    student = nn.Module()
    for i, a in enumerate(adapters):
        lin = nn.Linear(*a.shape, bias=False)
        lin.weight.data = torch.from_numpy(a.T.copy())
        setattr(student, f"kd_adapter_{i}", lin)
    p = [torch.from_numpy(x).requires_grad_() for x in sp]
    f = [torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_() for x in sf]  # the port's NCHW maps
    t_nchw = [torch.from_numpy(x).permute(0, 3, 1, 2) for x in tf]
    fn = distill.wrap_loss_with_distillation(
        lambda preds, targets: (torch.zeros(()), torch.zeros(3)), lambda aux, im: ([torch.from_numpy(x) for x in tp],
                                                                                   t_nchw),
        meta, alpha=0.7, teacher_anchors_px=t_px, level_map=level_map if mapped else None, hint=0.5)
    got = fn(p, None, images=torch.zeros(1), aux=object(), feats=f, params=student)[0]
    ws = [getattr(student, f"kd_adapter_{i}").weight for i in range(len(adapters))]
    grads = torch.autograd.grad(got, p + f + ws)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    got_kd = distill.distill_loss([torch.from_numpy(x) for x in sp], [torch.from_numpy(tp[j]) for j in level_map],
                                  s_anchors, s_strides, teacher_anchors_px=t_px)
    got_hint = distill.hint_loss([torch.from_numpy(x) for x in sf], [torch.from_numpy(tf[j]) for j in level_map],
                                 [torch.from_numpy(a) for a in adapters], [torch.from_numpy(tp[j]) for j in level_map])
    np.testing.assert_allclose(got_kd.item(), float(want_kd), rtol=1e-5)
    np.testing.assert_allclose(got_hint.item(), float(want_hint), rtol=1e-5)
    assert float(want_hint) > 0 and float(want_kd) > 0
    n = len(sp)
    pairs = (list(zip(grads[:n], jgrads[0])) + [(g.permute(0, 2, 3, 1), jg) for g, jg in zip(grads[n:2 * n], jgrads[1])]
             + [(g.t(), jg) for g, jg in zip(grads[2 * n:], jgrads[2])])
    for g, jg in pairs:
        jg = np.asarray(jg)
        assert np.abs(jg).max() > 0
        np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=1e-4 * np.abs(jg).max())


def test_a_call_without_images_is_the_detection_loss():
    """The per-epoch val loss calls the wrapped loss without pixels: the
    plain detection loss, the teacher not run (engine/distill.py:153-156)."""
    def teacher(aux, images):
        raise AssertionError("the teacher ran")

    base = lambda preds, targets: (torch.tensor(2.5), torch.ones(3))  # noqa: E731
    fn = distill.wrap_loss_with_distillation(base, teacher, SimpleNamespace(anchors_px=None, strides=None), hint=0.5)
    total, comps = fn([torch.zeros(1)], None)
    assert total.item() == 2.5 and fn.needs_images and fn.needs_aux and fn.needs_features


# ---------------------------------------------------------------------------
# one distilled train step, flagship teacher -> yolo-somi-t-p3 student
# ---------------------------------------------------------------------------


def student_cfg() -> dict:
    cfg = dict(load_model_cfg(find_config("yolo-somi-t-p3")))
    cfg["width_multiple"], cfg["depth_multiple"] = WIDTH, DEPTH
    return cfg


def targets_batch() -> np.ndarray:
    t = np.full((B, 8, 5), -1.0, np.float32)
    t[..., 1:] = 0.0
    t[0, :3] = [[0, .3, .4, .2, .3], [1, .6, .6, .1, .1], [2, .5, .5, .5, .4]]
    t[1, :2] = [[1, .2, .7, .15, .2], [0, .8, .3, .3, .25]]
    return t


def images() -> np.ndarray:
    return np.random.default_rng(0).integers(0, 256, (B, IMGSZ, IMGSZ, 3), dtype=np.uint8).astype(np.float32) / 255


def jax_adapters(s_model, s_vars, t_model, t_vars, s_meta, level_map) -> dict:
    """The JAX CLI's adapters (train.py:283-303): shapes from a
    max(stride) * 4 px forward of each model, drawn from PRNGKey(seed + 7)."""
    sz = int(max(s_meta.strides)) * 4
    dummy = jnp.zeros((1, sz, sz, 3), jnp.float32)
    s_shapes = jax.eval_shape(lambda v, x: s_model.apply(v, x, train=False, features=True), s_vars, dummy)[1]
    t_shapes = jax.eval_shape(lambda v, x: t_model.apply(v, x, train=False, features=True), t_vars, dummy)[1]
    t_shapes = [t_shapes[j] for j in level_map]
    rng_a = jax.random.PRNGKey(SEED + 7)
    out = {}
    for i, (ss, ts) in enumerate(zip(s_shapes, t_shapes)):
        cs, ct = int(ss.shape[-1]), int(ts.shape[-1])
        rng_a, k = jax.random.split(rng_a)
        kernel = jax.random.normal(k, (cs, ct), jnp.float32) * (1.0 / np.sqrt(cs))
        out[f"kd_adapter_{i}"] = {"kernel": np.asarray(kernel)}
    return out


@pytest.fixture(scope="module")
def jax_steps(hyp):
    """The JAX package's distilled train step with the hint off and on,
    each compiled on a thread of its own, and its state after one step."""
    t_model, t_meta, t_vars = jax_flagship(small_flagship_cfg())
    s_model, s_meta, s_vars = jax_random_model(student_cfg(), seed=1)
    t_strides = [int(s) for s in t_meta.strides]
    level_map = tuple(t_strides.index(int(s)) for s in s_meta.strides)
    assert level_map == (1, 2, 3)
    adapters = jax_adapters(s_model, s_vars, t_model, t_vars, s_meta, level_map)
    x, t = jnp.asarray(images()), jnp.asarray(targets_batch())
    t_dev = jax.tree_util.tree_map(jnp.asarray, t_vars)
    runs = {}
    for hint in HINTS:
        variables = dict(s_vars, params=dict(s_vars["params"], **(adapters if hint else {})))
        opt = jax_optim.make_optimizer(hyp, nb=4, epochs=3, batch_size=B)
        state = jax_trainer.create_train_state(jax.tree_util.tree_map(jnp.asarray, variables), opt)
        loss_fn = jax_distill.wrap_loss_with_distillation(
            jax_losses.ComputeLoss(s_meta, hyp),
            lambda v, im, h=hint: t_model.apply(v, im, train=False, features=h > 0),
            s_meta, alpha=1.0, teacher_anchors_px=np.asarray(t_meta.anchors_px)[list(level_map)], level_map=level_map,
            hint=hint)
        runs[hint] = dict(variables=variables, state=state,
                          lowered=jax_trainer.make_train_step(s_model, loss_fn, opt).lower(state, x, t, t_dev))
    with ThreadPoolExecutor(len(runs)) as pool:
        compiled = {h: pool.submit(r["lowered"].compile, {"xla_backend_optimization_level": 0})
                    for h, r in runs.items()}
        for h, r in runs.items():
            state, metrics = compiled[h].result()(r["state"], x, t, t_dev)
            r.update(after=jax.device_get(state), metrics=jax.device_get(metrics))
    return dict(runs=runs, t_vars=t_vars, level_map=level_map)


def port_teacher(t_vars):
    model, meta = build_model(small_flagship_cfg(), nc=NC, device="cpu")
    unmatched, unused = load_jax_variables(model, t_vars)
    assert not unmatched and not unused
    return model.requires_grad_(False), meta


@pytest.mark.parametrize("hint", HINTS, ids=["outputs", "outputs_and_hint"])
def test_distilled_train_step_matches_make_train_step(jax_steps, hyp, hint):
    """One step of the yolo-somi-t-p3 student distilled from the flagship,
    JAX's adapters carried across through the weight bridge: the loss and
    its components, and every momentum buffer after the step (the
    gradients of the student and of the adapters). The teacher's
    parameters and BatchNorm statistics are the same bits afterwards."""
    run = jax_steps["runs"][hint]
    teacher, t_meta = port_teacher(jax_steps["t_vars"])
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    model, meta = build_model(student_cfg(), nc=NC, device="cpu")
    level_map = jax_steps["level_map"]
    if hint:
        assert distill.plant_adapters(model, meta, t_meta, level_map, SEED) == \
            [tuple(run["variables"]["params"][f"kd_adapter_{i}"]["kernel"].shape) for i in range(meta.nl)]
    unmatched, unused = load_jax_variables(model, run["variables"])
    assert not unmatched and not unused
    opt = optim.make_optimizer(hyp, nb=4, epochs=3, batch_size=B)
    state = create_train_state(model, opt)

    def teacher_apply(t, im):
        with torch.no_grad():
            return t(im, features=hint > 0)

    loss_fn = distill.wrap_loss_with_distillation(losses.ComputeLoss(meta, hyp), teacher_apply, meta, alpha=1.0,
                                                  teacher_anchors_px=t_meta.anchors_px[list(level_map)],
                                                  level_map=level_map, hint=hint)
    got = {k: v.item() for k, v in make_train_step(loss_fn, opt)(state, images(), targets_batch(), aux=teacher).items()}
    for k in ("loss", "lbox", "lobj", "lcls"):
        np.testing.assert_allclose(got[k], float(run["metrics"][k]), rtol=1e-5, err_msg=k)
    want = flat(run["after"].opt_state.momentum_buf)
    mom = flat(export_param_tree(model, state.names, state.opt_state.momentum_buf))
    assert mom.keys() == want.keys() and any(k.startswith("kd_adapter_") for k in want) == bool(hint)
    for k in want:
        assert np.abs(mom[k] - want[k]).max() <= 0.02 * np.abs(want[k]).max() + 1e-6, k
    if hint:
        assert all(np.abs(want[f"kd_adapter_{i}/kernel"]).max() > 0 for i in range(meta.nl))
    assert all(torch.equal(v, before[k]) for k, v in teacher.state_dict().items())


def test_features_forward_returns_the_jax_head_inputs(jax_steps):
    """features=True: the head's per-level input maps in head_from order
    (NCHW in the port, NHWC in JAX), the maps unchanged beside them."""
    t_vars = jax_steps["t_vars"]
    model, _ = port_teacher(t_vars)
    t_model, _ = jax_build_model(small_flagship_cfg(), nc=NC)
    x = images()
    want_preds, want_feats = t_model.apply(t_vars, jnp.asarray(x), train=False, features=True)
    with torch.no_grad():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        preds, feats = model(xt, features=True)
        plain = model(xt)
    assert len(feats) == len(want_feats) == 4
    for f, jf in zip(feats, want_feats):
        jf = np.asarray(jf)
        np.testing.assert_allclose(f.permute(0, 2, 3, 1).numpy(), jf, rtol=0, atol=1e-4 * np.abs(jf).max())
    for p, q, jp in zip(preds, plain, want_preds):
        assert torch.equal(p, q)
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=0, atol=1e-4 * np.abs(np.asarray(jp)).max())


def test_train_run_distills_and_evolves_on_the_cpu(tmp_path):
    """train.run with --teacher --teacher-cfg --distill --distill-hint (a
    flagship teacher from a weights file, the yolo-somi-t-p3 student),
    then --evolve 2: the adapters in last.ckpt, evolve.csv with 2 rows of
    hyps within META's bounds, the runs named <name>_gen<i>."""
    import cv2
    import yaml

    from yolosomi_tpu_torch.engine.checkpoint import load_checkpoint, save_variables
    from yolosomi_tpu_torch.utils.weights import export_jax_variables

    rng = np.random.default_rng(0)
    (tmp_path / "ds" / "images").mkdir(parents=True)
    (tmp_path / "ds" / "labels").mkdir()
    for i in range(4):
        cv2.imwrite(str(tmp_path / "ds" / "images" / f"{i}.jpg"), rng.integers(0, 256, (48, 64, 3), np.uint8))
        (tmp_path / "ds" / "labels" / f"{i}.txt").write_text(f"{i % NC} 0.5 0.5 0.4 0.3\n")
    data = tmp_path / "data.yaml"
    data.write_text(yaml.safe_dump({"path": str(tmp_path / "ds"), "train": "images", "val": "images", "nc": NC,
                                    "names": [str(i) for i in range(NC)]}))
    (tmp_path / "teacher.yaml").write_text(yaml.safe_dump(small_flagship_cfg()))
    (tmp_path / "student.yaml").write_text(yaml.safe_dump(student_cfg()))
    teacher, t_meta = build_model(small_flagship_cfg(), nc=NC, device="cpu", seed=3)
    save_variables(tmp_path / "teacher.msgpack", export_jax_variables(teacher), anchors=t_meta.anchors_px)
    kw = dict(data=str(data), batch_size=2, imgsz=IMGSZ, device="cpu", no_bf16=True, noautoanchor=True,
              max_labels=8, workers=1, project=str(tmp_path / "runs"), epochs=1)
    fi = train.run(cfg=str(tmp_path / "student.yaml"), name="kd", teacher=str(tmp_path / "teacher.msgpack"),
                   teacher_cfg=str(tmp_path / "teacher.yaml"), distill=0.5, distill_hint=0.5, **kw)
    ckpt = load_checkpoint(tmp_path / "runs" / "kd" / "weights" / "last.ckpt")
    assert np.isfinite(fi)
    for c in ("params", "ema_params"):
        assert [ckpt[c][f"kd_adapter_{i}"]["kernel"].shape for i in range(3)] == [(64, 64), (128, 128), (256, 256)]
    best = train.run(cfg=str(tmp_path / "teacher.yaml"), name="evo", evolve=2, **kw)
    rows = (tmp_path / "runs" / "evolve" / "evolve.csv").read_text().splitlines()
    assert len(rows) == 3 and rows[0].startswith("fitness,lr0,") and best >= 0
    assert all((tmp_path / "runs" / f"evo_gen{g}" / "weights" / "last.ckpt").exists() for g in range(2))
    names = rows[0].split(",")[1:]
    for row in rows[1:]:
        vals = [float(v) for v in row.split(",")[1:]]
        assert all(evolve.META[k][1] <= v <= evolve.META[k][2] for k, v in zip(names, vals))
