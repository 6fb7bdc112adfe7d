"""The rest of the JAX training recipe in yolosomi_tpu_torch, against the
JAX package on the CPU: --image-weights, --rect, --quad, --cache ram, the
--cache device plans, slab and mosaic, the device preprocess, the
multi-scale resize, the repulsion loss, --remat, and train.run with them.

Sizes: the flagship at width 0.25 / depth 0.33, 64 px, f32; the remat
step on the flagship cut to rows 0-4 under a two-level head (remat_cfg),
the module's one JAX train program, compiled on a thread while the JAX
loss compiles beside it.

Tolerances, stated where they are used:
- exact: the class and image weights and the weighted sampling;
- bitwise: rect, quad and cached batches, the plans and the slab (the
  same Python and numpy draws in the same order, the same cv2 calls);
- 1e-4 on the 0-255 scale: the device mosaic (f32 bilinear taps);
- 1e-6: normalize, HSV jitter, flips and the affine warp, given the same
  parameters; 2e-6: the multi-scale resize;
- 1e-5 relative: the loss with the repulsion term, which adds no gradient;
- remat: parameters, BatchNorm statistics and EMA within 1e-6 of the step
  without remat, and of JAX's remat step (statistics 1e-6 relative).
"""

import json
import logging
import random
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

import jax
import jax.numpy as jnp

from tests._torch_port_common import IMGSZ, NC, few_threads, jax_flagship, small_flagship_cfg  # noqa: F401
from tests.test_torch_port_train import B, batches, flat, port_model, targets_batch
from yolosomi_tpu import losses as jax_losses
from yolosomi_tpu.data import datasets as jax_datasets
from yolosomi_tpu.engine import optim as jax_optim
from yolosomi_tpu.engine import trainer as jax_trainer
from yolosomi_tpu.models.yolo import build_model as jax_build_model
from yolosomi_tpu.ops import mosaic_device as jax_mosaic
from yolosomi_tpu.ops import preprocess as jax_pre
from yolosomi_tpu.utils import general as jax_general
from yolosomi_tpu_torch import losses, train
from yolosomi_tpu_torch.data import datasets
from yolosomi_tpu_torch.engine import optim, trainer
from yolosomi_tpu_torch.engine.trainer import create_train_state, make_train_step
from yolosomi_tpu_torch.ops import mosaic_device, preprocess
from yolosomi_tpu_torch.utils import general
from yolosomi_tpu_torch.utils.config import find_config, load_hyp
from yolosomi_tpu_torch.utils.weights import export_jax_variables

# (h, w) of the set's images: wide, tall and square, so rect batches differ
SIZES = ((32, 64), (24, 64), (32, 64), (30, 64), (64, 64), (48, 64), (64, 48), (64, 40), (64, 32), (40, 64))
REMAT = 3  # segments of the remat step


def remat_cfg() -> dict:
    """The small flagship's rows 0-4 (Conv, ODConv, C2f-CBAM, Conv,
    C2f-CBAM) under a DecoupledDetect at strides 4 and 8: cut into 3
    segments at rows 2 and 4, row 2's output crosses a boundary to the
    head. A third of the cut flagship's JAX compile time."""
    cfg = small_flagship_cfg()
    cfg["backbone"] = cfg["backbone"][:5]
    cfg["anchors"] = [[3, 4, 4, 8, 7, 6, 7, 11], [13, 8, 10, 17, 18, 12, 17, 23]]
    cfg["head"] = [[[2, 4], 1, "DecoupledDetect", ["nc", "anchors"]]]
    return cfg


@pytest.fixture(scope="module")
def hyp():
    return load_hyp(find_config("hyp.visdrone", "hyps"))


def write_set(root: Path, seed: int = 0) -> Path:
    """JPEGs of SIZES with 0-5 labelled boxes each (classes 0-2)."""
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(SIZES):
        cv2.imwrite(str(root / "images" / f"{i}.jpg"), rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
        rows = [f"{rng.integers(0, NC)} {rng.uniform(.2, .8):.6f} {rng.uniform(.2, .8):.6f} "
                f"{rng.uniform(.05, .4):.6f} {rng.uniform(.05, .4):.6f}" for _ in range(rng.integers(0, 6))]
        (root / "labels" / f"{i}.txt").write_text("\n".join(rows))
    return root / "images"


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    return write_set(tmp_path_factory.mktemp("recipe") / "ds")


def both(make, seed: int = 3):
    """`make(module)` for the JAX package's datasets module and the port's,
    each after random.seed and np.random.seed of `seed`."""
    out = []
    for mod in (jax_datasets, datasets):
        random.seed(seed)
        np.random.seed(seed)
        out.append(make(mod))
    return out


def assert_batches_equal(want, got) -> None:
    assert len(got) == len(want) > 0
    for w, g in zip(want, got):
        if isinstance(w[0], dict):
            assert w[0].keys() == g[0].keys()
            for k in w[0]:
                np.testing.assert_array_equal(g[0][k], w[0][k], err_msg=k)
        else:
            np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2] == w[2] and len(g[3]) == len(w[3])


# ---------------------------------------------------------------------------
# the JAX programs
# ---------------------------------------------------------------------------


def rep_targets() -> np.ndarray:
    """(B, 16, 5): overlapping boxes of several classes, so that positives
    of one ground truth overlap others (both repulsion terms non-zero) and
    there are more than 256 candidates per image."""
    rng = np.random.default_rng(5)
    t = np.zeros((B, 16, 5), np.float32)
    t[..., 0] = rng.integers(0, NC, (B, 16))
    t[..., 1:3] = rng.uniform(0.3, 0.7, (B, 16, 2))
    t[..., 3:5] = rng.uniform(0.1, 0.35, (B, 16, 2))
    t[1, 12:] = [-1, 0, 0, 0, 0]
    return t


def seeded_preds(meta, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, IMGSZ // int(s), IMGSZ // int(s), meta.na, meta.nc + 5)) * 1.5).astype(np.float32)
            for s in meta.strides]


@pytest.fixture(scope="module")
def jax_programs(hyp):
    """The JAX remat step of remat_cfg and its state, and the loss with and
    without the repulsion term, each compiled on a thread as soon as it is
    lowered."""
    model, meta, variables = jax_flagship(remat_cfg())
    opt = jax_optim.make_optimizer(hyp, nb=4, epochs=3, batch_size=B)
    state = jax_trainer.create_train_state(jax.tree_util.tree_map(jnp.asarray, variables), opt)
    x, t = jnp.asarray(batches()[0]), jnp.asarray(targets_batch())
    _, lmeta = jax_build_model(small_flagship_cfg(), nc=NC)

    def rep_losses(preds, targets):
        plain, rep = jax_losses.ComputeLoss(lmeta, hyp), jax_losses.ComputeLoss(lmeta, hyp)
        rep.rep = True
        return plain(preds, targets)[0], rep(preds, targets)[0]

    lowerings = {
        "remat_step": lambda: jax_trainer.make_train_step(model, jax_losses.ComputeLoss(meta, hyp), opt,
                                                          remat_segments=REMAT).lower(state, x, t),
        "rep_losses": lambda: jax.jit(rep_losses).lower([jnp.asarray(p) for p in seeded_preds(lmeta)],
                                                        jnp.asarray(rep_targets())),
    }
    with ThreadPoolExecutor(len(lowerings)) as pool:
        futures = {k: pool.submit(lambda f=f: f().compile({"xla_backend_optimization_level": 0}))
                   for k, f in lowerings.items()}
        compiled = {k: f.result() for k, f in futures.items()}
    return dict(compiled, variables=variables, state=state, lmeta=lmeta)


# ---------------------------------------------------------------------------
# --image-weights
# ---------------------------------------------------------------------------


def test_class_and_image_weights_match_jax():
    """Labels with a class that never occurs and an image without labels:
    the same weights, exactly; and the JAX train loop's (1 - maps)^2 mix."""
    rng = np.random.default_rng(0)
    labels = [np.concatenate([rng.integers(0, 4, (n, 1)), rng.uniform(0, 1, (n, 4))], 1).astype(np.float32)
              for n in (3, 0, 7, 1, 5)]
    nc, maps = 6, rng.uniform(0, 1, 6)
    cw = general.labels_to_class_weights(labels, nc)
    np.testing.assert_array_equal(cw, jax_general.labels_to_class_weights(labels, nc))
    cw = cw * (1 - maps) ** 2 / nc
    got = general.labels_to_image_weights(labels, nc, cw)
    np.testing.assert_array_equal(got, jax_general.labels_to_image_weights(labels, nc, cw))
    np.testing.assert_array_equal(general.labels_to_image_weights(labels, nc),
                                  jax_general.labels_to_image_weights(labels, nc))
    assert got[1] == 0 and (got[[0, 2, 3, 4]] > 0).all()
    np.testing.assert_array_equal(general.labels_to_class_weights([], nc), np.ones(nc))


def test_weighted_sampling_draws_the_jax_images(images):
    """Two epochs drawn with replacement by image weights: the same images
    in the same order as the JAX loader's, and only weighted ones."""
    ds_pair = both(lambda mod: mod.DetectionDataset(str(images), img_size=IMGSZ, max_labels=16))
    w = general.labels_to_image_weights(ds_pair[1].labels, NC)

    def run(ds):
        loader = (jax_datasets if ds is ds_pair[0] else datasets).DataLoader(ds, 4, prefetch=0, workers=1)
        loader.sample_weights = w
        return [b for _ in range(2) for b in loader]

    want, got = run(ds_pair[0]), run(ds_pair[1])
    assert_batches_equal(want, got)
    drawn = {p for b in got for p in b[2]}
    assert drawn <= {f for f, wi in zip(ds_pair[1].img_files, w) if wi > 0}


# ---------------------------------------------------------------------------
# --rect, --quad, --cache ram
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("augment", [False, True], ids=["eval", "augment"])
def test_rect_batches_match_jax(images, hyp, augment):
    """Aspect-sorted files, batch_shapes (H != W) and the batches, the
    short last one (10 = 3 x 3 + 1 images) unpadded: bitwise."""
    def make(mod):
        ds = mod.DetectionDataset(str(images), img_size=IMGSZ, augment=augment, hyp=hyp, rect=True, batch_size=3,
                                  stride=32, pad=0.5 if not augment else 0.0, max_labels=16)
        return ds, [b for b in mod.DataLoader(ds, 3, prefetch=0, workers=1)]

    (jds, want), (pds, got) = both(make)
    assert pds.img_files == jds.img_files and pds.img_files != sorted(pds.img_files)
    np.testing.assert_array_equal(pds.batch_shapes, jds.batch_shapes)
    assert any(h != w for h, w in pds.batch_shapes)
    assert_batches_equal(want, got)
    assert [b[0].shape[0] for b in got] == [3, 3, 3, 1]
    assert all(b[0].shape[1:3] == tuple(s) for b, s in zip(got, pds.batch_shapes))


@pytest.mark.parametrize("augment", [False, True], ids=["eval", "augment"])
def test_quad_batches_match_jax(images, hyp, augment):
    """The quad collate with the loader's generator (upscale or 2 x 2 paste
    per group): images and targets bitwise over two shuffled epochs."""
    def make(mod):
        ds = mod.DetectionDataset(str(images), img_size=IMGSZ, augment=augment, hyp=hyp, max_labels=16)
        loader = mod.DataLoader(ds, 4, shuffle=True, prefetch=0, workers=1, quad=True)
        return [b for _ in range(2) for b in loader]

    want, got = both(make)
    assert_batches_equal(want, got)
    assert all(b[0].shape == (1, 2 * IMGSZ, 2 * IMGSZ, 3) and b[1].shape == (1, 64, 5) for b in got)


@pytest.mark.parametrize("augment", [False, True], ids=["eval", "augment"])
def test_ram_cache_batches_equal_uncached_and_jax(images, hyp, augment):
    """--cache ram: the cached dataset's batches are the uncached one's and
    the cached JAX dataset's, bitwise."""
    def make(mod, cache):
        random.seed(4)
        np.random.seed(4)
        ds = mod.DetectionDataset(str(images), img_size=IMGSZ, augment=augment, hyp=hyp, max_labels=16,
                                  cache_images=cache)
        return [b for b in mod.DataLoader(ds, 4, shuffle=True, prefetch=0, workers=1)]

    got = make(datasets, True)
    assert_batches_equal(make(datasets, False), got)
    assert_batches_equal(make(jax_datasets, True), got)


# ---------------------------------------------------------------------------
# --cache device: plans, slab, mosaic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mixup", [0.0, 1.0], ids=["mosaic", "mixup"])
def test_plans_match_jax(images, hyp, mixup):
    """plan_item's draws and label geometry and collate_plan_batch, over
    two shuffled epochs with mosaic at 0.5 (letterbox plans too): every
    plan array and the targets bitwise."""
    h = dict(hyp, mosaic=0.5, mixup=mixup)

    def make(mod):
        ds = mod.DetectionDataset(str(images), img_size=IMGSZ, augment=True, hyp=h, max_labels=16)
        return [b for _ in range(2) for b in mod.DataLoader(ds, 4, shuffle=True, prefetch=0, plan=True)]

    want, got = both(make)
    assert_batches_equal(want, got)
    mixw = np.concatenate([b[0]["mixw"] for b in got])
    assert (mixw < 1).any() if mixup else (mixw == 1).all()
    centers = np.concatenate([b[0]["center"][:, 0, 0] for b in got])
    assert (centers == 1e9).any() and (centers < 1e9).any()  # letterbox and mosaic plans


@pytest.fixture(scope="module")
def slab(images):
    ds = datasets.DetectionDataset(str(images), img_size=IMGSZ, augment=True)
    return mosaic_device.build_device_cache(ds)


def test_device_cache_slab_matches_jax(images, slab):
    want, want_hw = jax_mosaic.build_device_cache(jax_datasets.DetectionDataset(str(images), img_size=IMGSZ,
                                                                                 augment=True))
    got, got_hw = slab
    assert got.shape == (len(SIZES), IMGSZ, IMGSZ, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_hw, want_hw)
    assert (got[0, 32:] == 114).all()  # image 0 is 32 x 64: the rest of its square is the fill


@pytest.mark.parametrize("mixup", [0.0, 1.0], ids=["mosaic", "mixup"])
def test_device_mosaic_matches_jax(images, hyp, slab, mixup):
    """mosaic_mixup_batch from the same slab and plans (mosaic at 0.5, so
    letterbox plans too): within 1e-4 on the 0-255 scale. Without mixup
    the second composite is skipped, and the result is the first's."""
    h = dict(hyp, mosaic=0.5, mixup=mixup)
    random.seed(6)
    np.random.seed(6)
    ds = datasets.DetectionDataset(str(images), img_size=IMGSZ, augment=True, hyp=h, max_labels=16)
    plans = [b[0] for b in datasets.DataLoader(ds, 4, shuffle=True, prefetch=0, plan=True)]
    jfn = jax.jit(jax_mosaic.mosaic_mixup_batch, static_argnums=2)
    for plan in plans:
        want = np.asarray(jfn(jnp.asarray(slab[0]), {k: jnp.asarray(v) for k, v in plan.items()}, IMGSZ))
        got = mosaic_device.mosaic_mixup_batch(torch.from_numpy(slab[0]), plan, IMGSZ).numpy()
        assert got.shape == (4, IMGSZ, IMGSZ, 3)
        np.testing.assert_allclose(got * 255, want * 255, rtol=0, atol=1e-4)
        assert 0 <= got.min() and got.max() <= 1 and (got != 114 / 255).mean() > 0.3


# ---------------------------------------------------------------------------
# the device preprocess and the multi-scale resize
# ---------------------------------------------------------------------------


def _batch(seed: int = 0, shape=(3, 20, 24, 3)):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("fn", ["normalize", "hsv_jitter", "flips", "affine_batch", "affine_batch_rotated"])
def test_preprocess_functions_match_jax(fn):
    """Each function on the same batch and the same explicit parameters
    (f32): uint8 and float normalize; HSV gains around 1 (grey pixels and
    saturated ones included); per-image flips of images and targets
    (padding rows keep their coordinates) bitwise; the inverse affine warp
    partly off the image. Within 1e-6, but for the rotated warp: XLA
    computes the source coordinates as a GEMM that rounds them in another
    order than any elementwise form (an ulp of a coordinate below 32, 3.8e-6,
    off in 0.5% of them), so that warp is held to 4e-6; the scaled and
    sheared warp with dyadic entries has exact coordinates and is held to
    1e-6."""
    rng = np.random.default_rng(1)
    x = _batch()
    x[0, :4] = 0.5  # grey: zero saturation
    x[1, :2, :, 0] = 1.0
    if fn == "normalize":
        u8 = rng.integers(0, 256, x.shape, dtype=np.uint8)
        for a in (u8, x):
            np.testing.assert_allclose(preprocess.normalize(torch.from_numpy(a)).numpy(),
                                       np.asarray(jax_pre.normalize(jnp.asarray(a))), rtol=0, atol=1e-6)
    elif fn == "hsv_jitter":
        gains = (1 + rng.uniform(-1, 1, (3, 3)) * [0.4, 0.3, 0.5]).astype(np.float32)
        want = np.asarray(jax.jit(jax_pre.hsv_jitter)(jnp.asarray(x), jnp.asarray(gains)))
        got = preprocess.hsv_jitter(torch.from_numpy(x), torch.from_numpy(gains)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert np.abs(got - x).max() > 0.1
    elif fn == "flips":
        t = np.tile(targets_batch()[:1], (3, 1, 1))
        lr, ud = np.array([True, False, True]), np.array([False, True, True])
        want = jax.jit(jax_pre.flips)(jnp.asarray(x), jnp.asarray(t), jnp.asarray(lr), jnp.asarray(ud))
        got = preprocess.flips(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(lr), torch.from_numpy(ud))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    else:
        if fn == "affine_batch":
            mats = np.array([[[1.25, 0.125, -3.5], [-0.25, 0.75, 2.0]], [[0.5, 0.0, 4.0], [0.0, 1.5, -6.25]],
                             [[1.0, -0.375, 1.0], [0.0625, 1.0, 0.5]]], np.float32)
        else:
            a = np.deg2rad(rng.uniform(-20, 20, 3))
            mats = np.stack([np.stack([np.cos(a) * 1.1, -np.sin(a) + 0.1, np.full(3, 3.0)], -1),
                             np.stack([np.sin(a), np.cos(a) * 0.9, np.full(3, -2.5)], -1)], 1).astype(np.float32)
        want = np.asarray(jax.jit(jax_pre.affine_batch, static_argnums=2)(jnp.asarray(x), jnp.asarray(mats), (18, 26)))
        got = preprocess.affine_batch(torch.from_numpy(x), torch.from_numpy(mats), (18, 26)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 if fn == "affine_batch" else 4e-6)
        assert (np.abs(got - 114 / 255) < 1e-6).any()  # taps off the image read the fill


def test_preprocess_train_batch_draws_from_its_generator():
    """The same generator seed gives the same batch; the gains and flips
    follow the hyp (all flips with fliplr = flipud = 1, HSV unchanged with
    zero gains); a uint8 batch is normalized first."""
    u8 = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 8, 10, 3), dtype=np.uint8))
    t = torch.from_numpy(targets_batch())
    hyp = dict(hsv_h=0.4, hsv_s=0.3, hsv_v=0.5, fliplr=0.5, flipud=0.5)
    a = preprocess.preprocess_train_batch(u8, t, torch.Generator().manual_seed(7), hyp)
    b = preprocess.preprocess_train_batch(u8, t, torch.Generator().manual_seed(7), hyp)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    flipped, ft = preprocess.preprocess_train_batch(u8, t, torch.Generator().manual_seed(7),
                                                    dict(fliplr=1.0, flipud=1.0))
    x = u8.float() / 255.0
    torch.testing.assert_close(flipped, x.flip(1).flip(2), rtol=0, atol=2e-6)  # HSV at gain 1 round-trips
    valid = t[..., 0] >= 0
    torch.testing.assert_close(ft[..., 1:3][valid], 1 - t[..., 1:3][valid])


def _state_on(dev: str = "cpu"):
    return SimpleNamespace(params=[torch.zeros(1, device=dev)], step=0)


@pytest.mark.parametrize("size", [40, 96], ids=["down", "up"])
def test_multi_scale_resize_matches_jax(size):
    """The step's resize of a 64 px uint8 batch to `size` against
    jax.image.resize's bilinear, within 2e-6. Downsampling needs
    antialiasing: without it torch's bilinear lies far off."""
    u8 = np.random.default_rng(3).integers(0, 256, (2, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    step = make_train_step(None, None, scale_to=size)
    x, _ = step.inputs(_state_on(), u8, targets_batch())
    assert x.shape == (2, 3, size, size) and x.is_contiguous(memory_format=torch.channels_last)
    want = np.asarray(jax.image.resize(jnp.asarray(u8, jnp.float32) / 255.0, (2, size, size, 3), "bilinear"))
    got = x.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    if size < IMGSZ:
        plain = F.interpolate(torch.from_numpy(u8).float().permute(0, 3, 1, 2) / 255.0, size=(size, size),
                              mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy()
        assert np.abs(plain - want).max() > 0.1
    same, _ = make_train_step(None, None, scale_to=IMGSZ).inputs(_state_on(), u8, targets_batch())
    assert torch.equal(same, torch.from_numpy(u8).permute(0, 3, 1, 2).float() / 255.0)  # no resize at its own size


# ---------------------------------------------------------------------------
# --rep
# ---------------------------------------------------------------------------


def test_repulsion_loss_matches_jax_and_adds_no_gradient(jax_programs, hyp):
    """The loss with and without the repulsion term at 16 overlapping
    target rows (more than 256 candidates an image): totals within 1e-5
    relative of JAX's, the term itself (their difference) too, and the
    gradient with respect to the maps unchanged by it, bitwise."""
    meta = jax_programs["lmeta"]
    preds, t = seeded_preds(meta), rep_targets()
    jplain, jrep = (float(v) for v in jax_programs["rep_losses"]([jnp.asarray(p) for p in preds], jnp.asarray(t)))
    totals, grads = [], []
    for rep in (False, True):
        fn = losses.ComputeLoss(meta, hyp)
        fn.rep = rep
        tp = [torch.from_numpy(p).requires_grad_() for p in preds]
        total, _ = fn(tp, torch.from_numpy(t))
        totals.append(total.item())
        grads.append(torch.autograd.grad(total, tp))
    np.testing.assert_allclose(totals, [jplain, jrep], rtol=1e-5)
    assert jrep - jplain > 1e-3
    np.testing.assert_allclose(totals[1] - totals[0], jrep - jplain, rtol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(*grads))


# ---------------------------------------------------------------------------
# --remat
# ---------------------------------------------------------------------------


def test_run_range_segments_compose_to_the_forward():
    """The graph run as row ranges (every cut of the remat step) gives the
    forward's maps, bitwise, in eval mode."""
    model, _ = port_model(small_flagship_cfg(), jax_flagship(small_flagship_cfg())[2])
    x = torch.from_numpy(batches()[0]).permute(0, 3, 1, 2)
    with torch.no_grad():
        want = model(x)
        n = len(model.model)
        for segs in (2, 5):
            cuts = sorted({int(round(n * k / segs)) for k in range(segs + 1)})
            y, saved = x, {}
            for lo, hi in zip(cuts[:-1], cuts[1:]):
                y, saved = model.run_range(y, saved, lo, hi)
            assert all(torch.equal(a, b) for a, b in zip(y, want))


def test_remat_step_matches_the_plain_step_and_jax(jax_programs, hyp):
    """One step of remat_cfg with remat 3 and without, from the same
    variables: parameters, BatchNorm statistics and EMA within 1e-6 (a
    recompute that moved the statistics again would put them ~3% away),
    loss equal; and against JAX's remat step: parameters and EMA within
    1e-6, statistics within 1e-6 relative, losses within 1e-5."""
    variables = jax_programs["variables"]
    x, t = batches()[0], targets_batch()
    runs = {}
    for segs in (0, REMAT):
        model, meta = port_model(remat_cfg(), variables)
        opt = optim.make_optimizer(hyp, nb=4, epochs=3, batch_size=B)
        state = create_train_state(model, opt)
        m = make_train_step(losses.ComputeLoss(meta, hyp), opt, remat_segments=segs)(state, x, t)
        runs[segs] = (m["loss"].item(), export_jax_variables(model), export_jax_variables(state.ema.ema))
    (l0, v0, e0), (l3, v3, e3) = runs[0], runs[REMAT]
    assert l0 == l3
    for got, want in ((v3, v0), (e3, e0)):
        for col in ("params", "batch_stats"):
            g, w = flat(got[col]), flat(want[col])
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-6, err_msg=k)
    before, after = flat(variables["batch_stats"]), flat(v3["batch_stats"])
    assert max(np.abs(after[k] - before[k]).max() for k in before) > 1e-3  # the statistics did move, once

    js, jm = jax_programs["remat_step"](jax_programs["state"], jnp.asarray(x), jnp.asarray(t))
    js = jax.device_get(js)
    np.testing.assert_allclose(l3, float(jm["loss"]), rtol=1e-5)
    for got, want in ((flat(v3["params"]), flat(js.params)), (flat(e3["params"]), flat(js.ema.variables["params"]))):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    for got, want in ((flat(v3["batch_stats"]), flat(js.batch_stats)),
                      (flat(e3["batch_stats"]), flat(js.ema.variables["batch_stats"]))):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# train.run with the recipe
# ---------------------------------------------------------------------------

RUNS = {
    "multi_scale_quad_image_weights_ram_rep_remat": dict(multi_scale=True, quad=True, image_weights=True,
                                                         cache="ram", rep=True, remat=2),
    "cache_device_multi_scale": dict(cache="device", multi_scale=True),
    "cache_device_rect": dict(cache="device", rect=True),
}


@pytest.mark.parametrize("case", list(RUNS))
def test_train_run_on_the_cpu_with_the_recipe(images, tmp_path, monkeypatch, case):
    """One epoch of 2 batches of 4 (quad: one 128 px image each), with the
    model's inputs recorded: multi-scale draws from {32, 64}; --cache
    device composites each batch from the slab and jitters it in the step;
    --cache device with --rect warns and loads rect batches on the host.
    Every logged loss finite, the weights written."""
    data = tmp_path / "data.yaml"
    data.write_text(yaml.safe_dump({"path": str(images.parent), "train": str(images), "val": str(images),
                                    "nc": NC, "names": ["a", "b", "c"]}))
    cfg = tmp_path / "somi-small.yaml"
    cfg.write_text(yaml.safe_dump(small_flagship_cfg()))
    seen = []
    inputs = trainer.TrainStep.inputs

    def spy(self, state, images_, targets):
        x, t = inputs(self, state, images_, targets)
        seen.append((tuple(x.shape), isinstance(images_, tuple), self.device_preprocess is not None,
                     self.remat_segments, self.loss_fn.rep))
        return x, t

    monkeypatch.setattr(trainer.TrainStep, "inputs", spy)
    warnings = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: warnings.append(record.getMessage())
    general.LOGGER.addHandler(handler)
    try:
        train.run(cfg=str(cfg), data=str(data), epochs=1, batch_size=4, imgsz=IMGSZ, device="cpu", no_bf16=True,
                  noautoanchor=True, workers=1, max_labels=16, project=str(tmp_path / "runs"), name="t", **RUNS[case])
    finally:
        general.LOGGER.removeHandler(handler)
    run = tmp_path / "runs" / "t"
    log = json.loads((run / "train_log.jsonl").read_text().splitlines()[0])
    assert log["steps"] == 2 and log["skipped_logged"] == 0
    assert all(np.isfinite(v) for row in log["logged_losses"] for v in row[1:])
    assert (run / "weights" / "last.msgpack").exists()
    assert len(seen) == 2
    shapes = {s[0] for s in seen}
    if case.startswith("multi_scale"):
        assert all(s[0] == 1 and s[2] == s[3] and s[2] in (32, 64) for s in shapes), shapes
        assert all(s[3:] == (2, True) and not s[1] for s in seen)
    elif case == "cache_device_multi_scale":
        assert all(s[1] and s[2] for s in seen) and all(s[2] == s[3] and s[2] in (32, 64) for s in shapes)
    else:
        assert any("does not support ['rect']" in w for w in warnings), warnings
        assert not any(s[1] or s[2] for s in seen) and any(s[2] != s[3] for s in shapes), shapes


def test_train_refuses_a_bad_cache_mode(tmp_path):
    opt = train.parse_opt(["--project", str(tmp_path), "--device", "cpu", "--cache", "disk"])
    with pytest.raises(ValueError, match="'ram' or 'device'"):
        train.train(load_hyp(find_config("hyp.visdrone", "hyps")), opt)
