"""yolosomi_tpu_torch's eval path against the JAX package's, on the CPU:
box and letterbox helpers, the val dataset and loader, multi-label
non_max_suppression, the mAP metrics and the COCO evaluator, the Runner's
eval call, and val.run as a whole on a self-labelled synthetic set.

The self-labelled set: with random weights mAP is about 0 on any labels
drawn independently of the model, and 0 == 0 proves nothing. So the
labels are the JAX Runner's own top 5 single-label detections per image
(conf > 0.25), mapped back to original-image normalized xywh. JAX's
val.run then scores high on them, and the port must reach the same numbers.
"""

import logging

import cv2
import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

import val as jax_val
from tests._torch_port_common import IMGSZ, NC, few_threads, jax_flagship, small_flagship_cfg  # noqa: F401
from yolosomi_tpu.data import augment as jax_augment
from yolosomi_tpu.data import datasets as jax_datasets
from yolosomi_tpu.engine import runner as jax_runner_mod
from yolosomi_tpu.models.heads import decode as jax_decode
from yolosomi_tpu.ops import nms as jax_nms
from yolosomi_tpu.utils import boxes as jax_boxes
from yolosomi_tpu.utils import cocoeval as jax_cocoeval
from yolosomi_tpu.utils import metrics as jax_metrics
from yolosomi_tpu_torch import val
from yolosomi_tpu_torch.data import augment, datasets
from yolosomi_tpu_torch.engine.runner import Runner
from yolosomi_tpu_torch.models.heads import decode
from yolosomi_tpu_torch.ops import nms
from yolosomi_tpu_torch.ops.nms import fused_postprocess
from yolosomi_tpu_torch.utils import boxes, cocoeval, metrics

EVAL_BATCH = 5  # 12 images: the last batch wraps 3
EVAL_SIZES = [(48, 64), (64, 48), (64, 64), (72, 96), (40, 52), (64, 37), (60, 80), (33, 64), (64, 64), (80, 60),
              (50, 64), (64, 50)]
EVAL_KW = dict(conf_thres=0.001, iou_thres=0.6, max_det=300, max_nms=30000, multi_label=True, exact=True)


def _write_image(path, rng, h, w):
    """Noise with a bright rectangle and a disc drawn by numpy masks."""
    im = (rng.integers(0, 80, (h, w, 3)) + rng.integers(0, 40)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
    im[y0:y0 + h // 3, x0:x0 + w // 3] = rng.integers(120, 256, 3)
    cy, cx, r = rng.integers(h // 4, 3 * h // 4), rng.integers(w // 4, 3 * w // 4), max(3, min(h, w) // 6)
    im[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.integers(120, 256, 3)
    assert cv2.imwrite(str(path), im)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _table(lines):
    """(class, images, labels) of every row of val's P/R/mAP table."""
    rows = []
    for line in lines:
        parts = line.split()
        if len(parts) == 7 and parts[1].isdigit() and parts[2].isdigit():
            rows.append(tuple(parts[:3]))
    return rows


def _run_logged(fn, logger, **kw):
    handler = _Lines()
    logger.addHandler(handler)
    try:
        out = fn(**kw)
    finally:
        logger.removeHandler(handler)
    return out, handler.lines


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """The small flagship (width 0.25, depth 0.33, nc 3) with randomized
    variables: its YAML path, the variables, and a JAX Runner (f32) that
    carries them."""
    cfg = small_flagship_cfg()
    _, _, variables = jax_flagship(cfg)
    path = tmp_path_factory.mktemp("cfg") / "somi-small.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.MonkeyPatch.context() as mp:  # the variables come from the fixture, not from init
        mp.setattr(jax_runner_mod, "init_model", lambda *a, **k: variables)
        jrunner = jax_runner_mod.Runner(str(path), nc=NC, dtype=jnp.float32, imgsz=IMGSZ)
    return str(path), variables, jrunner


@pytest.fixture(scope="module")
def self_labelled(flagship, tmp_path_factory):
    """12 synthetic PNGs labelled with the JAX Runner's top 5 single-label
    detections (conf > 0.25) each; returns the data YAML's path."""
    _, _, jrunner = flagship
    root = tmp_path_factory.mktemp("selfset") / "ds"
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate(EVAL_SIZES):
        _write_image(root / "images" / f"im{i:02d}.png", rng, h, w)
    dataset = jax_datasets.DetectionDataset(str(root / "images"), img_size=IMGSZ, batch_size=EVAL_BATCH)
    n_labels = 0
    for images, _, paths, shapes in jax_datasets.DataLoader(dataset, EVAL_BATCH, shuffle=False):
        out = jrunner(images, conf_thres=0.25)
        for det, path, ((h0, w0), ratio_pad) in zip(out, paths, shapes):
            det = det[det[:, 4] > 0][:5]
            xyxy = np.asarray(jax_boxes.scale_coords(images.shape[1:3], det[:, :4], (h0, w0), ratio_pad))
            xywhn = np.asarray(jax_boxes.xyxy2xywhn(xyxy, w=w0, h=h0))
            rows = [f"{int(c)} " + " ".join(f"{v:.6f}" for v in b)
                    for c, b in zip(det[:, 5], xywhn) if (b[2:] > 0).all()]
            lb = root / "labels" / (path.rsplit("/", 1)[-1].rsplit(".", 1)[0] + ".txt")
            if not lb.exists():  # the wrapped tail repeats images of the first batch
                lb.write_text("\n".join(rows) + "\n" if rows else "")
                n_labels += len(rows)
    assert n_labels >= 20, n_labels
    data = root / "data.yaml"
    data.write_text(yaml.safe_dump({"path": str(root), "train": "images", "val": "images", "nc": NC,
                                    "names": ["a", "b", "c"]}))
    return str(data)


# ---------------------------------------------------------------------------
# 1. box and letterbox helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn, kw", [
    ("xyxy2xywh", {}), ("xywh2xyxy", {}), ("xywhn2xyxy", dict(w=640, h=480, padw=10, padh=3.5)),
    ("xyxy2xywhn", dict(w=320, h=200, clip=True, eps=1e-3)), ("xyxy2xywhn", dict(w=320, h=200)),
    ("clip_coords", dict(shape=(200, 320))),
])
def test_box_helpers_equal_jax(fn, kw):
    x = np.random.default_rng(0).uniform(-50, 400, (17, 4)).astype(np.float32)
    got, ref = getattr(boxes, fn)(x, **kw), np.asarray(getattr(jax_boxes, fn)(x, **kw))
    np.testing.assert_array_equal(got, ref, err_msg="box helpers: exact equality with JAX on numpy input")
    tgot = getattr(boxes, fn)(torch.from_numpy(x), **kw)
    assert isinstance(tgot, torch.Tensor)
    np.testing.assert_allclose(tgot.numpy(), ref, rtol=1e-6, atol=1e-5, err_msg="torch input: 1e-6 rel of numpy")


def test_scale_coords_and_letterbox_params_equal_jax():
    x = np.random.default_rng(1).uniform(0, 64, (9, 4)).astype(np.float32)
    for img0, ratio_pad in (((48, 64), None), ((33, 64), ((1.0, 1.0), (0.0, 15.5))), ((96, 72), ((0.667, 0.667),
                                                                                            (8.0, 0.0)))):
        np.testing.assert_array_equal(boxes.scale_coords((64, 64), x, img0, ratio_pad),
                                      np.asarray(jax_boxes.scale_coords((64, 64), x, img0, ratio_pad)))
    for shape in ((480, 640), (37, 64), (100, 80), (30, 40), (33, 97)):
        for kw in (dict(new_shape=64, scaleup=False), dict(new_shape=64), dict(new_shape=(64, 96), auto=True),
                   dict(new_shape=64, scalefill=True)):
            assert boxes.letterbox_params(shape, **kw) == jax_boxes.letterbox_params(shape, **kw)


@pytest.mark.parametrize("shape, kw", [
    ((30, 40), dict(scaleup=True)),  # upscale
    ((100, 80), dict(scaleup=False)),  # downscale
    ((37, 64), dict(scaleup=False, auto=False)),  # no resize, odd padding (27 rows)
    ((51, 70), dict(scaleup=True, auto=True, stride=32)),  # downscale, minimal stride padding
])
def test_letterbox_bitwise_equal_jax(shape, kw):
    im = np.random.default_rng(2).integers(0, 256, (*shape, 3), dtype=np.uint8)
    got, gratio, gpad = augment.letterbox(im, 64, **kw)
    ref, rratio, rpad = jax_augment.letterbox(im, 64, **kw)
    assert (gratio, gpad) == (rratio, rpad)
    np.testing.assert_array_equal(got, ref, err_msg="letterbox images: bitwise equal")


# ---------------------------------------------------------------------------
# 2. the dataset and the loader
# ---------------------------------------------------------------------------


def test_dataset_and_loader_equal_jax(tmp_path):
    """PNG and JPEG images of several sizes (two need INTER_AREA, one an
    upscale, one odd padding); one image has an empty label file, one no
    label file, one duplicate label rows. 7 images in batches of 4: the
    last batch wraps one image."""
    root = tmp_path / "ds"
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.default_rng(3)
    specs = [("a.png", 48, 64), ("b.jpg", 100, 80), ("c.png", 37, 64), ("d.jpg", 30, 40), ("e.png", 64, 64),
             ("f.png", 90, 120), ("g.jpg", 50, 20)]
    for name, h, w in specs:
        _write_image(root / "images" / name, rng, h, w)
        stem = name.split(".")[0]
        if stem == "b":
            (root / "labels" / "b.txt").write_text("")
        elif stem == "c":
            continue
        else:
            rows = [f"{rng.integers(0, NC)} {rng.uniform(0.2, 0.8):.4f} {rng.uniform(0.2, 0.8):.4f} "
                    f"{rng.uniform(0.05, 0.3):.4f} {rng.uniform(0.05, 0.3):.4f}" for _ in range(3)]
            if stem == "d":
                rows += rows[:2]
            (root / "labels" / f"{stem}.txt").write_text("\n".join(rows) + "\n")

    jds = jax_datasets.DetectionDataset(str(root / "images"), img_size=IMGSZ, batch_size=4)
    pds = datasets.DetectionDataset(str(root / "images"), img_size=IMGSZ)
    assert pds.img_files == jds.img_files and len(pds) == 7
    assert [len(lb) for lb in pds.labels] == [len(lb) for lb in jds.labels] == [3, 0, 0, 3, 3, 3, 3]
    np.testing.assert_array_equal(pds.shapes, jds.shapes)
    jbatches = list(jax_datasets.DataLoader(jds, 4, shuffle=False))
    pbatches = list(datasets.DataLoader(pds, 4))
    assert len(pbatches) == len(jbatches) == 2
    for (pi, pt, pp, ps), (ji, jt, jp, js) in zip(pbatches, jbatches):
        assert pi.dtype == np.uint8 and pi.shape == (4, IMGSZ, IMGSZ, 3)
        np.testing.assert_array_equal(pi, ji, err_msg="loader images: bitwise equal")
        np.testing.assert_allclose(pt, jt, atol=1e-6, rtol=0, err_msg="targets: 1e-6")
        assert pp == jp and ps == js
    assert pbatches[1][2][3] == pbatches[0][2][0]  # the wrapped tail starts over

    # the port's cache is a file of its own, and a hit gives the same labels
    caches = sorted(p.name for p in tmp_path.iterdir() if p.is_file())
    assert caches == ["ds.somi-torch.cache.json", "ds.somi.cache.npy"], caches
    again = datasets.DetectionDataset(str(root / "images"), img_size=IMGSZ)
    for a, b in zip(again.labels, pds.labels):
        np.testing.assert_array_equal(a, b)


def test_loader_raises_a_failed_item(tmp_path):
    (tmp_path / "images").mkdir()
    _write_image(tmp_path / "images" / "a.png", np.random.default_rng(0), 32, 32)
    ds = datasets.DetectionDataset(str(tmp_path / "images"), img_size=IMGSZ)
    (tmp_path / "images" / "a.png").unlink()
    with pytest.raises(FileNotFoundError):
        list(datasets.DataLoader(ds, 2))


# ---------------------------------------------------------------------------
# 3. non_max_suppression
# ---------------------------------------------------------------------------


def _decoded(seed, b, n, nc, conf_scale=1.0, quantized=False):
    """Random decoded rows [xc, yc, w, h, obj, cls...] on a 128 px canvas."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 128, (b, n, 2))
    wh = rng.uniform(4, 40, (b, n, 2))
    scores = rng.uniform(0, 1, (b, n, 1 + nc)) * conf_scale
    if quantized:  # exact ties everywhere: scores from {0.5, 1.0}
        scores = np.where(scores > 0.5, 1.0, 0.5)
    return np.concatenate([xy, wh, scores], -1).astype(np.float32)


@pytest.mark.parametrize("case", [
    dict(multi_label=True),
    dict(multi_label=False),
    dict(multi_label=True, classes=np.array([True, False, True, True])),
    dict(multi_label=False, classes=np.array([False, True, False, True])),
    dict(multi_label=True, agnostic=True),
    dict(multi_label=True, max_nms=100),  # below N * nc = 1600
    dict(multi_label=True, conf_scale=0.2, conf_thres=0.3, expect="none"),  # nothing passes conf
    dict(multi_label=True, conf_thres=0.001, max_det=20, iou_thres=0.9, expect="full"),  # fills max_det
    dict(multi_label=True, quantized=True, iou_thres=0.3),  # exact ties: lower index first, as in JAX
    dict(multi_label=False, quantized=True, iou_thres=0.3),
], ids=["multi", "single", "multi-classes", "single-classes", "agnostic", "max-nms", "none-pass", "max-det-full",
        "multi-ties", "single-ties"])
def test_non_max_suppression_matches_jax(case):
    case = dict(case)
    expect = case.pop("expect", "some")
    pred = _decoded(7, 3, 400, 4, case.pop("conf_scale", 1.0), case.pop("quantized", False))
    classes = case.pop("classes", None)
    kw = dict(dict(conf_thres=0.25, iou_thres=0.45, max_det=300, max_nms=4096, exact=True), **case)
    ref = np.asarray(jax_nms.non_max_suppression(jnp.asarray(pred), classes=None if classes is None
                                                 else jnp.asarray(classes), **kw))
    got = nms.non_max_suppression(torch.from_numpy(pred), classes=None if classes is None
                                  else torch.from_numpy(classes), **kw).numpy()
    assert got.shape == ref.shape == (3, kw["max_det"], 6)
    for b in range(3):
        gv, rv = got[b][got[b][:, 4] > 0], ref[b][ref[b][:, 4] > 0]
        assert len(gv) == len(rv), (b, len(gv), len(rv))
        np.testing.assert_array_equal(gv[:, 5], rv[:, 5])
        np.testing.assert_allclose(gv, rv, atol=1e-5, rtol=1e-5, err_msg="keep-set rows: 1e-5")
        assert (got[b][got[b][:, 4] <= 0] == 0).all()
    n_valid = (ref[..., 4] > 0).sum(1)
    if expect == "none":
        assert (n_valid == 0).all()
    elif expect == "full":
        assert (n_valid == kw["max_det"]).all()
    else:
        assert n_valid.min() > 0


def test_fused_postprocess_ties_match_jax():
    """Exact ties in the serving path's selection order as in JAX too."""
    rng = np.random.default_rng(11)
    preds = [np.where(rng.uniform(0, 1, (2, g, g, 3, 8)) > 0.5, 30.0, 0.0).astype(np.float32) for g in (8, 4)]
    anchors = np.array([[[10, 13], [16, 30], [33, 23]], [[30, 61], [62, 45], [59, 119]]], np.float32)
    ref = np.asarray(jax_nms.fused_postprocess([jnp.asarray(p) for p in preds], anchors, (8.0, 16.0),
                                               max_det=50, max_nms=64))
    got = fused_postprocess([torch.from_numpy(p) for p in preds], anchors, (8.0, 16.0), max_det=50, max_nms=64).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5, err_msg="rows under exact ties: 1e-5")
    assert (ref[..., 4] == 1.0).sum() > 10  # the ties are real


def test_decode_matches_jax():
    rng = np.random.default_rng(4)
    anchors = np.array([[[10, 13], [16, 30], [33, 23]], [[30, 61], [62, 45], [59, 119]]], np.float32)
    preds = [rng.normal(0, 2, (2, g, g, 3, 5 + NC)).astype(np.float32) for g in (8, 4)]
    ref = np.asarray(jax_decode([jnp.asarray(p) for p in preds], anchors, (8.0, 16.0)))
    got = decode([torch.from_numpy(p) for p in preds], anchors, (8.0, 16.0)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5, err_msg="decoded rows: 1e-6 rel, 1e-5 abs")


# ---------------------------------------------------------------------------
# 4. metrics and COCO
# ---------------------------------------------------------------------------


def _stats(seed, n=300, m=120, nc=5):
    rng = np.random.default_rng(seed)
    tp = rng.uniform(0, 1, (n, 10)) < np.linspace(0.8, 0.2, 10)
    return tp, rng.uniform(0, 1, n), rng.integers(0, nc, n).astype(float), rng.integers(0, nc, m).astype(float)


@pytest.mark.parametrize("seed", [0, 1])
def test_ap_per_class_and_fitness_equal_jax(seed):
    stats = _stats(seed)
    got = metrics.ap_per_class(*stats)
    ref = jax_metrics.ap_per_class(*stats)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-12, err_msg="ap_per_class: 1e-12")
    x = np.array([got[0].mean(), got[1].mean(), got[2][:, 0].mean(), got[2].mean()])
    assert abs(metrics.fitness(x) - jax_metrics.fitness(x)) <= 1e-12
    assert abs(metrics.fitness(x, aiou=True) - jax_metrics.fitness(x, aiou=True)) <= 1e-12
    rec = np.sort(np.random.default_rng(seed).uniform(0, 1, 50))
    prec = np.random.default_rng(seed + 9).uniform(0, 1, 50)
    for g, r in zip(metrics.compute_ap(rec, prec), jax_metrics.compute_ap(rec, prec)):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-12, err_msg="compute_ap: 1e-12")
    y = np.random.default_rng(seed).uniform(0, 1, 1000)
    np.testing.assert_allclose(metrics.smooth(y), jax_metrics.smooth(y), rtol=0, atol=1e-12)


def _dets_and_labels(seed):
    rng = np.random.default_rng(seed)
    lab_xy = rng.uniform(0, 200, (15, 2))
    labels = np.concatenate([rng.integers(0, 3, (15, 1)), lab_xy, lab_xy + rng.uniform(10, 50, (15, 2))], 1)
    jitter = labels[rng.integers(0, 15, 40), 1:] + rng.normal(0, 2, (40, 4))
    dets = np.concatenate([jitter, rng.uniform(0, 1, (40, 1)), rng.integers(0, 3, (40, 1))], 1)
    return dets.astype(np.float32), labels.astype(np.float32)


@pytest.mark.parametrize("alpha_iou", [False, True])
def test_process_batch_equal_jax(alpha_iou):
    dets, labels = _dets_and_labels(5)
    iouv = np.linspace(0.5, 0.95, 10)
    got = metrics.process_batch(dets, labels, iouv, alpha_iou=alpha_iou)
    ref = jax_metrics.process_batch(dets, labels, iouv, alpha_iou=alpha_iou)
    np.testing.assert_array_equal(got, ref)
    assert 0 < got[:, 0].sum() < len(dets)
    assert not metrics.process_batch(dets[:0], labels, iouv).any()


def test_confusion_matrix_equal_jax():
    gm, rm = metrics.ConfusionMatrix(nc=3), jax_metrics.ConfusionMatrix(nc=3)
    for seed in range(4):
        dets, labels = _dets_and_labels(seed)
        for d, lb in ((dets, labels), (dets[:0], labels), (dets, labels[:0])):
            gm.process_batch(d, lb)
            rm.process_batch(d, lb)
    np.testing.assert_allclose(gm.matrix, rm.matrix, rtol=0, atol=1e-12)
    for g, r in zip(gm.tp_fp(), rm.tp_fp()):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-12)


def test_coco_evaluator_equal_jax():
    rng = np.random.default_rng(6)
    gt = {"images": [{"id": i} for i in range(4)], "categories": [{"id": c} for c in (1, 2)], "annotations": []}
    dt = []
    for i in range(4):
        for k in range(6):
            x, y, w, h = rng.uniform(0, 300), rng.uniform(0, 300), rng.uniform(8, 120), rng.uniform(8, 120)
            c = int(rng.integers(1, 3))
            gt["annotations"].append({"id": len(gt["annotations"]) + 1, "image_id": i, "category_id": c,
                                      "bbox": [x, y, w, h], "iscrowd": int(k == 5)})
            dt.append({"image_id": i, "category_id": c, "score": float(rng.uniform(0.1, 1)),
                       "bbox": [x + rng.normal(0, 4), y + rng.normal(0, 4), w, h]})
    got = cocoeval.COCOEvaluator(gt, dt).accumulate().summarize(log=lambda s: None)
    ref = jax_cocoeval.COCOEvaluator(gt, dt).accumulate().summarize(log=lambda s: None)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12, err_msg="COCO stats: 1e-12")
    assert got[1] > 0.3


# ---------------------------------------------------------------------------
# 5. the Runner's eval call, and val.run as a whole
# ---------------------------------------------------------------------------


def test_runner_eval_call_matches_jax(flagship):
    path, variables, jrunner = flagship
    runner = Runner(path, nc=NC, dtype=torch.float32, imgsz=IMGSZ, device="cpu", variables=variables)
    images = np.random.default_rng(8).integers(0, 256, (EVAL_BATCH, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    got = runner(images, **EVAL_KW)
    ref = jrunner(images, **EVAL_KW)
    assert got.shape == ref.shape == (EVAL_BATCH, 300, 6)
    for b in range(EVAL_BATCH):
        gv, rv = got[b][got[b][:, 4] > 0], ref[b][ref[b][:, 4] > 0]
        assert len(gv) == len(rv) > 0, (b, len(gv), len(rv))
        np.testing.assert_array_equal(gv[:, 5], rv[:, 5])
        np.testing.assert_allclose(gv[:, :5], rv[:, :5], rtol=1e-4, atol=1e-4, err_msg="rows: 1e-4 rel + 1e-4 abs")

    # single-label, inexact calls stay on the fused postprocess, classes and agnostic included
    with torch.no_grad():
        raw = runner.model(torch.from_numpy(images).permute(0, 3, 1, 2).float() / 255.0)
    mask = np.array([True, False, True])
    for kw in (dict(), dict(classes=mask), dict(agnostic=True)):
        ref = fused_postprocess(raw, runner.meta.anchors_px, runner.meta.strides, conf_thres=0.2, **kw).numpy()
        np.testing.assert_array_equal(runner(images, conf_thres=0.2, **kw), ref)
    assert set(np.unique(runner(images, conf_thres=0.01, classes=mask)[..., 5])) <= {0.0, 2.0}
    assert runner.stride == 32 and runner.names == [str(i) for i in range(NC)]


def test_val_run_matches_jax_on_a_self_labelled_set(flagship, self_labelled, tmp_path):
    path, variables, jrunner = flagship
    common = dict(data=self_labelled, batch_size=EVAL_BATCH, imgsz=IMGSZ, project=str(tmp_path), exist_ok=True)
    (jres, jmaps, _), jlines = _run_logged(jax_val.run, jax_val.LOGGER, runner=jrunner, name="jax", **common)
    (pres, pmaps, pspd), plines = _run_logged(val.run, val.LOGGER, cfg=path, variables=variables, half=False,
                                              device="cpu", name="port", **common)
    # on this set (CPU, f32): JAX mAP@.5 = mAP@.5:.95 = 0.96569, P 0.78262, R 1.0, and the port the same
    assert jres[2] > 0.5, f"JAX mAP@.5 {jres[2]} on its own labels: the check would be vacuous"
    assert abs(pres[2] - jres[2]) <= 1e-3, f"mAP@.5 {pres[2]} vs JAX {jres[2]}: 1e-3 absolute"
    assert abs(pres[3] - jres[3]) <= 1e-3, f"mAP@.5:.95 {pres[3]} vs JAX {jres[3]}: 1e-3 absolute"
    assert abs(pres[0] - jres[0]) <= 1e-2 and abs(pres[1] - jres[1]) <= 1e-2, (pres[:2], jres[:2])
    np.testing.assert_allclose(pmaps, jmaps, atol=1e-3, err_msg="per-class mAP@.5:.95: 1e-3")
    ptable, jtable = _table(plines), _table(jlines)
    assert ptable == jtable and ptable[0][:2] == ("all", str(len(EVAL_SIZES))), (ptable, jtable)
    assert len(pspd) == 3 and all(t >= 0 for t in pspd)
    summary = yaml.safe_load((tmp_path / "port" / "metrics.json").read_text())
    assert summary["images"] == len(EVAL_SIZES) and abs(summary["mAP50"] - pres[2]) < 1e-12


def test_val_run_single_cls_counts_every_label_as_class_0(flagship, tmp_path):
    """Each image's label is the model's own top box, given class 1 or 2.
    With single_cls every detection and label is class 0, so each label is
    found (the JAX val.py leaves labels in their class and fails indexing
    its 1-class map)."""
    path, variables, _ = flagship
    runner = Runner(path, nc=NC, dtype=torch.float32, imgsz=IMGSZ, device="cpu", variables=variables)
    (tmp_path / "ds" / "images").mkdir(parents=True)
    (tmp_path / "ds" / "labels").mkdir()
    rng = np.random.default_rng(9)
    for i in range(3):  # 64 x 64: the loader neither resizes nor pads
        _write_image(tmp_path / "ds" / "images" / f"{i}.png", rng, IMGSZ, IMGSZ)
        im = cv2.imread(str(tmp_path / "ds" / "images" / f"{i}.png"))
        top = runner(im[None], conf_thres=0.0)[0, 0]
        xywhn = boxes.xyxy2xywhn(top[:4], w=IMGSZ, h=IMGSZ, clip=True)
        (tmp_path / "ds" / "labels" / f"{i}.txt").write_text(f"{1 + i % 2} " + " ".join(f"{v:.6f}" for v in xywhn))
    data = {"path": str(tmp_path / "ds"), "val": str(tmp_path / "ds" / "images"), "nc": NC, "names": ["a", "b", "c"]}
    (res, maps, _), lines = _run_logged(val.run, val.LOGGER, data=data, runner=runner, batch_size=2, imgsz=IMGSZ,
                                        single_cls=True, project=str(tmp_path / "runs"))
    assert maps.shape == (1,) and res[1] == 1.0, res
    assert _table(lines)[0] == ("all", "3", "3"), lines


@pytest.mark.parametrize("kw, error, match", [(dict(plots=True), NotImplementedError, "ROADMAP queue A item"),
                                              (dict(shard_spatial=2), RuntimeError, "torchrun")],
                         ids=["plots", "shard"])
def test_val_run_refuses_what_is_not_ported(kw, error, match, tmp_path):
    """What is not ported raises, naming its ROADMAP item; spatial sharding
    without a process group raises, naming torchrun."""
    with pytest.raises(error, match=match):
        val.run("coco128", project=str(tmp_path), **kw)


def test_val_run_without_a_device_needs_cuda(self_labelled, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        val.run(self_labelled, cfg="yolo-somi", project=str(tmp_path))
