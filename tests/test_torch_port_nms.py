"""yolosomi_tpu_torch's serving postprocess against the JAX package's:
identical keep-sets and rows for the same raw level maps. Scores are drawn
continuous so that no two candidates tie (the frameworks' top_k may order
exact ties differently)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yolosomi_tpu.ops import nms as jax_nms
from yolosomi_tpu_torch.ops import nms

ANCHORS2 = np.array([[[10, 13], [16, 30], [33, 23]], [[30, 61], [62, 45], [59, 119]]], np.float32)


def _both(preds, anchors, strides, classes=None, **kw):
    ref = np.asarray(jax_nms.fused_postprocess(
        [jnp.asarray(p) for p in preds], anchors, tuple(strides),
        classes=None if classes is None else jnp.asarray(classes), **kw))
    got = nms.fused_postprocess(
        [torch.from_numpy(p) for p in preds], anchors, strides,
        classes=None if classes is None else torch.from_numpy(classes), **kw).numpy()
    return got, ref


def _assert_same_detections(got, ref):
    assert got.shape == ref.shape
    for b in range(ref.shape[0]):
        gv, rv = got[b][got[b][:, 4] > 0], ref[b][ref[b][:, 4] > 0]
        assert len(gv) == len(rv), (b, len(gv), len(rv))
        np.testing.assert_array_equal(gv[:, 5], rv[:, 5])
        np.testing.assert_allclose(gv, rv, atol=1e-5, rtol=1e-5)
        assert (got[b][got[b][:, 4] <= 0] == 0).all()  # padded rows are zeros


@pytest.mark.parametrize(
    "case",
    [
        # tests/test_nms.py::test_fused_postprocess_matches_unfused settings
        dict(seed=3, nc=4, grids=(8, 4), conf_thres=0.25, iou_thres=0.45, max_det=50, max_nms=64),
        dict(seed=4, nc=4, grids=(8, 4), conf_thres=0.25, iou_thres=0.45, max_det=50, max_nms=64, agnostic=True),
        dict(seed=5, nc=4, grids=(8, 4), conf_thres=0.25, iou_thres=0.45, max_det=50, max_nms=64,
             classes=np.array([True, False, True, False])),
        # several 512-wide NMS tiles, and a keep buffer that fills up
        dict(seed=6, nc=3, grids=(24, 12), conf_thres=0.05, iou_thres=0.5, max_det=300, max_nms=1600),
        dict(seed=7, nc=3, grids=(24, 12), conf_thres=0.05, iou_thres=0.3, max_det=20, max_nms=1600),
    ],
    ids=["unfused-settings", "agnostic", "classes", "multi-tile", "max-det-full"],
)
def test_fused_postprocess_matches_jax(case):
    case = dict(case)
    rng = np.random.default_rng(case.pop("seed"))
    nc, grids = case.pop("nc"), case.pop("grids")
    preds = [rng.normal(0, 2, (2, g, g, 3, 5 + nc)).astype(np.float32) for g in grids]
    got, ref = _both(preds, ANCHORS2, (8.0, 16.0), **case)
    _assert_same_detections(got, ref)
    assert (ref[..., 4] > 0).sum() > 0


def test_fused_postprocess_classes_pre_argmax():
    """A box whose best class is disallowed surfaces its best allowed class
    (tests/test_nms.py::test_fused_postprocess_classes_pre_argmax)."""
    p = np.full((1, 2, 2, 1, 8), -8.0, np.float32)
    p[0, 1, 1, 0, :4] = [0.0, 0.0, 0.5, 0.5]
    p[0, 1, 1, 0, 4] = 4.0  # obj
    p[0, 1, 1, 0, 5] = 4.0  # class 0 (disallowed)
    p[0, 1, 1, 0, 7] = 2.0  # class 2 (allowed)
    anchors = np.array([[[16, 16]]], np.float32)
    got, ref = _both([p], anchors, (8.0,), classes=np.array([False, False, True]), conf_thres=0.25,
                     max_det=10, max_nms=4)
    _assert_same_detections(got, ref)
    assert got[0, 0, 5] == 2.0 and (got[0, 1:] == 0).all()


def test_tiled_nms_suppression_chain():
    """A kills B, dead B must not kill C: greedy keeps {A, C}."""
    boxes = torch.tensor([[0, 0, 10, 10], [4, 0, 14, 10], [8, 0, 18, 10]], dtype=torch.float32)
    scores = torch.tensor([0.9, 0.8, 0.7])
    idx, valid = nms._nms_single_tiled(boxes, scores, 0.3, 10, tile=256)
    assert idx[valid].tolist() == [0, 2]
    assert valid.tolist() == [True, True] + [False] * 8


def test_tiled_nms_keep_set_matches_jax():
    """Random score-sorted boxes, some zero-score padding, small tiles."""
    rng = np.random.default_rng(7)
    for trial in range(8):
        K = int(rng.choice([32, 300, 1100]))
        n_real = int(rng.integers(1, K + 1))
        c = rng.uniform(0, 300, (n_real, 2))
        wh = rng.uniform(10, 90, (n_real, 2))
        boxes = np.zeros((K, 4), np.float32)
        boxes[:n_real] = np.concatenate([c - wh / 2, c + wh / 2], 1)
        scores = np.zeros((K,), np.float32)
        scores[:n_real] = np.sort(rng.uniform(0.1, 1.0, n_real))[::-1]
        for md in (5, 100):
            ji, jv = jax_nms._nms_single_tiled(jnp.asarray(boxes), jnp.asarray(scores), 0.45, md, tile=256)
            ti, tv = nms._nms_single_tiled(torch.from_numpy(boxes), torch.from_numpy(scores), 0.45, md, tile=256)
            np.testing.assert_array_equal(ti[tv].numpy(), np.asarray(ji)[np.asarray(jv)], err_msg=f"{trial} {md}")
