"""Autoanchor: the best-possible-recall check, and k-means or k-means++
anchor evolution when the check fails (counterpart of
yolosomi_tpu/utils/autoanchor.py). Host numpy, once before training.

kmean_anchors draws from numpy's global generator and Python's `random`
(scipy's k-means included) in the JAX package's order, so the same seeds
give the same anchors. kmeanplus_anchors (`--kmean`) is a k-means++ of
its own in numpy (the JAX package calls scikit-learn's, which the card
does not have): ten seeded k-means++ starts of Lloyd's iterations, the
lowest inertia kept; its centres are close to scikit-learn's, not equal.
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np

from yolosomi_tpu_torch.utils.general import LOGGER


def _metric(k: np.ndarray, wh: np.ndarray):
    """Per-target ratio metric to every anchor, and to the best one."""
    r = wh[:, None] / k[None]
    x = np.minimum(r, 1 / r).min(2)
    return x, x.max(1)


def check_anchor_order(anchors_px: np.ndarray, strides) -> np.ndarray:
    """Anchor areas ascending with stride (reversed otherwise)."""
    a = anchors_px.prod(-1).mean(-1)
    if np.sign(a[-1] - a[0]) != np.sign(strides[-1] - strides[0]):
        LOGGER.info("autoanchor: reversing anchor order")
        anchors_px = anchors_px[::-1].copy()
    return anchors_px


def dataset_wh(dataset, imgsz: int) -> np.ndarray:
    """The labels' wh in pixels at `imgsz`, each image jittered by a
    uniform 0.9-1.1 scale (one np.random draw per image)."""
    shapes = imgsz * dataset.shapes / dataset.shapes.max(1, keepdims=True)
    scale = np.random.uniform(0.9, 1.1, size=(shapes.shape[0], 1))
    parts = [lb[:, 3:5] * s * sh for s, sh, lb in zip(scale, shapes, dataset.labels) if len(lb)]
    return np.concatenate(parts) if parts else np.zeros((0, 2))


def kmean_anchors(wh: np.ndarray, n: int = 9, thr: float = 4.0, gen: int = 1000):
    """scipy's whitened k-means, sorted by area, then `gen` generations of
    mutation keeping the fittest."""
    from scipy.cluster.vq import kmeans

    thr = 1 / thr
    wh = wh[(wh >= 2.0).any(1)]
    s = wh.std(0)
    try:
        k, _ = kmeans(wh / s, n, iter=30)
        if len(k) != n:
            raise ValueError(f"k-means found {len(k)} of {n} centres")
        k *= s
    except ValueError:
        k = np.sort(np.random.rand(n * 2)).reshape(n, 2) * wh.max(0)
    k = k[np.argsort(k.prod(1))]

    def fit(k):
        r = wh[:, None] / k[None]
        best = np.minimum(r, 1 / r).min(2).max(1)
        return (best * (best > thr)).mean()

    f = fit(k)
    npr = np.random
    sh, mp, sigma = k.shape, 0.9, 0.1
    for _ in range(gen):
        v = np.ones(sh)
        while (v == 1).all():
            v = ((npr.random(sh) < mp) * random.random() * npr.randn(*sh) * sigma + 1).clip(0.3, 3.0)
        kg = (k.copy() * v).clip(min=2.0)
        fg = fit(kg)
        if fg > f:
            f, k = fg, kg.copy()
    LOGGER.info(f"autoanchor: kmeans fitness {f:.4f}")
    return k[np.argsort(k.prod(1))]


def kmeanplus_anchors(wh: np.ndarray, n: int = 9, n_init: int = 10, iters: int = 300, seed: int = 0) -> np.ndarray:
    """k-means++ centres of the wh (n_init seeded starts, Lloyd's
    iterations, the lowest inertia kept), at least 2 px, sorted by area."""
    wh = wh[(wh >= 2.0).any(1)].astype(np.float64)
    rs = np.random.RandomState(seed)
    best, best_inertia = None, np.inf
    for _ in range(n_init):
        c = [wh[rs.randint(len(wh))]]
        for _ in range(1, n):
            d2 = ((wh[:, None] - np.asarray(c)[None]) ** 2).sum(-1).min(1)
            c.append(wh[rs.choice(len(wh), p=d2 / d2.sum())] if d2.sum() > 0 else wh[rs.randint(len(wh))])
        c = np.asarray(c)
        for _ in range(iters):
            lab = ((wh[:, None] - c[None]) ** 2).sum(-1).argmin(1)
            new = np.array([wh[lab == j].mean(0) if (lab == j).any() else c[j] for j in range(n)])
            if np.allclose(new, c):
                break
            c = new
        inertia = ((wh - c[((wh[:, None] - c[None]) ** 2).sum(-1).argmin(1)]) ** 2).sum()
        if inertia < best_inertia:
            best, best_inertia = c, inertia
    k = best.clip(min=2.0)
    return k[np.argsort(k.prod(1))]


def check_anchors(dataset, meta, thr: float = 4.0, imgsz: int = 640, kmean: bool = False) -> Optional[np.ndarray]:
    """The best possible recall of the model's anchors on the dataset;
    below 0.98, anchors re-clustered from the labels. Returns the new
    (nl, na*2) pixel anchors, or None when the current ones pass or the
    new ones are no better."""
    wh = dataset_wh(dataset, imgsz)
    if len(wh) == 0:
        return None
    x, best = _metric(meta.anchors_px.reshape(-1, 2), wh)
    aat = float((x > 1 / thr).sum(1).mean())
    bpr = float((best > 1 / thr).mean())
    LOGGER.info(f"autoanchor: {aat:.2f} anchors/target, {bpr:.3f} best possible recall (thr={thr})")
    if bpr > 0.98:
        LOGGER.info("autoanchor: current anchors are a good fit")
        return None
    n = meta.na * meta.nl
    LOGGER.info(f"autoanchor: recomputing {n} anchors ({'kmeans++' if kmean else 'kmeans+GA'})...")
    k = kmeanplus_anchors(wh, n=n) if kmean else kmean_anchors(wh, n=n, thr=thr)
    new_bpr = float((_metric(k, wh)[1] > 1 / thr).mean())
    if new_bpr <= bpr:
        LOGGER.info("autoanchor: original anchors better, keeping them")
        return None
    new = check_anchor_order(k.reshape(meta.nl, meta.na, 2), meta.strides)
    LOGGER.info(f"autoanchor: new anchors (bpr {new_bpr:.3f}):\n{new.round(1).reshape(meta.nl, -1)}")
    return new.reshape(meta.nl, -1)
