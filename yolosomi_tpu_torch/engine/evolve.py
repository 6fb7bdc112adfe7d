"""Hyperparameter evolution: a genetic search over the training hyps
(counterpart of yolosomi_tpu/engine/evolve.py, the JAX package's copy of
the reference's --evolve loop, train.py:436-503, and print_mutation,
general.py:730-766): per-key mutation gains and bounds, a parent picked
from the top-5 fitness rows of evolve.csv, a 90%-probability scaled
gaussian mutation. The draws are the JAX package's: Python's `random`
for the parent and numpy's global `np.random` for the mutation, so the
same seeds give the same hyps and the same evolve.csv bytes.
"""

from __future__ import annotations

import random
from pathlib import Path

import numpy as np

from yolosomi_tpu_torch.utils.general import LOGGER

# {key: (mutation_gain, low, high)} — the reference's meta table (train.py:437-466)
META = {
    "lr0": (1.0, 1e-5, 0.1),
    "lrf": (1.0, 0.01, 1.0),
    "momentum": (0.3, 0.6, 0.98),
    "weight_decay": (1.0, 0.0, 0.001),
    "warmup_epochs": (1.0, 0.0, 5.0),
    "warmup_momentum": (1.0, 0.0, 0.95),
    "warmup_bias_lr": (1.0, 0.0, 0.2),
    "box": (1.0, 0.02, 0.2),
    "cls": (1.0, 0.2, 4.0),
    "cls_pw": (1.0, 0.5, 2.0),
    "obj": (1.0, 0.2, 4.0),
    "obj_pw": (1.0, 0.5, 2.0),
    "iou_t": (0.0, 0.1, 0.7),
    "anchor_t": (1.0, 2.0, 8.0),
    "fl_gamma": (0.0, 0.0, 2.0),
    "hsv_h": (1.0, 0.0, 0.1),
    "hsv_s": (1.0, 0.0, 0.9),
    "hsv_v": (1.0, 0.0, 0.9),
    "degrees": (1.0, 0.0, 45.0),
    "translate": (1.0, 0.0, 0.9),
    "scale": (1.0, 0.0, 0.9),
    "shear": (1.0, 0.0, 10.0),
    "perspective": (0.0, 0.0, 0.001),
    "flipud": (1.0, 0.0, 1.0),
    "fliplr": (0.0, 0.0, 1.0),
    "mosaic": (1.0, 0.0, 1.0),
    "mixup": (1.0, 0.0, 1.0),
    "copy_paste": (1.0, 0.0, 1.0),
}


def mutate(hyp: dict, evolve_csv: Path, mp: float = 0.8, s: float = 0.2) -> dict:
    """One GA mutation; parent = weighted pick of top-5 evolve.csv rows
    (reference: train.py:469-490)."""
    hyp = dict(hyp)
    keys = [k for k in META if k in hyp]
    if evolve_csv.exists():
        rows = np.loadtxt(evolve_csv, delimiter=",", skiprows=1, ndmin=2)
        if len(rows):
            n = min(5, len(rows))
            order = rows[:, 0].argsort()[::-1][:n]  # col 0 = fitness
            top = rows[order]
            w = top[:, 0] - top[:, 0].min() + 1e-6
            # single-parent selection weighted by fitness (reference :478-481)
            parent = top[random.choices(range(n), weights=w)[0]]
            for i, k in enumerate(keys):
                hyp[k] = float(parent[i + 1])
    # mutate until something changes (reference :483-489)
    npr = np.random
    gains = np.array([META[k][0] for k in keys])
    v = np.ones(len(keys))
    while (v == 1).all():
        v = (gains * (npr.random(len(keys)) < mp) * npr.randn(len(keys)) * npr.random() * s + 1).clip(0.3, 3.0)
    for i, k in enumerate(keys):
        lo, hi = META[k][1], META[k][2]
        hyp[k] = float(np.clip(hyp[k] * v[i], lo, hi))
    return hyp


def log_generation(evolve_csv: Path, hyp: dict, fitness: float) -> None:
    """Append one generation row (reference: print_mutation, general.py:730)."""
    keys = [k for k in META if k in hyp]
    header = not evolve_csv.exists()
    with open(evolve_csv, "a") as f:
        if header:
            f.write("fitness," + ",".join(keys) + "\n")
        f.write(f"{fitness:.5f}," + ",".join(f"{hyp[k]:.5g}" for k in keys) + "\n")
    LOGGER.info(f"evolve: fitness {fitness:.4f} logged to {evolve_csv}")
