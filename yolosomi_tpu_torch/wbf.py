"""Offline weighted-boxes-fusion CLI (counterpart of the root wbf.py of the
JAX package; the reference's wbf.py).

    python -m yolosomi_tpu_torch.wbf --dirs runs/detect/m1/labels runs/detect/m2/labels \
        --out runs/wbf/labels [--weights 2 1 --iou 0.55 --skip-thr 0.0]

Fuses, image by image, the label files of several models (one directory
per model, YOLO rows `cls xc yc w h [conf]` normalized; a row without conf
counts 1.0) and writes the fused rows, `cls xc yc w h conf` with six
decimals, one file per image stem.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from yolosomi_tpu_torch.ops.wbf import weighted_boxes_fusion
from yolosomi_tpu_torch.utils.general import LOGGER


def load_labels(path: Path):
    """A YOLO label file -> (boxes xyxy normalized and clipped to [0, 1],
    scores, labels); a missing or empty file gives empty arrays."""
    if not path.exists():
        return np.zeros((0, 4)), np.zeros(0), np.zeros(0)
    rows = np.array([line.split() for line in path.read_text().strip().splitlines() if line], np.float64)
    if rows.size == 0:
        return np.zeros((0, 4)), np.zeros(0), np.zeros(0)
    cls = rows[:, 0]
    xc, yc, w, h = rows[:, 1], rows[:, 2], rows[:, 3], rows[:, 4]
    conf = rows[:, 5] if rows.shape[1] > 5 else np.ones_like(cls)
    boxes = np.stack([xc - w / 2, yc - h / 2, xc + w / 2, yc + h / 2], 1).clip(0, 1)
    return boxes, conf, cls


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dirs", nargs="+", required=True, help="label dirs, one per model")
    parser.add_argument("--out", required=True, help="output label dir")
    parser.add_argument("--weights", nargs="+", type=float, default=None)
    parser.add_argument("--iou", type=float, default=0.55)
    parser.add_argument("--skip-thr", type=float, default=0.0)
    args = parser.parse_args(argv)

    dirs = [Path(d) for d in args.dirs]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    stems = sorted({p.stem for d in dirs for p in d.glob("*.txt")})
    LOGGER.info(f"WBF over {len(dirs)} models, {len(stems)} images")
    for stem in stems:
        per_model = [load_labels(d / f"{stem}.txt") for d in dirs]
        boxes, scores, labels = weighted_boxes_fusion(
            [b for b, _, _ in per_model], [s for _, s, _ in per_model], [c for _, _, c in per_model],
            weights=args.weights, iou_thr=args.iou, skip_box_thr=args.skip_thr,
        )
        with open(out / f"{stem}.txt", "w") as f:
            for (x1, y1, x2, y2), s, c in zip(boxes, scores, labels):
                f.write(f"{int(c)} {(x1 + x2) / 2:.6f} {(y1 + y2) / 2:.6f} {x2 - x1:.6f} {y2 - y1:.6f} {s:.6f}\n")
    LOGGER.info(f"fused labels written to {out}")


if __name__ == "__main__":
    main()
