"""The user API: Detections, AutoShape, the hub loader and the
second-stage classifier over Detections (counterpart of
yolosomi_tpu/api.py:20-189; the reference's common.py:2119-2318 and
hubconf.py:13).

    from yolosomi_tpu_torch import api
    model = api.load("yolo-somi", "somi.msgpack")   # on CUDA; device="cpu" to run on the CPU
    results = model(["img1.jpg", "img2.jpg"])
    print(results); results.save("runs/detect")

AutoShape sends the letterboxed batch to the Runner as uint8, which is
normalized on the device: a quarter of the float32 upload the JAX AutoShape
makes, and the same input to the model (Runner.upload).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Union

import cv2
import numpy as np

from yolosomi_tpu_torch.data.augment import letterbox
from yolosomi_tpu_torch.engine.runner import Runner
from yolosomi_tpu_torch.utils.boxes import scale_coords
from yolosomi_tpu_torch.utils.classifier import logits_to_numpy

RECORD_KEYS = ("xmin", "ymin", "xmax", "ymax", "confidence", "class", "name")


class Detections:
    """Inference results: per image an (n, 6) [x1, y1, x2, y2, conf, cls]
    array in the image's own pixels, with print, records, pandas, crop and
    save."""

    def __init__(self, ims: List[np.ndarray], pred: List[np.ndarray], files: List[str], names: List[str]):
        self.ims = ims
        self.pred = pred
        self.files = files
        self.names = names
        self.n = len(pred)

    def __len__(self):
        return self.n

    def _name(self, c) -> str:
        c = int(c)
        return self.names[c] if c < len(self.names) else str(c)

    def __repr__(self):
        lines = []
        for i, det in enumerate(self.pred):
            s = f"image {i + 1}/{self.n} {self.files[i]}: "
            if len(det) == 0:
                s += "(no detections)"
            for c in np.unique(det[:, 5].astype(int)):
                n = int((det[:, 5] == c).sum())
                s += f"{n} {self._name(c)}{'s' * (n > 1)}, "
            lines.append(s.rstrip(", "))
        return "\n".join(lines)

    def records(self) -> List[List[dict]]:
        """Per image, one dict per detection with the keys of RECORD_KEYS,
        as `pandas()[i].to_dict(orient="records")` gives them (Python
        floats, an int class, a str name), without pandas."""
        return [[dict(zip(RECORD_KEYS, (*(float(v) for v in box), float(conf), int(c), self._name(c))))
                 for *box, conf, c in det] for det in self.pred]

    def pandas(self):
        """Per-image DataFrames with the columns of RECORD_KEYS."""
        import pandas as pd

        return [pd.DataFrame([[*box, conf, int(c), self._name(c)] for *box, conf, c in det], columns=list(RECORD_KEYS))
                for det in self.pred]

    def crop(self, save_dir: str = "runs/crops"):
        """Write each detection's crop to save_dir/<class name>/ and return
        them; boxes thinner than a pixel have none."""
        save_dir = Path(save_dir)
        crops = []
        for im, det, f in zip(self.ims, self.pred, self.files):
            for j, (*box, conf, c) in enumerate(det):
                x1, y1, x2, y2 = (int(v) for v in box)
                crop = im[max(y1, 0):y2, max(x1, 0):x2]
                if crop.size == 0:  # a box thinner than a pixel
                    continue
                d = save_dir / self._name(c)
                d.mkdir(parents=True, exist_ok=True)
                cv2.imwrite(str(d / f"{Path(f).stem}_{j}.jpg"), crop)
                crops.append(crop)
        return crops

    def save(self, save_dir: str = "runs/detect"):
        """Write each image with its boxes drawn to save_dir."""
        from yolosomi_tpu_torch.detect import COLORS, draw_box

        save_dir = Path(save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)
        for im, det, f in zip(self.ims, self.pred, self.files):
            im = im.copy()
            for *box, conf, c in det:
                draw_box(im, box, f"{self._name(c)} {conf:.2f}", COLORS[int(c) % len(COLORS)])
            cv2.imwrite(str(save_dir / Path(f).name), im)
        return save_dir

    @property
    def xyxy(self):
        return self.pred


class AutoShape:
    """Takes file paths, numpy HWC BGR images (grey ones are stacked to
    three channels) or a list of them; letterboxes them to `imgsz`, runs
    them as one batch and maps the boxes back to each image's pixels."""

    def __init__(self, runner: Runner, imgsz: int = 640, conf: float = 0.25, iou: float = 0.45,
                 names: Optional[List[str]] = None):
        self.runner = runner
        self.imgsz = imgsz
        self.conf = conf
        self.iou = iou
        self.names = names or runner.names

    def __call__(self, ims: Union[str, np.ndarray, Sequence], size: Optional[int] = None) -> Detections:
        size = size or self.imgsz
        if not isinstance(ims, (list, tuple)):
            ims = [ims]
        raw, files = [], []
        for i, im in enumerate(ims):
            if isinstance(im, (str, Path)):
                files.append(str(im))
                im = cv2.imread(str(im))
                if im is None:
                    raise FileNotFoundError(f"image not found {files[-1]}")
            else:
                files.append(f"image{i}.jpg")
                im = np.asarray(im)
                if im.ndim == 2:
                    im = np.stack([im] * 3, -1)
            raw.append(im)

        batch, meta = [], []
        for im in raw:
            lb, ratio, pad = letterbox(im, size, auto=False)
            batch.append(lb)
            meta.append((im.shape[:2], (ratio, pad)))
        x = np.stack(batch, 0)  # uint8, normalized on the device
        out = self.runner(x, conf_thres=self.conf, iou_thres=self.iou, max_det=300)
        pred = []
        for det, ((h0, w0), ratio_pad) in zip(out, meta):
            det = det[det[:, 4] > 0]
            if len(det):
                det = det.copy()
                det[:, :4] = scale_coords(x.shape[1:3], det[:, :4], (h0, w0), ratio_pad)
            pred.append(det)
        return Detections(raw, pred, files, self.names)


def load(cfg: str = "yolo-somi", weights: Optional[str] = None, nc: Optional[int] = None, imgsz: int = 640,
         conf: float = 0.25, iou: float = 0.45, names: Optional[List[str]] = None, autoshape: bool = True,
         device=None):
    """The hub loader: a Runner of `cfg` with `weights` (a `.msgpack` or
    `.ckpt`; random weights from seed 0 when None or missing), on CUDA
    unless `device` names another device, wrapped in AutoShape unless
    `autoshape` is False."""
    runner = Runner(cfg, weights, nc=nc, imgsz=imgsz, device=device)
    if autoshape:
        return AutoShape(runner, imgsz=imgsz, conf=conf, iou=iou, names=names)
    return runner


def apply_classifier(detections: Detections, classifier, imgsz: int = 224) -> Detections:
    """Re-label with a second-stage classifier: each box's crop, resized to
    imgsz, goes through `classifier` ((N, imgsz, imgsz, 3) float32 in
    [0, 1] -> (N, n_classes) logits), and detections whose argmax disagrees
    with their class are dropped, in place."""
    for i, (im, det) in enumerate(zip(detections.ims, detections.pred)):
        if len(det) == 0:
            continue
        crops = []
        for x1, y1, x2, y2, *_ in det:
            crop = im[max(int(y1), 0):int(y2), max(int(x1), 0):int(x2)]
            if crop.size == 0:
                crop = np.zeros((imgsz, imgsz, 3), np.uint8)
            crops.append(cv2.resize(crop, (imgsz, imgsz)))
        logits = logits_to_numpy(classifier(np.stack(crops).astype(np.float32) / 255.0))
        keep = logits.argmax(1) == det[:, 5].astype(int)
        detections.pred[i] = det[keep]
    return detections
