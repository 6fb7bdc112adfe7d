"""Inference CLI (counterpart of the root detect.py of the JAX package,
:52-241; the reference's detect.py).

    python -m yolosomi_tpu_torch.detect --weights somi.msgpack --source <images, dir, glob or video> \
        [--save-txt --save-conf --save-crop] [--device cpu]
    torchrun --standalone --nproc-per-node <W> -m yolosomi_tpu_torch.detect --shard-spatial <S> --weights ... --source ...

Each image (or video frame) is letterboxed, run through the Runner (one
checkpoint) or the EnsembleRunner (several) at batch 1, and its boxes are
mapped back to the original frame: labels/*.txt (`cls xc yc w h [conf]`,
normalized, %g), crops, and annotated images or an .mp4 per video go to
the run directory. The reference's defaults: conf 0.4, IoU 0.2.

Runs on CUDA unless `--device` names another device. `--shard-spatial` S
> 1 serves each frame H-sharded over the process group of W = D x S ranks
(engine/runner.py; under torchrun, which raises without one; several
weights serve unsharded, as in the JAX package): every rank reads the same
frames and gets the whole detections, and rank 0 alone logs and writes.
`--augment` serves each frame with test-time augmentation (the Runner's
TTA; sharded too). `--classify cfg[:weights]` builds a second-stage
classifier from a headless config (classifier.yaml's Classify tail; random
weights from seed 0 without a weights file) as a Runner at 224 px, bf16,
on the same device, and keeps the detections whose crop it classifies
alike; `run` also takes any callable classifier. Feature maps
(`--visualize`, ROADMAP queue A item 9(b)) raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import cv2
import numpy as np

from yolosomi_tpu_torch.data.datasets import LoadImages
from yolosomi_tpu_torch.engine.runner import Runner, attempt_load
from yolosomi_tpu_torch.utils.boxes import scale_coords, xyxy2xywhn
from yolosomi_tpu_torch.utils.classifier import apply_classifier
from yolosomi_tpu_torch.utils.config import find_config, load_data_cfg
from yolosomi_tpu_torch.utils.general import LOGGER, increment_path, log_rank

COLORS = [(56, 56, 255), (151, 157, 255), (31, 112, 255), (29, 178, 255), (49, 210, 207),
          (10, 249, 72), (23, 204, 146), (134, 219, 61), (52, 147, 26), (187, 212, 0),
          (168, 153, 44), (255, 194, 0), (147, 69, 52), (255, 115, 100), (236, 24, 0),
          (255, 56, 132), (133, 0, 82), (255, 56, 203), (200, 149, 255), (199, 55, 255)]


def draw_box(im, box, label: str, color, lw: int = 2):
    """Draw one box and its label on `im` in place. `lw` is the line width;
    the label's font scales with it (thickness max(lw - 1, 1), scale
    lw / 4), as the reference's plot_one_box does."""
    p1, p2 = (int(box[0]), int(box[1])), (int(box[2]), int(box[3]))
    cv2.rectangle(im, p1, p2, color, lw, lineType=cv2.LINE_AA)
    if label:
        tf = max(lw - 1, 1)
        fs = lw / 4.0
        w, h = cv2.getTextSize(label, 0, fontScale=fs, thickness=tf)[0]
        outside = p1[1] - h - 3 >= 0
        p2 = p1[0] + w, p1[1] - h - 3 if outside else p1[1] + h + 3
        cv2.rectangle(im, p1, p2, color, -1, cv2.LINE_AA)
        cv2.putText(im, label, (p1[0], p1[1] - 2 if outside else p1[1] + h + 2), 0, fs,
                    (255, 255, 255), tf, cv2.LINE_AA)


def label_line(cls: int, xyxy, shape0, conf=None) -> str:
    """One labels/*.txt row: `cls xc yc w h [conf]`, normalized by the
    original frame's (h, w), each field %g."""
    xywh = xyxy2xywhn(np.asarray(xyxy)[None], w=shape0[1], h=shape0[0])[0]
    line = (cls, *xywh) if conf is None else (cls, *xywh, conf)
    return ("%g " * len(line)).rstrip() % line


def run(
    weights="somi.msgpack",
    cfg="yolo-somi",
    source="data/images",
    imgsz=640,
    conf_thres=0.4,
    iou_thres=0.2,
    max_det=300,
    save_txt=False,
    save_conf=False,
    save_crop=False,
    nosave=False,
    classes=None,
    agnostic_nms=False,
    project="runs/detect",
    name="exp",
    exist_ok=False,
    line_thickness=2,
    hide_labels=False,
    hide_conf=False,
    names=None,
    data=None,
    augment=False,
    visualize=False,
    classify=None,
    shard_spatial=1,
    device=None,
):
    """Detect on every image and frame of `source`; returns the run directory."""
    if visualize:
        raise NotImplementedError("feature-map plots (visualize; ROADMAP queue A item 9(b)) are not ported yet")
    if names is None and data:
        names = load_data_cfg(find_config(data, "data")).get("names")
    save_img = not nosave
    if "*" not in str(source) and not Path(source).exists():  # before the model is built
        raise FileNotFoundError(f"source {source} does not exist")
    if isinstance(classify, str):  # "cfg" or "cfg:weights": a Classify-tail model, as the JAX package's detect.py:84-95
        ccfg, _, cweights = classify.partition(":")
        classify = Runner(ccfg, cweights or None, imgsz=224, device=device)
    runner = attempt_load(weights, cfg, imgsz=imgsz, device=device, spatial_shards=shard_spatial)
    sharded = getattr(runner, "spatial", None)
    main_rank = sharded is None or sharded.rank == 0
    if not main_rank:  # rank 0 alone logs and writes
        log_rank(sharded.rank)
        save_img = save_txt = save_crop = False
    save_dir = increment_path(Path(project) / name, exist_ok=exist_ok, mkdir=main_rank)
    if main_rank:
        (save_dir / "labels" if save_txt else save_dir).mkdir(parents=True, exist_ok=True)

    names = names or runner.names
    dataset = LoadImages(source, img_size=imgsz, stride=runner.stride, auto=False)
    cls_mask = None
    if classes is not None:
        cls_mask = np.zeros(runner.meta.nc, bool)
        cls_mask[classes] = True

    def name_of(c: int) -> str:
        return names[c] if c < len(names) else str(c)

    t_pre = t_inf = 0.0
    seen = 0
    vid_writer = None
    t_start = time.time()
    for path, img, im0, cap in dataset:
        t0 = time.time()
        x = img[None]  # uint8; normalized on the device
        t1 = time.time()
        det = runner(x, conf_thres=conf_thres, iou_thres=iou_thres, agnostic=agnostic_nms, max_det=max_det,
                     classes=cls_mask, augment=augment)[0]
        t2 = time.time()
        t_pre += t1 - t0
        t_inf += t2 - t1
        seen += 1

        det = det[det[:, 4] > 0]
        if len(det):
            det[:, :4] = scale_coords(img.shape[:2], det[:, :4], im0.shape[:2])
        if classify is not None and len(det):
            det = apply_classifier(det, classify, im0)
        p = Path(path)
        s = f"{p.name}: {img.shape[1]}x{img.shape[0]} "
        for c in np.unique(det[:, 5].astype(int)) if len(det) else []:
            s += f"{(det[:, 5] == c).sum()} {name_of(int(c))}, "
        LOGGER.info(f"{s}({(t2 - t1) * 1000:.1f}ms)")

        if save_txt and len(det):
            with open(save_dir / "labels" / f"{p.stem}.txt", "a") as f:
                for *xyxy, conf, c in det:
                    f.write(label_line(int(c), xyxy, im0.shape, conf if save_conf else None) + "\n")
        for *xyxy, conf, c in det:
            c = int(c)
            if save_img or save_crop:
                label = None if hide_labels else (name_of(c) if hide_conf else f"{name_of(c)} {conf:.2f}")
                draw_box(im0, xyxy, label, COLORS[c % len(COLORS)], lw=line_thickness)
            x1, y1, x2, y2 = (int(v) for v in xyxy)
            if save_crop and x2 > max(x1, 0) and y2 > max(y1, 0):  # a box thinner than a pixel crops nothing
                crop_dir = save_dir / "crops" / name_of(c)
                crop_dir.mkdir(parents=True, exist_ok=True)
                cv2.imwrite(str(crop_dir / f"{p.stem}.jpg"), im0[max(y1, 0):y2, max(x1, 0):x2])

        if save_img:
            if dataset.mode == "image":
                cv2.imwrite(str(save_dir / p.name), im0)
            else:
                if vid_writer is None:
                    fps = cap.get(cv2.CAP_PROP_FPS) or 30
                    vid_writer = cv2.VideoWriter(str(save_dir / (p.stem + ".mp4")), cv2.VideoWriter_fourcc(*"mp4v"),
                                                 fps, (im0.shape[1], im0.shape[0]))
                vid_writer.write(im0)
    if vid_writer is not None:
        vid_writer.release()
    wall = time.time() - t_start
    LOGGER.info(
        f"Speed: {t_pre / max(seen, 1) * 1000:.1f}ms pre, {t_inf / max(seen, 1) * 1000:.1f}ms "
        f"inference+NMS per image; {seen / max(wall, 1e-9):.1f} img/s; results saved to {save_dir}"
    )
    return save_dir


def parse_opt(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--weights", type=str, nargs="+", default="somi.msgpack",
                        help="checkpoint path(s); several -> ensemble inference")
    parser.add_argument("--cfg", type=str, default="yolo-somi")
    parser.add_argument("--source", type=str, default="data/images")
    parser.add_argument("--imgsz", "--img", "--img-size", type=int, default=640)
    parser.add_argument("--conf-thres", type=float, default=0.4)
    parser.add_argument("--iou-thres", type=float, default=0.2)
    parser.add_argument("--max-det", type=int, default=300)
    parser.add_argument("--save-txt", action="store_true")
    parser.add_argument("--save-conf", action="store_true")
    parser.add_argument("--save-crop", action="store_true")
    parser.add_argument("--nosave", action="store_true")
    parser.add_argument("--classes", nargs="+", type=int)
    parser.add_argument("--agnostic-nms", action="store_true")
    parser.add_argument("--project", default="runs/detect")
    parser.add_argument("--name", default="exp")
    parser.add_argument("--exist-ok", action="store_true")
    parser.add_argument("--device", type=str, default="cuda", help="torch device: cuda, cuda:1 or cpu")
    parser.add_argument("--shard-spatial", type=int, default=1,
                        help="H-strips a frame is split into, one a rank (run under torchrun with a multiple of it)")
    parser.add_argument("--hide-labels", action="store_true")
    parser.add_argument("--hide-conf", action="store_true")
    parser.add_argument("--line-thickness", type=int, default=2, help="annotation box line width (px)")
    parser.add_argument("--data", type=str, default=None, help="data yaml for class names")
    parser.add_argument("--classify", type=str, default=None,
                        help="second-stage classifier: a headless config and its weights, cfg[:weights]")
    parser.add_argument("--augment", action="store_true", help="TTA inference")
    parser.add_argument("--visualize", action="store_true", help="save feature-map grids (not ported yet)")
    return parser.parse_args(argv)


def main(opt):
    return run(**vars(opt))


if __name__ == "__main__":
    main(parse_opt())
