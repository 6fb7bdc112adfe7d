"""Validation: mAP@.5 and mAP@.5:.95 of a model on a dataset (counterpart
of the root val.py of the JAX package, :35-388).

    python -m yolosomi_tpu_torch.val --data <data yaml> --cfg yolo-somi [--imgsz 640 --batch-size 16]
    torchrun --standalone --nproc-per-node <W> -m yolosomi_tpu_torch.val --shard-spatial <S> --data ... --cfg ...

Pipeline: the ordered, wrap-padded loader -> Runner on the device
(forward, decode, multi-label NMS at conf 0.001 / IoU 0.6 with
max_nms 30000) -> letterbox-inverse rescale on the host -> TP matching at
10 IoU thresholds -> ap_per_class -> the P / R / mAP table, a Speed line
and `metrics.json` in the run directory.

Runs on CUDA unless `device` names another device. Weights come from
`weights` / `--weights` (a `.msgpack` weights file or a `.ckpt` checkpoint,
loaded by the Runner), `variables` (the JAX package's flax variables as
nested numpy dicts), a built `runner`, or none of these (random weights
from seed 0). `compute_loss` (a losses.ComputeLoss) adds the val
losses, the mean [box, obj, cls] of the loss on the eval-mode forward,
as results[4:7]. `int8` evaluates through the int8 convs
(ops/quant.py: calibrated on the first val batch; `int8_exclude` regexes
of flax paths kept in float, `head` meaning the detect head;
`int8_per_channel` per-channel activation scales) under the same eval
protocol. `shard_spatial` S > 1 serves every batch H-sharded over the
process group of W = D x S ranks (engine/runner.py; under torchrun, which
raises without one): every rank loads the same batches and gets the whole
detections, and rank 0 alone logs the table and writes the files. With
`int8` it stays unsharded, as the JAX package's quantized_infer_fn never
uses the spatial mesh. `augment` / `--augment` evaluates with test-time
augmentation (the Runner's TTA under the same protocol, as the JAX
package's val.py:126; sharded too); with `int8` it is not applied, as the
JAX package's quantized_infer_fn has none, and a log line says so. Plots
(matplotlib, ROADMAP queue A item 9) raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from yolosomi_tpu_torch.data.datasets import DataLoader, DetectionDataset
from yolosomi_tpu_torch.engine.runner import Runner
from yolosomi_tpu_torch.ops.quant import quantized_infer_fn
from yolosomi_tpu_torch.utils.boxes import scale_coords, xywh2xyxy
from yolosomi_tpu_torch.utils.cocoeval import COCOEvaluator
from yolosomi_tpu_torch.utils.config import find_config, load_data_cfg
from yolosomi_tpu_torch.utils.general import LOGGER, check_img_size, increment_path, log_rank
from yolosomi_tpu_torch.utils.metrics import ap_per_class, fitness, process_batch


def _greedy_nms_host(rows: np.ndarray, iou_thres: float, max_wh: float | None = None) -> np.ndarray:
    """Greedy class-offset NMS on the host over (n, 6) [xyxy, conf, cls]
    rows, the device path's rule; used only by `save_hybrid`, where the
    ground-truth rows join the pool. It runs after scale_coords, in
    original-image pixels, so the class offset is sized from the data: a
    fixed 4096 would let the classes' regions overlap on images near or
    above 4096 px."""
    if max_wh is None:
        max_wh = max(4096.0, float(rows[:, :4].max()) + 1.0 if len(rows) else 0.0)
    order = np.argsort(-rows[:, 4], kind="stable")
    boxes = rows[order, :4] + rows[order, 5:6] * max_wh
    keep = []
    alive = np.ones(len(rows), bool)
    for i in range(len(rows)):
        if not alive[i]:
            continue
        keep.append(order[i])
        x1 = np.maximum(boxes[i, 0], boxes[i + 1:, 0])
        y1 = np.maximum(boxes[i, 1], boxes[i + 1:, 1])
        x2 = np.minimum(boxes[i, 2], boxes[i + 1:, 2])
        y2 = np.minimum(boxes[i, 3], boxes[i + 1:, 3])
        inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        a = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        b = (boxes[i + 1:, 2] - boxes[i + 1:, 0]) * (boxes[i + 1:, 3] - boxes[i + 1:, 1])
        iou = inter / (a + b - inter + 1e-7)
        alive[i + 1:] &= iou <= iou_thres
    return rows[np.array(keep, int)] if keep else rows[:0]


def _save_one_txt(path: Path, det: np.ndarray, h0w0, save_conf: bool) -> None:
    """Append detections as `cls xc yc w h [conf]`, normalized by the
    original image's shape, %g fields (the format wbf.py fuses)."""
    gn = np.array([h0w0[1], h0w0[0], h0w0[1], h0w0[0]], np.float32)
    with open(path, "a") as f:
        for row in det:
            xyxy = row[:4]
            xywh = np.array([(xyxy[0] + xyxy[2]) / 2, (xyxy[1] + xyxy[3]) / 2,
                             xyxy[2] - xyxy[0], xyxy[3] - xyxy[1]], np.float32) / gn
            line = (int(row[5]), *xywh, row[4]) if save_conf else (int(row[5]), *xywh)
            f.write(" ".join(f"{v:g}" for v in line) + "\n")


def run(
    data,
    weights=None,
    cfg="yolo-somi",
    batch_size=16,
    imgsz=640,
    conf_thres=0.001,
    iou_thres=0.6,
    task="val",
    single_cls=False,
    augment=False,
    save_txt=False,
    save_hybrid=False,
    save_conf=False,
    save_json=False,
    verbose=False,
    project="runs/val",
    name="exp",
    exist_ok=False,
    half=True,
    max_det=300,
    alpha_iou=False,
    plots=False,
    shard_spatial=1,
    int8=False,
    int8_exclude=(),
    int8_per_channel=False,
    device=None,
    variables=None,
    runner: Runner = None,
    dataloader: DataLoader = None,
    names=None,
    compute_loss=None,
):
    """Evaluate and return ((P, R, mAP@.5, mAP@.5:.95, val box, obj, cls
    loss), per-class mAP@.5:.95 (nc,), (pre, inference+NMS, post) ms per
    image); the losses are 0 without `compute_loss`. `half` builds the
    Runner in bf16, else f32; a given `runner` keeps its own."""
    if plots:
        raise NotImplementedError("plots (matplotlib; ROADMAP queue A item 9) are not ported yet")
    t_start = time.time()
    data_dict = load_data_cfg(find_config(data, "data")) if isinstance(data, str) else data
    nc = 1 if single_cls else int(data_dict["nc"])
    names = names or data_dict.get("names", [str(i) for i in range(nc)])

    if runner is None:
        if weights is None and variables is None:
            LOGGER.info("no weights given: random weights from seed 0")
        if int8 and shard_spatial > 1:
            LOGGER.info(f"--int8 serves unsharded: --shard-spatial {shard_spatial} is ignored, as the JAX package's "
                        "quantized_infer_fn never uses the spatial mesh")
            shard_spatial = 1
        runner = Runner(cfg, weights, nc=nc, dtype=torch.bfloat16 if half else torch.float32, imgsz=imgsz,
                        device=device, variables=variables, spatial_shards=shard_spatial)
    imgsz = check_img_size(imgsz, s=runner.stride)
    main_rank = runner.spatial is None or runner.spatial.rank == 0  # sharded: rank 0 alone writes
    if runner.spatial is not None:
        log_rank(runner.spatial.rank)

    save_dir = increment_path(Path(project) / name, exist_ok=exist_ok, mkdir=main_rank)

    if dataloader is None:
        dataset = DetectionDataset(data_dict[task], img_size=imgsz)
        dataloader = DataLoader(dataset, batch_size)

    # the eval protocol: multi-label, exact top-k over max_nms 30000 candidates
    protocol = dict(conf_thres=conf_thres, iou_thres=iou_thres, max_det=max_det, max_nms=30000, multi_label=True,
                    exact=True)
    infer = lambda x: runner(x, augment=augment, **protocol)  # noqa: E731
    if int8:
        if augment:
            LOGGER.info("--int8 evaluates without TTA: --augment is not applied, as the JAX package's "
                        "quantized_infer_fn has no TTA")
        # the same protocol through the int8 convs, so the mAP gap is the
        # quantization's; "head" names the detect head's rows
        exclude = tuple(rf"^layers_{len(runner.model.model) - 1}/" if p == "head" else p for p in int8_exclude)
        infer = quantized_infer_fn(runner, next(iter(dataloader))[0], exclude=exclude,
                                   per_channel=int8_per_channel, **protocol)
    loss_fn_batch = runner.val_loss_fn(compute_loss) if compute_loss is not None else None
    val_losses = np.zeros(3)
    n_loss_batches = 0
    iouv = np.linspace(0.5, 0.95, 10)
    stats = []
    jdict = []  # COCO-format prediction records
    seen = 0
    t_pre = t_inf = t_post = 0.0
    # The loader fills the last batch by wrapping to the start of the
    # dataset, and val iterates in order, so the wrapped images are always
    # the tail of the last batch: count each image once.
    remaining = len(dataloader.dataset)
    for images, targets, paths, shapes in dataloader:
        t0 = time.time()
        x = images  # uint8; normalized on the device
        t1 = time.time()
        out = infer(x)
        if loss_fn_batch is not None:
            val_losses += loss_fn_batch(x, targets)
            n_loss_batches += 1
        t2 = time.time()

        h, w = images.shape[1:3]
        n_real = min(len(paths), remaining)
        remaining -= n_real
        for si in range(n_real):
            seen += 1
            det = out[si]
            det = det[det[:, 4] > 0]
            labs = targets[si]
            labs = labs[labs[:, 0] >= 0]
            tbox = np.zeros((0, 5), np.float32)
            if len(labs):
                tbox = np.concatenate([labs[:, 0:1], xywh2xyxy(labs[:, 1:5] * [w, h, w, h])], 1)
            if shapes[si] is not None:
                (h0, w0), ratio_pad = shapes[si]
                if len(det):
                    det = det.copy()
                    det[:, :4] = scale_coords((h, w), det[:, :4], (h0, w0), ratio_pad)
                if len(tbox):
                    tbox = tbox.copy()
                    tbox[:, 1:5] = scale_coords((h, w), tbox[:, 1:5], (h0, w0), ratio_pad)
            if single_cls:  # one class: detections and labels alike
                det[:, 5] = 0
                tbox[:, 0] = 0
            if save_hybrid and len(tbox):
                # the labels join the pool at conf 1.0, so they sort first,
                # always survive and suppress overlapping predictions of
                # their class; truncated to max_det after they join
                lab_rows = np.concatenate([tbox[:, 1:5], np.ones((len(tbox), 1), np.float32), tbox[:, 0:1]], 1)
                det = _greedy_nms_host(np.concatenate([lab_rows, det], 0).astype(np.float32), iou_thres)[:max_det]
            correct = process_batch(det, tbox, iouv, alpha_iou=alpha_iou)
            stats.append((correct, det[:, 4], det[:, 5], tbox[:, 0]))
            if save_txt and len(det) and main_rank:
                (save_dir / "labels").mkdir(parents=True, exist_ok=True)
                h0w0 = shapes[si][0] if shapes[si] is not None else (h, w)
                _save_one_txt(save_dir / "labels" / (Path(paths[si]).stem + ".txt"), det, h0w0, save_conf)
            if save_json and len(det):
                stem = Path(paths[si]).stem
                image_id = int(stem) if stem.isnumeric() else stem
                for row in det:
                    jdict.append({
                        "image_id": image_id,
                        "category_id": int(row[5]),
                        "bbox": [round(float(v), 3) for v in (row[0], row[1], row[2] - row[0], row[3] - row[1])],
                        "score": round(float(row[4]), 5),
                    })
        t_post += time.time() - t2
        t_inf += t2 - t1
        t_pre += t1 - t0

    stats_np = [np.concatenate(x, 0) for x in zip(*stats)] if stats else []
    mp = mr = map50 = map_ = 0.0
    ap_class = []
    nt = np.zeros(nc)
    if len(stats_np) and stats_np[0].any():
        p, r, ap, f1, ap_class = ap_per_class(*stats_np)
        ap50, ap = ap[:, 0], ap.mean(1)
        mp, mr, map50, map_ = p.mean(), r.mean(), ap50.mean(), ap.mean()
        nt = np.bincount(stats_np[3].astype(int), minlength=nc)

    pf = "%20s" + "%11i" * 2 + "%11.3g" * 4
    LOGGER.info(("%20s" + "%11s" * 6) % ("Class", "Images", "Labels", "P", "R", "mAP@.5", "mAP@.5:.95"))
    LOGGER.info(pf % ("all", seen, nt.sum(), mp, mr, map50, map_))
    if len(ap_class) and nc > 1 and (verbose or nc < 50):
        for i, c in enumerate(ap_class):
            LOGGER.info(pf % (names[c] if c < len(names) else c, seen, nt[c], p[i], r[i], ap50[i], ap[i]))

    spd = tuple(x / max(seen, 1) * 1000 for x in (t_pre, t_inf, t_post))
    LOGGER.info("Speed: %.1fms pre, %.1fms inference+NMS, %.1fms post per image" % spd)

    if save_json and jdict and main_rank:
        pred_json = save_dir / "predictions.json"
        pred_json.write_text(json.dumps(jdict))
        LOGGER.info(f"COCO JSON: {pred_json} ({len(jdict)} detections)")
        ann_json = data_dict.get("annotations")
        if ann_json and Path(str(ann_json)).exists():
            ev = COCOEvaluator.from_files(str(ann_json), str(pred_json)).accumulate()
            coco_stats = ev.summarize(log=LOGGER.info)
            map_, map50 = float(coco_stats[0]), float(coco_stats[1])

    maps = np.zeros(nc) + map_
    for i, c in enumerate(ap_class):
        maps[int(c)] = ap[i]
    vb, vo, vc = (val_losses / max(n_loss_batches, 1)).tolist()
    results = (mp, mr, map50, map_, vb, vo, vc)
    fi = float(fitness(np.array(results[:4])))
    LOGGER.info(f"fitness: {fi:.4f} ({time.time() - t_start:.1f}s)")
    if not main_rank:
        return results, maps, spd
    (save_dir / "metrics.json").write_text(json.dumps({
        "P": float(mp), "R": float(mr), "mAP50": float(map50), "mAP": float(map_),
        "fitness": fi, "images": int(seen),
        "speed_ms": {"pre": spd[0], "inference_nms": spd[1], "post": spd[2]},
        "int8": bool(int8), "imgsz": int(imgsz), "cfg": str(cfg),
    }))
    return results, maps, spd


def parse_opt(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", type=str, default="visdrone")
    parser.add_argument("--weights", type=str, default=None, help="a .msgpack weights file or a .ckpt checkpoint")
    parser.add_argument("--cfg", type=str, default="yolo-somi")
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--imgsz", "--img", "--img-size", type=int, default=640)
    parser.add_argument("--conf-thres", type=float, default=0.001)
    parser.add_argument("--iou-thres", type=float, default=0.6)
    parser.add_argument("--task", default="val", help="train, val, test, speed or study")
    parser.add_argument("--single-cls", action="store_true")
    parser.add_argument("--augment", action="store_true", help="TTA inference")
    parser.add_argument("--save-txt", action="store_true")
    parser.add_argument("--save-hybrid", action="store_true",
                        help="merge ground-truth labels into the NMS pool (autolabelling)")
    parser.add_argument("--save-conf", action="store_true", help="append confidence to --save-txt rows")
    parser.add_argument("--save-json", action="store_true")
    parser.add_argument("--verbose", action="store_true", help="per-class metric rows regardless of class count")
    parser.add_argument("--project", default="runs/val")
    parser.add_argument("--name", default="exp")
    parser.add_argument("--exist-ok", action="store_true")
    parser.add_argument("--half", action=argparse.BooleanOptionalAction, default=True,
                        help="bf16 (default) or, with --no-half, f32")
    parser.add_argument("--device", type=str, default="cuda", help="torch device: cuda, cuda:1 or cpu")
    parser.add_argument("--alpha-iou", action="store_true")
    parser.add_argument("--int8", action="store_true", help="int8 eval (calibrates on the first val batch)")
    parser.add_argument("--int8-exclude", nargs="+", default=[], metavar="REGEX",
                        help="flax path regexes kept in float under --int8 ('head' = the detect head)")
    parser.add_argument("--int8-per-channel", action="store_true",
                        help="per-channel activation scales under --int8")
    parser.add_argument("--shard-spatial", type=int, default=1,
                        help="H-strips a batch is split into, one a rank (run under torchrun with a multiple of it)")
    parser.add_argument("--plots", action="store_true", help="PR curves and confusion matrix (not ported yet)")
    return parser.parse_args(argv)


def main(opt):
    opts = vars(opt).copy()
    task = opts.get("task", "val")
    if task in ("train", "val", "test"):
        return run(**opts)
    if task == "speed":
        # the speed protocol: serving thresholds, no JSON, no plots
        opts.update(task="val", conf_thres=0.25, iou_thres=0.45, save_json=False, plots=False)
        return run(**opts)
    if task == "study":
        # accuracy against image size, 256-1536 px
        results = []
        for imgsz in range(256, 1536 + 128, 128):
            LOGGER.info(f"study: imgsz {imgsz}")
            r, _, spd = run(**dict(opts, task="val", imgsz=imgsz, plots=False))
            results.append([imgsz, *r[:4], *spd])
        out = Path(f"study_{Path(str(opts['data'])).stem}_{opts['cfg']}.txt".replace("/", "_"))
        np.savetxt(out, np.array(results), fmt="%10.4g")
        LOGGER.info(f"study results saved to {out}")
        return results
    raise ValueError(f"unknown task {task}")


if __name__ == "__main__":
    main(parse_opt())
