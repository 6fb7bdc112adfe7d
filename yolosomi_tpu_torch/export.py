"""Export CLI (counterpart of the JAX package's root export.py, :162-309).

    python -m yolosomi_tpu_torch.export --weights somi.msgpack --cfg yolo-somi [--include torchscript onnx] \
        [--imgsz 640 --batch-size 1 --opset 12 --dynamic] [--project runs/export --name exp] [--device cpu]

The model is loaded through the Runner in float32 (a `.msgpack` / `.ckpt`
of either package; random weights from seed 0 without one) on the device
(CUDA unless `--device` names another) and exported by
utils/onnx_export.py from the port's own modules: `model.torchscript` and
`model.onnx` in the run directory, each the model and its decode at
(batch, 3, imgsz, imgsz), traced under plain_version(). An artifact runs
on the device it was traced on. `--dynamic` makes ONNX's batch axis
dynamic, and raises ValueError for a graph with ODConv, whose trace fixes
the batch. The JAX package's other formats (saved_model, pb, tflite,
tfjs, coreml and stablehlo, JAX's own IR) are not ported (ROADMAP queue A
item 9(c)) and raise NotImplementedError; NMS is not embedded in these
artifacts, so `--nms` raises ValueError.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from yolosomi_tpu_torch.engine.runner import Runner
from yolosomi_tpu_torch.utils.general import LOGGER, increment_path
from yolosomi_tpu_torch.utils.onnx_export import export_onnx, export_torchscript, onnx_summary

FORMATS = ("torchscript", "onnx")
NOT_PORTED = ("saved_model", "pb", "tflite", "tfjs", "coreml", "stablehlo")


def run(weights=None, cfg="yolo-somi", imgsz=640, batch_size=1, include=FORMATS, nms=False, opset=12, dynamic=False,
        project="runs/export", name="exp", device="cuda"):
    """Export the formats in `include`; returns the paths written."""
    unknown = sorted(set(include) - set(FORMATS) - set(NOT_PORTED))
    if unknown:
        raise ValueError(f"unknown formats {unknown}; choose from {FORMATS + NOT_PORTED}")
    not_ported = [f for f in include if f in NOT_PORTED]
    if not_ported:
        raise NotImplementedError(f"{', '.join(not_ported)} export is not ported (ROADMAP queue A item 9(c)); the "
                                  f"port exports {' and '.join(FORMATS)}")
    if nms:
        raise ValueError("--nms: TorchScript and ONNX artifacts end at the decoded rows; NMS is not embedded")
    t0 = time.time()
    save_dir = increment_path(Path(project) / name, mkdir=True)
    runner = Runner(cfg, weights, dtype=torch.float32, imgsz=imgsz, device=device)
    outputs = []
    if "torchscript" in include:
        t1, out = time.time(), save_dir / "model.torchscript"
        export_torchscript(runner.model, runner.meta, out, imgsz=imgsz, batch=batch_size)
        LOGGER.info(f"TorchScript: {out} ({out.stat().st_size / 1e6:.1f} MB in {time.time() - t1:.1f}s, runs on "
                    f"{runner.device})")
        outputs.append(out)
    if "onnx" in include:
        t1, out = time.time(), save_dir / "model.onnx"
        export_onnx(runner.model, runner.meta, out, imgsz=imgsz, batch=batch_size, opset=opset, dynamic_batch=dynamic)
        secs = time.time() - t1
        s = onnx_summary(out)
        LOGGER.info(f"ONNX: {out} ({out.stat().st_size / 1e6:.1f} MB in {secs:.1f}s; opset {s['opset']}, "
                    f"{s['n_nodes']} nodes, {s['n_initializers']} initializers, ops {sorted(s['ops'])})")
        outputs.append(out)
    LOGGER.info(f"export complete ({time.time() - t0:.1f}s): {[str(o) for o in outputs]}")
    return outputs


def parse_opt(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--weights", type=str, default=None, help="a .msgpack weights file or a .ckpt checkpoint")
    parser.add_argument("--cfg", type=str, default="yolo-somi")
    parser.add_argument("--imgsz", "--img", "--img-size", type=int, default=640)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--include", nargs="+", default=list(FORMATS), help=f"of {FORMATS} (the others raise)")
    parser.add_argument("--nms", action="store_true", help="not supported by these formats: raises")
    parser.add_argument("--opset", type=int, default=12, help="ONNX opset version")
    parser.add_argument("--dynamic", action="store_true", help="ONNX dynamic batch axis")
    parser.add_argument("--project", default="runs/export")
    parser.add_argument("--name", default="exp")
    parser.add_argument("--device", type=str, default="cuda", help="torch device: cuda, cuda:1 or cpu")
    return parser.parse_args(argv)


def main(opt):
    return run(**vars(opt))


if __name__ == "__main__":
    main(parse_opt())
