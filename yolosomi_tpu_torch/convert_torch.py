"""A reference PyTorch checkpoint -> a weights file of the port (counterpart
of the JAX package's tools/convert_torch.py).

    python -m yolosomi_tpu_torch.convert_torch --pt yolov5s.pt --cfg yolov5s [--nc 80] [--out yolov5s.msgpack] \
        [--device cpu]

The checkpoint's `ema` entry is taken first, then `model`, then the file
as a bare state dict. Its head's `anchors` buffer, when it has one,
replaces the config's anchors. The model is built from `--cfg` on the
device (CUDA unless `--device` names another), its weights filled by
utils/torch_convert.py, and written as a `.msgpack` with a `.json` beside
it holding `cfg`, `nc` and `anchors_px`: the bytes the JAX package's
converter writes, which either package loads (the port's loaders take the
anchors from the `.json`).

A checkpoint that pickles whole modules (the reference's own `.pt` files)
unpickles only where the reference's `models` package is importable, in
this package as in the JAX package; a state dict saved with
`torch.save(model.state_dict())` needs nothing.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from yolosomi_tpu_torch.engine.checkpoint import save_variables
from yolosomi_tpu_torch.models.yolo import build_model, parse_model
from yolosomi_tpu_torch.utils.config import find_config, load_model_cfg
from yolosomi_tpu_torch.utils.general import LOGGER
from yolosomi_tpu_torch.utils.torch_convert import anchors_from_state_dict, convert_state_dict
from yolosomi_tpu_torch.utils.weights import export_jax_variables


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def load_torch_state_dict(pt_path) -> Dict[str, np.ndarray]:
    """The state dict of a reference checkpoint as numpy arrays: its `ema`
    entry, else its `model` entry, else the file itself; a module is taken
    as its float state dict."""
    try:
        ckpt = torch.load(pt_path, map_location="cpu", weights_only=False)
    except ModuleNotFoundError as e:
        raise ModuleNotFoundError(f"{pt_path} pickles whole modules, which unpickle only where the reference's "
                                  f"`models` package is importable ({e}); save its state_dict() instead") from e
    obj = (ckpt.get("ema") or ckpt.get("model") or ckpt) if isinstance(ckpt, dict) else ckpt
    if hasattr(obj, "state_dict"):
        sd = obj.float().state_dict()
    elif isinstance(obj, dict):
        sd = obj
    else:
        raise TypeError(f"unsupported checkpoint object {type(obj)}")
    return {k: _numpy(v) for k, v in sd.items()}


def convert(pt, cfg: str, nc=None, out=None, device=None) -> Path:
    """Convert the checkpoint `pt` for the config `cfg`; returns the
    `.msgpack` written (`out`, else `pt` with that suffix)."""
    sd = load_torch_state_dict(pt)
    cfg_dict = load_model_cfg(find_config(cfg))
    with torch.device("meta"):  # the strides only; nothing is allocated
        strides = parse_model(cfg_dict)[1].strides
    anchors_px = anchors_from_state_dict(sd, strides)
    anchors = anchors_px.reshape(len(anchors_px), -1).tolist() if anchors_px is not None else None
    model, meta = build_model(cfg_dict, nc=nc, device=device, anchors=anchors)
    variables = convert_state_dict(sd, export_jax_variables(model))
    out = Path(out or Path(pt).with_suffix(".msgpack"))
    save_variables(out, variables, meta_dict={"cfg": cfg, "nc": meta.nc, "anchors_px": meta.anchors_px.tolist()})
    LOGGER.info(f"wrote {out}")
    return out


def parse_opt(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--pt", required=True, help="a reference checkpoint or state dict (.pt)")
    parser.add_argument("--cfg", required=True, help="model yaml name or path")
    parser.add_argument("--nc", type=int, default=None)
    parser.add_argument("--out", default=None, help="the .msgpack to write (default: --pt's with that suffix)")
    parser.add_argument("--device", type=str, default="cuda", help="torch device: cuda, cuda:1 or cpu")
    return parser.parse_args(argv)


def main(opt):
    return convert(opt.pt, opt.cfg, nc=opt.nc, out=opt.out, device=opt.device)


if __name__ == "__main__":
    main(parse_opt())
