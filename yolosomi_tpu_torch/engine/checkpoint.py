"""Checkpoint files: read and write the JAX package's `.msgpack` weights
and `.ckpt` checkpoints (counterparts of yolosomi_tpu/engine/checkpoint.py
:95, :201-254), through the port's own msgpack codec (utils/msgpack.py).

A weights-only file is `{params, batch_stats[, anchors]}`; a full
checkpoint adds `ema_params`, `ema_batch_stats`, `opt_state`, `epoch` and
the rest of the training state. Loading a full checkpoint gives its EMA
weights (the reference's attempt_load contract). `anchors`, when present,
are the per-level pixel anchors a run refined with autoanchor: they
override the config's. The training-side save (`build_checkpoint_payload`,
`AsyncCheckpointer`) waits for ROADMAP queue A item 5.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from yolosomi_tpu_torch.utils.msgpack import msgpack_restore, msgpack_serialize


def load_checkpoint(path) -> dict:
    """The whole tree of a `.msgpack` or `.ckpt` file."""
    return msgpack_restore(Path(path).read_bytes())


def checkpoint_variables(ckpt: dict, ema: bool = True) -> dict:
    """EMA weights when the checkpoint has them, else the raw model's."""
    if ema and ckpt.get("ema_params"):
        return {"params": ckpt["ema_params"], "batch_stats": ckpt.get("ema_batch_stats", {})}
    return {"params": ckpt["params"], "batch_stats": ckpt.get("batch_stats", {})}


def load_artifact(path):
    """(flax variables, anchors (nl, na, 2) float32 or None) of a weights
    file or a full checkpoint (whose EMA weights are taken)."""
    obj = load_checkpoint(path)
    anchors = obj.get("anchors")
    anchors = np.asarray(anchors, np.float32) if anchors is not None else None
    if "ema_params" in obj:
        return checkpoint_variables(obj), anchors
    return {"params": obj["params"], "batch_stats": obj.get("batch_stats", {})}, anchors


def load_variables(path) -> dict:
    return load_artifact(path)[0]


def save_variables(path, variables: dict, meta_dict: Optional[dict] = None, anchors=None) -> None:
    """Write a weights-only file. Leaves are numpy arrays or torch tensors
    (a torch.bfloat16 tensor is written as a bfloat16 leaf); `meta_dict`
    goes to a `.json` beside it."""
    payload = {"params": variables["params"], "batch_stats": variables.get("batch_stats", {})}
    if anchors is not None:
        payload["anchors"] = np.asarray(anchors, np.float32)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(msgpack_serialize(payload))
    if meta_dict is not None:
        path.with_suffix(".json").write_text(json.dumps(meta_dict, default=str, indent=1))


def _to_bf16(tree):
    """Every floating array leaf as a torch.bfloat16 tensor (rounded to
    nearest even, as jnp's astype rounds); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _to_bf16(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and np.issubdtype(tree.dtype, np.floating):
        return torch.tensor(tree).to(torch.bfloat16)  # a copy: arrays read from a file are read-only
    return tree


def strip_checkpoint(path, out_path=None, half: bool = True) -> None:
    """EMA -> model, optimizer dropped, floating leaves cast to bfloat16
    unless `half` is False; anchors kept (the reference's strip_optimizer)."""
    ckpt = load_checkpoint(path)
    variables = checkpoint_variables(ckpt, ema=True)
    if half:
        variables = _to_bf16(variables)
    save_variables(out_path or path, variables, anchors=ckpt.get("anchors"))
