"""Checkpoint files: read and write the JAX package's `.msgpack` weights
and `.ckpt` checkpoints (counterparts of yolosomi_tpu/engine/checkpoint.py
:95, :201-254), through the port's own msgpack codec (utils/msgpack.py).

A weights-only file is `{params, batch_stats[, anchors]}`; a full
checkpoint adds `ema_params`, `ema_batch_stats`, `opt_state`, `epoch` and
the rest of the training state. Loading a full checkpoint gives its EMA
weights (the reference's attempt_load contract). `anchors`, when present,
are the per-level pixel anchors a run refined with autoanchor: they
override the config's.

The training side (:33-162) writes the JAX package's layout: `epoch`,
`best_fitness`, `anchors`, `params`, `batch_stats`, `ema_params`,
`ema_batch_stats`, `ema_updates`, `step` and `opt_state` as flax's
`to_state_dict` gives YoloOptState (`step`, `momentum_buf`, `adam_mu`,
`adam_nu`, the buffers as flax `params` trees), so either package resumes
from the other's file. Files are replaced atomically. AsyncCheckpointer
writes on one background thread; the copy to the host happens in `save`,
because the train state is updated in place by the next step.
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from yolosomi_tpu_torch.utils.msgpack import msgpack_restore, msgpack_serialize
from yolosomi_tpu_torch.utils.weights import (export_jax_variables, export_param_tree, import_param_tree,
                                              load_jax_variables, without_adapters)


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
    file or a full checkpoint (whose EMA weights are taken). A file without
    anchors takes the `anchors_px` of the `.json` beside it, where there is
    one: a converted reference state dict's (convert_torch.py writes them
    there, as the JAX package's tools/convert_torch.py does, whose Runner
    reads no such file and serves with the config's anchors)."""
    obj = load_checkpoint(path)
    anchors = obj.get("anchors")
    side = Path(path).with_suffix(".json")
    if anchors is None and side.is_file():
        anchors = json.loads(side.read_text()).get("anchors_px")
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


# ---------------------------------------------------------------------------
# the training side
# ---------------------------------------------------------------------------


def build_checkpoint_payload(state, epoch: int = -1, best_fitness: float = 0.0, include_optimizer: bool = True,
                             anchors=None) -> dict:
    """The train state (engine.trainer.TrainState) on the host, in the JAX
    package's checkpoint layout. `anchors`: the run's per-level pixel
    anchors (autoanchor's, when it refined them)."""
    model_vars = export_jax_variables(state.model)
    ema_vars = export_jax_variables(state.ema.ema)
    payload = {
        "epoch": int(epoch),
        "best_fitness": float(best_fitness),
        **({"anchors": np.asarray(anchors, np.float32)} if anchors is not None else {}),
        "params": model_vars["params"],
        "batch_stats": model_vars["batch_stats"],
        "ema_params": ema_vars["params"],
        "ema_batch_stats": ema_vars["batch_stats"],
        "ema_updates": int(state.ema.updates),
        "step": int(state.step),
    }
    if include_optimizer:
        opt, model, names = state.opt_state, state.model, state.names
        payload["opt_state"] = {
            "step": np.asarray(int(opt.step), np.int32),
            "momentum_buf": export_param_tree(model, names, opt.momentum_buf),
            "adam_mu": export_param_tree(model, names, opt.adam_mu) if opt.adam_mu is not None else None,
            "adam_nu": export_param_tree(model, names, opt.adam_nu) if opt.adam_nu is not None else None,
        }
    return payload


def write_checkpoint_payload(paths, payload: dict, meta_dict: Optional[dict] = None) -> None:
    """Serialize once and write the same bytes to every path, each by an
    atomic replace (a kill during the write leaves the old file whole)."""
    if isinstance(paths, (str, Path)):
        paths = [paths]
    blob = msgpack_serialize(payload)
    for path in paths:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_bytes(blob)
        os.replace(tmp, path)
        if meta_dict is not None:
            path.with_suffix(".json").write_text(json.dumps(meta_dict, default=str, indent=1))


def save_checkpoint(path, state, epoch: int = -1, best_fitness: float = 0.0, meta_dict: Optional[dict] = None,
                    include_optimizer: bool = True, anchors=None) -> None:
    write_checkpoint_payload(path, build_checkpoint_payload(state, epoch, best_fitness, include_optimizer, anchors),
                             meta_dict=meta_dict)


@torch.no_grad()
def restore_train_state(state, ckpt: dict, fresh: tuple = ()) -> list:
    """Load a checkpoint of either package into a TrainState in place: the
    model's parameters and BatchNorm statistics, the EMA (weights and
    update count), the optimizer state (buffers and step) and the step
    count. The JAX package's resume restores the parameters but keeps the
    BatchNorm statistics of the fresh model; the port restores them too.
    Distillation's adapters (`params/kd_adapter_*`) in the checkpoint of a
    hint-distilled run are dropped where the model has none. Parameters
    whose names start with a `fresh` prefix may be missing from the
    checkpoint: they keep their values and their optimizer buffers; their
    names are returned."""
    unmatched, unused = load_jax_variables(state.model, {"params": ckpt["params"],
                                                         "batch_stats": ckpt.get("batch_stats", {})})
    kept = [k for k in unmatched if fresh and k.startswith(fresh)]
    unmatched = [k for k in unmatched if k not in kept]
    unused = without_adapters(unused)
    if unmatched or unused:
        raise ValueError(f"checkpoint does not fit the model: unmatched {unmatched[:5]}, unused {unused[:5]}")
    if ckpt.get("ema_params"):
        load_jax_variables(state.ema.ema, {"params": ckpt["ema_params"],
                                           "batch_stats": ckpt.get("ema_batch_stats", {})})
        state.ema.updates.fill_(int(ckpt.get("ema_updates", 0)))
    opt = ckpt.get("opt_state")
    if opt is not None:
        state.opt_state.step.fill_(int(np.asarray(opt["step"])))
        restored = [i for i, name in enumerate(state.names) if name not in kept]
        names = [state.names[i] for i in restored]
        for key in ("momentum_buf", "adam_mu", "adam_nu"):
            bufs = getattr(state.opt_state, key)
            if bufs is not None and opt.get(key) is not None:
                dst = [bufs[i] for i in restored]
                torch._foreach_copy_(dst, [t.to(b.device) for t, b in
                                           zip(import_param_tree(state.model, names, opt[key]), dst)])
    state.step = int(ckpt.get("step", state.step))
    return kept


class AsyncCheckpointer:
    """Writes checkpoints on one background thread. `save` copies the
    state to the host at once (the train state changes in place), then
    queues serialization and the writes; a newer save for the same paths
    replaces one still queued. `wait` drains the queue and raises the
    writer's error, if any; `close` waits and stops the thread."""

    def __init__(self):
        self._cond = threading.Condition()
        self._pending: dict = {}
        self._busy = False
        self._stop = False
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True, name="ckpt-writer")
        self._thread.start()

    def save(self, paths, state, meta_dict: Optional[dict] = None, **kwargs) -> None:
        paths = [str(p) for p in ([paths] if isinstance(paths, (str, Path)) else paths)]
        payload = build_checkpoint_payload(state, **kwargs)
        with self._cond:
            self._pending[tuple(paths)] = lambda: write_checkpoint_payload(paths, payload, meta_dict=meta_dict)
            self._cond.notify_all()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._stop:
                    self._cond.wait()
                if not self._pending:
                    return
                key = next(iter(self._pending))
                job = self._pending.pop(key)
                self._busy = True
            try:
                job()
            except Exception as e:  # raised to the caller by wait()
                self._error = e
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def wait(self) -> None:
        with self._cond:
            while self._pending or self._busy:
                self._cond.wait()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        try:
            self.wait()
        finally:
            with self._cond:
                self._stop = True
                self._cond.notify_all()
            self._thread.join(timeout=30)
