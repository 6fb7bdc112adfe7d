"""Callback hooks (counterpart of yolosomi_tpu/utils/callbacks.py): the
reference's named hooks, run in order of registration. train.py fires
them; a logger registers its methods against them."""

from __future__ import annotations

from typing import Any, Callable, Dict, List

HOOKS = (
    "on_pretrain_routine_start", "on_pretrain_routine_end", "on_train_start", "on_train_epoch_start",
    "on_train_batch_start", "optimizer_step", "on_before_zero_grad", "on_train_batch_end", "on_train_epoch_end",
    "on_val_start", "on_val_batch_start", "on_val_image_end", "on_val_batch_end", "on_val_end",
    "on_fit_epoch_end", "on_model_save", "on_train_end", "teardown",
)


class Callbacks:
    def __init__(self):
        self._callbacks: Dict[str, List[dict]] = {h: [] for h in HOOKS}

    def register_action(self, hook: str, name: str = "", callback: Callable = None) -> None:
        if hook not in self._callbacks:
            raise KeyError(f"unknown hook '{hook}'")
        if not callable(callback):
            raise TypeError("callback must be callable")
        self._callbacks[hook].append({"name": name, "callback": callback})

    def run(self, hook: str, *args: Any, **kwargs: Any) -> None:
        if hook not in self._callbacks:
            raise KeyError(f"unknown hook '{hook}'")
        for entry in self._callbacks[hook]:
            entry["callback"](*args, **kwargs)
