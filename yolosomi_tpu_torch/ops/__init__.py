"""The port's kernels and their plain PyTorch versions.

One switch, `plain_version()`, sends every kernel call of the model
(odconv_s2, dcnv3_core, dcnv2_im2col, and conv_int8 in int8 mode) to its
plain version inside the block, so a whole model can be compared against
its plain form. It is
re-exported as `yolosomi_tpu_torch.ops.odconv.plain_version`.

A kernel's launch is a ctypes call into a buffer that torch allocated,
which torch.jit.trace (and torch.onnx.export's tracer) cannot see: a
traced model would return the unfilled buffer. Every launch calls
`refuse_trace` first, which raises under a trace; export traces inside
`plain_version()` (utils/onnx_export.py).
"""

from __future__ import annotations

import contextlib

import torch

# Set only by `plain_version()` (tests and the smoke run's comparison of the
# whole model against its plain form); the Runner never touches it.
_USE_PLAIN = [False]


def plain_active() -> bool:
    """True inside `plain_version()`."""
    return _USE_PLAIN[0]


@contextlib.contextmanager
def plain_version():
    """Run every kernel call of the model through its plain version inside
    the block. Not thread-safe and not for serving."""
    prev = _USE_PLAIN[0]
    _USE_PLAIN[0] = True
    try:
        yield
    finally:
        _USE_PLAIN[0] = prev


def refuse_trace(name: str) -> None:
    """Raise RuntimeError when `name`'s kernel is about to launch under a trace."""
    if torch.jit.is_tracing():
        raise RuntimeError(f"{name}: a kernel launch cannot be traced (the trace would keep its output buffer "
                           "unfilled); trace the model inside plain_version()")
