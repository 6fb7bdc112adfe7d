"""The port's kernels and their plain PyTorch versions.

One switch, `plain_version()`, sends every kernel call of the model
(odconv_s2, dcnv3_core, dcnv2_im2col) to its plain version inside the
block, so a whole model can be compared against its plain form. It is
re-exported as `yolosomi_tpu_torch.ops.odconv.plain_version`.
"""

from __future__ import annotations

import contextlib

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
