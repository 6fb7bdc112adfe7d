"""The per-sample-weight 3x3 stride-2 conv of ODConv (counterpart of
yolosomi_tpu/ops/odconv_pallas.py::odconv_s2_pallas).

`odconv_s2` launches the hand-written CUDA kernel (csrc/odconv_s2.cu) for
a CUDA tensor and runs the plain version for a CPU tensor. There is no
fallback: on CUDA it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from yolosomi_tpu_torch.ops import build, plain_active, plain_version  # noqa: F401  (plain_version re-exported)

_SOURCE = "odconv_s2.cu"
_ENTRY = {torch.float32: "odconv_s2_f32", torch.bfloat16: "odconv_s2_bf16"}


def _entry(dtype: torch.dtype):
    """The C entry point for `dtype`, built and loaded on first use."""
    fn = getattr(build.load(_SOURCE), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, wmix: torch.Tensor):
    if x.dim() != 4 or wmix.dim() != 5:
        raise ValueError(f"expected x (B,H,W,Cin) and wmix (B,3,3,Cin,Cout), got {tuple(x.shape)} {tuple(wmix.shape)}")
    B, H, W, C = x.shape
    if tuple(wmix.shape[:4]) != (B, 3, 3, C):
        raise ValueError(f"wmix {tuple(wmix.shape)} does not match x {tuple(x.shape)}")
    if H % 2 or W % 2:
        raise ValueError(f"H and W must be even, got {H}x{W}")


def odconv_s2_reference(x: torch.Tensor, wmix: torch.Tensor) -> torch.Tensor:
    """Plain version: the grouped-conv trick (groups=B) of the reference.
    x (B, H, W, Cin), wmix (B, 3, 3, Cin, Cout) -> (B, H/2, W/2, Cout)."""
    _check(x, wmix)
    B, H, W, C = x.shape
    cout = wmix.shape[-1]
    w = wmix.permute(0, 4, 3, 1, 2).reshape(B * cout, C, 3, 3)  # per-sample OIHW stacked
    out = F.conv2d(x.permute(0, 3, 1, 2).reshape(1, B * C, H, W), w, stride=2, padding=1, groups=B)
    return out.reshape(B, cout, H // 2, W // 2).permute(0, 2, 3, 1)


def odconv_s2(x: torch.Tensor, wmix: torch.Tensor) -> torch.Tensor:
    """Per-sample 3x3 stride-2 conv, padding 1, f32 accumulation.

    x (B, H, W, Cin) with H, W even, in float32 or bfloat16; wmix
    (B, 3, 3, Cin, Cout) in the same dtype. Returns (B, H/2, W/2, Cout) in
    x.dtype. A CPU tensor runs `odconv_s2_reference`; a CUDA tensor
    launches the kernel on the current stream and counts the launch in
    `odconv_s2.launches`."""
    _check(x, wmix)
    if x.device.type == "cpu":
        return odconv_s2_reference(x, wmix)
    if x.device.type != "cuda" or wmix.device != x.device:
        raise ValueError(f"x and wmix must be on one CUDA device, got {x.device} and {wmix.device}")
    if x.dtype not in _ENTRY or wmix.dtype != x.dtype:
        raise TypeError(f"odconv_s2 takes float32 or bfloat16 of one dtype, got {x.dtype} and {wmix.dtype}")
    if not (x.is_contiguous() and wmix.is_contiguous()):
        raise ValueError("odconv_s2 needs contiguous x and wmix")
    B, H, W, C = x.shape
    cout = wmix.shape[-1]
    out = torch.empty((B, H // 2, W // 2, cout), device=x.device, dtype=x.dtype)
    fn = _entry(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), wmix.data_ptr(), out.data_ptr(), B, H, W, C, cout, stream)
    if rc != 0:
        raise RuntimeError(f"odconv_s2 kernel launch failed: CUDA error {rc}")
    odconv_s2.launches += 1
    return out


odconv_s2.launches = 0


def per_sample_conv(x: torch.Tensor, wmix: torch.Tensor) -> torch.Tensor:
    """What ODConv calls: `odconv_s2`, or its plain version inside
    `plain_version()`."""
    return odconv_s2_reference(x, wmix) if plain_active() else odconv_s2(x, wmix)
