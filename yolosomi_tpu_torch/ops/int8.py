"""The int8 convolution of int8 serving (counterpart of the int8
`conv_general_dilated` in ConvRaw._int8_forward,
yolosomi_tpu/models/layers.py:238-246, which is XLA and not Pallas).

`conv_int8` launches the hand-written CUDA kernel (csrc/conv_int8.cu) for
a CUDA tensor and runs the plain version, `conv_int8_reference`, for a
CPU tensor. There is no fallback: on CUDA it launches the kernel or
raises. `int8_conv` is what the model calls: the kernel, or the plain
version inside `plain_version()`.

Layouts: x_q (B, H, W, C) int8 NHWC; w_q (N, kh, kw, C/groups) int8, the
reduction axis contiguous (torch's OIHW weight permuted); scale (N,)
float32 (the activation scale times the weight's per-output-channel
scale); bias (N,) float32 or None. The result (B, Ho, Wo, N) is the int32
accumulator (out_dtype torch.int32), or float(acc) * scale + bias, rounded
after the product and after the sum as XLA's separate multiply and add
are, in float32 or bfloat16.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from yolosomi_tpu_torch.ops import build, plain_active

_SOURCE = "conv_int8.cu"
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


def _out_hw(H: int, W: int, k: Tuple[int, int], stride, padding, dilation) -> Tuple[int, int]:
    return tuple((n + 2 * p - d * (kk - 1) - 1) // s + 1
                 for n, kk, s, p, d in zip((H, W), k, stride, padding, dilation))


def _check(x_q: torch.Tensor, w_q: torch.Tensor, scale, bias, groups: int, out_dtype: torch.dtype) -> None:
    if x_q.dim() != 4 or w_q.dim() != 4:
        raise ValueError(f"expected x_q (B,H,W,C) and w_q (N,kh,kw,C/groups), got {tuple(x_q.shape)} "
                         f"{tuple(w_q.shape)}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"conv_int8 takes int8 x_q and w_q, got {x_q.dtype} and {w_q.dtype}")
    C, N = x_q.shape[-1], w_q.shape[0]
    if C % groups or N % groups or w_q.shape[-1] != C // groups:
        raise ValueError(f"w_q {tuple(w_q.shape)} does not fit C {C} in {groups} groups")
    if out_dtype not in _OUT_KIND:
        raise TypeError(f"conv_int8 writes float32, bfloat16 or int32, got {out_dtype}")
    if out_dtype != torch.int32 and (scale is None or tuple(scale.shape) != (N,) or scale.dtype != torch.float32):
        raise ValueError(f"a dequantized output needs a float32 scale of shape ({N},)")
    if bias is not None and (tuple(bias.shape) != (N,) or bias.dtype != torch.float32):
        raise ValueError(f"bias must be float32 of shape ({N},), got {bias.dtype} {tuple(bias.shape)}")


def _dequant(acc: torch.Tensor, scale, bias, out_dtype: torch.dtype) -> torch.Tensor:
    """float(acc) * scale + bias, each rounded in float32, then cast."""
    if out_dtype == torch.int32:
        return acc
    y = acc.float() * scale
    if bias is not None:
        y = y + bias
    return y.to(out_dtype)


def conv_int8_reference(x_q: torch.Tensor, w_q: torch.Tensor, scale: Optional[torch.Tensor] = None,
                        bias: Optional[torch.Tensor] = None, stride=(1, 1), padding=(0, 0), dilation=(1, 1),
                        groups: int = 1, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version: an im2col (F.unfold) and a product in float64, exact
    for int8 sums of this length, cast to the int32 accumulator; then the
    dequant. Same arguments and result as `conv_int8`."""
    _check(x_q, w_q, scale, bias, groups, out_dtype)
    B, H, W, C = x_q.shape
    N, kh, kw, cg = w_q.shape
    Ho, Wo = _out_hw(H, W, (kh, kw), stride, padding, dilation)
    cols = F.unfold(x_q.permute(0, 3, 1, 2).double(), (kh, kw), dilation=dilation, padding=padding,
                    stride=stride)  # (B, C*kh*kw, L), (c, ky, kx) order
    cols = cols.reshape(B, groups, cg * kh * kw, Ho * Wo)
    wg = w_q.permute(0, 3, 1, 2).double().reshape(groups, N // groups, cg * kh * kw)  # (c, ky, kx) order
    acc = torch.einsum("gnk,bgkl->blgn", wg, cols).reshape(B, Ho, Wo, N)
    return _dequant(acc.to(torch.int32), scale, bias, out_dtype)


def _entry():
    fn = build.load(_SOURCE).conv_int8
    fn.argtypes = [_PTR] * 5 + [_INT] * 18 + [_PTR]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(tensors) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"conv_int8's operands must be on one CUDA device, got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("conv_int8 needs contiguous operands")


def conv_int8(x_q: torch.Tensor, w_q: torch.Tensor, scale: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None, stride=(1, 1), padding=(0, 0), dilation=(1, 1), groups: int = 1,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 x int8 -> int32 convolution with the per-output-channel
    dequant: x_q (B, H, W, C), w_q (N, kh, kw, C/groups), any kernel size,
    stride, padding, dilation and group count -> (B, Ho, Wo, N) in
    `out_dtype` (float32 or bfloat16: float(acc) * scale + bias; int32: the
    accumulator, scale and bias unused). A CPU tensor runs
    `conv_int8_reference`; a CUDA tensor launches the kernel on the current
    stream and counts the launch in `conv_int8.launches`."""
    _check(x_q, w_q, scale, bias, groups, out_dtype)
    if x_q.device.type == "cpu":
        return conv_int8_reference(x_q, w_q, scale, bias, stride, padding, dilation, groups, out_dtype)
    tensors = [t for t in (x_q, w_q, scale, bias) if t is not None]
    _check_cuda(tensors)
    B, H, W, C = x_q.shape
    N, kh, kw, _ = w_q.shape
    Ho, Wo = _out_hw(H, W, (kh, kw), stride, padding, dilation)
    out = torch.empty((B, Ho, Wo, N), device=x_q.device, dtype=out_dtype)
    vec = int(groups == 1 and C % 16 == 0 and x_q.data_ptr() % 16 == 0 and w_q.data_ptr() % 16 == 0)
    args = [x_q.data_ptr(), w_q.data_ptr(), scale.data_ptr() if scale is not None else None,
            bias.data_ptr() if bias is not None else None, out.data_ptr(), B, H, W, C, Ho, Wo, N, kh, kw,
            *stride, *padding, *dilation, groups, _OUT_KIND[out_dtype], vec]
    with torch.cuda.device(x_q.device):
        rc = _entry()(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv_int8 kernel launch failed: CUDA error {rc}")
    conv_int8.launches += 1
    return out


conv_int8.launches = 0


def int8_conv(*args, **kwargs) -> torch.Tensor:
    """What int8 ConvRaw calls: `conv_int8`, or its plain version inside
    `plain_version()`."""
    return conv_int8_reference(*args, **kwargs) if plain_active() else conv_int8(*args, **kwargs)
