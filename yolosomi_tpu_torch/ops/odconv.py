"""The per-sample-weight 3x3 stride-2 conv of ODConv (counterpart of
yolosomi_tpu/ops/odconv_pallas.py::odconv_s2_pallas).

`odconv_s2` launches the hand-written CUDA kernel (csrc/odconv_s2.cu) for
a CUDA tensor and runs the plain version for a CPU tensor. There is no
fallback: on CUDA it launches the kernel or raises. The bf16 kernel's
launch plan (tile configuration and split-K) is chosen here, by `_plan`.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from yolosomi_tpu_torch.ops import build, plain_active, plain_version  # noqa: F401  (plain_version re-exported)

_SOURCE = "odconv_s2.cu"
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# C entry point and signature, without the trailing stream pointer
_ENTRY = {
    torch.float32: ("odconv_s2_f32", [_PTR] * 3 + [_INT] * 5),
    torch.bfloat16: ("odconv_s2_bf16", [_PTR] * 4 + [_INT] * 7),
}

# The bf16 kernel's tile configurations (csrc/odconv_s2.cu, Tile0 and
# Tile1): id -> (BN output channels, STAGES, blocks that fit on one SM).
# Both tiles take BM = 128 output pixels and step K by BK = 64 through
# STAGES shared-memory stages of BM x BK and BK x BN bf16.
_TILES = {0: (128, 3, 2), 1: (256, 4, 1)}
_BM, _BK = 128, 64
_SMS = 132  # streaming multiprocessors of an H100 SXM
_MAX_SPLIT = 8


def _smem_bytes(cfg: int) -> int:
    """Shared memory of tile configuration `cfg` (the kernel's Tile::SMEM:
    the stages and 1 KB to align them to the 128-byte swizzle's 1 KB)."""
    bn, stages, _ = _TILES[cfg]
    return stages * (_BM + bn) * _BK * 2 + 1024


def _k_splits(cin: int, split: int) -> list:
    """The [start, end) ranges of K = 9*cin that the kernel's `split` parts
    cover: ceil(ceil(K/BK)/split) whole K steps each, the last cut at K."""
    K = 9 * cin
    per = math.ceil(math.ceil(K / _BK) / split) * _BK
    return [(i * per, min(K, (i + 1) * per)) for i in range(split)]


def _plan(B: int, H: int, W: int, cin: int, cout: int) -> tuple:
    """(tile configuration, split_k) for the bf16 kernel at this shape.

    128x256 tiles where Cout > 128, so x is gathered once for 256 output
    channels; else 128x128. K is split only where the tiles fill less than
    one wave of resident blocks, into as many parts as that wave holds (at
    most _MAX_SPLIT, none empty). At 640 px, batch 8: rows 1, 26 and 29 run
    1600, 400 and 104 tiles unsplit; row 32 has 32 tiles and splits K in 4.
    A second wave costs more than the idle SMs of a partial one (row 29 ran
    slower split in 2 on an H100)."""
    M = (H // 2) * (W // 2)
    cfg = 1 if cout > 128 else 0
    bn, _, per_sm = _TILES[cfg]
    tiles = math.ceil(M / _BM) * math.ceil(cout / bn) * B
    split = min(_MAX_SPLIT, max(1, per_sm * _SMS // max(tiles, 1)), max(1, math.ceil(9 * cin / _BK)))
    while split > 1 and _k_splits(cin, split)[-1][0] >= 9 * cin:  # an empty last part
        split -= 1
    return cfg, split


def _entry(dtype: torch.dtype):
    """The C entry point for `dtype`, built and loaded on first use."""
    name, argtypes = _ENTRY[dtype]
    fn = getattr(build.load(_SOURCE), name)
    fn.argtypes = argtypes + [_PTR]
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
    `odconv_s2.launches` (one per call, split-K's reduction included).
    bfloat16 needs Cin and Cout multiples of 8 and 16-byte-aligned x and
    wmix (16-byte vectors of channels)."""
    _check(x, wmix)
    if x.device.type == "cpu":
        return odconv_s2_reference(x, wmix)
    B, H, W, C = x.shape
    cout = wmix.shape[-1]
    if x.dtype == torch.bfloat16 and (C % 8 or cout % 8):
        raise ValueError(f"odconv_s2 in bfloat16 needs Cin and Cout multiples of 8, got {C} and {cout}")
    if x.device.type != "cuda" or wmix.device != x.device:
        raise ValueError(f"x and wmix must be on one CUDA device, got {x.device} and {wmix.device}")
    if x.dtype not in _ENTRY or wmix.dtype != x.dtype:
        raise TypeError(f"odconv_s2 takes float32 or bfloat16 of one dtype, got {x.dtype} and {wmix.dtype}")
    if not (x.is_contiguous() and wmix.is_contiguous()):
        raise ValueError("odconv_s2 needs contiguous x and wmix")
    out = torch.empty((B, H // 2, W // 2, cout), device=x.device, dtype=x.dtype)
    fn = _entry(x.dtype)
    args = [x.data_ptr(), wmix.data_ptr(), out.data_ptr()]
    if x.dtype == torch.bfloat16:
        if x.data_ptr() % 16 or wmix.data_ptr() % 16:
            raise ValueError("odconv_s2 in bfloat16 needs 16-byte-aligned x and wmix")
        cfg, split = _plan(B, H, W, C, cout)
        ws = torch.empty((split, B, H // 2, W // 2, cout), device=x.device, dtype=torch.float32) if split > 1 else None
        args += [ws.data_ptr() if ws is not None else None, B, H, W, C, cout, cfg, split]
    else:
        args += [B, H, W, C, cout]
    with torch.cuda.device(x.device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"odconv_s2 kernel launch failed: CUDA error {rc}")
    odconv_s2.launches += 1
    return out


odconv_s2.launches = 0


def per_sample_conv(x: torch.Tensor, wmix: torch.Tensor) -> torch.Tensor:
    """What ODConv calls: `odconv_s2`, or its plain version inside
    `plain_version()`."""
    return odconv_s2_reference(x, wmix) if plain_active() else odconv_s2(x, wmix)
