"""The per-sample-weight 3x3 stride-2 conv of ODConv (counterpart of
yolosomi_tpu/ops/odconv_pallas.py::odconv_s2_pallas) and its gradient.

`odconv_s2` launches the hand-written CUDA kernel (csrc/odconv_s2.cu) for
a CUDA tensor and runs the plain version for a CPU tensor. There is no
fallback: on CUDA it launches the kernel or raises. The bf16 kernel's
launch plan (tile configuration and split-K) is chosen here, by `_plan`.

On CUDA under autograd the call goes through `OdconvS2Function`, whose
backward launches two more hand-written kernels (csrc/odconv_s2_bwd.cu):
`odconv_s2_dx` (the input gradient, by parity class of the input pixel)
and `odconv_s2_dwmix` (the per-sample weight gradient, its pixel
reduction split where the tiles leave the card idle). Their bf16 launch
plans are chosen here too: `_dx_plan` and `_dw_plan` (the f32 kernels'
split by `_dw_split`). The JAX package's kernel has no VJP (JAX trains
ODConv through the batch-grouped vmap conv); the plain versions of the
gradients are the autograd of `odconv_s2_reference`, which is what a CPU
tensor and `plain_version()` get.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from yolosomi_tpu_torch.ops import build, plain_active, plain_version  # noqa: F401  (plain_version re-exported)

_SOURCE = "odconv_s2.cu"
_BWD_SOURCE = "odconv_s2_bwd.cu"
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# C entry point and signature, without the trailing stream pointer
_ENTRY = {
    torch.float32: ("odconv_s2_f32", [_PTR] * 3 + [_INT] * 5),
    torch.bfloat16: ("odconv_s2_bf16", [_PTR] * 4 + [_INT] * 7),
}
_DX_ENTRY = {
    torch.float32: ("odconv_s2_dx_f32", [_PTR] * 3 + [_INT] * 5),
    torch.bfloat16: ("odconv_s2_dx_bf16", [_PTR] * 3 + [_INT] * 6),
}
_DW_ENTRY = {
    torch.float32: ("odconv_s2_dw_f32", [_PTR] * 4 + [_INT] * 6),
    torch.bfloat16: ("odconv_s2_dw_bf16", [_PTR] * 4 + [_INT] * 7),
}

# The bf16 kernel's tile configurations (csrc/odconv_s2.cu, Tile0 and
# Tile1): id -> (BN output channels, STAGES, blocks that fit on one SM).
# Both tiles take BM = 128 output pixels and step K by BK = 64 through
# STAGES shared-memory stages of BM x BK and BK x BN bf16.
_TILES = {0: (128, 3, 2), 1: (256, 4, 1)}
_BM, _BK = 128, 64
_SMS = 132  # streaming multiprocessors of an H100 SXM
_MAX_SPLIT = 8
# The bf16 gradient kernels' tile configurations (csrc/odconv_s2_bwd.cu,
# DxTile* and DwTile*), as _TILES: BM = 128 rows, K step BK = 64. dx's
# columns are Cin, dwmix's Cout.
_DX_TILES = {0: (64, 4, 2), 1: (128, 3, 2), 2: (256, 4, 1)}
_DW_TILES = {0: (128, 3, 2), 1: (256, 4, 1)}
# H100 SXM peaks for _dw_plan's cost model: bf16 tensor FLOP/s, HBM bytes/s
_PEAK_FLOPS, _PEAK_BYTES = 989e12, 3.35e12
# the f32 gradient kernels' tiles: 64 x 64 outputs, the reduction in steps
# of 32; dwmix splits its pixel reduction until about _DW_BLOCKS blocks are
# in flight (4 of its 256-thread blocks fit an SM); in f32 and bf16 into at
# most _DW_MAX_SPLIT parts (the f32 workspace)
_BWD_TILE, _BWD_K = 64, 32
_DW_BLOCKS = 4 * _SMS
_DW_MAX_SPLIT = 16


def _smem_bytes(cfg: int, tiles: dict = None) -> int:
    """Shared memory of tile configuration `cfg` of `tiles` (the forward's
    _TILES by default; the kernels' Tile::SMEM: the stages and 1 KB to
    align them to the 128-byte swizzle's 1 KB)."""
    bn, stages, _ = (tiles or _TILES)[cfg]
    return stages * (_BM + bn) * _BK * 2 + 1024


def _k_splits(K: int, split: int) -> list:
    """The [start, end) ranges of a reduction of length K that a kernel's
    `split` parts cover: ceil(ceil(K/BK)/split) whole K steps each, the last
    cut at K (the forward's K = 9*Cin, bf16 dwmix's K = the pixels)."""
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
    while split > 1 and _k_splits(9 * cin, split)[-1][0] >= 9 * cin:  # an empty last part
        split -= 1
    return cfg, split


def _dx_plan(cin: int) -> int:
    """Tile configuration of the bf16 dx kernel: columns BN = 64, 128 or
    256, the least that covers Cin (256 and two column tiles at Cin 512),
    so each gathered tile of dy serves as many input channels as it can.
    Rows are the parity class's pixels: the grid has B * 4 * ceil(M/128)
    row tiles (6400 at row 1, 640 px, b8), enough to fill the card."""
    return 0 if cin <= 64 else 1 if cin <= 128 else 2


def _dw_cost(B: int, H: int, W: int, cin: int, cout: int, cfg: int, split: int) -> float:
    """Seconds _dw_plan expects for the bf16 dwmix at this plan, at the
    card's peaks: the waves of resident blocks times the K steps of one
    part (a wave-step: every SM's blocks do one 128 x BN x 64 product),
    plus the f32 partial sums written and read back once per part."""
    bn, _, per_sm = _DW_TILES[cfg]
    tiles = B * math.ceil(9 * cin / _BM) * math.ceil(cout / bn)
    waves = math.ceil(tiles * split / (per_sm * _SMS))
    steps = math.ceil(math.ceil((H // 2) * (W // 2) / _BK) / split)
    wave_step = per_sm * 2 * _BM * bn * _BK / (_PEAK_FLOPS / _SMS)
    workspace = 8 * B * 9 * cin * cout * split / _PEAK_BYTES if split > 1 else 0.0
    return waves * steps * wave_step + workspace


def _dw_plan(B: int, H: int, W: int, cin: int, cout: int) -> tuple:
    """(tile configuration, split) of the bf16 dwmix kernel: columns BN =
    128 where Cout <= 128, else 256 (x gathered once for 256 output
    channels); the pixel reduction split into the number of parts
    (_k_splits(P, split), at most _DW_MAX_SPLIT, none empty) that _dw_cost
    expects to be fastest. Output tiles are few (40 at row 1, 640 px, b8,
    over a 25,600-pixel reduction; 144 at rows 26 and 29, 1.09 waves of 132
    SMs), so splitting fills the card, but each part costs its f32 partial
    sums' round trip through memory."""
    cfg = 1 if cout > 128 else 0
    P = (H // 2) * (W // 2)
    splits = [s for s in range(1, _DW_MAX_SPLIT + 1) if _k_splits(P, s)[-1][0] < P]  # none empty
    return cfg, min(splits, key=lambda s: (_dw_cost(B, H, W, cin, cout, cfg, s), s))


def _dw_split(B: int, H: int, W: int, cin: int, cout: int) -> int:
    """Parts of the f32 dwmix kernel's pixel reduction: enough for about
    _DW_BLOCKS blocks over the B * ceil(9*Cin/64) * ceil(Cout/64) output
    tiles (at most _DW_MAX_SPLIT, each part whole 32-pixel steps, none
    empty). At 640 px, batch 8, only row 1 splits (144 tiles, 25 600
    pixels: 3 parts)."""
    steps = math.ceil((H // 2) * (W // 2) / _BWD_K)
    tiles = B * math.ceil(9 * cin / _BWD_TILE) * math.ceil(cout / _BWD_TILE)
    split = min(_DW_MAX_SPLIT, max(1, _DW_BLOCKS // max(tiles, 1)), max(1, steps))
    while split > 1 and (split - 1) * math.ceil(steps / split) >= steps:  # an empty last part
        split -= 1
    return split


def _entry(dtype: torch.dtype, table: dict = None, source: str = _SOURCE):
    """The C entry point for `dtype`, built and loaded on first use."""
    name, argtypes = (table or _ENTRY)[dtype]
    fn = getattr(build.load(source), name)
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


def _check_cuda(tensors, cin: int, cout: int) -> None:
    """What every kernel of this module needs of its operands (x, wmix, dy),
    checked before any launch: one CUDA device, one dtype of float32 or
    bfloat16, contiguous; in bfloat16, Cin and Cout multiples of 8 and
    16-byte-aligned pointers."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dtype == torch.bfloat16 and (cin % 8 or cout % 8):
        raise ValueError(f"odconv_s2 in bfloat16 needs Cin and Cout multiples of 8, got {cin} and {cout}")
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"odconv_s2's operands must be on one CUDA device, got {[str(t.device) for t in tensors]}")
    if dtype not in _ENTRY or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"odconv_s2 takes float32 or bfloat16 of one dtype, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("odconv_s2 needs contiguous operands")
    if dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("odconv_s2 in bfloat16 needs 16-byte-aligned operands")


def _launch(fn, args, x: torch.Tensor, what: str) -> None:
    with torch.cuda.device(x.device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _forward_kernel(x: torch.Tensor, wmix: torch.Tensor) -> torch.Tensor:
    """The forward kernel on checked CUDA inputs."""
    B, H, W, C = x.shape
    cout = wmix.shape[-1]
    out = torch.empty((B, H // 2, W // 2, cout), device=x.device, dtype=x.dtype)
    args = [x.data_ptr(), wmix.data_ptr(), out.data_ptr()]
    if x.dtype == torch.bfloat16:
        cfg, split = _plan(B, H, W, C, cout)
        ws = torch.empty((split, B, H // 2, W // 2, cout), device=x.device, dtype=torch.float32) if split > 1 else None
        args += [ws.data_ptr() if ws is not None else None, B, H, W, C, cout, cfg, split]
    else:
        args += [B, H, W, C, cout]
    _launch(_entry(x.dtype), args, x, "odconv_s2")
    odconv_s2.launches += 1
    return out


class OdconvS2Function(torch.autograd.Function):
    """odconv_s2 under autograd on CUDA: the forward kernel, and a backward
    of the two gradient kernels, each launched only where its input needs
    a gradient. Under autocast both run as called: the kernels take x and
    wmix in one dtype and raise otherwise."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, wmix):
        ctx.save_for_backward(x, wmix)
        return _forward_kernel(x, wmix)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dy):
        x, wmix = ctx.saved_tensors
        # the gradient arrives through ODConv2d's NHWC -> NCHW permute: make
        # it the kernels' contiguous NHWC (free where it already is)
        dy = dy.contiguous()
        dx = odconv_s2_dx(dy, wmix, x.shape[1], x.shape[2]) if ctx.needs_input_grad[0] else None
        dw = odconv_s2_dwmix(x, dy) if ctx.needs_input_grad[1] else None
        return dx, dw


def odconv_s2(x: torch.Tensor, wmix: torch.Tensor) -> torch.Tensor:
    """Per-sample 3x3 stride-2 conv, padding 1, f32 accumulation.

    x (B, H, W, Cin) with H, W even, in float32 or bfloat16; wmix
    (B, 3, 3, Cin, Cout) in the same dtype. Returns (B, H/2, W/2, Cout) in
    x.dtype. A CPU tensor runs `odconv_s2_reference`; a CUDA tensor
    launches the kernel on the current stream and counts the launch in
    `odconv_s2.launches` (one per call, split-K's reduction included).
    Where autograd records and x or wmix needs a gradient, the call goes
    through OdconvS2Function, whose backward launches odconv_s2_dx and
    odconv_s2_dwmix. bfloat16 needs Cin and Cout multiples of 8 and
    16-byte-aligned x and wmix (16-byte vectors of channels)."""
    _check(x, wmix)
    if x.device.type == "cpu":
        return odconv_s2_reference(x, wmix)
    _check_cuda((x, wmix), x.shape[-1], wmix.shape[-1])
    if torch.is_grad_enabled() and (x.requires_grad or wmix.requires_grad):
        return OdconvS2Function.apply(x, wmix)
    return _forward_kernel(x, wmix)


odconv_s2.launches = 0


def _check_dy(dy: torch.Tensor, B: int, H: int, W: int, cout: int) -> None:
    if tuple(dy.shape) != (B, H // 2, W // 2, cout):
        raise ValueError(f"dy {tuple(dy.shape)} does not match the output {(B, H // 2, W // 2, cout)}")


def odconv_s2_backward_reference(x: torch.Tensor, wmix: torch.Tensor, dy: torch.Tensor, need_dx: bool = True,
                                 need_dw: bool = True):
    """Plain version of both gradient kernels: autograd of
    odconv_s2_reference. Returns (dx or None, dwmix or None)."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(need_dx)
        wg = wmix.detach().requires_grad_(need_dw)
        y = odconv_s2_reference(xg, wg)
        wanted = [t for t, need in ((xg, need_dx), (wg, need_dw)) if need]
        grads = list(torch.autograd.grad(y, wanted, dy))
    return (grads.pop(0) if need_dx else None), (grads.pop(0) if need_dw else None)


def odconv_s2_dx(dy: torch.Tensor, wmix: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """The input gradient of odconv_s2: dy (B, H/2, W/2, Cout) and wmix
    (B, 3, 3, Cin, Cout) -> dx (B, H, W, Cin), in their dtype. A CPU tensor
    runs the plain version; a CUDA tensor launches the kernel and counts
    it in `odconv_s2_dx.launches`."""
    B, cin, cout = wmix.shape[0], wmix.shape[3], wmix.shape[4]
    _check_dy(dy, B, H, W, cout)
    if dy.device.type == "cpu":  # the plain version reads only x's shape
        return odconv_s2_backward_reference(dy.new_zeros((B, H, W, cin)), wmix, dy, need_dw=False)[0]
    _check_cuda((dy, wmix), cin, cout)
    return _dx_kernel(dy, wmix, H, W, _dx_plan(cin) if dy.dtype == torch.bfloat16 else None)


def _dx_kernel(dy: torch.Tensor, wmix: torch.Tensor, H: int, W: int, cfg) -> torch.Tensor:
    """The dx kernel on checked CUDA inputs; `cfg` is the bf16 tile
    configuration (None in f32)."""
    B, cin, cout = wmix.shape[0], wmix.shape[3], wmix.shape[4]
    dx = torch.empty((B, H, W, cin), device=dy.device, dtype=dy.dtype)
    args = [dy.data_ptr(), wmix.data_ptr(), dx.data_ptr(), B, H, W, cin, cout] + ([cfg] if cfg is not None else [])
    _launch(_entry(dy.dtype, _DX_ENTRY, _BWD_SOURCE), args, dy, "odconv_s2_dx")
    odconv_s2_dx.launches += 1
    return dx


odconv_s2_dx.launches = 0


def odconv_s2_dwmix(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The weight gradient of odconv_s2: x (B, H, W, Cin) and dy
    (B, H/2, W/2, Cout) -> dwmix (B, 3, 3, Cin, Cout), in their dtype. A
    CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (its split reduction included) and counts it in
    `odconv_s2_dwmix.launches`. Two calls give the same bits."""
    B, H, W, cin = x.shape
    cout = dy.shape[-1]
    _check_dy(dy, B, H, W, cout)
    if H % 2 or W % 2:
        raise ValueError(f"H and W must be even, got {H}x{W}")
    if x.device.type == "cpu":  # the plain version reads only wmix's shape
        return odconv_s2_backward_reference(x, x.new_zeros((B, 3, 3, cin, cout)), dy, need_dx=False)[1]
    _check_cuda((x, dy), cin, cout)
    plan = _dw_plan(B, H, W, cin, cout) if x.dtype == torch.bfloat16 else (None, _dw_split(B, H, W, cin, cout))
    return _dw_kernel(x, dy, *plan)


def _dw_kernel(x: torch.Tensor, dy: torch.Tensor, cfg, split: int) -> torch.Tensor:
    """The dwmix kernel on checked CUDA inputs, its split reduction
    included: bf16 tile configuration `cfg` (None in f32), `split` parts."""
    B, H, W, cin = x.shape
    cout = dy.shape[-1]
    dw = torch.empty((B, 3, 3, cin, cout), device=x.device, dtype=x.dtype)
    ws = torch.empty((split, B, 9 * cin, cout), device=x.device, dtype=torch.float32) if split > 1 else None
    args = [x.data_ptr(), dy.data_ptr(), dw.data_ptr(), ws.data_ptr() if ws is not None else None, B, H, W, cin, cout]
    _launch(_entry(x.dtype, _DW_ENTRY, _BWD_SOURCE), args + ([cfg] if cfg is not None else []) + [split], x,
            "odconv_s2_dwmix")
    odconv_s2_dwmix.launches += 1
    return dw


odconv_s2_dwmix.launches = 0


def per_sample_conv(x: torch.Tensor, wmix: torch.Tensor) -> torch.Tensor:
    """What ODConv calls: `odconv_s2`, or its plain version inside
    `plain_version()`."""
    return odconv_s2_reference(x, wmix) if plain_active() else odconv_s2(x, wmix)
