"""The int8 convolution of int8 serving (counterpart of ConvRaw._int8_forward,
yolosomi_tpu/models/layers.py:192-255: the activation's quantize and the
int8 `conv_general_dilated` at :238, which is XLA and not Pallas).

Two entries launch the hand-written CUDA kernel (csrc/conv_int8.cu) for a
CUDA tensor and run their plain versions for a CPU tensor. There is no
fallback: on CUDA they launch the kernel or raise.

- `conv_int8_fused(x, s_a, w_q, scale, bias, ...)`: what int8 serving
  runs. x is the conv's float input as an NHWC view (bf16 or f32, channels
  contiguous, any pixel stride: a channel slice of a channels_last tensor
  is read in place); the kernel quantizes it on its way into shared memory,
  clamp(round(x / s_a), -127, 127) with s_a one scale or one per input
  channel, so no int8 copy of x is ever written. Plain version:
  `conv_int8_fused_reference` (`quantize_activation`, then
  `conv_int8_reference`).
- `conv_int8(x_q, w_q, scale, bias, ...)`: the same kernel on an already
  quantized int8 x_q (contiguous NHWC). Plain version: `conv_int8_reference`.

Both count their launches in `conv_int8.launches`. `int8_conv_fused` is what
the model calls: the fused kernel, or its plain version inside
`plain_version()`.

Layouts: w_q (N, kh, kw, C/groups) int8, the reduction axis contiguous
(torch's OIHW weight permuted); scale (N,) float32 (the activation scale
times the weight's per-output-channel scale); bias (N,) float32 or None.
The result (B, Ho, Wo, N) is the int32 accumulator (out_dtype torch.int32),
or float(acc) * scale + bias, rounded after the product and after the sum
as XLA's separate multiply and add are, in float32 or bfloat16.

The kernel reads its weights repacked (`pack_conv_int8_weights`) for the
route `_conv_int8_plan` takes: the implicit GEMM's (N, K), K in stages of
128 bytes (`_stage_layout`: one tap of a block of 128 input channels, or
for C <= 64 two or four taps of C rounded up to 32; zeros past C: the
kernel multiplies each tap's channels rounded up to 32, tap-aligned K), the
depthwise kernel's (kh*kw, N4), the grouped kernel's (N, kh*kw*Cg4). Callers that call often
pack once and pass `packed=`; otherwise the wrapper packs on each call.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from yolosomi_tpu_torch.ops import build, plain_active

_SOURCE = "conv_int8.cu"
_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_X_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ROUTES = {"gemm": 0, "dw": 1, "dp4": 2}

# the implicit GEMM's tile configurations, 64 output pixels (one consumer
# warpgroup) by BN output channels, in the order of CONV_INT8_TILES in
# csrc/conv_int8.cu: BN over wgmma's int8 widths (8, 16, 24, then multiples
# of 16 up to 256) that fit the flagship's N
_BN_WIDTHS = (24, 48, 64, 128, 256)
_BK, _STAGES = 128, 4  # K bytes a stage (a block of 128 channels at one tap), stages in the ring
_BM = 64  # output pixels a GEMM block
_SMS = 132  # an H100 SXM's streaming multiprocessors
_PW = 4  # outputs a direct-kernel thread computes at once
_DIRECT_THREADS = 256
_DIRECT_SMEM = 48 * 1024


def _out_hw(H: int, W: int, k: Tuple[int, int], stride, padding, dilation) -> Tuple[int, int]:
    return tuple((n + 2 * p - d * (kk - 1) - 1) // s + 1
                 for n, kk, s, p, d in zip((H, W), k, stride, padding, dilation))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _gemm_smem(bn: int) -> int:
    """Dynamic shared memory of a GEMM tile configuration's ring
    (GemmCfg::SMEM)."""
    return _STAGES * (_BM + bn) * _BK + 2 * _STAGES * 8 + 1024


def _route(N: int, cin_g: int, groups: int) -> str:
    if groups == 1 and N >= 8:
        return "gemm"
    if cin_g == 1 and N == groups:
        return "dw"
    return "dp4"


class Plan(NamedTuple):
    """A conv_int8 launch: its route; the GEMM's tile configuration (its
    index into _BN_WIDTHS, BN), the channels a tap it multiplies C'
    (C rounded up to 32) and its products an output K = kh*kw*C'; the output
    tile th x tw (GEMM: 0 x 0 for linear tiles of 64 pixels); the direct
    kernels' channels (dw) or groups (dp4) a block and 32-bit words a pixel
    in shared memory; the grid and the shared memory."""
    route: str
    cfg: int
    bn: int
    cp: int
    k: int
    th: int
    tw: int
    cb: int
    pstr: int
    grid: Tuple[int, int, int]
    smem: int


def _halo(th, tw, kh, kw, stride, dilation) -> int:
    """Input pixels under a th x tw tile of outputs."""
    return ((th - 1) * stride[0] + (kh - 1) * dilation[0] + 1) * ((tw - 1) * stride[1] + (kw - 1) * dilation[1] + 1)


def _direct_smem(th, tw, kh, kw, stride, dilation, pstr) -> int:
    return _halo(th, tw, kh, kw, stride, dilation) * pstr * 4


def _stage_layout(C: int, taps: int) -> Tuple[int, int, int, int]:
    """The GEMM's K stages (csrc/conv_int8.cu, Conv::sc): (sc, tps, blocks,
    groups): a stage of 128 bytes holds tps taps of sc bytes each (C rounded
    up to 32, at most 128) of one block of 128 input channels; blocks x
    groups stages in all, block by block, tap group by tap group."""
    sc = min(_BK, _round_up(C, 32))
    tps = _BK // sc if _BK % sc == 0 else 1
    return sc, tps, -(-C // _BK), -(-taps // tps)


def _gemm_tile(Ho: int, Wo: int, kh: int, kw: int, stride, dilation) -> Tuple[int, int]:
    """A spatial tile of at most 64 output pixels, th x tw: the one that
    needs the fewest blocks of 64 rows over the Ho x Wo map, then the one
    with the smallest halo."""
    best = None
    for tw in sorted({1, 2, 4, 8, 16, 32, 64, Wo} - {w for w in (Wo,) if w > 64}):
        th = _BM // tw
        rows = -(-Ho // th) * -(-Wo // tw) * _BM
        key = (rows, _halo(th, tw, kh, kw, stride, dilation))
        if best is None or key < best[0]:
            best = key, (th, tw)
    return best[1]


def _conv_int8_plan(x_shape, w_shape, stride=(1, 1), padding=(0, 0), dilation=(1, 1), groups: int = 1) -> Plan:
    """The launch plan of conv_int8 for x (B, H, W, C) and w (N, kh, kw,
    C/groups), in plain Python.

    groups == 1 and N >= 8, the implicit GEMM: tiles of 64 output pixels
    by BN, the narrowest int8 wgmma width of _BN_WIDTHS that holds N up to
    128; past it 128 at stride 1 (two blocks share an SM; x is quantized
    once per 128 output channels) and 256 at stride 2 (whose halo is four
    times a tile: quantized once per 256). probe_conv_int8.py --plans times
    the other widths; 128-pixel tiles were slower at every flagship shape.
    A kh x kw conv (kh*kw > 1) takes th x tw spatial tiles (_gemm_tile),
    whose halo of x the block quantizes into shared memory once for all its
    taps; a 1 x 1 conv takes 64 consecutive output pixels. Otherwise the
    direct kernels: depthwise (one input and one output channel a group) in
    tiles of up to 8 x 16 outputs by 64 channels; any other grouping in
    tiles of about 1024 outputs, as many groups a block as keep ~64 output
    channels; either shrunk until the halo fits 48 KB, then (rows first)
    until the blocks are at least two an SM, where the map allows."""
    B, H, W, C = x_shape
    N, kh, kw, cg = w_shape
    Ho, Wo = _out_hw(H, W, (kh, kw), stride, padding, dilation)
    M = B * Ho * Wo
    route = _route(N, cg, groups)
    if route == "gemm":
        cp = _round_up(C, 32)
        if N <= 128:
            bn = next(w for w in _BN_WIDTHS if w >= N)
        else:
            bn = 128 if tuple(stride) == (1, 1) else 256
        if kh * kw > 1:
            th, tw = _gemm_tile(Ho, Wo, kh, kw, stride, dilation)
            tiles, halo = B * -(-Ho // th) * -(-Wo // tw), _halo(th, tw, kh, kw, stride, dilation)
            smem = halo * (_BK + 8)  # the halo and x's offset of each of its pixels
        else:  # quantized straight into the stage: only the rows' offsets
            th = tw = 0
            tiles, smem = -(-M // _BM), _BM * 8
        return Plan(route, _BN_WIDTHS.index(bn), bn, cp, kh * kw * cp, th, tw, 0, 0, (tiles, -(-N // bn), 1),
                    _gemm_smem(bn) + smem)
    if route == "dw":
        cb = min(64, _round_up(C, 4))  # channels a block
        tw = min(Wo, 16)
        th = min(Ho, max(1, 128 // tw))
    else:
        cout_g = N // groups
        cb = min(groups, max(1, 64 // cout_g))  # groups a block
        tw = min(Wo, 64)
        th = min(Ho, max(1, -(-_DIRECT_THREADS * _PW // (cb * cout_g * tw))))
    while True:
        # words a pixel: depthwise, the block's channels; else its groups'
        # channels, odd so that consecutive pixels sit in distinct banks
        pstr = cb // 4 if route == "dw" else cb * (_round_up(cg, 4) // 4) | 1
        smem = _direct_smem(th, tw, kh, kw, stride, dilation, pstr)
        if smem <= _DIRECT_SMEM:
            break
        if th > 1:
            th = -(-th // 2)
        elif tw > 1:
            tw = -(-tw // 2)
        elif route == "dp4" and cb > 1:
            cb = -(-cb // 2)
        else:
            raise NotImplementedError(f"conv_int8: one output's window of x {tuple(x_shape)} under w "
                                      f"{tuple(w_shape)} does not fit the direct kernel's shared memory")
    n_blocks = -(-C // cb) if route == "dw" else -(-groups // cb)
    while -(-Ho // th) * -(-Wo // tw) * B * n_blocks < 2 * _SMS and th > 1:  # small maps: more, smaller tiles
        th = -(-th // 2)
    smem = _direct_smem(th, tw, kh, kw, stride, dilation, pstr)
    grid = (-(-Ho // th) * -(-Wo // tw), B, n_blocks)
    return Plan(route, -1, 0, 0, 0, th, tw, cb, pstr, grid, smem)


def _packed_shape(N: int, kh: int, kw: int, cg: int, groups: int) -> Tuple[int, int]:
    route = _route(N, cg, groups)
    if route == "gemm":
        _, _, blocks, groups_k = _stage_layout(cg, kh * kw)
        return N, blocks * groups_k * _BK
    if route == "dw":
        return kh * kw, _round_up(N, 4)
    return N, kh * kw * _round_up(cg, 4)


def pack_conv_int8_weights(w_q: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """w_q (N, kh, kw, C/groups) int8 in the layout the kernel reads for its
    route, zero where it pads: the GEMM's (N, K), stage by stage as
    `_stage_layout` lays them out (block by block of 128 input channels, tap
    group by tap group, each tap's channels of the block at its sc bytes,
    zeros to 128 bytes a stage); depthwise
    (kh*kw, round_up(N, 4)) (a tap's row over the channels); otherwise
    (N, kh*kw*Cg4) with each tap's C/groups channels padded to a multiple
    of 4."""
    N, kh, kw, cg = w_q.shape
    taps = kh * kw
    route = _route(N, cg, groups)
    if route == "gemm":
        sc, tps, blocks, groups_k = _stage_layout(cg, taps)
        out = torch.zeros((N, blocks, groups_k * tps, _BK), dtype=torch.int8, device=w_q.device)
        w = w_q.reshape(N, taps, cg)
        for cb in range(blocks):
            n = min(_BK, cg - cb * _BK)
            out[:, cb, :taps, :n] = w[:, :, cb * _BK:cb * _BK + n]
        # (N, blocks, group, tap in group, 128) -> each tap's sc bytes side by side in its group's stage
        out = out.reshape(N, blocks, groups_k, tps, _BK)[..., :sc]
        stage = torch.zeros((N, blocks, groups_k, _BK), dtype=torch.int8, device=w_q.device)
        stage[..., :tps * sc] = out.reshape(N, blocks, groups_k, tps * sc)
        return stage.reshape(N, -1)
    if route == "dw":
        out = torch.zeros((taps, _round_up(N, 4)), dtype=torch.int8, device=w_q.device)
        out[:, :N] = w_q.reshape(N, taps).t()
        return out
    out = torch.zeros((N, taps, _round_up(cg, 4)), dtype=torch.int8, device=w_q.device)
    out[:, :, :cg] = w_q.reshape(N, taps, cg)
    return out.reshape(N, -1)


def _check(x_q: torch.Tensor, w_q: torch.Tensor, scale, bias, groups: int, out_dtype: torch.dtype,
           name: str = "conv_int8") -> None:
    if x_q.dim() != 4 or w_q.dim() != 4:
        raise ValueError(f"expected x (B,H,W,C) and w_q (N,kh,kw,C/groups), got {tuple(x_q.shape)} "
                         f"{tuple(w_q.shape)}")
    if w_q.dtype != torch.int8:
        raise TypeError(f"{name} takes an int8 w_q, got {w_q.dtype}")
    C, N = x_q.shape[-1], w_q.shape[0]
    if C % groups or N % groups or w_q.shape[-1] != C // groups:
        raise ValueError(f"w_q {tuple(w_q.shape)} does not fit C {C} in {groups} groups")
    if out_dtype not in _OUT_KIND:
        raise TypeError(f"{name} writes float32, bfloat16 or int32, got {out_dtype}")
    if out_dtype != torch.int32 and (scale is None or tuple(scale.shape) != (N,) or scale.dtype != torch.float32):
        raise ValueError(f"a dequantized output needs a float32 scale of shape ({N},)")
    if bias is not None and (tuple(bias.shape) != (N,) or bias.dtype != torch.float32):
        raise ValueError(f"bias must be float32 of shape ({N},), got {bias.dtype} {tuple(bias.shape)}")


def _check_int8(x_q, w_q, scale, bias, groups, out_dtype) -> None:
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"conv_int8 takes int8 x_q and w_q, got {x_q.dtype} and {w_q.dtype}")
    _check(x_q, w_q, scale, bias, groups, out_dtype)


def _check_fused(x, s_a, w_q, scale, bias, groups, out_dtype) -> None:
    _check(x, w_q, scale, bias, groups, out_dtype, "conv_int8_fused")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv_int8_fused quantizes a float32 or bfloat16 x, got {x.dtype} (an int8 x goes to "
                        "conv_int8)")
    C = x.shape[-1]
    if not isinstance(s_a, torch.Tensor) or s_a.dtype != torch.float32 or tuple(s_a.shape) not in ((), (1,), (C,)):
        got = f"{s_a.dtype} {tuple(s_a.shape)}" if isinstance(s_a, torch.Tensor) else type(s_a).__name__
        raise ValueError(f"s_a must be a float32 scalar or ({C},) tensor, got {got}")


def conv_int8_reference(x_q: torch.Tensor, w_q: torch.Tensor, scale: Optional[torch.Tensor] = None,
                        bias: Optional[torch.Tensor] = None, stride=(1, 1), padding=(0, 0), dilation=(1, 1),
                        groups: int = 1, out_dtype: torch.dtype = torch.float32, packed=None) -> torch.Tensor:
    """Plain version: an im2col (F.unfold) and a product in float64, exact
    for int8 sums of this length, cast to the int32 accumulator; then the
    dequant. Same arguments and result as `conv_int8` (`packed` unused)."""
    _check_int8(x_q, w_q, scale, bias, groups, out_dtype)
    B, H, W, C = x_q.shape
    N, kh, kw, cg = w_q.shape
    Ho, Wo = _out_hw(H, W, (kh, kw), stride, padding, dilation)
    cols = F.unfold(x_q.permute(0, 3, 1, 2).double(), (kh, kw), dilation=dilation, padding=padding,
                    stride=stride)  # (B, C*kh*kw, L), (c, ky, kx) order
    cols = cols.reshape(B, groups, cg * kh * kw, Ho * Wo)
    wg = w_q.permute(0, 3, 1, 2).double().reshape(groups, N // groups, cg * kh * kw)  # (c, ky, kx) order
    acc = torch.einsum("gnk,bgkl->blgn", wg, cols).reshape(B, Ho, Wo, N)
    if out_dtype == torch.int32:
        return acc.to(torch.int32)
    y = acc.to(torch.int32).float() * scale  # float(acc) * scale + bias, each rounded in float32
    if bias is not None:
        y = y + bias
    return y.to(out_dtype)


def quantize_activation(x: torch.Tensor, s_a: torch.Tensor) -> torch.Tensor:
    """clamp(round(x / s_a), -127, 127) as int8, in float32 with round half
    to even: x (..., C), s_a a scalar or (C,) (JAX's x_q, layers.py:208/221)."""
    return torch.clamp(torch.round(x.float() / s_a), -127, 127).to(torch.int8)


def conv_int8_fused_reference(x: torch.Tensor, s_a: torch.Tensor, w_q: torch.Tensor, scale: Optional[torch.Tensor],
                              bias: Optional[torch.Tensor] = None, stride=(1, 1), padding=(0, 0), dilation=(1, 1),
                              groups: int = 1, out_dtype: Optional[torch.dtype] = None, packed=None) -> torch.Tensor:
    """Plain version of `conv_int8_fused`: `quantize_activation`, then
    `conv_int8_reference` (`packed` unused)."""
    out_dtype = out_dtype or x.dtype
    _check_fused(x, s_a, w_q, scale, bias, groups, out_dtype)
    return conv_int8_reference(quantize_activation(x, s_a), w_q, scale, bias, stride, padding, dilation, groups,
                               out_dtype)


def _entry():
    fn = build.load(_SOURCE).conv_int8
    fn.argtypes = [_PTR, _I64, _I64, _I64, _INT, _INT, _PTR, _INT] + [_PTR] * 4 + [_INT] * 24 + [_PTR]
    fn.restype = ctypes.c_int
    return fn


def gemm_smem_of_kernel(cfg: int) -> int:
    """The kernel's own shared memory for GEMM tile configuration `cfg`
    (needs the built library: the card tests hold _gemm_smem to it)."""
    fn = build.load(_SOURCE).conv_int8_gemm_smem
    fn.argtypes, fn.restype = [_INT], ctypes.c_int
    return fn(cfg)


def _vec_ok(x: torch.Tensor, route: str) -> int:
    """1 where every pixel's channels start, and C ends, on the vector the
    route loads: 16 bytes for the GEMM, 4 elements for the direct kernels."""
    need = 16 if route == "gemm" else 4 * x.element_size()
    es = x.element_size()
    return int(all(v % need == 0 for v in (x.data_ptr(), x.stride(0) * es, x.stride(1) * es, x.stride(2) * es,
                                            x.shape[3] * es)))


def gemm_plan(x_shape, w_shape, stride, padding, dilation, bn: int) -> Plan:
    """The implicit GEMM's plan with tile width bn in place of the chosen
    one (probe_conv_int8.py times the alternatives)."""
    plan = _conv_int8_plan(x_shape, w_shape, stride, padding, dilation, 1)
    return plan._replace(cfg=_BN_WIDTHS.index(bn), bn=bn, grid=(plan.grid[0], -(-w_shape[0] // bn), 1),
                         smem=plan.smem - _gemm_smem(plan.bn) + _gemm_smem(bn))


def _launch(x: torch.Tensor, s_a, w_q: torch.Tensor, scale, bias, stride, padding, dilation, groups: int,
            out_dtype: torch.dtype, packed, name: str, plan: Optional[Plan] = None) -> torch.Tensor:
    tensors = [t for t in (x, s_a, w_q, scale, bias, packed) if t is not None]
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}'s operands must be on one CUDA device, got {[str(t.device) for t in tensors]}")
    if x.stride(3) != 1 or any(s < 0 for s in x.stride()):
        raise ValueError(f"{name} needs x's channels contiguous (an NHWC view), got strides {x.stride()}")
    if not all(t.is_contiguous() for t in tensors[1:]):
        raise ValueError(f"{name} needs contiguous weights, scales and bias")
    stride, padding, dilation = (tuple(int(v) for v in a) for a in (stride, padding, dilation))
    B, H, W, C = x.shape
    N, kh, kw, cg = w_q.shape
    plan = plan or _conv_int8_plan(tuple(x.shape), tuple(w_q.shape), stride, padding, dilation, groups)
    if packed is None:
        packed = pack_conv_int8_weights(w_q, groups)
    want = _packed_shape(N, kh, kw, cg, groups)
    if tuple(packed.shape) != want or packed.dtype != torch.int8:
        raise ValueError(f"packed weights {packed.dtype} {tuple(packed.shape)} are not pack_conv_int8_weights' "
                         f"{want} for w_q {tuple(w_q.shape)}, groups {groups}")
    Ho, Wo = _out_hw(H, W, (kh, kw), stride, padding, dilation)
    out = torch.empty((B, Ho, Wo, N), device=dev, dtype=out_dtype)
    per_channel = int(s_a is not None and s_a.dim() == 1 and s_a.numel() == C and C > 1)
    args = [x.data_ptr(), x.stride(0), x.stride(1), x.stride(2), _X_KIND[x.dtype], _vec_ok(x, plan.route),
            s_a.data_ptr() if s_a is not None else None, per_channel, packed.data_ptr(),
            scale.data_ptr() if scale is not None else None, bias.data_ptr() if bias is not None else None,
            out.data_ptr(), _OUT_KIND[out_dtype], B, H, W, C, Ho, Wo, N, kh, kw, *stride, *padding, *dilation,
            groups, _ROUTES[plan.route], plan.cfg, plan.th, plan.tw, plan.cb, plan.pstr, plan.smem]
    with torch.cuda.device(dev):
        rc = _entry()(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: error {rc} (a CUDA error, or 10000 + the CUresult of "
                           f"the weights' tensor map)")
    conv_int8.launches += 1
    return out


def conv_int8(x_q: torch.Tensor, w_q: torch.Tensor, scale: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None, stride=(1, 1), padding=(0, 0), dilation=(1, 1), groups: int = 1,
              out_dtype: torch.dtype = torch.float32, packed: Optional[torch.Tensor] = None,
              plan: Optional[Plan] = None) -> torch.Tensor:
    """int8 x int8 -> int32 convolution with the per-output-channel
    dequant: x_q (B, H, W, C) contiguous, w_q (N, kh, kw, C/groups), any
    kernel size, stride, padding, dilation and group count -> (B, Ho, Wo, N)
    in `out_dtype` (float32 or bfloat16: float(acc) * scale + bias; int32:
    the accumulator, scale and bias unused). `packed`: w_q through
    pack_conv_int8_weights, if the caller keeps it; `plan`: a launch plan in
    place of _conv_int8_plan's (gemm_plan; for probes). A CPU tensor runs
    `conv_int8_reference`; a CUDA tensor launches the kernel on the current
    stream and counts the launch in `conv_int8.launches`."""
    _check_int8(x_q, w_q, scale, bias, groups, out_dtype)
    if x_q.device.type == "cpu":
        return conv_int8_reference(x_q, w_q, scale, bias, stride, padding, dilation, groups, out_dtype)
    if not x_q.is_contiguous():
        raise ValueError("conv_int8 needs contiguous operands")
    return _launch(x_q, None, w_q, scale, bias, stride, padding, dilation, groups, out_dtype, packed, "conv_int8",
                   plan)


conv_int8.launches = 0


def conv_int8_fused(x: torch.Tensor, s_a: torch.Tensor, w_q: torch.Tensor, scale: Optional[torch.Tensor],
                    bias: Optional[torch.Tensor] = None, stride=(1, 1), padding=(0, 0), dilation=(1, 1),
                    groups: int = 1, out_dtype: Optional[torch.dtype] = None,
                    packed: Optional[torch.Tensor] = None, plan: Optional[Plan] = None) -> torch.Tensor:
    """The activation's int8 quantize and the int8 convolution in one
    kernel: x (B, H, W, C) float32 or bfloat16 with contiguous channels and
    any pixel stride, s_a a float32 scalar or (C,) tensor; the rest as
    `conv_int8` (`out_dtype` defaults to x's). A CPU tensor runs
    `conv_int8_fused_reference`; a CUDA tensor launches the kernel on the
    current stream and counts the launch in `conv_int8.launches`."""
    out_dtype = out_dtype or x.dtype
    _check_fused(x, s_a, w_q, scale, bias, groups, out_dtype)
    if x.device.type == "cpu":
        return conv_int8_fused_reference(x, s_a, w_q, scale, bias, stride, padding, dilation, groups, out_dtype)
    return _launch(x, s_a, w_q, scale, bias, stride, padding, dilation, groups, out_dtype, packed,
                   "conv_int8_fused", plan)


def int8_conv_fused(*args, **kwargs) -> torch.Tensor:
    """What int8 ConvRaw calls: `conv_int8_fused`, or its plain version
    inside `plain_version()`."""
    return conv_int8_fused_reference(*args, **kwargs) if plain_active() else conv_int8_fused(*args, **kwargs)
