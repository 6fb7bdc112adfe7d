"""Deformable sampling for DCNv3 and DCNv2 (counterparts of
yolosomi_tpu/ops/dcn.py `_bilinear_gather` + `dcnv3_core`, :34-124, and
DCNv2's modulated sampling, :209-233), and its gradient.

`dcnv3_core` and `dcnv2_im2col` launch the hand-written CUDA kernels of
csrc/dcn.cu for CUDA tensors and run their plain versions for CPU
tensors. There is no fallback: on CUDA each launches its kernel or raises.
Where autograd records and an input needs a gradient, the call goes
through `Dcnv3CoreFunction` / `Dcnv2Im2colFunction`, whose backward calls
`dcnv3_core_bwd` / `dcnv2_im2col_bwd`: the hand-written kernels of
csrc/dcn_bwd.cu on CUDA (launch plans from `_v2_bwd_plan` /
`_v3_bwd_plan`), autograd of the plain forward on the CPU. The
JAX package trains through XLA's VJP of its gathers, so the gradient is
JAX's: at an integer sampling coordinate the one-sided derivative over
the corners floor(p) and floor(p) + 1 (`_corner_weight`).

The plain versions copy the JAX arithmetic with `torch.gather`. They
compute in float32, or in float64 when given float64, and cast back to
the input's dtype.

Both forwards take a row origin `row0` (default 0): the offsets and the
mask then hold output rows row0, row0 + 1, ... of the whole output, which
sample the whole map `input` / `x` (a strip of a spatially sharded map,
parallel/spatial.py). The sampling rows are (row0 + oy) * stride - pad +
..., and DCNv3's canvas stays the whole padded map, so a strip's call
gives rows row0 .. of the whole call. (Shifting the offsets by row0
instead would round in bf16: 640 + 0.3 is 640.) No gradient is taken at
row0 > 0: spatial sharding serves only.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from yolosomi_tpu_torch.ops import build, plain_active, refuse_trace

_SOURCE = "dcn.cu"
_BWD_SOURCE = "dcn_bwd.cu"
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# threads per block of dcnv3_core and dcnv2_im2col, and the most pairs a
# dcnv2_im2col lane group writes (csrc/dcn.cu V3_THREADS, V2_THREADS,
# V2_PAIRS); the gradient kernels' blocks (csrc/dcn_bwd.cu BWD_THREADS)
_V3_THREADS = 256
_V2_THREADS, _V2_PAIRS = 256, 4
_BWD_THREADS = 256
# the gradient kernels' plans (_v3_bwd_plan): output tiles of at most
# _BWD_TILE x _BWD_TILE pixels, channel slices of at most _BWD_SLICE, a
# halo of _BWD_HALO map pixels around each tile's receptive field; shared
# memory of _BWD_PAIR_WORDS 4-byte words per (pixel, point) pair of the
# tile, _BWD_PIXEL_WORDS per window pixel, and one more (csrc/dcn_bwd.cu
# PAIR_WORDS, PIXEL_WORDS); an H100's shared memory: at most _SMEM_BLOCK
# bytes a block (csrc/dcn_bwd.cu SMEM_BLOCK), _SMEM_SM an SM, 1 KB of it
# reserved for each block
_BWD_TILE, _BWD_SLICE, _BWD_HALO = 4, 128, 2
_BWD_PAIR_WORDS, _BWD_PIXEL_WORDS = 11, 2
_SMEM_BLOCK, _SMEM_SM, _SMEM_RESERVED = 232448, 233472, 1024
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# C signatures (csrc/dcn.cu, csrc/dcn_bwd.cu), without the trailing stream
# pointer
_ARGTYPES = {
    "dcnv3_core": [_PTR] * 4 + [_INT] * 15 + [ctypes.c_float] + [_INT] * 3,
    "dcnv2_im2col": [_PTR] * 5 + [_INT] * 12,
    "dcnv3_core_bwd": [_PTR] * 8 + [_INT] * 15 + [ctypes.c_float] + [_INT] * 7,
    "dcnv2_im2col_bwd": [_PTR] * 10 + [_INT] * 16,
}


def _entry(name: str, dtype: torch.dtype):
    """The C entry point `<name>_<f32|bf16>`, built and loaded on first use."""
    source = _BWD_SOURCE if name.endswith("_bwd") else _SOURCE
    fn = getattr(build.load(source), f"{name}_{_DTYPES[dtype]}")
    fn.argtypes = _ARGTYPES[name] + [_PTR]
    fn.restype = ctypes.c_int
    return fn


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """float64 stays float64; everything else samples in float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _check_cuda(name: str, tensors) -> None:
    """What the kernels take: one CUDA device, one dtype of float32 or
    bfloat16, contiguous, 32-bit sizes."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one CUDA device, got {[str(t.device) for t in tensors]}")
    if dtype not in _DTYPES or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"{name} takes float32 or bfloat16 of one dtype, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    if any(t.numel() >= 2**31 for t in tensors):
        raise ValueError(f"{name}: a tensor has 2**31 elements or more")


def _launch(name: str, fn, ptrs, ints, extra=()) -> None:
    refuse_trace(name)
    with torch.cuda.device(ptrs[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(None if t is None else t.data_ptr() for t in ptrs), *ints, *extra, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _abs(d: torch.Tensor) -> torch.Tensor:
    """|d| with JAX's derivative at 0 (+1, where torch's `abs` gives 0); the
    same values, up to the sign of a zero."""
    return torch.where(d >= 0, d, -d)


def _corner_weight(p: torch.Tensor, corner: torch.Tensor) -> torch.Tensor:
    """The JAX package's bilinear weight of a corner along one axis,
    |1 - |p - corner||, with JAX's derivative where p is an integer: -1 at
    corner floor(p), +1 at floor(p) + 1 (the one-sided derivative over
    those two corners). torch's `abs` has derivative 0 at 0, which made
    every sampling gradient 0 at integer points, as at the zero-initialised
    offset heads."""
    return _abs(1.0 - _abs(p - corner))


def _bilinear_gather(img: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Bilinear sample with zeros padding (copy of dcn.py:34-56).

    img: (N, H, W, G, Cg); px, py: (N, Q, G) pixel coordinates
    (align_corners=False: valid centres at 0..W-1). Returns (N, Q, G, Cg)."""
    N, H, W, G, Cg = img.shape
    Q = px.shape[1]
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    imgf = img.reshape(N, H * W, G, Cg).permute(0, 2, 1, 3)  # (N, G, HW, Cg)
    out = 0.0
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xc = x0 + dx
        yc = y0 + dy
        w = _corner_weight(px, xc) * _corner_weight(py, yc)
        inb = (xc >= 0) & (xc <= W - 1) & (yc >= 0) & (yc <= H - 1)
        xi = xc.clamp(0, W - 1).long()
        yi = yc.clamp(0, H - 1).long()
        flat = (yi * W + xi).permute(0, 2, 1)  # (N, G, Q)
        tap = torch.gather(imgf, 2, flat[..., None].expand(N, G, Q, Cg))  # (N, G, Q, Cg)
        out = out + tap * (w * inb).permute(0, 2, 1)[..., None]
    return out.permute(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# DCNv3
# ---------------------------------------------------------------------------


def _check_v3(input, offset, mask, kernel_h, kernel_w, group, group_channels, row0: int = 0):
    if input.dim() != 4 or offset.dim() != 4 or mask.dim() != 4:
        raise ValueError(f"expected 4-D NHWC tensors, got {tuple(input.shape)} {tuple(offset.shape)} "
                         f"{tuple(mask.shape)}")
    N, _, _, C = input.shape
    P = kernel_h * kernel_w
    n, ho, wo = offset.shape[:3]
    if C != group * group_channels:
        raise ValueError(f"input has {C} channels, not group*group_channels = {group * group_channels}")
    if n != N or offset.shape[3] != group * P * 2 or tuple(mask.shape) != (N, ho, wo, group * P):
        raise ValueError(f"offset {tuple(offset.shape)} / mask {tuple(mask.shape)} do not match input "
                         f"{tuple(input.shape)} with G={group}, P={P}")
    if row0 < 0:
        raise ValueError(f"row0 {row0} < 0")


def dcnv3_points(offset, H: int, W: int, kernel_h: int, kernel_w: int, stride_h: int, stride_w: int, pad_h: int,
                 pad_w: int, dilation_h: int, dilation_w: int, group: int, offset_scale: float = 1.0,
                 closed_form: bool = False, dtype: torch.dtype = None, row0: int = 0):
    """DCNv3's sampling coordinates (px, py), each (N, Ho, Wo, G, P), in
    pixels of the padded canvas (`closed_form` False: the plain version's
    and JAX's round trip through coordinates normalised over that canvas)
    or of the unpadded H x W map (`closed_form` True: dcnv3_core's kernels'
    f32 arithmetic, px = cx + (gx + off_x) * offset_scale, exact for
    offset_scale 1); in `dtype`, by default float32 or float64 as the
    offsets. The two differ by pad and, in f32, in the last bits:
    a point within an ulp of an integer can floor to another corner. The
    offsets' rows are output rows row0, row0 + 1, ... of an H x W map."""
    ct = dtype or _compute_dtype(offset.dtype)
    dev = offset.device
    N, Hout, Wout, _ = offset.shape
    P = kernel_h * kernel_w
    off = offset.reshape(N, Hout, Wout, group, P, 2).to(ct)
    if closed_form:
        half_x, half_y = (dilation_w * (kernel_w - 1)) // 2, (dilation_h * (kernel_h - 1)) // 2
        pp = torch.arange(P, device=dev)
        gx = ((pp // kernel_h) * dilation_w - half_x).to(ct)  # p = ix*kh + iy
        gy = ((pp % kernel_h) * dilation_h - half_y).to(ct)
        cx = (half_x + torch.arange(Wout, device=dev) * stride_w - pad_w).to(ct)[None, None, :, None, None]
        cy = (half_y + torch.arange(row0, row0 + Hout, device=dev) * stride_h - pad_h).to(ct)[None, :, None, None, None]
        return cx + (gx + off[..., 0]) * offset_scale, cy + (gy + off[..., 1]) * offset_scale
    H_, W_ = H + 2 * pad_h, W + 2 * pad_w
    base_y = (dilation_h * (kernel_h - 1)) // 2 + 0.5
    base_x = (dilation_w * (kernel_w - 1)) // 2 + 0.5
    ref_y = (base_y + torch.arange(row0, row0 + Hout, dtype=ct, device=dev) * stride_h) / H_
    ref_x = (base_x + torch.arange(Wout, dtype=ct, device=dev) * stride_w) / W_
    ref = torch.stack([ref_x[None, :].expand(Hout, Wout), ref_y[:, None].expand(Hout, Wout)], -1)

    # the grid is built (kw, kh) and flattened: p = ix*kh + iy, kernel-y fastest
    gx = -((dilation_w * (kernel_w - 1)) // 2) + torch.arange(kernel_w, dtype=ct, device=dev) * dilation_w
    gy = -((dilation_h * (kernel_h - 1)) // 2) + torch.arange(kernel_h, dtype=ct, device=dev) * dilation_h
    grid = torch.stack(
        [gx[:, None].expand(kernel_w, kernel_h) / W_, gy[None, :].expand(kernel_w, kernel_h) / H_], -1
    ).reshape(P, 2)

    spatial_norm = torch.tensor([W_, H_], dtype=ct, device=dev)
    loc = (ref[None, :, :, None, None, :] + grid[None, None, None, None] * offset_scale
           + off * offset_scale / spatial_norm)  # (N, Hout, Wout, G, P, 2) normalised
    return loc[..., 0] * W_ - 0.5, loc[..., 1] * H_ - 0.5


def dcnv3_core_reference(input, offset, mask, kernel_h: int, kernel_w: int, stride_h: int, stride_w: int,
                         pad_h: int, pad_w: int, dilation_h: int, dilation_w: int, group: int, group_channels: int,
                         offset_scale: float = 1.0, row0: int = 0) -> torch.Tensor:
    """Plain version of `dcnv3_core`: the JAX arithmetic (dcn.py:59-124),
    reference points normalised over the padded canvas included; the
    output rows from `row0` on."""
    _check_v3(input, offset, mask, kernel_h, kernel_w, group, group_channels, row0)
    ct = _compute_dtype(input.dtype)
    x = F.pad(input, (0, 0, pad_w, pad_w, pad_h, pad_h))
    N, H_, W_, _ = x.shape
    _, Hout, Wout, _ = offset.shape
    P = kernel_h * kernel_w
    G, Cg = group, group_channels
    px, py = dcnv3_points(offset, input.shape[1], input.shape[2], kernel_h, kernel_w, stride_h, stride_w, pad_h,
                          pad_w, dilation_h, dilation_w, group, offset_scale, dtype=ct, row0=row0)
    Q = Hout * Wout * P
    px = px.permute(0, 1, 2, 4, 3).reshape(N, Q, G)
    py = py.permute(0, 1, 2, 4, 3).reshape(N, Q, G)

    img = x.to(ct).reshape(N, H_, W_, G, Cg)
    sampled = _bilinear_gather(img, px, py).reshape(N, Hout, Wout, P, G, Cg)
    m = mask.reshape(N, Hout, Wout, G, P).to(ct)
    out = torch.einsum("nhwpgc,nhwgp->nhwgc", sampled, m)
    return out.reshape(N, Hout, Wout, G * Cg).to(input.dtype)


def _v3_geometry(Cg: int, elem_size: int, aligned: bool = True) -> tuple:
    """(VEC, LANES) of dcnv3_core for Cg channels a group of `elem_size`
    bytes: a group of LANES threads (a power of two, at most a warp) writes
    the Cg channels of one (pixel, group), lane l the VEC-vectors l,
    l + LANES, ... of them; VEC is 16 bytes where Cg allows it and value
    and out are 16-byte aligned, else 1."""
    full = 16 // elem_size
    vec = full if aligned and Cg % full == 0 else 1
    return vec, min(32, 1 << max(Cg // vec - 1, 0).bit_length())


class BwdPlan(NamedTuple):
    """A launch plan of dcnv2_im2col_bwd / dcnv3_core_bwd (csrc/dcn_bwd.cu):
    VEC channels a lane, lane groups of `lanes` threads on a (pixel, point)
    pair, channel slices of cs = vec * lanes (`slices` of them, a block
    each); output tiles of th x tw pixels (a block each); each block's
    window of fh x fw map pixels from (tile origin * stride - pad - halo),
    whose corners it gathers before one global add; `smem` bytes of shared
    memory a block (the tile's pair table and corner lists, the window's
    counts); `blocks` blocks."""

    vec: int
    lanes: int
    cs: int
    slices: int
    th: int
    tw: int
    halo: int
    fh: int
    fw: int
    blocks: int
    smem: int


def _v3_bwd_plan(N: int, G: int, Cg: int, Ho: int, Wo: int, kh: int, kw: int, sh: int, sw: int, dh: int, dw: int,
                 elem_size: int, aligned: bool = True, tile: int = _BWD_TILE, slice_: int = _BWD_SLICE,
                 halo: int = _BWD_HALO) -> BwdPlan:
    """The gradient kernels' plan for Cg channels a group (DCNv2: one group
    of C), the output Ho x Wo, the kernel kh x kw at strides (sh, sw) and
    dilations (dh, dw), inputs of `elem_size` bytes: VEC and the channels'
    16-byte vectors as `_v3_geometry` sets them (`aligned`: the input and
    the upstream gradient); slices of at most `slice_` channels; tiles of
    `tile` x `tile` pixels (clipped to the map), halved along the longer
    side while the shared memory would leave room for fewer than two
    blocks an SM; the window the tile's receptive field, its bilinear +1
    corner and `halo` pixels on each side, clipped to one block's shared
    memory where even a one-pixel tile's does not fit (the corners past it
    add to global memory). `tile`, `slice_` and `halo` are the module's
    constants; probe_dcn_bwd.py times others."""
    vec = _v3_geometry(Cg, elem_size, aligned)[0]
    lanes = min(slice_ // vec, 32, 1 << max(math.ceil(Cg / vec) - 1, 0).bit_length())
    cs = vec * lanes
    th, tw = max(1, min(tile, Ho)), max(1, min(tile, Wo))

    def sizes(th: int, tw: int) -> tuple:
        """(fh, fw, 4-byte words of the pairs and the one more)"""
        return ((th - 1) * sh + dh * (kh - 1) + 2 + 2 * halo, (tw - 1) * sw + dw * (kw - 1) + 2 + 2 * halo,
                th * tw * kh * kw * _BWD_PAIR_WORDS + 1)

    fh, fw, words = sizes(th, tw)
    while (words + fh * fw * _BWD_PIXEL_WORDS) * 4 > _SMEM_SM // 2 - _SMEM_RESERVED and th * tw > 1:
        th, tw = ((th + 1) // 2, tw) if th >= tw else (th, (tw + 1) // 2)
        fh, fw, words = sizes(th, tw)
    most = (_SMEM_BLOCK // 4 - words) // _BWD_PIXEL_WORDS  # window pixels one block can hold
    fw = min(fw, math.isqrt(most))
    fh = min(fh, most // fw)
    slices = math.ceil(Cg / cs)
    blocks = N * G * math.ceil(Ho / th) * math.ceil(Wo / tw) * slices
    return BwdPlan(vec, lanes, cs, slices, th, tw, halo, fh, fw, blocks, (words + fh * fw * _BWD_PIXEL_WORDS) * 4)


def _v2_bwd_plan(N: int, C: int, Ho: int, Wo: int, k: int, stride: int, elem_size: int, aligned: bool = True,
                 **kw) -> BwdPlan:
    """dcnv2_im2col_bwd's plan: `_v3_bwd_plan` of one group of C channels,
    a k x k kernel, dilation 1."""
    return _v3_bwd_plan(N, 1, C, Ho, Wo, k, k, stride, stride, 1, 1, elem_size, aligned, **kw)


def _bwd_args(plan: BwdPlan) -> tuple:
    """The plan as the C entry points take it."""
    return plan.vec, plan.th, plan.tw, plan.cs, plan.halo, plan.fh, plan.fw


def _aligned16(*tensors) -> bool:
    """Whether every tensor starts 16-byte aligned (16-byte vectors)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _workspace(plan: BwdPlan, mask: torch.Tensor):
    """The f32 partial sums (slice, 3, pair) of a plan with several
    slices (the pairs are mask's elements), else None."""
    if plan.slices == 1:
        return None
    return torch.empty((plan.slices, 3, mask.numel()), device=mask.device, dtype=torch.float32)


def dcnv3_core(input, offset, mask, kernel_h: int, kernel_w: int, stride_h: int, stride_w: int, pad_h: int,
               pad_w: int, dilation_h: int, dilation_w: int, group: int, group_channels: int,
               offset_scale: float = 1.0, row0: int = 0) -> torch.Tensor:
    """DCNv3's sampling: for each output pixel and group, the P = kh*kw
    points, each a bilinear sample of the zero-padded input at its learned
    offset, weighted by the softmax mask and summed over P, in f32.

    input (N, H, W, G*Cg), offset (N, Ho, Wo, G*P*2) with (x, y)
    interleaved per (g, p), mask (N, Ho, Wo, G*P) -> (N, Ho, Wo, G*Cg) in
    input.dtype. A CPU tensor runs `dcnv3_core_reference`; CUDA tensors
    (float32 or bfloat16, one dtype, contiguous; any kernel size and group
    count) launch the kernel on the current stream and count the launch in
    `dcnv3_core.launches`. Where autograd records and an input needs a
    gradient, the call goes through Dcnv3CoreFunction (on the CPU too), whose
    backward is `dcnv3_core_bwd`. `row0` > 0 (output rows from row0 on, of
    the whole map `input`) takes no gradient."""
    args = (kernel_h, kernel_w, stride_h, stride_w, pad_h, pad_w, dilation_h, dilation_w, group, group_channels)
    _check_v3(input, offset, mask, kernel_h, kernel_w, group, group_channels, row0)
    if input.device.type != "cpu":
        _check_cuda("dcnv3_core", (input, offset, mask))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (input, offset, mask)):
        _no_grad_at(row0, "dcnv3_core")
        return Dcnv3CoreFunction.apply(input, offset, mask, args, offset_scale)
    return _v3_forward(input, offset, mask, args, offset_scale, row0)


def _no_grad_at(row0: int, name: str) -> None:
    if row0:
        raise NotImplementedError(f"{name} takes no gradient at row0 {row0}: spatial sharding serves only")


def _v3_forward(input, offset, mask, args: tuple, offset_scale: float, row0: int = 0) -> torch.Tensor:
    """dcnv3_core on checked inputs: the plain version for CPU tensors, the
    kernel for CUDA tensors."""
    if input.device.type == "cpu":
        return dcnv3_core_reference(input, offset, mask, *args, offset_scale=offset_scale, row0=row0)
    N, H, W, C = input.shape
    _, Ho, Wo, _ = offset.shape
    group, group_channels = args[8:]
    out = torch.empty((N, Ho, Wo, C), device=input.device, dtype=input.dtype)
    vec, lanes = _v3_geometry(group_channels, input.element_size(),
                              input.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    _launch("dcnv3_core", _entry("dcnv3_core", input.dtype), (input, offset, mask, out),
            (N, H, W, group, group_channels, Ho, Wo, *args[:8]), (float(offset_scale), row0, vec, lanes))
    dcnv3_core.launches += 1
    return out


dcnv3_core.launches = 0


class Dcnv3CoreFunction(torch.autograd.Function):
    """dcnv3_core under autograd: the forward of `dcnv3_core` (kernel or
    plain version, by device), and a backward of one `dcnv3_core_bwd` call,
    made where any of value, offset and mask needs a gradient (value's
    scatter only where value does). Under autocast both run as called: the
    kernels take one dtype and raise otherwise."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, input, offset, mask, args, offset_scale):
        ctx.save_for_backward(input, offset, mask)
        ctx.args, ctx.offset_scale = args, offset_scale
        return _v3_forward(input, offset, mask, args, offset_scale)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dout):
        input, offset, mask = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        grads = dcnv3_core_bwd(input, offset, mask, dout.contiguous().to(input.dtype), *ctx.args,
                               offset_scale=ctx.offset_scale, need_input=need[0])
        return tuple(g if n else None for g, n in zip(grads, need)) + (None, None)


def dcnv3_core_backward_reference(input, offset, mask, dout, kernel_h: int, kernel_w: int, stride_h: int,
                                  stride_w: int, pad_h: int, pad_w: int, dilation_h: int, dilation_w: int,
                                  group: int, group_channels: int, offset_scale: float = 1.0) -> tuple:
    """Plain version of `dcnv3_core_bwd`: autograd of dcnv3_core_reference.
    Returns (dinput, doffset, dmask) in the inputs' dtypes."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (input, offset, mask)]
        out = dcnv3_core_reference(*leaves, kernel_h, kernel_w, stride_h, stride_w, pad_h, pad_w, dilation_h,
                                   dilation_w, group, group_channels, offset_scale)
        return torch.autograd.grad(out, leaves, dout)


def dcnv3_core_bwd(input, offset, mask, dout, kernel_h: int, kernel_w: int, stride_h: int, stride_w: int,
                   pad_h: int, pad_w: int, dilation_h: int, dilation_w: int, group: int, group_channels: int,
                   offset_scale: float = 1.0, need_input: bool = True) -> tuple:
    """The gradient of dcnv3_core: dout (N, Ho, Wo, G*Cg) -> (dinput,
    doffset, dmask), each in its input's dtype, the derivative at integer
    coordinates one-sided as JAX's (`_corner_weight`); dinput is None when
    not `need_input`. A CPU tensor runs the plain version; CUDA tensors (one
    dtype, contiguous) launch the kernel of csrc/dcn_bwd.cu under
    `_v3_bwd_plan`, which gathers dinput over a window around each tile of
    output pixels and adds it with f32 atomics into a zeroed f32 buffer
    (cast once to bf16; the order of the adds varies from call to call;
    doffset and dmask repeat bitwise), and count the launch in
    `dcnv3_core_bwd.launches`."""
    args = (kernel_h, kernel_w, stride_h, stride_w, pad_h, pad_w, dilation_h, dilation_w, group, group_channels)
    _check_v3(input, offset, mask, kernel_h, kernel_w, group, group_channels)
    if tuple(dout.shape) != tuple(offset.shape[:3]) + (input.shape[-1],):
        raise ValueError(f"dout {tuple(dout.shape)} does not match the output "
                         f"{tuple(offset.shape[:3]) + (input.shape[-1],)}")
    if input.device.type == "cpu":
        grads = dcnv3_core_backward_reference(input, offset, mask, dout, *args, offset_scale=offset_scale)
        return (grads[0] if need_input else None, *grads[1:])
    _check_cuda("dcnv3_core_bwd", (input, offset, mask, dout))
    _, Ho, Wo, _ = offset.shape
    plan = _v3_bwd_plan(input.shape[0], group, group_channels, Ho, Wo, *args[:4], *args[6:8], input.element_size(),
                        _aligned16(input, dout))
    dinput, doffset, dmask = _v3_bwd_launch(input, offset, mask, dout, args, offset_scale, plan, need_input)
    dcnv3_core_bwd.launches += 1
    return (dinput.to(input.dtype) if need_input else None), doffset, dmask


def _v3_bwd_launch(input, offset, mask, dout, args: tuple, offset_scale: float, plan: BwdPlan,
                   need_input: bool = True) -> tuple:
    """dcnv3_core_bwd's kernel under `plan` on checked CUDA tensors: (f32
    dinput or None, doffset, dmask)."""
    N, H, W, C = input.shape
    _, Ho, Wo, _ = offset.shape
    dinput = torch.zeros((N, H, W, C), device=input.device, dtype=torch.float32) if need_input else None
    doffset, dmask = torch.empty_like(offset), torch.empty_like(mask)
    _launch("dcnv3_core_bwd", _entry("dcnv3_core_bwd", input.dtype),
            (input, offset, mask, dout, dinput, doffset, dmask, _workspace(plan, mask)),
            (N, H, W, *args[8:], Ho, Wo, *args[:8]), (float(offset_scale), *_bwd_args(plan)))
    return dinput, doffset, dmask


dcnv3_core_bwd.launches = 0


def dcnv3_sampling(*args, **kwargs) -> torch.Tensor:
    """What DCNv3 calls: `dcnv3_core`, or its plain version inside
    `plain_version()`."""
    return (dcnv3_core_reference if plain_active() else dcnv3_core)(*args, **kwargs)


# ---------------------------------------------------------------------------
# DCNv2
# ---------------------------------------------------------------------------


def _check_v2(x, offset_y, offset_x, mask, k, row0: int = 0):
    if x.dim() != 4 or offset_y.dim() != 4:
        raise ValueError(f"expected x (N,H,W,C) and offsets (N,Ho,Wo,P), got {tuple(x.shape)} "
                         f"{tuple(offset_y.shape)}")
    n, ho, wo, p = offset_y.shape
    if n != x.shape[0] or p != k * k or tuple(offset_x.shape) != (n, ho, wo, p) or tuple(mask.shape) != (n, ho, wo, p):
        raise ValueError(f"offset_y {tuple(offset_y.shape)}, offset_x {tuple(offset_x.shape)} and mask "
                         f"{tuple(mask.shape)} must all be (N, Ho, Wo, {k * k}) for x {tuple(x.shape)}")
    if row0 < 0:
        raise ValueError(f"row0 {row0} < 0")


def _v2_geometry(C: int, elem_size: int, aligned: bool = True) -> tuple:
    """(VEC, LANES, PAIRS) of dcnv2_im2col for C channels of `elem_size`
    bytes: VEC and LANES as `_v3_geometry` sets them for C channels; a
    group of LANES threads writes the columns of PAIRS consecutive (pixel,
    point) pairs, one after the other, lane l taking the vectors l,
    l + LANES, ... of each. Group g (threads g*LANES ..) has the pairs from
    g*PAIRS on; the wrapper launches enough groups, in blocks of
    _V2_THREADS threads, for all pairs."""
    vec, lanes = _v3_geometry(C, elem_size, aligned)
    return vec, lanes, min(lanes, _V2_PAIRS)


def dcnv2_im2col_reference(x, offset_y, offset_x, mask, k: int = 3, stride: int = 1, pad: int = 1,
                           row0: int = 0) -> torch.Tensor:
    """Plain version of `dcnv2_im2col`: the JAX arithmetic (dcn.py:220-233);
    the output rows from `row0` on."""
    _check_v2(x, offset_y, offset_x, mask, k, row0)
    ct = _compute_dtype(x.dtype)
    dev = x.device
    N, H, W, C = x.shape
    _, Ho, Wo, P = offset_y.shape
    kk = torch.arange(k, dtype=ct, device=dev)
    grid_y = kk[:, None].expand(k, k).reshape(P)  # p = ky*k + kx
    grid_x = kk[None, :].expand(k, k).reshape(P)
    base_y = torch.arange(row0, row0 + Ho, dtype=ct, device=dev) * stride - pad
    base_x = torch.arange(Wo, dtype=ct, device=dev) * stride - pad
    py = base_y[None, :, None, None] + grid_y[None, None, None, :] + offset_y.to(ct)
    px = base_x[None, None, :, None] + grid_x[None, None, None, :] + offset_x.to(ct)
    Q = Ho * Wo * P
    img = x.to(ct).reshape(N, H, W, 1, C)
    sampled = _bilinear_gather(img, px.reshape(N, Q, 1), py.reshape(N, Q, 1))
    sampled = sampled.reshape(N, Ho, Wo, P, C) * mask.to(ct)[..., None]
    return sampled.reshape(N, Ho * Wo, P * C).to(x.dtype)


def dcnv2_im2col(x, offset_y, offset_x, mask, k: int = 3, stride: int = 1, pad: int = 1, row0: int = 0) -> torch.Tensor:
    """DCNv2's modulated sampling as columns: for each output pixel and
    kernel point p = ky*k + kx, the bilinear sample of x at
    (oy*stride - pad + ky + dy, ox*stride - pad + kx + dx), zeros outside,
    times the (sigmoid) mask, interpolated in f32 and rounded once.

    x (N, H, W, C); offset_y, offset_x, mask (N, Ho, Wo, P) ->
    (N, Ho*Wo, P*C), p-major to match the weight's (P, C, c2) flattening.
    A CPU tensor runs `dcnv2_im2col_reference`; CUDA tensors (float32 or
    bfloat16, one dtype, contiguous) launch the kernel on the current
    stream and count the launch in `dcnv2_im2col.launches`. Where autograd
    records and an input needs a gradient, the call goes through
    Dcnv2Im2colFunction (on the CPU too), whose backward is
    `dcnv2_im2col_bwd`. `row0` > 0 (output rows from row0 on, of the whole
    map x) takes no gradient."""
    _check_v2(x, offset_y, offset_x, mask, k, row0)
    if x.device.type != "cpu":
        _check_cuda("dcnv2_im2col", (x, offset_y, offset_x, mask))
        _check_v2_size(x, offset_y)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, offset_y, offset_x, mask)):
        _no_grad_at(row0, "dcnv2_im2col")
        return Dcnv2Im2colFunction.apply(x, offset_y, offset_x, mask, k, stride, pad)
    return _v2_forward(x, offset_y, offset_x, mask, k, stride, pad, row0)


def _check_v2_size(x, offset_y) -> None:
    if x.shape[0] * math.prod(offset_y.shape[1:]) * x.shape[-1] >= 2**31:
        raise ValueError("dcnv2_im2col: the columns would have 2**31 elements or more")


def _v2_forward(x, offset_y, offset_x, mask, k: int, stride: int, pad: int, row0: int = 0) -> torch.Tensor:
    """dcnv2_im2col on checked inputs: the plain version for CPU tensors,
    the kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return dcnv2_im2col_reference(x, offset_y, offset_x, mask, k, stride, pad, row0)
    N, H, W, C = x.shape
    _, Ho, Wo, P = offset_y.shape
    cols = torch.empty((N, Ho * Wo, P * C), device=x.device, dtype=x.dtype)
    vec, lanes, _ = _v2_geometry(C, x.element_size(), x.data_ptr() % 16 == 0 and cols.data_ptr() % 16 == 0)
    fn = _entry("dcnv2_im2col", x.dtype)
    _launch("dcnv2_im2col", fn, (x, offset_y, offset_x, mask, cols),
            (N, H, W, C, Ho, Wo, k, stride, pad, row0, vec, lanes))
    dcnv2_im2col.launches += 1
    return cols


dcnv2_im2col.launches = 0


class Dcnv2Im2colFunction(torch.autograd.Function):
    """dcnv2_im2col under autograd: the forward of `dcnv2_im2col` (kernel or
    plain version, by device), and a backward of one `dcnv2_im2col_bwd`
    call, made where any of x, the offsets and the mask needs a gradient
    (x's scatter only where x does)."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, offset_y, offset_x, mask, k, stride, pad):
        ctx.save_for_backward(x, offset_y, offset_x, mask)
        ctx.geometry = (k, stride, pad)
        return _v2_forward(x, offset_y, offset_x, mask, k, stride, pad)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dcols):
        x, offset_y, offset_x, mask = ctx.saved_tensors
        need = ctx.needs_input_grad[:4]
        grads = dcnv2_im2col_bwd(x, offset_y, offset_x, mask, dcols.contiguous().to(x.dtype), *ctx.geometry,
                                 need_x=need[0])
        return tuple(g if n else None for g, n in zip(grads, need)) + (None, None, None)


def dcnv2_im2col_backward_reference(x, offset_y, offset_x, mask, dcols, k: int = 3, stride: int = 1,
                                    pad: int = 1) -> tuple:
    """Plain version of `dcnv2_im2col_bwd`: autograd of
    dcnv2_im2col_reference. Returns (dx, doffset_y, doffset_x, dmask)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, offset_y, offset_x, mask)]
        return torch.autograd.grad(dcnv2_im2col_reference(*leaves, k, stride, pad), leaves, dcols)


def dcnv2_im2col_bwd(x, offset_y, offset_x, mask, dcols, k: int = 3, stride: int = 1, pad: int = 1,
                     need_x: bool = True) -> tuple:
    """The gradient of dcnv2_im2col: dcols (N, Ho*Wo, P*C), p-major as the
    forward writes it -> (dx, doffset_y, doffset_x, dmask), each in its
    input's dtype, the derivative at integer coordinates one-sided as
    JAX's (`_corner_weight`); dx is None when not `need_x`. A CPU tensor
    runs the plain version; CUDA tensors (one dtype, contiguous) launch
    the kernel of csrc/dcn_bwd.cu under `_v2_bwd_plan`, which gathers dx
    over a window around each tile of output pixels and adds it with f32
    atomics into a zeroed f32 buffer (cast once to bf16; the order of the
    adds varies from call to call; the other three repeat bitwise), and
    count the launch in `dcnv2_im2col_bwd.launches`."""
    _check_v2(x, offset_y, offset_x, mask, k)
    N, H, W, C = x.shape
    _, Ho, Wo, P = offset_y.shape
    if tuple(dcols.shape) != (N, Ho * Wo, P * C):
        raise ValueError(f"dcols {tuple(dcols.shape)} does not match the columns {(N, Ho * Wo, P * C)}")
    if x.device.type == "cpu":
        grads = dcnv2_im2col_backward_reference(x, offset_y, offset_x, mask, dcols, k, stride, pad)
        return (grads[0] if need_x else None, *grads[1:])
    _check_cuda("dcnv2_im2col_bwd", (x, offset_y, offset_x, mask, dcols))
    _check_v2_size(x, offset_y)
    plan = _v2_bwd_plan(N, C, Ho, Wo, k, stride, x.element_size(), _aligned16(x, dcols))
    dx, doffset_y, doffset_x, dmask = _v2_bwd_launch(x, offset_y, offset_x, mask, dcols, k, stride, pad, plan, need_x)
    dcnv2_im2col_bwd.launches += 1
    return (dx.to(x.dtype) if need_x else None), doffset_y, doffset_x, dmask


def _v2_bwd_launch(x, offset_y, offset_x, mask, dcols, k: int, stride: int, pad: int, plan: BwdPlan,
                   need_x: bool = True) -> tuple:
    """dcnv2_im2col_bwd's kernel under `plan` on checked CUDA tensors: (f32
    dx or None, doffset_y, doffset_x, dmask)."""
    N, H, W, C = x.shape
    _, Ho, Wo, _ = offset_y.shape
    dx = torch.zeros((N, H, W, C), device=x.device, dtype=torch.float32) if need_x else None
    doffset_y, doffset_x, dmask = (torch.empty_like(t) for t in (offset_y, offset_x, mask))
    _launch("dcnv2_im2col_bwd", _entry("dcnv2_im2col_bwd", x.dtype),
            (x, offset_y, offset_x, mask, dcols, dx, doffset_y, doffset_x, dmask, _workspace(plan, mask)),
            (N, H, W, C, Ho, Wo, k, stride, pad, *_bwd_args(plan)))
    return dx, doffset_y, doffset_x, dmask


dcnv2_im2col_bwd.launches = 0


def dcnv2_columns(*args, **kwargs) -> torch.Tensor:
    """What DCNv2 calls: `dcnv2_im2col`, or its plain version inside
    `plain_version()`."""
    return (dcnv2_im2col_reference if plain_active() else dcnv2_im2col)(*args, **kwargs)
