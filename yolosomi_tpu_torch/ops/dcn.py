"""Deformable sampling for DCNv3 and DCNv2 (counterparts of
yolosomi_tpu/ops/dcn.py `_bilinear_gather` + `dcnv3_core`, :34-124, and
DCNv2's modulated sampling, :209-233).

`dcnv3_core` and `dcnv2_im2col` launch the hand-written CUDA kernels of
csrc/dcn.cu for CUDA tensors and run their plain versions for CPU
tensors. There is no fallback: on CUDA each launches its kernel or raises.
The kernels have no backward yet: on CUDA, where autograd records and an
input needs a gradient, both raise (DCN_NO_BACKWARD) rather than hand
back an output that would carry none. The plain versions train.

The plain versions copy the JAX arithmetic with `torch.gather`. They
compute in float32, or in float64 when given float64, and cast back to
the input's dtype.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from yolosomi_tpu_torch.ops import build, plain_active

_SOURCE = "dcn.cu"
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# threads per block of dcnv3_core and dcnv2_im2col, and the most pairs a
# dcnv2_im2col lane group writes (csrc/dcn.cu V3_THREADS, V2_THREADS,
# V2_PAIRS)
_V3_THREADS = 256
_V2_THREADS, _V2_PAIRS = 256, 4
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# C signatures (csrc/dcn.cu), without the trailing stream pointer
_ARGTYPES = {
    "dcnv3_core": [_PTR] * 4 + [_INT] * 15 + [ctypes.c_float] + [_INT] * 2,
    "dcnv2_im2col": [_PTR] * 5 + [_INT] * 11,
}


def _entry(name: str, dtype: torch.dtype):
    """The C entry point `<name>_<f32|bf16>`, built and loaded on first use."""
    fn = getattr(build.load(_SOURCE), f"{name}_{_DTYPES[dtype]}")
    fn.argtypes = _ARGTYPES[name] + [_PTR]
    fn.restype = ctypes.c_int
    return fn


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """float64 stays float64; everything else samples in float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


DCN_NO_BACKWARD = ("has no backward kernel yet, so it cannot train on CUDA (the DCN backwards, ROADMAP queue A "
                   "item 5); run without gradients, or train yolo-somi-dcn on the CPU")


def _check_cuda(name: str, tensors) -> None:
    """What the kernels take: one CUDA device, one dtype of float32 or
    bfloat16, contiguous, 32-bit sizes; and no gradient asked of them."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} {DCN_NO_BACKWARD}")
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
    with torch.cuda.device(ptrs[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in ptrs), *ints, *extra, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


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
        w = (1.0 - (px - xc).abs()).abs() * (1.0 - (py - yc).abs()).abs()
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


def _check_v3(input, offset, mask, kernel_h, kernel_w, group, group_channels):
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


def dcnv3_core_reference(input, offset, mask, kernel_h: int, kernel_w: int, stride_h: int, stride_w: int,
                         pad_h: int, pad_w: int, dilation_h: int, dilation_w: int, group: int, group_channels: int,
                         offset_scale: float = 1.0) -> torch.Tensor:
    """Plain version of `dcnv3_core`: the JAX arithmetic (dcn.py:59-124),
    reference points normalised over the padded canvas included."""
    _check_v3(input, offset, mask, kernel_h, kernel_w, group, group_channels)
    ct = _compute_dtype(input.dtype)
    dev = input.device
    x = F.pad(input, (0, 0, pad_w, pad_w, pad_h, pad_h))
    N, H_, W_, _ = x.shape
    _, Hout, Wout, _ = offset.shape
    P = kernel_h * kernel_w
    G, Cg = group, group_channels

    base_y = (dilation_h * (kernel_h - 1)) // 2 + 0.5
    base_x = (dilation_w * (kernel_w - 1)) // 2 + 0.5
    ref_y = (base_y + torch.arange(Hout, dtype=ct, device=dev) * stride_h) / H_
    ref_x = (base_x + torch.arange(Wout, dtype=ct, device=dev) * stride_w) / W_
    ref = torch.stack([ref_x[None, :].expand(Hout, Wout), ref_y[:, None].expand(Hout, Wout)], -1)

    # the grid is built (kw, kh) and flattened: p = ix*kh + iy, kernel-y fastest
    gx = -((dilation_w * (kernel_w - 1)) // 2) + torch.arange(kernel_w, dtype=ct, device=dev) * dilation_w
    gy = -((dilation_h * (kernel_h - 1)) // 2) + torch.arange(kernel_h, dtype=ct, device=dev) * dilation_h
    grid = torch.stack(
        [gx[:, None].expand(kernel_w, kernel_h) / W_, gy[None, :].expand(kernel_w, kernel_h) / H_], -1
    ).reshape(P, 2)

    off = offset.reshape(N, Hout, Wout, G, P, 2).to(ct)
    spatial_norm = torch.tensor([W_, H_], dtype=ct, device=dev)
    loc = (ref[None, :, :, None, None, :] + grid[None, None, None, None] * offset_scale
           + off * offset_scale / spatial_norm)  # (N, Hout, Wout, G, P, 2) normalised

    px = loc[..., 0] * W_ - 0.5
    py = loc[..., 1] * H_ - 0.5
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


def dcnv3_core(input, offset, mask, kernel_h: int, kernel_w: int, stride_h: int, stride_w: int, pad_h: int,
               pad_w: int, dilation_h: int, dilation_w: int, group: int, group_channels: int,
               offset_scale: float = 1.0) -> torch.Tensor:
    """DCNv3's sampling: for each output pixel and group, the P = kh*kw
    points, each a bilinear sample of the zero-padded input at its learned
    offset, weighted by the softmax mask and summed over P, in f32.

    input (N, H, W, G*Cg), offset (N, Ho, Wo, G*P*2) with (x, y)
    interleaved per (g, p), mask (N, Ho, Wo, G*P) -> (N, Ho, Wo, G*Cg) in
    input.dtype. A CPU tensor runs `dcnv3_core_reference`; CUDA tensors
    (float32 or bfloat16, one dtype, contiguous; any kernel size and group
    count) launch the kernel on the current stream and count the launch in
    `dcnv3_core.launches`."""
    args = (kernel_h, kernel_w, stride_h, stride_w, pad_h, pad_w, dilation_h, dilation_w, group, group_channels)
    _check_v3(input, offset, mask, kernel_h, kernel_w, group, group_channels)
    if input.device.type == "cpu":
        return dcnv3_core_reference(input, offset, mask, *args, offset_scale=offset_scale)
    _check_cuda("dcnv3_core", (input, offset, mask))
    N, H, W, C = input.shape
    _, Ho, Wo, _ = offset.shape
    out = torch.empty((N, Ho, Wo, C), device=input.device, dtype=input.dtype)
    vec, lanes = _v3_geometry(group_channels, input.element_size(),
                              input.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    _launch("dcnv3_core", _entry("dcnv3_core", input.dtype), (input, offset, mask, out),
            (N, H, W, group, group_channels, Ho, Wo, *args[:8]), (float(offset_scale), vec, lanes))
    dcnv3_core.launches += 1
    return out


dcnv3_core.launches = 0


def dcnv3_sampling(*args, **kwargs) -> torch.Tensor:
    """What DCNv3 calls: `dcnv3_core`, or its plain version inside
    `plain_version()`."""
    return (dcnv3_core_reference if plain_active() else dcnv3_core)(*args, **kwargs)


# ---------------------------------------------------------------------------
# DCNv2
# ---------------------------------------------------------------------------


def _check_v2(x, offset_y, offset_x, mask, k):
    if x.dim() != 4 or offset_y.dim() != 4:
        raise ValueError(f"expected x (N,H,W,C) and offsets (N,Ho,Wo,P), got {tuple(x.shape)} "
                         f"{tuple(offset_y.shape)}")
    n, ho, wo, p = offset_y.shape
    if n != x.shape[0] or p != k * k or tuple(offset_x.shape) != (n, ho, wo, p) or tuple(mask.shape) != (n, ho, wo, p):
        raise ValueError(f"offset_y {tuple(offset_y.shape)}, offset_x {tuple(offset_x.shape)} and mask "
                         f"{tuple(mask.shape)} must all be (N, Ho, Wo, {k * k}) for x {tuple(x.shape)}")


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


def dcnv2_im2col_reference(x, offset_y, offset_x, mask, k: int = 3, stride: int = 1, pad: int = 1) -> torch.Tensor:
    """Plain version of `dcnv2_im2col`: the JAX arithmetic (dcn.py:220-233)."""
    _check_v2(x, offset_y, offset_x, mask, k)
    ct = _compute_dtype(x.dtype)
    dev = x.device
    N, H, W, C = x.shape
    _, Ho, Wo, P = offset_y.shape
    kk = torch.arange(k, dtype=ct, device=dev)
    grid_y = kk[:, None].expand(k, k).reshape(P)  # p = ky*k + kx
    grid_x = kk[None, :].expand(k, k).reshape(P)
    base_y = torch.arange(Ho, dtype=ct, device=dev) * stride - pad
    base_x = torch.arange(Wo, dtype=ct, device=dev) * stride - pad
    py = base_y[None, :, None, None] + grid_y[None, None, None, :] + offset_y.to(ct)
    px = base_x[None, None, :, None] + grid_x[None, None, None, :] + offset_x.to(ct)
    Q = Ho * Wo * P
    img = x.to(ct).reshape(N, H, W, 1, C)
    sampled = _bilinear_gather(img, px.reshape(N, Q, 1), py.reshape(N, Q, 1))
    sampled = sampled.reshape(N, Ho, Wo, P, C) * mask.to(ct)[..., None]
    return sampled.reshape(N, Ho * Wo, P * C).to(x.dtype)


def dcnv2_im2col(x, offset_y, offset_x, mask, k: int = 3, stride: int = 1, pad: int = 1) -> torch.Tensor:
    """DCNv2's modulated sampling as columns: for each output pixel and
    kernel point p = ky*k + kx, the bilinear sample of x at
    (oy*stride - pad + ky + dy, ox*stride - pad + kx + dx), zeros outside,
    times the (sigmoid) mask, interpolated in f32 and rounded once.

    x (N, H, W, C); offset_y, offset_x, mask (N, Ho, Wo, P) ->
    (N, Ho*Wo, P*C), p-major to match the weight's (P, C, c2) flattening.
    A CPU tensor runs `dcnv2_im2col_reference`; CUDA tensors (float32 or
    bfloat16, one dtype, contiguous) launch the kernel on the current
    stream and count the launch in `dcnv2_im2col.launches`."""
    _check_v2(x, offset_y, offset_x, mask, k)
    if x.device.type == "cpu":
        return dcnv2_im2col_reference(x, offset_y, offset_x, mask, k, stride, pad)
    _check_cuda("dcnv2_im2col", (x, offset_y, offset_x, mask))
    N, H, W, C = x.shape
    _, Ho, Wo, P = offset_y.shape
    if N * Ho * Wo * P * C >= 2**31:
        raise ValueError("dcnv2_im2col: the columns would have 2**31 elements or more")
    cols = torch.empty((N, Ho * Wo, P * C), device=x.device, dtype=x.dtype)
    vec, lanes, _ = _v2_geometry(C, x.element_size(), x.data_ptr() % 16 == 0 and cols.data_ptr() % 16 == 0)
    fn = _entry("dcnv2_im2col", x.dtype)
    _launch("dcnv2_im2col", fn, (x, offset_y, offset_x, mask, cols), (N, H, W, C, Ho, Wo, k, stride, pad, vec, lanes))
    dcnv2_im2col.launches += 1
    return cols


dcnv2_im2col.launches = 0


def dcnv2_columns(*args, **kwargs) -> torch.Tensor:
    """What DCNv2 calls: `dcnv2_im2col`, or its plain version inside
    `plain_version()`."""
    return (dcnv2_im2col_reference if plain_active() else dcnv2_im2col)(*args, **kwargs)
