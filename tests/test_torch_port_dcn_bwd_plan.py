"""The launch plans of the DCN gradient kernels (csrc/dcn_bwd.cu), on the
CPU: `_v2_bwd_plan` / `_v3_bwd_plan` and the kernels' index arithmetic
that uses them.

A block of either kernel takes a tile of output pixels (of one image and,
for DCNv3, one group) and a slice of channels. It lists the corners that
land in a window around the tile by window pixel, in shared memory, and
gathers each pixel's list before one add to the global buffer; a corner
whose offset reaches past the window adds straight to the global buffer.
These tests repeat the kernel's block -> (slice, tile, group, image)
decomposition and its window test from the plan, and hold:
- every (pixel, point) pair in exactly one block per slice, every channel
  in exactly one slice and lane, and the shared memory within an H100
  block's (two blocks an SM where the tile can shrink);
- the window and spill routes together giving the plain backward's input
  gradient (float64, 1e-6 relative: only the order of the sums differs),
  at zero offsets (nothing spills), random offsets of +-4 pixels (a few
  corners spill), offsets past the border (more do) and offsets of 20
  pixels (every corner spills).
"""

import math

import numpy as np
import pytest
import torch

from tests._torch_port_common import few_threads  # noqa: F401
from yolosomi_tpu_torch.ops import dcn as ops_dcn
from yolosomi_tpu_torch.ops.dcn import (_v2_bwd_plan, _v3_bwd_plan, dcnv2_im2col_backward_reference,
                                        dcnv3_core_backward_reference, dcnv3_points)


def check_plan(plan, N, G, Cg, Ho, Wo, kh, kw, sh, sw, dh, dw, elem_size, aligned):
    """The plan's invariants, and the kernel's cover of pairs and channels."""
    P = kh * kw
    full_vec = 16 // elem_size
    assert plan.vec == (full_vec if aligned and Cg % full_vec == 0 else 1)
    assert plan.lanes in (1, 2, 4, 8, 16, 32) and plan.cs == plan.vec * plan.lanes <= ops_dcn._BWD_SLICE
    words = plan.th * plan.tw * P * ops_dcn._BWD_PAIR_WORDS + plan.fh * plan.fw * ops_dcn._BWD_PIXEL_WORDS + 1
    assert plan.smem == words * 4 <= ops_dcn._SMEM_BLOCK
    if plan.th * plan.tw > 1:
        assert plan.smem <= ops_dcn._SMEM_SM // 2 - ops_dcn._SMEM_RESERVED
    full = ((plan.th - 1) * sh + dh * (kh - 1) + 2 + 2 * plan.halo,
            (plan.tw - 1) * sw + dw * (kw - 1) + 2 + 2 * plan.halo)
    assert (plan.fh, plan.fw) == full or plan.th * plan.tw == 1  # clipped only where one pixel's does not fit
    ty, tx = math.ceil(Ho / plan.th), math.ceil(Wo / plan.tw)
    assert plan.slices == math.ceil(Cg / plan.cs) and plan.blocks == N * G * ty * tx * plan.slices
    # the kernel's block decomposition, slice fastest
    b = np.arange(plan.blocks)
    sl, r = b % plan.slices, b // plan.slices
    tile_x, r = r % tx, r // tx
    tile_y, r = r % ty, r // ty
    g, n = r % G, r // G
    assert n.max() == N - 1
    t = np.arange(plan.th * plan.tw * P)
    p, i = t // (plan.th * plan.tw), t % (plan.th * plan.tw)
    oy = tile_y[:, None] * plan.th + i // plan.tw
    ox = tile_x[:, None] * plan.tw + i % plan.tw
    live = (oy < Ho) & (ox < Wo)
    q = (((n[:, None] * Ho + oy) * Wo + ox) * G + g[:, None]) * P + p
    for s in range(plan.slices):
        mine = live & (sl == s)[:, None]
        assert (np.bincount(q[mine], minlength=N * Ho * Wo * G * P) == 1).all(), s
    # lane l of slice s: channels s*cs + l*vec .. + vec, where below Cg
    c0 = (np.arange(plan.slices)[:, None] * plan.cs + np.arange(plan.lanes) * plan.vec).ravel()
    chans = (c0[c0 < Cg][:, None] + np.arange(plan.vec)).ravel()
    assert np.array_equal(np.sort(chans), np.arange(Cg))


V2_SITES = [(8, 40, 40, 256, 1), (8, 20, 20, 512, 1),  # yolo-somi-dcn rows 6 and 8 at 640 px
            (2, 4, 4, 64, 1), (2, 2, 2, 128, 1),  # the same rows at width 0.25, 64 px
            (2, 9, 11, 5, 1), (1, 13, 7, 40, 2), (3, 6, 6, 1, 1), (2, 12, 10, 256, 1), (1, 9, 7, 512, 2)]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("elem_size", [4, 2])
@pytest.mark.parametrize("site", V2_SITES + [(2, 11, 13, C, s) for C in (1, 5, 40, 256, 512) for s in (1, 2)])
def test_v2_bwd_plan_covers_every_pair_and_channel_once(site, elem_size, aligned):
    N, H, W, C, s = site
    Ho, Wo = (H - 1) // s + 1, (W - 1) // s + 1  # k 3, pad 1
    plan = _v2_bwd_plan(N, C, Ho, Wo, 3, s, elem_size, aligned)
    check_plan(plan, N, 1, C, Ho, Wo, 3, 3, s, s, 1, 1, elem_size, aligned)


V3_SITES = [(8, 20, 20, 8, 128, 3, 1, 1),  # yolo-somi-dcn row 10 at 640 px
            (2, 2, 2, 8, 32, 3, 1, 1),  # at width 0.25, 64 px
            (2, 9, 11, 4, 5, 3, 1, 1), (1, 13, 7, 8, 16, 3, 2, 2), (3, 6, 6, 1, 33, 3, 1, 1),
            (1, 10, 9, 16, 8, 5, 1, 1)]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("elem_size", [4, 2])
@pytest.mark.parametrize("site", V3_SITES + [(1, 9, 7, 3, Cg, 3, s, 1) for Cg in (1, 2, 5, 33, 128) for s in (1, 2)])
def test_v3_bwd_plan_covers_every_pair_and_channel_once(site, elem_size, aligned):
    N, H, W, G, Cg, k, s, dil = site
    pad = k // 2
    Ho = (H + 2 * pad - (dil * (k - 1) + 1)) // s + 1
    Wo = (W + 2 * pad - (dil * (k - 1) + 1)) // s + 1
    plan = _v3_bwd_plan(N, G, Cg, Ho, Wo, k, k, s, s, dil, dil, elem_size, aligned)
    check_plan(plan, N, G, Cg, Ho, Wo, k, k, s, s, dil, dil, elem_size, aligned)


def test_plans_at_the_training_sites():
    """yolo-somi-dcn at 640 px, b8, bf16: 4 x 4 tiles, 128-channel slices
    of 16 lanes (8 channels a lane), an 11 x 11 window, 7.3 KB of shared
    memory (the registers allow four blocks an SM)."""
    row6 = _v2_bwd_plan(8, 256, 40, 40, 3, 1, 2)
    row8 = _v2_bwd_plan(8, 512, 20, 20, 3, 1, 2)
    row10 = _v3_bwd_plan(8, 8, 128, 20, 20, 3, 3, 1, 1, 1, 1, 2)
    for plan, slices, blocks in ((row6, 2, 1600), (row8, 4, 800), (row10, 1, 1600)):
        assert plan == ops_dcn.BwdPlan(8, 16, 128, slices, 4, 4, 2, 11, 11, blocks, 7308), plan


def test_a_window_too_large_for_a_block_is_clipped():
    """A dilation of 200 leaves even a one-pixel tile's field past 227 KB:
    the window is clipped (the corners past it add to global memory)."""
    plan = _v3_bwd_plan(1, 2, 128, 100, 100, 3, 3, 1, 1, 200, 200, 4)
    assert plan.th == plan.tw == 1 and plan.fh * plan.fw < 403 ** 2 and plan.smem <= ops_dcn._SMEM_BLOCK
    check_plan(plan, 1, 2, 128, 100, 100, 3, 3, 1, 1, 200, 200, 4, True)


def route(plan, n, g, oy, ox, px, py, H, W, sh, sw, ph, pw):
    """The kernel's routing of each corner: its map pixel (yc, xc), its
    weight (0 off the map), and whether it lies in its block's window (at
    window pixel (wy, wx)) or spills. Arguments are (pairs,) tensors."""
    y_lo = (oy // plan.th) * plan.th * sh - ph - plan.halo
    x_lo = (ox // plan.tw) * plan.tw * sw - pw - plan.halo
    x0, y0 = torch.floor(px), torch.floor(py)
    fx, fy = px - x0, py - y0
    out = []
    for k in range(4):
        xc, yc = x0.long() + (k & 1), y0.long() + (k >> 1)
        inside = (xc >= 0) & (xc <= W - 1) & (yc >= 0) & (yc <= H - 1)
        w = (fx if k & 1 else 1 - fx) * (fy if k >> 1 else 1 - fy) * inside
        wy, wx = yc - y_lo, xc - x_lo
        in_window = (wy >= 0) & (wy < plan.fh) & (wx >= 0) & (wx < plan.fw)
        out.append((yc, xc, w, inside & (w != 0), in_window, wy, wx))
    return out


def emulate_dinput(plan, x_shape, G, pairs, g_rows, H, W, sh, sw, ph, pw):
    """The input gradient as the kernel builds it, in float64: each
    corner's m * w * g into its block's window or, past it, into the
    global buffer; then each window added into the global buffer at its
    on-map pixels. Returns (dinput, corners sent to windows, corners
    spilled)."""
    N, _, _, C = x_shape
    Cg = C // G
    n, g, oy, ox, px, py, m = pairs
    ty, tx = int(oy.max()) // plan.th + 1, int(ox.max()) // plan.tw + 1  # tiles a column and a row
    block = ((n * G + g) * ty + oy // plan.th) * tx + ox // plan.tw
    windows = torch.zeros(N * G * ty * tx, plan.fh, plan.fw, Cg, dtype=torch.float64)
    dinput = torch.zeros(N, H, W, G, Cg, dtype=torch.float64)
    sent = spilled = 0
    for yc, xc, w, adds, in_window, wy, wx in route(plan, n, g, oy, ox, px, py, H, W, sh, sw, ph, pw):
        add = (m * w)[:, None] * g_rows
        a, b = adds & in_window, adds & ~in_window
        windows.index_put_((block[a], wy[a], wx[a]), add[a], accumulate=True)
        dinput.index_put_((n[b], yc[b], xc[b], g[b]), add[b], accumulate=True)
        sent, spilled = sent + int(a.sum()), spilled + int(b.sum())
    # the flush: every window pixel on the map
    blk = torch.arange(windows.shape[0])
    bx, r = blk % tx, blk // tx
    by, r = r % ty, r // ty
    bg, bn = r % G, r // G
    wy, wx = torch.meshgrid(torch.arange(plan.fh), torch.arange(plan.fw), indexing="ij")
    y = (by * plan.th * sh - ph - plan.halo)[:, None, None] + wy
    xx = (bx * plan.tw * sw - pw - plan.halo)[:, None, None] + wx
    on = (y >= 0) & (y < H) & (xx >= 0) & (xx < W)
    bi = blk[:, None, None].expand_as(on)
    dinput.index_put_((bn[bi[on]], y[on], xx[on], bg[bi[on]]), windows[bi[on], wy.expand_as(on)[on],
                                                                       wx.expand_as(on)[on]], accumulate=True)
    return dinput.reshape(N, H, W, C), sent, spilled


def draw(rng, shape, offsets):
    if offsets == "zero":
        return np.zeros(shape)
    if offsets == "random":  # chip_smoke.py's +-4 px
        return (rng.random(shape) - 0.5) * 8
    if offsets == "far":  # 12 to 13 px: every corner past its window (halo 2 of a 4 x 4 tile)
        return 12.0 + rng.random(shape)
    return rng.choice([-1.0, 1.0], shape) * rng.uniform(4.0, 9.0, shape)  # "border": 4-9 px, many off the map


def rel(a, ref):
    return ((a - ref).norm() / ref.norm()).item()


@pytest.mark.parametrize("offsets", ["zero", "random", "border", "far"])
@pytest.mark.parametrize("s", [1, 2])
def test_dcnv2_windows_and_spills_give_the_plain_dx(offsets, s):
    """dcnv2_im2col_bwd's dx route at a 20 x 23 map (3 x 3 tiles of 8 x 8
    pixels at stride 1, ragged), in float64."""
    rng = np.random.default_rng(10 * s + len(offsets))
    N, H, W, C, k, p = 2, 20, 23, 6, 3, 1
    Ho, Wo, P = (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1, k * k
    x = torch.from_numpy(rng.standard_normal((N, H, W, C)))
    oy, ox = (torch.from_numpy(draw(rng, (N, Ho, Wo, P), offsets)) for _ in range(2))
    mask = torch.from_numpy(rng.random((N, Ho, Wo, P)))
    dcols = torch.from_numpy(rng.standard_normal((N, Ho * Wo, P * C)))
    plan = _v2_bwd_plan(N, C, Ho, Wo, k, s, 4)
    nn, yy, xx, pp = torch.meshgrid(*(torch.arange(d) for d in (N, Ho, Wo, P)), indexing="ij")
    py = (yy * s - p + pp // k).double() + oy
    px = (xx * s - p + pp % k).double() + ox
    pairs = [t.reshape(-1) for t in (nn, torch.zeros_like(nn), yy, xx, px, py, mask)]
    got, sent, spilled = emulate_dinput(plan, x.shape, 1, pairs, dcols.reshape(-1, C), H, W, s, s, p, p)
    want = dcnv2_im2col_backward_reference(x, oy, ox, mask, dcols, k, s, p)[0]
    assert rel(got, want) <= 1e-6
    assert (sent > 0) == (offsets != "far") and (spilled > 0) == (offsets != "zero")


@pytest.mark.parametrize("offsets", ["zero", "random", "border", "far"])
@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (5, 1)])
def test_dcnv3_windows_and_spills_give_the_plain_dvalue(offsets, k, s):
    """dcnv3_core_bwd's dvalue route at an 18 x 21 map of two groups, the
    kernel's closed-form coordinates, in float64."""
    rng = np.random.default_rng(100 * k + 10 * s + len(offsets))
    N, H, W, G, Cg, dil = 2, 18, 21, 2, 3, 1
    pad, P = k // 2, k * k
    Ho = (H + 2 * pad - (dil * (k - 1) + 1)) // s + 1
    Wo = (W + 2 * pad - (dil * (k - 1) + 1)) // s + 1
    value = torch.from_numpy(rng.standard_normal((N, H, W, G * Cg)))
    offset = torch.from_numpy(draw(rng, (N, Ho, Wo, G * P * 2), offsets))
    logits = rng.standard_normal((N, Ho, Wo, G, P))
    mask = torch.from_numpy(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).reshape(N, Ho, Wo, G * P)
    dout = torch.from_numpy(rng.standard_normal((N, Ho, Wo, G * Cg)))
    args = (k, k, s, s, pad, pad, dil, dil, G, Cg)
    plan = _v3_bwd_plan(N, G, Cg, Ho, Wo, k, k, s, s, dil, dil, 4)
    px, py = dcnv3_points(offset, H, W, *args[:9], closed_form=True)  # (N, Ho, Wo, G, P)
    nn, yy, xx, gg, _ = torch.meshgrid(*(torch.arange(d) for d in (N, Ho, Wo, G, P)), indexing="ij")
    pairs = [t.reshape(-1) for t in (nn, gg, yy, xx, px, py, mask.reshape(N, Ho, Wo, G, P))]
    g_rows = dout.reshape(N, Ho, Wo, G, 1, Cg).expand(N, Ho, Wo, G, P, Cg).reshape(-1, Cg)
    got, sent, spilled = emulate_dinput(plan, value.shape, G, pairs, g_rows, H, W, s, s, pad, pad)
    want = dcnv3_core_backward_reference(value, offset, mask, dout, *args)[0]
    assert rel(got, want) <= 1e-6
    assert (sent > 0) == (offsets != "far") and (spilled > 0) == (offsets != "zero")
