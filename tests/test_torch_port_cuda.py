"""yolosomi_tpu_torch's CUDA kernels against their plain versions, and the
entry points that load a checkpoint reaching them, on a GPU.

These tests need a CUDA device and skip without one. The file imports
neither jax nor the JAX package, so it runs on a machine that has only
PyTorch (tests/conftest.py imports jax, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

The gradient kernels (odconv_s2_dx, odconv_s2_dwmix, dcnv2_im2col_bwd,
dcnv3_core_bwd) are held against autograd of the plain version by the
relative norm of the difference: 1e-5 in f32 (summation order only) and
4e-3 in bf16 (one rounding of the output, 2**-9 relative). The DCN
kernels add the input gradient with f32 atomics (into shared-memory
windows, and past them into the global buffer), so it is held to the same
bound on every call rather than repeated bitwise; their offset and mask
gradients are fixed-order sums and repeat bitwise.
"""

import copy
import json

import cv2
import numpy as np
import pytest
import torch
import yaml

from yolosomi_tpu_torch import api
from yolosomi_tpu_torch.engine.checkpoint import save_variables, strip_checkpoint
from yolosomi_tpu_torch.engine.runner import Runner
from yolosomi_tpu_torch.models.dcn import BottleneckDCN, DCNv3, init_dcn_heads, randomize_offset_heads
from yolosomi_tpu_torch.models.yolo import build_model
from yolosomi_tpu_torch.ops import build
from yolosomi_tpu_torch.ops import plain_version
from yolosomi_tpu_torch.ops.dcn import (_v2_bwd_launch, _v2_bwd_plan, dcnv2_im2col, dcnv2_im2col_backward_reference,
                                        dcnv2_im2col_bwd, dcnv2_im2col_reference, dcnv3_core,
                                        dcnv3_core_backward_reference, dcnv3_core_bwd, dcnv3_core_reference,
                                        dcnv3_points)
from yolosomi_tpu_torch import train
from yolosomi_tpu_torch.engine.optim import make_optimizer
from yolosomi_tpu_torch.engine.trainer import create_train_state, make_train_step
from yolosomi_tpu_torch.losses import ComputeLoss
from yolosomi_tpu_torch.losses_v8 import ComputeLossV8
from yolosomi_tpu_torch.models.layers import ODConv2d
from yolosomi_tpu_torch.ops.odconv import (_DW_TILES, _DX_TILES, _TILES, _dw_plan, _dw_split, _plan, _smem_bytes,
                                           odconv_s2, odconv_s2_backward_reference, odconv_s2_dwmix, odconv_s2_dx,
                                           odconv_s2_reference)
from yolosomi_tpu_torch.utils.config import load_hyp
from yolosomi_tpu_torch.utils.config import find_config, load_model_cfg
from yolosomi_tpu_torch.utils.weights import export_jax_variables


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the plain version in full f32
    yield torch.Generator(device="cuda").manual_seed(0)
    torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 22, 38, 24, 72), (2, 16, 16, 8, 128), (1, 12, 20, 128, 256)])
def test_odconv_s2_kernel_matches_plain_version(cuda, dtype, shape):
    """Odd sizes exercise every ragged edge of the 64x64x32 tiles."""
    b, h, w, cin, cout = shape
    x = torch.randn(b, h, w, cin, device="cuda", generator=cuda).to(dtype)
    wmix = (torch.randn(b, 3, 3, cin, cout, device="cuda", generator=cuda) * 0.1).to(dtype)
    before = odconv_s2.launches
    got = odconv_s2(x, wmix)
    torch.cuda.synchronize()
    assert odconv_s2.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, h // 2, w // 2, cout)
    ref = odconv_s2_reference(x.float(), wmix.float())
    # f32: summation order only; bf16: the output rounding (test_odconv_pallas.py:52-54)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32 else dict(atol=0.15, rtol=0.03)
    torch.testing.assert_close(got.float(), ref, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 40, 40, 512, 256), (1, 64, 64, 64, 128), (2, 32, 32, 256, 256),
                                   (8, 160, 160, 64, 128), (8, 80, 80, 256, 256)])
def test_odconv_s2_bf16_plans_match_plain_version_and_repeat_bitwise(cuda, shape):
    """Serving-like widths reaching every launch plan: both tile
    configurations with and without split-K (tests/test_torch_port_odconv.py
    pins which shape gets which). Split-K sums its parts in a fixed order,
    so two calls give the same bits."""
    b, h, w, cin, cout = shape
    x = torch.randn(b, h, w, cin, device="cuda", generator=cuda).bfloat16()
    wmix = (torch.randn(b, 3, 3, cin, cout, device="cuda", generator=cuda) * (2.0 / (9 * cin)) ** 0.5).bfloat16()
    got = odconv_s2(x, wmix)
    again = odconv_s2(x, wmix)
    torch.cuda.synchronize()
    ref = odconv_s2_reference(x.float(), wmix.float())
    torch.testing.assert_close(got.float(), ref, atol=0.15, rtol=0.03)
    assert torch.equal(got, again), _plan(*shape)


@pytest.mark.cuda
def test_odconv_s2_tile_table_matches_the_kernel(cuda):
    lib = build.load("odconv_s2.cu")
    assert [lib.odconv_s2_bf16_smem(cfg) for cfg in sorted(_TILES)] == [_smem_bytes(cfg) for cfg in sorted(_TILES)]
    assert lib.odconv_s2_bf16_smem(len(_TILES)) == -1


@pytest.mark.cuda
def test_odconv_s2_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.randn(2, 8, 8, 16, device="cuda", generator=cuda)
    wmix = torch.randn(2, 3, 3, 16, 32, device="cuda", generator=cuda)
    with pytest.raises(TypeError):
        odconv_s2(x.half(), wmix.half())
    with pytest.raises(TypeError):
        odconv_s2(x, wmix.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        odconv_s2(x.permute(0, 2, 1, 3), wmix)
    with pytest.raises(ValueError, match="one CUDA device"):
        odconv_s2(x, wmix.cpu())
    with pytest.raises(ValueError, match="multiples of 8"):
        odconv_s2(x[..., :12].contiguous().bfloat16(), wmix[:, :, :, :12].contiguous().bfloat16())
    flat = torch.empty(x.numel() + 1, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        odconv_s2(flat[1:].view(x.shape), wmix.bfloat16())


def _dcnv3_case(gen, dtype, n, h, w, g, cg, s, dil, k=3, shifted=None, zero=False, far=False):
    """Inputs of a k x k DCNv3 sampling with pad k // 2; `shifted` ("value"
    or "offset") puts that tensor one element past an aligned address:
    value then misses 16-byte alignment, and offset the alignment of its
    (x, y) pairs; `zero` makes the offsets 0 (the heads' init); `far`
    makes them 20 to 21 pixels (every corner past the gradient kernel's
    window)."""
    pad, P = k // 2, k * k
    ho = (h + 2 * pad - (dil * (k - 1) + 1)) // s + 1
    wo = (w + 2 * pad - (dil * (k - 1) + 1)) // s + 1
    value = torch.randn(n, h, w, g * cg, device="cuda", generator=gen)
    # offsets of several pixels: fractional points, some off the map
    offset = (torch.rand(n, ho, wo, g * P * 2, device="cuda", generator=gen) - 0.5) * 8
    if zero:
        offset.zero_()
    if far:
        offset = offset / 8 + 20.5
    logits = torch.randn(n, ho, wo, g, P, device="cuda", generator=gen) * 2
    mask = torch.softmax(logits, -1).reshape(n, ho, wo, g * P)
    inputs = {"value": value.to(dtype), "offset": offset.to(dtype), "mask": mask.to(dtype)}
    if shifted:
        t = inputs[shifted]
        t = torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(t.shape)
        assert t.is_contiguous() and t.data_ptr() % (16 if shifted == "value" else 2 * t.element_size())
        inputs[shifted] = t
    return list(inputs.values()), (k, k, s, s, pad, pad, dil, dil, g, cg)


# f32: the kernel's closed-form coordinates differ from the plain version's
# normalised round trip in the last bits; the sampling is continuous, so
# that costs ~ulp(px) times the map's slope, well under 1e-4. bf16: the
# same bf16 inputs on both sides, interpolation in f32, one rounding of
# outputs of a few units (2**-9 relative).
_DCN_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4), torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(2, 9, 11, 4, 5, 1, 1), (1, 13, 7, 8, 16, 2, 2), (3, 6, 6, 1, 33, 1, 1),
                                  (2, 20, 20, 8, 128, 1, 1), (1, 9, 7, 3, 2, 1, 1), (1, 10, 9, 16, 8, 1, 1, 5),
                                  (1, 8, 6, 2, 16, 1, 1, 3, "value"), (1, 8, 6, 2, 16, 1, 1, 3, "offset")])
def test_dcnv3_core_kernel_matches_plain_version(cuda, dtype, case):
    """Odd sizes: Cg 5 and 33 one channel a lane, Cg 16 16-byte vectors on
    2 (bf16) or 4 (f32) lanes, a ragged last block; Cg 128 (the serving
    width: 16 lanes of 8 bf16, 32 of 4 f32); Cg 2, 9 points on 2 lanes in
    rounds; k 5 with G 16 (G*P = 400 points a pixel); a value tensor off
    16-byte alignment (one channel a lane); an offset tensor whose (x, y)
    pairs are off their alignment (each pair in two loads)."""
    (value, offset, mask), args = _dcnv3_case(cuda, dtype, *case)
    before = dcnv3_core.launches
    got = dcnv3_core(value, offset, mask, *args)
    torch.cuda.synchronize()
    assert dcnv3_core.launches == before + 1
    assert got.dtype == dtype and got.shape == offset.shape[:3] + (value.shape[-1],)
    ref = dcnv3_core_reference(value.float(), offset.float(), mask.float(), *args)
    torch.testing.assert_close(got.float(), ref, **_DCN_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(2, 9, 11, 5, 1), (1, 13, 7, 40, 2), (3, 6, 6, 1, 1), (2, 12, 10, 256, 1),
                                  (1, 9, 7, 512, 2), (1, 8, 6, 256, 1, "misaligned")])
def test_dcnv2_im2col_kernel_matches_plain_version(cuda, dtype, case):
    """Odd C runs one channel a lane; C = 256 / 512 (the serving widths)
    16-byte vectors; an x that is not 16-byte aligned one channel a lane."""
    n, h, w, c, s = case[:5]
    ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
    x = torch.randn(n, h, w, c, device="cuda", generator=cuda)
    oy, ox = ((torch.rand(2, n, ho, wo, 9, device="cuda", generator=cuda) - 0.5) * 8).unbind(0)
    mask = torch.sigmoid(torch.randn(n, ho, wo, 9, device="cuda", generator=cuda))
    x, oy, ox, mask = (t.to(dtype) for t in (x, oy, ox, mask))
    if len(case) > 5:
        x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(n, h, w, c)
        assert x.is_contiguous() and x.data_ptr() % 16
    before = dcnv2_im2col.launches
    got = dcnv2_im2col(x, oy, ox, mask, 3, s, 1)
    torch.cuda.synchronize()
    assert dcnv2_im2col.launches == before + 1
    assert got.dtype == dtype and got.shape == (n, ho * wo, 9 * c)
    ref = dcnv2_im2col_reference(x.float(), oy.float(), ox.float(), mask.float(), 3, s, 1)
    torch.testing.assert_close(got.float(), ref, **_DCN_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(2, 12, 11, 4, 5, 3), (1, 20, 20, 8, 128, 7), (1, 10, 9, 16, 8, 4, 5)])
def test_dcnv3_core_kernel_at_a_row_origin(cuda, dtype, case):
    """A strip of output rows (row0 .. row0 + 4 of the whole output) of a
    spatially sharded map: the kernel samples the whole value map at the
    strip's rows, within the tolerance of its plain version at row0 and
    bitwise the whole call's rows (the same arithmetic a pixel)."""
    n, h, w, g, cg, row0 = case[:6]
    k = case[6] if len(case) > 6 else 3
    (value, offset, mask), args = _dcnv3_case(cuda, dtype, n, h, w, g, cg, 1, 1, k)
    whole = dcnv3_core(value, offset, mask, *args)
    rows = slice(row0, row0 + 4)
    before = dcnv3_core.launches
    got = dcnv3_core(value, offset[:, rows].contiguous(), mask[:, rows].contiguous(), *args, row0=row0)
    torch.cuda.synchronize()
    assert dcnv3_core.launches == before + 1 and got.shape == whole[:, rows].shape
    ref = dcnv3_core_reference(value.float(), offset[:, rows].float(), mask[:, rows].float(), *args, row0=row0)
    torch.testing.assert_close(got.float(), ref, **_DCN_TOL[dtype])
    assert torch.equal(got, whole[:, rows])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(2, 12, 10, 5, 1, 3), (1, 20, 20, 256, 1, 9), (1, 16, 14, 40, 2, 2)])
def test_dcnv2_im2col_kernel_at_a_row_origin(cuda, dtype, case):
    """As the DCNv3 case: output rows row0 .. row0 + 3 of the whole map x."""
    n, h, w, c, s, row0 = case
    ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
    x = torch.randn(n, h, w, c, device="cuda", generator=cuda)
    oy, ox = ((torch.rand(2, n, ho, wo, 9, device="cuda", generator=cuda) - 0.5) * 8).unbind(0)
    mask = torch.sigmoid(torch.randn(n, ho, wo, 9, device="cuda", generator=cuda))
    x, oy, ox, mask = (t.to(dtype) for t in (x, oy, ox, mask))
    whole = dcnv2_im2col(x, oy, ox, mask, 3, s, 1).view(n, ho, wo, -1)
    rows = slice(row0, row0 + 3)
    part = [t[:, rows].contiguous() for t in (oy, ox, mask)]
    before = dcnv2_im2col.launches
    got = dcnv2_im2col(x, *part, 3, s, 1, row0=row0)
    torch.cuda.synchronize()
    assert dcnv2_im2col.launches == before + 1
    ref = dcnv2_im2col_reference(x.float(), *(t.float() for t in part), 3, s, 1, row0=row0)
    torch.testing.assert_close(got.float(), ref, **_DCN_TOL[dtype])
    assert torch.equal(got.view(n, 3, wo, -1), whole[:, rows])


@pytest.mark.cuda
def test_dcn_kernels_reject_what_they_do_not_take(cuda):
    (value, offset, mask), args = _dcnv3_case(cuda, torch.float32, 1, 6, 6, 2, 4, 1, 1)
    with pytest.raises(TypeError):
        dcnv3_core(value.half(), offset.half(), mask.half(), *args)
    with pytest.raises(TypeError):
        dcnv3_core(value, offset.bfloat16(), mask, *args)
    with pytest.raises(ValueError, match="contiguous"):
        dcnv3_core(value.transpose(1, 2), offset, mask, *args)
    with pytest.raises(ValueError, match="one CUDA device"):
        dcnv3_core(value, offset.cpu(), mask, *args)
    x = torch.randn(1, 6, 6, 3, device="cuda", generator=cuda)
    o = torch.zeros(1, 6, 6, 9, device="cuda")
    with pytest.raises(TypeError):
        dcnv2_im2col(x.double(), o.double(), o.double(), o.double())
    with pytest.raises(ValueError, match="contiguous"):
        dcnv2_im2col(x, o.transpose(1, 2), o, o)
    with pytest.raises(ValueError, match="one CUDA device"):
        dcnv2_im2col(x, o, o, o.cpu())


# ---------------------------------------------------------------------------
# checkpoints and entry points on the card
# ---------------------------------------------------------------------------

KERNELS = (odconv_s2, dcnv2_im2col, dcnv3_core)


def _weights_file(tmp_path, name: str):
    """A width-0.25 / depth-0.33 copy of config `name`, and a weights file of
    it from seed 0 (offset heads randomised) with anchors 1.25 x the
    config's, written through the inverse weight bridge."""
    cfg = dict(load_model_cfg(find_config(name)))
    cfg["width_multiple"], cfg["depth_multiple"] = 0.25, 0.33
    cfg_path = tmp_path / f"{name}-small.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    model, meta = build_model(cfg, nc=3, device="cpu", seed=0)
    randomize_offset_heads(model, seed=0)
    weights = tmp_path / f"{name}.msgpack"
    save_variables(weights, export_jax_variables(model), anchors=meta.anchors_px * 1.25)
    return str(cfg_path), str(weights)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["yolo-somi", "yolo-somi-dcn", "yolo-somi-s"])
def test_runner_from_a_weights_file_reaches_the_kernels(cuda, tmp_path, name):
    cfg, weights = _weights_file(tmp_path, name)
    runner = Runner(cfg, weights, dtype=torch.float32, device="cuda")
    cpu = Runner(cfg, weights, dtype=torch.float32, device="cpu")
    assert runner.meta.nc == 3 and np.array_equal(runner.meta.anchors_px, cpu.meta.anchors_px)
    x = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    before = [k.launches for k in KERNELS]
    got = runner.forward(x)
    torch.cuda.synchronize()
    launched = [k.launches - b for k, b in zip(KERNELS, before)]
    assert launched[0] == 4 and (all(launched[1:]) if name == "yolo-somi-dcn" else not any(launched[1:])), launched
    for g, r in zip(got, cpu.forward(x)):
        torch.testing.assert_close(g.cpu(), r, atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
def test_bf16_strip_file_round_trips_on_the_device(cuda, tmp_path):
    cfg, weights = _weights_file(tmp_path, "yolo-somi")
    stripped = tmp_path / "stripped.msgpack"
    strip_checkpoint(weights, stripped)
    a = Runner(cfg, str(stripped), dtype=torch.bfloat16, device="cuda")
    b = Runner(cfg, weights, dtype=torch.bfloat16, device="cuda")
    for (k, u), v in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(u, v), k
    x = np.random.default_rng(1).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    np.testing.assert_array_equal(a(x), b(x))


@pytest.mark.cuda
def test_autoshape_on_the_device_reaches_every_kernel(cuda, tmp_path):
    cfg, weights = _weights_file(tmp_path, "yolo-somi-dcn")
    model = api.load(cfg, weights, imgsz=64, conf=0.001, device="cuda")
    ims = [np.random.default_rng(2).integers(0, 256, (90, 120, 3), dtype=np.uint8)]
    before = [k.launches for k in KERNELS]
    results = model(ims)
    launched = [k.launches - b for k, b in zip(KERNELS, before)]
    assert launched[0] == 4 and all(launched), launched
    det = results.pred[0]
    assert len(det) and np.isfinite(det).all() and (det[:, [0, 2]] <= 120).all() and (det[:, [1, 3]] <= 90).all()


# ---------------------------------------------------------------------------
# the gradient kernels and training
# ---------------------------------------------------------------------------

GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 4e-3}


def _rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    return ((a.float() - ref).norm() / ref.norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 32, 32, 64, 128), (2, 16, 16, 256, 256), (2, 8, 8, 512, 256),
                                   (3, 22, 38, 24, 72), (2, 320, 320, 64, 128), (2, 18, 26, 120, 40),
                                   (1, 12, 20, 200, 136), (1, 96, 98, 256, 256), (2, 16, 16, 64, 64)])
def test_odconv_s2_gradient_kernels_match_plain_autograd(cuda, dtype, shape):
    """The flagship's channel counts (Cin, Cout) = (64, 128), (256, 256),
    (512, 256), row 1 at batch 2 (dwmix splits its reduction in f32 and
    bf16), and shapes that reach every bf16 tile configuration of both
    kernels, dwmix with and without a split, with ragged rows and columns
    in every parity class and taps inside K steps (Cout 72, 40, 136);
    tests/test_torch_port_odconv.py pins which shape gets which plan. Each
    twice, bitwise."""
    b, h, w, cin, cout = shape
    x = torch.randn(b, h, w, cin, device="cuda", generator=cuda).to(dtype)
    wmix = (torch.randn(b, 3, 3, cin, cout, device="cuda", generator=cuda) * (2.0 / (9 * cin)) ** 0.5).to(dtype)
    dy = torch.randn(b, h // 2, w // 2, cout, device="cuda", generator=cuda).to(dtype)
    before = (odconv_s2_dx.launches, odconv_s2_dwmix.launches)
    dx, dw = odconv_s2_dx(dy, wmix, h, w), odconv_s2_dwmix(x, dy)
    torch.cuda.synchronize()
    assert (odconv_s2_dx.launches, odconv_s2_dwmix.launches) == (before[0] + 1, before[1] + 1)
    assert dx.dtype == dw.dtype == dtype and dx.shape == x.shape and dw.shape == wmix.shape
    rdx, rdw = odconv_s2_backward_reference(x.float(), wmix.float(), dy.float())
    assert _rel(dx, rdx) <= GRAD_TOL[dtype] and _rel(dw, rdw) <= GRAD_TOL[dtype], (_rel(dx, rdx), _rel(dw, rdw))
    assert torch.equal(odconv_s2_dx(dy, wmix, h, w), dx) and torch.equal(odconv_s2_dwmix(x, dy), dw)
    if shape == (2, 320, 320, 64, 128):
        assert _dw_split(b, h, w, cin, cout) > 1 and _dw_plan(b, h, w, cin, cout)[1] > 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 64, 32, 64), (2, 20, 20, 256, 128)])
def test_odconv_s2_kernels_at_yolo_somi_s_sites_match_plain_version(cuda, dtype, shape):
    """yolo-somi-s's (Cin, Cout) at row 1 (32, 64: K = 288, four and a half
    64-channel steps, half of each 128-wide tile idle) and row 32 (256,
    128): the forward and both gradients against the plain version, each
    twice, bitwise."""
    b, h, w, cin, cout = shape
    x = torch.randn(b, h, w, cin, device="cuda", generator=cuda).to(dtype)
    wmix = (torch.randn(b, 3, 3, cin, cout, device="cuda", generator=cuda) * (2.0 / (9 * cin)) ** 0.5).to(dtype)
    dy = torch.randn(b, h // 2, w // 2, cout, device="cuda", generator=cuda).to(dtype)
    y, dx, dw = odconv_s2(x, wmix), odconv_s2_dx(dy, wmix, h, w), odconv_s2_dwmix(x, dy)
    torch.cuda.synchronize()
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32 else dict(atol=0.15, rtol=0.03)
    torch.testing.assert_close(y.float(), odconv_s2_reference(x.float(), wmix.float()), **tol)
    rdx, rdw = odconv_s2_backward_reference(x.float(), wmix.float(), dy.float())
    assert _rel(dx, rdx) <= GRAD_TOL[dtype] and _rel(dw, rdw) <= GRAD_TOL[dtype], (_rel(dx, rdx), _rel(dw, rdw))
    assert torch.equal(odconv_s2(x, wmix), y)
    assert torch.equal(odconv_s2_dx(dy, wmix, h, w), dx) and torch.equal(odconv_s2_dwmix(x, dy), dw)


@pytest.mark.cuda
def test_odconv_s2_gradient_tile_tables_match_the_kernels(cuda):
    lib = build.load("odconv_s2_bwd.cu")
    for kernel, tiles in enumerate((_DX_TILES, _DW_TILES)):
        assert [lib.odconv_s2_bwd_bf16_smem(kernel, cfg) for cfg in sorted(tiles)] == [
            _smem_bytes(cfg, tiles) for cfg in sorted(tiles)]
        assert lib.odconv_s2_bwd_bf16_smem(kernel, len(tiles)) == -1


@pytest.mark.cuda
def test_odconv_s2_under_autograd_launches_only_the_gradients_asked_for(cuda):
    x = torch.randn(2, 16, 16, 64, device="cuda", generator=cuda)
    wmix = torch.randn(2, 3, 3, 64, 128, device="cuda", generator=cuda) * 0.05
    g = torch.randn(2, 8, 8, 128, device="cuda", generator=cuda)
    for need_x, need_w in ((True, True), (True, False), (False, True)):
        xs, ws = x.clone().requires_grad_(need_x), wmix.clone().requires_grad_(need_w)
        before = (odconv_s2.launches, odconv_s2_dx.launches, odconv_s2_dwmix.launches)
        (odconv_s2(xs, ws) * g).sum().backward()
        assert (odconv_s2.launches - before[0], odconv_s2_dx.launches - before[1],
                odconv_s2_dwmix.launches - before[2]) == (1, int(need_x), int(need_w))
        rdx, rdw = odconv_s2_backward_reference(x, wmix, g)
        if need_x:
            assert _rel(xs.grad, rdx) <= GRAD_TOL[torch.float32]
        if need_w:
            assert _rel(ws.grad, rdw) <= GRAD_TOL[torch.float32]
    with torch.autocast("cuda", dtype=torch.bfloat16):  # one dtype is all the kernels take
        with pytest.raises(TypeError):
            odconv_s2(x.bfloat16().requires_grad_(), wmix.requires_grad_())


@pytest.mark.cuda
def test_odconv_s2_gradient_kernels_reject_what_they_do_not_take(cuda):
    x = torch.randn(2, 8, 8, 16, device="cuda", generator=cuda).bfloat16()
    wmix = torch.randn(2, 3, 3, 16, 32, device="cuda", generator=cuda).bfloat16()
    dy = torch.randn(2, 4, 4, 32, device="cuda", generator=cuda).bfloat16()
    before = (odconv_s2_dx.launches, odconv_s2_dwmix.launches)
    with pytest.raises(TypeError):
        odconv_s2_dx(dy.float(), wmix, 8, 8)
    with pytest.raises(ValueError, match="contiguous"):
        odconv_s2_dwmix(x, dy.permute(0, 2, 1, 3))
    with pytest.raises(ValueError, match="does not match"):
        odconv_s2_dx(dy[:, :3], wmix, 8, 8)
    with pytest.raises(ValueError, match="multiples of 8"):
        odconv_s2_dwmix(x[..., :12].contiguous(), dy)
    with pytest.raises(ValueError, match="multiples of 8"):
        odconv_s2_dx(dy[..., :20].contiguous(), wmix[..., :20].contiguous(), 8, 8)
    flat = torch.empty(dy.numel() + 1, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        odconv_s2_dx(flat[1:].view(dy.shape), wmix, 8, 8)
    with pytest.raises(ValueError, match="one CUDA device"):
        odconv_s2_dwmix(x, dy.cpu())
    assert (odconv_s2_dx.launches, odconv_s2_dwmix.launches) == before


def _write_shapes(root, n: int, size: int = 96):
    """n synthetic JPEGs under root/images with one labelled rectangle each."""
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.default_rng(0)
    for i in range(n):
        im = rng.integers(0, 80, (size, size, 3), dtype=np.uint8)
        x0, y0 = (int(v) for v in rng.integers(8, size // 2, 2))
        im[y0:y0 + 30, x0:x0 + 40] = 220
        cv2.imwrite(str(root / "images" / f"{i}.jpg"), im)
        (root / "labels" / f"{i}.txt").write_text(
            f"{i % 3} {(x0 + 20) / size:.6f} {(y0 + 15) / size:.6f} {40 / size:.6f} {30 / size:.6f}\n")
    data = root / "data.yaml"
    data.write_text(yaml.safe_dump({"path": str(root), "train": "images", "val": "images", "nc": 3,
                                    "names": ["a", "b", "c"]}))
    return data


@pytest.mark.cuda
def test_dcn_kernels_return_gradients_on_cuda_and_train_accepts_the_dcn_config(cuda, tmp_path):
    """The calls that raised before the gradient kernels: each now returns
    a gradient through its gradient kernel, equal to the plain version's;
    train.train takes full-width yolo-somi-dcn on CUDA (one epoch at 64
    px on four images) and writes its weights."""
    v = torch.randn(1, 6, 6, 8, device="cuda", generator=cuda).requires_grad_()
    off = torch.zeros(1, 6, 6, 2 * 9, device="cuda")
    mask = torch.full((1, 6, 6, 9), 1 / 9, device="cuda")
    before = (dcnv3_core_bwd.launches, dcnv2_im2col_bwd.launches)
    (gv,) = torch.autograd.grad(dcnv3_core(v, off, mask, 3, 3, 1, 1, 1, 1, 1, 1, 1, 8).sum(), [v])
    oy = torch.zeros(1, 6, 6, 9, device="cuda", requires_grad=True)
    (goy,) = torch.autograd.grad(dcnv2_im2col(v.detach(), oy, oy.detach(), torch.ones(1, 6, 6, 9, device="cuda")).sum(),
                                 [oy])
    torch.cuda.synchronize()
    assert (dcnv3_core_bwd.launches, dcnv2_im2col_bwd.launches) == (before[0] + 1, before[1] + 1)
    ones = torch.ones(1, 6, 6, 8, device="cuda")
    assert _rel(gv, dcnv3_core_backward_reference(v.detach(), off, mask, ones, 3, 3, 1, 1, 1, 1, 1, 1, 1, 8)[0]) < 1e-6
    want = dcnv2_im2col_backward_reference(v.detach(), oy.detach(), oy.detach(), torch.ones_like(oy),
                                           torch.ones(1, 36, 72, device="cuda"))[1]
    assert want.abs().max() > 0 and _rel(goy, want) < 1e-5  # zero offsets: the one-sided derivative
    data = _write_shapes(tmp_path / "ds", 4)
    opt = train.parse_opt(["--cfg", "yolo-somi-dcn", "--data", str(data), "--project", str(tmp_path / "runs"),
                           "--epochs", "1", "--batch-size", "2", "--imgsz", "64", "--noautoanchor", "--workers", "2"])
    train.train(load_hyp(find_config("hyp.visdrone", "hyps")), opt)
    assert (tmp_path / "runs" / "exp" / "weights" / "last.msgpack").exists()


def _same_corners(offset, H, W, args):
    """(N, Ho, Wo, G*P*2) mask of the DCNv3 points whose kernel coordinates
    (closed form, unpadded) and plain-version coordinates (normalised
    round trip, padded) floor to the same corner: f32 rounds them apart in
    the last bits, and a point within an ulp of an integer can land on
    either side of it, where doffset jumps (the one-sided derivative)."""
    pad_h, pad_w = args[4], args[5]
    kx, ky = dcnv3_points(offset.float(), H, W, *args[:9], closed_form=True)
    px, py = dcnv3_points(offset.float(), H, W, *args[:9])
    same = (kx.floor() + pad_w == px.floor()) & (ky.floor() + pad_h == py.floor())
    return same.unsqueeze(-1).expand(*same.shape, 2).reshape(offset.shape)


def _masked_rel(a, ref, keep):
    return _rel(a.float() * keep, ref * keep)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(2, 9, 11, 5, 1), (1, 13, 7, 40, 2), (3, 6, 6, 1, 1), (2, 12, 10, 256, 1),
                                  (1, 9, 7, 512, 2), (1, 8, 6, 256, 1, "misaligned"), (2, 12, 10, 256, 1, "zero"),
                                  (2, 9, 11, 5, 2, "zero"), (2, 13, 21, 64, 1), (2, 48, 44, 128, 1, "far"),
                                  (1, 40, 40, 5, 2, "far"), (1, 17, 19, 6, 1, "misaligned")])
def test_dcnv2_im2col_bwd_kernel_matches_plain_autograd(cuda, dtype, case):
    """dx, both offsets and the mask against autograd of the plain version:
    odd C one channel a lane (VEC 1), C = 256 / 512 (the training widths:
    channel slices split across blocks, their sums added by the second
    pass), x off alignment (VEC 1 at C 256 and 6), zero offsets (integer
    points: the one-sided derivative, 3 of 4 corners of weight 0), strides
    1 and 2, maps of ragged tiles whose windows reach past the border,
    offsets reaching past the border, and offsets of 20 to 21 pixels
    ("far": every corner past its window, to global atomics); each twice,
    both within the bound (the dx adds land in a varying order), the
    offset and mask gradients the same bits both times."""
    n, h, w, c, s = case[:5]
    ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
    x = torch.randn(n, h, w, c, device="cuda", generator=cuda)
    oy, ox = ((torch.rand(2, n, ho, wo, 9, device="cuda", generator=cuda) - 0.5) * 8).unbind(0)
    if "zero" in case:
        oy, ox = torch.zeros_like(oy), torch.zeros_like(ox)
    if "far" in case:
        oy, ox = oy / 8 + 20.5, ox / 8 + 20.5
    mask = torch.sigmoid(torch.randn(n, ho, wo, 9, device="cuda", generator=cuda))
    dcols = torch.randn(n, ho * wo, 9 * c, device="cuda", generator=cuda)
    x, oy, ox, mask, dcols = (t.to(dtype) for t in (x, oy, ox, mask, dcols))
    if "misaligned" in case:
        x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(n, h, w, c)
        assert x.is_contiguous() and x.data_ptr() % 16
    ref = dcnv2_im2col_backward_reference(x.float(), oy.float(), ox.float(), mask.float(), dcols.float(), 3, s, 1)
    calls = []
    for _ in range(2):
        before = dcnv2_im2col_bwd.launches
        got = dcnv2_im2col_bwd(x, oy, ox, mask, dcols, 3, s, 1)
        torch.cuda.synchronize()
        assert dcnv2_im2col_bwd.launches == before + 1
        for g, r, t in zip(got, ref, (x, oy, ox, mask)):
            assert g.dtype == dtype and g.shape == t.shape
            assert _rel(g, r) <= GRAD_TOL[dtype], (_rel(g, r), tuple(t.shape))
        calls.append(got)
    assert all(torch.equal(a, b) for a, b in zip(calls[0][1:], calls[1][1:]))
    assert ref[0].abs().max() > 0
    if "zero" in case:
        assert ref[1].abs().max() > 0 and ref[2].abs().max() > 0
    assert dcnv2_im2col_bwd(x, oy, ox, mask, dcols, 3, s, 1, need_x=False)[0] is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(2, 9, 11, 4, 5, 1, 1), (1, 13, 7, 8, 16, 2, 2), (3, 6, 6, 1, 33, 1, 1),
                                  (2, 20, 20, 8, 128, 1, 1), (1, 9, 7, 3, 2, 1, 1), (1, 10, 9, 16, 8, 1, 1, 5),
                                  (1, 8, 6, 2, 16, 1, 1, 3, "value"), (1, 8, 6, 2, 16, 1, 1, 3, "offset"),
                                  (2, 20, 20, 8, 128, 1, 1, 3, None, True), (1, 9, 7, 3, 5, 2, 1, 3, None, True),
                                  (2, 40, 44, 2, 64, 1, 1, 3, None, False, True), (1, 23, 13, 4, 6, 1, 1)])
def test_dcnv3_core_bwd_kernel_matches_plain_autograd(cuda, dtype, case):
    """dvalue, offset and mask against autograd of the plain version, at
    the forward test's shapes (odd Cg, Cg 128 the training width in two
    channel slices, Cg 2 two lanes a pair, k 5, misaligned value and
    offset), at zero offsets, at offsets of 20 to 21 pixels (every corner
    past its window, to global atomics) and on a map of ragged tiles. doffset
    is compared where the kernel's and the plain version's coordinates
    floor to the same corner (_same_corners: every point at random
    offsets but a rare one within an ulp of an integer; at zero offsets,
    the points that both put on the integer). Each twice, dvalue within
    the bound both times, doffset and dmask the same bits."""
    (value, offset, mask), args = _dcnv3_case(cuda, dtype, *case)
    n, h, w = value.shape[:3]
    dout = torch.randn(*offset.shape[:3], value.shape[-1], device="cuda", generator=cuda).to(dtype)
    ref = dcnv3_core_backward_reference(value.float(), offset.float(), mask.float(), dout.float(), *args)
    keep = _same_corners(offset, h, w, args)
    assert keep.float().mean() > 0.5
    calls = []
    for _ in range(2):
        before = dcnv3_core_bwd.launches
        got = dcnv3_core_bwd(value, offset, mask, dout, *args)
        torch.cuda.synchronize()
        assert dcnv3_core_bwd.launches == before + 1
        assert all(g.dtype == dtype and g.shape == t.shape for g, t in zip(got, (value, offset, mask)))
        assert _rel(got[0], ref[0]) <= GRAD_TOL[dtype], _rel(got[0], ref[0])
        assert _masked_rel(got[1], ref[1], keep) <= GRAD_TOL[dtype], _masked_rel(got[1], ref[1], keep)
        assert _rel(got[2], ref[2]) <= GRAD_TOL[dtype], _rel(got[2], ref[2])
        calls.append(got)
    assert torch.equal(calls[0][1], calls[1][1]) and torch.equal(calls[0][2], calls[1][2])
    assert (ref[1] * keep).abs().max() > 0 and ref[0].abs().max() > 0
    assert dcnv3_core_bwd(value, offset, mask, dout, *args, need_input=False)[0] is None


@pytest.mark.cuda
def test_dcn_gradient_kernels_refuse_a_plan_they_cannot_run(cuda):
    """The C side checks the plan it is handed: a window past 227 KB of
    shared memory, or 16-byte lanes on an input off 16-byte alignment, is
    refused before any launch."""
    x = torch.randn(1, 8, 8, 64, device="cuda", generator=cuda)
    o = torch.zeros(1, 8, 8, 9, device="cuda")
    dcols = torch.randn(1, 64, 9 * 64, device="cuda", generator=cuda)
    plan = _v2_bwd_plan(1, 64, 8, 8, 3, 1, 4)
    _v2_bwd_launch(x, o, o, o, dcols, 3, 1, 1, plan)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _v2_bwd_launch(x, o, o, o, dcols, 3, 1, 1, plan._replace(fh=400, fw=400))
    shifted = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(x.shape)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _v2_bwd_launch(shifted, o, o, o, dcols, 3, 1, 1, plan)
    vec1 = _v2_bwd_plan(1, 64, 8, 8, 3, 1, 4, aligned=False)
    assert _v2_bwd_launch(shifted, o, o, o, dcols, 3, 1, 1, vec1)[0].isfinite().all()


@pytest.mark.cuda
@pytest.mark.parametrize("block", ["DCNv3", "BottleneckDCN"])
def test_dcn_blocks_under_autocast_sample_in_one_dtype(cuda, block):
    """Under bf16 autocast DCNv3's softmax runs in f32 and the block casts
    the mask to value's bf16; DCNv2's operands (conv, BatchNorm, sigmoid)
    are bf16 as they come. So the forward and gradient kernels run (one
    launch each), the gradients reach every parameter and are finite, and
    the step is near the one under plain_version(). In eval mode: ahead of
    a train-mode BatchNorm, DCNv2's bias has no gradient; no shortcut: it
    would add the f32 input to the bf16 output."""
    torch.manual_seed(0)
    m = (DCNv3(64, group=4) if block == "DCNv3" else BottleneckDCN(64, 64, shortcut=False)).cuda().eval()
    for mod in m.modules():  # the JAX init (DCNv2's weight is zero until then), then random offset heads
        init_dcn_heads(mod, torch.Generator(device="cuda").manual_seed(0))
    randomize_offset_heads(m, seed=0)
    fwd, bwd = (dcnv3_core, dcnv3_core_bwd) if block == "DCNv3" else (dcnv2_im2col, dcnv2_im2col_bwd)
    x = torch.randn(2, 64, 12, 12, device="cuda", generator=cuda).to(memory_format=torch.channels_last)
    grads = []
    for plain in (False, True):
        before = (fwd.launches, bwd.launches)
        with plain_version() if plain else torch.enable_grad():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                out = m(x)
            assert out.dtype == torch.bfloat16
            grads.append(torch.autograd.grad(out.float().square().sum(), list(m.parameters())))
        launched = (fwd.launches - before[0], bwd.launches - before[1])
        assert launched == ((0, 0) if plain else (1, 1)), launched
    for gk, gp in zip(*grads):
        assert torch.isfinite(gk).all() and gk.abs().max() > 0
        assert _rel(gk, gp.float()) < 0.05


@pytest.mark.cuda
def test_train_run_of_the_dcn_variant_on_cuda(cuda, tmp_path):
    """train.run of yolo-somi-dcn at width 0.25 / depth 0.33 (3 DCNv2, 1
    DCNv3), bf16, 64 px, b2, 4 images: one epoch and one more from
    --resume; every step launches the forward and gradient kernels of both
    DCN ops, and the losses are finite."""
    data = _write_shapes(tmp_path / "ds", 4)
    cfg = dict(load_model_cfg(find_config("yolo-somi-dcn")))
    cfg["width_multiple"], cfg["depth_multiple"] = 0.25, 0.33
    cfg_path = tmp_path / "dcn-small.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    kw = dict(cfg=str(cfg_path), data=str(data), hyp="hyp.visdrone", batch_size=2, imgsz=64, noautoanchor=True,
              workers=2, project=str(tmp_path / "runs"), name="t", device="cuda")
    before = (dcnv2_im2col_bwd.launches, dcnv3_core_bwd.launches)
    train.run(epochs=1, **kw)
    last = tmp_path / "runs" / "t" / "weights" / "last.ckpt"
    train.run(epochs=2, weights=str(last), resume=True, exist_ok=True, **kw)
    steps = 2 * 2
    assert (dcnv2_im2col_bwd.launches - before[0], dcnv3_core_bwd.launches - before[1]) == (3 * steps, steps)
    log = [json.loads(line) for line in (tmp_path / "runs" / "t" / "train_log.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in log] == [0, 1] and all(r["skipped_logged"] == 0 for r in log)
    assert all(np.isfinite(v) for r in log for row in r["logged_losses"] for v in row[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("amp", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_a_train_step_on_cuda_goes_through_the_gradient_kernels(cuda, amp):
    """The small flagship, b2, 64 px: one step launches the forward and
    both gradient kernels at the four ODConv sites, every gradient is
    finite, and the ODConv banks move."""
    cfg = dict(load_model_cfg(find_config("yolo-somi")))
    cfg["width_multiple"], cfg["depth_multiple"] = 0.25, 0.33
    hyp = load_hyp(find_config("hyp.visdrone", "hyps"))
    model, meta = build_model(cfg, nc=3, device="cuda", seed=0, compute_dtype=amp)
    opt = make_optimizer(hyp, nb=2, epochs=1, batch_size=2)
    state = create_train_state(model, opt)
    step = make_train_step(ComputeLoss(meta, hyp), opt, amp_dtype=amp)
    banks = [m.weight for m in model.modules() if isinstance(m, ODConv2d)]
    bank0 = [b.detach().clone() for b in banks]
    t = np.full((2, 8, 5), -1, np.float32)
    t[..., 1:] = 0
    t[:, :2] = [[0, 0.3, 0.4, 0.2, 0.3], [2, 0.6, 0.6, 0.1, 0.1]]
    images = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    before = (odconv_s2.launches, odconv_s2_dx.launches, odconv_s2_dwmix.launches)
    m = step(state, images, t)
    step(state, images, t)  # the second step has a non-zero LR for the banks (their group is warmed from 0)
    torch.cuda.synchronize()
    assert (odconv_s2.launches - before[0], odconv_s2_dx.launches - before[1],
            odconv_s2_dwmix.launches - before[2]) == (8, 8, 8)
    assert bool(m["grads_finite"]) and torch.isfinite(m["loss"])
    assert len(banks) == 4 and all(not torch.equal(b, b0) for b, b0 in zip(banks, bank0))


@pytest.mark.cuda
def test_a_detect_v8_train_step_on_cuda_matches_the_plain_version(cuda):
    """The small flagship's body (rows 0-34, width 0.25, depth 0.33) under
    DetectV8 on rows 25 / 28 / 31 / 34, b2, 64 px, f32: one forward,
    ComputeLossV8 and backward through odconv_s2 and its two gradient
    kernels (4 + 4 + 4 launches) against the same step under
    plain_version() (none), both held against the plain step in float64:
    the kernels' loss and every gradient no further from f64 than four
    times the larger of the plain f32 step's distance and its median
    distance, plus 1e-6 of the largest gradient (chip_smoke.py's
    train_step_parity rule)."""
    cfg = dict(load_model_cfg(find_config("yolo-somi")))
    cfg["width_multiple"], cfg["depth_multiple"] = 0.25, 0.33
    cfg["head"] = cfg["head"][:-1] + [[[25, 28, 31, 34], 1, "DetectV8", ["nc"]]]
    model, meta = build_model(cfg, nc=3, device="cuda", seed=0)
    plain, f64 = copy.deepcopy(model), copy.deepcopy(model).double()
    loss_fn = ComputeLossV8(meta, load_hyp(find_config("hyp.visdrone", "hyps")))
    t = np.full((2, 8, 5), -1, np.float32)
    t[..., 1:] = 0
    t[:, :2] = [[0, 0.3, 0.4, 0.2, 0.3], [2, 0.6, 0.6, 0.1, 0.1]]
    t = torch.from_numpy(t).cuda()
    x = torch.from_numpy(np.random.default_rng(0).random((2, 3, 64, 64))).cuda()

    def step(m):
        m.train()
        loss, _ = loss_fn(m(x.to(next(m.parameters()).dtype)), t)
        return loss.detach().double(), [g.double() for g in torch.autograd.grad(loss, list(m.parameters()))]

    before = (odconv_s2.launches, odconv_s2_dx.launches, odconv_s2_dwmix.launches)
    loss_k, grads_k = step(model)
    torch.cuda.synchronize()
    assert (odconv_s2.launches - before[0], odconv_s2_dx.launches - before[1],
            odconv_s2_dwmix.launches - before[2]) == (4, 4, 4)
    with plain_version():
        loss_p, grads_p = step(plain)
        loss_d, grads_d = step(f64)
    assert (odconv_s2.launches, odconv_s2_dx.launches, odconv_s2_dwmix.launches) == (before[0] + 4, before[1] + 4,
                                                                                      before[2] + 4)
    assert torch.isfinite(loss_k) and all(torch.isfinite(g).all() for g in grads_k)
    assert abs(loss_k - loss_d) <= 4 * abs(loss_p - loss_d) + 1e-6 * abs(loss_d)
    floor = 1e-6 * max(g.norm().item() for g in grads_d)
    median = float(np.median([((gp - gd).norm() / gd.norm().clamp_min(1e-300)).item()
                              for gp, gd in zip(grads_p, grads_d)]))
    for (name, _), gk, gp, gd in zip(model.named_parameters(), grads_k, grads_p, grads_d):
        ek, ep = (gk - gd).norm().item(), (gp - gd).norm().item()
        assert ek <= 4 * max(ep, median * gd.norm().item()) + floor, (name, ek, ep)


# ---------------------------------------------------------------------------
# the training recipe's shapes and device paths (--rect, --multi-scale,
# --quad, --cache device, --remat)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 240, 320, 64, 128), (8, 30, 40, 512, 256), (2, 640, 640, 64, 128)],
                         ids=["rect_row1", "rect_row32", "quad_row1"])
def test_odconv_s2_kernels_at_the_recipe_shapes(cuda, dtype, shape):
    """Full-width sites no serving batch reaches: row 1's and row 32's
    inputs of a 480x640 rect batch (H != W) and row 1's of a quad batch
    (b2 at 1280 px). The forward against the plain version, both
    gradients against autograd of it (GRAD_TOL), each kernel twice,
    bitwise."""
    b, h, w, cin, cout = shape
    x = torch.randn(b, h, w, cin, device="cuda", generator=cuda).to(dtype)
    wmix = (torch.randn(b, 3, 3, cin, cout, device="cuda", generator=cuda) * (2.0 / (9 * cin)) ** 0.5).to(dtype)
    dy = torch.randn(b, h // 2, w // 2, cout, device="cuda", generator=cuda).to(dtype)
    y, dx, dw = odconv_s2(x, wmix), odconv_s2_dx(dy, wmix, h, w), odconv_s2_dwmix(x, dy)
    torch.cuda.synchronize()
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32 else dict(atol=0.15, rtol=0.03)
    torch.testing.assert_close(y.float(), odconv_s2_reference(x.float(), wmix.float()), **tol)
    rdx, rdw = odconv_s2_backward_reference(x.float(), wmix.float(), dy.float())
    assert _rel(dx, rdx) <= GRAD_TOL[dtype] and _rel(dw, rdw) <= GRAD_TOL[dtype], (_rel(dx, rdx), _rel(dw, rdw))
    assert torch.equal(odconv_s2(x, wmix), y)
    assert torch.equal(odconv_s2_dx(dy, wmix, h, w), dx) and torch.equal(odconv_s2_dwmix(x, dy), dw)


def _dcnv2_site(row: int, size: int):
    """(C, k, s, p, H, W) of yolo-somi-dcn's DCNv2 convolutions at graph row
    `row` on a `size` px square, read from the graph on the meta device."""
    from yolosomi_tpu_torch.models.dcn import DCNv2
    from yolosomi_tpu_torch.models.yolo import parse_model

    with torch.device("meta"):
        modules, meta = parse_model(load_model_cfg(find_config("yolo-somi-dcn")))
    conv = next(m for m in modules[row].modules() if isinstance(m, DCNv2))
    hw = int(size / meta.specs[row - 1].stride)
    return conv.conv_offset_mask.in_channels, conv.k, conv.s, conv.p, hw, hw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("row", [6, 8])
def test_dcnv2_kernels_at_the_832_px_training_sites(cuda, dtype, row):
    """dcnv2_im2col and dcnv2_im2col_bwd at the maps of rows 6 and 8 of
    yolo-somi-dcn on an 832 px batch (--multi-scale's largest square), b2,
    offsets up to +-4 px: the columns against the plain version, the
    gradients against autograd of it (GRAD_TOL), the offset and mask
    gradients the same bits twice."""
    c, k, s, p, h, w = _dcnv2_site(row, 832)
    n, ho, wo = 2, (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    x = torch.randn(n, h, w, c, device="cuda", generator=cuda)
    oy, ox = ((torch.rand(2, n, ho, wo, k * k, device="cuda", generator=cuda) - 0.5) * 8).unbind(0)
    mask = torch.sigmoid(torch.randn(n, ho, wo, k * k, device="cuda", generator=cuda))
    dcols = torch.randn(n, ho * wo, k * k * c, device="cuda", generator=cuda)
    x, oy, ox, mask, dcols = (t.to(dtype) for t in (x, oy, ox, mask, dcols))
    cols = dcnv2_im2col(x, oy, ox, mask, k, s, p)
    torch.cuda.synchronize()
    ref = dcnv2_im2col_reference(x.float(), oy.float(), ox.float(), mask.float(), k, s, p)
    torch.testing.assert_close(cols.float(), ref, **_DCN_TOL[dtype])
    rgrads = dcnv2_im2col_backward_reference(x.float(), oy.float(), ox.float(), mask.float(), dcols.float(), k, s, p)
    calls = [dcnv2_im2col_bwd(x, oy, ox, mask, dcols, k, s, p) for _ in range(2)]
    torch.cuda.synchronize()
    for got in calls:
        assert all(_rel(g, r) <= GRAD_TOL[dtype] for g, r in zip(got, rgrads)), [_rel(g, r) for g, r in zip(got, rgrads)]
    assert all(torch.equal(a, b) for a, b in zip(calls[0][1:], calls[1][1:]))


@pytest.mark.cuda
def test_device_mosaic_on_cuda_matches_its_cpu_form(cuda, tmp_path):
    """mosaic_mixup_batch from a slab on the card and on the CPU, the same
    plans (mosaic 0.5, mixup 1.0: letterbox, mosaic and mixed rows): within
    1e-4 on the 0-255 scale."""
    import random

    from yolosomi_tpu_torch.data.datasets import DataLoader, DetectionDataset
    from yolosomi_tpu_torch.ops.mosaic_device import build_device_cache, mosaic_mixup_batch

    _write_shapes(tmp_path / "ds", 8)
    hyp = dict(load_hyp(find_config("hyp.visdrone", "hyps")), mosaic=0.5, mixup=1.0)
    random.seed(0)
    np.random.seed(0)
    ds = DetectionDataset(str(tmp_path / "ds" / "images"), img_size=96, augment=True, hyp=hyp)
    slab, _ = build_device_cache(ds)
    for plan, _, _, _ in DataLoader(ds, 4, shuffle=True, prefetch=0, plan=True):
        got = mosaic_mixup_batch(torch.from_numpy(slab).cuda(), plan, 96)
        want = mosaic_mixup_batch(torch.from_numpy(slab), plan, 96)
        assert got.is_cuda and got.shape == (4, 96, 96, 3)
        torch.testing.assert_close(got.cpu() * 255, want * 255, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_multi_scale_resize_on_cuda_matches_the_cpu(cuda):
    """The step's antialiased bilinear resize of a uint8 batch, down and up,
    on the card against the CPU (whose parity with jax.image.resize
    tests/test_torch_port_recipe.py holds): within 2e-6."""
    from types import SimpleNamespace

    u8 = np.random.default_rng(0).integers(0, 256, (2, 96, 96, 3), dtype=np.uint8)
    for size in (64, 128):
        step = make_train_step(None, None, scale_to=size)
        got, _ = step.inputs(SimpleNamespace(params=[torch.zeros(1, device="cuda")], step=0), u8, np.zeros((2, 1, 5)))
        want, _ = step.inputs(SimpleNamespace(params=[torch.zeros(1)], step=0), u8, np.zeros((2, 1, 5)))
        assert got.is_cuda and got.shape == (2, 3, size, size)
        torch.testing.assert_close(got.cpu(), want, atol=2e-6, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("amp", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_remat_step_on_cuda_moves_batchnorm_statistics_once(cuda, amp):
    """The small flagship, b2, 64 px, one step from the same seed with
    --remat 3 and without: the loss and the BatchNorm statistics the same
    bits (a recompute that moved them would put them ~3% away), the EMA
    too in bf16. In f32 the EMA within 1e-4 relative: the f32 step's
    backward on the card is not bitwise repeatable even without remat
    (chip_smoke.py's f32 witness: a median 2e-6 relative between two
    runs), and the ODConv bias banks, updated at the warmup bias LR 0.05,
    carry that noise into the EMA (2.1e-5 relative on an H100 80GB HBM3); a
    wrong gradient would move them by percents. The forward kernel
    launched twice a site under remat (the recompute), the gradient
    kernels once."""
    from yolosomi_tpu_torch.models.layers import FlaxBatchNorm1d, FlaxBatchNorm2d

    cfg = dict(load_model_cfg(find_config("yolo-somi")))
    cfg["width_multiple"], cfg["depth_multiple"] = 0.25, 0.33
    hyp = load_hyp(find_config("hyp.visdrone", "hyps"))
    t = np.full((2, 8, 5), -1, np.float32)
    t[..., 1:] = 0
    t[:, :2] = [[0, 0.3, 0.4, 0.2, 0.3], [2, 0.6, 0.6, 0.1, 0.1]]
    images = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    runs = []
    for segs in (0, 3):
        model, meta = build_model(cfg, nc=3, device="cuda", seed=0, compute_dtype=amp)
        opt = make_optimizer(hyp, nb=2, epochs=1, batch_size=2)
        state = create_train_state(model, opt)
        before = (odconv_s2.launches, odconv_s2_dx.launches, odconv_s2_dwmix.launches)
        m = make_train_step(ComputeLoss(meta, hyp), opt, amp_dtype=amp, remat_segments=segs)(state, images, t)
        torch.cuda.synchronize()
        launches = (odconv_s2.launches - before[0], odconv_s2_dx.launches - before[1],
                    odconv_s2_dwmix.launches - before[2])
        bn = [b.clone() for mod in model.modules() if isinstance(mod, (FlaxBatchNorm1d, FlaxBatchNorm2d))
              for b in (mod.running_mean, mod.running_var)]
        runs.append((m["loss"], launches, bn, [v.clone() for v in state.ema.ema.state_dict().values()]))
    (loss0, l0, bn0, ema0), (loss3, l3, bn3, ema3) = runs
    assert l0 == (4, 4, 4) and l3 == (8, 4, 4), (l0, l3)
    assert torch.equal(loss0, loss3)
    assert all(torch.equal(a, b) for a, b in zip(bn0, bn3))
    for a, b in zip(ema0, ema3):
        if amp is None:
            torch.testing.assert_close(b, a, atol=1e-6, rtol=1e-4)
        else:
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# conv_int8 (ops/csrc/conv_int8.cu)
# ---------------------------------------------------------------------------

# (B, H, W, C, N, (kh, kw), stride, padding, dilation, groups): the first
# conv's C = 3, depthwise, 7x1, dilation 2, stride 2, H != W, C a multiple
# of 16 (the 16-byte gathers) and not, ragged tiles of M, N and K
INT8_SHAPES = {
    "cin3_s2": (2, 33, 47, 3, 64, (3, 3), (2, 2), (1, 1), (1, 1), 1),
    "depthwise": (2, 20, 13, 64, 64, (3, 3), (1, 1), (1, 1), (1, 1), 64),
    "7x1": (16, 26, 1, 8, 1, (7, 1), (1, 1), (3, 0), (1, 1), 1),
    "dilated_2": (1, 17, 23, 32, 40, (3, 3), (1, 1), (2, 2), (2, 2), 1),
    "stride_2_vec": (2, 40, 30, 256, 256, (3, 3), (2, 2), (1, 1), (1, 1), 1),
    "1x1_wide_k": (2, 10, 12, 1024, 72, (1, 1), (1, 1), (0, 0), (1, 1), 1),
    "grouped": (2, 9, 11, 48, 24, (3, 3), (1, 1), (1, 1), (1, 1), 4),
    "7x7_cin2": (2, 19, 21, 2, 1, (7, 7), (1, 1), (3, 3), (1, 1), 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(INT8_SHAPES))
def test_conv_int8_kernel_matches_plain_version_bitwise(cuda, name):
    """The int32 accumulators the same bits as the f64 plain version's, at
    full-range int8 operands (sums past 2**24 at the wide K); the f32 and
    bf16 dequant the same bits; two calls the same bits."""
    from yolosomi_tpu_torch.ops.int8 import conv_int8, conv_int8_reference

    B, H, W, C, N, k, s, p, d, g = INT8_SHAPES[name]
    x = torch.randint(-127, 128, (B, H, W, C), device="cuda", generator=cuda, dtype=torch.int8)
    w = torch.randint(-127, 128, (N, *k, C // g), device="cuda", generator=cuda, dtype=torch.int8)
    scale = torch.rand(N, device="cuda", generator=cuda) / 1000
    bias = torch.randn(N, device="cuda", generator=cuda)
    kw = dict(stride=s, padding=p, dilation=d, groups=g)
    before = conv_int8.launches
    acc = conv_int8(x, w, out_dtype=torch.int32, **kw)
    torch.cuda.synchronize()
    ref = conv_int8_reference(x, w, out_dtype=torch.int32, **kw)
    assert torch.equal(acc, ref), (acc.double() - ref.double()).abs().max().item()
    for dtype in (torch.float32, torch.bfloat16):
        for b in (bias, None):
            got = conv_int8(x, w, scale, b, out_dtype=dtype, **kw)
            assert torch.equal(got, conv_int8_reference(x, w, scale, b, out_dtype=dtype, **kw)), (name, dtype)
    assert torch.equal(conv_int8(x, w, out_dtype=torch.int32, **kw), acc)
    assert conv_int8.launches == before + 6


@pytest.mark.cuda
def test_conv_int8_kernel_rejects_what_it_does_not_take(cuda):
    from yolosomi_tpu_torch.ops.int8 import conv_int8

    x = torch.zeros(1, 8, 8, 16, device="cuda", dtype=torch.int8)
    w = torch.zeros(8, 3, 3, 16, device="cuda", dtype=torch.int8)
    with pytest.raises(TypeError, match="int8"):
        conv_int8(x.float(), w)
    with pytest.raises(ValueError, match="scale"):
        conv_int8(x, w, padding=(1, 1))
    with pytest.raises(ValueError, match="contiguous"):
        conv_int8(x.permute(0, 2, 1, 3), w, out_dtype=torch.int32)
    with pytest.raises(ValueError, match="groups"):
        conv_int8(x, w, out_dtype=torch.int32, groups=3)


@pytest.mark.cuda
def test_int8_model_launches_conv_int8_per_convraw(cuda):
    """yolo-somi-t-p3 at width 0.25 in int8 (bf16 Runner; it has no other
    kernel site, so plain_version() changes only the int8 convs): one
    conv_int8 launch per ConvRaw a forward, none under plain_version(),
    and the same detections there, bit for bit."""
    from yolosomi_tpu_torch.ops.int8 import conv_int8
    from yolosomi_tpu_torch.ops.quant import quantized_infer_fn
    from yolosomi_tpu_torch.utils.weights import conv_raw_paths

    cfg = load_model_cfg(find_config("yolo-somi-t-p3"))
    cfg["width_multiple"], cfg["depth_multiple"] = 0.25, 0.33
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "somi-t-p3-small.yaml"
        path.write_text(yaml.safe_dump(cfg))
        runner = Runner(str(path), nc=3, dtype=torch.bfloat16, device="cuda", seed=0)
    images = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    fn = quantized_infer_fn(runner, images, conf_thres=0.001, iou_thres=0.6, multi_label=True, exact=True,
                            max_nms=30000)
    before = conv_int8.launches
    out = fn(images)
    assert conv_int8.launches - before == len(conv_raw_paths(runner.model))
    with plain_version():
        ref = fn(images)
    assert conv_int8.launches - before == len(conv_raw_paths(runner.model))
    assert out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_array_equal(out, ref)


# ---------------------------------------------------------------------------
# conv_int8_fused: the activation's quantize inside conv_int8's loads
# ---------------------------------------------------------------------------

# (B, H, W, C, N, (kh, kw), stride, padding, dilation, groups, channels of
# the tensor x is sliced from (0: x is its own tensor)): the decoupled
# head's C = 177 -> 98 and 256 -> 177 3x3 convs, the spatial gates (7x7 over
# C = 2, 7x1 over C = 16, N = 1), SEAM's depthwise 3x3 over 256, the first
# conv's C = 3 at stride 2, and a dilated conv with ragged M read in place
# from a channel slice of a wider tensor; "wide_k" sums 2048 products of
# up to 127 * 127, past 2**24
FUSED_SHAPES = {
    "c177_n98": (2, 20, 20, 177, 98, (3, 3), (1, 1), (1, 1), (1, 1), 1, 0),
    "c256_n177": (2, 12, 14, 256, 177, (3, 3), (1, 1), (1, 1), (1, 1), 1, 0),
    "7x7_c2_n1": (2, 19, 21, 2, 1, (7, 7), (1, 1), (3, 3), (1, 1), 1, 0),
    "7x1_c16_n1": (16, 26, 1, 16, 1, (7, 1), (1, 1), (3, 0), (1, 1), 1, 0),
    "depthwise_256": (2, 20, 13, 256, 256, (3, 3), (1, 1), (1, 1), (1, 1), 256, 0),
    "c3_s2": (2, 33, 47, 3, 64, (3, 3), (2, 2), (1, 1), (1, 1), 1, 0),
    "dilated_slice": (1, 17, 23, 32, 40, (3, 3), (1, 1), (2, 2), (2, 2), 1, 96),
    "wide_k": (2, 10, 12, 2048, 72, (1, 1), (1, 1), (0, 0), (1, 1), 1, 0),
}


def fused_operands(gen, name, dtype, per_channel):
    """x (a view when the case slices it), s_a, w_q, scale and bias for a
    FUSED_SHAPES case: x spread per channel, s_a at 80% of its absmax (some
    values clip at +-127), full-range weights."""
    B, H, W, C, N, k, s, p, d, g, wide = FUSED_SHAPES[name]
    spread = torch.rand(C, device="cuda", generator=gen) * 3 + 0.2
    if wide:
        x = (torch.randn(B, H, W, wide, device="cuda", generator=gen) * 2).to(dtype)[..., 32:32 + C]
    else:
        x = (torch.randn(B, H, W, C, device="cuda", generator=gen) * spread).to(dtype)
    w = torch.randint(-127, 128, (N, *k, C // g), device="cuda", generator=gen, dtype=torch.int8)
    if name == "wide_k":  # positive x near its absmax and output channel 0's weights at 127: its sums pass 2**24
        x = (x.abs() * 0.1 + 4).to(dtype)
        w[0] = 127
    absmax = x.float().abs().amax(dim=(0, 1, 2)) if per_channel else x.float().abs().amax()
    s_a = torch.clamp(absmax * 0.8, min=1e-8) / 127.0
    scale = torch.rand(N, device="cuda", generator=gen) / 1000
    bias = torch.randn(N, device="cuda", generator=gen)
    return x, s_a, w, scale, bias, dict(stride=s, padding=p, dilation=d, groups=g)


@pytest.mark.cuda
@pytest.mark.parametrize("per_channel", [False, True], ids=["per_tensor", "per_channel"])
@pytest.mark.parametrize("name", list(FUSED_SHAPES))
def test_conv_int8_fused_matches_plain_version_bitwise(cuda, name, per_channel):
    """The fused kernel against quantize_activation + the f64 plain conv:
    the int32 sums and the dequantized output (in x's dtype, f32 and bf16)
    the same bits, packed weights or not; one launch a call."""
    from yolosomi_tpu_torch.ops.int8 import conv_int8, conv_int8_fused, conv_int8_fused_reference, \
        pack_conv_int8_weights

    for dtype in (torch.float32, torch.bfloat16):
        x, s_a, w, scale, bias, kw = fused_operands(cuda, name, dtype, per_channel)
        packed = pack_conv_int8_weights(w, kw["groups"])
        before = conv_int8.launches
        acc = conv_int8_fused(x, s_a, w, None, out_dtype=torch.int32, packed=packed, **kw)
        torch.cuda.synchronize()
        assert conv_int8.launches == before + 1
        ref = conv_int8_fused_reference(x, s_a, w, None, out_dtype=torch.int32, **kw)
        assert torch.equal(acc, ref), (name, dtype, (acc.double() - ref.double()).abs().max().item())
        for b in (bias, None):
            got = conv_int8_fused(x, s_a, w, scale, b, **kw)
            assert got.dtype == dtype
            assert torch.equal(got, conv_int8_fused_reference(x, s_a, w, scale, b, **kw)), (name, dtype)
        assert conv_int8.launches == before + 3
    if name == "wide_k":
        assert ref.abs().max().item() > 2 ** 24


@pytest.mark.cuda
def test_conv_int8_fused_refuses_what_it_does_not_take(cuda):
    from yolosomi_tpu_torch.ops.int8 import conv_int8_fused, pack_conv_int8_weights

    x = torch.randn(1, 8, 8, 16, device="cuda", generator=cuda)
    w = torch.zeros(8, 3, 3, 16, device="cuda", dtype=torch.int8)
    s_a = torch.tensor(0.01, device="cuda")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        conv_int8_fused(x.to(torch.int8), s_a, w, None, out_dtype=torch.int32)
    with pytest.raises(ValueError, match="s_a"):
        conv_int8_fused(x, torch.ones(17, device="cuda"), w, None, out_dtype=torch.int32)
    with pytest.raises(ValueError, match="s_a"):
        conv_int8_fused(x, s_a.double(), w, None, out_dtype=torch.int32)
    with pytest.raises(ValueError, match="channels contiguous"):  # the NHWC view of an NCHW-contiguous x
        conv_int8_fused(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), s_a, w, None, out_dtype=torch.int32)
    with pytest.raises(ValueError, match="packed"):
        conv_int8_fused(x, s_a, w, None, out_dtype=torch.int32, packed=pack_conv_int8_weights(w[:4]))
    with pytest.raises(ValueError, match="one CUDA device"):
        conv_int8_fused(x, s_a.cpu(), w, None, out_dtype=torch.int32)


@pytest.mark.cuda
def test_conv_int8_gemm_tiles_match_the_kernel(cuda):
    """ops/int8.py's tile table and shared-memory sizes are the kernel's."""
    from yolosomi_tpu_torch.ops.int8 import _BN_WIDTHS, _gemm_smem, gemm_smem_of_kernel

    assert [gemm_smem_of_kernel(i) for i in range(len(_BN_WIDTHS))] == [_gemm_smem(bn) for bn in _BN_WIDTHS]
    assert gemm_smem_of_kernel(len(_BN_WIDTHS)) == -1


# ---------------------------------------------------------------------------
# data and pipeline parallelism on one card (two ranks, two stages)
# ---------------------------------------------------------------------------


def _small_flagship_variables():
    cfg = dict(load_model_cfg(find_config("yolo-somi")))
    cfg["width_multiple"], cfg["depth_multiple"] = 0.25, 0.33
    model, _ = build_model(cfg, nc=3, device="cpu", seed=0)
    return cfg, export_jax_variables(model)


def _global_batch(b: int = 4, size: int = 64):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8)
    t = np.full((b, 8, 5), -1, np.float32)
    t[..., 1:] = 0
    t[:, :2] = [[0, 0.3, 0.4, 0.2, 0.3], [2, 0.6, 0.6, 0.1, 0.1]]
    return images, t


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_match_the_one_process_step(cuda):
    """The small flagship, f32, global b4 at 64 px: two gloo ranks on
    cuda:0 (b2 each) against one process's b4, two steps: the losses within
    2e-4 relative (the CPU test's limit), both ranks the same parameter
    bits, each rank launching the ODConv forward and both gradient kernels
    4 times a step; every parameter's update within 1.0 relative norm of
    one process's plus 1e-6 of the largest update, the median within 0.1
    (the small flagship's f32 backward puts two f32 computations of one step
    a median 3e-4 apart; the two runs agree to 5e-13 in f64 on the CPU)."""
    import _torch_parallel_ranks as ranks  # tests/ is on the path under pytest, and so in the spawned ranks
    from yolosomi_tpu_torch.parallel.mesh import spawn_local

    cfg, variables = _small_flagship_variables()
    hyp = load_hyp(find_config("hyp.visdrone", "hyps"))
    batches = [_global_batch()] * 2
    kw = dict(cfg=cfg, nc=3, variables=variables, hyp=hyp, opt_kw=dict(nb=2, epochs=1, batch_size=4),
              batches=batches, device="cuda")
    one = ranks.train_steps(None, **kw)
    two = [r[0] for r in spawn_local(2, ranks.run_calls, [(ranks.train_steps, kw)], backend="gloo", timeout=300)]
    for a, b in zip(two[0], two[1]):
        assert a["metrics"] == b["metrics"] and a["launches"] == b["launches"]
        for k, v in a["params"].items():
            np.testing.assert_array_equal(b["params"][k], v, err_msg=k)
    for got, want in zip(two[0], one):
        np.testing.assert_allclose(got["metrics"]["loss"], want["metrics"]["loss"], rtol=2e-4)
        assert got["launches"] == {"odconv_s2": 4, "odconv_s2_dx": 4, "odconv_s2_dwmix": 4}, got["launches"]
    before = ranks.flat(variables["params"])
    upd = {k: (two[0][-1]["params"][k] - v, one[-1]["params"][k] - v) for k, v in before.items()}
    top = max(np.linalg.norm(w) for _, w in upd.values())
    rel = [np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30) for g, w in upd.values() if np.linalg.norm(w) > 0]
    assert all(np.linalg.norm(g - w) <= 1.0 * np.linalg.norm(w) + 1e-6 * top for g, w in upd.values())
    assert np.median(rel) <= 0.1, np.median(rel)


@torch.no_grad()
def _spread_random_weights(model: torch.nn.Module, seed: int = 0, gain: float = 10.0) -> None:
    """The CPU spatial test's weights, drawn in torch: every parameter 0.1
    x normal, BatchNorm running means 0.2 x normal and variances uniform in
    [0.5, 2.5], LayerNorm scales 1 + 0.1 x normal, every norm scale then x
    `gain`, the DCN offset heads randomised: scores that depend on the
    image and spread over 0.4-0.9 at 256 px (a seed-0 model's saturate)."""
    g = torch.Generator().manual_seed(seed)
    norms = (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d, torch.nn.GroupNorm, torch.nn.LayerNorm)
    for m in model.modules():
        for n, p in list(m.named_parameters(recurse=False)) + list(m.named_buffers(recurse=False)):
            if not p.is_floating_point():
                continue
            r = torch.randn(p.shape, generator=g, dtype=torch.float64)
            if n == "running_var":
                p.copy_(0.5 + 2 * torch.rand(p.shape, generator=g, dtype=torch.float64))
            elif n == "running_mean":
                p.copy_(0.2 * r)
            elif isinstance(m, norms) and n == "weight":
                p.copy_(gain * (1 + 0.1 * r if isinstance(m, torch.nn.LayerNorm) else 0.1 * r))
            else:
                p.copy_(0.1 * r)
    randomize_offset_heads(model, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["yolo-somi", "yolo-somi-dcn"])
def test_two_gloo_ranks_serve_a_spatially_sharded_batch_on_one_card(cuda, tmp_path, name):
    """The small model (f32, TF32 off; the CPU test's spread random weights)
    from a weights file, b2 at 256 px, conf 0.5, over two H-strips on two
    gloo ranks sharing cuda:0, against the same Runner unsharded on the
    card, both against the model in float64 under plain_version()
    (chip_smoke.py phase 14's rule): each level's head maps no further from
    it than twice the unsharded Runner's plus 1e-5 of the level's largest
    value; the rows too (as many kept and unmatched, boxes within twice
    plus 1e-4 of the side, scores twice plus 1e-5); both ranks the same
    rows, and
    each launching the model's kernels once a site."""
    import _torch_parallel_ranks as ranks
    from chip_smoke import row_distance
    from yolosomi_tpu_torch.parallel.mesh import spawn_local

    cfg = dict(load_model_cfg(find_config(name)))
    cfg["width_multiple"], cfg["depth_multiple"] = 0.25, 0.33
    model, meta = build_model(cfg, nc=3, device="cpu", seed=0)
    _spread_random_weights(model)
    cfg_path, weights = tmp_path / "small.yaml", tmp_path / "small.msgpack"
    cfg_path.write_text(yaml.safe_dump(cfg))
    save_variables(weights, export_jax_variables(model), anchors=meta.anchors_px)
    cfg, weights = str(cfg_path), str(weights)
    images = np.random.default_rng(0).integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    runner = Runner(cfg, weights, dtype=torch.float32, device="cuda")
    preds, out = runner.forward(images), runner(images, conf_thres=0.5)
    with plain_version():
        runner64 = Runner(cfg, weights, dtype=torch.float64, device="cuda")
        preds64, out64 = runner64.forward(images), runner64(images, conf_thres=0.5)
    got = spawn_local(2, ranks.run_calls, [(ranks.spatial_runner, dict(cfg=cfg, images=images, shards=2, conf=0.5,
                                                                        weights=weights, device="cuda"))],
                      backend="gloo", timeout=300)
    want = {"odconv_s2": 4, "dcnv2_im2col": 3 if name == "yolo-somi-dcn" else 0,
            "dcnv3_core": 1 if name == "yolo-somi-dcn" else 0}
    one = row_distance(out, out64)
    assert (out[..., 4] > 0).sum() > 0
    for (r,) in got:
        assert r["launches"] == want, r["launches"]
        for p, p1, p64 in zip(r["preds"], preds, preds64):
            p64 = p64.cpu().double().numpy()
            limit = 2 * np.abs(p1.cpu().double().numpy() - p64).max() + 1e-5 * np.abs(p64).max()
            assert np.abs(p - p64).max() <= limit, (np.abs(p - p64).max(), limit)
        d = row_distance(r["out"], out64)
        assert d["unmatched"] == one["unmatched"] and (r["out"][..., 4] > 0).sum() == (out[..., 4] > 0).sum(), (d, one)
        assert d["box"] <= 2 * one["box"] + 1e-4 * 256 and d["score"] <= 2 * one["score"] + 1e-5, (d, one)
        np.testing.assert_array_equal(r["out"], got[0][0]["out"])


@pytest.mark.cuda
def test_pipeline_trainer_on_one_card_matches_the_single_step(cuda):
    """The small flagship in 2 stages on [cuda:0, cuda:0] at microbatch =
    batch (b4, f32): the loss within 1e-5 relative of one process's step
    and every gradient within 5e-5 relative norm plus 1e-6 of the largest
    gradient's norm (chip_smoke's f32 witness limits: the same kernels on
    the same operands, summed in another order), the forward kernel twice
    a site (the recompute) and each gradient kernel once."""
    from yolosomi_tpu_torch.engine.trainer import upload_images
    from yolosomi_tpu_torch.parallel.pipeline import PipelineTrainer

    cfg, _ = _small_flagship_variables()
    hyp = load_hyp(find_config("hyp.visdrone", "hyps"))
    model, meta = build_model(cfg, nc=3, device="cuda", seed=0)
    ref = build_model(cfg, nc=3, device="cuda", seed=0)[0].train()
    loss_fn = ComputeLoss(meta, hyp)
    images, t = _global_batch()
    ref_loss = loss_fn(ref(upload_images(images, torch.device("cuda"))), torch.as_tensor(t, device="cuda"))[0]
    names, params = zip(*ref.named_parameters())
    ref_grads = dict(zip(names, torch.autograd.grad(ref_loss, params)))
    before = (odconv_s2.launches, odconv_s2_dx.launches, odconv_s2_dwmix.launches)
    trainer = PipelineTrainer(model, loss_fn, 2, devices=["cuda:0", "cuda:0"], microbatch=4)
    loss = trainer.step(images, t)
    torch.cuda.synchronize()
    assert (odconv_s2.launches - before[0], odconv_s2_dx.launches - before[1],
            odconv_s2_dwmix.launches - before[2]) == (8, 4, 4)
    np.testing.assert_allclose(loss, ref_loss.item(), rtol=1e-5)
    got = {k: v for g in trainer.grads for k, v in g.items()}
    assert set(got) == set(ref_grads)
    floor = 1e-6 * max(g.norm().item() for g in ref_grads.values())
    for k, g in ref_grads.items():
        assert (got[k] - g).norm().item() <= 5e-5 * g.norm().item() + floor, (k, _rel(got[k], g))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["zoo-carafe", "zoo-fusion"])
def test_body_zoo_graph_forward_on_cuda_matches_the_plain_version(cuda, name):
    """The small body zoo graph (models/zoo_graphs.py at width 0.25, depth
    0.33, seed-0 weights, nc 3), f32 b2 at 64 px: CARAFE's upsamples, or
    BiFPN_Add2 / 3, MultiSEAM and the learnable activations, on the card
    with odconv_s2 at its four sites, against the same model under
    plain_version() (no launch), within the whole-model f32 tolerance of
    test_runner_from_a_weights_file_reaches_the_kernels."""
    from yolosomi_tpu_torch.models.zoo_graphs import zoo_graph

    cfg = zoo_graph(name)
    cfg["width_multiple"], cfg["depth_multiple"] = 0.25, 0.33
    model, _ = build_model(cfg, nc=3, device="cuda", seed=0)
    x = torch.from_numpy(np.random.default_rng(0).random((2, 3, 64, 64), np.float32)).cuda()
    before = odconv_s2.launches
    with torch.no_grad():
        got = model(x)
        torch.cuda.synchronize()
        assert odconv_s2.launches - before == 4
        with plain_version():
            want = model(x)
    assert odconv_s2.launches - before == 4
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["zoo-gates2", "zoo-global", "zoo-swin", "zoo-rfem"])
def test_attention_zoo_graph_forward_on_cuda_matches_the_plain_version(cuda, name):
    """The small graph of layers.py's attention family, Swin / HorNet or
    RFEM / EVC blocks (models/zoo_graphs.py at width 0.25, depth 0.33,
    seed-0 weights, nc 3; zoo-global's MHSA built for 64 px), f32 b2 at
    64 px on the card with odconv_s2 at its four sites, against the same
    model under plain_version() (no launch), within the whole-model f32
    tolerance of test_runner_from_a_weights_file_reaches_the_kernels."""
    from yolosomi_tpu_torch.models.zoo_graphs import zoo_graph

    cfg = zoo_graph(name)
    cfg["width_multiple"], cfg["depth_multiple"] = 0.25, 0.33
    model, _ = build_model(cfg, nc=3, device="cuda", seed=0, imgsz=64)
    x = torch.from_numpy(np.random.default_rng(0).random((2, 3, 64, 64), np.float32)).cuda()
    before = odconv_s2.launches
    with torch.no_grad():
        got = model(x)
        torch.cuda.synchronize()
        assert odconv_s2.launches - before == 4
        with plain_version():
            want = model(x)
    assert odconv_s2.launches - before == 4
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["zoo-down", "zoo-rfb", "zoo-c3att"])
def test_conv_zoo_graph_forward_on_cuda_matches_the_plain_version(cuda, name):
    """The small graph of layers_zoo.py's conv and csp kinds (the
    downsamplers and SPP family, the RFB blocks with ACmix and Conv_SWS, or
    the C3 blocks with attention bottlenecks; models/zoo_graphs.py at width
    0.25, depth 0.33, seed-0 weights, nc 3), f32 b2 at 64 px on the card
    with odconv_s2 at its four sites, against the same model under
    plain_version() (no launch), within the whole-model f32 tolerance of
    test_runner_from_a_weights_file_reaches_the_kernels."""
    from yolosomi_tpu_torch.models.zoo_graphs import zoo_graph

    cfg = zoo_graph(name)
    cfg["width_multiple"], cfg["depth_multiple"] = 0.25, 0.33
    model, _ = build_model(cfg, nc=3, device="cuda", seed=0)
    x = torch.from_numpy(np.random.default_rng(0).random((2, 3, 64, 64), np.float32)).cuda()
    before = odconv_s2.launches
    with torch.no_grad():
        got = model(x)
        torch.cuda.synchronize()
        assert odconv_s2.launches - before == 4
        with plain_version():
            want = model(x)
    assert odconv_s2.launches - before == 4
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["zoo-tconv", "zoo-asf"])
def test_fusion_zoo_graph_forward_on_cuda_matches_the_plain_version(cuda, name):
    """The small graph of layers_zoo.py's fusion kinds (the transposed-conv
    upsamplers, n-ary merges, context and HS-FPN gates, or the multi-scale
    fusions; models/zoo_graphs.py at width 0.25, depth 0.33, seed-0
    weights, nc 3), f32 b2 at 64 px on the card with odconv_s2 at its four
    sites, against the same model under plain_version() (no launch), within
    the whole-model f32 tolerance of
    test_runner_from_a_weights_file_reaches_the_kernels."""
    from yolosomi_tpu_torch.models.zoo_graphs import zoo_graph

    cfg = zoo_graph(name)
    cfg["width_multiple"], cfg["depth_multiple"] = 0.25, 0.33
    model, _ = build_model(cfg, nc=3, device="cuda", seed=0)
    x = torch.from_numpy(np.random.default_rng(0).random((2, 3, 64, 64), np.float32)).cuda()
    before = odconv_s2.launches
    with torch.no_grad():
        got = model(x)
        torch.cuda.synchronize()
        assert odconv_s2.launches - before == 4
        with plain_version():
            want = model(x)
    assert odconv_s2.launches - before == 4
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, atol=1e-3, rtol=1e-3)
