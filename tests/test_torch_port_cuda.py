"""yolosomi_tpu_torch's CUDA kernels against their plain versions, and the
entry points that load a checkpoint reaching them, on a GPU.

These tests need a CUDA device and skip without one. The file imports
neither jax nor the JAX package, so it runs on a machine that has only
PyTorch (tests/conftest.py imports jax, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

The gradient kernels (odconv_s2_dx, odconv_s2_dwmix) are held against
autograd of the plain version by the relative norm of the difference:
1e-5 in f32 (summation order only) and 4e-3 in bf16 (one rounding of the
output, 2**-9 relative).
"""

import numpy as np
import pytest
import torch
import yaml

from yolosomi_tpu_torch import api
from yolosomi_tpu_torch.engine.checkpoint import save_variables, strip_checkpoint
from yolosomi_tpu_torch.engine.runner import Runner
from yolosomi_tpu_torch.models.dcn import randomize_offset_heads
from yolosomi_tpu_torch.models.yolo import build_model
from yolosomi_tpu_torch.ops import build
from yolosomi_tpu_torch.ops.dcn import dcnv2_im2col, dcnv2_im2col_reference, dcnv3_core, dcnv3_core_reference
from yolosomi_tpu_torch import train
from yolosomi_tpu_torch.engine.optim import make_optimizer
from yolosomi_tpu_torch.engine.trainer import create_train_state, make_train_step
from yolosomi_tpu_torch.losses import ComputeLoss
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


def _dcnv3_case(gen, dtype, n, h, w, g, cg, s, dil, k=3, shifted=None):
    """Inputs of a k x k DCNv3 sampling with pad k // 2; `shifted` ("value"
    or "offset") puts that tensor one element past an aligned address:
    value then misses 16-byte alignment, and offset the alignment of its
    (x, y) pairs."""
    pad, P = k // 2, k * k
    ho = (h + 2 * pad - (dil * (k - 1) + 1)) // s + 1
    wo = (w + 2 * pad - (dil * (k - 1) + 1)) // s + 1
    value = torch.randn(n, h, w, g * cg, device="cuda", generator=gen)
    # offsets of several pixels: fractional points, some off the map
    offset = (torch.rand(n, ho, wo, g * P * 2, device="cuda", generator=gen) - 0.5) * 8
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
@pytest.mark.parametrize("name", ["yolo-somi", "yolo-somi-dcn"])
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


@pytest.mark.cuda
def test_dcn_kernels_refuse_a_gradient_on_cuda(cuda, tmp_path):
    """No backward yet: under autograd each raises instead of returning an
    output without a gradient; without gradients they run. train.py
    refuses yolo-somi-dcn on CUDA with the same message."""
    v = torch.randn(1, 6, 6, 8, device="cuda", generator=cuda).requires_grad_()
    off = torch.zeros(1, 6, 6, 2 * 9, device="cuda")
    mask = torch.full((1, 6, 6, 9), 1 / 9, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        dcnv3_core(v, off, mask, 3, 3, 1, 1, 1, 1, 1, 1, 1, 8)
    oy = torch.zeros(1, 6, 6, 9, device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        dcnv2_im2col(v.detach(), oy, oy.detach(), torch.ones(1, 6, 6, 9, device="cuda"))
    with torch.no_grad():
        assert dcnv3_core(v, off, mask, 3, 3, 1, 1, 1, 1, 1, 1, 1, 8).shape == (1, 6, 6, 8)
    data = tmp_path / "data.yaml"
    data.write_text(yaml.safe_dump({"path": str(tmp_path), "train": "images", "val": "images", "nc": 3}))
    opt = train.parse_opt(["--cfg", "yolo-somi-dcn", "--data", str(data), "--project", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="no backward"):
        train.train(load_hyp(find_config("hyp.visdrone", "hyps")), opt)


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
