"""yolosomi_tpu_torch ODConv against the JAX package: the per-sample conv's
plain version against the Pallas kernel (interpret mode), and the whole
ODConv module against the flax ODConv at the flagship's row 1 and row 26
sites; the gradient wrappers' plain versions on the CPU against the VJP of
the conv the JAX package trains through; and the bf16 kernel's launch
plan and the bf16 gradient kernels' plans, which are pure Python. The
CUDA kernels themselves are checked on a GPU by
tests/test_torch_port_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_port_common import IMGSZ, few_threads, jax_flagship, layer_variables, small_flagship_cfg  # noqa: F401
from yolosomi_tpu.ops.odconv_pallas import odconv_s2_pallas
from yolosomi_tpu_torch.models.yolo import build_model, parse_model
from yolosomi_tpu_torch.ops.odconv import (_BK, _BM, _DW_MAX_SPLIT, _DW_TILES, _DX_TILES, _TILES, _dw_plan,
                                           _dx_plan, _k_splits, _plan, _smem_bytes, odconv_s2,
                                           odconv_s2_dwmix, odconv_s2_dx, odconv_s2_reference, plain_version)
from yolosomi_tpu_torch.utils.config import find_config, load_model_cfg
from yolosomi_tpu_torch.utils.weights import load_jax_variables


@pytest.mark.parametrize(
    "b,h,w,cin,cout",
    [(2, 16, 16, 8, 128), (2, 8, 8, 32, 256), (2, 8, 8, 128, 256), (1, 12, 20, 16, 128)],
)
def test_reference_matches_pallas_kernel(b, h, w, cin, cout):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wmix = (rng.standard_normal((b, 3, 3, cin, cout)) * 0.1).astype(np.float32)
    ref = np.asarray(odconv_s2_pallas(jnp.asarray(x), jnp.asarray(wmix), interpret=True))
    got = odconv_s2_reference(torch.from_numpy(x), torch.from_numpy(wmix)).numpy()
    assert got.shape == (b, h // 2, w // 2, cout)
    # f32 on both sides: only the summation order differs
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_wrapper_on_cpu_runs_the_plain_version_and_checks_shapes():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 8, 6, 4)).astype(np.float32))
    wmix = torch.from_numpy(rng.standard_normal((2, 3, 3, 4, 5)).astype(np.float32))
    before = odconv_s2.launches
    torch.testing.assert_close(odconv_s2(x, wmix), odconv_s2_reference(x, wmix), rtol=0, atol=0)
    assert odconv_s2.launches == before  # only CUDA launches count
    with pytest.raises(ValueError, match="even"):
        odconv_s2(x[:, :7], wmix)
    with pytest.raises(ValueError, match="does not match"):
        odconv_s2(x, wmix[:, :, :, :3])
    with pytest.raises(ValueError, match="CUDA"):  # no silent plain version off the CPU
        odconv_s2(x.to("meta"), wmix.to("meta"))


def _jax_training_conv(x, wmix):
    """The per-sample conv the JAX package trains through (ODConv2d's
    batch-grouped `vmap` branch, yolosomi_tpu/models/layers.py:928-942, at
    k 3, s 2, p 1, d 1, g 1)."""
    def one(xi, wi):
        return jax.lax.conv_general_dilated(xi[None], wi, window_strides=(2, 2), padding=((1, 1), (1, 1)),
                                            rhs_dilation=(1, 1), dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                            feature_group_count=1)[0]

    return jax.vmap(one)(x, wmix)


@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 8, 8, 16, 32), (2, 10, 6, 3, 4), (1, 12, 20, 24, 8)])
def test_gradient_wrappers_on_cpu_match_the_vjp_jax_trains_through(b, h, w, cin, cout):
    """odconv_s2_dx and odconv_s2_dwmix on CPU tensors run their plain
    version (and count no launch): dx and dwmix within 1e-4 of the largest
    element of jax.vjp of the JAX package's training conv (f32, other
    summation orders)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wmix = (rng.standard_normal((b, 3, 3, cin, cout)) * 0.1).astype(np.float32)
    dy = rng.standard_normal((b, h // 2, w // 2, cout)).astype(np.float32)
    _, vjp = jax.vjp(_jax_training_conv, jnp.asarray(x), jnp.asarray(wmix))
    want_dx, want_dw = (np.asarray(g) for g in vjp(jnp.asarray(dy)))
    before = (odconv_s2_dx.launches, odconv_s2_dwmix.launches)
    dx = odconv_s2_dx(torch.from_numpy(dy), torch.from_numpy(wmix), h, w).numpy()
    dw = odconv_s2_dwmix(torch.from_numpy(x), torch.from_numpy(dy)).numpy()
    assert (odconv_s2_dx.launches, odconv_s2_dwmix.launches) == before
    assert dx.shape == x.shape and dw.shape == wmix.shape
    np.testing.assert_allclose(dx, want_dx, rtol=0, atol=1e-4 * np.abs(want_dx).max())
    np.testing.assert_allclose(dw, want_dw, rtol=0, atol=1e-4 * np.abs(want_dw).max())


@pytest.fixture(scope="module")
def flagship():
    cfg = small_flagship_cfg()
    jmodel, jmeta, variables = jax_flagship(cfg)
    pmodel, _ = build_model(cfg, nc=jmeta.nc, device="cpu")
    assert load_jax_variables(pmodel, variables) == ([], [])
    return jmodel, jmeta, variables, pmodel


@pytest.mark.parametrize("row", [1, 26])
def test_odconv_module_matches_flax(flagship, row):
    """Trunk + K-mix + per-sample conv + bias mix + BN + SiLU."""
    jmodel, jmeta, variables, pmodel = flagship
    spec = jmeta.specs[row]
    src = row + spec.f if spec.f < 0 else spec.f
    c1, hw = jmeta.specs[src].c2, int(IMGSZ / jmeta.specs[src].stride)
    x = np.random.default_rng(row).standard_normal((2, hw, hw, c1)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, t: jmodel.layers[row].apply(v, t, False))(layer_variables(variables, row), x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = pmodel.model[row](xt).permute(0, 2, 3, 1).numpy()
        with plain_version():  # on the CPU both name the plain version
            same = pmodel.model[row](xt).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, hw // 2, hw // 2, spec.c2)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got, same)


# ---------------------------------------------------------------------------
# the bf16 kernel's launch plan (pure Python: what the CUDA kernel is told)
# ---------------------------------------------------------------------------


def _odconv_sites(width: float, depth: float, imgsz: int, batch: int, name: str = "yolo-somi") -> list:
    """(B, H, W, Cin, Cout) of every ODConv row of config `name` (the
    flagship) at this size, read from the graph built on the meta device."""
    cfg = dict(load_model_cfg(find_config(name)))
    cfg["width_multiple"], cfg["depth_multiple"] = width, depth
    with torch.device("meta"):
        _, meta = parse_model(cfg)
    sites = []
    for spec in meta.specs:
        if spec.name in ("ODConv", "ODConv_3rd"):
            src = meta.specs[spec.i + spec.f if spec.f < 0 else spec.f]
            hw = int(imgsz / src.stride)
            sites.append((batch, hw, hw, src.c2, spec.c2))
    return sites


# rows 1, 26, 29, 32 of yolo-somi at 640 px, batch 8, and at the tests'
# width 0.25 / depth 0.33 / 64 px, batch 2
SERVING_SITES = [(8, 320, 320, 64, 128), (8, 160, 160, 256, 256), (8, 80, 80, 256, 256), (8, 40, 40, 512, 256)]
SMALL_SITES = [(2, 32, 32, 16, 32), (2, 16, 16, 64, 64), (2, 8, 8, 64, 64), (2, 4, 4, 128, 64)]
# the same rows of yolo-somi-s (its width 0.5 / depth 0.67) at 640 px, batch 8
SOMI_S_SITES = [(8, 320, 320, 32, 64), (8, 160, 160, 128, 128), (8, 80, 80, 128, 128), (8, 40, 40, 256, 128)]
# tests/test_torch_port_cuda.py's shapes: the odd ones, then the serving-like
# bf16 cases with the plan each must reach
CARD_ODD = [(3, 22, 38, 24, 72), (2, 16, 16, 8, 128), (1, 12, 20, 128, 256)]
CARD_PLANS = {(2, 40, 40, 512, 256): (1, 8), (1, 64, 64, 64, 128): (0, 5), (2, 32, 32, 256, 256): (1, 8),
              (8, 160, 160, 64, 128): (0, 1), (8, 80, 80, 256, 256): (1, 1), (2, 64, 64, 32, 64): (0, 5),
              (2, 20, 20, 256, 128): (0, 8)}


def test_site_lists_match_the_graph():
    assert _odconv_sites(1.0, 1.0, 640, 8) == SERVING_SITES
    assert _odconv_sites(0.25, 0.33, 64, 2) == SMALL_SITES
    assert _odconv_sites(0.5, 0.67, 640, 8, "yolo-somi-s") == SOMI_S_SITES


@pytest.mark.parametrize("shape", SERVING_SITES + SMALL_SITES + SOMI_S_SITES + CARD_ODD + list(CARD_PLANS))
def test_plan_tiles_cover_the_output_once_and_splits_partition_k(shape):
    B, H, W, cin, cout = shape
    M, K = (H // 2) * (W // 2), 9 * cin
    cfg, split = _plan(*shape)
    bn, _, per_sm = _TILES[cfg]
    bm = _BM
    # the grid (ceil(M/BM), ceil(Cout/BN), B*split); each block writes the
    # in-range part of its BM x BN tile
    cover = np.zeros((M, cout), np.int32)
    for bx in range(-(-M // bm)):
        for by in range(-(-cout // bn)):
            cover[bx * bm:(bx + 1) * bm, by * bn:(by + 1) * bn] += 1
    assert (cover == 1).all()
    parts = _k_splits(K, split)
    assert len(parts) == split and parts[0][0] == 0 and parts[-1][1] == K
    assert all(a < b for a, b in parts)  # none empty
    assert all(parts[i][1] == parts[i + 1][0] for i in range(split - 1))
    assert all(a % 8 == 0 and b % 8 == 0 for a, b in parts)  # whole 8-channel vectors
    assert all(a % _BK == 0 for a, _ in parts)  # whole K steps
    # a block's shared memory fits; per_sm blocks fit one SM's 228 KB
    assert _smem_bytes(cfg) <= 227 * 1024 and per_sm * (_smem_bytes(cfg) + 1024) <= 228 * 1024
    if shape in SERVING_SITES:  # fills at least 3/4 of a wave of resident blocks
        assert -(-M // bm) * -(-cout // bn) * B * split >= 0.75 * per_sm * 132


def test_plans_of_the_serving_sites_and_the_card_cases():
    """Row 1 takes 128x128 tiles, rows 26, 29 and 32 128x256, row 32 with K
    split in 4; the card tests reach each configuration with and without
    split-K."""
    assert [_plan(*s) for s in SERVING_SITES] == [(0, 1), (1, 1), (1, 1), (1, 4)]
    assert {s: _plan(*s) for s in CARD_PLANS} == CARD_PLANS
    reached = {(cfg, split > 1) for cfg, split in CARD_PLANS.values()}
    assert reached == {(0, False), (0, True), (1, False), (1, True)}


def test_plans_of_yolo_somi_s_sites():
    """Cout 64 and 128 take the 128x128 tiles (half of each idle at row 1);
    rows 29 and 32 split K (104 and 32 tiles unsplit); row 1's K = 288 ends
    in a half 64-channel step. dx: 128x64, 128x128, 128x128, 128x256
    tiles; dwmix 128x128 tiles, its pixels split in 11, 3, 2 and 1."""
    assert [_plan(*s) for s in SOMI_S_SITES] == [(0, 1), (0, 1), (0, 2), (0, 8)]
    assert [_dx_plan(s[3]) for s in SOMI_S_SITES] == [0, 1, 1, 2]
    assert [_dw_plan(*s) for s in SOMI_S_SITES] == [(0, 11), (0, 3), (0, 2), (0, 1)]
    assert 9 * SOMI_S_SITES[0][3] % _BK == 32


@pytest.mark.parametrize("cin,cout", [(12, 16), (16, 20), (4, 4)])
def test_bf16_needs_channels_in_multiples_of_8_before_any_launch(cin, cout):
    x = torch.empty(2, 8, 8, cin, dtype=torch.bfloat16, device="meta")
    wmix = torch.empty(2, 3, 3, cin, cout, dtype=torch.bfloat16, device="meta")
    before = odconv_s2.launches
    with pytest.raises(ValueError, match="multiples of 8"):
        odconv_s2(x, wmix)
    assert odconv_s2.launches == before
    # f32 takes any width; off the CPU and the card it still refuses the device
    with pytest.raises(ValueError, match="CUDA"):
        odconv_s2(x.float(), wmix.float())


# ---------------------------------------------------------------------------
# the bf16 gradient kernels' launch plans (csrc/odconv_s2_bwd.cu)
# ---------------------------------------------------------------------------

# tests/test_torch_port_cuda.py's gradient shapes, with the (dx tile
# configuration, (dwmix tile configuration, split)) each must reach: every
# configuration of both kernels, dwmix with and without a split; ragged
# rows and columns in every parity class at (3, 22, 38, 24, 72),
# (2, 18, 26, 120, 40) and (1, 12, 20, 200, 136), whose Cout (72, 40, 136)
# also puts taps inside K steps
CARD_BWD_PLANS = {(2, 32, 32, 64, 128): (0, (0, 2)), (2, 16, 16, 256, 256): (2, (1, 1)),
                  (2, 8, 8, 512, 256): (2, (1, 1)), (3, 22, 38, 24, 72): (0, (0, 4)),
                  (2, 320, 320, 64, 128): (0, (0, 16)), (2, 18, 26, 120, 40): (1, (0, 2)),
                  (1, 12, 20, 200, 136): (2, (1, 1)), (1, 96, 98, 256, 256): (2, (1, 4)),
                  (2, 16, 16, 64, 64): (0, (0, 1)), (2, 64, 64, 32, 64): (0, (0, 8)),
                  (2, 20, 20, 256, 128): (2, (0, 1))}


def _fits_an_sm(tiles: dict, cfg: int) -> None:
    """A block's shared memory fits (227 KB); per_sm blocks fit one SM's
    228 KB (1 KB of it reserved a block) and 2048 threads; the registers
    the launch bounds (256 threads, per_sm blocks) leave a thread hold its
    BN/2 f32 accumulators and the loaders' state."""
    bn, _, per_sm = tiles[cfg]
    smem = _smem_bytes(cfg, tiles)
    assert smem <= 227 * 1024 and per_sm * (smem + 1024) <= 228 * 1024
    assert per_sm * 256 <= 2048
    assert min(255, 65536 // (256 * per_sm)) >= bn // 2 + 24


@pytest.mark.parametrize("shape", SERVING_SITES + SMALL_SITES + SOMI_S_SITES + list(CARD_BWD_PLANS))
def test_dx_plan_covers_every_input_pixel_and_channel_once(shape):
    """The grid (ceil(M/128), ceil(Cin/BN), B*4) of the bf16 dx kernel: the
    block rows of each parity class (py, px) are its pixels (qy, qx) = (m //
    OW, m % OW), written to (2qy+py, 2qx+px); together the four classes'
    in-range tiles write every (pixel, channel) of dx once."""
    B, H, W, cin, cout = shape
    cfg = _dx_plan(cin)
    bn = _DX_TILES[cfg][0]
    OW, M = W // 2, (H // 2) * (W // 2)
    cover = np.zeros((H * W, cin), np.int16)
    for py, px in ((1, 1), (1, 0), (0, 1), (0, 0)):  # the kernel's ranks 0-3
        for bx in range(-(-M // _BM)):
            m = np.arange(bx * _BM, min(M, (bx + 1) * _BM))
            pix = (2 * (m // OW) + py) * W + 2 * (m % OW) + px
            for by in range(-(-cin // bn)):
                cover[pix, by * bn:(by + 1) * bn] += 1
    assert (cover == 1).all()
    assert cin <= bn or bn == 256  # one column tile covers Cin, or 256-wide tiles
    _fits_an_sm(_DX_TILES, cfg)


@pytest.mark.parametrize("shape", SERVING_SITES + SMALL_SITES + SOMI_S_SITES + list(CARD_BWD_PLANS))
def test_dw_plan_covers_dwmix_once_and_splits_partition_the_pixels(shape):
    """The grid (ceil(9*Cin/128), ceil(Cout/BN), B*split) of the bf16 dwmix
    kernel writes every (tap, ci, co) of a sample once; the split's parts
    are non-empty whole 64-pixel K steps that partition the P pixels."""
    B, H, W, cin, cout = shape
    cfg, split = _dw_plan(*shape)
    bn = _DW_TILES[cfg][0]
    R, P = 9 * cin, (H // 2) * (W // 2)
    cover = np.zeros((R, cout), np.int16)
    for bx in range(-(-R // _BM)):
        for by in range(-(-cout // bn)):
            cover[bx * _BM:(bx + 1) * _BM, by * bn:(by + 1) * bn] += 1
    assert (cover == 1).all()
    parts = _k_splits(P, split)
    assert 1 <= split <= _DW_MAX_SPLIT and len(parts) == split
    assert all(a < b for a, b in parts) and all(a % _BK == 0 for a, _ in parts)
    assert parts[0][0] == 0 and parts[-1][1] == P and all(parts[i][1] == parts[i + 1][0] for i in range(split - 1))
    _fits_an_sm(_DW_TILES, cfg)


def test_bwd_plans_of_the_serving_sites_and_the_card_cases():
    """At 640 px, b8: dx takes 128x64 tiles at row 1 (Cin 64) and 128x256
    at rows 26, 29 and 32; dwmix 128x128 at row 1 with its 25,600-pixel
    reduction split in 6 (40 output tiles), 128x256 elsewhere, row 26
    split in 2 (144 tiles: 1.09 waves unsplit). The card tests reach every
    configuration of both kernels, dwmix with and without a split."""
    assert [_dx_plan(s[3]) for s in SERVING_SITES] == [0, 2, 2, 2]
    assert [_dw_plan(*s) for s in SERVING_SITES] == [(0, 6), (1, 2), (1, 1), (1, 1)]
    assert {s: (_dx_plan(s[3]), _dw_plan(*s)) for s in CARD_BWD_PLANS} == CARD_BWD_PLANS
    assert {dx for dx, _ in CARD_BWD_PLANS.values()} == set(_DX_TILES)
    assert {(cfg, split > 1) for _, (cfg, split) in CARD_BWD_PLANS.values()} == {(c, s) for c in _DW_TILES
                                                                               for s in (False, True)}
