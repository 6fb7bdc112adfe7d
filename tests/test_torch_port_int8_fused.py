"""yolosomi_tpu_torch's int8 conv with the activation's quantize fused into
it (ops/int8.py: conv_int8_fused, its plain version, the weight packing and
the launch plan) on the CPU.

- conv_int8_fused_reference against JAX's ConvRaw._int8_forward, run as
  tests/test_torch_port_quant.py runs it (jax.lax.conv_general_dilated
  spied for the int8 operands): per tensor and per channel, ungrouped,
  depthwise and grouped, C in {2, 3, 16, 98, 177}, at stride 2 or
  dilation 2, x handed over as a channel slice of a wider NHWC tensor (a
  pixel stride larger than C). Tolerance: the quantized x and the int32
  sums bitwise; in f32 the output bitwise too; in bf16 (JAX computes the
  dequant in f32 and casts) the output within one bf16 rounding of JAX's.
- _conv_int8_plan at the 71 distinct ConvRaw shapes of a served b8 batch of
  the full-width flagship at 640 px: routes, BN, tap-aligned K, tiles and
  grids that cover every output pixel and channel, halos within shared
  memory.
- pack_conv_int8_weights: w_q on the unpadded entries, zeros elsewhere.
Sizes: single convs of 2 x 9 x 11 pixels.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_port_common import few_threads  # noqa: F401
from yolosomi_tpu.models import layers as jax_layers
from yolosomi_tpu.ops import quant as jax_quant
from yolosomi_tpu_torch.ops.int8 import (_BM, _BN_WIDTHS, _DIRECT_SMEM, _conv_int8_plan, _gemm_smem, _halo,
                                         _out_hw, conv_int8_fused, conv_int8_fused_reference, conv_int8_reference,
                                         pack_conv_int8_weights, quantize_activation)

# ---------------------------------------------------------------------------
# the fused plain version against JAX's int8 ConvRaw
# ---------------------------------------------------------------------------

# C -> the group count of its "grouped" case (two output channels a group)
GROUPED = {2: 2, 3: 3, 16: 4, 98: 2, 177: 3}
# C -> (stride, dilation) of its cases: stride 2 or dilation 2
GEOMETRY = {2: (2, 1), 3: (1, 2), 16: (2, 1), 98: (1, 2), 177: (2, 1)}


def conv_case(C: int, kind: str):
    """(cout, groups) of a case."""
    if kind == "ungrouped":
        return 24, 1
    if kind == "depthwise":
        return C, C
    return 2 * GROUPED[C], GROUPED[C]


def jax_int8(x: np.ndarray, C: int, kind: str, per_channel: bool, dtype, monkeypatch):
    """JAX's ConvRaw (3x3, bias) in int8 on x (B, H, W, C) with a_scale at
    80% of x's absmax (some values clip): its output, its int8 x and its
    int32 sums, and the module's variables."""
    cout, g = conv_case(C, kind)
    s, d = GEOMETRY[C]
    rng = np.random.default_rng(C * 7 + len(kind))
    m = jax_layers.ConvRaw(cout, 3, s, None, g, d, use_bias=True, dtype=dtype)
    v = jax.tree_util.tree_map(np.asarray, m.init(jax.random.PRNGKey(C), jnp.asarray(x)))
    v["params"]["conv"]["bias"] = rng.standard_normal(cout).astype(np.float32)
    a_scale = (np.abs(x).max(axis=(0, 1, 2)) if per_channel else np.abs(x).max()).astype(np.float32) * 0.8
    seen = {}
    orig = jax.lax.conv_general_dilated

    def spy(lhs, rhs, *args, **kwargs):
        out = orig(lhs, rhs, *args, **kwargs)
        if lhs.dtype == jnp.int8:
            seen.update(x_q=np.asarray(lhs), w_q=np.asarray(rhs), acc=np.asarray(out))
        return out

    monkeypatch.setattr(jax.lax, "conv_general_dilated", spy)
    with jax_quant.quant_mode("int8"):
        y = m.apply(dict(v, quant={"a_scale": jnp.asarray(a_scale)}), jnp.asarray(x, dtype))
    monkeypatch.setattr(jax.lax, "conv_general_dilated", orig)
    assert seen, "JAX's int8 branch did not run"
    return np.asarray(y.astype(jnp.float32)), seen, v, a_scale, (s, d, g)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_channel", [False, True], ids=["per_tensor", "per_channel"])
@pytest.mark.parametrize("kind", ["ungrouped", "depthwise", "grouped"])
@pytest.mark.parametrize("C", sorted(GROUPED))
def test_fused_reference_matches_jax_int8_convraw(C, kind, per_channel, dtype, monkeypatch):
    rng = np.random.default_rng(C)
    wide = (rng.standard_normal((2, 9, 11, C + 5)) * rng.uniform(0.2, 3.0, C + 5)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    wide = np.array(jnp.asarray(wide, jdt).astype(jnp.float32))  # the values bf16 holds
    x = wide[..., 3:3 + C]
    want, seen, v, a_scale, (s, d, g) = jax_int8(np.ascontiguousarray(x), C, kind, per_channel, jdt, monkeypatch)

    # the port's operands as ops/quant.py makes them for this ConvRaw
    from yolosomi_tpu_torch.models.layers import ConvRaw
    from yolosomi_tpu_torch.ops import quant

    cout, _ = conv_case(C, kind)
    conv = ConvRaw(C, cout, 3, s, d, dilation=d, groups=g, bias=True)
    with torch.no_grad():
        conv.weight.copy_(torch.tensor(v["params"]["conv"]["kernel"].transpose(3, 2, 0, 1)))
        conv.bias.copy_(torch.tensor(v["params"]["conv"]["bias"]))
    conv.a_scale = torch.tensor(a_scale)
    with torch.no_grad():
        w_q, packed, scale, s_a, bias = quant._int8_operands(conv)
    xt = torch.from_numpy(wide).to(tdt)[..., 3:3 + C]  # a view: pixel stride C + 5
    assert xt.stride(2) == C + 5 and xt.stride(3) == 1
    kw = dict(stride=(s, s), padding=(d, d), dilation=(d, d), groups=g)

    x_q = quantize_activation(xt, s_a)
    np.testing.assert_array_equal(x_q.numpy(), seen["x_q"])
    np.testing.assert_array_equal(w_q.numpy(), seen["w_q"].transpose(3, 0, 1, 2))  # HWIO -> OHWI
    assert np.abs(seen["x_q"]).max() == 127, "the scale clips nothing: the test would miss the clip"
    acc = conv_int8_fused_reference(xt, s_a, w_q, None, out_dtype=torch.int32, **kw)
    np.testing.assert_array_equal(acc.numpy(), seen["acc"])
    bias = bias.detach()  # the module's parameter itself
    got = conv_int8_fused_reference(xt, s_a, w_q, scale, bias, packed=packed, **kw)
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_array_equal(got.numpy(), want)
    else:  # one bf16 rounding of the same f32 value
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8, atol=0)
    # the CPU entry is the plain version
    assert torch.equal(conv_int8_fused(xt, s_a, w_q, scale, bias, packed=packed, **kw), got)


def test_fused_entries_check_their_operands():
    x = torch.randn(1, 6, 6, 8)
    w = torch.zeros(4, 3, 3, 8, dtype=torch.int8)
    s_a = torch.tensor(0.02)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        conv_int8_fused(x.to(torch.int8), s_a, w, None, out_dtype=torch.int32)
    with pytest.raises(ValueError, match="s_a"):
        conv_int8_fused(x, torch.ones(7), w, None, out_dtype=torch.int32)
    with pytest.raises(ValueError, match="scale"):
        conv_int8_fused(x, s_a, w, None)
    with pytest.raises(ValueError, match="groups"):
        conv_int8_fused(x, s_a, w, None, out_dtype=torch.int32, groups=3)
    # the fused plain version is quantize_activation and conv_int8_reference
    y = conv_int8_fused(x, s_a, w, None, out_dtype=torch.int32, padding=(1, 1))
    assert torch.equal(y, conv_int8_reference(quantize_activation(x, s_a), w, out_dtype=torch.int32,
                                              padding=(1, 1)))


# ---------------------------------------------------------------------------
# the launch plan at the flagship's shapes
# ---------------------------------------------------------------------------

# (x, w, stride, padding, dilation, groups, calls a batch): every distinct
# ConvRaw call of one int8 forward of the full-width flagship on a b8 batch
# of 640 px images (chip_smoke.py phase 12 captures the same list)
FLAGSHIP_SHAPES = [
    ((8, 640, 640, 3), (64, 3, 3, 3), (2, 2), (1, 1), (1, 1), 1, 1),
    ((64, 320, 1, 16), (1, 7, 1, 16), (1, 1), (3, 0), (1, 1), 1, 3),
    ((8, 160, 160, 128), (128, 1, 1, 128), (1, 1), (0, 0), (1, 1), 1, 1),
    ((8, 160, 160, 64), (64, 3, 3, 64), (1, 1), (1, 1), (1, 1), 1, 6),
    ((8, 160, 160, 2), (1, 7, 7, 2), (1, 1), (3, 3), (1, 1), 1, 3),
    ((8, 160, 160, 320), (128, 1, 1, 320), (1, 1), (0, 0), (1, 1), 1, 1),
    ((8, 160, 160, 128), (256, 3, 3, 128), (2, 2), (1, 1), (1, 1), 1, 1),
    ((8, 160, 160, 128), (256, 1, 1, 128), (1, 1), (0, 0), (1, 1), 1, 1),
    ((64, 160, 1, 16), (1, 7, 1, 16), (1, 1), (3, 0), (1, 1), 1, 6),
    ((8, 160, 160, 256), (256, 3, 3, 1), (1, 1), (1, 1), (1, 1), 256, 2),
    ((8, 160, 160, 256), (256, 1, 1, 256), (1, 1), (0, 0), (1, 1), 1, 1),
    ((8, 160, 160, 256), (256, 1, 1, 256), (1, 1), (0, 0), (1, 1), 1, 4),
    ((8, 160, 160, 128), (64, 3, 3, 128), (1, 1), (1, 1), (1, 1), 1, 3),
    ((8, 160, 160, 64), (128, 3, 3, 64), (1, 1), (1, 1), (1, 1), 1, 3),
    ((8, 160, 160, 640), (256, 1, 1, 640), (1, 1), (0, 0), (1, 1), 1, 1),
    ((8, 160, 160, 256), (177, 3, 3, 256), (1, 1), (1, 1), (1, 1), 1, 1),
    ((8, 160, 160, 177), (98, 3, 3, 177), (1, 1), (1, 1), (1, 1), 1, 1),
    ((8, 160, 160, 98), (20, 1, 1, 98), (1, 1), (0, 0), (1, 1), 1, 1),
    ((8, 160, 160, 256), (40, 1, 1, 256), (1, 1), (0, 0), (1, 1), 1, 1),
    ((8, 80, 80, 256), (256, 1, 1, 256), (1, 1), (0, 0), (1, 1), 1, 7),
    ((8, 80, 80, 128), (128, 3, 3, 128), (1, 1), (1, 1), (1, 1), 1, 12),
    ((8, 80, 80, 2), (1, 7, 7, 2), (1, 1), (3, 3), (1, 1), 1, 6),
    ((8, 80, 80, 1024), (256, 1, 1, 1024), (1, 1), (0, 0), (1, 1), 1, 1),
    ((8, 80, 80, 256), (512, 3, 3, 256), (2, 2), (1, 1), (1, 1), 1, 1),
    ((64, 80, 1, 16), (1, 7, 1, 16), (1, 1), (3, 0), (1, 1), 1, 3),
    ((8, 80, 80, 256), (256, 3, 3, 1), (1, 1), (1, 1), (1, 1), 256, 2),
    ((8, 80, 80, 256), (256, 1, 1, 256), (1, 1), (0, 0), (1, 1), 1, 1),
    ((8, 80, 80, 128), (64, 3, 3, 128), (1, 1), (1, 1), (1, 1), 1, 6),
    ((8, 80, 80, 64), (128, 3, 3, 64), (1, 1), (1, 1), (1, 1), 1, 6),
    ((8, 80, 80, 640), (256, 1, 1, 640), (1, 1), (0, 0), (1, 1), 1, 2),
    ((64, 80, 1, 32), (1, 7, 1, 32), (1, 1), (3, 0), (1, 1), 1, 3),
    ((8, 80, 80, 256), (177, 3, 3, 256), (1, 1), (1, 1), (1, 1), 1, 1),
    ((8, 80, 80, 177), (98, 3, 3, 177), (1, 1), (1, 1), (1, 1), 1, 1),
    ((8, 80, 80, 98), (20, 1, 1, 98), (1, 1), (0, 0), (1, 1), 1, 1),
    ((8, 80, 80, 256), (40, 1, 1, 256), (1, 1), (0, 0), (1, 1), 1, 1),
    ((8, 40, 40, 512), (512, 1, 1, 512), (1, 1), (0, 0), (1, 1), 1, 1),
    ((8, 40, 40, 256), (256, 3, 3, 256), (1, 1), (1, 1), (1, 1), 1, 12),
    ((8, 40, 40, 2), (1, 7, 7, 2), (1, 1), (3, 3), (1, 1), 1, 6),
    ((8, 40, 40, 2048), (512, 1, 1, 2048), (1, 1), (0, 0), (1, 1), 1, 1),
    ((8, 40, 40, 512), (1024, 3, 3, 512), (2, 2), (1, 1), (1, 1), 1, 1),
    ((8, 40, 40, 512), (256, 1, 1, 512), (1, 1), (0, 0), (1, 1), 1, 2),
    ((8, 40, 40, 256), (256, 3, 3, 1), (1, 1), (1, 1), (1, 1), 256, 2),
    ((8, 40, 40, 256), (256, 1, 1, 256), (1, 1), (0, 0), (1, 1), 1, 1),
    ((8, 40, 40, 256), (256, 1, 1, 256), (1, 1), (0, 0), (1, 1), 1, 3),
    ((8, 40, 40, 128), (64, 3, 3, 128), (1, 1), (1, 1), (1, 1), 1, 3),
    ((8, 40, 40, 64), (128, 3, 3, 64), (1, 1), (1, 1), (1, 1), 1, 3),
    ((8, 40, 40, 640), (256, 1, 1, 640), (1, 1), (0, 0), (1, 1), 1, 1),
    ((8, 40, 40, 256), (512, 1, 1, 256), (1, 1), (0, 0), (1, 1), 1, 1),
    ((8, 40, 40, 256), (128, 3, 3, 256), (1, 1), (1, 1), (1, 1), 1, 3),
    ((8, 40, 40, 128), (256, 3, 3, 128), (1, 1), (1, 1), (1, 1), 1, 3),
    ((8, 40, 40, 1280), (512, 1, 1, 1280), (1, 1), (0, 0), (1, 1), 1, 1),
    ((64, 40, 1, 64), (1, 7, 1, 64), (1, 1), (3, 0), (1, 1), 1, 3),
    ((8, 40, 40, 256), (177, 3, 3, 256), (1, 1), (1, 1), (1, 1), 1, 1),
    ((8, 40, 40, 177), (98, 3, 3, 177), (1, 1), (1, 1), (1, 1), 1, 1),
    ((8, 40, 40, 98), (20, 1, 1, 98), (1, 1), (0, 0), (1, 1), 1, 1),
    ((8, 40, 40, 256), (40, 1, 1, 256), (1, 1), (0, 0), (1, 1), 1, 1),
    ((8, 20, 20, 1024), (1024, 1, 1, 1024), (1, 1), (0, 0), (1, 1), 1, 1),
    ((8, 20, 20, 512), (512, 3, 3, 512), (1, 1), (1, 1), (1, 1), 1, 6),
    ((8, 20, 20, 2), (1, 7, 7, 2), (1, 1), (3, 3), (1, 1), 1, 3),
    ((8, 20, 20, 2560), (1024, 1, 1, 2560), (1, 1), (0, 0), (1, 1), 1, 2),
    ((8, 20, 20, 1024), (512, 1, 1, 1024), (1, 1), (0, 0), (1, 1), 1, 1),
    ((8, 20, 20, 2048), (1024, 1, 1, 2048), (1, 1), (0, 0), (1, 1), 1, 1),
    ((8, 20, 20, 1024), (256, 1, 1, 1024), (1, 1), (0, 0), (1, 1), 1, 2),
    ((8, 20, 20, 256), (1024, 1, 1, 256), (1, 1), (0, 0), (1, 1), 1, 1),
    ((8, 20, 20, 512), (256, 3, 3, 512), (1, 1), (1, 1), (1, 1), 1, 3),
    ((8, 20, 20, 256), (512, 3, 3, 256), (1, 1), (1, 1), (1, 1), 1, 3),
    ((8, 20, 20, 256), (177, 3, 3, 256), (1, 1), (1, 1), (1, 1), 1, 1),
    ((8, 20, 20, 177), (98, 3, 3, 177), (1, 1), (1, 1), (1, 1), 1, 1),
    ((8, 20, 20, 98), (20, 1, 1, 98), (1, 1), (0, 0), (1, 1), 1, 1),
    ((8, 20, 20, 256), (256, 1, 1, 256), (1, 1), (0, 0), (1, 1), 1, 2),
    ((8, 20, 20, 256), (40, 1, 1, 256), (1, 1), (0, 0), (1, 1), 1, 1),
]


def test_flagship_shapes_are_the_served_batch():
    assert len(FLAGSHIP_SHAPES) == 71 and sum(s[-1] for s in FLAGSHIP_SHAPES) == 175


@pytest.mark.parametrize("shape", FLAGSHIP_SHAPES, ids=lambda s: "x{}w{}s{}g{}".format(*s[:3], s[5]).replace(" ", ""))
def test_plan_at_flagship_shapes(shape):
    """Routes; the GEMM's BN the narrowest int8 wgmma width that holds N,
    its K tap-aligned (each tap's channels rounded up to 32), its tiles (64
    consecutive pixels for a 1x1 conv, else th x tw <= 64 pixels of one
    image with their halo in shared memory) and grid covering every output
    pixel and channel once; the direct kernels' tiles covering every output
    pixel and channel, their halo within 48 KB."""
    xs, ws, stride, padding, dilation, groups, _ = shape
    B, H, W, C = xs
    N, kh, kw, cg = ws
    Ho, Wo = _out_hw(H, W, (kh, kw), stride, padding, dilation)
    M = B * Ho * Wo
    plan = _conv_int8_plan(xs, ws, stride, padding, dilation, groups)
    if groups == 1 and N >= 8:
        assert plan.route == "gemm"
        assert plan.bn == _BN_WIDTHS[plan.cfg] and _BM == 64
        if N <= 128:
            assert plan.bn == min(w for w in _BN_WIDTHS if w >= N)
        else:  # two blocks an SM at stride 1; stride 2's larger halo quantized once per 256 channels
            assert plan.bn == (128 if stride == (1, 1) else 256)
        assert plan.cp % 32 == 0 and C <= plan.cp < C + 32 and plan.k == kh * kw * plan.cp
        if kh * kw == 1:
            assert (plan.th, plan.tw) == (0, 0)
            assert (plan.grid[0] - 1) * _BM < M <= plan.grid[0] * _BM
            halo = 0  # quantized straight into the stage
        else:
            assert 0 < plan.th * plan.tw <= _BM
            tiles_y, tiles_x = -(-Ho // plan.th), -(-Wo // plan.tw)
            assert (tiles_y - 1) * plan.th < Ho and (tiles_x - 1) * plan.tw < Wo
            assert plan.grid[0] == B * tiles_y * tiles_x
            assert plan.grid[0] * plan.th * plan.tw <= 1.5 * M  # the tiles waste at most a third of their rows
            halo = _halo(plan.th, plan.tw, kh, kw, stride, dilation)
        # the halo and the x offset of each halo pixel (of each row for a linear tile)
        assert plan.smem == _gemm_smem(plan.bn) + 136 * halo + (8 * _BM if not halo else 0)
        assert plan.smem <= 227 * 1024
        assert (plan.grid[1] - 1) * plan.bn < N <= plan.grid[1] * plan.bn and plan.grid[2] == 1
    else:
        assert plan.route == ("dw" if cg == 1 and N == groups else "dp4")
        tiles_y, tiles_x = -(-Ho // plan.th), -(-Wo // plan.tw)
        assert plan.grid[0] == tiles_y * tiles_x and plan.grid[1] == B
        assert (tiles_y - 1) * plan.th < Ho and (tiles_x - 1) * plan.tw < Wo
        covered = C if plan.route == "dw" else groups
        assert (plan.grid[2] - 1) * plan.cb < covered <= plan.grid[2] * plan.cb
        assert plan.smem <= _DIRECT_SMEM
        if plan.route == "dp4":
            assert plan.pstr % 2 == 1 and plan.pstr >= plan.cb * -(-cg // 4)


def test_plans_pinned_at_flagship_sites():
    """The plans at flagship sites, pinned: the head's 3x3 convs over
    C = 177 and to N = 177, SEAM's depthwise conv, the 7x7 spatial gate and
    a 7x1 gate."""
    cases = {  # (x, w, stride): (route, BN, C', th, tw)
        ((8, 160, 160, 177), (98, 3, 3, 177), 1): ("gemm", 128, 192, 8, 8),
        ((8, 160, 160, 256), (177, 3, 3, 256), 1): ("gemm", 128, 256, 8, 8),
        ((8, 20, 20, 512), (512, 3, 3, 512), 1): ("gemm", 128, 512, 3, 20),
        ((8, 40, 40, 2048), (512, 1, 1, 2048), 1): ("gemm", 128, 2048, 0, 0),
        ((8, 20, 20, 2560), (1024, 1, 1, 2560), 1): ("gemm", 128, 2560, 0, 0),
        ((8, 80, 80, 256), (512, 3, 3, 256), 2): ("gemm", 256, 256, 8, 8),
        ((8, 640, 640, 3), (64, 3, 3, 3), 2): ("gemm", 64, 32, 8, 8),
    }
    for (xs, ws, st), (route, bn, cp, th, tw) in cases.items():
        k = ws[1]
        plan = _conv_int8_plan(xs, ws, (st, st), (k // 2, k // 2), (1, 1), 1)
        assert (plan.route, plan.bn, plan.cp, plan.th, plan.tw) == (route, bn, cp, th, tw), (xs, ws, plan)
    dw = _conv_int8_plan((8, 160, 160, 256), (256, 3, 3, 1), (1, 1), (1, 1), (1, 1), 256)
    assert (dw.route, dw.th, dw.tw, dw.cb, dw.grid) == ("dw", 8, 16, 64, (200, 8, 4))
    gate = _conv_int8_plan((8, 160, 160, 2), (1, 7, 7, 2), (1, 1), (3, 3), (1, 1), 1)
    assert (gate.route, gate.th, gate.tw, gate.cb, gate.pstr) == ("dp4", 8, 64, 1, 1)
    gate = _conv_int8_plan((64, 320, 1, 16), (1, 7, 1, 16), (1, 1), (3, 0), (1, 1), 1)
    assert (gate.route, gate.th, gate.tw, gate.pstr, gate.grid) == ("dp4", 40, 1, 5, (8, 64, 1))  # >= 2 an SM
    gate = _conv_int8_plan((8, 20, 20, 2), (1, 7, 7, 2), (1, 1), (3, 3), (1, 1), 1)
    assert (gate.th, gate.tw, gate.grid) == (1, 20, (20, 8, 1))  # as many rows as the map has


# ---------------------------------------------------------------------------
# the packed weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N, kh, kw, cg, groups, route", [
    (98, 3, 3, 177, 1, "gemm"), (64, 3, 3, 3, 1, "gemm"), (20, 1, 1, 98, 1, "gemm"), (8, 1, 1, 300, 1, "gemm"),
    (16, 3, 3, 64, 1, "gemm"), (16, 7, 1, 40, 1, "gemm"), (16, 3, 3, 96, 1, "gemm"),
    (256, 3, 3, 1, 256, "dw"), (6, 3, 3, 1, 6, "dw"),
    (1, 7, 7, 2, 1, "dp4"), (1, 7, 1, 16, 1, "dp4"), (24, 3, 3, 12, 4, "dp4"), (4, 3, 3, 1, 2, "dp4"),
])
def test_packed_weights_hold_w_q_and_zeros(N, kh, kw, cg, groups, route):
    rng = np.random.default_rng(N + cg)
    w = torch.from_numpy(rng.integers(-127, 128, (N, kh, kw, cg)).astype(np.int8))
    packed = pack_conv_int8_weights(w, groups)
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    taps = kh * kw
    if route == "gemm":  # stages of 128 bytes: tps taps of sc bytes of one block of 128 channels
        sc = min(128, -(-cg // 32) * 32)
        tps = 128 // sc if 128 % sc == 0 else 1
        blocks, groups_k = -(-cg // 128), -(-taps // tps)
        st = packed.reshape(N, blocks, groups_k, 128)
        assert not st[..., tps * sc:].any()
        slots = st[..., :tps * sc].reshape(N, blocks, groups_k * tps, sc)
        assert not slots[:, :, taps:].any()
        for cb in range(blocks):
            n = min(128, cg - cb * 128)
            assert torch.equal(slots[:, cb, :taps, :n], w.reshape(N, taps, cg)[:, :, cb * 128:cb * 128 + n])
            assert not slots[:, cb, :, n:].any()
    elif route == "dw":
        n4 = -(-N // 4) * 4
        assert packed.shape == (taps, n4)
        assert torch.equal(packed[:, :N], w.reshape(N, taps).t()) and not packed[:, N:].any()
    else:
        cg4 = -(-cg // 4) * 4
        p = packed.reshape(N, taps, cg4)
        assert torch.equal(p[:, :, :cg], w.reshape(N, taps, cg)) and not p[:, :, cg:].any()
    plan = _conv_int8_plan((1, 9, 9, cg * groups), (N, kh, kw, cg), (1, 1), (kh // 2, kw // 2), (1, 1), groups)
    assert plan.route == route
