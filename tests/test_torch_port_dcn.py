"""yolosomi_tpu_torch's deformable path against the JAX package: the two
sampling functions' plain versions against `yolosomi_tpu.ops.dcn` and a
float64 loop oracle of the CUDA kernels' closed-form coordinates, the
deformable blocks against flax, the whole yolo-somi-dcn graph at width
0.25 / depth 0.33 / 64 px, the weight bridge at full width, the serving
Runner on the CPU, the `plain_version()` switch and both kernels' launch
geometry. The CUDA kernels
themselves are checked on a GPU by tests/test_torch_port_cuda.py and
chip_smoke.py.

The flax tree of every module is built with `eval_shape` and each leaf is
drawn from a numpy seed (positive BN variances, unit-ish LayerNorm scales,
positive BiFPN weights), the offset/mask heads large enough that offsets
are fractional, reach several pixels and leave the map: at the JAX init
they are zero and would sample only integer taps."""

import math

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from tests._torch_port_common import _to_dict, few_threads, random_variables  # noqa: F401
from yolosomi_tpu.models.heads import decode as jax_decode
from yolosomi_tpu.models.yolo import build_model as jax_build_model
from yolosomi_tpu.ops import dcn as jdcn
from yolosomi_tpu_torch.engine.runner import Runner
from yolosomi_tpu_torch.models import dcn as pdcn
from yolosomi_tpu_torch.models.heads import decode
from yolosomi_tpu_torch.models.yolo import build_model
from yolosomi_tpu_torch.ops import dcn as ops_dcn
from yolosomi_tpu_torch.ops import odconv as ops_odconv
from yolosomi_tpu_torch.ops import plain_version
from yolosomi_tpu_torch.ops.dcn import dcnv2_im2col, dcnv2_im2col_reference, dcnv3_core, dcnv3_core_reference
from yolosomi_tpu_torch.ops.nms import fused_postprocess
from yolosomi_tpu_torch.utils.config import find_config, load_model_cfg
from yolosomi_tpu_torch.utils.weights import load_jax_variables

WIDTH, DEPTH, IMGSZ, NC = 0.25, 0.33, 64, 3


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def small_dcn_cfg() -> dict:
    cfg = dict(load_model_cfg(find_config("yolo-somi-dcn")))
    cfg["width_multiple"], cfg["depth_multiple"] = WIDTH, DEPTH
    return cfg


@pytest.fixture(scope="module")
def dcn_graph():
    """The small yolo-somi-dcn in both packages with one set of random
    variables, and the jitted flax forward."""
    cfg = small_dcn_cfg()
    jmodel, jmeta = jax_build_model(cfg, nc=NC)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=False))
    variables = _to_dict(random_variables(shapes, 0))
    pmodel, pmeta = build_model(cfg, nc=NC, device="cpu")
    assert load_jax_variables(pmodel, variables) == ([], [])
    forward = jax.jit(lambda v, t: jmodel.apply(v, t, False))
    return cfg, jmeta, variables, forward, pmodel, pmeta


# ---------------------------------------------------------------------------
# the sampling functions
# ---------------------------------------------------------------------------


def _dcnv3_inputs(rng, n, h, w, g, cg, k, s, pad, dil):
    P = k * k
    ho = (h + 2 * pad - (dil * (k - 1) + 1)) // s + 1
    wo = (w + 2 * pad - (dil * (k - 1) + 1)) // s + 1
    value = rng.standard_normal((n, h, w, g * cg))
    # +-3 px: points cross the canvas edge and land on fractional positions
    offset = rng.uniform(-3.0, 3.0, (n, ho, wo, g * P * 2))
    logits = rng.standard_normal((n, ho, wo, g, P)) * 2.0
    mask = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return value, offset, mask.reshape(n, ho, wo, g * P)


def _oracle_dcnv3(value, offset, mask, k, s, pad, dil, g, offset_scale=1.0):
    """Float64 loops over the closed form the CUDA kernel computes:
    px = half + ox*s - pad + (ix*dil - half + off_x)*offset_scale on the
    unpadded map, p = ix*k + iy, corners outside the map count zero."""
    n_, h, w, c = value.shape
    cg, P, half = c // g, k * k, (dil * (k - 1)) // 2
    _, ho, wo, _ = offset.shape
    off = offset.reshape(n_, ho, wo, g, P, 2)
    m = mask.reshape(n_, ho, wo, g, P)
    out = np.zeros((n_, ho, wo, g, cg))
    for n in range(n_):
        for oy in range(ho):
            for ox in range(wo):
                for gi in range(g):
                    for p in range(P):
                        ix, iy = divmod(p, k)
                        px = half + ox * s - pad + (ix * dil - half + off[n, oy, ox, gi, p, 0]) * offset_scale
                        py = half + oy * s - pad + (iy * dil - half + off[n, oy, ox, gi, p, 1]) * offset_scale
                        x0, y0 = math.floor(px), math.floor(py)
                        for xc, yc in ((x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1)):
                            if 0 <= xc < w and 0 <= yc < h:
                                wt = (1 - abs(px - xc)) * (1 - abs(py - yc)) * m[n, oy, ox, gi, p]
                                out[n, oy, ox, gi] += wt * value[n, yc, xc, gi * cg:(gi + 1) * cg]
    return out.reshape(n_, ho, wo, c)


def _oracle_dcnv2(x, offset_y, offset_x, mask, k, s, pad):
    """Float64 loops over the CUDA kernel's columns: py = oy*s - pad + ky + dy,
    p = ky*k + kx, column p*C + c."""
    n_, h, w, c = x.shape
    _, ho, wo, P = offset_y.shape
    cols = np.zeros((n_, ho, wo, P, c))
    for n in range(n_):
        for oy in range(ho):
            for ox in range(wo):
                for p in range(P):
                    ky, kx = divmod(p, k)
                    py = oy * s - pad + ky + offset_y[n, oy, ox, p]
                    px = ox * s - pad + kx + offset_x[n, oy, ox, p]
                    x0, y0 = math.floor(px), math.floor(py)
                    for xc, yc in ((x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1)):
                        if 0 <= xc < w and 0 <= yc < h:
                            wt = (1 - abs(px - xc)) * (1 - abs(py - yc)) * mask[n, oy, ox, p]
                            cols[n, oy, ox, p] += wt * x[n, yc, xc]
    return cols.reshape(n_, ho * wo, P * c)


# (stride, dilation, group): pad 1, kernel 3 throughout
V3_CASES = [(1, 1, 1), (1, 1, 4), (2, 1, 4), (1, 2, 1), (2, 2, 4)]


@pytest.mark.parametrize("s,dil,g", V3_CASES)
def test_dcnv3_core_reference_matches_jax(s, dil, g):
    rng = np.random.default_rng(10 * s + dil + g)
    value, offset, mask = (a.astype(np.float32) for a in _dcnv3_inputs(rng, 2, 9, 11, g, 5, 3, s, 1, dil))
    args = (3, 3, s, s, 1, 1, dil, dil, g, 5)
    ref = np.asarray(jdcn.dcnv3_core(jnp.asarray(value), jnp.asarray(offset), jnp.asarray(mask), *args))
    got = dcnv3_core_reference(*(torch.from_numpy(a) for a in (value, offset, mask)), *args)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    # the same f32 arithmetic; only the order of the sums differs
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    # on the CPU the wrapper is the plain version, and counts nothing
    before = dcnv3_core.launches
    wrapped = dcnv3_core(*(torch.from_numpy(a) for a in (value, offset, mask)), *args)
    assert torch.equal(wrapped, got) and dcnv3_core.launches == before


@pytest.mark.parametrize("s,dil,g", V3_CASES)
def test_dcnv3_core_reference_in_f64_matches_kernel_closed_form(s, dil, g):
    """The plain version stays float64 when given float64: against the f64
    loop oracle it agrees to 1e-12, where its f32 run misses by ~1e-7."""
    rng = np.random.default_rng(20 + 10 * s + dil + g)
    value, offset, mask = _dcnv3_inputs(rng, 1, 6, 7, g, 2, 3, s, 1, dil)
    args = (3, 3, s, s, 1, 1, dil, dil, g, 2)
    oracle = _oracle_dcnv3(value, offset, mask, 3, s, 1, dil, g)
    got64 = dcnv3_core_reference(*(torch.from_numpy(a) for a in (value, offset, mask)), *args)
    got32 = dcnv3_core_reference(*(torch.from_numpy(a.astype(np.float32)) for a in (value, offset, mask)), *args)
    assert got64.dtype == torch.float64
    np.testing.assert_allclose(got64.numpy(), oracle, atol=1e-12, rtol=0)
    err32 = np.abs(got32.double().numpy() - oracle).max()
    assert 0 < err32 < 1e-5


# (stride, dilation, group) at kernel 5, pad 2: P = 25 points, more than a
# lane group of the kernel holds at once
V3_K5_CASES = [(1, 1, 2), (2, 1, 4)]


@pytest.mark.parametrize("s,dil,g", V3_K5_CASES)
def test_dcnv3_core_reference_matches_jax_at_kernel_5(s, dil, g):
    rng = np.random.default_rng(40 + 10 * s + dil + g)
    value, offset, mask = (a.astype(np.float32) for a in _dcnv3_inputs(rng, 2, 10, 9, g, 3, 5, s, 2, dil))
    args = (5, 5, s, s, 2, 2, dil, dil, g, 3)
    ref = np.asarray(jdcn.dcnv3_core(jnp.asarray(value), jnp.asarray(offset), jnp.asarray(mask), *args))
    got = dcnv3_core_reference(*(torch.from_numpy(a) for a in (value, offset, mask)), *args)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_dcnv3_core_reference_in_f64_matches_kernel_closed_form_at_kernel_5():
    rng = np.random.default_rng(50)
    value, offset, mask = _dcnv3_inputs(rng, 1, 7, 8, 2, 2, 5, 1, 2, 1)
    got = dcnv3_core_reference(*(torch.from_numpy(a) for a in (value, offset, mask)), 5, 5, 1, 1, 2, 2, 1, 1, 2, 2)
    np.testing.assert_allclose(got.numpy(), _oracle_dcnv3(value, offset, mask, 5, 1, 2, 1, 2), atol=1e-12, rtol=0)


def test_dcnv3_point_order_is_kernel_y_fastest():
    """A single nonzero mask point at p = 1 = ix*3 + iy (ix 0, iy 1) samples
    the tap left of the centre (dx -1, dy 0), not the one above it that a
    kernel-x-fastest order (iy 0, ix 1) would take."""
    value = np.zeros((1, 5, 5, 1))
    value[0, 1, 0, 0] = 1.0  # (y 1, x 0): output (1, 1) shifted by (dy 0, dx -1)
    value[0, 0, 1, 0] = 5.0  # (y 0, x 1): output (1, 1) shifted by (dy -1, dx 0)
    offset = np.zeros((1, 5, 5, 18))
    mask = np.zeros((1, 5, 5, 9))
    mask[..., 1] = 1.0
    got = dcnv3_core_reference(*(torch.from_numpy(a) for a in (value, offset, mask)), 3, 3, 1, 1, 1, 1, 1, 1, 1, 1)
    assert got[0, 1, 1, 0].item() == 1.0
    np.testing.assert_array_equal(got.numpy(), _oracle_dcnv3(value, offset, mask, 3, 1, 1, 1, 1))


@pytest.mark.parametrize("s", [1, 2])
def test_dcnv2_im2col_reference_matches_kernel_closed_form(s):
    rng = np.random.default_rng(30 + s)
    x = rng.standard_normal((2, 7, 6, 3))
    ho, wo = (7 + 2 - 3) // s + 1, (6 + 2 - 3) // s + 1
    oy, ox = rng.uniform(-3, 3, (2, 2, ho, wo, 9))
    mask = 1 / (1 + np.exp(-rng.standard_normal((2, ho, wo, 9))))
    got = dcnv2_im2col_reference(*(torch.from_numpy(a) for a in (x, oy, ox, mask)), 3, s, 1)
    assert got.dtype == torch.float64 and tuple(got.shape) == (2, ho * wo, 27)
    np.testing.assert_allclose(got.numpy(), _oracle_dcnv2(x, oy, ox, mask, 3, s, 1), atol=1e-12, rtol=0)
    before = dcnv2_im2col.launches
    assert torch.equal(dcnv2_im2col(*(torch.from_numpy(a) for a in (x, oy, ox, mask)), 3, s, 1), got)
    assert dcnv2_im2col.launches == before


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("elem_size", [4, 2])
@pytest.mark.parametrize("C", [1, 5, 40, 256, 512])
def test_dcnv2_launch_geometry_covers_every_column_once(C, elem_size, aligned):
    """The kernel's thread -> (group, lane) -> pairs -> vectors map, as
    _v2_geometry sets it up: the blocks' threads and VEC cover
    N*Ho*Wo*P*C exactly once."""
    N, Ho, Wo, P = 2, 3, 5, 9
    pairs = N * Ho * Wo * P
    vec, lanes, per_group = ops_dcn._v2_geometry(C, elem_size, aligned)
    assert C % vec == 0 and lanes in (1, 2, 4, 8, 16, 32) and 1 <= per_group <= min(lanes, 4)
    assert vec == (16 // elem_size if aligned and C % (16 // elem_size) == 0 else 1)
    assert lanes >= C // vec or lanes == 32  # a pair's vectors take one round, or a whole warp
    threads = -(-pairs // per_group) * lanes
    t = np.arange(-(-threads // ops_dcn._V2_THREADS) * ops_dcn._V2_THREADS)
    lane, first = t % lanes, t // lanes * per_group
    cover = np.zeros(pairs * C, np.int32)
    for j in range(per_group):  # the group's pairs, one after the other
        q = first + j
        for v0 in range(0, C, lanes * vec):  # a lane's vectors of pair q
            v = v0 + lane * vec
            live = (q < pairs) & (v < C)
            for e in range(vec):
                np.add.at(cover, q[live] * C + v[live] + e, 1)
    assert (cover == 1).all()


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("elem_size", [4, 2])
@pytest.mark.parametrize("Cg", [1, 2, 5, 33, 128, 256])
def test_dcnv3_launch_geometry_covers_every_output_once(Cg, elem_size, aligned):
    """The kernel's thread -> (pixel, group) item -> lane -> vectors map, as
    _v3_geometry and the wrapper set it up (block b: V3_THREADS / LANES
    consecutive pixels, from tile b // G on, of group b % G): the threads
    and VEC cover N*Ho*Wo*G*Cg exactly once."""
    npix, G = 2 * 3 * 5, 3
    vec, lanes = ops_dcn._v3_geometry(Cg, elem_size, aligned)
    assert lanes in (1, 2, 4, 8, 16, 32) and (vec == 1 or Cg % vec == 0)
    assert vec == (16 // elem_size if aligned and Cg % (16 // elem_size) == 0 else 1)
    assert lanes >= -(-Cg // vec) or lanes == 32  # an item's vectors take one round, or a whole warp
    per_block = ops_dcn._V3_THREADS // lanes
    threads = np.arange(-(-npix // per_block) * G * ops_dcn._V3_THREADS)
    block, tid = threads // ops_dcn._V3_THREADS, threads % ops_dcn._V3_THREADS
    lane, tile = tid % lanes, block // G
    g, pix = block - tile * G, tile * per_block + tid // lanes
    live = pix < npix
    cover = np.zeros(npix * G * Cg, np.int32)
    for c0 in range(0, Cg, lanes * vec):  # the lane's vectors, one chunk at a time
        v = c0 + lane * vec
        ok = live & (v < Cg)
        for e in range(vec):
            np.add.at(cover, (pix[ok] * G + g[ok]) * Cg + v[ok] + e, 1)
    assert (cover == 1).all()


def test_wrappers_check_shapes_and_refuse_non_cuda_devices():
    v = torch.zeros(1, 5, 5, 8)
    off, m = torch.zeros(1, 5, 5, 4 * 9 * 2), torch.zeros(1, 5, 5, 4 * 9)
    args = (3, 3, 1, 1, 1, 1, 1, 1, 4, 2)
    with pytest.raises(ValueError, match="group"):
        dcnv3_core(v, off, m, *args[:-1], 3)
    with pytest.raises(ValueError, match="do not match"):
        dcnv3_core(v, off[..., :-2], m, *args)
    with pytest.raises(ValueError, match="CUDA"):  # no silent plain version off the CPU
        dcnv3_core(v.to("meta"), off.to("meta"), m.to("meta"), *args)
    x, o = torch.zeros(1, 5, 5, 3), torch.zeros(1, 5, 5, 9)
    with pytest.raises(ValueError, match="must all be"):
        dcnv2_im2col(x, o, o[..., :4], o)
    with pytest.raises(ValueError, match="CUDA"):
        dcnv2_im2col(x.to("meta"), o.to("meta"), o.to("meta"), o.to("meta"))


# ---------------------------------------------------------------------------
# the blocks against flax
# ---------------------------------------------------------------------------


def _block_pair(flax_module, port_module, x_shape, seed):
    shapes = jax.eval_shape(lambda: flax_module.init(jax.random.PRNGKey(0), jnp.zeros(x_shape), False))
    variables = _to_dict(random_variables(shapes, seed))
    assert load_jax_variables(port_module, variables) == ([], [])
    x = np.random.default_rng(seed).standard_normal(x_shape).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, t: flax_module.apply(v, t, False))(variables, x))
    with torch.no_grad():
        got = port_module.eval()(_nchw(x)).permute(0, 2, 3, 1).numpy()
    return got, ref


def test_dcnv2_columns_times_weight_match_flax():
    """dcnv2_im2col_reference . weight + bias against the flax DCNv2 with an
    identity BatchNorm and no activation."""
    fm = jdcn.DCNv2(24, 3, 1, act=False)
    x_shape = (2, 10, 9, 16)
    shapes = jax.eval_shape(lambda: fm.init(jax.random.PRNGKey(0), jnp.zeros(x_shape), False))
    v = _to_dict(random_variables(shapes, 3))
    v["params"]["bn"] = {"scale": np.ones(24, np.float32), "bias": np.zeros(24, np.float32)}
    v["batch_stats"]["bn"] = {"mean": np.zeros(24, np.float32), "var": np.full(24, 1 - 1e-3, np.float32)}
    x = np.random.default_rng(3).standard_normal(x_shape).astype(np.float32)
    ref = np.asarray(fm.apply(v, x, False))

    pv = {k: torch.from_numpy(a) for k, a in v["params"]["conv_offset_mask"].items()}
    om = torch.nn.functional.conv2d(_nchw(x), pv["kernel"].permute(3, 2, 0, 1), pv["bias"], padding=1)
    om = om.permute(0, 2, 3, 1)
    cols = dcnv2_im2col_reference(torch.from_numpy(x), om[..., :9], om[..., 9:18], torch.sigmoid(om[..., 18:]))
    out = cols @ torch.from_numpy(v["params"]["weight"]).reshape(9 * 16, 24) + torch.from_numpy(v["params"]["bias"])
    assert np.abs(om[..., :18].numpy()).max() > 3  # offsets reach several pixels
    np.testing.assert_allclose(out.reshape(ref.shape).numpy(), ref, atol=1e-4, rtol=1e-4)


BLOCKS = {
    "DCNv3": (lambda: jdcn.DCNv3(32, group=4), lambda: pdcn.DCNv3(32, group=4), (2, 9, 10, 32)),
    "DCNv3_g8_cfs": (lambda: jdcn.DCNv3(64, group=8, center_feature_scale=True),
                     lambda: pdcn.DCNv3(64, group=8, center_feature_scale=True), (2, 8, 8, 64)),
    "DCNv2": (lambda: jdcn.DCNv2(24), lambda: pdcn.DCNv2(16, 24), (2, 10, 9, 16)),
    "DCNv2_s2": (lambda: jdcn.DCNv2(24, 3, 2), lambda: pdcn.DCNv2(16, 24, 3, 2), (2, 10, 9, 16)),
    "BottleneckDCN": (lambda: jdcn.BottleneckDCN(16), lambda: pdcn.BottleneckDCN(16, 16), (2, 8, 8, 16)),
    "C2f_DCN": (lambda: jdcn.C2f_DCN(32, 2, True), lambda: pdcn.C2f_DCN(24, 32, 2, True), (2, 8, 8, 24)),
    "C3_DCN": (lambda: jdcn.C3_DCN(32, 2), lambda: pdcn.C3_DCN(24, 32, 2), (2, 8, 8, 24)),
}


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_dcn_block_matches_flax(block):
    make_flax, make_port, x_shape = BLOCKS[block]
    got, ref = _block_pair(make_flax(), make_port(), x_shape, seed=sorted(BLOCKS).index(block))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the whole graph
# ---------------------------------------------------------------------------


def _offset_stats(model, x):
    """(max |offset| in px, share of offsets more than 0.01 px from an
    integer) over every DCNv2 and DCNv3 head of one forward."""
    seen = []

    def hook(name, P):
        def fn(mod, inp, out):
            o = out.permute(0, 2, 3, 1)[..., : 2 * P] if name == "v2" else out
            seen.append(o.detach().reshape(-1))
        return fn

    hooks = [m.conv_offset_mask.register_forward_hook(hook("v2", m.k * m.k))
             for m in model.modules() if isinstance(m, pdcn.DCNv2)]
    hooks += [m.offset.register_forward_hook(hook("v3", 0)) for m in model.modules() if isinstance(m, pdcn.DCNv3)]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    allo = torch.cat(seen)
    frac = ((allo - allo.round()).abs() > 0.01).float().mean().item()
    return allo.abs().max().item(), frac, len(hooks)


def test_graph_compiler_matches_jax(dcn_graph):
    _, jmeta, _, _, _, pmeta = dcn_graph
    assert [(s.i, s.f, s.n, s.name, s.c2, s.stride) for s in pmeta.specs] == [
        (s.i, s.f, s.n, s.name, s.c2, s.stride) for s in jmeta.specs
    ]
    assert pmeta.strides == jmeta.strides == (4.0, 8.0, 16.0, 32.0)
    assert [s.name for s in pmeta.specs if "DCN" in s.name] == ["C2f_DCN", "C2f_DCN", "DCNv3"]
    np.testing.assert_array_equal(pmeta.anchors_px, jmeta.anchors_px)
    assert (pmeta.save, pmeta.head_from, pmeta.nl, pmeta.na) == (jmeta.save, jmeta.head_from, jmeta.nl, jmeta.na)


def test_dcn_numerical_conventions_are_pinned(dcn_graph):
    """LayerNorm eps 1e-6 (flax default), DCNv2 BN eps 1e-3."""
    pmodel = dcn_graph[4]
    assert {m.eps for m in pmodel.modules() if isinstance(m, torch.nn.LayerNorm)} == {1e-6}
    assert {m.bn.eps for m in pmodel.modules() if isinstance(m, pdcn.DCNv2)} == {1e-3}
    assert [tuple(m.weight.shape) for m in pmodel.model[8].modules() if isinstance(m, pdcn.DCNv2)] == [(9, 128, 128)]


def test_dcn_graph_raw_outputs_and_decode_match_flax(dcn_graph):
    _, jmeta, variables, forward, pmodel, pmeta = dcn_graph
    x = np.random.default_rng(0).standard_normal((2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    max_off, frac, n_heads = _offset_stats(pmodel, _nchw(x))
    assert n_heads == 4 and max_off > 4 and frac > 0.9  # rows 6 (2), 8 (1), 10 (1)
    j_raw = forward(variables, jnp.asarray(x))
    with torch.no_grad():
        p_raw = pmodel(_nchw(x))
    assert len(p_raw) == len(j_raw) == 4
    for p, j in zip(p_raw, j_raw):
        assert tuple(p.shape) == j.shape
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-4, rtol=1e-4)
    j_dec = np.asarray(jax_decode(j_raw, jmeta.anchors_px, jmeta.strides))
    p_dec = decode(p_raw, pmeta.anchors_px, pmeta.strides).numpy()
    assert p_dec.shape == j_dec.shape
    np.testing.assert_allclose(p_dec[..., :4], j_dec[..., :4], atol=5e-3, rtol=1e-3)
    np.testing.assert_allclose(p_dec[..., 4:], j_dec[..., 4:], atol=5e-4)


def test_weight_bridge_covers_full_width_dcn_model():
    """Every torch key and every flax leaf of the full-width yolo-somi-dcn
    pair up, the DCNv2 weight in its (P, C, c2) layout (shapes checked by
    the copy); 60.53 M parameters on both sides. Built only, never run."""
    cfg = load_model_cfg(find_config("yolo-somi-dcn"))
    jmodel, _ = jax_build_model(cfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), _to_dict(shapes))
    pmodel, _ = build_model(cfg, device="cpu")
    unmatched, unused = load_jax_variables(pmodel, variables)
    assert unmatched == [] and unused == []
    n_jax = sum(v.size for v in jax.tree_util.tree_leaves(variables["params"]))
    n_port = sum(p.numel() for p in pmodel.parameters())
    assert n_port == n_jax and round(n_port / 1e6, 2) == 60.53


def test_init_zeroes_the_heads_and_the_randomizer_fills_them():
    model, _ = build_model(small_dcn_cfg(), nc=NC, device="cpu", seed=1)
    heads = [m.conv_offset_mask for m in model.modules() if isinstance(m, pdcn.DCNv2)]
    heads += [h for m in model.modules() if isinstance(m, pdcn.DCNv3) for h in (m.offset, m.mask)]
    assert len(heads) == 5 and all(h.weight.abs().max() == 0 and h.bias.abs().max() == 0 for h in heads)
    dcn2 = next(m for m in model.modules() if isinstance(m, pdcn.DCNv2))
    P, _, c2 = dcn2.weight.shape
    assert abs(dcn2.weight.std().item() - math.sqrt(2.0 / (P * c2))) < 0.1 * math.sqrt(2.0 / (P * c2))
    pdcn.randomize_offset_heads(model, seed=0)
    assert all(h.weight.abs().max() > 0 and h.bias.abs().max() > 1 for h in heads)


def test_runner_on_cpu_serves_the_dcn_model(dcn_graph, tmp_path):
    cfg, _, variables, _, _, _ = dcn_graph
    path = tmp_path / "somi-dcn-small.yaml"
    path.write_text(yaml.safe_dump(cfg))
    runner = Runner(str(path), nc=NC, dtype=torch.float32, imgsz=IMGSZ, device="cpu", variables=variables)
    images = np.random.default_rng(5).integers(0, 256, (2, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    launches = (ops_odconv.odconv_s2.launches, dcnv3_core.launches, dcnv2_im2col.launches)
    out = runner(images, conf_thres=0.2, max_det=40)
    assert out.shape == (2, 40, 6) and out.dtype == np.float32 and np.isfinite(out).all()
    assert (ops_odconv.odconv_s2.launches, dcnv3_core.launches, dcnv2_im2col.launches) == launches
    with torch.no_grad():
        raw = runner.model(torch.from_numpy(images).permute(0, 3, 1, 2).float() / 255.0)
    ref = fused_postprocess(raw, runner.meta.anchors_px, runner.meta.strides, conf_thres=0.2, max_det=40).numpy()
    np.testing.assert_array_equal(out, ref)
    valid = out[..., 4] > 0
    assert valid.any() and (out[~valid] == 0).all()


def test_dcn_runner_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Runner("yolo-somi-dcn")


def test_plain_version_switch_reaches_every_kernel_wrapper(dcn_graph, monkeypatch):
    """Outside `plain_version()` the model calls the three kernel wrappers
    (4 odconv_s2, 3 dcnv2_im2col, 1 dcnv3_core at depth 0.33), and its
    backward the two DCN gradient wrappers (3 dcnv2_im2col_bwd, 1
    dcnv3_core_bwd, through the autograd Functions); inside it calls none
    of them. One switch, also importable from ops.odconv."""
    pmodel = dcn_graph[4]
    calls = []

    def recording(name, fn):
        def wrapper(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(ops_odconv, "odconv_s2", recording("odconv_s2", ops_odconv.odconv_s2))
    monkeypatch.setattr(ops_dcn, "dcnv3_core", recording("dcnv3_core", ops_dcn.dcnv3_core))
    monkeypatch.setattr(ops_dcn, "dcnv2_im2col", recording("dcnv2_im2col", ops_dcn.dcnv2_im2col))
    for name in ("dcnv2_im2col_bwd", "dcnv3_core_bwd"):
        monkeypatch.setattr(ops_dcn, name, recording(name, getattr(ops_dcn, name)))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 3, IMGSZ, IMGSZ)).astype(np.float32))
    with torch.no_grad():
        pmodel(x)
        assert sorted(set(calls)) == ["dcnv2_im2col", "dcnv3_core", "odconv_s2"]
        assert (calls.count("odconv_s2"), calls.count("dcnv2_im2col"), calls.count("dcnv3_core")) == (4, 3, 1)
        calls.clear()
        with plain_version():
            pmodel(x)
        assert calls == []
    sum(o.sum() for o in pmodel(x)).backward()
    assert (calls.count("dcnv2_im2col_bwd"), calls.count("dcnv3_core_bwd")) == (3, 1), calls
    calls.clear()
    with plain_version():
        sum(o.sum() for o in pmodel(x)).backward()
    assert calls == []
    pmodel.zero_grad(set_to_none=True)
    assert ops_odconv.plain_version is plain_version
