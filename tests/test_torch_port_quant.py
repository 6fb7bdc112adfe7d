"""yolosomi_tpu_torch's int8 serving against the JAX package
(yolosomi_tpu/ops/quant.py and ConvRaw's calib and int8 branches), on the
CPU: one ConvRaw in int8 at every geometry the served graphs give it, the
calibration, --int8-exclude, the whole small flagship in int8, val.run
with int8, and conv_int8's plain version.

Sizes: the flagship at width 0.25 / depth 0.33, 64 px, nc 3, f32, with
the randomized variables of tests/_torch_port_common.py.

Tolerances, stated where they are used:
- one ConvRaw: x_q, w_q and the int32 accumulator bitwise; the output
  within 1 ulp (float(acc) * scale + bias, each rounded in f32 on both
  sides);
- calibration: each scale within 1e-4 relative (the activations of two
  f32 forwards whose convolutions sum in other orders; the deepest layers'
  absmax differ by up to 1.3e-5);
- the whole model in int8: the two packages' int8 maps lie closer to each
  other than each lies to its own float maps, by a factor of 1000 in the
  relative L2 distance (measured: 4.2e-8 against 2.6e-3; an activation a
  rounding apart in f32 can quantize one step apart, and that step
  travels on);
- val.run with int8: mAP@.5 and mAP@.5:.95 within 0.02 of JAX's (measured
  0.9663 against 0.9704: the first batch's calibration and the ranking of
  near-tied scores).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

import jax
import jax.numpy as jnp

import val as jax_val
from tests._torch_port_common import IMGSZ, NC, few_threads  # noqa: F401
from tests.test_torch_port_eval import EVAL_BATCH, flagship, self_labelled  # noqa: F401  (fixtures)
from yolosomi_tpu.models import layers as jax_layers
from yolosomi_tpu.ops import quant as jax_quant
from yolosomi_tpu_torch import val
from yolosomi_tpu_torch.engine.runner import Runner
from yolosomi_tpu_torch.models.layers import ConvRaw
from yolosomi_tpu_torch.ops import quant
from yolosomi_tpu_torch.ops.int8 import conv_int8, conv_int8_reference, quantize_activation
from yolosomi_tpu_torch.utils.weights import _leaves, conv_raw_paths


def flat(tree) -> dict:
    return {"/".join(p[:-1]): np.asarray(v) for p, v in _leaves(tree)}


# ---------------------------------------------------------------------------
# one ConvRaw
# ---------------------------------------------------------------------------

# name: (cin, cout, k, s, p, g, d, use_bias, per_channel, uint8-like input)
CONVS = {
    "per_tensor_3x3": (16, 24, 3, 1, None, 1, 1, False, False, False),
    "per_channel_1x1_bias": (16, 8, 1, 1, None, 1, 1, True, True, False),
    "grouped_per_channel": (16, 8, 3, 1, None, 4, 1, False, True, False),
    "depthwise_per_channel": (16, 16, 3, 1, None, 16, 1, True, True, False),
    "depthwise_per_tensor": (16, 16, 3, 1, None, 16, 1, True, False, False),
    "dilated_2": (8, 8, 3, 1, None, 1, 2, True, False, False),
    "7x1": (8, 1, (7, 1), 1, (3, 0), 1, 1, False, False, False),
    "stride_2": (8, 16, 3, 2, None, 1, 1, False, True, False),
    "first_conv_cin_3": (3, 16, 3, 2, None, 1, 1, False, False, True),
}


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@pytest.mark.parametrize("name", list(CONVS))
def test_one_convraw_in_int8_matches_jax(name, monkeypatch):
    """The same kernel, bias, input and calibrated scale (80% of the
    input's absmax, so some values clip) in both packages: the quantized
    activation and weight and the int32 accumulator the same bits, the
    dequantized output within 1 ulp."""
    cin, cout, k, s, p, g, d, bias, per_channel, image = CONVS[name]
    rng = np.random.default_rng(len(name))
    x = rng.integers(0, 256, (2, 12, 10, cin)).astype(np.float32) / 255 if image else \
        (rng.standard_normal((2, 12, 10, cin)) * rng.uniform(0.2, 3.0, cin)).astype(np.float32)
    m = jax_layers.ConvRaw(cout, k, s, p, g, d, use_bias=bias)
    v = jax.tree_util.tree_map(np.asarray, m.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    if bias:
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
        want = np.asarray(m.apply(dict(v, quant={"a_scale": jnp.asarray(a_scale)}), jnp.asarray(x)))
    monkeypatch.setattr(jax.lax, "conv_general_dilated", orig)
    assert seen, "JAX's int8 branch did not run"

    kh, kw = _pair(k)
    pad = _pair(jax_layers.autopad(k, p, d))
    conv = ConvRaw(cin, cout, (kh, kw), s, pad, dilation=d, groups=g, bias=bias)
    with torch.no_grad():
        conv.weight.copy_(torch.tensor(v["params"]["conv"]["kernel"].transpose(3, 2, 0, 1)))
        if bias:
            conv.bias.copy_(torch.tensor(v["params"]["conv"]["bias"]))
    conv.a_scale = torch.tensor(a_scale)
    got_ops = {}
    int8_conv_fused = quant.int8_conv_fused

    def port_spy(x_nhwc, s_a, w_q, *args, **kwargs):
        x_q = quantize_activation(x_nhwc, s_a)  # the fused entry's quantize
        got_ops.update(x_q=x_q.numpy(), w_q=w_q.numpy(), acc=conv_int8_reference(
            x_q, w_q, None, None, *args[2:], out_dtype=torch.int32).numpy())
        return int8_conv_fused(x_nhwc, s_a, w_q, *args, **kwargs)

    monkeypatch.setattr(quant, "int8_conv_fused", port_spy)
    with quant.quant_mode("int8"), torch.no_grad():
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got_ops["x_q"], seen["x_q"])
    np.testing.assert_array_equal(got_ops["w_q"], seen["w_q"].transpose(3, 0, 1, 2))  # HWIO -> OHWI
    np.testing.assert_array_equal(got_ops["acc"], seen["acc"])
    assert np.abs(seen["x_q"]).max() == 127, "the scale clips nothing: the test would miss the clip"
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    with torch.no_grad():  # the float forward is nn.Conv2d's outside a mode
        plain = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert torch.equal(plain, F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), conv.weight, conv.bias, s, pad,
                                           d, g))


@pytest.mark.parametrize("shape", [(2, 9, 7, 3, 5, (3, 3), 2, 1, 1, 1), (1, 8, 8, 16, 16, (3, 3), 1, 2, 2, 16),
                                   (2, 6, 5, 8, 4, (7, 1), 1, (3, 0), 1, 1), (1, 5, 6, 8, 6, (3, 3), 1, 1, 1, 2),
                                   (2, 7, 7, 64, 32, (1, 1), 1, 0, 1, 1)],
                         ids=["cin3_s2", "depthwise_d2", "7x1", "grouped", "1x1"])
def test_conv_int8_reference_is_f64_conv2d(shape):
    """The plain version against F.conv2d in float64 on the same integers:
    the same accumulators, and its dequant the float32 product and sum."""
    B, H, W, C, N, k, s, p, d, g = shape
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-127, 128, (B, H, W, C)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (N, *k, C // g)).astype(np.int8))
    kw = dict(stride=_pair(s), padding=_pair(p), dilation=_pair(d), groups=g)
    acc = conv_int8_reference(x, w, out_dtype=torch.int32, **kw)
    ref = F.conv2d(x.permute(0, 3, 1, 2).double(), w.permute(0, 3, 1, 2).double(), **kw).permute(0, 2, 3, 1)
    assert acc.dtype == torch.int32 and torch.equal(acc.double(), ref)
    scale, bias = torch.rand(N) / 100, torch.randn(N)
    y = conv_int8(x, w, scale, bias, out_dtype=torch.bfloat16, **kw)  # a CPU tensor: the plain version
    assert torch.equal(y, (acc.float() * scale + bias).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# the small flagship: calibration, exclusion, the int8 model
# ---------------------------------------------------------------------------


def batches(n: int = 2) -> list:
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, (2, IMGSZ, IMGSZ, 3), dtype=np.uint8) for _ in range(n)]


@pytest.fixture(scope="module")
def small(flagship):  # noqa: F811  (test_torch_port_eval's fixture)
    """test_torch_port_eval's small flagship (its YAML, variables and JAX
    Runner) in both packages, and JAX's calibration of it on two batches,
    per tensor and per channel."""
    path, variables, jrunner = flagship
    model = jrunner.model
    calib = {pc: jax.device_get(jax_quant.calibrate(model, variables, batches(), per_channel=pc))
             for pc in (False, True)}
    runner = Runner(path, nc=NC, dtype=torch.float32, device="cpu", variables=variables)
    return dict(path=path, model=model, variables=variables, calib=calib, runner=runner, jrunner=jrunner)


@pytest.mark.parametrize("per_channel", [False, True], ids=["per_tensor", "per_channel"])
def test_calibrate_matches_jax(small, per_channel):
    """The same two batches: every ConvRaw's scale at JAX's `quant` path,
    the largest input absmax over the batches (a scalar, or (Cin,))."""
    want = flat(small["calib"][per_channel])
    got = flat(quant.calibrate(small["runner"].model, batches(), per_channel=per_channel))
    assert got.keys() == want.keys() and len(want) == len(conv_raw_paths(small["runner"].model))
    for k in want:
        assert got[k].shape == want[k].shape == ((int(want[k].size),) if per_channel else ()), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    quant.load_quant_scales(small["runner"].model, small["calib"][per_channel])  # the bridge, both ways
    back = flat(quant.export_quant_scales(small["runner"].model))
    assert back.keys() == want.keys() and all(np.array_equal(back[k], want[k]) for k in want)


@pytest.mark.parametrize("exclude", [("head",), (r"/m0/", r"^layers_2/"), ()], ids=["head", "regexes", "none"])
def test_int8_exclude_selects_the_jax_convs(small, exclude, monkeypatch):
    """`head` (val's shorthand for ^layers_<n-1>/) and explicit path regexes
    keep the same ConvRaws in float in both packages: the same paths pass
    each package's own test, and the int8 convs one forward runs are as
    many as JAX's traced int8 program holds."""
    n = len(small["model"].layers)
    pats = tuple(rf"^layers_{n - 1}/" if p == "head" else p for p in exclude)
    assert n == len(small["runner"].model.model)
    paths = list(flat(small["calib"][False]))
    with jax_quant.quant_mode("int8", exclude=pats):
        want = {p for p in paths if jax_layers._quant_excluded(tuple(p.split("/")))}
    with quant.quant_mode("int8", exclude=pats):
        got = {p for p, _ in conv_raw_paths(small["runner"].model) if quant._excluded(p)}
    assert got == want and (bool(want) == bool(exclude))

    calls = []
    orig = jax.lax.conv_general_dilated

    def spy(lhs, rhs, *args, **kwargs):
        calls.append(lhs.dtype == jnp.int8)
        return orig(lhs, rhs, *args, **kwargs)

    monkeypatch.setattr(jax.lax, "conv_general_dilated", spy)
    vq = dict(small["variables"], quant=small["calib"][False])
    with jax_quant.quant_mode("int8", exclude=pats):  # traced, not compiled
        jax.eval_shape(lambda v, x: small["model"].apply(v, x, train=False), vq,
                       jnp.zeros((1, IMGSZ, IMGSZ, 3), jnp.float32))
    monkeypatch.setattr(jax.lax, "conv_general_dilated", orig)
    runner = small["runner"]
    quant.load_quant_scales(runner.model, small["calib"][False])
    launched = []
    int8_conv_fused = quant.int8_conv_fused
    monkeypatch.setattr(quant, "int8_conv_fused", lambda *a, **k: launched.append(1) or int8_conv_fused(*a, **k))
    with quant.quant_mode("int8", exclude=pats):
        runner.forward(batches(1)[0][:1])
    assert len(launched) == sum(calls) == len(paths) - len(want)


@pytest.fixture(scope="module")
def int8_maps(small):
    """JAX's raw maps of a batch through the int8 model (its per-tensor
    calibration) and through the float one."""
    x = jnp.asarray(batches(3)[2].astype(np.float32) / 255)
    model, v = small["model"], small["variables"]
    vq = dict(v, quant=small["calib"][False])
    with jax_quant.quant_mode("int8"):
        q = jax.jit(lambda v_, x_: model.apply(v_, x_, train=False)).lower(vq, x).compile()
    f = jax.jit(lambda v_, x_: model.apply(v_, x_, train=False)).lower(v, x).compile()
    return jax.device_get(q(vq, x)), jax.device_get(f(v, x))


def test_whole_model_int8_lies_closer_to_jax_int8_than_to_float(small, int8_maps):
    """JAX's scales carried into the port: the port's int8 maps against
    JAX's, each against its own float maps (relative L2 over all levels,
    factor in the module docstring); then quantized_infer_fn calibrates on
    the batch itself, to JAX's scales, and answers with the NMS of those
    int8 maps."""
    runner = small["runner"]
    want_q, want_f = int8_maps
    images = batches(3)[2]
    quant.load_quant_scales(runner.model, small["calib"][False])
    with quant.quant_mode("int8"):
        got_q = [p.numpy() for p in runner.forward(images)]
    got_f = [p.numpy() for p in runner.forward(images)]

    def dist(a, b):
        return np.sqrt(sum(((x - y) ** 2).sum() for x, y in zip(a, b)) / sum((y ** 2).sum() for y in b))

    port_jax, jax_q, port_q = dist(got_q, want_q), dist(want_q, want_f), dist(got_q, got_f)
    assert dist(got_f, want_f) < 1e-5
    assert 1000 * port_jax < min(jax_q, port_q), (port_jax, jax_q, port_q)

    kw = dict(conf_thres=0.001, iou_thres=0.6, max_det=300, max_nms=30000, multi_label=True, exact=True)
    fn = quant.quantized_infer_fn(runner, images, **kw)
    calib = flat(quant.export_quant_scales(runner.model))
    ref = flat(jax.device_get(jax_quant.calibrate(small["model"], small["variables"], [images])))
    assert calib.keys() == ref.keys() and all(np.allclose(calib[k], ref[k], rtol=1e-4, atol=0) for k in ref)
    with quant.quant_mode("int8"), torch.inference_mode():
        from yolosomi_tpu_torch.ops.nms import non_max_suppression

        direct = non_max_suppression(runner.decode(runner.forward(images)), **kw).numpy()
    np.testing.assert_array_equal(fn(images), direct)


# ---------------------------------------------------------------------------
# val.run with int8
# ---------------------------------------------------------------------------


def test_val_run_int8_matches_jax(small, self_labelled, tmp_path):
    """val.run(int8=True, int8_per_channel=True, int8_exclude=("head",)) in
    both packages on test_torch_port_eval's self-labelled set (the JAX
    float Runner's own top detections): calibrated on the first batch, the
    exact eval protocol, mAP within 0.02 of JAX's."""
    common = dict(data=self_labelled, batch_size=EVAL_BATCH, imgsz=IMGSZ, project=str(tmp_path), exist_ok=True,
                  int8=True, int8_per_channel=True, int8_exclude=["head"])
    jres, _, _ = jax_val.run(runner=small["jrunner"], name="jax", **common)
    runner = Runner(small["path"], nc=NC, dtype=torch.float32, device="cpu", variables=small["variables"])
    pres, _, _ = val.run(runner=runner, name="port", **common)
    assert jres[2] > 0.3, f"JAX int8 mAP@.5 {jres[2]}: the check would be vacuous"
    assert abs(pres[2] - jres[2]) <= 0.02 and abs(pres[3] - jres[3]) <= 0.02, (pres[:4], jres[:4])
    assert yaml.safe_load((tmp_path / "port" / "metrics.json").read_text())["int8"] is True
