"""The anchor-grid detection family in yolosomi_tpu_torch against the JAX
package, on the CPU: the graph compiler on every config the port serves, named
anchor presets, each new block
against flax, whole models at width 0.25 / depth 0.33 / 64 px (raw maps
and decode), the coupled Detect head's priors, the weight bridge both
ways, the Runner's rows, and one train step of yolo-somi-t.

Variables come from the flax `eval_shape` tree filled with seeded numpy
draws (tests/_torch_port_common.py `random_variables`), for the whole
models with every norm scale spread x5 as tests/test_torch_port_checkpoint.py
does. The Runner's rows need scores that rank the boxes: under those
draws the small models' scores are near-ties at x5 (outputs within 0.5
of the biases) and saturate at x15, so that check serves the port's own
seed-0 init (the JAX package's scheme, with the head's priors) through a
weights file the JAX package writes.
"""

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from tests._torch_port_common import (DEPTH, IMGSZ, NC, WIDTH, _to_dict, few_threads,  # noqa: F401
                                      jax_random_model, random_variables)
from tests.test_torch_port_checkpoint import assert_rows_match, spread
from tests.test_torch_port_train import batches, flat, targets_batch
from yolosomi_tpu import losses as jax_losses
from yolosomi_tpu.engine import checkpoint as jax_ckpt
from yolosomi_tpu.engine import runner as jax_runner_mod
from yolosomi_tpu.models import heads as jheads
from yolosomi_tpu.models import layers as jlayers
from yolosomi_tpu.models.heads import decode as jax_decode
from yolosomi_tpu.models.yolo import _Repeat
from yolosomi_tpu.models.yolo import build_model as jax_build_model
from yolosomi_tpu.models.yolo import init_model as jax_init_model
from yolosomi_tpu.models.yolo import parse_model as jax_parse_model
from yolosomi_tpu_torch.engine.runner import Runner
from yolosomi_tpu_torch.losses import ComputeLoss
from yolosomi_tpu_torch.models import heads, layers
from yolosomi_tpu_torch.models.heads import decode
from yolosomi_tpu_torch.models.yolo import build_model, parse_model
from yolosomi_tpu_torch.utils.config import find_config, load_hyp, load_model_cfg
from yolosomi_tpu_torch.utils.weights import export_jax_variables, export_param_tree, load_jax_variables

# the configs the port serves besides the flagship and yolo-somi-dcn
FAMILY = ("yolo-somi-s", "ablation/v5s-c2f-odconv-bifpn-p2-decoupled", "yolo-somi-t", "yolo-somi-t-p3",
          "yolo-somi-t-p3s", "yolo-somi-t-p3s8", "ablation/v5s-c2f", "ablation/v5s-c2f-bifpn-p2", "yolov5n",
          "yolov5s", "yolov5m", "yolov5l", "yolov5x", "yolov5s-p2", "yolov5s6")
HUB = ("yolov5n6", "hub/yolov5s6", "yolov5m6", "yolov5l6", "yolov5x6", "yolov5-p2", "yolov5-p6", "yolov5-p7",
       "yolov5-bifpn", "yolov5-fpn", "yolov5-panet", "yolov3", "yolov3-spp")
# whole models against flax: each new block family at least once
WHOLE = ("yolo-somi-s", "yolo-somi-t-p3s8", "ablation/v5s-c2f", "yolov5s")
# the weight bridge both ways: every new module and the repeated rows
BRIDGE = ("yolov5s", "yolov3", "yolov5-fpn", "yolo-somi-t-p3s8", "ablation/v5s-c2f-odconv-bifpn-p2-decoupled")


def small_cfg(name: str) -> dict:
    cfg = dict(load_model_cfg(find_config(name)))
    cfg["width_multiple"], cfg["depth_multiple"] = WIDTH, DEPTH
    return cfg


def specs(meta) -> tuple:
    return ([(s.i, s.f, s.n, s.name, s.c2, s.stride) for s in meta.specs], meta.strides, meta.save, meta.head_from,
            meta.nl, meta.na, meta.head_type)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def family():
    """name -> the small config in both packages with one set of spread
    random variables: (cfg, flax model, JAX meta, variables, port model,
    port meta), built at first use."""
    cache = {}

    def get(name: str):
        if name not in cache:
            cfg = small_cfg(name)
            jmodel, jmeta, variables = jax_random_model(cfg)
            variables = spread(variables)
            pmodel, pmeta = build_model(cfg, nc=NC, device="cpu")
            assert load_jax_variables(pmodel, variables) == ([], [])
            cache[name] = (cfg, jmodel, jmeta, variables, pmodel, pmeta)
        return cache[name]

    return get


# ---------------------------------------------------------------------------
# the graph compiler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", FAMILY + HUB)
def test_graph_matches_jax(name):
    """Specs (i, f, n, name, c2, stride), strides, anchors, save list and
    head rows of the full-width config equal JAX's; the port builds nothing
    (meta device)."""
    cfg = load_model_cfg(find_config(name))
    _, jmeta, _ = jax_parse_model(cfg)
    with torch.device("meta"):
        _, pmeta = parse_model(cfg)
    assert specs(pmeta) == specs(jmeta)
    np.testing.assert_array_equal(pmeta.anchors_px, jmeta.anchors_px)


def _raised(fn):
    with pytest.raises(Exception) as err:
        fn()
    return type(err.value), str(err.value)


def test_named_anchor_presets_resolve_as_jax_resolves_them():
    """`anchors: anchors_p5_640` on yolov5s gives JAX's anchors (the port
    failed on any preset with int()); on the 4-level flagship, a preset
    named in the head row with the wrong level count and an unknown name,
    the port raises JAX's error with JAX's message."""
    cfg = dict(load_model_cfg(find_config("yolov5s")), anchors="anchors_p5_640")
    with torch.device("meta"):
        _, pmeta = parse_model(cfg)
    _, jmeta, _ = jax_parse_model(cfg)
    np.testing.assert_array_equal(pmeta.anchors_px, jmeta.anchors_px)
    np.testing.assert_array_equal(pmeta.anchors_px.reshape(3, -1), [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119],
                                                                    [116, 90, 156, 198, 373, 326]])
    wrong_levels = dict(load_model_cfg(find_config("yolo-somi")), anchors="anchors_p5_640")
    head_arg = dict(cfg, anchors=3, head=cfg["head"][:-1] + [cfg["head"][-1][:3] + [["nc", "anchors_p6_640"]]])
    unknown = dict(cfg, anchors="anchors_p9_640")
    for bad, kind in ((wrong_levels, ValueError), (head_arg, ValueError), (unknown, KeyError)):
        got = _raised(lambda: parse_model(bad))
        assert got == _raised(lambda: jax_parse_model(bad)) and got[0] is kind, got
    assert "anchor preset has 4 levels, model has 3" in _raised(lambda: parse_model(head_arg))[1]


# ---------------------------------------------------------------------------
# the blocks against flax
# ---------------------------------------------------------------------------

ANCHORS3 = ((10, 13, 16, 30, 33, 23), (30, 61, 62, 45, 59, 119), (116, 90, 156, 198, 373, 326))
# name -> (flax module, port module, input (hw, channels) per input)
BLOCKS = {
    "Bottleneck": (lambda: jlayers.Bottleneck(16), lambda: layers.Bottleneck(16, 16), [(16, 16)]),
    "Bottleneck_no_residual": (lambda: jlayers.Bottleneck(24, True, k=((1, 1), (3, 3)), e=1.0),
                               lambda: layers.Bottleneck(16, 24, True, k=((1, 1), (3, 3)), e=1.0), [(16, 16)]),
    "Bottleneck_rows_repeated": (lambda: _Repeat((jlayers.Bottleneck(16), jlayers.Bottleneck(16))),
                                 lambda: torch.nn.Sequential(layers.Bottleneck(16, 16), layers.Bottleneck(16, 16)),
                                 [(16, 16)]),
    "C2f": (lambda: jlayers.C2f(32, 2, True), lambda: layers.C2f(24, 32, 2, True), [(16, 24)]),
    "C3": (lambda: jlayers.C3(32, 2), lambda: layers.C3(24, 32, 2), [(16, 24)]),
    "BottleneckCSP": (lambda: jlayers.BottleneckCSP(32, 2), lambda: layers.BottleneckCSP(24, 32, 2), [(16, 24)]),
    "Focus": (lambda: jlayers.Focus(16, 3), lambda: layers.Focus(3, 16, 3), [(32, 3)]),
    "SPP": (lambda: jlayers.SPP(32), lambda: layers.SPP(32, 32), [(16, 32)]),
    "Concat": (lambda: jlayers.Concat(), lambda: layers.Concat(), [(8, 16), (8, 24), (8, 8)]),
    "Contract": (lambda: jlayers.Contract(2), lambda: layers.Contract(2), [(16, 24)]),
    "Detect": (lambda: jheads.Detect(NC, ANCHORS3, (8, 16, 32)), lambda: heads.Detect(NC, 3, [16, 32, 64]),
               [(8, 16), (4, 32), (2, 64)]),
}


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_matches_flax(block):
    jfn, pfn, ins = BLOCKS[block]
    rng = np.random.default_rng(sorted(BLOCKS).index(block))
    xs = [rng.standard_normal((2, hw, hw, c)).astype(np.float32) for hw, c in ins]
    inp = xs if len(xs) > 1 else xs[0]
    jmod = jfn()
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), inp, False))
    variables = _to_dict(random_variables(shapes, 1))
    ref = jax.jit(lambda v, t: jmod.apply(v, t, False))(variables, inp)
    pmod = pfn().eval()
    assert load_jax_variables(pmod, variables) == ([], [])
    pmod.to(memory_format=torch.channels_last)
    with torch.no_grad():
        got = pmod([_nchw(x) for x in xs] if len(xs) > 1 else _nchw(xs[0]))
    if block == "Detect":  # raw level maps, already (B, ny, nx, na, no)
        got, ref = [g.numpy() for g in got], [np.asarray(r) for r in ref]
    else:
        got, ref = [got.permute(0, 2, 3, 1).numpy()], [np.asarray(ref)]
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=1e-4, rtol=1e-4)


def test_contract_keeps_jax_channel_order():
    """Every element distinct: an NCHW reading of the channels as (c, gy, gx)
    gives the right shape and other numbers. Exact, and channels_last in
    and out."""
    x = np.arange(2 * 8 * 12 * 5, dtype=np.float32).reshape(2, 8, 12, 5)
    ref = np.asarray(jlayers.Contract(2).apply({}, jnp.asarray(x)))
    got = layers.Contract(2)(_nchw(x))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)
    wrong = _nchw(x).reshape(2, 5, 4, 2, 6, 2).permute(0, 1, 3, 5, 2, 4).reshape(2, 20, 4, 6)
    assert not np.array_equal(wrong.permute(0, 2, 3, 1).numpy(), ref)


# ---------------------------------------------------------------------------
# whole models, the head's priors, the weight bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", WHOLE)
def test_whole_model_raw_outputs_and_decode_match_flax(family, name):
    """The tolerances of tests/test_torch_port_model.py."""
    _, jmodel, jmeta, variables, pmodel, pmeta = family(name)
    assert specs(pmeta) == specs(jmeta)
    x = np.random.default_rng(0).standard_normal((2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    j_raw = jax.jit(lambda v, t: jmodel.apply(v, t, False))(variables, jnp.asarray(x))
    with torch.no_grad():
        p_raw = pmodel(_nchw(x))
    assert len(p_raw) == len(j_raw) == jmeta.nl
    for p, j in zip(p_raw, j_raw):
        assert tuple(p.shape) == j.shape
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-4, rtol=1e-4)
    j_dec = np.asarray(jax_decode(j_raw, jmeta.anchors_px, jmeta.strides))
    p_dec = decode(p_raw, pmeta.anchors_px, pmeta.strides).numpy()
    assert p_dec.shape == j_dec.shape
    np.testing.assert_allclose(p_dec[..., :4], j_dec[..., :4], atol=5e-3, rtol=1e-3)
    np.testing.assert_allclose(p_dec[..., 4:], j_dec[..., 4:], atol=5e-4)


def test_detect_priors_equal_init_model():
    """The coupled head's biases after the port's init equal init_model's:
    obj log(8/(640/s)^2) on column 4, cls log(0.6/(nc-0.99999)) on columns
    5..5+nc, per anchor, at strides 4-32 (yolo-somi-t)."""
    cfg = small_cfg("yolo-somi-t")
    jmodel, jmeta = jax_build_model(cfg)
    jvars = jax_init_model(jmodel, jmeta, imgsz=IMGSZ)
    pmodel, pmeta = build_model(cfg, device="cpu")
    head = f"layers_{len(jmeta.specs) - 1}"
    assert pmeta.head_type == "Detect" and pmeta.nc == 10 and len(pmeta.strides) == 4
    for i, conv in enumerate(pmodel.model[-1].m):
        want = np.asarray(jvars["params"][head][f"m{i}"]["conv"]["bias"])
        np.testing.assert_array_equal(conv.bias.detach().numpy(), want)
        assert np.count_nonzero(want) == pmeta.na * (1 + 10)


@pytest.mark.parametrize("name", BRIDGE)
def test_weight_bridge_maps_every_leaf_both_ways(family, name):
    """load_jax_variables uses every flax leaf and fills every torch key;
    export_jax_variables gives back the same tree paths, shapes and values."""
    variables, pmodel = family(name)[3], family(name)[4]
    back = export_jax_variables(pmodel)
    assert sorted(flat(back)) == sorted(flat(variables))
    for key, value in flat(variables).items():
        np.testing.assert_array_equal(flat(back)[key], value, err_msg=key)


# ---------------------------------------------------------------------------
# serving and training
# ---------------------------------------------------------------------------


def test_runner_rows_equal_the_jax_runner(tmp_path):
    """The small yolo-somi-t (its YAML says nc 10) from the port's seed-0
    init with nc 3, written by the JAX package as a weights file: both
    Runners read nc 3 from the coupled head (_infer_nc) and give the same
    (B, 300, 6) rows on the CPU in f32, single-label and multi-label."""
    cfg = small_cfg("yolo-somi-t")
    cfg_path, weights = tmp_path / "somi-t-small.yaml", tmp_path / "w.msgpack"
    cfg_path.write_text(yaml.safe_dump(cfg))
    pmodel, pmeta = build_model(cfg, nc=NC, device="cpu", seed=0)
    jax_ckpt.save_variables(str(weights), export_jax_variables(pmodel), anchors=pmeta.anchors_px)
    jrunner = jax_runner_mod.Runner(str(cfg_path), str(weights), dtype=jnp.float32, imgsz=IMGSZ)
    runner = Runner(str(cfg_path), str(weights), dtype=torch.float32, imgsz=IMGSZ, device="cpu")
    assert runner.meta.nc == jrunner.meta.nc == NC and runner.meta.head_type == "Detect"
    images = np.random.default_rng(3).integers(0, 256, (3, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    for kw in (dict(conf_thres=0.001), dict(conf_thres=0.001, iou_thres=0.6, multi_label=True, max_nms=30000)):
        assert_rows_match(runner(images, **kw), np.asarray(jrunner(images, **kw)))


def test_train_step_loss_and_gradients_match_jax():
    """One train-mode forward, ComputeLoss (hyp.visdrone) and the gradient
    of every parameter of the small yolo-somi-t, as the two packages' train
    steps compute them: the loss components within 1e-5 relative, each
    gradient leaf within 1e-4 of its largest element plus 1e-6 of the
    largest gradient, the BatchNorm statistics the forward moved within
    1e-5 relative plus 1e-6. The draws are not spread: norm scales x5 make
    the net amplify f32 rounding, and its gradients then lie a median
    1.3e-4 of each leaf apart (2.5e-5 at most here), with the loss
    still within 1e-6."""
    cfg = small_cfg("yolo-somi-t")
    jmodel, jmeta, variables = jax_random_model(cfg)
    hyp = load_hyp(find_config("hyp.visdrone", "hyps"))
    x, t = batches()[0], targets_batch()
    jloss = jax_losses.ComputeLoss(jmeta, hyp)

    def loss_of(params):
        preds, mutated = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]}, x, train=True,
                                      mutable=["batch_stats"])
        loss, comps = jloss(preds, t)
        return loss, (comps, mutated["batch_stats"])

    (jl, (jcomps, jstats)), jgrads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(variables["params"])
    pmodel, pmeta = build_model(cfg, nc=NC, device="cpu")
    assert load_jax_variables(pmodel, variables) == ([], [])
    pmodel.train()
    names, params = zip(*pmodel.named_parameters())
    loss, comps = ComputeLoss(pmeta, hyp)(pmodel(_nchw(x)), torch.from_numpy(t))
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(comps.numpy(), np.asarray(jcomps), rtol=1e-5)
    got, want = flat(export_param_tree(pmodel, list(names), list(grads))), flat(jax.device_get(jgrads))
    assert sorted(got) == sorted(want) and len(want) == len(names)
    top = max(np.abs(v).max() for v in want.values())
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= 1e-4 * np.abs(w).max() + 1e-6 * top, (k, np.abs(got[k] - w).max())
    stats = flat(export_jax_variables(pmodel)["batch_stats"])
    for k, w in flat(jax.device_get(jstats)).items():
        np.testing.assert_allclose(stats[k], w, rtol=1e-5, atol=1e-6, err_msg=k)
