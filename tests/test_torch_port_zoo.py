"""The five shipped configs that the port's registry gained with the
Ghost, transformer and YOLOv10 blocks, yolov3-tiny's pool and pad and
the Classify head, against the JAX package, on the CPU: the graph
compiler's specs, strides and anchors at full width, each new block
against flax, the four detection configs whole at width 0.25 / depth
0.33 / 64 px (raw maps and decode), the classifier's logits, the weight
bridge both ways, the hub loader, and detect's `--classify cfg:weights`
with a weights file the JAX package writes.

Variables are the flax `eval_shape` tree filled with seeded numpy draws
(tests/_torch_port_common.py `random_variables`), with every norm scale
spread x5 for the whole models, as tests/test_torch_port_family.py does;
the tolerances are that file's.
"""

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from tests._torch_port_common import (DEPTH, IMGSZ, NC, WIDTH, _to_dict, few_threads,  # noqa: F401
                                      jax_flagship, jax_random_model, random_variables, small_flagship_cfg)
from tests.test_torch_port_checkpoint import flat, spread
from tests.test_torch_port_eval import _write_image
from tests.test_torch_port_family import specs
from yolosomi_tpu.engine import checkpoint as jax_ckpt
from yolosomi_tpu.models import layers as jlayers
from yolosomi_tpu.models.heads import decode as jax_decode
from yolosomi_tpu.models.yolo import _Repeat
from yolosomi_tpu.models.yolo import parse_model as jax_parse_model
from yolosomi_tpu_torch import detect, hubconf
from yolosomi_tpu_torch.engine.runner import Runner
from yolosomi_tpu_torch.models import layers
from yolosomi_tpu_torch.models.heads import decode
from yolosomi_tpu_torch.models.yolo import build_model, parse_model
from yolosomi_tpu_torch.utils.config import find_config, load_model_cfg
from yolosomi_tpu_torch.utils.weights import export_jax_variables, load_jax_variables

DETECTION = ("hub/yolov3-tiny", "hub/yolov5s-ghost", "hub/yolov5s-transformer", "hub/yolov10")
CONFIGS = DETECTION + ("classifier",)
CLASSIFIER_NC = 2  # classifier.yaml's


def small_cfg(name: str) -> dict:
    cfg = dict(load_model_cfg(find_config(name)))
    cfg["width_multiple"], cfg["depth_multiple"] = WIDTH, DEPTH
    return cfg


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def zoo():
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


@pytest.mark.parametrize("name", CONFIGS)
def test_graph_matches_jax(name):
    """Specs (i, f, n, name, c2, stride), strides, anchors, save list and
    head rows of the full-width config equal JAX's (yolov10's `anchors: 3`
    resolves to the default set; the classifier is headless, nl 0); the
    port builds nothing (meta device)."""
    cfg = load_model_cfg(find_config(name))
    _, jmeta, _ = jax_parse_model(cfg)
    with torch.device("meta"):
        _, pmeta = parse_model(cfg)
    assert specs(pmeta) == specs(jmeta)
    np.testing.assert_array_equal(pmeta.anchors_px, jmeta.anchors_px)
    assert (pmeta.nl == 0) == (name == "classifier")


@pytest.mark.parametrize("module", ["Conv2Former", "CAM", "SDI"])
def test_a_row_outside_the_registry_names_the_queue_item(module):
    """Every name of the JAX registry parses now; a name neither registry
    holds (the case's name with a 2 after it) raises KeyError naming it and
    its row in the port's parser and in the JAX parser alike."""
    cfg = dict(load_model_cfg(find_config("yolov5s")))
    cfg["backbone"] = cfg["backbone"][:-1] + [[-1, 1, f"{module}2", [1024]]]
    for parse in (parse_model, jax_parse_model):
        with pytest.raises(KeyError, match=f"'{module}2' not in registry \\(row {len(cfg['backbone']) - 1}\\)"):
            parse(cfg)


# ---------------------------------------------------------------------------
# the blocks against flax
# ---------------------------------------------------------------------------

# name -> (flax module, port module, input (hw, channels) per input)
BLOCKS = {
    "MaxPool2d_k2s2": (lambda: jlayers.MaxPool2d(2, 2, 0), lambda: layers.MaxPool2d(2, 2, 0), [(16, 8)]),
    "MaxPool2d_k3s2p1": (lambda: jlayers.MaxPool2d(3, 2, 1), lambda: layers.MaxPool2d(3, 2, 1), [(16, 8)]),
    "ZeroPad2d_MaxPool2d_k2s1": (lambda: _Repeat((jlayers.ZeroPad2d((0, 1, 0, 1)), jlayers.MaxPool2d(2, 1, 0))),
                                 lambda: torch.nn.Sequential(layers.ZeroPad2d((0, 1, 0, 1)),
                                                             layers.MaxPool2d(2, 1, 0)), [(15, 8)]),
    "ZeroPad2d": (lambda: jlayers.ZeroPad2d((1, 2, 3, 0)), lambda: layers.ZeroPad2d((1, 2, 3, 0)), [(8, 8)]),
    "DWConv": (lambda: jlayers.DWConv(32, 3, 2, g=16), lambda: layers.DWConv(16, 32, 3, 2), [(16, 16)]),
    "GhostConv": (lambda: jlayers.GhostConv(32, 3, 2), lambda: layers.GhostConv(16, 32, 3, 2), [(16, 16)]),
    "GhostBottleneck": (lambda: jlayers.GhostBottleneck(16), lambda: layers.GhostBottleneck(16, 16), [(16, 16)]),
    "GhostBottleneck_s2": (lambda: jlayers.GhostBottleneck(32, 3, 2), lambda: layers.GhostBottleneck(16, 32, 3, 2),
                           [(16, 16)]),
    "C3Ghost": (lambda: jlayers.C3Ghost(32, 2), lambda: layers.C3Ghost(24, 32, 2), [(16, 24)]),
    "TransformerBlock": (lambda: jlayers.TransformerBlock(32, 4, 2), lambda: layers.TransformerBlock(16, 32, 4, 2),
                         [(8, 16)]),
    "C3TR": (lambda: jlayers.C3TR(32, 1), lambda: layers.C3TR(24, 32, 1), [(8, 24)]),
    "SCDown": (lambda: jlayers.SCDown(32, 3, 2), lambda: layers.SCDown(16, 32, 3, 2), [(16, 16)]),
    "RepVGGDW": (lambda: jlayers.RepVGGDW(16), lambda: layers.RepVGGDW(16), [(16, 16)]),
    "CIB": (lambda: jlayers.CIB(16), lambda: layers.CIB(16, 16), [(16, 16)]),
    "CIB_lk": (lambda: jlayers.CIB(24, False, lk=True), lambda: layers.CIB(16, 24, False, lk=True), [(16, 16)]),
    "C2fCIB": (lambda: jlayers.C2fCIB(32, 2, True, lk=True), lambda: layers.C2fCIB(24, 32, 2, True, lk=True),
               [(16, 24)]),
    "AttentionPSA": (lambda: jlayers.AttentionPSA(32, 2), lambda: layers.AttentionPSA(32, 2), [(8, 32)]),
    "PSA": (lambda: jlayers.PSA(64), lambda: layers.PSA(64, 64), [(8, 64)]),
    "Classify": (lambda: jlayers.Classify(5), lambda: layers.Classify(16, 5), [(8, 16)]),
    "Classify_list": (lambda: jlayers.Classify(5), lambda: layers.Classify(40, 5), [(8, 16), (4, 24)]),
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
    ref = np.asarray(jax.jit(lambda v, t: jmod.apply(v, t, False))(variables, inp))
    pmod = pfn().eval()
    assert load_jax_variables(pmod, variables) == ([], [])
    pmod.to(memory_format=torch.channels_last)
    with torch.no_grad():
        got = pmod([_nchw(x) for x in xs] if len(xs) > 1 else _nchw(xs[0]))
    got = (got.permute(0, 2, 3, 1) if got.dim() == 4 else got).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# whole models, the weight bridge, the hub loader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", DETECTION)
def test_whole_model_raw_outputs_and_decode_match_flax(zoo, name):
    """The tolerances of tests/test_torch_port_family.py."""
    _, jmodel, jmeta, variables, pmodel, pmeta = zoo(name)
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


def test_classifier_logits_match_flax(zoo):
    """The headless graph: its Classify tail's (B, nc) logits."""
    _, jmodel, jmeta, variables, pmodel, pmeta = zoo("classifier")
    assert pmeta.nl == jmeta.nl == 0 and pmeta.head_type == jmeta.head_type
    x = np.random.default_rng(1).standard_normal((3, IMGSZ, IMGSZ, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, t: jmodel.apply(v, t, False))(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = pmodel(_nchw(x)).numpy()
    assert got.shape == ref.shape == (3, NC)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", CONFIGS)
def test_weight_bridge_maps_every_leaf_both_ways(zoo, name):
    """load_jax_variables uses every flax leaf and fills every torch key
    (LayerNorm scales, Dense kernels, the packed in_proj, cv1_<i>, ffn_<i>,
    tr<i>, qkv / pe / proj, linear); export_jax_variables gives back the
    same tree paths, shapes and values."""
    variables, pmodel = zoo(name)[3], zoo(name)[4]
    back = export_jax_variables(pmodel)
    assert sorted(flat(back)) == sorted(flat(variables))
    for key, value in flat(variables).items():
        np.testing.assert_array_equal(flat(back)[key], value, err_msg=key)


@pytest.mark.parametrize("name", DETECTION)
def test_hub_custom_serves_the_config(tmp_path, name):
    """hubconf.custom builds the small config (random weights from seed 0)
    and answers an AutoShape call with finite (n, 6) rows."""
    path = tmp_path / "small.yaml"
    path.write_text(yaml.safe_dump(small_cfg(name)))
    model = hubconf.custom(str(path), imgsz=IMGSZ, conf=1e-6, device="cpu")
    im = np.random.default_rng(2).integers(0, 256, (IMGSZ, IMGSZ, 3), dtype=np.uint8)
    pred = model(im).pred[0]
    assert pred.ndim == 2 and pred.shape[1] == 6 and len(pred) > 0 and np.isfinite(pred).all()


# ---------------------------------------------------------------------------
# the classifier Runner and detect --classify
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def classifier_file(tmp_path_factory):
    """classifier.yaml's model (full width, nc 2) with random variables,
    written by the JAX package, and its flax model."""
    d = tmp_path_factory.mktemp("classifier")
    cfg = load_model_cfg(find_config("classifier"))
    jmodel, _, variables = jax_random_model(cfg, nc=CLASSIFIER_NC)
    path = d / "classifier.msgpack"
    jax_ckpt.save_variables(str(path), variables)
    return dict(path=str(path), jmodel=jmodel, variables=variables)


def test_classifier_runner_gives_the_flax_logits(classifier_file):
    """Runner("classifier", file) at 224 px, f32, on a float [0, 1] batch:
    (B, 2) logits, JAX's within 1e-4; TTA of a classifier refuses."""
    runner = Runner("classifier", classifier_file["path"], dtype=torch.float32, imgsz=224, device="cpu")
    crops = np.random.default_rng(3).random((3, 224, 224, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, t: classifier_file["jmodel"].apply(v, t, False))(
        classifier_file["variables"], jnp.asarray(crops)))
    got = runner(crops)
    assert got.shape == ref.shape == (3, CLASSIFIER_NC) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    assert hubconf.custom("classifier", classifier_file["path"], autoshape=False, device="cpu").meta.nl == 0
    with pytest.raises(ValueError, match="headless"):
        runner(crops, augment=True)


def test_detect_classify_from_cfg_and_weights(classifier_file, tmp_path):
    """detect.run(classify="classifier:<file>") builds the classifier from
    the config and a weights file the JAX package wrote: with its Dense
    kernel zeroed and its bias one-hot on class c, it keeps exactly the
    detections of class c, as detect.run with that classifier as a
    callable (the same Runner) does."""
    cfg = small_flagship_cfg()
    _, jmeta, variables = jax_flagship(cfg)
    cfg_path, weights = tmp_path / "somi-small.yaml", tmp_path / "w.msgpack"
    cfg_path.write_text(yaml.safe_dump(cfg))
    jax_ckpt.save_variables(str(weights), spread(variables), anchors=jmeta.anchors_px.astype(np.float32))
    src = tmp_path / "images"
    src.mkdir()
    rng = np.random.default_rng(4)
    for i in range(2):
        _write_image(src / f"im{i}.jpg", rng, 96, 128)
    kw = dict(weights=str(weights), cfg=str(cfg_path), source=str(src), imgsz=IMGSZ, conf_thres=0.25, max_det=6,
              save_txt=True, save_conf=True, nosave=True, device="cpu", project=str(tmp_path))

    def rows(run_dir):
        return sorted((p.name, r) for p in (run_dir / "labels").glob("*.txt") for r in p.read_text().splitlines())

    every = rows(detect.run(name="all", **kw))
    c = min(int(r.split()[0]) for _, r in every)
    assert c < CLASSIFIER_NC
    one_hot = {"params": dict(classifier_file["variables"]["params"]),
               "batch_stats": classifier_file["variables"]["batch_stats"]}
    tail = max((k for k in one_hot["params"] if k.startswith("layers_")), key=lambda k: int(k.split("_")[1]))
    kernel = one_hot["params"][tail]["linear"]["kernel"]
    one_hot["params"][tail] = {"linear": {"kernel": np.zeros_like(kernel),
                                          "bias": np.eye(CLASSIFIER_NC, dtype=np.float32)[c]}}
    path = tmp_path / "one-hot.msgpack"
    jax_ckpt.save_variables(str(path), one_hot)
    want = [(f, r) for f, r in every if int(r.split()[0]) == c]
    assert 0 < len(want) < len(every)
    assert rows(detect.run(name="cfg", classify=f"classifier:{path}", **kw)) == want
    classifier = Runner("classifier", str(path), imgsz=224, device="cpu")
    assert rows(detect.run(name="callable", classify=classifier, **kw)) == want
