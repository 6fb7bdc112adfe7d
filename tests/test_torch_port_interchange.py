"""Weights in and out of the port against the JAX package: the reference's
state dicts converted by yolosomi_tpu_torch.utils.torch_convert and its
convert_torch CLI, the reference state dict written back from the port's
modules, and TorchScript / ONNX export from them (utils/onnx_export.py,
export.py).

Four configs at width 0.25, depth 0.33, 64 px, nc 3. The reference state
dict of yolo-somi and yolov5s is the JAX package's torch mirror randomized
(tests/test_torch_parity.py `_randomized_state_dict`); the mirror has no
C2f or DCN block, so yolo-somi-t's and yolo-somi-dcn's are built by the
JAX package's inverse key rules (`state_dict_from_variables`) from seeded
flax variables onto the port model's keys. Every head's `anchors` buffer
is 1.25 x the config's. The JAX programs compile in one module fixture, on
threads at once.

Tolerances: converted parameters and the round trips bitwise; decoded
rows against flax within tests/test_onnx_export.py:181-182's (boxes atol
5e-3, rtol 1e-3; scores atol 5e-4), the TorchScript artifact against the
JAX package's artifact within the same, and against the port's own plain
forward bitwise (the trace records the same ops).
"""

import logging
import sys
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from tests._torch_port_common import IMGSZ, NC, few_threads, jax_random_model  # noqa: F401
from tests.test_torch_parity import _randomized_state_dict
from yolosomi_tpu.models.heads import decode as jax_decode
from yolosomi_tpu.models.yolo import build_model as jax_build_model
from yolosomi_tpu.utils import onnx_export as jax_export
from yolosomi_tpu.utils import torch_convert as jax_convert
from yolosomi_tpu.utils.torch_mirror import build_torch_mirror
from yolosomi_tpu_torch import convert_torch, export
from yolosomi_tpu_torch.engine.checkpoint import save_variables
from yolosomi_tpu_torch.engine.runner import Runner
from yolosomi_tpu_torch.models.heads import decode
from yolosomi_tpu_torch.models.yolo import build_model
from yolosomi_tpu_torch.ops import plain_version, refuse_trace
from yolosomi_tpu_torch.utils import onnx_export, torch_convert
from yolosomi_tpu_torch.utils.config import find_config, load_model_cfg
from yolosomi_tpu_torch.utils.general import LOGGER
from yolosomi_tpu_torch.utils.weights import export_jax_variables, load_jax_variables

CONFIGS = ("yolo-somi", "yolo-somi-dcn", "yolov5s", "yolo-somi-t")
MIRRORED = ("yolo-somi", "yolov5s")
ANCHOR_SCALE = 1.25
BOXES, SCORES = dict(atol=5e-3, rtol=1e-3), dict(atol=5e-4, rtol=0)


class Lines(logging.Handler):
    """Collects the package logger's lines."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def small_cfg(name: str) -> dict:
    cfg = dict(load_model_cfg(find_config(name)))
    cfg["width_multiple"], cfg["depth_multiple"] = 0.25, 0.33
    return cfg


def images(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).random((2, IMGSZ, IMGSZ, 3), np.float32)


def port_model(name: str):
    return build_model(small_cfg(name), nc=NC, device="cpu")


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _reference_sd(name: str, cfg: dict, jmeta) -> dict:
    """The config's reference state dict (numpy), its head's anchors buffer
    ANCHOR_SCALE x the config's, in grid units (the randomized mirror's
    buffer is random)."""
    if name in MIRRORED:
        sd = _randomized_state_dict(build_torch_mirror(cfg, jmeta, imgsz=IMGSZ, decode=False))
    else:
        _, _, variables = jax_random_model(cfg)
        tsd, missing = jax_export.state_dict_from_variables(variables, port_model(name)[0])
        assert missing == []
        sd = {k: v.numpy() for k, v in tsd.items()}
    strides = np.asarray([int(s) for s in jmeta.strides], np.float32)
    sd[f"model.{len(jmeta.specs) - 1}.anchors"] = (np.array(jmeta.anchors_px, np.float32) * ANCHOR_SCALE
                                                   / strides[:, None, None])
    return sd


@pytest.fixture(scope="module")
def jax_side():
    """Per config: the small cfg, the JAX meta, the reference state dict,
    the JAX package's conversion of it (strict) and the flax model's
    decoded rows on `images()`."""
    side = {}
    for name in CONFIGS:
        cfg = small_cfg(name)
        jmodel, jmeta = jax_build_model(cfg, nc=NC)
        shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, IMGSZ, IMGSZ, 3)),
                                                    train=False))
        sd = _reference_sd(name, cfg, jmeta)
        jvars = _numpy_tree(jax_convert.convert_state_dict(sd, shapes, strict=True))
        side[name] = dict(cfg=cfg, jmodel=jmodel, jmeta=jmeta, sd=sd, jvars=jvars)

    def rows(s):
        fn = jax.jit(lambda v, x: jax_decode(s["jmodel"].apply(v, x, False), s["jmeta"].anchors_px,
                                             s["jmeta"].strides))
        return np.asarray(fn(s["jvars"], jnp.asarray(images())))

    with ThreadPoolExecutor(len(CONFIGS)) as ex:
        for name, out in zip(CONFIGS, ex.map(rows, [side[n] for n in CONFIGS])):
            side[name]["rows"] = out
    return side


def _convert_into(model, sd: dict) -> None:
    """The port's strict conversion of a reference state dict, loaded into `model`."""
    unmatched, unused = load_jax_variables(model, torch_convert.convert_state_dict(sd, export_jax_variables(model),
                                                                                   strict=True))
    assert unmatched == [] and unused == []


def _loaded_from_jax(name: str, jvars: dict):
    """A port model holding the JAX package's conversion."""
    model, meta = port_model(name)
    unmatched, unused = load_jax_variables(model, jvars)
    assert unmatched == [] and unused == []
    return model, meta


def _decoded(model, meta, x: np.ndarray) -> np.ndarray:
    with torch.no_grad(), plain_version():
        return decode(model(torch.from_numpy(x).permute(0, 3, 1, 2)), meta.anchors_px, meta.strides).numpy()


def _assert_rows_close(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape
    np.testing.assert_allclose(got[..., :4], want[..., :4], **BOXES)
    np.testing.assert_allclose(got[..., 4:], want[..., 4:], **SCORES)


def _assert_same_state(a: torch.nn.Module, b: torch.nn.Module) -> None:
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    bad = [k for k in sa if not torch.equal(sa[k], sb[k])]
    assert bad == []


# ---------------------------------------------------------------------------
# weights in
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CONFIGS)
def test_conversion_is_the_jax_conversion(jax_side, name):
    """The port's converter gives the parameters the JAX package's
    conversion carried over by load_jax_variables gives, bitwise; the model
    decodes as flax does (BOXES / SCORES); the anchors come back from the
    head's buffer as the JAX package reads them."""
    s = jax_side[name]
    model, meta = port_model(name)
    _convert_into(model, s["sd"])
    ref, _ = _loaded_from_jax(name, s["jvars"])
    _assert_same_state(model, ref)
    if name == "yolo-somi-dcn":
        assert any(v.abs().sum() > 0 for k, v in model.state_dict().items() if "conv_offset_mask" in k)
    _assert_rows_close(_decoded(model, meta, images()), s["rows"])
    anchors = torch_convert.anchors_from_state_dict(s["sd"], meta.strides)
    np.testing.assert_array_equal(anchors, jax_convert.anchors_from_state_dict(s["sd"], s["jmeta"].strides))
    np.testing.assert_allclose(anchors, meta.anchors_px * ANCHOR_SCALE, rtol=1e-6)


def test_unmatched_leaves_are_reported_and_strict_raises(jax_side):
    """A leaf with no key in the state dict keeps the template's value and
    is logged, as the JAX package's converter does; strict raises KeyError."""
    sd = dict(jax_side["yolo-somi"]["sd"])
    del sd["model.1.conv.bias"]  # an ODConv's (K, c2) bias bank
    model, _ = port_model("yolo-somi")
    template = export_jax_variables(model)

    lines = Lines()
    LOGGER.addHandler(lines)
    try:
        got = torch_convert.convert_state_dict(sd, template)
    finally:
        LOGGER.removeHandler(lines)
    assert "torch_convert: matched 557, missed 1 leaves" in lines.lines
    assert "torch_convert: first misses: model.1.bias" in lines.lines  # the leaf's primary key
    np.testing.assert_array_equal(got["params"]["layers_1"]["conv"]["bias"],
                                  template["params"]["layers_1"]["conv"]["bias"])
    with pytest.raises(KeyError, match="1 unmatched"):
        torch_convert.convert_state_dict(sd, template, strict=True)
    with pytest.raises(KeyError, match="1 unmatched"):
        jax_convert.convert_state_dict(sd, jax_side["yolo-somi"]["jvars"], strict=True)


def test_convert_cli_writes_the_jax_bytes(jax_side, tmp_path):
    """On one `.pt` (an `ema` entry, and a `model` entry of other values that
    both converters must pass over), the port's convert_torch writes the
    `.msgpack` the JAX package's tools/convert_torch.py writes, byte for
    byte, and the same `.json`; the Runner serves it with the file's anchors."""
    from tools.convert_torch import main as jax_main

    s = jax_side["yolov5s"]
    cfg_path = tmp_path / "v5s-small.yaml"
    cfg_path.write_text(yaml.safe_dump(s["cfg"]))
    pt = tmp_path / "v5s.pt"
    ema = {k: torch.from_numpy(np.array(v)) for k, v in s["sd"].items()}
    other = {k: (v * 2 if v.is_floating_point() else v) for k, v in ema.items()}
    torch.save({"ema": ema, "model": other}, pt)
    jax_main(["--pt", str(pt), "--cfg", str(cfg_path), "--nc", str(NC), "--out", str(tmp_path / "jax.msgpack")])
    out = convert_torch.main(convert_torch.parse_opt(["--pt", str(pt), "--cfg", str(cfg_path), "--nc", str(NC), "--out",
                                                      str(tmp_path / "port.msgpack"), "--device", "cpu"]))
    assert out == tmp_path / "port.msgpack"
    assert out.read_bytes() == (tmp_path / "jax.msgpack").read_bytes()
    assert yaml.safe_load(out.with_suffix(".json").read_text()) == yaml.safe_load(
        (tmp_path / "jax.msgpack").with_suffix(".json").read_text())
    runner = Runner(str(cfg_path), str(out), dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(runner.meta.anchors_px, torch_convert.anchors_from_state_dict(s["sd"],
                                                                                              runner.meta.strides))
    ref, _ = _loaded_from_jax("yolov5s", s["jvars"])
    _assert_same_state(runner.model, ref)


def test_whole_module_pickle_names_the_reference_package(tmp_path, monkeypatch):
    """A checkpoint that pickles a module of the reference's `models`
    package does not load without that package: the error says so."""
    models = types.ModuleType("models")
    models.Model = type("Model", (torch.nn.Module,), {"__module__": "models"})
    monkeypatch.setitem(sys.modules, "models", models)
    pt = tmp_path / "module.pt"
    torch.save({"model": models.Model()}, pt)
    monkeypatch.delitem(sys.modules, "models")
    with pytest.raises(ModuleNotFoundError, match="the reference's `models` package"):
        convert_torch.load_torch_state_dict(pt)


# ---------------------------------------------------------------------------
# weights out
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MIRRORED)
def test_reference_state_dict_is_the_jax_inverse(jax_side, name):
    """reference_state_dict of the port model is the JAX package's
    state_dict_from_variables on its torch mirror, key for key and bitwise
    (anchors in grid units, BatchNorm counts included), except at square
    Linear weights (the flagship's first ODConv's attention `fc` and `fc_c`
    at this width),
    which the JAX package's inverse does not transpose (onnx_export.py:45,
    `v.shape != ts`) while its forward converter does: there the port's is
    the transpose of JAX's. The JAX package's forward converter reads the
    port's state dict back to the variables it came from, and the port's
    converter to the model, both bitwise."""
    s = jax_side[name]
    model, meta = _loaded_from_jax(name, s["jvars"])
    got = torch_convert.reference_state_dict(model, meta)
    want, missing = jax_export.state_dict_from_variables(s["jvars"], build_torch_mirror(s["cfg"], s["jmeta"],
                                                                                         imgsz=IMGSZ, decode=False))
    assert missing == [] and sorted(got) == sorted(want)
    square = sorted(k for k, v in want.items() if k.endswith(".weight") and v.dim() == 2 and v.shape[0] == v.shape[1])
    assert square == (["model.1.conv.fc.weight", "model.1.conv.fc_c.weight"] if name == "yolo-somi" else [])
    for k, v in want.items():
        v = v.numpy().T if k in square else v.numpy()
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    shapes = jax.tree_util.tree_map(lambda v: jax.ShapeDtypeStruct(v.shape, v.dtype), s["jvars"])
    again = _numpy_tree(jax_convert.convert_state_dict(got, shapes, strict=True))
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, again, s["jvars"]))
    back, _ = port_model(name)
    _convert_into(back, got)
    _assert_same_state(back, model)


@pytest.mark.parametrize("name", ["yolo-somi-dcn", "yolo-somi-t"])
def test_reference_state_dict_outside_the_mirror_raises(jax_side, name):
    s = jax_side[name]
    model, meta = port_model(name)
    with pytest.raises(NotImplementedError, match="row"):
        torch_convert.reference_state_dict(model, meta)
    with pytest.raises(NotImplementedError):
        build_torch_mirror(s["cfg"], s["jmeta"], imgsz=IMGSZ)


def test_torchscript_matches_the_jax_artifact_and_flax(jax_side, tmp_path):
    """The flagship's TorchScript artifact from the port's own modules,
    loaded back, against the JAX package's artifact from its mirror and the
    flax decode (BOXES / SCORES), and the port's plain forward bitwise."""
    s = jax_side["yolo-somi"]
    model, meta = _loaded_from_jax("yolo-somi", s["jvars"])
    onnx_export.export_torchscript(model, meta, tmp_path / "port.torchscript", imgsz=IMGSZ, batch=2)
    jax_export.export_torchscript(s["cfg"], s["jmeta"], s["jvars"], str(tmp_path / "jax.torchscript"), imgsz=IMGSZ,
                                  batch=2)
    x = torch.from_numpy(images()).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        got = torch.jit.load(str(tmp_path / "port.torchscript"))(x).numpy()
        theirs = torch.jit.load(str(tmp_path / "jax.torchscript"))(x).numpy()
    np.testing.assert_array_equal(got, _decoded(model, meta, images()))
    _assert_rows_close(got, theirs)
    _assert_rows_close(got, s["rows"])
    assert model.training is False


def test_torchscript_of_yolo_somi_dcn(jax_side, tmp_path):
    """yolo-somi-dcn traces (offset heads random): the artifact gives the
    plain forward's bits and flax's rows (BOXES / SCORES)."""
    model, meta = _loaded_from_jax("yolo-somi-dcn", jax_side["yolo-somi-dcn"]["jvars"])
    ts = onnx_export.export_torchscript(model, meta, tmp_path / "dcn.torchscript", imgsz=IMGSZ, batch=2)
    with torch.no_grad():
        got = ts(torch.from_numpy(images()).permute(0, 3, 1, 2).contiguous()).numpy()
    np.testing.assert_array_equal(got, _decoded(model, meta, images()))
    _assert_rows_close(got, jax_side["yolo-somi-dcn"]["rows"])


def test_onnx_summary_is_the_jax_summary(jax_side, tmp_path):
    """The flagship's ONNX file: the port's wire walker reads what the JAX
    package's reads; ODConv's kernel attention (Softmax) and SEAM's gate
    (Exp) are in the graph."""
    model, meta = _loaded_from_jax("yolo-somi", jax_side["yolo-somi"]["jvars"])
    path = tmp_path / "somi.onnx"
    onnx_export.export_onnx(model, meta, path, imgsz=IMGSZ, opset=12)
    s = onnx_export.onnx_summary(path)
    assert s == jax_export.onnx_summary(str(path))
    assert s["opset"] == 12 and s["inputs"] == ["images"] and s["outputs"] == ["output"]
    assert "Softmax" in s["ops"] and "Exp" in s["ops"] and s["ops"]["Conv"] > 50
    assert s["n_initializers"] > 100


def test_onnx_refusals(jax_side, tmp_path):
    """yolo-somi-dcn raises NotImplementedError naming the row the exporter
    fails in; a dynamic batch raises ValueError on a graph with ODConv and
    exports on yolov5s."""
    model, meta = _loaded_from_jax("yolo-somi-dcn", jax_side["yolo-somi-dcn"]["jvars"])
    with pytest.raises(NotImplementedError, match=r"row 27: ODConv_3rd \(Unsupported: ONNX export of convolution"):
        onnx_export.export_onnx(model, meta, tmp_path / "dcn.onnx", imgsz=IMGSZ)
    model, meta = port_model("yolo-somi")
    with pytest.raises(ValueError, match="row 1: ODConv_3rd"):
        onnx_export.export_onnx(model, meta, tmp_path / "somi.onnx", imgsz=IMGSZ, dynamic_batch=True)
    model, meta = port_model("yolov5s")
    onnx_export.export_onnx(model, meta, tmp_path / "v5s.onnx", imgsz=IMGSZ, dynamic_batch=True)
    assert onnx_export.onnx_summary(tmp_path / "v5s.onnx")["outputs"] == ["output"]


def test_export_cli(jax_side, tmp_path):
    """export.py from a weights file writes both artifacts, the TorchScript
    one giving the plain forward's bits; the unported formats raise
    NotImplementedError, --nms ValueError."""
    s = jax_side["yolo-somi"]
    model, meta = _loaded_from_jax("yolo-somi", s["jvars"])
    cfg_path, weights = tmp_path / "somi-small.yaml", tmp_path / "somi.msgpack"
    cfg_path.write_text(yaml.safe_dump(s["cfg"]))
    save_variables(weights, export_jax_variables(model))
    argv = ["--weights", str(weights), "--cfg", str(cfg_path), "--imgsz", str(IMGSZ), "--device", "cpu", "--project",
            str(tmp_path / "runs")]
    outputs = export.main(export.parse_opt(argv))
    assert [p.name for p in outputs] == ["model.torchscript", "model.onnx"]
    with torch.no_grad():
        got = torch.jit.load(str(outputs[0]))(torch.from_numpy(images()[:1]).permute(0, 3, 1, 2).contiguous())
    np.testing.assert_array_equal(got.numpy(), _decoded(model, meta, images()[:1]))
    assert onnx_export.onnx_summary(outputs[1])["n_nodes"] > 1000
    for fmt in export.NOT_PORTED:
        with pytest.raises(NotImplementedError, match=r"9\(c\)"):
            export.main(export.parse_opt(argv + ["--include", "onnx", fmt]))
    with pytest.raises(ValueError, match="--nms"):
        export.main(export.parse_opt(argv + ["--nms"]))


def test_a_traced_launch_raises():
    """The kernels' launch guard: a no-op outside a trace, RuntimeError
    inside one (a CPU tensor runs the plain version and never reaches it;
    tests/test_torch_port_cuda.py traces the card's kernels)."""
    refuse_trace("odconv_s2")

    def launch(x):
        refuse_trace("odconv_s2")
        return x * 2

    with pytest.raises(RuntimeError, match="odconv_s2: a kernel launch cannot be traced.*plain_version"):
        torch.jit.trace(launch, torch.zeros(2))

