"""yolosomi_tpu_torch's flagship graph against the JAX package at width
0.25 / depth 0.33 / 64 px: the graph compiler's specs, each block family of
the graph, the whole model's raw outputs and decode, the weight bridge at
full width, and the serving Runner on the CPU."""

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from tests._torch_port_common import (IMGSZ, NC, few_threads, jax_flagship, layer_variables,  # noqa: F401
                                      small_flagship_cfg)
from yolosomi_tpu.models.heads import decode as jax_decode
from yolosomi_tpu.models.yolo import build_model as jax_build_model
from yolosomi_tpu_torch.engine.runner import Runner
from yolosomi_tpu_torch.models.heads import decode
from yolosomi_tpu_torch.models.yolo import build_model
from yolosomi_tpu_torch.ops.nms import MAX_WH, fused_postprocess
from yolosomi_tpu_torch.utils.config import find_config, load_model_cfg
from yolosomi_tpu_torch.utils.weights import load_jax_variables


@pytest.fixture(scope="module")
def flagship():
    cfg = small_flagship_cfg()
    jmodel, jmeta, variables = jax_flagship(cfg)
    pmodel, pmeta = build_model(cfg, nc=NC, device="cpu")
    unmatched, unused = load_jax_variables(pmodel, variables)
    assert unmatched == [] and unused == []
    return cfg, jmodel, jmeta, variables, pmodel, pmeta


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def test_graph_compiler_matches_jax(flagship):
    _, _, jmeta, _, _, pmeta = flagship
    assert [(s.i, s.f, s.n, s.name, s.c2, s.stride) for s in pmeta.specs] == [
        (s.i, s.f, s.n, s.name, s.c2, s.stride) for s in jmeta.specs
    ]
    assert pmeta.strides == jmeta.strides == (4.0, 8.0, 16.0, 32.0)
    np.testing.assert_array_equal(pmeta.anchors_px, jmeta.anchors_px)
    assert (pmeta.save, pmeta.head_from, pmeta.nl, pmeta.na) == (jmeta.save, jmeta.head_from, jmeta.nl, jmeta.na)


def test_numerical_conventions_are_pinned(flagship):
    """BN eps 1e-3 (Conv, SEAM, ODConv output) and 1e-5 (ODConv attention
    trunk); SEAM's GELU exact in f32 and tanh in bf16 (layers.py:631-632);
    the NMS class offset 4096 (nms.py:33)."""
    pmodel = flagship[4]
    assert {m.eps for m in pmodel.modules() if isinstance(m, torch.nn.BatchNorm2d)} == {1e-3}
    assert {m.eps for m in pmodel.modules() if isinstance(m, torch.nn.BatchNorm1d)} == {1e-5}
    assert {m.approximate for m in pmodel.modules() if isinstance(m, torch.nn.GELU)} == {"none"}
    bf16, _ = build_model(small_flagship_cfg(), nc=NC, device="cpu", dtype=torch.bfloat16)
    assert {m.approximate for m in bf16.modules() if isinstance(m, torch.nn.GELU)} == {"tanh"}
    assert next(bf16.parameters()).dtype == torch.bfloat16
    assert MAX_WH == 4096.0


def test_unknown_module_row_raises():
    cfg = small_flagship_cfg()
    cfg["backbone"] = [[-1, 1, "Conv2Former2", [64, 3]]] + list(cfg["backbone"][1:])  # in neither registry
    with pytest.raises(KeyError, match="'Conv2Former2' not in registry"):
        build_model(cfg, device="cpu")


# one layer of each block family of the flagship (row of yolo-somi.yaml)
BLOCK_ROWS = {"C2fCBAM": 2, "SPPF": 9, "BiFPN": 15, "SEAM": 16, "C2fEMACBAM": 17, "DecoupledDetect": 35}


@pytest.mark.parametrize("block", sorted(BLOCK_ROWS))
def test_block_matches_flax(flagship, block):
    _, jmodel, jmeta, variables, pmodel, _ = flagship
    row = BLOCK_ROWS[block]
    spec = jmeta.specs[row]
    froms = list(jmeta.head_from) if block == "DecoupledDetect" else (spec.f if isinstance(spec.f, list) else [spec.f])
    rng = np.random.default_rng(row)
    xs = []
    for f in froms:
        src = row + f if f < 0 else f
        hw = int(IMGSZ / jmeta.specs[src].stride)
        xs.append(rng.standard_normal((2, hw, hw, jmeta.specs[src].c2)).astype(np.float32))
    inp = xs if len(froms) > 1 else xs[0]
    ref = jax.jit(lambda v, t: jmodel.layers[row].apply(v, t, False))(layer_variables(variables, row), inp)
    with torch.no_grad():
        got = pmodel.model[row]([_nchw(x) for x in xs] if len(froms) > 1 else _nchw(xs[0]))
    if block == "DecoupledDetect":  # raw level maps, already (B, ny, nx, na, no)
        got, ref = [g.numpy() for g in got], [np.asarray(r) for r in ref]
    else:
        got, ref = [got.permute(0, 2, 3, 1).numpy()], [np.asarray(ref)]
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=1e-4, rtol=1e-4)


def test_flagship_raw_outputs_and_decode_match_flax(flagship):
    _, jmodel, jmeta, variables, pmodel, pmeta = flagship
    x = np.random.default_rng(0).standard_normal((2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    j_raw = jax.jit(lambda v, t: jmodel.apply(v, t, False))(variables, jnp.asarray(x))
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


def test_weight_bridge_covers_full_width_flagship():
    """Every torch key and every flax leaf of the full-width flagship pair up
    (shapes checked by the copy). Models are built only, never run."""
    cfg = load_model_cfg(find_config("yolo-somi"))
    jmodel, _ = jax_build_model(cfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    pmodel, _ = build_model(cfg, device="cpu")
    unmatched, unused = load_jax_variables(pmodel, variables)
    assert unmatched == [] and unused == []
    assert sum(p.numel() for p in pmodel.parameters()) == sum(v.size for v in jax.tree_util.tree_leaves(variables["params"]))


def test_runner_on_cpu_serves_its_own_postprocess(flagship, tmp_path):
    cfg, _, _, variables, _, _ = flagship
    path = tmp_path / "somi-small.yaml"
    path.write_text(yaml.safe_dump(cfg))
    runner = Runner(str(path), nc=NC, dtype=torch.float32, imgsz=IMGSZ, device="cpu", variables=variables)
    images = np.random.default_rng(5).integers(0, 256, (2, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    out = runner(images, conf_thres=0.2, max_det=40)
    assert out.shape == (2, 40, 6) and out.dtype == np.float32 and np.isfinite(out).all()
    with torch.no_grad():
        raw = runner.model(torch.from_numpy(images).permute(0, 3, 1, 2).float() / 255.0)
    ref = fused_postprocess(raw, runner.meta.anchors_px, runner.meta.strides, conf_thres=0.2, max_det=40).numpy()
    np.testing.assert_array_equal(out, ref)
    valid = out[..., 4] > 0
    assert valid.any() and (out[~valid] == 0).all()
    tta = runner(images, conf_thres=0.2, max_det=40, augment=True)  # held to JAX in tests/test_torch_port_tta.py
    assert tta.shape == out.shape and np.isfinite(tta).all() and not np.array_equal(tta, out)
    with pytest.raises(TypeError):  # float in [0, 1] is taken, as JAX's Runner takes it; ints are not
        runner(images.astype(np.int32))


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Runner("yolo-somi")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(small_flagship_cfg())
