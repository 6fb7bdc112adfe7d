"""The body zoo's six graphs (yolosomi_tpu_torch/models/zoo_graphs.py: the
flagship with CARAFE, DySample + Expand + Zoom_cat, the BiFPN_Add fusion
with MultiSEAM and the learnable activations, SPD-Conv with MixConv2d /
GSConv / CrossConv, the CSP variants, the gates with Involution) in the
port against the JAX package on the CPU: the graph compiler at full width,
the four ODConv sites each keeps, the raw maps and the decode at width
0.25 / depth 0.33 / 64 px, the weight bridge both ways, Zoom_cat's stride
(the port's divergence from the JAX parser, ROADMAP queue C), one
zoo-fusion train step against jax.value_and_grad, the Runner's rows
against the JAX Runner for zoo-carafe, and the refusals to shard any of
them spatially.

Variables are the flax `eval_shape` tree filled with seeded numpy draws
(tests/_torch_port_common.py `random_variables`), with every norm scale
spread x5 for the forwards and the Runner (tests/test_torch_port_checkpoint.py's
reason: at x1 the small models' scores are near-ties), as drawn for the
train step (test_torch_port_family.py's reason). The JAX programs are
compiled on threads at once, without XLA's backend optimizations (the
arithmetic is the same), as tests/test_torch_port_heads.py does.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from tests._torch_port_common import DEPTH, IMGSZ, NC, WIDTH, few_threads, jax_random_model  # noqa: F401
from tests.test_torch_port_checkpoint import assert_rows_match, spread
from tests.test_torch_port_family import specs
from tests.test_torch_port_train import batches, flat, targets_batch
from yolosomi_tpu import losses as jax_losses
from yolosomi_tpu.engine import checkpoint as jax_ckpt
from yolosomi_tpu.engine import runner as jax_runner_mod
from yolosomi_tpu.models.heads import decode as jax_decode
from yolosomi_tpu.models.yolo import parse_model as jax_parse_model
from yolosomi_tpu_torch import detect, val
from yolosomi_tpu_torch.engine.runner import Runner
from yolosomi_tpu_torch.losses import ComputeLoss
from yolosomi_tpu_torch.models.heads import decode
from yolosomi_tpu_torch.models.layers import ODConv2d
from yolosomi_tpu_torch.models.yolo import build_model, parse_model
from yolosomi_tpu_torch.models.zoo_graphs import zoo_graph
from yolosomi_tpu_torch.utils.config import find_config, load_hyp, load_model_cfg
from yolosomi_tpu_torch.utils.weights import export_jax_variables, export_param_tree, load_jax_variables

# the six graphs of the parser's remaining kinds and the body zoo's first
# blocks; test_torch_port_attention_zoo_graphs.py holds the others
GRAPHS = ("zoo-attention", "zoo-carafe", "zoo-csp", "zoo-dysample", "zoo-fusion", "zoo-spd")
ZOOMCAT = "zoo-dysample"  # the graph with a Zoom_cat row


def small(name: str) -> dict:
    cfg = zoo_graph(name)
    cfg["width_multiple"], cfg["depth_multiple"] = WIDTH, DEPTH
    return cfg


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def without_strides(s: tuple) -> tuple:
    return ([r[:-1] for r in s[0]], *s[2:])


@pytest.fixture(scope="module")
def graphs():
    """name -> (JAX meta, spread variables, port model, port meta, the
    flax model's raw maps of X): the small graphs, the JAX forwards
    compiled on threads at once."""
    x = jnp.asarray(X)
    built, lowered = {}, {}
    for name in GRAPHS:
        jmodel, jmeta, variables = jax_random_model(small(name))
        variables = spread(variables)
        pmodel, pmeta = build_model(small(name), nc=NC, device="cpu")
        assert load_jax_variables(pmodel, variables) == ([], [])
        built[name] = (jmeta, variables, pmodel, pmeta)
        lowered[name] = jax.jit(lambda v, t, m=jmodel: m.apply(v, t, False)).lower(variables, x)
    with ThreadPoolExecutor(4) as pool:
        futures = {n: pool.submit(low.compile, {"xla_backend_optimization_level": 0}) for n, low in lowered.items()}
        raw = {n: f.result()(built[n][1], x) for n, f in futures.items()}
    return {n: (*built[n], raw[n]) for n in GRAPHS}


def odconv_sites(modules) -> list:
    """(Cin, Cout) of the ODConv2d that odconv_s2 computes, in row order."""
    return [(m.c1, m.c2) for mod in modules for m in mod.modules() if isinstance(m, ODConv2d) and m.uses_kernel]


with torch.device("meta"):
    FLAGSHIP = parse_model(load_model_cfg(find_config("yolo-somi")))[0]
X = np.random.default_rng(0).standard_normal((2, IMGSZ, IMGSZ, 3)).astype(np.float32)


@pytest.mark.parametrize("name", GRAPHS)
def test_full_width_graph_matches_jax_and_keeps_the_odconv_sites(name):
    """At full width (meta device): specs (i, f, n, name, c2, stride),
    strides, save list and head rows equal JAX's parse (zoo-dysample's
    strides aside: test_zoomcat_stride_is_its_second_inputs), nc 10, and
    the four ODConv sites that odconv_s2 computes, with the flagship's
    shapes."""
    cfg = zoo_graph(name)
    _, jmeta, _ = jax_parse_model(cfg)
    with torch.device("meta"):
        modules, pmeta = parse_model(cfg)
    if name == ZOOMCAT:
        assert without_strides(specs(pmeta)) == without_strides(specs(jmeta))
    else:
        assert specs(pmeta) == specs(jmeta)
    assert pmeta.nc == 10 and pmeta.nl == 4 and pmeta.strides == (4.0, 8.0, 16.0, 32.0)
    assert odconv_sites(modules) == odconv_sites(FLAGSHIP) == [(64, 128), (256, 256), (256, 256), (512, 256)]


@pytest.mark.parametrize("name", GRAPHS)
def test_graph_raw_maps_and_decode_match_jax(graphs, name):
    """Raw maps within atol 1e-4, rtol 1e-4; the decode within the family's
    tolerances (boxes atol 5e-3 / rtol 1e-3, scores 5e-4), but for the
    Zoom_cat graph, whose JAX decode uses JAX's half strides."""
    jmeta, _, pmodel, pmeta, j_raw = graphs[name]
    with torch.no_grad():
        p_raw = pmodel(_nchw(X))
    assert len(p_raw) == len(j_raw) == 4
    for p, j in zip(p_raw, j_raw):
        assert tuple(p.shape) == j.shape
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-4, rtol=1e-4)
    if name == ZOOMCAT:
        return
    j_dec = np.asarray(jax_decode(j_raw, jmeta.anchors_px, jmeta.strides))
    p_dec = decode(p_raw, pmeta.anchors_px, pmeta.strides).numpy()
    assert p_dec.shape == j_dec.shape
    np.testing.assert_allclose(p_dec[..., :4], j_dec[..., :4], atol=5e-3, rtol=1e-3)
    np.testing.assert_allclose(p_dec[..., 4:], j_dec[..., 4:], atol=5e-4)


@pytest.mark.parametrize("name", GRAPHS)
def test_graph_weight_bridge_maps_every_leaf_both_ways(graphs, name):
    """load_jax_variables used every flax leaf and filled every torch key
    (the fixture asserts it); export_jax_variables gives back the same
    tree paths, shapes and values."""
    _, variables, pmodel, _, _ = graphs[name]
    back = flat(export_jax_variables(pmodel))
    want = flat(variables)
    assert sorted(back) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_zoomcat_stride_is_its_second_inputs(graphs):
    """zoo-dysample's maps lie at strides 4, 8, 16, 32 (imgsz / map size,
    in both packages' forwards); the port's ModelMeta says so, where the
    JAX parser, which records a Zoom_cat row's first input's stride, says
    2, 4, 8, 16 at full width and small (ROADMAP queue C)."""
    jmeta, _, _, pmeta, j_raw = graphs[ZOOMCAT]
    maps = tuple(IMGSZ / j.shape[1] for j in j_raw)
    assert maps == pmeta.strides == (4.0, 8.0, 16.0, 32.0)
    assert jmeta.strides == (2.0, 4.0, 8.0, 16.0)
    assert jax_parse_model(zoo_graph(ZOOMCAT))[1].strides == (2.0, 4.0, 8.0, 16.0)
    zoomcat = next(s for s in pmeta.specs if s.name == "Zoom_cat")
    assert zoomcat.stride == pmeta.specs[zoomcat.i - 1].stride == 8.0  # its second input, -1


def test_zoo_fusion_train_step_matches_jax_value_and_grad():
    """One train-mode forward of the small zoo-fusion, ComputeLoss
    (hyp.visdrone) and the gradient of every parameter (BiFPN_Add's w,
    MultiSEAM's, the ACON p1 / p2 / beta and MetaAconC's convs among
    them) against jax.value_and_grad: the loss within 1e-5 relative, each
    gradient leaf within 1e-4 of its largest element plus 1e-6 of the
    largest gradient, the BatchNorm statistics within 1e-5 relative plus
    1e-6 (test_torch_port_family.py's limits; the draws are not spread)."""
    cfg = small("zoo-fusion")
    jmodel, jmeta, variables = jax_random_model(cfg)
    hyp = load_hyp(find_config("hyp.visdrone", "hyps"))
    x, t = batches()[0], targets_batch()
    jloss = jax_losses.ComputeLoss(jmeta, hyp)

    def loss_of(params):
        preds, mutated = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]}, x, train=True,
                                      mutable=["batch_stats"])
        loss, comps = jloss(preds, t)
        return loss, (comps, mutated["batch_stats"])

    step = jax.jit(jax.value_and_grad(loss_of, has_aux=True)).lower(variables["params"])
    (jl, (jcomps, jstats)), jgrads = step.compile({"xla_backend_optimization_level": 0})(variables["params"])
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
    assert any(k.endswith("/w") for k in want) and any(k.endswith("/p1") for k in want)
    top = max(np.abs(v).max() for v in want.values())
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= 1e-4 * np.abs(w).max() + 1e-6 * top, (k, np.abs(got[k] - w).max())
    stats = flat(export_jax_variables(pmodel)["batch_stats"])
    for k, w in flat(jax.device_get(jstats)).items():
        np.testing.assert_allclose(stats[k], w, rtol=1e-5, atol=1e-6, err_msg=k)


def test_runner_rows_match_the_jax_runner(graphs, tmp_path):
    """zoo-carafe's spread variables written by the JAX package: the two
    f32 Runners give the same (B, 300, 6) rows, single-label at conf 0.25
    and multi-label exact at 0.001 (test_torch_port_checkpoint.py's
    tolerance)."""
    _, variables, _, _, _ = graphs["zoo-carafe"]
    cfg_path, weights = tmp_path / "zoo-carafe.yaml", tmp_path / "w.msgpack"
    cfg_path.write_text(yaml.safe_dump(small("zoo-carafe")))
    jax_ckpt.save_variables(str(weights), variables)
    jrunner = jax_runner_mod.Runner(str(cfg_path), str(weights), dtype=jnp.float32, imgsz=IMGSZ)
    runner = Runner(str(cfg_path), str(weights), dtype=torch.float32, imgsz=IMGSZ, device="cpu")
    assert runner.meta.nc == jrunner.meta.nc == NC
    images = np.random.default_rng(3).integers(0, 256, (3, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    cases = (dict(conf_thres=0.25), dict(conf_thres=0.001, iou_thres=0.6, multi_label=True, exact=True,
                                         max_nms=30000))
    lowered = [jrunner.infer_fn(**kw).lower(jrunner.variables, jnp.asarray(images)) for kw in cases]
    with ThreadPoolExecutor(2) as pool:
        compiled = list(pool.map(lambda low: low.compile({"xla_backend_optimization_level": 0}), lowered))
    for kw, fn in zip(cases, compiled):
        assert_rows_match(runner(images, **kw), np.asarray(fn(jrunner.variables, jnp.asarray(images))))


@pytest.mark.parametrize("name", GRAPHS)
def test_sharding_a_graph_spatially_raises_naming_item_6(name, tmp_path):
    """Runner(spatial_shards=2), val's and detect's --shard-spatial 2 raise
    NotImplementedError naming the graph's body zoo rows and item 6, with
    no process group up (none starts)."""
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(small(name)))
    with pytest.raises(NotImplementedError, match="are not ported.*item 6"):
        Runner(str(path), dtype=torch.float32, device="cpu", spatial_shards=2)
    data = {"path": str(tmp_path), "train": "images", "val": "images", "nc": NC, "names": [str(i) for i in range(NC)]}
    with pytest.raises(NotImplementedError, match="item 6"):
        val.run(data, cfg=str(path), imgsz=IMGSZ, shard_spatial=2, device="cpu", project=str(tmp_path))
    with pytest.raises(NotImplementedError, match="item 6"):
        detect.run(cfg=str(path), source=str(tmp_path), imgsz=IMGSZ, shard_spatial=2, device="cpu",
                   project=str(tmp_path))
    assert not torch.distributed.is_initialized()
