"""The body zoo's four graphs of layers.py's attention family, Swin /
HorNet and RFEM / EVC blocks (yolosomi_tpu_torch/models/zoo_graphs.py:
zoo-gates2, zoo-global, zoo-swin, zoo-rfem) in the port against the JAX
package on the CPU: the graph compiler at full width and the four ODConv
sites each keeps, the raw maps and the decode at width 0.25 / depth 0.33 /
64 px, the weight bridge both ways, one zoo-rfem train step against
jax.value_and_grad, zoo-global's Runner from a weights file the JAX
package writes (its MHSA takes the file's map size), and the refusals to
shard any of them spatially.

Variables are the flax `eval_shape` tree filled with seeded numpy draws
(tests/_torch_port_common.py `random_variables`), with every norm scale
spread x5 for the forwards and the Runner, as drawn for the train step,
as tests/test_torch_port_body_zoo_graphs.py does. The JAX parser cannot
build a block with no field from a YAML row (tests/_torch_port_common.py
FIELDLESS); within this module its registry builds them from the empty
row, as the port does.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from tests._torch_port_common import (DEPTH, IMGSZ, NC, WIDTH, few_threads, fieldless_rows,  # noqa: F401
                                      jax_random_model)
from tests.test_torch_port_body_zoo_graphs import FLAGSHIP, X, _nchw, odconv_sites
from tests.test_torch_port_body_zoo_graphs import GRAPHS as FIRST_GRAPHS
from tests.test_torch_port_checkpoint import spread
from tests.test_torch_port_conv_zoo_graphs import GRAPHS as CONV_GRAPHS
from tests.test_torch_port_fusion_zoo_graphs import GRAPHS as FUSION_GRAPHS
from tests.test_torch_port_family import specs
from tests.test_torch_port_train import batches, flat, targets_batch
from yolosomi_tpu import losses as jax_losses
from yolosomi_tpu.engine import checkpoint as jax_ckpt
from yolosomi_tpu.models.heads import decode as jax_decode
from yolosomi_tpu.models.yolo import parse_model as jax_parse_model
from yolosomi_tpu_torch import detect, val
from yolosomi_tpu_torch.engine.runner import Runner
from yolosomi_tpu_torch.losses import ComputeLoss
from yolosomi_tpu_torch.models import layers
from yolosomi_tpu_torch.models.heads import decode
from yolosomi_tpu_torch.models.yolo import build_model, parse_model
from yolosomi_tpu_torch.models.zoo_graphs import ZOO_GRAPHS, zoo_graph
from yolosomi_tpu_torch.utils.config import find_config, load_hyp
from yolosomi_tpu_torch.utils.weights import export_jax_variables, export_param_tree, load_jax_variables

GRAPHS = ("zoo-gates2", "zoo-global", "zoo-swin", "zoo-rfem")


def small(name: str) -> dict:
    cfg = zoo_graph(name)
    cfg["width_multiple"], cfg["depth_multiple"] = WIDTH, DEPTH
    return cfg


@pytest.fixture(scope="module")
def graphs(fieldless_rows):
    """name -> (JAX meta, spread variables, port model, port meta, the
    flax model's raw maps of X): the small graphs, the JAX forwards
    compiled on threads at once."""
    x = jnp.asarray(X)
    built, lowered = {}, {}
    for name in GRAPHS:
        jmodel, jmeta, variables = jax_random_model(small(name))
        variables = spread(variables)
        pmodel, pmeta = build_model(small(name), nc=NC, device="cpu", imgsz=IMGSZ)
        assert load_jax_variables(pmodel, variables) == ([], [])
        built[name] = (jmeta, variables, pmodel, pmeta)
        lowered[name] = jax.jit(lambda v, t, m=jmodel: m.apply(v, t, False)).lower(variables, x)
    with ThreadPoolExecutor(4) as pool:
        futures = {n: pool.submit(low.compile, {"xla_backend_optimization_level": 0}) for n, low in lowered.items()}
        raw = {n: f.result()(built[n][1], x) for n, f in futures.items()}
    return {n: (*built[n], raw[n]) for n in GRAPHS}


def test_every_zoo_graph_is_held_by_one_of_the_two_files():
    """ZOO_GRAPHS is this file's four graphs, test_torch_port_body_zoo_graphs.py's six,
    test_torch_port_conv_zoo_graphs.py's three and test_torch_port_fusion_zoo_graphs.py's two,
    each held by one file."""
    held = GRAPHS + FIRST_GRAPHS + CONV_GRAPHS + FUSION_GRAPHS
    assert sorted(ZOO_GRAPHS) == sorted(held) and len(set(held)) == len(held)


@pytest.mark.parametrize("name", GRAPHS)
def test_full_width_graph_matches_jax_and_keeps_the_odconv_sites(fieldless_rows, name):
    """At full width (meta device): specs (i, f, n, name, c2, stride),
    strides, save list and head rows equal JAX's parse, nc 10, and the
    four ODConv sites that odconv_s2 computes, with the flagship's shapes;
    zoo-global's MHSA is sized for the 20x20 map of a 640 px image when
    built at 640."""
    cfg = zoo_graph(name)
    _, jmeta, _ = jax_parse_model(cfg)
    with torch.device("meta"):
        modules, pmeta = parse_model(cfg, imgsz=640)
    assert specs(pmeta) == specs(jmeta)
    assert pmeta.nc == 10 and pmeta.nl == 4 and pmeta.strides == (4.0, 8.0, 16.0, 32.0)
    assert odconv_sites(modules) == odconv_sites(FLAGSHIP) == [(64, 128), (256, 256), (256, 256), (512, 256)]
    mhsa = [m for mod in modules for m in mod.modules() if isinstance(m, layers.MHSA)]
    assert [(m.rel_h.shape[2], m.rel_w.shape[1]) for m in mhsa] == ([(20, 20)] if name == "zoo-global" else [])


@pytest.mark.parametrize("name", GRAPHS)
def test_graph_raw_maps_and_decode_match_jax(graphs, name):
    """Raw maps within atol 1e-4, rtol 1e-4; the decode within the family's
    tolerances (boxes atol 5e-3 / rtol 1e-3, scores 5e-4)."""
    jmeta, _, pmodel, pmeta, j_raw = graphs[name]
    with torch.no_grad():
        p_raw = pmodel(_nchw(X))
    assert len(p_raw) == len(j_raw) == 4
    for p, j in zip(p_raw, j_raw):
        assert tuple(p.shape) == j.shape
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-4, rtol=1e-4)
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


def test_zoo_rfem_train_step_matches_jax_value_and_grad(fieldless_rows):
    """One train-mode forward of the small zoo-rfem, ComputeLoss
    (hyp.visdrone) and the gradient of every parameter (TridentBlock's
    shared kernels, the Encoding's codewords and scales, LVC's and
    ConvMixer's Dense kernels among them) against jax.value_and_grad: the
    loss within 1e-5 relative; the port's float64 gradient of each leaf
    within 1e-4 of the leaf's largest element plus 3e-6 of the largest
    gradient of JAX's f32 one (JAX's own f32 rounding: ODConv's bias
    gradient lies 1.3e-6 of the largest gradient from the f64 one), and its
    float32 gradient within 1e-4 of its largest element plus 1e-6 of the
    largest gradient (test_torch_port_family.py's limits) plus twice that
    float64 distance, at most 3e-6 of the largest gradient; the BatchNorm
    statistics (the shared TridentBlock ones moved three times) within 1e-5
    relative plus 1e-6; the draws are not spread."""
    cfg = small("zoo-rfem")
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
    ran = {}
    for dtype in (torch.float64, torch.float32):
        pmodel, pmeta = build_model(cfg, nc=NC, device="cpu", imgsz=IMGSZ, dtype=dtype)
        assert load_jax_variables(pmodel, variables) == ([], [])
        pmodel.train()
        names, params = zip(*pmodel.named_parameters())
        loss, comps = ComputeLoss(pmeta, hyp)(pmodel(_nchw(x).to(dtype)), torch.from_numpy(t))
        ran[dtype] = (loss, comps, flat(export_param_tree(pmodel, list(names), list(torch.autograd.grad(loss, params)))))
    loss, comps, got = ran[torch.float32]
    got64 = ran[torch.float64][2]
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(comps.numpy(), np.asarray(jcomps), rtol=1e-5)
    want = flat(jax.device_get(jgrads))
    assert sorted(got) == sorted(want) and len(want) == len(names)
    assert any(k.endswith("/share_weightconv2") for k in want) and any(k.endswith("/codewords") for k in want)
    top = max(np.abs(v).max() for v in want.values())
    for k, w in want.items():
        floor, d64 = 1e-4 * np.abs(w).max(), np.abs(got64[k] - w).max()
        assert d64 <= floor + 3e-6 * top, (k, d64, floor + 3e-6 * top)
        limit = floor + 1e-6 * top + min(2 * d64, 3e-6 * top)
        assert np.abs(got[k] - w).max() <= limit, (k, np.abs(got[k] - w).max(), limit)
    stats = flat(export_jax_variables(pmodel)["batch_stats"])
    for k, w in flat(jax.device_get(jstats)).items():
        np.testing.assert_allclose(stats[k], w, rtol=1e-5, atol=1e-6, err_msg=k)


def test_runner_serves_the_graph_from_a_jax_weights_file(graphs, tmp_path):
    """zoo-global's spread variables written by the JAX package at 64 px (its
    MHSA's rel_h / rel_w for a 2x2 map): the port's Runner at imgsz 640
    builds MHSA for 8x8 (min(imgsz, 256), as the JAX Runner inits), takes
    the file's 2x2, gives the flax model's raw maps of X (atol 1e-4, rtol
    1e-4), and raises ValueError for an image of another size."""
    _, variables, _, _, j_raw = graphs["zoo-global"]
    cfg_path, weights = tmp_path / "zoo-global.yaml", tmp_path / "w.msgpack"
    cfg_path.write_text(yaml.safe_dump(small("zoo-global")))
    jax_ckpt.save_variables(str(weights), variables)
    runner = Runner(str(cfg_path), str(weights), dtype=torch.float32, imgsz=640, device="cpu")
    mhsa = next(m for m in runner.model.modules() if isinstance(m, layers.MHSA))
    assert (mhsa.rel_h.shape[2], mhsa.rel_w.shape[1]) == (2, 2)
    for p, j in zip(runner.forward(X), j_raw):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="built for a 2x2 map"):
        runner(np.zeros((1, 2 * IMGSZ, 2 * IMGSZ, 3), np.uint8))
    fresh = Runner(str(cfg_path), dtype=torch.float32, imgsz=640, device="cpu")
    mhsa = next(m for m in fresh.model.modules() if isinstance(m, layers.MHSA))
    assert (mhsa.rel_h.shape[2], mhsa.rel_w.shape[1]) == (8, 8)


@pytest.mark.parametrize("name", GRAPHS)
def test_sharding_a_graph_spatially_raises_naming_item_6(name, tmp_path):
    """Runner(spatial_shards=2), val's and detect's --shard-spatial 2 raise
    NotImplementedError naming the graph's rows and item 6, with no process
    group up (none starts)."""
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
