"""The body zoo's three graphs of layers_zoo.py's conv and csp kinds
(yolosomi_tpu_torch/models/zoo_graphs.py: zoo-down, zoo-rfb, zoo-c3att) in
the port against the JAX package on the CPU: the graph compiler at full
width and the four ODConv sites each keeps, the raw maps and the decode at
width 0.25 / depth 0.33 / 64 px, the weight bridge both ways, one train
step of each graph against jax.value_and_grad with a float64 anchor, and
the refusals to shard any of them spatially.

Variables are the flax `eval_shape` tree filled with seeded numpy draws
(tests/_torch_port_common.py `random_variables`), with every norm scale
spread x5 for the forwards, as drawn for the train steps, as
tests/test_torch_port_attention_zoo_graphs.py does. The JAX programs are
compiled on threads at once, without XLA's backend optimizations.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from tests._torch_port_common import DEPTH, IMGSZ, NC, WIDTH, few_threads, jax_random_model  # noqa: F401
from tests.test_torch_port_body_zoo_graphs import FLAGSHIP, X, _nchw, odconv_sites
from tests.test_torch_port_checkpoint import spread
from tests.test_torch_port_family import specs
from tests.test_torch_port_train import batches, flat, targets_batch
from yolosomi_tpu import losses as jax_losses
from yolosomi_tpu.models.heads import decode as jax_decode
from yolosomi_tpu.models.yolo import parse_model as jax_parse_model
from yolosomi_tpu_torch import detect, val
from yolosomi_tpu_torch.engine.runner import Runner
from yolosomi_tpu_torch.losses import ComputeLoss
from yolosomi_tpu_torch.models.heads import decode
from yolosomi_tpu_torch.models.yolo import build_model, parse_model
from yolosomi_tpu_torch.models.zoo_graphs import zoo_graph
from yolosomi_tpu_torch.utils.config import find_config, load_hyp
from yolosomi_tpu_torch.utils.weights import export_jax_variables, export_param_tree, load_jax_variables

GRAPHS = ("zoo-down", "zoo-rfb", "zoo-c3att")
# leaves of each graph's new blocks whose gradient the train step carries (not 0). At 64 px zoo-rfb's P4
# lateral is 4x4, where Conv_SWS fits no 8x8 tile and passes zeros on, so ACmix and the lateral before it
# get no gradient in either package (test_torch_port_conv_zoo.py holds ACmix's gradient alone)
GRAD_LEAVES = {"zoo-down": ("/id_bn/scale", "/m2/conv/kernel", "layers_0/conv/conv/kernel"),
               "zoo-rfb": ("/b2_3/conv/conv/kernel", "/m0/gamma", "/dw/conv/kernel", "/m/layer_scale_2"),
               "zoo-c3att": ("/cpca/conv/conv/kernel", "/d121b/conv/kernel", "/sa_dw/conv/bias")}


def small(name: str) -> dict:
    cfg = zoo_graph(name)
    cfg["width_multiple"], cfg["depth_multiple"] = WIDTH, DEPTH
    return cfg


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
    with ThreadPoolExecutor(len(GRAPHS)) as pool:
        futures = {n: pool.submit(low.compile, {"xla_backend_optimization_level": 0}) for n, low in lowered.items()}
        raw = {n: f.result()(built[n][1], x) for n, f in futures.items()}
    return {n: (*built[n], raw[n]) for n in GRAPHS}


@pytest.fixture(scope="module")
def jax_steps():
    """name -> (unspread variables, JAX's loss, loss items, BatchNorm
    statistics and gradients of one train-mode step of the small graph
    through ComputeLoss (hyp.visdrone)), the three programs compiled on
    threads at once."""
    hyp = load_hyp(find_config("hyp.visdrone", "hyps"))
    x, t = batches()[0], targets_batch()
    made, lowered = {}, {}
    for name in GRAPHS:
        jmodel, jmeta, variables = jax_random_model(small(name))
        jloss = jax_losses.ComputeLoss(jmeta, hyp)

        def loss_of(params, jmodel=jmodel, jloss=jloss, stats=variables["batch_stats"]):
            preds, mutated = jmodel.apply({"params": params, "batch_stats": stats}, x, train=True,
                                          mutable=["batch_stats"])
            loss, comps = jloss(preds, t)
            return loss, (comps, mutated["batch_stats"])

        made[name] = variables
        lowered[name] = jax.jit(jax.value_and_grad(loss_of, has_aux=True)).lower(variables["params"])
    with ThreadPoolExecutor(len(GRAPHS)) as pool:
        futures = {n: pool.submit(low.compile, {"xla_backend_optimization_level": 0}) for n, low in lowered.items()}
        return {n: (made[n], *jax.device_get(f.result()(made[n]["params"]))) for n, f in futures.items()}


@pytest.mark.parametrize("name", GRAPHS)
def test_full_width_graph_matches_jax_and_keeps_the_odconv_sites(name):
    """At full width (meta device): specs (i, f, n, name, c2, stride; the
    stride of SimConv's arg 2, ADown's and DownSimper's 2, RepVGGBlock's
    arg 2, BasicRFB's arg 1), strides, save list and head rows equal JAX's
    parse, nc 10, and the four ODConv sites that odconv_s2 computes, with
    the flagship's shapes."""
    cfg = zoo_graph(name)
    _, jmeta, _ = jax_parse_model(cfg)
    with torch.device("meta"):
        modules, pmeta = parse_model(cfg)
    assert specs(pmeta) == specs(jmeta)
    assert pmeta.nc == 10 and pmeta.nl == 4 and pmeta.strides == (4.0, 8.0, 16.0, 32.0)
    assert odconv_sites(modules) == odconv_sites(FLAGSHIP) == [(64, 128), (256, 256), (256, 256), (512, 256)]


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
    tree paths, shapes and values (ACmix's flax-shaped fc and 0-d rates
    among them)."""
    _, variables, pmodel, _, _ = graphs[name]
    back = flat(export_jax_variables(pmodel))
    want = flat(variables)
    assert sorted(back) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


@pytest.mark.parametrize("name", GRAPHS)
def test_graph_train_step_matches_jax_value_and_grad(jax_steps, name):
    """One train-mode forward of the small graph, ComputeLoss (hyp.visdrone)
    and the gradient of every parameter against jax.value_and_grad, by
    test_torch_port_attention_zoo_graphs.py's rule for zoo-rfem: the loss
    and its items within 1e-5 relative; the port's float64 gradient of each
    leaf within 1e-4 of the leaf's largest element plus 3e-6 of the largest
    gradient of JAX's f32 one, and its float32 gradient within 1e-4 of its
    largest element plus 1e-6 of the largest gradient plus twice that
    float64 distance, at most 3e-6 of the largest gradient; the BatchNorm
    statistics the step moved within 1e-5 relative plus 1e-6. A parameter
    no path to the loss reaches has gradient 0 in both (GRAD_LEAVES'
    comment). Among the leaves that carry one: RepVGGBlock's identity
    BatchNorm, ASPP's dilated convs, SimConv's; the RFB branches,
    ConvNeXt's gamma, ConvMix's depthwise conv, C3CR's layer scale; CPCA's
    shared conv (used three times) and strips, the depthwise spatial
    gate."""
    variables, (jl, (jcomps, jstats)), jgrads = jax_steps[name]
    hyp = load_hyp(find_config("hyp.visdrone", "hyps"))
    x, t = batches()[0], targets_batch()
    ran = {}
    for dtype in (torch.float64, torch.float32):
        pmodel, pmeta = build_model(small(name), nc=NC, device="cpu", dtype=dtype)
        assert load_jax_variables(pmodel, variables) == ([], [])
        pmodel.train()
        names, params = zip(*pmodel.named_parameters())
        loss, comps = ComputeLoss(pmeta, hyp)(pmodel(_nchw(x).to(dtype)), torch.from_numpy(t))
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, torch.autograd.grad(loss, params, allow_unused=True))]
        ran[dtype] = (loss, comps, flat(export_param_tree(pmodel, list(names), grads)))
    loss, comps, got = ran[torch.float32]
    got64 = ran[torch.float64][2]
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(comps.numpy(), np.asarray(jcomps), rtol=1e-5)
    want = flat(jgrads)
    assert sorted(got) == sorted(want) and len(want) == len(names)
    for leaf in GRAD_LEAVES[name]:
        keys = [k for k in want if k.endswith(leaf)]
        assert keys and all(np.abs(want[k]).max() > 0 and np.abs(got[k]).max() > 0 for k in keys), leaf
    top = max(np.abs(v).max() for v in want.values())
    for k, w in want.items():
        floor, d64 = 1e-4 * np.abs(w).max(), np.abs(got64[k] - w).max()
        assert d64 <= floor + 3e-6 * top, (k, d64, floor + 3e-6 * top)
        limit = floor + 1e-6 * top + min(2 * d64, 3e-6 * top)
        assert np.abs(got[k] - w).max() <= limit, (k, np.abs(got[k] - w).max(), limit)
    stats = flat(export_jax_variables(pmodel)["batch_stats"])
    for k, w in flat(jstats).items():
        np.testing.assert_allclose(stats[k], w, rtol=1e-5, atol=1e-6, err_msg=k)


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
