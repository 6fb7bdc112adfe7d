"""The body zoo's two graphs of layers_zoo.py's fusion kinds
(yolosomi_tpu_torch/models/zoo_graphs.py: zoo-tconv, zoo-asf) in the port
against the JAX package on the CPU: the graph compiler at full width and
the four ODConv sites each keeps, the raw maps and the decode at width
0.25 / depth 0.33 / 64 px, the weight bridge both ways, one train step of
each graph against jax.value_and_grad with a float64 anchor, and the
refusals to shard either of them spatially.

Variables are the flax `eval_shape` tree filled with seeded numpy draws
(tests/_torch_port_common.py `random_variables`), with every norm scale
spread x5 for the forwards, as drawn for the train steps, as
tests/test_torch_port_conv_zoo_graphs.py does. The four JAX programs are
compiled on threads at once, without XLA's backend optimizations, in one
module fixture.
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

GRAPHS = ("zoo-tconv", "zoo-asf")
# the full-width graphs' parameters (the JAX package's parse gives the same)
PARAMS = {"zoo-tconv": 68_137_621, "zoo-asf": 75_781_341}
# leaves of each graph's new blocks whose gradient the train step carries (not 0)
GRAD_LEAVES = {"zoo-tconv": ("layers_19/conv/kernel", "layers_23/conv/bias", "layers_27/kernel", "layers_21/m/kernel",
                             "layers_25/attn/m/kernel", "layers_22/blk0/layer_scale_1", "layers_29/fc1/conv/kernel",
                             "layers_15/spatial_attention/cv1/conv/kernel", "layers_17/dw_bn/scale",
                             "layers_10/bn/scale"),
               "zoo-asf": ("layers_15/upsample/conv/kernel", "layers_19/upsample/conv/kernel",
                           "layers_15/cv_out/cv/conv/kernel", "layers_16/w", "layers_28/w", "layers_30/conv3d/kernel",
                           "layers_31/ca_conv/kernel", "layers_31/la_fw/conv/kernel",
                           "layers_14/fusion_4/cv/conv/kernel", "layers_23/conv2/conv/kernel",
                           "layers_19/downsample/cv/conv/kernel")}


def small(name: str) -> dict:
    cfg = zoo_graph(name)
    cfg["width_multiple"], cfg["depth_multiple"] = WIDTH, DEPTH
    return cfg


@pytest.fixture(scope="module")
def jax_side():
    """name -> (JAX meta, spread variables, port model, port meta, the
    flax model's raw maps of X, and the unspread variables with JAX's loss,
    loss items, BatchNorm statistics and gradients of one train-mode step
    of the small graph through ComputeLoss (hyp.visdrone)): the four
    programs compiled on threads at once."""
    hyp = load_hyp(find_config("hyp.visdrone", "hyps"))
    xb, t = batches()[0], targets_batch()
    x = jnp.asarray(X)
    built, lowered, args = {}, {}, {}
    for name in GRAPHS:
        jmodel, jmeta, variables = jax_random_model(small(name))
        spread_v = spread(variables)
        pmodel, pmeta = build_model(small(name), nc=NC, device="cpu")
        assert load_jax_variables(pmodel, spread_v) == ([], [])
        jloss = jax_losses.ComputeLoss(jmeta, hyp)

        def loss_of(params, jmodel=jmodel, jloss=jloss, stats=variables["batch_stats"]):
            preds, mutated = jmodel.apply({"params": params, "batch_stats": stats}, xb, train=True,
                                          mutable=["batch_stats"])
            loss, comps = jloss(preds, t)
            return loss, (comps, mutated["batch_stats"])

        built[name] = (jmeta, spread_v, pmodel, pmeta, variables)
        lowered[(name, "raw")] = jax.jit(lambda v, t, m=jmodel: m.apply(v, t, False)).lower(spread_v, x)
        args[(name, "raw")] = (spread_v, x)
        lowered[(name, "step")] = jax.jit(jax.value_and_grad(loss_of, has_aux=True)).lower(variables["params"])
        args[(name, "step")] = (variables["params"],)
    with ThreadPoolExecutor(len(lowered)) as pool:
        futures = {k: pool.submit(low.compile, {"xla_backend_optimization_level": 0}) for k, low in lowered.items()}
        out = {k: jax.device_get(f.result()(*args[k])) for k, f in futures.items()}
    return {n: (*built[n][:4], out[(n, "raw")], (built[n][4], *out[(n, "step")])) for n in GRAPHS}


@pytest.mark.parametrize("name", GRAPHS)
def test_full_width_graph_matches_jax_and_keeps_the_odconv_sites(name):
    """At full width (meta device): specs (i, f, n, name, c2, stride; the
    transposed convs' stride / 2, BiFusion's and SF's at their second
    input, BiFPNSDI's at its coarsest, the unscaled c2 of BiFusion, BiFPNs,
    BiFPNSDI and ScalSeq), strides, save list and head rows equal JAX's
    parse, nc 10, the parameter count, and the four ODConv sites that
    odconv_s2 computes, with the flagship's shapes."""
    cfg = zoo_graph(name)
    _, jmeta, _ = jax_parse_model(cfg)
    with torch.device("meta"):
        modules, pmeta = parse_model(cfg)
    assert specs(pmeta) == specs(jmeta)
    assert pmeta.nc == 10 and pmeta.nl == 4 and pmeta.strides == (4.0, 8.0, 16.0, 32.0)
    assert sum(p.numel() for m in modules for p in m.parameters()) == PARAMS[name]
    assert odconv_sites(modules) == odconv_sites(FLAGSHIP) == [(64, 128), (256, 256), (256, 256), (512, 256)]


@pytest.mark.parametrize("name", GRAPHS)
def test_graph_raw_maps_and_decode_match_jax(jax_side, name):
    """Raw maps within atol 1e-4, rtol 1e-4; the decode within the family's
    tolerances (boxes atol 5e-3 / rtol 1e-3, scores 5e-4)."""
    jmeta, _, pmodel, pmeta, j_raw, _ = jax_side[name]
    with torch.no_grad():
        p_raw = pmodel(_nchw(X))
    assert len(p_raw) == len(j_raw) == 4
    for p, j in zip(p_raw, j_raw):
        assert tuple(p.shape) == j.shape
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-4, rtol=1e-4)
    j_dec = np.asarray(jax_decode([jnp.asarray(j) for j in j_raw], jmeta.anchors_px, jmeta.strides))
    p_dec = decode(p_raw, pmeta.anchors_px, pmeta.strides).numpy()
    assert p_dec.shape == j_dec.shape
    np.testing.assert_allclose(p_dec[..., :4], j_dec[..., :4], atol=5e-3, rtol=1e-3)
    np.testing.assert_allclose(p_dec[..., 4:], j_dec[..., 4:], atol=5e-4)


@pytest.mark.parametrize("name", GRAPHS)
def test_graph_weight_bridge_maps_every_leaf_both_ways(jax_side, name):
    """load_jax_variables used every flax leaf and filled every torch key
    (the fixture asserts it); export_jax_variables gives back the same
    tree paths, shapes and values (the transposed kernels flipped and
    regrouped back, the bare `m`, `w` and `ca_conv`, ScalSeq's Dense)."""
    _, variables, pmodel, _, _, _ = jax_side[name]
    back = flat(export_jax_variables(pmodel))
    want = flat(variables)
    assert sorted(back) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


@pytest.mark.parametrize("name", GRAPHS)
def test_graph_train_step_matches_jax_value_and_grad(jax_side, name):
    """One train-mode forward of the small graph, ComputeLoss (hyp.visdrone)
    and the gradient of every parameter against jax.value_and_grad, by
    test_torch_port_attention_zoo_graphs.py's rule for zoo-rfem: the loss
    and its items within 1e-5 relative; the port's float64 gradient of each
    leaf within 1e-4 of the leaf's largest element plus 3e-6 of the largest
    gradient of JAX's f32 one, and its float32 gradient within 1e-4 of its
    largest element plus 1e-6 of the largest gradient plus twice that
    float64 distance, at most 3e-6 of the largest gradient; the BatchNorm
    statistics the step moved within 1e-5 relative plus 1e-6. Among the
    leaves that carry a gradient (GRAD_LEAVES): the three transposed
    convs' kernels (flipped, biased, depthwise), ContextAggregation's `m`,
    Conv2Former's layer scale, the HS-FPN gate, C3CBAM's spatial gate,
    ConvMix's and the standalone BatchNorm's scales; BiFusion's and SF's
    transposed and strided convs, the `w` of BiFPNs / BiFPNSDI, ScalSeq's
    Dense, attention_model's 1-D conv and strip gate, CAM's adaptive
    weights, SDI's convs."""
    variables, (jl, (jcomps, jstats)), jgrads = jax_side[name][5]
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
