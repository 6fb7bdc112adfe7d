"""The rest of the JAX package's detection heads in the port, against the
JAX package on the CPU: each head module against flax in eval and train
mode (IAuxDetect's lead + aux maps, DetectV11's end2end dict, Segment's
(levels, proto), RT-DETR's query rows), decode_v8, postprocess_end2end
with a tie, assemble_masks, ODConv2d at the shapes its CUDA kernel does
not take, the graph compiler's ModelMeta and the weight bridge for every
head name of the JAX registry, the detection priors, and the Runner's
rows per head against the JAX Runner's.

The graphs are a small conv pyramid (strides 2-32, 1x1 convs beside the
P3-P5 maps for IAuxDetect's aux inputs) at width 0.25 / depth 0.33,
64 px, nc 3, ending in each head. Variables are the flax `eval_shape` tree
filled with seeded numpy draws (tests/_torch_port_common.py
`random_variables`); for the Runner cases `lively` rescales them so that
the maps keep their spread through the graph and the scores differ from
cell to cell (with the draws as they are every score lies within 1e-2 of
0.25 and NMS orders near-ties). The JAX Runner programs are compiled on threads at once,
without XLA's backend optimizations (the arithmetic is the same), as
tests/test_torch_port_train.py does. RT-DETR's Runner case swaps both
registries' RTDETRDecoder for one of 2 decoder layers and 4 heads (a
fifth of the JAX compile); the 6-layer, 8-head decoder of the YAML row is
held in the graph and bridge tests.
"""

import functools
import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from tests._torch_port_common import IMGSZ, NC, _to_dict, few_threads, random_variables  # noqa: F401
from tests.test_torch_port_checkpoint import flat
from tests.test_torch_port_family import specs
from yolosomi_tpu.engine import checkpoint as jax_ckpt
from yolosomi_tpu.engine import runner as jax_runner_mod
from yolosomi_tpu.models import heads as jheads
from yolosomi_tpu.models import layers as jlayers
from yolosomi_tpu.models import rtdetr as jrtdetr
from yolosomi_tpu.models import yolo as jyolo
from yolosomi_tpu_torch.engine.runner import Runner
from yolosomi_tpu_torch.models import heads, layers, rtdetr
from yolosomi_tpu_torch.models import yolo as pyolo
from yolosomi_tpu_torch.ops.odconv import odconv_s2_reference
from yolosomi_tpu_torch.utils.weights import export_jax_variables, load_jax_variables

ANCHORS = [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119], [116, 90, 156, 198, 373, 326]]
GRID = ["nc", "anchors"]
# every head name of the JAX registry (yolo.py:151-167) -> (input rows, args)
HEADS = {
    "Detect": ([2, 3, 4], GRID),
    "DecoupledDetect": ([2, 3, 4], GRID),
    "DecoupledDetect1": ([2, 3, 4], GRID),
    "Decoupled_Detect": ([2, 3, 4], GRID),
    "DetectODConv": ([2, 3, 4], GRID),
    "IDetect": ([2, 3, 4], GRID),
    "IAuxDetect": ([2, 3, 4, 5, 6, 7], GRID),
    "ASFF_Detect": ([2, 3, 4], GRID),
    "CLLADetect": ([1, 2, 3, 4], GRID),
    "TSCODE_Detect": ([1, 2, 3, 4], GRID),  # levels P3, P4 between a finer and a coarser map
    "Segment": ([2, 3, 4], GRID + [8, 64]),
    "DetectYOLOv8": ([2, 3, 4], ["nc"]),
    "DetectYOLO8Head": ([2, 3, 4], ["nc"]),
    "DetectV8": ([2, 3, 4], ["nc"]),
    "DetectYolov11": ([2, 3, 4], ["nc"]),
    "DetectV11": ([2, 3, 4], ["nc"]),
    "RTDETRDecoder": ([2, 3, 4], ["nc", 256, 20]),
}
# one name per head class: the Runner and prior cases
DISTINCT = ("IDetect", "IAuxDetect", "ASFF_Detect", "CLLADetect", "TSCODE_Detect", "DetectODConv", "Segment",
            "DetectV8", "DetectV11", "RTDETRDecoder")
SMALL_RTDETR = dict(nh=4, ndl=2, d_ffn=64)


def head_cfg(name: str) -> dict:
    f, args = HEADS[name]
    return {
        "nc": NC, "depth_multiple": 0.33, "width_multiple": 0.25,
        "anchors": ANCHORS[:2] if name == "TSCODE_Detect" else ANCHORS,
        "backbone": [[-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [64, 3, 2]], [-1, 1, "Conv", [128, 3, 2]],
                     [-1, 1, "Conv", [256, 3, 2]], [-1, 1, "Conv", [512, 3, 2]]],
        "head": [[2, 1, "Conv", [128, 1, 1]], [3, 1, "Conv", [256, 1, 1]], [4, 1, "Conv", [512, 1, 1]],
                 [f, 1, name, args]],
    }


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def jax_variables(model, inputs, seed: int, **kw) -> dict:
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), inputs, False, **kw))
    return _to_dict(random_variables(shapes, seed))


def lively(tree: dict, parent: str = "") -> dict:
    """Params drawn by random_variables with conv and Dense kernels (and
    ODConv banks) rescaled to He's std sqrt(2 / fan_in), norm scales and
    ImplicitM's factors about 1 instead of 0."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = lively(v, k)
        elif (k == "kernel" and v.ndim >= 2) or (k == "weight" and v.ndim == 5):
            fan = math.prod(v.shape[1:-1] if v.ndim == 5 else v.shape[:-1])
            out[k] = (v / np.float32(0.1) * np.float32(math.sqrt(2.0 / fan))).astype(np.float32)
        elif k == "scale" or (k == "implicit" and parent.startswith("im")):
            out[k] = (1.0 + v).astype(np.float32)
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# the head modules against flax
# ---------------------------------------------------------------------------

A3 = tuple(tuple(a) for a in ANCHORS)
# (hw, channels) of the maps: a finer P2, the three levels, IAuxDetect's aux maps
P2, LEVELS, AUX = (16, 8), [(8, 16), (4, 24), (2, 32)], [(8, 12), (4, 16), (2, 20)]
# name -> (flax module, port module, input maps)
MODULES = {
    "IDetect": (lambda: jheads.IDetect(NC, A3), lambda ch: heads.IDetect(NC, 3, ch), LEVELS),
    "IAuxDetect": (lambda: jheads.IAuxDetect(NC, A3), lambda ch: heads.IAuxDetect(NC, 3, ch), LEVELS + AUX),
    "ASFF_Detect": (lambda: jheads.ASFFDetect(NC, A3), lambda ch: heads.ASFFDetect(NC, 3, ch), LEVELS),
    "CLLADetect": (lambda: jheads.CLLADetect(NC, A3), lambda ch: heads.CLLADetect(NC, 3, ch), [P2] + LEVELS),
    "TSCODE_Detect": (lambda: jheads.TSCODEDetect(NC, A3[:2]), lambda ch: heads.TSCODEDetect(NC, 3, ch),
                      [P2] + LEVELS),
    "DetectODConv": (lambda: jheads.DetectODConvHead(NC, A3), lambda ch: heads.DetectODConvHead(NC, 3, ch), LEVELS),
    "Segment": (lambda: jheads.Segment(NC, A3, nm=8, npr=16), lambda ch: heads.Segment(NC, 3, ch, 8, 16), LEVELS),
    "DetectV8": (lambda: jheads.DetectV8(NC), lambda ch: heads.DetectV8(NC, ch), LEVELS),
    "DetectV8_nc_wide": (lambda: jheads.DetectV8(40), lambda ch: heads.DetectV8(40, ch), LEVELS),  # c3 = nc
    "DetectV11": (lambda: jheads.DetectV11(NC), lambda ch: heads.DetectV11(NC, ch), LEVELS),
    "DetectV11_end2end": (lambda: jheads.DetectV11(NC, end2end=True),
                          lambda ch: heads.DetectV11(NC, ch, end2end=True), LEVELS),
    "RTDETRDecoder": (lambda: jrtdetr.RTDETRDecoder(nc=NC, hd=32, nq=40, **SMALL_RTDETR),
                      lambda ch: rtdetr.RTDETRDecoder(NC, ch, hd=32, nq=40, **SMALL_RTDETR), LEVELS),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(MODULES))
def test_head_module_matches_flax(name, train):
    """Every output leaf within atol 1e-4, rtol 1e-4 (f32), in train mode
    also the BatchNorm statistics the forward moved; the train-mode
    outputs' structure is flax's (IAuxDetect: 6 maps, DetectV11 end2end: a
    dict; Segment: (levels, proto))."""
    jfn, pfn, ins = MODULES[name]
    rng = np.random.default_rng(sorted(MODULES).index(name))
    xs = [rng.standard_normal((2, hw, hw, c)).astype(np.float32) for hw, c in ins]
    jmod = jfn()
    variables = jax_variables(jmod, xs, 1)
    if train:
        ref, mutated = jax.jit(lambda v, t: jmod.apply(v, t, True, mutable=["batch_stats"]))(variables, xs)
    else:
        ref = jax.jit(lambda v, t: jmod.apply(v, t, False))(variables, xs)
    pmod = pfn([c for _, c in ins])
    assert load_jax_variables(pmod, variables) == ([], [])
    pmod.train(train)
    with torch.no_grad():
        got = pmod([_nchw(x) for x in xs])
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, ref)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: t.numpy(), got))
    for g, r in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=1e-4)
    if train and "batch_stats" in variables:  # flax's moved statistics, loaded into a twin, against the port's
        want = pfn([c for _, c in ins])
        load_jax_variables(want, {"params": variables["params"], "batch_stats": jax.device_get(mutated["batch_stats"])})
        want = want.state_dict()
        for k, v in pmod.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (3, 1, 1, 1), (3, 1, 2, 2), (3, 2, 1, 1)],
                         ids=["k1s1", "k3s1", "k3s1g1d2", "k3s2"])
def test_odconv2d_at_other_shapes_matches_jax_vmap(shape, monkeypatch):
    """ODConv2d (k, s, g, d) against the JAX module's vmap conv, eval and
    train: 1x1 s1 (DetectODConv), 3x3 s1 and a dilated 3x3 through the
    batch-grouped conv, and 3x3 s2, the shape odconv_s2 computes, through
    per_sample_conv (its plain version here), the others never."""
    k, s, g, d = shape
    calls = []

    def counted(x, w):
        calls.append(1)
        return odconv_s2_reference(x, w)

    monkeypatch.setattr(layers, "per_sample_conv", counted)
    x = np.random.default_rng(k + s + d).standard_normal((2, 8, 8, 16)).astype(np.float32)
    jmod = jlayers.ODConv2d(24, k, s, g=g, d=d)
    variables = jax_variables(jmod, x, 2)
    for train in (False, True):
        ref = jax.jit(lambda v, t: jmod.apply(v, t, train, mutable=["batch_stats"])[0])(variables, x)
        pmod = layers.ODConv2d(16, 24, k, s, g=g, d=d)
        assert load_jax_variables(pmod, variables) == ([], [])
        pmod.train(train)
        with torch.no_grad():
            got = pmod(_nchw(x)).permute(0, 2, 3, 1).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4, rtol=1e-4)
    assert len(calls) == (2 if (k, s) == (3, 2) else 0)


# ---------------------------------------------------------------------------
# the decodes
# ---------------------------------------------------------------------------


def test_decode_v8_matches_jax():
    rng = np.random.default_rng(3)
    preds = [(rng.standard_normal((2, hw, hw, 64 + NC)) * 2).astype(np.float32) for hw in (8, 4, 2)]
    ref = np.asarray(jax.jit(lambda p: jheads.decode_v8(p, (8, 16, 32), NC))([jnp.asarray(p) for p in preds]))
    got = heads.decode_v8([torch.from_numpy(p) for p in preds], (8.0, 16.0, 32.0), NC).numpy()
    assert got.shape == ref.shape == (2, 84, 5 + NC)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


def test_postprocess_end2end_keeps_jax_top_k_order_among_ties():
    """Equal best scores (rows 1, 4, 7 at 0.9; rows 2 and 5 at 0.8) and
    equal class scores within a row: jax.lax.top_k puts the lower index
    first, and so must the port, bit for bit."""
    rng = np.random.default_rng(4)
    rows = rng.random((2, 12, 4 + NC)).astype(np.float32) * 0.5
    rows[0, [1, 4, 7], 4] = 0.9
    rows[0, [2, 5], 6] = 0.8
    rows[0, 5, 4:] = 0.8  # every class of row 5 ties
    rows[1, :, 4:] = 0.3  # every score of image 1 ties
    for max_det in (5, 12, 20):
        ref = np.asarray(jheads.postprocess_end2end(jnp.asarray(rows), max_det, NC))
        got = heads.postprocess_end2end(torch.from_numpy(rows), max_det, NC).numpy()
        np.testing.assert_array_equal(got, ref)


def test_assemble_masks_matches_jax():
    rng = np.random.default_rng(5)
    proto = rng.standard_normal((16, 20, 8)).astype(np.float32)
    coeffs = rng.standard_normal((5, 8)).astype(np.float32)
    boxes = np.array([[0, 0, 20, 16], [2.5, 3, 7, 9.5], [10, 4, 10, 8], [-3, -2, 5, 4], [15, 12, 30, 30]], np.float32)
    ref = np.asarray(jheads.assemble_masks(jnp.asarray(proto), jnp.asarray(coeffs), jnp.asarray(boxes)))
    got = heads.assemble_masks(torch.from_numpy(proto), torch.from_numpy(coeffs), torch.from_numpy(boxes)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


# ---------------------------------------------------------------------------
# the graph compiler, the bridge and the priors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(HEADS))
def test_graph_meta_and_bridge_match_jax(name):
    """parse_model's specs, strides, save list, head rows, nl, na,
    head_type, anchors and nc equal JAX's for a graph ending in every
    head name; load_jax_variables leaves no torch key unmatched and no
    flax leaf unused, and export_jax_variables gives back the same tree."""
    cfg = head_cfg(name)
    jmodel, jmeta = jyolo.build_model(cfg)
    pmodel, pmeta = pyolo.build_model(cfg, device="cpu")
    assert specs(pmeta) == specs(jmeta)
    np.testing.assert_array_equal(pmeta.anchors_px, jmeta.anchors_px)
    assert (pmeta.nc, pmeta.names, pmeta.head_type) == (jmeta.nc, jmeta.names, name)
    variables = jax_variables(jmodel, jnp.zeros((1, IMGSZ, IMGSZ, 3)), 0)
    assert load_jax_variables(pmodel, variables) == ([], [])
    back = export_jax_variables(pmodel)
    assert sorted(flat(back)) == sorted(flat(variables))
    for key, value in flat(variables).items():
        np.testing.assert_array_equal(flat(back)[key], value, err_msg=key)


@pytest.mark.parametrize("name", ["IAuxDetect", "CLLADetect", "Segment"])
def test_detection_priors_sit_where_init_model_puts_them(name):
    """Every bias of the head after the port's seed init equals the JAX
    init_model's (zero, plus the objectness and class priors on level i's
    `m<i>` conv, none on IAuxDetect's aux convs; a CLLADetect's m<i> is
    level i + 1's, and it gets level i's prior; Segment's mask
    coefficients none)."""
    cfg = head_cfg(name)
    jmodel, jmeta = jyolo.build_model(cfg)
    jvars = jyolo.init_model(jmodel, jmeta, imgsz=IMGSZ)
    pmodel, _ = pyolo.build_model(cfg, device="cpu")
    head = f"layers_{len(pmodel.model) - 1}/"
    got = flat(export_jax_variables(pmodel)["params"])
    want = {k: np.asarray(v) for k, v in flat(jax.device_get(jvars["params"])).items()
            if k.startswith(head) and k.endswith("/bias")}
    assert want
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# the Runner
# ---------------------------------------------------------------------------

ROW_KW = dict(conf_thres=0.01, max_det=100)
RUNNER_CASES = [(name, False) for name in DISTINCT] + [("DetectV8", True)]


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    """(name, augment) -> (port rows, JAX rows, weights file) of each
    head's graph, both Runners f32 on one weights file the JAX package
    wrote (`lively` random variables) and one uint8 batch; nc given to both
    (the JAX Runner's _infer_nc reads Segment's nc + nm from its conv)."""
    d = tmp_path_factory.mktemp("heads")
    images = np.random.default_rng(6).integers(0, 256, (2, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    jlazy = (lambda **kw: jrtdetr.RTDETRDecoder(**SMALL_RTDETR, **kw), "head_rtdetr")
    plazy = (functools.partial(rtdetr.RTDETRDecoder, **SMALL_RTDETR), "head_rtdetr")
    jobs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jyolo._REGISTRY, "RTDETRDecoder", jlazy)
        mp.setitem(pyolo._REGISTRY, "RTDETRDecoder", plazy)
        for name, augment in RUNNER_CASES:
            cfg_path, weights = d / f"{name}.yaml", d / f"{name}.msgpack"
            cfg_path.write_text(yaml.safe_dump(head_cfg(name)))
            if not weights.exists():
                jmodel, _ = jyolo.build_model(head_cfg(name))
                variables = jax_variables(jmodel, jnp.zeros((1, IMGSZ, IMGSZ, 3)), 7)
                jax_ckpt.save_variables(str(weights), {"params": lively(variables["params"]),
                                                       "batch_stats": variables["batch_stats"]})
            jr = jax_runner_mod.Runner(str(cfg_path), str(weights), nc=NC, dtype=jnp.float32, imgsz=IMGSZ)
            pr = Runner(str(cfg_path), str(weights), nc=NC, dtype=torch.float32, imgsz=IMGSZ, device="cpu")
            jobs[name, augment] = (jr, pr, weights)
    lowered = {key: jr.infer_fn(augment=key[1], **ROW_KW).lower(jr.variables, jnp.asarray(images))
               for key, (jr, _, _) in jobs.items()}
    with ThreadPoolExecutor(4) as pool:
        futures = {key: pool.submit(low.compile, {"xla_backend_optimization_level": 0})
                   for key, low in lowered.items()}
        compiled = {key: f.result() for key, f in futures.items()}
    return {key: (pr(images, augment=key[1], **ROW_KW), np.asarray(compiled[key](jr.variables, jnp.asarray(images))),
                  weights) for key, (jr, pr, weights) in jobs.items()}


@pytest.mark.parametrize("name,augment", RUNNER_CASES, ids=[n + ("-augment" if a else "") for n, a in RUNNER_CASES])
def test_runner_rows_match_the_jax_runner(runners, name, augment):
    """(B, max_det, 6) rows: the same kept rows in the same order, equal
    classes, boxes within atol 5e-3 / rtol 1e-3, scores within 5e-4
    (test_torch_port_zoo.py's decode tolerances). The fused postprocess
    serves DetectODConv only; RTDETRDecoder's rows are NMS-free."""
    got, ref, _ = runners[name, augment]
    assert got.shape == ref.shape == (2, ROW_KW["max_det"], 6)
    for b in range(2):
        gv, rv = got[b][got[b][:, 4] > 0], ref[b][ref[b][:, 4] > 0]
        assert len(gv) == len(rv) > 0, (b, len(gv), len(rv))
        np.testing.assert_array_equal(gv[:, 5], rv[:, 5])
        np.testing.assert_allclose(gv[:, :4], rv[:, :4], atol=5e-3, rtol=1e-3)
        np.testing.assert_allclose(gv[:, 4], rv[:, 4], atol=5e-4)
        np.testing.assert_array_equal(got[b][got[b][:, 4] <= 0], 0)


def test_segment_weights_give_nc_without_the_mask_coefficients(runners, tmp_path):
    """A Segment weights file under a config that says nc 10: the port's
    Runner reads nc 3 from the head's conv less its Proto's nm (the JAX
    Runner's _infer_nc counts the 8 coefficients as classes and then
    cannot load its own file)."""
    cfg = dict(head_cfg("Segment"), nc=10)
    path = tmp_path / "segment-nc10.yaml"
    path.write_text(yaml.safe_dump(cfg))
    runner = Runner(str(path), str(runners["Segment", False][2]), dtype=torch.float32, device="cpu")
    assert runner.meta.nc == NC


@pytest.mark.parametrize("name", DISTINCT)
def test_new_heads_refuse_spatial_sharding_naming_item_6(name, tmp_path):
    path = tmp_path / "h.yaml"
    path.write_text(yaml.safe_dump(head_cfg(name)))
    with pytest.raises(NotImplementedError, match="item 6"):
        Runner(str(path), dtype=torch.float32, device="cpu", spatial_shards=2)
