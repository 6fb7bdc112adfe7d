"""layers_zoo.py's fusion kinds in the port, the JAX registry's last 23
names (the transposed convs ConvTranspose / nn.ConvTranspose2d /
DWConvTranspose2d, nn.BatchNorm2d, Add / Multiply / CShortcut,
ContextAggregation / PSContextAggregation, ChannelAttention_HSFPN, CAM,
SimAMWithSlicing / SimAMWithFlexibleSlicing, C3CBAM, ConvMix, Conv2Former,
SDI, BiFPNSDI, BiFPNs, BiFusion, SF, ScalSeq, attention_model), against the
JAX package on the CPU: each name as one row of
test_torch_port_body_zoo.py's small conv pyramid (width 0.25, 64 px: the
row reads the 8x8 map of 32 channels, a fusion the 16x16, 8x8 and 4x4
maps): the graph compiler's specs against JAX's parse, the weight bridge
both ways, the graph's output against flax in eval and in train mode with
the BatchNorm statistics the forward moved; then the blocks alone where a
row cannot reach a case: the transposed convs at paddings past the kernel
and output paddings past the stride, CAM's three fusions on an odd map,
SDI and BiFPNSDI at whole and fractional ratios (JAX's antialiased
linear resize), ScalSeq at a fractional ratio, SimAMWithSlicing on an odd
map, ContextAggregation with a non-zero `m`; the gradients of six new
blocks and of five older ones (SKAttention, SwinTransformerBlock, MHSA,
CARAFE, DySample) against jax.grad; the port's registry against JAX's;
the refusals on a strip and the Runner's refusal to shard.

Variables are the flax `eval_shape` tree filled with seeded numpy draws
rescaled by test_torch_port_heads.py's `lively`, as
test_torch_port_body_zoo.py draws them. Every JAX program of the module
is compiled once, on threads at once, without XLA's backend
optimizations (one module fixture, `jax_side`).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from tests._torch_port_common import _to_dict, few_threads, random_variables  # noqa: F401
from tests.test_torch_port_body_zoo import BASE, _nchw, row_cfg
from tests.test_torch_port_checkpoint import flat
from tests.test_torch_port_family import specs
from tests.test_torch_port_heads import lively
from yolosomi_tpu.models import layers as jlayers
from yolosomi_tpu.models import layers_zoo as jzoo
from yolosomi_tpu.models import yolo as jyolo
from yolosomi_tpu_torch.engine.runner import Runner
from yolosomi_tpu_torch.models import layers
from yolosomi_tpu_torch.models import layers_zoo as zoo
from yolosomi_tpu_torch.models import yolo as pyolo
from yolosomi_tpu_torch.parallel.spatial import spatial
from yolosomi_tpu_torch.utils.weights import export_jax_variables, export_param_tree, load_jax_variables

IMGSZ = 64
# id -> the row under test (BASE: row 1 16x16, rows 2 and 4 8x8, row 3 4x4, 32 channels each; -1 is row 4)
ROWS = {
    "ConvTranspose": [-1, 1, "ConvTranspose", [128, 2, 2]],
    "ConvTranspose_k3_p1": [-1, 1, "ConvTranspose", [128, 3, 2, 1]],  # 8 -> 15
    "nn.ConvTranspose2d": [-1, 1, "nn.ConvTranspose2d", [128, 2, 2]],
    "nn.ConvTranspose2d_k3_s1": [-1, 1, "nn.ConvTranspose2d", [256, 3, 1, 1]],
    "DWConvTranspose2d": [-1, 1, "DWConvTranspose2d", [128, 2, 2]],  # depthwise: g 32
    "DWConvTranspose2d_g16_p1_p2": [-1, 1, "DWConvTranspose2d", [192, 3, 2, 1, 1]],  # 32 -> 48, g 16: 8 -> 16
    "nn.BatchNorm2d": [-1, 1, "nn.BatchNorm2d", []],
    "Add": [[-1, 2], 1, "Add", []],
    "Add_3": [[-1, 2, 2], 1, "Add", []],
    "Multiply": [[-1, 2, 2], 1, "Multiply", []],  # reads the first two only
    "CShortcut": [[-1, 2], 1, "CShortcut", []],
    "ContextAggregation": [-1, 1, "ContextAggregation", []],
    "PSContextAggregation": [-1, 1, "PSContextAggregation", []],
    "ChannelAttention_HSFPN": [-1, 1, "ChannelAttention_HSFPN", [4]],
    "ChannelAttention_HSFPN_gate": [-1, 1, "ChannelAttention_HSFPN", [8, False]],  # the (B, C, 1, 1) gate
    "CAM": [-1, 1, "CAM", []],
    "CAM_adaptive": [-1, 1, "CAM", ["adaptive"]],
    "CAM_concat": [-1, 1, "CAM", ["concat"]],  # 3 c1 channels
    "SimAMWithSlicing": [-1, 1, "SimAMWithSlicing", [256]],
    "SimAMWithFlexibleSlicing": [-1, 1, "SimAMWithFlexibleSlicing", [256, 4]],
    "SimAMWithFlexibleSlicing_overlap": [-1, 1, "SimAMWithFlexibleSlicing", [256, 4, 0.5]],
    "C3CBAM": [-1, 1, "C3CBAM", [256]],
    "ConvMix": [-1, 1, "ConvMix", [256]],
    "ConvMix_k5": [-1, 1, "ConvMix", [256, 5]],
    "Conv2Former": [-1, 2, "Conv2Former", [256]],  # two blocks of MLP width 64
    "SDI": [[-1, 1, 3], 1, "SDI", []],  # 16x16 pooled, 4x4 grown with aligned corners, to 8x8
    "BiFPNSDI": [[-1, 1, 3], 1, "BiFPNSDI", [256]],  # at 4x4, stride 16; c2 unscaled
    "BiFPNs": [[-1, 2], 1, "BiFPNs", [256, 256]],
    "BiFusion": [[3, -1, 1], 1, "BiFusion", [0, 0, 0, 128]],  # [coarse, mid, fine] -> 8x8
    "SF": [[3, -1, 1], 1, "SF", []],  # 96 channels
    "ScalSeq": [[1, -1, 3], 1, "ScalSeq", [32]],  # at 16x16: P3 carries c2's 32 channels
    "attention_model": [[-1, 2], 1, "attention_model", []],
    # repeated rows (JAX's _Repeat)
    "ContextAggregation_x2": [-1, 2, "ContextAggregation", []],
    "ConvTranspose_x2": [-1, 2, "ConvTranspose", [128, 2, 2]],
}
NAMES = sorted({r[2] for r in ROWS.values()})

# name -> (flax module, port module, the inputs' (h, w, channels)); one shape is one input, not a list
BLOCKS = {
    "ConvTranspose_k2_p2": (lambda: jzoo.ConvTransposeLayer(24, 2, 2, 2),  # padding past k - 1: 7 -> 10
                            lambda: zoo.ConvTransposeLayer(16, 24, 2, 2, 2), [(7, 5, 16)]),
    "ConvTranspose2dRaw_k3_s2": (lambda: jzoo.ConvTranspose2dRaw(8, 3, 2, 1),
                                 lambda: zoo.ConvTranspose2dRaw(16, 8, 3, 2, 1), [(7, 5, 16)]),
    "DWConvTranspose2d_k3_s2_p1_p1": (lambda: jzoo.DWConvTranspose2d(24, 3, 2, 1, 1),
                                      lambda: zoo.DWConvTranspose2d(16, 24, 3, 2, 1, 1), [(7, 5, 16)]),
    "DWConvTranspose2d_k2_s2_p0_p2": (lambda: jzoo.DWConvTranspose2d(16, 2, 2, 0, 2),  # p2 >= s: the dilated conv
                                      lambda: zoo.DWConvTranspose2d(16, 16, 2, 2, 0, 2), [(7, 5, 16)]),
    "DWConvTranspose2d_k3_s1_p1_p1": (lambda: jzoo.DWConvTranspose2d(12, 3, 1, 1, 1),
                                      lambda: zoo.DWConvTranspose2d(16, 12, 3, 1, 1, 1), [(7, 5, 16)]),
    "DWConvTranspose2d_k2_s2_p2_p1": (lambda: jzoo.DWConvTranspose2d(32, 2, 2, 2, 1),  # padding past k - 1
                                      lambda: zoo.DWConvTranspose2d(16, 32, 2, 2, 2, 1), [(7, 5, 16)]),
    "CAM_weight_7x9": (lambda: jzoo.CAM("weight"), lambda: zoo.CAM(16, "weight"), [(7, 9, 16)]),
    "CAM_adaptive_7x9": (lambda: jzoo.CAM("adaptive"), lambda: zoo.CAM(16, "adaptive"), [(7, 9, 16)]),
    "CAM_concat_7x9": (lambda: jzoo.CAM("concat"), lambda: zoo.CAM(16, "concat"), [(7, 9, 16)]),
    "SDI_whole": (lambda: jzoo.SDI(16), lambda: zoo.SDI([16, 8, 24], 16), [(6, 4, 16), (12, 8, 8), (3, 2, 24)]),
    "SDI_fractional": (lambda: jzoo.SDI(16), lambda: zoo.SDI([16, 8, 24], 16), [(6, 5, 16), (10, 9, 8), (4, 3, 24)]),
    "BiFPNSDI_whole": (lambda: jzoo.BiFPNSDI(16, 3), lambda: zoo.BiFPNSDI([16, 8, 24], 16),
                       [(8, 6, 16), (4, 3, 8), (16, 12, 24)]),
    "BiFPNSDI_fractional": (lambda: jzoo.BiFPNSDI(16, 3), lambda: zoo.BiFPNSDI([16, 8, 24], 16),
                            [(7, 6, 16), (4, 4, 8), (10, 9, 24)]),
    "ScalSeq_fractional": (lambda: jzoo.ScalSeq(16), lambda: zoo.ScalSeq([16, 8, 24], 16),
                           [(7, 5, 16), (3, 2, 8), (2, 2, 24)]),
    "SimAMWithSlicing_7x5": (lambda: jzoo.SimAMWithSlicing(), lambda: zoo.SimAMWithSlicing(16), [(7, 5, 16)]),
    "ContextAggregation_7x6": (lambda: jzoo.ContextAggregation(), lambda: zoo.ContextAggregation(16), [(7, 6, 16)]),
    "attention_model_5x7": (lambda: jzoo.AttentionModel(), lambda: zoo.AttentionModel([32, 32]),
                            [(5, 7, 32), (5, 7, 32)]),
    # the older blocks whose gradients the watch holds
    "SKAttention_8x8": (lambda: jlayers.SKAttention(), lambda: layers.SKAttention(32), [(8, 8, 32)]),
    "Swin_9x13_w4": (lambda: jlayers.SwinTransformerBlock(16, 2, 1, 4),
                     lambda: layers.SwinTransformerBlock(16, 16, 2, 1, 4), [(9, 13, 16)]),
    "MHSA_6x10": (lambda: jlayers.MHSA(4), lambda: layers.MHSA(32, 4, hw=(6, 10)), [(6, 10, 32)]),
    "CARAFE_6x7": (lambda: jlayers.CARAFE(), lambda: layers.CARAFE(16), [(6, 7, 16)]),
    "DySample_5x6": (lambda: jlayers.DySample(2, 4), lambda: layers.DySample(32, 2, 4), [(5, 6, 32)]),
}
GRAD_NEW = ["ContextAggregation_7x6", "ScalSeq_fractional", "attention_model_5x7", "BiFPNSDI_fractional",
            "DWConvTranspose2d_k3_s2_p1_p1", "DWConvTranspose2d_k2_s2_p0_p2", "SDI_fractional"]
GRAD_OLD = ["SKAttention_8x8", "Swin_9x13_w4", "MHSA_6x10", "CARAFE_6x7", "DySample_5x6"]


def _row_setup(name: str):
    cfg = row_cfg(ROWS[name])
    jmodel, jmeta = jyolo.build_model(cfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=False))
    variables = _to_dict(random_variables(shapes, sorted(ROWS).index(name)))
    variables = {"params": lively(variables["params"]), "batch_stats": variables["batch_stats"]}
    x = np.random.default_rng(sorted(ROWS).index(name)).standard_normal((2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    return cfg, jmodel, jmeta, variables, x


def _block_setup(name: str):
    jfn, _, shapes_in = BLOCKS[name]
    rng = np.random.default_rng(sorted(BLOCKS).index(name))
    xs = [rng.standard_normal((2, *s)).astype(np.float32) + np.linspace(-1.0, 1.0, s[2], dtype=np.float32)
          for s in shapes_in]  # channels that differ
    x = xs if len(xs) > 1 else xs[0]
    jmod = jfn()
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), x, False))
    variables = _to_dict(random_variables(shapes, 1))
    if "params" in variables:  # SimAMWithSlicing has none
        variables["params"] = lively(variables["params"])
    return jmod, variables, x


@pytest.fixture(scope="module")
def jax_side():
    """Every JAX result of the module: ("row", id, train) -> the flax row
    graph's output (and moved batch_stats in train mode); ("block", id) ->
    the block's eval output; ("grad", id) -> (the output's weights, the
    parameters' gradients of its weighted sum). The programs are compiled
    on threads at once; inputs and variables are in `setup`."""
    lowered, args, setup = {}, {}, {}
    for name in ROWS:
        cfg, jmodel, jmeta, variables, x = setup[("row", name)] = _row_setup(name)
        for train in (False, True):
            def fn(v, t, m=jmodel, train=train):
                return m.apply(v, t, True, mutable=["batch_stats"]) if train else m.apply(v, t, False)

            lowered[("row", name, train)] = jax.jit(fn).lower(variables, x)
            args[("row", name, train)] = (variables, x)
    for name in BLOCKS:
        jmod, variables, x = setup[("block", name)] = _block_setup(name)
        lowered[("block", name)] = jax.jit(lambda v, t, m=jmod: m.apply(v, t, False)).lower(variables, x)
        args[("block", name)] = (variables, x)
    for name in GRAD_NEW + GRAD_OLD:
        jmod, variables, x = setup[("block", name)]
        out_shape = jax.eval_shape(lambda v, t, m=jmod: m.apply(v, t, False), variables, x).shape
        wsum = np.random.default_rng(3).standard_normal(out_shape).astype(np.float32)

        def loss(params, m=jmod, variables=variables, x=x, wsum=wsum):
            return (m.apply({**variables, "params": params}, x, False) * wsum).sum()

        lowered[("grad", name)] = jax.jit(jax.grad(loss)).lower(variables["params"])
        args[("grad", name)] = (variables["params"],)
        setup[("wsum", name)] = wsum
    with ThreadPoolExecutor(8) as pool:
        futures = {k: pool.submit(low.compile, {"xla_backend_optimization_level": 0}) for k, low in lowered.items()}
        results = {k: jax.device_get(f.result()(*args[k])) for k, f in futures.items()}
    for name in GRAD_NEW + GRAD_OLD:
        results[("grad", name)] = (setup[("wsum", name)], results[("grad", name)])
    return results, setup


def test_every_fusion_zoo_name_is_a_row_here():
    """The 23 names each stand in ROWS, in the port's registry and in
    STRIPLESS."""
    assert len(NAMES) == 23
    assert set(NAMES) <= set(pyolo._REGISTRY) and set(NAMES) <= pyolo.STRIPLESS


def test_the_ports_registry_is_the_jax_registry():
    """Every one of the JAX registry's 169 names parses in the port, and the
    port has no name of its own."""
    assert len(jyolo._REGISTRY) == 169
    assert sorted(pyolo._REGISTRY) == sorted(jyolo._REGISTRY)


@pytest.mark.parametrize("name", sorted(ROWS))
def test_row_specs_and_bridge_match_jax(jax_side, name):
    """specs (i, f, n, name, c2, stride; the transposed convs' stride / s,
    BiFPNSDI's largest input stride, BiFusion's and SF's second input's,
    the unscaled c2 of BiFPNSDI, BiFPNs, BiFusion and ScalSeq, CAM's 3 c1
    under "concat") equal JAX's parse; load_jax_variables uses every flax
    leaf and fills every torch key (the transposed kernels, flipped or
    regrouped, ContextAggregation's bare `m`, the `w` of BiFPNSDI / BiFPNs,
    ScalSeq's Dense, the 1-D `ca_conv`, CAM's fusion_<i>, the blk<i> of
    Conv2Former, conv<i>, mods_<i>); export_jax_variables gives back the
    same tree, bit for bit."""
    cfg, _, jmeta, variables, _ = jax_side[1][("row", name)]
    pmodel, pmeta = pyolo.build_model(cfg, device="cpu")
    assert specs(pmeta) == specs(jmeta)
    assert load_jax_variables(pmodel, variables) == ([], [])
    back = flat(export_jax_variables(pmodel))
    want = flat(variables)
    assert sorted(back) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(ROWS))
def test_row_matches_flax(jax_side, name, train):
    """The graph's output within atol 1e-4, rtol 1e-4 (f32); in train mode
    also every BatchNorm statistic the forward moved within rtol 1e-5,
    atol 1e-6 (ScalSeq's one BatchNorm over its three scales among them)."""
    results, setup = jax_side
    cfg, _, _, variables, x = setup[("row", name)]
    out = results[("row", name, train)]
    ref, moved = out if train else (out, None)
    pmodel, _ = pyolo.build_model(cfg, device="cpu")
    assert load_jax_variables(pmodel, variables) == ([], [])
    pmodel.train(train)
    with torch.no_grad():
        got = pmodel(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4, rtol=1e-4)
    if train:
        stats = flat(export_jax_variables(pmodel)["batch_stats"])
        want = flat(moved["batch_stats"])
        assert sorted(stats) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(stats[k], w, rtol=1e-5, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# the blocks alone
# ---------------------------------------------------------------------------


def _port_block(name: str, variables: dict) -> torch.nn.Module:
    pmod = BLOCKS[name][1]()
    assert load_jax_variables(pmod, variables) == ([], [])
    return pmod.eval()


def _port_in(x):
    return [_nchw(t) for t in x] if isinstance(x, list) else _nchw(x)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_flax(jax_side, name):
    """Eval output within atol 1e-4, rtol 1e-4: ConvTransposeLayer with a
    padding past its kernel (the JAX conv's negative pad), the bare
    transposed conv at k 3 stride 2; DWConvTranspose2d at odd sizes with
    p1 and p2, where p2 >= s (torch's output_padding refuses it: the port
    convolves the dilated input, as JAX does) and p1 > k - 1; CAM's three
    fusions with its dilations reaching past a 7x9 map; SDI and BiFPNSDI
    at whole ratios (the average pool) and fractional ones (JAX's
    antialiased linear resize), growing with aligned corners; ScalSeq's
    nearest resize by 7 / 3 and 7 / 2 (half-pixel centres); SimAMWithSlicing
    on a 7x5 map (blocks of 3 and 4 rows, 2 and 3 columns);
    ContextAggregation with a non-zero `m`; attention_model on a
    non-square map; and the older blocks of the gradient watch."""
    results, setup = jax_side
    _, variables, x = setup[("block", name)]
    ref = np.asarray(results[("block", name)])
    pmod = _port_block(name, variables)
    with torch.no_grad():
        got = pmod(_port_in(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    if name == "ContextAggregation_7x6":
        assert np.abs(variables["params"]["m"]["kernel"]).max() > 0


def test_context_aggregations_m_starts_at_zero_and_bifpn_weights_at_flaxs_init():
    """init_weights keeps the JAX package's inits: ContextAggregation's bare
    `m` zero (so the block starts as the identity), BiFPNSDI's `w` ones,
    BiFPNs' `w` a normal(1.0) draw."""
    cfg = row_cfg([[-1, 1, 3], 1, "BiFPNSDI", [256]])
    cfg["backbone"][len(BASE) + 1:len(BASE) + 1] = [[-1, 1, "ContextAggregation", []], [[-1, 2], 1, "BiFPNs", [64]]]
    model, _ = pyolo.build_model(cfg, device="cpu")
    ca, bifpns = model.model[len(BASE) + 1], model.model[len(BASE) + 2]
    assert (ca.m.weight == 0).all() and (ca.m.bias == 0).all() and ca.a.weight.abs().max() > 0
    assert (model.model[len(BASE)].w == 1).all()
    assert bifpns.w.shape == (2,) and (bifpns.w != 1).all() and bifpns.w.abs().max() < 6
    x = torch.randn(1, 256, 4, 4)
    with torch.no_grad():
        np.testing.assert_array_equal(ca(x).numpy(), x.numpy())


def test_transposed_conv_kernels_are_flipped_where_flax_stores_them_unflipped():
    """A random 2x2 stride-2 kernel: flax's nn.ConvTranspose writes input
    pixel p's contribution w[a, b] to output 2 p + (1 - a, 1 - b), torch's
    to 2 p + (a, b); the bridge flips the kernel, so one pixel's response is
    the flax kernel mirrored, and the export flips it back."""
    w = np.random.default_rng(0).standard_normal((2, 2, 1, 1)).astype(np.float32)
    variables = {"params": {"conv": {"kernel": w, "bias": np.zeros(1, np.float32)}}, "batch_stats": {}}
    pmod = zoo.ConvTranspose2dRaw(1, 1, 2, 2)
    assert load_jax_variables(pmod, variables) == ([], [])
    x = torch.zeros(1, 1, 1, 1)
    x[0, 0, 0, 0] = 1.0
    with torch.no_grad():
        np.testing.assert_array_equal(pmod(x)[0, 0].numpy(), w[::-1, ::-1, 0, 0])
    np.testing.assert_array_equal(flat(export_jax_variables(pmod))["params/conv/kernel"], w)


def _grads_match(jax_side, name: str) -> None:
    results, setup = jax_side
    _, variables, x = setup[("block", name)]
    wsum, want = results[("grad", name)]
    want = flat(want)
    pmod = _port_block(name, variables)
    out = pmod(_port_in(x)).permute(0, 2, 3, 1)
    names, params = zip(*pmod.named_parameters())
    grads = torch.autograd.grad((out * torch.from_numpy(wsum)).sum(), params)
    got = flat(export_param_tree(pmod, list(names), list(grads)))
    assert sorted(got) == sorted(want)
    top = max(np.abs(w).max() for w in want.values())
    assert top > 0
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=1e-4 * np.abs(w).max() + 1e-6 * top, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", GRAD_NEW)
def test_block_gradients_match_jax_grad(jax_side, name):
    """Every parameter's gradient of the eval-mode output's weighted sum
    against jax.grad, within 1e-4 of each leaf's largest element plus 1e-6
    of the largest gradient: ContextAggregation's softmax pooling and bare
    `m`; ScalSeq's Dense over the scales, its nearest resize and the max
    over the scales; attention_model's 1-D ECA conv and its strips;
    BiFPNSDI's raw weights over their swish and the antialiased resize;
    DWConvTranspose2d's regrouped kernel through conv_transpose2d and
    through the dilated conv; SDI's product."""
    _grads_match(jax_side, name)


@pytest.mark.parametrize("name", GRAD_OLD)
def test_older_block_gradients_match_jax_grad(jax_side, name):
    """The same rule for older body-zoo blocks that were held to flax only
    in the forward pass: SKAttention's branch softmax, SwinTransformerBlock's
    relative-position bias table on a padded, shifted map, MHSA's rel_h /
    rel_w, CARAFE's reassembly kernels and DySample's offsets through its
    float32 gathers."""
    _grads_match(jax_side, name)


# one instance of each block that refuses a strip, 32 channels in, and its input's (h, w) (a list: several inputs)
STRIPLESS_BLOCKS = {
    "ConvTransposeLayer": (lambda: zoo.ConvTransposeLayer(32, 32), (8, 8)),
    "DWConvTranspose2d": (lambda: zoo.DWConvTranspose2d(32, 32, 2, 2), (8, 8)),
    "ContextAggregation": (lambda: zoo.ContextAggregation(32), (8, 8)),
    "ChannelAttentionHSFPN": (lambda: zoo.ChannelAttentionHSFPN(32), (8, 8)),
    "SimAMWithSlicing": (lambda: zoo.SimAMWithSlicing(), (8, 8)),
    "SDI": (lambda: zoo.SDI([32] * 3, 32), [(8, 8), (4, 4), (16, 16)]),
    "BiFPNSDI": (lambda: zoo.BiFPNSDI([32] * 3, 32), [(8, 8), (4, 4), (16, 16)]),
    "ScalSeq": (lambda: zoo.ScalSeq([32] * 3, 32), [(16, 16), (8, 8), (4, 4)]),
    "AttentionModel": (lambda: zoo.AttentionModel([32, 32]), [(8, 8), (8, 8)]),
    "SF": (lambda: zoo.SF([32] * 3), [(4, 4), (8, 8), (16, 16)]),
    "BiFusion": (lambda: zoo.BiFusion([32] * 3, 32), [(4, 4), (8, 8), (16, 16)]),
}


@pytest.mark.parametrize("block", sorted(STRIPLESS_BLOCKS))
def test_blocks_without_a_strip_path_refuse_a_strip(block):
    """Under spatial(strip) these blocks raise NotImplementedError naming
    item 6 rather than reduce over one strip, resize it as the map or
    transpose-convolve it without a halo (SF and BiFusion through their
    ConvTransposeLayer)."""
    make, hw = STRIPLESS_BLOCKS[block]
    inp = [torch.randn(2, 32, *s) for s in hw] if isinstance(hw, list) else torch.randn(2, 32, *hw)
    mod = make().eval()
    with torch.no_grad():
        mod(inp)  # unsharded it runs
        with spatial(object()), pytest.raises(NotImplementedError, match="item 6"):
            mod(inp)


@pytest.mark.parametrize("row", ["ConvTranspose", "Add", "CAM", "SDI", "ScalSeq", "C3CBAM"])
def test_runner_refuses_to_shard_a_graph_with_a_fusion_zoo_row(row, tmp_path):
    """Runner(spatial_shards=2) raises NotImplementedError naming item 6
    and the row's name before any process group starts."""
    name = ROWS[row][2]
    cfg = row_cfg(ROWS[row])
    cfg["head"] = [[[1, 2, 3], 1, "Detect", ["nc", "anchors"]]]
    path = tmp_path / "g.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(NotImplementedError, match=f"{name}.*item 6"):
        Runner(str(path), dtype=torch.float32, device="cpu", spatial_shards=2)
    assert not torch.distributed.is_initialized()
