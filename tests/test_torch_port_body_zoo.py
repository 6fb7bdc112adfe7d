"""The parser's remaining row kinds and layers.py's body zoo in the port,
against the JAX package on the CPU, row by row: each name of the slice
(SPD, Expand, BiFPN_Add2 / 3, CARAFE, DySample, Involution, Zoom_cat,
FReLU / AconC / MetaAconC, the gates SE / ECA / SimAM / CoorAttention /
BAM / CBAM, MultiSEAM, CrossConv, MixConv2d, GSConv and the CSP variants)
and repeated rows of several kinds, each as one row of a small conv
pyramid (width 0.25, depth 1.0, 64 px): the graph compiler's specs
against JAX's parse (Zoom_cat's stride aside, by design), the weight
bridge both ways, and the graph's output against flax in eval and in
train mode with the BatchNorm statistics the forward moved; the plain
rows' YAML args against the flax fields they fill; the names still
outside the registry; and the refusals of every block on a strip.

Variables are the flax `eval_shape` tree filled with seeded numpy draws
(tests/_torch_port_common.py `random_variables`) and rescaled by
test_torch_port_heads.py's `lively` (He-scaled kernels, norm scales about
1), so that every block sees and passes on O(1) activations. The JAX
programs are compiled without XLA's backend optimizations (the arithmetic
is the same), as tests/test_torch_port_heads.py does.
"""

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from tests._torch_port_common import _to_dict, few_threads, random_variables  # noqa: F401
from tests.test_torch_port_checkpoint import flat
from tests.test_torch_port_family import specs
from tests.test_torch_port_heads import lively
from yolosomi_tpu.models import yolo as jyolo
from yolosomi_tpu_torch.engine.runner import Runner
from yolosomi_tpu_torch.models import activations, layers
from yolosomi_tpu_torch.models import yolo as pyolo
from yolosomi_tpu_torch.parallel.spatial import spatial
from yolosomi_tpu_torch.utils.weights import export_jax_variables, load_jax_variables

IMGSZ = 64
# a small conv pyramid at width 0.25 (32 channels from row 1): the row
# under test reads row 4 (stride 8), a two-input fusion rows 4 and 2, and
# Zoom_cat the stride-4, -8 and -16 maps; a Conv after it takes its c2
BASE = [[-1, 1, "Conv", [64, 3, 2]], [-1, 1, "Conv", [128, 3, 2]], [-1, 1, "Conv", [128, 3, 2]],
        [-1, 1, "Conv", [128, 3, 2]], [2, 1, "Conv", [128, 1, 1]]]
# id -> the row under test
ROWS = {
    "SPD": [-1, 1, "SPD", []],
    "space_to_depth": [-1, 1, "space_to_depth", []],
    "Expand": [-1, 1, "Expand", [2]],
    "BiFPN_Add2": [[-1, 2], 1, "BiFPN_Add2", [256]],
    "BiFPN_Add3": [[-1, 2, 2], 1, "BiFPN_Add3", [256]],
    "CARAFE": [-1, 1, "CARAFE", [3, 5]],
    "CARAFE_defaults": [-1, 1, "CARAFE", []],
    "DySample": [-1, 1, "DySample", [2, 4]],
    "DySample_s4_g2": [-1, 1, "DySample", [4, 2]],
    "Involution": [-1, 1, "Involution", [1024, 3, 1]],
    "Involution_s2": [-1, 1, "Involution", [1024, 3, 2]],
    "Zoom_cat": [[1, -1, 3], 1, "Zoom_cat", []],
    "FReLU": [-1, 1, "FReLU", []],
    "AconC": [-1, 1, "AconC", []],
    "MetaAconC": [-1, 1, "MetaAconC", []],
    "SE": [-1, 1, "SE", [1024]],
    "SE_ratio4": [-1, 1, "SE", [1024, 4]],
    "se_block": [-1, 1, "se_block", []],
    "SimAM": [-1, 1, "SimAM", []],  # e_lambda = c2, the input's channels (flax's cls(c2))
    "SimAM_1024": [-1, 1, "SimAM", [1024]],  # e_lambda 1024
    "SimAM_1e-4": [-1, 1, "SimAM", [1e-4]],
    "eca_block": [-1, 1, "eca_block", []],  # b = c2
    "eca_block_1024": [-1, 1, "eca_block", [1024]],  # b 1024: k 515
    "ECA_b1": [-1, 1, "ECA", [1, 2]],
    "BAM": [-1, 1, "BAM", [256]],
    "BAM_r8": [-1, 1, "BAM", [256, 8]],
    "CBAM": [-1, 1, "CBAM", [1024]],
    "CBAM_r8": [-1, 1, "CBAM", [1024, 8]],
    "CoorAttention": [-1, 1, "CoorAttention", [128]],
    "CoorAttention_r8": [-1, 1, "CoorAttention", [128, 8]],
    "MultiSEAM": [-1, 1, "MultiSEAM", [256]],
    "CrossConv": [-1, 1, "CrossConv", [256, 3, 1]],
    "CrossConv_s2": [-1, 1, "CrossConv", [256, 3, 2]],
    "MixConv2d": [-1, 1, "MixConv2d", [64, [3, 5, 7], 2]],
    "MixConv2d_k13": [-1, 1, "MixConv2d", [128, [1, 3]]],
    "GSConv": [-1, 1, "GSConv", [256, 1, 1]],
    "GSConv_k3s2": [-1, 1, "GSConv", [256, 3, 2]],
    "C3SE": [-1, 2, "C3SE", [256, True]],
    "C3ECA": [-1, 2, "C3ECA", [256, True]],
    "C3SPP": [-1, 3, "C3SPP", [256]],
    "C3x": [-1, 2, "C3x", [128, True]],
    "C3x_no_shortcut": [-1, 2, "C3x", [256, False]],
    "RepC3": [-1, 2, "RepC3", [128]],
    "RepC3_e05": [-1, 2, "RepC3", [256, 0.5]],  # the hidden width is not c2: cv3
    "SPPCSPC": [-1, 1, "SPPCSPC", [256]],
    # repeated rows (JAX's _Repeat): the copies after the first take the row's c2
    "CBAM_x2": [-1, 2, "CBAM", [1024]],
    "SimAM_x2": [-1, 2, "SimAM", []],
    "FReLU_x3": [-1, 3, "FReLU", []],
    "MultiSEAM_x2": [-1, 2, "MultiSEAM", [256]],
    "GSConv_x2": [-1, 2, "GSConv", [128, 1, 1]],
    "Upsample_x2": [-1, 2, "nn.Upsample", [None, 2, "nearest"]],
    "Conv_x2": [-1, 2, "Conv", [128, 3, 1]],
}


def row_cfg(row: list) -> dict:
    """A headless graph: BASE, the row, a Conv after it."""
    return {"nc": 3, "anchors": 3, "depth_multiple": 1.0, "width_multiple": 0.25,
            "backbone": BASE + [row, [-1, 1, "Conv", [64, 1, 1]]], "head": []}


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def jax_compiled(jmodel, variables, x, train: bool):
    """jmodel.apply (with the moved batch_stats in train mode), compiled
    without XLA's backend optimizations."""
    def fn(v, t):
        if train:
            return jmodel.apply(v, t, True, mutable=["batch_stats"])
        return jmodel.apply(v, t, False)

    low = jax.jit(fn).lower(variables, x)
    return low.compile({"xla_backend_optimization_level": 0})


@pytest.fixture(scope="module")
def rows():
    """id -> (flax model, JAX meta, lively variables, port model, port
    meta), built at first use."""
    cache = {}

    def get(name: str):
        if name not in cache:
            cfg = row_cfg(ROWS[name])
            jmodel, jmeta = jyolo.build_model(cfg)
            shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, IMGSZ, IMGSZ, 3)),
                                                        train=False))
            variables = _to_dict(random_variables(shapes, sorted(ROWS).index(name)))
            variables = {"params": lively(variables["params"]), "batch_stats": variables["batch_stats"]}
            pmodel, pmeta = pyolo.build_model(cfg, device="cpu")
            cache[name] = (jmodel, jmeta, variables, pmodel, pmeta)
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(ROWS))
def test_row_specs_and_bridge_match_jax(rows, name):
    """specs (i, f, n, name, c2, stride) equal JAX's parse; a Zoom_cat
    row's stride is its second input's where JAX records its first's
    (ROADMAP queue C). load_jax_variables uses every flax leaf and fills
    every torch key (w, p1 / p2 / beta, ECA's (k, 1, 1) kernel, the Dense
    kernels, MixConv's m<i> and bn, sp1-4, dcov<i> / bn<i>, comp / enc,
    offset, conv1 / conv2 / conv_h / conv_w, se<i> / eca<i>, mods_<i>);
    export_jax_variables gives back the same tree."""
    jmodel, jmeta, variables, pmodel, pmeta = rows(name)
    got, want = specs(pmeta), specs(jmeta)
    if ROWS[name][2] == "Zoom_cat":
        i, second = len(BASE), len(BASE) + ROWS[name][0][1]  # the row and its second input (-1)
        assert got[0][i][-1] == pmeta.specs[second].stride
        assert [s[-1] for s in got[0][i:]] == [2 * s[-1] for s in want[0][i:]]  # the rows from it on
        got, want = ([s[:-1] for s in got[0]], *got[1:]), ([s[:-1] for s in want[0]], *want[1:])
    assert got == want
    assert load_jax_variables(pmodel, variables) == ([], [])
    back = export_jax_variables(pmodel)
    assert sorted(flat(back)) == sorted(flat(variables))
    for key, value in flat(variables).items():
        np.testing.assert_array_equal(flat(back)[key], value, err_msg=key)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(ROWS))
def test_row_matches_flax(rows, name, train):
    """The graph's output within atol 1e-4, rtol 1e-4 (f32); in train mode
    also every BatchNorm statistic the forward moved within rtol 1e-5,
    atol 1e-6."""
    jmodel, _, variables, pmodel, _ = rows(name)
    x = np.random.default_rng(sorted(ROWS).index(name)).standard_normal((2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    out = jax_compiled(jmodel, variables, jnp.asarray(x), train)(variables, jnp.asarray(x))
    ref, moved = out if train else (out, None)
    assert load_jax_variables(pmodel, variables) == ([], [])
    pmodel.train(train)
    with torch.no_grad():
        got = pmodel(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4, rtol=1e-4)
    if train:
        stats = flat(export_jax_variables(pmodel)["batch_stats"])
        want = flat(jax.device_get(moved["batch_stats"]))
        assert sorted(stats) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(stats[k], w, rtol=1e-5, atol=1e-6, err_msg=k)


# plain rows: (row, the flax fields that must carry over, the port's view of them)
PLAIN = [
    ([-1, 1, "SimAM", [1024]], lambda j, p: (j.e_lambda, p.e_lambda), 1024),
    ([-1, 1, "SimAM", []], lambda j, p: (j.e_lambda, p.e_lambda), 32),
    ([-1, 1, "eca_block", [1024]], lambda j, p: (j.b, p.b), 1024),
    ([-1, 1, "eca_block", []], lambda j, p: (j.b, p.b), 32),
    ([-1, 1, "ECA", [3, 4]], lambda j, p: ((j.b, j.gamma), (p.b, p.gamma)), (3, 4)),
    ([-1, 1, "SE", [1024, 4]], lambda j, p: (max(32 // j.ratio, 1), p.l1.out_features), 8),
    ([-1, 1, "se_block", [7]], lambda j, p: (max(32 // j.ratio, 1), p.l1.out_features), 2),  # c2 slot ignored
    ([-1, 1, "CBAM", [1024, 8]], lambda j, p: (max(32 // j.reduction, 1),
                                               p.channel_attention.shared_MLP[0].out_features), 4),
    ([-1, 1, "BAM", [5, 4]], lambda j, p: (max(32 // j.reduction, 1), p.fc1.out_features), 8),
]


@pytest.mark.parametrize("case", range(len(PLAIN)), ids=[f"{r[2]}{r[3]}" for r, _, _ in PLAIN])
def test_plain_row_args_fill_the_flax_fields(case):
    """A plain row's YAML args map positionally onto the JAX module's
    fields (`cls(*args)`, `cls(c2)` without args), not onto the torch
    module's input channels: SimAM [1024] is e_lambda 1024, eca_block
    [1024] is b 1024, and CBAM / SE / BAM ignore their c2 slot."""
    row, view, value = PLAIN[case]
    cfg = row_cfg(row)
    jmods, _, _ = jyolo.parse_model(cfg)
    pmods, _ = pyolo.parse_model(cfg)
    j, p = view(jmods[len(BASE)], pmods[len(BASE)])
    assert j == p == value


@pytest.mark.parametrize("module", ["Conv2Former", "ContextAggregation", "ConvTranspose", "CAM", "SDI", "Add"])
def test_names_still_outside_the_registry_name_what_remains(module):
    """The names that stood outside the registry until its part (d) of item
    8 (layers_zoo.py's fusion blocks and their kinds) parse with the JAX
    parser's specs and build; SDI and Add read two maps."""
    row = [[-1, 2], 1, module, []] if module in ("SDI", "Add") else [-1, 1, module, [128]]
    _, jmeta, _ = jyolo.parse_model(row_cfg(row))
    _, pmeta = pyolo.parse_model(row_cfg(row))
    assert specs(pmeta) == specs(jmeta) and pmeta.specs[len(BASE)].name == module
    model, _ = pyolo.build_model(row_cfg(row), device="cpu")
    assert type(model.model[len(BASE)]).__name__ in (module, "ConvTransposeLayer")


# one instance of each block with a whole-map reduction, an unbounded reach
# or a reshape across rows, 32 channels in (C3SE and C3ECA hold SE and ECA)
STRIPLESS_BLOCKS = {
    "SE": lambda: layers.SE(32), "ECA": lambda: layers.ECA(32), "SimAM": lambda: layers.SimAM(32),
    "CoorAttention": lambda: layers.CoorAttention(32), "BAM": lambda: layers.BAM(32),
    "MultiSEAM": lambda: layers.MultiSEAM(32), "MetaAconC": lambda: activations.MetaAconC(32),
    "SPD": lambda: layers.SPD(),
    "Expand": lambda: layers.Expand(2), "CARAFE": lambda: layers.CARAFE(32), "DySample": lambda: layers.DySample(32),
    "Involution": lambda: layers.Involution(32), "ZoomCat": lambda: layers.ZoomCat(),
}


@pytest.mark.parametrize("block", sorted(STRIPLESS_BLOCKS))
def test_blocks_without_a_strip_path_refuse_a_strip(block):
    """Under spatial(strip) these blocks raise NotImplementedError naming
    item 6 rather than reduce or sample over one strip only."""
    x = torch.randn(2, 32, 8, 8)
    inp = [torch.randn(2, 32, 16, 16), x, torch.randn(2, 32, 4, 4)] if block == "ZoomCat" else x
    mod = STRIPLESS_BLOCKS[block]().eval()
    with torch.no_grad():
        mod(inp)  # unsharded it runs
        with spatial(object()), pytest.raises(NotImplementedError, match="item 6"):
            mod(inp)


@pytest.mark.parametrize("name", ["Zoom_cat", "BiFPN_Add2", "CrossConv", "FReLU", "CBAM"])
def test_runner_refuses_to_shard_a_graph_with_a_body_zoo_row(name, tmp_path):
    """Runner(spatial_shards=2) raises NotImplementedError naming item 6
    and the rows' names before any process group starts."""
    cfg = row_cfg(ROWS[name])
    cfg["head"] = [[[1, 2, 3], 1, "Detect", ["nc", "anchors"]]]
    path = tmp_path / "g.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(NotImplementedError, match=f"{name}.*item 6"):
        Runner(str(path), dtype=torch.float32, device="cpu", spatial_shards=2)
