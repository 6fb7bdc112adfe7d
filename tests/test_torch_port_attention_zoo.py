"""layers.py's attention family, LSKA / SPPF_LSKA, Swin / C3STR, HorBlock /
gnconv, RFEM / C3RFEM, LVCBlock and ConvMixer in the port, against the JAX
package on the CPU: each of the 31 registry names (and repeated rows) as
one row of test_torch_port_body_zoo.py's small conv pyramid (width 0.25,
64 px: the row reads an 8x8 map of 32 channels): the graph compiler's
specs against JAX's parse, the plain rows' YAML args against the flax
fields they fill, the weight bridge both ways, the graph's output against
flax in eval and in train mode with the BatchNorm statistics the forward
moved; then the blocks alone where a row cannot reach a case: MHSA on a
non-square map and its refusal of another size, Swin on a 20x20 map
(padded to 24, shifted), ELA with one group, MLCA's two pool branches,
EMA's and SGE's NHWC band reshape on channels that differ, TridentBlock's
shared BatchNorm statistics after a train step, and the Encoding's
stored parameters through the bridge; the refusals on a strip.

Variables are the flax `eval_shape` tree filled with seeded numpy draws
rescaled by test_torch_port_heads.py's `lively`, as
test_torch_port_body_zoo.py draws them. The JAX package's parser cannot
build a block with no field from a YAML row (tests/_torch_port_common.py
FIELDLESS); within this module its registry builds them from the empty
row, as the port does.
"""

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from tests._torch_port_common import FIELDLESS, _to_dict, few_threads, fieldless_rows, random_variables  # noqa: F401
from tests.test_torch_port_body_zoo import BASE, _nchw, jax_compiled, row_cfg
from tests.test_torch_port_checkpoint import flat
from tests.test_torch_port_family import specs
from tests.test_torch_port_heads import lively
from yolosomi_tpu.models import layers as jlayers
from yolosomi_tpu.models import yolo as jyolo
from yolosomi_tpu_torch.engine.runner import Runner
from yolosomi_tpu_torch.models import layers
from yolosomi_tpu_torch.models import yolo as pyolo
from yolosomi_tpu_torch.parallel.spatial import spatial
from yolosomi_tpu_torch.utils.weights import export_jax_variables, load_jax_variables

IMGSZ = 64
# id -> the row under test (it reads BASE's row 4: 8x8, 32 channels)
ROWS = {
    "GAMAttention": [-1, 1, "GAMAttention", [128]],
    "GAMAttention_rate2": [-1, 1, "GAMAttention", [128, 2]],
    "SKAttention": [-1, 1, "SKAttention", [128]],
    "SKAttention_k13_r8": [-1, 1, "SKAttention", [128, [1, 3], 8]],
    "ShuffleAttention": [-1, 1, "ShuffleAttention", [128]],
    "ShuffleAttention_g4": [-1, 1, "ShuffleAttention", [128, 4]],
    "NAMAttention": [-1, 1, "NAMAttention", []],
    "EMA": [-1, 1, "EMA", [8]],
    "EMA_f4": [-1, 1, "EMA", [4]],
    "LSKblock": [-1, 1, "LSKblock", []],
    "MLCA": [-1, 1, "MLCA", [5]],  # 8 -> 5: the antialiased linear resize
    "MLCA_4": [-1, 1, "MLCA", [4, 2, 1, 0.25]],  # 8 -> 4: block means
    "TripletAttention": [-1, 1, "TripletAttention", []],
    "GlobalContextBlock": [-1, 1, "GlobalContextBlock", [0.25]],
    "NonLocalBlock": [-1, 1, "NonLocalBlock", []],
    "CoT": [-1, 1, "CoT", [3]],
    "CoTAttention": [-1, 1, "CoTAttention", [3]],
    "DoubleAttention": [-1, 1, "DoubleAttention", []],
    "ParallelPolarizedSelfAttention": [-1, 1, "ParallelPolarizedSelfAttention", []],
    "SpatialGroupEnhance": [-1, 1, "SpatialGroupEnhance", [8]],
    "SpatialGroupEnhance_g4": [-1, 1, "SpatialGroupEnhance", [4]],
    "MHSA": [-1, 1, "MHSA", [4]],
    "MHSA_h2": [-1, 1, "MHSA", [2]],
    "S2Attention": [-1, 1, "S2Attention", []],
    "EfficientAttention": [-1, 1, "EfficientAttention", [4]],
    "ELA": [-1, 1, "ELA", []],
    "MSCAAttention": [-1, 1, "MSCAAttention", []],
    "LSKA": [-1, 1, "LSKA", [11]],
    "LSKA_7": [-1, 1, "LSKA", [7]],
    "LSKA_23": [-1, 1, "LSKA", [23]],
    "SPPF_LSKA": [-1, 1, "SPPF_LSKA", [128, 5]],
    "SwinTransformerBlock": [-1, 1, "SwinTransformerBlock", [128, 2, 2, 3]],  # window 3: padded to 9, shifted by 1
    "SwinTransformerBlock_conv": [-1, 1, "SwinTransformerBlock", [256, 4, 2]],  # 32 -> 64 channels, window 8
    "C3STR": [-1, 2, "C3STR", [128]],
    "HorBlock": [-1, 1, "HorBlock", [128]],
    "HorNet_order3": [-1, 1, "HorNet", [128, 3]],
    "gnconv": [-1, 1, "gnconv", []],
    "gnconv_32_3_s05": [-1, 1, "gnconv", [32, 3, 0.5]],
    "RFEM": [-1, 1, "RFEM", [128]],
    "RFEM_e025": [-1, 1, "RFEM", [128, 1, 0.25]],
    "C3RFEM": [-1, 2, "C3RFEM", [128]],
    "LVCBlock": [-1, 1, "LVCBlock", [128, 8]],
    "LVCBlock_defaults": [-1, 1, "LVCBlock", []],
    "ConvMixer": [-1, 1, "ConvMixer", [128]],
    "ConvMixer_depth2": [-1, 1, "ConvMixer", [128, 2]],
    # repeated rows (JAX's _Repeat)
    "HorBlock_x2": [-1, 2, "HorBlock", [128]],
    "ELA_x2": [-1, 2, "ELA", []],
}
NAMES = sorted({r[2] for r in ROWS.values()})


@pytest.fixture(scope="module")
def rows(fieldless_rows):
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
            pmodel, pmeta = pyolo.build_model(cfg, device="cpu", imgsz=IMGSZ)
            cache[name] = (jmodel, jmeta, variables, pmodel, pmeta)
        return cache[name]

    return get


def test_every_attention_zoo_name_is_a_row_here():
    """The 31 names of layers.py's attention family, Swin, HorNet, RFEM /
    EVC and ConvMixer blocks each stand in ROWS and in the port's
    registry, and none of them can be sharded."""
    assert len(NAMES) == 31
    assert set(NAMES) <= set(pyolo._REGISTRY) and set(NAMES) <= pyolo.STRIPLESS


@pytest.mark.parametrize("name", sorted(ROWS))
def test_row_specs_and_bridge_match_jax(rows, name):
    """specs (i, f, n, name, c2, stride) equal JAX's parse; load_jax_variables
    uses every flax leaf and fills every torch key (Dense kernels,
    share_weightconv1 / 2, MLCA's (1, k, 1, 1) kernels, Shuffle's and SGE's
    gates, rel_h / rel_w, the bias tables, gamma1 / gamma2, NAM's gamma /
    beta, codewords / scale, gnconv's pw<i>, ConvMixer's dw<i> / pw<i> /
    bn_dw<i> / bn_pw<i>, mods_<i>); export_jax_variables gives back the
    same tree, bit for bit."""
    _, jmeta, variables, pmodel, pmeta = rows(name)
    assert specs(pmeta) == specs(jmeta)
    assert load_jax_variables(pmodel, variables) == ([], [])
    back = flat(export_jax_variables(pmodel))
    want = flat(variables)
    assert sorted(back) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


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


# plain rows: (row, the flax fields that carry over, the port's view of them, the value)
PLAIN = [
    ([-1, 1, "GAMAttention", [7, 2]], lambda j, p: (max(32 // j.rate, 1), p.fc1.out_features), 16),
    ([-1, 1, "SKAttention", [7, [1, 3], 8]], lambda j, p: (tuple(j.kernels), p.kernels), (1, 3)),
    ([-1, 1, "ShuffleAttention", [7, 4]], lambda j, p: (j.groups, p.groups), 4),
    ([-1, 1, "EMA", []], lambda j, p: (j.factor, p.factor), 32),  # factor = c2, the input's channels
    ([-1, 1, "MLCA", []], lambda j, p: (j.local_size, p.local_size), 32),  # local_size = c2
    ([-1, 1, "MLCA", [3, 2, 1, 0.25]], lambda j, p: ((j.local_size, j.local_weight),
                                                     (p.local_size, p.local_weight)), (3, 0.25)),
    ([-1, 1, "GlobalContextBlock", [0.5]], lambda j, p: (max(int(32 * j.ratio), 1), p.fc1.out_features), 16),
    ([-1, 1, "CoT", [5]], lambda j, p: (j.kernel_size, p.k), 5),
    ([-1, 1, "SpatialGroupEnhance", [2]], lambda j, p: (j.groups, p.groups), 2),
    ([-1, 1, "MHSA", [2]], lambda j, p: (j.num_heads, p.num_heads), 2),
    ([-1, 1, "EfficientAttention", [8]], lambda j, p: (j.num_heads, p.num_heads), 8),
    ([-1, 1, "LSKA", [23]], lambda j, p: (j._CFG[j.k_size], (p.dw_h.kernel_size[1], p.dwd_h.kernel_size[1],
                                                            p.dwd_h.dilation[1])), (5, 7, 3)),
    ([-1, 1, "HorBlock", [7, 3]], lambda j, p: (j.order, len(p.gnconv.pw) + 1), 3),
    ([-1, 1, "gnconv", [32, 3, 0.5]], lambda j, p: ((j.dim, j.order, j.s), (p.dims[-1], len(p.pw) + 1, p.s)),
     (32, 3, 0.5)),
    ([-1, 1, "LVCBlock", [7, 16]], lambda j, p: (j.num_codes, p.encoding.codewords.shape[0]), 16),
]


@pytest.mark.parametrize("case", range(len(PLAIN)), ids=[f"{r[2]}{r[3]}" for r, _, _ in PLAIN])
def test_plain_row_args_fill_the_flax_fields(fieldless_rows, case):
    """A plain row's YAML args fill the JAX module's fields in order
    (`cls(c2)` without args), not the torch module's input channels: EMA []
    is factor 32 and MLCA [] local_size 32; the c2 slot of GAM, SK,
    Shuffle, HorBlock and LVCBlock does not enter the block."""
    row, view, value = PLAIN[case]
    cfg = row_cfg(row)
    jmods, _, _ = jyolo.parse_model(cfg)
    pmods, _ = pyolo.parse_model(cfg)
    j, p = view(jmods[len(BASE)], pmods[len(BASE)])
    assert j == p == value


@pytest.mark.parametrize("name", FIELDLESS)
def test_a_block_without_fields_takes_an_empty_row(name, monkeypatch):
    """The JAX parser raises TypeError for any row of a block with no field
    (its `cls(c2, dtype=dtype)` fills dtype twice); the port builds it from
    an empty row and raises TypeError for a row with args (ROADMAP queue C)."""
    monkeypatch.setitem(jyolo._REGISTRY, name, (getattr(jlayers, name), "plain"))  # the registry as shipped
    with pytest.raises(TypeError, match="dtype"):
        jyolo.parse_model(row_cfg([-1, 1, name, []]))
    pyolo.parse_model(row_cfg([-1, 1, name, []]))
    with pytest.raises(TypeError, match="at most 0 args"):
        pyolo.parse_model(row_cfg([-1, 1, name, [4]]))


def test_gnconv_dim_must_be_the_input_channels():
    """gnconv's output has dim channels while the graph records the row as
    channel-preserving (the JAX parser too, whose lazy shapes then build
    the next rows on the wrong count); the port refuses a dim other than
    the input's channels."""
    with pytest.raises(ValueError, match="gnconv dim 256 on 32"):
        pyolo.parse_model(row_cfg([-1, 1, "gnconv", [256]]))


# ---------------------------------------------------------------------------
# the blocks alone
# ---------------------------------------------------------------------------

# name -> (flax module, port module, input (h, w, channels))
BLOCKS = {
    "MHSA_6x10": (lambda: jlayers.MHSA(4), lambda: layers.MHSA(32, 4, hw=(6, 10)), (6, 10, 32)),
    "Swin_20x20_w8": (lambda: jlayers.SwinTransformerBlock(32, 2, 2, 8),
                      lambda: layers.SwinTransformerBlock(32, 32, 2, 2, 8), (20, 20, 32)),
    "Swin_9x13_w4": (lambda: jlayers.SwinTransformerBlock(16, 2, 3, 4),
                     lambda: layers.SwinTransformerBlock(16, 16, 2, 3, 4), (9, 13, 16)),
    "ELA_24": (lambda: jlayers.ELA(), lambda: layers.ELA(24), (8, 6, 24)),
    "MLCA_12_mean": (lambda: jlayers.MLCA(3), lambda: layers.MLCA(24, 3), (12, 6, 24)),
    "MLCA_10_resize": (lambda: jlayers.MLCA(4), lambda: layers.MLCA(24, 4), (10, 7, 24)),
    "MLCA_3_up": (lambda: jlayers.MLCA(5), lambda: layers.MLCA(24, 5), (3, 4, 24)),
    "EMA_6x5": (lambda: jlayers.EMAAttention(4), lambda: layers.EMAAttention(32, 4), (6, 5, 32)),
    "SGE_6x5": (lambda: jlayers.SpatialGroupEnhance(4), lambda: layers.SpatialGroupEnhance(32, 4), (6, 5, 32)),
    "TripletAttention_5x9": (lambda: jlayers.TripletAttention(), lambda: layers.TripletAttention(12), (5, 9, 12)),
    "S2Attention_5x7": (lambda: jlayers.S2Attention(), lambda: layers.S2Attention(18), (5, 7, 18)),
    "LVCBlock_7x5": (lambda: jlayers.LVCBlock(16, 8), lambda: layers.LVCBlock(16, 8), (7, 5, 16)),
    "ConvMixer_8x12": (lambda: jlayers.ConvMixer(16), lambda: layers.ConvMixer(16), (8, 12, 16)),
}


def block_pair(name: str, seed: int = 1):
    """(flax module, its lively variables, port module with them loaded, x)."""
    jfn, pfn, (h, w, c) = BLOCKS[name]
    x = np.random.default_rng(sorted(BLOCKS).index(name)).standard_normal((2, h, w, c)).astype(np.float32)
    x += np.linspace(-1.0, 1.0, c, dtype=np.float32)  # channels that differ: a port grouping channels would show
    jmod = jfn()
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), x, False))
    variables = _to_dict(random_variables(shapes, seed))
    variables["params"] = lively(variables["params"])
    pmod = pfn()
    assert load_jax_variables(pmod, variables) == ([], [])
    return jmod, variables, pmod, x


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_flax(name):
    """Eval output within atol 1e-4, rtol 1e-4: MHSA's positions on an h != w
    map (rel_h + rel_w broadcast to (w, h), then flattened row-major), Swin
    on maps padded to its window and shifted, ELA with one group, MLCA's
    block-mean, shrinking and growing pools, EMA's and SGE's bands on maps
    whose rows do not split into the bands evenly, the triplet's transposed
    branches and S2's rolls on non-square maps, LVC and ConvMixer."""
    jmod, variables, pmod, x = block_pair(name)
    ref = np.asarray(jax.jit(lambda v, t: jmod.apply(v, t, False))(variables, x))
    with torch.no_grad():
        got = pmod.eval()(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_mhsa_refuses_another_map_size_and_takes_a_files_size():
    """An MHSA built for 6x10 raises ValueError on 10x6, as flax refuses its
    parameters' shape there; the weight bridge re-sizes it to a file's
    rel_h / rel_w (a model made at another image size)."""
    jmod, variables, pmod, x = block_pair("MHSA_6x10")
    with pytest.raises(ValueError, match="built for a 6x10 map"):
        pmod(_nchw(x.transpose(0, 2, 1, 3).copy()))
    with pytest.raises(Exception):
        jmod.apply(variables, x.transpose(0, 2, 1, 3), False)
    other = layers.MHSA(32, 4, hw=(3, 3))
    assert load_jax_variables(other, variables) == ([], [])
    assert other.rel_h.shape == (1, 1, 6, 1, 8) and other.rel_w.shape == (1, 10, 1, 1, 8)
    with torch.no_grad():
        np.testing.assert_array_equal(other(_nchw(x)).numpy(), pmod(_nchw(x)).numpy())


def test_mhsa_graph_takes_its_size_from_build_models_imgsz(fieldless_rows):
    """build_model's imgsz sizes MHSA as the JAX init_model's does (the map
    at the row's stride), 256 by default; the Runner builds at min(imgsz,
    256), as the JAX Runner inits."""
    cfg = row_cfg(ROWS["MHSA"])
    at = lambda m: tuple(m.model[len(BASE)].rel_h.shape[2:3]) + tuple(m.model[len(BASE)].rel_w.shape[1:2])  # noqa
    assert at(pyolo.build_model(cfg, device="cpu")[0]) == (32, 32)
    assert at(pyolo.build_model(cfg, device="cpu", imgsz=IMGSZ)[0]) == (8, 8)


def test_encoding_parameters_round_trip_before_the_shift():
    """Encoding's codewords and scale pass through the bridge as flax stores
    them (before the forward's `- std` and negation), both ways bit for
    bit, and the forward applies the shifts: its output equals flax's."""
    jenc = jlayers.Encoding(8)
    x = np.random.default_rng(5).standard_normal((2, 5, 4, 16)).astype(np.float32)
    variables = _to_dict(random_variables(jax.eval_shape(lambda: jenc.init(jax.random.PRNGKey(0), x)), 2))
    penc = layers.Encoding(16, 8)
    assert load_jax_variables(penc, variables) == ([], [])
    np.testing.assert_array_equal(penc.codewords.detach().numpy(), variables["params"]["codewords"])
    np.testing.assert_array_equal(penc.scale.detach().numpy(), variables["params"]["scale"])
    back = export_jax_variables(penc)["params"]
    for k in ("codewords", "scale"):
        np.testing.assert_array_equal(back[k], variables["params"][k])
    ref = np.asarray(jenc.apply(variables, x))
    with torch.no_grad():
        np.testing.assert_allclose(penc(_nchw(x)).numpy(), ref, atol=1e-5, rtol=1e-5)


def test_trident_shared_batchnorms_move_three_times_a_train_step():
    """TridentBlock applies one bn1 and one bn2 in its three branches: a
    train-mode forward moves their running statistics three times, in
    branch order, as flax does (within rtol 1e-5, atol 1e-6), and the three
    maps match (atol 1e-4, rtol 1e-4)."""
    jmod = jlayers.TridentBlock(16)
    x = np.random.default_rng(6).standard_normal((2, 9, 7, 16)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), x, False))
    variables = _to_dict(random_variables(shapes, 3))
    variables["params"] = {k: (v / 0.1 * np.sqrt(2.0 / np.prod(v.shape[:-1]))).astype(np.float32)
                           if k.startswith("share") else v for k, v in variables["params"].items()}
    refs, moved = jmod.apply(variables, x, True, mutable=["batch_stats"])
    pmod = layers.TridentBlock(16, 16).train()
    assert load_jax_variables(pmod, variables) == ([], [])
    before = flat(export_jax_variables(pmod)["batch_stats"])
    with torch.no_grad():
        got = pmod(_nchw(x))
    for g, r in zip(got, refs):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(r), atol=1e-4, rtol=1e-4)
    stats = flat(export_jax_variables(pmod)["batch_stats"])
    for k, w in flat(jax.device_get(moved["batch_stats"])).items():
        assert not np.allclose(w, before[k])
        np.testing.assert_allclose(stats[k], w, rtol=1e-5, atol=1e-6, err_msg=k)
    once = layers.TridentBlock(16, 16).train()
    load_jax_variables(once, variables)
    with torch.no_grad():
        once._branch(_nchw(x), 1)  # one branch moves them once: three differ
    assert not np.allclose(flat(export_jax_variables(once)["batch_stats"])["bn2/var"], stats["bn2/var"])


# one instance of each block that refuses a strip, 32 channels in
STRIPLESS_BLOCKS = {
    "SKAttention": lambda: layers.SKAttention(32), "ShuffleAttention": lambda: layers.ShuffleAttention(32),
    "EMA": lambda: layers.EMAAttention(32), "MLCA": lambda: layers.MLCA(32),
    "TripletAttention": lambda: layers.TripletAttention(32),
    "GlobalContextBlock": lambda: layers.GlobalContextBlock(32),
    "SpatialGroupEnhance": lambda: layers.SpatialGroupEnhance(32), "ELA": lambda: layers.ELA(32),
    "NonLocalBlock": lambda: layers.NonLocalBlock(32), "DoubleAttention": lambda: layers.DoubleAttention(32),
    "ParallelPolarizedSelfAttention": lambda: layers.ParallelPolarizedSelfAttention(32),
    "MHSA": lambda: layers.MHSA(32, 4, hw=(8, 8)), "S2Attention": lambda: layers.S2Attention(32),
    "EfficientAttention": lambda: layers.EfficientAttention(32),
    "SwinTransformerBlock": lambda: layers.SwinTransformerBlock(32, 32, 2, 2, 4),
    "RFEM": lambda: layers.RFEM(32, 32), "LVCBlock": lambda: layers.LVCBlock(32, 8),
    "ConvMixer": lambda: layers.ConvMixer(32),
}


@pytest.mark.parametrize("block", sorted(STRIPLESS_BLOCKS))
def test_blocks_without_a_strip_path_refuse_a_strip(block):
    """Under spatial(strip) these blocks raise NotImplementedError naming
    item 6 rather than reduce, attend or convolve over one strip only."""
    x = torch.randn(2, 32, 8, 8)
    mod = STRIPLESS_BLOCKS[block]().eval()
    with torch.no_grad():
        mod(x)  # unsharded it runs
        with spatial(object()), pytest.raises(NotImplementedError, match="item 6"):
            mod(x)


@pytest.mark.parametrize("row", ["GAMAttention", "C3STR", "HorNet_order3", "LVCBlock", "ConvMixer", "SPPF_LSKA"])
def test_runner_refuses_to_shard_a_graph_with_an_attention_zoo_row(row, tmp_path):
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
