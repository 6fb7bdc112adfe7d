"""layers_zoo.py's conv and csp kinds in the port (SimConv, CoordConv /
CoordConvd, ADown, DownSimper, ASPP, SPPELAN, SPPF_improve, BasicRFB /
BasicRFB_a, RepVGGBlock, ACmix, Conv_SWS, SPPCSPCS, CNeB, CSPCM, C3CR, the
C3_<attention> family, C2fBAM, C2f_DWR, VoVGSCSPCBAM, and CPCA), against
the JAX package on the CPU: each of the 30 names (and repeated rows) as one
row of test_torch_port_body_zoo.py's small conv pyramid (width 0.25, 64
px: the row reads an 8x8 map of 32 channels): the graph compiler's specs
against JAX's parse, the weight bridge both ways, the graph's output
against flax in eval and in train mode with the BatchNorm statistics the
forward moved; an nn.Upsample row of mode bilinear, which both packages
upsample nearest; then the blocks alone where a row cannot reach a case:
ACmix on a 2x2 map (its reflect padding reaches past the map) and at
stride 2, Conv_SWS on a 20x20 map (the border no tile covers stays zero)
and with overlapping tiles, ADown on an odd height, RepVGGBlock's identity
branch, the coordinate maps of CoordConv and ACmix in bfloat16 against
jnp.linspace's, the gradients of CPCA (its shared conv), ACmix, Conv_SWS
and coordinate attention against jax.grad; the
refusals on a strip and the Runner's refusal to shard.

Variables are the flax `eval_shape` tree filled with seeded numpy draws
rescaled by test_torch_port_heads.py's `lively`, as
test_torch_port_body_zoo.py draws them.
"""

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from tests._torch_port_common import _to_dict, few_threads, random_variables  # noqa: F401
from tests.test_torch_port_body_zoo import BASE, _nchw, jax_compiled, row_cfg
from tests.test_torch_port_checkpoint import flat
from tests.test_torch_port_family import specs
from tests.test_torch_port_heads import lively
from yolosomi_tpu.models import layers_zoo as jzoo
from yolosomi_tpu.models import yolo as jyolo
from yolosomi_tpu_torch.engine.runner import Runner
from yolosomi_tpu_torch.models import layers_zoo as zoo
from yolosomi_tpu_torch.models import yolo as pyolo
from yolosomi_tpu_torch.parallel.spatial import spatial
from yolosomi_tpu_torch.utils.general import LOGGER
from yolosomi_tpu_torch.utils.weights import export_jax_variables, export_param_tree, load_jax_variables

IMGSZ = 64
# id -> the row under test (it reads BASE's row 4: 8x8, 32 channels)
ROWS = {
    "SimConv": [-1, 1, "SimConv", [128]],
    "SimConv_k3s2": [-1, 1, "SimConv", [128, 3, 2]],
    "CoordConv": [-1, 1, "CoordConv", [128, 3, 1]],
    "CoordConv_with_r_s2": [-1, 1, "CoordConv", [256, 3, 2, True]],
    "CoordConvd": [-1, 1, "CoordConvd", [128, 3, 1]],
    "ADown": [-1, 1, "ADown", [256]],  # 8 rows -> 7 -> 4
    "DownSimper": [-1, 1, "DownSimper", [128]],
    "ASPP": [-1, 1, "ASPP", [128]],
    "SPPELAN": [-1, 1, "SPPELAN", [128, 64]],  # c3 64 is not width-scaled
    "SPPF_improve": [-1, 1, "SPPF_improve", [128, 5]],
    "BasicRFB": [-1, 1, "BasicRFB", [128, 1]],
    "BasicRFB_s2_visual2": [-1, 1, "BasicRFB", [256, 2, 0.2, 2]],
    "BasicRFB_a": [-1, 1, "BasicRFB_a", [128, 1]],
    "RepVGGBlock": [-1, 1, "RepVGGBlock", [128]],  # c1 == c2, s 1: the identity branch
    "RepVGGBlock_s2": [-1, 1, "RepVGGBlock", [128, 3, 2]],
    "RepVGGBlock_wider": [-1, 1, "RepVGGBlock", [256]],
    "ACmix": [-1, 1, "ACmix", [128, 7, 4, 3, 1]],
    "ACmix_s2_k5": [-1, 1, "ACmix", [128, 5, 2, 3, 2]],
    "Conv_SWS": [-1, 1, "Conv_SWS", [128, 8, 0.0, 1e-4, 1, 1]],
    "Conv_SWS_overlap": [-1, 1, "Conv_SWS", [256, 4, 0.5, 1e-4, 3, 2]],  # tiles at 0, 2, 4 overlap; stride 2
    "SPPCSPCS": [-1, 1, "SPPCSPCS", [128]],
    "CNeB": [-1, 2, "CNeB", [128]],
    "CSPCM": [-1, 2, "CSPCM", [128]],
    "C3CR": [-1, 2, "C3CR", [256]],
    "C3_CBAM": [-1, 2, "C3_CBAM", [128, True]],
    "C3_CBAMS": [-1, 1, "C3_CBAMS", [128]],
    "C3_CBAM_DWC": [-1, 2, "C3_CBAM_DWC", [128, True]],
    "C3_CBAMS_DWC": [-1, 1, "C3_CBAMS_DWC", [128, False]],
    "C3CPCA": [-1, 2, "C3CPCA", [128, True]],
    "C3GAM": [-1, 2, "C3GAM", [128, True]],
    "C3GAM_no_shortcut": [-1, 1, "C3GAM", [128, False]],
    "C3_SCBAM": [-1, 2, "C3_SCBAM", [128, True]],
    "C3_BAM": [-1, 2, "C3_BAM", [128]],
    "C3_CA": [-1, 2, "C3_CA", [128, True]],
    "C2fBAM": [-1, 2, "C2fBAM", [128, True]],
    "C2f_DWR": [-1, 2, "C2f_DWR", [128]],
    "C2f_DWR_shortcut": [-1, 1, "C2f_DWR", [128, True]],
    "VoVGSCSPCBAM": [-1, 2, "VoVGSCSPCBAM", [256]],
    "CPCA": [-1, 1, "CPCA", []],
    # repeated rows (JAX's _Repeat)
    "CPCA_x2": [-1, 2, "CPCA", []],
    "RepVGGBlock_x2": [-1, 2, "RepVGGBlock", [128]],
    # another Upsample mode: built, upsampling nearest, as the JAX package does
    "Upsample_bilinear": [-1, 1, "nn.Upsample", [None, 2, "bilinear"]],
}
NAMES = sorted({r[2] for r in ROWS.values()} - {"nn.Upsample"})


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


def test_every_conv_zoo_name_is_a_row_here():
    """The 29 conv and csp names of layers_zoo.py and CPCA each stand in
    ROWS and in the port's registry, and none of them can be sharded."""
    assert len(NAMES) == 30
    assert set(NAMES) <= set(pyolo._REGISTRY) and set(NAMES) <= pyolo.STRIPLESS
    assert {n for n, (_, kind) in jyolo._REGISTRY.items() if kind in ("conv", "csp")} - set(pyolo._REGISTRY) == set()


@pytest.mark.parametrize("name", sorted(ROWS))
def test_row_specs_and_bridge_match_jax(rows, name):
    """specs (i, f, n, name, c2, stride; BasicRFB's stride arg 1, ACmix's
    4, Conv_SWS's 5, ADown's and DownSimper's 2) equal JAX's parse;
    load_jax_variables uses every flax leaf and fills every torch key (the
    RFB branches b<i>_<j>, linear / shortcut, dense / dense_bn / one /
    one_bn / id_bn, sa_dw / sa_pw, conv_h / conv_w / bn1, CPCA's d55 ...
    d121b and its shared conv, the Dense pwconv1 / pwconv2, gamma,
    layer_scale_1 / 2, the mlp_* convs, ACmix's fc, rate1 / rate2, conv_p
    and dep_conv, m<i>_cv1 / m<i>_cv2, gsb<i>, mods_<i>);
    export_jax_variables gives back the same tree, bit for bit."""
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


def test_upsample_of_another_mode_builds_and_upsamples_nearest(rows, caplog):
    """A bilinear nn.Upsample row builds (the port raised before), repeats
    each pixel as the JAX package's Upsample does whatever the mode, and
    the parser logs the mode it dropped."""
    LOGGER.propagate, kept = True, LOGGER.propagate
    try:
        with caplog.at_level("INFO", logger=LOGGER.name):
            mods, _ = pyolo.parse_model(row_cfg(ROWS["Upsample_bilinear"]))
    finally:
        LOGGER.propagate = kept
    assert "mode 'bilinear' dropped" in caplog.text
    x = torch.randn(1, 2, 3, 4)
    np.testing.assert_array_equal(mods[len(BASE)](x).numpy(), x.repeat_interleave(2, 2).repeat_interleave(2, 3))


# ---------------------------------------------------------------------------
# the blocks alone
# ---------------------------------------------------------------------------

# name -> (flax module, port module, input (h, w, channels))
BLOCKS = {
    "ACmix_2x2": (lambda: jzoo.ACmix(16, 7, 4, 3, 1), lambda: zoo.ACmix(16, 16, 7, 4, 3, 1), (2, 2, 16)),
    "ACmix_2x3_dilated": (lambda: jzoo.ACmix(16, 3, 2, 3, 1, 2), lambda: zoo.ACmix(16, 16, 3, 2, 3, 1, 2), (2, 3, 16)),
    "ACmix_6x8_s2": (lambda: jzoo.ACmix(32, 7, 4, 3, 2), lambda: zoo.ACmix(16, 32, 7, 4, 3, 2), (6, 8, 16)),
    "Conv_SWS_20x20": (lambda: jzoo.Conv_SWS(16), lambda: zoo.Conv_SWS(16, 16), (20, 20, 16)),
    "Conv_SWS_13x12_overlap": (lambda: jzoo.Conv_SWS(16, 8, 0.5), lambda: zoo.Conv_SWS(16, 16, 8, 0.5), (13, 12, 16)),
    "ADown_9x8": (lambda: jzoo.ADown(16), lambda: zoo.ADown(12, 16), (9, 8, 12)),
    "DownSimper_7x9": (lambda: jzoo.DownSimper(24), lambda: zoo.DownSimper(12, 24), (7, 9, 12)),
    "RepVGGBlock_identity": (lambda: jzoo.RepVGGBlock(16), lambda: zoo.RepVGGBlock(16, 16), (6, 5, 16)),
    "CoordConv_with_r_7x5": (lambda: jzoo.CoordConv(16, 3, 1, True), lambda: zoo.CoordConv(8, 16, 3, 1, True),
                             (7, 5, 8)),
    "CPCA_9x7": (lambda: jzoo.CPCA(), lambda: zoo.CPCA(16), (9, 7, 16)),
    "C3_CA_5x9": (lambda: jzoo.C3_CA(16), lambda: zoo.C3_CA(16, 16), (5, 9, 16)),
    "CABottleneck_5x9": (lambda: jzoo.CABottleneck(16), lambda: zoo.CABottleneck(16, 16), (5, 9, 16)),
}


def block_pair(name: str, seed: int = 1):
    """(flax module, its lively variables, port module with them loaded, x)."""
    jfn, pfn, (h, w, c) = BLOCKS[name]
    x = np.random.default_rng(sorted(BLOCKS).index(name)).standard_normal((2, h, w, c)).astype(np.float32)
    x += np.linspace(-1.0, 1.0, c, dtype=np.float32)  # channels that differ
    jmod = jfn()
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), x, False))
    variables = _to_dict(random_variables(shapes, seed))
    variables["params"] = lively(variables["params"])
    pmod = pfn()
    assert load_jax_variables(pmod, variables) == ([], [])
    return jmod, variables, pmod, x


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_flax(name):
    """Eval output within atol 1e-4, rtol 1e-4: ACmix's windows on a map
    smaller than its pad (jnp.pad's reflect reflects again: F.pad refuses
    it), dilated and at stride 2; Conv_SWS's border that no 8x8 tile covers
    (zero) and its overlapping tiles divided by the coverage at their add;
    ADown and DownSimper on odd sizes; RepVGGBlock's identity BatchNorm;
    CoordConv's with_r channel; CPCA's strips; coordinate attention's
    strip on a non-square map."""
    jmod, variables, pmod, x = block_pair(name)
    ref = np.asarray(jax.jit(lambda v, t: jmod.apply(v, t, False))(variables, x))
    with torch.no_grad():
        got = pmod.eval()(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    if name == "Conv_SWS_20x20":  # rows and columns 16-19 are covered by no tile: the attention passes 0 on
        att = zoo.SimAMWithFlexibleSlicing()(_nchw(x))
        assert (att[:, :, 16:] == 0).all() and (att[:, :, :, 16:] == 0).all() and (att[:, :, :16, :16] != 0).all()
    if name == "RepVGGBlock_identity":
        assert pmod.id_bn is not None and "id_bn" in variables["params"]


def test_reflect_index_is_jnp_pads_reflect():
    """reflect_index gives jnp.pad(mode="reflect")'s source positions for
    pads shorter than the axis, as long and longer ([1, 0, 1, 0, 1, 0, 1,
    0] on a 2-long axis padded by 3), and on a 1-long axis."""
    for n in (1, 2, 3, 5):
        for pad in (0, 1, 2, 3, 7):
            want = np.asarray(jnp.pad(jnp.arange(n), pad, mode="reflect"))
            np.testing.assert_array_equal(zoo.reflect_index(n, pad, "cpu").numpy(), want, err_msg=(n, pad))
    np.testing.assert_array_equal(zoo.reflect_index(2, 3, "cpu").numpy(), [1, 0, 1, 0, 1, 0, 1, 0])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_coordinates_are_jnp_linspace_bit_for_bit(dtype):
    """The coordinate maps of CoordConv and ACmix: jax_linspace(n) equals
    jnp.linspace(-1, 1, n, dtype) bitwise in bfloat16 at every map size of
    the 64- and 640-px graphs and more, where torch.linspace does not (n =
    20: JAX -0.890625 at index 1, torch -0.89453125); in float32 within one
    ulp of 1 (XLA reorders the f32 arithmetic on the CPU)."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    for n in (1, 2, 3, 4, 5, 7, 8, 13, 16, 20, 32, 40, 64, 80, 160, 256):
        want = np.asarray(jnp.linspace(-1.0, 1.0, n, dtype=jdt).astype(jnp.float32))
        got = zoo.jax_linspace(n, tdt, "cpu").float().numpy()
        np.testing.assert_allclose(got, want, atol=0 if dtype == "bfloat16" else 2.0 ** -23, rtol=0, err_msg=n)
    if dtype == "bfloat16":
        assert zoo.jax_linspace(20, tdt, "cpu")[1].item() == -0.890625
        assert torch.linspace(-1.0, 1.0, 20, dtype=tdt)[1].item() == -0.89453125


@pytest.mark.parametrize("name", ["CoordConv_with_r_7x5", "ACmix_2x3_dilated"])
def test_coordinate_blocks_in_bfloat16_match_flax(name):
    """CoordConv (with_r) and ACmix with bfloat16 weights and input against
    flax at dtype bfloat16 with the same variables: within the bf16 limits
    atol 5e-2, rtol 5e-2 (the convs' sums round apart; the coordinates
    themselves are the bits of the test above)."""
    jmod, variables, pmod, x = block_pair(name)
    jbf = type(jmod)(**{f.name: getattr(jmod, f.name) for f in jmod.__dataclass_fields__.values()
                        if f.name not in ("parent", "name", "dtype")}, dtype=jnp.bfloat16)
    ref = np.asarray(jbf.apply(variables, jnp.asarray(x, jnp.bfloat16), False).astype(jnp.float32))
    with torch.no_grad():
        got = pmod.to(torch.bfloat16).eval()(_nchw(x).to(torch.bfloat16)).float().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("name", ["CPCA_9x7", "ACmix_2x2", "ACmix_6x8_s2", "Conv_SWS_13x12_overlap", "CABottleneck_5x9"])
def test_block_gradients_match_jax_grad(name):
    """Every parameter's gradient of the eval-mode output's weighted sum
    against jax.grad, within 1e-4 of each leaf's largest element plus 1e-6
    of the largest gradient: CPCA's one 1x1 `conv` runs three times, and the
    port holds it once, so its gradient sums the three uses; ACmix's fc,
    0-d rates, dep_conv and conv_p (through the reflected windows); the
    overlapping tiles of Conv_SWS; the coordinate attention's strip."""
    jmod, variables, pmod, x = block_pair(name)
    wsum = np.random.default_rng(3).standard_normal(np.asarray(jmod.apply(variables, x, False)).shape)
    wsum = wsum.astype(np.float32)

    def loss(params):
        return (jmod.apply({**variables, "params": params}, x, False) * wsum).sum()

    want = flat(jax.device_get(jax.grad(loss)(variables["params"])))
    out = pmod.eval()(_nchw(x)).permute(0, 2, 3, 1)
    names, params = zip(*pmod.named_parameters())
    grads = torch.autograd.grad((out * torch.from_numpy(wsum)).sum(), params)
    if name == "CPCA_9x7":
        assert sum(1 for n in names if n.startswith("conv.")) == 2  # one conv: its weight and bias
    got = flat(export_param_tree(pmod, list(names), list(grads)))
    assert sorted(got) == sorted(want)
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=1e-4 * np.abs(w).max() + 1e-6 * top, rtol=0, err_msg=k)


# one instance of each block that refuses a strip, 32 channels in
STRIPLESS_BLOCKS = {
    "CoordConv": lambda: zoo.CoordConv(32, 32, 3), "CoordConvd": lambda: zoo.CoordConvd(32, 32, 3),
    "ADown": lambda: zoo.ADown(32, 32), "DownSimper": lambda: zoo.DownSimper(32, 32),
    "SPPF_improve": lambda: zoo.SPPF_improve(32, 32), "SPPCSPCS": lambda: zoo.SPPCSPCS(32, 32),
    "Conv_SWS": lambda: zoo.Conv_SWS(32, 32, 4), "ACmix": lambda: zoo.ACmix(32, 32, 3, 4),
    "CPCA": lambda: zoo.CPCA(32), "C3_CA": lambda: zoo.C3_CA(32, 32), "C3_BAM": lambda: zoo.C3_BAM(32, 32),
}


@pytest.mark.parametrize("block", sorted(STRIPLESS_BLOCKS))
def test_blocks_without_a_strip_path_refuse_a_strip(block):
    """Under spatial(strip) these blocks raise NotImplementedError naming
    item 6 rather than reduce over one strip, read its coordinates as the
    map's, pool it without a halo or pad at its edges."""
    x = torch.randn(2, 32, 8, 8)
    mod = STRIPLESS_BLOCKS[block]().eval()
    with torch.no_grad():
        mod(x)  # unsharded it runs
        with spatial(object()), pytest.raises(NotImplementedError, match="item 6"):
            mod(x)


@pytest.mark.parametrize("row", ["SimConv", "ACmix", "Conv_SWS", "C3_CBAM", "VoVGSCSPCBAM", "CPCA"])
def test_runner_refuses_to_shard_a_graph_with_a_conv_zoo_row(row, tmp_path):
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
